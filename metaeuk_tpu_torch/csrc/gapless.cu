// Ungapped (gapless) diagonal scoring for NVIDIA Hopper (sm_90a).
//
// gapless_pair replaces metaeuk_tpu/ops/ungapped.py::_gapless_kernel (K7), and
// with it ungapped.py::_build_S: for each (query, target) pair, the best
// local run over all diagonals,
//   D(i,j) = max(0, D(i-1,j-1) + S(i,j)),   score = max D (floored at 0),
// over rows i < q_len and columns j < t_len, with
// S(i,j) = submat[q_i][t_j] + bias_i looked up in a shared-memory copy of the
// substitution matrix, in int32, instead of read from an int8 (Lt, Lq, B)
// score tensor.
//
// Design: one thread per pair. D(i,j) depends only on D(i-1,j-1), so the
// recurrence splits by diagonal: the thread walks the diagonals one after the
// other (Kadane's scan) with one register of state and needs no column
// scratch at all; the TPU kernel keeps a (Lq, 128) column of D in VMEM only
// because it streams columns. Rows >= q_len (the TPU's NEG mask) and columns
// >= t_len end a diagonal, which is exact: D past them never reaches the best.
// Queries and targets are read from transposed staged matrices, qT (Lq, nq)
// and tT (Lt, nt), through the pair's row indices li and lj. The prefilter
// launches the cross product of a query block and a target block query-major
// (consecutive pairs share li and walk consecutive lj), so at each step the
// threads of a warp read one query byte (a broadcast) and neighbouring target
// bytes (one coalesced load).
//
// What bounds it on an H100: about five integer operations per cell (the
// score add, the bias add, the run add, two max) and three byte loads per
// cell served from L1; device memory traffic is small (the staged matrices
// are read from cache). The least is two instructions per cell: with the bias
// folded into a query profile, run = __viaddmax_s32_relu(run, s, 0) and one
// max. A later PR packs four target codes per load and holds the query
// profile in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlphPad = 32;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) gapless_pair_kernel(
    const int32_t* __restrict__ submat, int alph,
    const uint8_t* __restrict__ qT, const int8_t* __restrict__ qbT,
    const int32_t* __restrict__ q_lens, int nq, int Lq,
    const uint8_t* __restrict__ tT, const int32_t* __restrict__ t_lens,
    int nt, int Lt, const int32_t* __restrict__ li,
    const int32_t* __restrict__ lj, long long B,
    int32_t* __restrict__ best_out) {
  __shared__ int sm[kAlphPad * kAlphPad];
  for (int k = threadIdx.x; k < kAlphPad * kAlphPad; k += blockDim.x) {
    const int r = k / kAlphPad, c = k % kAlphPad;
    sm[k] = (r < alph && c < alph) ? submat[r * alph + c] : 0;
  }
  __syncthreads();
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const int qi = li[b], tj = lj[b];
  if (qi < 0 || qi >= nq || tj < 0 || tj >= nt) {
    best_out[b] = 0;
    return;
  }
  const int m = max(0, min(q_lens[qi], Lq));
  const int n = max(0, min(t_lens[tj], Lt));
  const size_t qs = static_cast<size_t>(nq), ts = static_cast<size_t>(nt);
  int best = 0;
  // diagonal d = j - i, from the bottom-left corner to the top-right one
  for (int d = 1 - m; d < n; ++d) {
    int i = max(0, -d);
    const int i_end = min(m, n - d);
    int run = 0;
    for (; i < i_end; ++i) {
      const int s = sm[qT[i * qs + qi] * kAlphPad + tT[(i + d) * ts + tj]] +
                    qbT[i * qs + qi];
      run = max(run + s, 0);
      best = max(best, run);
    }
  }
  best_out[b] = best;
}

}  // namespace

// qT, qbT: (Lq, nq) transposed staged query codes and biases; tT: (Lt, nt)
// transposed staged target codes; li, lj: (B,) row indices of each pair (a
// pair with an index out of range scores 0). Every pointer is on the device;
// the launch goes on `stream` and does not synchronise. Returns
// cudaGetLastError().
extern "C" int gapless_pair(const int32_t* submat, int alph,
                            const uint8_t* qT, const int8_t* qbT,
                            const int32_t* q_lens, int nq, int Lq,
                            const uint8_t* tT, const int32_t* t_lens, int nt,
                            int Lt, const int32_t* li, const int32_t* lj,
                            long long B, int32_t* best, void* stream) {
  if (B > 0) {
    const long long blocks = (B + kThreads - 1) / kThreads;
    gapless_pair_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        submat, alph, qT, qbT, q_lens, nq, Lq, tT, t_lens, nt, Lt, li, lj, B,
        best);
  }
  return static_cast<int>(cudaGetLastError());
}
