// Query-major Smith-Waterman kernels for NVIDIA Hopper (sm_90a).
//
// sw_qm_ends   replaces metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_qm (K3):
//              forward affine-gap local alignment ends, one query against
//              the 128 target lanes of a tile.
// sw_qm_starts replaces metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_qm_rev (K4):
//              the reverse-prefix pass that finds the starts from known ends.
// Both also replace sw_pallas.py::build_prof_tiles and ::build_tcodes_T: the
// kernels read the staged (nq, Lq) query rows and (nt, Lt) target rows and
// the tile's lane map directly.
//
// Design: one block per tile, one thread per lane (128 lanes). On the TPU the
// one-hot MXU product exists to deliver a score column without an (Lt, Lq, B)
// score tensor. Here the block first writes its query's profile
// prof[i][a] = submat[q_i][a] + bias_i into shared memory as int16 (Lq x alph,
// 168 KB at Lq 4096 and 21 classes, so dynamic shared memory above 48 KB);
// each thread then looks up prof[i][t_j] for its own target residue t_j. All
// lanes of a tile share the query, so the threads of a warp walk the same row
// i together and read neighbouring words of one profile row: no bank
// conflicts. The Gotoh recurrence is sw_pair.cu's, on scalars:
//   G(i,j)   = max(H(i-1,j-1) + s(i,j), E(i,j), 0)
//   F(i,j)   = max(G(i-1,j) - go, F(i-1,j) - ge)
//   H(i,j)   = min(max(G(i,j), F(i,j)), 32767)
//   E(i,j+1) = max(E(i,j) - ge, H(i,j) - go)
// with H and E packed as 16-bit halves of one word in a device-memory column
// scratch laid out [tile][row][lane], so a warp's accesses are coalesced.
//
// Contract (the Pallas kernels'): H starts at 0 and E at -go; H is capped at
// 32767. Forward tie-break: highest score, then the first column, then the
// smallest row; no hit gives (0, Lq-1, -1) with Lq the tier width. Reverse:
// columns te..0 and rows qe..0, tie-break the last column, then the largest
// row; no hit gives (0, 0, -1). A padding lane (lj < 0) or a padding tile
// (qidx < 0) gives the no-hit values. The loops stop at the true lengths: a
// padded cell (scored -128 through code 21 or a masked profile row on the
// TPU) never strictly improves the best and never feeds a real cell, so
// skipping it gives the same result. The TPU's 512-column chunks and bf16
// profile have no counterpart here.
//
// What bounds it on an H100: the H/E column traffic, 4 B read and 4 B written
// per cell (L2-resident for the tiles in flight), and about a dozen integer
// operations per cell on one thread (eight would do, with sm_90's DPX
// add-max functions); the shared-memory lookup replaces the pair kernel's
// two global loads of query code and bias. A later PR keeps a stripe of the
// column in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScoreCap = 32767;
constexpr int kNeg = -1000000;
constexpr int kLanes = 128;

__device__ __forceinline__ uint32_t pack_he(int h, int e) {
  return static_cast<uint32_t>(static_cast<uint16_t>(h)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(static_cast<int16_t>(e))) << 16);
}
__device__ __forceinline__ int unpack_h(uint32_t w) {
  return static_cast<int>(w & 0xffffu);
}
__device__ __forceinline__ int unpack_e(uint32_t w) {
  return static_cast<int>(static_cast<int16_t>(static_cast<uint16_t>(w >> 16)));
}

// prof[i * alph + a] = submat[q_i][a] + bias_i for the tile's query rows
// i < ql; returns ql (0 for a padding tile). Call before any thread returns.
__device__ int load_profile(int16_t* prof, const int32_t* submat, int alph,
                            const uint8_t* q_mat, const int8_t* qb_mat,
                            const int32_t* q_lens, int nq, int Lq, int qi) {
  const int ql = (qi >= 0 && qi < nq) ? max(0, min(q_lens[qi], Lq)) : 0;
  const uint8_t* q = q_mat + static_cast<size_t>(max(qi, 0)) * Lq;
  const int8_t* qb = qb_mat + static_cast<size_t>(max(qi, 0)) * Lq;
  for (int k = threadIdx.x; k < ql * alph; k += blockDim.x) {
    const int i = k / alph, a = k % alph;
    prof[k] = static_cast<int16_t>(submat[q[i] * alph + a] + qb[i]);
  }
  __syncthreads();
  return ql;
}

__global__ void __launch_bounds__(kLanes) sw_qm_ends_kernel(
    const int32_t* __restrict__ submat, int alph,
    const uint8_t* __restrict__ q_mat, const int8_t* __restrict__ qb_mat,
    const int32_t* __restrict__ q_lens, int nq, int Lq,
    const uint8_t* __restrict__ t_mat, const int32_t* __restrict__ t_lens,
    int nt, int Lt, const int32_t* __restrict__ qidx,
    const int32_t* __restrict__ lj, int go, int ge, uint32_t* __restrict__ he,
    int32_t* __restrict__ best_out, int32_t* __restrict__ qend_out,
    int32_t* __restrict__ tend_out) {
  extern __shared__ int16_t prof[];
  const int tile = blockIdx.x, lane = threadIdx.x;
  const int ql = load_profile(prof, submat, alph, q_mat, qb_mat, q_lens, nq,
                              Lq, qidx[tile]);
  const int b = tile * kLanes + lane;
  const int tj = lj[b];
  const int tn = (tj >= 0 && tj < nt) ? max(0, min(t_lens[tj], Lt)) : 0;
  const uint8_t* t = t_mat + static_cast<size_t>(max(tj, 0)) * Lt;
  uint32_t* col_he = he + static_cast<size_t>(tile) * Lq * kLanes + lane;
  const uint32_t init = pack_he(0, -go);
  if (tn > 0) {
    for (int i = 0; i < ql; ++i) col_he[i * kLanes] = init;
  }
  int best = 0, qe = Lq - 1, te = -1;
  for (int j = 0; j < tn && ql > 0; ++j) {
    const int16_t* col = prof + t[j];
    int hdiag = 0;  // H(i-1, j-1); row -1 is 0
    int f = kNeg;   // F(i, j)
    for (int i = 0; i < ql; ++i) {
      const uint32_t w = col_he[i * kLanes];
      const int e = unpack_e(w);
      const int s = col[i * alph];
      const int g = max(max(hdiag + s, e), 0);
      const int h = min(max(g, f), kScoreCap);
      if (h > best) { best = h; qe = i; te = j; }
      col_he[i * kLanes] = pack_he(h, max(e - ge, h - go));
      f = max(g - go, f - ge);
      hdiag = unpack_h(w);
    }
  }
  best_out[b] = best;
  qend_out[b] = qe;
  tend_out[b] = te;
}

__global__ void __launch_bounds__(kLanes) sw_qm_starts_kernel(
    const int32_t* __restrict__ submat, int alph,
    const uint8_t* __restrict__ q_mat, const int8_t* __restrict__ qb_mat,
    const int32_t* __restrict__ q_lens, int nq, int Lq,
    const uint8_t* __restrict__ t_mat, const int32_t* __restrict__ t_lens,
    int nt, int Lt, const int32_t* __restrict__ qidx,
    const int32_t* __restrict__ lj, const int32_t* __restrict__ q_end,
    const int32_t* __restrict__ t_end, int go, int ge,
    uint32_t* __restrict__ he, int32_t* __restrict__ score_out,
    int32_t* __restrict__ qstart_out, int32_t* __restrict__ tstart_out) {
  extern __shared__ int16_t prof[];
  const int tile = blockIdx.x, lane = threadIdx.x;
  const int ql = load_profile(prof, submat, alph, q_mat, qb_mat, q_lens, nq,
                              Lq, qidx[tile]);
  const int b = tile * kLanes + lane;
  const int tj = lj[b];
  const int tn = (tj >= 0 && tj < nt) ? max(0, min(t_lens[tj], Lt)) : 0;
  const uint8_t* t = t_mat + static_cast<size_t>(max(tj, 0)) * Lt;
  uint32_t* col_he = he + static_cast<size_t>(tile) * Lq * kLanes + lane;
  // rows qe..0 and columns te..0, cut to the real cells
  const int r0 = min(q_end[b], ql - 1);
  const int c0 = min(t_end[b], tn - 1);
  const uint32_t init = pack_he(0, -go);
  if (c0 >= 0) {
    for (int i = 0; i <= r0; ++i) col_he[i * kLanes] = init;
  }
  int best = 0, qs = 0, ts = -1;
  for (int j = c0; j >= 0; --j) {
    const int16_t* col = prof + t[j];
    int hdiag = 0;  // H(i+1, j+1); row r0+1 is 0
    int f = kNeg;   // F(i, j), fed from the rows below
    for (int i = r0; i >= 0; --i) {
      const uint32_t w = col_he[i * kLanes];
      const int e = unpack_e(w);
      const int s = col[i * alph];
      const int g = max(max(hdiag + s, e), 0);
      const int h = min(max(g, f), kScoreCap);
      if (h > best) { best = h; qs = i; ts = j; }
      col_he[i * kLanes] = pack_he(h, max(e - ge, h - go));
      f = max(g - go, f - ge);
      hdiag = unpack_h(w);
    }
  }
  score_out[b] = best;
  qstart_out[b] = qs;
  tstart_out[b] = ts;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

// q_mat, qb_mat: (nq, Lq) staged query codes and biases; t_mat: (nt, Lt)
// staged target codes; qidx: (n_tiles,) query row per tile; lj: (n_tiles *
// 128,) target row per lane; scratch: (n_tiles, Lq, 128) words. Every pointer
// is on the device; the launch goes on `stream` and does not synchronise.
// Returns the error of the attribute call or of the launch (0 on success).
extern "C" int sw_qm_ends(const int32_t* submat, int alph,
                          const uint8_t* q_mat, const int8_t* qb_mat,
                          const int32_t* q_lens, int nq, int Lq,
                          const uint8_t* t_mat, const int32_t* t_lens, int nt,
                          int Lt, const int32_t* qidx, const int32_t* lj,
                          int n_tiles, int go, int ge, uint32_t* scratch,
                          int32_t* best, int32_t* q_end, int32_t* t_end,
                          void* stream) {
  const size_t smem = static_cast<size_t>(Lq) * alph * sizeof(int16_t);
  int rc = set_smem(reinterpret_cast<const void*>(sw_qm_ends_kernel), smem);
  if (rc != 0) return rc;
  if (n_tiles > 0) {
    sw_qm_ends_kernel<<<n_tiles, kLanes, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        submat, alph, q_mat, qb_mat, q_lens, nq, Lq, t_mat, t_lens, nt, Lt,
        qidx, lj, go, ge, scratch, best, q_end, t_end);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sw_qm_starts(const int32_t* submat, int alph,
                            const uint8_t* q_mat, const int8_t* qb_mat,
                            const int32_t* q_lens, int nq, int Lq,
                            const uint8_t* t_mat, const int32_t* t_lens,
                            int nt, int Lt, const int32_t* qidx,
                            const int32_t* lj, const int32_t* q_end,
                            const int32_t* t_end, int n_tiles, int go, int ge,
                            uint32_t* scratch, int32_t* score,
                            int32_t* q_start, int32_t* t_start,
                            void* stream) {
  const size_t smem = static_cast<size_t>(Lq) * alph * sizeof(int16_t);
  int rc = set_smem(reinterpret_cast<const void*>(sw_qm_starts_kernel), smem);
  if (rc != 0) return rc;
  if (n_tiles > 0) {
    sw_qm_starts_kernel<<<n_tiles, kLanes, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        submat, alph, q_mat, qb_mat, q_lens, nq, Lq, t_mat, t_lens, nt, Lt,
        qidx, lj, q_end, t_end, go, ge, scratch, score, q_start, t_start);
  }
  return static_cast<int>(cudaGetLastError());
}
