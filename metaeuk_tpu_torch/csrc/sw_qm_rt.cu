// Query-major Smith-Waterman kernels for long queries on NVIDIA Hopper
// (sm_90a): a warp per (query, target) pair, the target's columns in the
// warp's registers, the query streamed through the warp as a wavefront.
//
// sw_qm_rt_ends   replaces metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_qm_rt
//                 (K5): forward affine-gap local alignment ends, one query
//                 against the 128 target lanes of a tile.
// sw_qm_rt_starts replaces metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_qm_rev_rt
//                 (K6): the reverse-prefix pass that finds the starts from
//                 known ends.
// The JAX package runs them for query tiers above 4096 rows (16384 and
// 65536; MetaEuk keeps frames up to 32734 codons), against target tiers up
// to 4096 (usually 60-600 aa). The Pallas kernels cut the query into row
// tiles of 2048 and carry each column's H, E and F down a row tile through
// VMEM scratch; on this card that scratch, (tiles, 2048, 128) words plus a
// (tiles, Lt, 128) boundary, does not fit L2 and makes every cell wait on
// device memory. Here the sweep runs the other way round, so the state it
// carries is one row of the short axis, and that fits in registers.
//
// Design. Warp w of a block aligns pair b = 4 * blockIdx.x + w (tile b /
// 128, lane b % 128). Thread k owns C consecutive target columns (C = 4, 8
// or 16, the least that covers what is left of the target, 32 C columns a
// stripe) and keeps, for each of them, H of the previous row and F (the
// gap along the query) in registers, indexed only by unrolled constants.
// Thread k works on query row i at step i + k. Each step it receives from
// thread k - 1, in one __shfl_up_sync of a packed word, that thread's last
// column's H (the diagonal one step later) and its outgoing E (the gap
// along the target) for row i: one shuffle per C cells. A target wider
// than one stripe of 512 columns is swept stripe by stripe; thread 31
// hands each row's last H and E on to thread 0 of the next stripe through
// a per-pair array of Lq words (one word per 512 cells), read two rows
// ahead. There is no H/E scratch and no shared-memory barrier: each warp
// stages, per stripe, its own int8 target profile in shared memory
// (prof[a][k] = the scores of thread k's C columns against query class a,
// 16 bytes a thread at C = 16), so one shared load per row gives a thread
// all its C scores; the query's bias is added after the load. Query codes
// and biases are read from device memory two rows ahead. The reverse pass
// is the forward sweep over rows qe..0 and columns te..0 (each cut to the
// true lengths), counted from the end cell.
//
// Contract (the Pallas kernels'): H starts at 0 and E and F at -go; H is
// capped at 32767; per cell, with DPX, g = max(Hdiag + s, E, 0), h =
// min(max(g, F), 32767), E' = max(E - ge, h - go), F' = max(F - ge, g - go).
// Forward tie-break: highest score, then the first column, then the
// smallest row; no hit gives (0, Lq-1, -1) with Lq the tier width.
// Reverse: the highest score, then the last column, then the largest row;
// no hit gives (0, 0, -1). Both are the forward order in sweep coordinates
// (the reverse pass counts rows and columns back from its end cell): each
// thread keeps its best cell under it, visiting rows in order and its
// columns in order, and the warp reduces its 32 bests under it. A padding
// lane (lj < 0), a padding tile (qidx < 0) or a zero length gives the
// no-hit values. Columns past the target's end inside a thread's last
// slice score -128 + bias < 0: they never feed a real cell (they lie to
// its right) and stay below the best real cell, so they never win.
// Substitution scores must fit int8 (the wrapper checks).
//
// What bounds it on an H100: the integer instructions of a cell, about 8
// at the least (chip_smoke.py SW_OPS, DPX add-max counted as one) and about
// 11 here (the score's byte extract and bias add, the running row max), at
// 64 int32 lanes an SM, 1.675e13 operations a second. Device memory holds
// only the inputs, the outputs and, for targets wider than 512, the stripe
// hand-off; shuffles, the shared profile load and the query loads are
// amortised over C cells.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;           // target lanes of a tile (sw_torch.TB)
constexpr int kWarps = 4;             // pairs (warps) per block
constexpr int kMaxCols = 16;          // columns a thread carries, at most
constexpr int kStripe = 32 * kMaxCols;
constexpr int kScoreCap = 32767;
constexpr unsigned kFull = 0xffffffffu;

// H (0..32767) in the low half, E (-go..32767) as int16 in the high half
__device__ __forceinline__ uint32_t pack_he(int h, int e) {
  return (static_cast<uint32_t>(h) & 0xffffu) | (static_cast<uint32_t>(e) << 16);
}
__device__ __forceinline__ int unpack_h(uint32_t w) {
  return static_cast<int>(w & 0xffffu);
}
__device__ __forceinline__ int unpack_e(uint32_t w) {
  return static_cast<int>(w) >> 16;
}

// byte b of w, sign-extended (one PRMT: the selector's msb replicates the
// byte's sign)
__device__ __forceinline__ int sbyte(uint32_t w, int b) {
  const uint32_t sel = b | ((8 | b) << 4) | ((8 | b) << 8) | ((8 | b) << 12);
  int r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(w), "r"(sel));
  return r;
}

// One alignment in sweep coordinates: sweep row r is query row q[qs * r],
// sweep column c is target column t[ts * c].
struct Sweep {
  const uint8_t* q;
  const int8_t* qb;
  int qs;
  const uint8_t* t;
  int ts;
  int rows, cols;   // both > 0
};

// A thread's best cell, in sweep coordinates.
struct Best {
  int score, row, col;
};

// The order of both passes in sweep coordinates: the higher score, then the
// smaller column, then the smaller row.
__device__ __forceinline__ bool before(int s, int r, int c, const Best& b) {
  return s > b.score ||
         (s == b.score && (c < b.col || (c == b.col && r < b.row)));
}

template <int C>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t* w) {
  if constexpr (C == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (C == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *p;
  }
}

template <int C>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t* w) {
  if constexpr (C == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (C == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *p = w[0];
  }
}

// Sweep row r's query class and bias; r is clamped into the sweep, so the
// look-ahead past either end reads a real row.
__device__ __forceinline__ void query_row(const Sweep& p, int r, int& a,
                                          int& bias) {
  r = min(max(r, 0), p.rows - 1);
  a = p.q[p.qs * r];
  bias = p.qb[p.qs * r];
}

// One stripe of 32 C columns from sweep column `start`: stage this warp's
// profile, then run the wavefront over every row. `carry` (per-row H and E
// of the column before `start`, or null at the left edge) is read by thread
// 0; `carry_out` (the stripe's last column, or null when no stripe
// follows) is written by thread 31, in place: row i is read two steps
// before thread 0 reaches it and written 31 steps after.
template <int C>
__device__ __forceinline__ void stripe(const Sweep& p, int start,
                                       const int32_t* __restrict__ submat,
                                       int alph, uint32_t* prof,
                                       const uint32_t* carry,
                                       uint32_t* carry_out, int go, int ge,
                                       Best& best) {
  constexpr int W = C / 4;   // profile words of a thread and class
  const int k = threadIdx.x & 31;
  const int c0 = start + k * C;     // this thread's first column
  uint32_t* mine = prof + k * W;    // class a at mine[a * 32 * W]

  __syncwarp();   // the previous stripe's carry writes, before thread 0 reads
  {   // each thread reads back only the profile words it writes here
    int code[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      code[c] = c0 + c < p.cols ? p.t[p.ts * (c0 + c)] : -1;
    for (int a = 0; a < alph; ++a) {
      uint32_t w[W];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int s = code[c] >= 0 ? submat[a * alph + code[c]] : -128;
        const uint32_t byte = (static_cast<uint32_t>(s) & 0xffu) << (8 * (c % 4));
        w[c / 4] = c % 4 == 0 ? byte : w[c / 4] | byte;
      }
      store_words<C>(mine + a * 32 * W, w);
    }
  }

  // the last thread with a real column; the threads past it idle
  const int last_k = min(31, (p.cols - 1 - start) / C);
  int hp[C], f[C];   // H(i - 1, j) and F(i, j) of this thread's columns
#pragma unroll
  for (int c = 0; c < C; ++c) {
    hp[c] = 0;
    f[c] = -go;
  }
  const uint32_t edge = pack_he(0, -go);   // column -1: H 0, E -go
  int hup = 0;             // H(i - 1, c0 - 1): row -1 is 0
  uint32_t in = edge;      // H(i, c0 - 1) and E(i, c0)
  int a0, b0, a1, b1;      // query class and bias, one and two rows ahead
  query_row(p, -k, a0, b0);
  query_row(p, 1 - k, a1, b1);
  uint32_t w0 = edge, w1 = edge;   // thread 0's carry words, likewise
  if (carry != nullptr) {
    w0 = carry[0];
    w1 = carry[min(1, p.rows - 1)];
  }
  const int steps = p.rows + last_k;
  for (int t = 0; t < steps; ++t) {
    const int i = t - k;
    const int a = a0, bias = b0;
    a0 = a1;
    b0 = b1;
    query_row(p, i + 2, a1, b1);
    if (k == 0) in = w0;
    w0 = w1;
    if (carry != nullptr && t + 2 < p.rows) w1 = carry[t + 2];
    uint32_t out = 0;
    if (i >= 0 && i < p.rows && k <= last_k) {
      uint32_t w[W];
      load_words<C>(mine + a * 32 * W, w);
      int diag = hup;
      hup = unpack_h(in);
      int e = unpack_e(in);
      int rowmax = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int s = sbyte(w[c / 4], c % 4) + bias;
        const int g = __viaddmax_s32_relu(diag, s, e);
        diag = hp[c];
        const int h = min(max(g, f[c]), kScoreCap);
        e = __viaddmax_s32(e, -ge, h - go);
        f[c] = __viaddmax_s32(f[c], -ge, g - go);
        hp[c] = h;
        rowmax = max(rowmax, h);
      }
      out = pack_he(hp[C - 1], e);
      if (carry_out != nullptr && k == 31) carry_out[i] = out;
      if (rowmax > 0 && rowmax >= best.score) {   // a new best, or a tie
        int first = C - 1;
#pragma unroll
        for (int c = C - 1; c >= 0; --c)
          if (hp[c] == rowmax) first = c;
        if (before(rowmax, i, c0 + first, best))
          best = Best{rowmax, i, c0 + first};
      }
    }
    in = __shfl_up_sync(kFull, out, 1);
  }
}

// The warp's sweep over every stripe, each at the least C that covers the
// columns left; returns the warp's best under the order of `before`.
__device__ __forceinline__ Best sweep(const Sweep& p,
                                      const int32_t* __restrict__ submat,
                                      int alph, uint32_t* prof,
                                      uint32_t* carry, int go, int ge) {
  Best best{0, 0, INT_MAX};
  for (int start = 0; start < p.cols;) {
    const int left = p.cols - start;
    const uint32_t* in = start > 0 ? carry : nullptr;
    if (left <= 32 * 4) {
      stripe<4>(p, start, submat, alph, prof, in, nullptr, go, ge, best);
      start += 32 * 4;
    } else if (left <= 32 * 8) {
      stripe<8>(p, start, submat, alph, prof, in, nullptr, go, ge, best);
      start += 32 * 8;
    } else {
      stripe<16>(p, start, submat, alph, prof, in,
                 left > kStripe ? carry : nullptr, go, ge, best);
      start += kStripe;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Best o{__shfl_xor_sync(kFull, best.score, off),
                 __shfl_xor_sync(kFull, best.row, off),
                 __shfl_xor_sync(kFull, best.col, off)};
    if (before(o.score, o.row, o.col, best)) best = o;
  }
  return best;
}

template <bool kRev>
__global__ void __launch_bounds__(32 * kWarps) sw_qm_rt_kernel(
    const int32_t* __restrict__ submat, int alph,
    const uint8_t* __restrict__ q_mat, const int8_t* __restrict__ qb_mat,
    const int32_t* __restrict__ q_lens, int nq, int Lq,
    const uint8_t* __restrict__ t_mat, const int32_t* __restrict__ t_lens,
    int nt, int Lt, const int32_t* __restrict__ qidx,
    const int32_t* __restrict__ lj, const int32_t* __restrict__ q_end,
    const int32_t* __restrict__ t_end, int n_pairs, int go, int ge,
    uint32_t* __restrict__ carry, int32_t* __restrict__ score_out,
    int32_t* __restrict__ row_out, int32_t* __restrict__ col_out) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= n_pairs) return;   // uniform over the warp
  const int qi = qidx[b / kLanes], tj = lj[b];
  const int ql = (qi >= 0 && qi < nq) ? max(0, min(q_lens[qi], Lq)) : 0;
  const int tn = (tj >= 0 && tj < nt) ? max(0, min(t_lens[tj], Lt)) : 0;
  const uint8_t* q = q_mat + static_cast<size_t>(max(qi, 0)) * Lq;
  const int8_t* qb = qb_mat + static_cast<size_t>(max(qi, 0)) * Lq;
  const uint8_t* t = t_mat + static_cast<size_t>(max(tj, 0)) * Lt;
  // the reverse pass starts at its end cell, cut to the true lengths
  const int r0 = kRev ? min(q_end[b], ql - 1) : ql - 1;
  const int c0 = kRev ? min(t_end[b], tn - 1) : tn - 1;
  Best best{0, 0, INT_MAX};
  if (r0 >= 0 && c0 >= 0) {
    const Sweep p = kRev ? Sweep{q + r0, qb + r0, -1, t + c0, -1, r0 + 1, c0 + 1}
                         : Sweep{q, qb, 1, t, 1, r0 + 1, c0 + 1};
    uint32_t* prof = smem + warp * alph * 32 * (kMaxCols / 4);
    uint32_t* pair_carry =
        carry != nullptr ? carry + static_cast<size_t>(b) * Lq : nullptr;
    best = sweep(p, submat, alph, prof, pair_carry, go, ge);
  }
  if ((threadIdx.x & 31) == 0) {
    const bool hit = best.score > 0;
    score_out[b] = hit ? best.score : 0;
    if (kRev) {
      row_out[b] = hit ? r0 - best.row : 0;
      col_out[b] = hit ? c0 - best.col : -1;
    } else {
      row_out[b] = hit ? best.row : Lq - 1;
      col_out[b] = hit ? best.col : -1;
    }
  }
}

template <bool kRev>
int launch(const int32_t* submat, int alph, const uint8_t* q_mat,
           const int8_t* qb_mat, const int32_t* q_lens, int nq, int Lq,
           const uint8_t* t_mat, const int32_t* t_lens, int nt, int Lt,
           const int32_t* qidx, const int32_t* lj, const int32_t* q_end,
           const int32_t* t_end, int n_tiles, int go, int ge, uint32_t* carry,
           int32_t* score, int32_t* row, int32_t* col, void* stream) {
  if (alph < 1 || alph > 32 || (Lt > kStripe && carry == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kWarps) * alph * 32 * kMaxCols;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        sw_qm_rt_kernel<kRev>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int n_pairs = n_tiles * kLanes;
  if (n_pairs > 0) {
    sw_qm_rt_kernel<kRev><<<(n_pairs + kWarps - 1) / kWarps, 32 * kWarps,
                            smem, static_cast<cudaStream_t>(stream)>>>(
        submat, alph, q_mat, qb_mat, q_lens, nq, Lq, t_mat, t_lens, nt, Lt,
        qidx, lj, q_end, t_end, n_pairs, go, ge, carry, score, row, col);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_mat, qb_mat: (nq, Lq) staged query codes and biases; t_mat: (nt, Lt)
// staged target codes; qidx: (n_tiles,) query row per tile; lj: (n_tiles *
// 128,) target row per lane; carry: (n_tiles * 128, Lq) words for the
// stripe hand-off, needed (non-null) only when Lt > 512. Substitution
// scores must fit int8. Every pointer is on the device; the launch goes on
// `stream` and does not synchronise. Returns the error of the attribute
// call or of the launch (0 on success).
extern "C" int sw_qm_rt_ends(const int32_t* submat, int alph,
                             const uint8_t* q_mat, const int8_t* qb_mat,
                             const int32_t* q_lens, int nq, int Lq,
                             const uint8_t* t_mat, const int32_t* t_lens,
                             int nt, int Lt, const int32_t* qidx,
                             const int32_t* lj, int n_tiles, int go, int ge,
                             uint32_t* carry, int32_t* best, int32_t* q_end,
                             int32_t* t_end, void* stream) {
  return launch<false>(submat, alph, q_mat, qb_mat, q_lens, nq, Lq, t_mat,
                       t_lens, nt, Lt, qidx, lj, nullptr, nullptr, n_tiles,
                       go, ge, carry, best, q_end, t_end, stream);
}

// As sw_qm_rt_ends, with each lane's known ends q_end, t_end: (n_tiles *
// 128,).
extern "C" int sw_qm_rt_starts(const int32_t* submat, int alph,
                               const uint8_t* q_mat, const int8_t* qb_mat,
                               const int32_t* q_lens, int nq, int Lq,
                               const uint8_t* t_mat, const int32_t* t_lens,
                               int nt, int Lt, const int32_t* qidx,
                               const int32_t* lj, const int32_t* q_end,
                               const int32_t* t_end, int n_tiles, int go,
                               int ge, uint32_t* carry, int32_t* score,
                               int32_t* q_start, int32_t* t_start,
                               void* stream) {
  return launch<true>(submat, alph, q_mat, qb_mat, q_lens, nq, Lq, t_mat,
                      t_lens, nt, Lt, qidx, lj, q_end, t_end, n_tiles, go,
                      ge, carry, score, q_start, t_start, stream);
}
