// Row-tiled query-major Smith-Waterman kernels for NVIDIA Hopper (sm_90a),
// for queries whose profile does not fit one block's shared memory.
//
// sw_qm_rt_ends   replaces metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_qm_rt
//                 (K5): forward affine-gap local alignment ends, one query
//                 against the 128 target lanes of a tile.
// sw_qm_rt_starts replaces metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_qm_rev_rt
//                 (K6): the reverse-prefix pass that finds the starts from
//                 known ends.
// The JAX package runs them for query tiers above 4096 rows (16384 and
// 65536; MetaEuk keeps frames up to 32734 codons), against target tiers up
// to 4096.
//
// Design: sw_qm.cu's, one block per tile and one thread per lane, with the
// query axis cut into row tiles of tq rows. For each row tile the block
// stages that tile's profile rows, prof[i][a] = submat[q_i][a] + bias_i as
// int16 (tq x alph; 86 KB at tq 2048 and 21 classes), in dynamic shared
// memory and synchronises; each lane then sweeps its columns over the
// tile's rows. The H/E column scratch is [tile][row-in-tile][lane], H and E
// packed in the 16-bit halves of one word (sw_qm.cu). Between row tiles a
// boundary word per (tile, column, lane) carries the last row's H and the
// F that enters the next tile, F + go in the high half: below row 0,
// G >= 0 gives F >= -go, and F <= G - go stays under 65536. The first row's
// diagonal at column j is the boundary H at column j - 1, held in a
// register from the previous column's read. Row -1 is H = 0, F = -go: with
// G >= 0 that gives the same H and F below as F = -infinity.
//
// Contract (the Pallas kernels'): H starts at 0 and E at -go; H is capped
// at 32767. Forward tie-break: highest score, then the first column, then
// the smallest row; no hit gives (0, Lq-1, -1) with Lq the tier width.
// Reverse: columns te..0 and rows qe..0, tie-break the last column, then
// the largest row; no hit gives (0, 0, -1). With row tiles outermost a
// strict `>` would prefer an earlier tile over an earlier column: like the
// Pallas kernels, which compare Hn * 65536 + (65535 - j) across tiles, a
// later tile's equal score wins when its column comes first (forward) or
// last (reverse), and an equal score at an equal column keeps the earlier
// tile, whose row is the smaller (forward, top tile first) or the larger
// (reverse, bottom tile first). A padding lane (lj < 0) or a padding tile
// (qidx < 0) gives the no-hit values. The loops stop at the true lengths,
// as in sw_qm.cu.
//
// The tile loop is uniform over the block: every thread reaches each
// __syncthreads. In the reverse pass lanes of one tile have different qe,
// so a lane whose qe lies above a row tile skips its rows and stays in the
// loop.
//
// What bounds it on an H100: sw_qm.cu's per-cell work (the H/E word read
// and written, about a dozen integer operations), plus one boundary word
// read and written per (row tile, column, lane). The TPU's one-hot MXU
// product, bf16 profile and code 21 have no counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScoreCap = 32767;
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
// boundary word: H in the low half, F + go in the high half
__device__ __forceinline__ uint32_t pack_hf(int h, int f, int go) {
  return static_cast<uint32_t>(static_cast<uint16_t>(h)) |
         (static_cast<uint32_t>(f + go) << 16);
}
__device__ __forceinline__ int unpack_f(uint32_t w, int go) {
  return static_cast<int>(w >> 16) - go;
}

struct Tile {
  const uint8_t* q;   // the tile's query row
  const int8_t* qb;   // and its biases
  int ql;             // its true length (0 for a padding tile)
};

__device__ __forceinline__ Tile tile_query(const uint8_t* q_mat,
                                           const int8_t* qb_mat,
                                           const int32_t* q_lens, int nq,
                                           int Lq, int qi) {
  Tile t;
  t.ql = (qi >= 0 && qi < nq) ? max(0, min(q_lens[qi], Lq)) : 0;
  t.q = q_mat + static_cast<size_t>(max(qi, 0)) * Lq;
  t.qb = qb_mat + static_cast<size_t>(max(qi, 0)) * Lq;
  return t;
}

// prof[(i - lo) * alph + a] = submat[q_i][a] + bias_i for rows lo..hi-1,
// after every lane is done with the previous row tile's profile.
__device__ __forceinline__ void load_profile_rows(int16_t* prof,
                                                  const int32_t* submat,
                                                  int alph, const Tile& query,
                                                  int lo, int hi) {
  __syncthreads();
  for (int k = threadIdx.x; k < (hi - lo) * alph; k += blockDim.x) {
    const int i = lo + k / alph, a = k % alph;
    prof[k] = static_cast<int16_t>(submat[query.q[i] * alph + a] +
                                   query.qb[i]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kLanes) sw_qm_rt_ends_kernel(
    const int32_t* __restrict__ submat, int alph,
    const uint8_t* __restrict__ q_mat, const int8_t* __restrict__ qb_mat,
    const int32_t* __restrict__ q_lens, int nq, int Lq,
    const uint8_t* __restrict__ t_mat, const int32_t* __restrict__ t_lens,
    int nt, int Lt, const int32_t* __restrict__ qidx,
    const int32_t* __restrict__ lj, int tq, int go, int ge,
    uint32_t* __restrict__ he, uint32_t* __restrict__ bnd,
    int32_t* __restrict__ best_out, int32_t* __restrict__ qend_out,
    int32_t* __restrict__ tend_out) {
  extern __shared__ int16_t prof[];
  const int tile = blockIdx.x, lane = threadIdx.x;
  const Tile query = tile_query(q_mat, qb_mat, q_lens, nq, Lq, qidx[tile]);
  const int b = tile * kLanes + lane;
  const int tj = lj[b];
  const int tn = (tj >= 0 && tj < nt) ? max(0, min(t_lens[tj], Lt)) : 0;
  const uint8_t* t = t_mat + static_cast<size_t>(max(tj, 0)) * Lt;
  uint32_t* col_he = he + static_cast<size_t>(tile) * tq * kLanes + lane;
  uint32_t* col_bnd = bnd + static_cast<size_t>(tile) * Lt * kLanes + lane;
  const uint32_t init = pack_he(0, -go);
  for (int j = 0; j < tn; ++j) col_bnd[static_cast<size_t>(j) * kLanes] = 0;
  int best = 0, qe = Lq - 1, te = -1;
  for (int lo = 0; lo < query.ql; lo += tq) {   // uniform over the block
    const int hi = min(lo + tq, query.ql);
    load_profile_rows(prof, submat, alph, query, lo, hi);
    if (tn == 0) continue;
    const int rows = hi - lo;
    for (int r = 0; r < rows; ++r) col_he[r * kLanes] = init;
    int hb_prev = 0;  // H(lo - 1, j - 1); column -1 is 0
    for (int j = 0; j < tn; ++j) {
      const int16_t* col = prof + t[j];
      uint32_t* bj = col_bnd + static_cast<size_t>(j) * kLanes;
      const uint32_t wb = *bj;
      int hdiag = hb_prev;            // H(i-1, j-1)
      hb_prev = unpack_h(wb);
      int f = unpack_f(wb, go);       // F(i, j), fed from the tile above
      int h = 0;
      for (int r = 0; r < rows; ++r) {
        const uint32_t w = col_he[r * kLanes];
        const int e = unpack_e(w);
        const int g = max(max(hdiag + col[r * alph], e), 0);
        h = min(max(g, f), kScoreCap);
        // an earlier tile's best loses to an equal score at an earlier
        // column (te > j happens only across tiles)
        if (h > best || (h == best && best > 0 && j < te)) {
          best = h; qe = lo + r; te = j;
        }
        col_he[r * kLanes] = pack_he(h, max(e - ge, h - go));
        f = max(g - go, f - ge);
        hdiag = unpack_h(w);
      }
      *bj = pack_hf(h, f, go);        // H(hi-1, j) and F(hi, j)
    }
  }
  best_out[b] = best;
  qend_out[b] = qe;
  tend_out[b] = te;
}

__global__ void __launch_bounds__(kLanes) sw_qm_rt_starts_kernel(
    const int32_t* __restrict__ submat, int alph,
    const uint8_t* __restrict__ q_mat, const int8_t* __restrict__ qb_mat,
    const int32_t* __restrict__ q_lens, int nq, int Lq,
    const uint8_t* __restrict__ t_mat, const int32_t* __restrict__ t_lens,
    int nt, int Lt, const int32_t* __restrict__ qidx,
    const int32_t* __restrict__ lj, const int32_t* __restrict__ q_end,
    const int32_t* __restrict__ t_end, int tq, int go, int ge,
    uint32_t* __restrict__ he, uint32_t* __restrict__ bnd,
    int32_t* __restrict__ score_out, int32_t* __restrict__ qstart_out,
    int32_t* __restrict__ tstart_out) {
  extern __shared__ int16_t prof[];
  const int tile = blockIdx.x, lane = threadIdx.x;
  const Tile query = tile_query(q_mat, qb_mat, q_lens, nq, Lq, qidx[tile]);
  const int b = tile * kLanes + lane;
  const int tj = lj[b];
  const int tn = (tj >= 0 && tj < nt) ? max(0, min(t_lens[tj], Lt)) : 0;
  const uint8_t* t = t_mat + static_cast<size_t>(max(tj, 0)) * Lt;
  uint32_t* col_he = he + static_cast<size_t>(tile) * tq * kLanes + lane;
  uint32_t* col_bnd = bnd + static_cast<size_t>(tile) * Lt * kLanes + lane;
  // rows qe..0 and columns te..0, cut to the real cells; the rows below
  // r0 are H = 0, F = -go (boundary word 0)
  const int r0 = min(q_end[b], query.ql - 1);
  const int c0 = min(t_end[b], tn - 1);
  const uint32_t init = pack_he(0, -go);
  for (int j = 0; j <= c0; ++j) col_bnd[static_cast<size_t>(j) * kLanes] = 0;
  int best = 0, qs = 0, ts = -1;
  const int n_rt = (query.ql + tq - 1) / tq;
  for (int rt = n_rt - 1; rt >= 0; --rt) {   // bottom-up, uniform over the block
    const int lo = rt * tq, hi = min(lo + tq, query.ql);
    load_profile_rows(prof, submat, alph, query, lo, hi);
    const int top = min(hi - 1, r0) - lo;  // this lane's first row, in the tile
    if (top < 0 || c0 < 0) continue;       // qe above the tile: skip its rows
    for (int r = 0; r <= top; ++r) col_he[r * kLanes] = init;
    int hb_prev = 0;  // H(top + 1, j + 1); column c0 + 1 is 0
    for (int j = c0; j >= 0; --j) {
      const int16_t* col = prof + t[j];
      uint32_t* bj = col_bnd + static_cast<size_t>(j) * kLanes;
      const uint32_t wb = *bj;
      int hdiag = hb_prev;            // H(i+1, j+1)
      hb_prev = unpack_h(wb);
      int f = unpack_f(wb, go);       // F(i, j), fed from the tile below
      int h = 0;
      for (int r = top; r >= 0; --r) {
        const uint32_t w = col_he[r * kLanes];
        const int e = unpack_e(w);
        const int g = max(max(hdiag + col[r * alph], e), 0);
        h = min(max(g, f), kScoreCap);
        // a lower tile's best loses to an equal score at a later column
        // (ts < j happens only across tiles)
        if (h > best || (h == best && best > 0 && j > ts)) {
          best = h; qs = lo + r; ts = j;
        }
        col_he[r * kLanes] = pack_he(h, max(e - ge, h - go));
        f = max(g - go, f - ge);
        hdiag = unpack_h(w);
      }
      *bj = pack_hf(h, f, go);        // H(lo, j) and F(lo - 1, j)
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
// 128,) target row per lane; tq: rows per row tile (>= 1); scratch:
// (n_tiles, tq, 128) words; boundary: (n_tiles, Lt, 128) words. Every pointer
// is on the device; the launch goes on `stream` and does not synchronise.
// Returns the error of the attribute call or of the launch (0 on success).
extern "C" int sw_qm_rt_ends(const int32_t* submat, int alph,
                             const uint8_t* q_mat, const int8_t* qb_mat,
                             const int32_t* q_lens, int nq, int Lq,
                             const uint8_t* t_mat, const int32_t* t_lens,
                             int nt, int Lt, const int32_t* qidx,
                             const int32_t* lj, int n_tiles, int tq, int go,
                             int ge, uint32_t* scratch, uint32_t* boundary,
                             int32_t* best, int32_t* q_end, int32_t* t_end,
                             void* stream) {
  if (tq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tq) * alph * sizeof(int16_t);
  int rc = set_smem(reinterpret_cast<const void*>(sw_qm_rt_ends_kernel), smem);
  if (rc != 0) return rc;
  if (n_tiles > 0) {
    sw_qm_rt_ends_kernel<<<n_tiles, kLanes, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        submat, alph, q_mat, qb_mat, q_lens, nq, Lq, t_mat, t_lens, nt, Lt,
        qidx, lj, tq, go, ge, scratch, boundary, best, q_end, t_end);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sw_qm_rt_starts(const int32_t* submat, int alph,
                               const uint8_t* q_mat, const int8_t* qb_mat,
                               const int32_t* q_lens, int nq, int Lq,
                               const uint8_t* t_mat, const int32_t* t_lens,
                               int nt, int Lt, const int32_t* qidx,
                               const int32_t* lj, const int32_t* q_end,
                               const int32_t* t_end, int n_tiles, int tq,
                               int go, int ge, uint32_t* scratch,
                               uint32_t* boundary, int32_t* score,
                               int32_t* q_start, int32_t* t_start,
                               void* stream) {
  if (tq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tq) * alph * sizeof(int16_t);
  int rc = set_smem(reinterpret_cast<const void*>(sw_qm_rt_starts_kernel),
                    smem);
  if (rc != 0) return rc;
  if (n_tiles > 0) {
    sw_qm_rt_starts_kernel<<<n_tiles, kLanes, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        submat, alph, q_mat, qb_mat, q_lens, nq, Lq, t_mat, t_lens, nt, Lt,
        qidx, lj, q_end, t_end, tq, go, ge, scratch, boundary, score,
        q_start, t_start);
  }
  return static_cast<int>(cudaGetLastError());
}
