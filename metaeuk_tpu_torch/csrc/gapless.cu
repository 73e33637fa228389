// Ungapped (gapless) diagonal scoring for NVIDIA Hopper (sm_90a).
//
// The three entry points replace metaeuk_tpu/ops/ungapped.py::_gapless_kernel
// (K7), and with it ungapped.py::_build_S: for each (query, target) pair,
// the best local run over all diagonals,
//   D(i,j) = max(0, D(i-1,j-1) + S(i,j)),   score = max D (floored at 0),
// over rows i < q_len and columns j < t_len, with
// S(i,j) = submat[q_i][t_j] + bias_i taken from a query profile in shared
// memory instead of read from an int8 (Lt, Lq, B) score tensor. D(i,j)
// depends only on D(i-1,j-1), so the recurrence splits by diagonal: a
// thread walks diagonals with its runs in registers and needs no column
// scratch at all; the TPU kernel keeps a (Lq, 128) column of D in VMEM only
// because it streams columns.
//
// gapless_long takes long query rows (a block per pair and 256 diagonals),
// gapless_rows the ungapped prefilter's cross products of short rows, and
// gapless_pair arbitrary pair lists of short rows (the k-mer-index
// prefilter's candidates) on gapless_rows's band walk, one query row a
// thread. All three compute the same function; ops/ungapped_cuda.py picks
// one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlphPad = 32;

}  // namespace

// gapless_long computes K7's function for long query rows (the
// prefilter's buckets from ops/ungapped_cuda.py LONG_ROWS up). At the
// longest (fragments over 4096 aa) a launch holds a few thousand pairs (the
// prefilter sizes it to 2^36 cells), so a thread per pair leaves most SMs
// idle, each thread walks about 1e7 cells one after the other, and each cell
// waits on three byte loads from global memory.
//
// Design: a block of kLongThreads threads per (pair, chunk of kLongThreads
// consecutive diagonals d = j - i), so a launch has hundreds of thousands of
// blocks; thread k owns diagonal d0 + k and walks it with its run and its
// best in registers. The columns go by in tiles of kTileCols. For each tile
// the block stages in shared memory the tile's target codes, as byte offsets
// into the profile, and the query profile of the kTileCols + kLongThreads -
// 1 rows that its diagonals touch there, prof[a][r] = submat[q_r][a] +
// bias_r in int16 (exact: |submat| < 32640 is checked by the wrapper),
// alphabet-major: at one column the lanes of a warp read one offset (a
// broadcast) and 32 consecutive profile entries (no bank conflict). The
// queries are read row-major from the staged (nq, Lq) matrix, where one
// query's rows are contiguous. A cell is one shared load, an add for its
// address, __viaddmax_s32_relu (the run) and a max (the best); four column
// offsets come in one 16-byte load. The run carries from one tile to the
// next in its register. Each thread's loop covers exactly the cells of its
// diagonal, rows < q_len and columns < t_len, so no padding can extend or
// restart a run. The block's maximum goes through __reduce_max_sync and
// shared memory into one atomicMax on the pair's score, which the entry
// point zeroes first on the same stream: scores are >= 0 and max does not
// depend on order, so the result is the same bit for bit however the
// diagonals are split.
//
// What bounds it on an H100: the dispatch of about four instructions a
// cell (two of them on the int32 pipe besides the DPX op) and one shared
// load a cell; staging adds about alph / t_len + alph / kLongThreads profile
// entries a cell.

namespace {

constexpr int kLongThreads = 256;  // diagonals per block, one per thread
constexpr int kTileCols = 512;     // target columns per staged tile

__device__ __forceinline__ void gapless_cell(const char* prof, int off,
                                             int& run, int& best) {
  const int s = *reinterpret_cast<const int16_t*>(prof + off);
  run = __viaddmax_s32_relu(run, s, 0);
  best = max(best, run);
}

__global__ void __launch_bounds__(kLongThreads) gapless_long_kernel(
    const int32_t* __restrict__ submat, int alph,
    const uint8_t* __restrict__ q_mat, const int8_t* __restrict__ qb_mat,
    const int32_t* __restrict__ q_lens, int nq, int Lq,
    const uint8_t* __restrict__ t_mat, const int32_t* __restrict__ t_lens,
    int nt, int Lt, const int32_t* __restrict__ li,
    const int32_t* __restrict__ lj, int chunks, int stride,
    int32_t* __restrict__ best_out) {
  // col_off: kTileCols byte offsets 2 * (t_code * stride + column); prof:
  // (alph, stride) int16, row r - r_base of column block a
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sub_t[kAlphPad * kAlphPad];  // [a][q] = submat[q][a]
  __shared__ int warp_best[kLongThreads / 32];
  int* col_off = reinterpret_cast<int*>(smem);
  int16_t* prof = reinterpret_cast<int16_t*>(smem + kTileCols * sizeof(int));

  const long long b = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int qi = li[b], tj = lj[b];
  if (qi < 0 || qi >= nq || tj < 0 || tj >= nt) return;
  const int m = max(0, min(q_lens[qi], Lq));
  const int n = max(0, min(t_lens[tj], Lt));
  const int d0 = 1 - m + chunk * kLongThreads;  // the block's first diagonal
  if (m == 0 || n == 0 || d0 >= n) return;
  for (int k = threadIdx.x; k < kAlphPad * kAlphPad; k += kLongThreads) {
    const int a = k / kAlphPad, q = k % kAlphPad;
    sub_t[k] = (a < alph && q < alph) ? submat[q * alph + a] : 0;
  }
  const int t = threadIdx.x, d = d0 + t;
  const uint8_t* q_row = q_mat + static_cast<size_t>(qi) * Lq;
  const int8_t* b_row = qb_mat + static_cast<size_t>(qi) * Lq;
  const uint8_t* t_row = t_mat + static_cast<size_t>(tj) * Lt;
  // the block's columns (j >= d0 for i >= 0, j < m + d for i < m) and this
  // thread's; column j of diagonal d is row j - d, profile row
  // (j - c0) + (kLongThreads - 1 - t) of the tile that starts at c0
  const int j_lo = max(0, d0), j_hi = min(n, m + d0 + kLongThreads - 1);
  const int my_lo = max(0, d), my_hi = min(n, m + d);
  const char* my_prof =
      reinterpret_cast<const char*>(prof + (kLongThreads - 1 - t));
  int run = 0, best = 0;
  for (int c0 = j_lo; c0 < j_hi; c0 += kTileCols) {
    const int c1 = min(c0 + kTileCols, j_hi);
    const int r_base = c0 - d0 - (kLongThreads - 1);
    __syncthreads();  // sub_t is written and the last tile is read
    for (int c = t; c < c1 - c0; c += kLongThreads)
      col_off[c] = 2 * (t_row[c0 + c] * stride + c);
    const int r_hi = min(m, c1 - d0);
    for (int r = max(0, r_base) + t; r < r_hi; r += kLongThreads) {
      const int q = q_row[r], bias = b_row[r];
      int16_t* p = prof + (r - r_base);
      for (int a = 0; a < alph; ++a)
        p[a * stride] = static_cast<int16_t>(sub_t[a * kAlphPad + q] + bias);
    }
    __syncthreads();
    int c = max(my_lo, c0) - c0;
    const int ce = min(my_hi, c1) - c0;
    for (; c < ce && (c & 3); ++c)
      gapless_cell(my_prof, col_off[c], run, best);
    for (; c + 4 <= ce; c += 4) {
      const int4 o = *reinterpret_cast<const int4*>(col_off + c);
      gapless_cell(my_prof, o.x, run, best);
      gapless_cell(my_prof, o.y, run, best);
      gapless_cell(my_prof, o.z, run, best);
      gapless_cell(my_prof, o.w, run, best);
    }
    for (; c < ce; ++c) gapless_cell(my_prof, col_off[c], run, best);
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if ((t & 31) == 0) warp_best[t >> 5] = best;
  __syncthreads();
  if (t == 0) {
    int v = 0;
    for (int w = 0; w < kLongThreads / 32; ++w) v = max(v, warp_best[w]);
    if (v > 0) atomicMax(best_out + b, v);
  }
}

}  // namespace

// q_mat, qb_mat: (nq, Lq) staged query codes and biases and t_mat: (nt, Lt)
// staged target codes, row-major; q_lens, t_lens: their lengths; li, lj: (B,)
// row indices of each pair (a pair with an index out of range scores 0).
// Every pointer is on the device. Zeroes best on `stream`, then launches
// B * ceil((Lq + Lt - 1) / kLongThreads) blocks there; does not
// synchronise. Returns cudaGetLastError(), or cudaErrorInvalidValue when
// the grid would pass 2^31 - 1 blocks.
extern "C" int gapless_long(const int32_t* submat, int alph,
                            const uint8_t* q_mat, const int8_t* qb_mat,
                            const int32_t* q_lens, int nq, int Lq,
                            const uint8_t* t_mat, const int32_t* t_lens,
                            int nt, int Lt, const int32_t* li,
                            const int32_t* lj, long long B, int32_t* best,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaMemsetAsync(best, 0, static_cast<size_t>(B) * sizeof(int32_t), st);
  const int chunks = (Lq + Lt - 1 + kLongThreads - 1) / kLongThreads;
  const long long blocks = B * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    const int stride = min(kTileCols, Lt) + kLongThreads - 1;
    const size_t shmem = kTileCols * sizeof(int) +
                         static_cast<size_t>(alph) * stride * sizeof(int16_t);
    cudaFuncSetAttribute(gapless_long_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(shmem));
    gapless_long_kernel<<<static_cast<unsigned int>(blocks), kLongThreads,
                          shmem, st>>>(submat, alph, q_mat, qb_mat, q_lens,
                                       nq, Lq, t_mat, t_lens, nt, Lt, li, lj,
                                       chunks, stride, best);
  }
  return static_cast<int>(cudaGetLastError());
}

// gapless_rows computes K7's function on the ungapped prefilter's launches,
// which are cross products: staged query rows r0 .. r0 + rows - 1 against
// every staged target of a bucket (12 to 1,687 targets on the slices of
// PERF.md, tens of thousands on a Swiss-Prot-sized DB), for query widths
// below ops/ungapped_cuda.py LONG_ROWS (fragments up to 512 aa). A thread
// per pair that reads its codes from device memory pays three byte loads a
// cell; a block per pair (gapless_long) restages a 21-row query profile for
// pairs of only 32 x 64 cells.
//
// Design: a thread scores one target against a pair of query rows, which
// share the walk's target codes, addresses and shared loads. The wrapper
// (ungapped_cuda.row_pairs) sorts the launch's rows by length on the device
// and pairs neighbours, so the two lengths of a pair differ little; an odd
// count leaves the longest row with an absent partner (-1), which scores 0
// and is not written. A block takes a group of R pairs and a tile of T
// targets, a thread per (pair, target). It stages each pair's profile once
// in shared memory, interleaved: word prof[i][a] holds submat[q_i][a] +
// bias_i of the pair's first row in its low half and of its second row in
// its high half, each in int16 (exact: the wrapper checks |submat| <
// 32640), row-major with SA words a row: the lanes of a pair stand at the
// same row i of different targets, so they read one window of at most 128
// bytes, which is conflict-free. T is a multiple of 32 up to 128 or, for
// fewer than 32 targets, a power of two from 8 (32 / T pairs share a warp),
// and R fills the block, cut so that the profiles stay near kRowsProfBytes
// and several blocks share an SM. Each thread writes its two scores to
// their rows' places in the input order: no atomics, no scratch.
//
// A thread walks its target in bands of kBand = 4 consecutive diagonals d0
// .. d0 + 3 (d0 a multiple of 4), row by row (pair_bands): at row i the
// band's cells are columns i + d0 .. i + d0 + 3, so four rows of a band
// take seven target columns, one new 32-bit word of four codes, and the
// four runs are independent chains. The target codes come packed four to a
// word, transposed and sorted by length by the wrapper: word (c, s) holds
// columns 4c - 8 .. 4c - 5 of the s-th longest target, so the lanes of a
// pair (the same i and d0, consecutive s) read one 128-byte line, and their
// loops end at nearly the same row. Columns < 0 and >= t_len hold the code
// alph, whose entry is 0 in both halves, and so does every row of a query
// from its q_len on (to Lq + 3). So the walk covers the longer row of the
// pair, every band starts on a word and runs whole groups of four rows with
// no bounds inside: a score of 0 (or less) is exact there, because such
// cells lie before a diagonal's first cell, where the run is 0 and stays 0,
// or after its last, where the run can only stay or fall and so never
// passes the best it already counted; no run restarts after them.
//
// The pair's two runs of a diagonal advance in one packed 16 x 2 op,
// __viaddmax_s16x2_relu, and the bests in __vimax3_s16x2, wherever 16 bits
// hold: a run is a sum of consecutive entries of its diagonal, one a row,
// so it never passes U = the sum over rows i < q_len of max(0, max_a
// S(i, a)). The block adds up each row's U while it stages the row, and a
// pair takes the packed loop when both rows' U are at most 32767: no lane
// then passes 32767, and a run (>= 0) plus an entry (>= -32768) stays above
// -32768 before the relu, so every lane holds the int32 recurrence's value.
// Any other pair walks the same bands with each run in an int32 (Wide32),
// exact at any score. The tile-0 block of a group adds its rows of each
// kind to row_counts (ops/ungapped_cuda.py ROW_LANES).
//
// A group of four rows is a word load, seven byte extracts and address
// adds, 16 shared loads, 16 packed add-max and eight packed max-of-three
// ops for 32 cells: under two instructions and half a shared load a cell,
// where one row a thread took four instructions and a load. The loop runs
// two groups a trip, so that two groups' word loads are in flight at once:
// 1.1-1.6x over one group a trip at Lq 32-512 on an H100 (PERF.md §6),
// where a word loaded a group ahead or 256 threads a block gained nothing.
//
// What bounds it on an H100: the dispatch of those instructions and, a
// step behind, the shared loads (32 a clock an SM serves, at half a load a
// cell); device memory traffic is an eighth of a byte a cell, mostly from
// L1 and L2. It runs at 7-8e12 cells/s on the prefilter's buckets, about
// half the issue bound: with a pair's profile twice a row's bytes, fewer
// warps share an SM to hide the loads' latency (most at Lq 256-512). A
// pair past 16 bits runs twice the DPX ops of a packed one.

namespace {

constexpr int kRowsThreads = 128;          // threads a block at most
constexpr int kRowsProfBytes = 32 * 1024;  // profile bytes a block aims at
constexpr int kBand = 4;                   // diagonals a thread walks at once
constexpr int kLeadCols = 8;               // sentinel columns before column 0
constexpr int kPadRows = 4;                // zero profile rows past Lq
constexpr int kMinTile = 8;                // targets a pair at least
constexpr int kPackedMax = 32767;          // the most a 16-bit lane holds
constexpr size_t kRowsProfBytesMax = 200 * 1024;  // profiles a block at most

__device__ __forceinline__ void fill_sub(int* sub_s, const int32_t* submat,
                                         int alph) {
  for (int k = threadIdx.x; k < kAlphPad * kAlphPad; k += blockDim.x) {
    const int r = k / kAlphPad, c = k % kAlphPad;
    sub_s[k] = (r < alph && c < alph) ? submat[r * alph + c] : 0;
  }
}

// Row i of a query profile: p[a] = submat[q_i][a] + bias_i for a < alph and
// p[alph] = 0 (the code of no column) while i < m, all zero from m on.
__device__ __forceinline__ void profile_row(int16_t* p, const int* sub_s,
                                            const uint8_t* q_row,
                                            const int8_t* b_row, int m, int i,
                                            int alph) {
  if (i < m) {
    const int* s = sub_s + q_row[i] * kAlphPad;
    const int bias = b_row[i];
    for (int a = 0; a < alph; ++a) p[a] = static_cast<int16_t>(s[a] + bias);
    p[alph] = 0;
  } else {
    for (int a = 0; a <= alph; ++a) p[a] = 0;
  }
}

// The best gapless run of a query of m rows, whose profile P has SA entries
// a row and at least m + kPadRows rows (zero from m on), against the target
// of n columns whose packed words start at W with stride ws (column c of
// word row c of the words' matrix; sentinel code alph left of column 0 and
// from n on), over the bands part, part + split, part + 2 * split, ... of
// its bands of kBand diagonals (all of them with the defaults).
template <int SA>
__device__ __forceinline__ int gapless_bands(const int16_t* P,
                                             const uint32_t* W, size_t ws,
                                             int m, int n, int part = 0,
                                             int split = 1) {
  int best = 0;
  // bands of diagonals d = j - i from the bottom-left corner; d0 = 1 - m
  // rounded down to a multiple of 4 (diagonals below 1 - m hold no cell)
  for (int d0 = m > 0 ? ((1 - m) & ~(kBand - 1)) + kBand * part : n; d0 < n;
       d0 += kBand * split) {
    // the first row whose word starts at column i + d0 (one row early when
    // d0 < 0: its cells lie left of column 0), and the row past which
    // every column of the band is >= n
    int i = max(0, -(d0 + kBand));
    const int i_end = min(m, n - d0);
    const int16_t* p = P + i * SA;
    const uint32_t* wp = W + ((i + d0 + kLeadCols) >> 2) * ws;
    uint32_t A = __ldg(wp);
    int x0 = 0, x1 = 0, x2 = 0, x3 = 0;
    for (; i < i_end; i += 4, p += 4 * SA) {
      wp += ws;
      const uint32_t B = __ldg(wp);
      // columns i + d0 + b, b = 0 .. 6, as profile rows of row i
      const int16_t* c0 = p + (A & 0xffu);
      const int16_t* c1 = p + ((A >> 8) & 0xffu);
      const int16_t* c2 = p + ((A >> 16) & 0xffu);
      const int16_t* c3 = p + (A >> 24);
      const int16_t* c4 = p + (B & 0xffu);
      const int16_t* c5 = p + ((B >> 8) & 0xffu);
      const int16_t* c6 = p + ((B >> 16) & 0xffu);
      // row i + r meets diagonal d0 + k at column b = r + k
      x0 = __viaddmax_s32_relu(x0, c0[0], 0);
      x1 = __viaddmax_s32_relu(x1, c1[0], 0);
      x2 = __viaddmax_s32_relu(x2, c2[0], 0);
      x3 = __viaddmax_s32_relu(x3, c3[0], 0);
      best = __vimax3_s32(best, x0, x1);
      best = __vimax3_s32(best, x2, x3);
      x0 = __viaddmax_s32_relu(x0, c1[SA], 0);
      x1 = __viaddmax_s32_relu(x1, c2[SA], 0);
      x2 = __viaddmax_s32_relu(x2, c3[SA], 0);
      x3 = __viaddmax_s32_relu(x3, c4[SA], 0);
      best = __vimax3_s32(best, x0, x1);
      best = __vimax3_s32(best, x2, x3);
      x0 = __viaddmax_s32_relu(x0, c2[2 * SA], 0);
      x1 = __viaddmax_s32_relu(x1, c3[2 * SA], 0);
      x2 = __viaddmax_s32_relu(x2, c4[2 * SA], 0);
      x3 = __viaddmax_s32_relu(x3, c5[2 * SA], 0);
      best = __vimax3_s32(best, x0, x1);
      best = __vimax3_s32(best, x2, x3);
      x0 = __viaddmax_s32_relu(x0, c3[3 * SA], 0);
      x1 = __viaddmax_s32_relu(x1, c4[3 * SA], 0);
      x2 = __viaddmax_s32_relu(x2, c5[3 * SA], 0);
      x3 = __viaddmax_s32_relu(x3, c6[3 * SA], 0);
      best = __vimax3_s32(best, x0, x1);
      best = __vimax3_s32(best, x2, x3);
      A = B;
    }
  }
  return best;
}

// The runs of a pair of query rows on one diagonal, advanced by the pair's
// interleaved profile word s (the first row's entry in the low half, the
// second's in the high half). Packed16 keeps both in the halves of one word
// (s16x2 DPX: exact while no run passes kPackedMax), Wide32 each in an
// int32 (exact at any score).
struct Packed16 {
  uint32_t v = 0;
  __device__ __forceinline__ void add(uint32_t s) {
    v = __viaddmax_s16x2_relu(v, s, 0u);
  }
  __device__ __forceinline__ void keep(const Packed16& x, const Packed16& y) {
    v = __vimax3_s16x2(v, x.v, y.v);
  }
  __device__ __forceinline__ int first() const {
    return static_cast<int>(v & 0xffffu);
  }
  __device__ __forceinline__ int second() const {
    return static_cast<int>(v >> 16);
  }
};

struct Wide32 {
  int a = 0, b = 0;
  __device__ __forceinline__ void add(uint32_t s) {
    a = __viaddmax_s32_relu(a, static_cast<int16_t>(s & 0xffffu), 0);
    b = __viaddmax_s32_relu(b, static_cast<int>(s) >> 16, 0);
  }
  __device__ __forceinline__ void keep(const Wide32& x, const Wide32& y) {
    a = __vimax3_s32(a, x.a, y.a);
    b = __vimax3_s32(b, x.b, y.b);
  }
  __device__ __forceinline__ int first() const { return a; }
  __device__ __forceinline__ int second() const { return b; }
};

// The best gapless runs of a pair of query rows, the longer of m rows,
// whose interleaved profile P has SA words a row and at least m + kPadRows
// rows (zero from each row's length on), against the target of n columns
// whose packed words start at W with stride ws (as gapless_bands reads
// them), over every band of kBand diagonals. The maxima go in two chains,
// one for diagonals d0 and d0 + 1 and one for d0 + 2 and d0 + 3, merged at
// the end.
template <int SA, class Runs>
__device__ __forceinline__ Runs pair_bands(const uint32_t* P,
                                           const uint32_t* W, size_t ws,
                                           int m, int n) {
  Runs best, best2;
  for (int d0 = m > 0 ? ((1 - m) & ~(kBand - 1)) : n; d0 < n; d0 += kBand) {
    int i = max(0, -(d0 + kBand));
    const int i_end = min(m, n - d0);
    const uint32_t* p = P + i * SA;
    const uint32_t* wp = W + ((i + d0 + kLeadCols) >> 2) * ws;
    uint32_t A = __ldg(wp);
    Runs x0, x1, x2, x3;
#pragma unroll 2
    for (; i < i_end; i += 4, p += 4 * SA) {
      wp += ws;
      const uint32_t B = __ldg(wp);
      // columns i + d0 + b, b = 0 .. 6, as profile rows of row i
      const uint32_t* c0 = p + (A & 0xffu);
      const uint32_t* c1 = p + ((A >> 8) & 0xffu);
      const uint32_t* c2 = p + ((A >> 16) & 0xffu);
      const uint32_t* c3 = p + (A >> 24);
      const uint32_t* c4 = p + (B & 0xffu);
      const uint32_t* c5 = p + ((B >> 8) & 0xffu);
      const uint32_t* c6 = p + ((B >> 16) & 0xffu);
      // row i + r meets diagonal d0 + k at column b = r + k
      x0.add(c0[0]);
      x1.add(c1[0]);
      x2.add(c2[0]);
      x3.add(c3[0]);
      best.keep(x0, x1);
      best2.keep(x2, x3);
      x0.add(c1[SA]);
      x1.add(c2[SA]);
      x2.add(c3[SA]);
      x3.add(c4[SA]);
      best.keep(x0, x1);
      best2.keep(x2, x3);
      x0.add(c2[2 * SA]);
      x1.add(c3[2 * SA]);
      x2.add(c4[2 * SA]);
      x3.add(c5[2 * SA]);
      best.keep(x0, x1);
      best2.keep(x2, x3);
      x0.add(c3[3 * SA]);
      x1.add(c4[3 * SA]);
      x2.add(c5[3 * SA]);
      x3.add(c6[3 * SA]);
      best.keep(x0, x1);
      best2.keep(x2, x3);
      A = B;
    }
  }
  best.keep(best2, best2);
  return best;
}

template <int SA>
__global__ void __launch_bounds__(kRowsThreads) gapless_rows_kernel(
    const int32_t* __restrict__ submat, int alph,
    const uint8_t* __restrict__ q_mat, const int8_t* __restrict__ qb_mat,
    const int32_t* __restrict__ q_lens, int Lq,
    const uint32_t* __restrict__ t_words, const int32_t* __restrict__ t_lens,
    const int32_t* __restrict__ order, int nt, int Lt, int r0,
    const int32_t* __restrict__ pair_rows, int pairs, int T, int R,
    int tiles, int32_t* __restrict__ best_out,
    unsigned long long* __restrict__ row_counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sub_s[kAlphPad * kAlphPad];
  __shared__ int sub_max[kAlphPad];  // max_a submat[q][a] (0 past alph)
  __shared__ int bound[2 * (kRowsThreads / kMinTile)];  // U of each row
  uint32_t* prof = reinterpret_cast<uint32_t*>(smem);  // [R][Lq + 4][SA]
  const int PR = Lq + kPadRows;
  const int group = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int t = threadIdx.x, nthr = blockDim.x;
  fill_sub(sub_s, submat, alph);
  for (int q = t; q < kAlphPad; q += nthr) {
    int mx = 0;
    if (q < alph) {
      mx = submat[q * alph];
      for (int a = 1; a < alph; ++a) mx = max(mx, submat[q * alph + a]);
    }
    sub_max[q] = mx;
  }
  for (int k = t; k < 2 * R; k += nthr) bound[k] = 0;
  __syncthreads();
  // row kAlphPad - 1 of sub_s is all zero (alph < kAlphPad): the entries of
  // an absent row and of the rows from a query's length on
  const int* zero = sub_s + (kAlphPad - 1) * kAlphPad;
  for (int e = t; e < R * PR; e += nthr) {
    const int rr = e / PR, i = e - rr * PR, p = group * R + rr;
    if (p >= pairs) continue;
    const int* s[2];
    int bias[2];
    for (int h = 0; h < 2; ++h) {
      const int row = pair_rows[2 * p + h];
      s[h] = zero;
      bias[h] = 0;
      if (row >= 0 && i < min(q_lens[r0 + row], Lq)) {
        const size_t at = static_cast<size_t>(r0 + row) * Lq + i;
        const int q = q_mat[at];
        s[h] = sub_s + q * kAlphPad;
        bias[h] = qb_mat[at];
        atomicAdd(&bound[2 * rr + h], max(0, sub_max[q] + bias[h]));
      }
    }
    uint32_t* w = prof + static_cast<size_t>(e) * SA;
    for (int a = 0; a < alph; ++a)
      w[a] = (static_cast<uint32_t>(s[0][a] + bias[0]) & 0xffffu) |
             (static_cast<uint32_t>(s[1][a] + bias[1]) << 16);
    w[alph] = 0;
  }
  __syncthreads();

  if (tile == 0 && t == 0) {
    unsigned long long packed = 0, wide = 0;
    for (int k = 0; k < R && group * R + k < pairs; ++k) {
      const int n_rows = 1 + (pair_rows[2 * (group * R + k) + 1] >= 0);
      if (max(bound[2 * k], bound[2 * k + 1]) <= kPackedMax)
        packed += n_rows;
      else
        wide += n_rows;
    }
    if (packed) atomicAdd(row_counts, packed);
    if (wide) atomicAdd(row_counts + 1, wide);
  }
  const int rr = t / T, slot = tile * T + (t - rr * T);
  const int p = group * R + rr;
  if (p >= pairs || slot >= nt) return;
  const int ra = pair_rows[2 * p], rb = pair_rows[2 * p + 1];
  const int ma = ra < 0 ? 0 : max(0, min(q_lens[r0 + ra], Lq));
  const int mb = rb < 0 ? 0 : max(0, min(q_lens[r0 + rb], Lq));
  const int tj = order[slot];
  const int n = max(0, min(t_lens[tj], Lt));
  const uint32_t* P = prof + static_cast<size_t>(rr) * PR * SA;
  const size_t ws = static_cast<size_t>(nt);
  int sa, sb;
  if (max(bound[2 * rr], bound[2 * rr + 1]) <= kPackedMax) {
    const Packed16 b =
        pair_bands<SA, Packed16>(P, t_words + slot, ws, max(ma, mb), n);
    sa = b.first();
    sb = b.second();
  } else {
    const Wide32 b =
        pair_bands<SA, Wide32>(P, t_words + slot, ws, max(ma, mb), n);
    sa = b.first();
    sb = b.second();
  }
  if (ra >= 0) best_out[static_cast<size_t>(ra) * nt + tj] = sa;
  if (rb >= 0) best_out[static_cast<size_t>(rb) * nt + tj] = sb;
}

}  // namespace

// q_mat, qb_mat: (nq, Lq) staged query codes and biases, row-major;
// t_words: (ceil(Lt / 4) + 4, nt) words, word (c, s) = the codes of columns
// 4c - 8 .. 4c - 5 of target order[s] (little-endian), alph for a column
// < 0 or >= its length; t_lens: (nt,) target lengths; order: (nt,) target
// indices, longest first; pair_rows: (2 * ceil(rows / 2),) the query rows
// as offsets from r0, two a pair, each of 0 .. rows - 1 once and -1 for an
// absent row. Writes best (rows, nt), best[r][k] = the score of query row
// r0 + r against target k, and adds the rows scored in packed lanes and in
// int32 to row_counts[0] and row_counts[1], on `stream`; does not
// synchronise. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// rows outside [0, nq), more than 31 classes, a pair's profile past
// kRowsProfBytesMax or a grid past 2^31 - 1 blocks.
extern "C" int gapless_rows(const int32_t* submat, int alph,
                            const uint8_t* q_mat, const int8_t* qb_mat,
                            const int32_t* q_lens, int nq, int Lq,
                            const uint32_t* t_words, const int32_t* t_lens,
                            int nt, int Lt, const int32_t* order, int r0,
                            int rows, const int32_t* pair_rows, int32_t* best,
                            unsigned long long* row_counts, void* stream) {
  if (rows <= 0 || nt <= 0) return static_cast<int>(cudaGetLastError());
  if (r0 < 0 || r0 + rows > nq || alph >= kAlphPad || Lq < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pairs = (rows + 1) / 2;
  const int sa = alph < 22 ? 22 : kAlphPad;  // alph + 1 entries a row
  const size_t pair_bytes =
      static_cast<size_t>(Lq + kPadRows) * sa * sizeof(uint32_t);
  // pairs whose profiles fit the block's budget; T targets a pair: a power
  // of two from 8 below 32 targets (32 / T pairs share a warp, if that many
  // profiles fit), else a multiple of 32 up to kRowsThreads
  const size_t fit_pairs = kRowsProfBytes / pair_bytes;
  const int fit = fit_pairs > 0 ? static_cast<int>(fit_pairs) : 1;
  int T = kMinTile;
  while (T < nt && T < 32) T *= 2;
  while (T < 32 && 32 / T > fit) T *= 2;
  if (T == 32) T = min(kRowsThreads, (nt + 31) / 32 * 32);
  const int per_warp = max(1, 32 / T);
  const int R = max(per_warp,
                    min(kRowsThreads / T, fit) / per_warp * per_warp);
  const int tiles = (nt + T - 1) / T;
  const long long blocks =
      static_cast<long long>((pairs + R - 1) / R) * tiles;
  const size_t shmem = R * pair_bytes;
  if (blocks > 0x7fffffffLL || shmem > kRowsProfBytesMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = sa == 22 ? gapless_rows_kernel<22>
                         : gapless_rows_kernel<kAlphPad>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(shmem));
  kernel<<<static_cast<unsigned int>(blocks), R * T, shmem, st>>>(
      submat, alph, q_mat, qb_mat, q_lens, Lq, t_words, t_lens, order, nt,
      Lt, r0, pair_rows, pairs, T, R, tiles, best, row_counts);
  return static_cast<int>(cudaGetLastError());
}

// gapless_pair computes K7's function on arbitrary pair lists (li, lj): in
// any order, with repeats, and with indices out of range, which score 0.
// Its caller is the k-mer-index prefilter (search/kmer_prefilter.py), whose
// candidates come grouped by query, a few targets each. A thread per pair
// that walks its cells one diagonal at a time pays about five int32
// operations and three byte loads a cell (the query code, the bias, the
// target code) and rebuilds S(i,j) at every cell.
//
// Design: gapless_rows's band walk, one query row a thread in int32
// (gapless_bands), on a work list. The wrapper (ops/ungapped_cuda.py
// pair_plan) sorts the pairs stably by query and,
// within a query, by the rank of the target in the packed words (longest
// first), on the device and with no host sync, and cuts each query's run
// into groups of at most c pairs. Each pair takes `split` consecutive
// threads and a group g = c * split; group k of a block of kPairThreads
// threads is threads k * g .. k * g + g - 1, so a block holds Q =
// kPairThreads / g groups, from one query with many pairs or from Q
// queries with a few each (ungapped_cuda.pair_layout: c follows the pairs
// a query has, g is large enough that Q profiles fit the block's budget).
// Each group stages its query's profile once in shared memory, as
// gapless_rows stages a pair's, and each pair is walked with gapless_bands
// over the words of every staged target: the threads of a group stand at
// the same rows of targets of similar length, and for a query's run over
// consecutive targets they read consecutive words. A launch of many pairs
// (split 1) gives a thread a pair; a launch of a few hundred pairs, the
// k-mer prefilter's buckets, would leave the card
// to a few warps that walk 10^5 cells each one after the other, so its
// pairs' bands are dealt round-robin over up to 32 threads (split, a power
// of two), whose bests meet in a warp shuffle. The first thread of a pair
// writes its score to the pair's place in the input order (best[perm[pos]]):
// the pairs a block takes are distinct positions of the sort, so no atomics
// are needed; the wrapper zeroes best, which leaves 0 for the pairs out of
// range.
//
// What bounds it on an H100: the dispatch of under four instructions a
// cell, two to three of them on the int32 pipe, when a launch fills the
// card; the sort and the plan are a few passes over the
// (B,) pair list. A small launch waits on the latency of its threads'
// band loops.

namespace {

constexpr int kPairThreads = 128;  // threads a block

template <int SA>
__global__ void __launch_bounds__(kPairThreads) gapless_pair_kernel(
    const int32_t* __restrict__ submat, int alph,
    const uint8_t* __restrict__ q_mat, const int8_t* __restrict__ qb_mat,
    const int32_t* __restrict__ q_lens, int Lq,
    const uint32_t* __restrict__ t_words, const int32_t* __restrict__ t_lens,
    const int32_t* __restrict__ rank, int nt, int Lt,
    const int32_t* __restrict__ lj, const int64_t* __restrict__ perm,
    const int32_t* __restrict__ grp_q, const int64_t* __restrict__ grp_p0,
    const int32_t* __restrict__ grp_n, int n_groups, int c, int split,
    int32_t* __restrict__ best_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sub_s[kAlphPad * kAlphPad];
  int16_t* prof = reinterpret_cast<int16_t*>(smem);  // [Q][Lq + 4][SA]
  const int g = c * split, PR = Lq + kPadRows, Q = kPairThreads / g;
  const long long g0 = static_cast<long long>(blockIdx.x) * Q;
  const int t = threadIdx.x;
  fill_sub(sub_s, submat, alph);
  __syncthreads();
  for (int e = t; e < Q * PR; e += kPairThreads) {
    const int k = e / PR, i = e - k * PR;
    const long long G = g0 + k;
    if (G >= n_groups || grp_n[G] == 0) continue;
    const int qi = grp_q[G];
    const size_t at = static_cast<size_t>(qi) * Lq;
    profile_row(prof + static_cast<size_t>(e) * SA, sub_s, q_mat + at,
                qb_mat + at, min(q_lens[qi], Lq), i, alph);
  }
  __syncthreads();

  // thread t: group k, its pair `slot`, and `part` of that pair's bands;
  // every thread reaches the shuffles (a split pair's threads share a warp)
  const int k = t / g, lane = t - k * g, slot = lane / split;
  const int part = lane - slot * split;
  const long long G = g0 + k;
  const bool live = G < n_groups && slot < grp_n[G];
  long long b = 0;
  int best = 0;
  if (live) {
    b = perm[grp_p0[G] + slot];
    const int qi = grp_q[G], tj = lj[b];
    const int m = max(0, min(q_lens[qi], Lq));
    const int n = max(0, min(t_lens[tj], Lt));
    best = gapless_bands<SA>(prof + static_cast<size_t>(k) * PR * SA,
                             t_words + rank[tj], static_cast<size_t>(nt), m,
                             n, part, split);
  }
  for (int off = split / 2; off > 0; off /= 2)
    best = max(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (live && part == 0) best_out[b] = best;
}

}  // namespace

// q_mat, qb_mat: (nq, Lq) staged query codes and biases, row-major; t_words
// and t_lens as gapless_rows's, over all nt staged targets; rank: (nt,) the
// word column of each target; lj: (B,) the pairs' target indices; perm:
// the sort's pair indices, query by query; group G (of n_groups) holds the
// grp_n[G] <= c pairs perm[grp_p0[G] ..] of query grp_q[G] (grp_n 0: an
// empty group), each pair on `split` threads. Indices are in range; best
// must hold zeros. Launches ceil(n_groups / (kPairThreads / (c * split)))
// blocks on `stream`; does not synchronise. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a split that is not a power of two up to 32, a
// c * split that does not divide kPairThreads, more than 31 classes,
// profiles past kPairProfBytesMax or a grid past 2^31 - 1 blocks.
extern "C" int gapless_pair(const int32_t* submat, int alph,
                            const uint8_t* q_mat, const int8_t* qb_mat,
                            const int32_t* q_lens, int nq, int Lq,
                            const uint32_t* t_words, const int32_t* t_lens,
                            const int32_t* rank, int nt, int Lt,
                            const int32_t* lj, const int64_t* perm,
                            const int32_t* grp_q, const int64_t* grp_p0,
                            const int32_t* grp_n, int n_groups, int c,
                            int split, int32_t* best, void* stream) {
  constexpr size_t kPairProfBytesMax = 200 * 1024;
  if (n_groups <= 0 || nq <= 0 || nt <= 0)
    return static_cast<int>(cudaGetLastError());
  const int g = c * split;
  if (split <= 0 || split > 32 || (split & (split - 1)) != 0 || c <= 0 ||
      g > kPairThreads || kPairThreads % g != 0 || alph >= kAlphPad || Lq < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Q = kPairThreads / g;
  const int sa = alph < 22 ? 22 : kAlphPad;  // alph + 1 entries a row
  const size_t shmem = static_cast<size_t>(Q) * (Lq + kPadRows) * sa *
                       sizeof(int16_t);
  const long long blocks = (static_cast<long long>(n_groups) + Q - 1) / Q;
  if (shmem > kPairProfBytesMax || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = sa == 22 ? gapless_pair_kernel<22>
                         : gapless_pair_kernel<kAlphPad>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(shmem));
  kernel<<<static_cast<unsigned int>(blocks), kPairThreads, shmem, st>>>(
      submat, alph, q_mat, qb_mat, q_lens, Lq, t_words, t_lens, rank, nt, Lt,
      lj, perm, grp_q, grp_p0, grp_n, n_groups, c, split, best);
  return static_cast<int>(cudaGetLastError());
}
