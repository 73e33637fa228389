// Query-major SW recurrence variants for NVIDIA Hopper (sm_90a).
//
// qm_variant_ends replaces tools/kernel_variants.py::make_kernel (T4): K3's
// forward ends (best, q_end, t_end per lane) of one query profile against
// the 128 target lanes of a tile, in five variants:
//   base        H in [0, 32767], packed tie-break Hn * 65536 + (65535 - j)
//   fold        H' = H + i*ge and E' = E + i*ge carried; the profile comes
//               shifted by +GE (as run_variant builds it); the cap is
//               32767 + i*ge; packing 32768
//   nocap       base without the cap, packing 32768
//   fold_nocap  fold without the cap
//   nof         base without the F recurrence (no vertical gaps; inexact)
// Each returns what the Pallas variant returns, the inexact ones included
// (fold_nocap while its H' stays below 65536, where H' * 32768 is still an
// int32, as for the Pallas kernel's packed word).
//
// Design: K3's (csrc/sw_qm.cu on csrc/sw_group.cuh), so that the variants
// measure the kernel the main path runs. A group of G threads aligns one
// lane; thread k of the group holds rows k R .. k R + R - 1 of a stripe of
// G R rows in registers (H of the previous column and E of each) and works
// on visited step s at loop step s + k, receiving the row above's H and F
// from thread k - 1 in one shuffle per R cells. The class (G, R) is the
// first of sw_cuda.PAIR_CLASSES whose G R rows cover Lq: (4, 8), (8, 8),
// (16, 8), (16, 16); above 256 rows a warp per lane (32, 16) sweeps stripes
// of 512 rows, thread 31 handing each column's word to thread 0 of the
// next stripe through a per-lane array of words (read 32 columns at a time,
// 32 steps ahead, written in place). The wrapper picks the class
// (qm_variants_cuda.launch_plan) and there is one launch: every lane of
// every tile has the same Lq and the same visited columns. A block of 128
// threads aligns 4 (32 / G) lanes of one tile and stages the tile's profile
// once, as int16 (the cap cases' scores do not fit int8; the bf16 input
// holds integers, so the conversion is exact), class-major: class a's row
// holds the stripe's G R rows, thread k's R scores as one (R 8) or two (R
// 16) 16-byte parts, part p of every thread of the group after part p - 1,
// so that a thread reads a column's scores with one or two 16-byte shared
// loads and the eight threads of a quarter-warp read 128 contiguous bytes.
// Where a class row is shorter than 128 bytes ((4, 8)) it is repeated and
// the groups of a warp alternate between the copies. Class 32 holds 0 (a
// code outside 0..31, whose one-hot column is empty on the TPU); a row past
// Lq scores -32768. There is no H/E scratch in device memory.
//
// The knobs. Only the columns the Pallas grid visits are visited, one after
// the other as if adjacent: with TJ = min(tj, Lt) and per = (TJ / u) * u,
// visited step s is column j = (s / per) TJ + s % per, for s below (Lt /
// TJ) per. tj sets the codes a group stages per load of its ring in shared
// memory: the per visited columns of one Pallas chunk, or of as many chunks
// as make 64 steps (the ring holds two loads, a power of two of bytes; a
// load is staged 32 steps into the one before, once every thread is past
// the load it replaces). u is the compile-time unroll of the loop over
// steps (1, 2, 4, 8 or 16), whose body carries no branch but the step's own
// range check and the rare best-cell update.
//
// The recurrences, each cell a few DPX add-max (E and F carried as E + go
// and F + go where the variant's form allows it):
//   base, nocap  g = max(Hdiag + s, E, 0), h = max(g, F) (base: min 32767),
//                E' = max(E - ge, h - go), F' = max(F - ge, g - go): the
//                Pallas in-column cummax of G + i*ge as a recurrence
//   fold         g' = max(H'diag + s', E', i*ge), h' = max(g', f + ge - go)
//                (fold: min 32767 + i*ge), f = running max of g' down the
//                column, E'' = max(E' - ge, h' - go); H' of row -1 is -ge
//   nof          h = min(max(Hdiag + s, E, 0), 32767), no F
// The hand-off word is HandOff<false> (16-bit H and F + go) for base and
// nof, HandOff<true> (32 bits each) for the others, whose H or f leave 16
// bits.
//
// The best cell. The packed word hu * div + (div - 1 - j) (hu the unfolded
// H, an unsigned product cast to int32) orders cells; equal words go to the
// smallest row. A thread takes each column's max of hu over its rows (one
// max a cell) and enters the update only where that max passes the hu of
// its best so far: visited columns increase with s, so a later column with
// no larger hu has a smaller word (a stripe below starts from the first
// column again, and takes ties of that hu too). The update compares the
// word of the first row holding the max; where that row lies past Lq, or a
// word can wrap (nocap, fold_nocap: hu at or above 2^31 / div), an
// out-of-line rescan compares every real row's word, and after a wrapped
// best every later column's. The group then reduces its G bests under the
// same order.
//
// What bounds it on an H100: the integer instructions of a cell, 7 at the
// least (chip_smoke.py SW_OPS), about 8 here (the score's extract and add,
// four add-maxes, the cap, the column's max), at 64 int32 lanes an SM,
// 1.675e13 operations a second; the per-step shuffle, loads and range check
// cost about one more a cell at R 16. Device memory holds the inputs, the
// outputs and, above 512 rows, the stripe hand-off.

#include <cuda_bf16.h>

#include "sw_group.cuh"

namespace {

constexpr int kLanes = 128;                // lanes a tile
constexpr int kPCols = 32;                 // profile columns
constexpr int kProfClasses = kPCols + 1;   // class 32: a code outside 0..31
constexpr int kNeg = -1000000;
constexpr int kPadScore = -32768;          // a row at or past Lq
constexpr int kMinChunk = 64;              // steps a ring load, at least
// the gap costs, as tools/kernel_variants.py's GO and GE: compile-time, so
// that i*ge of a thread's rows is an immediate beside one register
constexpr int kGo = 11, kGe = 1;
enum Variant { kBase = 0, kFold = 1, kNoCap = 2, kFoldNoCap = 3, kNoF = 4 };

__host__ __device__ constexpr bool folded(int v) {
  return v == kFold || v == kFoldNoCap;
}
__host__ __device__ constexpr int packing(int v) {
  return (v == kBase || v == kNoF) ? 65536 : 32768;
}
// H and F + go fit one 32-bit hand-off word (H <= 32767, F + go <= 65534)
__host__ __device__ constexpr bool narrow(int v) {
  return v == kBase || v == kNoF;
}
// hu can reach 2^31 / div, where the packed word wraps
__host__ __device__ constexpr bool may_wrap(int v) {
  return v == kNoCap || v == kFoldNoCap;
}

// Bytes of a class's row of the block profile: 2 G R, at least 128 (one
// copy a group of a quarter-warp).
template <int G, int R>
constexpr int kVRow = 2 * G * R > 128 ? 2 * G * R : 128;

template <int G, int R>
__host__ __device__ constexpr int smem_bytes(int ring) {
  return kProfClasses * kVRow<G, R> + kWarps * (32 / G) * (ring + 4);
}

// What a launch is given: the wrapper's plan (qm_variants_cuda.launch_plan)
// and the tensors.
struct Plan {
  const uint16_t* prof;   // (tiles, Lq, 32) bfloat16 bits
  const int32_t* tc;      // (Lt, tiles * 128)
  int Lq, Lt, B, TJ, per, nvis, chunk, ring;
  void* carry;            // (tiles * 128, Lt) hand-off words, or null
  int32_t *best, *q_end, *t_end;
};

// A thread's best cell: its packed word and row, the hu of that cell, and
// the hu a column's max must pass to enter the update (-1: every column).
struct VBest {
  int w, row, hu, th;
};

// The unfolded H of a thread's rows in one column.
template <int R>
struct HuRows {
  int v[R];
};

// The exact update over a column's real rows (nreal of them, from row0),
// kcol = div - 1 - j: every row's packed word against the best. Out of
// line: it runs only where the column's max of hu lies on a row past Lq or
// its word may wrap.
template <int V, int R>
__device__ __noinline__ VBest rescan(VBest best, const HuRows<R> hu,
                                     int nreal, int row0, unsigned kcol) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int w = static_cast<int>(
        static_cast<unsigned>(hu.v[r]) * static_cast<unsigned>(packing(V)) +
        kcol);
    if (r < nreal && hu.v[r] > 0 &&
        (w > best.w || (w == best.w && row0 + r < best.row)))
      best = VBest{w, row0 + r, hu.v[r], best.th};
  }
  return best;
}

// The local row of halfword x of a class row: part p of thread k's rows is
// at halfword p 8 G + 8 k.
template <int G, int R>
__device__ __forceinline__ int slot_row(int x) {
  const int y = x % (G * R);
  const int p = y / (G * 8), q = y % (G * 8);
  return (q / 8) * R + p * 8 + q % 8;
}

// The block's int16 profile of rows [base, base + G R) of the tile's query
// at shared byte offset 0.
template <int G, int R>
__device__ __forceinline__ void stage_profile(const uint16_t* p, int Lq,
                                              int base) {
  constexpr int kHalf = kVRow<G, R> / 2;
  int16_t* ps = reinterpret_cast<int16_t*>(smem);
  for (int x = threadIdx.x; x < kHalf * kProfClasses; x += blockDim.x) {
    const int pos = x / kProfClasses, a = x % kProfClasses;
    const int i = base + slot_row<G, R>(pos);
    int v = kPadScore;
    if (i < Lq) {
      v = 0;
      if (a < kPCols) {
        __nv_bfloat16_raw raw;
        raw.x = __ldg(p + static_cast<size_t>(i) * kPCols + a);
        v = static_cast<int>(__bfloat162float(__nv_bfloat16(raw)));
      }
    }
    ps[a * kHalf + pos] = static_cast<int16_t>(v);
  }
}

// Stage ring load L (visited steps [L chunk, (L + 1) chunk)) of lane b into
// the group's ring at rg: thread k of the group stages every G-th step from
// k. A step past the last visited one gets class 0.
template <int G>
__device__ __forceinline__ void stage_ring(const Plan& pl, int b, int L,
                                           uint8_t* rg, int k) {
  const int s0 = L * pl.chunk;
  for (int v = k; v < pl.chunk; v += G) {
    const int s = s0 + v;
    int a = 0;
    if (s < pl.nvis) {
      const int c = s / pl.per;
      const int code = __ldg(
          pl.tc + static_cast<size_t>(c * pl.TJ + s - c * pl.per) * pl.B + b);
      a = (code >= 0 && code < kPCols) ? code : kPCols;
    }
    rg[s & (pl.ring - 1)] = static_cast<uint8_t>(a);
  }
}

// A thread's R int16 scores of one class: one or two 16-byte shared loads.
template <int G, int R>
__device__ __forceinline__ void load_scores(uint32_t addr, uint32_t* w) {
  load_words<4>(addr, w);
  if constexpr (R == 16) load_words<4>(addr + 16 * G, w + 4);
}

// The signed low (h 0) or high (h 1) half of w.
__device__ __forceinline__ int shalf(uint32_t w, int h) {
  if (h != 0) return static_cast<int>(w) >> 16;
  int r;
  asm("prmt.b32 %0, %1, 0, 0x9910;" : "=r"(r) : "r"(w));
  return r;
}

// One stripe of G R rows from row `base`: stage the ring's first two loads,
// then run the wavefront over the visited steps. prof is this thread's
// byte offset in a class row, ring the group's ring (a byte offset of
// smem). carry (per-step H and F of the row before `base`, or null at the
// top) is read 32 steps at a time, 32 steps ahead, and handed to thread 0
// by a shuffle; carry_out (or null when no stripe follows) is written by
// thread 31, in place.
template <int V, int U, int G, int R>
__device__ __forceinline__ void vstripe(
    const Plan& pl, int b, int base, int prof, int ring,
    const typename HandOff<!narrow(V)>::Word* carry,
    typename HandOff<!narrow(V)>::Word* carry_out, VBest& best) {
  using Link = HandOff<!narrow(V)>;
  using Word = typename Link::Word;
  constexpr bool kFolded = folded(V);
  constexpr int kDiv = packing(V);
  constexpr int kWrap = 0x7fffffff / kDiv + 1;   // 2^31 / div
  constexpr int W = R / 2;                       // score words a class
  constexpr int kRow = kVRow<G, R>;
  const int lane = threadIdx.x & 31;
  const int k = lane % G;
  const int row0 = base + k * R;
  const int last_k = min(G - 1, (pl.Lq - 1 - base) / R);
  const bool on = k <= last_k;
  const int nreal = pl.Lq - row0;   // this thread's rows below Lq (if < R)
  const int ig0 = row0 * kGe;       // i*ge of this thread's first row

  // a stripe below sweeps the columns again from the first: a cell of the
  // best's hu at an earlier column beats it
  if (best.th > 0) best.th = best.hu - 1;
  // the previous stripe's ring reads, before this one's staging
  __syncwarp();
  uint8_t* rg = reinterpret_cast<uint8_t*>(smem) + ring;
  stage_ring<G>(pl, b, 0, rg, k);
  stage_ring<G>(pl, b, 1, rg, k);
  __syncwarp();

  int hp[R], e[R];   // H(i, j - 1); E(i, j) + go
#pragma unroll
  for (int r = 0; r < R; ++r) {
    hp[r] = kFolded ? ig0 + r * kGe : 0;
    e[r] = kFolded ? ig0 + r * kGe : 0;
  }
  // row -1: H 0 and F + go 0 (F = -go); folded, H' -ge and f below any g'
  const Word edge = kFolded ? Link::pack(-kGe, kNeg) : Link::pack(0, 0);
  int hup = kFolded ? ig0 - kGe : 0;   // H(row0 - 1, j - 1)
  Word in = edge;                            // H(row0 - 1, j), F(row0, j)
  const uint32_t smem_at =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint32_t prof_at = smem_at + prof;
  uint32_t ring_at = smem_at + ring;
  const int rmask = pl.ring - 1;
  uint32_t wcur[W];   // the scores of this step's class
  load_scores<G, R>(prof_at + load_byte(ring_at + ((-k) & rmask)) * kRow,
                    wcur);
  int a1 = load_byte(ring_at + ((1 - k) & rmask));   // the next class
  Word cw = 0, cw_next = 0;   // carry words of this and the next 32 steps
  if (carry != nullptr) cw_next = lane < pl.nvis ? carry[lane] : 0;
  const int steps = pl.nvis + last_k;   // uniform over the warp
  int next_stage = pl.chunk + 32, L = 2;
  for (int t0 = 0; t0 < steps; t0 += U) {
    if (t0 >= next_stage) {   // uniform: load L replaces load L - 2
      __syncwarp();
      stage_ring<G>(pl, b, L, rg, k);
      __syncwarp();
      ++L;
      next_stage += pl.chunk;
    }
    if (carry != nullptr && (t0 & 31) == 0) {   // uniform: U divides 32
      cw = cw_next;
      cw_next = t0 + 32 + lane < pl.nvis ? carry[t0 + 32 + lane] : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      const int s = t - k;
      if (carry != nullptr) {
        const Word c = __shfl_sync(kFull, cw, t & 31);
        if (k == 0) in = c;
      } else if (k == 0) {
        in = edge;
      }
      asm volatile("" : "+r"(prof_at), "+r"(ring_at));
      const int a2 = load_byte(ring_at + ((s + 2) & rmask));
      uint32_t wnext[W];
      load_scores<G, R>(prof_at + a1 * kRow, wnext);
      Word out = 0;
      if (on && s >= 0 && s < pl.nvis) {
        int diag = hup;
        hup = Link::h(in);
        int f = Link::f(in);
        // the column's max of hu over this thread's rows (folded: of H' -
        // r ge, less ig0 after the loop)
        int colmax = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int x = diag + shalf(wcur[r / 2], r % 2);
          int h;
          if constexpr (kFolded) {
            const int g = __viaddmax_s32(ig0, r * kGe,
                                         __viaddmax_s32(e[r], -kGo, x));
            h = __viaddmax_s32(f, kGe - kGo, g);
            if constexpr (V == kFold)
              h = __viaddmin_s32(ig0, kScoreCap + r * kGe, h);
            f = max(f, g);
            colmax = __viaddmax_s32(h, -r * kGe, colmax);
          } else if constexpr (V == kNoF) {
            h = min(__viaddmax_s32_relu(e[r], -kGo, x), kScoreCap);
            colmax = max(colmax, h);
          } else {
            const int g = __viaddmax_s32_relu(e[r], -kGo, x);
            h = __viaddmax_s32(f, -kGo, g);
            if constexpr (V == kBase) h = min(h, kScoreCap);
            f = __viaddmax_s32(f, -kGe, g);
            colmax = max(colmax, h);
          }
          e[r] = __viaddmax_s32(e[r], -kGe, h);
          diag = hp[r];
          hp[r] = h;
        }
        if constexpr (kFolded) colmax -= ig0;
        out = Link::pack(hp[R - 1], V == kNoF ? 0 : f);
        if (carry_out != nullptr && k == G - 1) carry_out[s] = out;
        if (colmax > best.th) {   // rare: the column may hold a new best
          const int c = s / pl.per;
          const unsigned kcol = static_cast<unsigned>(
              (kDiv - 1) - (c * pl.TJ + s - c * pl.per));
          HuRows<R> hu;
          int first = R;   // the first row of the column's max
#pragma unroll
          for (int r = R - 1; r >= 0; --r) {
            hu.v[r] = kFolded ? hp[r] - ig0 - r * kGe : hp[r];
            if (hu.v[r] == colmax) first = r;
          }
          if (first < nreal && (!may_wrap(V) || colmax < kWrap)) {
            // no word of the column wraps: the first row of its max has
            // the column's largest word
            const int w = static_cast<int>(
                static_cast<unsigned>(colmax) * static_cast<unsigned>(kDiv) +
                kcol);
            if (w > best.w || (w == best.w && row0 + first < best.row))
              best = VBest{w, row0 + first, colmax, best.th};
          } else {
            best = rescan<V, R>(best, hu, nreal, row0, kcol);
          }
          best.th = (may_wrap(V) && best.hu >= kWrap) ? -1 : best.hu;
        }
      }
      a1 = a2;
#pragma unroll
      for (int w = 0; w < W; ++w) wcur[w] = wnext[w];
      in = __shfl_up_sync(kFull, out, 1, G);
    }
  }
}

// Lanes (tile x / kBlocks, 4 (32 / G) of them from (x % kBlocks) 4 (32 /
// G)), 32 / G a warp, G threads a lane.
template <int V, int U, int G, int R>
__global__ void __launch_bounds__(kLanes, 4) qm_variant_kernel(
    const Plan pl) {
  using Word = typename HandOff<!narrow(V)>::Word;
  constexpr int kPairs = 32 / G;                        // lanes a warp
  constexpr int kBlockLanes = kWarps * kPairs;          // lanes a block
  constexpr int kBlocks = kLanes / kBlockLanes;         // blocks a tile
  constexpr int kDiv = packing(V);
  const int tile = blockIdx.x / kBlocks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp * kPairs + lane / G;            // the block's lane
  const int b = tile * kLanes + (blockIdx.x % kBlocks) * kBlockLanes + slot;
  // the group's ring after the profile, zeroed (any class is a valid one:
  // the look-behind before step 0 reads the ring's end)
  const int ring = kProfClasses * kVRow<G, R> + slot * (pl.ring + 4);
  uint8_t* rg = reinterpret_cast<uint8_t*>(smem) + ring;
  for (int x = lane % G; x < pl.ring; x += G) rg[x] = 0;
  // this thread's scores in a class row: its group's copy, then part 0
  const int prof = ((lane / G) * 2 * G * R) % kVRow<G, R> + (lane % G) * 16;
  const uint16_t* p = pl.prof + static_cast<size_t>(tile) * pl.Lq * kPCols;
  Word* pc = pl.carry != nullptr
                 ? static_cast<Word*>(pl.carry) +
                       static_cast<size_t>(b) * pl.Lt
                 : nullptr;
  VBest best{0, INT_MAX, 0, 0};
  for (int base = 0; base < pl.Lq; base += G * R) {   // uniform
    __syncthreads();   // the last stripe's profile reads done
    stage_profile<G, R>(p, pl.Lq, base);
    __syncthreads();
    vstripe<V, U, G, R>(pl, b, base, prof, ring, base > 0 ? pc : nullptr,
                        base + G * R < pl.Lq ? pc : nullptr, best);
  }
  // the group's best: the largest word, then the smallest row
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const int ow = __shfl_xor_sync(kFull, best.w, off, G);
    const int orow = __shfl_xor_sync(kFull, best.row, off, G);
    if (ow > best.w || (ow == best.w && orow < best.row)) {
      best.w = ow;
      best.row = orow;
    }
  }
  if (lane % G == 0) {
    const int M = best.w / kDiv;   // best.w >= 0
    const bool has = M > 0;
    pl.best[b] = has ? M : 0;
    pl.t_end[b] = has ? (kDiv - 1) - best.w % kDiv : -1;
    pl.q_end[b] = has ? best.row : pl.Lq - 1;
  }
}

template <int V, int U, int G, int R>
int launch(const Plan& pl, int n_tiles, cudaStream_t stream) {
  const size_t bytes = smem_bytes<G, R>(pl.ring);
  auto kernel = qm_variant_kernel<V, U, G, R>;
  const int rc = allow_smem(kernel, bytes);
  if (rc != 0) return rc;
  const int blocks = n_tiles * (kLanes / (kWarps * (32 / G)));
  kernel<<<blocks, kLanes, bytes, stream>>>(pl);
  return static_cast<int>(cudaGetLastError());
}

template <int V, int U>
int by_class(int cls, const Plan& pl, int n_tiles, cudaStream_t s) {
  switch (cls) {
    case 0: return launch<V, U, 4, 8>(pl, n_tiles, s);
    case 1: return launch<V, U, 8, 8>(pl, n_tiles, s);
    case 2: return launch<V, U, 16, 8>(pl, n_tiles, s);
    case 3: return launch<V, U, 16, 16>(pl, n_tiles, s);
    case 4: return launch<V, U, 32, kMaxRows>(pl, n_tiles, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int V>
int by_unroll(int U, int cls, const Plan& pl, int n_tiles, cudaStream_t s) {
  switch (U) {
    case 1: return by_class<V, 1>(cls, pl, n_tiles, s);
    case 2: return by_class<V, 2>(cls, pl, n_tiles, s);
    case 4: return by_class<V, 4>(cls, pl, n_tiles, s);
    case 8: return by_class<V, 8>(cls, pl, n_tiles, s);
    case 16: return by_class<V, 16>(cls, pl, n_tiles, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr int kClassRows[kClasses] = {32, 64, 128, 256, kStripe};

}  // namespace

// Bytes of dynamic shared memory a launch of class cls (sw_cuda.PAIR_CLASSES)
// with a ring of `ring` bytes a lane takes, or -1 for no such class.
extern "C" long long qm_variant_smem(int cls, int ring) {
  switch (cls) {
    case 0: return smem_bytes<4, 8>(ring);
    case 1: return smem_bytes<8, 8>(ring);
    case 2: return smem_bytes<16, 8>(ring);
    case 3: return smem_bytes<16, 16>(ring);
    case 4: return smem_bytes<32, kMaxRows>(ring);
    default: return -1;
  }
}

// variant: 0 base, 1 fold, 2 nocap, 3 fold_nocap, 4 nof; unroll one of 1, 2,
// 4, 8, 16; cls, TJ, per, nvis, chunk, ring: qm_variants_cuda.launch_plan's
// (TJ = min(tj, Lt), per = (TJ / unroll) unroll, nvis = (Lt / TJ) per,
// chunk >= 64 steps a ring load, ring a power of two >= 2 chunk); go, ge
// 11 and 1 (the kernel's compile-time gap costs). prof:
// (n_tiles, Lq, 32) bfloat16 bits holding int16 scores; tc: (Lt, n_tiles *
// 128) int32; carry: (n_tiles * 128, Lt) 8-byte words, needed (non-null)
// only when Lq > 512; best, q_end, t_end: (n_tiles * 128,) int32. Every
// pointer is on the device; the launch goes on `stream` and does not
// synchronise. Returns the error of the attribute call or of the launch (0
// on success).
extern "C" int qm_variant_ends(int variant, int unroll, int cls,
                               const uint16_t* prof, const int32_t* tc,
                               int n_tiles, int Lq, int Lt, int TJ, int per,
                               int nvis, int chunk, int ring, int go, int ge,
                               void* carry, int32_t* best, int32_t* q_end,
                               int32_t* t_end, void* stream) {
  const bool shape_ok =
      n_tiles > 0 && Lq > 0 && TJ > 0 && TJ <= Lt && per >= 0 &&
      per <= TJ && nvis == (Lt / TJ) * per && chunk >= kMinChunk &&
      ring >= 2 * chunk && (ring & (ring - 1)) == 0 && cls >= 0 &&
      cls < kClasses && (cls == kClasses - 1 || Lq <= kClassRows[cls]) &&
      (Lq <= kStripe || carry != nullptr) && go == kGo && ge == kGe;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl{prof, tc, Lq, Lt, n_tiles * kLanes, TJ, per, nvis, chunk,
                ring, carry, best, q_end, t_end};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBase: return by_unroll<kBase>(unroll, cls, pl, n_tiles, s);
    case kFold: return by_unroll<kFold>(unroll, cls, pl, n_tiles, s);
    case kNoCap: return by_unroll<kNoCap>(unroll, cls, pl, n_tiles, s);
    case kFoldNoCap: return by_unroll<kFoldNoCap>(unroll, cls, pl, n_tiles, s);
    case kNoF: return by_unroll<kNoF>(unroll, cls, pl, n_tiles, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
