// Smith-Waterman pair kernels for NVIDIA Hopper (sm_90a): a group of G
// lanes per (fragment, target) pair, the fragment's rows in the group's
// registers, the target's columns streamed through the group as a
// wavefront.
//
// sw_pair_ends   replaces metaeuk_tpu/ops/sw_pallas.py::_dp_kernel (K1):
//                forward affine-gap local alignment ends.
// sw_pair_starts replaces metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_rev (K2):
//                the reverse-prefix pass that finds the starts.
// Both also replace sw_pallas.py::_build_S_gapped: the score of cell (i, j)
// is submat[q_i][t_j] + bias_i, read from an int8 query profile in shared
// memory with the bias added after the load, instead of an int8 (Lt_pad,
// Lq, B) score tensor. The JAX driver sends them every pair whose fragment
// has fewer than 48 candidates in its length bucket; on the k-mer main
// path that is every pair: fragments of about 24-450 aa (median 67)
// against targets of about 120-550 aa (median 412).
//
// Design. The fragment is the short axis, so the state a pair carries is
// one column of the fragment, and it fits in registers. The wrapper
// (ops/sw_cuda.py pair_classes) sorts a launch's pairs into length classes
// by the rows n they sweep, and within a class by columns; it passes the
// order and the class bounds, and each class runs one launch of its own
// template instance, the five at once on side streams (a class alone holds
// too few warps to fill the card) (G lanes a pair, R rows a lane, 32 / G
// pairs a warp):
//   n <= 32: (4, 8); <= 64: (8, 8); <= 128: (16, 8); <= 256: (16, 16);
//   longer: (32, R), a warp per pair, in row stripes of 512 with R = 16,
//   the last stripe at the least R of 4, 8 or 16 that covers its rows.
// Lane k of a group owns rows k R .. k R + R - 1 of the stripe and keeps,
// for each, H of the previous column and E (the gap along the target),
// indexed only by unrolled constants. It works on column j at step j + k.
// Each step it receives from lane k - 1, in one __shfl_up_sync of width G,
// a packed word: that lane's last row's H (the diagonal one step later) and
// the outgoing F (the gap along the query): one shuffle per R cells. A
// fragment longer than a stripe is swept stripe by stripe; lane 31 hands
// each column's word on to lane 0 of the next stripe through a per-pair
// array of Lt words (one word per 512 cells), which the warp reads 32
// columns at a time, 32 steps ahead. Each warp stages, per stripe, its own
// int8 query profile in shared memory (prof[a][lane] = the scores of the
// lane's R rows against target class a), so one shared load per column
// gives a lane all R of its scores, and each group stages its target's
// classes in a shared ring, 64 columns at a time, two chunks ahead. A
// lane loads a column's class two steps and its profile words one step
// before it uses them, so no step waits on a load from device memory.
// There is no H/E scratch. The reverse pass is the forward sweep over rows
// qe..0 and columns te..0 (each cut to the true lengths), counted from the
// end cell, as in sw_qm_rt.cu.
//
// Contract (the Pallas kernels'): H starts at 0 and E and F at -go; H is
// capped at 32767; per cell g = max(Hdiag + s, E, 0), h = min(max(g, F),
// 32767), E' = max(E - ge, h - go), F' = max(F - ge, g - go) (F taken over
// G instead of H is exact for go >= ge). Here E and F are carried as E + go
// and F + go, so that each line but the score's is one DPX add-max: g =
// max(E + go - go, Hdiag + s, 0), h = max(F + go - go, g), E' + go =
// max(E + go - ge, h), F' + go = max(F + go - ge, g). The cap is dropped
// where it cannot bind: with int8 scores and biases a cell adds at most
// 254, so a pair of at most 128 rows stays below 32767. Forward tie-break:
// the highest score, then the first column, then the smallest row; no hit
// gives (0, Lq-1, -1) with Lq the batch width. Reverse: the highest score,
// then the last column, then the largest row; no hit gives (0, 0, -1). Both
// are one order in sweep coordinates: each lane keeps its best cell under
// it, visiting columns in order and, within a column, its rows in order,
// and the group reduces its G bests under it. Columns at or past the
// sweep's end are never computed. Rows at or past it, in the last lane of
// the last stripe, get a bias of -65536: their Hdiag + s is negative, so
// their H is at most max(E, F, 0) of a chain fed from real cells, below a
// real cell of the same or an earlier column; they lie below every real
// row and feed nothing real, and never win the group's reduction.
// Substitution scores must fit int8 (the wrapper checks), and codes must
// lie below alph.
//
// What bounds it on an H100: the integer instructions of a cell, 7 at the
// least (chip_smoke.py SW_OPS, a DPX add-max counted as one) and about 7
// here (the score's byte extract and add, four add-maxes, the cap where it
// binds, half a three-way max for the column's best), at 64 int32 lanes an
// SM, 1.675e13 operations a second; rows of a class that the fragment does
// not fill (n / (G R) of a group's cells are real) and the wavefront's
// ramp of G - 1 steps on each pair are paid at that rate too. A launch of
// few pairs is bound instead by the latency of a warp's step (its R cells
// issue in order, about 160 instructions at R 16). Device memory holds
// only the inputs, the outputs, the work list and, for fragments over 512
// rows, the stripe hand-off.

#include <climits>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;               // warps a block
constexpr int kMaxRows = 16;            // rows a lane carries, at most
constexpr int kStripe = 32 * kMaxRows;  // sw_cuda.PAIR_STRIPE
constexpr int kAlphPad = 32;
constexpr int kScoreCap = 32767;
constexpr int kPadBias = -65536;        // bias of a row past the sweep
constexpr int kChunk = 64;              // target columns staged at once
constexpr int kRing = 4 * kChunk;       // target classes a group holds
// bytes between two groups' rings: one word more than a ring, so that the
// groups of a warp reading the same ring index hit different banks
constexpr int kRingStride = kRing + 4;
constexpr unsigned kFull = 0xffffffffu;

// H (0..32767) in the low half, F + go (0..33021) in the high half
__device__ __forceinline__ uint32_t pack_hf(int h, int f) {
  return (static_cast<uint32_t>(h) & 0xffffu) |
         (static_cast<uint32_t>(f) << 16);
}
__device__ __forceinline__ int unpack_h(uint32_t w) {
  return static_cast<int>(w & 0xffffu);
}
__device__ __forceinline__ int unpack_f(uint32_t w) {
  return static_cast<int>(w >> 16);
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
// sweep column c is target column t[ts * c]; rows and cols 0 for a group
// with no work.
struct Sweep {
  const uint8_t* q;
  const int8_t* qb;
  int qs;
  const uint8_t* t;
  int ts;
  int rows, cols;
};

// A lane's best cell, in sweep coordinates.
struct Best {
  int score, row, col;
};

// The order of both passes in sweep coordinates: the higher score, then the
// smaller column, then the smaller row.
__device__ __forceinline__ bool before(int s, int r, int c, const Best& b) {
  return s > b.score ||
         (s == b.score && (c < b.col || (c == b.col && r < b.row)));
}

// W profile words at a shared-memory byte address. The loads are volatile
// and clobber memory, so they stay after the stripe's profile stores and
// the ring's staging (ordered by __syncwarp).
template <int W>
__device__ __forceinline__ void load_words(uint32_t addr, uint32_t* w) {
  if constexpr (W == 4) {
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(addr) : "memory");
  } else if constexpr (W == 2) {
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(w[0]), "=r"(w[1]) : "r"(addr) : "memory");
  } else {
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(w[0]) : "r"(addr)
                 : "memory");
  }
}

// The byte at a shared-memory byte address, as load_words.
__device__ __forceinline__ int load_byte(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return static_cast<int>(v);
}

template <int W>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t* w) {
  if constexpr (W == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *p = w[0];
  }
}

// The block's shared memory: the 32 x 32 substitution matrix (int32), then
// each warp's query profile, then each group's ring of target classes.
// Device functions address it by offsets from this base, which the
// compiler keeps in registers and folds into the shared loads.
extern __shared__ uint32_t smem[];

// Stage columns [64 c, 64 c + 64) of the sweep into the group's ring of
// target classes at byte offset ring (column j at ring + j % 256), clamped
// below alph, 0 past the sweep: lane k of the group writes every G-th
// column from k.
template <int G>
__device__ __forceinline__ void stage_codes(const Sweep& p, int c, int alph,
                                            int ring, int k) {
  uint8_t* codes = reinterpret_cast<uint8_t*>(smem) + ring;
#pragma unroll
  for (int v = 0; v < kChunk / G; ++v) {
    const int col = c * kChunk + v * G + k;
    codes[col & (kRing - 1)] =
        col < p.cols ? min(static_cast<int>(p.t[p.ts * col]), alph - 1) : 0;
  }
}

// One stripe of G R rows from sweep row `base`: stage this warp's profile,
// then run the wavefront over every column. `carry` (per-column H and F of
// the row before `base`, or null at the top) is read 32 columns at a time,
// a column a lane, 32 steps ahead, and handed to lane 0 by a shuffle;
// `carry_out` (the stripe's last row, or null when no stripe follows) is
// written by lane 31, in place: a column is read at least 32 steps before
// it is written. The group's target classes are staged in its ring two
// chunks of 64 columns ahead; a lane reads the class of its column two
// steps ahead and the profile words one step ahead, so no load waits in
// the step that uses it. prof is the warp's profile (a word offset of
// smem), ring the group's ring (a byte offset).
template <int G, int R, bool kCap>
__device__ __forceinline__ void stripe(const Sweep& p, int base,
                                       int alph, int prof, int ring,
                                       const uint32_t* carry,
                                       uint32_t* carry_out, int go, int ge,
                                       Best& best) {
  constexpr int W = R / 4;   // profile words of a lane and class
  const int lane = threadIdx.x & 31;
  const int k = lane % G;
  const int row0 = base + k * R;     // this lane's first sweep row
  const int mine = prof + lane * W;  // class a at smem[mine + a * 32 * W]
  const int* sm = reinterpret_cast<const int*>(smem);
  // the last lane of the group with a real row; the lanes past it idle
  const int last_k = p.rows > base ? min(G - 1, (p.rows - 1 - base) / R) : -1;
  const bool on = p.cols > 0 && k <= last_k;

  // the previous stripe's carry writes and ring reads, before this one's
  __syncwarp();
  int bias[R];
#pragma unroll
  for (int r = 0; r < R; ++r) bias[r] = kPadBias;
  if (on) {   // each lane reads back only the profile words it writes here
    int code[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + r;
      code[r] = i < p.rows ? min(static_cast<int>(p.q[p.qs * i]), kAlphPad - 1)
                           : 0;
      if (i < p.rows) bias[r] = p.qb[p.qs * i];
    }
    for (int a = 0; a < alph; ++a) {
      uint32_t w[W];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t byte =
            (static_cast<uint32_t>(sm[code[r] * kAlphPad + a]) & 0xffu)
            << (8 * (r % 4));
        w[r / 4] = r % 4 == 0 ? byte : w[r / 4] | byte;
      }
      store_words<W>(smem + mine + a * 32 * W, w);   // class a's words
    }
  }
  stage_codes<G>(p, 0, alph, ring, k);
  stage_codes<G>(p, 1, alph, ring, k);
  __syncwarp();

  const int steps = __reduce_max_sync(kFull, on ? p.cols + last_k : 0);
  int hp[R], e[R];   // H(i, j - 1) and E(i, j) + go of this lane's rows
#pragma unroll
  for (int r = 0; r < R; ++r) {
    hp[r] = 0;
    e[r] = 0;
  }
  const uint32_t edge = pack_hf(0, 0);   // row -1: H 0, F -go
  int hup = 0;             // H(row0 - 1, j - 1): column -1 is 0
  uint32_t in = edge;      // H(row0 - 1, j) and F(row0, j) + go
  uint32_t wcur[W];        // the profile words of this step's column
  // shared byte addresses of this lane's profile (class 0) and of the
  // group's ring, kept in registers through the loop (the empty asm hides
  // their origin, so the compiler cannot recompute them from the thread
  // index in every step)
  const uint32_t smem_at =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint32_t prof_at = smem_at + 4 * mine;
  uint32_t ring_at = smem_at + ring;
  constexpr int kClassBytes = 32 * W * 4;   // profile bytes of a class
  load_words<W>(prof_at + load_byte(ring_at + ((-k) & (kRing - 1))) *
                              kClassBytes, wcur);
  int a1 = load_byte(ring_at + ((1 - k) & (kRing - 1)));   // next class
  uint32_t cw = 0, cw_next = 0;   // carry words of this and the next 32
  if (carry != nullptr) cw_next = lane < p.cols ? carry[lane] : 0;
  for (int t = 0; t < steps; ++t) {
    const int j = t - k;
    if ((t & (kChunk - 1)) == 0) {   // uniform over the warp
      __syncwarp();
      stage_codes<G>(p, t / kChunk + 2, alph, ring, k);
    }
    if (carry != nullptr) {   // uniform: one pair a warp
      if ((t & 31) == 0) {
        cw = cw_next;
        cw_next = t + 32 + lane < p.cols ? carry[t + 32 + lane] : 0;
      }
      const uint32_t c = __shfl_sync(kFull, cw, t & 31);
      if (k == 0) in = c;
    } else if (k == 0) {
      in = edge;
    }
    asm volatile("" : "+r"(prof_at), "+r"(ring_at));
    const int a2 = load_byte(ring_at + ((j + 2) & (kRing - 1)));
    uint32_t wnext[W];
    load_words<W>(prof_at + a1 * kClassBytes, wnext);
    uint32_t out = 0;
    if (on && j >= 0 && j < p.cols) {
      int diag = hup;
      hup = unpack_h(in);
      int f = unpack_f(in);   // F + go, as e holds E + go
      int colmax = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // g = max(Hdiag + s, E, 0), h = max(g, F) (capped), E' + go =
        // max(E + go - ge, h), F' + go = max(F + go - ge, g): a DPX
        // add-max each
        const int x = diag + sbyte(wcur[r / 4], r % 4) + bias[r];
        const int g = __viaddmax_s32_relu(e[r], -go, x);
        diag = hp[r];
        int h = __viaddmax_s32(f, -go, g);
        if constexpr (kCap) h = min(h, kScoreCap);
        e[r] = __viaddmax_s32(e[r], -ge, h);
        f = __viaddmax_s32(f, -ge, g);
        hp[r] = h;
        colmax = max(colmax, h);
      }
      out = pack_hf(hp[R - 1], f);
      if (carry_out != nullptr && k == G - 1) carry_out[j] = out;
      if (colmax > 0 && colmax >= best.score) {   // a new best, or a tie
        int first = R - 1;
#pragma unroll
        for (int r = R - 1; r >= 0; --r)
          if (hp[r] == colmax) first = r;
        if (before(colmax, row0 + first, j, best))
          best = Best{colmax, row0 + first, j};
      }
    }
    a1 = a2;
#pragma unroll
    for (int w = 0; w < W; ++w) wcur[w] = wnext[w];
    in = __shfl_up_sync(kFull, out, 1, G);
  }
}

// Class instance (G, R): 32 / G pairs a warp, the pairs order[lo..hi) of
// class cls (lo = bounds[cls - 1], hi = bounds[cls]). G = 32 sweeps any
// number of rows in stripes; a smaller G takes pairs of at most G R rows.
template <int G, int R, bool kRev>
__global__ void __launch_bounds__(32 * kWarps) sw_pair_kernel(
    const int32_t* __restrict__ submat, int alph,
    const uint8_t* __restrict__ q, const int8_t* __restrict__ qb,
    const int32_t* __restrict__ q_len, const uint8_t* __restrict__ t,
    const int32_t* __restrict__ t_len, const int32_t* __restrict__ q_end,
    const int32_t* __restrict__ t_end, int Lq, int Lt, int go, int ge,
    const int32_t* __restrict__ order, const int32_t* __restrict__ bounds,
    int cls, uint32_t* __restrict__ carry, int32_t* __restrict__ score_out,
    int32_t* __restrict__ row_out, int32_t* __restrict__ col_out) {
  constexpr int kPairs = 32 / G;   // pairs a warp
  const int lo = cls > 0 ? bounds[cls - 1] : 0, hi = bounds[cls];
  const int block0 = lo + blockIdx.x * kWarps * kPairs;
  if (block0 >= hi) return;   // uniform over the block
  int* sm = reinterpret_cast<int*>(smem);
  for (int x = threadIdx.x; x < kAlphPad * kAlphPad; x += blockDim.x) {
    const int r = x / kAlphPad, c = x % kAlphPad;
    sm[x] = (r < alph && c < alph) ? submat[r * alph + c] : 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot0 = block0 + warp * kPairs;
  if (slot0 >= hi) return;   // uniform over the warp
  const int slot = slot0 + lane / G;
  const bool have = slot < hi;
  const int b = order[have ? slot : slot0];
  const uint8_t* qr = q + static_cast<size_t>(b) * Lq;
  const int8_t* qbr = qb + static_cast<size_t>(b) * Lq;
  const uint8_t* tr = t + static_cast<size_t>(b) * Lt;
  const int qn = max(0, min(q_len[b], Lq));
  const int tn = max(0, min(t_len[b], Lt));
  // the reverse pass starts at its end cell, cut to the true lengths
  const int r0 = kRev ? min(q_end[b], qn - 1) : qn - 1;
  const int c0 = kRev ? min(t_end[b], tn - 1) : tn - 1;
  Sweep p{qr, qbr, 1, tr, 1, 0, 0};
  if (have && r0 >= 0 && c0 >= 0) {
    p = kRev ? Sweep{qr + r0, qbr + r0, -1, tr + c0, -1, r0 + 1, c0 + 1}
             : Sweep{qr, qbr, 1, tr, 1, r0 + 1, c0 + 1};
  }
  // the warp's profile, and its groups' rings of target classes, zeroed so
  // that a look-behind past the left edge reads a class
  const int prof = kAlphPad * kAlphPad + warp * alph * 32 * (R / 4);
  const int rings = kAlphPad * kAlphPad + kWarps * alph * 32 * (R / 4) +
                    warp * kPairs * (kRingStride / 4);
  for (int x = lane; x < kPairs * (kRingStride / 4); x += 32)
    smem[rings + x] = 0;
  const int ring = 4 * rings + (lane / G) * kRingStride;
  Best best{0, 0, INT_MAX};
  if constexpr (G == 32) {
    uint32_t* pc = carry != nullptr ? carry + static_cast<size_t>(b) * Lt
                                    : nullptr;
    for (int base = 0; base < p.rows;) {   // uniform: one pair a warp
      const int left = p.rows - base;
      const uint32_t* in = base > 0 ? pc : nullptr;
      if (left <= 32 * 4) {
        stripe<32, 4, true>(p, base, alph, prof, ring, in, nullptr, go, ge,
                            best);
        base += 32 * 4;
      } else if (left <= 32 * 8) {
        stripe<32, 8, true>(p, base, alph, prof, ring, in, nullptr, go, ge,
                            best);
        base += 32 * 8;
      } else {
        stripe<32, kMaxRows, true>(p, base, alph, prof, ring, in,
                                   left > kStripe ? pc : nullptr, go, ge,
                                   best);
        base += kStripe;
      }
    }
  } else {
    // at most 128 rows: H <= 254 * 128 < 32767, the cap never binds
    stripe<G, R, (G * R > 128)>(p, 0, alph, prof, ring, nullptr, nullptr,
                                go, ge, best);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const Best o{__shfl_xor_sync(kFull, best.score, off, G),
                 __shfl_xor_sync(kFull, best.row, off, G),
                 __shfl_xor_sync(kFull, best.col, off, G)};
    if (before(o.score, o.row, o.col, best)) best = o;
  }
  if (have && lane % G == 0) {
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

struct Args {
  const int32_t* submat;
  int alph;
  const uint8_t* q;
  const int8_t* qb;
  const int32_t* q_len;
  const uint8_t* t;
  const int32_t* t_len;
  const int32_t* q_end;
  const int32_t* t_end;
  int B, Lq, Lt, go, ge;
  const int32_t* order;
  const int32_t* bounds;
  uint32_t* carry;
  int32_t *score, *row, *col;
  cudaStream_t stream;
};

// One launch of class cls on `stream`: a block per 4 (32 / G) slots of the
// whole batch, since the class bounds stay on the device; blocks past the
// class return at once.
template <int G, int R, bool kRev>
int launch_class(const Args& a, int cls, cudaStream_t stream) {
  const size_t bytes = sizeof(int) * kAlphPad * kAlphPad +
                       static_cast<size_t>(kWarps) * a.alph * 32 * R +
                       kWarps * (32 / G) * kRingStride;
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        sw_pair_kernel<G, R, kRev>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int per_block = kWarps * (32 / G);
  sw_pair_kernel<G, R, kRev><<<(a.B + per_block - 1) / per_block,
                               32 * kWarps, bytes, stream>>>(
      a.submat, a.alph, a.q, a.qb, a.q_len, a.t, a.t_len, a.q_end, a.t_end,
      a.Lq, a.Lt, a.go, a.ge, a.order, a.bounds, cls, a.carry, a.score,
      a.row, a.col);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kClasses = 5;   // sw_cuda.PAIR_CLASSES
constexpr int kMaxDevices = 64;

// Per device, a stream for each class and the events that fork them from
// the caller's stream and join them back: the classes run at once, so a
// class of few pairs (a few warps an SM, bound by the latency of its
// steps) shares the SMs with the others instead of leaving them idle.
struct SideStreams {
  cudaStream_t stream[kClasses];
  cudaEvent_t fork, join[kClasses];
};

std::mutex side_mutex;   // guards the table and each fork/join sequence
SideStreams* side_table[kMaxDevices] = {};

// The current device's side streams, made on first use (side_mutex held).
cudaError_t side_streams(SideStreams** out) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (side_table[dev] == nullptr) {
    SideStreams* sd = new SideStreams;
    rc = cudaEventCreateWithFlags(&sd->fork, cudaEventDisableTiming);
    for (int c = 0; c < kClasses && rc == cudaSuccess; ++c) {
      rc = cudaStreamCreateWithFlags(&sd->stream[c], cudaStreamNonBlocking);
      if (rc == cudaSuccess)
        rc = cudaEventCreateWithFlags(&sd->join[c], cudaEventDisableTiming);
    }
    if (rc != cudaSuccess) {
      delete sd;   // what was made before the failure stays allocated
      return rc;
    }
    side_table[dev] = sd;
  }
  *out = side_table[dev];
  return cudaSuccess;
}

// The classes of sw_cuda.PAIR_CLASSES, each on its side stream, forked
// from and joined back into a.stream: work queued on a.stream after this
// call runs after every class.
template <bool kRev>
int launch(const Args& a) {
  if (a.alph < 1 || a.alph > kAlphPad || a.Lq < 1 || a.Lt < 1 ||
      (a.Lq > kStripe && a.carry == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B <= 0) return static_cast<int>(cudaGetLastError());
  std::lock_guard<std::mutex> lock(side_mutex);
  SideStreams* sd = nullptr;
  cudaError_t err = side_streams(&sd);
  if (err == cudaSuccess) err = cudaEventRecord(sd->fork, a.stream);
  for (int c = 0; c < kClasses && err == cudaSuccess; ++c)
    err = cudaStreamWaitEvent(sd->stream[c], sd->fork, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = launch_class<4, 8, kRev>(a, 0, sd->stream[0]);
  if (rc == 0) rc = launch_class<8, 8, kRev>(a, 1, sd->stream[1]);
  if (rc == 0) rc = launch_class<16, 8, kRev>(a, 2, sd->stream[2]);
  if (rc == 0) rc = launch_class<16, 16, kRev>(a, 3, sd->stream[3]);
  if (rc == 0) rc = launch_class<32, kMaxRows, kRev>(a, 4, sd->stream[4]);
  // join every stream, also after a failed launch
  for (int c = 0; c < kClasses; ++c) {
    err = cudaEventRecord(sd->join[c], sd->stream[c]);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(a.stream, sd->join[c], 0);
    if (rc == 0 && err != cudaSuccess) rc = static_cast<int>(err);
  }
  return rc;
}

}  // namespace

// q, qb: (B, Lq) query codes and biases; t: (B, Lt) target codes; order:
// (B,) pairs by length class, bounds: (5,) the end of each class in order
// (ops/sw_cuda.py pair_classes); carry: (B, Lt) words for the row-stripe
// hand-off, needed (non-null) only when Lq > 512. Substitution scores must
// fit int8. Every pointer is on the device; the launches are ordered after
// the work queued on `stream` and before the work queued on it later (five
// side streams, one a class, forked and joined by events), and do not
// synchronise the host. Returns the error of an attribute call, a stream
// or event call or a launch (0 on success).
extern "C" int sw_pair_ends(const int32_t* submat, int alph, const uint8_t* q,
                            const int8_t* qb, const int32_t* q_len,
                            const uint8_t* t, const int32_t* t_len, int B,
                            int Lq, int Lt, int go, int ge,
                            const int32_t* order, const int32_t* bounds,
                            uint32_t* carry, int32_t* best, int32_t* q_end,
                            int32_t* t_end, void* stream) {
  return launch<false>(Args{submat, alph, q, qb, q_len, t, t_len, nullptr,
                            nullptr, B, Lq, Lt, go, ge, order, bounds, carry,
                            best, q_end, t_end,
                            static_cast<cudaStream_t>(stream)});
}

// As sw_pair_ends, with each pair's known ends q_end, t_end: (B,).
extern "C" int sw_pair_starts(const int32_t* submat, int alph,
                              const uint8_t* q, const int8_t* qb,
                              const int32_t* q_len, const uint8_t* t,
                              const int32_t* t_len, const int32_t* q_end,
                              const int32_t* t_end, int B, int Lq, int Lt,
                              int go, int ge, const int32_t* order,
                              const int32_t* bounds, uint32_t* carry,
                              int32_t* score, int32_t* q_start,
                              int32_t* t_start, void* stream) {
  return launch<true>(Args{submat, alph, q, qb, q_len, t, t_len, q_end, t_end,
                           B, Lq, Lt, go, ge, order, bounds, carry, score,
                           q_start, t_start,
                           static_cast<cudaStream_t>(stream)});
}
