// The lane-group Smith-Waterman machinery of the SW kernels for NVIDIA
// Hopper (sm_90a), shared by csrc/sw_pair.cu (K1/K2: pair b is row b of a
// (B, Lq) x (B, Lt) batch) and csrc/sw_qm.cu (K3/K4: pair b is lane b of
// the query-major tiles, query row qidx[b / 128] against target row lj[b]
// of the staged matrices). A group of G lanes aligns one pair, the query's
// rows in the group's registers and the target's columns streamed through
// the group as a wavefront.
//
// Lane k of a group owns rows k R .. k R + R - 1 of a stripe of G R rows
// and keeps, for each, H of the previous column and E (the gap along the
// target), indexed only by unrolled constants. It works on column j at
// step j + k. Each step it receives from lane k - 1, in one __shfl_up_sync
// of width G, a packed word: that lane's last row's H (the diagonal one
// step later) and the outgoing F (the gap along the query): one shuffle
// per R cells. A query longer than a stripe (G = 32, a warp per pair) is
// swept stripe by stripe of 512 rows; lane 31 hands each column's word on
// to lane 0 of the next stripe through a per-pair array of Lt words, which
// the warp reads 32 columns at a time, 32 steps ahead. A lane reads its R
// scores of a column with one shared load from an int8 query profile (the
// scores of its rows against each target class; the bias is added after
// the load), and each group stages its target's classes in a shared ring,
// 64 columns at a time, two chunks ahead. A lane loads a column's class
// two steps and its profile words one step before it uses them, so no step
// waits on a load from device memory. There is no H/E scratch. The profile
// is either the warp's own (stripe<..., kStage = true>: each lane writes
// the words it reads, prof[a][lane], as K1/K2/K4 do, one query a group) or
// one that the caller staged for every group of the block (K3: the groups
// of a tile share its query). The reverse pass is the forward sweep over
// rows qe..0 and columns te..0 (each cut to the true lengths), counted
// from the end cell.
//
// Contract (the Pallas kernels'): H starts at 0 and E and F at -go; H is
// capped at 32767; per cell g = max(Hdiag + s, E, 0), h = min(max(g, F),
// 32767), E' = max(E - ge, h - go), F' = max(F - ge, g - go) (F taken over
// G instead of H is exact for go >= ge). Here E and F are carried as E + go
// and F + go, so that each line but the score's is one DPX add-max: g =
// max(E + go - go, Hdiag + s, 0), h = max(F + go - go, g), E' + go =
// max(E + go - ge, h), F' + go = max(F + go - ge, g). The cap is dropped
// where it cannot bind: with int8 scores and biases a cell adds at most
// 254, so a sweep of at most 128 rows stays below 32767. Forward tie-break:
// the highest score, then the first column, then the smallest row; no hit
// gives (0, Lq-1, -1) with Lq the batch (tier) width. Reverse: the highest
// score, then the last column, then the largest row; no hit gives (0, 0,
// -1). Both are one order in sweep coordinates: each lane keeps its best
// cell under it, visiting columns in order and, within a column, its rows
// in order, and the group reduces its G bests under it. Columns at or past
// the sweep's end are never computed. Rows at or past it, in the last lane
// of the last stripe, get a bias of -65536: their Hdiag + s is negative
// (uncapped, it lies more than 65,000 below Hdiag, a cell of an earlier
// column), so their H is at most max(E, F, 0) of a chain fed from real
// cells, below a real cell of the same or an earlier column; they lie below
// every real row and feed nothing real, and never win the group's
// reduction. K1/K2's uncapped instances (kWide, the realign pass: the JAX
// package's sw_jax.sw_align_batch does not cap H) drop the cap everywhere
// and hand H and F + go on in 32 bits each.
// Substitution scores must fit int8 (the wrappers check), and codes must
// lie below alph. The PSSM entries of K1/K2 (ProfRows) read each lane's
// int8 scores straight from the query profile's rows, with a bias of 0
// (the PROFILE_SEQ path has no composition bias); the rest is the same.
//
// What bounds it on an H100: the integer instructions of a cell, 7 at the
// least (chip_smoke.py SW_OPS, a DPX add-max counted as one) and about 7
// here (the score's byte extract and add, four add-maxes, the cap where it
// binds, half a three-way max for the column's best), at 64 int32 lanes an
// SM, 1.675e13 operations a second; rows of a class that the query does
// not fill (n / (G R) of a group's cells are real) and the wavefront's
// ramp of G - 1 steps on each pair are paid at that rate too. A launch of
// few pairs is bound instead by the latency of a warp's step (its R cells
// issue in order, about 160 instructions at R 16). Device memory holds
// only the inputs, the outputs, K1/K2's work list and, for queries over
// 512 rows, the stripe hand-off.

#pragma once

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
constexpr int kClasses = 5;             // sw_cuda.PAIR_CLASSES

// What lane k - 1 hands lane k each step, and the last lane of a stripe
// the next stripe through the hand-off array: H and F + go. The capped
// kernels pack both in one 32-bit word, H (0..32767) in the low half and
// F + go (0..33021) in the high half. The uncapped ones (kWide: the realign
// pass, whose H passes 32767 on long self-matches) give each a 32-bit word
// of its own, one 64-bit word that a shuffle moves as two.
template <bool kWide>
struct HandOff {
  using Word = uint32_t;
  static __device__ __forceinline__ Word pack(int h, int f) {
    return (static_cast<uint32_t>(h) & 0xffffu) |
           (static_cast<uint32_t>(f) << 16);
  }
  static __device__ __forceinline__ int h(Word w) {
    return static_cast<int>(w & 0xffffu);
  }
  static __device__ __forceinline__ int f(Word w) {
    return static_cast<int>(w >> 16);
  }
};
template <>
struct HandOff<true> {
  using Word = unsigned long long;
  static __device__ __forceinline__ Word pack(int h, int f) {
    return static_cast<Word>(static_cast<uint32_t>(h)) |
           (static_cast<Word>(static_cast<uint32_t>(f)) << 32);
  }
  static __device__ __forceinline__ int h(Word w) {
    return static_cast<int>(static_cast<uint32_t>(w));
  }
  static __device__ __forceinline__ int f(Word w) {
    return static_cast<int>(static_cast<uint32_t>(w >> 32));
  }
};

// byte b of w, sign-extended (one PRMT: the selector's msb replicates the
// byte's sign)
__device__ __forceinline__ int sbyte(uint32_t w, int b) {
  const uint32_t sel = b | ((8 | b) << 4) | ((8 | b) << 8) | ((8 | b) << 12);
  int r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(w), "r"(sel));
  return r;
}

// One alignment in sweep coordinates: sweep row r is query row q[qs * r]
// (for a PSSM query, the alph scores at pm + qs * r * alph), sweep column c
// is target column t[ts * c]; rows and cols 0 for a group with no work.
struct Sweep {
  const uint8_t* q;
  const int8_t* qb;
  int qs;
  const uint8_t* t;
  int ts;
  int rows, cols;
  const int8_t* pm;
};

// A pair's rows: its query codes and biases (or, for a PSSM query, its
// profile's rows of alph scores, pm), its target codes, and its true
// lengths (0 for a pair with no work).
struct Rows {
  const uint8_t* q;
  const int8_t* qb;
  const uint8_t* t;
  int qn, tn;
  const int8_t* pm;
};

// K1/K2's pairs: pair b is row b of (B, Lq) query codes and biases and of
// (B, Lt) target codes.
struct PairRows {
  static constexpr bool kPssm = false;
  const uint8_t* q;
  const int8_t* qb;
  const int32_t* q_len;
  const uint8_t* t;
  const int32_t* t_len;
  int Lq, Lt;

  __device__ __forceinline__ Rows at(int b) const {
    return Rows{q + static_cast<size_t>(b) * Lq,
                qb + static_cast<size_t>(b) * Lq,
                t + static_cast<size_t>(b) * Lt, max(0, min(q_len[b], Lq)),
                max(0, min(t_len[b], Lt))};
  }
};

// K3/K4's pairs: lane b of tile b / 128 aligns staged query row qidx[b /
// 128] of (nq, Lq) against staged target row lj[b] of (nt, Lt); a padding
// lane (lj < 0) or tile (qidx < 0), or an index past the matrices, has no
// work.
struct TileRows {
  static constexpr bool kPssm = false;
  const uint8_t* q;
  const int8_t* qb;
  const int32_t* q_len;
  const uint8_t* t;
  const int32_t* t_len;
  const int32_t* qidx;
  const int32_t* lj;
  int nq, nt, Lq, Lt;

  __device__ __forceinline__ Rows at(int b) const {
    const int qi = qidx[b >> 7], tj = lj[b];
    const bool ok = qi >= 0 && qi < nq && tj >= 0 && tj < nt;
    const size_t qr = ok ? qi : 0, tr = ok ? tj : 0;
    return Rows{q + qr * Lq, qb + qr * Lq, t + tr * Lt,
                ok ? max(0, min(q_len[qi], Lq)) : 0,
                ok ? max(0, min(t_len[tj], Lt)) : 0};
  }
};

// The PSSM entries' pairs (the inverted profile search): pair b aligns
// profile li[b], rows of alph int8 scores of a staged (nP, Lq, alph)
// matrix, against fragment lj[b] of staged (nT, Lt) codes; an index below
// 0 or past the matrices has no work. No bias: 0 in the rows.
struct ProfRows {
  static constexpr bool kPssm = true;
  const int8_t* prof;
  const int32_t* p_len;
  const uint8_t* t;
  const int32_t* t_len;
  const int32_t* li;
  const int32_t* lj;
  int nP, nT, Lq, Lt, alph;

  __device__ __forceinline__ Rows at(int b) const {
    const int pi = li[b], tj = lj[b];
    const bool ok = pi >= 0 && pi < nP && tj >= 0 && tj < nT;
    const size_t pr = ok ? pi : 0, tr = ok ? tj : 0;
    return Rows{nullptr, nullptr, t + tr * Lt,
                ok ? max(0, min(p_len[pi], Lq)) : 0,
                ok ? max(0, min(t_len[tj], Lt)) : 0,
                prof + pr * Lq * alph};
  }
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
// and clobber memory, so they stay after the profile's stores and the
// ring's staging (ordered by __syncwarp or __syncthreads).
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
// the query profile (each warp's, or the block's), then each group's ring
// of target classes. Device functions address it by offsets from this
// base, which the compiler keeps in registers and folds into the shared
// loads.
extern __shared__ uint32_t smem[];

// The block's substitution matrix, padded to 32 x 32 with zeros.
__device__ __forceinline__ void stage_submat(const int32_t* submat,
                                             int alph) {
  int* sm = reinterpret_cast<int*>(smem);
  for (int x = threadIdx.x; x < kAlphPad * kAlphPad; x += blockDim.x) {
    const int r = x / kAlphPad, c = x % kAlphPad;
    sm[x] = (r < alph && c < alph) ? submat[r * alph + c] : 0;
  }
}

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

// One stripe of G R rows from sweep row `base`: (with kStage) stage this
// lane's profile words, from the substitution matrix and the query's codes
// or (kPssm) from the query's PSSM rows, then run the wavefront over every
// column. The lane's R scores against target class a are the R bytes at
// shared byte offset prof + a kClassBytes. `carry` (per-column H and F of
// the row before `base`, or null at the top) is read 32 columns at a time,
// a column a lane, 32 steps ahead, and handed to lane 0 by a shuffle;
// `carry_out` (the stripe's last row, or null when no stripe follows) is
// written by lane 31, in place: a column is read at least 32 steps before
// it is written. The group's target classes are staged in its ring two chunks of
// 64 columns ahead; a lane reads the class of its column two steps ahead
// and the profile words one step ahead, so no load waits in the step that
// uses it. ring is the group's ring (a byte offset of smem).
template <int G, int R, bool kCap, bool kStage, int kClassBytes,
          bool kPssm = false, bool kWide = false>
__device__ __forceinline__ void stripe(
    const Sweep& p, int base, int alph, int prof, int ring,
    const typename HandOff<kWide>::Word* carry,
    typename HandOff<kWide>::Word* carry_out, int go, int ge, Best& best) {
  using Link = HandOff<kWide>;
  using Word = typename Link::Word;
  constexpr int W = R / 4;   // profile words of a lane and class
  const int lane = threadIdx.x & 31;
  const int k = lane % G;
  const int row0 = base + k * R;     // this lane's first sweep row
  // the last lane of the group with a real row; the lanes past it idle
  const int last_k = p.rows > base ? min(G - 1, (p.rows - 1 - base) / R) : -1;
  const bool on = p.cols > 0 && k <= last_k;

  // the previous stripe's carry writes and ring reads, before this one's
  __syncwarp();
  int bias[R];
#pragma unroll
  for (int r = 0; r < R; ++r) bias[r] = kPadBias;
  if (on) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (row0 + r < p.rows) bias[r] = kPssm ? 0 : p.qb[p.qs * (row0 + r)];
    // each lane reads back only the profile words it writes here
    if constexpr (kStage && kPssm) {
      for (int a = 0; a < alph; ++a) {
        uint32_t w[W];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = row0 + r;
          const uint32_t byte =
              (i < p.rows ? static_cast<uint32_t>(static_cast<uint8_t>(
                                p.pm[p.qs * i * alph + a]))
                          : 0u)
              << (8 * (r % 4));
          w[r / 4] = r % 4 == 0 ? byte : w[r / 4] | byte;
        }
        store_words<W>(smem + (prof + a * kClassBytes) / 4, w);
      }
    } else if constexpr (kStage) {
      const int* sm = reinterpret_cast<const int*>(smem);
      int code[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = row0 + r;
        code[r] = i < p.rows ? min(static_cast<int>(p.q[p.qs * i]),
                                   kAlphPad - 1)
                             : 0;
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
        store_words<W>(smem + (prof + a * kClassBytes) / 4, w);
      }
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
  const Word edge = Link::pack(0, 0);   // row -1: H 0, F -go
  int hup = 0;             // H(row0 - 1, j - 1): column -1 is 0
  Word in = edge;          // H(row0 - 1, j) and F(row0, j) + go
  uint32_t wcur[W];        // the profile words of this step's column
  // shared byte addresses of this lane's profile (class 0) and of the
  // group's ring, kept in registers through the loop (the empty asm hides
  // their origin, so the compiler cannot recompute them from the thread
  // index in every step)
  const uint32_t smem_at =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint32_t prof_at = smem_at + prof;
  uint32_t ring_at = smem_at + ring;
  load_words<W>(prof_at + load_byte(ring_at + ((-k) & (kRing - 1))) *
                              kClassBytes, wcur);
  int a1 = load_byte(ring_at + ((1 - k) & (kRing - 1)));   // next class
  Word cw = 0, cw_next = 0;   // carry words of this and the next 32
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
      const Word c = __shfl_sync(kFull, cw, t & 31);
      if (k == 0) in = c;
    } else if (k == 0) {
      in = edge;
    }
    asm volatile("" : "+r"(prof_at), "+r"(ring_at));
    const int a2 = load_byte(ring_at + ((j + 2) & (kRing - 1)));
    uint32_t wnext[W];
    load_words<W>(prof_at + a1 * kClassBytes, wnext);
    Word out = 0;
    if (on && j >= 0 && j < p.cols) {
      int diag = hup;
      hup = Link::h(in);
      int f = Link::f(in);   // F + go, as e holds E + go
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
      out = Link::pack(hp[R - 1], f);
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

// The group's best under the order of both passes, in every lane.
template <int G>
__device__ __forceinline__ void reduce_best(Best& best) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const Best o{__shfl_xor_sync(kFull, best.score, off, G),
                 __shfl_xor_sync(kFull, best.row, off, G),
                 __shfl_xor_sync(kFull, best.col, off, G)};
    if (before(o.score, o.row, o.col, best)) best = o;
  }
}

// A pair's outputs from its group's best: forward (score, row, column) or
// no hit (0, Lq - 1, -1); reverse from the end cell (r0, c0), (score, r0 -
// row, c0 - column) or no hit (0, 0, -1).
template <bool kRev>
__device__ __forceinline__ void write_best(const Best& best, int b, int Lq,
                                           int r0, int c0,
                                           int32_t* score_out,
                                           int32_t* row_out,
                                           int32_t* col_out) {
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

// Aligns pair b (have: b is a pair of this group's, else the group sweeps
// nothing and writes nothing) with the warp-profile design: each group
// stages its own profile in its warp's share of shared memory (after the
// matrix), its ring of target classes after every warp's profile. G = 32
// sweeps any number of rows in stripes; a smaller G takes pairs of at most
// G R rows. Call with every lane of the warp, after stage_submat and a
// __syncthreads. kWide: H is not capped, and the hand-offs carry H and F +
// go in a 32-bit word each (HandOff<true>; carry then holds 8-byte words).
template <int G, int R, bool kRev, bool kWide = false, class PairsOf>
__device__ __forceinline__ void align_group(
    const PairsOf& pairs, int b, bool have, int alph, const int32_t* q_end,
    const int32_t* t_end, int go, int ge, void* carry,
    int32_t* score_out, int32_t* row_out, int32_t* col_out) {
  using Word = typename HandOff<kWide>::Word;
  constexpr bool kCap = !kWide;   // the warp class's stripes
  constexpr int kPairs = 32 / G;   // pairs a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr bool kPssm = PairsOf::kPssm;
  const Rows r = pairs.at(b);
  // the reverse pass starts at its end cell, cut to the true lengths
  const int r0 = kRev ? min(q_end[b], r.qn - 1) : r.qn - 1;
  const int c0 = kRev ? min(t_end[b], r.tn - 1) : r.tn - 1;
  Sweep p{r.q, r.qb, 1, r.t, 1, 0, 0, r.pm};
  if (have && r0 >= 0 && c0 >= 0) {
    if constexpr (!kRev)
      p = Sweep{r.q, r.qb, 1, r.t, 1, r0 + 1, c0 + 1, r.pm};
    else if constexpr (kPssm)
      p = Sweep{nullptr, nullptr, -1, r.t + c0, -1, r0 + 1, c0 + 1,
                r.pm + r0 * alph};
    else
      p = Sweep{r.q + r0, r.qb + r0, -1, r.t + c0, -1, r0 + 1, c0 + 1,
                nullptr};
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
    Word* pc = carry != nullptr ? static_cast<Word*>(carry) +
                                      static_cast<size_t>(b) * pairs.Lt
                                : nullptr;
    for (int base = 0; base < p.rows;) {   // uniform: one pair a warp
      const int left = p.rows - base;
      const Word* in = base > 0 ? pc : nullptr;
      if (left <= 32 * 4) {
        stripe<32, 4, kCap, true, 32 * 4, kPssm, kWide>(
            p, base, alph, 4 * (prof + lane), ring, in, nullptr, go, ge,
            best);
        base += 32 * 4;
      } else if (left <= 32 * 8) {
        stripe<32, 8, kCap, true, 32 * 8, kPssm, kWide>(
            p, base, alph, 4 * (prof + lane * 2), ring, in, nullptr, go, ge,
            best);
        base += 32 * 8;
      } else {
        stripe<32, kMaxRows, kCap, true, 32 * kMaxRows, kPssm, kWide>(
            p, base, alph, 4 * (prof + lane * (kMaxRows / 4)), ring, in,
            left > kStripe ? pc : nullptr, go, ge, best);
        base += kStripe;
      }
    }
  } else {
    // at most 128 rows: H <= 254 * 128 < 32767, the cap never binds
    stripe<G, R, (kCap && G * R > 128), true, 32 * R, kPssm, kWide>(
        p, 0, alph, 4 * (prof + lane * (R / 4)), ring, nullptr, nullptr, go,
        ge, best);
  }
  reduce_best<G>(best);
  if (have && lane % G == 0)
    write_best<kRev>(best, b, pairs.Lq, r0, c0, score_out, row_out, col_out);
}

// Words of the warp-profile kernels' shared memory: the matrix, each warp's
// profile and each group's ring.
template <int G, int R>
__host__ __device__ constexpr int group_smem_words(int alph) {
  return kAlphPad * kAlphPad + kWarps * alph * 32 * (R / 4) +
         kWarps * (32 / G) * (kRingStride / 4);
}

// Sets a kernel's dynamic shared memory limit where it passes 48 KB.
template <class Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

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

// Runs launch_class(c, side stream c) for the kClasses classes, each on
// its side stream, forked from and joined back into `stream`: work queued
// on `stream` after this call runs after every class. Returns the first
// error (0 on success).
template <class LaunchClass>
int on_side_streams(cudaStream_t stream, LaunchClass launch_class) {
  std::lock_guard<std::mutex> lock(side_mutex);
  SideStreams* sd = nullptr;
  cudaError_t err = side_streams(&sd);
  if (err == cudaSuccess) err = cudaEventRecord(sd->fork, stream);
  for (int c = 0; c < kClasses && err == cudaSuccess; ++c)
    err = cudaStreamWaitEvent(sd->stream[c], sd->fork, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = 0;
  for (int c = 0; c < kClasses && rc == 0; ++c)
    rc = launch_class(c, sd->stream[c]);
  // join every stream, also after a failed launch
  for (int c = 0; c < kClasses; ++c) {
    err = cudaEventRecord(sd->join[c], sd->stream[c]);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(stream, sd->join[c], 0);
    if (rc == 0 && err != cudaSuccess) rc = static_cast<int>(err);
  }
  return rc;
}

}  // namespace
