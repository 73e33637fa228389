// Query-major Smith-Waterman kernels for NVIDIA Hopper (sm_90a): a group of
// G lanes per (tile, lane) pair, the query's rows in the group's registers,
// the target's columns streamed through the group as a wavefront
// (csrc/sw_group.cuh, the machinery of the pair kernels K1/K2).
//
// sw_qm_ends   replaces metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_qm (K3):
//              forward affine-gap local alignment ends, one query against
//              the 128 target lanes of a tile.
// sw_qm_starts replaces metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_qm_rev (K4):
//              the reverse-prefix pass that finds the starts from known ends.
// Both also replace sw_pallas.py::build_prof_tiles and ::build_tcodes_T: the
// kernels read the staged (nq, Lq) query rows and (nt, Lt) target rows and
// the tile's lane map directly. On the ungapped path (MetaEuk's GPU mode)
// they take every query with 48 candidates or more in its length bucket.
//
// K3. All 128 lanes of a tile share its query, so a block never spans two
// tiles and stages the tile's int8 query profile once for all its groups
// (K1 stages one a warp): class a's row holds the scores of the stripe's G
// R rows against a, and lane k of a group reads its R bytes k R .. k R + R
// - 1 with one 8- or 16-byte shared load a column, the bias added after
// the load. Where a class's row is shorter than 128 bytes (G R < 128: the
// (4, 8) and (8, 8) classes) it is repeated to 128 bytes and group g of a
// warp reads copy g % (128 / (G R)), so the groups of a half-warp, which
// read different classes, hit different banks. A tile's class is the first
// of sw_cuda.PAIR_CLASSES whose G R rows cover its true query length (G
// lanes a pair, R rows a lane; a warp per pair in row stripes of 512 above
// 256 rows, the block staging each stripe's profile in turn). Each class
// runs one launch of its template instance, a block per 4 (32 / G) lanes
// of every tile, the five at once on side streams forked from and joined
// to the caller's stream; a block whose tile is of another class returns
// at once. A block ranks its tile's 128 lanes by target length, longest
// first and padding lanes last (a thread a lane, one pass over the
// block's 128 keys in shared memory), so that the groups of a warp end
// together and a block whose first lane has no work has none (it writes
// its lanes' no-hit values and stages nothing). There is no work list and
// no host synchronisation.
//
// K4. Each lane has its own end cell, so the rows a lane sweeps (rows qe..0
// of its query, columns te..0 of its target) differ within a tile, and no
// profile is shared: K4 runs K2's warp-profile design (align_group in
// sw_group.cuh, each group staging its own profile in sweep coordinates)
// on the tile's lanes. A lane's class is the one of the rows it sweeps;
// each class launch runs a block per 4 (32 / G) lanes of every tile, and a
// block counts its tile's lanes of its class (one __syncthreads_count),
// returns if its share is past them, and otherwise ranks those lanes by
// the columns they sweep, most first, as K3 does. Dead lanes (lj < 0, a
// padding tile, an end of -1) sweep nothing and write the no-hit values.
// Neither kernel takes a work list from the host.
//
// The contract (the Pallas kernels'), the tie-breaks and what bounds both
// kernels are in sw_group.cuh: H starts at 0, E and F at -go, H is capped
// at 32767; forward ties go to the first column, then the smallest row, no
// hit gives (0, Lq-1, -1) with Lq the tier width; reverse ties to the last
// column, then the largest row, no hit (0, 0, -1). The loops stop at the
// true lengths: a padded cell (scored -128 through code 21 or a masked
// profile row on the TPU) never strictly improves the best and never feeds
// a real cell, so skipping it gives the same result. The TPU's 512-column
// chunks and bf16 profile have no counterpart here. Device memory holds the
// staged inputs, the outputs, the work lists and, for query tiers over 512
// rows, the stripe hand-off (tiles * 128, Lt) words; there is no H/E
// scratch.

#include "sw_group.cuh"

namespace {

constexpr int kLanes = 128;   // lanes a tile (sw_torch.TB)

// Bytes of a class's row of the block profile: G R, at least 128 (one copy
// per group of a half-warp); a warp per pair stages stripes of up to 512.
template <int G, int R>
constexpr int kProfileRow =
    G == 32 ? 32 * kMaxRows : (G * R > 128 ? G * R : 128);

// The block's query profile of rows [base, base + G R) of the tile's query
// (codes q, qn rows) at shared byte offset prof: class a's kRow bytes at
// prof + a kRow, byte x the int8 score of row base + x % (G R) against a
// (of code 0 for a row at or past qn, whose bias is kPadBias). Call after
// stage_submat and a __syncthreads.
template <int G, int R, int kRow>
__device__ __forceinline__ void stage_tile_profile(const uint8_t* q, int qn,
                                                   int base, int alph,
                                                   int prof) {
  const int* sm = reinterpret_cast<const int*>(smem);
  constexpr int kWords = kRow / 4;
  for (int x = threadIdx.x; x < alph * kWords; x += blockDim.x) {
    const int a = x / kWords, w = x % kWords;
    uint32_t word = 0;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int i = base + (4 * w + y) % (G * R);
      const int code = i < qn ? min(static_cast<int>(q[i]), kAlphPad - 1) : 0;
      word |= (static_cast<uint32_t>(sm[code * kAlphPad + a]) & 0xffu)
              << (8 * y);
    }
    smem[prof / 4 + x] = word;
  }
}

// The class of a sweep of n rows in sw_cuda.PAIR_CLASSES: the first whose
// G R rows cover it (32, 64, 128, 256), else the warp class.
__device__ __forceinline__ int length_class(int n) {
  return (n > 32) + (n > 64) + (n > 128) + (n > 256);
}

// Ranks a tile's 128 lanes, a thread a lane (call with the block's 128
// threads): the lanes with `mine` set first, by `cols`, most first (ties
// by lane), the others after; order[rank] = lane, the keys at `keys`.
// Returns how many lanes have `mine` set, or -1, having ranked nothing,
// where that is at most `skip` (a block whose share of the order starts at
// `skip` has no lane then).
__device__ __forceinline__ int rank_lanes(bool mine, int cols, int skip,
                                          int* keys, int* order) {
  const int me = threadIdx.x;
  const int key = (mine ? 0 : 1 << 30) + ((1 << 22) - cols) * kLanes + me;
  keys[me] = key;
  const int count = __syncthreads_count(mine);
  if (count <= skip) return -1;   // uniform over the block
  int rank = 0;
#pragma unroll 8
  for (int i = 0; i < kLanes; ++i) rank += keys[i] < key;
  order[rank] = me;
  __syncthreads();
  return count;
}

// K3's class instance (G, R): block x aligns 4 (32 / G) lanes of tile x /
// kBlocks, 32 / G a warp, if the tile's query falls in class cls (the
// other blocks return at once). The block ranks the tile's 128 lanes by
// target length, longest first (ties by lane), and takes places (x %
// kBlocks) 4 (32 / G) onwards of that order.
template <int G, int R>
__global__ void __launch_bounds__(kLanes) sw_qm_ends_kernel(
    const int32_t* __restrict__ submat, int alph, TileRows tiles, int go,
    int ge, int cls, uint32_t* __restrict__ carry,
    int32_t* __restrict__ score_out, int32_t* __restrict__ row_out,
    int32_t* __restrict__ col_out) {
  static_assert(32 * kWarps == kLanes, "a thread per lane of a tile");
  constexpr int kPairs = 32 / G;                        // pairs a warp
  constexpr int kBlocks = kLanes / (kWarps * kPairs);   // blocks a tile
  constexpr int kRow = kProfileRow<G, R>;
  // shared words: the matrix, the lanes' keys and order, then (bytes from
  // kProf) the profile and the rings
  constexpr int kKeys = kAlphPad * kAlphPad, kOrder = kKeys + kLanes;
  constexpr int kProf = 4 * (kOrder + kLanes);
  const int tile = blockIdx.x / kBlocks;
  const int qi = tiles.qidx[tile];
  const int qn = qi >= 0 && qi < tiles.nq
                     ? max(0, min(tiles.q_len[qi], tiles.Lq)) : 0;
  if (length_class(qn) != cls) return;   // uniform over the block
  int* order = reinterpret_cast<int*>(smem) + kOrder;
  rank_lanes(true, tiles.at(tile * kLanes + threadIdx.x).tn, -1,
             reinterpret_cast<int*>(smem) + kKeys, order);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* lanes = order + (blockIdx.x % kBlocks) * kWarps * kPairs;
  const int b = tile * kLanes + lanes[warp * kPairs + lane / G];
  const Rows r = tiles.at(b);
  // every lane has the tile's query; the block's first lane has the
  // longest target of its lanes
  const Rows first = tiles.at(tile * kLanes + lanes[0]);
  Best best{0, 0, INT_MAX};
  if (first.qn > 0 && first.tn > 0) {   // uniform over the block
    stage_submat(submat, alph);
    // each group's ring of target classes after the profile, zeroed so
    // that a look-behind past the left edge reads a class
    const int rings = kProf + alph * kRow + warp * kPairs * kRingStride;
    for (int x = lane; x < kPairs * (kRingStride / 4); x += 32)
      smem[rings / 4 + x] = 0;
    const int ring = rings + (lane / G) * kRingStride;
    Sweep p{r.q, r.qb, 1, r.t, 1, 0, 0};
    if (r.qn > 0 && r.tn > 0) {
      p.rows = r.qn;
      p.cols = r.tn;
    }
    if constexpr (G == 32) {
      uint32_t* pc = carry != nullptr ? carry + static_cast<size_t>(b) *
                                                tiles.Lt
                                      : nullptr;
      for (int base = 0; base < first.qn;) {   // uniform: the tile's rows
        const int left = first.qn - base;
        const uint32_t* in = base > 0 ? pc : nullptr;
        __syncthreads();   // the matrix staged, the last stripe's reads done
        if (left <= 32 * 4) {
          stage_tile_profile<32, 4, 32 * 4>(first.q, first.qn, base, alph,
                                            kProf);
          __syncthreads();
          stripe<32, 4, true, false, 32 * 4>(p, base, alph,
                                             kProf + lane * 4, ring, in,
                                             nullptr, go, ge, best);
          base += 32 * 4;
        } else if (left <= 32 * 8) {
          stage_tile_profile<32, 8, 32 * 8>(first.q, first.qn, base, alph,
                                            kProf);
          __syncthreads();
          stripe<32, 8, true, false, 32 * 8>(p, base, alph,
                                             kProf + lane * 8, ring, in,
                                             nullptr, go, ge, best);
          base += 32 * 8;
        } else {
          stage_tile_profile<32, kMaxRows, kStripe>(first.q, first.qn, base,
                                                    alph, kProf);
          __syncthreads();
          stripe<32, kMaxRows, true, false, kStripe>(
              p, base, alph, kProf + lane * kMaxRows, ring, in,
              left > kStripe ? pc : nullptr, go, ge, best);
          base += kStripe;
        }
      }
    } else {
      __syncthreads();   // the matrix staged
      stage_tile_profile<G, R, kRow>(first.q, first.qn, 0, alph, kProf);
      __syncthreads();
      // at most 128 rows: H <= 254 * 128 < 32767, the cap never binds
      stripe<G, R, (G * R > 128), false, kRow>(
          p, 0, alph, kProf + (lane * R) % kRow, ring, nullptr, nullptr, go,
          ge, best);
    }
    reduce_best<G>(best);
  }
  if (lane % G == 0)
    write_best<false>(best, b, tiles.Lq, 0, 0, score_out, row_out, col_out);
}

struct QmArgs {
  const int32_t* submat;
  int alph;
  TileRows tiles;
  int n_tiles, go, ge;
  uint32_t* carry;
  int32_t *score, *row, *col;
};

// One launch of K3's class cls on `stream`: a block per 4 (32 / G) lanes
// of every tile, since the tiles' classes are found on the device.
template <int G, int R>
int launch_qm_class(const QmArgs& a, int cls, cudaStream_t stream) {
  constexpr int kPairs = 32 / G;
  const size_t bytes = 4 * (kAlphPad * kAlphPad + 2 * kLanes) +
                       static_cast<size_t>(a.alph) * kProfileRow<G, R> +
                       kWarps * kPairs * kRingStride;
  const int rc = allow_smem(sw_qm_ends_kernel<G, R>, bytes);
  if (rc != 0) return rc;
  const int blocks = a.n_tiles * (kLanes / (kWarps * kPairs));
  sw_qm_ends_kernel<G, R><<<blocks, kLanes, bytes, stream>>>(
      a.submat, a.alph, a.tiles, a.go, a.ge, cls, a.carry, a.score, a.row,
      a.col);
  return static_cast<int>(cudaGetLastError());
}

// K4's class instance (G, R): block x aligns, with the warp-profile design,
// the lanes of tile x / kBlocks whose reverse sweep falls in class cls,
// places (x % kBlocks) 4 (32 / G) onwards of their order by the columns
// they sweep, 32 / G a warp.
template <int G, int R>
__global__ void __launch_bounds__(kLanes) sw_qm_starts_kernel(
    const int32_t* __restrict__ submat, int alph, TileRows tiles,
    const int32_t* __restrict__ q_end, const int32_t* __restrict__ t_end,
    int go, int ge, int cls, uint32_t* __restrict__ carry,
    int32_t* __restrict__ score_out, int32_t* __restrict__ row_out,
    int32_t* __restrict__ col_out) {
  constexpr int kPairs = 32 / G;                        // pairs a warp
  constexpr int kBlocks = kLanes / (kWarps * kPairs);   // blocks a tile
  const int tile = blockIdx.x / kBlocks;
  const int first = (blockIdx.x % kBlocks) * kWarps * kPairs;
  // the rows and columns this thread's lane sweeps, as align_group does
  const int me = tile * kLanes + threadIdx.x;
  const Rows r = tiles.at(me);
  const int rows = max(0, min(q_end[me], r.qn - 1) + 1);
  const int cols = max(0, min(t_end[me], r.tn - 1) + 1);
  // the lanes' keys and order after the profiles and the rings
  int* keys = reinterpret_cast<int*>(smem) + group_smem_words<G, R>(alph);
  const int count = rank_lanes(length_class(rows) == cls, cols, first, keys,
                               keys + kLanes);
  if (count < 0) return;   // uniform over the block
  stage_submat(submat, alph);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot0 = first + warp * kPairs;
  if (slot0 >= count) return;   // uniform over the warp
  const int slot = slot0 + lane / G;
  const bool have = slot < count;
  align_group<G, R, true>(tiles,
                          tile * kLanes + keys[kLanes + (have ? slot : slot0)],
                          have, alph, q_end, t_end, go, ge, carry, score_out,
                          row_out, col_out);
}

struct StartsArgs {
  const int32_t* submat;
  int alph;
  TileRows tiles;
  const int32_t* q_end;
  const int32_t* t_end;
  int n_tiles, go, ge;
  uint32_t* carry;
  int32_t *score, *row, *col;
};

// One launch of K4's class cls on `stream`: a block per 4 (32 / G) lanes
// of every tile.
template <int G, int R>
int launch_starts_class(const StartsArgs& a, int cls, cudaStream_t stream) {
  const size_t bytes = 4 * (group_smem_words<G, R>(a.alph) + 2 * kLanes);
  const int rc = allow_smem(sw_qm_starts_kernel<G, R>, bytes);
  if (rc != 0) return rc;
  const int blocks = a.n_tiles * (kLanes / (kWarps * (32 / G)));
  sw_qm_starts_kernel<G, R><<<blocks, kLanes, bytes, stream>>>(
      a.submat, a.alph, a.tiles, a.q_end, a.t_end, a.go, a.ge, cls, a.carry,
      a.score, a.row, a.col);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int alph, int Lq, int Lt, const uint32_t* carry) {
  return alph < 1 || alph > kAlphPad || Lq < 1 || Lt < 1 ||
         (Lq > kStripe && carry == nullptr);
}

}  // namespace

// q_mat, qb_mat: (nq, Lq) staged query codes and biases; t_mat: (nt, Lt)
// staged target codes; qidx: (n_tiles,) query row per tile; lj: (n_tiles *
// 128,) target row per lane; carry: (n_tiles * 128, Lt) words for the
// row-stripe hand-off, needed (non-null) only when Lq > 512.
// Substitution scores must fit int8. Every pointer is on the device; the
// launches are ordered after the work queued on `stream` and before the
// work queued on it later (five side streams, one a class, forked and
// joined by events), and do not synchronise the host. Returns the error of
// an attribute call, a stream or event call or a launch (0 on success).
extern "C" int sw_qm_ends(const int32_t* submat, int alph,
                          const uint8_t* q_mat, const int8_t* qb_mat,
                          const int32_t* q_lens, int nq, int Lq,
                          const uint8_t* t_mat, const int32_t* t_lens, int nt,
                          int Lt, const int32_t* qidx, const int32_t* lj,
                          int n_tiles, int go, int ge, uint32_t* carry,
                          int32_t* best, int32_t* q_end, int32_t* t_end,
                          void* stream) {
  const QmArgs a{submat, alph,
                 TileRows{q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj, nq,
                          nt, Lq, Lt},
                 n_tiles, go, ge, carry, best, q_end, t_end};
  if (bad_shape(alph, Lq, Lt, carry))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  return on_side_streams(
      static_cast<cudaStream_t>(stream), [&](int c, cudaStream_t s) {
        switch (c) {
          case 0: return launch_qm_class<4, 8>(a, 0, s);
          case 1: return launch_qm_class<8, 8>(a, 1, s);
          case 2: return launch_qm_class<16, 8>(a, 2, s);
          case 3: return launch_qm_class<16, 16>(a, 3, s);
          default: return launch_qm_class<32, kMaxRows>(a, 4, s);
        }
      });
}

// As sw_qm_ends for the reverse pass, with each lane's known ends q_end,
// t_end: (n_tiles * 128,).
extern "C" int sw_qm_starts(const int32_t* submat, int alph,
                            const uint8_t* q_mat, const int8_t* qb_mat,
                            const int32_t* q_lens, int nq, int Lq,
                            const uint8_t* t_mat, const int32_t* t_lens,
                            int nt, int Lt, const int32_t* qidx,
                            const int32_t* lj, const int32_t* q_end,
                            const int32_t* t_end, int n_tiles, int go, int ge,
                            uint32_t* carry, int32_t* score,
                            int32_t* q_start, int32_t* t_start,
                            void* stream) {
  const StartsArgs a{submat, alph,
                     TileRows{q_mat, qb_mat, q_lens, t_mat, t_lens, qidx, lj,
                              nq, nt, Lq, Lt},
                     q_end, t_end, n_tiles, go, ge, carry, score, q_start,
                     t_start};
  if (bad_shape(alph, Lq, Lt, carry))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  return on_side_streams(
      static_cast<cudaStream_t>(stream), [&](int c, cudaStream_t s) {
        switch (c) {
          case 0: return launch_starts_class<4, 8>(a, 0, s);
          case 1: return launch_starts_class<8, 8>(a, 1, s);
          case 2: return launch_starts_class<16, 8>(a, 2, s);
          case 3: return launch_starts_class<16, 16>(a, 3, s);
          default: return launch_starts_class<32, kMaxRows>(a, 4, s);
        }
      });
}
