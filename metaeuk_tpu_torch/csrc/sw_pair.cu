// Smith-Waterman pair kernels for NVIDIA Hopper (sm_90a): a group of G
// lanes per (fragment, target) pair, the fragment's rows in the group's
// registers, the target's columns streamed through the group as a
// wavefront.
//
// sw_pair_ends   replaces metaeuk_tpu/ops/sw_pallas.py::_dp_kernel (K1):
//                forward affine-gap local alignment ends.
// sw_pair_starts replaces metaeuk_tpu/ops/sw_pallas.py::_dp_kernel_rev (K2):
//                the reverse-prefix pass that finds the starts.
// sw_pair_ends_prof, sw_pair_starts_prof are the same two kernels on a PSSM
//                query (the inverted profile search: a profile's rows
//                against a fragment's columns), in place of
//                sw_pallas.py::_align_full_prof over _build_S_prof.
// sw_pair_ends_nocap, sw_pair_starts_nocap and their PSSM twins
//                sw_pair_ends_prof_nocap, sw_pair_starts_prof_nocap are
//                the uncapped instances (H not capped at 32767), in place
//                of the JAX package's XLA code: sw_jax.py sw_align_batch
//                (the realign pass) and sw_align_batch_prof (the
//                profile-query aligner, search/profile_align.py).
// Both also replace sw_pallas.py::_build_S_gapped: the score of cell (i, j)
// is submat[q_i][t_j] + bias_i, read from an int8 query profile in shared
// memory with the bias added after the load, instead of an int8 (Lt_pad,
// Lq, B) score tensor. The JAX driver sends them every pair whose fragment
// has fewer than 48 candidates in its length bucket; on the k-mer main
// path that is every pair: fragments of about 24-450 aa (median 67)
// against targets of about 120-550 aa (median 412).
//
// Design (csrc/sw_group.cuh, shared with K3/K4). The fragment is the short
// axis, so the state a pair carries is one column of the fragment, and it
// fits in registers. The wrapper (ops/sw_cuda.py pair_classes) sorts a
// launch's pairs into length classes by the rows n they sweep, and within a
// class by columns; it passes the order and the class bounds, and each
// class runs one launch of its own template instance of sw_pair_kernel,
// the five at once on side streams (a class alone holds too few warps to
// fill the card) (G lanes a pair, R rows a lane, 32 / G pairs a warp):
//   n <= 32: (4, 8); <= 64: (8, 8); <= 128: (16, 8); <= 256: (16, 16);
//   longer: (32, R), a warp per pair, in row stripes of 512 with R = 16,
//   the last stripe at the least R of 4, 8 or 16 that covers its rows.
// Each warp stages, per stripe, its own int8 query profile in shared memory
// (prof[a][lane] = the scores of the lane's R rows against target class a),
// so one shared load per column gives a lane all R of its scores. The
// reverse pass is the forward sweep over rows qe..0 and columns te..0
// (each cut to the true lengths), counted from the end cell, as in
// sw_qm_rt.cu. The PSSM entries read pair b's profile li[b] and fragment
// lj[b] from staged matrices (ProfRows in sw_group.cuh: no gathered (B, Lq,
// 21) copy exists): each lane stages its rows' int8 scores against the
// alph classes straight from the profile's rows, with no bias, and the
// sweep is the same. The contract, the tie-breaks and what bounds the
// kernel are in sw_group.cuh.

#include "sw_group.cuh"

namespace {

// K1/K2's class instance (G, R): 32 / G pairs a warp, the pairs
// order[lo..hi) of class cls (lo = bounds[cls - 1], hi = bounds[cls]);
// Pairs is PairRows (sequence queries) or ProfRows (PSSM queries); kWide:
// the uncapped instance (align_group).
template <int G, int R, bool kRev, bool kWide, class Pairs>
__global__ void __launch_bounds__(32 * kWarps) sw_pair_kernel(
    const int32_t* __restrict__ submat, int alph, Pairs pairs,
    const int32_t* __restrict__ q_end, const int32_t* __restrict__ t_end,
    int go, int ge, const int32_t* __restrict__ order,
    const int32_t* __restrict__ bounds, int cls,
    void* __restrict__ carry, int32_t* __restrict__ score_out,
    int32_t* __restrict__ row_out, int32_t* __restrict__ col_out) {
  constexpr int kPairs = 32 / G;   // pairs a warp
  const int lo = cls > 0 ? bounds[cls - 1] : 0, hi = bounds[cls];
  const int block0 = lo + blockIdx.x * kWarps * kPairs;
  if (block0 >= hi) return;   // uniform over the block
  if constexpr (!Pairs::kPssm) stage_submat(submat, alph);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot0 = block0 + warp * kPairs;
  if (slot0 >= hi) return;   // uniform over the warp
  const int slot = slot0 + lane / G;
  const bool have = slot < hi;
  align_group<G, R, kRev, kWide>(pairs, order[have ? slot : slot0], have,
                                 alph, q_end, t_end, go, ge, carry,
                                 score_out, row_out, col_out);
}

// One launch of K1/K2.
template <class Pairs>
struct GroupArgs {
  const int32_t* submat;
  int alph;
  Pairs pairs;
  const int32_t* q_end;
  const int32_t* t_end;
  int B, go, ge;
  const int32_t* order;
  const int32_t* bounds;
  void* carry;   // 4-byte words, 8-byte in the uncapped instances
  int32_t *score, *row, *col;
};

// One launch of class cls on `stream`: a block per 4 (32 / G) slots of the
// whole batch, since the class bounds stay on the device; blocks past the
// class return at once.
template <int G, int R, bool kRev, bool kWide, class Pairs>
int launch_group_class(const GroupArgs<Pairs>& a, int cls,
                       cudaStream_t stream) {
  const size_t bytes = 4 * group_smem_words<G, R>(a.alph);
  const int rc = allow_smem(sw_pair_kernel<G, R, kRev, kWide, Pairs>, bytes);
  if (rc != 0) return rc;
  const int per_block = kWarps * (32 / G);
  sw_pair_kernel<G, R, kRev, kWide, Pairs>
      <<<(a.B + per_block - 1) / per_block, 32 * kWarps, bytes, stream>>>(
      a.submat, a.alph, a.pairs, a.q_end, a.t_end, a.go, a.ge, a.order,
      a.bounds, cls, a.carry, a.score, a.row, a.col);
  return static_cast<int>(cudaGetLastError());
}

// K1/K2's classes of sw_cuda.PAIR_CLASSES, each on its side stream
// (on_side_streams). The uncapped instances (kWide) differ only in classes
// 3 and 4: classes 0-2 sweep at most 128 rows, where the capped instance
// never caps (align_group) and H fits its 16-bit hand-off, so they launch
// the capped instance.
template <bool kRev, bool kWide, class Pairs>
int launch_groups(const GroupArgs<Pairs>& a, cudaStream_t stream) {
  if (a.alph < 1 || a.alph > kAlphPad || a.pairs.Lq < 1 || a.pairs.Lt < 1 ||
      (a.pairs.Lq > kStripe && a.carry == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B <= 0) return static_cast<int>(cudaGetLastError());
  return on_side_streams(stream, [&](int c, cudaStream_t s) {
    switch (c) {
      case 0: return launch_group_class<4, 8, kRev, false>(a, 0, s);
      case 1: return launch_group_class<8, 8, kRev, false>(a, 1, s);
      case 2: return launch_group_class<16, 8, kRev, false>(a, 2, s);
      case 3: return launch_group_class<16, 16, kRev, kWide>(a, 3, s);
      default: return launch_group_class<32, kMaxRows, kRev, kWide>(a, 4, s);
    }
  });
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
  return launch_groups<false, false>(
      GroupArgs<PairRows>{submat, alph,
                          PairRows{q, qb, q_len, t, t_len, Lq, Lt}, nullptr,
                          nullptr, B, go, ge, order, bounds, carry, best,
                          q_end, t_end},
      static_cast<cudaStream_t>(stream));
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
  return launch_groups<true, false>(
      GroupArgs<PairRows>{submat, alph,
                          PairRows{q, qb, q_len, t, t_len, Lq, Lt}, q_end,
                          t_end, B, go, ge, order, bounds, carry, score,
                          q_start, t_start},
      static_cast<cudaStream_t>(stream));
}

// The PSSM entries. prof: (nP, Lq, alph) int8 PSSM rows, p_len: (nP,); t:
// (nT, Lt) fragment codes, t_len: (nT,); pair b aligns profile li[b] with
// fragment lj[b] (li, lj: (B,)); order and bounds over the pairs' swept
// rows and columns (pair_classes of p_len[li], t_len[lj]); carry as above.
// The scores need no check here: they are int8. Otherwise as sw_pair_ends.
extern "C" int sw_pair_ends_prof(const int8_t* prof, int alph,
                                 const int32_t* p_len, int nP, int Lq,
                                 const uint8_t* t, const int32_t* t_len,
                                 int nT, int Lt, const int32_t* li,
                                 const int32_t* lj, int B, int go, int ge,
                                 const int32_t* order, const int32_t* bounds,
                                 uint32_t* carry, int32_t* best,
                                 int32_t* q_end, int32_t* t_end,
                                 void* stream) {
  return launch_groups<false, false>(
      GroupArgs<ProfRows>{nullptr, alph,
                          ProfRows{prof, p_len, t, t_len, li, lj, nP, nT, Lq,
                                   Lt, alph},
                          nullptr, nullptr, B, go, ge, order, bounds, carry,
                          best, q_end, t_end},
      static_cast<cudaStream_t>(stream));
}

// As sw_pair_ends_prof, with each pair's known ends q_end, t_end: (B,).
extern "C" int sw_pair_starts_prof(const int8_t* prof, int alph,
                                   const int32_t* p_len, int nP, int Lq,
                                   const uint8_t* t, const int32_t* t_len,
                                   int nT, int Lt, const int32_t* li,
                                   const int32_t* lj, const int32_t* q_end,
                                   const int32_t* t_end, int B, int go,
                                   int ge, const int32_t* order,
                                   const int32_t* bounds, uint32_t* carry,
                                   int32_t* score, int32_t* q_start,
                                   int32_t* t_start, void* stream) {
  return launch_groups<true, false>(
      GroupArgs<ProfRows>{nullptr, alph,
                          ProfRows{prof, p_len, t, t_len, li, lj, nP, nT, Lq,
                                   Lt, alph},
                          q_end, t_end, B, go, ge, order, bounds, carry,
                          score, q_start, t_start},
      static_cast<cudaStream_t>(stream));
}

// The uncapped instances of sw_pair_ends / sw_pair_starts (the realign
// pass: sw_jax.sw_align_batch's contract, H not capped at 32767): the same
// arguments, with carry holding (B, Lt) 8-byte words (H and F + go in 32
// bits each) when Lq > 512.
extern "C" int sw_pair_ends_nocap(const int32_t* submat, int alph,
                                  const uint8_t* q, const int8_t* qb,
                                  const int32_t* q_len, const uint8_t* t,
                                  const int32_t* t_len, int B, int Lq,
                                  int Lt, int go, int ge,
                                  const int32_t* order,
                                  const int32_t* bounds, void* carry,
                                  int32_t* best, int32_t* q_end,
                                  int32_t* t_end, void* stream) {
  return launch_groups<false, true>(
      GroupArgs<PairRows>{submat, alph,
                          PairRows{q, qb, q_len, t, t_len, Lq, Lt}, nullptr,
                          nullptr, B, go, ge, order, bounds, carry, best,
                          q_end, t_end},
      static_cast<cudaStream_t>(stream));
}

extern "C" int sw_pair_starts_nocap(const int32_t* submat, int alph,
                                    const uint8_t* q, const int8_t* qb,
                                    const int32_t* q_len, const uint8_t* t,
                                    const int32_t* t_len,
                                    const int32_t* q_end,
                                    const int32_t* t_end, int B, int Lq,
                                    int Lt, int go, int ge,
                                    const int32_t* order,
                                    const int32_t* bounds, void* carry,
                                    int32_t* score, int32_t* q_start,
                                    int32_t* t_start, void* stream) {
  return launch_groups<true, true>(
      GroupArgs<PairRows>{submat, alph,
                          PairRows{q, qb, q_len, t, t_len, Lq, Lt}, q_end,
                          t_end, B, go, ge, order, bounds, carry, score,
                          q_start, t_start},
      static_cast<cudaStream_t>(stream));
}

// The uncapped instances of sw_pair_ends_prof / sw_pair_starts_prof (the
// profile-query aligner: sw_jax.sw_align_batch_prof's contract, H not
// capped at 32767): the same arguments, with carry holding (B, Lt) 8-byte
// words when Lq > 512.
extern "C" int sw_pair_ends_prof_nocap(const int8_t* prof, int alph,
                                       const int32_t* p_len, int nP, int Lq,
                                       const uint8_t* t,
                                       const int32_t* t_len, int nT, int Lt,
                                       const int32_t* li, const int32_t* lj,
                                       int B, int go, int ge,
                                       const int32_t* order,
                                       const int32_t* bounds, void* carry,
                                       int32_t* best, int32_t* q_end,
                                       int32_t* t_end, void* stream) {
  return launch_groups<false, true>(
      GroupArgs<ProfRows>{nullptr, alph,
                          ProfRows{prof, p_len, t, t_len, li, lj, nP, nT, Lq,
                                   Lt, alph},
                          nullptr, nullptr, B, go, ge, order, bounds, carry,
                          best, q_end, t_end},
      static_cast<cudaStream_t>(stream));
}

extern "C" int sw_pair_starts_prof_nocap(
    const int8_t* prof, int alph, const int32_t* p_len, int nP, int Lq,
    const uint8_t* t, const int32_t* t_len, int nT, int Lt,
    const int32_t* li, const int32_t* lj, const int32_t* q_end,
    const int32_t* t_end, int B, int go, int ge, const int32_t* order,
    const int32_t* bounds, void* carry, int32_t* score, int32_t* q_start,
    int32_t* t_start, void* stream) {
  return launch_groups<true, true>(
      GroupArgs<ProfRows>{nullptr, alph,
                          ProfRows{prof, p_len, t, t_len, li, lj, nP, nT, Lq,
                                   Lt, alph},
                          q_end, t_end, B, go, ge, order, bounds, carry,
                          score, q_start, t_start},
      static_cast<cudaStream_t>(stream));
}
