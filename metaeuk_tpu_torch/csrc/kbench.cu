// Microbenchmark kernels for NVIDIA Hopper (sm_90a): what one step of an SW
// column recurrence costs on the card.
//
// kb_alu   replaces tools/kbench.py::make_alu_case (T1): `reps` times
//          b = a; n_ops / 2 times b = max(b + 1, a); a = b, elementwise.
// kb_shift replaces tools/kbench.py::make_shift_case (T2): `reps` times
//          a = max(a, a moved down the rows by `amount`), zero fill or
//          wrapped round (pltpu.roll(a, amount, 0), torch.roll's direction).
// kb_scan  replaces tools/kbench.py::make_scan_case (T3): `reps` / 8 times
//          a = cummax_down(a) - 1, the Pallas kernel's log-step max-scan with
//          fill NEG (which it is exactly, NEG included: see scan_kernel).
//
// kb_alu: one thread per 32-bit word, the chain in registers, one
// instruction per step where the card has one:
//   int32     __viaddmax_s32(b, 1, a)            (DPX add-max)
//   int16     __viaddmax_s16x2 on two packed lanes (DPX, two lanes a word)
//   float32   fmaxf(b + 1, a)                    (add, then max)
//   bfloat16  __hmax2(__hadd2(b, 1), a) on __nv_bfloat162 (round to nearest
//             even after the add, as torch and XLA round: b + 1 stops
//             growing at 256)
// The increment is a kernel argument, so the compiler cannot fold
// max(b + 1, a) into b + 1. At 131,072 words the launch holds about 31 warps
// an SM and is bound by the pipe's rate; on one warp (32 words) it is bound
// by the latency of one dependent step. chip_smoke.py prints the SASS
// opcodes of each chain (cuobjdump -sass of this library); with nvcc for
// sm_90a, n_ops 8: int32 and int16 one VIADDMNMX a step (the int16 one two
// lanes); float32 FADD then FMNMX; bfloat16 HMNMX2 after HADD2 or HFMA2
// (b * 1 + 1, which rounds as the add does).
//
// kb_shift and kb_scan: the row axis is the one a column recurrence runs
// along, so they use the layout a register-resident SW column holds (K3's
// lane groups, csrc/sw_group.cuh): one warp per column of 256 rows, row
// 8t + i in register i of lane t. int16 values are held sign-extended in
// 32-bit registers (max of int16 values is the same there), so the int16
// case does the int32 case's work; T1 asks the packed question. Both
// perform every rep or pass they are given, each a max of every element. A
// block's four columns come from device memory and go back as whole rows
// of 16 bytes (8 for int16), through a shared tile (load_columns), where
// the width allows.
//
// kb_shift: a shift by k = 8q + r gives register i of lane t register
// (i - r) mod 8 of lane t - q - (i < r): a register of the lane itself where
// that distance is 0, else one __shfl_up_sync (__shfl_sync for the wrap) a
// register, the zero fill on the lanes the move leaves a multiply by 0 (an
// IMAD, beside the max's pipe) or, where a register is its own source,
// the floor of a three-way max. A shift by 1 moves one register across
// lanes a rep (register 7), by 3 three, by 8 or 64 all eight. What sent
// value a rep needs was made reps before: for k = 1 register 7's value
// reaches register 0 of the next lane and, through seven in-lane moves, its
// register 7 again eight reps later (k = 3: three shuffles in eight reps).
// So the rep loop is unrolled by the eight registers (kRowsPerLane, a
// remainder loop for the rest), and within the unrolled reps the compiler
// issues each shuffle reps ahead of the max that uses it: k = 1 and 3 are
// bound by the max's pipe. For k = 8 and 64 every register waits on a
// shuffle every rep: each rep is one shuffle's latency and a max (eight in
// flight), and with one warp an SM sub-partition that chain, not the
// shuffle unit's rate, sets the time.
//
// kb_scan: a pass is a = cummax_down(a) - 1 with fill NEG, which is the
// exact prefix max P with max(P, NEG) on rows 0..254 (see scan_kernel). A
// wavefront across the lanes: at step s lane t works on pass s - t, with the
// max of the rows above it for that pass (the carry) received from lane t -
// 1 in one shuffle; it sends max(carry, its rows' max) on to lane t + 1.
// Its rows' max for the next pass follows from the carry alone (max(send,
// NEG) - 1), so one max, a select and one shuffle lie between two sends;
// the pass's in-lane prefix, its max with the carry and NEG, and the -1
// stay off that chain. passes + 31 steps; every lane runs every step, so
// no branch splits the warp (scan_step). NEG is never the carry: lane 0
// receives the carry of no rows, and row 255 takes the carry's max
// without NEG.
//
// What bounds them on an H100: the maxes over the INT32 pipe (64 lanes an
// SM), the shuffles over the shuffle unit, and the dependent chain of a
// column: 512 columns are 512 warps, about one an SM sub-partition, with no
// other warp to hide a latency; and a launch's fixed cost. chip_smoke.py
// and tools/torch_kbench_floors.py print each bound beside the times.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -1000000;
constexpr int kRows = 256;          // rows of a column (tools/kbench.py SHAPE)
constexpr int kRowsPerLane = kRows / 32;
constexpr int kColsPerBlock = 4;    // one warp per column
constexpr unsigned kFull = 0xffffffffu;

struct AluI32 {
  using T = int32_t;
  static __device__ __forceinline__ T step(T b, T inc, T a) {
    return __viaddmax_s32(b, inc, a);
  }
};
struct AluI16x2 {
  using T = uint32_t;
  static __device__ __forceinline__ T step(T b, T inc, T a) {
    return __viaddmax_s16x2(b, inc, a);
  }
};
struct AluF32 {
  using T = float;
  static __device__ __forceinline__ T step(T b, T inc, T a) {
    return fmaxf(b + inc, a);
  }
};
struct AluBF16x2 {
  using T = __nv_bfloat162;
  static __device__ __forceinline__ T step(T b, T inc, T a) {
    return __hmax2(__hadd2(b, inc), a);
  }
};

// kHalf = n_ops / 2 unrolled (the TPU tool's 8 and the tests' 2); kHalf 0
// reads it from `half` at run time
template <class Op, int kHalf>
__global__ void __launch_bounds__(256) alu_kernel(
    const typename Op::T* __restrict__ x, typename Op::T* __restrict__ out,
    long long n, int reps, int half, typename Op::T inc) {
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (w >= n) return;
  typename Op::T a = x[w];
  for (int r = 0; r < reps; ++r) {
    typename Op::T b = a;
    if (kHalf > 0) {
#pragma unroll
      for (int k = 0; k < kHalf; ++k) b = Op::step(b, inc, a);
    } else {
      for (int k = 0; k < half; ++k) b = Op::step(b, inc, a);
    }
    a = b;
  }
  out[w] = a;
}

template <class Op>
int launch_alu(const void* x, void* out, long long n, int reps, int n_ops,
               typename Op::T inc, cudaStream_t stream) {
  using T = typename Op::T;
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const int half = n_ops / 2;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  switch (half) {
    case 1: alu_kernel<Op, 1><<<blocks, threads, 0, stream>>>(xi, o, n, reps, half, inc); break;
    case 4: alu_kernel<Op, 4><<<blocks, threads, 0, stream>>>(xi, o, n, reps, half, inc); break;
    default: alu_kernel<Op, 0><<<blocks, threads, 0, stream>>>(xi, o, n, reps, half, inc);
  }
  return static_cast<int>(cudaGetLastError());
}

// A block's kColsPerBlock columns, one a warp, moved between device memory
// and the lanes' registers (row 8t + i in register i of lane t). Where
// every row of the block's columns is one aligned vector (Vec: the four
// values of a row), a thread moves whole rows and the block transposes
// them through `tile` (a column's 256 rows contiguous, a lane's eight read
// or written as two 16-byte accesses), in place of a lane's eight 4-byte
// accesses 256 rows apart a column. Otherwise (a width not a multiple of
// kColsPerBlock, an unaligned tensor) each lane reads and writes its rows
// one by one. `vec` is uniform over the launch.
template <typename T>
struct Vec;
template <>
struct Vec<int32_t> {
  using type = int4;
};
template <>
struct Vec<int16_t> {
  using type = short4;
};

template <typename T>
__device__ __forceinline__ bool vector_rows(const T* x, const T* out,
                                            int cols) {
  constexpr uintptr_t kAlign = sizeof(typename Vec<T>::type) - 1;
  return cols % kColsPerBlock == 0 &&
         (reinterpret_cast<uintptr_t>(x) & kAlign) == 0 &&
         (reinterpret_cast<uintptr_t>(out) & kAlign) == 0;
}

// This lane's rows in the tile: two 16-byte shared words.
__device__ __forceinline__ int4* lane_rows(int* tile) {
  return reinterpret_cast<int4*>(tile + (threadIdx.x >> 5) * kRows +
                                 (threadIdx.x & 31) * kRowsPerLane);
}

__device__ __forceinline__ void put_rows(int4* rows,
                                         const int (&v)[kRowsPerLane]) {
  rows[0] = make_int4(v[0], v[1], v[2], v[3]);
  rows[1] = make_int4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__device__ __forceinline__ void load_columns(const T* x, int cols, bool vec,
                                             int* tile,
                                             int (&v)[kRowsPerLane]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kColsPerBlock;
  if (vec) {
    for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
      const auto q = *reinterpret_cast<const typename Vec<T>::type*>(
          x + static_cast<size_t>(r) * cols + c0);
      tile[r] = q.x;
      tile[kRows + r] = q.y;
      tile[2 * kRows + r] = q.z;
      tile[3 * kRows + r] = q.w;
    }
    __syncthreads();
    const int4* t = lane_rows(tile);
    const int4 lo = t[0], hi = t[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i)
      v[i] = static_cast<int>(
          x[static_cast<size_t>(lane * kRowsPerLane + i) * cols + c0 + w]);
  }
}

// The block's tile, every lane's rows in it, to device memory a row a
// thread (vec only).
template <typename T>
__device__ __forceinline__ void flush_tile(T* out, int cols, const int* tile) {
  const int c0 = blockIdx.x * kColsPerBlock;
  __syncthreads();
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    typename Vec<T>::type q;
    q.x = static_cast<T>(tile[r]);
    q.y = static_cast<T>(tile[kRows + r]);
    q.z = static_cast<T>(tile[2 * kRows + r]);
    q.w = static_cast<T>(tile[3 * kRows + r]);
    *reinterpret_cast<typename Vec<T>::type*>(
        out + static_cast<size_t>(r) * cols + c0) = q;
  }
}

template <typename T>
__device__ __forceinline__ void store_columns(T* out, int cols, bool vec,
                                              int* tile,
                                              const int (&v)[kRowsPerLane]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (vec) {
    put_rows(lane_rows(tile), v);
    flush_tile(out, cols, tile);
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i)
      out[static_cast<size_t>(lane * kRowsPerLane + i) * cols +
          blockIdx.x * kColsPerBlock + w] = static_cast<T>(v[i]);
  }
}

// One rep of a = max(a, a moved down K rows): row 8t + i takes row
// 8t + i - K, register (i - r) mod 8 of lane t - q - (i < r) with q = K / 8,
// r = K % 8. The zero fill, on the lanes a move of q (index 0) or q + 1
// (index 1) lanes leaves, where a shuffle up returns the lane its own
// value: keep multiplies that value by 0 (an IMAD, beside the max's pipe);
// where the register is its own source (r = 0: k 8, 64) the lane's own
// value is harmless, and one three-way max with floor (0 there, INT_MIN
// elsewhere) adds the fill on the max itself.
template <int K, bool kRoll>
__device__ __forceinline__ void shift_rep(int (&v)[kRowsPerLane], int lane,
                                          const int (&keep)[2],
                                          const int (&floor)[2]) {
  constexpr int q = K / kRowsPerLane, r = K % kRowsPerLane;
  int s[kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    const int src = (i - r + kRowsPerLane) % kRowsPerLane;
    const int dq = q + (i < r ? 1 : 0);
    if (dq == 0) {
      s[i] = v[src];
    } else if (kRoll) {
      s[i] = __shfl_sync(kFull, v[src], (lane - dq) & 31);
    } else if (src == i) {
      s[i] = __shfl_up_sync(kFull, v[src], dq);
    } else {
      s[i] = __shfl_up_sync(kFull, v[src], dq) * keep[i < r ? 1 : 0];
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    const int src = (i - r + kRowsPerLane) % kRowsPerLane;
    const int dq = q + (i < r ? 1 : 0);
    v[i] = (!kRoll && dq > 0 && src == i)
               ? __vimax3_s32(v[i], s[i], floor[i < r ? 1 : 0])
               : max(v[i], s[i]);
  }
}

template <typename T, int K, bool kRoll>
__global__ void __launch_bounds__(32 * kColsPerBlock) shift_kernel(
    const T* __restrict__ x, T* __restrict__ out, int cols, int reps) {
  constexpr int q = K / kRowsPerLane;
  static_assert(q < 31, "a row moves at most 31 lanes");
  __shared__ __align__(16) int tile[kColsPerBlock * kRows];
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kColsPerBlock + (threadIdx.x >> 5);
  const bool vec = vector_rows(x, out, cols);
  if (!vec && c >= cols) return;    // the whole warp leaves together
  // opaque to the compiler, so that the fill stays a multiply (IMAD) and
  // does not become a select on the max's pipe
  int keep[2] = {lane >= q ? 1 : 0, lane >= q + 1 ? 1 : 0};
  asm volatile("" : "+r"(keep[0]), "+r"(keep[1]));
  const int floor[2] = {lane >= q ? INT_MIN : 0, lane >= q + 1 ? INT_MIN : 0};
  int v[kRowsPerLane];
  load_columns(x, cols, vec, tile, v);
  int rep = 0;
  for (; rep + kRowsPerLane <= reps; rep += kRowsPerLane) {
#pragma unroll
    for (int u = 0; u < kRowsPerLane; ++u)
      shift_rep<K, kRoll>(v, lane, keep, floor);
  }
#pragma unroll 1
  for (; rep < reps; ++rep) shift_rep<K, kRoll>(v, lane, keep, floor);
  store_columns(out, cols, vec, tile, v);
}

// The scan's step s on lane `lane`, whose pass is q = s - lane (of
// `passes`). Every lane runs every step, a lane with no pass on values of
// no use, so that no branch splits the warp: a lane takes its input back
// (in, in_tot) at its first pass (kFirst steps) and leaves its output in
// the tile at its last (kSave steps); a lane sends to lane + 1, which has
// a pass exactly when the sender had one. got: the carry lane - 1 sent at
// the step before, replaced by this step's send, shuffled as soon as it is
// known so that the shuffle's latency passes under the rest of the step.
// Lane 0 receives lane 31's INT_MIN + 1, the carry of no rows (INT_MIN at
// step 0, its first pass). a: the lane's rows, the pass's input; tot:
// their max. kFirst steps hold every first pass, whose values may lie near
// INT_MIN: max, then NEG, then - 1, as the plain version (lim7: NEG,
// INT_MIN on row 255). Later passes hold rows 0..254 at NEG - 1 or more
// and row 255 only in lane 31's last prefix, so max(p, c, NEG) - 1 is one
// add-max (p - 1 and c - 1 cannot wrap; lim7: NEG - 1, INT_MIN on row
// 255), and the next max of the rows one add-max of the send.
template <bool kFirst, bool kSave>
__device__ __forceinline__ void scan_step(int s, int lane, int passes,
                                          int (&a)[kRowsPerLane],
                                          const int (&in)[kRowsPerLane],
                                          int in_tot, int& tot, int& got,
                                          int lim7, int4* rows) {
  if (kFirst) {
    const bool first = s == lane;
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) a[i] = first ? in[i] : a[i];
    tot = first ? in_tot : tot;
  }
  const int c = got;
  const int send = max(tot, c);   // the rows above and this lane's
  got = __shfl_sync(kFull, lane == 31 ? INT_MIN + 1 : send, (lane + 31) & 31);
  int p = a[0];                   // the in-lane prefix max
  if (kFirst) {
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      p = max(p, a[i]);
      a[i] = __vimax3_s32(p, c, i < kRowsPerLane - 1 ? kNeg : lim7) - 1;
    }
    tot = max(send, kNeg) - 1;
  } else {
    const int cn = __viaddmax_s32(c, -1, kNeg - 1);   // max(c, NEG) - 1
    const int cn7 = __viaddmax_s32(c, -1, lim7);      // row 255: c - 1
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      p = max(p, a[i]);
      a[i] = __viaddmax_s32(p, -1, i < kRowsPerLane - 1 ? cn : cn7);
    }
    tot = __viaddmax_s32(send, -1, kNeg - 1);
  }
  if (kSave && s - lane == passes - 1) put_rows(rows, a);
}

// The Pallas scan gives row p max(a[p - 255 .. p]) over the log-step
// windows, an index below 0 standing for NEG: every row but the last sees
// NEG. So each pass is the exact prefix max P, then max(P, NEG) on rows
// 0..254 and P on row 255, then - 1. The step loops (ops/kbench_cuda.py
// scan_phases): [0, 32) holds every lane's first pass, [32, passes - 1)
// every lane's middle passes, the rest to passes + 31 every last pass. The
// tile holds the input until a lane's last pass leaves its output there.
__global__ void __launch_bounds__(32 * kColsPerBlock) scan_kernel(
    const int32_t* __restrict__ x, int32_t* __restrict__ out, int cols,
    int reps) {
  __shared__ __align__(16) int tile[kColsPerBlock * kRows];
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kColsPerBlock + (threadIdx.x >> 5);
  const bool vec = vector_rows(x, out, cols);
  if (!vec && c >= cols) return;
  const int passes = reps / 8;
  int in[kRowsPerLane], a[kRowsPerLane];
  load_columns(x, cols, vec, tile, in);
  int4* rows = lane_rows(tile);
  if (!vec) put_rows(rows, in);
  int in_tot = in[0];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    a[i] = in[i];
    in_tot = max(in_tot, in[i]);
  }
  int tot = in_tot, got = INT_MIN;
  const int steps = passes > 0 ? passes + 31 : 0;
  const int lim7x = lane == 31 ? INT_MIN : kNeg;
  for (int s = 0; s < min(32, steps); ++s)
    scan_step<true, true>(s, lane, passes, a, in, in_tot, tot, got, lim7x,
                          rows);
  const int lim7 = lane == 31 ? INT_MIN : kNeg - 1;
#pragma unroll 4
  for (int s = 32; s < passes - 1; ++s)
    scan_step<false, false>(s, lane, passes, a, in, in_tot, tot, got, lim7,
                            rows);
  for (int s = max(32, passes - 1); s < steps; ++s)
    scan_step<false, true>(s, lane, passes, a, in, in_tot, tot, got, lim7,
                           rows);
  if (vec) {
    flush_tile(out, cols, tile);
  } else {
    const int4 lo = rows[0], hi = rows[1];
    const int v[kRowsPerLane] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
    store_columns(out, cols, false, tile, v);
  }
}

template <typename T, int K>
void launch_shift(const void* x, void* out, int cols, int reps, bool roll,
                  cudaStream_t stream) {
  const unsigned blocks = (cols + kColsPerBlock - 1) / kColsPerBlock;
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (roll)
    shift_kernel<T, K, true><<<blocks, 32 * kColsPerBlock, 0, stream>>>(xi, o, cols, reps);
  else
    shift_kernel<T, K, false><<<blocks, 32 * kColsPerBlock, 0, stream>>>(xi, o, cols, reps);
}

template <typename T>
int dispatch_shift(const void* x, void* out, int cols, int reps, int amount,
                   bool roll, cudaStream_t stream) {
  switch (amount) {
    case 1: launch_shift<T, 1>(x, out, cols, reps, roll, stream); break;
    case 3: launch_shift<T, 3>(x, out, cols, reps, roll, stream); break;
    case 8: launch_shift<T, 8>(x, out, cols, reps, roll, stream); break;
    case 64: launch_shift<T, 64>(x, out, cols, reps, roll, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 int32, 1 int16, 2 float32, 3 bfloat16. x, out: device buffers of
// n_words 32-bit words (two lanes a word for the 16-bit types). The launch
// goes on `stream` and does not synchronise; returns the launch's error.
extern "C" int kb_alu(int dtype, const void* x, void* out, long long n_words,
                      int reps, int n_ops, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_alu<AluI32>(x, out, n_words, reps, n_ops, 1, s);
    case 1: return launch_alu<AluI16x2>(x, out, n_words, reps, n_ops, 0x00010001u, s);
    case 2: return launch_alu<AluF32>(x, out, n_words, reps, n_ops, 1.0f, s);
    case 3: {
      __nv_bfloat162_raw one;
      one.x = one.y = 0x3f80;       // 1.0 in bfloat16
      return launch_alu<AluBF16x2>(x, out, n_words, reps, n_ops,
                                   __nv_bfloat162(one), s);
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype: 0 int32, 1 int16. x, out: (256, cols) row-major on the device;
// amount one of the TPU tool's 1, 3, 8, 64.
extern "C" int kb_shift(int dtype, const void* x, void* out, int rows,
                        int cols, int reps, int amount, int roll,
                        void* stream) {
  if (rows != kRows || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_shift<int32_t>(x, out, cols, reps, amount, roll != 0, s);
  if (dtype == 1) return dispatch_shift<int16_t>(x, out, cols, reps, amount, roll != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, out: (256, cols) int32 row-major on the device.
extern "C" int kb_scan(const int32_t* x, int32_t* out, int rows, int cols,
                       int reps, void* stream) {
  if (rows != kRows || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (cols + kColsPerBlock - 1) / kColsPerBlock;
  scan_kernel<<<blocks, 32 * kColsPerBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(x, out, cols, reps);
  return static_cast<int>(cudaGetLastError());
}
