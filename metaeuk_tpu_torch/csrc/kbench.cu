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
// along, so they use the layout a register-resident SW column would: one
// warp per column of 256 rows, 8 consecutive rows per lane in registers. A
// shift by k = 8q + r takes each row from lane t - q (or t - q - 1) with one
// __shfl_up_sync (__shfl_sync for the wrap) per register, or from a
// register of the lane itself when q = 0 and the row is below r: a shift by
// 1 costs one shuffle and seven register renames a lane, by 8 or 64 eight
// shuffles. The scan is a lane's sequential prefix max over its 8 rows, a
// 5-step shuffle scan of the lanes' totals, and one more shuffle to carry
// the rows above into each lane. int16 values are held sign-extended in
// 32-bit registers (max of int16 values is the same there); T1 asks the
// packed question. What bounds both: the shuffle unit's rate and latency
// (a dependent chain per column, 512 columns = 512 warps, about 4 an SM).

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

template <typename T>
__device__ __forceinline__ void load_column(const T* x, int cols, int c,
                                            int lane, int (&v)[kRowsPerLane]) {
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i)
    v[i] = static_cast<int>(x[static_cast<size_t>(lane * kRowsPerLane + i) * cols + c]);
}

template <typename T>
__device__ __forceinline__ void store_column(T* out, int cols, int c,
                                             int lane,
                                             const int (&v)[kRowsPerLane]) {
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i)
    out[static_cast<size_t>(lane * kRowsPerLane + i) * cols + c] =
        static_cast<T>(v[i]);
}

// row 8t + i takes row 8t + i - K: register (i - r) mod 8 of lane
// t - q - (i < r), with q = K / 8, r = K % 8
template <typename T, int K, bool kRoll>
__global__ void __launch_bounds__(32 * kColsPerBlock) shift_kernel(
    const T* __restrict__ x, T* __restrict__ out, int cols, int reps) {
  constexpr int q = K / kRowsPerLane, r = K % kRowsPerLane;
  static_assert(q < 31, "a row moves at most 31 lanes");
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kColsPerBlock + (threadIdx.x >> 5);
  if (c >= cols) return;            // the whole warp leaves together
  int v[kRowsPerLane];
  load_column(x, cols, c, lane, v);
  for (int rep = 0; rep < reps; ++rep) {
    int s[kRowsPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      const int src = (i - r + kRowsPerLane) % kRowsPerLane;
      const int dq = q + (i < r ? 1 : 0);
      if (dq == 0) {
        s[i] = v[src];
      } else if (kRoll) {
        s[i] = __shfl_sync(kFull, v[src], (lane - dq) & 31);
      } else {
        const int t = __shfl_up_sync(kFull, v[src], dq);
        s[i] = lane >= dq ? t : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) v[i] = max(v[i], s[i]);
  }
  store_column(out, cols, c, lane, v);
}

// The Pallas scan gives row p max(a[p - 255 .. p]) over the log-step
// windows, an index below 0 standing for NEG: every row but the last sees
// NEG. So each pass is the exact prefix max P, then max(P, NEG) on rows
// 0..254; P[p] < NEG only if a[0] < NEG, which a uniform branch tests.
__global__ void __launch_bounds__(32 * kColsPerBlock) scan_kernel(
    const int32_t* __restrict__ x, int32_t* __restrict__ out, int cols,
    int reps) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kColsPerBlock + (threadIdx.x >> 5);
  if (c >= cols) return;
  int v[kRowsPerLane];
  load_column(x, cols, c, lane, v);
  for (int rep = 0; rep < reps / 8; ++rep) {
#pragma unroll
    for (int i = 1; i < kRowsPerLane; ++i) v[i] = max(v[i], v[i - 1]);
    int tot = v[kRowsPerLane - 1];
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int t = __shfl_up_sync(kFull, tot, d);
      if (lane >= d) tot = max(tot, t);
    }
    const int above = __shfl_up_sync(kFull, tot, 1);
    if (lane > 0) {
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) v[i] = max(v[i], above);
    }
    if (__shfl_sync(kFull, v[0], 0) < kNeg) {
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i)
        if (lane < 31 || i < kRowsPerLane - 1) v[i] = max(v[i], kNeg);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) v[i] -= 1;
  }
  store_column(out, cols, c, lane, v);
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
