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
// Each returns what the Pallas variant returns, the inexact ones included.
//
// Design (sw_qm.cu's): one block per tile, one thread per lane. The tile's
// profile goes to shared memory as int16, 33 columns a row (a code outside
// 0..31 reads column 32, which holds 0, as its empty one-hot column does on
// the TPU); the bf16 input holds integers, so the conversion is exact. The
// Pallas grid's column chunk (tj) becomes the columns of target codes a
// lane stages in shared memory per load, from the (Lt, B) layout, coalesced;
// its unroll (u) becomes the columns a lane carries in registers through one
// sweep down the rows: the H/E column scratch ([tile][row][lane], int32
// pairs) is read and written once per u columns, as the Pallas kernel writes
// its H/E scratch once per UNROLL columns. Only the columns the Pallas grid
// visits are visited: c * TJ + jj for c < Lt / TJ and jj < (TJ / u) * u.
//
// The F term: base, nocap and nof keep sw_qm.cu's F(i) = max(G(i-1) - go,
// F(i-1) - ge), equal to the Pallas in-column cummax of G + i*ge; fold keeps
// the folded form literally, a running max of G' (one max a cell instead of
// two operations). The tie-break: each cell's packed word h*div + (div-1-j)
// (h the unfolded Hn, int32 arithmetic) goes into a running max, the first
// row kept on equal words; this is the Pallas max over rows of per-row
// maxima, with the smallest row among equal words, while Hn * div stays
// inside int32 (Hn below 65536 for the 32768 packing, as for the Pallas
// kernel) and no column reaches div (the wrapper refuses Lt > div).
//
// What bounds it on an H100: about 8 integer operations a cell (DPX add-max
// counted as one) over the int32 rate, and per lane one dependent chain
// down the column; the H/E scratch traffic is 16 B a row per u columns.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kPCols = 32;
constexpr int kRowStride = kPCols + 1;   // column 32 is the empty one
constexpr int kNeg = -1000000;
constexpr int kCap = 32767;
enum Variant { kBase = 0, kFold = 1, kNoCap = 2, kFoldNoCap = 3, kNoF = 4 };

__host__ __device__ constexpr bool folded(int v) {
  return v == kFold || v == kFoldNoCap;
}
__host__ __device__ constexpr int packing(int v) {
  return (v == kBase || v == kNoF) ? 65536 : 32768;
}

template <int V, int U>
__global__ void __launch_bounds__(kLanes) qm_variant_kernel(
    const uint16_t* __restrict__ prof, const int32_t* __restrict__ tc,
    int Lq, int Lt, int B, int TJ, int go, int ge, int2* __restrict__ he,
    int32_t* __restrict__ best_out, int32_t* __restrict__ qend_out,
    int32_t* __restrict__ tend_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* prof_s = reinterpret_cast<int16_t*>(smem);
  const size_t prof_bytes =
      ((static_cast<size_t>(Lq) * kRowStride * sizeof(int16_t)) + 15) & ~size_t(15);
  uint8_t* codes_s = smem + prof_bytes;   // [jj][lane]
  const int tile = blockIdx.x, lane = threadIdx.x;
  const int b = tile * kLanes + lane;
  constexpr int div = packing(V);

  const uint16_t* p = prof + static_cast<size_t>(tile) * Lq * kPCols;
  for (int k = threadIdx.x; k < Lq * kRowStride; k += kLanes) {
    const int i = k / kRowStride, a = k % kRowStride;
    int val = 0;
    if (a < kPCols) {
      __nv_bfloat16_raw raw;
      raw.x = p[i * kPCols + a];
      val = static_cast<int>(__bfloat162float(__nv_bfloat16(raw)));
    }
    prof_s[k] = static_cast<int16_t>(val);
  }
  __syncthreads();

  int2* col = he + static_cast<size_t>(tile) * Lq * kLanes + lane;
  for (int i = 0; i < Lq; ++i) {
    const int h0 = folded(V) ? i * ge : 0;
    col[static_cast<size_t>(i) * kLanes] = make_int2(h0, h0 - go);
  }
  const int h_top = folded(V) ? -ge : 0;     // H of row -1
  int bestp = 0, qe = 0;
  const int per_chunk = (TJ / U) * U;
  for (int c = 0; c < Lt / TJ; ++c) {
    for (int jj = 0; jj < per_chunk; ++jj) {
      const int code = tc[static_cast<size_t>(c * TJ + jj) * B + b];
      codes_s[jj * kLanes + lane] =
          static_cast<uint8_t>((code >= 0 && code < kPCols) ? code : kPCols);
    }
    for (int j0 = 0; j0 < per_chunk; j0 += U) {
      int cols[U], hprev[U], f[U];
      const int k0 = (div - 1) - (c * TJ + j0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        cols[u] = codes_s[(j0 + u) * kLanes + lane];
        hprev[u] = h_top;
        f[u] = kNeg;
      }
      int hleft = h_top;                     // H(i-1, j0-1)
      for (int i = 0; i < Lq; ++i) {
        const int2 w = col[static_cast<size_t>(i) * kLanes];
        const int16_t* row = prof_s + i * kRowStride;
        const int igge = i * ge;
        int e = w.y, diag = hleft;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = row[cols[u]];
          int h, hu;
          if (folded(V)) {
            const int g = max(__viaddmax_s32(diag, s, e), igge);
            h = max(g, f[u] + (ge - go));
            if (V == kFold) h = min(h, kCap + igge);
            f[u] = max(f[u], g);             // running max of G'
            hu = h - igge;
          } else if (V == kNoF) {
            h = min(__viaddmax_s32_relu(diag, s, e), kCap);
            hu = h;
          } else {
            const int g = __viaddmax_s32_relu(diag, s, e);
            h = max(g, f[u]);
            if (V == kBase) h = min(h, kCap);
            f[u] = max(g - go, f[u] - ge);
            hu = h;
          }
          const int packed = static_cast<int>(
              static_cast<unsigned>(hu) * static_cast<unsigned>(div) +
              static_cast<unsigned>(k0 - u));
          if (packed > bestp) { bestp = packed; qe = i; }
          e = max(e - ge, h - go);
          diag = hprev[u];
          hprev[u] = h;
        }
        hleft = w.x;
        col[static_cast<size_t>(i) * kLanes] = make_int2(hprev[U - 1], e);
      }
    }
  }
  const int M = bestp / div;                 // bestp >= 0
  const bool has = M > 0;
  best_out[b] = has ? M : 0;
  tend_out[b] = has ? (div - 1) - bestp % div : -1;
  qend_out[b] = has ? qe : Lq - 1;
}

template <int V, int U>
int launch(const uint16_t* prof, const int32_t* tc, int n_tiles, int Lq,
           int Lt, int TJ, int go, int ge, int2* he, int32_t* best,
           int32_t* qend, int32_t* tend, size_t smem, cudaStream_t stream) {
  auto kernel = qm_variant_kernel<V, U>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<n_tiles, kLanes, smem, stream>>>(prof, tc, Lq, Lt,
                                            n_tiles * kLanes, TJ, go, ge, he,
                                            best, qend, tend);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int dispatch_unroll(int U, const uint16_t* prof, const int32_t* tc,
                    int n_tiles, int Lq, int Lt, int TJ, int go, int ge,
                    int2* he, int32_t* best, int32_t* qend, int32_t* tend,
                    size_t smem, cudaStream_t s) {
  switch (U) {
    case 1: return launch<V, 1>(prof, tc, n_tiles, Lq, Lt, TJ, go, ge, he, best, qend, tend, smem, s);
    case 2: return launch<V, 2>(prof, tc, n_tiles, Lq, Lt, TJ, go, ge, he, best, qend, tend, smem, s);
    case 4: return launch<V, 4>(prof, tc, n_tiles, Lq, Lt, TJ, go, ge, he, best, qend, tend, smem, s);
    case 8: return launch<V, 8>(prof, tc, n_tiles, Lq, Lt, TJ, go, ge, he, best, qend, tend, smem, s);
    case 16: return launch<V, 16>(prof, tc, n_tiles, Lq, Lt, TJ, go, ge, he, best, qend, tend, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Bytes of dynamic shared memory a launch takes.
extern "C" long long qm_variant_smem(int Lq, int TJ) {
  const long long prof = ((static_cast<long long>(Lq) * kRowStride * 2) + 15) & ~15LL;
  return prof + static_cast<long long>(TJ) * kLanes;
}

// variant: 0 base, 1 fold, 2 nocap, 3 fold_nocap, 4 nof; unroll one of 1, 2,
// 4, 8, 16; TJ = min(tj, Lt) >= 1. prof: (n_tiles, Lq, 32) bfloat16 bits;
// tc: (Lt, n_tiles * 128) int32; scratch: (n_tiles, Lq, 128) int32 pairs;
// best, q_end, t_end: (n_tiles * 128,) int32. Every pointer is on the
// device; the launch goes on `stream` and does not synchronise. Returns the
// error of the attribute call or of the launch (0 on success).
extern "C" int qm_variant_ends(int variant, int unroll, const uint16_t* prof,
                               const int32_t* tc, int n_tiles, int Lq, int Lt,
                               int TJ, int go, int ge, int2* scratch,
                               int32_t* best, int32_t* q_end, int32_t* t_end,
                               void* stream) {
  if (n_tiles <= 0 || Lq <= 0 || TJ <= 0 || TJ > Lt)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(qm_variant_smem(Lq, TJ));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBase: return dispatch_unroll<kBase>(unroll, prof, tc, n_tiles, Lq, Lt, TJ, go, ge, scratch, best, q_end, t_end, smem, s);
    case kFold: return dispatch_unroll<kFold>(unroll, prof, tc, n_tiles, Lq, Lt, TJ, go, ge, scratch, best, q_end, t_end, smem, s);
    case kNoCap: return dispatch_unroll<kNoCap>(unroll, prof, tc, n_tiles, Lq, Lt, TJ, go, ge, scratch, best, q_end, t_end, smem, s);
    case kFoldNoCap: return dispatch_unroll<kFoldNoCap>(unroll, prof, tc, n_tiles, Lq, Lt, TJ, go, ge, scratch, best, q_end, t_end, smem, s);
    case kNoF: return dispatch_unroll<kNoF>(unroll, prof, tc, n_tiles, Lq, Lt, TJ, go, ge, scratch, best, q_end, t_end, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
