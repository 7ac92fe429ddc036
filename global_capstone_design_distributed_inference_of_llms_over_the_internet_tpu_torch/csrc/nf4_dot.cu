// NF4 weight matmul with the dequantization fused in:
//   y[M, N] = x[M, K] @ deq(W)[K, N], rounded to x's dtype, where
//   deq(code, scale) = round_to(x dtype, NF4_LEVELS[code] * scale)   (float32
//   product, then rounded: ops/nf4_kernel.py:122-124 of the JAX package).
//
// Replaces the TPU kernel ops/nf4_kernel.py:_make_kernel (the Pallas kernel
// behind nf4_dot) of the JAX package. It runs at every projection of
// --quant nf4 serving with NF4_KERNEL=1: wqkv, wo, wgu and wd of every layer.
//
// Layout of W (models/quant.py NF4Tensor): packed uint8 [P, N], P = in_pad/2,
// the high nibble of packed[r][n] is weight row 2r, the low nibble row 2r+1;
// scales bf16 [P/32, N], one absmax per 64 weight rows (32 packed rows).
//
// What bounds it on an H100: at decode (M = 1) every weight is used once, so
// the kernel is bound by the bytes it reads: 0.5 B per weight plus 2 B of
// scale per 64 weights (62.4 MB for the 8B model's fused gate/up weight,
// 115.9 MB for one layer's four sites: 34.6 us at 3.35 TB/s). Per weight it
// also does a table lookup, a multiply and a rounding before the FMA, which
// at M = 1 is near the same time on the CUDA cores as the byte stream.
//
// What the design does about it:
//   * The TPU kernel split the matmul by nibble parity (x_even @ deq(hi) +
//     x_odd @ deq(lo)) only to avoid a sublane shuffle. Here one packed byte
//     is split in registers into rows 2r and 2r+1 of its column, multiplied
//     by x[2r] and x[2r+1]: no split of x, no second pass.
//   * Packed bytes are read straight from device memory, 16 bytes (16
//     columns x 2 rows) per thread per load where N allows, four loads in
//     flight per thread (two at the 8-row M tile, whose accumulators fill
//     the registers); no dequantized weight is ever materialized.
//   * A 16-level table in shared memory holds NF4_LEVELS: lanes that look up
//     different codes hit different banks, lanes with the same code share a
//     broadcast. (A __constant__ table indexed by a varying code would
//     serialise the warp.) The 16 bf16 scales of a thread's columns are read
//     once per 32-row scale block; within a warp they are one broadcast.
//   * Sums are float32 over the whole K; the block's 8 warps split K and
//     reduce with warp shuffles and one shared-memory pass in a fixed order,
//     so results are deterministic. A block owns 32 output columns and an M
//     tile of up to 8 rows; the grid is ceil(N/32) x ceil(M/MT).
//   * Any M, K and N: rows past M, columns past N and x past in_dim (the
//     padded rows of in_pad) are masked; the 16-byte loads are used only
//     where N % 16 == 0 and the pointers are 16-byte aligned.
//
// This is the simple, correct first design. Not done yet (a later PR's work):
// tensor cores at prefill M (mma.sync / wgmma on bf16 tiles dequantized in
// shared memory), split-K so the N = 4096 sites fill all 132 SMs, TMA with a
// multi-stage shared-memory ring.
//
// C interface (loaded with ctypes):
//   int nf4_dot_launch(x, packed, scales, y, M, K, P, N, x_dtype, device,
//                      stream)
//     K = in_dim (x's row length), P = packed rows (2P - K in [0, 64));
//     x_dtype: 0 = float32, 1 = bfloat16 (y has the same dtype as x);
//     device: the CUDA device index of the tensors and of `stream`.
//     Returns the cudaError_t of the launch (0 = success).
//   const char* nf4_dot_error_string(int code)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 16;                      // one 16-byte load
constexpr int kColGroups = 2;                           // per warp
constexpr int kBlockN = kColGroups * kColsPerThread;    // 32 columns
constexpr int kRowsPerWarp = 32 / kColGroups;           // 16 packed rows
constexpr int kRowsPerStep = kRowsPerWarp * kWarps;     // 128 packed rows
constexpr int kUnroll = 4;                              // loads in flight
constexpr int kRowsPerScale = 32;                       // 64 weight rows

// NF4_LEVELS of models/quant.py, copied into shared memory at block start.
__constant__ float kLevels[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.4407098591327667f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The dequantized weight as the activation dtype holds it, back in float.
__device__ __forceinline__ float round_weight(float v, float) { return v; }
__device__ __forceinline__ float round_weight(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes of packed row r starting at column n0 (zero past N).
__device__ __forceinline__ int4 load_packed(const uint8_t* __restrict__ pk,
                                            int r, int N, int n0, bool vec) {
  const uint8_t* row = pk + static_cast<size_t>(r) * N;
  if (vec) {
    return __ldg(reinterpret_cast<const int4*>(row + n0));
  }
  int4 out;
  uint8_t* b = reinterpret_cast<uint8_t*>(&out);
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    b[j] = (n0 + j < N) ? row[n0 + j] : static_cast<uint8_t>(0);
  }
  return out;
}

// The 16 scales of scale row sb at columns n0.. as float (zero past N).
__device__ __forceinline__ void load_scales(float (&s)[kColsPerThread],
                                            const __nv_bfloat16* __restrict__ sc,
                                            int sb, int N, int n0, bool vec) {
  const __nv_bfloat16* row = sc + static_cast<size_t>(sb) * N + n0;
  if (vec) {
    int4 raw[2];
    raw[0] = __ldg(reinterpret_cast<const int4*>(row));
    raw[1] = __ldg(reinterpret_cast<const int4*>(row) + 1);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(raw);
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = __bfloat162float(h[j]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    s[j] = (n0 + j < N) ? __bfloat162float(row[j]) : 0.f;
  }
}

// Packed row r (weight rows 2r, 2r+1) of 16 columns into the accumulators:
// the 2 x MT activations first, then one column at a time, so only two
// dequantized weights are live at once.
template <typename T, int MT>
__device__ __forceinline__ void fma_pair(float (&acc)[MT][kColsPerThread],
                                         int4 w, const float (&s)[kColsPerThread],
                                         const float* __restrict__ lut,
                                         const T* __restrict__ x, int r,
                                         int m0, int M, int K) {
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(&w);
  const int k0 = 2 * r;
  float xe[MT], xo[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const bool row_ok = m0 + i < M;
    const T* xr = x + static_cast<size_t>(m0 + i) * K;
    xe[i] = (row_ok && k0 < K) ? to_f32(xr[k0]) : 0.f;
    xo[i] = (row_ok && k0 + 1 < K) ? to_f32(xr[k0 + 1]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const float whi = round_weight(lut[wb[j] >> 4] * s[j], T());
    const float wlo = round_weight(lut[wb[j] & 0xF] * s[j], T());
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      acc[i][j] = fmaf(xe[i], whi, acc[i][j]);
      acc[i][j] = fmaf(xo[i], wlo, acc[i][j]);
    }
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
    nf4_dot_kernel(const T* __restrict__ x, const uint8_t* __restrict__ pk,
                   const __nv_bfloat16* __restrict__ sc, T* __restrict__ y,
                   int M, int K, int P, int N, bool aligned) {
  __shared__ float lut[16];
  __shared__ float partial[kWarps][MT][kBlockN];
  if (threadIdx.x < 16) lut[threadIdx.x] = kLevels[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane % kColGroups;
  const int row_in_warp = lane / kColGroups;
  const int col0 = group * kColsPerThread;          // within the block
  const int n0 = blockIdx.x * kBlockN + col0;
  const int m0 = blockIdx.y * MT;
  // 16-byte loads need every row start 16-byte aligned (N % 16 == 0 and
  // aligned bases) and all 16 columns inside N.
  const bool vec = aligned && (n0 + kColsPerThread <= N);

  float acc[MT][kColsPerThread];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  // Each packed row takes the scales of its 32-row block; a warp's 16 rows
  // of one step share one block, so the load is a broadcast in the warp.
  // Fewer loads in flight at the 8-row M tile keep its accumulators in
  // registers.
  constexpr int kU = MT >= 8 ? kUnroll / 2 : kUnroll;
  int r = warp * kRowsPerWarp + row_in_warp;
  float s[kColsPerThread];
  if (n0 < N) {
    for (; r + (kU - 1) * kRowsPerStep < P; r += kU * kRowsPerStep) {
      int4 w[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        w[u] = load_packed(pk, r + u * kRowsPerStep, N, n0, vec);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int ru = r + u * kRowsPerStep;
        load_scales(s, sc, ru / kRowsPerScale, N, n0, vec);
        fma_pair<T, MT>(acc, w[u], s, lut, x, ru, m0, M, K);
      }
    }
    for (; r < P; r += kRowsPerStep) {
      load_scales(s, sc, r / kRowsPerScale, N, n0, vec);
      fma_pair<T, MT>(acc, load_packed(pk, r, N, n0, vec), s, lut, x, r, m0,
                      M, K);
    }
  }

  // Sum the 16 rows of each column group inside the warp (lanes that share
  // `group` differ in bits 1..4), then the 8 warps through shared memory.
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
#pragma unroll
      for (int off = kColGroups; off < 32; off <<= 1)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);

  if (row_in_warp == 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        partial[warp][i][col0 + j] = acc[i][j];
  }
  __syncthreads();

  for (int t = threadIdx.x; t < MT * kBlockN; t += kThreads) {
    const int i = t / kBlockN;
    const int c = t % kBlockN;
    const int m = m0 + i;
    const int n = blockIdx.x * kBlockN + c;
    if (m < M && n < N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += partial[w][i][c];
      y[static_cast<size_t>(m) * N + n] = from_f32<T>(sum);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* pk, const void* sc, void* y,
                         int M, int K, int P, int N, bool aligned,
                         cudaStream_t stream) {
  const int mt = M >= 5 ? 8 : M >= 3 ? 4 : M;   // smallest tile >= M, <= 8
  dim3 grid((N + kBlockN - 1) / kBlockN, (M + mt - 1) / mt);
  const T* xt = static_cast<const T*>(x);
  const uint8_t* pkt = static_cast<const uint8_t*>(pk);
  const __nv_bfloat16* sct = static_cast<const __nv_bfloat16*>(sc);
  T* yt = static_cast<T*>(y);
  switch (mt) {
    case 1:
      nf4_dot_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xt, pkt, sct, yt, M,
                                                          K, P, N, aligned);
      break;
    case 2:
      nf4_dot_kernel<T, 2><<<grid, kThreads, 0, stream>>>(xt, pkt, sct, yt, M,
                                                          K, P, N, aligned);
      break;
    case 4:
      nf4_dot_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xt, pkt, sct, yt, M,
                                                          K, P, N, aligned);
      break;
    default:
      nf4_dot_kernel<T, 8><<<grid, kThreads, 0, stream>>>(xt, pkt, sct, yt, M,
                                                          K, P, N, aligned);
      break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int nf4_dot_launch(const void* x, const void* packed,
                              const void* scales, void* y, int M, int K, int P,
                              int N, int x_dtype, int device, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || P <= 0 || P % kRowsPerScale != 0 ||
      2 * P < K || 2 * P - K >= 2 * kRowsPerScale || (M + 7) / 8 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // This library links its own CUDA runtime, whose current device is not
  // PyTorch's: launch on the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = (N % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(packed) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(scales) % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    err = launch_typed<float>(x, packed, scales, y, M, K, P, N, aligned, st);
  } else if (x_dtype == 1) {
    err = launch_typed<__nv_bfloat16>(x, packed, scales, y, M, K, P, N, aligned,
                                      st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* nf4_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
