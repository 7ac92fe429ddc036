// int8 weight matmul with the per-output-channel scale folded into the
// epilogue:  y[M, N] = (x[M, K] @ q[K, N]) * s[N], rounded to x's dtype.
//
// Replaces the TPU kernel ops/int8_kernel.py:_make_kernel (the Pallas
// kernel behind int8_dot) of the JAX package. It runs at every projection
// of --quant int8 serving: wqkv, wo, wgu and wd of every layer.
//
// What bounds it on an H100: at decode (M = 1) the work is one multiply-add
// per weight byte, so the kernel is bound by reading q from device memory
// (K * N bytes; 117 MB for the 8B model's fused gate/up weight). At large M
// (prefill) it becomes bound by arithmetic instead, which this kernel does
// on the CUDA cores in float32.
//
// What the design does about it:
//   * q is read as int8 straight from device memory, 16 bytes per thread per
//     load, and widened to float in registers; no bf16 or f32 weight is ever
//     materialized, so device memory sees each weight byte once per M tile.
//   * x is exact in float32 (bf16 or f32 input), the products of int8 and
//     x are accumulated in float32 over the whole K, and the f32 scale
//     multiplies each output column once, after the reduction.
//   * A block owns 32 output columns (two 16-column groups per warp) and an
//     M tile of up to 8 rows; its 8 warps x 16 lanes split K between them
//     (128 rows of q per step, four steps in flight per thread), then reduce
//     with warp shuffles and a small shared-memory pass in a fixed order, so
//     results are deterministic. The grid is ceil(N/32) x ceil(M/MT).
//   * Any M, K and N: rows past M, columns past N and the K tail are masked;
//     the 16-byte loads are used only where N % 16 == 0, else byte loads.
//
// This is the simple, correct first design. Not done yet (a later PR's work):
// tensor cores (mma.sync / wgmma), TMA with a multi-stage shared-memory ring,
// and split-K across blocks to fill all 132 SMs when N is only 4096.
//
// C interface (loaded with ctypes):
//   int int8_dot_launch(x, q, s, y, M, K, N, x_dtype, device, stream)
//     x_dtype: 0 = float32, 1 = bfloat16 (y has the same dtype as x);
//     device: the CUDA device index of the tensors and of `stream`.
//     Returns the cudaError_t of the launch (0 = success).
//   const char* int8_dot_error_string(int code)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 16;                      // one 16-byte q load
constexpr int kColGroups = 2;                           // per warp
constexpr int kBlockN = kColGroups * kColsPerThread;    // 32 columns
constexpr int kRowsPerWarp = 32 / kColGroups;           // 16 rows of q
constexpr int kRowsPerStep = kRowsPerWarp * kWarps;     // 128 rows of q
constexpr int kUnroll = 4;                              // loads in flight

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

// 16 int8 weights of row k starting at column n0 (zero past N).
__device__ __forceinline__ int4 load_q(const int8_t* __restrict__ q, int k,
                                       int N, int n0, bool vec) {
  const int8_t* row = q + static_cast<size_t>(k) * N;
  if (vec) {
    return __ldg(reinterpret_cast<const int4*>(row + n0));
  }
  int4 out;
  int8_t* b = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    b[j] = (n0 + j < N) ? row[n0 + j] : static_cast<int8_t>(0);
  }
  return out;
}

template <typename T, int MT>
__device__ __forceinline__ void fma_row(float (&acc)[MT][kColsPerThread],
                                        int4 w, const T* __restrict__ x,
                                        int k, int m0, int M, int K) {
  const int8_t* wb = reinterpret_cast<const int8_t*>(&w);
  float wf[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) wf[j] = static_cast<float>(wb[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float xv =
        (m0 + i < M) ? to_f32(x[static_cast<size_t>(m0 + i) * K + k]) : 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      acc[i][j] = fmaf(xv, wf[j], acc[i][j]);
    }
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
    int8_dot_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ s, T* __restrict__ y, int M,
                    int K, int N) {
  __shared__ float partial[kWarps][MT][kBlockN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane % kColGroups;
  const int row_in_warp = lane / kColGroups;
  const int col0 = group * kColsPerThread;          // within the block
  const int n0 = blockIdx.x * kBlockN + col0;
  const int m0 = blockIdx.y * MT;
  // 16-byte loads need every row start 16-byte aligned (N % 16 == 0; the
  // tensor base is 256-byte aligned) and all 16 columns inside N.
  const bool vec = ((N & 15) == 0) && (n0 + kColsPerThread <= N);

  float acc[MT][kColsPerThread];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  int k = warp * kRowsPerWarp + row_in_warp;
  if (n0 < N) {
    for (; k + (kUnroll - 1) * kRowsPerStep < K; k += kUnroll * kRowsPerStep) {
      int4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        w[u] = load_q(q, k + u * kRowsPerStep, N, n0, vec);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        fma_row<T, MT>(acc, w[u], x, k + u * kRowsPerStep, m0, M, K);
      }
    }
    for (; k < K; k += kRowsPerStep) {
      fma_row<T, MT>(acc, load_q(q, k, N, n0, vec), x, k, m0, M, K);
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
      y[static_cast<size_t>(m) * N + n] = from_f32<T>(sum * s[n]);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* q, const void* s, void* y,
                         int M, int K, int N, cudaStream_t stream) {
  const int mt = M >= 5 ? 8 : M >= 3 ? 4 : M;   // smallest tile >= M, <= 8
  dim3 grid((N + kBlockN - 1) / kBlockN, (M + mt - 1) / mt);
  const T* xt = static_cast<const T*>(x);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(s);
  T* yt = static_cast<T*>(y);
  switch (mt) {
    case 1:
      int8_dot_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xt, qt, st, yt, M, K, N);
      break;
    case 2:
      int8_dot_kernel<T, 2><<<grid, kThreads, 0, stream>>>(xt, qt, st, yt, M, K, N);
      break;
    case 4:
      int8_dot_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xt, qt, st, yt, M, K, N);
      break;
    default:
      int8_dot_kernel<T, 8><<<grid, kThreads, 0, stream>>>(xt, qt, st, yt, M, K, N);
      break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int int8_dot_launch(const void* x, const void* q, const void* s,
                               void* y, int M, int K, int N, int x_dtype,
                               int device, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (M + 7) / 8 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // This library links its own CUDA runtime, whose current device is not
  // PyTorch's: launch on the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    err = launch_typed<float>(x, q, s, y, M, K, N, st);
  } else if (x_dtype == 1) {
    err = launch_typed<__nv_bfloat16>(x, q, s, y, M, K, N, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* int8_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
