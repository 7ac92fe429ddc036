// The threefry Gumbel-max draw: for each row r of float32 logp [B, V] and
// its key (k0[r], k1[r]), the token
//
//   argmax_i ( gumbel(key_r)[i] + logp[r, i] )      (first index on ties)
//
// bit for bit the plain version, ops/threefry.py `categorical_reference`,
// which is jax.random.categorical (jax 0.9, threefry2x32, partitionable
// bits, Gumbel mode "low"):
//   * bits  = b0 ^ b1 of threefry2x32(key, (i >> 32, i & 0xFFFFFFFF));
//   * f     = the float in [1, 2) with mantissa bits >> 9, minus 1;
//   * u     = max(tiny, f * (1 - tiny) + tiny), the product exact in double
//             and one rounding to float (XLA's FMA, threefry.py `uniform`);
//   * noise = -log(-log(u)), two float32 logf as torch's CUDA log computes
//             them: this file is built without fast math (no __logf).
//
// It is not the port of a Pallas kernel: the JAX package leaves the draw to
// XLA inside sample_token_jit (ops/sampling.py). It runs on the final stage
// for every sampled token, inside the captured sampler (runtime/graphs.py)
// and the fused sampled oracle (runtime/fused_decode.py).
//
// What bounds it on an H100: at B = 1 and V = 128256 it reads 0.51 MB of
// logp (0.15 us at 3.35 TB/s) and runs 128256 ciphers of 20 rounds, about
// 74 integer instructions each on sm_90 (a round is IADD3, a one-instruction
// SHF.L.W rotate and LOP3) plus two logf (~0.6 us of the CUDA cores' integer
// rate). Both are far below a launch's few microseconds: the draw is bound
// by its launch latency, and by nothing else, at these sizes.
//
// What the design does about it:
//   * one pass, one thread per element in turn: each block owns a chunk of
//     one row (1024 elements; 126 blocks a row at V = 128256), its 256
//     threads stride over it, the cipher stays in registers, and each
//     thread keeps its best (score, index); logp is read once and nothing
//     else of size V is written (the noise only on request, to check it);
//   * a block reduces its threads' bests with warp shuffles and one pass
//     through shared memory, and writes one (score, index) per block;
//   * a second kernel, one block a row, reduces the blocks' pairs. Both
//     reductions use one strict total order, `better`: the greater score,
//     NaN above all (as torch.argmax), the lower index on equal scores, so
//     the token does not depend on the order in which blocks or warps
//     finish, and ties go to the first index across blocks;
//   * one int32 token a row is written to device memory; nothing is read
//     back to the host, and the kernel allocates nothing (the wrapper
//     passes the per-block scratch).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// threefry2x32 (20 rounds) of the counter (hi, lo) under key (k0, k1); the
// two output words xor-ed, as jax's partitionable random bits.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t hi, uint32_t lo) {
  const uint32_t ks0 = k0, ks1 = k1, ks2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = hi + ks0;
  uint32_t x1 = lo + ks1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl32(x1, r) ^ x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks1; x1 += ks2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += ks2; x1 += ks0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks0; x1 += ks1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += ks1; x1 += ks2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks2; x1 += ks0 + 5u;
#undef TF_ROUND
  return x0 ^ x1;
}

// jax.random.gumbel's float32 noise of one element's bits.
__device__ __forceinline__ float gumbel_noise(uint32_t bits) {
  const float lo = FLT_MIN;          // torch.finfo(float32).tiny
  const float span = 1.0f - lo;      // rounds to 1.0f, as the plain version's
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  // The product of two floats is exact in double: one rounding of the sum.
  const float u = fmaxf(lo, static_cast<float>(static_cast<double>(f) *
                                                   static_cast<double>(span) +
                                               static_cast<double>(lo)));
  return -logf(-logf(u));
}

// The order of the argmax: is (a, ia) the better of (a, ia) and (b, ib)?
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && bn ? ia < ib : an;
  return a > b || (a == b && ia < ib);
}

// Reduce each thread's (v, i) to thread 0's, over a block of kThreads.
__device__ __forceinline__ void block_best(float& v, int& i) {
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? sv[lane] : -INFINITY;
    i = lane < kThreads / 32 ? si[lane] : INT32_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
  }
}

// Grid (blocks, B): block b of row r scores elements [b * chunk, (b + 1) *
// chunk) of the row and writes its best to part_{val,idx}[r * blocks + b].
__global__ void __launch_bounds__(kThreads)
draw_partial_kernel(const float* __restrict__ logp, const int64_t* __restrict__ keys,
                    int vocab, int chunk, float* __restrict__ noise_out,
                    float* __restrict__ part_val, int* __restrict__ part_idx) {
  const int row = blockIdx.y;
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * row]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * row + 1]);
  const size_t base = static_cast<size_t>(row) * vocab;
  const int begin = blockIdx.x * chunk;
  const int end = min(begin + chunk, vocab);
  float best = -INFINITY;
  int best_i = INT32_MAX;
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const float g = gumbel_noise(threefry_bits(k0, k1, 0u, static_cast<uint32_t>(i)));
    if (noise_out != nullptr) noise_out[base + i] = g;
    const float s = g + logp[base + i];
    if (better(s, i, best, best_i)) { best = s; best_i = i; }
  }
  block_best(best, best_i);
  if (threadIdx.x == 0) {
    part_val[row * gridDim.x + blockIdx.x] = best;
    part_idx[row * gridDim.x + blockIdx.x] = best_i;
  }
}

// Grid (B): row r's token, the best of its `parts` block results.
__global__ void __launch_bounds__(kThreads)
draw_final_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                  int parts, int* __restrict__ out) {
  const int row = blockIdx.x;
  float best = -INFINITY;
  int best_i = INT32_MAX;
  for (int p = threadIdx.x; p < parts; p += kThreads) {
    const float v = part_val[row * parts + p];
    const int i = part_idx[row * parts + p];
    if (better(v, i, best, best_i)) { best = v; best_i = i; }
  }
  block_best(best, best_i);
  if (threadIdx.x == 0) out[row] = best_i;
}

}  // namespace

// logp float32 [rows, vocab], keys int64 [rows, 2] (uint32 words), out
// int32 [rows]; part_val float32 and part_idx int32 [rows, blocks] scratch;
// noise_out float32 [rows, vocab] or null. The wrapper (ops/draw_kernel.py)
// picks blocks and chunk (blocks * chunk >= vocab > (blocks - 1) * chunk,
// chunk a multiple of 256).
extern "C" int sample_draw_launch(const void* logp, const void* keys, void* noise_out,
                                  void* part_val, void* part_idx, void* out,
                                  int rows, int vocab, int blocks, int chunk,
                                  int device, void* stream) {
  if (rows <= 0 || rows > 65535 || vocab <= 0 || blocks <= 0 || chunk <= 0 ||
      chunk % kThreads != 0 || static_cast<long long>(blocks) * chunk < vocab ||
      static_cast<long long>(blocks - 1) * chunk >= vocab ||
      static_cast<long long>(rows) * blocks >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // This library links its own CUDA runtime, whose current device is not
  // PyTorch's: launch on the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  draw_partial_kernel<<<dim3(blocks, rows), kThreads, 0, st>>>(
      static_cast<const float*>(logp), static_cast<const int64_t*>(keys), vocab, chunk,
      static_cast<float*>(noise_out), static_cast<float*>(part_val),
      static_cast<int*>(part_idx));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  draw_final_kernel<<<rows, kThreads, 0, st>>>(
      static_cast<const float*>(part_val), static_cast<const int*>(part_idx), blocks,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sample_draw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
