// int8 weight matmul with the per-output-channel scale folded into the
// epilogue:  y[M, N] = (x[M, K] @ q[K, N]) * s[N], rounded to x's dtype.
//
// Replaces the TPU kernel ops/int8_kernel.py:_make_kernel (the Pallas
// kernel behind int8_dot) of the JAX package. It runs at every projection
// of --quant int8 serving: wqkv, wo, wgu and wd of every layer. Two
// kernels compute that one function; the wrapper (ops/int8_kernel.py,
// `_route`) picks one from M, K, N and x's dtype alone:
//   * int8_dot_kernel, on the CUDA cores ("simt"): decode (M below
//     MMA_MIN_M), float32 x, and shapes the tensor-core route does not take;
//   * int8_dot_mma_kernel, on the tensor cores ("mma"): bf16 x at prefill M
//     with N % 16 == 0 and K % 8 == 0 (every llama-3.1-8b site).
//
// ---- int8_dot_kernel (CUDA cores) ----
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
// Not done yet: split-K across blocks, so that the N = 4096 sites fill all
// 132 SMs at decode.
//
// ---- int8_dot_mma_kernel (tensor cores, bf16 x) ----
// Replaces int8_dot_kernel at prefill M (the prompt, every prefill chunk,
// every failover replay), where the CUDA-core kernel re-reads every weight
// for each 8-row M tile. What bounds it: at M <= ~128 each int8 weight byte
// carries 2M FLOP, below the H100's bf16 ridge of ~295 FLOP/byte, so the
// work is bound by the weight bytes (0.066 ms a llama-3.1-8b layer at
// M = 30); above that, by the tensor cores. What the design does about it
// (the structure of nf4_dot_mma_kernel, csrc/nf4_dot.cu):
//   * A block owns a BM x BN output tile and walks K in steps of 128 rows.
//     BM = 32 for M <= 32, else 64. BN is the widest tile whose grid still
//     gives every SM a block (128 at BM = 32, 64 at BM = 64), else 32: a
//     wider tile re-reads x from L2 fewer times. The grid is ceil(M/BM) x
//     ceil(N/BN) with the M tiles fastest, so the M tiles of one column
//     stripe run together and share its bytes in L2.
//   * Two rings in shared memory, filled with 16-byte cp.async.cg copies
//     (zero-filled past K, N and M): warps 0-3 copy the int8 rows, warps 4-7
//     the x tile (cp.async groups are per thread, so each ring waits only
//     for its own copies and runs ahead by its own distance). At BN = 32,
//     about one block an SM, 7 and 3 steps ahead (76 KB at BM = 32); at
//     the wider tiles 2 and 2, so that two or three blocks share an SM and
//     one block's copies and barriers overlap another's work.
//   * Each weight is widened once per block: per step the 8 warps turn the
//     stage's int8 rows into a bf16 [128 rows][BN] tile, int8 -> float ->
//     bf16, exact for +-127, so the tile equals q.to(bfloat16) bit for bit.
//     No scale touches the tile.
//   * WMMA bf16 16x16x16 products with float accumulators. Every output is
//     the sum of 4 chains in a fixed order, chain c taking the k-slices c
//     and c + 4 of each step: the 8 warps are 2 groups of 4 chains, and the
//     groups split the tile by columns (BN >= 64) or by rows. So a result
//     depends on its row of x and its column of q alone, never on M, N or
//     whether wq|wk|wv are fused (the stage executors fuse them, a
//     full_forward over the loaded weights does not), and it is
//     deterministic. The chains are
//     added through shared memory (aliased onto the drained rings), and
//     only then is each column multiplied by its f32 scale and rounded: the
//     reference's (acc * s).astype(out). Tile rows are padded by 16 bytes so
//     the fragment loads do not conflict on banks.
//   * bf16 x * bf16 w is exact in float32: only the order of the sums differs
//     from the plain version. Rows past M and columns past N are not stored.
// Measured (PERF.md): the copies, not the widening or the products, take
// most of its time at the prompt's M, and at BN = 32 the x tile a block
// re-reads from L2 is twice its int8 bytes. Sharing x between blocks
// (clusters) or wider tiles at N = 4096 (split-K) is a later PR's work, as
// are wgmma/TMA where M reaches the hundreds.
//
// C interface (loaded with ctypes):
//   int int8_dot_launch(x, q, s, y, M, K, N, x_dtype, device, stream)
//     x_dtype: 0 = float32, 1 = bfloat16 (y has the same dtype as x);
//     device: the CUDA device index of the tensors and of `stream`.
//     Returns the cudaError_t of the launch (0 = success).
//   int int8_dot_mma_launch(...the same arguments...)
//     The tensor-core route: x_dtype 1 only, N % 16 == 0, K % 8 == 0, and
//     x, q, s, y 16-byte aligned (else an error code, no launch).
//   const char* int8_dot_error_string(int code)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
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

// ---- The tensor-core route ----

namespace wmma = nvcuda::wmma;

constexpr int kMmaThreads = 256;  // 8 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kLoadThreads = kMmaThreads / 2;  // per ring: weights, x
// Shared memory of an SM (228 KB), and what each block takes besides its
// dynamic shared memory (1 KB reserved).
constexpr int kSmemPerSM = 233472;
constexpr int kSmemPerBlock = 1024;

// Every output element is the sum, in this order, of kChains partial sums;
// chain c adds the products of the k-slices c, c + kChains, ... of each
// step in K order. So a result depends on its row of x and its column of q
// alone, not on the tile (M, N, a fused or a separate weight).
constexpr int kChains = 4;

// One block's tile: BM x BN outputs; K in steps of BK rows. Warps 0-3 copy
// the int8 rows through a ring of kStages steps, warps 4-7 copy x through a
// ring of kXStages steps (cp.async groups are per thread, so the two rings
// run ahead by different distances). Warp w is chain w % kChains of group
// w / kChains; the two groups split the tile by columns where BN >= 64,
// else by rows. The 32-column tile runs where N leaves about one block an
// SM (the N = 4096 sites), so its rings run deep (32 KB of weights, 3 x
// tiles ahead); wider tiles keep them short, so that two or three blocks
// share an SM.
template <int BM_, int BN_>
struct MmaTile {
  static constexpr int BM = BM_, BN = BN_, BK = 128;
  static constexpr int kStages = BN == 32 ? 8 : 3, kXStages = BN == 32 ? 4 : 3;
  static constexpr bool kSplitN = BN >= 64;
  static constexpr int kGroupRows = kSplitN ? BM : BM / 2;  // a group's part
  static constexpr int kGroupCols = kSplitN ? BN / 2 : BN;
  static constexpr int kFragM = kGroupRows / 16, kFragN = kGroupCols / 16;
  static constexpr int kK16PerWarp = BK / 16 / kChains;
  static constexpr int kXPitch = BK + 8;               // bf16: x tile rows
  static constexpr int kWPitch = BN + 8;               // bf16: weight tile rows
  static constexpr int kRedPitch = BN + 4;             // floats
  static constexpr int kXBytes = BM * kXPitch * 2;     // one x stage
  static constexpr int kQBytes = BK * BN;              // one int8 stage
  static constexpr int kXRingBytes = kXStages * kXBytes;
  static constexpr int kRingBytes = kStages * kQBytes;
  static constexpr int kWBytes = BK * kWPitch * 2;
  static constexpr int kMainBytes = kXRingBytes + kRingBytes + kWBytes;
  static constexpr int kRedBytes = kChains * BM * kRedPitch * 4;
  static constexpr int kSmemBytes = kMainBytes > kRedBytes ? kMainBytes : kRedBytes;
  // Blocks an SM by shared memory, and by registers: 3 x 256 threads at
  // <= 85 a thread up to 4 accumulator tiles a warp, else 2.
  static constexpr int kBlocksPerSM = kSmemPerSM / (kSmemBytes + kSmemPerBlock);
  static constexpr int kRegBlocks = kFragM * kFragN <= 4 ? 3 : 2;
  static constexpr int kMinBlocks = kBlocksPerSM < kRegBlocks ? kBlocksPerSM : kRegBlocks;
  static_assert(kGroupRows % 16 == 0 && kGroupCols % 16 == 0, "whole tiles");
  static_assert(kMmaWarps == 2 * kChains && (BK / 16) % kChains == 0,
                "two groups of kChains warps, each chain with whole k-slices");
  static_assert(kStages >= 2 && kXStages >= 2, "rings");
  static_assert(kBlocksPerSM >= 1, "fits an SM");
  static_assert(kXBytes % 128 == 0 && kQBytes % 128 == 0 && kWBytes % 128 == 0,
                "aligned buffers");
};

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (then
// `src` is only a valid address and nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Step `step`'s int8 rows (BK x BN) into one weight stage; `t` is the
// thread's index among the weight loaders.
template <class T>
__device__ __forceinline__ void mma_load_q(int8_t* qs,
                                           const int8_t* __restrict__ q,
                                           int step, int n0, int K, int N,
                                           int t) {
  for (int i = t; i < T::BK * (T::BN / 16); i += kLoadThreads) {
    const int row = i / (T::BN / 16), chunk = i % (T::BN / 16);
    const int k = step * T::BK + row, n = n0 + chunk * 16;
    const bool ok = k < K && n < N;  // N % 16 == 0: a chunk is all in or out
    cp_async16(qs + row * T::BN + chunk * 16,
               ok ? q + static_cast<size_t>(k) * N + n : q, ok);
  }
}

// Step `step`'s x tile (BM rows x BK) into one x stage; `t` is the thread's
// index among the x loaders.
template <class T>
__device__ __forceinline__ void mma_load_x(__nv_bfloat16* xs,
                                           const __nv_bfloat16* __restrict__ x,
                                           int step, int m0, int M, int K,
                                           int t) {
  for (int i = t; i < T::BM * (T::BK / 8); i += kLoadThreads) {  // 8 a chunk
    const int row = i / (T::BK / 8), chunk = i % (T::BK / 8);
    const int m = m0 + row, k = step * T::BK + chunk * 8;
    const bool ok = m < M && k < K;  // K % 8 == 0: a chunk is all in or out
    cp_async16(xs + row * T::kXPitch + chunk * 8,
               ok ? x + static_cast<size_t>(m) * K + k : x, ok);
  }
}

// The stage's int8 rows into the bf16 weight tile ws[k][n]: 16 weights a
// thread per pass, int8 -> float -> bf16 (exact), two 16-byte stores.
template <class T>
__device__ __forceinline__ void mma_widen(const int8_t* qs, __nv_bfloat16* ws) {
  static_assert(T::BK * (T::BN / 16) % kMmaThreads == 0, "whole passes");
#pragma unroll
  for (int p = 0; p < T::BK * (T::BN / 16) / kMmaThreads; ++p) {
    const int i = threadIdx.x + p * kMmaThreads;
    const int row = i / (T::BN / 16), c0 = (i % (T::BN / 16)) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(qs + row * T::BN + c0);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    __align__(16) __nv_bfloat162 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = __floats2bfloat162_rn(static_cast<float>(b[2 * j]),
                                   static_cast<float>(b[2 * j + 1]));
    }
    int4* out = reinterpret_cast<int4*>(ws + row * T::kWPitch + c0);
    out[0] = reinterpret_cast<const int4*>(v)[0];
    out[1] = reinterpret_cast<const int4*>(v)[1];
  }
}

template <class T>
__global__ void __launch_bounds__(kMmaThreads, T::kMinBlocks)
    int8_dot_mma_kernel(const __nv_bfloat16* __restrict__ x,
                        const int8_t* __restrict__ q,
                        const float* __restrict__ s,
                        __nv_bfloat16* __restrict__ y, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int chain = warp % kChains, group = warp / kChains;
  const int r0 = T::kSplitN ? 0 : group * T::kGroupRows;  // within the tile
  const int c0 = T::kSplitN ? group * T::kGroupCols : 0;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int steps = (K + T::BK - 1) / T::BK;
  __nv_bfloat16* xring = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* qring = reinterpret_cast<int8_t*>(smem + T::kXRingBytes);
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(smem + T::kXRingBytes + T::kRingBytes);
  const bool weight_loader = threadIdx.x < kLoadThreads;  // warps 0-3
  const int lt = threadIdx.x % kLoadThreads;

  // Each loader fills its ring but one stage; empty groups keep its wait
  // count uniform.
  if (weight_loader) {
    for (int st = 0; st < T::kStages - 1; ++st) {
      if (st < steps) {
        mma_load_q<T>(qring + st * T::kQBytes, q, st, n0, K, N, lt);
      }
      cp_async_commit();
    }
  } else {
    for (int st = 0; st < T::kXStages - 1; ++st) {
      if (st < steps) {
        mma_load_x<T>(xring + st * (T::kXBytes / 2), x, st, m0, M, K, lt);
      }
      cp_async_commit();
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kFragM]
                                                          [T::kFragN];
#pragma unroll
  for (int i = 0; i < T::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int step = 0; step < steps; ++step) {
    // Each loader's copies of step `step` have landed; after the barrier
    // all have, and every warp is done with step - 1, whose ring slots and
    // weight tile are now free.
    if (weight_loader) {
      cp_async_wait<T::kStages - 2>();
    } else {
      cp_async_wait<T::kXStages - 2>();
    }
    __syncthreads();
    if (weight_loader) {
      const int next = step + T::kStages - 1;
      if (next < steps) {
        mma_load_q<T>(qring + (next % T::kStages) * T::kQBytes, q, next, n0,
                      K, N, lt);
      }
    } else {
      const int next = step + T::kXStages - 1;
      if (next < steps) {
        mma_load_x<T>(xring + (next % T::kXStages) * (T::kXBytes / 2), x,
                      next, m0, M, K, lt);
      }
    }
    cp_async_commit();
    mma_widen<T>(qring + (step % T::kStages) * T::kQBytes, ws);
    __syncthreads();
    const __nv_bfloat16* xs = xring + (step % T::kXStages) * (T::kXBytes / 2);
#pragma unroll
    for (int sl = 0; sl < T::kK16PerWarp; ++sl) {
      const int kk = (chain + sl * kChains) * 16;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          b[T::kFragN];
#pragma unroll
      for (int j = 0; j < T::kFragN; ++j) {
        wmma::load_matrix_sync(b[j], ws + kk * T::kWPitch + c0 + j * 16,
                               T::kWPitch);
      }
#pragma unroll
      for (int i = 0; i < T::kFragM; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, xs + (r0 + i * 16) * T::kXPitch + kk,
                               T::kXPitch);
#pragma unroll
        for (int j = 0; j < T::kFragN; ++j) {
          wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
        }
      }
    }
  }

  // The chains' partial sums, through shared memory (over the drained rings
  // and the weight tile), added in chain order; then the column's scale,
  // then one rounding.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < T::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFragN; ++j) {
      wmma::store_matrix_sync(
          red + (chain * T::BM + r0 + i * 16) * T::kRedPitch + c0 + j * 16,
          acc[i][j], T::kRedPitch, wmma::mem_row_major);
    }
  __syncthreads();
  for (int e = threadIdx.x; e < T::BM * T::BN; e += kMmaThreads) {
    const int r = e / T::BN, c = e % T::BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < kChains; ++g) {
        sum += red[(g * T::BM + r) * T::kRedPitch + c];
      }
      y[static_cast<size_t>(m) * N + n] = __float2bfloat16_rn(sum * s[n]);
    }
  }
}

template <class T>
cudaError_t launch_mma(const void* x, const void* q, const void* s, void* y,
                       int M, int K, int N, cudaStream_t stream) {
  if ((N + T::BN - 1) / T::BN > 65535) return cudaErrorInvalidValue;
  // Above 48 KB of dynamic shared memory must be asked for first.
  cudaError_t err = cudaFuncSetAttribute(
      int8_dot_mma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((M + T::BM - 1) / T::BM, (N + T::BN - 1) / T::BN);
  int8_dot_mma_kernel<T><<<grid, kMmaThreads, T::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(y), M, K, N);
  return cudaGetLastError();
}

// By M: the prompt's M tile in one block row; above 32 rows, 64-row tiles.
// By N: the widest tile whose grid still gives each of the 132 SMs a block
// (x is re-read from L2 once per column tile, and the grid fills the card in
// one wave): 128 columns at BM = 32 (wgu at the prompt's M: 224 blocks, two
// an SM), 64 otherwise; else 32 (the N = 4096 sites at M <= 64: 128
// blocks). 64 x 128 tiles would take one block an SM and were slower.
constexpr int kSMs = 132;

template <int BM, int BN>
bool fills_card(int M, int N) {
  return static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN) >= kSMs;
}

template <int BM>
cudaError_t launch_mma_m(const void* x, const void* q, const void* s, void* y,
                         int M, int K, int N, cudaStream_t stream) {
  constexpr int kWide = BM == 32 ? 128 : 64;
  return fills_card<BM, kWide>(M, N)
             ? launch_mma<MmaTile<BM, kWide>>(x, q, s, y, M, K, N, stream)
             : launch_mma<MmaTile<BM, 32>>(x, q, s, y, M, K, N, stream);
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

extern "C" int int8_dot_mma_launch(const void* x, const void* q, const void* s,
                                   void* y, int M, int K, int N, int x_dtype,
                                   int device, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || x_dtype != 1 || N % 16 != 0 ||
      K % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(y)) %
          16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = M <= 32 ? launch_mma_m<32>(x, q, s, y, M, K, N, st)
                : launch_mma_m<64>(x, q, s, y, M, K, N, st);
  return static_cast<int>(err);
}

extern "C" const char* int8_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
