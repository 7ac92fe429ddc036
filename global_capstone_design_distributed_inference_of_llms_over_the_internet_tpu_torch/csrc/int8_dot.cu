// int8 weight matmul with the per-output-channel scale folded into the
// epilogue:  y[M, N] = (x[M, K] @ q[K, N]) * s[N], rounded to x's dtype.
//
// Replaces the TPU kernel ops/int8_kernel.py:_make_kernel (the Pallas
// kernel behind int8_dot, the pallas_call at :98) of the JAX package. It
// runs at every projection of --quant int8 serving: wqkv, wo, wgu and wd of
// every layer. Four kernels compute that one function; the wrapper
// (ops/int8_kernel.py, `_route`) picks one from M, K, N and x's dtype alone:
//   * int8_gemv_kernel ("gemv"): decode, M <= 2 (bf16 x below MMA_MIN_M,
//     float32 x at M <= 2), N % 16 == 0, K <= 32768;
//   * int8_f32mma_kernel ("f32mma"): float32 x at M >= 3 (stages 1-3's
//     prefill and the batched engine's rounds, which compute in the float32
//     the wire decodes to), N % 16 == 0, K % 4 == 0, K <= 32768;
//   * int8_dot_mma_kernel, on the tensor cores ("mma"): bf16 x at prefill M
//     with N % 16 == 0 and K % 8 == 0 (every llama-3.1-8b site);
//   * int8_dot_kernel, on the CUDA cores ("simt"): bf16 x at M 3-4, and
//     shapes the others do not take (N % 16 != 0; float32 x with K % 4 != 0
//     or K > 32768).
//
// ---- int8_gemv_kernel (decode: M <= 2, bf16 or float32 x) ----
// What bounds it on an H100: at M <= 2 every weight byte is used once or
// twice, so the work is bound by the bytes it reads: K * N int8 weights
// (218 MB for one llama-3.1-8b layer's four sites: 0.0652 ms at 3.35 TB/s).
// What the design does about it:
//   * Split-K across a thread-block cluster fills the card at every site. A
//     CTA of 4 warps owns a strip of 128 columns and a K chunk of it: a
//     whole number of 128-row stages, ceil(stages / S) of them for rank r
//     of a cluster of S <= 8 (the portable size) along K. The wrapper's
//     host function `_gemv_plan` picks S per shape and passes it in; the
//     launch takes it as its cluster dimension (cudaLaunchKernelEx), which
//     graphs capture. The plan depends on K alone (the least split that
//     gives every rank as many stages, at most 8), so that a fused weight
//     and its parts sum a column in the same order and give the same bits:
//     at llama-3.1-8b's sites wqkv 48 strips x 4, wo 32 x 4, wgu 224 x 4,
//     wd 32 x 8 CTAs.
//   * Each CTA sums its 4 warps' partials in shared memory in warp order and
//     stores the sum into rank 0's shared memory through distributed shared
//     memory (cooperative_groups map_shared_rank), one slot a rank; after a
//     cluster barrier rank 0 adds the slots in rank order 0..S-1, multiplies
//     each column by its f32 scale once and rounds to x's dtype. The result
//     is deterministic: one launch, no workspace, no atomics. (A relaxed
//     cluster arrive at the start, waited for before the push, makes sure
//     rank 0 has started before anyone writes to it.)
//   * The CTA streams its chunk in stages of 128 rows x 128 columns (16 KB),
//     by cp.async into a ring of 4 stages in shared memory (64 KB), 3
//     stages ahead of the work (the first three asked for before x is
//     staged): 48 KB a CTA, ~70 KB an SM in flight. One warp instruction
//     copies 4 rows x 128 contiguous bytes, and the CTA's 4 warps copy and
//     work on the same 128 rows together, one barrier a stage (warp w on
//     rows 32 w .. 32 w + 31): on the H100 a pure read of this shape ran
//     at ~1.4x the speed of one where each warp streamed its own rows
//     through a ring of its own (PERF.md). A stage's 16-byte chunks are
//     swizzled so that the lanes' fragment reads are free of bank
//     conflicts: lane (g, c) of a warp reads chunk g (16 columns) of rows
//     2c, 2c + 1, 2c + 8, 2c + 9 of each 16-row slice.
//   * No per-weight int-to-float conversion instruction (I2F runs at 16
//     results a clock an SM on sm_90, an eighth of the FFMA rate). For bf16
//     x: one byte_perm puts a weight of row 2c and one of row 2c + 1 (the
//     two k of an mma A-fragment register) under the low bytes of two
//     halves; two LOP3s make 0x4300 | (b & 0x7F) = 128 + (b & 0x7F) and
//     0x4300 | (b & 0x80) = 128 or 256 from each half; one bf16x2
//     subtraction leaves b exactly: 4 instructions for 2 weights. The
//     pair is one register of an mma.sync m16n8k16 A fragment: fragment row
//     g is column 16g + 2j, row g + 8 column 16g + 2j + 1, k the slice's
//     rows 2c, 2c + 1, 2c + 8, 2c + 9; x is the B fragment (fragment column
//     m = lane group g, zero past M). So the FMAs run on the tensor cores,
//     in float32. For float32 x: per 4-byte word one XOR with 0x80808080,
//     then per weight one byte_perm under the float exponent 0x4B000000
//     and one subtraction of 8388736.0f (b exactly), then M FFMAs on the
//     CUDA cores; the 4 lanes that share a column group add their sums with
//     two shuffles, in a fixed order.
//   * The CTA's K chunk of x (M <= 2 rows) is staged in shared memory once,
//     with 16-byte loads, zero past K; bf16 x in its own layout (a 32-bit
//     word is the B-fragment register of two k), float32 as it is.
//   * bf16 x * an int8 weight is exact in float32: only the order of the
//     float32 sums differs from the plain version.
// SASS (chip_smoke.py's int8_gemv_sass, PERF.md): the bf16 kernel's loop
// over a stage takes 128 weights a lane with 64 PRMT, 128 LOP3, 64 HADD2
// and 16 HMMA, 2.1 instructions a weight and no I2F (1616 instructions in
// all); the float32 kernel's 128 PRMT, 128 FADD, 32 LOP3 and 128 FFMA, 3.25
// a weight (1768); the old int8_dot_kernel<bf16, 1> 128 I2F beside 144
// FFMA, one conversion a weight (1488).
// Measured (PERF.md): a llama-3.1-8b layer's four sites at M = 1 in ~0.132
// ms with the L2 cold (bf16 and float32 x alike), 2.0x the byte bound,
// against 0.177 for int8_dot_kernel in the same run.
//
// ---- int8_f32mma_kernel (float32 x at M >= 3) ----
// Stages 1-3 compute in the float32 the wire decodes to, as the reference
// does: their prefill projections get float32 x at the prompt's bucket (M
// = 32 for chip_smoke.py's prompts; failover replays 33-63, chunks up to
// 2048), and a batched round every slot (M = --slots, 8). What bounds it on
// an H100: at M = 8 each weight byte carries 16 FLOP, at M = 32 64, far
// below the tensor cores' ridge, so the K * N int8 bytes (0.066 ms a
// llama-3.1-8b layer) if the products ran on the tensor cores; float32
// products are not bf16 ones, though. int8_dot_kernel<float, 8> did an I2F
// and M FFMAs a weight on the CUDA cores, re-read every weight for each
// 8-row M tile, and had no split-K. What the design does about it:
// int8_gemv_kernel's structure (the strips, the cluster split-K with its
// plan, the cp.async ring, the conflict-free swizzle, the exact bf16 A
// fragments of gemv_widen_pair) with x in the B fragments:
//   * M tiles of 16 rows (two n8 fragments of x) past M = 8, 8 rows up to
//     it, along the grid's second dimension, next to each other, so the M
//     tiles of a strip share its weight bytes in L2. Each A fragment is
//     widened once for both fragments: 6 mma a widening at 16 rows. 8-row
//     tiles at every M ran a layer at M = 32 in 0.306 ms against 0.237
//     (scripts/torch_f32mma_variants.py int8_dot rows8, PERF.md).
//   * Each ring slot carries its stage's 128 rows of the tile's x (float32,
//     4 or 8.5 KB) beside the 16 KB of weights, copied with them, so x is
//     never staged ahead of the loop: a rank's whole chunk of x, split,
//     would take 48-84 KB of shared memory at 8 rows and its loads would
//     run in series at each CTA's start (0.237 ms a layer against 0.165 at
//     M = 8, chip_smoke.py, PERF.md).
//   * A lane splits its B fragments into three bf16 terms as it reads
//     them: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid) (each
//     subtraction exact; three terms hold every normal float32 exactly).
//     Each x value is read, and split, by one lane of a CTA: once for each
//     column strip, with no scratch. A build with no split instruction at
//     all (wrong sums, the variants script's nosplit) ran a layer 1-2%
//     faster at M = 32 and under 1% at M = 8: the most a split pre-pass,
//     as nf4_dot's, could save, for its own launch and 3 x M x K bf16 of
//     scratch in every captured prefill graph's pool (176 MB at a
//     2048-row chunk of wd). Per A fragment one mma a fragment and term,
//     hi first, into the same float32 accumulators: each term * int8
//     product is exact, so only the order of the float32 sums (and the
//     tensor cores' own accumulation) differs from the plain version.
//   * A row's sums never touch another row's, and a fragment's
//     accumulators take the same products in the same order at either
//     tile size, so a row gives the same bits whatever M it is launched at
//     and whatever the other rows hold.
//   * After the loop each warp's sums go into the drained ring, in a padded
//     layout free of bank conflicts (f32mma_sum_at); once every rank is
//     past its loop each pushes its sum of row m (warps in order) into rank
//     m % split's slots through distributed shared memory, and after a
//     cluster barrier each rank adds its rows' slots in rank order and
//     writes y: at 16 rows and split 8 two rows a rank, not all 16 on rank
//     0. With a ring of 3 slots a CTA takes 62208 bytes at 8 rows and
//     75264 at 16, and three fit an SM (128 and 168 registers); a ring of
//     4 ran 7% slower at M = 32 (the variants script's stages4).
//   * The plan (strip, split) is the gemv's `_gemv_plan`, a function of K
//     alone, so that a fused weight and its parts sum every column in the
//     same order. x needs K % 4 == 0 (16-byte copies, all in or all out).
// Two terms would leave 2.0-3.0e-6 of max|plain| at the llama-3.1-8b sites
// against three's 0.8-2.0e-6, for 3% of the time at M = 8 (PERF.md): the
// kernel takes three (scripts/torch_f32mma_variants.py compares builds with
// other constants).
// Measured (PERF.md): a llama-3.1-8b layer's four sites at M = 32 in ~0.236
// ms with the L2 cold, against ~1.145 for int8_dot_kernel<float, 8> and
// ~0.465 for torch.matmul on the float32-widened weight in the same run
// (3.5x the 0.068 ms byte bound); ~0.143 at M = 8. The products run near
// mma.sync's issue rate; set-up, the cluster barriers and the push take
// about a quarter of a CTA (scripts/torch_f32mma_profile.py int8_dot).
//
// ---- int8_dot_kernel (CUDA cores) ----
// The first port of the kernel, the decode kernel until the gemv route and
// float32 prefill until the f32mma route took every float32 M >= 3: now bf16
// x at M 3-4 and the shapes the other routes do not take.
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
// At M = 1 (PERF.md) it ran at 2.7x the byte bound: 128 blocks at N = 4096
// on 132 SMs, and one int8-to-float conversion instruction a weight.
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
//   int int8_dot_gemv_launch(...the same arguments..., strip_cols, split)
//     The decode route: M <= 2, N % 16 == 0, q 16-byte aligned,
//     strip_cols == 128, 1 <= split <= 8 (the cluster size), at most 128
//     stages of 128 rows a rank (else an error code, no launch).
//   int int8_dot_f32mma_launch(...the gemv's arguments...)
//     The float32 route: x_dtype 0 only, M >= 1, K % 4 == 0, N % 16 == 0,
//     x and q 16-byte aligned, strip_cols == 128, 1 <= split <= 8 (else an
//     error code, no launch); 8-row M tiles up to M = 8, 16-row past it.
//   const char* int8_dot_error_string(int code)

#include <cooperative_groups.h>
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

// ---- The decode route: split-K over a cluster ----

namespace cg = cooperative_groups;

constexpr int kGemvWarps = 4;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvStrip = 128;     // columns a CTA: 8 lane groups x 16
constexpr int kGemvMaxSplit = 8;    // the portable cluster size
constexpr int kGemvRows = 128;      // rows of q a stage: 32 for each warp
constexpr int kGemvMaxChunk = 32;   // stages a rank (its x stage)
constexpr int kGemvStages = 4;      // the CTA's ring of stages
constexpr int kGemvStageBytes = kGemvRows * kGemvStrip;  // 16 KB
constexpr int kGemvRingBytes = kGemvStages * kGemvStageBytes;
constexpr int kGemvCopies = kGemvStageBytes / 16 / kGemvThreads;  // a thread's
constexpr int kGemvXPad = 8;        // elements past each staged row of x

// The row of a warp's 32 that its lane group c reads as load e: in slice
// t = e / 4 (16 rows, one mma k-slice), rows 2c, 2c + 1, 2c + 8, 2c + 9.
__device__ __forceinline__ int gemv_row(int e, int c) {
  return 16 * (e >> 2) + 2 * c + (e & 1) + 8 * ((e >> 1) & 1);
}

// A stage in shared memory is [128 rows][8 chunks of 16 bytes], chunk j of
// row r at position j ^ (2 ((r >> 1) & 3)): a lane of group (g, c) reads
// chunk g of rows 2c + ..., so the 8 lanes of a quarter-warp hit 8
// different bank quads.
__device__ __forceinline__ int gemv_chunk(int r, int j) {
  return j ^ (((r >> 1) & 3) << 1);
}

// This thread's 8 copies of stage `stage` (rows 128 stage .. + 127 of the
// strip) into ring slot `slot`: copy e of thread t is chunk t % 8 of row
// 16 e + t / 8, so one warp instruction reads 4 rows x 128 contiguous
// bytes; zero-filled past K and N.
__device__ __forceinline__ void gemv_copy(unsigned char* slot,
                                          const int8_t* __restrict__ q,
                                          int stage, int n_strip, int K, int N) {
  const int r0 = threadIdx.x >> 3, j = threadIdx.x & 7;
  const int n = n_strip + 16 * j;
#pragma unroll
  for (int e = 0; e < kGemvCopies; ++e) {
    const int r = r0 + 16 * e;
    const int k = stage * kGemvRows + r;
    const bool ok = k < K && n < N;  // N % 16 == 0: all 16 columns or none
    cp_async16(slot + r * kGemvStrip + 16 * gemv_chunk(r, j),
               ok ? q + static_cast<size_t>(k) * N + n : q, ok);
  }
}

// (a & b) | c in one LOP3.
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Byte e of `lo` and of `hi` (the same column in rows 2c and 2c + 1) as a
// bf16 pair, exactly, with no conversion instruction: the bytes go under
// the low bytes of two halves; 0x4300 | (b & 0x7F) is 128 + (b & 0x7F),
// 0x4300 | (b & 0x80) is 128 or 256, and their difference is b.
template <int E>
__device__ __forceinline__ uint32_t gemv_widen_pair(uint32_t lo, uint32_t hi) {
  const uint32_t p = __byte_perm(lo, hi, 0x4400u + 0x1111u * E);
  const uint32_t v = and_or(p, 0x007F007Fu, 0x43004300u);
  const uint32_t b = and_or(p, 0x00800080u, 0x43004300u);
  uint32_t out;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(out) : "r"(v), "r"(b));
  return out;
}

// Byte I of a word already XORed with 0x80808080 (b + 128) as a float,
// exactly: under the exponent of 2^23, then 2^23 + 128 off.
template <int I>
__device__ __forceinline__ float gemv_widen(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650u | I)) -
         8388736.0f;
}

__device__ __forceinline__ void gemv_mma(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A lane's sums: for bf16 x, the 8 mma accumulators of its column group
// (lanes with c = 0 hold y[m][16g + 2j] in d[j][m], y[m][16g + 2j + 1] in
// d[j][2 + m]); for float32 x, acc[m][j] of its 16 columns.
template <typename T, int M>
struct GemvAcc;

template <int M>
struct GemvAcc<__nv_bfloat16, M> {
  float d[8][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[j][i] = 0.f;
  }
  // A warp's 32 rows of a stage: per 16-row slice the x pairs of rows 2c,
  // 2c + 1 and 2c + 8, 2c + 9 (lane group g is fragment column m = g), then
  // per column pair j one mma over 16 columns x 16 rows.
  __device__ __forceinline__ void rows(const int4 (&w)[8],
                                       const __nv_bfloat16* xs, int xstride,
                                       int row0, int g, int c) {
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(xs) +
                         (g < M ? g : 0) * (xstride / 2);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int r = (row0 + 16 * t) / 2 + c;
      const uint32_t x0 = xw[r], x1 = xw[r + 4];
      const uint32_t b0 = g < M ? x0 : 0u, b1 = g < M ? x1 : 0u;
      const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&w[4 * t]);
      const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&w[4 * t + 1]);
      const uint32_t* w2 = reinterpret_cast<const uint32_t*>(&w[4 * t + 2]);
      const uint32_t* w3 = reinterpret_cast<const uint32_t*>(&w[4 * t + 3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // word q: columns 4q..4q+3 = pairs 2q, 2q+1
        uint32_t a[4];
        a[0] = gemv_widen_pair<0>(w0[q], w1[q]);
        a[1] = gemv_widen_pair<1>(w0[q], w1[q]);
        a[2] = gemv_widen_pair<0>(w2[q], w3[q]);
        a[3] = gemv_widen_pair<1>(w2[q], w3[q]);
        gemv_mma(d[2 * q], a, b0, b1);
        a[0] = gemv_widen_pair<2>(w0[q], w1[q]);
        a[1] = gemv_widen_pair<3>(w0[q], w1[q]);
        a[2] = gemv_widen_pair<2>(w2[q], w3[q]);
        a[3] = gemv_widen_pair<3>(w2[q], w3[q]);
        gemv_mma(d[2 * q + 1], a, b0, b1);
      }
    }
  }
  // y[m][16g + jj] of the lane's column group (valid on lanes with c = 0).
  __device__ __forceinline__ float out(int m, int jj) const {
    return d[jj >> 1][(jj & 1) * 2 + m];
  }
  __device__ __forceinline__ void reduce_lanes() {}
};

template <int M>
struct GemvAcc<float, M> {
  float acc[M][16];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;
  }
  template <int I>
  __device__ __forceinline__ void column(uint32_t biased, int j,
                                         const float (&xv)[M]) {
    const float wf = gemv_widen<I>(biased);
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m][j] = fmaf(xv[m], wf, acc[m][j]);
  }
  __device__ __forceinline__ void rows(const int4 (&w)[8],
                                       const float* xs, int xstride,
                                       int row0, int, int c) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = row0 + gemv_row(e, c);
      float xv[M];
#pragma unroll
      for (int m = 0; m < M; ++m) xv[m] = xs[m * xstride + r];
      const uint32_t* wv = reinterpret_cast<const uint32_t*>(&w[e]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t biased = wv[q] ^ 0x80808080u;
        column<0>(biased, 4 * q, xv);
        column<1>(biased, 4 * q + 1, xv);
        column<2>(biased, 4 * q + 2, xv);
        column<3>(biased, 4 * q + 3, xv);
      }
    }
  }
  __device__ __forceinline__ float out(int m, int jj) const {
    return acc[m][jj];
  }
  // The 4 lanes of a column group (c = lane % 4) hold sums over different
  // rows: (c0 + c1) + (c2 + c3) on every one of them.
  __device__ __forceinline__ void reduce_lanes() {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 1);
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 2);
      }
  }
};

// Shared memory of a CTA: the warps' rings, the x stage [M][chunk rows +
// pad], the warps' sums [warps][M][strip] and rank 0's slots
// [split][M][strip].
template <typename T, int M>
constexpr size_t gemv_smem(int chunk, int split) {
  return kGemvRingBytes + sizeof(T) * M * (chunk * kGemvRows + kGemvXPad) +
         sizeof(float) * (kGemvWarps + split) * M * kGemvStrip;
}

// The CTA's rows [row0, row0 + nrows) of x (M rows) into the stage:
// 16-byte loads where `vec` (K a multiple of them and x 16-byte aligned; a
// load is then all inside K or all past it), else one element at a time;
// zero past K.
template <typename T, int M>
__device__ __forceinline__ void gemv_stage_x(T* xs, const T* __restrict__ x,
                                             int xstride, int row0, int nrows,
                                             int K, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      for (int i = threadIdx.x; i < nrows / kVec; i += kGemvThreads) {
        const int k = row0 + i * kVec;
        const int4 v = k < K ? __ldg(reinterpret_cast<const int4*>(
                                   x + static_cast<size_t>(m) * K + k))
                             : make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(xs + m * xstride + i * kVec) = v;
      }
    }
    return;
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    for (int r = threadIdx.x; r < nrows; r += kGemvThreads) {
      const int k = row0 + r;
      xs[m * xstride + r] =
          k < K ? x[static_cast<size_t>(m) * K + k] : from_f32<T>(0.f);
    }
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kGemvThreads)
    int8_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                     const float* __restrict__ s, T* __restrict__ y, int K,
                     int N, int chunk, bool vec_x) {
  extern __shared__ __align__(16) unsigned char gsmem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // the cluster spans gridDim.x
  const int split = gridDim.x;
  const int strip0 = blockIdx.y * kGemvStrip;
  const int stages = (K + kGemvRows - 1) / kGemvRows;
  const int s0 = rank * chunk;
  const int nrows = max(min(s0 + chunk, stages) - s0, 0) * kGemvRows;
  const int xstride = chunk * kGemvRows + kGemvXPad;
  T* xs = reinterpret_cast<T*>(gsmem + kGemvRingBytes);
  float* wsum = reinterpret_cast<float*>(gsmem + kGemvRingBytes +
                                         sizeof(T) * M * xstride);
  float* slots = wsum + kGemvWarps * M * kGemvStrip;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  // The rank's stages s0 .. s1 - 1 through the ring; the first
  // kGemvStages - 1 are asked for before x is staged, and each later one
  // kGemvStages - 1 stages ahead of the work.
  const int count = max(min(s0 + chunk, stages) - s0, 0);
#pragma unroll
  for (int i = 0; i < kGemvStages - 1; ++i) {
    if (i < count) gemv_copy(gsmem + i * kGemvStageBytes, q, s0 + i, strip0, K, N);
    cp_async_commit();
  }
  // A rank writes rank 0's shared memory only once every rank has started:
  // arrive now, wait before the push (long since met by then).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  gemv_stage_x<T, M>(xs, x, xstride, s0 * kGemvRows, nrows, K, vec_x);

  GemvAcc<T, M> acc;
  acc.zero();
  // Warp w works on rows 32 w .. 32 w + 31 of each stage; lane (g, c) reads
  // chunk g of its rows (at position g ^ 2c: gemv_chunk).
  const int lane_off = 32 * warp * kGemvStrip + 16 * (g ^ (2 * c));
  for (int i = 0; i < count; ++i) {
    // Stage i's copies (this thread's) have landed; after the barrier all
    // have, x is staged, and every warp is done with stage i - 1, whose
    // slot the next copies take.
    cp_async_wait<kGemvStages - 2>();
    __syncthreads();
    if (i + kGemvStages - 1 < count) {
      gemv_copy(gsmem + ((i + kGemvStages - 1) % kGemvStages) * kGemvStageBytes, q,
                s0 + i + kGemvStages - 1, strip0, K, N);
    }
    cp_async_commit();
    const unsigned char* st =
        gsmem + (i % kGemvStages) * kGemvStageBytes + lane_off;
    int4 w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      w[e] = *reinterpret_cast<const int4*>(st + gemv_row(e, c) * kGemvStrip);
    }
    acc.rows(w, xs, xstride, i * kGemvRows + 32 * warp, g, c);
  }
  cp_async_wait<0>();
  acc.reduce_lanes();
  if (c == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
        wsum[(warp * M + m) * kGemvStrip + 16 * g + jj] = acc.out(m, jj);
  }
  __syncthreads();
  // This CTA's sum, warps in order, into its slot of rank 0's shared memory.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* root = cluster.map_shared_rank(slots, 0);
  for (int i = threadIdx.x; i < M * kGemvStrip; i += kGemvThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) v += wsum[w * M * kGemvStrip + i];
    root[rank * M * kGemvStrip + i] = v;
  }
  cluster.sync();
  if (rank == 0) {
    for (int i = threadIdx.x; i < M * kGemvStrip; i += kGemvThreads) {
      const int m = i / kGemvStrip, n = strip0 + i % kGemvStrip;
      if (n < N) {
        float v = 0.f;
        for (int r = 0; r < split; ++r) v += slots[r * M * kGemvStrip + i];
        y[static_cast<size_t>(m) * N + n] = from_f32<T>(v * s[n]);
      }
    }
  }
}

// A launch of `kernel` on `grid`, the grid.x ranks of a split along K one
// thread-block cluster (cudaLaunchKernelEx, which CUDA graphs capture),
// with `smem` bytes of dynamic shared memory: above 48 KB it must be asked
// for first. Both split-K kernels launch this way.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kGemvThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int M>
cudaError_t launch_gemv(const void* x, const void* q, const void* s, void* y,
                        int K, int N, int split, cudaStream_t stream) {
  const int stages = (K + kGemvRows - 1) / kGemvRows;
  const int chunk = (stages + split - 1) / split;
  const int strips = (N + kGemvStrip - 1) / kGemvStrip;
  if (chunk > kGemvMaxChunk || strips > 65535) return cudaErrorInvalidValue;
  const bool aligned = K % (16 / static_cast<int>(sizeof(T))) == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return launch_cluster(int8_gemv_kernel<T, M>, dim3(split, strips, 1),
                        gemv_smem<T, M>(chunk, split),
                        stream, static_cast<const T*>(x), static_cast<const int8_t*>(q),
                        static_cast<const float*>(s), static_cast<T*>(y), K, N, chunk,
                        aligned);
}

// The most a CTA takes (kGemvMaxChunk stages of float32 x at M = 2, the
// largest cluster's slots): 108 KB, two CTAs an SM.
static_assert(2 * (gemv_smem<float, 2>(kGemvMaxChunk, kGemvMaxSplit) + 1024) <=
                  kSmemPerSM,
              "two of the gemv's largest CTAs fit an SM's shared memory");

// ---- The float32 route: float32 x at M >= 3 as bf16 terms ----

constexpr int kF32MmaRows = 8;      // rows of x in one n8 B fragment of the mma
constexpr int kF32MmaMaxFrags = 2;  // fragments a CTA: 16-row M tiles past M = 8
constexpr int kF32MmaTerms = 3;     // bf16 terms of a float32 x value
// A ring slot: the stage's 128 x 128 int8 weights, then its 128 rows of x
// as float32 [tile rows][128 + 8] (the pad keeps a warp's 8-byte fragment
// reads free of bank conflicts). A ring of 3 slots (two stages ahead of the
// work) lets three CTAs share an SM at both tile sizes: at M = 8 a layer's
// four sites ran in 0.150 ms against 0.162 with the gemv's 4 slots and two
// CTAs an SM (scripts/torch_f32mma_variants.py, PERF.md).
constexpr int kF32MmaXRow = kGemvRows + 8;
constexpr int kF32MmaStages = 3;
// The warps' sums after the loop, [warp][row][148 words]: column col of row
// m at m * 148 + col + col / 16, so that a warp's stores of its D fragments
// (lane (g, c): columns 16g + ..., rows 2c, 2c + 1 of a fragment) hit 32
// different banks.
constexpr int kF32MmaSumRow = kGemvStrip + kGemvStrip / 16 + 12;  // 148 words

// A CTA's shared memory at NF fragments of x (8 NF rows): the ring; after
// the loop the drained ring takes the warps' sums and then the slots that
// the cluster's ranks push to this one, [rank][row / split][column].
template <int NF>
struct F32MmaTile {
  static constexpr int kRows = kF32MmaRows * NF;
  static constexpr int kSlotBytes = kGemvStageBytes + 4 * kRows * kF32MmaXRow;
  static constexpr int kSmem = kF32MmaStages * kSlotBytes;
  static constexpr int kXCopies = kRows * kGemvRows / 4 / kGemvThreads;  // a thread's
  static constexpr int kSumBytes = 4 * kGemvWarps * kRows * kF32MmaSumRow;
  static_assert(kSlotBytes % 16 == 0 && (4 * kF32MmaXRow) % 16 == 0 && kSumBytes % 16 == 0,
                "16-byte copies");
  static_assert(kSumBytes + 4 * (kRows + kGemvMaxSplit - 1) * kGemvStrip <= kSmem,
                "the warps' sums and the pushed slots fit the drained ring");
};

// Three CTAs an SM at both tile sizes (62208 bytes at 8 rows, 75264 at 16).
static_assert(3 * (F32MmaTile<kF32MmaMaxFrags>::kSmem + 1024) <= kSmemPerSM,
              "three of the largest CTAs fit an SM's shared memory");
static_assert(kGemvThreads == kGemvStrip, "a thread a column of the strip");

__device__ __forceinline__ int f32mma_sum_at(int m, int col) {
  return m * kF32MmaSumRow + col + (col >> 4);
}

// This thread's copies of stage `stage` into ring slot `slot`: the gemv's
// weight copies, and 16-byte chunks of the stage's rows of the M tile's x
// (chunk e of thread t: row m = e / 32 of the tile, 4 floats at 4 (e %
// 32)); zero-filled past M and past K (K % 4 == 0: a chunk is all in or
// all out).
template <int NF>
__device__ __forceinline__ void f32mma_copy(unsigned char* slot,
                                            const int8_t* __restrict__ q,
                                            const float* __restrict__ x, int stage,
                                            int n_strip, int m0, int M, int K, int N) {
  gemv_copy(slot, q, stage, n_strip, K, N);
  float* xs = reinterpret_cast<float*>(slot + kGemvStageBytes);
#pragma unroll
  for (int e0 = 0; e0 < F32MmaTile<NF>::kXCopies; ++e0) {
    const int e = threadIdx.x + e0 * kGemvThreads;
    const int m = e >> 5, r = 4 * (e & 31);
    const int k = stage * kGemvRows + r;
    const bool ok = m0 + m < M && k < K;
    cp_async16(xs + m * kF32MmaXRow + r,
               ok ? x + static_cast<size_t>(m0 + m) * K + k : x, ok);
  }
}

// Two float32 x values (k and k + 1 of one row) as three bf16x2 words, the
// B-fragment register of each term: hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid), each subtraction exact in float32 (three terms hold
// every normal float32 exactly).
__device__ __forceinline__ void f32mma_split(float2 v, uint32_t (&b)[kF32MmaTerms]) {
#pragma unroll
  for (int u = 0; u < kF32MmaTerms; ++u) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);
    b[u] = *reinterpret_cast<const uint32_t*>(&p);
    v.x -= __low2float(p);
    v.y -= __high2float(p);
  }
}

// A warp's 32 rows of a stage into the lane's accumulators: per 16-row
// slice the B fragments of every term of every fragment f (lane group g is
// row 8f + g of the tile: k = 2c, 2c + 1 and 2c + 8, 2c + 9 of the slice),
// then per column pair j (d[f][j]: D row g is column 16g + 2j, row g + 8
// column 16g + 2j + 1; lane (g, c) holds rows 8f + 2c, 8f + 2c + 1) each A
// fragment widened once and one mma a fragment and term, hi first. A
// fragment's accumulators take the same products in the same order at
// either tile size.
template <int NF>
__device__ __forceinline__ void f32mma_rows(float (&d)[NF][8][4], const int4 (&w)[8],
                                            const float* xs, int g, int c) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    uint32_t b0[NF][kF32MmaTerms], b1[NF][kF32MmaTerms];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* xr = xs + (kF32MmaRows * f + g) * kF32MmaXRow + 16 * t + 2 * c;
      f32mma_split(*reinterpret_cast<const float2*>(xr), b0[f]);
      f32mma_split(*reinterpret_cast<const float2*>(xr + 8), b1[f]);
    }
    const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&w[4 * t]);
    const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&w[4 * t + 1]);
    const uint32_t* w2 = reinterpret_cast<const uint32_t*>(&w[4 * t + 2]);
    const uint32_t* w3 = reinterpret_cast<const uint32_t*>(&w[4 * t + 3]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t a[4];
      a[0] = gemv_widen_pair<0>(w0[q], w1[q]);
      a[1] = gemv_widen_pair<1>(w0[q], w1[q]);
      a[2] = gemv_widen_pair<0>(w2[q], w3[q]);
      a[3] = gemv_widen_pair<1>(w2[q], w3[q]);
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int u = 0; u < kF32MmaTerms; ++u) gemv_mma(d[f][2 * q], a, b0[f][u], b1[f][u]);
      a[0] = gemv_widen_pair<2>(w0[q], w1[q]);
      a[1] = gemv_widen_pair<3>(w0[q], w1[q]);
      a[2] = gemv_widen_pair<2>(w2[q], w3[q]);
      a[3] = gemv_widen_pair<3>(w2[q], w3[q]);
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int u = 0; u < kF32MmaTerms; ++u)
          gemv_mma(d[f][2 * q + 1], a, b0[f][u], b1[f][u]);
    }
  }
}

template <int NF>
__global__ void __launch_bounds__(kGemvThreads, 3)
    int8_f32mma_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ s, float* __restrict__ y, int M,
                       int K, int N, int chunk, int per) {
  using T = F32MmaTile<NF>;
  extern __shared__ __align__(16) unsigned char gsmem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // the cluster spans gridDim.x
  const int split = gridDim.x;
  const int m0 = blockIdx.y * T::kRows;
  const int strip0 = blockIdx.z * kGemvStrip;
  const int stages = (K + kGemvRows - 1) / kGemvRows;
  const int s0 = rank * chunk;
  const int count = max(min(s0 + chunk, stages) - s0, 0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < kF32MmaStages - 1; ++i) {
    if (i < count) {
      f32mma_copy<NF>(gsmem + i * T::kSlotBytes, q, x, s0 + i, strip0, m0, M, K, N);
    }
    cp_async_commit();
  }
  float d[NF][8][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[f][j][i] = 0.f;
  // Warp w works on rows 32 w .. 32 w + 31 of each stage; lane (g, c) reads
  // chunk g of its rows (at position g ^ 2c: gemv_chunk) and x's row g of
  // each fragment.
  const int lane_off = 32 * warp * kGemvStrip + 16 * (g ^ (2 * c));
  for (int i = 0; i < count; ++i) {
    // As int8_gemv_kernel's loop: stage i (its weights and its rows of x)
    // has landed, and stage i - 1's slot is free for the next copies,
    // kF32MmaStages - 1 stages ahead.
    cp_async_wait<kF32MmaStages - 2>();
    __syncthreads();
    if (i + kF32MmaStages - 1 < count) {
      f32mma_copy<NF>(gsmem + ((i + kF32MmaStages - 1) % kF32MmaStages) * T::kSlotBytes, q,
                      x, s0 + i + kF32MmaStages - 1, strip0, m0, M, K, N);
    }
    cp_async_commit();
    const unsigned char* slot = gsmem + (i % kF32MmaStages) * T::kSlotBytes;
    int4 w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      w[e] = *reinterpret_cast<const int4*>(slot + lane_off + gemv_row(e, c) * kGemvStrip);
    }
    f32mma_rows<NF>(d, w, reinterpret_cast<const float*>(slot + kGemvStageBytes) + 32 * warp,
                    g, c);
  }
  // The ring is drained: the warps' sums go into it.
  cp_async_wait<0>();
  __syncthreads();
  float* wsum = reinterpret_cast<float*>(gsmem);
  float* mine = wsum + warp * T::kRows * kF32MmaSumRow;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mine[f32mma_sum_at(kF32MmaRows * f + 2 * c + (i & 1), 16 * g + 2 * j + (i >> 1))] =
            d[f][j][i];
  // Rank r owns rows r, r + split, ... of the tile. Once every rank is past
  // its loop (its ring drained) each pushes its sum of every row, warps in
  // order, into the owner's slots through distributed shared memory (warp
  // w the rows of owners w and w + 4, lane l columns 4l .. 4l + 3: one
  // 16-byte store, 2% faster at M = 32 than a column a thread,
  // scripts/torch_f32mma_variants.py int8_dot push1); after the second
  // barrier each rank adds its rows' slots in rank order 0 .. split - 1
  // (thread = column), then each column's scale. One launch, no atomics,
  // deterministic, and a row's bits do not depend on M or on the other
  // rows.
  cluster.sync();
  const int col = threadIdx.x;
  const int rows = min(T::kRows, M - m0);
  // Row m = j * split + o goes to rank o's slot rank * per + j; the host
  // passes per = ceil(kRows / split), so the kernel divides nothing (no
  // I2F in it).
  float* slots = reinterpret_cast<float*>(gsmem + T::kSumBytes);
  const int c4 = 4 * (threadIdx.x & 31);
  for (int j = 0; j < per; ++j) {
    for (int o = warp; o < split && j * split + o < rows; o += kGemvWarps) {
      const int m = j * split + o;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kGemvWarps; ++w) {
        const float* src = wsum + w * T::kRows * kF32MmaSumRow + f32mma_sum_at(m, c4);
        v.x += src[0];
        v.y += src[1];
        v.z += src[2];
        v.w += src[3];
      }
      *reinterpret_cast<float4*>(cluster.map_shared_rank(slots, o) +
                                 (rank * per + j) * kGemvStrip + c4) = v;
    }
  }
  cluster.sync();
  if (strip0 + col < N) {
    for (int j = 0; j < per && rank + j * split < rows; ++j) {
      float v = 0.f;
      for (int r = 0; r < split; ++r) v += slots[(r * per + j) * kGemvStrip + col];
      y[static_cast<size_t>(m0 + rank + j * split) * N + strip0 + col] = v * s[strip0 + col];
    }
  }
}

// The M tiles of a strip are neighbours in the grid (y inside z), so they
// share its weight bytes in L2.
template <int NF>
cudaError_t launch_f32mma_tiles(const void* x, const void* q, const void* s, void* y, int M,
                                int K, int N, int split, cudaStream_t stream) {
  using T = F32MmaTile<NF>;
  const int stages = (K + kGemvRows - 1) / kGemvRows;
  const int chunk = (stages + split - 1) / split;
  const int strips = (N + kGemvStrip - 1) / kGemvStrip;
  const int tiles = (M + T::kRows - 1) / T::kRows;
  const int per = (T::kRows + split - 1) / split;  // rows a rank owns at most
  if (strips > 65535 || tiles > 65535) return cudaErrorInvalidValue;
  return launch_cluster(int8_f32mma_kernel<NF>, dim3(split, tiles, strips), T::kSmem, stream,
                        static_cast<const float*>(x), static_cast<const int8_t*>(q),
                        static_cast<const float*>(s), static_cast<float*>(y), M, K, N,
                        chunk, per);
}

// 8-row tiles up to M = 8 (the batched rounds), 16-row tiles past it.
cudaError_t launch_f32mma(const void* x, const void* q, const void* s, void* y, int M,
                          int K, int N, int split, cudaStream_t stream) {
  return M <= kF32MmaRows
             ? launch_f32mma_tiles<1>(x, q, s, y, M, K, N, split, stream)
             : launch_f32mma_tiles<kF32MmaMaxFrags>(x, q, s, y, M, K, N, split, stream);
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

extern "C" int int8_dot_gemv_launch(const void* x, const void* q, const void* s,
                                    void* y, int M, int K, int N, int x_dtype,
                                    int device, void* stream, int strip_cols,
                                    int split) {
  if (M <= 0 || M > 2 || K <= 0 || N <= 0 || N % 16 != 0 ||
      strip_cols != kGemvStrip || split < 1 || split > kGemvMaxSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(q) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    err = M == 1 ? launch_gemv<float, 1>(x, q, s, y, K, N, split, st)
                 : launch_gemv<float, 2>(x, q, s, y, K, N, split, st);
  } else if (x_dtype == 1) {
    err = M == 1 ? launch_gemv<__nv_bfloat16, 1>(x, q, s, y, K, N, split, st)
                 : launch_gemv<__nv_bfloat16, 2>(x, q, s, y, K, N, split, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int int8_dot_f32mma_launch(const void* x, const void* q, const void* s,
                                      void* y, int M, int K, int N, int x_dtype,
                                      int device, void* stream, int strip_cols,
                                      int split) {
  if (M <= 0 || K <= 0 || K % 4 != 0 || N <= 0 || N % 16 != 0 ||
      x_dtype != 0 || strip_cols != kGemvStrip || split < 1 || split > kGemvMaxSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_f32mma(x, q, s, y, M, K, N, split, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* int8_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
