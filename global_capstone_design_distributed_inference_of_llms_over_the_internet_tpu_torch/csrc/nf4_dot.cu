// NF4 weight matmul with the dequantization fused in:
//   y[M, N] = x[M, K] @ deq(W)[K, N], rounded to x's dtype, where
//   deq(code, scale) = round_to(x dtype, NF4_LEVELS[code] * scale)   (float32
//   product, then rounded: ops/nf4_kernel.py:122-124 of the JAX package).
//
// Replaces the TPU kernel ops/nf4_kernel.py:_make_kernel (the Pallas kernel
// behind nf4_dot, the pallas_call at :132) of the JAX package. It runs at
// every projection of --quant nf4 serving with NF4_KERNEL=1: wqkv, wo, wgu
// and wd of every layer. Four kernels compute that one function; the
// wrapper (ops/nf4_kernel.py, `_route`) picks one from M, K, N and x's dtype
// alone:
//   * nf4_gemv_kernel ("gemv"): decode, M <= 2 (bf16 x below MMA_MIN_M,
//     float32 x at M <= 2), N % 16 == 0, K <= 32768;
//   * nf4_f32mma_kernel ("f32mma", after nf4_f32mma_split_kernel): float32 x
//     at M >= 3 (the prefill of the stages behind TCP, which compute in the
//     float32 the wire decodes to), N % 16 == 0, K % 8 == 0, any K;
//   * nf4_dot_mma_kernel, on the tensor cores ("mma"): bf16 x at prefill M
//     with N % 16 == 0 and K % 8 == 0 (every llama-3.1-8b site);
//   * nf4_dot_kernel, on the CUDA cores ("simt"): the shapes the others do
//     not take (N % 16 != 0, K % 8 != 0 at prefill M, say).
//
// Layout of W (models/quant.py NF4Tensor): packed uint8 [P, N], P = in_pad/2,
// the high nibble of packed[r][n] is weight row 2r, the low nibble row 2r+1;
// scales bf16 [P/32, N], one absmax per 64 weight rows (32 packed rows).
//
// ---- nf4_gemv_kernel (decode: M <= 2, bf16 or float32 x) ----
// What bounds it on an H100: at M <= 2 every weight is used once or twice,
// so the work is bound by the bytes it reads: 0.5 B per weight plus 2 B of
// scale per 64 weights (62.4 MB for the 8B model's fused gate/up weight,
// 115.9 MB for one layer's four sites: 0.0346 ms at 3.35 TB/s). The per-
// weight work comes close to that: at ~3.35 TB/s the CUDA cores have about
// five instructions a weight, and a lookup, a multiply and a rounding come
// before the product. What the design does about it:
//   * Split-K across a thread-block cluster fills the card at every site. A
//     CTA owns a strip of 128 columns and a K chunk of it: a whole number of
//     32-row scale blocks, ceil(blocks / S) of them for rank r of a cluster
//     of S <= 8 (the portable size) along K. The wrapper's host function
//     `_gemv_plan` picks S per shape and passes it in; the launch takes it as
//     its cluster dimension (cudaLaunchKernelEx), which graphs capture. The
//     plan asks for the least split that gives ~1.5 CTAs an SM (192) with as
//     many blocks for every warp: at llama-3.1-8b's sites wqkv 48 strips x
//     4, wo 32 x 8, wgu 224 x 1, wd 32 x 7 CTAs of 4 warps (PERF.md: the
//     fastest of the plan scan; more, shorter CTAs pay the x stage, the
//     cluster barrier and their own start more often).
//   * Each CTA sums its 4 warps' partials in shared memory in warp order and
//     stores the sum into rank 0's shared memory through distributed shared
//     memory (cooperative_groups map_shared_rank), one slot a rank; after a
//     cluster barrier rank 0 adds the slots in rank order 0..S-1 and writes
//     y. The result is deterministic: one launch, no workspace, no atomics.
//     (The ranks push their sums, so rank 0 only reads its own shared memory
//     and no rank's shared memory is read after it exits. A relaxed cluster
//     arrive at the start, waited for before the push, makes sure rank 0
//     has started before anyone writes to it.)
//   * Whole lines: lane l of a warp reads 16 bytes (16 columns) of packed row
//     R + l % 4 at column 16 (l / 4), so one load instruction reads 4 rows x
//     128 contiguous bytes. A warp walks the 32 rows of one scale block as 4
//     slices of 8 rows, two 16-byte loads a lane a slice, and issues the next
//     block's 8 loads and scales before it works on this one (the first
//     block's before x is staged): 8-16 loads in flight a lane, 4-8 KB a
//     warp, 32-64 KB an SM at two CTAs an SM.
//   * One scale load per scale block: a lane's 16 columns' bf16 scales, two
//     16-byte loads (a broadcast among the 4 lanes of a column group),
//     widened once for the block's 8 packed rows.
//   * Per byte one 8-byte lookup of its two levels in a 256-entry pair
//     table in shared memory (32 KB: 16 copies of each entry side by side,
//     lane l reading copy l % 16, so a half-warp's 16 lanes always hit 16
//     different bank pairs, whatever the bytes) and the float32 products by
//     the scale. For bf16 x the two weights of a byte are rounded by one
//     __floats2bfloat162_rn, bit-equal to dequant_f32().to(bfloat16), and
//     that pair is exactly one register of an mma.sync m16n8k16 A fragment:
//     column 16g + 2j (fragment row g) or 16g + 2j + 1 (row g + 8), weight
//     rows 2r, 2r + 1 (k 2c, 2c + 1). So the FMAs run on the tensor cores, in
//     float32, with x in the B fragment (fragment column m = lane group g,
//     zero past M): no widening of the weights and no FMA on the CUDA cores.
//     For float32 x there is no rounding and the two FMAs a weight pair and
//     row of x run on the CUDA cores in float32; the 4 lanes that share a
//     column group add their sums with two shuffles, in a fixed order.
//   * The CTA's K chunk of x (M <= 2 rows) is staged in shared memory once,
//     with 16-byte loads, as the pairs the inner loop reads: bf16 pairs for
//     the mma, float32 pairs for the FMAs, zero past K.
//   * Only the order of the float32 sums differs from the plain version.
// Measured (PERF.md): a llama-3.1-8b layer's four sites at M = 1 in ~0.099
// ms with the L2 cold, 2.9x the byte bound and half the CUDA-core kernel's
// time; how the rest splits between the weight stream and each launch's
// start and end is not measured.
//
// ---- nf4_f32mma_kernel (float32 x at prefill M) ----
// The stages behind TCP compute in the float32 the wire decodes to, as the
// reference does, so their prefill projections get float32 x at the
// prompt's bucket (M = 32 for chip_smoke.py's prompts; chunks up to 2048).
// The function is the reference's: w = NF4_LEVELS[code] * scale in float32,
// float32 sums, y float32. What bounds it on an H100: at M = 32 a packed
// byte (two weights) carries 128 FLOP, under the bf16 ridge, so on the
// tensor cores the weight bytes would (0.035 ms a llama-3.1-8b layer); but
// float32 products are not bf16 ones. The CUDA-core kernel did every
// product as an FFMA (13.96 GFLOP a layer at M = 32) and re-read and
// dequantized every weight for each 8-row M tile. What the design does:
//   * The products on the tensor cores in bf16 terms. x = x0 + x1 + x2,
//     each term bf16 of what the earlier ones leave (exact for every normal
//     float32). Each NF4 level = L0 + L1, L0 = bf16(level), L1 = bf16(level
//     - L0): 2^-17 of the level at most. The scale is bf16 and the same for
//     a scale block's 64 k, so a block's sums are taken over the levels and
//     multiplied by each column's scale once per block (an FFMA into the
//     running sums): level * scale * x summed per block, not the rounded
//     float32 weight, a difference of 2^-24 of a product. Per block the
//     products x_t * L_u with t + u <= 2 ((0,0), (1,0), (0,1), (2,0),
//     (1,1)) go through mma.sync m16n8k16 into float32 sums; each product
//     of two bf16 terms is exact in float32, so only the dropped terms
//     (about 2^-17 of a product) and the order of the sums differ from the
//     plain version: 2.2-3.4e-6 of max|plain| at the llama-3.1-8b sites
//     (chip_smoke.py, PERF.md).
//   * nf4_f32mma_split_kernel splits x into its three terms once a call,
//     into scratch the wrapper allocates, pairs c and c + 4 of each 8 pairs
//     side by side (one B-fragment register pair of the mma). Split in each
//     CTA instead, every x value is split once for every column strip (224
//     times at wgu), behind a second barrier in every block.
//   * The decode kernel's strips and split-K: a CTA owns 128 columns, a
//     warp 32 of them (two m16 tiles), and the ranks of a thread-block
//     cluster (split <= 8, the wrapper's `_f32mma_plan`, a function of K
//     alone so that fused and unfused projections give the same bits) a
//     whole number of scale blocks each. M tiles of 16 rows (two n8
//     fragments of x; 8 rows when M <= 8) along the grid's second
//     dimension, next to each other, so the M tiles of a strip share its
//     weight bytes in L2.
//   * A ring of 3 slots in shared memory, one scale block each (the
//     strip's 32 packed rows, its 128 scales, the block's terms of x),
//     filled by cp.async two blocks ahead; rows swizzled (16-byte chunk q
//     of row r at q ^ 2 (r & 3)), so a warp's 4-byte weight reads and
//     8-byte x-term reads are free of bank conflicts without padding.
//   * Per byte one 8-byte lookup in a 256-entry pair table in shared
//     memory (8 copies of each entry, lane % 8 reading its own) gives both
//     level terms' A-fragment registers of its two weights (rows 2r, 2r +
//     1: exactly one register of the m16n8k16 A fragment): no float math a
//     weight. Lane (g, c) reads columns 4g .. 4g + 3 of the warp's 32:
//     fragment row g of tile t is column 4g + 2t, row g + 8 column 4g + 2t
//     + 1.
//   * After the loop each CTA's sums go into its drained ring; once every
//     rank is past its loop each pushes its sums of row m into rank m %
//     split's slots through distributed shared memory, and after a cluster
//     barrier each rank adds its rows in rank order and writes y: one
//     launch (after the split), no atomics, deterministic, and a row's
//     bits do not depend on M or on the other rows. (Pulling the sums from
//     the other ranks instead waits out a distributed shared memory load
//     for each rank and row.)
//   * 47 KB of shared memory a CTA at 16 rows and 122 registers, so four
//     CTAs share an SM: 16-row M tiles ran 21% faster at M = 32 than
//     32-row ones at three CTAs an SM, which read and look up each weight
//     half as often; 16 table copies (conflict-free lookups, 32 KB) and a
//     ring of 4 ran 7-11% slower (scripts/torch_f32mma_variants.py).
// Measured (PERF.md): a llama-3.1-8b layer's four sites at M = 32 in
// ~0.39 ms with the L2 cold, against 1.26 for the CUDA-core kernel and
// 0.45 for torch.matmul on the dequantized float32 weight in the same run
// (9.3x the 0.042 ms bound); at M = 8 ~0.18 ms against 0.38. The loop runs
// near mma.sync's issue rate on this card (~10 cycles an m16n8k16 per SM
// sub-partition at four CTAs an SM, scripts/torch_f32mma_profile.py);
// a CTA's set-up, the cluster's barriers and the push take about a third
// of its time. Three products instead of five took 13% off at 5.0e-6 of
// max|plain| (scripts/torch_f32mma_variants.py).
//
// ---- nf4_dot_kernel (CUDA cores) ----
// The first port of the kernel, the decode kernel until the gemv route and
// float32 prefill until the f32mma route: now the shapes the other routes
// do not take. What
// bounds it: at small M the bytes it reads, as above; per weight it does a
// table lookup, a multiply and a rounding before the FMA.
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
// At prefill M it is slow: CUDA-core FMAs, and every 8-row M tile reads and
// dequantizes every weight again. At M = 1 (PERF.md) it ran at 5.5x the
// byte bound: 128 blocks at N = 4096, a scale load per packed row, 32-byte
// pieces of 16 rows per warp load.
//
// ---- nf4_dot_mma_kernel (tensor cores, bf16 x) ----
// Replaces nf4_dot_kernel at prefill M (the prompt, every prefill chunk,
// every failover replay). What bounds it: at M <= ~64 each packed byte
// carries 4M FLOP, below the H100's bf16 ridge of ~295 FLOP/byte, so the
// work is bound by the weight bytes (0.036 ms a llama-3.1-8b layer at
// M = 30); above that, by the tensor cores. What the design does about it:
//   * A block owns a BM x 32 output tile (BM = 32 for M <= 32, else 64)
//     and walks K in steps of 256 weight rows (128 packed rows, 4 whole
//     scale blocks, so no packed step is ragged inside P; only x is masked
//     past K). The grid is ceil(M/BM) x ceil(N/32) with the M tiles fastest,
//     so the M tiles of one column stripe run together and share its bytes
//     in L2. The N = 4096 sites launch 128 blocks per M tile on 132 SMs.
//   * Two rings in shared memory, filled with 16-byte cp.async.cg copies
//     (zero-filled past P, N, M and K): warps 0-3 copy the packed bytes and
//     scales 3 steps ahead, warps 4-7 the x tile 1 step ahead (cp.async
//     groups are per thread, so each ring waits only for its own copies).
//     Kept small, so that several blocks share an SM and one block's copies
//     and barriers overlap another's work: 74.5 KB and 76 registers at
//     BM = 32 (three blocks an SM), 107.5 KB at BM = 64 (two).
//   * Each weight is dequantized once per block: per step the 8 warps expand
//     the packed bytes into a bf16 [32 columns][256 rows] tile (column-major,
//     so the two nibbles of a byte are one 4-byte store); per byte two
//     lookups in the 16-level table, two multiplies by the column's scale
//     and one __floats2bfloat162_rn, the same float32 product and rounding as
//     above, so the tile is bit-equal to dequant_f32().to(bfloat16).
//   * WMMA bf16 16x16x16 products with float accumulators: each warp takes 2
//     of the step's 16 k-slices for all BM/16 x 2 output tiles, so every
//     element of the x and weight tiles is read from shared memory once; the
//     8 warps' partial sums are added in a fixed order through shared memory
//     (aliased onto the drained rings), so results are deterministic. Tile
//     rows are padded by 16 bytes so the fragment loads do not conflict on
//     banks.
//   * bf16 x * bf16 w is exact in float32: only the order of the sums differs
//     from the plain version. Rows past M and columns past N are not stored.
// Measured (PERF.md): at M = 30 it runs at ~6-10x the byte bound, and the
// copies take most of that: a block reads a 32-byte strip of each packed
// row (rows N bytes apart) and re-reads x from L2 for every 32 columns.
// Wider strips need split-K or clusters to keep the N = 4096 sites' block
// count, a later PR's work, as are wgmma/TMA where M reaches the hundreds.
//
// C interface (loaded with ctypes):
//   int nf4_dot_launch(x, packed, scales, y, M, K, P, N, x_dtype, device,
//                      stream)
//     K = in_dim (x's row length), P = packed rows (2P - K in [0, 64));
//     x_dtype: 0 = float32, 1 = bfloat16 (y has the same dtype as x);
//     device: the CUDA device index of the tensors and of `stream`.
//     Returns the cudaError_t of the launch (0 = success).
//   int nf4_dot_mma_launch(...the same arguments...)
//     The tensor-core route: x_dtype 1 only, N % 16 == 0, K % 8 == 0, and
//     x, packed, scales, y 16-byte aligned (else an error code, no launch).
//   int nf4_dot_gemv_launch(...the same arguments..., strip_cols, split)
//     The decode route: M <= 2, N % 16 == 0, packed and scales 16-byte
//     aligned; strip_cols = 128 and the cluster size split (1..8) from the
//     wrapper's `_gemv_plan`, with at most 64 scale blocks a rank.
//   int nf4_dot_f32mma_launch(...the gemv's arguments..., terms)
//     The float32 prefill route: x_dtype 0, N % 16 == 0, K % 8 == 0, x,
//     packed, scales and terms 16-byte aligned; the plan (strip_cols = 128,
//     split 1..8) from the wrapper's `_f32mma_plan`; terms is scratch of
//     3 * M * P 32-bit words that the wrapper allocates. Two launches on
//     `stream`: the split of x into terms, then the matmul.
//   const char* nf4_dot_error_string(int code)

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
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

// ---- The tensor-core route ----

namespace wmma = nvcuda::wmma;

constexpr int kMmaThreads = 256;  // 8 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kLoadThreads = kMmaThreads / 2;  // per ring: weights, x
// Shared memory of an SM (228 KB), and what each block takes besides its
// dynamic shared memory (1 KB reserved, the static level table).
constexpr int kSmemPerSM = 233472;
constexpr int kSmemPerBlock = 1024 + 128;

// One block's tile: BM x BN outputs; K in steps of BK weight rows. Warps
// 0-3 copy the packed bytes and scales through a ring of kStages steps,
// warps 4-7 copy x through a ring of kXStages steps (cp.async groups are
// per thread, so the two rings run ahead by different distances).
template <int BM_>
struct MmaTile {
  static constexpr int BM = BM_, BN = 32, BK = 256;
  static constexpr int kStages = 4, kXStages = 2;
  static constexpr int kBKP = BK / 2;                      // packed rows
  static constexpr int kScaleRows = kBKP / kRowsPerScale;  // scale rows
  static constexpr int kGroups = BN / 16;                  // 16-column groups
  static constexpr int kUnits = kScaleRows * kGroups;      // 32 x 16 dequant units
  static constexpr int kK16PerWarp = BK / 16 / kMmaWarps;  // k-slices a warp
  static constexpr int kTilePitch = BK + 8;                // bf16: x, w tiles
  static constexpr int kPackedPitch = BN + 16;             // bytes
  static constexpr int kRedPitch = BN + 4;                 // floats
  static constexpr int kXBytes = BM * kTilePitch * 2;      // one x stage
  static constexpr int kPackedBytes = kBKP * kPackedPitch;
  static constexpr int kScaleBytes = kScaleRows * BN * 2;
  static constexpr int kStageBytes = kPackedBytes + kScaleBytes;  // one weight stage
  static constexpr int kXRingBytes = kXStages * kXBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kWBytes = BN * kTilePitch * 2;
  static constexpr int kSmemBytes = kXRingBytes + kRingBytes + kWBytes;
  // Blocks an SM by shared memory, at most 3 (3 x 256 threads fit in the
  // registers at <= 85 a thread).
  static constexpr int kBlocksPerSM = kSmemPerSM / (kSmemBytes + kSmemPerBlock);
  static constexpr int kMinBlocks = kBlocksPerSM < 3 ? kBlocksPerSM : 3;
  static_assert(BM % 16 == 0 && BN % 16 == 0 && BK % 64 == 0, "whole tiles");
  static_assert(BK % (16 * kMmaWarps) == 0, "every warp takes k-slices");
  static_assert(kUnits % kMmaWarps == 0, "every warp takes dequant units");
  static_assert(kScaleRows * (BN / 8) <= kLoadThreads, "one scale chunk a thread");
  static_assert(kStages >= 2 && kXStages >= 2, "rings");
  static_assert(kBlocksPerSM >= 1, "fits an SM");
  static_assert(kXBytes % 128 == 0 && kPackedBytes % 128 == 0 &&
                    kStageBytes % 128 == 0 && kWBytes % 128 == 0,
                "aligned buffers");
  static_assert(kMmaWarps * BM * kRedPitch * 4 <= kSmemBytes,
                "the epilogue's partial sums fit in shared memory");
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

// Step `step`'s packed rows and scales into one weight stage; `t` is the
// thread's index among the weight loaders.
template <class T>
__device__ __forceinline__ void mma_load_weights(
    unsigned char* stage, const uint8_t* __restrict__ pk,
    const __nv_bfloat16* __restrict__ sc, int step, int n0, int P, int N,
    int t) {
  uint8_t* ps = stage;
  __nv_bfloat16* ss = reinterpret_cast<__nv_bfloat16*>(stage + T::kPackedBytes);
  // packed: kBKP rows x kGroups chunks of 16 columns
  for (int i = t; i < T::kBKP * T::kGroups; i += kLoadThreads) {
    const int row = i / T::kGroups, chunk = i % T::kGroups;
    const int r = step * T::kBKP + row, n = n0 + chunk * 16;
    const bool ok = r < P && n + 16 <= N;
    cp_async16(ps + row * T::kPackedPitch + chunk * 16,
               ok ? pk + static_cast<size_t>(r) * N + n : pk, ok);
  }
  if (t < T::kScaleRows * (T::BN / 8)) {  // scales: chunks of 8 columns
    const int row = t / (T::BN / 8), chunk = t % (T::BN / 8);
    const int r = step * T::kScaleRows + row, n = n0 + chunk * 8;
    const bool ok = r < P / kRowsPerScale && n + 8 <= N;
    cp_async16(ss + row * T::BN + chunk * 8,
               ok ? sc + static_cast<size_t>(r) * N + n : sc, ok);
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
    cp_async16(xs + row * T::kTilePitch + chunk * 8,
               ok ? x + static_cast<size_t>(m) * K + k : x, ok);
  }
}

// The stage's packed bytes into the bf16 weight tile ws[column][k]. A unit
// is 32 packed rows (one scale row) x 16 columns; lane l takes packed row
// l of the unit, and per byte makes one 4-byte store of weight rows 2r and
// 2r+1 of a column: two lookups in the 16-level table (16 banks, so lanes
// never conflict), two multiplies by the column's scale, one rounding.
template <class T>
__device__ __forceinline__ void mma_dequant(const uint8_t* ps,
                                            const __nv_bfloat16* ss,
                                            __nv_bfloat16* ws,
                                            const float* lut) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < T::kUnits / kMmaWarps; ++i) {
    const int unit = warp + i * kMmaWarps;
    const int c0 = (unit % T::kGroups) * 16;
    const int rs = unit / T::kGroups;  // the unit's scale row in the step
    const int row = rs * 32 + lane;
    const int4 w = *reinterpret_cast<const int4*>(ps + row * T::kPackedPitch + c0);
    const uint32_t* wq = reinterpret_cast<const uint32_t*>(&w);
    const __nv_bfloat16* srow = ss + rs * T::BN + c0;
    uint32_t* out = reinterpret_cast<uint32_t*>(ws) + row;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t b = (wq[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      const float s = __bfloat162float(srow[j]);
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(lut[b >> 4] * s, lut[b & 0xFu] * s);
      out[(c0 + j) * (T::kTilePitch / 2)] =
          *reinterpret_cast<const uint32_t*>(&v);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kMmaThreads, T::kMinBlocks)
    nf4_dot_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ pk,
                       const __nv_bfloat16* __restrict__ sc,
                       __nv_bfloat16* __restrict__ y, int M, int K, int P,
                       int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float lut[16];
  if (threadIdx.x < 16) lut[threadIdx.x] = kLevels[threadIdx.x];
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int steps = (P + T::kBKP - 1) / T::kBKP;
  __nv_bfloat16* xring = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* wring = smem + T::kXRingBytes;
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(wring + T::kRingBytes);
  const bool weight_loader = threadIdx.x < kLoadThreads;  // warps 0-3
  const int lt = threadIdx.x % kLoadThreads;

  // Each loader fills its ring but one stage; empty groups keep its wait
  // count uniform.
  if (weight_loader) {
    for (int s = 0; s < T::kStages - 1; ++s) {
      if (s < steps) {
        mma_load_weights<T>(wring + s * T::kStageBytes, pk, sc, s, n0, P, N, lt);
      }
      cp_async_commit();
    }
  } else {
    for (int s = 0; s < T::kXStages - 1; ++s) {
      if (s < steps) {
        mma_load_x<T>(xring + s * (T::kXBytes / 2), x, s, m0, M, K, lt);
      }
      cp_async_commit();
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::BM / 16]
                                                          [T::BN / 16];
#pragma unroll
  for (int i = 0; i < T::BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < T::BN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

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
        mma_load_weights<T>(wring + (next % T::kStages) * T::kStageBytes, pk,
                            sc, next, n0, P, N, lt);
      }
    } else {
      const int next = step + T::kXStages - 1;
      if (next < steps) {
        mma_load_x<T>(xring + (next % T::kXStages) * (T::kXBytes / 2), x,
                      next, m0, M, K, lt);
      }
    }
    cp_async_commit();
    const unsigned char* stage = wring + (step % T::kStages) * T::kStageBytes;
    mma_dequant<T>(stage,
                   reinterpret_cast<const __nv_bfloat16*>(stage +
                                                          T::kPackedBytes),
                   ws, lut);
    __syncthreads();
    const __nv_bfloat16* xs = xring + (step % T::kXStages) * (T::kXBytes / 2);
#pragma unroll
    for (int s = 0; s < T::kK16PerWarp; ++s) {
      const int kk = (warp * T::kK16PerWarp + s) * 16;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          b[T::BN / 16];
#pragma unroll
      for (int j = 0; j < T::BN / 16; ++j) {
        wmma::load_matrix_sync(b[j], ws + j * 16 * T::kTilePitch + kk,
                               T::kTilePitch);
      }
#pragma unroll
      for (int i = 0; i < T::BM / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, xs + i * 16 * T::kTilePitch + kk,
                               T::kTilePitch);
#pragma unroll
        for (int j = 0; j < T::BN / 16; ++j) {
          wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
        }
      }
    }
  }

  // The 8 warps' partial sums, through shared memory (over the drained
  // rings and the weight tile), added in warp order.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < T::BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < T::BN / 16; ++j) {
      wmma::store_matrix_sync(
          red + (warp * T::BM + i * 16) * T::kRedPitch + j * 16, acc[i][j],
          T::kRedPitch, wmma::mem_row_major);
    }
  __syncthreads();
  for (int e = threadIdx.x; e < T::BM * T::BN; e += kMmaThreads) {
    const int r = e / T::BN, c = e % T::BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w) {
        sum += red[(w * T::BM + r) * T::kRedPitch + c];
      }
      y[static_cast<size_t>(m) * N + n] = __float2bfloat16_rn(sum);
    }
  }
}

template <class T>
cudaError_t launch_mma(const void* x, const void* pk, const void* sc, void* y,
                       int M, int K, int P, int N, cudaStream_t stream) {
  if ((N + T::BN - 1) / T::BN > 65535) return cudaErrorInvalidValue;
  // Above 48 KB of dynamic shared memory must be asked for first.
  cudaError_t err = cudaFuncSetAttribute(
      nf4_dot_mma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((M + T::BM - 1) / T::BM, (N + T::BN - 1) / T::BN);
  nf4_dot_mma_kernel<T><<<grid, kMmaThreads, T::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(pk),
      static_cast<const __nv_bfloat16*>(sc), static_cast<__nv_bfloat16*>(y),
      M, K, P, N);
  return cudaGetLastError();
}

// By M: the prompt's M tile in one block row, 74.5 KB and 76 registers,
// three blocks an SM; above 32 rows, 64-row tiles at 107.5 KB, two blocks
// an SM. On the H100 the occupancy decides: deeper rings, 128-row tiles and
// 64-row tiles at one block an SM were all slower (PERF.md).
using SmallM = MmaTile<32>;  // M <= 32
using LargeM = MmaTile<64>;  // M > 32

// ---- The decode route: split-K over a cluster ----

namespace cg = cooperative_groups;

constexpr int kGemvWarps = 4;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvStrip = 128;   // columns a CTA: 8 lane groups x 16
constexpr int kGemvMaxSplit = 8;  // the portable cluster size
constexpr int kGemvMaxChunk = 64; // scale blocks a rank (its x stage)
constexpr int kGemvSlice = 8;     // packed rows an mma k-slice (k = 16)

// x staged for the inner loop: one pair (weight rows 2r, 2r + 1) a packed
// row and x row, as bf16 bits (the mma's B fragment) or as float32.
template <typename T>
struct GemvX;
template <>
struct GemvX<__nv_bfloat16> {
  using Pair = uint32_t;
  static __device__ __forceinline__ Pair make(const __nv_bfloat16* xr, int k,
                                              int K) {
    const uint16_t* b = reinterpret_cast<const uint16_t*>(xr);
    const uint32_t lo = k < K ? b[k] : 0u;
    const uint32_t hi = k + 1 < K ? b[k + 1] : 0u;
    return lo | (hi << 16);
  }
};
template <>
struct GemvX<float> {
  using Pair = float2;
  static __device__ __forceinline__ Pair make(const float* xr, int k, int K) {
    return make_float2(k < K ? xr[k] : 0.f, k + 1 < K ? xr[k + 1] : 0.f);
  }
};

// One scale block of a lane: its two packed rows of each of the block's 4
// slices (w[2t]: row 8t + c, w[2t + 1]: row 8t + c + 4 of the block), 16
// columns each, and the 16 columns' bf16 scales.
struct GemvBlock {
  int4 w[8];
  int4 s[2];
};

__device__ __forceinline__ void gemv_load(GemvBlock& b,
                                          const uint8_t* __restrict__ pk,
                                          const __nv_bfloat16* __restrict__ sc,
                                          int blk, int c, int n0, int N,
                                          bool col_ok) {
  if (!col_ok) {
#pragma unroll
    for (int i = 0; i < 8; ++i) b.w[i] = make_int4(0, 0, 0, 0);
    b.s[0] = b.s[1] = make_int4(0, 0, 0, 0);
    return;
  }
  const uint8_t* base =
      pk + (static_cast<size_t>(blk) * kRowsPerScale + c) * N + n0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    b.w[2 * t] = __ldg(reinterpret_cast<const int4*>(
        base + static_cast<size_t>(kGemvSlice * t) * N));
    b.w[2 * t + 1] = __ldg(reinterpret_cast<const int4*>(
        base + static_cast<size_t>(kGemvSlice * t + 4) * N));
  }
  const int4* srow =
      reinterpret_cast<const int4*>(sc + static_cast<size_t>(blk) * N + n0);
  b.s[0] = __ldg(srow);
  b.s[1] = __ldg(srow + 1);
}

// The levels of the two codes of byte j of `v` (high nibble, low nibble)
// from the pair table: entry b of it is 16 copies of (level[b >> 4],
// level[b & 15]) side by side, 128 bytes, and `tab` is the shared address
// of the copy this lane reads (lane % 16), so the 16 lanes of a half-warp
// always read 16 different bank pairs.
__device__ __forceinline__ float2 gemv_levels(uint32_t v, uint32_t tab, int j) {
  const uint32_t addr = tab + (__byte_perm(v, 0u, 0x4440u | j) << 7);
  float2 levels;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(levels.x), "=f"(levels.y)
               : "r"(addr));
  return levels;
}

__device__ __forceinline__ uint32_t gemv_pair(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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
  // One scale block: per slice the x pairs of rows 8t + c and 8t + c + 4
  // (lane group g is fragment column m = g), then per byte pair j of the
  // two packed rows one mma over 16 columns x 16 weight rows.
  __device__ __forceinline__ void block(const GemvBlock& b, uint32_t tab,
                                        const uint32_t* xs, int xstride,
                                        int row0, int g, int c) {
    float s[16];
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(b.s);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[2 * i] = __uint_as_float(sw[i] << 16);
      s[2 * i + 1] = __uint_as_float(sw[i] & 0xFFFF0000u);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = row0 + kGemvSlice * t + c;
      const uint32_t b0 = g < M ? xs[g * xstride + r] : 0u;
      const uint32_t b1 = g < M ? xs[g * xstride + r + 4] : 0u;
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(&b.w[2 * t]);
      const uint32_t* wq = reinterpret_cast<const uint32_t*>(&b.w[2 * t + 1]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // word q: bytes 4q..4q+3 = pairs 2q, 2q+1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * q + h;  // the pair: columns 16g + 2j, 16g + 2j + 1
          const float s0 = s[2 * j], s1 = s[2 * j + 1];
          const float2 p0 = gemv_levels(wp[q], tab, 2 * h);
          const float2 p1 = gemv_levels(wp[q], tab, 2 * h + 1);
          const float2 q0 = gemv_levels(wq[q], tab, 2 * h);
          const float2 q1 = gemv_levels(wq[q], tab, 2 * h + 1);
          uint32_t a[4];
          a[0] = gemv_pair(p0.x * s0, p0.y * s0);
          a[1] = gemv_pair(p1.x * s1, p1.y * s1);
          a[2] = gemv_pair(q0.x * s0, q0.y * s0);
          a[3] = gemv_pair(q1.x * s1, q1.y * s1);
          mma_16816(d[j], a, b0, b1);
        }
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
  __device__ __forceinline__ void row(int4 w, const float (&s)[16],
                                      uint32_t tab, const float2 (&xp)[M]) {
    const uint32_t* wv = reinterpret_cast<const uint32_t*>(&w);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int j = 4 * q + h;
        const float2 lv = gemv_levels(wv[q], tab, h);
        const float whi = lv.x * s[j];
        const float wlo = lv.y * s[j];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          acc[m][j] = fmaf(xp[m].x, whi, acc[m][j]);
          acc[m][j] = fmaf(xp[m].y, wlo, acc[m][j]);
        }
      }
    }
  }
  __device__ __forceinline__ void block(const GemvBlock& b, uint32_t tab,
                                        const float2* xs, int xstride,
                                        int row0, int, int c) {
    float s[16];
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(b.s);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[2 * i] = __uint_as_float(sw[i] << 16);
      s[2 * i + 1] = __uint_as_float(sw[i] & 0xFFFF0000u);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = row0 + kGemvSlice * t + c;
      float2 xp[M], xq[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        xp[m] = xs[m * xstride + r];
        xq[m] = xs[m * xstride + r + 4];
      }
      row(b.w[2 * t], s, tab, xp);
      row(b.w[2 * t + 1], s, tab, xq);
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

// Shared memory of a CTA: the pair table (256 entries x 16 copies of two
// levels), the x stage [M][chunk rows], the warps' sums [warps][M][strip]
// and rank 0's slots [split][M][strip].
constexpr int kGemvTableBytes = 256 * 16 * 8;
template <typename T, int M>
constexpr size_t gemv_smem(int chunk_rows, int split) {
  return kGemvTableBytes + sizeof(typename GemvX<T>::Pair) * M * chunk_rows +
         sizeof(float) * (kGemvWarps + split) * M * kGemvStrip;
}

// The CTA's packed rows [row0, row0 + nrows) of x (M rows) into the stage
// as pairs: 16-byte loads (8 bf16 or 4 float32: 4 or 2 pairs) where `vec`
// (K a multiple of them, x 16-byte aligned; a load is then all inside K or
// all past it), else a pair at a time; zero past K.
template <typename T, int M>
__device__ __forceinline__ void gemv_stage_x(typename GemvX<T>::Pair* xs,
                                             const T* __restrict__ x,
                                             int xstride, int row0, int nrows,
                                             int K, bool vec) {
  constexpr int kPairs = 8 / sizeof(T);
  if (vec) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      for (int i = threadIdx.x; i < nrows / kPairs; i += kGemvThreads) {
        const int k = 2 * (row0 + i * kPairs);
        const int4 v = k < K ? __ldg(reinterpret_cast<const int4*>(
                                   x + static_cast<size_t>(m) * K + k))
                             : make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(xs + m * xstride + i * kPairs) = v;
      }
    }
    return;
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    for (int r = threadIdx.x; r < nrows; r += kGemvThreads) {
      xs[m * xstride + r] = GemvX<T>::make(x + static_cast<size_t>(m) * K,
                                           2 * (row0 + r), K);
    }
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kGemvThreads)
    nf4_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ pk,
                    const __nv_bfloat16* __restrict__ sc, T* __restrict__ y,
                    int K, int P, int N, int chunk, bool vec_x) {
  using Pair = typename GemvX<T>::Pair;
  extern __shared__ __align__(16) unsigned char gsmem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // the cluster spans gridDim.x
  const int split = gridDim.x;
  const int strip0 = blockIdx.y * kGemvStrip;
  const int blocks = P / kRowsPerScale;
  const int b0 = rank * chunk;
  const int b1 = min(b0 + chunk, blocks);
  const int xstride = chunk * kRowsPerScale;
  const int nrows = max(b1 - b0, 0) * kRowsPerScale;
  float2* table = reinterpret_cast<float2*>(gsmem);
  Pair* xs = reinterpret_cast<Pair*>(gsmem + kGemvTableBytes);
  float* wsum = reinterpret_cast<float*>(gsmem + kGemvTableBytes +
                                         sizeof(Pair) * M * xstride);
  float* slots = wsum + kGemvWarps * M * kGemvStrip;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int n0 = strip0 + 16 * g;
  const bool col_ok = n0 < N;  // N % 16 == 0: all 16 columns or none
  // The warp's scale blocks: b0 + warp, b0 + warp + 4, ...; the first one's
  // loads are issued before x is staged, and each next one's before this
  // one's work.
  int blk = b0 + warp;
  GemvBlock cur, nxt;
  if (blk < b1) gemv_load(cur, pk, sc, blk, c, n0, N, col_ok);
  // A rank writes rank 0's shared memory only once every rank has started:
  // arrive now, wait before the push (long since met by then).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  for (int e = threadIdx.x; e < 256 * 16; e += kGemvThreads) {
    const int b = e >> 4;
    table[e] = make_float2(kLevels[b >> 4], kLevels[b & 15]);
  }
  gemv_stage_x<T, M>(xs, x, xstride, b0 * kRowsPerScale, nrows, K, vec_x);
  __syncthreads();

  const uint32_t tab =
      static_cast<uint32_t>(__cvta_generic_to_shared(table)) + 8 * (lane & 15);
  GemvAcc<T, M> acc;
  acc.zero();
  for (; blk < b1; blk += kGemvWarps) {
    if (blk + kGemvWarps < b1) {
      gemv_load(nxt, pk, sc, blk + kGemvWarps, c, n0, N, col_ok);
    }
    acc.block(cur, tab, xs, xstride, (blk - b0) * kRowsPerScale, g, c);
    cur = nxt;
  }
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
        y[static_cast<size_t>(m) * N + n] = from_f32<T>(v);
      }
    }
  }
}

// A launch of `kernel` on `grid`, its x dimension the split ranks of one
// thread-block cluster (cudaLaunchKernelEx, which CUDA graphs capture), with
// `smem` bytes of dynamic shared memory: above 48 KB it must be asked for
// first. Both split-K kernels launch this way.
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
cudaError_t launch_gemv(const void* x, const void* pk, const void* sc, void* y,
                        int K, int P, int N, int split, cudaStream_t stream) {
  const int blocks = P / kRowsPerScale;
  const int chunk = (blocks + split - 1) / split;
  const int strips = (N + kGemvStrip - 1) / kGemvStrip;
  if (chunk > kGemvMaxChunk || strips > 65535) return cudaErrorInvalidValue;
  return launch_cluster(
      nf4_gemv_kernel<T, M>, dim3(split, strips, 1),
      gemv_smem<T, M>(chunk * kRowsPerScale, split), stream, static_cast<const T*>(x),
      static_cast<const uint8_t*>(pk), static_cast<const __nv_bfloat16*>(sc),
      static_cast<T*>(y), K, P, N, chunk,
      K % (16 / static_cast<int>(sizeof(T))) == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0);
}

// The most a CTA takes (kGemvMaxChunk blocks of float32 x at M = 2, the
// largest cluster's slots): 76 KB, two CTAs an SM; bf16 x at M = 1 takes
// at most 44 KB.
static_assert(2 * (gemv_smem<float, 2>(kGemvMaxChunk * kRowsPerScale,
                                       kGemvMaxSplit) + 1024) <= kSmemPerSM,
              "two of the gemv's largest CTAs fit an SM's shared memory");

// ---- The float32 prefill route: bf16 terms on the tensor cores ----

constexpr int kF32MmaTerms = 3;        // bf16 terms of a float32 x value
constexpr int kF32MmaLevelTerms = 2;   // bf16 terms of an NF4 level
constexpr int kF32MmaProducts = 5;     // term products summed, t + u <= 2
constexpr int kF32MmaMaxFrags = 2;     // n8 fragments of x a CTA: 16 rows
constexpr int kF32MmaStages = 3;       // ring slots, one scale block each
constexpr int kF32MmaCopies = 8;       // copies of each pair-table entry
constexpr int kF32MmaSplitThreads = 256;
constexpr int kF32MmaTableBytes = 256 * kF32MmaCopies * 8;

// Product p of a scale block's sums: x term f32mma_x(p) times level term
// f32mma_l(p): (0, 0), (1, 0), (0, 1), (2, 0), (1, 1), the largest first.
__host__ __device__ constexpr int f32mma_x(int p) {
  return p == 1 || p == 4 ? 1 : p == 3 ? 2 : 0;
}
__host__ __device__ constexpr int f32mma_l(int p) { return p == 2 || p == 4 ? 1 : 0; }

// A CTA's shared memory at NF n8 fragments of x (8 NF rows): the pair
// table, then a ring of kF32MmaStages slots, each one scale block of the
// strip: its 32 packed rows x 128 columns, its 128 bf16 scales, and its 64
// k of each row of x as the terms (32 words a row and term). Rows of the
// weights and of the terms are swizzled: 16-byte chunk q of row r sits at
// chunk q ^ 2 (r & 3), so the lanes' reads below are free of bank
// conflicts with no padding. After the loop the drained ring takes the
// CTA's sums [column][row + 2 pad] and then the slots that the cluster's
// ranks push to this one, [rank][row / split][column].
template <int NF>
struct F32MmaTile {
  static constexpr int kRows = 8 * NF;
  static constexpr int kWBytes = kRowsPerScale * kGemvStrip;
  static constexpr int kSBytes = kGemvStrip * 2;
  static constexpr int kXtBytes = kF32MmaTerms * kRows * kRowsPerScale * 4;
  static constexpr int kSlotBytes = kWBytes + kSBytes + kXtBytes;
  static constexpr int kSumPitch = kRows + 2;
  static constexpr int kSumBytes = kGemvStrip * kSumPitch * 4;
  static constexpr int kSmem = kF32MmaTableBytes + kF32MmaStages * kSlotBytes;
  static_assert(kSlotBytes % 16 == 0 && kSumBytes % 16 == 0, "16-byte copies");
  static_assert(kSumBytes + (kRows + kGemvMaxSplit - 1) * kGemvStrip * 4 <=
                    kF32MmaStages * kSlotBytes,
                "the sums and the pushed slots fit the drained ring");
};

// Four CTAs an SM at every number of rows (47 KB at 16 rows).
static_assert(4 * (F32MmaTile<kF32MmaMaxFrags>::kSmem + 1024) <= kSmemPerSM,
              "four of the largest CTAs fit an SM's shared memory");

// Pair q of row m (x[m][2q], x[m][2q + 1]) sits in the term buffer at word
// f32mma_pos(q) of the row: within each 8 pairs (a k16 slice) pairs c and
// c + 4, the B fragment's two registers of lane c, side by side.
__device__ __forceinline__ int f32mma_pos(int q) {
  return (q & ~7) | ((q & 3) << 1) | ((q >> 2) & 1);
}

// x [M, K] float32 into its bf16 terms, once a call: term t of a value is
// bf16 of what the earlier terms leave (each subtraction exact; three terms
// hold every normal float32 exactly); a word holds a pair of k. terms is
// [kF32MmaTerms][M][P] words, zero past K.
__global__ void __launch_bounds__(kF32MmaSplitThreads)
    nf4_f32mma_split_kernel(const float* __restrict__ x, uint32_t* __restrict__ terms,
                            int M, int K, int P) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kF32MmaSplitThreads + threadIdx.x;
  if (i >= static_cast<size_t>(M) * P) return;
  const int m = static_cast<int>(i / P), q = static_cast<int>(i % P);
  float2 v = 2 * q < K ? *reinterpret_cast<const float2*>(x + static_cast<size_t>(m) * K + 2 * q)
                       : make_float2(0.f, 0.f);
  uint32_t* out = terms + static_cast<size_t>(m) * P + f32mma_pos(q);
#pragma unroll
  for (int u = 0; u < kF32MmaTerms; ++u) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
    out[static_cast<size_t>(u) * M * P] = *reinterpret_cast<const uint32_t*>(&b);
    v.x -= __low2float(b);
    v.y -= __high2float(b);
  }
}

// The pair-table entry of byte b: the A-fragment register of its two
// levels (weight rows 2r, 2r + 1: the high nibble's level in the low half)
// for each level term, L0 = bf16(level), L1 = bf16(level - L0). `levels`:
// the 16 levels in shared memory.
__device__ __forceinline__ uint2 f32mma_entry(const float* levels, int b) {
  uint32_t w[kF32MmaLevelTerms];
  float hi = levels[b >> 4], lo = levels[b & 15];
#pragma unroll
  for (int u = 0; u < kF32MmaLevelTerms; ++u) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(hi, lo);
    w[u] = *reinterpret_cast<const uint32_t*>(&p);
    hi -= __low2float(p);
    lo -= __high2float(p);
  }
  return make_uint2(w[0], w[1]);
}

// Byte j of `v` through the pair table: both level terms' A registers.
// `tab` is the shared address of the copy this lane reads (lane %
// kF32MmaCopies): at 8 copies two lanes of a half-warp share a bank pair
// only when their bytes differ in the lowest bit.
__device__ __forceinline__ uint2 f32mma_levels(uint32_t v, uint32_t tab, int j) {
  const uint32_t addr = tab + __byte_perm(v, 0u, 0x4440u | j) * (kF32MmaCopies * 8);
  uint2 out;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(out.x), "=r"(out.y)
               : "r"(addr));
  return out;
}

__device__ __forceinline__ void mma_16816_zero(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// This thread's copies of scale block `blk` into ring slot `slot`: the
// strip's 32 packed rows (16-byte chunk e: row e / 8, chunk e % 8), its 128
// scales (threads 0-15), and the block's 32 words of each term of each of
// the tile's rows (chunk e: term and row e / 8, chunk e % 8), swizzled;
// zero-filled past N and past M.
template <int NF>
__device__ __forceinline__ void f32mma_copy(unsigned char* slot,
                                            const uint8_t* __restrict__ pk,
                                            const __nv_bfloat16* __restrict__ sc,
                                            const uint32_t* __restrict__ terms, int blk,
                                            int strip0, int m0, int M, int P, int N) {
  using T = F32MmaTile<NF>;
  const int t = threadIdx.x;
#pragma unroll
  for (int e0 = 0; e0 < kRowsPerScale * 8 / kGemvThreads; ++e0) {
    const int e = t + e0 * kGemvThreads;
    const int row = e >> 3, q = e & 7;
    const bool ok = strip0 + 16 * q < N;
    cp_async16(slot + row * kGemvStrip + 16 * (q ^ (2 * (row & 3))),
               ok ? pk + (static_cast<size_t>(blk) * kRowsPerScale + row) * N + strip0 + 16 * q
                  : pk,
               ok);
  }
  if (t < kGemvStrip / 8) {
    const bool ok = strip0 + 8 * t < N;
    cp_async16(slot + T::kWBytes + 16 * t,
               ok ? sc + static_cast<size_t>(blk) * N + strip0 + 8 * t : sc, ok);
  }
  unsigned char* xs = slot + T::kWBytes + T::kSBytes;
#pragma unroll
  for (int e0 = 0; e0 < (kF32MmaTerms * T::kRows * 8 + kGemvThreads - 1) / kGemvThreads;
       ++e0) {
    const int e = t + e0 * kGemvThreads;
    if (e < kF32MmaTerms * T::kRows * 8) {
      const int u = e / (T::kRows * 8), m = (e >> 3) % T::kRows, q = e & 7;
      const bool ok = m0 + m < M;
      cp_async16(xs + (u * T::kRows + m) * 128 + 16 * (q ^ (2 * (m & 3))),
                 ok ? terms + (static_cast<size_t>(u) * M + m0 + m) * P + blk * kRowsPerScale +
                          4 * q
                    : terms,
                 ok);
    }
  }
}

// A warp's 32 columns of one scale block into its sums. Lane (g, c) reads 4
// bytes (columns 4g .. 4g + 3 of the warp's) of packed rows c and c + 4 of
// each 8-row slice: fragment row g of tile t is column 4g + 2t, row g + 8
// column 4g + 2t + 1, k the slice's weight rows 2c, 2c + 1 (row c) and 2c +
// 8, 2c + 9 (row c + 4). Per slice the products of the level terms (A) and
// x's terms (B: fragment f is rows 8f .. 8f + 7 of the tile) go into the
// block's own float32 sums; then each column's scale multiplies the block's
// sums into the running ones, in block order.
template <int NF>
__device__ __forceinline__ void f32mma_block(float (&acc)[2][NF][4],
                                             const unsigned char* slot, uint32_t tab,
                                             int warp, int g, int c) {
  using T = F32MmaTile<NF>;
  // Row r = 8 sl + c (+ 4) has r & 3 = c: its word 8 warp + g sits at
  // (8 warp + g) ^ 8c.
  const uint32_t* wr =
      reinterpret_cast<const uint32_t*>(slot) + 32 * c + ((8 * warp + g) ^ (8 * c));
  const uint2 sraw = *reinterpret_cast<const uint2*>(slot + T::kWBytes + 64 * warp + 8 * g);
  const float s[4] = {__uint_as_float(sraw.x << 16), __uint_as_float(sraw.x & 0xFFFF0000u),
                      __uint_as_float(sraw.y << 16), __uint_as_float(sraw.y & 0xFFFF0000u)};
  // Row 8f + g of a term has (8f + g) & 3 = g & 3: slice sl's words sit at
  // 8 (sl ^ (g & 3)) + 2c.
  const uint32_t* xr = reinterpret_cast<const uint32_t*>(slot + T::kWBytes + T::kSBytes) +
                       32 * g + 2 * c;
  float blk[2][NF][4];
#pragma unroll
  for (int sl = 0; sl < 4; ++sl) {
    const uint32_t w0 = wr[32 * kGemvSlice * sl];
    const uint32_t w1 = wr[32 * (kGemvSlice * sl + 4)];
    uint32_t a[kF32MmaLevelTerms][2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint2 e0 = f32mma_levels(w0, tab, 2 * t);
      const uint2 e1 = f32mma_levels(w0, tab, 2 * t + 1);
      const uint2 e2 = f32mma_levels(w1, tab, 2 * t);
      const uint2 e3 = f32mma_levels(w1, tab, 2 * t + 1);
      a[0][t][0] = e0.x, a[0][t][1] = e1.x, a[0][t][2] = e2.x, a[0][t][3] = e3.x;
      a[1][t][0] = e0.y, a[1][t][1] = e1.y, a[1][t][2] = e2.y, a[1][t][3] = e3.y;
    }
    const int xoff = 8 * (sl ^ (g & 3));
    uint2 b[kF32MmaTerms][NF];
#pragma unroll
    for (int u = 0; u < kF32MmaTerms; ++u)
#pragma unroll
      for (int f = 0; f < NF; ++f)
        b[u][f] = *reinterpret_cast<const uint2*>(xr + (u * T::kRows + 8 * f) * 32 + xoff);
#pragma unroll
    for (int p = 0; p < kF32MmaProducts; ++p)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const uint2 bb = b[f32mma_x(p)][f];
          if (sl == 0 && p == 0) {
            mma_16816_zero(blk[t][f], a[f32mma_l(p)][t], bb.x, bb.y);
          } else {
            mma_16816(blk[t][f], a[f32mma_l(p)][t], bb.x, bb.y);
          }
        }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[t][f][e] = fmaf(blk[t][f][e], s[2 * t + (e >> 1)], acc[t][f][e]);
}

template <int NF>
__global__ void __launch_bounds__(kGemvThreads)
    nf4_f32mma_kernel(const uint32_t* __restrict__ terms, const uint8_t* __restrict__ pk,
                      const __nv_bfloat16* __restrict__ sc, float* __restrict__ y,
                      int M, int P, int N, int chunk) {
  using T = F32MmaTile<NF>;
  extern __shared__ __align__(16) unsigned char gsmem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // the cluster spans gridDim.x
  const int split = gridDim.x;
  const int m0 = blockIdx.y * T::kRows;
  const int strip0 = blockIdx.z * kGemvStrip;
  const int blocks = P / kRowsPerScale;
  const int b0 = rank * chunk;
  const int count = max(min(b0 + chunk, blocks) - b0, 0);
  unsigned char* ring = gsmem + kF32MmaTableBytes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;

  // The rank's scale blocks b0 .. b0 + count - 1 through the ring; the
  // first kF32MmaStages - 1 are asked for before the table is built, and
  // each later one kF32MmaStages - 1 blocks ahead of the work.
#pragma unroll
  for (int i = 0; i < kF32MmaStages - 1; ++i) {
    if (i < count) {
      f32mma_copy<NF>(ring + i * T::kSlotBytes, pk, sc, terms, b0 + i, strip0, m0, M, P, N);
    }
    cp_async_commit();
  }
  // The levels into shared memory first: a warp's entries read 4-8
  // different levels, which __constant__ memory would serialise.
  __shared__ float levels[16];
  if (threadIdx.x < 16) levels[threadIdx.x] = kLevels[threadIdx.x];
  __syncthreads();
  uint2* table = reinterpret_cast<uint2*>(gsmem);
  for (int e = threadIdx.x; e < 256 * kF32MmaCopies; e += kGemvThreads) {
    table[e] = f32mma_entry(levels, e / kF32MmaCopies);
  }
  const uint32_t tab = static_cast<uint32_t>(__cvta_generic_to_shared(gsmem)) +
                       8 * (lane % kF32MmaCopies);
  float acc[2][NF][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][f][e] = 0.f;
  for (int i = 0; i < count; ++i) {
    // Block i has landed; after the barrier every warp is done with block
    // i - 1, whose slot the next copies take.
    cp_async_wait<kF32MmaStages - 2>();
    __syncthreads();
    if (i + kF32MmaStages - 1 < count) {
      f32mma_copy<NF>(ring + ((i + kF32MmaStages - 1) % kF32MmaStages) * T::kSlotBytes, pk,
                      sc, terms, b0 + i + kF32MmaStages - 1, strip0, m0, M, P, N);
    }
    cp_async_commit();
    f32mma_block<NF>(acc, ring + (i % kF32MmaStages) * T::kSlotBytes, tab, warp, g, c);
  }
  // The ring is drained: the CTA's sums go into it, [column][row], each
  // lane's D rows 2c, 2c + 1 as one 8-byte store (the 2-word pad keeps a
  // half-warp's stores on 16 different bank pairs).
  cp_async_wait<0>();
  __syncthreads();
  float* sums = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 32 * warp + 4 * g + 2 * t + h;
        *reinterpret_cast<float2*>(sums + col * T::kSumPitch + 8 * f + 2 * c) =
            make_float2(acc[t][f][2 * h], acc[t][f][2 * h + 1]);
      }
  // Rank r owns rows r, r + split, ... of the tile. Once every rank is past
  // its loop (its ring drained) each pushes its sums of every row into the
  // owner's slots (thread = column), through distributed shared memory;
  // after the second barrier each rank adds its rows' slots in rank order
  // 0 .. split - 1 and writes y. One launch, no atomics, deterministic.
  cluster.sync();
  const int col = threadIdx.x;
  const int rows = min(T::kRows, M - m0);
  const int per = (rows + split - 1) / split;
  float* slots = reinterpret_cast<float*>(ring + T::kSumBytes);
  for (int m = 0; m < rows; ++m) {
    cluster.map_shared_rank(slots, m % split)[(rank * per + m / split) * kGemvStrip + col] =
        sums[col * T::kSumPitch + m];
  }
  cluster.sync();
  if (strip0 + col < N) {
    for (int j = 0; j < per && rank + j * split < rows; ++j) {
      float v = 0.f;
      for (int r = 0; r < split; ++r) v += slots[(r * per + j) * kGemvStrip + col];
      y[static_cast<size_t>(m0 + rank + j * split) * N + strip0 + col] = v;
    }
  }
}

template <int NF>
cudaError_t launch_f32mma(const void* x, const void* pk, const void* sc, void* y,
                          void* terms, int M, int K, int P, int N, int split,
                          cudaStream_t stream) {
  using T = F32MmaTile<NF>;
  const int blocks = P / kRowsPerScale;
  const int chunk = (blocks + split - 1) / split;
  const int strips = (N + kGemvStrip - 1) / kGemvStrip;
  const int tiles = (M + T::kRows - 1) / T::kRows;
  const size_t words = static_cast<size_t>(M) * P;
  if (strips > 65535 || tiles > 65535 ||
      (words + kF32MmaSplitThreads - 1) / kF32MmaSplitThreads > 0x7FFFFFFF) {
    return cudaErrorInvalidValue;
  }
  nf4_f32mma_split_kernel<<<static_cast<unsigned>((words + kF32MmaSplitThreads - 1) /
                                                  kF32MmaSplitThreads),
                            kF32MmaSplitThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<uint32_t*>(terms), M, K, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The M tiles of a strip are neighbours in the grid, so they share its
  // weight bytes in L2.
  return launch_cluster(nf4_f32mma_kernel<NF>, dim3(split, tiles, strips), T::kSmem,
                        stream, static_cast<const uint32_t*>(terms),
                        static_cast<const uint8_t*>(pk),
                        static_cast<const __nv_bfloat16*>(sc), static_cast<float*>(y), M, P,
                        N, chunk);
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

extern "C" int nf4_dot_mma_launch(const void* x, const void* packed,
                                  const void* scales, void* y, int M, int K,
                                  int P, int N, int x_dtype, int device,
                                  void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || P <= 0 || P % kRowsPerScale != 0 ||
      2 * P < K || 2 * P - K >= 2 * kRowsPerScale || x_dtype != 1 ||
      N % 16 != 0 || K % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(packed) |
       reinterpret_cast<uintptr_t>(scales) | reinterpret_cast<uintptr_t>(y)) %
          16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = M <= SmallM::BM
            ? launch_mma<SmallM>(x, packed, scales, y, M, K, P, N, st)
            : launch_mma<LargeM>(x, packed, scales, y, M, K, P, N, st);
  return static_cast<int>(err);
}

extern "C" int nf4_dot_gemv_launch(const void* x, const void* packed,
                                   const void* scales, void* y, int M, int K,
                                   int P, int N, int x_dtype, int device,
                                   void* stream, int strip_cols, int split) {
  if (M <= 0 || M > 2 || K <= 0 || N <= 0 || P <= 0 ||
      P % kRowsPerScale != 0 || 2 * P < K || 2 * P - K >= 2 * kRowsPerScale ||
      N % 16 != 0 || strip_cols != kGemvStrip || split < 1 ||
      split > kGemvMaxSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(packed) |
       reinterpret_cast<uintptr_t>(scales)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    err = M == 1 ? launch_gemv<float, 1>(x, packed, scales, y, K, P, N, split, st)
                 : launch_gemv<float, 2>(x, packed, scales, y, K, P, N, split, st);
  } else if (x_dtype == 1) {
    err = M == 1 ? launch_gemv<__nv_bfloat16, 1>(x, packed, scales, y, K, P, N,
                                                 split, st)
                 : launch_gemv<__nv_bfloat16, 2>(x, packed, scales, y, K, P, N,
                                                 split, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int nf4_dot_f32mma_launch(const void* x, const void* packed,
                                     const void* scales, void* y, int M, int K,
                                     int P, int N, int x_dtype, int device,
                                     void* stream, int strip_cols, int split,
                                     void* terms) {
  if (M <= 0 || K <= 0 || N <= 0 || P <= 0 || P % kRowsPerScale != 0 ||
      2 * P < K || 2 * P - K >= 2 * kRowsPerScale || x_dtype != 0 ||
      N % 16 != 0 || K % 8 != 0 || strip_cols != kGemvStrip || split < 1 ||
      split > kGemvMaxSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(packed) |
       reinterpret_cast<uintptr_t>(scales) | reinterpret_cast<uintptr_t>(terms)) % 16 !=
      0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // One n8 fragment of x for M <= 8, else M tiles of 8 kF32MmaMaxFrags rows.
  err = M <= 8 ? launch_f32mma<1>(x, packed, scales, y, terms, M, K, P, N, split, st)
               : launch_f32mma<kF32MmaMaxFrags>(x, packed, scales, y, terms, M, K, P, N,
                                                split, st);
  return static_cast<int>(err);
}

extern "C" const char* nf4_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
