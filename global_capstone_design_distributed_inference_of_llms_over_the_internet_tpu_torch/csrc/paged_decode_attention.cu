// Paged decode attention: one query token a row over the occupied pages of
// a session's KV cache,
//
//   out[b, h] = softmax_j( q[b, h] . k[b, j, h / G] * Dh^-0.5 ) v[b, j, h / G]
//
// for j = 0 .. cache_len (the new key already written at cache_len), q
// [B, 1, H, Dh] and caches [B, S, Hkv, Dh], each in float32 or bf16, G = H /
// Hkv query heads a KV head. The plain version is ops/attention.py
// `paged_decode_attention`, itself line for line the JAX package's
// (ops/attention.py:58-114): q scaled in its own dtype, scores summed in
// float32, a float32 running max and denominator a page at a time, the
// weights rounded to v's dtype for the value product, which sums in float32,
// the output divided by max(l, 1e-20) and returned in q's dtype.
//
// It replaces no Pallas kernel: the JAX package leaves this function to XLA,
// a fori_loop whose trip count (cache_len + page) / page is traced. The
// port runs its session steps and fused oracles as CUDA graphs, where
// cache_len is a 0-d device tensor the host never reads back; plain PyTorch
// can only read every page under a mask (what cached_attention does) or
// sync on cache_len every layer, which a captured step cannot. This kernel
// reads cache_len from device memory and skips the pages past it, so a
// replayed graph reads what the cache holds, at any length.
//
// What bounds it on an H100: bytes. At llama-3.1-8b's B = 1, Hkv = 8, G = 4,
// Dh = 128 a float32 cache holds 4 KB of K and V a row (both, all heads);
// each key costs 2 x G x Dh multiply-adds, 2 operations a byte read, far
// below the ~20 a byte (float32 CUDA cores) where the operations would
// bound it. The least time is the occupied pages' K and V, q and the output
// at 3.35 TB/s.
//
// The design, simple first (one block of 4 warps a work item, no wgmma,
// TMA or persistent blocks):
//   * the grid is fixed by the shapes: (chunks of `chunk_pages` pages, Hkv,
//     B), so one captured launch serves every cache_len;
//   * a block whose chunk starts past cache_len writes an empty partial
//     (max -inf, sum 0, acc 0) and exits; the others walk their chunk's
//     pages in order up to the one holding cache_len, each page as the
//     reference's loop body: the page's K rows staged in shared memory by
//     every thread at once (16-byte loads, eight a thread in flight, where
//     a warp reading each row as it used it would wait on one load after
//     another), a warp a key row for the
//     scores (its lanes stride over Dh, every query head of the group at
//     once, q in shared memory), a warp a query head for the page's max,
//     weights and sum, then its V rows staged the same way and a thread a
//     Dh column for the value product; rows past cache_len are neither
//     read nor summed (their weight is exactly 0 in the reference);
//   * a second launch merges the chunks' partials in chunk order: the max
//     M of their maxima, each partial's sum and accumulator scaled by
//     exp(m_c - M), the output divided by max(L, 1e-20). This changes the
//     order of the sums against the reference's sequential pages (float32:
//     a few ulps), and with a bf16 cache a chunk rounds its weights against
//     its own running max, not the reference's (one bf16 rounding either
//     way);
//   * the wrapper (ops/paged_attention_kernel.py) allocates the partials
//     with torch.empty, so inside a capture they come from the graph's pool;
//     nothing here allocates, syncs or reads back to the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 8;        // query heads a KV head
constexpr int kMaxHeadDim = 256;
constexpr int kMaxPage = 128;
// Bytes of K or V rows staged in shared memory at once (a tile), and the
// 16-byte loads a thread has in flight while it stages: with the scores
// and q the block stays under 48 KB of shared memory at kMaxGroups,
// kMaxHeadDim and kMaxPage.
constexpr int kStageBytes = 32768;
constexpr int kCopyBatch = 8;
constexpr int kDimSlots = kMaxHeadDim / kThreads;
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T's precision, as a float (round to nearest even).
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// A tile of key rows [r0, r0 + rows) of one KV head copied to shared memory
// [rows][Dh], 16 bytes a load where the rows allow it, kCopyBatch loads of a
// thread in flight before their stores: the page's bytes are read once and
// many loads overlap.
template <typename KT>
__device__ __forceinline__ void stage_rows(const KT* __restrict__ base, size_t row_stride,
                                           int r0, int rows, int Dh, KT* __restrict__ dst,
                                           bool vec) {
  if (vec) {
    const int per_row = Dh * static_cast<int>(sizeof(KT)) / 16;
    const int total = rows * per_row;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kCopyBatch) {
      uint4 buf[kCopyBatch];
#pragma unroll
      for (int j = 0; j < kCopyBatch; ++j) {
        const int i = i0 + j * kThreads;
        if (i < total) {
          const int r = i / per_row, u = i % per_row;
          buf[j] = reinterpret_cast<const uint4*>(
              base + static_cast<size_t>(r0 + r) * row_stride)[u];
        }
      }
#pragma unroll
      for (int j = 0; j < kCopyBatch; ++j) {
        const int i = i0 + j * kThreads;
        if (i < total) d4[i] = buf[j];
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * Dh; i += kThreads) {
      dst[i] = base[static_cast<size_t>(r0 + i / Dh) * row_stride + i % Dh];
    }
  }
}

// Grid (chunks, Hkv, B). Partials of chunk c of (b, kv head h): m and l
// [B, Hkv, chunks, G], acc [B, Hkv, chunks, G, Dh], float32. A page is the
// reference's loop body: its rows' scores (K staged a tile of `tile` rows
// at a time), the page's max, weights and sum, then the value product (V
// staged the same way) summed over the page's rows in order.
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_partial_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                     const KT* __restrict__ v, const long long* __restrict__ cache_len_ptr,
                     long long cache_len_value, int S, int Hkv, int G, int Dh, int page,
                     int chunk_pages, int tile, float scale, float* __restrict__ m_part,
                     float* __restrict__ l_part, float* __restrict__ acc_part) {
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  long long last = cache_len_ptr != nullptr ? *cache_len_ptr : cache_len_value;
  // The caller keeps 0 <= cache_len < S; clamped so that no read leaves
  // the cache whatever the device value holds.
  last = last < 0 ? 0 : (last > S - 1 ? S - 1 : last);
  const size_t part = (static_cast<size_t>(b) * Hkv + kvh) * gridDim.x + chunk;
  float* acc_out = acc_part + part * G * Dh;
  const int first_page = chunk * chunk_pages;
  if (static_cast<long long>(first_page) * page > last) {
    for (int i = threadIdx.x; i < G * Dh; i += kThreads) acc_out[i] = 0.f;
    if (threadIdx.x < G) {
      m_part[part * G + threadIdx.x] = -INFINITY;
      l_part[part * G + threadIdx.x] = 0.f;
    }
    return;
  }

  // Dynamic shared memory: the staged tile [tile][Dh] (16-byte aligned,
  // first), q scaled in its own dtype [G][Dh], the page's scores and then
  // weights [G][page].
  extern __shared__ uint4 smem4[];
  KT* kv_s = reinterpret_cast<KT*>(smem4);
  float* qs = reinterpret_cast<float*>(smem4 + (static_cast<size_t>(tile) * Dh *
                                                sizeof(KT) + 15) / 16);
  float* sc = qs + G * Dh;
  __shared__ float m_s[kMaxGroups], l_s[kMaxGroups], corr_s[kMaxGroups];

  const int H = Hkv * G;
  const QT* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * Dh;
  for (int i = threadIdx.x; i < G * Dh; i += kThreads) {
    qs[i] = round_to<QT>(to_f(qb[i]) * scale);
  }
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[kMaxGroups][kDimSlots];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
#pragma unroll
    for (int i = 0; i < kDimSlots; ++i) acc[g][i] = 0.f;
  }

  const size_t row_stride = static_cast<size_t>(Hkv) * Dh;
  const size_t head0 = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(kvh) * Dh;
  const KT* kb = k + head0;
  const KT* vb = v + head0;
  // 16-byte copies need whole 16-byte rows and 16-byte aligned caches.
  const bool vec = (Dh * sizeof(KT)) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int end_page = min(first_page + chunk_pages, S / page);
  for (int p = first_page; p < end_page && static_cast<long long>(p) * page <= last; ++p) {
    const int r0 = p * page;
    const long long left = last - r0 + 1;   // real rows from r0 on, >= 1
    const int valid = left < page ? static_cast<int>(left) : page;
    // Scores: a warp a key row of the staged tile, every query head of the
    // group at once; rows past cache_len score NEG_INF unread.
    for (int t0 = 0; t0 < page; t0 += tile) {
      const int rows = max(0, min(tile, valid - t0));
      __syncthreads();                      // the tile's last readers are done
      stage_rows(kb, row_stride, r0 + t0, rows, Dh, kv_s, vec);
      __syncthreads();
      for (int r = warp; r < min(tile, page - t0); r += kWarps) {
        float dot[kMaxGroups];
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g) dot[g] = 0.f;
        if (r < rows) {
          const KT* kr = kv_s + r * Dh;
          for (int d = lane; d < Dh; d += 32) {
            const float kd = to_f(kr[d]);
#pragma unroll
            for (int g = 0; g < kMaxGroups; ++g) {
              if (g < G) dot[g] = fmaf(qs[g * Dh + d], kd, dot[g]);
            }
          }
#pragma unroll
          for (int g = 0; g < kMaxGroups; ++g) {
            if (g < G) dot[g] = warp_sum(dot[g]);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int g = 0; g < kMaxGroups; ++g) {
            if (g < G) sc[g * page + t0 + r] = r < rows ? dot[g] : kNegInf;
          }
        }
      }
    }
    __syncthreads();
    // The page's max, weights and sum: a warp a query head.
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int r = lane; r < page; r += 32) mx = fmaxf(mx, sc[g * page + r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < page; r += 32) {
        const float w = expf(sc[g * page + r] - m_new);
        sum += w;
        sc[g * page + r] = round_to<KT>(w);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    // The value product: a thread a Dh column, over the page's real rows
    // in order, V staged a tile at a time.
    float pv[kMaxGroups][kDimSlots];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
#pragma unroll
      for (int i = 0; i < kDimSlots; ++i) pv[g][i] = 0.f;
    }
    for (int t0 = 0; t0 < valid; t0 += tile) {
      const int rows = min(tile, valid - t0);
      __syncthreads();
      stage_rows(vb, row_stride, r0 + t0, rows, Dh, kv_s, vec);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kDimSlots; ++i) {
        const int d = threadIdx.x + i * kThreads;
        if (d < Dh) {
          for (int r = 0; r < rows; ++r) {
            const float vd = to_f(kv_s[r * Dh + d]);
#pragma unroll
            for (int g = 0; g < kMaxGroups; ++g) {
              if (g < G) pv[g][i] = fmaf(sc[g * page + t0 + r], vd, pv[g][i]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kDimSlots; ++i) {
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g < G) acc[g][i] = acc[g][i] * corr_s[g] + pv[g][i];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kDimSlots; ++i) {
    const int d = threadIdx.x + i * kThreads;
    if (d < Dh) {
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g < G) acc_out[g * Dh + d] = acc[g][i];
      }
    }
  }
  if (threadIdx.x < G) {
    m_part[part * G + threadIdx.x] = m_s[threadIdx.x];
    l_part[part * G + threadIdx.x] = l_s[threadIdx.x];
  }
}

// Grid (Hkv, B): a thread a (query head, Dh column) of (b, kv head), its
// chunks merged in chunk order; out [B, 1, H, Dh] in q's dtype.
template <typename OT>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                   const float* __restrict__ acc_part, int chunks, int Hkv, int G, int Dh,
                   OT* __restrict__ out) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const size_t base = (static_cast<size_t>(b) * Hkv + kvh) * chunks;
  const int H = Hkv * G;
  for (int i = threadIdx.x; i < G * Dh; i += kThreads) {
    const int g = i / Dh, d = i % Dh;
    float mx = -INFINITY;
    for (int c = 0; c < chunks; ++c) mx = fmaxf(mx, m_part[(base + c) * G + g]);
    float l = 0.f, a = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const float mc = m_part[(base + c) * G + g];
      if (mc != -INFINITY) {            // an empty chunk adds nothing
        const float e = expf(mc - mx);
        l += l_part[(base + c) * G + g] * e;
        a += acc_part[((base + c) * G + g) * Dh + d] * e;
      }
    }
    out[(static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G + g) * Dh + d] =
        from_f<OT>(a / fmaxf(l, 1e-20f));
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* cache_len_ptr,
                   long long cache_len, void* m_part, void* l_part, void* acc_part, void* out,
                   int B, int S, int Hkv, int G, int Dh, int page, int chunk_pages,
                   float scale, cudaStream_t st) {
  const int pages = S / page;
  const int chunks = (pages + chunk_pages - 1) / chunk_pages;
  // Rows a staged tile: as many as kStageBytes holds, at most a page.
  const int fit = kStageBytes / (Dh * static_cast<int>(sizeof(KT)));
  const int tile = page < fit ? page : fit;
  const size_t stage = (static_cast<size_t>(tile) * Dh * sizeof(KT) + 15) / 16 * 16;
  const size_t smem = stage + static_cast<size_t>(G) * (Dh + page) * sizeof(float);
  paged_partial_kernel<QT, KT><<<dim3(chunks, Hkv, B), kThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const long long*>(cache_len_ptr), cache_len, S, Hkv, G, Dh, page,
      chunk_pages, tile, scale, static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_merge_kernel<QT><<<dim3(Hkv, B), kThreads, 0, st>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), chunks, Hkv, G, Dh, static_cast<QT*>(out));
  return cudaGetLastError();
}

}  // namespace

// q [B, 1, H, Dh] (q_dtype), k and v [B, S, Hkv, Dh] (kv_dtype), all
// contiguous; dtype codes 0 = float32, 1 = bf16. cache_len_ptr: a 0-d
// int64 device tensor, or null and cache_len by value. m_part and l_part
// float32 [B, Hkv, chunks, G], acc_part float32 [B, Hkv, chunks, G, Dh],
// chunks = ceil((S / page) / chunk_pages); out [B, 1, H, Dh] in q's dtype.
// scale is Dh ** -0.5 as a float.
extern "C" int paged_decode_attention_launch(const void* q, const void* k, const void* v,
                                             const void* cache_len_ptr, long long cache_len,
                                             void* m_part, void* l_part, void* acc_part,
                                             void* out, int B, int S, int Hkv, int G, int Dh,
                                             int page, int chunk_pages, int q_dtype,
                                             int kv_dtype, float scale, int device,
                                             void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || G <= 0 || G > kMaxGroups ||
      Dh <= 0 || Dh > kMaxHeadDim || page <= 0 || page > kMaxPage || S <= 0 ||
      S % page != 0 || chunk_pages <= 0 || q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 ||
      kv_dtype > 1 || (cache_len_ptr == nullptr && (cache_len < 0 || cache_len >= S))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // This library links its own CUDA runtime, whose current device is not
  // PyTorch's: launch on the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0) {
    err = launch<float, float>(q, k, v, cache_len_ptr, cache_len, m_part, l_part, acc_part,
                               out, B, S, Hkv, G, Dh, page, chunk_pages, scale, st);
  } else if (q_dtype == 0) {
    err = launch<float, bf16>(q, k, v, cache_len_ptr, cache_len, m_part, l_part, acc_part,
                              out, B, S, Hkv, G, Dh, page, chunk_pages, scale, st);
  } else if (kv_dtype == 0) {
    err = launch<bf16, float>(q, k, v, cache_len_ptr, cache_len, m_part, l_part, acc_part,
                              out, B, S, Hkv, G, Dh, page, chunk_pages, scale, st);
  } else {
    err = launch<bf16, bf16>(q, k, v, cache_len_ptr, cache_len, m_part, l_part, acc_part,
                             out, B, S, Hkv, G, Dh, page, chunk_pages, scale, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
