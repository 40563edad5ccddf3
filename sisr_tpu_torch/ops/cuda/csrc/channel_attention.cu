// Squeeze-and-excite channel attention for Hopper (sm_90a), plain C interface.
//
//   out = x * sigmoid(relu(mean_hw(x) @ w1 + b1) @ w2 + b2)
//
// x is an (N, H, W, C) map, float32 or bfloat16, contiguous (a channels_last NCHW
// activation viewed as NHWC).  w1 (C, Cr), b1 (Cr), w2 (Cr, C), b2 (C) are float32.
// The pool and the excite run in float32; the scale multiplies x by the attention
// rounded to x's type, as `x * att.astype(x.dtype)` does.
//
// Replaces sisr_tpu/ops/pallas/channel_attention.py `_fused_ca_forward` (excite
// `_excite`), by two paths; the wrapper's plan (`onchip_plan` in
// ops/channel_attention.py) picks one from the shape and the card alone.
//
// Bound.  The work is two flops per element and one read plus one write of the map,
// so bytes bound it: at the main-path shape (8, 128, 128, 64) bf16 the least traffic
// is 2 x 16.8 MB = 33.6 MB, about 10 us at 3.35 TB/s.
//
// Path 1, on chip (entry sisr_ca_onchip_forward, kernel ca_onchip): replaces the
// single-block body `_ca_kernel_single`, which holds the whole map in VMEM and reads
// and writes it once.  Hopper's counterpart of that fast memory is the SMs' shared
// memory taken together (132 x 227 KB), so one cooperative launch of S blocks per
// image, all resident at once, each owning one contiguous slab of its image's NHWC
// pixels (at the main shape 16 blocks of 1024 pixels, 128 KB):
//   a. thread 0 copies the slab into dynamic shared memory with 1-D bulk async copies
//      (cp.async.bulk, the TMA), in kOnchipChunks chunks, each on its own mbarrier;
//      meanwhile the block stages the excite's weights in shared memory, then pools
//      each chunk in float32 as soon as it lands;
//   b. the block writes its per-channel sum to partial (N, S, C) with plain stores
//      and waits at one grid barrier (cooperative_groups grid sync);
//   c. every block of image n sums the S partials in a fixed order, divides by H*W
//      and runs the excite itself (64 -> 4 -> 64 at the main shape, well under a
//      microsecond), so no second barrier is needed;
//   d. the block scales its slab from shared memory by att rounded to x's type and
//      writes it out with 16-byte stores.
// The map leaves device memory once and returns once: the bound's own 33.6 MB.  No
// atomics on floats and every sum in a fixed order, so runs repeat bit for bit and
// every block of an image computes the same att.  The launch needs C * itemsize % 16
// == 0 and x 16-byte aligned (bulk copies move 16-byte units), every image at least
// one block, all N * S blocks co-resident, and the slab with its scratch inside the
// per-block opt-in shared memory; a cooperative launch that cannot make the blocks
// resident fails, and the wrapper raises.
//
// Path 2, three passes (entry sisr_ca_forward): replaces the tiled body `_ca_kernel`,
// for maps that do not fit on chip (at the main shape in float32, or one 512 x 512
// map).  The TPU kernel carries the spatial sum across a sequential grid and then
// revisits the tiles; Hopper blocks run in parallel in no order, so this is three
// launches on one stream:
//   1. ca_pool_partial: each block reduces a slab of pixels of one image over its
//      lanes of channels in float32 and writes one partial sum per channel to
//      partial (N, S, C).  Plain stores, no atomics: every sum is taken in a fixed
//      order, so results repeat exactly from run to run.
//   2. ca_excite: one block per image sums the S partials, divides by H*W and runs
//      the two small products, relu and sigmoid into att (N, C) float32.
//   3. ca_scale: out = x * att, one 16-byte vector per thread where C * itemsize is
//      a multiple of 16 (and x is 16-byte aligned), one element per thread otherwise.
// The map is read twice; the second read hits L2 where the map fits in its 50 MB.
//
// Second entry point, sisr_ca_res_forward: the int8 RCAB block tail
//
//   out = TR(float(x) * att(x) + float(r))
//
// with att computed as above (pool and excite in float32) and multiplied in float32,
// not rounded to x's type.  x is float32 or bfloat16 (the main path passes the
// float32 dequantised conv output), r the residual carry (float32 or bfloat16) of
// x's shape, and out has r's type.  Passes 1 and 2 are the same ca_pool_partial and
// ca_excite; pass 3 is ca_res_scale.
//
// Replaces sisr_tpu/ops/pallas/channel_attention.py `_fused_ca_res_forward` (bodies
// `_ca_res_kernel_single` and `_ca_res_kernel`).
//
// Bound.  At the main-path shape (8, 128, 128, 64), x float32 and r bfloat16, the
// least traffic is one read of x (33.6 MB), one read of r (16.8 MB) and one write of
// out (16.8 MB): 67.1 MB, 20.0 us at 3.35 TB/s.  Bytes bound it (three flops per
// element).  This design reads x twice, once to pool and once to scale: 100.7 MB if
// the second read of x missed L2 entirely, 30.1 us.  The 33.6 MB map fits in the
// 50 MB L2 only in part while r and out stream through it, so part of the second read
// comes from device memory.
//
// Design.  Pass 3 moves one 16-byte x vector and the matching r/out vectors (8 bytes
// for bfloat16) per thread when C is a multiple of the vector width and every pointer
// is aligned, one element per thread otherwise.  The multiply and the add round
// separately (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain version
// does.  No atomics, so repeated runs are bit-identical.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOnchipChunks = 4;  // bulk copies (and mbarriers) per slab

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC elements of T moved as one load or store (16 bytes when vectorised).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Grid (S, N, lane chunks).  A block covers pixels [s*slab_len, (s+1)*slab_len) of
// image n and up to blockDim.x lanes (VEC channels each) of the channel axis; its
// threads form `rows` rows of `chunk_lanes` lanes that stride over the slab's pixels.
template <typename T, int VEC>
__global__ void ca_pool_partial(const T* __restrict__ x, float* __restrict__ partial,
                                int64_t hw, int c, int slabs, int64_t slab_len) {
  extern __shared__ float red[];  // [rows][chunk_lanes * VEC]
  const int lanes = c / VEC;
  const int chunk_lanes = min(lanes, (int)blockDim.x);
  const int rows = blockDim.x / chunk_lanes;
  const int width = chunk_lanes * VEC;
  const int lane0 = blockIdx.z * chunk_lanes;
  const int t = threadIdx.x;
  const int row = t / chunk_lanes;
  const int lane = lane0 + t % chunk_lanes;
  const int64_t n = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * slab_len;
  const int64_t p1 = min(hw, p0 + slab_len);

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  if (row < rows && lane < lanes) {
    const Pack<T, VEC>* img = reinterpret_cast<const Pack<T, VEC>*>(x + n * hw * c);
    for (int64_t p = p0 + row; p < p1; p += rows) {
      const Pack<T, VEC> pk = img[p * lanes + lane];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += to_float(pk.v[v]);
    }
  }
  if (row < rows) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[row * width + (t % chunk_lanes) * VEC + v] = acc[v];
  }
  __syncthreads();
  for (int j = t; j < width; j += blockDim.x) {
    const int ch = lane0 * VEC + j;
    if (ch < c) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += red[r * width + j];
      partial[(n * slabs + blockIdx.x) * c + ch] = s;
    }
  }
}

// Grid (N).  pooled = sum of the S partials / (H*W); att = sigmoid(relu(pooled @ w1
// + b1) @ w2 + b2).  w1[ch, j] is at w1[ch * w1_sc + j * w1_sj], w2[j, ch] at
// w2[j * w2_sj + ch * w2_sc], so transposed views need no copy.  `parts` threads share
// each channel's slab sum (a fixed split and a fixed order of the final add).  Shared
// memory holds pooled (C), hidden (Cr) and the per-part sums (C * parts).  The block
// size is a multiple of 32 (one warp per hidden unit at a time).
__global__ void ca_excite(const float* __restrict__ partial, const float* __restrict__ w1,
                          const float* __restrict__ b1, const float* __restrict__ w2,
                          const float* __restrict__ b2, float* __restrict__ att,
                          int slabs, int c, int cr, float hw, int64_t w1_sc, int64_t w1_sj,
                          int64_t w2_sj, int64_t w2_sc, int parts) {
  extern __shared__ float sh[];
  float* pooled = sh;
  float* hidden = sh + c;
  float* part_sum = hidden + cr;
  const int64_t n = blockIdx.x;
  for (int idx = threadIdx.x; idx < c * parts; idx += blockDim.x) {
    const int ch = idx % c;
    const int part = idx / c;
    float s = 0.f;
    for (int k = part; k < slabs; k += parts) s += partial[(n * slabs + k) * c + ch];
    part_sum[idx] = s;
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s = 0.f;
    for (int part = 0; part < parts; ++part) s += part_sum[part * c + ch];
    pooled[ch] = s / hw;
  }
  __syncthreads();
  // one warp per hidden unit: lanes split the channels, a fixed shuffle tree adds up
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < cr; j += blockDim.x / 32) {
    float h = 0.f;
    for (int ch = lane; ch < c; ch += 32) h += pooled[ch] * w1[ch * w1_sc + j * w1_sj];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) h += __shfl_down_sync(0xffffffffu, h, off);
    if (lane == 0) hidden[j] = fmaxf(h + b1[j], 0.f);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f;
    for (int j = 0; j < cr; ++j) a += hidden[j] * w2[j * w2_sj + ch * w2_sc];
    att[n * c + ch] = 1.f / (1.f + expf(-(a + b2[ch])));
  }
}

// Grid-stride over the map's VEC-element vectors: out = x * T(att[n, c]).
template <typename T, int VEC>
__global__ void ca_scale(const T* __restrict__ x, const float* __restrict__ att,
                         T* __restrict__ out, int64_t total_vecs, int64_t hw, int c) {
  const int lanes = c / VEC;
  const Pack<T, VEC>* src = reinterpret_cast<const Pack<T, VEC>*>(x);
  Pack<T, VEC>* dst = reinterpret_cast<Pack<T, VEC>*>(out);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total_vecs;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t pix = i / lanes;
    const int lane = (int)(i - pix * lanes);
    const float* a = att + (pix / hw) * c + lane * VEC;
    Pack<T, VEC> pk = src[i];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      pk.v[v] = from_float<T>(to_float(pk.v[v]) * to_float(from_float<T>(a[v])));
    dst[i] = pk;
  }
}

// Grid-stride over the map's VEC-element vectors: out = TR(x * att[n, c] + r), the
// product and the sum each rounded to float32 on their own.
template <typename TX, typename TR, int VEC>
__global__ void ca_res_scale(const TX* __restrict__ x, const TR* __restrict__ r,
                             const float* __restrict__ att, TR* __restrict__ out,
                             int64_t total_vecs, int64_t hw, int c) {
  const int lanes = c / VEC;
  const Pack<TX, VEC>* xs = reinterpret_cast<const Pack<TX, VEC>*>(x);
  const Pack<TR, VEC>* rs = reinterpret_cast<const Pack<TR, VEC>*>(r);
  Pack<TR, VEC>* dst = reinterpret_cast<Pack<TR, VEC>*>(out);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total_vecs;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t pix = i / lanes;
    const int lane = (int)(i - pix * lanes);
    const float* a = att + (pix / hw) * c + lane * VEC;
    const Pack<TX, VEC> px = xs[i];
    const Pack<TR, VEC> pr = rs[i];
    Pack<TR, VEC> po;
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      po.v[v] = from_float<TR>(__fadd_rn(__fmul_rn(to_float(px.v[v]), a[v]),
                                         to_float(pr.v[v])));
    dst[i] = po;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// Thread 0's one arrival, announcing `bytes` of transactions to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the barrier's first phase (parity 0) to complete.
__device__ __forceinline__ void mbar_wait_first(uint64_t* bar) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr)
        : "memory");
  }
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory bytes of ca_onchip: the slab, then the float scratch, then the
// mbarriers.  onchip_smem_bytes in ops/channel_attention.py computes the same.
__host__ __device__ inline int64_t onchip_float_offset(int64_t slab_len, int c, int itemsize) {
  return slab_len * c * itemsize;
}
__host__ __device__ inline int onchip_parts(int c) {
  return c < kThreads ? kThreads / c : 1;
}
__host__ __device__ inline int64_t onchip_floats(int c, int cr, int vec) {
  const int rows = kThreads / (c / vec);
  // red, w1 (as Cr x C), w2, b1, b2, part_sum, pooled, hidden, att
  return (int64_t)rows * c + 2 * c * cr + cr + c + c * onchip_parts(c) + c + cr + c;
}
__host__ __device__ inline int64_t onchip_barrier_offset(int64_t slab_len, int c, int cr,
                                                         int itemsize) {
  const int64_t floats_end = onchip_float_offset(slab_len, c, itemsize) +
                             4 * onchip_floats(c, cr, 16 / itemsize);
  return (floats_end + 15) / 16 * 16;
}
__host__ inline int64_t onchip_smem_bytes(int64_t slab_len, int c, int cr, int itemsize) {
  return onchip_barrier_offset(slab_len, c, cr, itemsize) + 8 * kOnchipChunks;
}

// Grid (S, N), kThreads threads, launched cooperatively (path 1 of the note above).
// Block (s, n) owns pixels [s*slab_len, min(hw, (s+1)*slab_len)) of image n; its
// threads form `rows` rows of C/VEC lanes (VEC channels each) that stride over the
// slab's pixels, so each thread keeps one lane's pool and attention in registers.
// The plan guarantees C/VEC <= kThreads and a non-empty slab for every block.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ca_onchip(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, float* __restrict__ partial, int64_t hw, int c,
              int cr, int64_t slab_len, int64_t w1_sc, int64_t w1_sj, int64_t w2_sj,
              int64_t w2_sc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int slabs = gridDim.x;
  const int lanes = c / VEC;
  const int rows = kThreads / lanes;
  const int parts = onchip_parts(c);
  const int t = threadIdx.x;
  const int row = t / lanes, lane = t % lanes;
  const int64_t n = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * slab_len;
  const int64_t len = min(hw - p0, slab_len);
  const int64_t chunk_len = (len + kOnchipChunks - 1) / kOnchipChunks;

  Pack<T, VEC>* slab = reinterpret_cast<Pack<T, VEC>*>(smem);
  float* red = reinterpret_cast<float*>(smem + onchip_float_offset(slab_len, c, sizeof(T)));
  float* w1s = red + rows * c;  // [j * c + ch]
  float* w2s = w1s + c * cr;    // [j * c + ch]
  float* b1s = w2s + cr * c;
  float* b2s = b1s + cr;
  float* part_sum = b2s + c;  // [part * c + ch]
  float* pooled = part_sum + c * parts;
  float* hidden = pooled + c;
  float* att = hidden + cr;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + onchip_barrier_offset(slab_len, c, cr, sizeof(T)));

  // a. bulk copies of the slab, one mbarrier per chunk
  if (t == 0) {
    for (int k = 0; k < kOnchipChunks; ++k) mbar_init(&bars[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(x + (n * hw + p0) * c);
    const int64_t pixel_bytes = (int64_t)c * sizeof(T);
    for (int k = 0; k < kOnchipChunks; ++k) {
      const int64_t a = k * chunk_len, b = min(len, a + chunk_len);
      if (a >= b) break;
      const uint32_t bytes = (uint32_t)((b - a) * pixel_bytes);
      mbar_expect_tx(&bars[k], bytes);
      bulk_load(smem + a * pixel_bytes, src + a * pixel_bytes, bytes, &bars[k]);
    }
  }
  for (int i = t; i < c * cr; i += kThreads) {
    const int j = i / c, ch = i % c;
    w1s[i] = w1[ch * w1_sc + j * w1_sj];
    w2s[i] = w2[j * w2_sj + ch * w2_sc];
  }
  for (int i = t; i < cr; i += kThreads) b1s[i] = b1[i];
  for (int i = t; i < c; i += kThreads) b2s[i] = b2[i];

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  for (int k = 0; k < kOnchipChunks; ++k) {
    const int64_t a = k * chunk_len, b = min(len, a + chunk_len);
    if (a >= b) break;
    mbar_wait_first(&bars[k]);
    if (row < rows) {
      for (int64_t p = a + row; p < b; p += rows) {
        const Pack<T, VEC> pk = slab[p * lanes + lane];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += to_float(pk.v[v]);
      }
    }
  }

  // b. the block's per-channel sum: rows -> `parts` strided sums -> one, in order
  if (row < rows) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[row * c + lane * VEC + v] = acc[v];
  }
  __syncthreads();
  const int row_parts = min(parts, rows);
  for (int i = t; i < c * row_parts; i += kThreads) {
    const int ch = i % c, part = i / c;
    float s = 0.f;
    for (int r = part; r < rows; r += row_parts) s += red[r * c + ch];
    part_sum[i] = s;
  }
  __syncthreads();
  for (int ch = t; ch < c; ch += kThreads) {
    float s = 0.f;
    for (int part = 0; part < row_parts; ++part) s += part_sum[part * c + ch];
    partial[(n * slabs + blockIdx.x) * c + ch] = s;
  }
  cooperative_groups::this_grid().sync();

  // c. image n's pool from the S partials (read past L1), then the excite
  const int slab_parts = min(parts, slabs);
  for (int i = t; i < c * slab_parts; i += kThreads) {
    const int ch = i % c, part = i / c;
    float s = 0.f;
    for (int k = part; k < slabs; k += slab_parts)
      s += __ldcg(&partial[(n * slabs + k) * c + ch]);
    part_sum[i] = s;
  }
  __syncthreads();
  for (int ch = t; ch < c; ch += kThreads) {
    float s = 0.f;
    for (int part = 0; part < slab_parts; ++part) s += part_sum[part * c + ch];
    pooled[ch] = s / (float)hw;
  }
  __syncthreads();
  const int warp = t / 32, wl = t % 32;
  for (int j = warp; j < cr; j += kThreads / 32) {
    float h = 0.f;
    for (int ch = wl; ch < c; ch += 32) h += pooled[ch] * w1s[j * c + ch];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) h += __shfl_down_sync(0xffffffffu, h, off);
    if (wl == 0) hidden[j] = fmaxf(h + b1s[j], 0.f);
  }
  __syncthreads();
  for (int ch = t; ch < c; ch += kThreads) {
    float a = 0.f;
    for (int j = 0; j < cr; ++j) a += hidden[j] * w2s[j * c + ch];
    att[ch] = 1.f / (1.f + expf(-(a + b2s[ch])));
  }
  __syncthreads();

  // d. out = x * T(att) from shared memory, 16-byte stores
  if (row < rows) {
    float scale[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) scale[v] = to_float(from_float<T>(att[lane * VEC + v]));
    Pack<T, VEC>* dst = reinterpret_cast<Pack<T, VEC>*>(out + (n * hw + p0) * c);
    for (int64_t p = row; p < len; p += rows) {
      Pack<T, VEC> pk = slab[p * lanes + lane];
#pragma unroll
      for (int v = 0; v < VEC; ++v) pk.v[v] = from_float<T>(to_float(pk.v[v]) * scale[v]);
      dst[p * lanes + lane] = pk;
    }
  }
}

// Passes 1 and 2: att (N, C) float32 from x.
template <typename T, int VEC>
cudaError_t launch_pool_excite(const T* xt, const float* w1, const float* b1,
                               const float* w2, const float* b2, float* partial,
                               float* att, int64_t n, int64_t hw, int c, int cr,
                               const int64_t* w_strides, int slabs, cudaStream_t stream) {
  const int lanes = c / VEC;
  const int chunk_lanes = lanes < kThreads ? lanes : kThreads;
  const int rows = kThreads / chunk_lanes;
  const int chunks = (lanes + chunk_lanes - 1) / chunk_lanes;
  const int64_t slab_len = (hw + slabs - 1) / slabs;
  const size_t red_bytes = sizeof(float) * rows * chunk_lanes * VEC;
  ca_pool_partial<T, VEC><<<dim3(slabs, (unsigned)n, chunks), kThreads, red_bytes, stream>>>(
      xt, partial, hw, c, slabs, slab_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int parts = c < kThreads ? (slabs < kThreads / c ? slabs : kThreads / c) : 1;
  ca_excite<<<(unsigned)n, kThreads, sizeof(float) * (c + cr + c * parts), stream>>>(
      partial, w1, b1, w2, b2, att, slabs, c, cr, (float)hw, w_strides[0], w_strides[1],
      w_strides[2], w_strides[3], parts);
  return cudaGetLastError();
}

// Blocks for a grid-stride pass over total_vecs vectors: at most 16 per SM.
unsigned scale_blocks(int64_t total_vecs, int sm_count) {
  int64_t blocks = (total_vecs + kThreads - 1) / kThreads;
  const int64_t max_blocks = (int64_t)sm_count * 16;
  return (unsigned)(blocks > max_blocks ? max_blocks : blocks);
}

template <typename TX, typename TR, int VEC>
cudaError_t launch_res(const void* x, const void* r, void* out, const float* w1,
                       const float* b1, const float* w2, const float* b2, float* partial,
                       float* att, int64_t n, int64_t hw, int c, int cr,
                       const int64_t* w_strides, int slabs, int sm_count,
                       cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  cudaError_t err = launch_pool_excite<TX, VEC>(xt, w1, b1, w2, b2, partial, att, n, hw, c,
                                                cr, w_strides, slabs, stream);
  if (err != cudaSuccess) return err;
  const int64_t total_vecs = n * hw * (c / VEC);
  ca_res_scale<TX, TR, VEC><<<scale_blocks(total_vecs, sm_count), kThreads, 0, stream>>>(
      xt, static_cast<const TR*>(r), att, static_cast<TR*>(out), total_vecs, hw, c);
  return cudaGetLastError();
}

template <typename TX, int VEC>
cudaError_t dispatch_res(int r_dtype, const void* x, const void* r, void* out,
                         const float* w1, const float* b1, const float* w2, const float* b2,
                         float* partial, float* att, int64_t n, int64_t hw, int c, int cr,
                         const int64_t* ws, int slabs, int sm_count, cudaStream_t s) {
  if (r_dtype == 0)
    return launch_res<TX, float, VEC>(x, r, out, w1, b1, w2, b2, partial, att, n, hw, c, cr,
                                      ws, slabs, sm_count, s);
  if (r_dtype == 1)
    return launch_res<TX, __nv_bfloat16, VEC>(x, r, out, w1, b1, w2, b2, partial, att, n, hw,
                                              c, cr, ws, slabs, sm_count, s);
  return cudaErrorInvalidValue;
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* out, const float* w1, const float* b1,
                   const float* w2, const float* b2, float* partial, float* att,
                   int64_t n, int64_t hw, int c, int cr, const int64_t* w_strides,
                   int slabs, int sm_count, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  cudaError_t err = launch_pool_excite<T, VEC>(xt, w1, b1, w2, b2, partial, att, n, hw, c,
                                               cr, w_strides, slabs, stream);
  if (err != cudaSuccess) return err;
  const int64_t total_vecs = n * hw * (c / VEC);
  ca_scale<T, VEC><<<scale_blocks(total_vecs, sm_count), kThreads, 0, stream>>>(
      xt, att, static_cast<T*>(out), total_vecs, hw, c);
  return cudaGetLastError();
}

// One cooperative launch of ca_onchip over grid (slabs, n).  smem_bytes is the
// caller's plan; it must equal this file's layout, or nothing launches.
template <typename T, int VEC>
cudaError_t launch_onchip(const void* x, void* out, const float* w1, const float* b1,
                          const float* w2, const float* b2, float* partial, int64_t n,
                          int64_t hw, int c, int cr, const int64_t* w_strides, int slabs,
                          int64_t slab_len, int64_t smem_bytes, cudaStream_t stream) {
  if (c % VEC != 0 || c / VEC > kThreads ||
      smem_bytes != onchip_smem_bytes(slab_len, c, cr, sizeof(T)))
    return cudaErrorInvalidValue;
  // the opt-in limit above 48 KB, raised once per device for this instance
  static int64_t allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem_bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(ca_onchip<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem_bytes;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)slabs, (unsigned)n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ca_onchip<T, VEC>, static_cast<const T*>(x),
                            static_cast<T*>(out), w1, b1, w2, b2, partial, hw, c, cr, slab_len,
                            w_strides[0], w_strides[1], w_strides[2], w_strides[3]);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  vectorized: 1 for 16-byte vectors (the caller checks
// that C * itemsize % 16 == 0 and that x is 16-byte aligned), 0 for one element per
// thread.  w1 (C, Cr) and w2 (Cr, C) are strided (element strides w1 row, w1 col,
// w2 row, w2 col); b1 and b2 are contiguous.  partial holds N * slabs * C floats, att
// N * C floats.  Returns the CUDA error code of the first failed launch, 0 when all
// three launched.
int sisr_ca_forward(const void* x, void* out, const float* w1, const float* b1,
                    const float* w2, const float* b2, float* partial, float* att,
                    long long n, long long hw, int c, int cr, long long w1_s0,
                    long long w1_s1, long long w2_s0, long long w2_s1, int dtype,
                    int vectorized, int slabs, int sm_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t ws[4] = {w1_s0, w1_s1, w2_s0, w2_s1};
  if (dtype == 0) {
    return vectorized ? launch<float, 4>(x, out, w1, b1, w2, b2, partial, att, n, hw, c, cr,
                                         ws, slabs, sm_count, s)
                      : launch<float, 1>(x, out, w1, b1, w2, b2, partial, att, n, hw, c, cr,
                                         ws, slabs, sm_count, s);
  }
  if (dtype == 1) {
    return vectorized ? launch<__nv_bfloat16, 8>(x, out, w1, b1, w2, b2, partial, att, n, hw,
                                                 c, cr, ws, slabs, sm_count, s)
                      : launch<__nv_bfloat16, 1>(x, out, w1, b1, w2, b2, partial, att, n, hw,
                                                 c, cr, ws, slabs, sm_count, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The on-chip path: one cooperative launch of `slabs` blocks per image, each owning
// slab_len pixels (the last one the rest), with smem_bytes of dynamic shared memory.
// The caller checks that C * itemsize % 16 == 0, that x is 16-byte aligned, that
// every block has pixels and that all n * slabs blocks fit on the card at once.
// dtype, the weights and their strides are those of sisr_ca_forward; partial holds
// N * slabs * C floats.  Returns the CUDA error code of the launch, 0 when it
// launched.
int sisr_ca_onchip_forward(const void* x, void* out, const float* w1, const float* b1,
                           const float* w2, const float* b2, float* partial, long long n,
                           long long hw, int c, int cr, long long w1_s0, long long w1_s1,
                           long long w2_s0, long long w2_s1, int dtype, int slabs,
                           long long slab_len, long long smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t ws[4] = {w1_s0, w1_s1, w2_s0, w2_s1};
  if (dtype == 0)
    return launch_onchip<float, 4>(x, out, w1, b1, w2, b2, partial, n, hw, c, cr, ws, slabs,
                                   slab_len, smem_bytes, s);
  if (dtype == 1)
    return launch_onchip<__nv_bfloat16, 8>(x, out, w1, b1, w2, b2, partial, n, hw, c, cr, ws,
                                           slabs, slab_len, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// The CA + residual block tail.  x_dtype and r_dtype: 0 float32, 1 bfloat16; out has
// r's type.  vectorized: 1 for VEC = 16 / sizeof(x) elements per thread (the caller
// checks that C is a multiple of VEC, that x is 16-byte aligned and that r and out
// are aligned to VEC elements of r's type), 0 for one element per thread.  The other
// arguments are those of sisr_ca_forward.
int sisr_ca_res_forward(const void* x, const void* r, void* out, const float* w1,
                        const float* b1, const float* w2, const float* b2, float* partial,
                        float* att, long long n, long long hw, int c, int cr, long long w1_s0,
                        long long w1_s1, long long w2_s0, long long w2_s1, int x_dtype,
                        int r_dtype, int vectorized, int slabs, int sm_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t ws[4] = {w1_s0, w1_s1, w2_s0, w2_s1};
  if (x_dtype == 0) {
    return vectorized ? dispatch_res<float, 4>(r_dtype, x, r, out, w1, b1, w2, b2, partial,
                                               att, n, hw, c, cr, ws, slabs, sm_count, s)
                      : dispatch_res<float, 1>(r_dtype, x, r, out, w1, b1, w2, b2, partial,
                                               att, n, hw, c, cr, ws, slabs, sm_count, s);
  }
  if (x_dtype == 1) {
    return vectorized
               ? dispatch_res<__nv_bfloat16, 8>(r_dtype, x, r, out, w1, b1, w2, b2, partial,
                                                att, n, hw, c, cr, ws, slabs, sm_count, s)
               : dispatch_res<__nv_bfloat16, 1>(r_dtype, x, r, out, w1, b1, w2, b2, partial,
                                                att, n, hw, c, cr, ws, slabs, sm_count, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* sisr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
