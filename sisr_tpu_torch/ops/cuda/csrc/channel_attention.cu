// Squeeze-and-excite channel attention for Hopper (sm_90a), plain C interface.
//
//   out = x * sigmoid(relu(mean_hw(x) @ w1 + b1) @ w2 + b2)
//
// x is an (N, H, W, C) map, float32 or bfloat16, contiguous (a channels_last NCHW
// activation viewed as NHWC).  w1 (C, Cr), b1 (Cr), w2 (Cr, C), b2 (C) are float32.
// The pool and the excite run in float32; the scale multiplies x by the attention
// rounded to x's type, as `x * att.astype(x.dtype)` does.
//
// Replaces sisr_tpu/ops/pallas/channel_attention.py `_fused_ca_forward`
// (bodies `_ca_kernel_single` and `_ca_kernel`, excite `_excite`).
//
// Bound.  The work is two flops per element and one read plus one write of the map,
// so bytes bound it: at the main-path shape (8, 128, 128, 64) bf16 the least traffic
// is 2 x 16.8 MB = 33.6 MB, about 10 us at 3.35 TB/s.
//
// Design.  The TPU kernel carries the spatial sum across a sequential grid and then
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
// The map is read twice.  At the main-path shape it is 16.8 MB, well inside the
// 50 MB L2, so the second read mostly hits L2.  Folding the excite into pass 3, or
// one cooperative pass that holds the map in L2, is left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T, int VEC>
cudaError_t launch(const void* x, void* out, const float* w1, const float* b1,
                   const float* w2, const float* b2, float* partial, float* att,
                   int64_t n, int64_t hw, int c, int cr, const int64_t* w_strides,
                   int slabs, int sm_count, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
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
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t total_vecs = n * hw * lanes;
  int64_t blocks = (total_vecs + kThreads - 1) / kThreads;
  const int64_t max_blocks = (int64_t)sm_count * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  ca_scale<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(xt, att, static_cast<T*>(out),
                                                              total_vecs, hw, c);
  return cudaGetLastError();
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

const char* sisr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
