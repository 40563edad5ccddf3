// Squeeze-and-excite channel attention for Hopper (sm_90a), plain C interface.
//
//   out = x * sigmoid(relu(mean_hw(x) @ w1 + b1) @ w2 + b2)
//
// x is an (N, H, W, C) map, float32 or bfloat16, contiguous (a channels_last NCHW
// activation viewed as NHWC).  w1 (C, Cr), b1 (Cr), w2 (Cr, C), b2 (C) are float32.
// The pool and the excite run in float32; the scale multiplies x by the attention
// rounded to x's type, as `x * att.astype(x.dtype)` does.
//
// Two optional per-image inputs carry the meta-attention layers of Q-RCAN
// (sisr_tpu/models/q_layers.py QCALayer, ParaCALayer), which sisr_tpu computes in
// plain jnp:
//   meta (N, M) float32 is concatenated onto the pooled vector before the first
//     product, so w1 has C + M rows: hidden = relu([pooled | meta] @ w1 + b1)
//     (QCALayer's max_concat style);
//   gate (N, C) float32 multiplies the attention after the sigmoid:
//     out = x * T(att * gate) (QCALayer's modulate style, and the QRCAB's q_node,
//     whose sigmoid depends on the metadata alone).
// With neither (meta null and M = 0, gate null) the work is the plain CA's, bit for
// bit.  Both paths below take them: the excite stages meta[n] beside pooled and the
// M extra rows of w1 beside the other weights, and multiplies att by gate[n].  The
// bound grows by N * (M + C) * 4 bytes, 2.8 KB at the main shape.
//
// Bucketed eval (sisr_tpu/ops/masking.py) zero-pads a batch of images of true size
// (vh, vw) to a bucket (H, W).  Every CA entry takes the map's width and that valid
// extent: the pool sums only the pixels whose row is under vh and column under vw and
// divides by vh * vw (masked_global_mean); the scale still multiplies every pixel, as
// `x * y` does in sisr_tpu's CALayer.  A pixel's row and column come from its flat
// index, walked without a division per pixel (Extent, ExtentWalk below), and tested only
// when the extent is smaller than the map, so the full extent is the plain call bit for
// bit.  The CA + residual tail takes
// no extent: sisr_tpu's int8 program runs unpadded.
//
// Replaces sisr_tpu/ops/pallas/channel_attention.py `_fused_ca_forward` (excite
// `_excite`), by four paths; the wrapper's plan (`ca_plan` in ops/channel_attention.py)
// picks one from the shape and the card alone: on chip where the whole batch fits in
// the SMs' shared memory at once, else in rounds where one round's images fit, else
// streaming one image a round where not even that fits, else (pixels that are not
// whole 16-byte units, a misaligned x) three passes.
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
// Path 2, in rounds (entry sisr_ca_rounds_forward with no r, kernel ca_rounds): replaces
// the tiled body `_ca_kernel` where the batch does not fit on chip at once but one
// round of images does: the float32 map of int8 Q-RCAN's QRCAB tail and of the f32
// eval, (8, 128, 128, 64), 33.6 MB against the SMs' 30.7 MB.  It is the CA +
// residual's path 1 below without r: the batch streams through shared memory in
// rounds (2 of 4 images at that shape, 33 blocks of 497 pixels, 127 KB slabs), one
// grid barrier a round, and out = x * T(att * gate) is written from the slab.  The map
// leaves device memory once and returns once, as on path 1.
//
// Path 3, streaming (entry sisr_ca_stream_forward with no r, kernel ca_stream): replaces
// the tiled body `_ca_kernel` for maps of which not even one image fits the SMs' shared
// memory: a DIV2K-size f32 map, (1, 339, 510, 64) is 44.3 MB against 30.7 MB.  It is
// the CA + residual's path 2 below without r, and moves the bound's own bytes plus a
// second read of each slab's tail from L2.
//
// Path 4, three passes (entry sisr_ca_forward): replaces the tiled body `_ca_kernel`
// for maps whose pixels are not whole 16-byte units or whose x is misaligned, which
// no bulk copy takes.  The TPU kernel carries the spatial sum
// across a sequential grid and then revisits the tiles; Hopper blocks run in parallel
// in no order, so this is three launches on one stream:
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
// The int8 RCAB block tail, entries sisr_ca_rounds_forward (with r),
// sisr_ca_stream_forward (with r) and sisr_ca_res_forward:
//
//   out = TR(float(x) * att(x) + float(r))
//
// with att computed as above (pool and excite in float32) and multiplied in float32,
// not rounded to x's type.  x is float32 or bfloat16 (the main path passes the
// float32 dequantised conv output), r the residual carry (float32 or bfloat16) of
// x's shape, and out has r's type.  The multiply and the add round separately
// (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain version does, so the
// two differ only by the pool's summation order.  Replaces
// sisr_tpu/ops/pallas/channel_attention.py `_fused_ca_res_forward`, by three paths;
// the wrapper's plan (`ca_res_plan`) picks one from the shape and the card alone.
//
// Every path also takes the CA's meta and gate, and a cast-first rounding for the int8
// QRCAB tail of Q-RCAN, whose branch sisr_tpu casts to the carry before it adds
// (sisr_tpu/ops/quantization.py `qrcan_int8_forward_static`):
//
//   out = TR(TR(TX(x * TX(att * gate))) + r)
//
// the CA op's output rounded to r's type, then added in r's type: bit for bit the
// plain `fused_channel_attention(x, ...).to(r.dtype) + r` up to the pool's order.
//
// Bound.  At the main-path shape (8, 128, 128, 64), x float32 and r bfloat16, the
// least traffic is one read of x (33.6 MB), one read of r (16.8 MB) and one write of
// out (16.8 MB): 67.1 MB, 20.0 us at 3.35 TB/s.  Bytes bound it (three flops per
// element).
//
// Path 1, on chip in rounds (entry sisr_ca_rounds_forward, kernel ca_rounds, the CA's
// path 2 with r): replaces the single-block body `_ca_res_kernel_single`, which holds
// x and r in VMEM and reads each once.  Unlike the CA's bf16 map, the float32 x of
// the whole batch (33.6 MB) does not fit the SMs' shared memory together (132 x
// 227 KB = 30.7 MB), and one image (4.2 MB) is more than a 16-block cluster holds, so
// the batch streams through shared memory in R rounds of I images, with B blocks per
// image (I * B <= SMs, one block per SM, all resident: one cooperative launch).  A
// block holds its slab of x and its slab of r.  At the main shape R = 2, I = 4,
// B = 33: slabs of 497 pixels, 127 KB of x and 64 KB of r.  In round k block (s, i)
// owns slab s of image k*I + i:
//   a. its slab of x has come in by bulk async copies (cp.async.bulk) in kResChunks
//      chunks, each on its own mbarrier, whose phase parity is the round's; the block
//      pools each chunk in float32 as it lands and writes its per-channel sum to
//      partial (N, B, C) with plain stores.  Meanwhile the next round's slab of x is
//      prefetched into L2;
//   b. one grid barrier per round, split: between the block's arrival and its wait,
//      its slab of r starts coming in (r does not wait for att), so the barrier's own
//      traffic is not queued behind it.  Then every block of the image sums its B
//      partials in a fixed order (kResLoads loads in flight a thread) and runs the
//      excite itself, so no second barrier is needed;
//   c. chunk by chunk, the block reads x and r from shared memory and writes out with
//      vector stores; once every thread is done with chunk j, thread 0 bulk-copies
//      round k+1's chunk j of x into the same bytes, so the next round's x streams in
//      while this round's out streams out.
// x is read once, r once and out written once: the bound's own 67.1 MB.  Blocks with
// no image in a ragged last round still meet the barrier.  Needs the pixels of x and
// of r to be whole 16-byte units, x and r 16-byte aligned (bulk copies) and out
// aligned to one vector of r's type.  Why r sits in shared memory as well, and why it
// is sent for between the barrier's arrival and its wait: read from device memory in
// the scale, every chunk waited on memory latency (54 us a call at the main shape on
// an H100 SXM); issued before the arrival, its traffic queued ahead of the barrier's
// own.  The partial sums are loaded together because one L2 round trip after another
// was most of the excite's time.  Meta and gate change with the image, hence with the
// round: each round stages its image's M meta values beside pooled while the slab is
// pooled, and the excite reads that image's gate.  Without r (the CA's path 2) the
// slab of r takes no bytes and its mbarriers are not armed.  A build with
// -DSISR_CA_RES_TIMELINE stamps the phases (res_stamp below; tools/ca_res_timeline.py
// reads them).
//
// Path 2, streaming (entry sisr_ca_stream_forward, kernel ca_stream, the CA's path 3
// with r): replaces the tiled body `_ca_res_kernel` where not even one image's slabs
// of x and r fit a round: the int8 RCAB tail of a DIV2K-size image, x (1, 339, 510,
// 64) f32 (44.3 MB) with a bf16 carry, 503 KB a slab on 132 blocks.  Clusters and
// distributed shared memory add no capacity (132 x 227 KB is all there is), so the
// slab is split: one block per SM, all resident (one cooperative launch), one image a
// round, block s owning slab s of ceil(hw / SMs) pixels (1310 at that shape), whose
// first head_len pixels (its head, as many as fit beside the scratch and a ring of r)
// sit in shared memory and whose rest (its tail) does not.  In round n:
//   a. the head comes in by bulk copies in kStreamChunks chunks (evict_first: read
//      once) and is pooled as each lands; the tail was sent for into L2 in one bulk
//      prefetch under evict_last, and is pooled after the head with 16-byte loads
//      (kStreamLoads at once) under the same policy, so it is the freshest data in L2
//      at the barrier.  The order is fixed (head, then tail), so runs repeat bit for
//      bit, and the extent's walk restarts where the tail begins;
//   b. one grid barrier, split as in ca_rounds: between the arrival and the wait the
//      first pieces of r start into their ring (kStreamSlots slots of kStreamSlotBytes,
//      bulk copies under evict_first, each slot on its own mbarrier whose phase is
//      counted per use, not per round); then every block runs the image's excite;
//   c. the scale, tail first while L2 still holds it (16-byte loads under
//      evict_first, its last use), then the head from shared memory; r through the
//      ring, each slot refilled once every thread is done with it; out by vector
//      stores under evict_first, so neither r nor out pushes the tail out of L2.
// x leaves device memory once, r once and out once: the bound's 88.5 MB at that
// shape (0.0264 ms at 3.35 TB/s), plus the tail's second read (16.8 MB at 812-pixel
// heads with the ring; 14.7 MB at 876 without r), from L2 where it still holds it.
// The ring's two slots, the eight loads at once and the tail-first order are timed
// against four slots, sixteen loads and head first by tools/ca_res_timeline.py
// --variants (PERF.md).  Needs what path 1 needs.  The timeline build stamps its
// phases too: head pooled, tail pooled, past the barrier, excited, tail scaled, head
// scaled.
//
// Path 3, three passes (entry sisr_ca_res_forward): replaces the tiled body
// `_ca_res_kernel`, for pixels that are not whole 16-byte units or a misaligned x or
// r, which no bulk copy takes.  Passes 1 and 2 are
// the CA's ca_pool_partial and ca_excite; pass 3, ca_res_scale, moves one 16-byte x
// vector and the matching r/out vectors per thread when C is a multiple of the
// vector width and every pointer is aligned, one element per thread otherwise.  It
// reads x twice: 100.7 MB at the main shape where the second read misses L2.
// No path uses atomics, so repeated runs are bit-identical.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kOnchipChunks = 4;  // bulk copies (and mbarriers) per slab
constexpr int kResChunks = 2;     // bulk copies of x, and of r, per slab of ca_rounds
constexpr int kResLoads = 16;     // block sums a thread of ca_rounds loads at once
// ca_stream's ring slots, its loads from L2 at once and its order of the scale (each
// slab's tail before its head) are fixed here; a build with -DSISR_CA_STREAM_SLOTS=n,
// -DSISR_CA_STREAM_LOADS=n or -DSISR_CA_STREAM_HEAD_FIRST changes one of them, for
// tools/ca_res_timeline.py --variants to time against this build in turns.
#ifndef SISR_CA_STREAM_SLOTS
#define SISR_CA_STREAM_SLOTS 2
#endif
#ifndef SISR_CA_STREAM_LOADS
#define SISR_CA_STREAM_LOADS 8
#endif
constexpr int kStreamChunks = 4;  // bulk copies (and mbarriers) of a slab's head in ca_stream
constexpr int kStreamSlots = SISR_CA_STREAM_SLOTS;  // slots of ca_stream's ring of r
constexpr int kStreamSlotBytes = 8192;  // bytes of r a slot holds (whole pixels)
// vectors of x a thread of ca_stream loads from L2 at once
constexpr int kStreamLoads = SISR_CA_STREAM_LOADS;
#ifdef SISR_CA_STREAM_HEAD_FIRST
constexpr bool kStreamTailFirst = false;
#else
constexpr bool kStreamTailFirst = true;
#endif

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

// The valid extent of an image of width w that bucketed eval zero-padded (sisr_tpu's
// masked_global_mean): the pool sums only the pixels whose row is under vh and whose
// column is under vw, and divides by count = vh * vw.  With masked 0 (the full extent,
// count = H * W) no pixel is tested, so the pool adds the same elements in the same
// order as without an extent, bit for bit.
struct Extent {
  int64_t w, vh, vw, count;
  int masked;
};

// A thread's walk over the pixels p, p + step, p + 2 * step, ... of one image, saying
// whether each lies inside the extent: the row and column of the first pixel come from
// one division, then each step adds step / w rows and step % w columns and wraps the
// column, so the pool pays no division per pixel.  Under the full extent it does
// nothing.
struct ExtentWalk {
  int64_t row, col, step_rows, step_cols, w, vh, vw;
  bool masked;
  __device__ __forceinline__ ExtentWalk(const Extent& e, int64_t p, int64_t step)
      : row(0), col(0), step_rows(0), step_cols(0), w(e.w), vh(e.vh), vw(e.vw),
        masked(e.masked != 0) {
    if (masked) {
      row = p / w;
      col = p - row * w;
      step_rows = step / w;
      step_cols = step - step_rows * w;
    }
  }
  __device__ __forceinline__ bool inside() const { return !masked || (row < vh && col < vw); }
  __device__ __forceinline__ void next() {
    if (masked) {
      row += step_rows;
      col += step_cols;
      if (col >= w) {
        col -= w;
        ++row;
      }
    }
  }
};

// Grid (S, N, lane chunks).  A block covers pixels [s*slab_len, (s+1)*slab_len) of
// image n and up to blockDim.x lanes (VEC channels each) of the channel axis; its
// threads form `rows` rows of `chunk_lanes` lanes that stride over the slab's pixels
// and pool those inside the valid extent `ext`.
template <typename T, int VEC>
__global__ void ca_pool_partial(const T* __restrict__ x, float* __restrict__ partial,
                                int64_t hw, int c, int slabs, int64_t slab_len, Extent ext) {
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
    ExtentWalk walk(ext, p0 + row, rows);
    for (int64_t p = p0 + row; p < p1; p += rows, walk.next()) {
      if (!walk.inside()) continue;
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

// Grid (N).  pooled = sum of the S partials / count (H*W, or the valid extent's
// pixels); att = sigmoid(relu([pooled |
// meta[n]] @ w1 + b1) @ w2 + b2) * gate[n] (meta and gate optional: null, M = 0).
// w1[ch, j] is at w1[ch * w1_sc + j * w1_sj] (ch < C + M), w2[j, ch] at w2[j * w2_sj +
// ch * w2_sc], so transposed views need no copy.  `parts` threads share each
// channel's slab sum (a fixed split and a fixed order of the final add).  Shared
// memory holds pooled with meta (C + M), hidden (Cr) and the per-part sums
// (C * parts).  The block size is a multiple of 32 (one warp per hidden unit at a
// time).
__global__ void ca_excite(const float* __restrict__ partial, const float* __restrict__ w1,
                          const float* __restrict__ b1, const float* __restrict__ w2,
                          const float* __restrict__ b2, const float* __restrict__ meta,
                          const float* __restrict__ gate, float* __restrict__ att,
                          int slabs, int c, int m, int cr, float count, int64_t w1_sc,
                          int64_t w1_sj, int64_t w2_sj, int64_t w2_sc, int parts) {
  extern __shared__ float sh[];
  float* pooled = sh;
  float* hidden = sh + c + m;
  float* part_sum = hidden + cr;
  const int64_t n = blockIdx.x;
  for (int i = threadIdx.x; i < m; i += blockDim.x) pooled[c + i] = meta[n * m + i];
  // the thread's first gate value goes out now, not after the sigmoid
  const float own_gate = gate && (int)threadIdx.x < c ? gate[n * c + threadIdx.x] : 1.f;
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
    pooled[ch] = s / count;
  }
  __syncthreads();
  // one warp per hidden unit: lanes split the channels, a fixed shuffle tree adds up
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < cr; j += blockDim.x / 32) {
    float h = 0.f;
    for (int ch = lane; ch < c + m; ch += 32) h += pooled[ch] * w1[ch * w1_sc + j * w1_sj];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) h += __shfl_down_sync(0xffffffffu, h, off);
    if (lane == 0) hidden[j] = fmaxf(h + b1[j], 0.f);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f;
    for (int j = 0; j < cr; ++j) a += hidden[j] * w2[j * w2_sj + ch * w2_sc];
    a = 1.f / (1.f + expf(-(a + b2[ch])));
    att[n * c + ch] = gate ? a * (ch == (int)threadIdx.x ? own_gate : gate[n * c + ch]) : a;
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

// What ca_rounds writes: the CA's out = x * T(att) (no r), the plain tail TR(x * att +
// r), or the cast-first tail TR(TR(TX(x * TX(att))) + r).
enum RoundsMode { kNoR = 0, kRes = 1, kResCastFirst = 2 };

// The factor x is multiplied by: the float32 att for the plain tail; att rounded to
// x's type for the CA and the cast-first tail (`x * att.to(x.dtype)`).
template <typename TX, int MODE>
__device__ __forceinline__ float scale_of(float att) {
  return MODE == kRes ? att : to_float(from_float<TX>(att));
}

// One element of the tail from x, its scale_of<TX, MODE> factor and r: the product,
// then for the cast-first tail a round to x's type and to r's, then the sum, each
// rounded on its own (no fused multiply-add).
template <typename TX, typename TR, int MODE>
__device__ __forceinline__ TR res_out(TX x, float scale, TR r) {
  const float prod = __fmul_rn(to_float(x), scale);
  if constexpr (MODE == kResCastFirst) {
    const float branch = to_float(from_float<TR>(to_float(from_float<TX>(prod))));
    return from_float<TR>(__fadd_rn(branch, to_float(r)));
  } else {
    return from_float<TR>(__fadd_rn(prod, to_float(r)));
  }
}

// Grid-stride over the map's VEC-element vectors: out = res_out<TX, TR, MODE>(x,
// att[n, c], r), the plain (kRes) or the cast-first tail.
template <typename TX, typename TR, int VEC, int MODE>
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
      po.v[v] = res_out<TX, TR, MODE>(px.v[v], scale_of<TX, MODE>(a[v]), pr.v[v]);
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

// Wait for the barrier's phase of parity `parity` (0 for its first phase, then 1, 0,
// ...) to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Ask for `bytes` (a multiple of 16, from a 16-byte aligned address) of global memory
// to be brought into L2, without waiting.
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes)
               : "memory");
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

// L2 eviction policies for the cache hints below: a line touched under evict_last
// outlives the lines of normal priority, one under evict_first goes before them.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// bulk_load and prefetch_l2 with an L2 cache policy.
__device__ __forceinline__ void bulk_load_hint(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void prefetch_l2_hint(const void* src, uint32_t bytes,
                                                 uint64_t policy) {
  asm volatile("cp.async.bulk.prefetch.L2.global.L2::cache_hint [%0], %1, %2;\n" ::"l"(src),
               "r"(bytes), "l"(policy)
               : "memory");
}

// One 16-byte vector of global memory under an L2 cache policy.  Only for data that no
// thread writes while the kernel runs (x), so the load may move freely.
template <typename P>
__device__ __forceinline__ P ld_hint(const P* src, uint64_t policy) {
  static_assert(sizeof(P) == 16, "one 16-byte vector");
  uint4 v;
  asm("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(src), "l"(policy));
  P out;
  memcpy(&out, &v, sizeof(P));
  return out;
}

// A vector of 8, 16 or 32 bytes to global memory under an L2 cache policy.
template <typename P>
__device__ __forceinline__ void st_hint(P* dst, const P& v, uint64_t policy) {
  uint32_t w[sizeof(P) / 4];
  memcpy(w, &v, sizeof(P));
  char* d = reinterpret_cast<char*>(dst);
  if constexpr (sizeof(P) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(P) / 16); ++i)
      asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(
                       d + 16 * i),
                   "r"(w[4 * i]), "r"(w[4 * i + 1]), "r"(w[4 * i + 2]), "r"(w[4 * i + 3]),
                   "l"(policy)
                   : "memory");
  } else {
    static_assert(sizeof(P) == 8, "a vector of 8, 16 or 32 bytes");
    asm volatile("st.global.L2::cache_hint.v2.u32 [%0], {%1, %2}, %3;\n" ::"l"(d), "r"(w[0]),
                 "r"(w[1]), "l"(policy)
                 : "memory");
  }
}

// Shared-memory bytes of ca_onchip: the slab, then the float scratch, then the
// mbarriers.  onchip_smem_bytes in ops/channel_attention.py computes the same.
__host__ __device__ inline int64_t onchip_float_offset(int64_t slab_len, int c, int itemsize) {
  return slab_len * c * itemsize;
}
__host__ __device__ inline int onchip_parts(int c) {
  return c < kThreads ? kThreads / c : 1;
}
__host__ __device__ inline int64_t onchip_floats(int c, int m, int cr, int vec) {
  const int rows = kThreads / (c / vec);
  // red, w1 (as Cr x (C + M)), w2, b1, b2, part_sum, pooled with meta, hidden, att
  return (int64_t)rows * c + (2 * c + m) * cr + cr + c + c * onchip_parts(c) + c + m + cr +
         c;
}
__host__ __device__ inline int64_t onchip_barrier_offset(int64_t slab_len, int c, int m,
                                                         int cr, int itemsize) {
  const int64_t floats_end = onchip_float_offset(slab_len, c, itemsize) +
                             4 * onchip_floats(c, m, cr, 16 / itemsize);
  return (floats_end + 15) / 16 * 16;
}
__host__ inline int64_t onchip_smem_bytes(int64_t slab_len, int c, int m, int cr,
                                          int itemsize) {
  return onchip_barrier_offset(slab_len, c, m, cr, itemsize) + 8 * kOnchipChunks;
}

// Shared-memory bytes of ca_rounds: the slab of x, the slab of r (from a 128-byte
// boundary; r_itemsize 0 without r), ca_onchip's float scratch for M meta values, then
// one mbarrier for each chunk of x and one for each chunk of r.  res_onchip_smem_bytes
// in ops/channel_attention.py computes the same.
__host__ __device__ inline int64_t res_r_offset(int64_t slab_len, int c, int x_itemsize) {
  return (slab_len * c * x_itemsize + 127) / 128 * 128;
}
__host__ __device__ inline int64_t res_barrier_offset(int64_t slab_len, int c, int m, int cr,
                                                      int x_itemsize, int r_itemsize) {
  const int64_t floats_end = res_r_offset(slab_len, c, x_itemsize) +
                             slab_len * c * r_itemsize +
                             4 * onchip_floats(c, m, cr, 16 / x_itemsize);
  return (floats_end + 15) / 16 * 16;
}
__host__ inline int64_t res_onchip_smem_bytes(int64_t slab_len, int c, int m, int cr,
                                              int x_itemsize, int r_itemsize) {
  return res_barrier_offset(slab_len, c, m, cr, x_itemsize, r_itemsize) + 8 * 2 * kResChunks;
}

// Shared-memory bytes of ca_stream: the slab's head (head_len pixels of x); from a
// 128-byte boundary the ring of r, kStreamSlots slots of stream_ring_pixels pixels each
// (none without r: r_itemsize 0); ca_onchip's float scratch for M meta values; then one
// mbarrier for each chunk of the head and one for each slot of the ring.
// stream_smem_bytes in ops/channel_attention.py computes the same.
__host__ __device__ inline int64_t stream_ring_pixels(int c, int r_itemsize) {
  if (r_itemsize == 0) return 0;
  const int64_t pixels = kStreamSlotBytes / ((int64_t)c * r_itemsize);
  return pixels > 0 ? pixels : 1;
}
__host__ __device__ inline int64_t stream_ring_offset(int64_t head_len, int c, int x_itemsize) {
  return (head_len * c * x_itemsize + 127) / 128 * 128;
}
__host__ __device__ inline int64_t stream_barrier_offset(int64_t head_len, int c, int m, int cr,
                                                         int x_itemsize, int r_itemsize) {
  const int64_t floats_end = stream_ring_offset(head_len, c, x_itemsize) +
                             kStreamSlots * stream_ring_pixels(c, r_itemsize) * c * r_itemsize +
                             4 * onchip_floats(c, m, cr, 16 / x_itemsize);
  return (floats_end + 15) / 16 * 16;
}
__host__ inline int64_t stream_smem_bytes(int64_t head_len, int c, int m, int cr,
                                          int x_itemsize, int r_itemsize) {
  return stream_barrier_offset(head_len, c, m, cr, x_itemsize, r_itemsize) +
         8 * (kStreamChunks + kStreamSlots);
}

// The float scratch of the on-chip kernels, after the slab, as onchip_floats counts
// it: the block's row sums, the excite's weights ([j * (c + m) + ch] for w1, [j * c +
// ch] for w2), the partial sums ([part * c + ch]), pooled (C) followed by the image's
// meta (M), hidden and att.
struct OnchipScratch {
  float *red, *w1s, *w2s, *b1s, *b2s, *part_sum, *pooled, *hidden, *att;
  __device__ OnchipScratch(float* base, int c, int m, int cr, int rows, int parts)
      : red(base), w1s(red + rows * c), w2s(w1s + (c + m) * cr), b1s(w2s + cr * c),
        b2s(b1s + cr), part_sum(b2s + c), pooled(part_sum + c * parts),
        hidden(pooled + c + m), att(hidden + cr) {}
};

// The excite's weights into shared memory and, given img_meta, the image's M meta
// values after pooled's C (ca_rounds passes null and stages each round's own).
__device__ __forceinline__ void stage_excite_weights(
    const OnchipScratch& s, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ img_meta, int c, int m, int cr, int64_t w1_sc, int64_t w1_sj,
    int64_t w2_sj, int64_t w2_sc, int t) {
  for (int i = t; i < (c + m) * cr; i += kThreads) {
    const int j = i / (c + m), ch = i % (c + m);
    s.w1s[i] = w1[ch * w1_sc + j * w1_sj];
  }
  for (int i = t; i < c * cr; i += kThreads) {
    const int j = i / c, ch = i % c;
    s.w2s[i] = w2[j * w2_sj + ch * w2_sc];
  }
  for (int i = t; i < cr; i += kThreads) s.b1s[i] = b1[i];
  for (int i = t; i < c; i += kThreads) s.b2s[i] = b2[i];
  if (img_meta)
    for (int i = t; i < m; i += kThreads) s.pooled[c + i] = img_meta[i];
}

// The block's per-channel sum of its threads' pools (acc: VEC channels of lane `lane`
// in row `row`) into dst[0, c): rows -> `parts` strided sums -> one, in a fixed order.
template <int VEC>
__device__ __forceinline__ void block_channel_sum(const float (&acc)[VEC],
                                                  const OnchipScratch& s, float* dst, int c,
                                                  int rows, int parts, int row, int lane,
                                                  int t) {
  if (row < rows) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) s.red[row * c + lane * VEC + v] = acc[v];
  }
  __syncthreads();
  const int row_parts = min(parts, rows);
  for (int i = t; i < c * row_parts; i += kThreads) {
    const int ch = i % c, part = i / c;
    float sum = 0.f;
    for (int r = part; r < rows; r += row_parts) sum += s.red[r * c + ch];
    s.part_sum[i] = sum;
  }
  __syncthreads();
  for (int ch = t; ch < c; ch += kThreads) {
    float sum = 0.f;
    for (int part = 0; part < row_parts; ++part) sum += s.part_sum[part * c + ch];
    dst[ch] = sum;
  }
}

// s.att of one image from its `slabs` block sums img_partial[k * c + ch] (read past
// L1: other blocks wrote them before the grid barrier), added in a fixed order and
// divided by `count` (the pooled pixels), then the excite on the staged weights and meta (M of them), and with img_gate (C floats,
// or null) the product with the gate.  Each thread issues LOADS of its sums at once
// before it adds them (in the same order), so LOADS L2 round trips overlap.  Ends with
// the block synchronised.
template <int LOADS>
__device__ __forceinline__ void image_excite(const OnchipScratch& s, const float* img_partial,
                                             const float* __restrict__ img_gate, int slabs,
                                             int64_t count, int c, int m, int cr,
                                             int parts, int t) {
  // the thread's first gate value is loaded with the partial sums, not after the
  // sigmoid: one round trip to memory on the serial path instead of two
  const float own_gate = img_gate && t < c ? img_gate[t] : 1.f;
  const int slab_parts = min(parts, slabs);
  for (int i = t; i < c * slab_parts; i += kThreads) {
    const int ch = i % c, part = i / c;
    float sum = 0.f;
    for (int k0 = part; k0 < slabs; k0 += LOADS * slab_parts) {
      float v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int k = k0 + u * slab_parts;
        v[u] = k < slabs ? __ldcg(&img_partial[k * c + ch]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        if (k0 + u * slab_parts < slabs) sum += v[u];
    }
    s.part_sum[i] = sum;
  }
  __syncthreads();
  for (int ch = t; ch < c; ch += kThreads) {
    float sum = 0.f;
    for (int part = 0; part < slab_parts; ++part) sum += s.part_sum[part * c + ch];
    s.pooled[ch] = sum / (float)count;
  }
  __syncthreads();
  const int warp = t / 32, wl = t % 32;
  for (int j = warp; j < cr; j += kThreads / 32) {
    float h = 0.f;
    for (int ch = wl; ch < c + m; ch += 32) h += s.pooled[ch] * s.w1s[j * (c + m) + ch];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) h += __shfl_down_sync(0xffffffffu, h, off);
    if (wl == 0) s.hidden[j] = fmaxf(h + s.b1s[j], 0.f);
  }
  __syncthreads();
  for (int ch = t; ch < c; ch += kThreads) {
    float a = 0.f;
    for (int j = 0; j < cr; ++j) a += s.hidden[j] * s.w2s[j * c + ch];
    a = 1.f / (1.f + expf(-(a + s.b2s[ch])));
    s.att[ch] = img_gate ? a * (ch == t ? own_gate : img_gate[ch]) : a;
  }
  __syncthreads();
}

// Thread 0: bulk-copy pixels [a, b) of `src` (C channels of T each) to dst, counted
// on bar.
template <typename T>
__device__ __forceinline__ void load_pixels(unsigned char* dst, const T* src, int c,
                                            int64_t a, int64_t b, uint64_t* bar) {
  const uint32_t bytes = (uint32_t)((b - a) * c * (int64_t)sizeof(T));
  mbar_expect_tx(bar, bytes);
  bulk_load(dst, src + a * c, bytes, bar);
}

// Grid (S, N), kThreads threads, launched cooperatively (path 1 of the note above).
// Block (s, n) owns pixels [s*slab_len, min(hw, (s+1)*slab_len)) of image n; its
// threads form `rows` rows of C/VEC lanes (VEC channels each) that stride over the
// slab's pixels, so each thread keeps one lane's pool (of the pixels inside `ext`) and
// attention in registers.  meta (N, M) and gate (N, C) are optional (null, M = 0).
// The plan guarantees
// C/VEC <= kThreads and a non-empty slab for every block.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ca_onchip(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ meta,
              const float* __restrict__ gate, float* __restrict__ partial, int64_t hw, int c,
              int m, int cr, int64_t slab_len, int64_t w1_sc, int64_t w1_sj, int64_t w2_sj,
              int64_t w2_sc, Extent ext) {
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
  const OnchipScratch s(
      reinterpret_cast<float*>(smem + onchip_float_offset(slab_len, c, sizeof(T))), c, m,
      cr, rows, parts);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + onchip_barrier_offset(slab_len, c, m, cr, sizeof(T)));

  // a. bulk copies of the slab, one mbarrier per chunk
  if (t == 0) {
    for (int k = 0; k < kOnchipChunks; ++k) mbar_init(&bars[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    for (int k = 0; k < kOnchipChunks; ++k) {
      const int64_t a = k * chunk_len, b = min(len, a + chunk_len);
      if (a >= b) break;
      load_pixels(smem + a * c * sizeof(T), x + (n * hw + p0) * c, c, a, b, &bars[k]);
    }
  }
  stage_excite_weights(s, w1, b1, w2, b2, meta + n * m, c, m, cr, w1_sc, w1_sj, w2_sj, w2_sc,
                       t);

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  for (int k = 0; k < kOnchipChunks; ++k) {
    const int64_t a = k * chunk_len, b = min(len, a + chunk_len);
    if (a >= b) break;
    mbar_wait(&bars[k], 0);
    if (row < rows) {
      ExtentWalk walk(ext, p0 + a + row, rows);
      for (int64_t p = a + row; p < b; p += rows, walk.next()) {
        if (!walk.inside()) continue;
        const Pack<T, VEC> pk = slab[p * lanes + lane];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += to_float(pk.v[v]);
      }
    }
  }

  // b. the block's per-channel sum, then the grid barrier
  block_channel_sum<VEC>(acc, s, partial + (n * slabs + blockIdx.x) * c, c, rows, parts,
                         row, lane, t);
  cooperative_groups::this_grid().sync();

  // c. image n's pool from the S partials, then the excite (and the gate)
  image_excite<1>(s, partial + n * slabs * c, gate ? gate + n * c : nullptr, slabs, ext.count,
                  c, m, cr, parts, t);

  // d. out = x * T(att) from shared memory, 16-byte stores
  if (row < rows) {
    float scale[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) scale[v] = to_float(from_float<T>(s.att[lane * VEC + v]));
    Pack<T, VEC>* dst = reinterpret_cast<Pack<T, VEC>*>(out + (n * hw + p0) * c);
    for (int64_t p = row; p < len; p += rows) {
      Pack<T, VEC> pk = slab[p * lanes + lane];
#pragma unroll
      for (int v = 0; v < VEC; ++v) pk.v[v] = from_float<T>(to_float(pk.v[v]) * scale[v]);
      dst[p * lanes + lane] = pk;
    }
  }
}

// Phase stamps of ca_rounds, recorded only in a build with -DSISR_CA_RES_TIMELINE
// (tools/ca_res_timeline.py): thread 0 of each block takes the global timer (ns) at
// kernel entry (stamp 0) and, in each of the first kResStampRounds rounds, once its
// slab is pooled, past the barrier, after the excite and after the scale (stamps
// 1 + 4k .. 4 + 4k), into res_stamps[block * kResStamps + stamp].
constexpr int kResStampRounds = 3;
constexpr int kResStamps = 1 + 4 * kResStampRounds;
constexpr int kResStampBlocks = 1024;
#ifdef SISR_CA_RES_TIMELINE
__device__ unsigned long long res_stamps[kResStampBlocks * kResStamps];
#endif

__device__ __forceinline__ void res_stamp(int stamp) {
#ifdef SISR_CA_RES_TIMELINE
  const unsigned block = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && block < kResStampBlocks && stamp < kResStamps) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    res_stamps[block * kResStamps + stamp] = ns;
  }
#endif
}

// Grid (B, I), kThreads threads, launched cooperatively (path 1 of the CA + residual
// note above, and the CA's path 2).  In round k, block (s, i) owns pixels [s*slab_len,
// min(hw, (s+1)*slab_len)) of image k*I + i while that image exists (blocks with none
// only meet the barrier); its threads form rows of C/VEC lanes as in ca_onchip.  The
// slab splits into `chunks` chunks of chunk_len pixels; chunk j of x lands on xbars[j]
// and chunk j of r on rbars[j], each of whose phases completes once a round, so round
// k waits for parity k & 1.  MODE (RoundsMode) says what is written: with kNoR, r is
// null, TR is TX and out = x * T(att); else out = res_out<TX, TR, MODE>.  meta (N, M)
// and gate (N, C) are optional (null, M = 0).  The pool takes the pixels inside `ext`
// (the full extent with r).  The plan guarantees C/VEC <= kThreads, a non-empty slab
// for every block and rounds * I >= N.
template <typename TX, typename TR, int VEC, int MODE>
__global__ void __launch_bounds__(kThreads)
    ca_rounds(const TX* __restrict__ x, const TR* __restrict__ r, TR* __restrict__ out,
              const float* __restrict__ w1, const float* __restrict__ b1,
              const float* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ meta, const float* __restrict__ gate,
              float* __restrict__ partial, int64_t n_images, int64_t hw, int c, int m, int cr,
              int rounds, int64_t slab_len, int64_t w1_sc, int64_t w1_sj, int64_t w2_sj,
              int64_t w2_sc, Extent ext) {
  constexpr bool kHasR = MODE != kNoR;
  constexpr int kRBytes = kHasR ? (int)sizeof(TR) : 0;  // r's itemsize in the layout
  extern __shared__ __align__(128) unsigned char smem[];
  const int slabs = gridDim.x;
  const int images = gridDim.y;
  const int lanes = c / VEC;
  const int rows = kThreads / lanes;
  const int parts = onchip_parts(c);
  const int t = threadIdx.x;
  const int row = t / lanes, lane = t % lanes;
  const int64_t p0 = (int64_t)blockIdx.x * slab_len;
  const int64_t len = min(hw - p0, slab_len);
  const int64_t chunk_len = (len + kResChunks - 1) / kResChunks;
  const int chunks = (int)((len + chunk_len - 1) / chunk_len);  // all non-empty

  const Pack<TX, VEC>* xs = reinterpret_cast<const Pack<TX, VEC>*>(smem);
  unsigned char* r_smem = smem + res_r_offset(slab_len, c, sizeof(TX));
  const Pack<TR, VEC>* rs = reinterpret_cast<const Pack<TR, VEC>*>(r_smem);
  const OnchipScratch s(reinterpret_cast<float*>(r_smem + slab_len * c * kRBytes), c, m, cr,
                        rows, parts);
  uint64_t* xbars = reinterpret_cast<uint64_t*>(
      smem + res_barrier_offset(slab_len, c, m, cr, sizeof(TX), kRBytes));
  uint64_t* rbars = xbars + kResChunks;
  res_stamp(0);

  if (t == 0) {
    for (int j = 0; j < (kHasR ? 2 : 1) * kResChunks; ++j) mbar_init(&xbars[j]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0 && blockIdx.y < n_images) {  // round 0's slab of x
    for (int j = 0; j < chunks; ++j) {
      const int64_t a = j * chunk_len, b = min(len, a + chunk_len);
      load_pixels(smem + a * c * sizeof(TX), x + ((int64_t)blockIdx.y * hw + p0) * c, c, a,
                  b, &xbars[j]);
    }
  }
  stage_excite_weights(s, w1, b1, w2, b2, nullptr, c, m, cr, w1_sc, w1_sj, w2_sj, w2_sc, t);

  for (int k = 0; k < rounds; ++k) {
    const int64_t n = (int64_t)k * images + blockIdx.y;
    const bool mine = n < n_images;  // the same for the whole block
    const bool more = n + images < n_images;
    // the next round's slab of x on its way into L2, so that its copy into shared
    // memory during this round's scale is quick
    if (t == 0 && more)
      prefetch_l2(x + ((n + images) * hw + p0) * c, (uint32_t)(len * c * sizeof(TX)));
    // a. this round's image's meta beside pooled (read by the excite after its block
    //    syncs); pool the slab of x as its chunks land, then the block's sum to partial
    if (mine) {
      for (int i = t; i < m; i += kThreads) s.pooled[c + i] = meta[n * m + i];
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
      for (int j = 0; j < chunks; ++j) {
        const int64_t a = j * chunk_len, b = min(len, a + chunk_len);
        mbar_wait(&xbars[j], (uint32_t)(k & 1));
        if (row < rows) {
          ExtentWalk walk(ext, p0 + a + row, rows);
          for (int64_t p = a + row; p < b; p += rows, walk.next()) {
            if (!walk.inside()) continue;
            const Pack<TX, VEC> pk = xs[p * lanes + lane];
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] += to_float(pk.v[v]);
          }
        }
      }
      block_channel_sum<VEC>(acc, s, partial + (n * slabs + blockIdx.x) * c, c, rows, parts,
                             row, lane, t);
    }
    // b. one grid barrier a round, split: between the arrival and the wait the slab of
    //    r starts coming in (r does not wait for att; issued before the arrival, its
    //    traffic would delay the barrier's own); then each block runs its image's excite
    res_stamp(1 + 4 * k);
    {
      const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
      auto token = grid.barrier_arrive();
      if (kHasR && t == 0 && mine) {
        for (int j = 0; j < chunks; ++j) {
          const int64_t a = j * chunk_len, b = min(len, a + chunk_len);
          load_pixels(r_smem + a * c * sizeof(TR), r + (n * hw + p0) * c, c, a, b, &rbars[j]);
        }
      }
      grid.barrier_wait(std::move(token));
    }
    res_stamp(2 + 4 * k);
    if (!mine) continue;
    image_excite<kResLoads>(s, partial + n * slabs * c, gate ? gate + n * c : nullptr, slabs,
                            ext.count, c, m, cr, parts, t);
    res_stamp(3 + 4 * k);

    // c. out chunk by chunk from shared memory; each chunk's bytes of x then take the
    //    next round's
    float scale[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      scale[v] = row < rows ? scale_of<TX, MODE>(s.att[lane * VEC + v]) : 0.f;
    Pack<TR, VEC>* dst = reinterpret_cast<Pack<TR, VEC>*>(out + (n * hw + p0) * c);
    for (int j = 0; j < chunks; ++j) {
      const int64_t a = j * chunk_len, b = min(len, a + chunk_len);
      if (kHasR) mbar_wait(&rbars[j], (uint32_t)(k & 1));
      if (row < rows) {
        for (int64_t p = a + row; p < b; p += rows) {
          const Pack<TX, VEC> px = xs[p * lanes + lane];
          Pack<TR, VEC> po;
          if constexpr (kHasR) {
            const Pack<TR, VEC> pr = rs[p * lanes + lane];
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              po.v[v] = res_out<TX, TR, MODE>(px.v[v], scale[v], pr.v[v]);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              po.v[v] = from_float<TR>(to_float(px.v[v]) * scale[v]);
          }
          dst[p * lanes + lane] = po;
        }
      }
      if (more) {
        __syncthreads();  // every thread is done reading chunk j of x (and of r)
        if (t == 0) {     // order those reads before the async proxy's writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          load_pixels(smem + a * c * sizeof(TX), x + ((n + images) * hw + p0) * c, c, a, b,
                      &xbars[j]);
        }
      }
    }
    res_stamp(4 + 4 * k);
  }
}

// ca_stream's pool of pixels [a, b) of a slab past shared memory (src its first pixel),
// the thread's lane of rows `row`, `row + rows`, ... inside `walk`'s extent, into acc:
// kStreamLoads loads at once under `policy`, added in pixel order.
template <typename TX, int VEC>
__device__ __forceinline__ void stream_pool(const Pack<TX, VEC>* src, int64_t a, int64_t b,
                                            int row, int rows, int lanes, int lane,
                                            ExtentWalk walk, uint64_t policy,
                                            float (&acc)[VEC]) {
  for (int64_t p = a + row; p < b; p += kStreamLoads * rows) {
    Pack<TX, VEC> px[kStreamLoads];
    bool take[kStreamLoads];
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u) {
      const int64_t q = p + u * rows;
      take[u] = q < b && walk.inside();
      if (q < b) walk.next();
      if (take[u]) px[u] = ld_hint(&src[q * lanes + lane], policy);
    }
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u)
      if (take[u]) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += to_float(px[u].v[v]);
      }
  }
}

// ca_stream's scale of pixels [a, b) of a slab: x from xs (kGlobalX: the slab in
// global memory, read under `policy`, kStreamLoads loads at once; else the head in
// shared memory), r (with MODE's r) from rs, which holds pixels [a, b), and out to dst
// (the slab's first pixel) under `policy`.
template <bool kGlobalX, typename TX, typename TR, int VEC, int MODE>
__device__ __forceinline__ void stream_scale(const Pack<TX, VEC>* xs, const Pack<TR, VEC>* rs,
                                             Pack<TR, VEC>* dst, int64_t a, int64_t b,
                                             int row, int rows, int lanes, int lane,
                                             const float (&scale)[VEC], uint64_t policy) {
  for (int64_t p = a + row; p < b; p += kStreamLoads * rows) {
    Pack<TX, VEC> px[kStreamLoads];
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u) {
      const int64_t q = p + u * rows;
      if (q < b) {
        if constexpr (kGlobalX)
          px[u] = ld_hint(&xs[q * lanes + lane], policy);
        else
          px[u] = xs[q * lanes + lane];
      }
    }
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u) {
      const int64_t q = p + u * rows;
      if (q >= b) break;
      Pack<TR, VEC> po;
      if constexpr (MODE != kNoR) {
        const Pack<TR, VEC> pr = rs[(q - a) * lanes + lane];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          po.v[v] = res_out<TX, TR, MODE>(px[u].v[v], scale[v], pr.v[v]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) po.v[v] = from_float<TR>(to_float(px[u].v[v]) * scale[v]);
      }
      st_hint(&dst[q * lanes + lane], po, policy);
    }
  }
}

// Grid (B), kThreads threads, launched cooperatively (the CA's path 3 and the CA +
// residual's path 2 of the note above).  One image a round (N rounds): block s owns
// pixels [s*slab_len, min(hw, (s+1)*slab_len)) of each image, the first head_len of
// them (its head) in shared memory, the rest (its tail) read past it; rows of C/VEC
// lanes as in ca_onchip.  The head lands in kStreamChunks bulk copies on xbars, whose
// phases complete once a round (parity k & 1).  The scale walks the slab in pieces:
// runs of stream_ring_pixels pixels (one slot of r's ring each), the tail's first and
// then the head's (kStreamTailFirst false: the head's first), or without r the tail
// and the head whole; piece j of round k is use g = k * pieces + j of the ring, in slot g %
// kStreamSlots, whose phase is the slot's (g / kStreamSlots)-th (parity & 1).  MODE,
// meta, gate and ext as in ca_rounds.  The plan guarantees C/VEC <= kThreads, a
// non-empty slab for every block and 1 <= head_len <= slab_len.
template <typename TX, typename TR, int VEC, int MODE>
__global__ void __launch_bounds__(kThreads)
    ca_stream(const TX* __restrict__ x, const TR* __restrict__ r, TR* __restrict__ out,
              const float* __restrict__ w1, const float* __restrict__ b1,
              const float* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ meta, const float* __restrict__ gate,
              float* __restrict__ partial, int64_t n_images, int64_t hw, int c, int m, int cr,
              int64_t slab_len, int64_t head_len, int64_t w1_sc,
              int64_t w1_sj, int64_t w2_sj, int64_t w2_sc, Extent ext) {
  constexpr bool kHasR = MODE != kNoR;
  constexpr int kRBytes = kHasR ? (int)sizeof(TR) : 0;  // r's itemsize in the layout
  extern __shared__ __align__(128) unsigned char smem[];
  const int slabs = gridDim.x;
  const int lanes = c / VEC;
  const int rows = kThreads / lanes;
  const int parts = onchip_parts(c);
  const int t = threadIdx.x;
  const int row = t / lanes, lane = t % lanes;
  const int64_t p0 = (int64_t)blockIdx.x * slab_len;
  const int64_t len = min(hw - p0, slab_len);
  const int64_t head = min(len, head_len);  // pixels [0, head): in shared memory
  const int64_t tail = len - head;          // pixels [head, len): from L2
  const int64_t chunk_len = (head + kStreamChunks - 1) / kStreamChunks;
  const int chunks = (int)((head + chunk_len - 1) / chunk_len);  // all non-empty
  const int64_t ring_len = stream_ring_pixels(c, kRBytes);
  const int tail_pieces = (int)(kHasR ? (tail + ring_len - 1) / ring_len : (tail > 0));
  const int head_pieces = (int)(kHasR ? (head + ring_len - 1) / ring_len : 1);
  const int pieces = tail_pieces + head_pieces;

  const Pack<TX, VEC>* xs = reinterpret_cast<const Pack<TX, VEC>*>(smem);
  unsigned char* ring = smem + stream_ring_offset(head_len, c, sizeof(TX));
  const int64_t slot_bytes = ring_len * c * kRBytes;
  const OnchipScratch s(reinterpret_cast<float*>(ring + kStreamSlots * slot_bytes), c, m, cr,
                        rows, parts);
  uint64_t* xbars = reinterpret_cast<uint64_t*>(
      smem + stream_barrier_offset(head_len, c, m, cr, sizeof(TX), kRBytes));
  uint64_t* rbars = xbars + kStreamChunks;
  const uint64_t keep = l2_evict_last(), pass = l2_evict_first();
  res_stamp(0);

  // piece j of the scale: pixels [*a, *b) of the slab; true when they are in the tail
  auto piece = [&](int j, int64_t* a, int64_t* b) {
    const int first = kStreamTailFirst ? tail_pieces : head_pieces;
    const bool in_tail = kStreamTailFirst == (j < first);
    const int i = j < first ? j : j - first;
    const int64_t lo = in_tail ? head : 0, hi = in_tail ? len : head;
    *a = lo + i * (kHasR ? ring_len : hi - lo);
    *b = min(hi, *a + (kHasR ? ring_len : hi - lo));
    return in_tail;
  };
  // thread 0: round k's piece j of r (image n) into its slot, past L2 (evict_first)
  auto send_r = [&](int64_t n, int k, int j) {
    int64_t a, b;
    piece(j, &a, &b);
    const int slot = (int)(((int64_t)k * pieces + j) % kStreamSlots);
    const uint32_t bytes = (uint32_t)((b - a) * c * (int64_t)sizeof(TR));
    mbar_expect_tx(&rbars[slot], bytes);
    bulk_load_hint(ring + slot * slot_bytes, r + (n * hw + p0 + a) * c, bytes, &rbars[slot],
                   pass);
  };

  // a. thread 0: image n's head by bulk copies, read once (evict_first), and its tail
  //    sent for into L2 to stay there (evict_last) until the scale reads it again
  auto send_x = [&](int64_t n) {
    const TX* img = x + (n * hw + p0) * c;
    for (int i = 0; i < chunks; ++i) {
      const int64_t a = i * chunk_len, b = min(head, a + chunk_len);
      const uint32_t bytes = (uint32_t)((b - a) * c * (int64_t)sizeof(TX));
      mbar_expect_tx(&xbars[i], bytes);
      bulk_load_hint(smem + a * c * sizeof(TX), img + a * c, bytes, &xbars[i], pass);
    }
    if (tail > 0)
      prefetch_l2_hint(img + head * c, (uint32_t)(tail * c * (int64_t)sizeof(TX)), keep);
  };

  if (t == 0) {
    for (int j = 0; j < kStreamChunks + (kHasR ? kStreamSlots : 0); ++j) mbar_init(&xbars[j]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) send_x(0);
  stage_excite_weights(s, w1, b1, w2, b2, nullptr, c, m, cr, w1_sc, w1_sj, w2_sj, w2_sc, t);

  for (int k = 0; k < (int)n_images; ++k) {
    const int64_t n = k;
    const TX* img = x + (n * hw + p0) * c;  // the slab's first pixel
    if (t == 0 && k > 0) {  // order the last round's reads of the head before the copies
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      send_x(n);
    }
    for (int i = t; i < m; i += kThreads) s.pooled[c + i] = meta[n * m + i];
    // pool the head as its chunks land, then the tail from L2, always in that order
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    const Pack<TX, VEC>* img_packs = reinterpret_cast<const Pack<TX, VEC>*>(img);
    for (int i = 0; i < chunks; ++i) {
      const int64_t a = i * chunk_len, b = min(head, a + chunk_len);
      mbar_wait(&xbars[i], (uint32_t)(k & 1));
      if (row < rows) {
        ExtentWalk walk(ext, p0 + a + row, rows);
        for (int64_t p = a + row; p < b; p += rows, walk.next()) {
          if (!walk.inside()) continue;
          const Pack<TX, VEC> pk = xs[p * lanes + lane];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] += to_float(pk.v[v]);
        }
      }
    }
    res_stamp(1 + 6 * k);
    if (row < rows)
      stream_pool<TX, VEC>(img_packs, head, len, row, rows, lanes, lane,
                           ExtentWalk(ext, p0 + head + row, rows), keep, acc);
    block_channel_sum<VEC>(acc, s, partial + (n * slabs + blockIdx.x) * c, c, rows, parts, row,
                           lane, t);
    res_stamp(2 + 6 * k);
    // b. one grid barrier a round, split: r's first pieces start between the arrival
    //    and the wait (every thread is done with the ring: block_channel_sum synced)
    {
      const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
      auto token = grid.barrier_arrive();
      if (kHasR && t == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int j = 0; j < pieces && j < kStreamSlots; ++j) send_r(n, k, j);
      }
      grid.barrier_wait(std::move(token));
    }
    res_stamp(3 + 6 * k);
    image_excite<kResLoads>(s, partial + n * slabs * c, gate ? gate + n * c : nullptr, slabs,
                            ext.count, c, m, cr, parts, t);
    res_stamp(4 + 6 * k);

    // c. the scale piece by piece: the tail first, while L2 still holds it; r through
    //    its ring, out past L2 (evict_first); each slot takes the piece kStreamSlots on
    //    once every thread is done with it
    float scale[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      scale[v] = row < rows ? scale_of<TX, MODE>(s.att[lane * VEC + v]) : 0.f;
    Pack<TR, VEC>* dst = reinterpret_cast<Pack<TR, VEC>*>(out + (n * hw + p0) * c);
    for (int j = 0; j < pieces; ++j) {
      int64_t a, b;
      const bool in_tail = piece(j, &a, &b);
      const int64_t g = (int64_t)k * pieces + j;
      const Pack<TR, VEC>* rs =
          reinterpret_cast<const Pack<TR, VEC>*>(ring + (g % kStreamSlots) * slot_bytes);
      if (kHasR) mbar_wait(&rbars[g % kStreamSlots], (uint32_t)((g / kStreamSlots) & 1));
      if (row < rows) {
        if (in_tail)
          stream_scale<true, TX, TR, VEC, MODE>(img_packs, rs, dst, a, b, row, rows, lanes,
                                                lane, scale, pass);
        else
          stream_scale<false, TX, TR, VEC, MODE>(xs, rs, dst, a, b, row, rows, lanes, lane,
                                                 scale, pass);
      }
      if (kHasR && j + kStreamSlots < pieces) {
        __syncthreads();  // every thread is done reading the slot
        if (t == 0) {     // order those reads before the async proxy's writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          send_r(n, k, j + kStreamSlots);
        }
      }
      if (j + 1 == (kStreamTailFirst ? tail_pieces : head_pieces)) res_stamp(5 + 6 * k);
    }
    res_stamp(6 + 6 * k);
    __syncthreads();  // every thread is done with the head and the ring
  }
}

// Passes 1 and 2: att (N, C) float32 from x (and meta (N, M), gate (N, C) where not
// null), pooled over the valid extent `ext`.
template <typename T, int VEC>
cudaError_t launch_pool_excite(const T* xt, const float* w1, const float* b1,
                               const float* w2, const float* b2, const float* meta,
                               const float* gate, float* partial, float* att, int64_t n,
                               int64_t hw, int c, int m, int cr, const int64_t* w_strides,
                               int slabs, const Extent& ext, cudaStream_t stream) {
  const int lanes = c / VEC;
  const int chunk_lanes = lanes < kThreads ? lanes : kThreads;
  const int rows = kThreads / chunk_lanes;
  const int chunks = (lanes + chunk_lanes - 1) / chunk_lanes;
  const int64_t slab_len = (hw + slabs - 1) / slabs;
  const size_t red_bytes = sizeof(float) * rows * chunk_lanes * VEC;
  ca_pool_partial<T, VEC><<<dim3(slabs, (unsigned)n, chunks), kThreads, red_bytes, stream>>>(
      xt, partial, hw, c, slabs, slab_len, ext);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int parts = c < kThreads ? (slabs < kThreads / c ? slabs : kThreads / c) : 1;
  ca_excite<<<(unsigned)n, kThreads, sizeof(float) * (c + m + cr + c * parts), stream>>>(
      partial, w1, b1, w2, b2, meta, gate, att, slabs, c, m, cr, (float)ext.count, w_strides[0],
      w_strides[1], w_strides[2], w_strides[3], parts);
  return cudaGetLastError();
}

// Blocks for a grid-stride pass over total_vecs vectors: at most 16 per SM.
unsigned scale_blocks(int64_t total_vecs, int sm_count) {
  int64_t blocks = (total_vecs + kThreads - 1) / kThreads;
  const int64_t max_blocks = (int64_t)sm_count * 16;
  return (unsigned)(blocks > max_blocks ? max_blocks : blocks);
}

// What every launch of the CA + residual tail and of ca_rounds takes: x, r (null for
// ca_rounds without r), out, the excite's weights with their strides (as in
// sisr_ca_forward), meta (null with M = 0), gate (or null), partial and the valid
// extent of the pool (the full extent for the tail).
struct TailArgs {
  const void* x;
  const void* r;
  void* out;
  const float *w1, *b1, *w2, *b2, *meta, *gate;
  float* partial;
  int64_t n, hw;
  int c, m, cr;
  int64_t ws[4];
  Extent ext;
};

// ca_rounds' plan: `rounds` rounds of `images` images, `slabs` blocks of slab_len pixels
// per image, smem_bytes of dynamic shared memory a block.
struct RoundsPlan {
  int rounds, images, slabs;
  int64_t slab_len, smem_bytes;
};

template <typename TX, typename TR, int VEC, int MODE>
cudaError_t launch_res(const TailArgs& a, float* att, int slabs, int sm_count,
                       cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(a.x);
  cudaError_t err = launch_pool_excite<TX, VEC>(xt, a.w1, a.b1, a.w2, a.b2, a.meta, a.gate,
                                                a.partial, att, a.n, a.hw, a.c, a.m, a.cr, a.ws,
                                                slabs, a.ext, stream);
  if (err != cudaSuccess) return err;
  const int64_t total_vecs = a.n * a.hw * (a.c / VEC);
  ca_res_scale<TX, TR, VEC, MODE><<<scale_blocks(total_vecs, sm_count), kThreads, 0, stream>>>(
      xt, static_cast<const TR*>(a.r), att, static_cast<TR*>(a.out), total_vecs, a.hw, a.c);
  return cudaGetLastError();
}

template <typename TX, int VEC>
cudaError_t dispatch_res(int r_dtype, int cast_first, const TailArgs& a, float* att,
                         int slabs, int sm_count, cudaStream_t s) {
  if (r_dtype == 0)
    return cast_first ? launch_res<TX, float, VEC, kResCastFirst>(a, att, slabs, sm_count, s)
                      : launch_res<TX, float, VEC, kRes>(a, att, slabs, sm_count, s);
  if (r_dtype == 1)
    return cast_first
               ? launch_res<TX, __nv_bfloat16, VEC, kResCastFirst>(a, att, slabs, sm_count, s)
               : launch_res<TX, __nv_bfloat16, VEC, kRes>(a, att, slabs, sm_count, s);
  return cudaErrorInvalidValue;
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* out, const float* w1, const float* b1,
                   const float* w2, const float* b2, const float* meta, const float* gate,
                   float* partial, float* att, int64_t n, int64_t hw, int c, int m, int cr,
                   const int64_t* w_strides, int slabs, int sm_count, const Extent& ext,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  cudaError_t err = launch_pool_excite<T, VEC>(xt, w1, b1, w2, b2, meta, gate, partial, att, n,
                                               hw, c, m, cr, w_strides, slabs, ext, stream);
  if (err != cudaSuccess) return err;
  const int64_t total_vecs = n * hw * (c / VEC);
  ca_scale<T, VEC><<<scale_blocks(total_vecs, sm_count), kThreads, 0, stream>>>(
      xt, att, static_cast<T*>(out), total_vecs, hw, c);
  return cudaGetLastError();
}

// One cooperative launch of `kernel` over `grid` with smem_bytes of dynamic shared
// memory, raising the kernel's opt-in limit above 48 KB first where this device has
// not yet (allowed: the limit set so far on each device, one array per kernel).
template <typename... Params, typename... Args>
cudaError_t launch_cooperative(void (*kernel)(Params...), int64_t* allowed, dim3 grid,
                               int64_t smem_bytes, cudaStream_t stream, Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem_bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem_bytes;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// One cooperative launch of ca_onchip over grid (slabs, n).  smem_bytes is the
// caller's plan; it must equal this file's layout (which counts M), and meta must be
// given exactly when M > 0, or nothing launches.
template <typename T, int VEC>
cudaError_t launch_onchip(const void* x, void* out, const float* w1, const float* b1,
                          const float* w2, const float* b2, const float* meta,
                          const float* gate, float* partial, int64_t n, int64_t hw, int c,
                          int m, int cr, const int64_t* w_strides, int slabs, int64_t slab_len,
                          int64_t smem_bytes, const Extent& ext, cudaStream_t stream) {
  if (c % VEC != 0 || c / VEC > kThreads || m < 0 || (m > 0) != (meta != nullptr) ||
      smem_bytes != onchip_smem_bytes(slab_len, c, m, cr, sizeof(T)))
    return cudaErrorInvalidValue;
  static int64_t allowed[64] = {};
  return launch_cooperative(ca_onchip<T, VEC>, allowed, dim3((unsigned)slabs, (unsigned)n),
                            smem_bytes, stream, static_cast<const T*>(x), static_cast<T*>(out),
                            w1, b1, w2, b2, meta, gate, partial, hw, c, m, cr, slab_len,
                            w_strides[0], w_strides[1], w_strides[2], w_strides[3], ext);
}

// One cooperative launch of ca_rounds over grid (slabs, images) for `rounds` rounds.
// The plan must cover every image once and every pixel once with no empty block, r
// must be given exactly when MODE has one (and then the extent be full), meta exactly
// when M > 0, and smem_bytes
// must equal this file's layout (which counts M, and r's itemsize as 0 without r), or
// nothing launches.
template <typename TX, typename TR, int VEC, int MODE>
cudaError_t launch_rounds(const TailArgs& a, const RoundsPlan& p, cudaStream_t stream) {
  constexpr bool kHasR = MODE != kNoR;
  constexpr int kRBytes = kHasR ? (int)sizeof(TR) : 0;
  if (a.c % VEC != 0 || a.c / VEC > kThreads || a.m < 0 || (a.m > 0) != (a.meta != nullptr) ||
      kHasR != (a.r != nullptr) || (kHasR && a.ext.masked) || p.rounds < 1 || p.images < 1 ||
      p.slabs < 1 ||
      (int64_t)(p.rounds - 1) * p.images >= a.n || (int64_t)p.rounds * p.images < a.n ||
      (p.slabs - 1) * p.slab_len >= a.hw || p.slabs * p.slab_len < a.hw ||
      (a.c * kRBytes) % 16 != 0 ||
      p.smem_bytes != res_onchip_smem_bytes(p.slab_len, a.c, a.m, a.cr, sizeof(TX), kRBytes))
    return cudaErrorInvalidValue;
  static int64_t allowed[64] = {};
  return launch_cooperative(ca_rounds<TX, TR, VEC, MODE>, allowed,
                            dim3((unsigned)p.slabs, (unsigned)p.images), p.smem_bytes, stream,
                            static_cast<const TX*>(a.x), static_cast<const TR*>(a.r),
                            static_cast<TR*>(a.out), a.w1, a.b1, a.w2, a.b2, a.meta, a.gate,
                            a.partial, a.n, a.hw, a.c, a.m, a.cr, p.rounds, p.slab_len,
                            a.ws[0], a.ws[1], a.ws[2], a.ws[3], a.ext);
}

// ca_rounds for x of type TX: without r (r_dtype -1), or the tail with r float32 (0)
// or bfloat16 (1), plain or cast first.
template <typename TX, int VEC>
cudaError_t dispatch_rounds(int r_dtype, int cast_first, const TailArgs& a,
                            const RoundsPlan& p, cudaStream_t s) {
  if (r_dtype == -1 && !cast_first) return launch_rounds<TX, TX, VEC, kNoR>(a, p, s);
  if (r_dtype == 0)
    return cast_first ? launch_rounds<TX, float, VEC, kResCastFirst>(a, p, s)
                      : launch_rounds<TX, float, VEC, kRes>(a, p, s);
  if (r_dtype == 1)
    return cast_first ? launch_rounds<TX, __nv_bfloat16, VEC, kResCastFirst>(a, p, s)
                      : launch_rounds<TX, __nv_bfloat16, VEC, kRes>(a, p, s);
  return cudaErrorInvalidValue;
}

// ca_stream's plan: one round an image, `slabs` blocks of slab_len pixels whose first
// head_len sit in shared memory, smem_bytes of dynamic shared memory a block.
struct StreamPlan {
  int rounds, slabs;
  int64_t slab_len, head_len, smem_bytes;
};

// One cooperative launch of ca_stream over `slabs` blocks for one round an image.  The
// plan must take each image in its own round and cover every pixel once with no empty
// block and a head of 1 to slab_len pixels; r, meta and the extent are held to what
// launch_rounds holds them to, and smem_bytes must equal this file's layout, or nothing
// launches.
template <typename TX, typename TR, int VEC, int MODE>
cudaError_t launch_stream(const TailArgs& a, const StreamPlan& p, cudaStream_t stream) {
  constexpr bool kHasR = MODE != kNoR;
  constexpr int kRBytes = kHasR ? (int)sizeof(TR) : 0;
  if (a.c % VEC != 0 || a.c / VEC > kThreads || a.m < 0 || (a.m > 0) != (a.meta != nullptr) ||
      kHasR != (a.r != nullptr) || (kHasR && a.ext.masked) || p.rounds != a.n ||
      p.slabs < 1 || (p.slabs - 1) * p.slab_len >= a.hw || p.slabs * p.slab_len < a.hw ||
      p.head_len < 1 || p.head_len > p.slab_len || (a.c * kRBytes) % 16 != 0 ||
      p.smem_bytes != stream_smem_bytes(p.head_len, a.c, a.m, a.cr, sizeof(TX), kRBytes))
    return cudaErrorInvalidValue;
  static int64_t allowed[64] = {};
  return launch_cooperative(ca_stream<TX, TR, VEC, MODE>, allowed, dim3((unsigned)p.slabs),
                            p.smem_bytes, stream, static_cast<const TX*>(a.x),
                            static_cast<const TR*>(a.r), static_cast<TR*>(a.out), a.w1, a.b1,
                            a.w2, a.b2, a.meta, a.gate, a.partial, a.n, a.hw, a.c, a.m, a.cr,
                            p.slab_len, p.head_len, a.ws[0], a.ws[1], a.ws[2], a.ws[3],
                            a.ext);
}

// ca_stream for x of type TX, with r as dispatch_rounds takes it.
template <typename TX, int VEC>
cudaError_t dispatch_stream(int r_dtype, int cast_first, const TailArgs& a,
                            const StreamPlan& p, cudaStream_t s) {
  if (r_dtype == -1 && !cast_first) return launch_stream<TX, TX, VEC, kNoR>(a, p, s);
  if (r_dtype == 0)
    return cast_first ? launch_stream<TX, float, VEC, kResCastFirst>(a, p, s)
                      : launch_stream<TX, float, VEC, kRes>(a, p, s);
  if (r_dtype == 1)
    return cast_first ? launch_stream<TX, __nv_bfloat16, VEC, kResCastFirst>(a, p, s)
                      : launch_stream<TX, __nv_bfloat16, VEC, kRes>(a, p, s);
  return cudaErrorInvalidValue;
}

// The valid extent (vh, vw) of images of hw pixels, w wide, into *e: false (and nothing
// launches) unless w divides hw, 0 < vh <= H = hw / w and 0 < vw <= w.
bool make_extent(int64_t hw, int64_t w, int64_t vh, int64_t vw, Extent* e) {
  if (w <= 0 || hw % w != 0) return false;
  const int64_t h = hw / w;
  if (vh <= 0 || vh > h || vw <= 0 || vw > w) return false;
  *e = {w, vh, vw, vh * vw, (vh < h || vw < w) ? 1 : 0};
  return true;
}

// The whole image of hw pixels: the CA + residual tail's pool.
Extent full_extent(int64_t hw) { return {hw, 1, hw, hw, 0}; }

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  vectorized: 1 for 16-byte vectors (the caller checks
// that C * itemsize % 16 == 0 and that x is 16-byte aligned), 0 for one element per
// thread.  w1 (C + M, Cr) and w2 (Cr, C) are strided (element strides w1 row, w1 col,
// w2 row, w2 col); b1 and b2 are contiguous.  meta (N, M) and gate (N, C) are
// contiguous float32, or null (meta null with M = 0).  partial holds N * slabs * C
// floats, att N * C floats.  The map is w pixels wide; the pool takes the pixels of
// each image whose row is under vh and column under vw (vh = H, vw = w: all of them),
// as make_extent checks.  Returns the CUDA error code of the first failed launch, 0
// when all three launched.
int sisr_ca_forward(const void* x, void* out, const float* w1, const float* b1,
                    const float* w2, const float* b2, const float* meta, const float* gate,
                    float* partial, float* att, long long n, long long hw, int c, int m,
                    int cr, long long w1_s0, long long w1_s1, long long w2_s0,
                    long long w2_s1, int dtype, int vectorized, int slabs, int sm_count,
                    long long w, long long vh, long long vw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t ws[4] = {w1_s0, w1_s1, w2_s0, w2_s1};
  Extent e;
  if (m < 0 || (m > 0) != (meta != nullptr) || !make_extent(hw, w, vh, vw, &e))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return vectorized ? launch<float, 4>(x, out, w1, b1, w2, b2, meta, gate, partial, att, n,
                                         hw, c, m, cr, ws, slabs, sm_count, e, s)
                      : launch<float, 1>(x, out, w1, b1, w2, b2, meta, gate, partial, att, n,
                                         hw, c, m, cr, ws, slabs, sm_count, e, s);
  }
  if (dtype == 1) {
    return vectorized
               ? launch<__nv_bfloat16, 8>(x, out, w1, b1, w2, b2, meta, gate, partial, att, n,
                                          hw, c, m, cr, ws, slabs, sm_count, e, s)
               : launch<__nv_bfloat16, 1>(x, out, w1, b1, w2, b2, meta, gate, partial, att, n,
                                          hw, c, m, cr, ws, slabs, sm_count, e, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The on-chip path: one cooperative launch of `slabs` blocks per image, each owning
// slab_len pixels (the last one the rest), with smem_bytes of dynamic shared memory.
// The caller checks that C * itemsize % 16 == 0, that x is 16-byte aligned, that
// every block has pixels and that all n * slabs blocks fit on the card at once.
// dtype, the weights, meta, gate and their strides, and the width w and valid extent
// (vh, vw) are those of sisr_ca_forward; partial holds N * slabs * C floats.  Returns
// the CUDA error code of the launch, 0 when it launched.
int sisr_ca_onchip_forward(const void* x, void* out, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* meta,
                           const float* gate, float* partial, long long n, long long hw,
                           int c, int m, int cr, long long w1_s0, long long w1_s1,
                           long long w2_s0, long long w2_s1, int dtype, int slabs,
                           long long slab_len, long long smem_bytes, long long w, long long vh,
                           long long vw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t ws[4] = {w1_s0, w1_s1, w2_s0, w2_s1};
  Extent e;
  if (!make_extent(hw, w, vh, vw, &e)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_onchip<float, 4>(x, out, w1, b1, w2, b2, meta, gate, partial, n, hw, c, m,
                                   cr, ws, slabs, slab_len, smem_bytes, e, s);
  if (dtype == 1)
    return launch_onchip<__nv_bfloat16, 8>(x, out, w1, b1, w2, b2, meta, gate, partial, n, hw,
                                           c, m, cr, ws, slabs, slab_len, smem_bytes, e, s);
  return (int)cudaErrorInvalidValue;
}

// The rounds path (ca_rounds): one cooperative launch of `slabs` blocks for each of
// `images` images a round, over `rounds` rounds, each block owning slab_len pixels
// (the last one of an image the rest), with smem_bytes of dynamic shared memory.
// Without r (null, r_dtype -1, cast_first 0) it is the CA op, out in x's type; with r
// the CA + residual tail, out in r's type, with cast_first 1 the cast-first tail.
// x_dtype and r_dtype: 0 float32, 1 bfloat16.  The caller checks that C * itemsize(x)
// and C * itemsize(r) are multiples of 16, that x and r are 16-byte aligned, that out
// is aligned to one vector (16 / itemsize(x) elements) of its type and that all
// images * slabs blocks fit on the card at once.  The weights, meta, gate and their
// strides, and the width w and valid extent (vh, vw) are those of sisr_ca_forward; with
// r the extent must be the full image.  partial holds N * slabs * C floats.  Returns
// the CUDA error code of the launch, 0 when it launched.
int sisr_ca_rounds_forward(const void* x, const void* r, void* out, const float* w1,
                           const float* b1, const float* w2, const float* b2,
                           const float* meta, const float* gate, float* partial, long long n,
                           long long hw, int c, int m, int cr, long long w1_s0,
                           long long w1_s1, long long w2_s0, long long w2_s1, int x_dtype,
                           int r_dtype, int cast_first, int rounds, int images, int slabs,
                           long long slab_len, long long smem_bytes, long long w, long long vh,
                           long long vw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Extent e;
  if (!make_extent(hw, w, vh, vw, &e)) return (int)cudaErrorInvalidValue;
  const TailArgs a = {x, r, out, w1, b1, w2, b2, meta, gate, partial, n, hw, c, m, cr,
                      {w1_s0, w1_s1, w2_s0, w2_s1}, e};
  const RoundsPlan p = {rounds, images, slabs, slab_len, smem_bytes};
  if (x_dtype == 0) return (int)dispatch_rounds<float, 4>(r_dtype, cast_first, a, p, s);
  if (x_dtype == 1) return (int)dispatch_rounds<__nv_bfloat16, 8>(r_dtype, cast_first, a, p, s);
  return (int)cudaErrorInvalidValue;
}

// The stream path (ca_stream): one cooperative launch of `slabs` blocks, one image a
// round over `rounds` (= n) rounds, each block owning slab_len pixels (the last one the
// rest) of which the first head_len sit in shared memory, with smem_bytes of dynamic
// shared memory, whose tail is scaled before its head.  The other arguments, and
// what the caller checks, are those of sisr_ca_rounds_forward.  Returns the CUDA
// error code of the launch, 0 when it launched.
int sisr_ca_stream_forward(const void* x, const void* r, void* out, const float* w1,
                           const float* b1, const float* w2, const float* b2,
                           const float* meta, const float* gate, float* partial, long long n,
                           long long hw, int c, int m, int cr, long long w1_s0,
                           long long w1_s1, long long w2_s0, long long w2_s1, int x_dtype,
                           int r_dtype, int cast_first, int rounds, int slabs,
                           long long slab_len, long long head_len, long long smem_bytes,
                           long long w, long long vh, long long vw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Extent e;
  if (!make_extent(hw, w, vh, vw, &e)) return (int)cudaErrorInvalidValue;
  const TailArgs a = {x, r, out, w1, b1, w2, b2, meta, gate, partial, n, hw, c, m, cr,
                      {w1_s0, w1_s1, w2_s0, w2_s1}, e};
  const StreamPlan p = {rounds, slabs, slab_len, head_len, smem_bytes};
  if (x_dtype == 0) return (int)dispatch_stream<float, 4>(r_dtype, cast_first, a, p, s);
  if (x_dtype == 1) return (int)dispatch_stream<__nv_bfloat16, 8>(r_dtype, cast_first, a, p, s);
  return (int)cudaErrorInvalidValue;
}

// The CA + residual block tail in three passes.  x_dtype and r_dtype: 0 float32, 1
// bfloat16; out has r's type; cast_first 1 for the cast-first tail.  vectorized: 1
// for VEC = 16 / sizeof(x) elements per thread (the caller checks that C is a
// multiple of VEC, that x is 16-byte aligned and that r and out are aligned to VEC
// elements of r's type), 0 for one element per thread.  The other arguments are those
// of sisr_ca_forward.
int sisr_ca_res_forward(const void* x, const void* r, void* out, const float* w1,
                        const float* b1, const float* w2, const float* b2, const float* meta,
                        const float* gate, float* partial, float* att, long long n,
                        long long hw, int c, int m, int cr, long long w1_s0, long long w1_s1,
                        long long w2_s0, long long w2_s1, int x_dtype, int r_dtype,
                        int cast_first, int vectorized, int slabs, int sm_count,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 0 || (m > 0) != (meta != nullptr)) return (int)cudaErrorInvalidValue;
  const TailArgs a = {x, r, out, w1, b1, w2, b2, meta, gate, partial, n, hw, c, m, cr,
                      {w1_s0, w1_s1, w2_s0, w2_s1}, full_extent(hw)};
  if (x_dtype == 0) {
    return vectorized ? dispatch_res<float, 4>(r_dtype, cast_first, a, att, slabs, sm_count, s)
                      : dispatch_res<float, 1>(r_dtype, cast_first, a, att, slabs, sm_count, s);
  }
  if (x_dtype == 1) {
    return vectorized
               ? dispatch_res<__nv_bfloat16, 8>(r_dtype, cast_first, a, att, slabs, sm_count, s)
               : dispatch_res<__nv_bfloat16, 1>(r_dtype, cast_first, a, att, slabs, sm_count, s);
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef SISR_CA_RES_TIMELINE
// The phase stamps of the last ca_rounds launch: kResStampBlocks * kResStamps values
// (ns), as res_stamp lays them out.
int sisr_ca_res_stamps(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, res_stamps, sizeof(res_stamps));
}
#endif

const char* sisr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
