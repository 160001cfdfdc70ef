// Fused-pyramid RoIAlign backward for Hopper (sm_90a): the gradient of the
// forward (roi_align.cu) with respect to the pyramid planes.
//
// Replaces the TPU kernel `_ml_bwd_kernel` in
// tf_eager_object_detection_tpu/ops/pallas/roi_align_pallas.py (wrapped by
// `_ml_backward`, the VJP of `pallas_roi_align_multilevel`): every roi's
// output gradient g [S, S, C] is scattered into its own level's gradient
// plane, each sample's value to its four taps with the forward's tent
// weights. Rois with valid == 0, or a level outside the pyramid, read and
// write nothing. Launched with one plane (levels all 0, valid = active) it is
// the single-level backward `_bwd_kernel` (K3) as well.
//
// This is the exact VJP of the port's exact forward (the JAX einsum VJP),
// not of the TPU kernel's 64-cell window: the sample coordinates and taps
// come from roi_align_common.cuh, the forward's own code, and a tap index is
// clamped exactly as the forward clamps it. A tap of weight 0 (the second
// tap of a sample on a cell) adds nothing. The gradient planes are zeroed by
// the caller and have the planes' exact shapes: no window, no padding.
//
// What bounds it on this card: at the stock training shape (B=1, N=256,
// S=14, C=256) it reads 51.4 MB of g and the gradient planes of a 640x1024
// bucket are 55.7 MB (zeroed by the caller and written), ~0.03 ms at
// 3.35 TB/s. Added one by one, its 51 M float terms (4 taps of each sample
// and channel) are 205 MB of read-modify-write at the L2, which paces such a
// kernel before the device memory does: fewer, combined reductions are what
// make it faster.
//
// Design, as the forward's: one block per (roi, group of kRows sample rows),
// a grid of B * N * ceil(S / kRows) blocks, so a launch is many short blocks
// (1,792 at B=1, N=256) and not one block per roi that walks its S * S
// samples one after another. A block computes its row and column taps once
// into shared memory. Its threads are spread over (sample row, channel
// unit) pairs, flattened so that neighbouring threads load and add at
// neighbouring NHWC addresses. A unit is 4 channels, one float4, when
// C % 4 == 0 and g and every gradient plane are 16-byte aligned (the wrapper
// checks and passes `vec`); otherwise one channel (the scalar path of the
// same kernel). A thread loads the g units of its row's samples, kBatch (14)
// at a time, with streaming 16-byte loads all in flight (g is read once;
// the first batch is issued before the block computes its taps), then walks
// the samples in order. Samples a cell or less apart share a column tap, so
// the thread keeps the sums of w_x * g of the two current columns in
// registers and adds a column's sum to the plane once the walk has passed
// it: w_y * sum to each of the row's two tap rows, with one reduction each.
// On the float4 path that is a 16-byte vector reduction (atomicAdd(float4*),
// sm_90's red.global.add.v4.f32), one instruction for four channels; on
// the scalar path a float atomicAdd. A sum that is all exactly zero (no
// sample of the column reaches it, or a zero unit of g: on the training
// path the 2x2 max pool's backward zeroes three of every four samples of a
// channel) adds nothing: +-0 added to a cell that starts at +0 changes no
// bit of it. At the stock training shape's fixture in chip_smoke.py (most
// rois small, on P2, their samples less than a cell apart) the walk issues
// 2.1x fewer reductions than one per tap. A second column tap clamped onto
// the plane's last column (an image whose last valid cell lies past the
// plane) is added to that column, where the forward reads it.
//
// Exactness: built with -fmad=false and without fast math. Blocks run in
// parallel, so rois (and the row groups of one roi) that share a cell add
// in an order that changes from run to run: the result is not bitwise
// deterministic. Against the plain version (autograd through two matmuls;
// where the image extents fit the planes, since past them its tent over the
// plane's cells drops a clamped tap) each cell agrees within 1e-5 of
// sum |g * w| over the terms it adds (the plain backward applied to |g|): a
// float sum of n terms taken in another order moves by a few ulps of that
// sum. A deterministic roi-sorted segmented sum is later work.

#include "roi_align_common.cuh"

namespace {

using roi_align::kMaxCrop;
using roi_align::Taps;

constexpr int kThreads = 128;  // block: (row, unit) pairs of kRows rows of 64 float4 units
constexpr int kRows = 2;       // sample rows of a roi per block
constexpr int kBatch = 14;     // samples of a row whose g a thread loads before it adds any

__device__ __forceinline__ bool all_zero(float v) { return v == 0.0f; }
__device__ __forceinline__ bool all_zero(float4 v) {
  return v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

__device__ __forceinline__ float scaled(float w, float g) { return w * g; }
__device__ __forceinline__ float4 scaled(float w, float4 g) {
  return make_float4(w * g.x, w * g.y, w * g.z, w * g.w);
}

// acc + w * g, the product and the sum each rounded on its own
__device__ __forceinline__ float add_scaled(float acc, float w, float g) { return acc + w * g; }
__device__ __forceinline__ float4 add_scaled(float4 acc, float w, float4 g) {
  return make_float4(acc.x + w * g.x, acc.y + w * g.y, acc.z + w * g.z, acc.w + w * g.w);
}

// One reduction into a gradient plane: a float atomic on the scalar path,
// one 16-byte vector reduction on the float4 path.
__device__ __forceinline__ void reduce_add(float* dst, float v) { atomicAdd(dst, v); }
__device__ __forceinline__ void reduce_add(float4* dst, float4 v) { atomicAdd(dst, v); }

// g of samples [j0, j0 + kBatch) of a row at one unit (src: the row's g at
// that unit; samples are `units` apart), streaming: g is read once.
template <typename T>
__device__ __forceinline__ void load_batch(const T* __restrict__ src, int units, int j0, int crop,
                                           T (&g)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (j0 + u < crop) g[u] = __ldcs(src + static_cast<size_t>(j0 + u) * units);
  }
}

// Adds r, the sum over a row's samples of w_x * g at column x, to the
// column's cells of the row's two taps: w_y * r to each tap of nonzero
// weight w_y. A sum that is all exactly zero adds nothing.
template <typename T>
__device__ __forceinline__ void add_column(T* __restrict__ plane, int plane_w, int units,
                                           const Taps& yt, int x, const T& r) {
  if (all_zero(r)) return;
  T* col = plane + static_cast<size_t>(x) * units;
  const size_t row = static_cast<size_t>(plane_w) * units;
  if (yt.w0 != 0.0f) reduce_add(col + yt.i0 * row, scaled(yt.w0, r));
  if (yt.w1 != 0.0f) reduce_add(col + yt.i1 * row, scaled(yt.w1, r));
}

// One thread's work: sample row `yt` of a roi at one unit (plane and src
// offset to that unit). It walks the row's samples in order, keeping the
// sums r_a, r_b of w_x * g for the current columns a and a + 1 in registers:
// a sample's column taps are a and a + 1 (or both a, where the plane's last
// column clamps the second; or its second tap has weight 0), and the
// samples' columns only grow along a row, so a column's sum is complete, and
// added to the plane, when the walk passes it. (For a roi with x2 < x1 they
// shrink: both sums are added whenever the first column moves.)
template <typename T>
__device__ __forceinline__ void walk_row(T* __restrict__ plane, int plane_w, int units, int crop,
                                         const Taps& yt, const Taps* tx, const int* x_in,
                                         const T* __restrict__ src, T (&g)[kBatch]) {
  int a = -2;  // no current column
  T ra = zero<T>(), rb = zero<T>();
  for (int j0 = 0; j0 < crop; j0 += kBatch) {
    if (j0 > 0) load_batch(src, units, j0, crop, g);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u;
      if (j >= crop || !x_in[j]) continue;
      const Taps xt = tx[j];
      if (xt.i0 != a) {
        add_column(plane, plane_w, units, yt, a, ra);
        if (xt.i0 == a + 1) {
          ra = rb;
        } else {
          add_column(plane, plane_w, units, yt, a + 1, rb);
          ra = zero<T>();
        }
        rb = zero<T>();
        a = xt.i0;
      }
      ra = add_scaled(ra, xt.w0, g[u]);
      if (xt.w1 != 0.0f) {
        if (xt.i1 == a) {
          ra = add_scaled(ra, xt.w1, g[u]);  // clamped onto column a
        } else {
          rb = add_scaled(rb, xt.w1, g[u]);
        }
      }
    }
  }
  add_column(plane, plane_w, units, yt, a, ra);
  add_column(plane, plane_w, units, yt, a + 1, rb);
}

// The block's rows, in units of T: thread e takes row e / units at unit
// e % units, so neighbouring threads load and add neighbouring channels. A
// thread's first batch of g is in flight while the block computes its taps.
template <typename T>
__device__ __forceinline__ void block_rows(const roi_align::Level<float>& level,
                                           const float* roi_xyxy, float image_h, float image_w,
                                           int row_first, int rows, int crop, int units,
                                           T* __restrict__ plane, const T* __restrict__ src,
                                           Taps* ty, int* y_in, Taps* tx, int* x_in) {
  T g[kBatch];
  const int total = rows * units;
  if (threadIdx.x < total) {
    const int r = threadIdx.x / units;
    load_batch(src + static_cast<size_t>(r) * crop * units + (threadIdx.x - r * units), units, 0,
               crop, g);
  }
  roi_align::block_taps(level, roi_xyxy, image_h, image_w, crop, row_first, rows, ty, y_in, tx,
                        x_in);
  __syncthreads();
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / units;
    const int q = e - r * units;
    const T* row = src + static_cast<size_t>(r) * crop * units + q;
    if (e != threadIdx.x) load_batch(row, units, 0, crop, g);
    if (y_in[r]) walk_row(plane + q, level.w, units, crop, ty[r], tx, x_in, row, g);
  }
}

// grid (B * N * ceil(S / kRows)), block kThreads.
__global__ void __launch_bounds__(kThreads)
roi_align_ml_backward_kernel(roi_align::Pyramid<float> grad, const float* __restrict__ rois,
                             const int64_t* __restrict__ levels,
                             const uint8_t* __restrict__ valid,
                             const float* __restrict__ image_h, const float* __restrict__ image_w,
                             int n, int c, int crop, int vec, const float* __restrict__ grad_out) {
  __shared__ Taps ty[kRows];
  __shared__ int y_in[kRows];
  __shared__ Taps tx[kMaxCrop];
  __shared__ int x_in[kMaxCrop];

  const int groups = (crop + kRows - 1) / kRows;
  const int roi = blockIdx.x / groups;  // b * n + r
  const int64_t lvl = levels[roi];
  if (!valid[roi] || lvl < 0 || lvl >= grad.n_levels) return;
  const int row_first = (blockIdx.x - roi * groups) * kRows;
  const int rows = min(kRows, crop - row_first);
  const int b = roi / n;
  const roi_align::Level<float> level = grad.level[lvl];
  const float* r = rois + static_cast<size_t>(roi) * 4;
  // this block's rows of g: [rows, S, C] at row row_first of roi
  const float* src = grad_out + (static_cast<size_t>(roi) * crop + row_first) * crop * c;
  float* plane = level.data + static_cast<size_t>(b) * level.h * level.w * c;
  if (vec) {
    block_rows(level, r, image_h[b], image_w[b], row_first, rows, crop, c / 4,
               reinterpret_cast<float4*>(plane), reinterpret_cast<const float4*>(src), ty, y_in,
               tx, x_in);
  } else {
    block_rows(level, r, image_h[b], image_w[b], row_first, rows, crop, c, plane, src, ty, y_in,
               tx, x_in);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// grad_planes[l] [B, heights[l], widths[l], C] f32 (NHWC, contiguous, zeroed
// by the caller; the gradients are added into them), strides[l]; rois
// [B, N, 4] f32 xyxy pixels; levels [B, N] i64 index into the planes; valid
// [B, N] u8; image_h / image_w [B] f32; vec: 1 for the float4 path
// (C % 4 == 0, every gradient plane and `grad_out` 16-byte aligned), 0 for
// the scalar path; grad_out [B, N, S, S, C] f32. Launches on `stream`;
// returns cudaGetLastError() (or an invalid-value error for arguments the
// kernel does not take).
int roi_align_multilevel_backward_cuda(void* const* grad_planes, const int* heights,
                                       const int* widths, const float* strides, int n_levels,
                                       const float* rois, const int64_t* levels,
                                       const uint8_t* valid, const float* image_h,
                                       const float* image_w, int batch, int n, int c,
                                       int crop, int vec, const float* grad_out, int device,
                                       void* stream) {
  if (!roi_align::launch_args_ok(n_levels, crop, batch, n, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks =
      static_cast<long long>(batch) * n * ((crop + kRows - 1) / kRows);
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    bool ok = c % 4 == 0 && aligned16(grad_out);
    for (int l = 0; l < n_levels; ++l) ok = ok && aligned16(grad_planes[l]);
    if (!ok) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto grad =
      roi_align::make_pyramid<float>(grad_planes, heights, widths, strides, n_levels);
  roi_align_ml_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      grad, rois, levels, valid, image_h, image_w, n, c, crop, vec, grad_out);
  return static_cast<int>(cudaGetLastError());
}

const char* roi_align_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
