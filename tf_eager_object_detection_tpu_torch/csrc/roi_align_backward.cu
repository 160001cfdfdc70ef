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
// Design: one block per roi over a [B*N] grid, one thread per channel; the
// block's 2S sample coordinates go to shared memory once; each in-range
// sample adds its four weighted taps with float atomicAdd (NHWC, so the
// adds of a warp are coalesced along C). The TPU kernel needed no atomics:
// its grid steps run in order. Blocks here run in parallel, so rois that
// share a cell add in an order that changes from run to run: the result is
// not bitwise deterministic. Against the plain version (autograd through
// two matmuls) each cell agrees within 1e-5 of sum |g * w| over the terms
// it adds (the plain backward applied to |g|): a float sum of n terms taken
// in another order moves by a few ulps of that sum.
//
// What bounds it on this card: at the stock training shape (B=1, N=256,
// S=14, C=256) it reads 51.4 MB of g and the gradient planes of a 640x1024
// bucket are 55.7 MB (zeroed and written), ~0.03 ms at 3.35 TB/s; it issues
// up to 256 * 196 * 4 * 256 = 51 M float atomics, which the L2's atomic
// rate rather than the bytes is expected to pace. A deterministic
// roi-sorted segmented sum, or staging a roi's footprint in shared memory,
// is later work.

#include "roi_align_common.cuh"

namespace {

using roi_align::kMaxCrop;
using roi_align::kMaxThreads;

// grid (B*N), block threads_for(C) threads.
__global__ void __launch_bounds__(kMaxThreads)
roi_align_ml_backward_kernel(roi_align::Pyramid<float> grad, const float* __restrict__ rois,
                             const int64_t* __restrict__ levels,
                             const uint8_t* __restrict__ valid,
                             const float* __restrict__ image_h, const float* __restrict__ image_w,
                             int n, int c, int crop, const float* __restrict__ grad_out) {
  __shared__ float ys[kMaxCrop];
  __shared__ float xs[kMaxCrop];
  __shared__ int y_in[kMaxCrop];
  __shared__ int x_in[kMaxCrop];

  const int roi = blockIdx.x;  // b * n + r
  const int b = roi / n;
  const int64_t lvl = levels[roi];
  if (!valid[roi] || lvl < 0 || lvl >= grad.n_levels) return;
  const roi_align::Level<float> level = grad.level[lvl];
  roi_align::roi_sample_coords(level, rois, image_h, image_w, roi, b, crop, ys, xs, y_in, x_in);
  __syncthreads();

  const size_t per_roi = static_cast<size_t>(crop) * crop * c;
  const float* src = grad_out + static_cast<size_t>(roi) * per_roi;
  float* plane = level.data + static_cast<size_t>(b) * level.h * level.w * c;
  for (int i = 0; i < crop; ++i) {
    if (!y_in[i]) continue;
    const roi_align::Taps ty = roi_align::taps(ys[i], level.h);
    const size_t row0 = static_cast<size_t>(ty.i0) * level.w;
    const size_t row1 = static_cast<size_t>(ty.i1) * level.w;
    for (int j = 0; j < crop; ++j) {
      if (!x_in[j]) continue;
      const roi_align::Taps tx = roi_align::taps(xs[j], level.w);
      // the forward's sample is tx.w0 * (ty.w0 f00 + ty.w1 f10)
      //                        + tx.w1 * (ty.w0 f01 + ty.w1 f11)
      const float w00 = tx.w0 * ty.w0;
      const float w10 = tx.w0 * ty.w1;
      const float w01 = tx.w1 * ty.w0;
      const float w11 = tx.w1 * ty.w1;
      float* d00 = plane + (row0 + tx.i0) * c;
      float* d01 = plane + (row0 + tx.i1) * c;
      float* d10 = plane + (row1 + tx.i0) * c;
      float* d11 = plane + (row1 + tx.i1) * c;
      const float* gs = src + (static_cast<size_t>(i) * crop + j) * c;
      for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
        const float g = gs[ch];
        if (w00 != 0.0f) atomicAdd(d00 + ch, w00 * g);
        if (w01 != 0.0f) atomicAdd(d01 + ch, w01 * g);
        if (w10 != 0.0f) atomicAdd(d10 + ch, w10 * g);
        if (w11 != 0.0f) atomicAdd(d11 + ch, w11 * g);
      }
    }
  }
}

}  // namespace

extern "C" {

// grad_planes[l] [B, heights[l], widths[l], C] f32 (NHWC, contiguous, zeroed
// by the caller; the gradients are added into them), strides[l]; rois
// [B, N, 4] f32 xyxy pixels; levels [B, N] i64 index into the planes; valid
// [B, N] u8; image_h / image_w [B] f32; grad_out [B, N, S, S, C] f32.
// Launches on `stream`; returns cudaGetLastError() (or an invalid-value error
// for arguments the kernel does not take).
int roi_align_multilevel_backward_cuda(void* const* grad_planes, const int* heights,
                                       const int* widths, const float* strides, int n_levels,
                                       const float* rois, const int64_t* levels,
                                       const uint8_t* valid, const float* image_h,
                                       const float* image_w, int batch, int n, int c, int crop,
                                       const float* grad_out, int device, void* stream) {
  if (!roi_align::launch_args_ok(n_levels, crop, batch, n, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto grad =
      roi_align::make_pyramid<float>(grad_planes, heights, widths, strides, n_levels);
  roi_align_ml_backward_kernel<<<batch * n, roi_align::threads_for(c), 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      grad, rois, levels, valid, image_h, image_w, n, c, crop, grad_out);
  return static_cast<int>(cudaGetLastError());
}

const char* roi_align_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
