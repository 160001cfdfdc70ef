// Fused-pyramid RoIAlign forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ml_kernel` in
// tf_eager_object_detection_tpu/ops/pallas/roi_align_pallas.py (wrapped by
// `_ml_forward` and `pallas_roi_align_multilevel`): every roi of a batch is
// sampled, with TF crop_and_resize semantics, from the pyramid level it is
// assigned to; rois with valid == 0 (or a level outside the pyramid) give
// zeros. Output [B, N, S, S, C] float32, before the 2x2 max pool. Launched
// with one plane (levels all 0, valid = active) it is the single-level
// kernel `_kernel` (K2) as well; its gradient is roi_align_backward.cu.
//
// Sampling and tap arithmetic: roi_align_common.cuh, shared with the backward
// (roi_align_backward.cu). Each sample is summed over y first and then over
// x, like the plain version's two matmuls. The TPU kernel copies a fixed
// 64-cell window around each roi into VMEM (aligned to (8, 128) tiles,
// planes padded to the window) and truncates rois longer than the window;
// here every sample reads its four taps straight from the plane, so nothing
// is truncated and no plane is padded.
//
// What bounds it on this card: memory. At the served shape (B=4, N=1000,
// S=14, C=256) it writes 803 MB and reads at most the 223 MB of the four
// planes, so the bound is ~0.3 ms at 3.35 TB/s; the arithmetic (9 flops per
// sample and channel) is ~1.8 GFLOP, 27 us at the float32 rate. The design:
// one block per roi over a [B*N] grid, one thread per channel, so the four
// tap reads and the output write of a sample are coalesced along C (NHWC);
// the block's 2S sample coordinates are computed once into shared memory.
// Taps shared by neighbouring samples and rois are left to L1/L2.
//
// Exactness: built with -fmad=false and without fast math, so every float
// operation rounds as in the plain version; the two differ only in the order
// in which the matmuls add their (exactly zero) off-tent terms.

#include "roi_align_common.cuh"

namespace {

using roi_align::kMaxCrop;
using roi_align::kMaxThreads;

// grid (B*N), block threads_for(C) threads.
__global__ void __launch_bounds__(kMaxThreads)
roi_align_ml_kernel(roi_align::Pyramid<const float> pyr, const float* __restrict__ rois,
                    const int64_t* __restrict__ levels, const uint8_t* __restrict__ valid,
                    const float* __restrict__ image_h, const float* __restrict__ image_w, int n,
                    int c, int crop, float* __restrict__ out) {
  __shared__ float ys[kMaxCrop];
  __shared__ float xs[kMaxCrop];
  __shared__ int y_in[kMaxCrop];
  __shared__ int x_in[kMaxCrop];

  const int roi = blockIdx.x;  // b * n + r
  const int b = roi / n;
  const size_t per_roi = static_cast<size_t>(crop) * crop * c;
  float* dst = out + static_cast<size_t>(roi) * per_roi;
  const int64_t lvl = levels[roi];
  if (!valid[roi] || lvl < 0 || lvl >= pyr.n_levels) {
    for (size_t t = threadIdx.x; t < per_roi; t += blockDim.x) dst[t] = 0.0f;
    return;
  }
  const roi_align::Level<const float> level = pyr.level[lvl];
  roi_align::roi_sample_coords(level, rois, image_h, image_w, roi, b, crop, ys, xs, y_in, x_in);
  __syncthreads();

  const float* plane = level.data + static_cast<size_t>(b) * level.h * level.w * c;
  for (int i = 0; i < crop; ++i) {
    const roi_align::Taps ty = roi_align::taps(ys[i], level.h);
    const size_t row0 = static_cast<size_t>(ty.i0) * level.w;
    const size_t row1 = static_cast<size_t>(ty.i1) * level.w;
    for (int j = 0; j < crop; ++j) {
      float* o = dst + (static_cast<size_t>(i) * crop + j) * c;
      if (!(y_in[i] && x_in[j])) {
        for (int ch = threadIdx.x; ch < c; ch += blockDim.x) o[ch] = 0.0f;
        continue;
      }
      const roi_align::Taps tx = roi_align::taps(xs[j], level.w);
      const float* f00 = plane + (row0 + tx.i0) * c;
      const float* f01 = plane + (row0 + tx.i1) * c;
      const float* f10 = plane + (row1 + tx.i0) * c;
      const float* f11 = plane + (row1 + tx.i1) * c;
      for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
        const float left = ty.w0 * f00[ch] + ty.w1 * f10[ch];   // column x0, summed over y
        const float right = ty.w0 * f01[ch] + ty.w1 * f11[ch];  // column x0 + 1
        o[ch] = tx.w0 * left + tx.w1 * right;
      }
    }
  }
}

}  // namespace

extern "C" {

// planes[l] [B, heights[l], widths[l], C] f32 (NHWC, contiguous), strides[l];
// rois [B, N, 4] f32 xyxy pixels; levels [B, N] i64 index into planes;
// valid [B, N] u8; image_h / image_w [B] f32; out [B, N, S, S, C] f32.
// Launches on `stream`; returns cudaGetLastError() (or an invalid-value error
// for arguments the kernel does not take).
int roi_align_multilevel_cuda(const void* const* planes, const int* heights, const int* widths,
                              const float* strides, int n_levels, const float* rois,
                              const int64_t* levels, const uint8_t* valid, const float* image_h,
                              const float* image_w, int batch, int n, int c, int crop,
                              float* out, int device, void* stream) {
  if (!roi_align::launch_args_ok(n_levels, crop, batch, n, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto pyr =
      roi_align::make_pyramid<const float>(planes, heights, widths, strides, n_levels);
  roi_align_ml_kernel<<<batch * n, roi_align::threads_for(c), 0,
                        static_cast<cudaStream_t>(stream)>>>(pyr, rois, levels, valid, image_h,
                                                             image_w, n, c, crop, out);
  return static_cast<int>(cudaGetLastError());
}

const char* roi_align_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
