// Fused-pyramid RoIAlign forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ml_kernel` in
// tf_eager_object_detection_tpu/ops/pallas/roi_align_pallas.py (wrapped by
// `_ml_forward` and `pallas_roi_align_multilevel`): every roi of a batch is
// sampled, with TF crop_and_resize semantics, from the pyramid level it is
// assigned to; rois with valid == 0 (or a level outside the pyramid) give
// zeros. Output [B, N, S, S, C] float32, before the 2x2 max pool. With one
// level it is the single-level kernel `_kernel` (K2) as well.
//
// Sampling (the arithmetic of the JAX `_window_geometry` / `_coord_scales`
// and of the plain PyTorch version `roi_align_multilevel_reference`): on a
// level of stride s the last valid cell of an image of extent d is
// b = ceil(d / s) - 1, pixel p maps to p * (b / d), sample i of S lies at
// c1 + ((c2 - c1) * i) * r, r the float32 reciprocal of S - 1 (the product
// XLA compiles the JAX division into), counts as inside when it lies in
// [-1e-3, b + 1e-3], and is clamped to [0, b]. Each sample is the tent
// weight max(0, 1 - |y - cell|) on its two neighbouring cells along each
// axis, summed over y first and then over x, like the plain version's two
// matmuls. The TPU kernel copies a fixed 64-cell window around each roi
// into VMEM (aligned to (8, 128) tiles, planes padded to the window) and
// truncates rois longer than the window; here every sample reads its four
// taps straight from the plane, so nothing is truncated and no plane is
// padded. A tap index is clamped to the plane, so a sample on the last cell
// never reads past it (its second tap has weight 0).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxCrop = 64;
constexpr int kMaxThreads = 256;
constexpr float kEdgeEps = 1e-3f;

struct Level {
  const float* data;  // [B, H, W, C]
  int h;
  int w;
  float stride;
};

struct Pyramid {
  Level level[kMaxLevels];
  int n_levels;
};

// Sample i of one axis of a roi spanning [lo, hi] pixels on a level of
// `stride`, for an image of valid extent `dim` (see the header).
__device__ __forceinline__ void sample_coord(float lo, float hi, float dim, float stride, int i,
                                             int crop, float* coord, int* in_range) {
  const float last = ceilf(dim / stride) - 1.0f;
  const float g = last / dim;
  const float c1 = lo * g;
  const float c2 = hi * g;
  const float recip = 1.0f / static_cast<float>(crop - 1);
  const float v = c1 + ((c2 - c1) * static_cast<float>(i)) * recip;
  *in_range = (v >= -kEdgeEps) && (v <= last + kEdgeEps);
  *coord = fminf(fmaxf(v, 0.0f), last);
}

// grid (B*N), block min(256, C rounded up to a warp) threads.
__global__ void __launch_bounds__(kMaxThreads)
roi_align_ml_kernel(Pyramid pyr, const float* __restrict__ rois,
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
  const Level level = pyr.level[lvl];
  const float* r = rois + static_cast<size_t>(roi) * 4;  // x1, y1, x2, y2
  for (int t = threadIdx.x; t < 2 * crop; t += blockDim.x) {
    if (t < crop) {
      sample_coord(r[1], r[3], image_h[b], level.stride, t, crop, &ys[t], &y_in[t]);
    } else {
      const int j = t - crop;
      sample_coord(r[0], r[2], image_w[b], level.stride, j, crop, &xs[j], &x_in[j]);
    }
  }
  __syncthreads();

  const float* plane = level.data + static_cast<size_t>(b) * level.h * level.w * c;
  for (int i = 0; i < crop; ++i) {
    const float y = ys[i];
    const int y0 = static_cast<int>(floorf(y));
    const float wy0 = fmaxf(0.0f, 1.0f - fabsf(y - static_cast<float>(y0)));
    const float wy1 = fmaxf(0.0f, 1.0f - fabsf(y - static_cast<float>(y0 + 1)));
    const size_t row0 = static_cast<size_t>(min(y0, level.h - 1)) * level.w;
    const size_t row1 = static_cast<size_t>(min(y0 + 1, level.h - 1)) * level.w;
    for (int j = 0; j < crop; ++j) {
      float* o = dst + (static_cast<size_t>(i) * crop + j) * c;
      if (!(y_in[i] && x_in[j])) {
        for (int ch = threadIdx.x; ch < c; ch += blockDim.x) o[ch] = 0.0f;
        continue;
      }
      const float x = xs[j];
      const int x0 = static_cast<int>(floorf(x));
      const float wx0 = fmaxf(0.0f, 1.0f - fabsf(x - static_cast<float>(x0)));
      const float wx1 = fmaxf(0.0f, 1.0f - fabsf(x - static_cast<float>(x0 + 1)));
      const size_t col0 = static_cast<size_t>(min(x0, level.w - 1));
      const size_t col1 = static_cast<size_t>(min(x0 + 1, level.w - 1));
      const float* f00 = plane + (row0 + col0) * c;
      const float* f01 = plane + (row0 + col1) * c;
      const float* f10 = plane + (row1 + col0) * c;
      const float* f11 = plane + (row1 + col1) * c;
      for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
        const float left = wy0 * f00[ch] + wy1 * f10[ch];   // column x0, summed over y
        const float right = wy0 * f01[ch] + wy1 * f11[ch];  // column x0 + 1
        o[ch] = wx0 * left + wx1 * right;
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
  if (n_levels < 1 || n_levels > kMaxLevels || crop < 2 || crop > kMaxCrop || batch < 1 ||
      n < 1 || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Pyramid pyr = {};
  pyr.n_levels = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    pyr.level[l].data = static_cast<const float*>(planes[l]);
    pyr.level[l].h = heights[l];
    pyr.level[l].w = widths[l];
    pyr.level[l].stride = strides[l];
  }
  int threads = ((c + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  roi_align_ml_kernel<<<batch * n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      pyr, rois, levels, valid, image_h, image_w, n, c, crop, out);
  return static_cast<int>(cudaGetLastError());
}

const char* roi_align_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
