// What the RoIAlign forward (roi_align.cu) and backward (roi_align_backward.cu)
// kernels share: the pyramid passed by value, and the sample arithmetic. One
// definition, so the backward scatters to exactly the taps the forward reads.
//
// Sampling (the arithmetic of the JAX `_window_geometry` / `_coord_scales`
// and of the plain PyTorch version `roi_align_multilevel_reference`): on a
// level of stride s the last valid cell of an image of extent d is
// b = ceil(d / s) - 1, pixel p maps to p * (b / d), sample i of S lies at
// c1 + ((c2 - c1) * i) * r, r the float32 reciprocal of S - 1 (the product
// XLA compiles the JAX division into), counts as inside when it lies in
// [-1e-3, b + 1e-3], and is clamped to [0, b]. A sample at y weighs its two
// neighbouring cells along the axis by the tent max(0, 1 - |y - cell|); a
// tap index is clamped to the plane, so a sample on the last cell never
// reads past it (its second tap has weight 0).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace roi_align {

constexpr int kMaxLevels = 8;
constexpr int kMaxCrop = 64;
constexpr float kEdgeEps = 1e-3f;

template <typename T>
struct Level {
  T* data;  // [B, H, W, C]
  int h;
  int w;
  float stride;
};

template <typename T>
struct Pyramid {
  Level<T> level[kMaxLevels];
  int n_levels;
};

// Sample i of one axis of a roi spanning [lo, hi] pixels on a level of
// `stride`, for an image of valid extent `dim`.
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

// The two taps of a clamped sample coordinate along an axis of `size` cells:
// cell indices (clamped to the plane) and tent weights.
struct Taps {
  int i0;
  int i1;
  float w0;
  float w1;
};

__device__ __forceinline__ Taps taps(float v, int size) {
  const int c0 = static_cast<int>(floorf(v));
  Taps t;
  t.w0 = fmaxf(0.0f, 1.0f - fabsf(v - static_cast<float>(c0)));
  t.w1 = fmaxf(0.0f, 1.0f - fabsf(v - static_cast<float>(c0 + 1)));
  t.i0 = min(c0, size - 1);
  t.i1 = min(c0 + 1, size - 1);
  return t;
}

// The taps of a block's sample columns (all `crop` of them) and of its
// `rows` sample rows from row `row_lo`, for roi `r` (x1, y1, x2, y2 pixels)
// of an image of valid extent (image_h, image_w) on `level`, into shared
// memory: thread t < crop takes column t, the next `rows` threads the rows
// (the block needs crop + rows threads); the caller synchronises. The same
// arithmetic as the forward's (roi_align.cu) prologue.
template <typename T>
__device__ __forceinline__ void block_taps(const Level<T>& level, const float* r, float image_h,
                                           float image_w, int crop, int row_lo, int rows,
                                           Taps* ty, int* y_in, Taps* tx, int* x_in) {
  const int t = threadIdx.x;
  if (t < crop) {
    float x;
    sample_coord(r[0], r[2], image_w, level.stride, t, crop, &x, &x_in[t]);
    tx[t] = taps(x, level.w);
  } else if (t < crop + rows) {
    float y;
    sample_coord(r[1], r[3], image_h, level.stride, row_lo + t - crop, crop, &y,
                 &y_in[t - crop]);
    ty[t - crop] = taps(y, level.h);
  }
}

// Pyramid of `n_levels` planes from the C interface's arrays.
template <typename T>
inline Pyramid<T> make_pyramid(const void* const* planes, const int* heights, const int* widths,
                               const float* strides, int n_levels) {
  Pyramid<T> pyr = {};
  pyr.n_levels = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    pyr.level[l].data = static_cast<T*>(const_cast<void*>(planes[l]));
    pyr.level[l].h = heights[l];
    pyr.level[l].w = widths[l];
    pyr.level[l].stride = strides[l];
  }
  return pyr;
}

inline bool launch_args_ok(int n_levels, int crop, int batch, int n, int c) {
  return n_levels >= 1 && n_levels <= kMaxLevels && crop >= 2 && crop <= kMaxCrop &&
         batch >= 1 && n >= 1 && c >= 1;
}

}  // namespace roi_align
