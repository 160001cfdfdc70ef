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
// Sampling and tap arithmetic: roi_align_common.cuh (`sample_coord`,
// `taps`), shared with the backward (roi_align_backward.cu). Each sample is
// summed over y first and then over x, like the plain version's two matmuls.
// The TPU kernel copies a fixed 64-cell window around each roi into VMEM
// (aligned to (8, 128) tiles, planes padded to the window) and truncates
// rois longer than the window; here every sample reads its four taps
// straight from the plane, so nothing is truncated and no plane is padded.
//
// What bounds it on this card: memory. At the served shape (B=4, N=1000,
// S=14, C=256) it writes 803 MB and reads at most the 223 MB of the four
// planes, so the bound is ~0.29 ms at 3.35 TB/s; the arithmetic (9 flops per
// sample and channel) is ~1.8 GFLOP, 27 us at the float32 rate. At the
// training shape (B=1, N=256) the bound is ~0.07 ms.
//
// Design: one block per (roi, group of kRows sample rows), a grid of
// B * N * ceil(S / kRows) blocks; the block's threads are spread over all of
// its samples and channels at once, (sample, channel unit) pairs flattened
// so that neighbouring threads read and write neighbouring addresses (NHWC).
// A channel unit is 4 channels moved as one 16-byte float4 when C % 4 == 0
// and the planes and the output are 16-byte aligned (the wrapper checks and
// passes `vec`); otherwise a unit is one channel (the scalar path of the
// same kernel). Each thread issues the four tap loads of kUnroll samples
// before it blends any of them, so kUnroll * 4 = 8 loads are in flight per
// thread (at ~60 registers, four blocks fit an SM), and writes each sample
// with a streaming store (the output is not read again by this kernel). The
// sample coordinates and taps of the block's rows and columns are computed
// once into shared memory.
//
// Why this beats the per-roi walk it replaces (one block per roi over a
// [B*N] grid, one thread per channel, 4-byte loads and stores, the roi's
// S * S samples visited one after another): a launch no longer lasts as
// long as one roi's serial walk of 196 samples (the ~0.13 ms floor per
// launch at B=1, N=256, where 256 blocks met 132 SMs), each block does one
// short pass, and each thread moves 16 bytes per load with many loads in
// flight instead of 4 bytes with one.
//
// Exactness: built with -fmad=false and without fast math, so every float
// operation rounds as in the plain version, and each channel's arithmetic
// (two weighted sums over y, then one over x, each product and sum rounded
// on its own) is that of the per-roi kernel it replaces: the outputs are
// the same bits. Kernel and plain version differ only in the order in which
// the plain version's matmuls add their (exactly zero) off-tent terms.

#include "roi_align_common.cuh"

namespace {

using roi_align::kMaxCrop;
using roi_align::Taps;

constexpr int kThreads = 256;  // block
constexpr int kRows = 2;       // sample rows of a roi per block
constexpr int kUnroll = 2;     // samples whose taps a thread loads before blending

__device__ __forceinline__ float blend(const Taps& ty, const Taps& tx, float f00, float f01,
                                       float f10, float f11) {
  const float left = ty.w0 * f00 + ty.w1 * f10;   // column x0, summed over y
  const float right = ty.w0 * f01 + ty.w1 * f11;  // column x0 + 1
  return tx.w0 * left + tx.w1 * right;
}

__device__ __forceinline__ float4 blend(const Taps& ty, const Taps& tx, float4 f00, float4 f01,
                                        float4 f10, float4 f11) {
  return make_float4(blend(ty, tx, f00.x, f01.x, f10.x, f11.x),
                     blend(ty, tx, f00.y, f01.y, f10.y, f11.y),
                     blend(ty, tx, f00.z, f01.z, f10.z, f11.z),
                     blend(ty, tx, f00.w, f01.w, f10.w, f11.w));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

// The block's `rows` sample rows: element e = (row r, sample j, unit q) of
// `units` units of T per sample. plane: this image's plane in units of T.
template <typename T>
__device__ __forceinline__ void sample_rows(const T* __restrict__ plane, int plane_w, int units,
                                            int rows, int crop, const Taps* ty, const int* y_in,
                                            const Taps* tx, const int* x_in,
                                            T* __restrict__ dst) {
  const int per_row = crop * units;
  const int total = rows * per_row;
  for (int e0 = threadIdx.x; e0 < total; e0 += kUnroll * kThreads) {
    T f00[kUnroll], f01[kUnroll], f10[kUnroll], f11[kUnroll];
    int r_of[kUnroll], j_of[kUnroll];
    bool inside[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / per_row;
      const int rem = e - r * per_row;
      const int j = rem / units;
      const int q = rem - j * units;
      r_of[u] = r;
      j_of[u] = j;
      inside[u] = e < total && y_in[r] && x_in[j];
      if (inside[u]) {
        const size_t row0 = static_cast<size_t>(ty[r].i0) * plane_w;
        const size_t row1 = static_cast<size_t>(ty[r].i1) * plane_w;
        f00[u] = __ldg(plane + (row0 + tx[j].i0) * units + q);
        f01[u] = __ldg(plane + (row0 + tx[j].i1) * units + q);
        f10[u] = __ldg(plane + (row1 + tx[j].i0) * units + q);
        f11[u] = __ldg(plane + (row1 + tx[j].i1) * units + q);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads;
      if (e < total) {
        __stcs(dst + e, inside[u] ? blend(ty[r_of[u]], tx[j_of[u]], f00[u], f01[u], f10[u],
                                          f11[u])
                                  : zero<T>());
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void zero_rows(int n, T* __restrict__ dst) {
  for (int e = threadIdx.x; e < n; e += kThreads) __stcs(dst + e, zero<T>());
}

// grid (B * N * ceil(S / kRows)), block kThreads.
__global__ void __launch_bounds__(kThreads)
roi_align_ml_kernel(roi_align::Pyramid<const float> pyr, const float* __restrict__ rois,
                    const int64_t* __restrict__ levels, const uint8_t* __restrict__ valid,
                    const float* __restrict__ image_h, const float* __restrict__ image_w, int n,
                    int c, int crop, int vec, float* __restrict__ out) {
  __shared__ Taps ty[kRows];
  __shared__ int y_in[kRows];
  __shared__ Taps tx[kMaxCrop];
  __shared__ int x_in[kMaxCrop];

  const int groups = (crop + kRows - 1) / kRows;
  const int roi = blockIdx.x / groups;  // b * n + r
  const int row_lo = (blockIdx.x - roi * groups) * kRows;
  const int rows = min(kRows, crop - row_lo);
  const int b = roi / n;
  const int units = vec ? c / 4 : c;
  // this block's rows of the output: [rows, S, C] at row row_lo of roi
  const size_t dst0 = (static_cast<size_t>(roi) * crop + row_lo) * crop * c;
  const int64_t lvl = levels[roi];
  if (!valid[roi] || lvl < 0 || lvl >= pyr.n_levels) {
    if (vec) {
      zero_rows(rows * crop * units, reinterpret_cast<float4*>(out + dst0));
    } else {
      zero_rows(rows * crop * units, out + dst0);
    }
    return;
  }
  const roi_align::Level<const float> level = pyr.level[lvl];
  const float* r = rois + static_cast<size_t>(roi) * 4;  // x1, y1, x2, y2
  const int t = threadIdx.x;
  if (t < crop) {
    float x;
    roi_align::sample_coord(r[0], r[2], image_w[b], level.stride, t, crop, &x, &x_in[t]);
    tx[t] = roi_align::taps(x, level.w);
  } else if (t < crop + rows) {
    float y;
    roi_align::sample_coord(r[1], r[3], image_h[b], level.stride, row_lo + t - crop, crop, &y,
                            &y_in[t - crop]);
    ty[t - crop] = roi_align::taps(y, level.h);
  }
  __syncthreads();

  const float* plane = level.data + static_cast<size_t>(b) * level.h * level.w * c;
  if (vec) {
    sample_rows(reinterpret_cast<const float4*>(plane), level.w, units, rows, crop, ty, y_in, tx,
                x_in, reinterpret_cast<float4*>(out + dst0));
  } else {
    sample_rows(plane, level.w, units, rows, crop, ty, y_in, tx, x_in, out + dst0);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// planes[l] [B, heights[l], widths[l], C] f32 (NHWC, contiguous), strides[l];
// rois [B, N, 4] f32 xyxy pixels; levels [B, N] i64 index into planes;
// valid [B, N] u8; image_h / image_w [B] f32; vec: 1 for the float4 path
// (C % 4 == 0, every plane and `out` 16-byte aligned), 0 for the scalar
// path; out [B, N, S, S, C] f32. Launches on `stream`; returns
// cudaGetLastError() (or an invalid-value error for arguments the kernel
// does not take).
int roi_align_multilevel_cuda(const void* const* planes, const int* heights, const int* widths,
                              const float* strides, int n_levels, const float* rois,
                              const int64_t* levels, const uint8_t* valid, const float* image_h,
                              const float* image_w, int batch, int n, int c, int crop, int vec,
                              float* out, int device, void* stream) {
  if (!roi_align::launch_args_ok(n_levels, crop, batch, n, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks =
      static_cast<long long>(batch) * n * ((crop + kRows - 1) / kRows);
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    bool ok = c % 4 == 0 && aligned16(out);
    for (int l = 0; l < n_levels; ++l) ok = ok && aligned16(planes[l]);
    if (!ok) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto pyr =
      roi_align::make_pyramid<const float>(planes, heights, widths, strides, n_levels);
  roi_align_ml_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(pyr, rois, levels, valid, image_h,
                                                             image_w, n, c, crop, vec, out);
  return static_cast<int>(cudaGetLastError());
}

const char* roi_align_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
