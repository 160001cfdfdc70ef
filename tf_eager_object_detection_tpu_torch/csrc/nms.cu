// Greedy non-maximum suppression over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_nms_kernel` in
// tf_eager_object_detection_tpu/ops/pallas/nms_pallas.py (wrapped by
// `pallas_nms_alive`): given boxes already in score-descending order and a
// validity mask, compute the alive mask of exact greedy NMS (strict
// `iou > thr`, no +1 pixel convention), capped at `max_output` kept boxes.
// A leading batch dimension covers the RPN (one row per image) and the
// class-batched per-class NMS (one row per class).
//
// What bounds it on this card: the greedy decision is a chain -- box i is kept
// only if no kept box before it overlaps it -- so some part of the work is
// serial. The TPU kernel breaks the chain into 128-box blocks with an
// in-block fixpoint because a Mosaic kernel has no cheap scalar loop. Here the
// work is split so that the serial part touches as few bytes as possible:
//
//   stage 1 (parallel, compute-light): every pair (i, c > i) gets one IoU
//     test; the results are packed 64 to a word into a [B, K, W] bit matrix,
//     W = ceil(K / 64). One thread per row box, one block per 64x64 tile,
//     tiles below the diagonal skipped. At K = 6000 this is 18M IoU tests and
//     4.5 MB of mask, a few microseconds of the card's bandwidth.
//   stage 2 (serial, latency-bound): one warp per batch row keeps a `removed`
//     bitset of W words in shared memory, seeded with the invalid slots. It
//     finds the next live box with a find-first-set over the current word and,
//     for each kept box only, ORs that box's mask row into `removed` with the
//     32 lanes splitting the words. Removed boxes cost no memory traffic at
//     all; the chain's length is the number of kept boxes (<= max_output), and
//     each link costs one L2 read of a W-word row.
//
// Exactness: the IoU is computed in the same float32 operations, in the same
// order, as the plain PyTorch version (`nms_alive_sorted_reference`) and the
// JAX `_nms_iou`. The build passes -fmad=false so that no multiply-add is
// contracted into an FMA, and never --use_fast_math, so the division is IEEE
// round-to-nearest: a box sitting at the threshold is decided alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // boxes per tile side == bits per mask word

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return (x2 - x1) * (y2 - y1);
}

// iou(a, b) > thr with the arithmetic of `_nms_iou` (ops/nms.py).
__device__ __forceinline__ bool overlaps(float ax1, float ay1, float ax2, float ay2,
                                         float a_area, float bx1, float by1, float bx2,
                                         float by2, float b_area, float thr) {
  const float iw = fmaxf(0.0f, fminf(ax2, bx2) - fmaxf(ax1, bx1));
  const float ih = fmaxf(0.0f, fminf(ay2, by2) - fmaxf(ay1, by1));
  const float inter = iw * ih;
  const float uni = (a_area + b_area) - inter;
  const float iou = inter > 0.0f ? inter / fmaxf(uni, 1e-12f) : 0.0f;
  return iou > thr;
}

// Stage 1. grid (W column tiles, W row tiles, B), block kTile threads.
// mask[b, i, t] bit j  <=>  c = t*64 + j > i  and  iou(i, c) > thr.
// Words below the diagonal (t < i / 64) are never written nor read.
__global__ void nms_mask_kernel(const float* __restrict__ boxes, int k, int words,
                                float thr, unsigned long long* __restrict__ mask) {
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  if (col_tile < row_tile) return;
  const float* bb = boxes + static_cast<size_t>(blockIdx.z) * k * 4;

  __shared__ float cols[kTile][5];
  const int c0 = col_tile * kTile;
  const int ncols = min(kTile, k - c0);
  if (threadIdx.x < ncols) {
    const float* c = bb + static_cast<size_t>(c0 + threadIdx.x) * 4;
    cols[threadIdx.x][0] = c[0];
    cols[threadIdx.x][1] = c[1];
    cols[threadIdx.x][2] = c[2];
    cols[threadIdx.x][3] = c[3];
    cols[threadIdx.x][4] = box_area(c[0], c[1], c[2], c[3]);
  }
  __syncthreads();

  const int i = row_tile * kTile + threadIdx.x;
  if (i >= k) return;
  const float* r = bb + static_cast<size_t>(i) * 4;
  const float x1 = r[0], y1 = r[1], x2 = r[2], y2 = r[3];
  const float area = box_area(x1, y1, x2, y2);
  unsigned long long bits = 0ull;
  const int start = (col_tile == row_tile) ? threadIdx.x + 1 : 0;
  for (int j = start; j < ncols; ++j) {
    if (overlaps(x1, y1, x2, y2, area, cols[j][0], cols[j][1], cols[j][2], cols[j][3],
                 cols[j][4], thr)) {
      bits |= 1ull << j;
    }
  }
  mask[(static_cast<size_t>(blockIdx.z) * k + i) * words + col_tile] = bits;
}

// Stage 2. grid (B), block one warp, dynamic shared memory W words.
__global__ void nms_scan_kernel(const uint8_t* __restrict__ valid,
                                const unsigned long long* __restrict__ mask, int k,
                                int words, int max_output, uint8_t* __restrict__ alive) {
  extern __shared__ unsigned long long removed[];
  const int lane = threadIdx.x;
  valid += static_cast<size_t>(blockIdx.x) * k;
  alive += static_cast<size_t>(blockIdx.x) * k;
  mask += static_cast<size_t>(blockIdx.x) * k * words;

  // Invalid slots and the ragged tail start out removed: they are never kept
  // and, never being kept, never suppress anything.
  for (int w = lane; w < words; w += 32) {
    unsigned long long r = 0ull;
    for (int j = 0; j < kTile; ++j) {
      const int p = w * kTile + j;
      if (p >= k) {
        r |= 1ull << j;
      } else {
        alive[p] = 0;
        if (!valid[p]) r |= 1ull << j;
      }
    }
    removed[w] = r;
  }
  __syncwarp();

  int kept = 0;
  for (int w = 0; w < words && kept < max_output; ++w) {
    // `done` marks positions of word w that are removed or already visited.
    unsigned long long done = removed[w];
    while (done != ~0ull && kept < max_output) {
      const int bit = __ffsll(static_cast<long long>(~done)) - 1;
      const int i = w * kTile + bit;
      if (lane == 0) alive[i] = 1;
      ++kept;
      const unsigned long long* row = mask + static_cast<size_t>(i) * words;
      for (int v = w + lane; v < words; v += 32) removed[v] |= row[v];
      __syncwarp();
      done = removed[w] | ((2ull << bit) - 1ull);
      __syncwarp();  // every lane has read removed[w] before the next OR
    }
  }
}

}  // namespace

extern "C" {

// boxes [B, K, 4] f32, valid [B, K] bool, mask scratch [B, K, W] u64,
// alive [B, K] u8 (output). Launches on `stream`; returns cudaGetLastError().
int nms_alive_sorted_cuda(const float* boxes, const uint8_t* valid, int batch, int k,
                          float thr, int max_output, unsigned long long* mask,
                          uint8_t* alive, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int words = (k + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words, batch), kTile, 0, s>>>(boxes, k, words, thr, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<batch, 32, words * sizeof(unsigned long long), s>>>(
      valid, mask, k, words, max_output, alive);
  return static_cast<int>(cudaGetLastError());
}

const char* nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
