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
// What bounds it on this card: not bytes nor operations but latency. The
// greedy decision is a chain -- box i is kept only if no kept box before it
// overlaps it -- and at the training RPN shape ([1, 12000] -> 2000) the IoU
// tests are ~2 us of the card's float rate and the mask ~18 MB, which stays
// in L2. What costs time is the number of dependent steps in the chain and
// what each step waits for. The TPU kernel breaks the chain into 128-box
// blocks with an in-block fixpoint; this kernel breaks it into 64-box words:
//
//   stage 1 (parallel, compute-light): every pair (i, c > i) gets one IoU
//     test; the results are packed 64 to a word into a [B, K, W] bit matrix,
//     W = ceil(K / 64). One thread per row box, one block per 64x64 tile on
//     or above the diagonal (a triangular grid: no block is launched for a
//     tile below it), the column boxes in shared memory as float4.
//   stage 2 (the chain, one block of 1024 threads per batch row): a
//     `removed` bitset of W words in shared memory, seeded with the invalid
//     slots and the ragged tail, is walked word by word, one barrier per
//     word. In iteration w, warp 0 resolves word w's 64 boxes in registers:
//     removed[w], ORed with the column-w words of the rows kept in word w-1
//     (loaded at the end of iteration w-1, so their latency passes during
//     its barrier), gives the live boxes, and the greedy set of the word is
//     the fixpoint of keep <- live & ~(OR of the diagonal rows of keep),
//     one warp OR-reduce a round, as many rounds as the word's longest
//     suppression chain (the TPU kernel's in-block fixpoint, on 64 boxes).
//     The word's diagonal tile (mask[w*64 + j][w], 512 bytes) was loaded
//     during iteration w-1. The first boxes up to `max_output` are kept,
//     even inside the word. At the same time the other 31 warps OR the rows
//     kept in word w-1 into removed[w+1 .. W): a thread per (target word,
//     group of rows) issues its rows' loads eight at a time, ORs them in a
//     register, then adds them with two 32-bit shared atomics. The scan
//     stops once `max_output` boxes are kept.
//
// Why this beats the per-box chain it replaces (one warp per row, one kept
// box at a time, each kept box one dependent L2 read of its W-word row and
// two warp barriers before the next find-first-set could start): the
// chain now has W links (188 at K = 12000) instead of one per kept box (up
// to 2000); a link costs a few warp reductions and one block barrier, the
// one dependent load of a link (the next column) is in flight across the
// barrier, and the kept boxes' rows are read in parallel, off the chain,
// while the next word is resolved.
//
// Exactness: the IoU is computed in the same float32 operations, in the same
// order, as the plain PyTorch version (`nms_alive_sorted_reference`) and the
// JAX `_nms_iou`. The build passes -fmad=false so that no multiply-add is
// contracted into an FMA, and never --use_fast_math, so the division is IEEE
// round-to-nearest: a box sitting at the threshold is decided alike. The
// mask, and the greedy order over it, are those of the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // boxes per tile side == bits per mask word
constexpr int kScanThreads = 1024;  // stage 2 block: warp 0 resolves, the rest OR
constexpr int kOrLoads = 8;  // mask loads a thread has in flight in stage 2's OR step

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return (x2 - x1) * (y2 - y1);
}

// iou(a, b) > thr with the arithmetic of `_nms_iou` (ops/nms.py):
// iou = inter > 0 ? inter / max(union, 1e-12) : 0.
__device__ __forceinline__ bool overlaps(float ax1, float ay1, float ax2, float ay2,
                                         float a_area, float4 b, float b_area, float thr) {
  const float iw = fmaxf(0.0f, fminf(ax2, b.z) - fmaxf(ax1, b.x));
  const float ih = fmaxf(0.0f, fminf(ay2, b.w) - fmaxf(ay1, b.y));
  const float inter = iw * ih;
  const float uni = (a_area + b_area) - inter;
  const float iou = inter > 0.0f ? inter / fmaxf(uni, 1e-12f) : 0.0f;
  return iou > thr;
}

// Stage 1. grid (W (W + 1) / 2 tiles on and above the diagonal, B), block
// kTile threads. mask[b, i, t] bit j  <=>  c = t*64 + j > i  and
// iou(i, c) > thr. Words below the diagonal (t < i / 64) are never written
// nor read.
__global__ void nms_mask_kernel(const float* __restrict__ boxes, int k, int words,
                                float thr, unsigned long long* __restrict__ mask) {
  // block -> tile, counted from the last row up: the last row of tiles has
  // one tile, the row above it two, and so on
  const long long tiles = static_cast<long long>(words) * (words + 1) / 2;
  const long long s = tiles - 1 - blockIdx.x;
  int up = static_cast<int>((sqrt(8.0 * static_cast<double>(s) + 1.0) - 1.0) * 0.5);
  while (static_cast<long long>(up + 1) * (up + 2) / 2 <= s) ++up;
  while (static_cast<long long>(up) * (up + 1) / 2 > s) --up;
  const int row_tile = words - 1 - up;
  const int col_tile = words - 1 - static_cast<int>(s - static_cast<long long>(up) * (up + 1) / 2);
  const float* bb = boxes + static_cast<size_t>(blockIdx.y) * k * 4;

  __shared__ float4 cols[kTile];
  __shared__ float col_area[kTile];
  const int c0 = col_tile * kTile;
  const int ncols = min(kTile, k - c0);
  if (threadIdx.x < ncols) {
    const float* c = bb + static_cast<size_t>(c0 + threadIdx.x) * 4;
    cols[threadIdx.x] = make_float4(c[0], c[1], c[2], c[3]);
    col_area[threadIdx.x] = box_area(c[0], c[1], c[2], c[3]);
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
    if (overlaps(x1, y1, x2, y2, area, cols[j], col_area[j], thr)) bits |= 1ull << j;
  }
  mask[(static_cast<size_t>(blockIdx.y) * k + i) * words + col_tile] = bits;
}

// Stage 2 helpers. The diagonal words of rows w*64 + lane and w*64 + 32 + lane
// (zero past the last box: those slots start out removed and are never taken).
__device__ __forceinline__ void load_diagonal(const unsigned long long* __restrict__ mask, int k,
                                              int words, int w, int lane,
                                              unsigned long long* lo, unsigned long long* hi) {
  const int r = w * kTile + lane;
  *lo = r < k ? mask[static_cast<size_t>(r) * words + w] : 0ull;
  *hi = r + 32 < k ? mask[static_cast<size_t>(r + 32) * words + w] : 0ull;
}

// OR of a 64-bit value over the warp.
__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  const unsigned full = 0xffffffffu;
  return (static_cast<unsigned long long>(__reduce_or_sync(full, static_cast<unsigned>(v >> 32)))
          << 32) |
         __reduce_or_sync(full, static_cast<unsigned>(v));
}

// Stage 2. grid (B), block kScanThreads, dynamic shared memory W words.
// Iteration w: warp 0 resolves word w while warps 1.. OR the rows kept in
// word w-1 into removed[w+1 ..]; one barrier per word.
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const uint8_t* __restrict__ valid, const unsigned long long* __restrict__ mask,
                int k, int words, int max_output, uint8_t* __restrict__ alive) {
  extern __shared__ unsigned long long removed[];
  // Written by warp 0 in iteration w at [w & 1], read by all after its
  // barrier: the other slot is the one warp 0 writes next, so no thread can
  // read a value of iteration w+1 where it expects iteration w's.
  __shared__ int rows[2][kTile];  // the boxes kept in word w, in order
  __shared__ int n_rows[2];
  __shared__ int kept_total[2];   // boxes kept up to and including word w
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  valid += static_cast<size_t>(blockIdx.x) * k;
  alive += static_cast<size_t>(blockIdx.x) * k;
  mask += static_cast<size_t>(blockIdx.x) * k * words;

  // Every slot starts not alive; invalid slots and the ragged tail start out
  // removed: they are never kept and, never being kept, never suppress.
  for (int p = tid; p < k; p += blockDim.x) alive[p] = 0;
  for (int w = warp; w < words; w += blockDim.x / 32) {
    const int p = w * kTile + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, p < k && valid[p]);
    const unsigned hi = __ballot_sync(0xffffffffu, p + 32 < k && valid[p + 32]);
    if (lane == 0) removed[w] = ~((static_cast<unsigned long long>(hi) << 32) | lo);
  }
  if (tid == 0) n_rows[1] = 0;  // word -1 kept nothing
  // warp 0's registers: word w's diagonal tile, and the column-w words of
  // the rows kept in word w-1 (loaded in iteration w-1, still in flight
  // through its barrier)
  unsigned long long diag_lo = 0ull, diag_hi = 0ull, col_lo = 0ull, col_hi = 0ull;
  if (warp == 0) load_diagonal(mask, k, words, 0, lane, &diag_lo, &diag_hi);
  __syncthreads();

  int kept = 0;  // warp 0's running count, the same in every lane
  for (int w = 0; w < words; ++w) {
    const int* prev = rows[(w + 1) & 1];  // the boxes kept in word w-1
    const int n_prev = n_rows[(w + 1) & 1];
    if (warp == 0) {
      unsigned long long next_lo = 0ull, next_hi = 0ull;
      if (w + 1 < words) load_diagonal(mask, k, words, w + 1, lane, &next_lo, &next_hi);
      // removed[w] holds every kept word but w-1; the gathered column adds it
      const unsigned long long live = ~(removed[w] | warp_or(col_lo | col_hi));
      // Word w's greedy set: the fixpoint of keep <- live & ~(OR of the
      // diagonal rows of keep). The fixpoint is unique and is the greedy
      // answer (box j's bit depends only on boxes before it), and after t
      // rounds the first t + 1 boxes are settled: as many rounds as the
      // word's longest suppression chain, plus one.
      unsigned long long keep = live;
      for (;;) {
        const unsigned long long mine = (((keep >> lane) & 1ull) ? diag_lo : 0ull) |
                                        (((keep >> (lane + 32)) & 1ull) ? diag_hi : 0ull);
        const unsigned long long next = live & ~warp_or(mine);
        if (next == keep) break;
        keep = next;
      }
      // stop at max_output, even inside the word: its first `room` boxes
      const int room = max_output - kept;
      while (__popcll(keep) > room) keep &= ~(1ull << (63 - __clzll(keep)));
      kept += __popcll(keep);
      // publish word w's kept boxes; gather their column-w+1 words for the next word
      int* cur = rows[w & 1];
      col_lo = col_hi = 0ull;
      const int i_lo = w * kTile + lane;
      const int i_hi = i_lo + 32;
      if ((keep >> lane) & 1ull) {
        cur[__popcll(keep & ((1ull << lane) - 1ull))] = i_lo;
        alive[i_lo] = 1;
        if (w + 1 < words) col_lo = mask[static_cast<size_t>(i_lo) * words + w + 1];
      }
      if ((keep >> (lane + 32)) & 1ull) {
        cur[__popcll(keep & ((1ull << (lane + 32)) - 1ull))] = i_hi;
        alive[i_hi] = 1;
        if (w + 1 < words) col_hi = mask[static_cast<size_t>(i_hi) * words + w + 1];
      }
      if (lane == 0) {
        n_rows[w & 1] = __popcll(keep);
        kept_total[w & 1] = kept;
      }
      diag_lo = next_lo;
      diag_hi = next_hi;
    } else {
      // OR word w-1's kept rows into removed[w+1 .. W): a thread per (target
      // word, group of rows), its rows' words ORed in a register, then two
      // 32-bit shared atomics
      const int targets = words - 1 - w;
      if (targets > 0 && n_prev > 0) {
        const int stride = blockDim.x - 32;
        const int groups = max(1, min(n_prev, stride / targets));
        const unsigned long long* cols = mask + (w + 1);
        for (int slot = tid - 32; slot < targets * groups; slot += stride) {
          const int g = slot / targets;
          const int v = slot - g * targets;
          unsigned long long acc = 0ull;
          for (int r0 = g; r0 < n_prev; r0 += kOrLoads * groups) {
            unsigned long long bits[kOrLoads];  // all issued before any is used
#pragma unroll
            for (int u = 0; u < kOrLoads; ++u) {
              const int r = r0 + u * groups;
              bits[u] = r < n_prev ? cols[static_cast<size_t>(prev[r]) * words + v] : 0ull;
            }
#pragma unroll
            for (int u = 0; u < kOrLoads; ++u) acc |= bits[u];
          }
          unsigned* half = reinterpret_cast<unsigned*>(&removed[w + 1 + v]);  // low half first
          if (static_cast<unsigned>(acc) != 0u) atomicOr(half, static_cast<unsigned>(acc));
          if ((acc >> 32) != 0ull) atomicOr(half + 1, static_cast<unsigned>(acc >> 32));
        }
      }
    }
    // removed[w+1] now lacks only word w's rows, whose column warp 0 holds
    __syncthreads();
    if (kept_total[w & 1] >= max_output) break;
  }
}

// Makes `device` current for a launch and gives the caller's current device
// back when it goes out of scope, on success and on error alike.
struct DeviceGuard {
  int previous = -1;
  cudaError_t enter(int device) {
    cudaError_t err = cudaGetDevice(&previous);
    if (err != cudaSuccess) {
      previous = -1;
      return err;
    }
    return cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (previous >= 0) cudaSetDevice(previous);
  }
};

}  // namespace

extern "C" {

// boxes [B, K, 4] f32, valid [B, K] bool, mask scratch [B, K, W] u64,
// alive [B, K] u8 (output). Launches on `stream`; returns cudaGetLastError().
int nms_alive_sorted_cuda(const float* boxes, const uint8_t* valid, int batch, int k,
                          float thr, int max_output, unsigned long long* mask,
                          uint8_t* alive, int device, void* stream) {
  DeviceGuard guard;
  cudaError_t err = guard.enter(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int words = (k + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned tiles = static_cast<unsigned>(static_cast<long long>(words) * (words + 1) / 2);
  nms_mask_kernel<<<dim3(tiles, batch), kTile, 0, s>>>(boxes, k, words, thr, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<batch, kScanThreads, words * sizeof(unsigned long long), s>>>(
      valid, mask, k, words, max_output, alive);
  return static_cast<int>(cudaGetLastError());
}

const char* nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
