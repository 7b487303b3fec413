// Wide gather-accumulate for Hopper (sm_90a): windows wider than the quad
// kernel takes (W > 120).
//
// Replaces the fused XLA step coolpuppy_tpu/ops/gather.py:111-234
// (make_pileup_step_fn: block_fn :126-192, the lax.scan over snip blocks
// :226), whose window gather, mask and per-group segment sums XLA compiles
// into one program. For every work item, a span of snip words that share
// one top-left tile (t1, t2) = (r1 / 128, r2 / 128) and one group:
//
//   for each snip word w of the item:
//     a = (w >> 24) & 0x7F, b = (w >> 17) & 0x7F, g = w & 0x1FFFF
//     v = M[a + i, b + j] for the W x W window, where M is the superwindow
//         of the item's R x R tiles slots[item][u * R + v] (tile rows
//         t1 .. t1 + R - 1, columns t2 .. t2 + R - 1; R = ceil((127 + W) /
//         128): offsets are below 128, so a window reaches no further)
//     sum[g]    += v           where v is finite
//     num[g]    += 1           where v is finite
//     poison[g] += 1           where v is +-inf
//
// on the NaN-encoded normalized stack (masked pixels NaN, OOE poison +inf;
// slot 0, an absent tile, is all NaN). The accumulators are float32
// [C, W, W], as the reference's: the counts are exact only while a pixel of
// one group counts fewer than 2^24 snips.
//
// What bounds it on an H100 (published peaks: 3.35 TB/s of device memory,
// 67 TFLOP/s float32). The W = 201 cell (115,299 snips) adds 4.66e9 window
// pixels: one float add each is 0.070 ms, while the stack pixels the windows
// cover, the words, the items and the outputs are 58 MB: 0.017 ms. It is
// bound by operations, and the gap between it and any real kernel is the
// work a pixel costs besides its add: the window load, its tile lookup and
// three compare-and-adds. The design keeps that work per pixel small and
// keeps the loads coalesced:
//   - Work items hold one group and at most ITEM_MAX snips (the host cuts
//     each (tile, group) run, sorted stably by tile then group). All snips
//     of an item share the same R x R tile slots, so the block reads them
//     once into shared memory, and one group means one flush an item.
//   - A window of W = 201 has 40,401 pixels, more than a block holds in
//     registers, so an item gets ceil(W^2 / 2048) blocks, one a band of
//     2048 consecutive pixels (blockIdx.x = item * bands + band, so the
//     bands of an item run together and share its tiles in L2). Each of the
//     256 threads holds 8 pixels, p = band * 2048 + m * 256 + tid, with
//     their three partial sums in registers while it walks the item's snips,
//     and flushes each non-zero sum with one atomicAdd at the item's end.
//   - A warp's 32 pixels are consecutive in a window row, so its loads of
//     one snip fall in one or two 128-float tile rows: one or two
//     transactions, through L1 and L2. The 8 pixels of a thread give 8
//     independent loads in flight per snip.
//   - Any W works: the slots are R x R (R = 3 up to W = 257, 4 to 385, 5 to
//     513, ...) and the bands cover any W^2. Staging the item's tiles in
//     shared memory as the quad kernel does would cut the L1 traffic, but
//     the reachable corner at W = 201 is 328 x 328 floats (430 KB, past a
//     block's 227 KB), and a band of even one window row, 128 x (127 + W)
//     floats, stops fitting near W = 300: that is later work, with 2-D
//     bands.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kTileElems = kTile * kTile;
constexpr int kGroupMask = 0x1FFFF;
constexpr int kThreads = 256;
constexpr int kPixels = 8;  // pixels a thread holds
constexpr int kBand = kThreads * kPixels;

__global__ void __launch_bounds__(kThreads)
wide_accumulate_kernel(const float* __restrict__ stiles,
                       const int32_t* __restrict__ slots,
                       const int32_t* __restrict__ istart,
                       const int32_t* __restrict__ icount,
                       const int32_t* __restrict__ snips, int W, int R, int C,
                       int bands, float* __restrict__ sum,
                       float* __restrict__ num, float* __restrict__ poison) {
  extern __shared__ int32_t sslot[];  // the item's R x R tile slots
  const int item = blockIdx.x / bands;
  const int band = blockIdx.x - item * bands;
  const int cnt = icount[item];
  if (cnt <= 0) return;  // uniform across the block: no barrier is skipped
  const int RR = R * R;
  for (int t = threadIdx.x; t < RR; t += blockDim.x)
    sslot[t] = slots[(size_t)item * RR + t];
  __syncthreads();

  const int32_t* __restrict__ sn = snips + istart[item];
  const int g = __ldg(sn) & kGroupMask;  // one group an item
  const int WW = W * W;
  int pi[kPixels], pj[kPixels];
#pragma unroll
  for (int m = 0; m < kPixels; ++m) {
    const int p = band * kBand + m * kThreads + threadIdx.x;
    const int pp = p < WW ? p : 0;  // idle slots read pixel 0, flush nothing
    pi[m] = pp / W;
    pj[m] = pp - pi[m] * W;
  }
  float s[kPixels];
  int nf[kPixels], ni[kPixels];
#pragma unroll
  for (int m = 0; m < kPixels; ++m) {
    s[m] = 0.0f;
    nf[m] = 0;
    ni[m] = 0;
  }

  const float inf = __int_as_float(0x7f800000);
#pragma unroll 2
  for (int e = 0; e < cnt; ++e) {
    const int w = __ldg(sn + e);
    const int a = (w >> 24) & 0x7F;
    const int b = (w >> 17) & 0x7F;
    float v[kPixels];
#pragma unroll
    for (int m = 0; m < kPixels; ++m) {
      const int r = a + pi[m];
      const int c = b + pj[m];
      const int slot = sslot[(r >> 7) * R + (c >> 7)];
      v[m] = __ldg(stiles + (size_t)slot * kTileElems +
                   ((r & (kTile - 1)) << 7) + (c & (kTile - 1)));
    }
#pragma unroll
    for (int m = 0; m < kPixels; ++m) {
      const float x = fabsf(v[m]);
      const bool fin = x < inf;  // false for NaN and +-inf
      s[m] += fin ? v[m] : 0.0f;
      nf[m] += fin ? 1 : 0;
      ni[m] += x == inf ? 1 : 0;
    }
  }

  // g < C is checked by the host; the guard keeps a bad word from writing
  // out of bounds
  if (g >= C) return;
  const size_t base = (size_t)g * WW;
#pragma unroll
  for (int m = 0; m < kPixels; ++m) {
    const int p = band * kBand + m * kThreads + threadIdx.x;
    if (p >= WW) continue;
    if (s[m] != 0.0f) atomicAdd(sum + base + p, s[m]);
    if (nf[m]) atomicAdd(num + base + p, (float)nf[m]);
    if (ni[m]) atomicAdd(poison + base + p, (float)ni[m]);
  }
}

// The thread's current device for one launcher call, put back on return
// (as in quad_accumulate.cu).
struct DeviceGuard {
  int prev = -1;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};
}  // namespace

extern "C" {

// Pixel bands of one item for W x W windows (blocks an item).
int wide_accumulate_bands(int W) {
  if (W < 1 || W > 46340) return 0;  // W * W must fit an int
  return (W * W + kBand - 1) / kBand;
}

// Launches the wide kernel over nitems work items on `stream` (a
// cudaStream_t) of device `device`, wide_accumulate_bands(W) blocks an
// item. slots [nitems, R * R] int32 are each item's tile slots, istart and
// icount [nitems] int32 its span of `snips` (packed words, one group an
// item). All pointers are device pointers; sum, num and poison [C, W, W]
// float32 must be zeroed by the caller. Returns the CUDA error code of the
// launch (0 on success; cudaErrorInvalidValue for a W, R or grid it does not
// take); nothing is synchronized.
int wide_accumulate_launch(const void* stiles, const void* slots,
                           const void* istart, const void* icount,
                           const void* snips, int nitems, int W, int R, int C,
                           void* sum, void* num, void* poison, void* stream,
                           int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int bands = wide_accumulate_bands(W);
  if (bands == 0 || R != (kTile - 1 + W + kTile - 1) / kTile || C < 1)
    return (int)cudaErrorInvalidValue;
  if (nitems <= 0) return (int)cudaSuccess;
  const long long blocks = (long long)nitems * bands;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int32_t) * (size_t)R * R;
  wide_accumulate_kernel<<<(unsigned)blocks, kThreads, smem,
                           (cudaStream_t)stream>>>(
      (const float*)stiles, (const int32_t*)slots, (const int32_t*)istart,
      (const int32_t*)icount, (const int32_t*)snips, W, R, C, bands,
      (float*)sum, (float*)num, (float*)poison);
  return (int)cudaGetLastError();
}

const char* wide_accumulate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
