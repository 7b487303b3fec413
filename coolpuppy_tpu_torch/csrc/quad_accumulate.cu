// Quad gather-accumulate for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel coolpuppy_tpu/ops/pallas_gather.py::
// _make_pallas_call (kernel body :86-182, pl.pallas_call :209). It computes
// what that kernel computes, for every work item: a run of snips that share
// one tile quad and one group g (``split_runs`` on the host makes every item
// so; the kernel takes g from the item's first word):
//
//   for each snip word w of the item:
//     a = w >> 24, b = (w >> 17) & 0x7F, g = w & 0x1FFFF
//     v = M[a + i, b + j] for the W x W window, where M is the 256 x 256
//         superwindow of the item's four 128 x 128 tiles k[4q .. 4q+3]
//     sum[g] += (v == v) ? v : 0            (a NaN adds nothing, +inf adds)
//     num[g] += (v == v) && |v| != inf
//
// What bounds it on this card. Every snip reads W*W floats and does two
// compares and one add per float: at W = 21 that is 441 loads a snip, all
// of them from a quad's four tiles (256 KB), and the whole normalized stack
// of the loop-APA headline (about 40 MB) fits in the 50 MB L2. So the loop
// is bound by load latency and L1/L2 bandwidth, not by device memory. The
// TPU kernel stages the superwindow in VMEM and carries its accumulators in
// VMEM across a sequential grid; Hopper has neither: a block can hold 227 KB
// of shared memory, less than the superwindow and even than the reachable
// (128 + W - 1)^2 corner at W = 120, and blocks run in parallel, so sums
// cross blocks by atomics.
//
// What the design does about it:
//   - one block per work item, all items in one launch; the host caps an
//     item at 1024 snips so heavy quads spread over many SMs;
//   - windows are read straight from global memory (the quad's tiles stay
//     resident in L1/L2); no shared-memory staging;
//   - each thread owns pixels p of the window (stride blockDim.x) and keeps
//     its sum in a float register and its count in an int register over the
//     item's snips, loading 8 snips ahead so that 8 independent loads are in
//     flight; it flushes with one atomicAdd each at the end of the item;
//   - num is int32, so counts stay exact far past float32's 2^24.
// Shared-memory staging of the reachable corner, fewer atomics and TMA are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kTileElems = kTile * kTile;
constexpr int kUnroll = 8;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float window_value(const float* __restrict__ t00,
                                              const float* __restrict__ t01,
                                              const float* __restrict__ t10,
                                              const float* __restrict__ t11,
                                              int w, int i, int j) {
  const int r = (w >> 24) + i;
  const int c = ((w >> 17) & 0x7F) + j;
  const float* t =
      r < kTile ? (c < kTile ? t00 : t01) : (c < kTile ? t10 : t11);
  return __ldg(t + (r & (kTile - 1)) * kTile + (c & (kTile - 1)));
}

__device__ __forceinline__ void add_value(float v, float& s, int& n) {
  if (v == v) {
    s += v;
    n += fabsf(v) != __int_as_float(0x7f800000);  // not +-inf
  }
}

__device__ __forceinline__ void flush(float* __restrict__ sum,
                                      int32_t* __restrict__ num, int g, int C,
                                      int WW, int p, float s, int n) {
  // g < C is checked by the host; the guard keeps a bad word from writing
  // out of bounds
  if (g < C && (n != 0 || s != 0.0f)) {
    atomicAdd(sum + (size_t)g * WW + p, s);
    atomicAdd(num + (size_t)g * WW + p, n);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
quad_accumulate_kernel(const float* __restrict__ stiles,
                       const int32_t* __restrict__ k,
                       const int32_t* __restrict__ qstart,
                       const int32_t* __restrict__ qcount,
                       const int32_t* __restrict__ snips, int W, int C,
                       float* __restrict__ sum, int32_t* __restrict__ num) {
  const int q = blockIdx.x;
  const int cnt = qcount[q];
  if (cnt <= 0) return;
  const int32_t* __restrict__ sn = snips + qstart[q];
  const float* __restrict__ t00 = stiles + (size_t)k[4 * q + 0] * kTileElems;
  const float* __restrict__ t01 = stiles + (size_t)k[4 * q + 1] * kTileElems;
  const float* __restrict__ t10 = stiles + (size_t)k[4 * q + 2] * kTileElems;
  const float* __restrict__ t11 = stiles + (size_t)k[4 * q + 3] * kTileElems;
  const int WW = W * W;
  const int g = __ldg(sn) & 0x1FFFF;  // one group per item

  for (int p = threadIdx.x; p < WW; p += blockDim.x) {
    const int i = p / W;
    const int j = p - i * W;
    float s = 0.0f;
    int n = 0;
    int e = 0;
    for (; e + kUnroll <= cnt; e += kUnroll) {
      // the 8 window loads are independent
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = window_value(t00, t01, t10, t11, __ldg(sn + e + u), i, j);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_value(v[u], s, n);
    }
    for (; e < cnt; ++e)
      add_value(window_value(t00, t01, t10, t11, __ldg(sn + e), i, j), s, n);
    flush(sum, num, g, C, WW, p, s, n);
  }
}

}  // namespace

extern "C" {

// Launches the kernel over nq work items on `stream` (a cudaStream_t) of
// device `device`. Every item's snips must share one group (the group of
// its first word takes them all). All pointers are device pointers; sum
// [C, W, W] float32 and num [C, W, W] int32 must be zeroed by the caller.
// Returns the CUDA error code of the launch (0 on success); nothing is
// synchronized.
int quad_accumulate_launch(const void* stiles, const void* k,
                           const void* qstart, const void* qcount,
                           const void* snips, int nq, int W, int C, void* sum,
                           void* num, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nq <= 0) return (int)cudaSuccess;
  const int ww = W * W;
  int threads = ((ww + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  quad_accumulate_kernel<<<nq, threads, 0, (cudaStream_t)stream>>>(
      (const float*)stiles, (const int32_t*)k, (const int32_t*)qstart,
      (const int32_t*)qcount, (const int32_t*)snips, W, C, (float*)sum,
      (int32_t*)num);
  return (int)cudaGetLastError();
}

const char* quad_accumulate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
