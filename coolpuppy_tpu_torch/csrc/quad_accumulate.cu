// Quad gather-accumulate for Hopper (sm_90a): the staged kernel.
//
// Replaces the Pallas TPU kernel coolpuppy_tpu/ops/pallas_gather.py::
// _make_pallas_call (kernel body :86-182, pl.pallas_call :209). For every
// work item, a span of quad-sorted snip words that share one tile quad:
//
//   for each snip word w of the item:
//     a = w >> 24, b = (w >> 17) & 0x7F, g = w & 0x1FFFF
//     v = M[a + i, b + j] for the W x W window, where M is the 256 x 256
//         superwindow of the item's four 128 x 128 tiles k[4q .. 4q+3]
//     sum[g] += (v == v) ? v : 0            (a NaN adds nothing, +inf adds)
//     num[g] += (v == v) && |v| != inf
//
// What bounds it on an H100 (published peaks: 3.35 TB/s of device memory,
// 67 TFLOP/s float32). At the loop-APA headline (1M snips, W = 21, a
// ~40 MB stack) the function must move ~44.5 MB (the stack, 4 MB of words,
// 28 KB of accumulators): 13 us; it does 441M float adds: 6.6 us. The bound
// is the bytes'. No design that reads each window once from on-chip memory
// comes near it: the 1M windows are 1.76 GB of 4-byte reads, and shared
// memory delivers 128 B a clock an SM, ~29 TB/s over 132 SMs at 1.7 GHz, so
// ~61 us is the working ceiling, with ~5 issue slots a pixel about as much
// again on 132 x 4 schedulers.
//
// The staged kernel (quad_accumulate_staged_kernel), taken at every W:
//   - Offsets are below 128, so a window never reaches past row or column
//     128 + W - 2. The block copies that (128 + W - 1)^2 corner of the
//     superwindow (88 KB at W = 21; the superwindow would be 256 KB, more
//     than a block's 227 KB) from the item's four tiles into ONE shared
//     array with one row stride S, bits untouched (slot 0 is the all-NaN
//     tile, +inf is poison), with cp.async, once per item. A pixel's address
//     is then (a*S + b) + (i*S + j): the first term is decoded once per
//     snip per block into shared memory, the second once per thread, and
//     the inner loop is an add, a shared load, two compares and two adds.
//   - Bands, where the corner does not fit a block (from W = 111: 238 x 239
//     floats and the chunk buffers are 233,840 bytes, a block has 232,448):
//     the window's rows are cut into R bands of H = ceil(W / R) rows, and
//     each item gets R blocks, one a band (blockIdx.x = item * R + band, so
//     the bands of an item are dispatched together and share its tiles in
//     L2). Band r holds window rows [r*H, r*H + H); with a < 128 it reaches
//     superwindow rows [r*H, r*H + 127 + H) only, and stages those rows:
//     (127 + H) x S floats, 185,504 bytes at W = 120, R = 2. Its pixel term
//     is ((i - r*H)*S + j). The R blocks of an item flush disjoint pixels,
//     so the atomics per pixel do not change; each snip word is decoded R
//     times and the corner copy moves (2 * 187) / 247 = 1.5x the rows. The
//     host picks the fewest bands that fit (R = 1 up to W = 110, R = 2 from
//     111 to 120). The band arithmetic is a template flag: with one band it
//     folds away and the kernel is the one without bands (done at run time
//     for R = 1 too, it took P = 16 to 80 registers and 52 bytes of
//     spills). Thread block clusters, which would let one block read a
//     peer's half of the corner, are not used: a read of distributed shared
//     memory costs several local reads, and the window loads are nearly all
//     of the work.
//   - S = W + 128, so S = W (mod 32): a warp's 32 consecutive pixels span
//     two window rows and still hit 32 distinct banks. Rows are then not
//     16-byte aligned and the copy moves 4 bytes a cp.async. The other
//     choice, S rounded up to 4 floats with 16-byte cp.async and a few
//     2-way conflicts, was measured beside it at the headline on an H100 at
//     700 W and lost: 0.1856 ms against 0.1783 ms (medians of 6, in turns),
//     because the copy is a few percent of an item's work and the window
//     loads nearly all of it. TMA is not used: a TMA box lands
//     dense, so four boxes would give four regions and bring a per-pixel
//     region select back.
//   - An item holds up to ITEM_MAX snips of one quad whatever their groups
//     (the host's split_items), sorted by group. The block finds the group
//     runs with warp ballots, keeps each pixel's sum and count in registers
//     over a run and flushes them with one atomicAdd each at the run's end:
//     as many atomics as one item per run would make, but the corner is
//     staged once per item.
//   - Every pixel of the band is held at once: threads = ceil(H*W / P)
//     rounded up to a warp, P = 1, 2, 4, 8 or 16 pixels a thread in
//     registers, so the item's snips are walked once. The fewest pixels that
//     cover the band are the fastest (W = 21: 0.182 ms at P = 1, 0.197 at 2,
//     0.321 at 4); W = 111..120 take P = 8 with 800..928 threads.
//   - Items longer than kChunk snips are walked in chunks of kChunk (the
//     decoded offsets and run starts live in shared memory, per block); a
//     run that crosses a chunk boundary is flushed twice, which changes no
//     result. The host cuts items at ITEM_MAX = kChunk = 1024 snips: 0.182
//     ms at the headline against 0.204 at 512 and 0.189 at 2048.
//
// num is int32, so counts stay exact far past float32's 2^24.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kTileElems = kTile * kTile;
constexpr int kGroupMask = 0x1FFFF;
// staged kernel: snips decoded per pass, and the bytes after the corner:
// int32 offsets [kChunk], uint16 run starts [kChunk + 8], uint32 run-start
// masks [kChunk / 32], the run count (16 bytes)
constexpr int kChunk = 1024;
constexpr int kOffBytes = 4 * kChunk;
constexpr int kRunBytes = 2 * (kChunk + 8);
constexpr int kMaskBytes = 4 * (kChunk / 32);
constexpr int kTailBytes = kOffBytes + kRunBytes + kMaskBytes + 16;

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

// One snip into a thread's P pixels: `off` is the snip's byte offset
// (a*S + b)*4 into the corner, pix[m] the pixel's (i*S + j)*4.
template <int P>
__device__ __forceinline__ void add_snip(const unsigned char* corner, int off,
                                         const int (&pix)[P], float (&s)[P],
                                         int (&n)[P]) {
  float v[P];
#pragma unroll
  for (int m = 0; m < P; ++m)
    v[m] = *reinterpret_cast<const float*>(corner + (off + pix[m]));
#pragma unroll
  for (int m = 0; m < P; ++m) {
    s[m] += v[m] == v[m] ? v[m] : 0.0f;
    // finite: neither NaN nor +-inf
    n[m] += fabsf(v[m]) < __int_as_float(0x7f800000) ? 1 : 0;
  }
}

template <int P, bool kBands>
__global__ void __launch_bounds__(P <= 8 ? 1024 : 768)
quad_accumulate_staged_kernel(const float* __restrict__ stiles,
                              const int32_t* __restrict__ k,
                              const int32_t* __restrict__ qstart,
                              const int32_t* __restrict__ qcount,
                              const int32_t* __restrict__ snips, int W, int C,
                              int S, int H, int corner_bytes,
                              float* __restrict__ sum,
                              int32_t* __restrict__ num) {
  extern __shared__ __align__(16) unsigned char smem[];
  // R blocks an item, one a band of H window rows (one block, H = W,
  // without bands)
  const int R = kBands ? (W + H - 1) / H : 1;
  const int q = kBands ? blockIdx.x / R : blockIdx.x;
  const int row0 = kBands ? (blockIdx.x - q * R) * H : 0;  // first window row
  const int cnt = qcount[q];
  if (cnt <= 0) return;  // uniform across the block: no barrier is skipped
  float* corner = reinterpret_cast<float*>(smem);
  int32_t* soff = reinterpret_cast<int32_t*>(smem + corner_bytes);
  uint16_t* srun =
      reinterpret_cast<uint16_t*>(smem + corner_bytes + kOffBytes);
  uint32_t* smask = reinterpret_cast<uint32_t*>(smem + corner_bytes +
                                                kOffBytes + kRunBytes);
  int* snruns = reinterpret_cast<int*>(smem + corner_bytes + kOffBytes +
                                       kRunBytes + kMaskBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int side = kTile + W - 1;
  const int WW = W * W;
  const int rows = kBands ? min(H, W - row0) : W;  // the band's window rows
  const int band_side = kTile - 1 + rows;  // superwindow rows they reach
  const int npix = rows * W;             // the band's pixels
  const int base = row0 * W;             // its first pixel in the window

  // 1. the band's rows [row0, row0 + band_side) of the reachable corner,
  // one warp a row: columns of tile 00 or 10, then W - 1 of 01 or 11
  {
    const float* t00 = stiles + (size_t)k[4 * q + 0] * kTileElems;
    const float* t01 = stiles + (size_t)k[4 * q + 1] * kTileElems;
    const float* t10 = stiles + (size_t)k[4 * q + 2] * kTileElems;
    const float* t11 = stiles + (size_t)k[4 * q + 3] * kTileElems;
    for (int r = warp; r < band_side; r += nwarps) {
      const int sr = row0 + r;  // the superwindow row
      const int tr = (sr & (kTile - 1)) * kTile;
      const float* left = (sr < kTile ? t00 : t10) + tr;
      const float* right = (sr < kTile ? t01 : t11) + tr;
      float* dst = corner + r * S;
      for (int c = lane; c < side; c += 32)
        __pipeline_memcpy_async(
            dst + c, c < kTile ? left + c : right + (c - kTile), 4);
    }
    __pipeline_commit();
  }

  // each thread's pixels p = tid + m * blockDim.x of the band, as byte
  // offsets from the band's first row
  int pix[P];
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const int p = tid + m * blockDim.x;
    const int pp = p < npix ? p : 0;  // idle slots read pixel 0, flush nothing
    const int i = pp / W;
    pix[m] = (i * S + (pp - i * W)) * 4;
  }

  const int32_t* __restrict__ item = snips + qstart[q];
  for (int c0 = 0; c0 < cnt; c0 += kChunk) {
    const int32_t* __restrict__ sn = item + c0;
    const int m_snips = min(kChunk, cnt - c0);
    // the last chunk's offsets and run starts are still being read
    if (c0 > 0) __syncthreads();

    // 2. decode the chunk's words into corner byte offsets
    for (int e = tid; e < m_snips; e += blockDim.x) {
      const int w = __ldg(sn + e);
      soff[e] = (((w >> 24) & 0x7F) * S + ((w >> 17) & 0x7F)) * 4;
    }
    // 3. group runs: a ballot of run starts per 32 snips, then each start's
    // rank among all starts
    const int nmask = (m_snips + 31) >> 5;
    for (int c = warp; c < nmask; c += nwarps) {
      const int e = c * 32 + lane;
      bool start = false;
      if (e < m_snips) {
        const int g = __ldg(sn + e) & kGroupMask;
        start = e == 0 || g != (__ldg(sn + e - 1) & kGroupMask);
      }
      const unsigned msk = __ballot_sync(0xffffffffu, start);
      if (lane == 0) smask[c] = msk;
    }
    __syncthreads();
    for (int c = warp; c < nmask; c += nwarps) {
      int before = 0;
      for (int d = lane; d < c; d += 32) before += __popc(smask[d]);
      before = __reduce_add_sync(0xffffffffu, before);
      const unsigned msk = smask[c];
      if ((msk >> lane) & 1u)
        srun[before + __popc(msk & ((1u << lane) - 1u))] =
            (uint16_t)(c * 32 + lane);
      if (c == nmask - 1 && lane == 0) {
        const int total = before + __popc(msk);
        srun[total] = (uint16_t)m_snips;
        *snruns = total;
      }
    }
    if (c0 == 0) __pipeline_wait_prior(0);
    __syncthreads();

    // 4. accumulate run by run
    const int nruns = *snruns;
    for (int r = 0; r < nruns; ++r) {
      const int e0 = srun[r];
      const int e1 = srun[r + 1];
      const int g = __ldg(sn + e0) & kGroupMask;
      float s[P];
      int n[P];
#pragma unroll
      for (int m = 0; m < P; ++m) {
        s[m] = 0.0f;
        n[m] = 0;
      }
      int e = e0;
      for (; e < e1 && (e & 3); ++e) add_snip<P>(smem, soff[e], pix, s, n);
      for (; e + 4 <= e1; e += 4) {
        const int4 o = *reinterpret_cast<const int4*>(soff + e);
        add_snip<P>(smem, o.x, pix, s, n);
        add_snip<P>(smem, o.y, pix, s, n);
        add_snip<P>(smem, o.z, pix, s, n);
        add_snip<P>(smem, o.w, pix, s, n);
      }
      for (; e < e1; ++e) add_snip<P>(smem, soff[e], pix, s, n);
#pragma unroll
      for (int m = 0; m < P; ++m) {
        const int p = tid + m * blockDim.x;
        if (p < npix) flush(sum, num, g, C, WW, base + p, s[m], n[m]);
      }
    }
  }
}

// threads of the staged launch for bands of H rows and P pixels a thread,
// 0 if P does not fit the band or H is not a band height of W
int staged_threads(int W, int H, int P) {
  if (P != 1 && P != 2 && P != 4 && P != 8 && P != 16) return 0;
  if (W < 1 || H < 1 || H > W) return 0;
  const int px = H * W;
  const int threads = (((px + P - 1) / P + 31) / 32) * 32;
  return threads <= (P <= 8 ? 1024 : 768) ? threads : 0;
}

// the staged launch's dynamic shared memory for bands of H rows: the band's
// 127 + H corner rows of S floats, then the chunk buffers; 0 if S is too
// short for W or H is not a band height of W
int staged_smem_bytes(int W, int S, int H) {
  const int side = kTile + W - 1;
  if (W < 1 || H < 1 || H > W || S < side) return 0;
  return (((kTile - 1 + H) * S * 4 + 15) / 16) * 16 + kTailBytes;
}

// the staged kernel for P pixels a thread, with bands where H < W
template <int P>
decltype(&quad_accumulate_staged_kernel<P, false>) staged_kernel(int W,
                                                                 int H) {
  return H < W ? quad_accumulate_staged_kernel<P, true>
               : quad_accumulate_staged_kernel<P, false>;
}

template <int P>
cudaError_t staged_launch(const void* stiles, const void* k,
                          const void* qstart, const void* qcount,
                          const void* snips, int blocks, int W, int C, int S,
                          int H, int threads, int smem_bytes, void* sum,
                          void* num, cudaStream_t stream) {
  const auto kernel = staged_kernel<P>(W, H);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem_bytes, stream>>>(
      (const float*)stiles, (const int32_t*)k, (const int32_t*)qstart,
      (const int32_t*)qcount, (const int32_t*)snips, W, C, S, H,
      smem_bytes - kTailBytes, (float*)sum, (int32_t*)num);
  return cudaGetLastError();
}

// The thread's current device for one launcher call: set to `device` on
// entry and put back to the caller's on every return path, so that a launch
// on one card leaves what PyTorch reads as the current device (and every
// later "cuda" without an index) as it found it.
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

// Launches the staged kernel over nq work items, ceil(W / H) blocks an item
// (one a band of H window rows); an item may hold many groups, sorted. S is
// the corner's row stride in floats, P the pixels a thread holds,
// smem_bytes the dynamic shared memory the caller worked out: it must equal
// this file's own layout, or the launch is refused with
// cudaErrorInvalidValue, as is a P that does not fit the band. `stream` is a
// cudaStream_t of device `device`. All pointers are device pointers; sum
// [C, W, W] float32 and num [C, W, W] int32 must be zeroed by the caller.
// Returns the CUDA error code of the launch (0 on success); nothing is
// synchronized.
int quad_accumulate_staged_launch(const void* stiles, const void* k,
                                  const void* qstart, const void* qcount,
                                  const void* snips, int nq, int W, int C,
                                  int S, int H, int P, int smem_bytes,
                                  void* sum, void* num, void* stream,
                                  int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int threads = staged_threads(W, H, P);
  if (threads == 0 || smem_bytes != staged_smem_bytes(W, S, H))
    return (int)cudaErrorInvalidValue;
  if (nq <= 0) return (int)cudaSuccess;
  const long long blocks = (long long)nq * ((W + H - 1) / H);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int nb = (int)blocks;
  cudaStream_t st = (cudaStream_t)stream;
  switch (P) {
    case 1:
      return (int)staged_launch<1>(stiles, k, qstart, qcount, snips, nb, W, C,
                                   S, H, threads, smem_bytes, sum, num, st);
    case 2:
      return (int)staged_launch<2>(stiles, k, qstart, qcount, snips, nb, W, C,
                                   S, H, threads, smem_bytes, sum, num, st);
    case 4:
      return (int)staged_launch<4>(stiles, k, qstart, qcount, snips, nb, W, C,
                                   S, H, threads, smem_bytes, sum, num, st);
    case 8:
      return (int)staged_launch<8>(stiles, k, qstart, qcount, snips, nb, W, C,
                                   S, H, threads, smem_bytes, sum, num, st);
    default:
      return (int)staged_launch<16>(stiles, k, qstart, qcount, snips, nb, W,
                                    C, S, H, threads, smem_bytes, sum, num,
                                    st);
  }
}

const char* quad_accumulate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
