// Native host-side ingest for coolpuppy_tpu_torch (a copy of
// coolpuppy_tpu/native/_ingest.cpp with entries of its own: the thread
// setter, the region fetch's column filter and the tile upload's float16
// cast).
//
// The hot host-side loops behind the device pipeline: the column filter of
// a region fetch (the plain version in io/cool.py is a numpy mask and three
// boolean takes), scattering COO pixels into the block-sparse tile stack
// (the plain version in ops/tiles.py is a numpy bincount chain over ~3
// temporary arrays), the float16 cast of the tile upload wire and its
// scan (the plain versions in ops/tiles.py are numpy casts out and back and
// a nanmax of a copy), the stable counting sort of snip words by tile quad,
// and enumerating all-vs-all feature pairs with distance filtering.
// Compiled to a plain shared library at first use and bound with ctypes
// (coolpuppy_tpu_torch/native/build.py, __init__.py).
//
// ingest_set_threads(n) sets the OpenMP team size of every entry for every
// calling thread (an OpenMP runtime keeps omp_set_num_threads per thread,
// and the engine calls these entries from worker threads too).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>
#if defined(__F16C__) && defined(__AVX__)
#include <immintrin.h>
#define INGEST_F16C 1
#endif
#ifdef _OPENMP
// declared here rather than through <omp.h>: a compiler built without its
// OpenMP runtime still compiles the pragmas, and build.py links the runtime
// it finds (torch's own libgomp first)
extern "C" int omp_get_max_threads(void);
extern "C" int omp_get_thread_num(void);
#endif

// team size of every parallel region below; 0 = the runtime's default
static int g_threads = 0;

static inline int ingest_threads() {
#ifdef _OPENMP
  return g_threads > 0 ? g_threads : omp_get_max_threads();
#else
  return 1;
#endif
}

// Two-pass conflict-free scatter: counting-sort the (tile, cell, value)
// entries by tile (parallel, per-thread histograms), then reduce each tile's
// run with exactly one thread. Beats both float atomics (~2x) and
// thread-private stack copies (whose 67 MB-per-thread serial merge dominated
// at 12M nnz / K~1000). `emit(i, ks, ix, vs)` yields 0..2 entries for input
// i, already filtered to mapped tiles (k >= 1).
template <typename EmitFn>
static void scatter_two_pass(int64_t nnz, int64_t K, int64_t B, EmitFn emit,
                             float* out) {
#ifdef _OPENMP
  int nt = ingest_threads();
  if (nt > 16) nt = 16;
#else
  int nt = 1;
#endif
  const int64_t nb = K;  // buckets are tiles 1..K, stored at k-1
  std::vector<int64_t> hist((size_t)nt * nb, 0);
#pragma omp parallel num_threads(nt)
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t lo = nnz * t / nt, hi = nnz * (t + 1) / nt;
    int64_t* h = hist.data() + (size_t)t * nb;
    int32_t ks[2], ix[2];
    float vs[2];
    for (int64_t i = lo; i < hi; i++) {
      const int n = emit(i, ks, ix, vs);
      for (int e = 0; e < n; e++) h[ks[e] - 1]++;
    }
  }
  std::vector<int64_t> bstart(nb + 1);
  int64_t run = 0;
  for (int64_t b = 0; b < nb; b++) {
    bstart[b] = run;
    int64_t total = 0;
    for (int tt = 0; tt < nt; tt++) {
      int64_t c = hist[(size_t)tt * nb + b];
      hist[(size_t)tt * nb + b] = run + total;
      total += c;
    }
    run += total;
  }
  bstart[nb] = run;
  // raw allocations: value-init of ~100 MB staging would cost real memsets
  std::unique_ptr<int32_t[]> ecell(new int32_t[run]);
  std::unique_ptr<float[]> evalv(new float[run]);
#pragma omp parallel num_threads(nt)
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t lo = nnz * t / nt, hi = nnz * (t + 1) / nt;
    int64_t* cur = hist.data() + (size_t)t * nb;
    int32_t ks[2], ix[2];
    float vs[2];
    for (int64_t i = lo; i < hi; i++) {
      const int n = emit(i, ks, ix, vs);
      for (int e = 0; e < n; e++) {
        const int64_t p = cur[ks[e] - 1]++;
        ecell[p] = ix[e];
        evalv[p] = vs[e];
      }
    }
  }
#pragma omp parallel for schedule(dynamic, 8) num_threads(nt)
  for (int64_t k = 0; k < nb; k++) {
    float* tile = out + (k + 1) * B * B;
    for (int64_t p = bstart[k]; p < bstart[k + 1]; p++) {
      tile[ecell[p]] += evalv[p];
    }
  }
}

// Scatter nnz COO entries into a zeroed tile stack [K+1, B, B] (f32).
// tile_map is the dense [tm_rows, tm_cols] grid -> stack index (0 = skip).
template <typename I, typename V>
static void tile_scatter_impl(const I* rows, const I* cols, const V* vals,
                              int64_t nnz, const int32_t* tile_map,
                              int64_t tm_cols, int64_t B, int64_t K,
                              float* out) {
  if (nnz > (int64_t)1 << 19 && K < (int64_t)1 << 18) {
    scatter_two_pass(
        nnz, K, B,
        [=](int64_t i, int32_t* ks, int32_t* ix, float* vs) -> int {
          const int64_t tr = (int64_t)rows[i] / B;
          const int64_t tc = (int64_t)cols[i] / B;
          const int32_t k = tile_map[tr * tm_cols + tc];
          if (k <= 0) return 0;
          ks[0] = k;
          ix[0] = (int32_t)(((int64_t)rows[i] - tr * B) * B +
                            ((int64_t)cols[i] - tc * B));
          vs[0] = (float)vals[i];
          return 1;
        },
        out);
    return;
  }
  const int64_t stack = (K + 1) * B * B;
#ifdef _OPENMP
  const bool priv = stack * (int64_t)sizeof(float) < (int64_t)128 << 20 &&
                    nnz > stack / 4;
#else
  const bool priv = false;
#endif
  if (!priv) {
#pragma omp parallel for schedule(static) num_threads(ingest_threads())
    for (int64_t i = 0; i < nnz; i++) {
      const int64_t tr = (int64_t)rows[i] / B;
      const int64_t tc = (int64_t)cols[i] / B;
      const int32_t k = tile_map[tr * tm_cols + tc];
      if (k > 0) {
        float* cell = out + ((int64_t)k * B + ((int64_t)rows[i] - tr * B)) * B +
                      ((int64_t)cols[i] - tc * B);
#pragma omp atomic
        *cell += (float)vals[i];
      }
    }
    return;
  }
#ifdef _OPENMP
#pragma omp parallel num_threads(ingest_threads())
  {
    const int t = omp_get_thread_num();
    float* buf = t == 0 ? out : new float[stack]();
#pragma omp for schedule(static)
    for (int64_t i = 0; i < nnz; i++) {
      const int64_t tr = (int64_t)rows[i] / B;
      const int64_t tc = (int64_t)cols[i] / B;
      const int32_t k = tile_map[tr * tm_cols + tc];
      if (k > 0) {
        buf[((int64_t)k * B + ((int64_t)rows[i] - tr * B)) * B +
            ((int64_t)cols[i] - tc * B)] += (float)vals[i];
      }
    }
    if (t != 0) {
#pragma omp critical
      {
        for (int64_t j = 0; j < stack; j++) out[j] += buf[j];
      }
      delete[] buf;
    }
  }
#endif
}

// team size of a pass over nchunks chunks: no more threads than chunks
static inline int chunk_threads(int64_t nchunks) {
  const int nt = ingest_threads();
  return nchunks < nt ? (int)nchunks : nt;
}

// Column filter of a region fetch (io/cool.py, Cooler._fetch_rect_raw): of
// a bin1 row span's pixels, those whose bin2 lies in [lo2, hi2), counts cast
// to D. out1 == NULL: every pixel is kept (slab_count said so) and only the
// counts are cast. Otherwise chunk t of the input writes its kept pixels from
// the sum of kept[] over the chunks before it, in input order: numpy's
// boolean-take order.
template <typename S, typename D>
static void slab_select_impl(const int64_t* bin1, const int64_t* bin2,
                             const S* count, int64_t n, int64_t lo2,
                             int64_t hi2, int64_t nchunks,
                             const int64_t* kept, int64_t* out1,
                             int64_t* out2, D* outv) {
  const int nt = chunk_threads(nchunks);
  if (!out1) {
#pragma omp parallel for schedule(static) num_threads(nt)
    for (int64_t i = 0; i < n; i++) outv[i] = (D)count[i];
    return;
  }
  std::vector<int64_t> start(nchunks);
  int64_t run = 0;
  for (int64_t t = 0; t < nchunks; t++) {
    start[t] = run;
    run += kept[t];
  }
#pragma omp parallel for schedule(static, 1) num_threads(nt)
  for (int64_t t = 0; t < nchunks; t++) {
    const int64_t lo = n * t / nchunks, hi = n * (t + 1) / nchunks;
    int64_t p = start[t];
    for (int64_t i = lo; i < hi; i++) {
      if (bin2[i] >= lo2 && bin2[i] < hi2) {
        out1[p] = bin1[i];
        out2[p] = bin2[i];
        outv[p] = (D)count[i];
        p++;
      }
    }
  }
}

template <typename S>
static void slab_select_to(const int64_t* bin1, const int64_t* bin2,
                           const S* count, int64_t n, int64_t lo2,
                           int64_t hi2, int64_t nchunks, const int64_t* kept,
                           int64_t* out1, int64_t* out2, void* outv,
                           int32_t out_f64) {
  if (out_f64) {
    slab_select_impl(bin1, bin2, count, n, lo2, hi2, nchunks, kept, out1,
                     out2, (double*)outv);
  } else {
    slab_select_impl(bin1, bin2, count, n, lo2, hi2, nchunks, kept, out1,
                     out2, (float*)outv);
  }
}

// -- the float16 upload wire (ops/tiles.cast_slab_f16, f16_wire_plan) -----

// values a chunk of the cast and the scan, and the payload from which they
// run an OpenMP team (a region's 4.6M values: ~1.6 ms on one thread of an
// H100 host, ~0.4 ms on a team of seven)
static const int64_t kCastChunk = (int64_t)1 << 16;
static const int64_t kCastTeamMin = (int64_t)1 << 20;

// float32 -> float16 bits, rounded to nearest even: the bits of numpy's
// float32 -> float16 cast (and of F16C's), NaN kept NaN with the top of its
// payload, overflow to signed inf, float16 subnormals rounded once
static inline uint16_t f16_bits(float x) {
  uint32_t f;
  std::memcpy(&f, &x, 4);
  const uint16_t sign = (uint16_t)((f >> 16) & 0x8000u);
  const uint32_t exp = f & 0x7f800000u;
  uint32_t sig = f & 0x007fffffu;
  if (exp == 0x7f800000u) {  // inf or NaN
    uint16_t h = (uint16_t)(0x7c00u | (sig >> 13));
    if (sig && h == 0x7c00u) h++;  // a NaN whose payload sits low
    return sign | h;
  }
  if (exp >= 0x47800000u) return sign | 0x7c00u;  // |x| >= 2^16
  if (exp <= 0x38000000u) {  // |x| < 2^-14: a float16 subnormal or zero
    if (exp < 0x33000000u) return sign;  // below half the least subnormal
    const uint32_t shift = 126 - (exp >> 23);  // 14..24
    const uint32_t m = sig | 0x00800000u;
    uint32_t h = m >> shift;
    const uint32_t rest = m & ((1u << shift) - 1), half = 1u << (shift - 1);
    if (rest > half || (rest == half && (h & 1u))) h++;
    return sign | (uint16_t)h;  // a carry into the exponent is right
  }
  uint32_t h = ((exp - 0x38000000u) >> 13) | (sig >> 13);
  const uint32_t rest = sig & 0x1fffu;
  if (rest > 0x1000u || (rest == 0x1000u && (h & 1u))) h++;
  return sign | (uint16_t)h;  // a carry past 0x7bff gives inf
}

// float16 bits -> float32, exact
static inline float f16_value(uint16_t h) {
  const uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  const uint32_t exp = (h >> 10) & 0x1fu, man = h & 0x3ffu;
  uint32_t f;
  if (exp == 0x1fu) {
    f = sign | 0x7f800000u | (man << 13);
  } else if (exp) {
    f = sign | ((exp + 112) << 23) | (man << 13);
  } else {
    const float v = std::ldexp((float)man, -24);
    return sign ? -v : v;
  }
  float x;
  std::memcpy(&x, &f, 4);
  return x;
}

// One run of the cast: h[i] = f16(x[i] * scale). EXACT also converts back,
// multiplies by inv and returns false at the first value that does not
// come back equal (or NaN for NaN).
template <bool EXACT>
static bool cast_run(const float* x, int64_t n, float scale, float inv,
                     uint16_t* h) {
  int64_t i = 0;
#ifdef INGEST_F16C
  const __m256 vs = _mm256_set1_ps(scale), vi = _mm256_set1_ps(inv);
  for (; i + 8 <= n; i += 8) {
    const __m256 v = _mm256_loadu_ps(x + i);
    const __m128i w =
        _mm256_cvtps_ph(_mm256_mul_ps(v, vs), _MM_FROUND_TO_NEAREST_INT);
    _mm_storeu_si128((__m128i*)(h + i), w);
    if (EXACT) {
      const __m256 rt = _mm256_mul_ps(_mm256_cvtph_ps(w), vi);
      const __m256 same = _mm256_or_ps(
          _mm256_cmp_ps(rt, v, _CMP_EQ_OQ),
          _mm256_and_ps(_mm256_cmp_ps(rt, rt, _CMP_UNORD_Q),
                        _mm256_cmp_ps(v, v, _CMP_UNORD_Q)));
      if (_mm256_movemask_ps(same) != 0xff) return false;
    }
  }
#endif
  for (; i < n; i++) {
    const uint16_t b = f16_bits(x[i] * scale);
    h[i] = b;
    if (EXACT) {
      const float rt = f16_value(b) * inv;
      if (!(rt == x[i] || (std::isnan(rt) && std::isnan(x[i])))) return false;
    }
  }
  return true;
}

extern "C" {

// Set the team size of every entry (n > 0; n <= 0 leaves it) and return
// the team size in effect.
int ingest_set_threads(int n) {
  if (n > 0) g_threads = n;
  return ingest_threads();
}

void tile_scatter(const int64_t* rows, const int64_t* cols, const double* vals,
                  int64_t nnz, const int32_t* tile_map, int64_t tm_cols,
                  int64_t B, int64_t K, float* out) {
  tile_scatter_impl(rows, cols, vals, nnz, tile_map, tm_cols, B, K, out);
}

// scipy's native COO dtypes (int32 indices, float32 data) — scatter without
// the 200 MB of dtype-conversion copies the generic entry would force
void tile_scatter_i32f32(const int32_t* rows, const int32_t* cols,
                         const float* vals, int64_t nnz,
                         const int32_t* tile_map, int64_t tm_cols, int64_t B,
                         int64_t K, float* out) {
  tile_scatter_impl(rows, cols, vals, nnz, tile_map, tm_cols, B, K, out);
}

void tile_scatter_i32f64(const int32_t* rows, const int32_t* cols,
                         const double* vals, int64_t nnz,
                         const int32_t* tile_map, int64_t tm_cols, int64_t B,
                         int64_t K, float* out) {
  tile_scatter_impl(rows, cols, vals, nnz, tile_map, tm_cols, B, K, out);
}

// Fused triangle scatter: one pass over the STORED (upper-triangle) pixels of
// a cooler region fetch, folding in balancing weights and the symmetric
// mirror, so the host never materializes the mirrored/balanced COO (the
// reference materializes it via clr.matrix(sparse=True).fetch, then slices —
// coolpup.py:1053–1057, 1115–1121).
//
// rows/cols are GLOBAL bin ids; the logical rectangle is rows in
// [lo1, lo1+n1), cols in [lo2, lo2+n2). w (global per-bin, NaN already
// cleaned to 0) may be NULL for unbalanced. mirror!=0 additionally scatters
// the transposed pixel (cis same-extent fetches, skipping the diagonal).
static inline void scatter_one_wtri(int64_t gr, int64_t gc, float v,
                                    int64_t lo1, int64_t lo2, int64_t n1,
                                    int64_t n2, const int32_t* tile_map,
                                    int64_t tm_cols, int64_t B, float* buf) {
  const int64_t r = gr - lo1, c = gc - lo2;
  if (r >= 0 && r < n1 && c >= 0 && c < n2) {
    const int32_t k = tile_map[(r / B) * tm_cols + (c / B)];
    if (k > 0) {
      buf[((int64_t)k * B + (r % B)) * B + (c % B)] += v;
    }
  }
}

void tile_scatter_wtri(const int64_t* rows, const int64_t* cols,
                       const float* vals, int64_t nnz, int64_t lo1,
                       int64_t lo2, int64_t n1, int64_t n2, const float* w,
                       const int32_t* tile_map, int64_t tm_cols, int64_t B,
                       int64_t K, int32_t mirror, float* out) {
  if (nnz > (int64_t)1 << 19 && K < (int64_t)1 << 18) {
    scatter_two_pass(
        nnz, K, B,
        [=](int64_t i, int32_t* ks, int32_t* ix, float* vs) -> int {
      const int64_t gr = rows[i], gc = cols[i];
      float v = vals[i];
      if (w) v *= w[gr] * w[gc];
      int n = 0;
      {
        const int64_t r = gr - lo1, c = gc - lo2;
        if (r >= 0 && r < n1 && c >= 0 && c < n2) {
          const int32_t k = tile_map[(r / B) * tm_cols + (c / B)];
          if (k > 0) {
            ks[n] = k;
            ix[n] = (int32_t)((r % B) * B + (c % B));
            vs[n] = v;
            n++;
          }
        }
      }
      if (mirror && gr != gc) {
        const int64_t r = gc - lo1, c = gr - lo2;
        if (r >= 0 && r < n1 && c >= 0 && c < n2) {
          const int32_t k = tile_map[(r / B) * tm_cols + (c / B)];
          if (k > 0) {
            ks[n] = k;
            ix[n] = (int32_t)((r % B) * B + (c % B));
            vs[n] = v;
            n++;
          }
        }
      }
      return n;
        },
        out);
    return;
  }
  const int64_t stack = (K + 1) * B * B;
#ifdef _OPENMP
  const bool priv = stack * (int64_t)sizeof(float) < (int64_t)128 << 20 &&
                    nnz > stack / 4;
  if (priv) {
#pragma omp parallel num_threads(ingest_threads())
    {
      const int t = omp_get_thread_num();
      float* buf = t == 0 ? out : new float[stack]();
#pragma omp for schedule(static)
      for (int64_t i = 0; i < nnz; i++) {
        const int64_t gr = rows[i], gc = cols[i];
        float v = vals[i];
        if (w) v *= w[gr] * w[gc];
        scatter_one_wtri(gr, gc, v, lo1, lo2, n1, n2, tile_map, tm_cols, B,
                         buf);
        if (mirror && gr != gc) {
          scatter_one_wtri(gc, gr, v, lo1, lo2, n1, n2, tile_map, tm_cols, B,
                           buf);
        }
      }
      if (t != 0) {
#pragma omp critical
        {
          for (int64_t j = 0; j < stack; j++) out[j] += buf[j];
        }
        delete[] buf;
      }
    }
    return;
  }
#endif
#pragma omp parallel for schedule(static) num_threads(ingest_threads())
  for (int64_t i = 0; i < nnz; i++) {
    const int64_t gr = rows[i], gc = cols[i];
    float v = vals[i];
    if (w) v *= w[gr] * w[gc];
    const int64_t r = gr - lo1, c = gc - lo2;
    if (r >= 0 && r < n1 && c >= 0 && c < n2) {
      const int32_t k = tile_map[(r / B) * tm_cols + (c / B)];
      if (k > 0) {
        float* cell = out + ((int64_t)k * B + (r % B)) * B + (c % B);
#pragma omp atomic
        *cell += v;
      }
    }
    if (mirror && gr != gc) {
      const int64_t r2 = gc - lo1, c2 = gr - lo2;
      if (r2 >= 0 && r2 < n1 && c2 >= 0 && c2 < n2) {
        const int32_t k = tile_map[(r2 / B) * tm_cols + (c2 / B)];
        if (k > 0) {
          float* cell = out + ((int64_t)k * B + (r2 % B)) * B + (c2 % B);
#pragma omp atomic
          *cell += v;
        }
      }
    }
  }
}

// Pass 1 of the column filter: kept[t] = the pixels of chunk t (of nchunks
// equal contiguous chunks of the n) whose bin2 lies in [lo2, hi2); returns
// their sum.
int64_t slab_count(const int64_t* bin2, int64_t n, int64_t lo2, int64_t hi2,
                   int64_t nchunks, int64_t* kept) {
  const int nt = chunk_threads(nchunks);
#pragma omp parallel for schedule(static, 1) num_threads(nt)
  for (int64_t t = 0; t < nchunks; t++) {
    const int64_t lo = n * t / nchunks, hi = n * (t + 1) / nchunks;
    int64_t k = 0;
    for (int64_t i = lo; i < hi; i++) k += (bin2[i] >= lo2) & (bin2[i] < hi2);
    kept[t] = k;
  }
  int64_t total = 0;
  for (int64_t t = 0; t < nchunks; t++) total += kept[t];
  return total;
}

// Pass 2: count_kind 0 = int32, 1 = float32, 2 = float64 counts; out_f64
// picks float64 over float32 outputs (slab_select_impl).
void slab_select(const int64_t* bin1, const int64_t* bin2, const void* count,
                 int32_t count_kind, int64_t n, int64_t lo2, int64_t hi2,
                 int64_t nchunks, const int64_t* kept, int64_t* out1,
                 int64_t* out2, void* outv, int32_t out_f64) {
  switch (count_kind) {
    case 0:
      slab_select_to(bin1, bin2, (const int32_t*)count, n, lo2, hi2, nchunks,
                     kept, out1, out2, outv, out_f64);
      break;
    case 1:
      slab_select_to(bin1, bin2, (const float*)count, n, lo2, hi2, nchunks,
                     kept, out1, out2, outv, out_f64);
      break;
    default:
      slab_select_to(bin1, bin2, (const double*)count, n, lo2, hi2, nchunks,
                     kept, out1, out2, outv, out_f64);
  }
}

// Enumerate ordered pairs (i, j), i < j, with |center[j] - center[i]| in
// [mindist, maxdist], assuming centers sorted ascending. Writes pair indices
// into out_i/out_j (caller-allocated, capacity cap); returns the number of
// pairs written, or -1 if capacity was exceeded. k-th superdiagonal sweep
// with early exit once min distance at k exceeds maxdist (same enumeration
// order as coords.py::_batches_cis_bed).
// Stable parallel counting sort of a 32-bit payload by small-ranged keys
// (tile-quad ids). Replaces numpy argsort+gather in the pallas dispatch hot
// path (reference hot loop coolpup.py:1104–1191 has no analog: it never
// sorts, it streams). counts[nbuckets] receives the per-key histogram —
// exactly the per-quad snip counts the packer needs, so the caller skips
// np.unique entirely. Threads each own a contiguous input range; stability
// follows from offsetting each thread's scatter cursor by the histograms of
// lower-ranked threads.
void quad_sort(const int32_t* q, const int32_t* payload, int64_t n,
               int64_t nbuckets, int32_t* out_payload, int64_t* counts) {
#ifdef _OPENMP
  int nt = ingest_threads();
  if (nt > 16) nt = 16;
  if (n < (int64_t)1 << 16) nt = 1;
  // cap the transient per-thread histogram at ~64 MB: with nbuckets up to
  // 2^23 a 16-thread histogram would be a ~1 GB allocation
  while (nt > 1 && (size_t)nt * nbuckets * sizeof(int64_t) > (64u << 20))
    nt /= 2;
#else
  const int nt = 1;
#endif
  std::vector<int64_t> hist((size_t)nt * nbuckets, 0);
#pragma omp parallel num_threads(nt)
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
    int64_t* h = hist.data() + (size_t)t * nbuckets;
    for (int64_t i = lo; i < hi; i++) h[q[i]]++;
#ifdef _OPENMP
#pragma omp barrier
#pragma omp single
#endif
    {
      // column-major prefix over (bucket, thread): cursor for thread t at
      // bucket b = sum of all buckets < b plus hist of threads < t at b
      int64_t run = 0;
      for (int64_t b = 0; b < nbuckets; b++) {
        int64_t total = 0;
        for (int tt = 0; tt < nt; tt++) {
          int64_t c = hist[(size_t)tt * nbuckets + b];
          hist[(size_t)tt * nbuckets + b] = run + total;
          total += c;
        }
        counts[b] = total;
        run += total;
      }
    }
    int64_t* cur = hist.data() + (size_t)t * nbuckets;
    for (int64_t i = lo; i < hi; i++) out_payload[cur[q[i]]++] = payload[i];
  }
}

// The float16 wire of n float32 values: h[i] = f16(x[i] * scale), rounded to
// nearest even. exact != 0 also checks that f32(h[i]) * inv gives x[i] back
// (NaN for NaN) and returns 0 at the first that does not, the rest of h then
// undefined; 1 otherwise. A team of ingest_threads() runs chunks of
// kCastChunk values from kCastTeamMin values on.
int32_t cast_f16(const float* x, int64_t n, float scale, float inv,
                 int32_t exact, uint16_t* h) {
  const int64_t nchunks = (n + kCastChunk - 1) / kCastChunk;
  const int nt = n >= kCastTeamMin ? chunk_threads(nchunks) : 1;
  int refused = 0;
#pragma omp parallel for schedule(static) num_threads(nt)
  for (int64_t c = 0; c < nchunks; c++) {
    int stop;
#pragma omp atomic read
    stop = refused;
    if (stop) continue;
    const int64_t lo = c * kCastChunk;
    const int64_t len = n - lo < kCastChunk ? n - lo : kCastChunk;
    const bool ok = exact ? cast_run<true>(x + lo, len, scale, inv, h + lo)
                          : cast_run<false>(x + lo, len, scale, inv, h + lo);
    if (!ok) {
#pragma omp atomic write
      refused = 1;
    }
  }
  return !refused;
}

// The largest |x[i]| of n float32 values, NaN skipped: +inf where one is
// infinite, 0 where none is a number (the scan of f16_wire_plan).
float abs_max(const float* x, int64_t n) {
  const int64_t nchunks = (n + kCastChunk - 1) / kCastChunk;
  const int nt = n >= kCastTeamMin ? chunk_threads(nchunks) : 1;
  float m = 0.0f;
#pragma omp parallel for schedule(static) num_threads(nt) reduction(max : m)
  for (int64_t c = 0; c < nchunks; c++) {
    const int64_t lo = c * kCastChunk;
    const int64_t hi = n - lo < kCastChunk ? n : lo + kCastChunk;
    int64_t i = lo;
    float cm = 0.0f;
#ifdef INGEST_F16C
    const __m256 absmask = _mm256_castsi256_ps(_mm256_set1_epi32(0x7fffffff));
    __m256 vm = _mm256_setzero_ps();
    for (; i + 8 <= hi; i += 8) {
      // max_ps(a, b) gives b where either is NaN: NaN is skipped
      vm = _mm256_max_ps(_mm256_and_ps(_mm256_loadu_ps(x + i), absmask), vm);
    }
    float lanes[8];
    _mm256_storeu_ps(lanes, vm);
    for (int k = 0; k < 8; k++) cm = lanes[k] > cm ? lanes[k] : cm;
#endif
    for (; i < hi; i++) {
      const float a = std::fabs(x[i]);
      cm = a > cm ? a : cm;
    }
    m = cm > m ? cm : m;
  }
  return m;
}

int64_t enumerate_pairs(const double* centers, int64_t n, double mindist,
                        double maxdist, int64_t* out_i, int64_t* out_j,
                        int64_t cap) {
  int64_t count = 0;
  for (int64_t k = 1; k < n; k++) {
    double dmin = 1e300;
    for (int64_t i = 0; i + k < n; i++) {
      const double d = centers[i + k] - centers[i];
      if (d < dmin) dmin = d;
      const double ad = d < 0 ? -d : d;
      if (ad >= mindist && ad <= maxdist) {
        if (count >= cap) return -1;
        out_i[count] = i;
        out_j[count] = i + k;
        count++;
      }
    }
    if (dmin > maxdist) break;
  }
  return count;
}

}  // extern "C"
