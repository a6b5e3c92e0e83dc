// Batched forecast of the HA fleet's metric series, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference leaves its forecast to XLA
// (karpenter_tpu/forecast/models.py::forecast). It replaces the port's
// plain PyTorch program (forecast/models.py::forecast_reference), whose
// five sequential loops over T run as ~4,000 elementwise kernels of S
// elements each in a fused tick at S = 6,144, T = 64: launch-sized kernels
// that leave the card idle. Per series it computes, in this order, the
// mirror's (forecast_numpy's) five passes over the history: a weighted
// least-squares line on the base weights, its residual sum of squares, a
// Huber-style reweight and a second line, that line's residual sum, and
// the masked Holt-Winters recurrence with a seasonal buffer of
// m = clamp(season, 1, T) slots; then the model select and the `cnt > 0`
// guard, into point, sigma2 and n_valid.
//
// What bounds it on this card: latency. The operands are ~5.1 MB at the
// fleet's shape (~1.5 us at 3.35 TB/s) and the arithmetic is a few dozen
// operations per sample, but every sum over time is a chain of T dependent
// steps, and each step of a float64-rounded multiply-add is a round trip
// through float64. The design:
//   * one thread per series, so each chain runs in registers with no
//     synchronisation; a block is one tile of up to kMaxSeries series (a
//     warp), so S = 6,144 gives 192 blocks over the 132 SMs, all resident
//     at once;
//   * the tile's [series, T] rows of values, valid, times and weights are
//     row-major in device memory, so a thread reading its own row would
//     stride by T: the block loads them instead with consecutive lanes on
//     consecutive samples of one row, into shared memory laid out
//     time-major ([step][series + 1]: the odd stride keeps both the
//     loading writes and the per-step reads free of bank conflicts);
//   * the tile is loaded once when the whole history fits (the fleet's
//     T = 64), else in chunks of `chunk` steps, reloaded for each sweep;
//   * four sweeps, the first carrying two independent chains (the first
//     line's sums and the Holt-Winters scan) so their latencies overlap;
//     the Huber weights are recomputed where they are used, never stored;
//   * the seasonal buffer sits in shared memory ([slot][series]: each lane
//     in its own bank), or, for a history too long for any tile, in a
//     scratch the wrapper allocates ([block][slot][series]);
//   * the shared memory a block takes never passes 48 KB, so no launch
//     needs a function attribute; the tile's size (series a block, steps a
//     chunk) follows from T alone (forecast/models.py::forecast_plan);
//   * bitwise the mirror: every float32 operation rounds once
//     (__fadd_rn, __fsub_rn, __fmul_rn, IEEE __fdiv_rn), each of the
//     mirror's `_fma` is an exact float64 product, a float64 add and one
//     rounding to float32, every sum runs over t = 0..T-1 in order, and
//     round() is rintf (half to even). Built with --fmad=false and without
//     --use_fast_math.
// One launch a call, no allocation and no synchronisation, so a fused
// tick's CUDA graph captures it as one node.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeries = 32;
constexpr int kSharedBudget = 49152;
constexpr int kModelHoltWinters = 1;
// f32(1.5) * f32(1.5), exact: the Huber threshold squared
constexpr float kHuberK2 = 2.25f;
// floor of the per-step horizon conversion (degenerate spacing)
constexpr float kMinStep = 1e-3f;

struct Operands {
  const float* __restrict__ values;   // [S, T]
  const uint8_t* __restrict__ valid;  // [S, T] 0/1
  const float* __restrict__ times;    // [S, T]
  const float* __restrict__ weights;  // [S, T]
  const float* horizon;  // [S]
  const float* step_s;   // [S]
  const int32_t* model;  // [S]
  const int32_t* season; // [S]
  const float* alpha;    // [S]
  const float* beta;     // [S]
  const float* gamma;    // [S]
};

struct Outputs {
  float* point;           // [S]
  float* sigma2;          // [S]
  int32_t* n_valid;       // [S]
  float* season_scratch;  // [n_blocks, T, series] or null (shared buffer)
};

// f32(a*b + c) with the product exact in float64 and one float64 add:
// the mirror's _fma
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// The weighted least-squares line from its five sums: (slope, intercept at
// t = 0); fewer than two points or no spread in time give slope 0
__device__ __forceinline__ void line(float sw, float st, float sv, float stt,
                                     float stv, float& slope, float& icept) {
  const float den = fma64(sw, stt, -__fmul_rn(st, st));
  const float num = fma64(sw, stv, -__fmul_rn(st, sv));
  slope = den > 0.f ? __fdiv_rn(num, den) : 0.f;
  const float sw_safe = sw > 0.f ? sw : 1.f;
  icept = fma64(-slope, __fdiv_rn(st, sw_safe), __fdiv_rn(sv, sw_safe));
}

// One block: `blockDim.x` series (its tile) from row blockIdx.x *
// blockDim.x, the history in chunks of `chunk` steps
template <bool kSharedSeason>
__global__ void forecast_kernel(const Operands op, const Outputs out, int S,
                                int T, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = blockDim.x;
  const int lane = threadIdx.x;
  const int ld = ns + 1;
  const long long first = (long long)blockIdx.x * ns;
  const int rows = (int)min((long long)ns, (long long)S - first);
  const long long row = first + lane;
  const bool live = lane < rows;

  // this series' seasonal slot 0; slot i is seas[i * ns]
  float* seas;
  unsigned char* tile = smem;
  if (kSharedSeason) {
    seas = reinterpret_cast<float*>(smem) + lane;
    tile += sizeof(float) * (size_t)T * ns;
  } else {
    seas = out.season_scratch + (size_t)blockIdx.x * T * ns + lane;
  }
  float* tx = reinterpret_cast<float*>(tile);
  float* tt = tx + (size_t)chunk * ld;
  float* tw = tt + (size_t)chunk * ld;
  uint8_t* tv = reinterpret_cast<uint8_t*>(tw + (size_t)chunk * ld);

  // steps c0 .. c0 + n - 1 of the tile's rows into shared memory: lanes
  // on consecutive samples of one row (coalesced), written time-major;
  // the read-only loads of eight rows are in flight at once
  auto load = [&](int c0, int n) {
    __syncthreads();  // every read of the previous chunk is done
    for (int k = lane; k < n; k += ns) {
      const size_t base = (size_t)first * T + c0 + k;
#pragma unroll 8
      for (int s = 0; s < rows; ++s) {
        const size_t g = base + (size_t)s * T;
        const int at = k * ld + s;
        tx[at] = __ldg(op.values + g);
        tt[at] = __ldg(op.times + g);
        tw[at] = __ldg(op.weights + g);
        tv[at] = __ldg(op.valid + g);
      }
    }
    __syncthreads();
  };
  const bool whole = chunk >= T;
  if (whole) load(0, T);
  // step(value, time, base weight, valid) for t = 0 .. T-1, in order
  auto sweep = [&](auto&& step) {
    for (int c0 = 0; c0 < T; c0 += chunk) {
      const int n = min(chunk, T - c0);
      if (!whole) load(c0, n);
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const int at = k * ld + lane;
        step(tx[at], tt[at], tw[at], tv[at] != 0);
      }
    }
  };

  float horizon = 0.f, step_s = 1.f, alpha = 0.f, beta = 0.f, gamma = 0.f;
  int model = 0, season = 0;
  if (live) {
    horizon = op.horizon[row];
    step_s = op.step_s[row];
    alpha = op.alpha[row];
    beta = op.beta[row];
    gamma = op.gamma[row];
    model = op.model[row];
    season = op.season[row];
  }
  const int m = min(max(season, 1), T);
  const bool seasonal = season >= 2;
  if (seasonal)
    for (int i = 0; i < m; ++i) seas[(size_t)i * ns] = 0.f;

  // sweep 1: the line on the base weights, and the Holt-Winters scan
  float sw = 0.f, st = 0.f, sv = 0.f, stt = 0.f, stv = 0.f;
  float level = 0.f, trend = 0.f;
  int cnt = 0, slot = 0;  // slot = cnt mod m
  sweep([&](float x, float tm, float wb, bool v) {
    const float w = v ? wb : 0.f;
    const float wt = __fmul_rn(w, tm);
    sw = __fadd_rn(sw, w);
    st = fma64(w, tm, st);
    sv = fma64(w, x, sv);
    stt = fma64(wt, tm, stt);
    stv = fma64(wt, x, stv);
    if (!v) return;  // an invalid step changes no state of the scan
    float* at = seas + (size_t)slot * ns;
    const float s_old = seasonal ? *at : 0.f;
    // the lerp forms c + a*(x - c), one rounding each
    const float q = __fadd_rn(level, trend);
    const float nl = fma64(alpha, __fsub_rn(__fsub_rn(x, s_old), q), q);
    const float nt =
        fma64(beta, __fsub_rn(__fsub_rn(nl, level), trend), trend);
    const float ns_new =
        fma64(gamma, __fsub_rn(__fsub_rn(x, nl), s_old), s_old);
    const bool init = cnt == 0;
    level = init ? x : nl;
    trend = init ? 0.f : nt;
    if (seasonal) *at = ns_new;
    ++cnt;
    slot = slot + 1 == m ? 0 : slot + 1;
  });
  float slope0, icept0;
  line(sw, st, sv, stt, stv, slope0, icept0);

  // sweep 2: the first line's weighted squared residuals; their weight
  // sum is sw (the same adds in the same order)
  float sse0 = 0.f;
  sweep([&](float x, float tm, float wb, bool v) {
    const float w = v ? wb : 0.f;
    const float r = __fsub_rn(x, fma64(slope0, tm, icept0));
    sse0 = fma64(__fmul_rn(w, r), r, sse0);
  });
  const float k2s = __fmul_rn(kHuberK2, __fdiv_rn(sse0, sw > 0.f ? sw : 1.f));
  // the Huber weight: base * min(1, k2s / r^2) on the first line's residual
  auto robust = [&](float x, float tm, float wb) {
    const float r = __fsub_rn(x, fma64(slope0, tm, icept0));
    const float r2 = __fmul_rn(r, r);
    return __fmul_rn(wb, r2 > k2s ? __fdiv_rn(k2s, r2 > 0.f ? r2 : 1.f) : 1.f);
  };

  // sweep 3: the line on the Huber weights
  float sw1 = 0.f, st1 = 0.f, sv1 = 0.f, stt1 = 0.f, stv1 = 0.f;
  sweep([&](float x, float tm, float wb, bool v) {
    const float w = v ? robust(x, tm, wb) : 0.f;
    const float wt = __fmul_rn(w, tm);
    sw1 = __fadd_rn(sw1, w);
    st1 = fma64(w, tm, st1);
    sv1 = fma64(w, x, sv1);
    stt1 = fma64(wt, tm, stt1);
    stv1 = fma64(wt, x, stv1);
  });
  float slope, icept;
  line(sw1, st1, sv1, stt1, stv1, slope, icept);

  // sweep 4: its weighted squared residuals (weight sum sw1)
  float sse = 0.f;
  sweep([&](float x, float tm, float wb, bool v) {
    const float w = v ? robust(x, tm, wb) : 0.f;
    const float r = __fsub_rn(x, fma64(slope, tm, icept));
    sse = fma64(__fmul_rn(w, r), r, sse);
  });
  if (!live) return;  // no barrier follows
  const float sigma2 = __fdiv_rn(sse, sw1 > 0.f ? sw1 : 1.f);
  const float point_lin = fma64(slope, horizon, icept);

  // Holt-Winters at the horizon: the newest sample sat at phase
  // (cnt-1) mod m, the target round(h_steps) later (half to even)
  // max(step_s, kMinStep), a NaN passing through as the mirror's
  const float step = !(step_s <= kMinStep) ? step_s : kMinStep;
  const float h_steps = __fdiv_rn(horizon, step);
  const int h_i = static_cast<int>(rintf(h_steps));
  // int32 arithmetic wraps, as the mirror's; the remainder takes m's sign
  int idx = (int)((unsigned)(cnt > 0 ? cnt - 1 : 0) + (unsigned)h_i) % m;
  if (idx < 0) idx += m;
  const float seas_at = seasonal ? seas[(size_t)idx * ns] : 0.f;
  const float point_hw = __fadd_rn(fma64(trend, h_steps, level), seas_at);
  const float point = model == kModelHoltWinters ? point_hw : point_lin;
  out.point[row] = cnt > 0 ? point : 0.f;
  out.sigma2[row] = sigma2;
  out.n_valid[row] = cnt;
}

}  // namespace

extern "C" {

const char* forecast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches forecast_kernel on `stream` over S series of T samples, with
// the plan of forecast/models.py::forecast_plan: `series` a block (1 to
// kMaxSeries), `chunk` steps a load (1 to T) and `shared_bytes` of dynamic
// shared memory, which must equal the plan's (the seasonal buffer's
// 4 T series bytes unless `season_scratch` is given, plus 13 (series + 1)
// bytes a step of the chunk) and stay within kSharedBudget.
// `season_scratch` is null, or float[ceil(S / series) * T * series] when
// the buffer lives in device memory. Launches nothing when S is 0.
// Returns the cudaError_t (0 on success).
int forecast_launch(
    const void* values, const void* valid, const void* times,
    const void* weights, const void* horizon, const void* step_s,
    const void* model, const void* season, const void* alpha,
    const void* beta, const void* gamma,
    int S, int T, int series, int chunk, int shared_bytes,
    void* point, void* sigma2, void* n_valid, void* season_scratch,
    void* stream)
{
  if (S < 0 || T < 1 || series < 1 || series > kMaxSeries || chunk < 1 ||
      chunk > T)
    return (int)cudaErrorInvalidValue;
  const bool shared_season = season_scratch == nullptr;
  const long long need = (shared_season ? 4LL * T * series : 0LL) +
                         13LL * (series + 1) * chunk;
  if (need != shared_bytes || need > kSharedBudget)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const Operands op = {
      static_cast<const float*>(values), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(times), static_cast<const float*>(weights),
      static_cast<const float*>(horizon), static_cast<const float*>(step_s),
      static_cast<const int32_t*>(model), static_cast<const int32_t*>(season),
      static_cast<const float*>(alpha), static_cast<const float*>(beta),
      static_cast<const float*>(gamma)};
  const Outputs out = {static_cast<float*>(point),
                       static_cast<float*>(sigma2),
                       static_cast<int32_t*>(n_valid),
                       static_cast<float*>(season_scratch)};
  const int blocks = (S + series - 1) / series;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared_season)
    forecast_kernel<true><<<blocks, series, shared_bytes, s>>>(op, out, S, T,
                                                               chunk);
  else
    forecast_kernel<false><<<blocks, series, shared_bytes, s>>>(op, out, S,
                                                                T, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
