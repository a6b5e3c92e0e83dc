// The fused HA tick's row stages, for Hopper (sm_90a): the forecast ->
// decide scatter, decide, the decide -> cost seam and the cost ladder.
//
// Replaces no Pallas kernel: the reference leaves decide and cost to XLA
// (karpenter_tpu/ops/decision.py, karpenter_tpu/ops/cost.py) and scatters
// with XLA's scatter (karpenter_tpu/ops/fusedtick.py). It replaces the
// port's plain PyTorch chain (ops/fusedtick.py::tick_rows_reference: the
// amax scatter and its gathers, ops/decision.py::decide,
// ops/fusedtick.py::_demand_overlay and ops/cost.py::cost_decide), ~330
// kernels a tick at the fleet's 10,000 x 3, each of which reads and writes
// a whole [N, M] or [N, K, M] tensor in device memory.
//
// What bounds it on this card: latency. Every output of a fleet row depends
// only on that row's M metric cells, its K policy slots and the forecast
// outputs the scatter routes to its cells: ~330 bytes a row, ~3.3 MB a tick
// at N = 10,000 (about 1 us at 3.35 TB/s). The design:
//   * two launches and one memset a tick, and nothing between them: the
//     wrapper sets an int32 [2, N, M] winners grid to -1
//     (cudaMemsetAsync), `tick_scatter_kernel` takes, one thread a series,
//     the atomicMax of each gated series' index into its cell of the blend
//     grid and of the dist grid (the largest gated index wins, whatever the
//     order of the atomics), and `tick_rows_kernel` runs the rest, one
//     thread a fleet row, with every intermediate in registers;
//   * M and K are runtime sizes; the loops over them run in registers, the
//     8-candidate ladder and its risks in fully unrolled arrays;
//   * blocks of kThreads threads (79 blocks at N = 10,000), no shared
//     memory: a warp's stride-M loads touch the same few cache lines;
//   * no allocation and no synchronisation, on the caller's stream, so a
//     captured CUDA graph holds the row stages as three nodes;
//   * stages present or absent by their operands: no cost operands, no
//     cost outputs; no winners grid (no forecast), the decision's own
//     forecast_value / forecast_valid blend where they are given;
//   * bitwise the PyTorch program on the card and the numpy mirror: every
//     float32 operation rounds once (__fadd_rn, __fsub_rn, __fmul_rn, IEEE
//     __fdiv_rn, __fsqrt_rn, also for the division by 100), each `fma` of
//     the port is an exact float64 product, a float64 add and one rounding
//     to float32; max and min propagate a NaN as torch.maximum /
//     torch.minimum do on the card, clamp by scalars passes a NaN through,
//     clip is max then min; the cost argmin keeps the first index on ties
//     and a NaN wins, as torch.argmin; f32 -> i32 saturates to [-2**31,
//     2**31 - 128] before the cast. Built with --fmad=false and without
//     --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCandidates = 8;
// ops/decision.py's codes
constexpr int kTypeValue = 0;
constexpr int kTypeAverageValue = 1;
constexpr int kTypeUtilization = 2;
constexpr int kPolicyMax = 0;
constexpr int kPolicyMin = 1;
constexpr int kPolicyDisabled = 2;
constexpr int kPolicyTypePercent = 1;
constexpr float kCeilGuard = 1e-5f;
// ops/cost.py's floor of a denominator
constexpr float kEps = 1e-6f;
constexpr float kF32Max = 3.40282346638528859812e+38f;
// the saturating cast's bounds: 2**31 - 128 is the largest f32 below 2**31
constexpr float kI32SafeMin = -2147483648.0f;
constexpr float kI32SafeMax = 2147483520.0f;

// Every operand and output of `tick_rows_kernel`, in the order of
// ops/fusedtick.py's SLOTS (the wrapper hands an array of as many
// pointers). Null marks an absent stage: the forecast's (point, sigma2,
// winners, dist_*), the cost's (ha_min .. prior_valid, cost_desired ..
// slo_raised) or the decision's own blend (forecast_value,
// forecast_valid).
struct Slots {
  // DecisionInputs
  const float* metric_value;     // [N, M]
  const float* target_value;     // [N, M]
  const int32_t* target_type;    // [N, M]
  const uint8_t* metric_valid;   // [N, M]
  const int32_t* spec_replicas;  // [N]
  const int32_t* status_replicas;
  const int32_t* min_replicas;
  const int32_t* max_replicas;
  const int32_t* up_window;
  const int32_t* down_window;
  const int32_t* up_policy;
  const int32_t* down_policy;
  const float* last_scale_time;
  const uint8_t* has_last_scale;
  const float* now;  // 0-d
  const int32_t* up_ptype;  // [N, K]
  const int32_t* up_pvalue;
  const int32_t* up_pperiod;
  const uint8_t* up_pvalid;
  const int32_t* down_ptype;
  const int32_t* down_pvalue;
  const int32_t* down_pperiod;
  const uint8_t* down_pvalid;
  const float* forecast_value;    // [N, M]
  const uint8_t* forecast_valid;  // [N, M]
  // the forecast's outputs and the scatter's winners grid
  const float* point;      // [S]
  const float* sigma2;     // [S]
  const int32_t* winners;  // [2, N, M]: blend, then dist
  // the cost group
  const int32_t* ha_min;  // [N]
  const int32_t* ha_max;
  const float* unit_cost;
  const float* slo_weight;
  const float* max_hourly_cost;
  const uint8_t* slo_valid;
  const float* slo_target;  // [N, M]
  const float* observed;
  const uint8_t* demand_base_valid;
  const float* prior_point;
  const float* prior_sigma2;
  const uint8_t* prior_valid;
  // DecisionOutputs, [N]
  int32_t* desired;
  int32_t* recommendation;
  int32_t* limited;
  uint8_t* able_to_scale;
  uint8_t* scaling_unbounded;
  float* able_at;
  uint8_t* rate_limited;
  int32_t* up_ceiling;
  int32_t* down_floor;
  // CostOutputs, [N]
  int32_t* cost_desired;
  float* expected_hourly;
  float* violation_risk;
  int32_t* headroom;
  uint8_t* cost_limited;
  uint8_t* slo_raised;
  // the dist grids the pool-group seam reads, [N, M]
  float* dist_point;
  float* dist_sigma2;
  uint8_t* dist_ok;
};
constexpr int kSlots = sizeof(Slots) / sizeof(void*);
static_assert(sizeof(Slots) == kSlots * sizeof(void*), "Slots are pointers");

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
// false for a NaN and for either infinity
__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) <= kF32Max;
}

// torch.maximum / torch.minimum on the card: the first NaN operand, else
// fmaxf / fminf
__device__ __forceinline__ float tmax(float a, float b) {
  return is_nan(a) ? a : is_nan(b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return is_nan(a) ? a : is_nan(b) ? b : fminf(a, b);
}
// jnp.clip: maximum then minimum (hi wins when lo > hi)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}
// torch.clamp / clamp_min by scalars on the card: a NaN passes through
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return is_nan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return is_nan(x) ? x : fmaxf(x, lo);
}
// amax / amin's combine on the card: the running value while it is a NaN
// or beyond the next, else the next
__device__ __forceinline__ float amax(float acc, float x) {
  return (is_nan(acc) || acc > x) ? acc : x;
}
__device__ __forceinline__ float amin(float acc, float x) {
  return (is_nan(acc) || acc < x) ? acc : x;
}
// f32(a*b + c) with the product exact in float64 and one float64 add: the
// port's `fma`
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}
__device__ __forceinline__ float ceil_guarded(float x) {
  return ceilf(__fsub_rn(x, kCeilGuard));
}
// the saturating f32 -> i32 cast; a NaN casts to 0, as on the card
__device__ __forceinline__ int32_t to_i32(float x) {
  return is_nan(x) ? 0 : __float2int_rz(fminf(fmaxf(x, kI32SafeMin),
                                               kI32SafeMax));
}

// One metric's desired replicas (decision.py::_recommendations)
__device__ __forceinline__ float recommendation(float value, float target,
                                                int kind, float status) {
  const float ratio = target != 0.f ? __fdiv_rn(value, target) : 0.f;
  const float proportional = __fmul_rn(status, ratio);
  if (kind == kTypeValue) return tmax(1.f, ceil_guarded(proportional));
  if (kind == kTypeAverageValue) return ceil_guarded(ratio);
  if (kind == kTypeUtilization)
    return tmax(1.f, ceil_guarded(__fmul_rn(proportional, 100.f)));
  return status;  // an unknown target type keeps the current replicas
}

// One direction's (allowed step, when the binding budget frees)
// (decision.py::_allowed) over its K policy slots
__device__ __forceinline__ void allowed(
    const int32_t* ptype, const int32_t* pvalue, const int32_t* pperiod,
    const uint8_t* pvalid, int K, float spec, float elapsed, bool has_last,
    int select, float& step, float& frees) {
  const float base = clamp_min(spec, 1.f);
  float a_max = -INFINITY, a_min = INFINITY;
  float p_max = -INFINITY, p_min = INFINITY;
  bool any = false;
  for (int k = 0; k < K; ++k) {
    const float value = (float)pvalue[k];
    const float budget =
        ptype[k] == kPolicyTypePercent
            ? ceil_guarded(__fdiv_rn(__fmul_rn(base, value), 100.f))
            : value;
    const float period = (float)pperiod[k];
    const float per_policy = has_last && elapsed < period ? 0.f : budget;
    const bool valid = pvalid[k] != 0;
    a_max = amax(a_max, valid ? per_policy : -kF32Max);
    a_min = amin(a_min, valid ? per_policy : kF32Max);
    p_max = amax(p_max, valid ? period : -kF32Max);
    p_min = amin(p_min, valid ? period : kF32Max);
    any |= valid;
  }
  step = !any || !has_last ? kF32Max : select == kPolicyMin ? a_min : a_max;
  frees = select == kPolicyMin ? p_max : p_min;
}

__global__ void __launch_bounds__(kThreads)
    tick_scatter_kernel(const int32_t* __restrict__ n_valid,
                        const int32_t* __restrict__ need,
                        const uint8_t* __restrict__ blend,
                        const int32_t* __restrict__ row,
                        const int32_t* __restrict__ col, int S, int N, int M,
                        int32_t* __restrict__ winners) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S || n_valid[s] < need[s]) return;
  // pad series carry the trash row N: every cell past the grid is dropped
  const long long cells = (long long)N * M;
  const long long cell = (long long)row[s] * M + col[s];
  if (cell < 0 || cell >= cells) return;
  atomicMax(winners + cells + cell, s);
  if (blend[s]) atomicMax(winners + cell, s);
}

__global__ void __launch_bounds__(kThreads)
    tick_rows_kernel(const Slots p, int N, int M, int K) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const size_t row = (size_t)n * M;
  const bool forecast = p.winners != nullptr;
  const bool own_blend = !forecast && p.forecast_value != nullptr;
  const int32_t* blend_win = p.winners;
  const int32_t* dist_win = p.winners + (size_t)N * M;
  const float spec = (float)p.spec_replicas[n];
  const float status = (float)p.status_replicas[n];

  // recommendations, the blend, and the select policy's reductions
  bool any_valid = false, any_up = false, any_down = false;
  float rec_max = -INFINITY, rec_min = INFINITY;
  for (int m = 0; m < M; ++m) {
    const size_t i = row + m;
    const float target = p.target_value[i];
    const int kind = p.target_type[i];
    const bool valid = p.metric_valid[i] != 0;
    float rec = recommendation(p.metric_value[i], target, kind, status);
    float fvalue = 0.f;
    bool fvalid = false;
    if (forecast) {
      const int32_t w = blend_win[i];
      fvalid = w >= 0;
      fvalue = fvalid ? p.point[w] : 0.f;
      const int32_t d = dist_win[i];
      p.dist_point[i] = d >= 0 ? p.point[d] : 0.f;
      p.dist_sigma2[i] = d >= 0 ? p.sigma2[d] : 0.f;
      p.dist_ok[i] = d >= 0;
    } else if (own_blend) {
      fvalue = p.forecast_value[i];
      fvalid = p.forecast_valid[i] != 0;
    }
    // the proactive blend can only raise a recommendation
    if (fvalid && valid)
      rec = tmax(rec, recommendation(fvalue, target, kind, status));
    any_valid |= valid;
    any_up |= valid && rec > spec;
    any_down |= valid && rec < spec;
    rec_max = amax(rec_max, valid ? rec : -kF32Max);
    rec_min = amin(rec_min, valid ? rec : kF32Max);
  }
  const int up_policy = p.up_policy[n];
  const int down_policy = p.down_policy[n];
  const int policy =
      any_up ? up_policy : any_down ? down_policy : kPolicyDisabled;
  float selected = policy == kPolicyMax   ? rec_max
                   : policy == kPolicyMin ? rec_min
                                          : spec;
  if (!any_valid) selected = spec;

  // stabilization window
  const bool going_up = selected > spec;
  const bool going_down = selected < spec;
  const int up_window = p.up_window[n];
  const int down_window = p.down_window[n];
  const float window =
      (float)(going_up ? up_window : going_down ? down_window : 0);
  const float last = p.last_scale_time[n];
  const bool has_last = p.has_last_scale[n] != 0;
  const float elapsed = __fsub_rn(*p.now, last);
  const bool within = (going_up || going_down) && has_last && elapsed < window;
  const float window_end = __fadd_rn(last, window);
  float limited = within ? spec : selected;

  // scaling policies: the per-direction allowed-delta clamp
  const size_t slot = (size_t)n * K;
  float allowed_up, up_frees, allowed_down, down_frees;
  allowed(p.up_ptype + slot, p.up_pvalue + slot, p.up_pperiod + slot,
          p.up_pvalid + slot, K, spec, elapsed, has_last, up_policy,
          allowed_up, up_frees);
  allowed(p.down_ptype + slot, p.down_pvalue + slot, p.down_pperiod + slot,
          p.down_pvalid + slot, K, spec, elapsed, has_last, down_policy,
          allowed_down, down_frees);
  const float rate_clamped = clip(limited, __fsub_rn(spec, allowed_down),
                                  __fadd_rn(spec, allowed_up));
  const bool rate_limited = rate_clamped != limited;
  const bool fully_held = rate_limited && rate_clamped == spec;
  const float rate_end =
      __fadd_rn(last, limited > spec ? up_frees : down_frees);
  limited = rate_clamped;

  // [min, max] clamp, and the movement bounds
  const float bounded =
      clip(limited, (float)p.min_replicas[n], (float)p.max_replicas[n]);
  const bool up_hold = has_last && elapsed < (float)up_window;
  const bool down_hold = has_last && elapsed < (float)down_window;
  const int32_t desired = to_i32(bounded);
  const int32_t up_ceiling =
      to_i32(up_hold ? spec : __fadd_rn(spec, allowed_up));
  const int32_t down_floor =
      to_i32(down_hold ? spec : __fsub_rn(spec, allowed_down));
  p.desired[n] = desired;
  p.recommendation[n] = to_i32(selected);
  p.limited[n] = to_i32(limited);
  p.able_to_scale[n] = !within && !fully_held;
  p.scaling_unbounded[n] = bounded == limited;
  p.able_at[n] = fully_held ? rate_end : window_end;
  p.rate_limited[n] = rate_limited;
  p.up_ceiling[n] = up_ceiling;
  p.down_floor[n] = down_floor;
  if (p.slo_valid == nullptr) return;

  // the decide -> cost seam: movement-clamped bounds
  const bool slo = p.slo_valid[n] != 0;
  const int32_t ha_min = p.ha_min[n];
  const int32_t ha_max = p.ha_max[n];
  const float base = (float)desired;
  const float min_f = (float)(slo ? max(ha_min, min(down_floor, ha_max)) : 0);
  const float max_f = (float)(slo ? min(ha_max, max(up_ceiling, ha_min)) : 0);
  // the ladder: base + 0..7 clipped to [min, hi], hi the affordable ceiling
  const float unit = p.unit_cost[n];
  const float budget = p.max_hourly_cost[n];
  const bool cap_on = slo && unit > 0.f && budget > 0.f;
  const float cap = floorf(__fdiv_rn(budget, unit > 0.f ? unit : 1.f));
  const float hi = cap_on ? tmin(max_f, tmax(cap, min_f)) : max_f;
  float cand[kCandidates], risk[kCandidates];
#pragma unroll
  for (int k = 0; k < kCandidates; ++k) {
    cand[k] = clip(__fadd_rn(base, (float)k), min_f, hi);
    risk[k] = -INFINITY;
  }
  float need = -INFINITY;
  for (int m = 0; m < M; ++m) {
    const size_t i = row + m;
    // the seam's demand: the fresh distribution overlaid on the prior
    float prior_point = p.prior_point[i];
    float prior_sigma2 = p.prior_sigma2[i];
    bool have = p.prior_valid[i] != 0;
    if (forecast && dist_win[i] >= 0) {
      prior_point = p.point[dist_win[i]];
      prior_sigma2 = p.sigma2[dist_win[i]];
      have = true;
    }
    const bool valid = p.demand_base_valid[i] != 0;
    const float observed = p.observed[i];
    const float mu = !valid ? 0.f
                     : have && is_finite(prior_point)
                         ? tmax(observed, prior_point)
                         : observed;
    const float sigma =
        valid && have && is_finite(prior_sigma2) && prior_sigma2 > 0.f
            ? __fsqrt_rn(prior_sigma2)
            : 0.f;
    const float demand_hi = __fadd_rn(mu, sigma);
    const float denom = clamp_min(demand_hi, kEps);
    const float target = p.slo_target[i];
#pragma unroll
    for (int k = 0; k < kCandidates; ++k) {
      // demand_hi - cand * slo_target, one rounding
      const float shortfall = fma64(-cand[k], target, demand_hi);
      risk[k] = amax(risk[k], valid ? clamp(__fdiv_rn(shortfall, denom),
                                            0.f, 1.f)
                                    : 0.f);
    }
    need = amax(need, valid ? ceilf(__fdiv_rn(demand_hi,
                                              clamp_min(target, kEps)))
                            : 0.f);
  }
  // the first minimum of the score (a NaN wins, as torch.argmin)
  const float weight = p.slo_weight[n];
  float best = fma64(weight, risk[0], __fmul_rn(cand[0], unit));
  float chosen = cand[0], chosen_risk = risk[0];
#pragma unroll
  for (int k = 1; k < kCandidates; ++k) {
    const float score = fma64(weight, risk[k], __fmul_rn(cand[k], unit));
    if (is_nan(score) ? !is_nan(best) : score < best) {
      best = score;
      chosen = cand[k];
      chosen_risk = risk[k];
    }
  }
  const float headroom = clamp_min(__fsub_rn(need, chosen), 0.f);
  const float final_desired = slo ? chosen : base;
  p.cost_desired[n] = to_i32(final_desired);
  p.expected_hourly[n] = __fmul_rn(final_desired, unit);
  p.violation_risk[n] = slo ? chosen_risk : 0.f;
  p.headroom[n] = to_i32(slo ? headroom : 0.f);
  p.cost_limited[n] = cap_on && base > hi;
  p.slo_raised[n] = slo && chosen > base;
}

}  // namespace

extern "C" {

const char* tick_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sets the int32 [2, N, M] `winners` grid to -1 and launches
// tick_scatter_kernel over S series on `stream` (nothing when S is 0):
// each series whose n_valid reaches its need takes the atomicMax of its
// index into its cell of the dist grid (winners[1]), and, where its blend
// gate is set, of the blend grid (winners[0]). Returns the cudaError_t.
int tick_scatter_launch(const void* n_valid, const void* need,
                        const void* blend, const void* row, const void* col,
                        int S, int N, int M, void* winners, void* stream)
{
  if (S < 0 || N < 0 || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = 2 * (size_t)N * M * sizeof(int32_t);
  cudaError_t err = cudaMemsetAsync(winners, 0xff, bytes, s);
  if (err != cudaSuccess || S == 0) return (int)err;
  tick_scatter_kernel<<<(S + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int32_t*>(n_valid), static_cast<const int32_t*>(need),
      static_cast<const uint8_t*>(blend), static_cast<const int32_t*>(row),
      static_cast<const int32_t*>(col), S, N, M,
      static_cast<int32_t*>(winners));
  return (int)cudaGetLastError();
}

// Launches tick_rows_kernel over N fleet rows of M metrics and K policy
// slots on `stream` (nothing when N is 0). `slots` holds `n_slots` ==
// kSlots pointers in Slots' order; a stage's pointers are all set or all
// null. Returns the cudaError_t.
int tick_rows_launch(const void* slots, int n_slots, int N, int M, int K,
                     void* stream)
{
  if (n_slots != kSlots || N < 0 || M < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  Slots p;
  memcpy(&p, slots, sizeof(Slots));
  const bool forecast = p.winners != nullptr;
  if ((p.point != nullptr) != forecast || (p.sigma2 != nullptr) != forecast ||
      (p.dist_point != nullptr) != forecast ||
      (p.dist_sigma2 != nullptr) != forecast ||
      (p.dist_ok != nullptr) != forecast ||
      (p.forecast_value == nullptr) != (p.forecast_valid == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool cost = p.slo_valid != nullptr;
  const void* cost_ptrs[] = {
      p.ha_min, p.ha_max, p.unit_cost, p.slo_weight, p.max_hourly_cost,
      p.slo_target, p.observed, p.demand_base_valid, p.prior_point,
      p.prior_sigma2, p.prior_valid, p.cost_desired, p.expected_hourly,
      p.violation_risk, p.headroom, p.cost_limited, p.slo_raised};
  for (const void* q : cost_ptrs)
    if ((q != nullptr) != cost) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  tick_rows_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(p, N, M, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
