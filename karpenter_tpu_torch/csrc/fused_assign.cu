// Fused assignment stage of the pending-pods bin-pack, for Hopper (sm_90a).
//
// Replaces karpenter_tpu/ops/pallas_binpack.py::_kernel (launched by
// fused_assign). Per pod row: resource fit against every node group,
// taint and required-label violations, the forbidden mask and validity;
// the assignment (lowest feasible index, or with a score operand the
// lowest index among the max-score feasible groups); the dominant share of
// the assigned group quantized up into B buckets (exclusive rows take
// bucket B); and the weighted [T, B] histogram, the [T, R] demand and the
// weighted count of valid rows that no group takes (unschedulable).
//
// What bounds it on this card: at the main-path shape (P = 100000,
// T = 300, R = 3, K = L = 64) the kernel reads ~3.3 MB of row data once
// (~1 us at 3.35 TB/s) and examines ~2 groups per row on average: neither
// bytes nor operations come close to the card's limits, so the latency of
// each block's chain (scan, then the per-group sums) and the launches
// bound it. The design:
//   * a block owns a fixed chunk of kRowsPerBlock consecutive rows, so the
//     order of every float sum depends on the inputs alone, never on the
//     SM count or on scheduling;
//   * scan: one thread per row walks the groups in index order and,
//     without a score, stops at the first feasible one. K and L arrive
//     bit-packed in 64-bit words, so a violation is (pod & group) != 0 on
//     some word. The per-row arrays are sized by the template (MaxR
//     resources, MaxW words) and every loop over them is unrolled with a
//     runtime guard, so they live in registers: no stack frame;
//   * the scan's time is its slowest warp (up to ~100 groups on the main
//     path's data, though the mean is ~2), so each step must be short:
//     the narrow instance (R <= 3, K and L in one word each: the main
//     path) tests a group with two 16-byte shared-memory loads of a
//     32-byte record and six compares, and runs two blocks per SM;
//   * the generic instance reads the group side (alloc, taint and ~label
//     words) from global memory through the read-only path (L1- and
//     L2-resident). Nothing in shared memory grows with T * B, so any T
//     runs;
//   * per block, sort then reduce: the rows are sorted by the key
//     group * B + bucket (cub::BlockRadixSort, stable, unassigned rows
//     last), and one segmented inclusive scan (cub::BlockScan, a fixed
//     tree) gives each run of equal keys its weight sum and each run of
//     equal groups its f64 demand. One int32 global atomicAdd per key run
//     builds hist (integer atomics are exact and order-free); each group
//     run writes its demand into the block's slab of partial[n_blocks, T,
//     R] (zero elsewhere);
//   * demand takes no float atomics (lp_bound = ceil(demand/alloc - 1e-5)
//     is pinned exactly): a second launch reduces each (t, r) over the
//     blocks with one warp and a fixed shuffle tree, rounds once to f32,
//     and also reduces the per-block unschedulable counts.
// Built without --use_fast_math (approximate division would move bucket
// boundaries) and with --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 2;  // rows per thread
constexpr int kRowsPerBlock = kThreads * kItems;
constexpr int kMaxResources = 8;
constexpr int kMaxWords = 8;  // K, L <= 512
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
// stand-in for inf on a zero-allocatable resource the pod requests, as in
// the Pallas kernel (there member_f * inf would be NaN)
constexpr float kBig = 3.4e38f;

// One sorted row in the segmented scan: its weight, summed over runs of
// equal keys, and its f64 demand, summed over runs of equal groups.
template <int MaxR>
struct RunSums {
  int32_t key_head;    // the row starts a run of equal keys
  int32_t group_head;  // the row starts a run of equal groups
  int32_t w;
  double d[MaxR];
};

template <int MaxR>
struct SegmentedSum {
  __device__ __forceinline__ RunSums<MaxR> operator()(
      const RunSums<MaxR>& a, const RunSums<MaxR>& b) const {
    RunSums<MaxR> out;
    out.key_head = a.key_head | b.key_head;
    out.group_head = a.group_head | b.group_head;
    out.w = b.key_head ? b.w : a.w + b.w;
#pragma unroll
    for (int r = 0; r < MaxR; ++r)
      out.d[r] = b.group_head ? b.d[r] : __dadd_rn(a.d[r], b.d[r]);
    return out;
  }
};

// One (row, group) test of the generic instance, on the group side in
// global memory: resource fit, nonempty, no taint the row does not
// tolerate, no required label the group lacks.
template <int MaxR, int MaxW>
__device__ __forceinline__ bool scan_fits(
    const float (&q)[MaxR], const uint64_t (&iw)[MaxW],
    const uint64_t (&rw)[MaxW], const float* __restrict__ alloc,
    const uint64_t* __restrict__ taint_w,
    const uint64_t* __restrict__ nolabel_w, int t, int R, int KW, int LW) {
  bool fit = true, nonempty = false;
#pragma unroll
  for (int r = 0; r < MaxR; ++r) {
    if (r < R) {
      const float a = __ldg(alloc + t * R + r);
      fit &= q[r] <= a;
      nonempty |= a > 0.0f;
    }
  }
  fit &= nonempty;
#pragma unroll
  for (int w = 0; w < MaxW; ++w) {
    if (w < KW)
      fit &= (iw[w] & __ldg(reinterpret_cast<const unsigned long long*>(
                           taint_w) + t * KW + w)) == 0;
    if (w < LW)
      fit &= (rw[w] & __ldg(reinterpret_cast<const unsigned long long*>(
                           nolabel_w) + t * LW + w)) == 0;
  }
  return fit;
}

// The narrow instance's group record in shared memory: one 16-byte load of
// alloc (a[3] is 0 for a group with some allocatable, -1 for an empty one,
// against a request of 0, so the nonempty rule is one more compare) and
// one of the taint and ~label words.
struct __align__(16) GroupRecord {
  float4 a;
  ulonglong2 words;
};
static_assert(sizeof(GroupRecord) == 32, "ops/fused_assign.py plans 32 B");

// kTable: the narrow instance (R <= 3, K and L in one word each), which
// scans GroupRecords in shared memory; otherwise the group side is read
// from global memory, for up to MaxR resources and MaxW words.
template <int MaxR, int MaxW, bool kTable>
__global__ void __launch_bounds__(kThreads, kTable ? 2 : 1) assign_kernel(
    const float* __restrict__ req,             // [P, R]
    const uint8_t* __restrict__ valid,         // [P]
    const uint64_t* __restrict__ intol_w,      // [P, KW]
    const uint64_t* __restrict__ required_w,   // [P, LW]
    const int32_t* __restrict__ weight,        // [P] or null (all 1)
    const float* __restrict__ alloc,           // [T, R]
    const uint64_t* __restrict__ taint_w,      // [T, KW]
    const uint64_t* __restrict__ nolabel_w,    // [T, LW] words of ~labels
    const uint8_t* __restrict__ forbidden,     // [P, T] or null
    const float* __restrict__ score,           // [P, T] or null
    const uint8_t* __restrict__ exclusive,     // [P] or null
    int P, int T, int R, int KW, int LW, int B, int key_bits,
    int32_t* __restrict__ assigned,            // [P]
    int32_t* __restrict__ hist,                // [T, B], zeroed
    double* __restrict__ partial,              // [n_blocks, T, R]
    int32_t* __restrict__ unsched_partial)     // [n_blocks]
{
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, kItems, int32_t>;
  using Scan = cub::BlockScan<RunSums<MaxR>, kThreads>;
  __shared__ union {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  } tmp;
  __shared__ uint32_t s_keys[kRowsPerBlock];
  __shared__ int32_t s_unsched;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int base = blockIdx.x * kRowsPerBlock;
  GroupRecord* s_rec = reinterpret_cast<GroupRecord*>(smem_raw);
  if constexpr (kTable) {
    for (int t = tid; t < T; t += kThreads) {
      float a[3] = {0.0f, 0.0f, 0.0f};
      bool nonempty = false;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if (r < R) {
          a[r] = alloc[t * R + r];
          nonempty |= a[r] > 0.0f;
        }
      }
      GroupRecord rec;
      rec.a = make_float4(a[0], a[1], a[2], nonempty ? 0.0f : -1.0f);
      rec.words = make_ulonglong2(taint_w[t], nolabel_w[t]);
      s_rec[t] = rec;
    }
  }
  if (tid == 0) s_unsched = 0;
  // the block's demand slab is zero except for the groups its rows reach,
  // which are written after the barriers below
  double* slab = partial + (size_t)blockIdx.x * T * R;
  for (int i = tid; i < T * R; i += kThreads) slab[i] = 0.0;
  __syncthreads();

  const uint32_t sentinel = (uint32_t)T * (uint32_t)B;
  uint32_t keys[kItems];
  int32_t rows[kItems];
  int32_t unsched = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = tid * kItems + j;
    const int p = base + i;
    rows[j] = i;
    keys[j] = sentinel;
    if (p >= P) continue;
    float q[MaxR];
#pragma unroll
    for (int r = 0; r < MaxR; ++r) q[r] = r < R ? req[(size_t)p * R + r] : 0.0f;
    int choice = -1;
    const bool ok = valid[p] != 0;
    if (ok) {
      uint64_t iw[MaxW], rw[MaxW];
#pragma unroll
      for (int w = 0; w < MaxW; ++w) {
        iw[w] = w < KW ? intol_w[(size_t)p * KW + w] : 0ull;
        rw[w] = w < LW ? required_w[(size_t)p * LW + w] : 0ull;
      }
      float best = 0.0f;
      for (int t = 0; t < T; ++t) {
        bool fit;
        if constexpr (kTable) {
          const GroupRecord rec = s_rec[t];
          fit = (q[0] <= rec.a.x) & (q[1] <= rec.a.y) & (q[2] <= rec.a.z) &
                (0.0f <= rec.a.w) & ((iw[0] & rec.words.x) == 0) &
                ((rw[0] & rec.words.y) == 0);
        } else {
          fit = scan_fits<MaxR, MaxW>(q, iw, rw, alloc, taint_w, nolabel_w,
                                      t, R, KW, LW);
        }
        if (fit && forbidden != nullptr) fit = !forbidden[(size_t)p * T + t];
        if (!fit) continue;
        if (score == nullptr) {
          choice = t;
          break;
        }
        // strictly greater: the lowest index keeps a tie
        const float s = score[(size_t)p * T + t];
        if (choice < 0 || s > best) {
          best = s;
          choice = t;
        }
      }
    }
    assigned[p] = choice;
    if (choice < 0) {
      if (ok) unsched += weight == nullptr ? 1 : weight[p];
      continue;
    }
    float share = 0.0f;
#pragma unroll
    for (int r = 0; r < MaxR; ++r) {
      if (r < R) {
        const float a = alloc[choice * R + r];
        float s = a > 0.0f ? q[r] / fmaxf(a, 1e-30f) : kBig;
        if (a <= 0.0f && q[r] <= 0.0f) s = 0.0f;
        share = fmaxf(share, s);
      }
    }
    // clamp in float before the cast, as the reference's clip of ceil
    float bf = ceilf(share * (float)B);
    bf = fminf(fmaxf(bf, 1.0f), (float)B);
    int bucket = (int)bf;
    if (exclusive != nullptr && exclusive[p]) bucket = B;
    keys[j] = (uint32_t)choice * (uint32_t)B + (uint32_t)(bucket - 1);
  }
  if (unsched != 0) atomicAdd(&s_unsched, unsched);

  // stable sort of the block's rows by key; thread tid then holds sorted
  // positions tid * kItems + j (a blocked arrangement)
  Sort(tmp.sort).Sort(keys, rows, 0, key_bits);
#pragma unroll
  for (int j = 0; j < kItems; ++j) s_keys[tid * kItems + j] = keys[j];
  __syncthreads();
  if (tid == 0) unsched_partial[blockIdx.x] = s_unsched;

  RunSums<MaxR> items[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int pos = tid * kItems + j;
    const uint32_t key = keys[j];
    const bool first = pos == 0;
    items[j].key_head = first || s_keys[pos - 1] != key;
    items[j].group_head = first || s_keys[pos - 1] / B != key / B;
    int32_t w = 0;
    if (key < sentinel) {
      const int p = base + rows[j];
      w = weight == nullptr ? 1 : weight[p];
    }
    items[j].w = w;
#pragma unroll
    for (int r = 0; r < MaxR; ++r) {
      double d = 0.0;
      if (key < sentinel && r < R) {
        const int p = base + rows[j];
        // an i32 weight below 2^24 times an f32 request is exact in f64
        d = __dmul_rn((double)w, (double)req[(size_t)p * R + r]);
      }
      items[j].d[r] = d;
    }
  }
  Scan(tmp.scan).InclusiveScan(items, items, SegmentedSum<MaxR>());

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int pos = tid * kItems + j;
    const uint32_t key = keys[j];
    if (key >= sentinel) continue;
    const bool last = pos + 1 == kRowsPerBlock;
    if (items[j].w != 0 && (last || s_keys[pos + 1] != key))
      atomicAdd(&hist[key], items[j].w);
    if (last || s_keys[pos + 1] / B != key / B) {
      const int g = key / B;
#pragma unroll
      for (int r = 0; r < MaxR; ++r)
        if (r < R) slab[g * R + r] = items[j].d[r];
    }
  }
}

__global__ void demand_reduce_kernel(
    const double* __restrict__ partial,          // [n_blocks, n]
    const int32_t* __restrict__ unsched_partial, // [n_blocks]
    int n_blocks, int n,
    float* __restrict__ demand,                  // [n]
    int32_t* __restrict__ unsched)               // [1]
{
  const int lane = threadIdx.x & 31;
  const int out = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (out > n) return;  // warp-uniform
  if (out < n) {
    double acc = 0.0;
    for (int b = lane; b < n_blocks; b += 32)
      acc = __dadd_rn(acc, partial[(size_t)b * n + out]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = __dadd_rn(acc, __shfl_down_sync(kFull, acc, o));
    if (lane == 0) demand[out] = __double2float_rn(acc);
  } else {
    int32_t acc = 0;
    for (int b = lane; b < n_blocks; b += 32) acc += unsched_partial[b];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o);
    if (lane == 0) unsched[0] = acc;
  }
}

// the largest dynamic shared memory set so far per kernel instance and
// device: the attribute is set once per size, not on every launch
int g_smem_narrow[kMaxDevices];
int g_smem_wide[kMaxDevices];

template <int MaxR, int MaxW, bool kTable>
cudaError_t launch_assign(
    int* smem_set, int n_blocks, int smem, cudaStream_t s,
    const void* req, const void* valid, const void* intol_w,
    const void* required_w, const void* weight, const void* alloc,
    const void* taint_w, const void* nolabel_w, const void* forbidden,
    const void* score, const void* exclusive,
    int P, int T, int R, int KW, int LW, int B, int key_bits,
    void* assigned, void* hist, void* partial, void* unsched_partial)
{
  if (R > MaxR || KW > MaxW || LW > MaxW) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto kernel = assign_kernel<MaxR, MaxW, kTable>;
  if (dev >= kMaxDevices || smem_set[dev] < smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) smem_set[dev] = smem;
  }
  kernel<<<n_blocks, kThreads, smem, s>>>(
      static_cast<const float*>(req), static_cast<const uint8_t*>(valid),
      static_cast<const uint64_t*>(intol_w),
      static_cast<const uint64_t*>(required_w),
      static_cast<const int32_t*>(weight), static_cast<const float*>(alloc),
      static_cast<const uint64_t*>(taint_w),
      static_cast<const uint64_t*>(nolabel_w),
      static_cast<const uint8_t*>(forbidden),
      static_cast<const float*>(score),
      static_cast<const uint8_t*>(exclusive),
      P, T, R, KW, LW, B, key_bits,
      static_cast<int32_t*>(assigned), static_cast<int32_t*>(hist),
      static_cast<double*>(partial), static_cast<int32_t*>(unsched_partial));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_assign_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the assignment kernel and the demand reduction on `stream`,
// with the launch plan of ops/fused_assign.py::fused_assign_plan
// (n_blocks, narrow, shared_bytes, key_bits). Zeroes hist itself. partial
// holds n_blocks * T * R doubles, unsched_partial n_blocks ints. Returns the cudaError_t (0 on success).
int fused_assign_launch(
    const void* req, const void* valid, const void* intol_w,
    const void* required_w, const void* weight, const void* alloc,
    const void* taint_w, const void* nolabel_w, const void* forbidden,
    const void* score, const void* exclusive,
    int P, int T, int R, int KW, int LW, int B,
    int n_blocks, int narrow, int shared_bytes, int key_bits,
    void* assigned, void* hist, void* partial, void* unsched_partial,
    void* demand, void* unsched, void* stream)
{
  if (n_blocks != (P + kRowsPerBlock - 1) / kRowsPerBlock || key_bits < 1 ||
      key_bits > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if ((size_t)T * B > 0)
    err = cudaMemsetAsync(hist, 0, sizeof(int32_t) * (size_t)T * B, s);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks > 0) {
    err = narrow
        ? launch_assign<3, 1, true>(
              g_smem_narrow, n_blocks, shared_bytes, s, req, valid, intol_w,
              required_w, weight, alloc, taint_w, nolabel_w, forbidden,
              score, exclusive, P, T, R, KW, LW, B, key_bits, assigned,
              hist, partial, unsched_partial)
        : launch_assign<kMaxResources, kMaxWords, false>(
              g_smem_wide, n_blocks, shared_bytes, s, req, valid, intol_w,
              required_w, weight, alloc, taint_w, nolabel_w, forbidden,
              score, exclusive, P, T, R, KW, LW, B, key_bits, assigned,
              hist, partial, unsched_partial);
    if (err != cudaSuccess) return (int)err;
  }
  const int n = T * R;
  const int warps = n + 1;  // one per (t, r), one for unschedulable
  demand_reduce_kernel<<<(warps * 32 + 255) / 256, 256, 0, s>>>(
      static_cast<const double*>(partial),
      static_cast<const int32_t*>(unsched_partial), n_blocks, n,
      static_cast<float*>(demand), static_cast<int32_t*>(unsched));
  return (int)cudaGetLastError();
}

}  // extern "C"
