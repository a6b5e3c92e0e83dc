// Shelf best-fit-decreasing node count per group, for Hopper (sm_90a).
//
// Replaces the XLA tail karpenter_tpu/ops/binpack.py::_shelf_bfd (a
// lax.scan of B sizes, each a lax.while_loop of up to B fill passes over
// [T, B+1] state), which in eager PyTorch would be ~B^2 small launches per
// solve. Sizes k = B..1; items of size k fill existing bins best-fit
// (smallest sufficient remnant first, one item per bin per pass, passes
// repeated while anything is placed), then open new bins of floor(B/k)
// items each, registering the remnants. It also emits each group's item
// count (the row sum of the histogram), which the solve reports as
// assigned_count.
//
// What bounds it on this card: the data is tiny (T * B int32 in, 2 T int32
// out: ~40 KB at T = 300, B = 32) and the work is a chain of dependent
// fill passes per group, so latency through that chain bounds it, not
// bytes or throughput. The design shortens the chain and spreads it:
//   * one warp per group, several warps per block, so T = 300 groups run
//     on 75 SMs rather than 5;
//   * a fill pass is the plain version's vectorised pass
//     (ops/binpack.py::_shelf_bfd): an exclusive prefix sum of the usable
//     bin counts over the remnants, place = min(max(c - before, 0), avail),
//     the placed bins moved down k remnants. For B <= 32 lane j holds the
//     count of open bins with remnant j + 1 in one register, the prefix
//     sum is five __shfl_up_sync and the move one __shfl_down_sync; for
//     B > 32 each lane owns a contiguous run of remnants in shared memory;
//   * remnant-0 bins are never read again (sizes are >= 1), so they are
//     not kept;
//   * a size with no items is skipped, and the passes of a size stop as
//     soon as c = 0 or a pass finds no usable bin: both are warp-uniform
//     and exact (a bin still usable at pass j + 1 took an item in each of
//     passes 1..j, so no pass past floor(B/k) places anything);
//   * the histogram row is read once, coalesced, before the size loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
// the largest dynamic shared memory one block may take on Hopper
constexpr size_t kMaxSharedBytes = 232448;

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int32_t warp_inclusive_scan(int32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// B <= 32: lane j holds the count of open bins with remnant j + 1.
__global__ void __launch_bounds__(kWarpsPerBlock * 32) shelf_bfd_warp_kernel(
    const int32_t* __restrict__ hist,  // [T, B]
    int T, int B,
    int32_t* __restrict__ nodes_out,   // [T]
    int32_t* __restrict__ count_out)   // [T]
{
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;  // warp-uniform
  const int32_t row = lane < B ? hist[(size_t)t * B + lane] : 0;
  const int32_t count = warp_sum(row);
  int32_t bins = 0;
  int32_t nodes = 0;
  for (int k = B; k >= 1; --k) {
    int32_t c = __shfl_sync(kFull, row, k - 1);
    if (c == 0) continue;
    const bool usable = lane + 1 >= k;
    for (;;) {
      const int32_t avail = usable ? bins : 0;
      const int32_t incl = warp_inclusive_scan(avail, lane);
      const int32_t total = __shfl_sync(kFull, incl, 31);
      if (total == 0) break;
      const int32_t place = min(max(c - (incl - avail), 0), avail);
      // a bin of remnant j + 1 + k that took an item now has remnant j + 1
      const int32_t moved = __shfl_down_sync(kFull, place, k);
      bins += (lane + k < 32 ? moved : 0) - place;
      c -= min(c, total);
      if (c == 0) break;
    }
    if (c > 0) {
      const int per_bin = B / k;
      const int32_t full = c / per_bin;
      const int32_t leftover = c - full * per_bin;
      nodes += full + (leftover > 0 ? 1 : 0);
      if (lane + 1 == B - per_bin * k) bins += full;
      if (leftover > 0 && lane + 1 == B - leftover * k) bins += 1;
    }
  }
  if (lane == 0) {
    nodes_out[t] = nodes;
    count_out[t] = count;
  }
}

// Any B: per warp, row[B], bins[B] (bins[s] = open bins of remnant s + 1)
// and place[B] in shared memory; lane j owns slots [j S, j S + S), S =
// ceil(B / 32), so a lane's slots are contiguous in remnant order.
__global__ void shelf_bfd_wide_kernel(
    const int32_t* __restrict__ hist, int T, int B, int warps_per_block,
    int32_t* __restrict__ nodes_out, int32_t* __restrict__ count_out)
{
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * warps_per_block + warp;
  if (t >= T) return;  // warp-uniform
  int32_t* row = smem + (size_t)warp * 3 * B;
  int32_t* bins = row + B;
  int32_t* place = bins + B;
  const int per_lane = (B + 31) / 32;
  const int lo = min(lane * per_lane, B);
  const int hi = min(lo + per_lane, B);
  int32_t count = 0;
  for (int s = lane; s < B; s += 32) {
    const int32_t v = hist[(size_t)t * B + s];
    row[s] = v;
    bins[s] = 0;
    count += v;
  }
  count = warp_sum(count);
  __syncwarp();
  int32_t nodes = 0;
  for (int k = B; k >= 1; --k) {
    int32_t c = row[k - 1];
    if (c == 0) continue;
    for (;;) {
      int32_t mine = 0;
      for (int s = max(lo, k - 1); s < hi; ++s) mine += bins[s];
      const int32_t incl = warp_inclusive_scan(mine, lane);
      const int32_t total = __shfl_sync(kFull, incl, 31);
      if (total == 0) break;
      int32_t before = incl - mine;
      for (int s = lo; s < hi; ++s) {
        const int32_t avail = s + 1 >= k ? bins[s] : 0;
        place[s] = min(max(c - before, 0), avail);
        before += avail;
      }
      __syncwarp();
      for (int s = lo; s < hi; ++s)
        bins[s] += (s + k < B ? place[s + k] : 0) - place[s];
      __syncwarp();
      c -= min(c, total);
      if (c == 0) break;
    }
    if (c > 0) {
      const int per_bin = B / k;
      const int32_t full = c / per_bin;
      const int32_t leftover = c - full * per_bin;
      nodes += full + (leftover > 0 ? 1 : 0);
      if (lane == 0) {
        const int full_rem = B - per_bin * k;
        if (full_rem >= 1) bins[full_rem - 1] += full;
        if (leftover > 0) bins[B - leftover * k - 1] += 1;
      }
      __syncwarp();
    }
  }
  if (lane == 0) {
    nodes_out[t] = nodes;
    count_out[t] = count;
  }
}

// the largest dynamic shared memory set so far for the wide kernel, per
// device: the attribute is set once per size, not on every launch
int g_wide_smem[kMaxDevices];

}  // namespace

extern "C" {

const char* shelf_bfd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the shelf kernel on `stream`: nodes[t] and count[t] for each
// group. B > 32 needs 12 B bytes of shared memory per warp, so at most
// kMaxSharedBytes / 12 buckets. Returns the cudaError_t (0 on success).
int shelf_bfd_launch(const void* hist, int T, int B, void* nodes, void* count,
                     void* stream)
{
  if (T <= 0) return 0;
  if (B < 1) return (int)cudaErrorInvalidValue;
  const size_t fit = kMaxSharedBytes / (12 * (size_t)B);
  const int warps_per_block =
      fit < (size_t)kWarpsPerBlock ? (int)fit : kWarpsPerBlock;
  if (B > 32 && warps_per_block < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 32) {
    const int n_blocks = (T + kWarpsPerBlock - 1) / kWarpsPerBlock;
    shelf_bfd_warp_kernel<<<n_blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const int32_t*>(hist), T, B,
        static_cast<int32_t*>(nodes), static_cast<int32_t*>(count));
    return (int)cudaGetLastError();
  }
  const int smem = 12 * B * warps_per_block;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || g_wide_smem[dev] < smem) {
    err = cudaFuncSetAttribute(shelf_bfd_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) g_wide_smem[dev] = smem;
  }
  const int n_blocks = (T + warps_per_block - 1) / warps_per_block;
  shelf_bfd_wide_kernel<<<n_blocks, warps_per_block * 32, smem, s>>>(
      static_cast<const int32_t*>(hist), T, B, warps_per_block,
      static_cast<int32_t*>(nodes), static_cast<int32_t*>(count));
  return (int)cudaGetLastError();
}

}  // extern "C"
