// Exact scatter-add of N randomly indexed float32 updates into a dense weight
// vector (or a [D, C] weight matrix), for Hopper.
//
// Replaces the TPU kernel benchmarks/sparse_scatter_experiment.py::pallas_serial
// (body `kernel`), the Pallas form of the sparse learners' scatter
// (omldm_tpu/ops/sparse.py sparse_scatter_add and sparse_scatter_add_outer).
// It computes
//   w[idx[b,k], c] += sum over (b,k) of u,  u = coef[b,c] * val[b,k]
// with u rounded to float32 before it is added, as the JAX package rounds it.
// C = 1 is the scalar entry (w[D], coef[B]); C > 1 the outer product of a
// multiclass gradient (W[D, C], coef[B, C]).
//   - An update whose index lies outside [0, D) is dropped: the XLA scatter
//     drops out-of-bounds updates, and the kernel must not write past `w`.
//   - An update equal to zero is skipped (pad slots: idx 0, val 0; rows the
//     mask zeroed). That changes nothing but the sign of a zero weight.
//   - Every update is applied; pallas_serial dropped the tail N mod 1024.
//
// In place. The JAX package donates the pipeline state on every fit, so XLA
// updates w in device memory where it lies; the port's pipeline gives the
// learner's state up the same way, and the kernel writes into it. The
// copying entry point (out != w) first copies w into out on the stream.
//
// What bounds it on an H100: the bytes -- idx, val and coef read once, and
// each distinct in-range element of w that an update touches read and
// written once: (2N + B*C + 2*U*C) * 4 bytes for U distinct indices, about
// 0.14 MB at the slice's (256, 41) into 13 + 2^18, 0.04 us at 3.35 TB/s:
// far below one launch. So what sets its time is the launch, the latency of
// one dependent chain (load idx, val and coef; combine; one atomic), and
// atomics that meet at one address and serialise in L2.
//
// Design. The TPU kernel kept w resident in VMEM and applied the updates in
// one serial loop; no Hopper block has the shared memory for w, and blocks
// run in no order, so updates meet in L2 as atomics. To make fewer of them
// meet, threads are mapped slot-major: one warp takes one slot k of 32
// consecutive records, lane l record b0 + l. Slots whose index is the same
// in every record (in the Criteo layout the 13 numerics at 0..12 and the
// bias at D - 1) then land in one warp per 32 records. Within the warp,
// `__match_any_sync` groups lanes of equal index; each group is summed by
// shuffles in a tree over the lanes' ranks in the group (`reduce_peers`:
// five rounds for a whole warp, none for a warp of distinct hashed
// indices), and the group's lowest lane issues one atomicAdd per class. A
// fixed slot thus takes B/32 atomics instead of B. Within a warp the order
// of the sums is fixed; across warps, where the atomics meet, it still
// changes from run to run. idx, val and coef are loaded at once, so one
// memory latency, the match, the tree and one atomic make a task's chain.
//
// Grid: one warp a (32-record tile, slot) task, slot fastest, so the warps
// of one CTA read neighbouring slots of the same records (the strided
// loads share sectors in L1). A CTA is four warps while the tasks number at
// most kSmallTasks, eight above: the slice's (256, 41) makes 328 tasks in
// 82 CTAs, Avazu's (256, 22) 176 in 44, the experiment's (4096, 39) 4,992
// in 624. In tuning runs on an H100, one-warp CTAs, spread over more SMs,
// were slower at the slice's and Avazu's shapes than four-warp ones, and
// at 4,992 tasks eight-warp CTAs beat four-warp ones: a grid this small
// pays for its CTAs' launch, not for the SMs it leaves idle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmallWarps = 4;            // warps a CTA up to kSmallTasks tasks
constexpr int kMaxWarps = 8;              // warps a CTA above
constexpr int64_t kSmallTasks = 8 * 132;
constexpr int64_t kMaxCtas = 132 * 8;     // a grid-stride loop covers the rest

// Sums x over each group of lanes that `peers` names (the lanes of equal
// index) into the group's lowest lane, by a tree over the lanes' ranks in
// their group: in round r, the lane of rank q (q a multiple of 2^r) adds the
// partial sum of rank q + 2^(r-1). The order of the sums is fixed by the
// groups alone, so one warp's result does not change from run to run; a
// group of g lanes takes ceil(log2 g) rounds, a warp of distinct indices
// none. Every lane of the warp must call it.
template <int N>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane, float (&x)[N]) {
  int rank = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;  // the peers above this lane
  while (__any_sync(kFull, peers)) {
    const int next = __ffs(peers);  // the next peer above, 1-based; 0: none
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float t = __shfl_sync(kFull, x[n], next > 0 ? next - 1 : lane);
      if (next) x[n] += t;
    }
    peers &= ~__ballot_sync(kFull, rank & 1);  // odd ranks were taken in
    rank >>= 1;
  }
}

// CT > 0: the class count is a compile-time constant; CT == 0: it is `c_rt`,
// taken one class a pass.
template <int CT>
__global__ void __launch_bounds__(kMaxWarps * 32)
scatter_add_kernel(float* __restrict__ w, const int32_t* __restrict__ idx,
                   const float* __restrict__ coef, const float* __restrict__ val,
                   int64_t b, int k, int c_rt, int64_t d) {
  constexpr int N = CT > 0 ? CT : 1;
  const int c = CT > 0 ? CT : c_rt;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t tasks = (b + 31) / 32 * k;
  for (int64_t task = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); task < tasks;
       task += (int64_t)gridDim.x * warps) {  // warp-uniform: the shuffles below see the whole warp
    const int64_t tile = task / k;
    const int slot = (int)(task - tile * k);
    const int64_t row = tile * 32 + lane;
    const bool real = row < b;
    // idx, val and coef are loaded together: none waits on another
    const int32_t i = real ? idx[row * k + slot] : -1;
    const float v = real ? val[row * k + slot] : 0.0f;
    float u[N];
    bool live = false;  // the index is in range and an update is nonzero
    if (CT > 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        u[n] = real ? __fmul_rn(coef[row * N + n], v) : 0.0f;
        live |= u[n] != 0.0f;
      }
    } else {
      for (int j = 0; j < c; ++j) live |= real && __fmul_rn(coef[row * c + j], v) != 0.0f;
    }
    live = live && i >= 0 && (int64_t)i < d;
    unsigned peers = __match_any_sync(kFull, live ? i : -1);
    if (!live) peers = 1u << lane;  // the lanes left out form no group
    const bool leader = live && __ffs(peers) - 1 == lane;
    for (int j0 = 0; j0 < c; j0 += N) {  // one pass when CT > 0
      if (CT == 0) u[0] = live ? __fmul_rn(coef[row * c + j0], v) : 0.0f;
      unsigned nonzero[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        // C = 1: every live lane's update is nonzero
        nonzero[n] = CT == 1 ? peers : __ballot_sync(kFull, u[n] != 0.0f) & peers;
      }
      reduce_peers(peers, lane, u);
      if (leader) {
#pragma unroll
        for (int n = 0; n < N; ++n)
          if (nonzero[n]) atomicAdd(w + (int64_t)i * c + j0 + n, u[n]);
      }
    }
  }
}

__global__ void empty_kernel() {}

template <int CT>
cudaError_t launch(float* w, const int32_t* idx, const float* coef, const float* val,
                   int64_t b, int k, int c, int64_t d, cudaStream_t stream) {
  const int64_t tasks = (b + 31) / 32 * k;
  const int warps = tasks <= kSmallTasks ? kSmallWarps : kMaxWarps;
  int64_t blocks = (tasks + warps - 1) / warps;
  if (blocks > kMaxCtas) blocks = kMaxCtas;
  scatter_add_kernel<CT><<<(unsigned)blocks, warps * 32, 0, stream>>>(
      w, idx, coef, val, b, k, c, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[D, C] = w[D, C] + the scattered updates, on `stream`. idx[B, K] int32,
// val[B, K] and coef[B, C] float32, all contiguous device arrays; C = 1 is the
// scalar entry. out == w updates w in place; any other out is first made a
// copy of w. Returns a CUDA error code (0 on success) from the copy or the
// launch. Launches nothing when B * K == 0.
int omldm_scatter_add(const float* w, const int32_t* idx, const float* coef,
                      const float* val, float* out, int64_t b, int k, int c,
                      int64_t d, void* stream) {
  if (b < 0 || k < 0 || c < 1 || d < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (out != w) {
    err = cudaMemcpyAsync(out, w, (size_t)(d * c) * sizeof(float),
                          cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (b * k == 0) return 0;
  switch (c) {
    case 1: err = launch<1>(out, idx, coef, val, b, k, c, d, s); break;
    case 2: err = launch<2>(out, idx, coef, val, b, k, c, d, s); break;
    default: err = launch<0>(out, idx, coef, val, b, k, c, d, s); break;
  }
  return (int)err;
}

// One launch of a kernel that does nothing, on `stream`: the floor under
// any one launch, for measurement beside the scatter's bound.
int omldm_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
