// Exact scatter-add of N randomly indexed float32 updates into a dense weight
// vector (or a [D, C] weight matrix), for Hopper.
//
// Replaces the TPU kernel benchmarks/sparse_scatter_experiment.py::pallas_serial
// (body `kernel`), the Pallas form of the sparse learners' scatter
// (omldm_tpu/ops/sparse.py sparse_scatter_add and sparse_scatter_add_outer).
// It computes
//   out[idx[b,k], c] = w[idx[b,k], c] + sum over (b,k) of u,  u = coef[b,c] * val[b,k]
// with u rounded to float32 before it is added, as the JAX package rounds it.
// C = 1 is the scalar entry (w[D], coef[B]); C > 1 the outer product of a
// multiclass gradient (W[D, C], coef[B, C]).
//   - An update whose index lies outside [0, D) is dropped: the XLA scatter
//     drops out-of-bounds updates, and the kernel must not write past `out`.
//   - An update equal to zero is skipped (pad slots: idx 0, val 0; rows the
//     mask zeroed). That changes nothing but the sign of a zero weight.
//   - Every update is applied; pallas_serial dropped the tail N mod 1024.
//
// What bounds it on an H100: the bytes -- idx, val and coef read once, w read
// and written once: (2N + B*C + 2*D*C) * 4 bytes, 3.4 MB at the experiment's
// N = 4096 x 39 into D = 13 + 2^18, about a microsecond at 3.35 TB/s. The
// operations (N*C products and adds) are far below the float32 peak.
//
// Design: the simple, correct form. The TPU kernel kept w resident in VMEM
// and applied the updates in one serial loop, one 128-lane one-hot row each;
// no Hopper block has the shared memory for w, and blocks run in no order.
// Here the wrapper's stream first copies w into out (cudaMemcpyAsync), then
// one thread per update issues one atomicAdd per class on out. The 1 MB
// vector at 2^18 sits in the 50 MB L2, so the atomics resolve there. With
// atomics the float32 sum order changes from run to run. Addresses many
// updates share (the bias slot w[D-1] gets one update per record) serialize
// in L2; pre-combining equal indices is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// CT > 0: the class count is a compile-time constant; CT == 0: it is `c_rt`.
template <int CT>
__global__ void scatter_add_kernel(float* __restrict__ out,
                                   const int32_t* __restrict__ idx,
                                   const float* __restrict__ coef,
                                   const float* __restrict__ val,
                                   int64_t n, int k, int c_rt, int64_t d) {
  const int c = CT > 0 ? CT : c_rt;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n; t += stride) {
    const int32_t i = idx[t];
    if (i < 0 || (int64_t)i >= d) continue;
    const float v = val[t];
    const float* crow = coef + (t / k) * c;
    float* orow = out + (int64_t)i * c;
#pragma unroll
    for (int j = 0; j < c; ++j) {
      const float u = __fmul_rn(crow[j], v);
      if (u != 0.0f) atomicAdd(orow + j, u);
    }
  }
}

template <int CT>
cudaError_t launch(float* out, const int32_t* idx, const float* coef, const float* val,
                   int64_t n, int k, int c, int64_t d, cudaStream_t stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535 * 8) blocks = 65535 * 8;  // the grid-stride loop covers the rest
  scatter_add_kernel<CT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      out, idx, coef, val, n, k, c, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[D, C] = w[D, C] + the scattered updates, on `stream`. idx[B, K] int32,
// val[B, K] and coef[B, C] float32, all contiguous device arrays; C = 1 is the
// scalar entry. Returns a CUDA error code (0 on success) from the copy or the
// launch. Launches nothing when B * K == 0 (out is then a copy of w).
int omldm_scatter_add(const float* w, const int32_t* idx, const float* coef,
                      const float* val, float* out, int64_t b, int k, int c,
                      int64_t d, void* stream) {
  if (b < 0 || k < 0 || c < 1 || d < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(out, w, (size_t)(d * c) * sizeof(float),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = b * k;
  if (n == 0) return 0;
  switch (c) {
    case 1: err = launch<1>(out, idx, coef, val, n, k, c, d, s); break;
    case 2: err = launch<2>(out, idx, coef, val, n, k, c, d, s); break;
    default: err = launch<0>(out, idx, coef, val, n, k, c, d, s); break;
  }
  return (int)err;
}

}  // extern "C"
