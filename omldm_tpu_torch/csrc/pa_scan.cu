// Exact per-record Passive-Aggressive scan over one micro-batch, for Hopper.
//
// Replaces the TPU kernel omldm_tpu/ops/pa_scan.py::_pa_kernel (wrapper
// pa_scan_update). For each row i in order:
//   margin = w . x_i,  hinge = max(0, 1 - y_i * margin),  y_i = +1 if y > 0 else -1
//   sq = max(||x_i||^2, 1e-12),  tau by variant (PA / PA-I / PA-II)
//   w += tau * y_i * m_i * x_i
// and the masked mean hinge sum(hinge * m) / max(sum(m), 1).
//
// What bounds it on an H100: the bytes are tiny, about
// (B*D + 2B + 2D) * 4 -- 31 KB at B=256, D=29, nanoseconds at 3.35 TB/s, so the
// roofline calls it bytes-bound. In fact it is bound by the chain of B
// dependent block-wide reductions: row i+1's margin needs row i's update.
//
// Design: one CTA per call, threads striding over the D columns.
//   - w lives in shared memory for the whole sweep. Each thread owns the
//     columns j = tid, tid + nt, ..., and only it reads or writes them, so the
//     update needs no barrier.
//   - Rows are staged into shared memory in tiles by a flat, unrolled copy
//     (a tile is one contiguous run of x): many independent loads go out at
//     once instead of one global-memory latency per row on the chain. When D
//     is too wide for even one staged row beside w, rows are read straight
//     from memory.
//   - Per row, the partial w.x and x.x are reduced with warp shuffles, then
//     across warps through a double-buffered shared array: one barrier a row.
//     Every thread sums the warp partials in the same order, so every thread
//     derives the same tau without a second barrier to broadcast it.
//   - Thread 0 accumulates the masked hinge and the mask sum; the mean loss
//     goes to a one-element output the caller reads lazily.
// Faster designs (precomputing every ||x_i||^2 in parallel, one warp per call
// at small D, many pipelines per launch) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;
// the H100's per-block shared memory limit (opt-in above 48 KB)
constexpr int kSmemLimit = 232448;
constexpr int kRedBytes = 2 * kMaxWarps * (int)sizeof(float2);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void pa_scan_kernel(const float* __restrict__ w0,
                               const float* __restrict__ x,
                               const float* __restrict__ y,
                               const float* __restrict__ mask,
                               float* __restrict__ w_out,
                               float* __restrict__ loss_out,
                               int B, int D, int tile_rows, int variant,
                               float C, float inv2c) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* red = reinterpret_cast<float2*>(smem);                   // [2][32]
  float* ws = reinterpret_cast<float*>(smem + kRedBytes);          // [D]
  float* xs = ws + D;                                              // [tile_rows][D]
  float* ys = xs + (size_t)tile_rows * D;                          // [tile_rows]
  float* ms = ys + tile_rows;                                      // [tile_rows]

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nt + 31) >> 5;

  for (int j = tid; j < D; j += nt) ws[j] = w0[j];

  float acc = 0.f;   // sum(hinge * m), thread 0 only
  float msum = 0.f;  // sum(m), thread 0 only
  const int step = tile_rows > 0 ? tile_rows : 1;

  for (int t0 = 0; t0 < B; t0 += step) {
    const int rows = min(step, B - t0);
    if (tile_rows > 0) {
      __syncthreads();  // nobody still reads the previous tile
      // the tile's rows are one contiguous run of x: a flat copy, unrolled
      // so that many independent loads are in flight per thread
      const float* src = x + (size_t)t0 * D;
      const int n = rows * D;
#pragma unroll 8
      for (int e = tid; e < n; e += nt) xs[e] = src[e];
      for (int r = tid; r < rows; r += nt) {
        ys[r] = y[t0 + r];
        ms[r] = mask[t0 + r];
      }
      __syncthreads();
    }
    for (int r = 0; r < rows; ++r) {
      const int i = t0 + r;
      const float* xr = tile_rows > 0 ? xs + (size_t)r * D : x + (size_t)i * D;
      float dot = 0.f, sq = 0.f;
      for (int j = tid; j < D; j += nt) {
        const float v = xr[j];
        dot += ws[j] * v;
        sq += v * v;
      }
      dot = warp_sum(dot);
      sq = warp_sum(sq);
      if (nwarps > 1) {
        float2* buf = red + (i & 1) * kMaxWarps;
        if (lane == 0) buf[warp] = make_float2(dot, sq);
        __syncthreads();
        dot = 0.f;
        sq = 0.f;
        for (int k = 0; k < nwarps; ++k) {
          const float2 p = buf[k];
          dot += p.x;
          sq += p.y;
        }
      }
      const float yv = tile_rows > 0 ? ys[r] : y[i];
      const float m = tile_rows > 0 ? ms[r] : mask[i];
      const float ysg = yv > 0.f ? 1.f : -1.f;
      const float hinge = fmaxf(0.f, 1.f - ysg * dot);
      const float sqc = fmaxf(sq, 1e-12f);
      float tau;
      if (variant == 0) {
        tau = hinge / sqc;
      } else if (variant == 1) {
        tau = fminf(C, hinge / sqc);
      } else {
        tau = hinge / (sqc + inv2c);
      }
      const float coef = tau * ysg * m;
      for (int j = tid; j < D; j += nt) ws[j] += coef * xr[j];
      if (tid == 0) {
        acc += hinge * m;
        msum += m;
      }
    }
  }
  for (int j = tid; j < D; j += nt) w_out[j] = ws[j];
  if (tid == 0) loss_out[0] = acc / fmaxf(msum, 1.f);
}

}  // namespace

extern "C" {

// Largest D (the weight length, bias column included) the kernel takes.
int omldm_pa_scan_max_dim() { return (kSmemLimit - kRedBytes) / (int)sizeof(float); }

// Launches the scan on `stream`; returns cudaGetLastError() of the launch
// (0 on success). Pointers are device pointers to contiguous float32 arrays:
// w0[D], x[B, D], y[B], mask[B], w_out[D], loss_out[1].
int omldm_pa_scan(const float* w0, const float* x, const float* y,
                  const float* mask, float* w_out, float* loss_out, int B,
                  int D, int variant, float C, float inv2c, void* stream) {
  if (D < 1 || B < 0 || D > omldm_pa_scan_max_dim()) return (int)cudaErrorInvalidValue;
  int nt = ((D + 31) / 32) * 32;
  if (nt > 256) nt = 256;
  const size_t fixed = kRedBytes + (size_t)D * sizeof(float);
  const size_t per_row = (size_t)D * sizeof(float) + 2 * sizeof(float);
  size_t tile = (kSmemLimit - fixed) / per_row;
  if (tile > (size_t)B) tile = (size_t)B;
  const size_t smem = fixed + tile * per_row;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        pa_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    opted_in = kSmemLimit;
  }
  pa_scan_kernel<<<1, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      w0, x, y, mask, w_out, loss_out, B, D, (int)tile, variant, C, inv2c);
  return (int)cudaGetLastError();
}

}  // extern "C"
