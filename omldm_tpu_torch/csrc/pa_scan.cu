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
// dependent rows: row i's margin needs every earlier row's update.
//
// Design: the Gram form. With c_k = tau_k y_k m_k, the weights before row i
// are w0 + sum_{k<i} c_k x_k, so
//   margin_i = x_i . w0 + sum_{k<i} c_k G[k, i],   G = X X^T,
// and only the scalar c_k is on the chain. Three launches on the stream:
//   1. pa_gram_kernel, the parallel prologue: one CTA per 32 x 32 tile of
//      the upper triangle of G (tiles k <= i), f32 FMAs on the CUDA cores
//      (no TF32: the products must round as the per-row dots do). Every
//      warp sums the whole tile over a share of the columns, a lane an 8 x 4
//      block of it (three 16-byte shared loads a column for 32 FMAs); the 8
//      warps' sums are added in shared memory. Column chunks of the two row
//      tiles go through registers (the next chunk's loads are in flight
//      while one is summed) into a 2-slot ring, stored column by column.
//      Diagonal tiles also give base_i = x_i . w0. G goes to a scratch
//      buffer the wrapper allocates: Bp x Bp floats, Bp = B rounded up to 32.
//   2. pa_chain_kernel, the sequential chain, one CTA. Rows go in blocks of
//      32, one a lane of warp 0. A lane holds its row's margin, its column
//      of the block's diagonal tile of G and 1/sq (PA-II: 1/(sq + 1/2C)),
//      so no reduction and no division is left on the chain. Step r: every
//      lane forms hinge, tau and c from its own margin, lane r's c is
//      broadcast with one __shfl_sync and every lane adds c_r G[r, i]; the
//      same broadcast feeds a second sum over the next block's column of G,
//      so the next block's margins hold this block's terms when its chain
//      ends. No barrier and no memory access on the chain. Meanwhile warps
//      1-7 stage the next block's two tiles of G (16-byte cp.async), y and
//      mask in shared memory and add the block before's terms to the
//      margins of the blocks after the next (a 32-term mat-vec a row): one
//      barrier a block. (Every lane of warp 0 running the block's whole
//      chain on replicated margins needs no shuffle, but puts ~16 FMAs a
//      row on one warp's issue slot; it measured slower.)
//   3. pa_update_kernel, the epilogue: w = w0 + X^T c, a thread a (column,
//      segment of B/8 rows); the 8 segment sums are added in order.
// The prologue costs B^2 D / 2 FMAs spread over B (B + 32) / 2048 CTAs; the
// chain does not depend on D. The margin's rounding order differs from a
// D-wide dot on the current w: base_i, then up to B - 1 Gram terms, each a
// D-term dot; w's from the per-row update's (segment sums).
//
// Members: omldm_pa_scan_batched runs C independent scans (C pipelines of a
// cohort, or C data-parallel workers) in the same three launches. The
// member index is blockIdx.y of every grid: the prologue and epilogue
// grids gain a y extent of C, and the chain is one CTA a member, so C
// chains run side by side on the SMs instead of one after another. Member
// m reads w0[m], x[m], y[m], mask[m] and its own scratch block (m times
// omldm_pa_scan_scratch_floats(B) floats in), and writes w_out[m] and
// loss[m]. A member whose mask is all zero keeps w0 bitwise (the chain
// leaves its mask count in its scratch for the epilogue), as the JAX
// cohort's select keeps an all-masked member's state. The three kernels'
// bodies are shared; the member kernels (pa_*_members_kernel) only offset
// the pointers by blockIdx.y and keep the all-zero member, so
// omldm_pa_scan's kernels hold no member arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 32;                // rows a tile of G, a block of the chain
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;               // columns staged a time in the prologue
constexpr int kLd = kRows + 4;           // floats between two staged columns (16-byte aligned)
constexpr int kAcc = kRows + 1;          // a tile's sums: its 32 x 32 entries, then x_i . w0
constexpr int kSegments = 8;             // row segments of the epilogue
constexpr int kUpdateCols = kThreads / kSegments;
// the prologue's shared memory: the chunk ring (two row tiles a slot),
// which the warps' partial sums reuse once the sweep is done
constexpr int kSlotFloats = 2 * kChunk * kLd + kChunk;  // two row tiles, then w0's chunk
constexpr int kRingFloats = 2 * kSlotFloats;
constexpr int kPartFloats = kWarps * kAcc * kRows;
// the chain's shared memory besides its two floats a row: two blocks' G
// tiles, y and mask
constexpr int kChainFixed = 4 * kRows * kRows + 4 * kRows;
constexpr int kGramSmem = (kRingFloats > kPartFloats ? kRingFloats : kPartFloats) * (int)sizeof(float);
// the H100's per-block shared memory limit (opt-in above 48 KB)
constexpr int kSmemLimit = 232448;
// devices whose opt-in is remembered (any further one opts in every call)
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ int padded_rows(int B) { return (B + kRows - 1) / kRows * kRows; }

// Floats of scratch one member takes: G (Bp x Bp), then base and coef (Bp
// each). A multiple of 64 floats, so every member's block stays 16-byte
// aligned.
__host__ __device__ __forceinline__ size_t member_floats(int Bp) { return (size_t)Bp * Bp + 2 * (size_t)Bp; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// 4 bytes from global to shared memory, or 4 zero bytes where !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes from global to shared memory (both 16-byte aligned), or zeros where !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits for every copy this thread committed.
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Chunk loads of the prologue: thread t holds, for q < kPerThread, the
// element e = q * kThreads + t of the chunk -- row tile e / 2048 (0: kt, 1:
// it), row (e / 64) % 32, column j0 + e % 64 -- so a warp reads 32
// neighbouring columns of one row; threads t < 64 also hold w0[j0 + t].
constexpr int kPerThread = 2 * kRows * kChunk / kThreads;

__device__ __forceinline__ void load_chunk(float (&v)[kPerThread], float& wv, const float* x, const float* w0, int kt,
                                           int it, int j0, int B, int D) {
  const int cols = min(kChunk, D - j0);
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int e = q * kThreads + threadIdx.x;
    const int row = (e / (kRows * kChunk) ? it : kt) * kRows + (e / kChunk) % kRows, c = e % kChunk;
    v[q] = row < B && c < cols ? x[(size_t)row * D + j0 + c] : 0.f;
  }
  wv = w0 != nullptr && (int)threadIdx.x < cols ? w0[j0 + threadIdx.x] : 0.f;
}

// ... and into a ring slot, column by column (slot[(tile * kChunk + c) * kLd
// + r]; rows past B are zeros), then w0's chunk.
__device__ __forceinline__ void store_chunk(float* slot, const float (&v)[kPerThread], float wv) {
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int e = q * kThreads + threadIdx.x;
    slot[(e / (kRows * kChunk) * kChunk + e % kChunk) * kLd + (e / kChunk) % kRows] = v[q];
  }
  if (threadIdx.x < kChunk) slot[2 * kChunk * kLd + threadIdx.x] = wv;
}

// 1. G[k][i] = x_k . x_i for the tile (kt, it), kt <= it, and base_i = x_i . w0
// on the diagonal tiles. G is [Bp][Bp], row k. Each warp sums the whole
// tile over every 8th column of a chunk; lane t owns the 8 x 4 block of rows
// k from 8 (t / 8) and i from 4 (t % 8): three 16-byte loads a column for
// 32 FMAs.
__device__ __forceinline__ void gram_tile(const float* __restrict__ w0, const float* __restrict__ x,
                                          float* __restrict__ G, float* __restrict__ base, int B, int D, int Bp) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = (lane >> 3) * 8, i0 = (lane & 7) * 4;
  int it = 0;  // blockIdx.x = it (it + 1) / 2 + kt
  while ((it + 1) * (it + 2) / 2 <= (int)blockIdx.x) ++it;
  const int kt = blockIdx.x - it * (it + 1) / 2;
  const bool diag = kt == it;
  const float* w0d = diag ? w0 : nullptr;
  const int n_chunks = (D + kChunk - 1) / kChunk;

  float v[kPerThread], wv;  // the next chunk, loaded while this one is summed
  load_chunk(v, wv, x, w0d, kt, it, 0, B, D);
  store_chunk(smem, v, wv);
  __syncthreads();
  float acc[8][4], accw = 0.f;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load_chunk(v, wv, x, w0d, kt, it, (c + 1) * kChunk, B, D);
    const float* sk = smem + (c & 1) * kSlotFloats;
    const float* si = sk + kChunk * kLd;
    const int j0 = c * kChunk, cols = min(kChunk, D - j0);
    for (int cc = warp; cc < cols; cc += kWarps) {
      const float4 ka = *reinterpret_cast<const float4*>(sk + cc * kLd + k0);
      const float4 kb = *reinterpret_cast<const float4*>(sk + cc * kLd + k0 + 4);
      const float4 xi = *reinterpret_cast<const float4*>(si + cc * kLd + i0);
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
      const float iv[4] = {xi.x, xi.y, xi.z, xi.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(kv[a], iv[b], acc[a][b]);
      if (diag) accw = fmaf(sk[2 * kChunk * kLd + cc], si[cc * kLd + lane], accw);
    }
    // the next chunk's slot was last read before the previous barrier
    if (c + 1 < n_chunks) store_chunk(smem + ((c + 1) & 1) * kSlotFloats, v, wv);
    __syncthreads();
  }
  float* part = smem;  // [kWarps][kAcc][kRows], in the ring's place
#pragma unroll
  for (int a = 0; a < 8; ++a)
    *reinterpret_cast<float4*>(part + (warp * kAcc + k0 + a) * kRows + i0) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  part[(warp * kAcc + kRows) * kRows + lane] = accw;
  __syncthreads();
  for (int e = tid; e < kAcc * kRows; e += kThreads) {
    const int k = e / kRows, i = e % kRows;
    if (k == kRows && !diag) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w * kAcc * kRows + e];
    if (k < kRows)
      G[(size_t)(kt * kRows + k) * Bp + it * kRows + i] = s;
    else
      base[it * kRows + i] = s;
  }
}

// One scan: its few tiles want the registers for the column sweep.
__global__ void __launch_bounds__(kThreads) pa_gram_kernel(const float* __restrict__ w0,
                                                           const float* __restrict__ x, float* __restrict__ G,
                                                           float* __restrict__ base, int B, int D, int Bp) {
  gram_tile(w0, x, G, base, B, D, Bp);
}

// Member blockIdx.y of a batch; registers for two CTAs an SM (the members'
// tiles fill the SMs twice over).
__global__ void __launch_bounds__(kThreads, 2) pa_gram_members_kernel(const float* __restrict__ w0,
                                                                      const float* __restrict__ x,
                                                                      float* __restrict__ scratch, int B, int D,
                                                                      int Bp) {
  const size_t member = blockIdx.y;
  float* G = scratch + member * member_floats(Bp);
  gram_tile(w0 + member * D, x + member * B * (size_t)D, G, G + (size_t)Bp * Bp, B, D, Bp);
}

// The tiles of G the chain of block `blk` reads, into shared memory by
// cp.async from the threads `first` .. `first + count - 1`: its diagonal tile
// and the tile of the next block's rows, as gt[tile][k][i] (zeros where
// there is no next block); its rows' y and mask (zeros past B).
__device__ __forceinline__ void stage_block(float* gt, float* ym, const float* G, const float* y, const float* mask,
                                            int blk, int B, int Bp, int first, int count) {
  const int t0 = blk * kRows;
  const bool next = t0 + kRows < Bp;
  for (int e = threadIdx.x - first; e < 2 * kRows * kRows / 4; e += count) {  // 16 bytes each
    const int tile = e / (kRows * kRows / 4), k = (e / (kRows / 4)) % kRows, i = 4 * (e % (kRows / 4));
    const bool valid = tile == 0 || next;
    cp_async16(gt + (tile * kRows + k) * kRows + i, valid ? G + (size_t)(t0 + k) * Bp + t0 + tile * kRows + i : G,
               valid);
  }
  for (int e = threadIdx.x - first; e < 2 * kRows; e += count) {
    const int i = t0 + e % kRows;
    cp_async4(ym + e, i < B ? (e < kRows ? y : mask) + i : y, i < B);
  }
  cp_async_commit();
}

// 2. The chain; writes coef[Bp] (c_k, 0 past B) and the mean hinge; with
// kCount, also the mask count into base[0] (read by the member epilogue;
// base is dead by then).
template <bool kCount>
__device__ __forceinline__ void chain(const float* __restrict__ G, float* __restrict__ base,
                                      const float* __restrict__ y, const float* __restrict__ mask,
                                      float* __restrict__ coef, float* __restrict__ loss_out, int B, int Bp,
                                      int variant, float C, float inv2c) {
  extern __shared__ __align__(16) float smem[];
  float* tiles = smem;                    // [2 blocks][2 tiles][kRows][kRows]
  float* rows = tiles + 4 * kRows * kRows;  // [2 blocks][y, mask][kRows]
  float* msm = rows + 4 * kRows;          // [Bp]: base_i plus the terms of the blocks before the previous one
  float* cs = msm + Bp;                   // [Bp]: c_k
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_blocks = Bp / kRows;
  for (int i = tid; i < Bp; i += kThreads) msm[i] = base[i];
  if (n_blocks > 0) stage_block(tiles, rows, G, y, mask, 0, B, Bp, 0, kThreads);
  cp_async_wait_all();
  __syncthreads();

  const float cap = variant == 1 ? C : __int_as_float(0x7f800000);  // PA-I caps tau at C
  float hsum = 0.f, msum = 0.f;  // warp 0, lane i: sum(hinge * m), sum(m) of rows i mod 32
  float carry = 0.f;             // warp 0: the previous block's terms of this lane's row
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int t0 = blk * kRows;
    if (warp == 0) {
      const float* gd = tiles + (blk & 1) * 2 * kRows * kRows;  // G[t0 + k][t0 + i]
      const float* gx = gd + kRows * kRows;                     // G[t0 + k][t0 + 32 + i]
      float g[kRows], gn[kRows];  // lane i: its row's column of both tiles
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        g[k] = gd[k * kRows + lane];
        gn[k] = gx[k * kRows + lane];
      }
      const float yv = rows[(blk & 1) * 2 * kRows + lane], mv = rows[(blk & 1) * 2 * kRows + kRows + lane];
      const float sq = fmaxf(gd[lane * kRows + lane], 1e-12f);
      const float inv = variant == 2 ? 1.f / (sq + inv2c) : 1.f / sq;
      const float ys = yv > 0.f ? 1.f : -1.f;
      const float ysm = ys * mv;
      float margin = msm[t0 + lane] + carry, next = 0.f;
      float c_own = 0.f, h_own = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hinge = fmaxf(0.f, fmaf(-ys, margin, 1.f));
        const float c = fminf(hinge * inv, cap) * ysm;
        if (lane == r) {
          c_own = c;
          h_own = hinge;
        }
        const float cr = __shfl_sync(kFull, c, r);
        margin = fmaf(cr, g[r], margin);  // rows after r; row r is done
        next = fmaf(cr, gn[r], next);
      }
      carry = next;
      hsum += h_own * mv;
      msum += mv;
      cs[t0 + lane] = c_own;
    } else {
      if (blk + 1 < n_blocks)
        stage_block(tiles + ((blk + 1) & 1) * 2 * kRows * kRows, rows + ((blk + 1) & 1) * 2 * kRows, G, y, mask,
                    blk + 1, B, Bp, 32, kThreads - 32);
      if (blk > 0) {  // the previous block's terms into the rows of the blocks after the next
        const int p0 = t0 - kRows;
        for (int i = t0 + kRows + tid - 32; i < Bp; i += kThreads - 32) {
          float gk[kRows];  // every load in flight at once
#pragma unroll
          for (int k = 0; k < kRows; ++k) gk[k] = G[(size_t)(p0 + k) * Bp + i];
          float m = msm[i];
#pragma unroll
          for (int k = 0; k < kRows; ++k) m = fmaf(cs[p0 + k], gk[k], m);
          msm[i] = m;
        }
      }
      cp_async_wait_all();  // the next block's tiles have landed
    }
    __syncthreads();
  }
  for (int i = tid; i < Bp; i += kThreads) coef[i] = cs[i];
  if (warp == 0) {
    hsum = warp_sum(hsum);
    msum = warp_sum(msum);
    if (lane == 0) {
      loss_out[0] = hsum / fmaxf(msum, 1.f);
      if (kCount && Bp > 0) base[0] = msum;  // every thread read base before the first barrier
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) pa_chain_kernel(const float* __restrict__ G,
                                                               const float* __restrict__ base,
                                                               const float* __restrict__ y,
                                                               const float* __restrict__ mask,
                                                               float* __restrict__ coef, float* __restrict__ loss_out,
                                                               int B, int Bp, int variant, float C, float inv2c) {
  chain<false>(G, const_cast<float*>(base), y, mask, coef, loss_out, B, Bp, variant, C, inv2c);
}

__global__ void __launch_bounds__(kThreads, 1) pa_chain_members_kernel(float* __restrict__ scratch,
                                                                       const float* __restrict__ y,
                                                                       const float* __restrict__ mask,
                                                                       float* __restrict__ loss_out, int B, int Bp,
                                                                       int variant, float C, float inv2c) {
  const size_t member = blockIdx.y;
  float* G = scratch + member * member_floats(Bp);
  float* base = G + (size_t)Bp * Bp;
  chain<true>(G, base, y + member * B, mask + member * B, base + Bp, loss_out + member, B, Bp, variant, C, inv2c);
}

// 3. w = w0 + sum_k c_k x_k: thread (segment s, column j) sums its rows in
// order; the segment sums are added to w0 in order. With kKeep (members),
// a member with no masked-in row (the chain's `count`) keeps w0 as it is.
template <bool kKeep>
__device__ __forceinline__ void update(const float* __restrict__ w0, const float* __restrict__ x,
                                       const float* __restrict__ coef, const float* __restrict__ count,
                                       float* __restrict__ w_out, int B, int D) {
  __shared__ float part[kSegments][kUpdateCols];
  const int col = threadIdx.x % kUpdateCols, seg = threadIdx.x / kUpdateCols;
  const int j = blockIdx.x * kUpdateCols + col;
  const int per = (B + kSegments - 1) / kSegments;
  const int r0 = seg * per, r1 = min(B, r0 + per);
  float s = 0.f;
  if (j < D) {
#pragma unroll 16
    for (int r = r0; r < r1; ++r) s = fmaf(coef[r], x[(size_t)r * D + j], s);
  }
  part[seg][col] = s;
  __syncthreads();
  if (seg == 0 && j < D) {
    float w = w0[j];
    if (!kKeep || (B > 0 && count[0] > 0.f)) {
#pragma unroll
      for (int q = 0; q < kSegments; ++q) w += part[q][col];
    }
    w_out[j] = w;
  }
}

__global__ void __launch_bounds__(kThreads) pa_update_kernel(const float* __restrict__ w0,
                                                             const float* __restrict__ x,
                                                             const float* __restrict__ coef,
                                                             float* __restrict__ w_out, int B, int D) {
  update<false>(w0, x, coef, nullptr, w_out, B, D);
}

__global__ void __launch_bounds__(kThreads) pa_update_members_kernel(const float* __restrict__ w0,
                                                                     const float* __restrict__ x,
                                                                     const float* __restrict__ scratch,
                                                                     float* __restrict__ w_out, int B, int D,
                                                                     int Bp) {
  const size_t member = blockIdx.y;
  const float* base = scratch + member * member_floats(Bp) + (size_t)Bp * Bp;
  update<true>(w0 + member * D, x + member * B * (size_t)D, base + Bp, base, w_out + member * D, B, D);
}

}  // namespace

extern "C" {

// Largest B the chain kernel's shared memory takes (two floats a row).
int omldm_pa_scan_max_rows() { return (kSmemLimit / (int)sizeof(float) - kChainFixed) / 2 / kRows * kRows; }

// Floats of device scratch a call with B rows needs, a member: G (Bp x
// Bp), base and coef (Bp each), Bp = B rounded up to 32.
long long omldm_pa_scan_scratch_floats(int B) { return (long long)member_floats(padded_rows(B)); }

// Launches the scan's three kernels on `stream`; returns cudaGetLastError()
// of the first launch that fails (0 on success). Pointers are device
// pointers to contiguous float32 arrays: w0[D], x[B, D], y[B], mask[B],
// w_out[D], loss_out[1], scratch[omldm_pa_scan_scratch_floats(B)] (16-byte
// aligned).
int omldm_pa_scan(const float* w0, const float* x, const float* y,
                  const float* mask, float* w_out, float* loss_out, float* scratch,
                  int B, int D, int variant, float C, float inv2c, void* stream) {
  if (D < 1 || B < 0 || B > omldm_pa_scan_max_rows()) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bp = padded_rows(B), n_blocks = bp / kRows;
  float* G = scratch;
  float* base = G + (size_t)bp * bp;
  float* coef = base + bp;
  // The chain may take more than 48 KB of dynamic shared memory. The
  // opt-in belongs to each device's context, so it is made once a device
  // (the wrapper makes the tensors' device current), and on every call on
  // a device past the table.
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= kMaxDevices || !opted_in[device]) {
    err = cudaFuncSetAttribute(pa_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < kMaxDevices) opted_in[device] = true;
  }
  if (n_blocks > 0) {
    pa_gram_kernel<<<n_blocks * (n_blocks + 1) / 2, kThreads, kGramSmem, s>>>(w0, x, G, base, B, D, bp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t chain_smem = (size_t)(kChainFixed + 2 * bp) * sizeof(float);
  pa_chain_kernel<<<1, kThreads, chain_smem, s>>>(G, base, y, mask, coef, loss_out, B, bp, variant, C, inv2c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pa_update_kernel<<<(D + kUpdateCols - 1) / kUpdateCols, kThreads, 0, s>>>(w0, x, coef, w_out, B, D);
  return (int)cudaGetLastError();
}

// Launches the member kernels for `members` independent scans on `stream`;
// returns cudaGetLastError() of the first launch that fails (0 on
// success). Pointers are device pointers to contiguous float32 arrays:
// w0[C, D], x[C, B, D], y[C, B], mask[C, B], w_out[C, D], loss_out[C],
// scratch[C * omldm_pa_scan_scratch_floats(B)] (16-byte aligned).
int omldm_pa_scan_batched(const float* w0, const float* x, const float* y,
                          const float* mask, float* w_out, float* loss_out, float* scratch,
                          int members, int B, int D, int variant, float C, float inv2c, void* stream) {
  if (D < 1 || B < 0 || B > omldm_pa_scan_max_rows() || members < 1 || members > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bp = padded_rows(B), n_blocks = bp / kRows;
  // the member chain's own opt-in, as the one-scan chain's
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= kMaxDevices || !opted_in[device]) {
    err = cudaFuncSetAttribute(pa_chain_members_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < kMaxDevices) opted_in[device] = true;
  }
  if (n_blocks > 0) {
    pa_gram_members_kernel<<<dim3(n_blocks * (n_blocks + 1) / 2, members), kThreads, kGramSmem, s>>>(
        w0, x, scratch, B, D, bp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t chain_smem = (size_t)(kChainFixed + 2 * bp) * sizeof(float);
  pa_chain_members_kernel<<<dim3(1, members), kThreads, chain_smem, s>>>(scratch, y, mask, loss_out, B, bp,
                                                                         variant, C, inv2c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pa_update_members_kernel<<<dim3((D + kUpdateCols - 1) / kUpdateCols, members), kThreads, 0, s>>>(
      w0, x, scratch, w_out, B, D, bp);
  return (int)cudaGetLastError();
}

}  // extern "C"
