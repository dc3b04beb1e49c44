// Flash attention for Hopper: forward, dQ and dK/dV, CUDA C++ for sm_90a.
//
// Replaces the three TPU kernels of omldm_tpu/ops/attention.py:
//   flash_fwd_kernel   <- _flash_kernel          (wrapper flash_attention_pallas)
//   flash_dq_kernel    <- _flash_bwd_dq_kernel   (wrapper _flash_diff_bwd)
//   flash_dkdv_kernel  <- _flash_bwd_dkdv_kernel (wrapper _flash_diff_bwd)
// on q [B, Lq, H, Dh], k/v [B, Lk, H, Dh] (Dh = 32, 64 or 128 in bfloat16,
// 32 or 64 in float32), with the causal mask on absolute positions q_offset + row >=
// kv_offset + col, keys past Lk masked, and p = 0 wherever s <= NEG_INF / 2
// (so a row that sees no key has a zero output, an lse near NEG_INF and zero
// gradients).
//
//   forward: S = Q K^T * scale, online softmax over K tiles with f32 running
//            max m, denominator l and accumulator; out = acc / max(l, 1e-30),
//            lse = m + log(max(l, 1e-30)).
//   dQ:      P = exp(S - lse), dP = dO V^T, dS = P (dP - delta),
//            dQ = dS K * scale.
//   dK/dV:   dV = P^T dO, dK = dS^T Q * scale.
// delta = rowsum(dO * O) comes from the caller (plain torch), as the JAX
// package computes it outside its kernels.
//
// What bounds them on an H100: per (b, h) head the forward does 4 Lq Lk Dh
// flops (about half under the causal mask) on 4 L Dh * 2 bytes of q, k, v
// and out, so its intensity is ~L/4 flops a byte, causal: the roofline
// (989 TFLOP/s bf16 dense, 3.35 TB/s, balance ~295) calls it about balanced
// at L = 1024 and operation-bound from L = 2048 on; the backward passes do
// 1.5x and 2x the forward's products on a little more data. These first
// versions use warp-level mma.sync tensor-core products (m16n8k16, bf16 in,
// f32 accumulate) with plain synchronous tile copies; wgmma, TMA and warp
// specialisation are later work.
//
// Design:
//   - The TPU's sequential K grid axis becomes a loop inside the block. One
//     CTA of 4 warps per (b*h, 64-row Q tile) in the forward and dQ passes,
//     sweeping 64-key tiles; one CTA per (b*h, 64-key tile) in the dK/dV
//     pass, sweeping 32-row Q tiles. Each warp owns 16 rows of the CTA's
//     tile; the accumulators live in registers in the mma C-fragment layout.
//   - The tiles a CTA reads sit in shared memory (rows padded by 8 elements,
//     so fragment loads hit 32 distinct banks). S and dS never leave
//     registers: an mma C fragment of two adjacent 8-column tiles is exactly
//     the A fragment of the next product (P V, dS K, P^T dO, dS^T Q).
//   - Whole tiles above the causal diagonal are never visited (the JAX
//     package's _causal_block_needed); the TPU's lane-replicated m/l scratch
//     and DMA-eliding index maps have no counterpart here.
//   - Inputs are taken by strides ([B, L, H, Dh] with unit stride on Dh and
//     16-byte aligned rows), so q, k and v can be views into the packed qkv
//     projection without a copy. Outputs are contiguous [B, L, H, Dh]; lse
//     and delta are contiguous f32 [B*H, Lq].
//   - Rounding points follow the JAX kernels: scores, softmax statistics and
//     every accumulator are f32; P is rounded to the operand type before the
//     P V and P^T dO products, dS before the dS K and dS^T Q products.
//   - float32 runs the same code with an exact f32 emulation of the
//     m16n8k16 product (warp shuffles and FMAs), so the tensor-core path and
//     the f32 path share every index and mask. It is there for parity
//     checks at small sizes, not for speed.
// Ragged Lq and Lk are handled by bounds checks: rows past the end load as
// zeros, are masked, and are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;      // 4 warps, 16 tile rows each
constexpr int kBlockQ = 64;        // forward / dQ: query rows per CTA
constexpr int kBlockK = 64;        // forward / dQ: keys per tile; dK/dV: keys per CTA
constexpr int kBlockQB = 32;       // dK/dV: query rows per tile of the sweep
constexpr int kPad = 8;            // shared-memory row padding, in elements

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;
  void* dq;
  void* dk;
  void* dv;
  float* lse;
  const float* delta;
  long long q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, do_sb, do_sl, do_sh;
  int H, Lq, Lk, causal, q_offset, kv_offset;
  float scale;
};

// ---- mma.sync m16n8k16 fragments -------------------------------------------
// Lane l holds, with g = l / 4 and t = l % 4:
//   A (16x16): a0,a1 = (g, 2t..2t+1)  a2,a3 = (g+8, 2t..)  a4,a5 = (g, 2t+8..)  a6,a7 = (g+8, 2t+8..)
//   B (16x8):  b0,b1 = (k 2t..2t+1, n g)  b2,b3 = (k 2t+8.., n g)
//   C (16x8):  c0,c1 = (g, 2t..2t+1)  c2,c3 = (g+8, 2t..2t+1)

template <typename T> struct FragA;
template <> struct FragA<bf16> { uint32_t x[4]; };
template <> struct FragA<float> { float x[8]; };
template <typename T> struct FragB;
template <> struct FragB<bf16> { uint32_t x[2]; };
template <> struct FragB<float> { float x[4]; };

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A from a row-major shared tile (the K dimension contiguous), rows row0..row0+15.
__device__ __forceinline__ void load_a(FragA<bf16>& a, const bf16* s, int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p0 = s + (row0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  const bf16* p1 = p0 + 8 * ld;
  a.x[0] = ld32(p0);
  a.x[1] = ld32(p1);
  a.x[2] = ld32(p0 + 8);
  a.x[3] = ld32(p1 + 8);
}

__device__ __forceinline__ void load_a(FragA<float>& a, const float* s, int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  const float* p0 = s + (row0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  const float* p1 = p0 + 8 * ld;
  a.x[0] = p0[0]; a.x[1] = p0[1]; a.x[2] = p1[0]; a.x[3] = p1[1];
  a.x[4] = p0[8]; a.x[5] = p0[9]; a.x[6] = p1[8]; a.x[7] = p1[9];
}

// B from a shared tile stored [n][k] (k contiguous): B = tile^T.
__device__ __forceinline__ void load_b_nk(FragB<bf16>& b, const bf16* s, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b.x[0] = ld32(p);
  b.x[1] = ld32(p + 8);
}

__device__ __forceinline__ void load_b_nk(FragB<float>& b, const float* s, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const float* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b.x[0] = p[0]; b.x[1] = p[1]; b.x[2] = p[8]; b.x[3] = p[9];
}

// B from a shared tile stored [k][n] (n contiguous).
__device__ __forceinline__ void load_b_kn(FragB<bf16>& b, const bf16* s, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b.x[0] = pack(p[0], p[ld]);
  b.x[1] = pack(p[8 * ld], p[9 * ld]);
}

__device__ __forceinline__ void load_b_kn(FragB<float>& b, const float* s, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const float* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b.x[0] = p[0]; b.x[1] = p[ld]; b.x[2] = p[8 * ld]; b.x[3] = p[9 * ld];
}

// A from two adjacent C fragments (columns 0-7 and 8-15), rounded to the
// operand type: the rounding point of P and dS before their products.
__device__ __forceinline__ void a_from_acc(FragA<bf16>& a, const float (&c0)[4], const float (&c1)[4]) {
  a.x[0] = pack(c0[0], c0[1]);
  a.x[1] = pack(c0[2], c0[3]);
  a.x[2] = pack(c1[0], c1[1]);
  a.x[3] = pack(c1[2], c1[3]);
}

__device__ __forceinline__ void a_from_acc(FragA<float>& a, const float (&c0)[4], const float (&c1)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a.x[i] = c0[i];
    a.x[4 + i] = c1[i];
  }
}

// c += a . b on the tensor cores (bf16 in, f32 accumulate).
__device__ __forceinline__ void mma(float (&c)[4], const FragA<bf16>& a, const FragB<bf16>& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]), "r"(b.x[1]));
}

// The same product in f32 on the CUDA cores: each operand element is fetched
// from the lane that holds it in the fragment layout above.
__device__ __forceinline__ void mma(float (&c)[4], const FragA<float>& a, const FragB<float>& b) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int ia = (kk >> 3) * 4 + (kk & 1);  // a_i of row g at column kk
    const int ib = (kk >> 3) * 2 + (kk & 1);  // b_i at row kk
    const int sub = (kk & 7) >> 1;            // the quad lane holding column / row kk
    const float ag = __shfl_sync(kFull, a.x[ia], (lane & ~3) | sub);
    const float ag8 = __shfl_sync(kFull, a.x[ia + 2], (lane & ~3) | sub);
    const float b0 = __shfl_sync(kFull, b.x[ib], (2 * t) * 4 + sub);
    const float b1 = __shfl_sync(kFull, b.x[ib], (2 * t + 1) * 4 + sub);
    c[0] = fmaf(ag, b0, c[0]);
    c[1] = fmaf(ag, b1, c[1]);
    c[2] = fmaf(ag8, b0, c[2]);
    c[3] = fmaf(ag8, b1, c[3]);
  }
}

// ---- tile products ----------------------------------------------------------

// c[16 x N] = sA[row0 .. row0+15, :DH] . sB[:N, :DH]^T (both tiles row-major over DH).
template <typename T, int DH, int N>
__device__ __forceinline__ void gemm_abt(float (&c)[N / 8][4], const T* sA, int row0, const T* sB) {
  constexpr int LD = DH + kPad;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    FragA<T> a;
    load_a(a, sA, LD, row0, kk);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      FragB<T> b;
      load_b_nk(b, sB, LD, j * 8, kk);
      mma(c[j], a, b);
    }
  }
}

// c[16 x DH] += P[16 x N] (registers, C layout) . sB[:N, :DH].
template <typename T, int DH, int N>
__device__ __forceinline__ void gemm_pb(float (&c)[DH / 8][4], const float (&pm)[N / 8][4], const T* sB) {
  constexpr int LD = DH + kPad;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    FragA<T> a;
    a_from_acc(a, pm[2 * kk], pm[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      FragB<T> b;
      load_b_kn(b, sB, LD, kk * 16, n * 8);
      mma(c[n], a, b);
    }
  }
}

// ---- the rules all three kernels share --------------------------------------

// The JAX package's _masked_scores: the scaled score of (query row, key col),
// both local to this call, or NEG_INF where masked. Rows past Lq are masked
// too (their results are never stored).
__device__ __forceinline__ float masked(float s, int row, int col, const Params& p) {
  if (row >= p.Lq || col >= p.Lk) return kNegInf;
  if (p.causal && p.q_offset + row < p.kv_offset + col) return kNegInf;
  return s;
}

// Softmax weight with the fully-masked-row guard: exactly 0 for masked scores.
__device__ __forceinline__ float weight(float s, float m) {
  return s <= 0.5f * kNegInf ? 0.f : expf(s - m);
}

// The JAX package's _causal_block_needed, as loop bounds: how many K tiles a
// Q tile starting at local row q0 visits ...
__device__ __forceinline__ int k_tiles_needed(const Params& p, int q0, int block_q) {
  const int n = (p.Lk + kBlockK - 1) / kBlockK;
  if (!p.causal) return n;
  const int last = p.q_offset + q0 + block_q - 1 - p.kv_offset;
  return last < 0 ? 0 : min(n, last / kBlockK + 1);
}

// ... and the first Q tile a K tile starting at local key k0 visits.
__device__ __forceinline__ int first_q_tile_needed(const Params& p, int k0, int block_q) {
  if (!p.causal) return 0;
  const int x = p.kv_offset + k0 - p.q_offset;
  return x > 0 ? x / block_q : 0;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// Rows [row0, row0 + ROWS) of one (b, h) slice into shared memory (row stride
// DH + kPad), 16 bytes a thread at a time; rows at or past `rows` are zeros.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_tile(T* s, const T* src, long long row_stride, int row0, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = DH / kVec;
  constexpr int LD = DH + kPad;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Stores this lane's two rows of a [16 x DH] C-layout accumulator, times
// `mul`, into a contiguous [B, L, H, DH] output.
template <typename T, int DH>
__device__ __forceinline__ void store_rows(T* out, const float (&c)[DH / 8][4], int b, int h, int row0,
                                           int L, int H, float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= L) continue;
    T* dst = out + (((long long)b * L + row) * H + h) * DH + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) store_pair(dst + n * 8, c[n][2 * r] * mul, c[n][2 * r + 1] * mul);
  }
}

// ---- kernels ----------------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int LD = DH + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBlockQ * LD;
  T* sV = sK + kBlockK * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // longest causal sweeps first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row0, row0 + 8

  load_tile<T, DH, kBlockQ>(sQ, Q, p.q_sl, q0, p.Lq);
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_k = k_tiles_needed(p, q0, kBlockQ);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, DH, kBlockK>(sK, K, p.k_sl, k0, p.Lk);
    load_tile<T, DH, kBlockK>(sV, V, p.v_sl, k0, p.Lk);
    __syncthreads();

    float s[kBlockK / 8][4];
    gemm_abt<T, DH, kBlockK>(s, sQ, warp * 16, sK);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = masked(s[j][i] * p.scale, row0 + 8 * (i >> 1), k0 + j * 8 + 2 * t + (i & 1), p);
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(fminf(m[r] - mn, 0.f));
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = weight(s[j][i], m[i >> 1]);
        rs[i >> 1] += s[j][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
    gemm_pb<T, DH, kBlockK>(o, s, sV);
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] = fmaxf(l[r], 1e-30f);
    const int row = row0 + 8 * r;
    if (t == 0 && row < p.Lq) p.lse[(long long)bh * p.Lq + row] = m[r] + logf(den[r]);
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] /= den[i >> 1];
  store_rows<T, DH>(static_cast<T*>(p.out), o, b, h, q0 + warp * 16, p.Lq, p.H, 1.f);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  constexpr int LD = DH + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + kBlockQ * LD;
  T* sK = sDO + kBlockQ * LD;
  T* sV = sK + kBlockK * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int row0 = q0 + warp * 16 + (lane >> 2);

  load_tile<T, DH, kBlockQ>(sQ, Q, p.q_sl, q0, p.Lq);
  load_tile<T, DH, kBlockQ>(sDO, DO, p.do_sl, q0, p.Lq);
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse[r] = row < p.Lq ? p.lse[(long long)bh * p.Lq + row] : 0.f;
    delta[r] = row < p.Lq ? p.delta[(long long)bh * p.Lq + row] : 0.f;
  }
  float dq[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  const int n_k = k_tiles_needed(p, q0, kBlockQ);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_tile<T, DH, kBlockK>(sK, K, p.k_sl, k0, p.Lk);
    load_tile<T, DH, kBlockK>(sV, V, p.v_sl, k0, p.Lk);
    __syncthreads();

    float s[kBlockK / 8][4], dp[kBlockK / 8][4];
    gemm_abt<T, DH, kBlockK>(s, sQ, warp * 16, sK);
    gemm_abt<T, DH, kBlockK>(dp, sDO, warp * 16, sV);
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float pw = weight(
            masked(s[j][i] * p.scale, row0 + 8 * r, k0 + j * 8 + 2 * t + (i & 1), p), lse[r]);
        s[j][i] = pw * (dp[j][i] - delta[r]);  // dS
      }
    gemm_pb<T, DH, kBlockK>(dq, s, sK);
  }
  store_rows<T, DH>(static_cast<T*>(p.dq), dq, b, h, q0 + warp * 16, p.Lq, p.H, p.scale);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_dkdv_kernel(const Params p) {
  constexpr int LD = DH + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kBlockK * LD;
  T* sQ = sV + kBlockK * LD;
  T* sDO = sQ + kBlockQB * LD;
  float* sLse = reinterpret_cast<float*>(sDO + kBlockQB * LD);
  float* sDelta = sLse + kBlockQB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int k0 = blockIdx.x * kBlockK;  // the first K tiles have the longest causal sweeps
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int key0 = k0 + warp * 16 + (lane >> 2);  // this lane's keys: key0, key0 + 8

  load_tile<T, DH, kBlockK>(sK, K, p.k_sl, k0, p.Lk);
  load_tile<T, DH, kBlockK>(sV, V, p.v_sl, k0, p.Lk);
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  const int n_q = (p.Lq + kBlockQB - 1) / kBlockQB;
  for (int qt = first_q_tile_needed(p, k0, kBlockQB); qt < n_q; ++qt) {
    const int q0 = qt * kBlockQB;
    __syncthreads();
    load_tile<T, DH, kBlockQB>(sQ, Q, p.q_sl, q0, p.Lq);
    load_tile<T, DH, kBlockQB>(sDO, DO, p.do_sl, q0, p.Lq);
    if (threadIdx.x < kBlockQB) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < p.Lq ? p.lse[(long long)bh * p.Lq + row] : 0.f;
      sDelta[threadIdx.x] = row < p.Lq ? p.delta[(long long)bh * p.Lq + row] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: rows are this warp's keys, columns the tile's queries
    float st[kBlockQB / 8][4], dpt[kBlockQB / 8][4];
    gemm_abt<T, DH, kBlockQB>(st, sK, warp * 16, sQ);
#pragma unroll
    for (int j = 0; j < kBlockQB / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = j * 8 + 2 * t + (i & 1);
        st[j][i] = weight(masked(st[j][i] * p.scale, q0 + col, key0 + 8 * (i >> 1), p), sLse[col]);
      }
    gemm_pb<T, DH, kBlockQB>(dv, st, sDO);  // dV += P^T dO
    gemm_abt<T, DH, kBlockQB>(dpt, sV, warp * 16, sDO);
#pragma unroll
    for (int j = 0; j < kBlockQB / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] *= dpt[j][i] - sDelta[j * 8 + 2 * t + (i & 1)];  // dS^T
    gemm_pb<T, DH, kBlockQB>(dk, st, sQ);  // dK += dS^T Q
  }
  store_rows<T, DH>(static_cast<T*>(p.dk), dk, b, h, k0 + warp * 16, p.Lk, p.H, p.scale);
  store_rows<T, DH>(static_cast<T*>(p.dv), dv, b, h, k0 + warp * 16, p.Lk, p.H, 1.f);
}

// ---- host side --------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int run(int which, const Params& p, int BH, cudaStream_t stream) {
  constexpr size_t row = (DH + kPad) * sizeof(T);
  const int n_q = (p.Lq + kBlockQ - 1) / kBlockQ, n_k = (p.Lk + kBlockK - 1) / kBlockK;
  switch (which) {
    case 0:
      return launch(flash_fwd_kernel<T, DH>, dim3(n_q, BH), (kBlockQ + 2 * kBlockK) * row, p, stream);
    case 1:
      return launch(flash_dq_kernel<T, DH>, dim3(n_q, BH), (2 * kBlockQ + 2 * kBlockK) * row, p, stream);
    case 2:
      return launch(flash_dkdv_kernel<T, DH>, dim3(n_k, BH),
                    (2 * kBlockK + 2 * kBlockQB) * row + 2 * kBlockQB * sizeof(float), p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Head widths built: 32, 64, 128 in bf16; 32 and 64 in float32 (the f32
// emulation at 128 spills and only lengthens the build).
int run_dtype(int which, int dtype, int dh, const Params& p, int BH, cudaStream_t stream) {
  if (dtype == 1) {
    switch (dh) {
      case 32: return run<bf16, 32>(which, p, BH, stream);
      case 64: return run<bf16, 64>(which, p, BH, stream);
      case 128: return run<bf16, 128>(which, p, BH, stream);
    }
  } else if (dtype == 0) {
    switch (dh) {
      case 32: return run<float, 32>(which, p, BH, stream);
      case 64: return run<float, 64>(which, p, BH, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches one pass on `stream` and returns cudaGetLastError() of the launch
// (0 on success). which: 0 forward (writes out, lse), 1 dQ (writes dq),
// 2 dK/dV (writes dk, dv). dtype: 0 float32, 1 bfloat16. strides: element
// strides (batch, row, head) of q, k, v and dout, 12 values; the head
// dimension has unit stride. Pointers the pass does not use may be null.
int omldm_flash_attention(int which, int dtype, int dh, int B, int H, int Lq, int Lk, int causal,
                          int q_offset, int kv_offset, float scale, const long long* strides,
                          const void* q, const void* k, const void* v, const void* dout, void* out,
                          void* dq, void* dk, void* dv, float* lse, const float* delta,
                          void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || (long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.out = out; p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = lse; p.delta = delta;
  p.q_sb = strides[0]; p.q_sl = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_sl = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_sl = strides[7]; p.v_sh = strides[8];
  p.do_sb = strides[9]; p.do_sl = strides[10]; p.do_sh = strides[11];
  p.H = H; p.Lq = Lq; p.Lk = Lk; p.causal = causal;
  p.q_offset = q_offset; p.kv_offset = kv_offset; p.scale = scale;
  return run_dtype(which, dtype, dh, p, B * H, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
