// Flash attention for Hopper: forward, dQ and dK/dV, CUDA C++ for sm_90a.
//
// Replaces the three TPU kernels of omldm_tpu/ops/attention.py:
//   flash_fwd_sm90_kernel,  flash_fwd_kernel  <- _flash_kernel          (wrapper flash_attention_pallas)
//   flash_dq_sm90_kernel,   flash_dq_kernel   <- _flash_bwd_dq_kernel   (wrapper _flash_diff_bwd)
//   flash_dkdv_sm90_kernel, flash_dkdv_kernel <- _flash_bwd_dkdv_kernel (wrapper _flash_diff_bwd)
// on q [B, Lq, H, Dh], k/v [B, Lk, H, Dh] (any Dh from 1 up, bfloat16 or
// float32, any B * H), with the causal mask on absolute positions q_offset + row >=
// kv_offset + col, keys past Lk masked, and p = 0 wherever s <= NEG_INF / 2
// (so a row that sees no key has a zero output, an lse near NEG_INF and zero
// gradients).
//
// Head widths: instances are built at 32, 64, 128 and 256 columns; a width
// with no instance of its own runs the next built one with Q, K, V and dO
// zero-padded in shared memory (zero columns change neither S nor dP), the
// padded output columns never stored, and the softmax scale 1/sqrt(Dh) of
// the true width (the caller passes it). Every width past 256 runs the wide
// instance, which loops over Dh at run time. run_dtype says which design
// runs each (dtype, Dh) and view.
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
// 1.5x and 2x the forward's products on a little more data. Only warpgroup
// wgmma reaches the tensor cores' rate, and only copies that run beside the
// products keep them fed: that is the Hopper design. The mma.sync design
// covers the widths and types it does not.
//
// Hopper design (bfloat16 at Dh 33 to 128 whose rows are whole 16-byte
// groups, Dh % 8 == 0, in the instances at 64 and 128, where every view's
// base and strides are whole 16-byte groups too: all three passes):
//   - One CTA of three warpgroups. Warpgroup 0 is the producer: after
//     setmaxnreg gives its registers away (24 a thread), one thread (in
//     dK/dV one warp, which also stages each tile's lse and delta rows)
//     keeps TMA tile loads in flight into a 2-stage ring of shared-memory
//     stages, each completed on an mbarrier ("full"), and reuses a stage
//     once both consumers have released it (an "empty" mbarrier).
//     Warpgroups 1 and 2 are consumers (240 registers a thread) and run
//     every product as wgmma with f32 accumulators in registers.
//   - Tiles arrive by TMA from a 4-d tensor map over the strided [B, L, H, Dh]
//     view (so q, k and v can be views into the packed qkv projection), in
//     64-column boxes with the 128-byte swizzle (a Dh-128 tile is two boxes);
//     rows past L and columns past Dh arrive as zeros. The wgmma shared-memory descriptors
//     describe that layout: K-major (Dh contiguous) for Q K^T-shaped
//     products, MN-major (the transpose flag) where the same tile is the B
//     operand of a product over its rows.
//   - Forward: one CTA per (b*h, 128-row Q tile), each consumer owns 64 rows;
//     Q is loaded once, K and V stream in 128-key tiles. S = Q K^T by SS
//     wgmma (m64n128k16), online softmax in the accumulator registers, P
//     rounded to bf16 in registers and O += P V by RS wgmma (V MN-major).
//   - dK/dV: one CTA per (b*h, 128-key tile), each consumer owns 64 keys; K and
//     V are loaded once and stay, Q, dO and the tile's lse/delta rows stream
//     in 64-row tiles from first_q_tile_needed on. With keys as rows nothing
//     is transposed in registers: S^T = K Q^T and dP^T = V dO^T (SS),
//     P^T = exp(scale S^T - lse), dV += P^T dO (RS, dO MN-major),
//     dS^T = P^T (dP^T - delta), dK += dS^T Q (RS, Q MN-major); dK is scaled
//     by `scale` when it is stored.
//   - dQ: one CTA per (b*h, 128-row Q tile), each consumer owns 64 rows; Q
//     and dO are loaded once (one mbarrier), K and V stream in 64-key tiles.
//     S = Q K^T and dP = dO V^T go out back to back as SS wgmma (m64n64k16);
//     P = exp2(S scale log2 e - lse log2 e) is computed while dP runs, then
//     dS = P (dP - delta) overwrites S in registers, is rounded to bf16 as
//     the A operand and dQ += dS K runs as RS wgmma (K MN-major); dQ is
//     scaled by `scale` when it is stored. Each thread reads its two rows'
//     lse and delta once. 64-key tiles keep dQ (Dh / 2 f32), S, dP (32
//     each) and dS (16) under the 240 registers; 128-key tiles would not.
//   - The mask is applied only on tiles the causal diagonal, Lq or Lk cut; a
//     consumer whose 64 rows (keys) lie wholly on the masked side of a tile
//     releases it untouched, and whole tiles above the diagonal are never
//     loaded (the JAX package's _causal_block_needed).
//   - The grid's slow axis runs over the tiles, longest causal sweeps first,
//     so the first wave holds the heaviest CTAs of every head.
//
// mma.sync design (float32 at every width; bfloat16 at Dh 1 to 32, at
// widths whose rows are not whole 16-byte groups, at a Hopper width whose
// view the tensor maps cannot take, and from 129 up; all three passes):
// warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate) with plain
// synchronous tile copies.
//   - The TPU's sequential K grid axis becomes a loop inside the block. One
//     CTA of 4 warps per (b*h, 64-row Q tile, column chunk) in the forward
//     and dQ passes, sweeping 64-key tiles (32 in the dQ at 256, so its
//     four float32 tiles fit shared memory and its bf16 S and dP leave
//     registers for the 128-column chunk); one CTA per (b*h, 64-key tile,
//     column chunk) in the dK/dV pass, sweeping 32-row Q tiles. Each warp
//     owns 16 rows of the CTA's tile; the accumulators live in registers in
//     the mma C-fragment layout. b*h is the grid's x axis (2^31 - 1), the
//     tile its y axis, the chunk its z axis.
//   - Column chunks keep the accumulators under the register file: a CTA
//     computes S (and dP) over the whole width but accumulates and stores
//     only its chunk of O, dQ or dK and dV -- 128 columns (bf16) or 64
//     (float32) in the forward and dQ, 64 in dK/dV, whose two accumulators
//     at 128 float32 columns spilled. The chunks of a row recompute its
//     scores; only chunk 0 writes the forward's lse.
//   - The tiles a CTA reads sit in shared memory (rows padded by 8 elements,
//     so fragment loads hit 32 distinct banks). S and dS never leave
//     registers: an mma C fragment of two adjacent 8-column tiles is exactly
//     the A fragment of the next product (P V, dS K, P^T dO, dS^T Q).
//   - float32 runs the same code with an exact f32 emulation of the
//     m16n8k16 product (warp shuffles and FMAs), so the tensor-core path and
//     the f32 path share every index and mask. It is there for parity
//     checks at small sizes, not for speed.
//   - Ragged Lq and Lk are handled by bounds checks: rows past the end load
//     as zeros, are masked, and are never stored. Rows that are whole
//     16-byte groups (every base, stride and the width) load 16 bytes a
//     thread; others, such as Dh 12 in bf16, one element at a time.
//   - The wide instance (every Dh past 256, one instance a type): a 64-row
//     float32 K tile of 512 columns alone would take ~132 KB of shared
//     memory, so its tiles hold one column chunk of a row -- 64 columns in
//     float32, 128 in bf16 -- and a loop over Dh at run time accumulates S
//     (and dP, and in dK/dV their transposes) chunk after chunk into the
//     same registers, each output one ascending chain over Dh as in the
//     built instances. Each CTA still owns one output column chunk on grid
//     z (that chunk's width in the forward and dQ, 64 in dK/dV), and its
//     products with P and dS read only that chunk of V or K (forward, dQ)
//     or of dO and Q (dK/dV). Every CTA of a row recomputes S over the
//     whole width: right and slow (Dh / 64 recomputations in float32).
//
// Both designs: inputs by strides ([B, L, H, Dh] with unit stride on Dh;
// the Hopper design also needs 16-byte aligned rows for its tensor maps);
// outputs contiguous [B, L, H, Dh]; lse and delta
// contiguous f32 [B*H, Lq]. Rounding points follow the JAX kernels: scores,
// softmax statistics and every accumulator are f32; P is rounded to the
// operand type before the P V and P^T dO products, dS before the dS K and
// dS^T Q products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

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
  int dh;   // the true head width (the instance's DH may be wider)
  int vec;  // every row of q, k, v and dout is whole 16-byte groups at 16-byte aligned addresses
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

// c[16 x N] = sA[row0 .. row0+15, :DH] . sB[:N, :DH]^T (both tiles row-major
// over DH), each output one sequential chain over DH.
template <typename T, int DH, int N>
__device__ __forceinline__ void gemm_abt(float (&c)[N / 8][4], const T* sA, int row0, const T* sB) {
  constexpr int LD = DH + kPad;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
  // float32's emulated products are long: a rolled reduction loop keeps
  // its code (and build) small; nothing in it indexes registers by kk
#pragma unroll(sizeof(T) == 4 ? 1 : DH / 16)
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

// c[16 x DC] += P[16 x N] (registers, C layout) . sB[:N, :DC], where sB points
// at the first column of a DC-wide chunk of a tile row-major over DH.
template <typename T, int DH, int DC, int N>
__device__ __forceinline__ void gemm_pb(float (&c)[DC / 8][4], const float (&pm)[N / 8][4], const T* sB) {
  constexpr int LD = DH + kPad;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    FragA<T> a;
    a_from_acc(a, pm[2 * kk], pm[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      FragB<T> b;
      load_b_kn(b, sB, LD, kk * 16, n * 8);
      mma(c[n], a, b);
    }
  }
}

// ---- the rules all three kernels share --------------------------------------

// Whether (query row, key col), both local to this call, is masked: past Lq
// or Lk, or above the causal diagonal.
__device__ __forceinline__ bool masked_out(int row, int col, const Params& p) {
  return row >= p.Lq || col >= p.Lk || (p.causal && p.q_offset + row < p.kv_offset + col);
}

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
__device__ __forceinline__ int k_tiles_needed(const Params& p, int q0, int block_q, int block_k) {
  const int n = (p.Lk + block_k - 1) / block_k;
  if (!p.causal) return n;
  const int last = p.q_offset + q0 + block_q - 1 - p.kv_offset;
  return last < 0 ? 0 : min(n, last / block_k + 1);
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

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16_rn(0.f); }
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

// Rows [row0, row0 + ROWS) of one (b, h) slice into shared memory (row stride
// DH + kPad); rows at or past `rows` and columns at or past p.dh are zeros.
// 16 bytes a thread at a time where every row is whole 16-byte groups
// (p.vec), else one element at a time.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_tile(T* s, const T* src, long long row_stride, int row0, int rows,
                                          const Params& p) {
  constexpr int LD = DH + kPad;
  if (p.vec) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kPerRow = DH / kVec;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < rows && c < p.dh)
        val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
      *reinterpret_cast<uint4*>(s + r * LD + c) = val;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * DH; i += kThreads) {
      const int r = i / DH, c = i % DH;
      s[r * LD + c] = row0 + r < rows && c < p.dh ? src[(long long)(row0 + r) * row_stride + c] : zero<T>();
    }
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_one(bf16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store_one(float* p, float a) { *p = a; }

// Columns col, col + 1 of one output row of width dh: one paired store where
// both lie inside and the pair is aligned (dh even), else one at a time.
template <typename T>
__device__ __forceinline__ void store_cols(T* row, int col, int dh, float a, float b) {
  if (col + 1 < dh && !(dh & 1)) {
    store_pair(row + col, a, b);
  } else {
    if (col < dh) store_one(row + col, a);
    if (col + 1 < dh) store_one(row + col + 1, b);
  }
}

// Stores this lane's two rows of a [16 x DC] C-layout accumulator (columns
// col0 .. col0 + DC - 1 of the instance's width), times `mul`, into a
// contiguous [B, L, H, p.dh] output; columns past p.dh are not stored.
template <typename T, int DC>
__device__ __forceinline__ void store_rows(T* out, const float (&c)[DC / 8][4], int b, int h, int row0,
                                           int L, const Params& p, int col0, float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= L) continue;
    T* dst = out + (((long long)b * L + row) * p.H + h) * p.dh;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
      store_cols(dst, col0 + n * 8 + 2 * (lane & 3), p.dh, c[n][2 * r] * mul, c[n][2 * r + 1] * mul);
  }
}

// ---- kernels ----------------------------------------------------------------

template <typename T, int DH, int DC>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int LD = DH + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBlockQ * LD;
  T* sV = sK + kBlockK * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // longest causal sweeps first
  const int c0 = blockIdx.z * DC;                          // this CTA's output columns
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row0, row0 + 8

  load_tile<T, DH, kBlockQ>(sQ, Q, p.q_sl, q0, p.Lq, p);
  float o[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_k = k_tiles_needed(p, q0, kBlockQ, kBlockK);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, DH, kBlockK>(sK, K, p.k_sl, k0, p.Lk, p);
    load_tile<T, DH, kBlockK>(sV, V, p.v_sl, k0, p.Lk, p);
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
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
    gemm_pb<T, DH, DC, kBlockK>(o, s, sV + c0);
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] = fmaxf(l[r], 1e-30f);
    const int row = row0 + 8 * r;
    if (blockIdx.z == 0 && t == 0 && row < p.Lq) p.lse[(long long)bh * p.Lq + row] = m[r] + logf(den[r]);
  }
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] /= den[i >> 1];
  store_rows<T, DC>(static_cast<T*>(p.out), o, b, h, q0 + warp * 16, p.Lq, p, c0, 1.f);
}

template <typename T, int DH, int DC, int BK>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  constexpr int LD = DH + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + kBlockQ * LD;
  T* sK = sDO + kBlockQ * LD;
  T* sV = sK + BK * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int c0 = blockIdx.z * DC;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int row0 = q0 + warp * 16 + (lane >> 2);

  load_tile<T, DH, kBlockQ>(sQ, Q, p.q_sl, q0, p.Lq, p);
  load_tile<T, DH, kBlockQ>(sDO, DO, p.do_sl, q0, p.Lq, p);
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse[r] = row < p.Lq ? p.lse[(long long)bh * p.Lq + row] : 0.f;
    delta[r] = row < p.Lq ? p.delta[(long long)bh * p.Lq + row] : 0.f;
  }
  float dq[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  const int n_k = k_tiles_needed(p, q0, kBlockQ, BK);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, DH, BK>(sK, K, p.k_sl, k0, p.Lk, p);
    load_tile<T, DH, BK>(sV, V, p.v_sl, k0, p.Lk, p);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
    gemm_abt<T, DH, BK>(s, sQ, warp * 16, sK);
    gemm_abt<T, DH, BK>(dp, sDO, warp * 16, sV);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float pw = weight(
            masked(s[j][i] * p.scale, row0 + 8 * r, k0 + j * 8 + 2 * t + (i & 1), p), lse[r]);
        s[j][i] = pw * (dp[j][i] - delta[r]);  // dS
      }
    gemm_pb<T, DH, DC, BK>(dq, s, sK + c0);
  }
  store_rows<T, DC>(static_cast<T*>(p.dq), dq, b, h, q0 + warp * 16, p.Lq, p, c0, p.scale);
}

template <typename T, int DH, int DC>
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
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kBlockK;  // the first K tiles have the longest causal sweeps
  const int c0 = blockIdx.z * DC;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int key0 = k0 + warp * 16 + (lane >> 2);  // this lane's keys: key0, key0 + 8

  load_tile<T, DH, kBlockK>(sK, K, p.k_sl, k0, p.Lk, p);
  load_tile<T, DH, kBlockK>(sV, V, p.v_sl, k0, p.Lk, p);
  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  const int n_q = (p.Lq + kBlockQB - 1) / kBlockQB;
  for (int qt = first_q_tile_needed(p, k0, kBlockQB); qt < n_q; ++qt) {
    const int q0 = qt * kBlockQB;
    __syncthreads();
    load_tile<T, DH, kBlockQB>(sQ, Q, p.q_sl, q0, p.Lq, p);
    load_tile<T, DH, kBlockQB>(sDO, DO, p.do_sl, q0, p.Lq, p);
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
    gemm_pb<T, DH, DC, kBlockQB>(dv, st, sDO + c0);  // dV += P^T dO
    gemm_abt<T, DH, kBlockQB>(dpt, sV, warp * 16, sDO);
#pragma unroll
    for (int j = 0; j < kBlockQB / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] *= dpt[j][i] - sDelta[j * 8 + 2 * t + (i & 1)];  // dS^T
    gemm_pb<T, DH, DC, kBlockQB>(dk, st, sQ + c0);  // dK += dS^T Q
  }
  store_rows<T, DC>(static_cast<T*>(p.dk), dk, b, h, k0 + warp * 16, p.Lk, p, c0, p.scale);
  store_rows<T, DC>(static_cast<T*>(p.dv), dv, b, h, k0 + warp * 16, p.Lk, p, c0, 1.f);
}

// ---- the wide instance: every head width past 256 ---------------------------

template <typename T> struct WideChunk;
template <> struct WideChunk<bf16> { static constexpr int value = 128; };
template <> struct WideChunk<float> { static constexpr int value = 64; };
constexpr int kWideDqKeys = 32;    // dQ keys per tile (S and dP beside a 128-column bf16 chunk)
constexpr int kWideBwdCols = 64;   // dK/dV output columns per CTA

template <int N>
__device__ __forceinline__ void clear(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
}

// W columns from col0 of rows [row0, row0 + ROWS) of one (b, h) slice into
// shared memory (row stride LDW + kPad); rows at or past `rows` and columns
// at or past p.dh are zeros. col0 is a multiple of 64, so where every row is
// whole 16-byte groups (p.vec) so is every chunk of it.
template <typename T, int W, int LDW, int ROWS>
__device__ __forceinline__ void load_chunk(T* s, const T* src, long long row_stride, int row0, int rows,
                                           int col0, const Params& p) {
  constexpr int LD = LDW + kPad;
  const int cols = p.dh - col0;
  src += col0;
  if (p.vec) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kPerRow = W / kVec;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < rows && c < cols)
        val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
      *reinterpret_cast<uint4*>(s + r * LD + c) = val;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * W; i += kThreads) {
      const int r = i / W, c = i % W;
      s[r * LD + c] = row0 + r < rows && c < cols ? src[(long long)(row0 + r) * row_stride + c] : zero<T>();
    }
  }
}

// c[16 x N] += sA[row0 .. row0+15, :W] . sB[:N, :W]^T (both tiles row-major,
// row stride W + kPad): the next W terms of each output's one chain over dh.
template <typename T, int W, int N>
__device__ __forceinline__ void gemm_abt_add(float (&c)[N / 8][4], const T* sA, int row0, const T* sB) {
  constexpr int LD = W + kPad;
#pragma unroll(sizeof(T) == 4 ? 1 : W / 16)
  for (int kk = 0; kk < W; kk += 16) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_wide_kernel(const Params p) {
  constexpr int CH = WideChunk<T>::value;
  constexpr int LD = CH + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBlockQ * LD;
  T* sV = sK + kBlockK * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // longest causal sweeps first
  const int c0 = blockIdx.z * CH;                          // this CTA's output columns
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int n_c = (p.dh + CH - 1) / CH;

  float o[CH / 8][4];
  clear(o);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int n_k = k_tiles_needed(p, q0, kBlockQ, kBlockK);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBlockK;
    float s[kBlockK / 8][4];
    clear(s);
    for (int c = 0; c < n_c; ++c) {  // S = Q K^T, chunk after chunk of dh
      __syncthreads();  // every warp is done with the previous chunks (and V tile)
      load_chunk<T, CH, CH, kBlockQ>(sQ, Q, p.q_sl, q0, p.Lq, c * CH, p);
      load_chunk<T, CH, CH, kBlockK>(sK, K, p.k_sl, k0, p.Lk, c * CH, p);
      if (c == 0) load_chunk<T, CH, CH, kBlockK>(sV, V, p.v_sl, k0, p.Lk, c0, p);
      __syncthreads();
      gemm_abt_add<T, CH, kBlockK>(s, sQ, warp * 16, sK);
    }
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
    for (int n = 0; n < CH / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
    gemm_pb<T, CH, CH, kBlockK>(o, s, sV);  // O += P V[:, chunk]
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] = fmaxf(l[r], 1e-30f);
    const int row = row0 + 8 * r;
    if (blockIdx.z == 0 && t == 0 && row < p.Lq) p.lse[(long long)bh * p.Lq + row] = m[r] + logf(den[r]);
  }
#pragma unroll
  for (int n = 0; n < CH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] /= den[i >> 1];
  store_rows<T, CH>(static_cast<T*>(p.out), o, b, h, q0 + warp * 16, p.Lq, p, c0, 1.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_wide_kernel(const Params p) {
  constexpr int CH = WideChunk<T>::value, BK = kWideDqKeys;
  constexpr int LD = CH + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + kBlockQ * LD;
  T* sK = sDO + kBlockQ * LD;
  T* sV = sK + BK * LD;
  T* sKc = sV + BK * LD;  // K[:, this CTA's chunk], the B operand of dS K
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int c0 = blockIdx.z * CH;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int n_c = (p.dh + CH - 1) / CH;

  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse[r] = row < p.Lq ? p.lse[(long long)bh * p.Lq + row] : 0.f;
    delta[r] = row < p.Lq ? p.delta[(long long)bh * p.Lq + row] : 0.f;
  }
  float dq[CH / 8][4];
  clear(dq);
  const int n_k = k_tiles_needed(p, q0, kBlockQ, BK);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    float s[BK / 8][4], dp[BK / 8][4];
    clear(s);
    clear(dp);
    for (int c = 0; c < n_c; ++c) {  // S = Q K^T and dP = dO V^T, chunk after chunk of dh
      __syncthreads();
      load_chunk<T, CH, CH, kBlockQ>(sQ, Q, p.q_sl, q0, p.Lq, c * CH, p);
      load_chunk<T, CH, CH, kBlockQ>(sDO, DO, p.do_sl, q0, p.Lq, c * CH, p);
      load_chunk<T, CH, CH, BK>(sK, K, p.k_sl, k0, p.Lk, c * CH, p);
      load_chunk<T, CH, CH, BK>(sV, V, p.v_sl, k0, p.Lk, c * CH, p);
      if (c == 0) load_chunk<T, CH, CH, BK>(sKc, K, p.k_sl, k0, p.Lk, c0, p);
      __syncthreads();
      gemm_abt_add<T, CH, BK>(s, sQ, warp * 16, sK);
      gemm_abt_add<T, CH, BK>(dp, sDO, warp * 16, sV);
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float pw = weight(
            masked(s[j][i] * p.scale, row0 + 8 * r, k0 + j * 8 + 2 * t + (i & 1), p), lse[r]);
        s[j][i] = pw * (dp[j][i] - delta[r]);  // dS
      }
    gemm_pb<T, CH, CH, BK>(dq, s, sKc);  // dQ += dS K[:, chunk]
  }
  store_rows<T, CH>(static_cast<T*>(p.dq), dq, b, h, q0 + warp * 16, p.Lq, p, c0, p.scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dkdv_wide_kernel(const Params p) {
  constexpr int CH = WideChunk<T>::value, DC = kWideBwdCols;
  constexpr int LD = CH + kPad, LDC = DC + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kBlockK * LD;
  T* sQ = sV + kBlockK * LD;
  T* sDO = sQ + kBlockQB * LD;
  T* sQc = sDO + kBlockQB * LD;    // Q[:, this CTA's chunk], the B operand of dS^T Q
  T* sDOc = sQc + kBlockQB * LDC;  // dO[:, this CTA's chunk], the B operand of P^T dO
  float* sLse = reinterpret_cast<float*>(sDOc + kBlockQB * LDC);
  float* sDelta = sLse + kBlockQB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kBlockK;
  const int c0 = blockIdx.z * DC;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int key0 = k0 + warp * 16 + (lane >> 2);
  const int n_c = (p.dh + CH - 1) / CH;

  float dk[DC / 8][4], dv[DC / 8][4];
  clear(dk);
  clear(dv);
  const int n_q = (p.Lq + kBlockQB - 1) / kBlockQB;
  for (int qt = first_q_tile_needed(p, k0, kBlockQB); qt < n_q; ++qt) {
    const int q0 = qt * kBlockQB;
    // S^T = K Q^T and dP^T = V dO^T, chunk after chunk of dh: rows are this
    // warp's keys, columns the tile's queries
    float st[kBlockQB / 8][4], dpt[kBlockQB / 8][4];
    clear(st);
    clear(dpt);
    for (int c = 0; c < n_c; ++c) {
      __syncthreads();
      load_chunk<T, CH, CH, kBlockK>(sK, K, p.k_sl, k0, p.Lk, c * CH, p);
      load_chunk<T, CH, CH, kBlockK>(sV, V, p.v_sl, k0, p.Lk, c * CH, p);
      load_chunk<T, CH, CH, kBlockQB>(sQ, Q, p.q_sl, q0, p.Lq, c * CH, p);
      load_chunk<T, CH, CH, kBlockQB>(sDO, DO, p.do_sl, q0, p.Lq, c * CH, p);
      if (c == 0) {
        load_chunk<T, DC, DC, kBlockQB>(sQc, Q, p.q_sl, q0, p.Lq, c0, p);
        load_chunk<T, DC, DC, kBlockQB>(sDOc, DO, p.do_sl, q0, p.Lq, c0, p);
        if (threadIdx.x < kBlockQB) {
          const int row = q0 + threadIdx.x;
          sLse[threadIdx.x] = row < p.Lq ? p.lse[(long long)bh * p.Lq + row] : 0.f;
          sDelta[threadIdx.x] = row < p.Lq ? p.delta[(long long)bh * p.Lq + row] : 0.f;
        }
      }
      __syncthreads();
      gemm_abt_add<T, CH, kBlockQB>(st, sK, warp * 16, sQ);
      gemm_abt_add<T, CH, kBlockQB>(dpt, sV, warp * 16, sDO);
    }
#pragma unroll
    for (int j = 0; j < kBlockQB / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = j * 8 + 2 * t + (i & 1);
        st[j][i] = weight(masked(st[j][i] * p.scale, q0 + col, key0 + 8 * (i >> 1), p), sLse[col]);
      }
    gemm_pb<T, DC, DC, kBlockQB>(dv, st, sDOc);  // dV += P^T dO[:, chunk]
#pragma unroll
    for (int j = 0; j < kBlockQB / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] *= dpt[j][i] - sDelta[j * 8 + 2 * t + (i & 1)];  // dS^T
    gemm_pb<T, DC, DC, kBlockQB>(dk, st, sQc);  // dK += dS^T Q[:, chunk]
  }
  store_rows<T, DC>(static_cast<T*>(p.dk), dk, b, h, k0 + warp * 16, p.Lk, p, c0, p.scale);
  store_rows<T, DC>(static_cast<T*>(p.dv), dv, b, h, k0 + warp * 16, p.Lk, p, c0, 1.f);
}

// ---- Hopper kernels: bfloat16 at Dh 64 and 128 (and the widths padded to them) ----

constexpr int kWarpgroup = 128;
constexpr int kSm90Threads = 3 * kWarpgroup;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 24 x 128 + 240 x 256 <= 65,536
constexpr int kFwdM = 128, kFwdN = 128;  // forward: query rows per CTA, keys per tile
constexpr int kBwdN = 128, kBwdM = 64;   // dK/dV: keys per CTA, query rows per tile
constexpr int kDqM = 128, kDqN = 64;     // dQ: query rows per CTA, keys per tile
constexpr int kStages = 2;               // ring depth of the streamed tiles
constexpr int kBox = 128;                // bytes of one swizzled box row (64 bf16)
constexpr int kConsumerWarps = 8;        // arrivals that release a stage
constexpr float kLog2e = 1.4426950408889634f;

struct Sm90Args {
  CUtensorMap q, k, v, dout;
  Params p;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The ROWS x DH tile at `tile` (DH / 64 swizzled halves of ROWS x 128 bytes)
// as a wgmma operand whose reduction runs over DH: 16 columns from kk * 16,
// rows from `row` on.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k_major(const unsigned char* tile, int row, int kk) {
  return sm90::desc_sw128(tile + (kk / 4) * ROWS * kBox + row * kBox + (kk % 4) * 32, 16, 1024);
}

// The same tile as the B operand of a product whose reduction runs over its
// rows (16 rows from kk * 16) and whose output columns are its DH columns.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn_major(const unsigned char* tile, int kk) {
  return sm90::desc_sw128(tile + kk * 16 * kBox, ROWS * kBox, 1024);
}

// The ROWS x DH tile of rows [row0, row0 + ROWS) of one (b, h) slice, as
// DH / 64 TMA boxes completed on `bar` (which the caller armed for them).
template <int ROWS, int DH>
__device__ __forceinline__ void load_tile_tma(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int b,
                                              int h, int row0) {
#pragma unroll
  for (int half = 0; half < DH / 64; ++half)
    sm90::tma_load_4d(dst + half * ROWS * kBox, map, bar, half * 64, h, row0, b);
}

// Packs two accumulator chunks per 16 columns into wgmma A registers,
// rounding to bf16: the rounding point of P and dS.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack(c[8 * kk + 2 * i], c[8 * kk + 2 * i + 1]);
}

// Stores this thread's two rows (row0, row0 + 8) of a warpgroup's 64 x DH
// accumulator, times `mul`, into a contiguous [B, L, H, dh] output (dh <= DH,
// a multiple of 8: the columns past it are not stored).
template <int DH>
__device__ __forceinline__ void store_acc(bf16* out, const float (&c)[DH / 2], int b, int h, int row0, int L,
                                          const Params& p, float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    bf16* dst = out + (((long long)b * L + row) * p.H + h) * p.dh + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      if (8 * j < p.dh) store_pair(dst + 8 * j, c[4 * j + 2 * r] * mul, c[4 * j + 2 * r + 1] * mul);
  }
}

template <int DH>
__global__ void __launch_bounds__(kSm90Threads, 1) flash_fwd_sm90_kernel(const __grid_constant__ Sm90Args args) {
  constexpr uint32_t kQBytes = kFwdM * DH * 2, kKVBytes = kFwdN * DH * 2;
  const Params& p = args.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sK = sQ + kQBytes;
  unsigned char* sV = sK + kStages * kKVBytes;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + kStages * kKVBytes);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdM;  // longest causal sweeps first
  const int n_k = k_tiles_needed(p, q0, kFwdM, kFwdN);
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n_k > 0) {
      sm90::mbar_arrive_expect_tx(bar_q, kQBytes);
      load_tile_tma<kFwdM, DH>(sQ, &args.q, bar_q, b, h, q0);
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) sm90::mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        sm90::mbar_arrive_expect_tx(&full_k[s], kKVBytes);
        load_tile_tma<kFwdN, DH>(sK + s * kKVBytes, &args.k, &full_k[s], b, h, kt * kFwdN);
        sm90::mbar_arrive_expect_tx(&full_v[s], kKVBytes);
        load_tile_tma<kFwdN, DH>(sV + s * kKVBytes, &args.v, &full_v[s], b, h, kt * kFwdN);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows r0 .. r0 + 63 of the CTA's tile
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3, t = lane & 3;
  const int r0 = q0 + cw * 64;
  const int row0 = r0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const float sl2 = p.scale * kLog2e;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};  // running max of the raw scores, denominator

  if (n_k > 0) sm90::mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages, k0 = kt * kFwdN;
    const uint32_t phase = (kt / kStages) & 1;
    sm90::mbar_wait(&full_k[s], phase);
    if (p.causal && p.q_offset + r0 + 63 < p.kv_offset + k0) {  // every row above every key
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
      continue;
    }
    float sc[kFwdN / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      sm90::Wgmma<kFwdN>::ss(sc, desc_k_major<kFwdM>(sQ, cw * 64, kk),
                             desc_k_major<kFwdN>(sK + s * kKVBytes, 0, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    if (k0 + kFwdN > p.Lk || (p.causal && p.q_offset + r0 < p.kv_offset + k0 + kFwdN - 1)) {
#pragma unroll
      for (int j = 0; j < kFwdN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (masked_out(row0 + 8 * (i >> 1), k0 + 8 * j + 2 * t + (i & 1), p)) sc[4 * j + i] = neg_inf();
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kFwdN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      const float mu = mx[r] == neg_inf() ? 0.f : mx[r];  // a row that has seen no key yet
      alpha[r] = exp2f((m[r] - mu) * sl2);
      ms[r] = mu * sl2;
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < kFwdN / 2; ++i) {
      sc[i] = exp2f(fmaf(sc[i], sl2, -ms[(i >> 1) & 1]));  // masked scores give exactly 0
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[kFwdN / 16][4];
    pack_a<kFwdN>(pa, sc);

    sm90::mbar_wait(&full_v[s], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdN / 16; ++kk)
      sm90::Wgmma<DH>::rs(o, pa[kk], desc_mn_major<kFwdN>(sV + s * kKVBytes, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(l[r], 1e-30f);
    const int row = row0 + 8 * r;
    if (t == 0 && row < p.Lq)
      p.lse[(long long)bh * p.Lq + row] = m[r] == neg_inf() ? kNegInf : m[r] * p.scale + logf(den);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j + 2 * r] /= den;
      o[4 * j + 2 * r + 1] /= den;
    }
  }
  store_acc<DH>(static_cast<bf16*>(p.out), o, b, h, row0, p.Lq, p, 1.f);
}

template <int DH>
__global__ void __launch_bounds__(kSm90Threads, 1) flash_dkdv_sm90_kernel(const __grid_constant__ Sm90Args args) {
  constexpr uint32_t kKVBytes = kBwdN * DH * 2, kQBytes = kBwdM * DH * 2;
  const Params& p = args.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align_1024(smem_raw);
  unsigned char* sV = sK + kKVBytes;
  unsigned char* sQ = sV + kKVBytes;
  unsigned char* sDO = sQ + kStages * kQBytes;
  float* sLse = reinterpret_cast<float*>(sDO + kStages * kQBytes);  // lse * log2(e), per stage
  float* sDelta = sLse + kStages * kBwdM;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sDelta + kStages * kBwdM);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kBwdN;  // the first key tiles have the longest causal sweeps
  const int n_q = (p.Lq + kBwdM - 1) / kBwdM;
  const int qt0 = first_q_tile_needed(p, k0, kBwdM);
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);  // the TMA's arrival and the producer warp's lse/delta rows
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: warp 0
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x;
    if (threadIdx.x < 32 && qt0 < n_q) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(bar_kv, 2 * kKVBytes);
        load_tile_tma<kBwdN, DH>(sK, &args.k, bar_kv, b, h, k0);
        load_tile_tma<kBwdN, DH>(sV, &args.v, bar_kv, b, h, k0);
      }
      for (int qt = qt0, i = 0; qt < n_q; ++qt, ++i) {
        const int s = i % kStages;
        if (i >= kStages) sm90::mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[s], 2 * kQBytes);
          load_tile_tma<kBwdM, DH>(sQ + s * kQBytes, &args.q, &full[s], b, h, qt * kBwdM);
          load_tile_tma<kBwdM, DH>(sDO + s * kQBytes, &args.dout, &full[s], b, h, qt * kBwdM);
        }
        for (int r = lane; r < kBwdM; r += 32) {
          const int row = qt * kBwdM + r;
          const bool in = row < p.Lq;
          sLse[s * kBwdM + r] = in ? p.lse[(long long)bh * p.Lq + row] * kLog2e : 0.f;
          sDelta[s * kBwdM + r] = in ? p.delta[(long long)bh * p.Lq + row] : 0.f;
        }
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns keys kw0 .. kw0 + 63 of the CTA's tile
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3, t = lane & 3;
  const int kw0 = k0 + cw * 64;
  const int key0 = kw0 + warp * 16 + (lane >> 2);  // this thread's keys: key0, key0 + 8
  const float sl2 = p.scale * kLog2e;
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;

  if (qt0 < n_q) sm90::mbar_wait(bar_kv, 0);
  for (int qt = qt0, it = 0; qt < n_q; ++qt, ++it) {
    const int s = it % kStages, q0 = qt * kBwdM;
    sm90::mbar_wait(&full[s], (it / kStages) & 1);
    if (p.causal && p.q_offset + q0 + kBwdM - 1 < p.kv_offset + kw0) {  // every query above every key
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
      continue;
    }
    const unsigned char* q_tile = sQ + s * kQBytes;
    const unsigned char* do_tile = sDO + s * kQBytes;
    const float* lse2 = sLse + s * kBwdM;
    const float* dlt = sDelta + s * kBwdM;

    // S^T and dP^T: rows are this warpgroup's keys, columns the tile's queries
    float st[kBwdM / 2], dpt[kBwdM / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      sm90::Wgmma<kBwdM>::ss(st, desc_k_major<kBwdN>(sK, cw * 64, kk), desc_k_major<kBwdM>(q_tile, 0, kk), kk > 0);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      sm90::Wgmma<kBwdM>::ss(dpt, desc_k_major<kBwdN>(sV, cw * 64, kk), desc_k_major<kBwdM>(do_tile, 0, kk),
                             kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // S^T is done; dP^T may still run
    sm90::fence_regs(st);

    const bool cut = q0 + kBwdM > p.Lq || (p.causal && p.q_offset + q0 < p.kv_offset + kw0 + 63);
#pragma unroll
    for (int j = 0; j < kBwdM / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 8 * j + 2 * t + (i & 1);
        const float e = exp2f(fmaf(st[4 * j + i], sl2, -lse2[col]));
        st[4 * j + i] = cut && masked_out(q0 + col, key0 + 8 * (i >> 1), p) ? 0.f : e;
      }
    uint32_t pa[kBwdM / 16][4];
    pack_a<kBwdM>(pa, st);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdM / 16; ++kk) sm90::Wgmma<DH>::rs(dv, pa[kk], desc_mn_major<kBwdM>(do_tile, kk));
    sm90::wgmma_commit();  // dV += P^T dO
    sm90::wgmma_wait<1>();  // dP^T is done; dV may still run
    sm90::fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < kBwdM / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[4 * j + i] *= dpt[4 * j + i] - dlt[8 * j + 2 * t + (i & 1)];  // dS^T
    sm90::wgmma_wait<0>();  // dV is done reading pa
    sm90::fence_regs(dv);
    pack_a<kBwdM>(pa, st);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdM / 16; ++kk) sm90::Wgmma<DH>::rs(dk, pa[kk], desc_mn_major<kBwdM>(q_tile, kk));
    sm90::wgmma_commit();  // dK += dS^T Q
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dk);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }
  store_acc<DH>(static_cast<bf16*>(p.dk), dk, b, h, key0, p.Lk, p, p.scale);
  store_acc<DH>(static_cast<bf16*>(p.dv), dv, b, h, key0, p.Lk, p, 1.f);
}

template <int DH>
__global__ void __launch_bounds__(kSm90Threads, 1) flash_dq_sm90_kernel(const __grid_constant__ Sm90Args args) {
  constexpr uint32_t kQBytes = kDqM * DH * 2, kKVBytes = kDqN * DH * 2;
  const Params& p = args.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sDO = sQ + kQBytes;
  unsigned char* sK = sDO + kQBytes;
  unsigned char* sV = sK + kStages * kKVBytes;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + kStages * kKVBytes);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqM;  // longest causal sweeps first
  const int n_k = k_tiles_needed(p, q0, kDqM, kDqN);
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n_k > 0) {
      sm90::mbar_arrive_expect_tx(bar_q, 2 * kQBytes);
      load_tile_tma<kDqM, DH>(sQ, &args.q, bar_q, b, h, q0);
      load_tile_tma<kDqM, DH>(sDO, &args.dout, bar_q, b, h, q0);
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) sm90::mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        sm90::mbar_arrive_expect_tx(&full_k[s], kKVBytes);
        load_tile_tma<kDqN, DH>(sK + s * kKVBytes, &args.k, &full_k[s], b, h, kt * kDqN);
        sm90::mbar_arrive_expect_tx(&full_v[s], kKVBytes);
        load_tile_tma<kDqN, DH>(sV + s * kKVBytes, &args.v, &full_v[s], b, h, kt * kDqN);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows r0 .. r0 + 63 of the CTA's tile
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3, t = lane & 3;
  const int r0 = q0 + cw * 64;
  const int row0 = r0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const float sl2 = p.scale * kLog2e;
  float lse2[2], delta[2];  // lse * log2(e) and delta of this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < p.Lq ? p.lse[(long long)bh * p.Lq + row] * kLog2e : 0.f;
    delta[r] = row < p.Lq ? p.delta[(long long)bh * p.Lq + row] : 0.f;
  }
  float dq[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;

  if (n_k > 0) sm90::mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages, k0 = kt * kDqN;
    const uint32_t phase = (kt / kStages) & 1;
    sm90::mbar_wait(&full_k[s], phase);
    if (p.causal && p.q_offset + r0 + 63 < p.kv_offset + k0) {  // every row above every key
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
      continue;
    }
    const unsigned char* k_tile = sK + s * kKVBytes;
    // S = Q K^T and dP = dO V^T, issued back to back
    float sc[kDqN / 2], dp[kDqN / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      sm90::Wgmma<kDqN>::ss(sc, desc_k_major<kDqM>(sQ, cw * 64, kk), desc_k_major<kDqN>(k_tile, 0, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::mbar_wait(&full_v[s], phase);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      sm90::Wgmma<kDqN>::ss(dp, desc_k_major<kDqM>(sDO, cw * 64, kk),
                            desc_k_major<kDqN>(sV + s * kKVBytes, 0, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // S is done; dP may still run
    sm90::fence_regs(sc);

    const bool cut = k0 + kDqN > p.Lk || (p.causal && p.q_offset + r0 < p.kv_offset + k0 + kDqN - 1);
#pragma unroll
    for (int j = 0; j < kDqN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = exp2f(fmaf(sc[4 * j + i], sl2, -lse2[i >> 1]));
        sc[4 * j + i] = cut && masked_out(row0 + 8 * (i >> 1), k0 + 8 * j + 2 * t + (i & 1), p) ? 0.f : e;
      }
    sm90::wgmma_wait<0>();  // dP is done
    sm90::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < kDqN / 2; ++i) sc[i] *= dp[i] - delta[(i >> 1) & 1];  // dS
    uint32_t da[kDqN / 16][4];
    pack_a<kDqN>(da, sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqN / 16; ++kk) sm90::Wgmma<DH>::rs(dq, da[kk], desc_mn_major<kDqN>(k_tile, kk));
    sm90::wgmma_commit();  // dQ += dS K
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }
  store_acc<DH>(static_cast<bf16*>(p.dq), dq, b, h, row0, p.Lq, p, p.scale);
}

// ---- host side --------------------------------------------------------------

template <typename Kernel, typename Arg>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Arg& arg, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(arg);
  return (int)cudaGetLastError();
}

// The mma.sync design, all three passes: (b*h, tile, column chunk) grids,
// as many chunks as hold columns of the true width.
template <typename T, int DH>
int run_mma(int which, const Params& p, int BH, cudaStream_t stream) {
  constexpr int kWide = sizeof(T) == 4 ? 64 : 128;   // forward and dQ column chunk
  constexpr int kCols = DH < kWide ? DH : kWide;
  constexpr int kBwdCols = DH < 64 ? DH : 64;           // dK/dV column chunk
  constexpr int kDqKeys = DH > 128 ? 32 : kBlockK;  // dQ key tile at 256: shared memory (f32), registers (bf16)
  constexpr size_t row = (DH + kPad) * sizeof(T);
  const int n_q = (p.Lq + kBlockQ - 1) / kBlockQ, n_k = (p.Lk + kBlockK - 1) / kBlockK;
  if (n_q > 65535 || n_k > 65535) return (int)cudaErrorInvalidValue;
  switch (which) {
    case 0:
      return launch(flash_fwd_kernel<T, DH, kCols>, dim3(BH, n_q, (p.dh + kCols - 1) / kCols), kThreads,
                    (kBlockQ + 2 * kBlockK) * row, p, stream);
    case 1:
      return launch(flash_dq_kernel<T, DH, kCols, kDqKeys>, dim3(BH, n_q, (p.dh + kCols - 1) / kCols), kThreads,
                    (2 * kBlockQ + 2 * kDqKeys) * row, p, stream);
    case 2:
      return launch(flash_dkdv_kernel<T, DH, kBwdCols>, dim3(BH, n_k, (p.dh + kBwdCols - 1) / kBwdCols), kThreads,
                    (2 * kBlockK + 2 * kBlockQB) * row + 2 * kBlockQB * sizeof(float), p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The Hopper design, all three passes (bf16). The tensor maps are encoded
// here, on the host, for each call: they hold the call's pointers and
// strides. A map cuTensorMapEncodeTiled refuses returns its error and
// nothing is launched.
template <int DH>
int run_sm90(int which, const Params& p, int B, cudaStream_t stream) {
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  if ((which == 2 ? (p.Lk + kBwdN - 1) / kBwdN : (p.Lq + kFwdM - 1) / kFwdM) > 65535)
    return (int)cudaErrorInvalidValue;
  Sm90Args args;
  args.p = p;
  const int q_rows = which == 0 ? kFwdM : which == 1 ? kDqM : kBwdM;
  const int kv_rows = which == 0 ? kFwdN : which == 1 ? kDqN : kBwdN;
  int rc = sm90::make_tensor_map(&args.q, p.q, B, p.Lq, p.H, p.dh, p.q_sb, p.q_sl, p.q_sh, q_rows);
  if (rc == 0) rc = sm90::make_tensor_map(&args.k, p.k, B, p.Lk, p.H, p.dh, p.k_sb, p.k_sl, p.k_sh, kv_rows);
  if (rc == 0) rc = sm90::make_tensor_map(&args.v, p.v, B, p.Lk, p.H, p.dh, p.v_sb, p.v_sl, p.v_sh, kv_rows);
  if (rc == 0 && which != 0)
    rc = sm90::make_tensor_map(&args.dout, p.dout, B, p.Lq, p.H, p.dh, p.do_sb, p.do_sl, p.do_sh, q_rows);
  if (rc != 0) return rc;
  constexpr size_t kAlign = 1024, kBars = 8 * (1 + 3 * kStages);
  if (which == 0) {
    constexpr size_t smem = kAlign + (size_t)(kFwdM + 2 * kStages * kFwdN) * DH * 2 + kBars;
    const dim3 grid(B * p.H, (p.Lq + kFwdM - 1) / kFwdM);
    return launch(flash_fwd_sm90_kernel<DH>, grid, kSm90Threads, smem, args, stream);
  }
  if (which == 1) {
    constexpr size_t smem = kAlign + (size_t)(2 * kDqM + 2 * kStages * kDqN) * DH * 2 + 8 * (1 + 3 * kStages);
    const dim3 grid(B * p.H, (p.Lq + kDqM - 1) / kDqM);
    return launch(flash_dq_sm90_kernel<DH>, grid, kSm90Threads, smem, args, stream);
  }
  constexpr size_t smem =
      kAlign + (size_t)(2 * kBwdN + 2 * kStages * kBwdM) * DH * 2 + 2 * kStages * kBwdM * sizeof(float) + kBars;
  const dim3 grid(B * p.H, (p.Lk + kBwdN - 1) / kBwdN);
  return launch(flash_dkdv_sm90_kernel<DH>, grid, kSm90Threads, smem, args, stream);
}

// The wide instance, all three passes: (b*h, tile, column chunk) grids as
// in run_mma, every chunk of the true width its own CTA.
template <typename T>
int run_wide(int which, const Params& p, int BH, cudaStream_t stream) {
  constexpr int CH = WideChunk<T>::value;
  constexpr size_t row = (CH + kPad) * sizeof(T), out_row = (kWideBwdCols + kPad) * sizeof(T);
  const int n_q = (p.Lq + kBlockQ - 1) / kBlockQ, n_k = (p.Lk + kBlockK - 1) / kBlockK;
  if (n_q > 65535 || n_k > 65535) return (int)cudaErrorInvalidValue;
  switch (which) {
    case 0:
      return launch(flash_fwd_wide_kernel<T>, dim3(BH, n_q, (p.dh + CH - 1) / CH), kThreads,
                    (kBlockQ + 2 * kBlockK) * row, p, stream);
    case 1:
      return launch(flash_dq_wide_kernel<T>, dim3(BH, n_q, (p.dh + CH - 1) / CH), kThreads,
                    (2 * kBlockQ + 3 * kWideDqKeys) * row, p, stream);
    case 2:
      return launch(flash_dkdv_wide_kernel<T>, dim3(BH, n_k, (p.dh + kWideBwdCols - 1) / kWideBwdCols),
                    kThreads,
                    (2 * kBlockK + 2 * kBlockQB) * row + 2 * kBlockQB * out_row + 2 * kBlockQB * sizeof(float),
                    p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Whether the views fit the Hopper design's tensor maps: every row whole
// 16-byte groups at 16-byte aligned addresses (p.vec), and every byte
// stride below 2^40, the largest cuTensorMapEncodeTiled takes.
bool tma_fits(const Params& p) {
  const long long strides[12] = {p.q_sb, p.q_sl, p.q_sh, p.k_sb, p.k_sl, p.k_sh,
                                 p.v_sb, p.v_sl, p.v_sh, p.do_sb, p.do_sl, p.do_sh};
  for (long long s : strides)
    if (s * 2 >= (1LL << 40)) return false;
  return p.vec != 0;
}

// Which design and instance run each (dtype, head width) and view: the next
// built width of 32, 64, 128 and 256 at or above dh, and the wide instance
// past 256; bfloat16 rows of whole 16-byte groups (dh % 8 == 0) at 64 and
// 128 take the Hopper design where the views fit its tensor maps
// (tma_fits), every other width and view the mma.sync design at the same
// width. ops/attention.py restates this as kernel_width, KERNEL_DESIGNS
// and kernel_design; the CPU tests pin them together.
int run_dtype(int which, int dtype, int dh, const Params& p, int B, cudaStream_t stream) {
  const int BH = B * p.H;
  const bool tma = tma_fits(p);
  if (dtype == 1) {
    if (dh <= 32) return run_mma<bf16, 32>(which, p, BH, stream);
    if (dh <= 64) return dh % 8 == 0 && tma ? run_sm90<64>(which, p, B, stream) : run_mma<bf16, 64>(which, p, BH, stream);
    if (dh <= 128) return dh % 8 == 0 && tma ? run_sm90<128>(which, p, B, stream) : run_mma<bf16, 128>(which, p, BH, stream);
    if (dh <= 256) return run_mma<bf16, 256>(which, p, BH, stream);
    return run_wide<bf16>(which, p, BH, stream);
  } else if (dtype == 0) {
    if (dh <= 32) return run_mma<float, 32>(which, p, BH, stream);
    if (dh <= 64) return run_mma<float, 64>(which, p, BH, stream);
    if (dh <= 128) return run_mma<float, 128>(which, p, BH, stream);
    if (dh <= 256) return run_mma<float, 256>(which, p, BH, stream);
    return run_wide<float>(which, p, BH, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Whether every row of t (base and the three strides, in elements of `size`
// bytes) and the width are whole 16-byte groups: the mma.sync design's 16-byte loads.
bool rows_of_16(const void* t, const long long* strides, int dh, int size) {
  if (t == nullptr) return true;
  if (reinterpret_cast<uintptr_t>(t) % 16 || (dh * size) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if ((strides[i] * size) % 16) return false;
  return true;
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
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || dh < 1 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
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
  p.dh = dh;
  const int size = dtype == 1 ? 2 : 4;
  p.vec = rows_of_16(q, strides, dh, size) && rows_of_16(k, strides + 3, dh, size) &&
          rows_of_16(v, strides + 6, dh, size) && rows_of_16(dout, strides + 9, dh, size);
  return run_dtype(which, dtype, dh, p, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
