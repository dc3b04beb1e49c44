// Flash attention for Hopper: forward, dQ and dK/dV, CUDA C++ for sm_90a.
//
// Replaces the three TPU kernels of omldm_tpu/ops/attention.py:
//   flash_fwd_sm90_kernel,  flash_fwd_kernel,  flash_fwd_cluster_kernel  <- _flash_kernel
//                                                                           (wrapper flash_attention_pallas)
//   flash_dq_sm90_kernel,   flash_dq_kernel,   flash_dq_cluster_kernel   <- _flash_bwd_dq_kernel
//                                                                           (wrapper _flash_diff_bwd)
//   flash_dkdv_sm90_kernel, flash_dkdv_kernel, flash_dkdv_cluster_kernel <- _flash_bwd_dkdv_kernel
//                                                                           (wrapper _flash_diff_bwd)
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
// the true width (the caller passes it). Past 256 all three passes run the
// cluster design, which splits Dh across the CTAs of a thread-block cluster.
// run_dtype says which design runs each pass of each (dtype, Dh) and view.
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
// covers the widths and types it does not up to 256. Past 256 a CTA cannot
// hold a whole row of a tile: the cluster design keeps each score computed
// once all the same (below).
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
// mma.sync design (float32 at Dh 1 to 256; bfloat16 at Dh 1 to 32, at
// widths whose rows are not whole 16-byte groups, at a Hopper width whose
// view the tensor maps cannot take, and from 129 to 256; all three passes):
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
//
// Cluster design (all three passes at every Dh past 256, bfloat16 and
// float32): a CTA cannot hold a whole row of a tile, and column chunks as
// in the mma.sync design would recompute S (and dP) in each of Dh / 64 (or
// 128) CTAs (4.5-5.7x the products at Dh 512). At Dh 512 the
// function is bound by its operations (bf16 tensor cores, float32 FFMA at
// 67 TFLOP/s), not its bytes: the design does each product once, and pays
// for it with an exchange a tile through distributed shared memory and two
// cluster barriers. The width is split, not repeated:
//   - One cluster of CTAs per (b*h, 64-row tile): query rows in the forward
//     and dQ, keys in dK/dV. CTA r owns slice r of Dh (kSlice = 128 columns;
//     the last one ragged, its columns past Dh loaded as zeros and never
//     stored); the slices on grid z form the cluster, its size set at
//     launch. Past 8 slices (Dh 1024) a CTA owns ceil(slices / 8) of them,
//     so a cluster never exceeds the portable 8 CTAs. The grid's slow axis
//     runs the longest causal sweeps first.
//   - A CTA's fixed tiles (Q in the forward, Q and dO in dQ, K and V in
//     dK/dV) load once; the sweep's tiles (K and V, or Q, dO and their lse
//     and delta rows) stream through a 2-stage cp.async ring, the next
//     tile's copies beside this tile's products (plain loads where the rows
//     are not whole 16-byte groups, such as bf16 Dh 300).
//   - Each CTA computes the partial S (and dP; S^T and dP^T in dK/dV) of its
//     slice in f32 into its own shared memory; the cluster sums them. Every
//     element is summed once in one order -- over every CTA's partial in
//     rank order, slice 0 first, all the peers' loads in flight at once --
//     so the forward's S is bit for bit the S from which dQ recomputes P,
//     no atomics are needed and two runs are bitwise equal.
//   - Backward: after a cluster barrier each CTA sums its share of the
//     tile's elements (shared out in rank order), applies the mask and P =
//     exp(scale S - lse), dS = P (dP - delta), and writes P and dS, rounded
//     to the operand type, into its shared memory; after a second barrier
//     every CTA gathers the others' shares and applies its slice only: dQ
//     += dS K[:, slice], or dV += P^T dO[:, slice] and dK += dS^T Q[:, slice].
//   - Forward: a row's max and sum need the whole row, so the tile is
//     shared out by whole rows (64 / C a CTA, ragged where C does not
//     divide 64). After the first barrier the owner of a row sums it,
//     applies the scale and the mask, updates its running max m and
//     denominator l (f32, kept by the owner), and writes alpha = exp(m_old -
//     m_new) and P = exp(s - m_new), rounded to the operand type, into its
//     shared memory. After the second barrier every CTA gathers P, alpha
//     and l of the other rows, rescales its O slice by alpha and adds P
//     V[:, slice]. At the end each CTA divides its O slice by max(l, 1e-30)
//     and stores its columns below Dh; the owners write their rows' lse =
//     m + log(max(l, 1e-30)). Past 8 slices a CTA sums its partial over all
//     its slices before the exchange and holds an O accumulator for each,
//     so S is still computed once a tile in bf16 (float32 sweeps once a
//     slice: a second accumulator beside its S engine spilled).
//   - Every CTA of a cluster takes the same barriers (sweep bounds from the
//     cluster's (b*h, tile), never from the slice; clusters whose rows see
//     no key sweep nothing, store zeros and write an lse near NEG_INF), and
//     a last cluster barrier keeps each CTA's shared memory alive until no
//     peer reads it.
//   - bf16 products run on mma.sync fed by ldmatrix (8 warps, each 16 rows
//     and half the columns); float32 on exact FFMA register micro-tiles
//     read from shared memory as float4 (no TF32), each score of S and dP
//     four chains of a quarter of the slice, summed pairwise (the float32
//     worst element at dh 1100).
//
// Every design: inputs by strides ([B, L, H, Dh] with unit stride on Dh;
// the Hopper design also needs 16-byte aligned rows for its tensor maps);
// outputs contiguous [B, L, H, Dh]; lse and delta
// contiguous f32 [B*H, Lq]. Rounding points follow the JAX kernels: scores,
// softmax statistics and every accumulator are f32; P is rounded to the
// operand type before the P V and P^T dO products, dS before the dS K and
// dS^T Q products.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;
namespace cg = cooperative_groups;

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
  int per_cta;  // the cluster design: head-width slices a CTA owns
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

// ---- the cluster design: all three passes past head width 256 ---------------
//
// (the design: see the head of this file)

constexpr int kSlice = 128;        // head-width columns of one slice
constexpr int kClusterMax = 8;     // CTAs of a cluster (the portable limit)
constexpr int kClRows = 64;        // the CTA's fixed rows: queries (forward, dQ), keys (dK/dV)
constexpr int kClThreads = 256;    // 8 warps
template <typename T> struct ClTile;  // rows of the sweep's tiles: keys (dQ), queries (dK/dV)
template <> struct ClTile<bf16> { static constexpr int value = 64; };
template <> struct ClTile<float> { static constexpr int value = 32; };
template <typename T> struct ClFwdTile;  // keys of the forward's tiles
template <> struct ClFwdTile<bf16> { static constexpr int value = 128; };
template <> struct ClFwdTile<float> { static constexpr int value = 64; };
template <typename T> struct ClFwdAcc;  // forward: output slices a CTA accumulates in one sweep
template <> struct ClFwdAcc<bf16> { static constexpr int value = 2; };
template <> struct ClFwdAcc<float> { static constexpr int value = 1; };  // a second beside the S engine spilled

// Shared memory of one CTA: the two fixed tiles (Q and dO in dQ, K and V in
// dK/dV), a 2-stage ring of the two streamed tiles, the two f32 partials,
// P and/or dS in the operand type, and two stages of lse and delta rows.
template <typename T>
struct ClLayout {
  static constexpr int N = ClTile<T>::value;
  static constexpr int LD = kSlice + 16 / sizeof(T);  // slice tiles' row stride (16 bytes of padding)
  static constexpr int LDF = N + 4;                   // the f32 partials' row stride
  static constexpr int LDP = N + 16 / sizeof(T);      // P's and dS's row stride
  static constexpr size_t kFixed = (size_t)kClRows * LD * sizeof(T);
  static constexpr size_t kStream = (size_t)N * LD * sizeof(T);
  static constexpr size_t kPartial = (size_t)kClRows * LDF * 4;
  static constexpr size_t kOperand = (size_t)kClRows * LDP * sizeof(T);
  static constexpr size_t kRows = 2 * 2 * kClRows * 4;
  static constexpr size_t bytes(bool kv) {
    return 2 * kFixed + 4 * kStream + 2 * kPartial + (kv ? 2 : 1) * kOperand + kRows;
  }
};

// The forward's: Q's slice, a 2-stage ring of K and V, the f32 partial S,
// P in the operand type, and three rows of f32 row state (alpha, the
// running max m and denominator l).
template <typename T>
struct ClFwdLayout {
  static constexpr int N = ClFwdTile<T>::value;
  static constexpr int LD = ClLayout<T>::LD;
  static constexpr int LDF = N + 4;
  static constexpr int LDP = N + 16 / sizeof(T);
  static constexpr size_t kFixed = (size_t)kClRows * LD * sizeof(T);
  static constexpr size_t kStream = (size_t)N * LD * sizeof(T);
  static constexpr size_t kPartial = (size_t)kClRows * LDF * 4;
  static constexpr size_t kOperand = (size_t)kClRows * LDP * sizeof(T);
  static constexpr size_t kRows = 3 * kClRows * 4;
  static constexpr size_t bytes() { return kFixed + 4 * kStream + kPartial + kOperand + kRows; }
};

// Per-dtype product engines. bf16: mma.sync m16n8k16, warp w owning rows
// 16 (w % 4) and half w / 4 of the columns. float32: exact FFMA on register
// micro-tiles read from shared memory as float4.
template <typename T> struct ClFrag;
template <> struct ClFrag<bf16> {
  typedef float Parts[8][4];  // S then dP: 16 rows x 32 columns each of the 64 x 64 partials
  typedef float Acc[8][4];    // 16 rows x 64 columns of a 64 x 128 accumulator
};
template <> struct ClFrag<float> {
  typedef float Parts[8][8];  // rows rb + 8 i, 8 columns of S (warps 0-3) or dP (4-7), one quarter of k
  typedef float Acc[4][8];    // rows ty + 16 i, columns 4 tx + j and 64 + 4 tx + j
};

template <int A, int B>
__device__ __forceinline__ void fill0(float (&c)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) c[i][j] = 0.f;
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ldmatrix: four 8 x 8 bf16 matrices from shared memory, lane l giving the
// address of one 16-byte row (matrix l / 8); .trans transposes each.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p)));
}

// The A fragment of rows row0 .. row0 + 15, columns k0 .. k0 + 15 of a
// row-major tile (load_a's layout).
__device__ __forceinline__ void ldsm_a(FragA<bf16>& a, const bf16* s, int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm4(a.x, s + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// The B fragments of output columns n0 .. n0 + 7 (b[0]) and n0 + 8 .. n0 + 15
// (b[1]), reduction k0 .. k0 + 15, from a tile stored [n][k] (load_b_nk's
// layout) ...
__device__ __forceinline__ void ldsm_b_nk(FragB<bf16> (&b)[2], const bf16* s, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  uint32_t r[4];
  ldsm4(r, s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
  b[0].x[0] = r[0]; b[0].x[1] = r[1]; b[1].x[0] = r[2]; b[1].x[1] = r[3];
}

// ... and from a tile stored [k][n] (load_b_kn's layout).
__device__ __forceinline__ void ldsm_b_kn(FragB<bf16> (&b)[2], const bf16* s, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  uint32_t r[4];
  ldsm4_trans(r, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
  b[0].x[0] = r[0]; b[0].x[1] = r[1]; b[1].x[0] = r[2]; b[1].x[1] = r[3];
}

// c += the next kSlice terms of the partial S = A0 . B0^T and dP = A1 . B1^T
// (A: the 64 x kSlice fixed tiles, B: the N x kSlice streamed ones).
__device__ __forceinline__ void parts_add(float (&c)[8][4], const bf16* A0, const bf16* A1, const bf16* B0,
                                          const bf16* B1) {
  constexpr int LD = ClLayout<bf16>::LD;
  const int warp = threadIdx.x >> 5, wr = warp & 3, wc = warp >> 2;
#pragma unroll 2
  for (int kk = 0; kk < kSlice; kk += 16) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      FragA<bf16> a;
      ldsm_a(a, m ? A1 : A0, LD, 16 * wr, kk);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        FragB<bf16> b[2];
        ldsm_b_nk(b, m ? B1 : B0, LD, 32 * wc + 8 * j, kk);
        mma(c[4 * m + j], a, b[0]);
        mma(c[4 * m + j + 1], a, b[1]);
      }
    }
  }
}

// The forward's: c += the next kSlice terms of the partial S = A . B^T (A:
// Q's 64 x kSlice slice, B: K's N x kSlice), warp w owning rows 16 (w % 4)
// and columns 64 (w / 4) .. + 63 of the 64 x 128 tile. Each score is the
// chain parts_add gives it: the same k steps in the same order.
__device__ __forceinline__ void s_add(float (&c)[8][4], const bf16* A, const bf16* B) {
  constexpr int LD = ClLayout<bf16>::LD;
  const int warp = threadIdx.x >> 5, wr = warp & 3, wc = warp >> 2;
#pragma unroll 2
  for (int kk = 0; kk < kSlice; kk += 16) {
    FragA<bf16> a;
    ldsm_a(a, A, LD, 16 * wr, kk);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      FragB<bf16> b[2];
      ldsm_b_nk(b, B, LD, 64 * wc + 8 * j, kk);
      mma(c[j], a, b[0]);
      mma(c[j + 1], a, b[1]);
    }
  }
}

// float32: warp w computes partial w / 4 (S or dP) at columns 8 (w % 4) ..
// + 7 and every row; lane 4 rb + q owns rows rb + 8 i over a quarter of the
// slice's columns (float4 groups g with g % 8 in {2q, 2q + 1}: 16
// conflict-free float4 loads for 256 FMAs a step). The four quarters, four
// chains of 32 terms a score, are summed pairwise by parts_store: short
// chains keep the rounding of S and dP (and of dS = P (dP - delta), where
// dP and delta nearly cancel) within FLASH_TOL's float32 limit at dh 1100.
// ffma_add is the step both passes share: A points at the lane's row rb of
// the fixed tile, B at the warp's first column of the streamed one.
__device__ __forceinline__ void ffma_add(float (&c)[8][8], const float* A, const float* B) {
  constexpr int LD = ClLayout<float>::LD;
  const int q = threadIdx.x & 3;
#pragma unroll 1
  for (int st = 0; st < kSlice / 16; ++st) {
    const int k = 4 * (8 * (st >> 1) + 2 * q + (st & 1));
    float4 y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = *reinterpret_cast<const float4*>(B + j * LD + k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(A + 8 * i * LD + k);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j] = fmaf(lane4(x, e), lane4(y[j], e), c[i][j]);
    }
  }
}

__device__ __forceinline__ void parts_add(float (&c)[8][8], const float* A0, const float* A1, const float* B0,
                                          const float* B1) {
  constexpr int LD = ClLayout<float>::LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ffma_add(c, (warp >> 2 ? A1 : A0) + (lane >> 2) * LD, (warp >> 2 ? B1 : B0) + 8 * (warp & 3) * LD);
}

// The forward's (N = 64 keys): warp w computes S at columns 8 w .. + 7.
__device__ __forceinline__ void s_add(float (&c)[8][8], const float* A, const float* B) {
  constexpr int LD = ClLayout<float>::LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ffma_add(c, A + (lane >> 2) * LD, B + 8 * warp * LD);
}

// Stores this thread's share of the partial S and dP into this CTA's
// shared memory (row-major, row stride LDF).
__device__ __forceinline__ void parts_store(float (&c)[8][4], float* part0, float* part1) {
  constexpr int LDF = ClLayout<bf16>::LDF;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = 16 * (warp & 3) + (lane >> 2), col = 32 * (warp >> 2) + 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float* part = m ? part1 : part0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* f = c[4 * m + j];
      *reinterpret_cast<float2*>(part + row * LDF + col + 8 * j) = make_float2(f[0], f[1]);
      *reinterpret_cast<float2*>(part + (row + 8) * LDF + col + 8 * j) = make_float2(f[2], f[3]);
    }
  }
}

// The quarters' sums, (q0 + q1) + (q2 + q3) in every lane of the four
// (addition commutes: each lane gets the same bits); lane q stores rows
// rb + 8 i for i = 2q, 2q + 1 from `part` (at the lane's row rb and the
// warp's first column, row stride LDF).
template <int LDF>
__device__ __forceinline__ void quarters_store(float (&c)[8][8], float* part) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[i][j] += __shfl_xor_sync(kFull, c[i][j], 1);
      c[i][j] += __shfl_xor_sync(kFull, c[i][j], 2);
    }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i >> 1 != q) continue;
    *reinterpret_cast<float4*>(part + 8 * i * LDF) = make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
    *reinterpret_cast<float4*>(part + 8 * i * LDF + 4) = make_float4(c[i][4], c[i][5], c[i][6], c[i][7]);
  }
}

__device__ __forceinline__ void parts_store(float (&c)[8][8], float* part0, float* part1) {
  constexpr int LDF = ClLayout<float>::LDF;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  quarters_store<LDF>(c, (warp >> 2 ? part1 : part0) + (lane >> 2) * LDF + 8 * (warp & 3));
}

// The forward's partial S into this CTA's shared memory (row stride LDF).
__device__ __forceinline__ void s_store(float (&c)[8][4], float* part) {
  constexpr int LDF = ClFwdLayout<bf16>::LDF;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = 16 * (warp & 3) + (lane >> 2), col = 64 * (warp >> 2) + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(part + row * LDF + col + 8 * j) = make_float2(c[j][0], c[j][1]);
    *reinterpret_cast<float2*>(part + (row + 8) * LDF + col + 8 * j) = make_float2(c[j][2], c[j][3]);
  }
}

__device__ __forceinline__ void s_store(float (&c)[8][8], float* part) {
  constexpr int LDF = ClFwdLayout<float>::LDF;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  quarters_store<LDF>(c, part + (lane >> 2) * LDF + 8 * warp);
}

// acc[64 x kSlice] += Pm[64 x N] . B[N x kSlice] (Pm: P or dS in the operand
// type, row stride LDP): the backward's tiles by default, the forward's given.
template <int N = ClLayout<bf16>::N, int LDP = ClLayout<bf16>::LDP>
__device__ __forceinline__ void acc_add(float (&acc)[8][4], const bf16* Pm, const bf16* B) {
  constexpr int LD = ClLayout<bf16>::LD;
  const int warp = threadIdx.x >> 5, wr = warp & 3, wc = warp >> 2;
#pragma unroll
  for (int kk = 0; kk < N; kk += 16) {
    FragA<bf16> a;
    ldsm_a(a, Pm, LDP, 16 * wr, kk);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      FragB<bf16> b[2];
      ldsm_b_kn(b, B, LD, kk, 64 * wc + 8 * n);
      mma(acc[n], a, b[0]);
      mma(acc[n + 1], a, b[1]);
    }
  }
}

template <int N = ClLayout<float>::N, int LDP = ClLayout<float>::LDP>
__device__ __forceinline__ void acc_add(float (&acc)[4][8], const float* Pm, const float* B) {
  constexpr int LD = ClLayout<float>::LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 1
  for (int n = 0; n < N; n += 4) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(Pm + (ty + 16 * i) * LDP + n);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 y0 = *reinterpret_cast<const float4*>(B + (n + e) * LD + 4 * tx);
      const float4 y1 = *reinterpret_cast<const float4*>(B + (n + e) * LD + 64 + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = lane4(x[i], e);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(xv, lane4(y0, j), acc[i][j]);
          acc[i][4 + j] = fmaf(xv, lane4(y1, j), acc[i][4 + j]);
        }
      }
    }
  }
}

// Stores a CTA's 64 x kSlice accumulator (rows from row0, columns from col0
// of a contiguous [B, L, H, p.dh] output), times `mul`; rows past L and
// columns past p.dh are not stored.
__device__ __forceinline__ void acc_store(bf16* out, const float (&acc)[8][4], int b, int h, int row0, int L,
                                          const Params& p, int col0, float mul) {
  const int warp = threadIdx.x >> 5;
  store_rows<bf16, 64>(out, acc, b, h, row0 + 16 * (warp & 3), L, p, col0 + 64 * (warp >> 2), mul);
}

__device__ __forceinline__ void acc_store(float* out, const float (&acc)[4][8], int b, int h, int row0, int L,
                                          const Params& p, int col0, float mul) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= L) continue;
    float* dst = out + (((long long)b * L + row) * p.H + h) * p.dh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = col0 + 64 * half + 4 * tx;
      store_cols(dst, col, p.dh, acc[i][4 * half] * mul, acc[i][4 * half + 1] * mul);
      store_cols(dst, col + 2, p.dh, acc[i][4 * half + 2] * mul, acc[i][4 * half + 3] * mul);
    }
  }
}

// The forward's row-wise steps on a CTA's accumulator: each row times v[row]
// (the online softmax's rescale alpha) or, with DIV, over max(v[row], 1e-30)
// (the end's division by the denominator l).
template <bool DIV>
__device__ __forceinline__ void acc_rows(float (&acc)[8][4], const float* v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = 16 * (warp & 3) + (lane >> 2);
  const float v0 = v[row], v1 = v[row + 8];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = i >> 1 ? v1 : v0;
      acc[n][i] = DIV ? acc[n][i] / fmaxf(x, 1e-30f) : acc[n][i] * x;
    }
}

template <bool DIV>
__device__ __forceinline__ void acc_rows(float (&acc)[4][8], const float* v) {
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = v[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = DIV ? acc[i][j] / fmaxf(x, 1e-30f) : acc[i][j] * x;
  }
}

__device__ __forceinline__ void store4(bf16* dst, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack(v[0], v[1]), pack(v[2], v[3]));
}
__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void copy4(bf16* dst, const bf16* src) {
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
}
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

// 16 bytes from global to shared memory, asynchronously; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm90::smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Slice `chunk` (kSlice columns) of rows [row0, row0 + ROWS) of one (b, h)
// slice into shared memory (row stride ClLayout<T>::LD); rows at or past
// `rows` and columns at or past p.dh are zeros. By cp.async, 16 bytes a
// thread, where every row is whole 16-byte groups (p.vec; the caller
// commits and waits), else by plain loads one element at a time.
template <typename T, int ROWS>
__device__ __forceinline__ void load_slice(T* s, const T* src, long long row_stride, int row0, int rows, int chunk,
                                           const Params& p) {
  constexpr int LD = ClLayout<T>::LD;
  const int col0 = chunk * kSlice, cols = p.dh - col0;
  if (p.vec) {
    constexpr int kVec = 16 / sizeof(T), kPerRow = kSlice / kVec;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * kPerRow; i += kClThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kVec;
      const bool in = row0 + r < rows && c < cols;
      cp_async16(s + r * LD + c, in ? src + (long long)(row0 + r) * row_stride + col0 + c : src, in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * kSlice; i += kClThreads) {
      const int r = i / kSlice, c = i % kSlice;
      s[r * LD + c] = row0 + r < rows && c < cols ? src[(long long)(row0 + r) * row_stride + col0 + c] : zero<T>();
    }
  }
}

// out = the float4 at `own` in every CTA of the cluster, summed in rank
// order (slice 0 first); every peer's load in flight at once.
__device__ __forceinline__ void sum_peers(const cg::cluster_group& cluster, float (&out)[4], float* own, int C) {
  float4 a[kClusterMax];
#pragma unroll
  for (int q = 0; q < kClusterMax; ++q)
    if (q < C) a[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(own, q));
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = 0.f;
#pragma unroll
  for (int q = 0; q < kClusterMax; ++q)
    if (q < C)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] += lane4(a[q], e);
}

// The CTA of C that owns x of [0, total) shared out in rank order: CTA q
// owns [q total / C, (q + 1) total / C).
__device__ __forceinline__ int share_owner(int x, int total, int C) {
  int q = x * C / total;
  if ((q + 1) * total / C <= x) ++q;
  if (q * total / C > x) --q;
  return q;
}

// The max and sum of v over each aligned group of G lanes (a score row).
template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The dQ (KV false) and dK/dV (KV true) passes of the cluster design. The
// CTA's fixed tiles are the A operands of the partial products (Q and dO in
// dQ, K and V in dK/dV), the streamed tiles their B operands (K and V, Q and
// dO); partial 0 is S (S^T), partial 1 dP (dP^T).
template <typename T, bool KV>
__device__ __forceinline__ void cluster_bwd(const Params& p) {
  using Ly = ClLayout<T>;
  constexpr int R = kClRows, N = Ly::N, LD = Ly::LD, LDF = Ly::LDF, LDP = Ly::LDP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* fix0 = reinterpret_cast<T*>(smem);
  T* fix1 = fix0 + R * LD;
  T* ring = fix1 + R * LD;  // [stage][tile 0 or 1]
  float* part0 = reinterpret_cast<float*>(ring + 4 * N * LD);  // the partial S (S^T) and dP (dP^T)
  float* part1 = part0 + R * LDF;
  T* pm0 = reinterpret_cast<T*>(part1 + R * LDF);  // dS (dQ); P^T (dK/dV)
  T* pm1 = pm0 + R * LDP;                          // dS^T (dK/dV)
  float* rows = reinterpret_cast<float*>(pm0 + (KV ? 2 : 1) * R * LDP);  // [stage][lse, delta][R]
  auto stream = [&](int stage, int i) { return ring + (2 * stage + i) * N * LD; };

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int m = p.per_cta, n_chunks = (p.dh + kSlice - 1) / kSlice;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // the CTA's rows (dQ: longest causal sweeps first; dK/dV: the first key tiles have the longest)
  const int base = KV ? blockIdx.y * R : (gridDim.y - 1 - blockIdx.y) * R;
  const int t_begin = KV ? first_q_tile_needed(p, base, N) : 0;
  const int t_end = KV ? (p.Lq + N - 1) / N : k_tiles_needed(p, base, R, N);
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse_g = p.lse + (long long)bh * p.Lq;
  const float* delta_g = p.delta + (long long)bh * p.Lq;

  auto load_fixed = [&](int chunk) {
    load_slice<T, R>(fix0, KV ? K : Q, KV ? p.k_sl : p.q_sl, base, KV ? p.Lk : p.Lq, chunk, p);
    load_slice<T, R>(fix1, KV ? V : DO, KV ? p.v_sl : p.do_sl, base, KV ? p.Lk : p.Lq, chunk, p);
  };
  auto load_stream = [&](int stage, int tile, int chunk) {
    load_slice<T, N>(stream(stage, 0), KV ? Q : K, KV ? p.q_sl : p.k_sl, tile * N, KV ? p.Lq : p.Lk, chunk, p);
    load_slice<T, N>(stream(stage, 1), KV ? DO : V, KV ? p.do_sl : p.v_sl, tile * N, KV ? p.Lq : p.Lk, chunk, p);
  };
  // lse and delta of query rows [row0, row0 + count) into rows stage `stage`
  auto load_rows = [&](int stage, int row0, int count) {
    for (int i = threadIdx.x; i < count; i += kClThreads) {
      const int row = row0 + i;
      rows[2 * R * stage + i] = row < p.Lq ? lse_g[row] : 0.f;
      rows[2 * R * stage + R + i] = row < p.Lq ? delta_g[row] : 0.f;
    }
  };

  // The exchange of one tile, its partials stored. A tile's G groups of 4
  // elements are shared out in rank order: CTA q owns [q G / C, (q + 1) G /
  // C). After the first cluster barrier every partial is written; CTA r
  // sums its groups over every CTA's partials in rank order (slice 0
  // first), so every CTA gets the same S and dP and from them the same P
  // and dS, which it writes into its own shared memory. After the second
  // barrier every share is written and no CTA reads a partial any more (the
  // next tile's may be written); each CTA gathers the shares of the others.
  // Those reads end before it arrives at the next tile's first barrier,
  // before any share is written again.
  auto exchange = [&](int stage, int tile0) {
    constexpr int G = R * N / 4;
    const float* lse = rows + 2 * R * stage;
    const float* delta = lse + R;
    cluster.sync();
    for (int g = r * G / C + threadIdx.x; g < (r + 1) * G / C; g += kClThreads) {
      const int row = 4 * g / N, col = 4 * g % N;
      float sc[4], dp[4];
      sum_peers(cluster, sc, part0 + row * LDF + col, C);
      sum_peers(cluster, dp, part1 + row * LDF + col, C);
      float pw[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // dQ: rows are queries, columns keys; dK/dV: rows keys, columns queries
        const int qrow = KV ? tile0 + col + e : base + row, key = KV ? base + row : tile0 + col + e;
        const int ri = KV ? col + e : row;
        pw[e] = weight(masked(sc[e] * p.scale, qrow, key, p), lse[ri]);
        ds[e] = pw[e] * (dp[e] - delta[ri]);
      }
      if (KV) {
        store4(pm0 + row * LDP + col, pw);
        store4(pm1 + row * LDP + col, ds);
      } else {
        store4(pm0 + row * LDP + col, ds);
      }
    }
    cluster.sync();
    // the gather: every group of the tile outside this CTA's share, from its owner
#pragma unroll
    for (int i = 0; i < G / kClThreads; ++i) {
      const int g = i * kClThreads + threadIdx.x;
      const int q = share_owner(g, G, C);
      if (q == r) continue;
      const int off = (4 * g / N) * LDP + 4 * g % N;
      copy4(pm0 + off, cluster.map_shared_rank(pm0, q) + off);
      if (KV) copy4(pm1 + off, cluster.map_shared_rank(pm1, q) + off);
    }
    __syncthreads();
  };

  typename ClFrag<T>::Parts parts;  // this thread's share of the partial S and dP
  typename ClFrag<T>::Acc acc0, acc1;  // dQ; dK and dV
  // the products with P and dS: their B operands are the streamed tiles at `stage`
  auto apply = [&](int stage) {
    if (KV) {
      acc_add(acc1, pm0, stream(stage, 1));  // dV += P^T dO
      acc_add(acc0, pm1, stream(stage, 0));  // dK += dS^T Q
    } else {
      acc_add(acc0, pm0, stream(stage, 0));  // dQ += dS K
    }
  };
  auto store = [&](int chunk) {
    if (KV) {
      acc_store(static_cast<T*>(p.dk), acc0, b, h, base, p.Lk, p, chunk * kSlice, p.scale);
      acc_store(static_cast<T*>(p.dv), acc1, b, h, base, p.Lk, p, chunk * kSlice, 1.f);
    } else {
      acc_store(static_cast<T*>(p.dq), acc0, b, h, base, p.Lq, p, chunk * kSlice, p.scale);
    }
  };

  fill0(acc0);
  fill0(acc1);
  if (!KV) load_rows(0, base, R);
  if (m == 1) {
    // one slice a CTA: the fixed tiles load once, the streamed ones through
    // a 2-stage ring (the next tile's copies run beside this tile's work)
    load_fixed(r);
    if (t_begin < t_end) {
      load_stream(0, t_begin, r);
      if (KV) load_rows(0, t_begin * N, N);
    }
    cp_async_commit();
    for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
      const int s = it & 1;
      if (t + 1 < t_end) {
        load_stream(s ^ 1, t + 1, r);
        if (KV) load_rows(s ^ 1, (t + 1) * N, N);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      fill0(parts);
      parts_add(parts, fix0, fix1, stream(s, 0), stream(s, 1));
      parts_store(parts, part0, part1);
      exchange(KV ? s : 0, t * N);
      apply(s);
      __syncthreads();  // stage s is free for the copies of tile t + 2
    }
    cp_async_wait<0>();
    cluster.sync();  // no CTA leaves while a peer may still read its shared memory
    store(r);
    return;
  }
  // per_cta slices a CTA (past kClusterMax slices): one sweep for each
  // slice it owns, each tile's partial summed over all its slices (their
  // tiles loaded one after another through stage 0); the slice the sweep
  // accumulates has its B operands in stage 1
  const int first = r * m, last = min(first + m, n_chunks);
  for (int j = 0; j < m; ++j) {
    const int o = first + j;
    for (int t = t_begin; t < t_end; ++t) {
      __syncthreads();  // every warp is done with the last tile's stages
      if (o < n_chunks) load_stream(1, t, o);
      if (KV) load_rows(0, t * N, N);
      fill0(parts);
      for (int c = first; c < last; ++c) {
        if (c > first) __syncthreads();
        load_fixed(c);
        load_stream(0, t, c);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        parts_add(parts, fix0, fix1, stream(0, 0), stream(0, 1));
      }
      parts_store(parts, part0, part1);
      exchange(0, t * N);
      if (o < n_chunks) apply(1);
    }
    if (o < n_chunks) store(o);
    fill0(acc0);
    fill0(acc1);
  }
  cluster.sync();
}

template <typename T>
__global__ void __launch_bounds__(kClThreads, 1) flash_dq_cluster_kernel(const Params p) {
  cluster_bwd<T, false>(p);
}

template <typename T>
__global__ void __launch_bounds__(kClThreads, 1) flash_dkdv_cluster_kernel(const Params p) {
  cluster_bwd<T, true>(p);
}

// The forward of the cluster design: one cluster a (b*h, 64-row query tile),
// CTA r owning slice r of Dh (the first per_cta slices from r per_cta past
// kClusterMax slices). A key tile's step: every CTA's partial S over its
// slices into its own shared memory; a cluster barrier; each CTA, for the
// rows it owns (shared out in rank order, whole rows, as share_owner), sums
// the row over every CTA's partial in rank order (slice 0 first, as
// cluster_bwd's dQ sums it: the same S, bit for bit), applies the scale and
// the mask, updates the row's m and l, and writes P in the operand type and
// alpha = exp(m_old - m_new) into its own shared memory; a second barrier;
// each CTA gathers P, alpha and l of the rows it does not own from their
// owners, rescales its O slice by alpha and adds P V[:, slice]. At the end
// each CTA divides its O slice by max(l, 1e-30) and stores it; the owners
// write their rows' lse. Sweep bounds come from the cluster's (b*h, tile):
// every CTA takes the same barriers. MULTI: a CTA owns more than one slice
// (per_cta > 1), an instance of its own so that its registers do not
// weigh on the one-slice sweep's (one kernel holding both spilled).
template <typename T, bool MULTI>
__global__ void __launch_bounds__(kClThreads, 1) flash_fwd_cluster_kernel(const Params p) {
  using Ly = ClFwdLayout<T>;
  constexpr int R = kClRows, N = Ly::N, LD = Ly::LD, LDF = Ly::LDF, LDP = Ly::LDP;
  constexpr int G = N / 4;                 // float4 groups of a score row: the lanes that own it
  constexpr int kRowsPass = kClThreads / G;
  constexpr int U = N * (int)sizeof(T) / 16;  // 16-byte units of a row of P
  static_assert(R * U % kClThreads == 0, "P's gather: whole units a thread");
  static_assert(N == (sizeof(T) == 2 ? 128 : 64), "s_add's 8 warps cover the tile's keys");
  extern __shared__ __align__(16) unsigned char smem[];
  T* fix = reinterpret_cast<T*>(smem);                         // Q's slice
  T* ring = fix + R * LD;                                      // [stage][K, V]
  float* part = reinterpret_cast<float*>(ring + 4 * N * LD);  // this CTA's partial S
  T* pm = reinterpret_cast<T*>(part + R * LDF);               // P
  float* alpha = reinterpret_cast<float*>(pm + R * LDP);      // O's rescale this tile, by row
  float* mrow = alpha + R;                                     // the running max (owned rows)
  float* lrow = mrow + R;                                      // the running denominator
  auto stream = [&](int stage, int i) { return ring + (2 * stage + i) * N * LD; };

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int m = p.per_cta, n_chunks = (p.dh + kSlice - 1) / kSlice;
  const int first = r * m, last = min(first + m, n_chunks);
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;  // longest causal sweeps first
  const int n_k = k_tiles_needed(p, q0, R, N);
  const int own0 = r * R / C, own1 = (r + 1) * R / C;  // the rows this CTA owns
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int i = threadIdx.x; i < R; i += kClThreads) {
    mrow[i] = kNegInf;
    lrow[i] = 0.f;
  }

  // The exchange of key tile k0, every partial stored; `fresh`: the first
  // tile of a sweep (m and l start anew). The owner's reads of m and l come
  // before the row's shuffles, its writes after them.
  auto exchange = [&](int k0, bool fresh) {
    cluster.sync();  // every CTA's partial of this tile is written
    for (int i0 = own0; i0 < own1; i0 += kRowsPass) {
      const int i = i0 + threadIdx.x / G, g = threadIdx.x % G;
      const bool own = i < own1;
      const float m_old = own && !fresh ? mrow[i] : kNegInf;
      const float l_old = own && !fresh ? lrow[i] : 0.f;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (own) sum_peers(cluster, x, part + i * LDF + 4 * g, C);
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = own ? masked(x[e] * p.scale, q0 + i, k0 + 4 * g + e, p) : kNegInf;
        mx = fmaxf(mx, x[e]);
      }
      const float mn = fmaxf(m_old, group_max<G>(mx));
      float rs = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = weight(x[e], mn);
        rs += x[e];
      }
      rs = group_sum<G>(rs);
      if (own) {
        store4(pm + i * LDP + 4 * g, x);  // P rounded to the operand type
        if (g == 0) {
          const float a = expf(fminf(m_old - mn, 0.f));
          alpha[i] = a;
          mrow[i] = mn;
          lrow[i] = a * l_old + rs;
        }
      }
    }
    cluster.sync();  // every owner's rows are written; no partial is read any more
    // the gather: every row outside this CTA's share, from its owner; these
    // reads end before this CTA arrives at the next tile's first barrier
#pragma unroll
    for (int k = 0; k < R * U / kClThreads; ++k) {
      const int u = k * kClThreads + threadIdx.x, i = u / U;
      const int q = share_owner(i, R, C);
      if (q == r) continue;
      const int off = i * LDP + (u % U) * (16 / (int)sizeof(T));
      *reinterpret_cast<uint4*>(pm + off) = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(pm, q) + off);
    }
    if (threadIdx.x < R) {
      const int q = share_owner(threadIdx.x, R, C);
      if (q != r) {
        alpha[threadIdx.x] = *cluster.map_shared_rank(alpha + threadIdx.x, q);
        lrow[threadIdx.x] = *cluster.map_shared_rank(lrow + threadIdx.x, q);
      }
    }
    __syncthreads();
  };

  typename ClFrag<T>::Parts sc;  // this thread's share of the partial S
  typename ClFrag<T>::Acc acc[ClFwdAcc<T>::value];
  // O of slice `chunk` over max(l, 1e-30), its columns below p.dh stored
  auto finish = [&](typename ClFrag<T>::Acc& o, int chunk) {
    acc_rows<true>(o, lrow);
    acc_store(static_cast<T*>(p.out), o, b, h, q0, p.Lq, p, chunk * kSlice, 1.f);
  };

  if constexpr (!MULTI) {
    // one slice a CTA: Q's slice loads once, K and V stream through a
    // 2-stage ring (the next tile's copies run beside this tile's work)
    fill0(acc[0]);
    load_slice<T, R>(fix, Q, p.q_sl, q0, p.Lq, r, p);
    if (n_k > 0) {
      load_slice<T, N>(stream(0, 0), K, p.k_sl, 0, p.Lk, r, p);
      load_slice<T, N>(stream(0, 1), V, p.v_sl, 0, p.Lk, r, p);
    }
    cp_async_commit();
    for (int t = 0; t < n_k; ++t) {
      const int s = t & 1;
      if (t + 1 < n_k) {
        load_slice<T, N>(stream(s ^ 1, 0), K, p.k_sl, (t + 1) * N, p.Lk, r, p);
        load_slice<T, N>(stream(s ^ 1, 1), V, p.v_sl, (t + 1) * N, p.Lk, r, p);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      fill0(sc);
      s_add(sc, fix, stream(s, 0));
      s_store(sc, part);
      exchange(t * N, t == 0);
      acc_rows<false>(acc[0], alpha);
      acc_add<N, LDP>(acc[0], pm, stream(s, 1));  // O += P V[:, slice]
      __syncthreads();  // stage s is free for the copies of tile t + 2
    }
    cp_async_wait<0>();
    __syncthreads();  // every row's l is in lrow (0 where no tile was swept)
    finish(acc[0], r);
  } else {
    // per_cta slices a CTA (past kClusterMax slices): each tile's partial
    // summed over all its slices (their Q and K slices loaded one after
    // another through the fixed tile and stage 0), so S is computed once a
    // tile for up to A output slices (in stage 1's V tiles); a CTA with
    // more sweeps the keys once for each A of them, m and l anew each
    // time. Every CTA takes the cluster's number of sweeps.
    constexpr int A = ClFwdAcc<T>::value;
    const int sweeps = (m + A - 1) / A;
    for (int sw = 0; sw < sweeps; ++sw) {
      const int a0 = first + sw * A;
#pragma unroll
      for (int j = 0; j < A; ++j) fill0(acc[j]);
      for (int t = 0; t < n_k; ++t) {
        __syncthreads();  // every warp is done with the last tile's stages
#pragma unroll
        for (int j = 0; j < A; ++j)
          if (a0 + j < last) load_slice<T, N>(stream(1, j), V, p.v_sl, t * N, p.Lk, a0 + j, p);
        fill0(sc);
        for (int c = first; c < last; ++c) {
          if (c > first) __syncthreads();
          load_slice<T, R>(fix, Q, p.q_sl, q0, p.Lq, c, p);
          load_slice<T, N>(stream(0, 0), K, p.k_sl, t * N, p.Lk, c, p);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          s_add(sc, fix, stream(0, 0));
        }
        s_store(sc, part);
        exchange(t * N, t == 0);
#pragma unroll
        for (int j = 0; j < A; ++j)
          if (a0 + j < last) {
            acc_rows<false>(acc[j], alpha);
            acc_add<N, LDP>(acc[j], pm, stream(1, j));
          }
      }
      __syncthreads();  // every row's l is in lrow
#pragma unroll
      for (int j = 0; j < A; ++j)
        if (a0 + j < last) finish(acc[j], a0 + j);
    }
  }
  for (int i = own0 + threadIdx.x; i < own1; i += kClThreads)
    if (q0 + i < p.Lq) p.lse[(long long)bh * p.Lq + q0 + i] = mrow[i] + logf(fmaxf(lrow[i], 1e-30f));
  cluster.sync();  // no CTA leaves while a peer may still read its shared memory
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

template <typename Kernel>
int launch_cluster(Kernel kernel, const cudaLaunchConfig_t& cfg, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
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

// The cluster design, all three passes: the forward (which 0), dQ (1) and
// dK/dV (2) on a (b*h, 64-row tile, slice) grid whose slices on z form one
// cluster. n slices of kSlice columns cover dh; a CTA owns per_cta =
// ceil(n / kClusterMax) of them (1 up to dh 1024), so a cluster is
// ceil(n / per_cta) <= kClusterMax CTAs. Returns the occupancy query's
// error, or cudaErrorInvalidConfiguration where no such cluster fits on the
// card, rather than launch a grid that cannot be scheduled.
template <typename T>
int run_cluster(int which, const Params& p0, int BH, cudaStream_t stream) {
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  Params p = p0;
  const int n = (p.dh + kSlice - 1) / kSlice;
  p.per_cta = (n + kClusterMax - 1) / kClusterMax;
  const int cluster = (n + p.per_cta - 1) / p.per_cta;
  const int tiles = ((which == 2 ? p.Lk : p.Lq) + kClRows - 1) / kClRows;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH, tiles, cluster);
  cfg.blockDim = dim3(kClThreads);
  cfg.dynamicSmemBytes = which == 0 ? ClFwdLayout<T>::bytes() : ClLayout<T>::bytes(which == 2);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (which == 0)
    return p.per_cta > 1 ? launch_cluster(flash_fwd_cluster_kernel<T, true>, cfg, p)
                         : launch_cluster(flash_fwd_cluster_kernel<T, false>, cfg, p);
  return which == 1 ? launch_cluster(flash_dq_cluster_kernel<T>, cfg, p)
                    : launch_cluster(flash_dkdv_cluster_kernel<T>, cfg, p);
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
// built width of 32, 64, 128 and 256 at or above dh, and the cluster design
// past 256 (all three passes); bfloat16 rows of whole 16-byte groups (dh % 8
// == 0) at 64 and 128 take the Hopper design where the views fit its tensor
// maps (tma_fits), every other width and view the mma.sync design at the
// same width. ops/attention.py restates this as kernel_width, KERNEL_DESIGNS
// and kernel_design; the CPU tests pin them together.
int run_dtype(int which, int dtype, int dh, const Params& p, int B, cudaStream_t stream) {
  const int BH = B * p.H;
  const bool tma = tma_fits(p);
  if (dtype == 1) {
    if (dh <= 32) return run_mma<bf16, 32>(which, p, BH, stream);
    if (dh <= 64) return dh % 8 == 0 && tma ? run_sm90<64>(which, p, B, stream) : run_mma<bf16, 64>(which, p, BH, stream);
    if (dh <= 128) return dh % 8 == 0 && tma ? run_sm90<128>(which, p, B, stream) : run_mma<bf16, 128>(which, p, BH, stream);
    if (dh <= 256) return run_mma<bf16, 256>(which, p, BH, stream);
    return run_cluster<bf16>(which, p, BH, stream);
  } else if (dtype == 0) {
    if (dh <= 32) return run_mma<float, 32>(which, p, BH, stream);
    if (dh <= 64) return run_mma<float, 64>(which, p, BH, stream);
    if (dh <= 128) return run_mma<float, 128>(which, p, BH, stream);
    if (dh <= 256) return run_mma<float, 256>(which, p, BH, stream);
    return run_cluster<float>(which, p, BH, stream);
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
  p.per_cta = 1;
  const int size = dtype == 1 ? 2 : 4;
  p.vec = rows_of_16(q, strides, dh, size) && rows_of_16(k, strides + 3, dh, size) &&
          rows_of_16(v, strides + 6, dh, size) && rows_of_16(dout, strides + 9, dh, size);
  return run_dtype(which, dtype, dh, p, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
