// K4 pooled_attention: out = softmax((q * scale) K^T + bias) V per head,
// head outputs rounded to bf16, then + q (residual pooling) in bf16.
//
// Replaces svit_tpu/ops/pallas_attention.py _attn_kernel (pooled_attention,
// reached by fused_attention_proj), launched twice per block: the grid
// queries with the decomposed rel-pos bias, and the cls + object queries
// with none.  The TPU kernel's out-projection epilogue is a separate K1
// launch here (ln_linear.cu, round then + bias in bf16).
//
// K5 pooled_attention_bwd replaces _attn_bwd_kernel (pooled_attention_bwd,
// pallas_attention.py:317-491) and computes what it computes, per head:
//   P = softmax((q * scale) K^T + bias) in f32 (recomputed),
//   dP = dO V^T, delta = rowsum(dP o P), dS = P o (dP - delta),
//   dq = round(dS) K * scale,  dK = round(dS)^T (q * scale),
//   dV = round(P)^T dO,  dbias = dS M^T (JAX's f32 product with the one-hot
//   map), rounded to bf16; with q_residual, dq += dO in bf16.
//
// What bounds them on the H100: the products on the tensor cores (4 Nq Nk
// head_dim flops per head forward, 10 backward at 989 TFLOP/s bf16),
// against q, kv, the bias rows and the outputs in device memory.
//
// The rel-pos bias is a product, as on the TPU (bias_src @ M): the block's
// bias rows [rows, R] (R = kT + kH + kW, padded with zeros to RP = 16 RK)
// times the key tile's rows of the one-hot map M^T [Nk, RP] (for patch key
// j ones at columns t, kT + h, kT + kH + w; zero rows for the extras keys and
// the padding), built once per (k_shape, Nk) by the host (ops/attention.py)
// and stored tile by tile in the no-swizzle core-matrix order: extra wgmma
// k-steps on the same f32 accumulator as QK^T.  The one-hot factor is exact
// in bf16, so the logits differ from a gather only in the order of f32
// additions.  Keys >= Nk are masked to -inf by index in the last key tile.
//
// Design, both kernels (sm_90a): one producer warp (its lane 0) issues every
// TMA load (3-D tensor maps over [B, N, C] and [B, Nk, 2C], so a tile never
// reads the next clip's rows: they are zero-filled; 64-byte swizzled boxes
// of 32 columns, head_dim 64, 96 or 128 being two to four of them) into a
// ring of slots with a full and an empty mbarrier each; one consumer
// warpgroup of 64 rows runs wgmma (A from shared memory or, for P and dS,
// from registers, as FlashAttention-3 does) with the accumulators in
// registers; a row's scores sit in the four threads of a quad, as with
// mma.sync, so the row reductions are quad shuffles.  The bias rows are
// 2R bytes each, no TMA box: the consumers write them once per block into
// shared memory, the A operand of the bias product (the query side also
// stores that tile for the key side, which takes it by bulk copy as the B
// operand).  Every rounding of the plain twin is kept:
// q scaled in bf16 (the scale rounded first), P rounded before the PV
// product, head outputs rounded then + q, dS rounded before dq and dK, dq
// rounded after * scale then + dO.  Two consumer warpgroups per block (128
// rows sharing each tile) were tried: no faster forward, and the key side's
// four accumulators do not fit 288 threads' registers without spilling.
//
// K4: a block per 64 query rows takes its q tile once by TMA and scales it
// in place; K | V | one-hot tiles of 64 keys stream through the ring; per
// tile S = Q_s K^T + bias M^T, the online softmax, O += round(P) V with V's
// descriptor MN-major.  The epilogue divides by l, rounds, adds q.
//
// K5, three launches with no atomics (blocks run in no order):
//   A (query side, a block per 64 query rows): pass 1 over the key tiles
//     takes S and dP and the online row max, sum and delta; pass 2 takes them
//     again, forms P and dS in registers and accumulates dq += round(dS) K
//     and dbias += dS M with dS split into round(dS) + round(dS - round(dS))
//     (two bf16 products against the exact one-hot keep about 16 bits of the
//     f32 dS; the accumulation is f32).  A dbias row is complete inside one
//     block.  It writes dq, dbias, and for B the row statistics (max, 1 /
//     sum, delta), q * scale (by TMA store from its q tile) and its bias tile
//     (by bulk store).
//   B (key side, a block per 64 keys, K, V and one-hot rows resident): the
//     producer streams q * scale, dO, the statistics and the bias tile per
//     64-query tile of its query split; S^T = K Q_s^T + M bias^T and dP^T = V dO^T,
//     then P^T and dS^T from the statistics, dV += round(P^T) dO and dK +=
//     round(dS^T) Q_s.  One split writes bf16 dK | dV; several write f32
//     partials that
//   C adds in split order and rounds.
#include "hopper.cuh"

namespace {

constexpr int SMEM_BLOCK_MAX = 232448;  // dynamic shared memory of a block
constexpr int BK = 64;  // keys (or queries) per tile, rows per warpgroup
// the bias product's k-steps for a key grid with 48 < kT + kH + kW <= 128
// (a block without k|v pooling: 8 + 56 + 56 at 224 px); its one-hot and
// bias tiles are 16 KB each and K5's query side keeps 64 more f32 dbias
// accumulators a thread
constexpr int RK_WIDE = 8;
// ... and for 128 < kT + kH + kW <= 256 (a block without k|v pooling at 256
// px or more: 8 + 64 + 64): two 128-column chunks.  The scores take all 16
// k-steps; K5's query side takes dbias one chunk at a time, over one more
// pass of the key tiles per chunk, so it keeps RK_WIDE's 64 accumulators
constexpr int RK_CHUNKED = 16;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory addresses of the operands (see hopper.cuh for the layouts).
// A tile of ``rows`` rows by HD columns: HD / 32 swizzled boxes of rows x 64
// bytes.  K-major (K = HD) at k16 step kk:
__device__ __forceinline__ uint64_t tile_k(uint32_t base, int rows, int kk) {
  return desc_sw64_k(base + (kk >> 1) * rows * 64 + (kk & 1) * 32);
}

// MN-major (N = HD, K = rows) at k16 step kk (rows 16 kk .. 16 kk + 15)
__device__ __forceinline__ uint64_t tile_mn(uint32_t base, int rows, int kk) {
  return desc_sw64_mn(base + kk * 1024, rows * 64);
}

// A one-hot or bias tile [RP / 8][rows][8]: K-major (K = RP) at k-step kr
__device__ __forceinline__ uint64_t onehot_k(uint32_t base, int rows, int kr) {
  return desc_plain(base + kr * 2 * rows * 16, rows * 16, 128);
}

// ... and MN-major (N = RP, K = rows) at k-step kk
__device__ __forceinline__ uint64_t onehot_mn(uint32_t base, int rows, int kk) {
  return desc_plain(base + kk * 256, 128, rows * 16);
}

// k16 step kk of a 64 x N accumulator as a bf16 A fragment (rounded)
template <int N>
__device__ __forceinline__ void frag_of(const float (&d)[N], int kk,
                                        uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// rows q0 .. q0 + 63 of one (clip, head)'s bias [Nq, R] into a [RP / 8][64][8]
// tile (the one-hot tiles' order), zero past R and past Nq, by the 128
// consumer threads (a bias row is 2R bytes: no TMA box)
template <int RP>
__device__ __forceinline__ void bias_tile(uint8_t* tile, const bf16* rows,
                                          int R, int Nq, int q0, int tid) {
  const unsigned short* src = reinterpret_cast<const unsigned short*>(rows);
  for (int cell = tid; cell < 64 * RP / 8; cell += 128) {
    const int r = cell % 64, c = cell / 64, q = q0 + r;
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = 8 * c + 2 * k;
      uint32_t lo = 0, hi = 0;
      if (q < Nq) {
        if (col < R) lo = __ldg(src + (size_t)q * R + col);
        if (col + 1 < R) hi = __ldg(src + (size_t)q * R + col + 1);
      }
      w[k] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(tile + c * 1024 + r * 16) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// q * scale (bf16, the scale rounded to bf16) in place on a 64-row tile:
// elementwise, so the swizzle does not matter
template <int HD>
__device__ __forceinline__ void scale_tile(uint8_t* tile, float scale,
                                           int tw) {
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    uint4* cell = reinterpret_cast<uint4*>(tile) + tw + 128 * k;
    float v[8];
    unpack8(*cell, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] *= scale;
    *cell = pack8(v);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// keys >= Nk of a key tile to -inf (the accumulator's columns are keys)
template <int N>
__device__ __forceinline__ void mask_keys(float (&s)[N], int k0, int Nk,
                                          int t) {
  if (k0 + N * 2 <= Nk) return;
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + 8 * j + 2 * t + (e & 1) >= Nk) s[4 * j + e] = -INFINITY;
}

// ---------------------------------------------------------------------------
// K4: the forward
// ---------------------------------------------------------------------------

struct FwdParams {
  const bf16* q;     // [B, Nq, C], for the residual
  const bf16* bias;  // [B, heads, Nq, R] or null
  const bf16* mt;    // one-hot tiles [n_kt][RP / 8][BK][8] or null
  bf16* out;
  int B, Nq, Nk, C, heads, R;
  float scale;
  int q_residual, stages, n_kt;
};

// Shared memory: [q tile (64 x HD)][bias tile (64 x RP)][ring: stages x (K |
// V tile (64 x HD each) | one-hot tile (64 x RP))][full | empty per slot,
// q]; every part a multiple of 1024 bytes.
// ops/attention.py:attention_smem mirrors it.
template <int HD, int RK>
__global__ void __launch_bounds__(160, 1)
    attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_kv, FwdParams p) {
  constexpr int QT = 64 * HD * 2, KT = BK * HD * 2, MT = BK * 16 * RK * 2;
  constexpr int BT = 64 * 16 * RK * 2, SLOT = 2 * KT + MT;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* ring = smem + QT + BT;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * SLOT);
  uint64_t* empty = full + p.stages;
  uint64_t* q_bar = empty + p.stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_bar, QT);
      for (int c = 0; c < HD / 32; ++c)
        tma_load_3d(smem + c * 64 * 64, &tm_q, q_bar, h * HD + 32 * c, q0, b);
      for (int i = 0; i < p.n_kt; ++i) {
        const int s = i % p.stages;
        mbar_wait(&empty[s], ((i / p.stages) & 1) ^ 1);  // the slot is free
        uint8_t* dst = ring + s * SLOT;
        mbar_expect_tx(&full[s], SLOT);
        for (int c = 0; c < HD / 32; ++c) {
          tma_load_3d(dst + c * BK * 64, &tm_kv, &full[s], h * HD + 32 * c,
                      i * BK, b);
          tma_load_3d(dst + KT + c * BK * 64, &tm_kv, &full[s],
                      p.C + h * HD + 32 * c, i * BK, b);
        }
        if (RK) bulk_load(dst + 2 * KT, p.mt + (size_t)i * BK * 16 * RK, MT,
                          &full[s]);
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp + g;  // this thread's rows r0, r0 + 8
  uint8_t* myb = smem + QT;
  if (RK)  // the bias rows, once per block, as the A operand of its product
    bias_tile<16 * RK>(myb, p.bias + ((size_t)b * p.heads + h) * p.Nq * p.R,
                       p.R, p.Nq, q0, tid);
  mbar_wait(q_bar, 0);
  scale_tile<HD>(smem, round_bf16(p.scale), tid);
  fence_async_smem();  // generic writes, then wgmma reads the tiles
  bar_sync<2, 128>();
  const uint32_t qa = smem_u32(smem), ba = smem_u32(myb);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int i = 0; i < p.n_kt; ++i) {
    const int s = i % p.stages;
    mbar_wait(&full[s], (i / p.stages) & 1);
    __syncwarp();  // wgmma is .aligned: the warp converged after the spin
    const uint32_t ka = smem_u32(ring + s * SLOT), va = ka + KT, ma = va + KT;
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(sc, tile_k(qa, 64, kk), tile_k(ka, BK, kk), kk > 0);
#pragma unroll
    for (int kr = 0; kr < RK; ++kr)
      wgmma_ss(sc, onehot_k(ba, 64, kr), onehot_k(ma, BK, kr), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    mask_keys(sc, i * BK, p.Nk, t);

    // online softmax: a row's scores live in the 4 threads of a quad
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h2], sc[4 * j + 2 * h2 + 1]));
      const float m_new = fmaxf(m_run[h2], quad_max(mx));  // key i*BK < Nk
      const float alpha = ex2((m_run[h2] - m_new) * LOG2E);
      const float mb = m_new * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sc[4 * j + 2 * h2 + e];
          v = ex2(fmaf(v, LOG2E, -mb));
          sum += v;
        }
      l_run[h2] = l_run[h2] * alpha + quad_sum(sum);
      m_run[h2] = m_new;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 2 * h2] *= alpha;
        o[4 * j + 2 * h2 + 1] *= alpha;
      }
    }

    // O += round(P) V: P from registers, V's descriptor MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      frag_of(sc, kk, a);
      wgmma_rs(o, a, tile_mn(va, BK, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    mbar_arrive_if(lane == 0, &empty[s]);  // the products have read the slot
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int q = r0 + 8 * h2;
    if (q >= p.Nq) continue;
    const size_t base = ((size_t)b * p.Nq + q) * p.C + h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int d = 8 * j + 2 * t;
      float v0 = round_bf16(o[4 * j + 2 * h2] / l_run[h2]);
      float v1 = round_bf16(o[4 * j + 2 * h2 + 1] / l_run[h2]);
      if (p.q_residual) {
        const float2 qq = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.q + base + d));
        v0 += qq.x;
        v1 += qq.y;
      }
      *reinterpret_cast<uint32_t*>(p.out + base + d) = pack_bf16(v0, v1);
    }
  }
}

// ---------------------------------------------------------------------------
// K5: the backward
// ---------------------------------------------------------------------------

struct BwdParams {
  const bf16* q;     // [B, Nq, C]
  const bf16* bias;  // [B, heads, Nq, R] or null
  const bf16* dout;  // [B, Nq, C]
  const bf16* mt;    // one-hot tiles [n_kt][RP / 8][64][8] or null
  bf16* dq;
  bf16* dkv;         // [B, Nk, 2C]
  bf16* dbias;       // [B, heads, Nq, R] or null
  float* stats;      // [B, heads, nq_pad, 4]: row max, 1 / row sum, delta
  float* partial;    // [splits, B, Nk, 2C] (splits > 1)
  bf16* bias_tiles;  // [B, heads, q_tiles, RP / 8, 64, 8] or null
  int B, Nq, Nk, C, heads, R;
  float scale;
  int q_residual, nq_pad, n_kt, q_stages, kv_stages, splits, tiles_per_split;
};

// A, the query side.  Shared memory: [q tile | dO tile (64 x HD each)][bias
// tile (64 x RP)][ring: stages x (K | V tile (64 x HD each) | one-hot tile
// (64 x RP))][full | empty per slot, q].  The ring carries the key tiles twice, for
// pass 1 and pass 2.
template <int HD, int RK>
__global__ void __launch_bounds__(160, 1)
    attn_bwd_q_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_kv,
                      const __grid_constant__ CUtensorMap tm_qs,
                      BwdParams p) {
  constexpr int RP = 16 * RK, QT = 64 * HD * 2, KT = BK * HD * 2;
  constexpr int MT = BK * RP * 2, BT = 64 * RP * 2, SLOT = 2 * KT + MT;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* ring = smem + 2 * QT + BT;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.q_stages * SLOT);
  uint64_t* empty = full + p.q_stages;
  uint64_t* q_bar = empty + p.q_stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // 128-column chunks of dbias (ops/attention.py:chunks), k-steps of one
  constexpr int NCH = RK > RK_WIDE ? RK / RK_WIDE : 1;
  constexpr int RKC = RK / NCH, NB = RKC > 0 ? 8 * RKC : 8;
  static_assert(RK % NCH == 0, "whole chunks");
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  // pass 1, then one pass per dbias chunk (the first also takes dq)
  const int stages = p.q_stages, loads = (1 + NCH) * p.n_kt;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_bar, 2 * QT);
      for (int c = 0; c < HD / 32; ++c) {
        tma_load_3d(smem + c * 64 * 64, &tm_q, q_bar, h * HD + 32 * c, q0, b);
        tma_load_3d(smem + QT + c * 64 * 64, &tm_do, q_bar, h * HD + 32 * c,
                    q0, b);
      }
      for (int i = 0; i < loads; ++i) {
        const int s = i % stages, kt = i % p.n_kt;
        mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        uint8_t* dst = ring + s * SLOT;
        mbar_expect_tx(&full[s], SLOT);
        for (int c = 0; c < HD / 32; ++c) {
          tma_load_3d(dst + c * BK * 64, &tm_kv, &full[s], h * HD + 32 * c,
                      kt * BK, b);
          tma_load_3d(dst + KT + c * BK * 64, &tm_kv, &full[s],
                      p.C + h * HD + 32 * c, kt * BK, b);
        }
        if (RK) bulk_load(dst + 2 * KT, p.mt + (size_t)kt * BK * RP, MT,
                          &full[s]);
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp + g;  // this thread's rows r0, r0 + 8
  uint8_t* myb = smem + 2 * QT;
  if (RK)
    bias_tile<RP>(myb, p.bias + ((size_t)b * p.heads + h) * p.Nq * p.R, p.R,
                  p.Nq, q0, tid);
  mbar_wait(q_bar, 0);
  scale_tile<HD>(smem, round_bf16(p.scale), tid);
  fence_async_smem();
  bar_sync<2, 128>();
  if (tid == 0) {  // q * scale and the bias tile leave once, for the key side
    for (int c = 0; c < HD / 32; ++c)
      tma_store_3d(&tm_qs, smem + c * 64 * 64, h * HD + 32 * c, q0, b);
    if (RK)
      bulk_store(p.bias_tiles +
                     (((size_t)b * p.heads + h) * p.nq_pad + q0) * RP,
                 myb, BT);
    bulk_commit();
  }
  const uint32_t qa = smem_u32(smem), da = qa + QT, ba = smem_u32(myb);

  // S (+ bias) and dP of ring load i into sc and dp; returns the slot
  auto products = [&](int i, float (&sc)[BK / 2], float (&dp)[BK / 2]) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    __syncwarp();
    const uint32_t ka = smem_u32(ring + s * SLOT);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(sc, tile_k(qa, 64, kk), tile_k(ka, BK, kk), kk > 0);
#pragma unroll
    for (int kr = 0; kr < RK; ++kr)
      wgmma_ss(sc, onehot_k(ba, 64, kr), onehot_k(ka + 2 * KT, BK, kr), 1);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(dp, tile_k(da, 64, kk), tile_k(ka + KT, BK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    mask_keys(sc, (i % p.n_kt) * BK, p.Nk, t);
    return s;
  };

  // pass 1: row max, row sum and delta = rowsum(dP o P), online
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float d_run[2] = {0.f, 0.f};
  for (int i = 0; i < p.n_kt; ++i) {
    float sc[BK / 2], dp[BK / 2];
    const int s = products(i, sc, dp);
    mbar_arrive_if(lane == 0, &empty[s]);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h2], sc[4 * j + 2 * h2 + 1]));
      const float m_new = fmaxf(m_run[h2], quad_max(mx));
      const float alpha = ex2((m_run[h2] - m_new) * LOG2E);
      const float mb = m_new * LOG2E;
      float sum = 0.f, sd = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = ex2(fmaf(sc[4 * j + 2 * h2 + e], LOG2E, -mb));
          sum += pe;
          sd += pe * dp[4 * j + 2 * h2 + e];
        }
      l_run[h2] = l_run[h2] * alpha + quad_sum(sum);
      d_run[h2] = d_run[h2] * alpha + quad_sum(sd);
      m_run[h2] = m_new;
    }
  }
  float rl[2], delta[2], mb[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int q = r0 + 8 * h2;
    rl[h2] = 1.f / l_run[h2];
    delta[h2] = d_run[h2] / l_run[h2];
    mb[h2] = m_run[h2] * LOG2E;
    // rows past Nq (up to nq_pad): P = exp(S - inf) = 0 on the key side
    const float4 st = q < p.Nq ? make_float4(m_run[h2], rl[h2], delta[h2], 0.f)
                               : make_float4(INFINITY, 1.f, 0.f, 0.f);
    if (t == 0)
      *reinterpret_cast<float4*>(
          p.stats + (((size_t)b * p.heads + h) * p.nq_pad + q) * 4) = st;
  }

  // dS of ring load i into dp (f32, the high part's source) and sc (its
  // low part); returns the slot
  auto ds_of = [&](int i, float (&sc)[BK / 2], float (&dp)[BK / 2]) {
    const int s = products(i, sc, dp);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h2 = e >> 1, x = 4 * j + e;
        const float pe = ex2(fmaf(sc[x], LOG2E, -mb[h2])) * rl[h2];
        dp[x] = pe * (dp[x] - delta[h2]);      // dS, f32
        sc[x] = dp[x] - round_bf16(dp[x]);     // its low part
      }
    return s;
  };
  // columns 16 RKC c .. of this thread's dbias rows, from dba
  float dba[NB];
  auto store_dbias = [&](int c) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int q = r0 + 8 * h2;
      if (q >= p.Nq) continue;
      bf16* db = p.dbias + (((size_t)b * p.heads + h) * p.Nq + q) * p.R;
#pragma unroll
      for (int j = 0; j < 2 * RKC; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 16 * RKC * c + 8 * j + 2 * t + e;
          if (col < p.R) db[col] = __float2bfloat16(dba[4 * j + 2 * h2 + e]);
        }
    }
  };

  // pass 2: dS; dq += round(dS) K; dbias (its first chunk) += dS M (hi + lo)
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) dba[i] = 0.f;
  for (int i = p.n_kt; i < 2 * p.n_kt; ++i) {
    float sc[BK / 2], dp[BK / 2];
    const int s = ds_of(i, sc, dp);
    const uint32_t ka = smem_u32(ring + s * SLOT);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      frag_of(dp, kk, hi);
      frag_of(sc, kk, lo);
      wgmma_rs(dqa, hi, tile_mn(ka, BK, kk), 1);
      if (RK) {
        wgmma_rs(dba, hi, onehot_mn(ka + 2 * KT, BK, kk), 1);
        wgmma_rs(dba, lo, onehot_mn(ka + 2 * KT, BK, kk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dqa);
    fence_acc(dba);
    mbar_arrive_if(lane == 0, &empty[s]);
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int q = r0 + 8 * h2;
    if (q >= p.Nq) continue;
    const size_t base = ((size_t)b * p.Nq + q) * p.C + h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int d = 8 * j + 2 * t;
      float v0 = round_bf16(dqa[4 * j + 2 * h2] * p.scale);
      float v1 = round_bf16(dqa[4 * j + 2 * h2 + 1] * p.scale);
      if (p.q_residual) {
        const float2 g2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.dout + base + d));
        v0 += g2.x;
        v1 += g2.y;
      }
      *reinterpret_cast<uint32_t*>(p.dq + base + d) = pack_bf16(v0, v1);
    }
  }
  if (RK) store_dbias(0);
  // the other chunks: dS again for each, the one-hot tile's columns of the
  // chunk as the B operand (no-swizzle groups of 8 columns, 64 keys each)
  for (int c = 1; c < NCH; ++c) {
#pragma unroll
    for (int i = 0; i < NB; ++i) dba[i] = 0.f;
    for (int i = (1 + c) * p.n_kt; i < (2 + c) * p.n_kt; ++i) {
      float sc[BK / 2], dp[BK / 2];
      const int s = ds_of(i, sc, dp);
      const uint32_t mc = smem_u32(ring + s * SLOT) + 2 * KT +
                          c * 2 * RKC * BK * 16;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        frag_of(dp, kk, hi);
        frag_of(sc, kk, lo);
        wgmma_rs(dba, hi, onehot_mn(mc, BK, kk), 1);
        wgmma_rs(dba, lo, onehot_mn(mc, BK, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dba);
      mbar_arrive_if(lane == 0, &empty[s]);
    }
    store_dbias(c);
  }
  if (tid == 0) bulk_wait();  // the q * scale store has left shared memory
}

// B, the key side.  Shared memory: [K | V tile (64 x HD each) | one-hot tile
// (64 x RP)][ring: stages x (q * scale | dO tile (64 x HD each) | statistics
// (64 x 16 bytes) | bias tile (64 x RP))][full | empty per slot, resident].
template <int HD, int RK>
__global__ void __launch_bounds__(160, 1)
    attn_bwd_kv_kernel(const __grid_constant__ CUtensorMap tm_qs,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_kv,
                       BwdParams p) {
  constexpr int RP = 16 * RK, QT = 64 * HD * 2, KT = BK * HD * 2;
  constexpr int MT = BK * RP * 2, RES = 2 * KT + MT, ST = 64 * 16;
  constexpr int BT = 64 * RP * 2, SLOT = 2 * QT + ST + BT;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* ring = smem + RES;
  const int stages = p.kv_stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * SLOT);
  uint64_t* empty = full + stages;
  uint64_t* res_bar = empty + stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK, h = blockIdx.y;
  const int b = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int q_tiles = (p.Nq + 63) / 64;
  const int qt0 = split * p.tiles_per_split;
  const int n_qt = max(0, min(q_tiles, qt0 + p.tiles_per_split) - qt0);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(res_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(res_bar, RES);
      for (int c = 0; c < HD / 32; ++c) {
        tma_load_3d(smem + c * BK * 64, &tm_kv, res_bar, h * HD + 32 * c, k0,
                    b);
        tma_load_3d(smem + KT + c * BK * 64, &tm_kv, res_bar,
                    p.C + h * HD + 32 * c, k0, b);
      }
      if (RK) bulk_load(smem + 2 * KT, p.mt + (size_t)blockIdx.x * BK * RP, MT,
                        res_bar);
      for (int jj = 0; jj < n_qt; ++jj) {
        const int s = jj % stages, q0 = (qt0 + jj) * 64;
        mbar_wait(&empty[s], ((jj / stages) & 1) ^ 1);
        uint8_t* dst = ring + s * SLOT;
        mbar_expect_tx(&full[s], SLOT);
        for (int c = 0; c < HD / 32; ++c) {
          tma_load_3d(dst + c * 64 * 64, &tm_qs, &full[s], h * HD + 32 * c,
                      q0, b);
          tma_load_3d(dst + QT + c * 64 * 64, &tm_do, &full[s],
                      h * HD + 32 * c, q0, b);
        }
        const size_t row = ((size_t)b * p.heads + h) * p.nq_pad + q0;
        bulk_load(dst + 2 * QT, p.stats + row * 4, ST, &full[s]);
        if (RK)  // the query side's bias tile of these rows
          bulk_load(dst + 2 * QT + ST, p.bias_tiles + row * RP, BT, &full[s]);
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const uint32_t ka = smem_u32(smem), va = ka + KT, ma = va + KT;
  // the first query tile's products overwrite dk and dv (no zero-fill
  // by other instructions beside the asynchronous products)
  float dk[HD / 2], dv[HD / 2];
  mbar_wait(res_bar, 0);
  for (int jj = 0; jj < n_qt; ++jj) {
    const int s = jj % stages;
    mbar_wait(&full[s], (jj / stages) & 1);
    __syncwarp();
    const uint32_t qsa = smem_u32(ring + s * SLOT), doa = qsa + QT;
    const uint32_t ba = doa + QT + ST;
    const float4* st = reinterpret_cast<const float4*>(ring + s * SLOT + 2 * QT);
    float sc[32], dp[32];  // S^T and dP^T: rows keys, columns queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(sc, tile_k(ka, BK, kk), tile_k(qsa, 64, kk), kk > 0);
#pragma unroll
    for (int kr = 0; kr < RK; ++kr)
      wgmma_ss(sc, onehot_k(ma, BK, kr), onehot_k(ba, 64, kr), 1);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(dp, tile_k(va, BK, kk), tile_k(doa, 64, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 sq = st[8 * j + 2 * t + e];  // max, 1 / sum, delta
        const float mb = sq.x * LOG2E;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int x = 4 * j + 2 * h2 + e;
          const float pe = ex2(fmaf(sc[x], LOG2E, -mb)) * sq.y;
          sc[x] = pe;
          dp[x] = pe * (dp[x] - sq.z);
        }
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4], c[4];
      frag_of(sc, kk, a);
      frag_of(dp, kk, c);
      wgmma_rs(dv, a, tile_mn(doa, 64, kk), jj > 0 || kk > 0);
      wgmma_rs(dk, c, tile_mn(qsa, 64, kk), jj > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
    mbar_arrive_if(lane == 0, &empty[s]);
  }

  if (n_qt == 0) {  // a split past the last query tile adds zeros
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  }
  const size_t row = 2 * (size_t)p.C;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int j = k0 + 16 * warp + g + 8 * h2;
    if (j >= p.Nk) continue;
#pragma unroll
    for (int x = 0; x < HD / 8; ++x) {
      const int d = h * HD + 8 * x + 2 * t, i = 4 * x + 2 * h2;
      if (p.splits == 1) {
        bf16* base = p.dkv + ((size_t)b * p.Nk + j) * row;
        *reinterpret_cast<uint32_t*>(base + d) = pack_bf16(dk[i], dk[i + 1]);
        *reinterpret_cast<uint32_t*>(base + p.C + d) =
            pack_bf16(dv[i], dv[i + 1]);
      } else {
        float* base =
            p.partial + (((size_t)split * p.B + b) * p.Nk + j) * row;
        *reinterpret_cast<float2*>(base + d) = make_float2(dk[i], dk[i + 1]);
        *reinterpret_cast<float2*>(base + p.C + d) =
            make_float2(dv[i], dv[i + 1]);
      }
    }
  }
}

// C: dkv = round(sum over the query splits of the f32 partials), in split
// order
__global__ void __launch_bounds__(256) attn_bwd_reduce_kernel(
    const float* partial, bf16* dkv, int splits, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * n + i];
  dkv[i] = __float2bfloat16(s);
}

// the shared-memory grant of a kernel instance, once per device
template <auto kernel>
int grant() {
  static bool granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && granted[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BLOCK_MAX);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) granted[dev] = true;
  return 0;
}

// bytes of shared memory, as ops/attention.py:attention_smem counts them:
// the resident tiles, the ring's slots, the barriers
int fwd_smem(int hd, int rk, int stages) {
  return (BK * hd * 2 + BK * 32 * rk) +
         stages * (2 * BK * hd * 2 + BK * 32 * rk) + 8 * (2 * stages + 1);
}

int bwd_q_smem(int hd, int rk, int stages) {
  return (2 * BK * hd * 2 + BK * 32 * rk) +
         stages * (2 * BK * hd * 2 + BK * 32 * rk) + 8 * (2 * stages + 1);
}

int bwd_kv_smem(int hd, int rk, int stages) {
  return (2 * BK * hd * 2 + BK * 32 * rk) +
         stages * (2 * BK * hd * 2 + BK * 16 + BK * 32 * rk) +
         8 * (2 * stages + 1);
}

template <int HD, int RK>
int launch_fwd(const FwdParams& p, const CUtensorMap& tq,
               const CUtensorMap& tkv, cudaStream_t stream) {
  const int smem = fwd_smem(HD, RK, p.stages);
  if (smem > SMEM_BLOCK_MAX) return ERR_PLAN;
  int rc = grant<attn_fwd_kernel<HD, RK>>();
  if (rc) return rc;
  dim3 grid((p.Nq + 63) / 64, p.heads, p.B);
  attn_fwd_kernel<HD, RK><<<grid, 160, smem, stream>>>(tq, tkv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int fwd_rk(const FwdParams& p, int rk, const CUtensorMap& tq,
           const CUtensorMap& tkv, cudaStream_t stream) {
  switch (rk) {
    case 0: return launch_fwd<HD, 0>(p, tq, tkv, stream);
    case 3: return launch_fwd<HD, 3>(p, tq, tkv, stream);
    case RK_WIDE: return launch_fwd<HD, RK_WIDE>(p, tq, tkv, stream);
    case RK_CHUNKED: return launch_fwd<HD, RK_CHUNKED>(p, tq, tkv, stream);
  }
  if constexpr (HD == 96) {  // other head widths pad R to 48 (or 128)
    switch (rk) {
      case 1: return launch_fwd<HD, 1>(p, tq, tkv, stream);
      case 2: return launch_fwd<HD, 2>(p, tq, tkv, stream);
    }
  }
  return ERR_PLAN;
}

template <int HD, int RK>
int launch_bwd(const BwdParams& p, const CUtensorMap (&maps)[4],
               cudaStream_t stream) {
  const int smem_q = bwd_q_smem(HD, RK, p.q_stages);
  const int smem_kv = bwd_kv_smem(HD, RK, p.kv_stages);
  if (smem_q > SMEM_BLOCK_MAX || smem_kv > SMEM_BLOCK_MAX) return ERR_PLAN;
  int rc = grant<attn_bwd_q_kernel<HD, RK>>();
  if (!rc) rc = grant<attn_bwd_kv_kernel<HD, RK>>();
  if (rc) return rc;
  // maps: q, dO, kv (64-row boxes), q * scale
  dim3 grid_q(p.nq_pad / 64, p.heads, p.B);
  attn_bwd_q_kernel<HD, RK><<<grid_q, 160, smem_q, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_kv((p.Nk + BK - 1) / BK, p.heads, p.B * p.splits);
  attn_bwd_kv_kernel<HD, RK><<<grid_kv, 160, smem_kv, stream>>>(
      maps[3], maps[1], maps[2], p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)p.B * p.Nk * 2 * p.C;
  attn_bwd_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      p.partial, p.dkv, p.splits, n);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int bwd_rk(const BwdParams& p, int rk, const CUtensorMap (&maps)[4],
           cudaStream_t stream) {
  switch (rk) {
    case 0: return launch_bwd<HD, 0>(p, maps, stream);
    case 3: return launch_bwd<HD, 3>(p, maps, stream);
    case RK_WIDE: return launch_bwd<HD, RK_WIDE>(p, maps, stream);
    case RK_CHUNKED: return launch_bwd<HD, RK_CHUNKED>(p, maps, stream);
  }
  if constexpr (HD == 96) {
    switch (rk) {
      case 1: return launch_bwd<HD, 1>(p, maps, stream);
      case 2: return launch_bwd<HD, 2>(p, maps, stream);
    }
  }
  return ERR_PLAN;
}

// a [batch, rows, cols] bf16 tensor in 64-byte swizzled boxes of 32 columns
// by box_rows rows
int map3(CUtensorMap* map, const void* ptr, int batch, int rows, int cols,
         int box_rows) {
  const long dims[3] = {cols, rows, batch};
  return encode_map(map, ptr, 3, dims, 32, box_rows, 64);
}

}  // namespace

// stages, rk: the launch plan of ops/attention.py:attention_plan; mt: the
// one-hot tiles of ops/attention.py:onehot_tiles for (k_shape, Nk, 16 rk),
// null without a bias
extern "C" int svit_pooled_attention(const bf16* q, const bf16* kv,
                                     const bf16* bias, const bf16* mt,
                                     bf16* out, int B, int Nq, int Nk, int C,
                                     int heads, int R, float scale,
                                     int q_residual, int stages, int rk,
                                     cudaStream_t stream) {
  const int hd = C / heads;
  if ((bias == nullptr) != (rk == 0) || 16 * rk < R || stages < 1 ||
      C % heads)
    return ERR_PLAN;
  FwdParams p{q, bias, mt, out, B, Nq, Nk, C, heads, R, scale, q_residual,
              stages, (Nk + BK - 1) / BK};
  CUtensorMap tq, tkv;
  int rc = map3(&tq, q, B, Nq, C, 64);
  if (!rc) rc = map3(&tkv, kv, B, Nk, 2 * C, BK);
  if (rc) return rc;
  switch (hd) {
    case 64: return fwd_rk<64>(p, rk, tq, tkv, stream);
    case 96: return fwd_rk<96>(p, rk, tq, tkv, stream);
    case 128: return fwd_rk<128>(p, rk, tq, tkv, stream);
  }
  return ERR_PLAN;
}

// q_stages, kv_stages, rk, splits: the launch plan of
// ops/attention.py:attention_plan (backward); scratch: qs [B, Nq, C] for
// q * scale, stats [B, heads, nq_pad, 4] f32 and bias_tiles [B, heads,
// nq_pad, 16 rk] (with a bias), nq_pad = Nq rounded up to 64, partial
// [splits, B, Nk, 2C] f32 when splits > 1; mt: the one-hot tiles for
// (k_shape, Nk, 16 rk)
extern "C" int svit_pooled_attention_bwd(
    const bf16* q, const bf16* kv, const bf16* bias, const bf16* dout,
    const bf16* mt, bf16* dq, bf16* dkv, bf16* dbias, float* stats, bf16* qs,
    bf16* bias_tiles, float* partial, int B, int Nq, int Nk, int C, int heads, int R,
    float scale, int q_residual, int q_stages, int kv_stages, int rk,
    int splits, cudaStream_t stream) {
  const int hd = C / heads;
  const int q_tiles = (Nq + 63) / 64;
  if ((bias == nullptr) != (rk == 0) || 16 * rk < R || q_stages < 1 ||
      kv_stages < 1 || splits < 1 || splits > q_tiles || C % heads ||
      (splits > 1 && partial == nullptr) || (rk && bias_tiles == nullptr))
    return ERR_PLAN;
  BwdParams p{q, bias, dout, mt, dq, dkv, dbias, stats, partial, bias_tiles,
              B, Nq, Nk, C, heads, R, scale, q_residual, q_tiles * 64,
              (Nk + BK - 1) / BK, q_stages, kv_stages, splits,
              (q_tiles + splits - 1) / splits};
  CUtensorMap maps[4];
  int rc = map3(&maps[0], q, B, Nq, C, 64);
  if (!rc) rc = map3(&maps[1], dout, B, Nq, C, 64);
  if (!rc) rc = map3(&maps[2], kv, B, Nk, 2 * C, BK);
  if (!rc) rc = map3(&maps[3], qs, B, Nq, C, 64);
  if (rc) return rc;
  switch (hd) {
    case 64: return bwd_rk<64>(p, rk, maps, stream);
    case 96: return bwd_rk<96>(p, rk, maps, stream);
    case 128: return bwd_rk<128>(p, rk, maps, stream);
  }
  return ERR_PLAN;
}
