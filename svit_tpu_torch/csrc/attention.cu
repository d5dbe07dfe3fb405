// K4 pooled_attention: out = softmax((q * scale) K^T + bias) V per head,
// head outputs rounded to bf16, then + q (residual pooling) in bf16.
//
// Replaces svit_tpu/ops/pallas_attention.py _attn_kernel (pooled_attention,
// reached by fused_attention_proj), launched twice per block: the grid
// queries with the decomposed rel-pos bias, and the cls + object queries
// with none.  The TPU kernel's out-projection epilogue is a separate K1
// launch here (ln_linear.cu, round then + bias in bf16).
//
// What bounds it on the H100: the QK^T and PV products, 4 * Nq * Nk *
// head_dim flops per head on the tensor cores (989 TFLOP/s bf16), against
// q, the bias rows and the output in device memory; at the stem (Nq =
// 25,088 per clip, Nk = 457, head_dim 96) the two are within a factor of
// two of each other.  The TPU materialised the bias through a one-hot
// scatter matrix M of [R, Nk_pad]; here the bias is gathered: for a patch
// key j < kT*kH*kW with grid position (t, h, w),
//   bias = bias_src[q, t] + bias_src[q, kT + h] + bias_src[q, kT + kH + w],
// the extras keys get 0 and keys >= Nk are masked, which is bias_src @ M.
//
// Design: flash-style online softmax, one block of 4 warps per (64-query
// tile, head, clip); each warp owns 16 query rows.  q is scaled in bf16 (the
// scale rounded to bf16 first) into shared memory and kept as mma fragments;
// 64-key tiles of K and V are staged in padded shared memory and read with
// ldmatrix (V transposed); S and the running max / sum stay in registers in
// f32; P is rounded to bf16 for the PV product.  The block's bias rows
// (64 x (kT + kH + kW), f32) and each key tile's (t, h, w) offsets sit in
// shared memory.  No cp.async / TMA pipelining yet.
//
// K5 pooled_attention_bwd replaces _attn_bwd_kernel (pooled_attention_bwd,
// pallas_attention.py:317-491) and computes what it computes, per head:
//   P = softmax((q * scale) K^T + bias) in f32 (recomputed),
//   dP = dO V^T, delta = rowsum(dP o P), dS = P o (dP - delta),
//   dq = round(dS) K * scale,  dK = round(dS)^T (q * scale),
//   dV = round(P)^T dO,  dbias = the scatter of dS back onto the
//   kT + kH + kW bias columns (JAX's dS M^T), rounded to bf16;
// with q_residual, dq += dO in bf16 (the projection's dbase).
// What bounds it: the five Nq x Nk x head_dim products on the tensor cores,
// about 2.5 times the forward's work.  The TPU kept the whole [Nk, 2C]
// key/value block and its f32 dK|dV accumulator in VMEM and walked the q
// tiles in order.  Blocks on the H100 run in no order, so the work is split
// in two launches with no atomics:
//   A (query side): one block per (64-query tile, head, clip) makes two
//     passes over the key tiles.  The first takes the row max, sum and
//     delta online; the second writes dq and scatters dS into the block's
//     [64, R] dbias rows in shared memory.  One thread owns each (row,
//     t|h|w) group and adds the key tile's dS values in key order, so the
//     sums do not depend on scheduling.  The row statistics go to an f32
//     scratch.
//   B (key side): one block per (64-key tile, head, clip, query split)
//     walks its share of the query tiles, recomputes P^T and dS^T from the
//     saved statistics and accumulates dK and dV in registers (f32).  The
//     query splits fill the card when the key tiles are few (the stem has 8
//     per clip); a third launch adds the splits' f32 partials in order and
//     rounds to bf16.
#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;

struct AttnParams {
  const bf16* q;
  const bf16* kv;
  const bf16* bias;  // [B, heads, Nq, R] or null
  bf16* out;
  int B, Nq, Nk, C, heads, kT, kH, kW, R, k_l;
  float scale;
  int q_residual;
};

template <int HD>
__global__ void __launch_bounds__(THREADS) attn_kernel(AttnParams p) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BKV * LD;
  int* Kidx = reinterpret_cast<int*>(Vs + BKV * LD);  // [BKV][3]
  float* Bias = reinterpret_cast<float*>(Kidx + BKV * 3);  // [BQ][R]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t kv_row = 2 * (size_t)p.C;
  const float scale = round_bf16(p.scale);

  for (int c = tid; c < BQ * HD / 8; c += THREADS) {
    const int r = c / (HD / 8), d = (c % (HD / 8)) * 8, q = q0 + r;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q < p.Nq)
      unpack8(*reinterpret_cast<const uint4*>(
                  p.q + ((size_t)b * p.Nq + q) * p.C + h * HD + d), v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = v[i] * scale;
    *reinterpret_cast<uint4*>(Qs + r * LD + d) = pack8(v);
  }
  if (p.bias) {
    for (int c = tid; c < BQ * p.R; c += THREADS) {
      const int r = c / p.R, j = c % p.R, q = q0 + r;
      Bias[c] = q < p.Nq ? __bfloat162float(
          p.bias[(((size_t)b * p.heads + h) * p.Nq + q) * p.R + j]) : 0.f;
    }
  }
  __syncthreads();

  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);

  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int row0 = warp * 16 + g;  // this thread's rows: row0, row0 + 8

  for (int k0 = 0; k0 < p.Nk; k0 += BKV) {
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < BKV * HD / 8; c += THREADS) {
      const int r = c / (HD / 8), d = (c % (HD / 8)) * 8, j = k0 + r;
      uint4 kq = make_uint4(0, 0, 0, 0), vq = make_uint4(0, 0, 0, 0);
      if (j < p.Nk) {
        const bf16* row = p.kv + ((size_t)b * p.Nk + j) * kv_row + h * HD + d;
        kq = *reinterpret_cast<const uint4*>(row);
        vq = *reinterpret_cast<const uint4*>(row + p.C);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + d) = kq;
      *reinterpret_cast<uint4*>(Vs + r * LD + d) = vq;
    }
    if (p.bias && tid < BKV) {
      const int j = k0 + tid;
      int* ix = Kidx + tid * 3;
      if (j < p.k_l) {
        ix[0] = j / (p.kH * p.kW);
        ix[1] = p.kT + (j / p.kW) % p.kH;
        ix[2] = p.kT + p.kH + j % p.kW;
      } else {
        ix[0] = -1;
      }
    }
    __syncthreads();

    float s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int nj = 0; nj < BKV / 16; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, Ks + (nj * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                           ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * nj], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * nj + 1], qf[kk], r[2], r[3]);
      }

#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = ni * 8 + 2 * t + (e % 2), j = k0 + jl;
        if (j >= p.Nk) {
          s[ni][e] = -INFINITY;
        } else if (p.bias) {
          const int* ix = Kidx + jl * 3;
          if (ix[0] >= 0) {
            const float* br = Bias + (row0 + (e / 2) * 8) * p.R;
            s[ni][e] += br[ix[0]] + br[ix[1]] + br[ix[2]];
          }
        }
      }

    // online softmax: a row's 64 scores live in the 4 threads of a quad
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
        mx = fmaxf(mx, fmaxf(s[ni][2 * half], s[ni][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);  // finite: key k0 < Nk
      const float alpha = __expf(m_run[half] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          s[ni][e] = __expf(s[ni][e] - m_new);
          sum += s[ni][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[half] = l_run[half] * alpha + sum;
      m_run[half] = m_new;
#pragma unroll
      for (int di = 0; di < HD / 8; ++di) {
        o[di][2 * half] *= alpha;
        o[di][2 * half + 1] *= alpha;
      }
    }

    // O += P V, P (bf16) from the S accumulators in A-fragment order
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dj = 0; dj < HD / 16; ++dj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                 dj * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * dj], a, r[0], r[1]);
        mma_bf16(o[2 * dj + 1], a, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + row0 + half * 8;
    if (q >= p.Nq) continue;
    const size_t base = ((size_t)b * p.Nq + q) * p.C + h * HD;
#pragma unroll
    for (int di = 0; di < HD / 8; ++di) {
      const int d = di * 8 + 2 * t;
      float v0 = round_bf16(o[di][2 * half] / l_run[half]);
      float v1 = round_bf16(o[di][2 * half + 1] / l_run[half]);
      if (p.q_residual) {
        float2 qq = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.q + base + d));
        v0 += qq.x;
        v1 += qq.y;
      }
      *reinterpret_cast<uint32_t*>(p.out + base + d) = pack_bf16(v0, v1);
    }
  }
}

template <int HD>
int launch(const AttnParams& p, cudaStream_t stream) {
  constexpr int LD = HD + 8;
  const size_t smem = (size_t)3 * BQ * LD * sizeof(bf16) + BKV * 3 * sizeof(int) +
                      (size_t)BQ * p.R * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Nq + BQ - 1) / BQ, p.heads, p.B);
  attn_kernel<HD><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K5: the backward
// ---------------------------------------------------------------------------

struct BwdParams {
  const bf16* q;
  const bf16* kv;
  const bf16* bias;  // [B, heads, Nq, R] or null
  const bf16* dout;  // [B, Nq, C]
  bf16* dq;
  bf16* dbias;       // [B, heads, Nq, R] or null
  float* stats;      // [B, heads, Nq, 3]: row max, row sum, delta
  float* partial;    // [splits, B, Nk, 2C]
  int B, Nq, Nk, C, heads, kT, kH, kW, R, k_l;
  float scale;
  int q_residual, splits, q_tiles_per_split;
};

// a 64-row tile of [rows, head_dim] bf16 (row stride ld) into padded smem;
// rows at or past n are zero; optional multiply by a bf16-rounded scale
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t ld, int r0, int n,
                                          float mul) {
  constexpr int LD = HD + 8;
  for (int c = threadIdx.x; c < 64 * HD / 8; c += THREADS) {
    const int r = c / (HD / 8), d = (c % (HD / 8)) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r0 + r < n) u = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + d);
    if (mul != 1.f) {
      float v[8];
      unpack8(u, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= mul;
      u = pack8(v);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + d) = u;
  }
}

// key j's bias columns (t, kT + h, kT + kH + w), or -1 for the extras keys
__device__ __forceinline__ void key_index(const BwdParams& p, int j, int* ix) {
  if (j < p.k_l) {
    ix[0] = j / (p.kH * p.kW);
    ix[1] = p.kT + (j / p.kW) % p.kH;
    ix[2] = p.kT + p.kH + j % p.kW;
  } else {
    ix[0] = ix[1] = ix[2] = -1;
  }
}

// acc[16 rows x 64 cols] = A (this warp's 16 rows, as fragments) . Bsm^T,
// Bsm a [64][LD] smem tile whose rows are the output columns
template <int HD>
__device__ __forceinline__ void rows_by_tile(float (&acc)[8][4],
                                             const uint32_t (&a)[HD / 16][4],
                                             const bf16* Bsm, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t r[4];
      ldmatrix_x4(r, Bsm + (nj * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                         ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * nj], a[kk], r[0], r[1]);
      mma_bf16(acc[2 * nj + 1], a[kk], r[2], r[3]);
    }
}

// out[16 x HD] += round(P) (16 x 64, accumulator layout) . Vsm (64 x HD)
template <int HD>
__device__ __forceinline__ void acc_by_tile(float (&out)[HD / 8][4],
                                            const float (&pm)[8][4],
                                            const bf16* Vsm, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(pm[2 * kk][0], pm[2 * kk][1]);
    a[1] = pack_bf16(pm[2 * kk][2], pm[2 * kk][3]);
    a[2] = pack_bf16(pm[2 * kk + 1][0], pm[2 * kk + 1][1]);
    a[3] = pack_bf16(pm[2 * kk + 1][2], pm[2 * kk + 1][3]);
#pragma unroll
    for (int dj = 0; dj < HD / 16; ++dj) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, Vsm + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                               dj * 16 + (lane / 16) * 8);
      mma_bf16(out[2 * dj], a, r[0], r[1]);
      mma_bf16(out[2 * dj + 1], a, r[2], r[3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) attn_bwd_q_kernel(BwdParams p) {
  constexpr int LD = HD + 8, LDS = BKV + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + BQ * LD;
  bf16* Ks = Ds + BQ * LD;
  bf16* Vs = Ks + BKV * LD;
  int* Kidx = reinterpret_cast<int*>(Vs + BKV * LD);       // [BKV][3]
  float* Bias = reinterpret_cast<float*>(Kidx + BKV * 3);  // [BQ][R]
  float* dB = Bias + BQ * p.R;                             // [BQ][R]
  float* dSs = dB + BQ * p.R;                              // [BQ][LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t kv_row = 2 * (size_t)p.C;
  const size_t qoff = (size_t)b * p.Nq * p.C + h * HD;

  load_rows<HD>(Qs, p.q + qoff, p.C, q0, p.Nq, round_bf16(p.scale));
  load_rows<HD>(Ds, p.dout + qoff, p.C, q0, p.Nq, 1.f);
  if (p.bias) {
    for (int c = tid; c < BQ * p.R; c += THREADS) {
      const int r = c / p.R, j = c % p.R, q = q0 + r;
      Bias[c] = q < p.Nq ? __bfloat162float(
          p.bias[(((size_t)b * p.heads + h) * p.Nq + q) * p.R + j]) : 0.f;
      dB[c] = 0.f;
    }
  }
  __syncthreads();
  uint32_t qf[HD / 16][4], df[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8;
    ldmatrix_x4(qf[kk], Qs + off);
    ldmatrix_x4(df[kk], Ds + off);
  }
  const int row0 = warp * 16 + g;  // this thread's rows: row0, row0 + 8

  // the scores of key tile k0 (f32, bias added, keys >= Nk at -inf) and dP
  auto tile = [&](int k0, float (&s)[8][4], float (&dp)[8][4]) {
    __syncthreads();  // the previous tile is consumed
    const bf16* kvb = p.kv + (size_t)b * p.Nk * kv_row + h * HD;
    load_rows<HD>(Ks, kvb, kv_row, k0, p.Nk, 1.f);
    load_rows<HD>(Vs, kvb + p.C, kv_row, k0, p.Nk, 1.f);
    if (tid < BKV) key_index(p, k0 + tid, Kidx + tid * 3);
    __syncthreads();
    rows_by_tile<HD>(s, qf, Ks, lane);
    rows_by_tile<HD>(dp, df, Vs, lane);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = ni * 8 + 2 * t + (e % 2);
        if (k0 + jl >= p.Nk) {
          s[ni][e] = -INFINITY;
        } else if (p.bias) {
          const int* ix = Kidx + jl * 3;
          if (ix[0] >= 0) {
            const float* br = Bias + (row0 + (e / 2) * 8) * p.R;
            s[ni][e] += br[ix[0]] + br[ix[1]] + br[ix[2]];
          }
        }
      }
  };

  // pass 1: row max, row sum and delta = rowsum(dP o P), online
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float d_run[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < p.Nk; k0 += BKV) {
    float s[8][4], dp[8][4];
    tile(k0, s, dp);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        mx = fmaxf(mx, fmaxf(s[ni][2 * half], s[ni][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      const float alpha = expf(m_run[half] - m_new);
      float sum = 0.f, sd = 0.f;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          const float pe = expf(s[ni][e] - m_new);
          sum += pe;
          sd += pe * dp[ni][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sd += __shfl_xor_sync(0xffffffffu, sd, 1);
      sd += __shfl_xor_sync(0xffffffffu, sd, 2);
      l_run[half] = l_run[half] * alpha + sum;
      d_run[half] = d_run[half] * alpha + sd;
      m_run[half] = m_new;
    }
  }
  float delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    delta[half] = d_run[half] / l_run[half];
    const int q = q0 + row0 + half * 8;
    if (t == 0 && q < p.Nq) {
      float* st = p.stats + (((size_t)b * p.heads + h) * p.Nq + q) * 3;
      st[0] = m_run[half];
      st[1] = l_run[half];
      st[2] = delta[half];
    }
  }

  // pass 2: dS, dq and the dbias scatter
  float dqa[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;
  for (int k0 = 0; k0 < p.Nk; k0 += BKV) {
    float s[8][4], dp[8][4];
    tile(k0, s, dp);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        const float pe = expf(s[ni][e] - m_run[half]) / l_run[half];
        s[ni][e] = pe * (dp[ni][e] - delta[half]);
        if (p.bias) dSs[(row0 + half * 8) * LDS + ni * 8 + 2 * t + (e % 2)] = s[ni][e];
      }
    acc_by_tile<HD>(dqa, s, Ks, lane);
    if (p.bias) {
      __syncthreads();
      for (int task = tid; task < BQ * 3; task += THREADS) {
        const int r = task / 3, kind = task % 3;
        float* dst = dB + r * p.R;
        const float* src = dSs + r * LDS;
        for (int j = 0; j < BKV; ++j) {
          const int* ix = Kidx + j * 3;
          if (ix[0] >= 0) dst[ix[kind]] += src[j];
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + row0 + half * 8;
    if (q >= p.Nq) continue;
    const size_t base = ((size_t)b * p.Nq + q) * p.C + h * HD;
#pragma unroll
    for (int di = 0; di < HD / 8; ++di) {
      const int d = di * 8 + 2 * t;
      float v0 = round_bf16(dqa[di][2 * half] * p.scale);
      float v1 = round_bf16(dqa[di][2 * half + 1] * p.scale);
      if (p.q_residual) {
        float2 g2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.dout + base + d));
        v0 += g2.x;
        v1 += g2.y;
      }
      *reinterpret_cast<uint32_t*>(p.dq + base + d) = pack_bf16(v0, v1);
    }
  }
  if (p.bias) {
    __syncthreads();
    for (int c = tid; c < BQ * p.R; c += THREADS) {
      const int r = c / p.R, j = c % p.R, q = q0 + r;
      if (q < p.Nq)
        p.dbias[(((size_t)b * p.heads + h) * p.Nq + q) * p.R + j] =
            __float2bfloat16(dB[c]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) attn_bwd_kv_kernel(BwdParams p) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;
  bf16* Ds = Qs + BQ * LD;
  int* Kidx = reinterpret_cast<int*>(Ds + BQ * LD);         // [BKV][3]
  float* St = reinterpret_cast<float*>(Kidx + BKV * 3);    // [BQ][3]
  float* Bias = St + BQ * 3;                               // [BQ][R]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BKV, h = blockIdx.y;
  const int b = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const size_t kv_row = 2 * (size_t)p.C;
  const size_t qoff = (size_t)b * p.Nq * p.C + h * HD;
  const float scale_b = round_bf16(p.scale);

  const bf16* kvb = p.kv + (size_t)b * p.Nk * kv_row + h * HD;
  load_rows<HD>(Ks, kvb, kv_row, k0, p.Nk, 1.f);
  load_rows<HD>(Vs, kvb + p.C, kv_row, k0, p.Nk, 1.f);
  if (tid < BKV) key_index(p, k0 + tid, Kidx + tid * 3);
  __syncthreads();
  const int krow0 = warp * 16 + g;  // this thread's keys: krow0, krow0 + 8
  int kix[2][3];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int i = 0; i < 3; ++i) kix[half][i] = Kidx[(krow0 + half * 8) * 3 + i];

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  const int q_tiles = (p.Nq + BQ - 1) / BQ;
  const int qt0 = split * p.q_tiles_per_split;
  const int qt1 = min(q_tiles, qt0 + p.q_tiles_per_split);
  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous query tile is consumed
    load_rows<HD>(Qs, p.q + qoff, p.C, q0, p.Nq, scale_b);
    load_rows<HD>(Ds, p.dout + qoff, p.C, q0, p.Nq, 1.f);
    for (int c = tid; c < BQ * 3; c += THREADS) {
      const int r = c / 3, q = q0 + r;
      // rows past Nq: P = exp(-inf) = 0, so they add nothing
      St[c] = q < p.Nq ? p.stats[(((size_t)b * p.heads + h) * p.Nq + q) * 3 + c % 3]
                       : (c % 3 == 0 ? INFINITY : c % 3 == 1 ? 1.f : 0.f);
    }
    if (p.bias) {
      for (int c = tid; c < BQ * p.R; c += THREADS) {
        const int r = c / p.R, j = c % p.R, q = q0 + r;
        Bias[c] = q < p.Nq ? __bfloat162float(
            p.bias[(((size_t)b * p.heads + h) * p.Nq + q) * p.R + j]) : 0.f;
      }
    }
    __syncthreads();
    // S^T and dP^T: this warp's 16 keys against the 64 queries
    uint32_t kf[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(kf[kk], Ks + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
    float s[8][4], dp[8][4];
    rows_by_tile<HD>(s, kf, Qs, lane);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(kf[kk], Vs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
    rows_by_tile<HD>(dp, kf, Ds, lane);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2, qc = ni * 8 + 2 * t + (e % 2);
        float sv = s[ni][e];
        if (p.bias && kix[half][0] >= 0) {
          const float* br = Bias + qc * p.R;
          sv += br[kix[half][0]] + br[kix[half][1]] + br[kix[half][2]];
        }
        const float* st = St + qc * 3;
        const float pe = expf(sv - st[0]) / st[1];
        s[ni][e] = pe;
        dp[ni][e] = pe * (dp[ni][e] - st[2]);
      }
    acc_by_tile<HD>(dv, s, Ds, lane);
    acc_by_tile<HD>(dk, dp, Qs, lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = k0 + krow0 + half * 8;
    if (j >= p.Nk) continue;
    float* base = p.partial + (((size_t)split * p.B + b) * p.Nk + j) * kv_row + h * HD;
#pragma unroll
    for (int di = 0; di < HD / 8; ++di) {
      const int d = di * 8 + 2 * t;
      *reinterpret_cast<float2*>(base + d) = make_float2(dk[di][2 * half], dk[di][2 * half + 1]);
      *reinterpret_cast<float2*>(base + p.C + d) =
          make_float2(dv[di][2 * half], dv[di][2 * half + 1]);
    }
  }
}

// dkv = round(sum over the query splits of the f32 partials), in split order
__global__ void __launch_bounds__(256) attn_bwd_reduce_kernel(
    const float* partial, bf16* dkv, int splits, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * n + i];
  dkv[i] = __float2bfloat16(s);
}

template <int HD>
int launch_bwd(const BwdParams& p, bf16* dkv, cudaStream_t stream) {
  constexpr int LD = HD + 8;
  const size_t tiles = (size_t)(2 * BQ + 2 * BKV) * LD * sizeof(bf16) +
                       BKV * 3 * sizeof(int);
  const size_t smem_q = tiles + (p.bias ? (size_t)(2 * BQ * p.R + BQ * (BKV + 4)) *
                                              sizeof(float) : 0);
  const size_t smem_kv = tiles + (size_t)(BQ * 3 + BQ * p.R) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_q_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_kv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_q((p.Nq + BQ - 1) / BQ, p.heads, p.B);
  attn_bwd_q_kernel<HD><<<grid_q, THREADS, smem_q, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_kv((p.Nk + BKV - 1) / BKV, p.heads, p.B * p.splits);
  attn_bwd_kv_kernel<HD><<<grid_kv, THREADS, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = (size_t)p.B * p.Nk * 2 * p.C;
  attn_bwd_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      p.partial, dkv, p.splits, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int svit_pooled_attention(const bf16* q, const bf16* kv,
                                     const bf16* bias, bf16* out, int B,
                                     int Nq, int Nk, int C, int heads, int kT,
                                     int kH, int kW, float scale,
                                     int q_residual, cudaStream_t stream) {
  const int R = bias ? kT + kH + kW : 0;
  AttnParams p{q, kv, bias, out, B, Nq, Nk, C, heads, kT, kH, kW, R,
               kT * kH * kW, scale, q_residual};
  switch (C / heads) {
    case 64: return launch<64>(p, stream);
    case 96: return launch<96>(p, stream);
    case 128: return launch<128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int svit_pooled_attention_bwd(
    const bf16* q, const bf16* kv, const bf16* bias, const bf16* dout,
    bf16* dq, bf16* dkv, bf16* dbias, float* stats, float* partial, int B,
    int Nq, int Nk, int C, int heads, int kT, int kH, int kW, float scale,
    int q_residual, int splits, cudaStream_t stream) {
  const int R = bias ? kT + kH + kW : 0;
  const int q_tiles = (Nq + BQ - 1) / BQ;
  BwdParams p{q, kv, bias, dout, dq, dbias, stats, partial, B, Nq, Nk, C,
              heads, kT, kH, kW, R, kT * kH * kW, scale, q_residual, splits,
              (q_tiles + splits - 1) / splits};
  switch (C / heads) {
    case 64: return launch_bwd<64>(p, dkv, stream);
    case 96: return launch_bwd<96>(p, dkv, stream);
    case 128: return launch_bwd<128>(p, dkv, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
