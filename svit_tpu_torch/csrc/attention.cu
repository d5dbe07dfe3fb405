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
