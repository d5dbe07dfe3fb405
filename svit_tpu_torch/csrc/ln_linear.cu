// K1 ln_linear: Y = epilogue(prologue(X) . W^T), bf16 in, f32 accumulate.
//
// Replaces the TPU kernels of svit_tpu/ops/pallas_ffn.py:
//   _ln_qkv_kernel  (fused_ln_qkv)       -> one launch over [Wq | Wkv], the
//                                           two outputs split by column;
//   _ln_dense_kernel (fused_ln_dense)     -> one launch;
//   _ffn_res_kernel (fused_ffn_residual) -> two launches: (x_res + a) -> LN
//                                           -> fc1 + b1 -> GELU writes h and
//                                           x; then h . W2 + b2, rounded,
//                                           + x.  The attention
//                                           out-projection is a third use;
//   _ffn_res_kernel with the SMEM drop-path mask (fused_ffn_residual_masked)
//                                        -> the same two launches in masked
//                                           mode: fc1's prologue takes
//                                           x_res + a / keep * ma, fc2's
//                                           epilogue round(fc2 + b2) / keep
//                                           * my + x, every op rounded to
//                                           bf16 as the TPU kernel's IO-dtype
//                                           ops are (ma, my: per-sample 0/1).
//
// What bounds it on the H100: at the early stages (K = 96..192, N <= 4K)
// the product does about K/2 flops per byte of X and Y moved, far below the
// ~295 flop/byte ridge, so device memory bounds it; at C = 768 the products
// are compute-bound.  The TPU kept fc1's [tile, 4C] output in VMEM; a 64-row
// tile of it at C = 768 is 384 KB, beyond a block's 227 KB of shared memory,
// so h goes through device memory here (a known cost).
//
// Design: each 128x128 output tile is one block of 8 warps (2 x 4, a 64x32
// warp tile of m16n8k16 mma.sync).  The LN prologue is fused into the A-tile
// load: a block first takes its 128 rows' mean and rstd (two passes over
// the row, from L2), then normalises, rounds to bf16 and stores each A tile
// to shared memory, so the normalised tensor never exists in device memory.
// With x_add the rounded sum x + x_add is what is normalised, and the blocks
// of the first column of tiles write it out.  The epilogue adds the bias in
// f32 (optionally exact-erf GELU) before the one rounding, or rounds first
// and adds the bias in bf16 (attention projection), then adds the residual
// in bf16.  Loads are not pipelined yet (no cp.async / TMA, no wgmma).
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32, LDS = BK + 8, THREADS = 256;

struct Params {
  const bf16* x;
  const bf16* x_add;
  bf16* s_out;
  const float* ln_g;
  const float* ln_b;
  float eps;
  const bf16* w;
  const float* bias;
  int bias_mode;  // 0 none, 1 f32 before the rounding, 2 bf16 after it
  int gelu;
  const bf16* residual;
  bf16* out0;
  bf16* out1;
  int n_split;
  int M, N, K;
  const float* mask_add;  // [M / rows] 0/1: x_add becomes x_add / keep * mask
  const float* mask_out;  // [M / rows] 0/1: output becomes out / keep * mask
  float keep;             // the keep probability, rounded to bf16
  int rows;               // rows per sample (mask index = m / rows)
};

// 8 consecutive values of the (rounded) prologue sum x (+ x_add) at (m, k)
__device__ __forceinline__ void load_row8(const Params& p, int m, int k,
                                          float (&v)[8]) {
  size_t off = (size_t)m * p.K + k;
  unpack8(*reinterpret_cast<const uint4*>(p.x + off), v);
  if (p.x_add) {
    float a[8];
    unpack8(*reinterpret_cast<const uint4*>(p.x_add + off), a);
    if (p.mask_add) {  // a / keep * ma: two bf16 ops (the mask is exact)
      const float ma = p.mask_add[m / p.rows];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = round_bf16(a[i] / p.keep) * ma;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_bf16(v[i] + a[i]);
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

__global__ void __launch_bounds__(THREADS) ln_linear_kernel(Params p) {
  __shared__ __align__(16) bf16 As[BM][LDS];
  __shared__ __align__(16) bf16 Bs[BN][LDS];
  __shared__ float row_mean[BM], row_rstd[BM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool ln = p.ln_g != nullptr;
  const bool write_s = p.s_out != nullptr && blockIdx.y == 0;

  if (ln) {  // LN statistics, one warp per row, two passes
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int m = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (m < p.M) {
        float v[8], sum = 0.f;
        for (int k = lane * 8; k < p.K; k += 256) {
          load_row8(p, m, k, v);
#pragma unroll
          for (int i = 0; i < 8; ++i) sum += v[i];
        }
        mean = warp_sum(sum) / p.K;
        float sq = 0.f;
        for (int k = lane * 8; k < p.K; k += 256) {
          load_row8(p, m, k, v);
#pragma unroll
          for (int i = 0; i < 8; ++i) sq += (v[i] - mean) * (v[i] - mean);
        }
        rstd = rsqrtf(warp_sum(sq) / p.K + p.eps);
      }
      if (lane == 0) {
        row_mean[r] = mean;
        row_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + kc;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (m < p.M && k < p.K) {
        float v[8];
        load_row8(p, m, k, v);
        if (write_s)
          *reinterpret_cast<uint4*>(p.s_out + (size_t)m * p.K + k) = pack8(v);
        if (ln) {
          const float mean = row_mean[r], rstd = row_rstd[r];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[i] = (v[i] - mean) * rstd * p.ln_g[k + i] + p.ln_b[k + i];
        }
        packed = pack8(v);
      }
      *reinterpret_cast<uint4*>(&As[r][kc]) = packed;
    }
    for (int c = tid; c < BN * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int n = n0 + r, k = k0 + kc;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (n < p.N && k < p.K)
        packed = *reinterpret_cast<const uint4*>(p.w + (size_t)n * p.K + k);
      *reinterpret_cast<uint4*>(&Bs[r][kc]) = packed;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], &As[wm + mi * 16 + lane % 16][kk + (lane / 16) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, &Bs[wn + nj * 16 + (lane / 16) * 8 + lane % 8]
                          [kk + ((lane / 8) % 2) * 8]);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + mi * 16 + g + half * 8;
        const int n = n0 + wn + ni * 8 + 2 * t;
        if (m >= p.M || n >= p.N) continue;  // N % 8 == 0: n + 1 < N too
        float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (p.bias_mode == 1) {
          v0 += p.bias[n];
          v1 += p.bias[n + 1];
        }
        if (p.gelu) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        v0 = round_bf16(v0);
        v1 = round_bf16(v1);
        if (p.bias_mode == 2) {
          v0 = round_bf16(v0 + round_bf16(p.bias[n]));
          v1 = round_bf16(v1 + round_bf16(p.bias[n + 1]));
        }
        if (p.mask_out) {
          const float my = p.mask_out[m / p.rows];
          v0 = round_bf16(v0 / p.keep) * my;
          v1 = round_bf16(v1 / p.keep) * my;
        }
        if (p.residual) {
          float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              p.residual + (size_t)m * p.N + n));
          v0 += r.x;
          v1 += r.y;
        }
        const uint32_t packed = pack_bf16(v0, v1);
        if (n < p.n_split)
          *reinterpret_cast<uint32_t*>(p.out0 + (size_t)m * p.n_split + n) = packed;
        else
          *reinterpret_cast<uint32_t*>(
              p.out1 + (size_t)m * (p.N - p.n_split) + (n - p.n_split)) = packed;
      }
}

}  // namespace

extern "C" const char* svit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int svit_ln_linear(const bf16* x, const bf16* x_add, bf16* s_out,
                              const float* ln_g, const float* ln_b, float eps,
                              const bf16* w, const float* bias, int bias_mode,
                              int gelu, const bf16* residual, bf16* out0,
                              bf16* out1, int n_split, int M, int N, int K,
                              const float* mask_add, const float* mask_out,
                              float keep, int rows, cudaStream_t stream) {
  Params p{x, x_add, s_out, ln_g, ln_b, eps, w, bias, bias_mode, gelu,
           residual, out0, out1, n_split, M, N, K, mask_add, mask_out, keep,
           rows};
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  ln_linear_kernel<<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
