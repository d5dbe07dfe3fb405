// K2 pool_ln and K3 pool_max over channels-last [B, T, H, W, C] bf16 grids.
//
// K2 replaces svit_tpu/ops/pallas_pool.py _kernel_s1 (stride 1, reached by
// fused_pool_ln through _forward) and _kernel_strided (spatial stride s,
// through _forward_strided): a depthwise kT x kH x kW conv with zero
// padding k//2 at strides (sT, sH, sW) given at run time, accumulated in
// f32, then LayerNorm (eps 1e-6) over each head_dim group of channels with
// full-width scale/bias, so the fused k|v pool is one launch.  One kernel
// covers every stride; the TPU's parity reshapes, halo rotates and W8 carry
// answer to Mosaic and have no counterpart here.
// K3 replaces _kernel_strided_max (fused_pool_max): MaxPool3d with -inf
// padding k//2.
//
// What bounds them on the H100: device memory.  K2 does 2*kT*kH*kW flops
// per output element on the CUDA cores (f32 FMA, 67 TFLOP/s) against one
// input read and one output write; K3 only compares.  Both are plain CUDA
// (not Triton): the conv is a gather over taps, which CUDA expresses
// directly.
//
// Design: K2 gives one warp to one (output position, head group); a lane
// holds up to 4 channels of the group (lane + 32 i), so the taps read
// coalesced 64-byte rows and the group's LN statistics are warp shuffles.
// The input rows are re-read per tap from L1/L2 (no shared-memory halo
// tile yet).  K3 gives one thread to 8 channels of one output position,
// 16-byte loads.
#include "common.cuh"

namespace {

struct PoolParams {
  const bf16* x;
  const float* w;  // [kT*kH*kW, C], tap-major
  const float* g;
  const float* b;
  bf16* out;
  int B, T, H, W, C, kT, kH, kW, sT, sH, sW, To, Ho, Wo, hd;
  float eps;
};

template <int CPL>
__global__ void __launch_bounds__(256) pool_ln_kernel(PoolParams p) {
  const int lane = threadIdx.x % 32;
  const long long wid = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int G = p.C / p.hd;
  const long long total = (long long)p.B * p.To * p.Ho * p.Wo * G;
  if (wid >= total) return;
  const int grp = wid % G;
  long long pos = wid / G;
  const int wo = pos % p.Wo;
  pos /= p.Wo;
  const int ho = pos % p.Ho;
  pos /= p.Ho;
  const int to = pos % p.To;
  const int b = pos / p.To;
  const int c0 = grp * p.hd;

  float acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
  for (int dt = 0; dt < p.kT; ++dt) {
    const int ti = to * p.sT - p.kT / 2 + dt;
    if (ti < 0 || ti >= p.T) continue;
    for (int dh = 0; dh < p.kH; ++dh) {
      const int hi = ho * p.sH - p.kH / 2 + dh;
      if (hi < 0 || hi >= p.H) continue;
      for (int dw = 0; dw < p.kW; ++dw) {
        const int wi = wo * p.sW - p.kW / 2 + dw;
        if (wi < 0 || wi >= p.W) continue;
        const bf16* src =
            p.x + ((((size_t)b * p.T + ti) * p.H + hi) * p.W + wi) * p.C + c0;
        const float* wt = p.w + (size_t)((dt * p.kH + dh) * p.kW + dw) * p.C + c0;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          if (c < p.hd) acc[i] += __bfloat162float(src[c]) * wt[c];
        }
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    if (lane + 32 * i < p.hd) sum += acc[i];
  const float mean = warp_sum(sum) / p.hd;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    if (lane + 32 * i < p.hd) sq += (acc[i] - mean) * (acc[i] - mean);
  const float rstd = rsqrtf(warp_sum(sq) / p.hd + p.eps);
  bf16* dst = p.out +
      ((((size_t)b * p.To + to) * p.Ho + ho) * p.Wo + wo) * p.C + c0;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < p.hd)
      dst[c] = __float2bfloat16((acc[i] - mean) * rstd * p.g[c0 + c] + p.b[c0 + c]);
  }
}

struct MaxParams {
  const bf16* x;
  bf16* out;
  int B, T, H, W, C, kT, kH, kW, sT, sH, sW, To, Ho, Wo;
};

__global__ void __launch_bounds__(256) pool_max_kernel(MaxParams p) {
  const int C8 = p.C / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)p.B * p.To * p.Ho * p.Wo * C8;
  if (idx >= total) return;
  const int c = (idx % C8) * 8;
  long long pos = idx / C8;
  const int wo = pos % p.Wo;
  pos /= p.Wo;
  const int ho = pos % p.Ho;
  pos /= p.Ho;
  const int to = pos % p.To;
  const int b = pos / p.To;
  float mx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i] = -INFINITY;
  for (int dt = 0; dt < p.kT; ++dt) {
    const int ti = to * p.sT - p.kT / 2 + dt;
    if (ti < 0 || ti >= p.T) continue;
    for (int dh = 0; dh < p.kH; ++dh) {
      const int hi = ho * p.sH - p.kH / 2 + dh;
      if (hi < 0 || hi >= p.H) continue;
      for (int dw = 0; dw < p.kW; ++dw) {
        const int wi = wo * p.sW - p.kW / 2 + dw;
        if (wi < 0 || wi >= p.W) continue;
        float v[8];
        unpack8(*reinterpret_cast<const uint4*>(
                    p.x + ((((size_t)b * p.T + ti) * p.H + hi) * p.W + wi) * p.C + c),
                v);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (v[i] > mx[i] || v[i] != v[i]) mx[i] = v[i];  // NaN propagates
      }
    }
  }
  *reinterpret_cast<uint4*>(
      p.out + ((((size_t)b * p.To + to) * p.Ho + ho) * p.Wo + wo) * p.C + c) =
      pack8(mx);
}

}  // namespace

extern "C" int svit_pool_ln(const bf16* x, const float* w, const float* g,
                            const float* b, bf16* out, int B, int T, int H,
                            int W, int C, int kT, int kH, int kW, int sT,
                            int sH, int sW, int To, int Ho, int Wo, int hd,
                            float eps, cudaStream_t stream) {
  PoolParams p{x, w, g, b, out, B, T, H, W, C, kT, kH, kW, sT, sH, sW,
               To, Ho, Wo, hd, eps};
  const long long warps = (long long)B * To * Ho * Wo * (C / hd);
  const unsigned blocks = (unsigned)((warps + 7) / 8);
  const int cpl = (hd + 31) / 32;
  if (cpl == 1) pool_ln_kernel<1><<<blocks, 256, 0, stream>>>(p);
  else if (cpl == 2) pool_ln_kernel<2><<<blocks, 256, 0, stream>>>(p);
  else if (cpl == 3) pool_ln_kernel<3><<<blocks, 256, 0, stream>>>(p);
  else if (cpl == 4) pool_ln_kernel<4><<<blocks, 256, 0, stream>>>(p);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svit_pool_max(const bf16* x, bf16* out, int B, int T, int H,
                             int W, int C, int kT, int kH, int kW, int sT,
                             int sH, int sW, int To, int Ho, int Wo,
                             cudaStream_t stream) {
  MaxParams p{x, out, B, T, H, W, C, kT, kH, kW, sT, sH, sW, To, Ho, Wo};
  const long long threads = (long long)B * To * Ho * Wo * (C / 8);
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  pool_max_kernel<<<blocks, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
