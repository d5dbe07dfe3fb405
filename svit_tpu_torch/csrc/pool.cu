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
// K2 also has a bare mode (apply_ln = 0): the conv alone, rounded to bf16.
// That is pallas_depthwise_conv's forward (the same pool kernels with
// apply_ln=False), which fused_pool_ln's backward recomputes
// (_pool_ln_recompute).
// K3 replaces _kernel_strided_max (fused_pool_max): MaxPool3d with -inf
// padding k//2.
// K6 (depthwise_conv_dx) replaces the dx half of _pdc_bwd, which ran the
// pool kernel on the zero-stuffed f32 cotangent with flipped filters; here
// it is a transposed conv by gather that never writes the stuffed tensor.
// K7 (depthwise_conv_dk) replaces _dk_pallas (_kernel_dk_s1,
// _kernel_dk_strided): the filter gradient [kT*kH*kW, C] in f32.
//
// What bounds them on the H100: device memory.  K2 does 2*kT*kH*kW flops
// per output element on the CUDA cores (f32 FMA, 67 TFLOP/s) against one
// input read and one output write; K3 only compares; K6 reads g and writes
// dx; K7 reads x and g once each and writes 27 * C floats.  All are plain
// CUDA (not Triton): the conv is a gather over taps, which CUDA expresses
// directly.
//
// Design: K2 gives one warp to one (output position, head group); a lane
// holds up to 4 channels of the group (lane + 32 i), so the taps read
// coalesced 64-byte rows and the group's LN statistics are warp shuffles.
// The input rows are re-read per tap from L1/L2 (no shared-memory halo
// tile yet).  K3 and K6 give one thread to 8 channels of one position,
// 16-byte loads.  K7 reduces over up to 200,704 positions per (tap,
// channel): per-block partial sums, then a second pass over the blocks.
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
  int apply_ln;
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
  bf16* dst = p.out +
      ((((size_t)b * p.To + to) * p.Ho + ho) * p.Wo + wo) * p.C + c0;
  if (!p.apply_ln) {  // bare conv (the backward's recompute)
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < p.hd) dst[c] = __float2bfloat16(acc[i]);
    }
    return;
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

// K6: dx[b, i, c] = sum over taps u with (i + pad - u) % s == 0 and the
// quotient o in range of w[u, c] * g[b, o, c], f32 accumulation, one
// rounding.  One thread holds 8 channels of one input position.
struct DxParams {
  const bf16* g;   // [B, To, Ho, Wo, C]
  const float* w;  // [kT*kH*kW, C], tap-major, not flipped
  bf16* dx;        // [B, T, H, W, C]
  int B, T, H, W, C, kT, kH, kW, sT, sH, sW, To, Ho, Wo;
};

__global__ void __launch_bounds__(256) conv_dx_kernel(DxParams p) {
  const int C8 = p.C / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)p.B * p.T * p.H * p.W * C8;
  if (idx >= total) return;
  const int c = (idx % C8) * 8;
  long long pos = idx / C8;
  const int w = pos % p.W;
  pos /= p.W;
  const int h = pos % p.H;
  pos /= p.H;
  const int t = pos % p.T;
  const int b = pos / p.T;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int dt = 0; dt < p.kT; ++dt) {
    const int nt = t + p.kT / 2 - dt;
    if (nt < 0 || nt % p.sT) continue;
    const int to = nt / p.sT;
    if (to >= p.To) continue;
    for (int dh = 0; dh < p.kH; ++dh) {
      const int nh = h + p.kH / 2 - dh;
      if (nh < 0 || nh % p.sH) continue;
      const int ho = nh / p.sH;
      if (ho >= p.Ho) continue;
      for (int dw = 0; dw < p.kW; ++dw) {
        const int nw = w + p.kW / 2 - dw;
        if (nw < 0 || nw % p.sW) continue;
        const int wo = nw / p.sW;
        if (wo >= p.Wo) continue;
        float gv[8];
        unpack8(*reinterpret_cast<const uint4*>(
                    p.g + ((((size_t)b * p.To + to) * p.Ho + ho) * p.Wo + wo) * p.C + c),
                gv);
        const float* wt = p.w + (size_t)((dt * p.kH + dh) * p.kW + dw) * p.C + c;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += wt[i] * gv[i];
      }
    }
  }
  *reinterpret_cast<uint4*>(
      p.dx + ((((size_t)b * p.T + t) * p.H + h) * p.W + w) * p.C + c) = pack8(acc);
}

// K7, first pass: a block takes 32 channels and one chunk of the output
// positions; its 8 warps stride over the chunk, each lane holding the
// KT*3*3 tap sums of one channel in registers, and the 8 warps' sums are
// added in a fixed order through shared memory.  Second pass: the chunks'
// partial sums are added in chunk order.  No atomics: the result does not
// depend on scheduling.
struct DkParams {
  const bf16* x;    // [B, T, H, W, C]
  const bf16* g;    // [B, To, Ho, Wo, C]
  float* partial;   // [chunks, taps, C]
  int B, T, H, W, C, sT, sH, sW, To, Ho, Wo;
  long long per_chunk;
};

template <int KT>
__global__ void __launch_bounds__(256) conv_dk_partial_kernel(DkParams p) {
  constexpr int KH = 3, KW = 3, TAPS = KT * KH * KW;
  __shared__ float red[8][TAPS][32];
  const int lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  const int c = blockIdx.y * 32 + lane;
  const long long total = (long long)p.B * p.To * p.Ho * p.Wo;
  const long long p0 = blockIdx.x * p.per_chunk;
  const long long p1 = min(total, p0 + p.per_chunk);
  float acc[TAPS];
#pragma unroll
  for (int i = 0; i < TAPS; ++i) acc[i] = 0.f;
  if (c < p.C) {
    for (long long q = p0 + wp; q < p1; q += 8) {
      long long r = q;
      const int wo = r % p.Wo;
      r /= p.Wo;
      const int ho = r % p.Ho;
      r /= p.Ho;
      const int to = r % p.To;
      const int b = r / p.To;
      const float gv = __bfloat162float(p.g[q * p.C + c]);
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        const int ti = to * p.sT - KT / 2 + dt;
        if (ti < 0 || ti >= p.T) continue;
#pragma unroll
        for (int dh = 0; dh < KH; ++dh) {
          const int hi = ho * p.sH - KH / 2 + dh;
          if (hi < 0 || hi >= p.H) continue;
          const bf16* row = p.x + (((size_t)b * p.T + ti) * p.H + hi) * p.W * p.C + c;
#pragma unroll
          for (int dw = 0; dw < KW; ++dw) {
            const int wi = wo * p.sW - KW / 2 + dw;
            if (wi < 0 || wi >= p.W) continue;
            acc[(dt * KH + dh) * KW + dw] +=
                __bfloat162float(row[(size_t)wi * p.C]) * gv;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TAPS; ++i) red[wp][i][lane] = acc[i];
  __syncthreads();
  for (int e = threadIdx.x; e < TAPS * 32; e += 256) {
    const int tap = e / 32, l = e % 32, cc = blockIdx.y * 32 + l;
    if (cc >= p.C) continue;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += red[k][tap][l];
    p.partial[((size_t)blockIdx.x * TAPS + tap) * p.C + cc] = s;
  }
}

__global__ void __launch_bounds__(256) conv_dk_reduce_kernel(
    const float* partial, float* dk, int chunks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += partial[(size_t)k * n + i];
  dk[i] = s;
}

}  // namespace

extern "C" int svit_pool_ln(const bf16* x, const float* w, const float* g,
                            const float* b, bf16* out, int B, int T, int H,
                            int W, int C, int kT, int kH, int kW, int sT,
                            int sH, int sW, int To, int Ho, int Wo, int hd,
                            float eps, int apply_ln, cudaStream_t stream) {
  PoolParams p{x, w, g, b, out, B, T, H, W, C, kT, kH, kW, sT, sH, sW,
               To, Ho, Wo, hd, eps, apply_ln};
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

extern "C" int svit_conv_dx(const bf16* g, const float* w, bf16* dx, int B,
                            int T, int H, int W, int C, int kT, int kH,
                            int kW, int sT, int sH, int sW, int To, int Ho,
                            int Wo, cudaStream_t stream) {
  DxParams p{g, w, dx, B, T, H, W, C, kT, kH, kW, sT, sH, sW, To, Ho, Wo};
  const long long threads = (long long)B * T * H * W * (C / 8);
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  conv_dx_kernel<<<blocks, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svit_conv_dk(const bf16* x, const bf16* g, float* partial,
                            float* dk, int B, int T, int H, int W, int C,
                            int kT, int sT, int sH, int sW, int To, int Ho,
                            int Wo, int chunks, cudaStream_t stream) {
  const long long total = (long long)B * To * Ho * Wo;
  DkParams p{x, g, partial, B, T, H, W, C, sT, sH, sW, To, Ho, Wo,
             (total + chunks - 1) / chunks};
  dim3 grid(chunks, (C + 31) / 32);
  if (kT == 3) conv_dk_partial_kernel<3><<<grid, 256, 0, stream>>>(p);
  else if (kT == 1) conv_dk_partial_kernel<1><<<grid, 256, 0, stream>>>(p);
  else return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = kT * 9 * C;
  conv_dk_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, dk,
                                                             chunks, n);
  return static_cast<int>(cudaGetLastError());
}
