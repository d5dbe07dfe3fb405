// K1 ln_linear: Y = epilogue(prologue(X) . W^T), bf16 in, f32 accumulate,
// written for Hopper (sm_90a): TMA loads and stores under mbarriers, wgmma
// from shared memory, and a resident LayerNorm panel.
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
//                                           ops are (ma, my: per-sample 0/1);
//   _ffn_kernel (fused_ffn)              -> two launches: LN -> fc1 + b1 ->
//                                           GELU, then fc2 + b2.
//
// What bounds it on the H100: by bytes and operations every use on the
// SViT-B/16 path is bound by device memory.  With an LN prologue K = C is
// 96..768 and the product does about K/2 flops per byte of X and Y moved,
// below the ~295 flop/byte ridge; fc2 (K = 4C) moves its [M, 4C] input once
// for 2C flops per element.  So the design reads each input once, keeps
// loads and products in flight and writes whole lines.
//
// Design.  Warp roles: one producer warp issues every TMA load (128-byte
// swizzled boxes of 64 columns, zero-filled past the tensor's edge) into a
// ring of slots, each with a full and an empty mbarrier; one or two
// consumer warpgroups run wgmma (m64n128k16, both operands from shared
// memory, f32 accumulators) and keep one group in flight, so a slot goes
// back to the producer as soon as the next chunk's products are issued and
// no consumer ever waits for a refill it asked for.  Two paths:
//  * PANEL (an LN or x_add prologue): the block's X rows, all of K (up to
//    1024), stay resident in shared memory.  The consumers form
//    s = round(x + round(round(x_add / keep) * ma)) in place (x_add read
//    once, coalesced; s leaves once, by TMA store straight from the panel),
//    take each row's mean and rstd from shared memory in f32 (all rows at
//    once), normalise and round the panel in place, then sweep the block's
//    N tiles: W tiles (BN x 64) stream through the ring while the prologue
//    runs.  X is read from device memory once, not once per column tile.
//    The padding columns past K stay zero.
//  * GEMM (no prologue: fc2 at K up to 3072, the out-projection): A and W
//    tiles both stream through the ring.
//  * A prologue past the panel (K > 1024: MViTv2-L's last stage, C = 1152):
//    a pass of its own (ln_rows_kernel, below) writes the rows prologue(x)
//    to device memory first, then the GEMM path takes them; s, where the use
//    adds it as the residual, is the pass's.
// Block shapes (the host's plan, ops/ln_linear.py, picks one per call):
// 64 rows and one consumer warpgroup, up to three blocks an SM, for the
// GEMM path and panels of K <= 192, where one block's prologue and
// epilogue run under another's products; one block an SM with two
// consumer warpgroups for wider panels, either 64 rows whose warpgroups
// take alternate N tiles, each with half of the ring, so that one's
// epilogue runs under the other's products (long sweeps, and K = 768,
// where a 128-row panel does not fit), or 128 rows, each warpgroup 64 of
// them, both reading each W tile.  Where the row panels leave SMs idle,
// several blocks share one panel and split its N sweep.
// Epilogue: the ops in the contract's order on the f32 fragment in
// registers (bias in f32, exact-erf GELU, one rounding; or round, then bias
// in bf16; then round(v / keep) * my; then + residual), each op after the
// rounding a correctly rounded bf16x2 op.  The bf16 tile goes to shared
// memory (64-byte swizzled 32-column sub-tiles, conflict-free from the
// fragment) and leaves by TMA store, clipped at the tensor's edges: plain
// 16-byte stores from each SM could not keep up with the writes.  The
// residual arrives the same way, by a TMA load issued when the tile starts.
// The q | kv split falls on a sub-tile edge on the SViT path (C is a
// multiple of 32); any other multiple of 8 stores the fragment's column
// pairs directly instead.
#include "hopper.cuh"

namespace {

constexpr int BN = 128;       // output columns per tile (one m64n128 wgmma)
constexpr int BK = 64;        // K per TMA box: 128 bytes, the swizzle span
constexpr int SUB = 32;       // columns of one output sub-tile (64-byte rows)
constexpr int SUB_BYTES = 64 * SUB * 2;  // a warpgroup's 64 rows of it
constexpr int SMEM_BLOCK_MAX = 232448;   // dynamic shared memory of a block

struct Params {
  int bm;  // rows per block: 64, or 128 (two warpgroups, 64 rows each)
  const bf16* x;
  const bf16* x_add;
  bf16* s_out;
  const float* ln_g;
  const float* ln_b;
  float eps;
  const float* bias;
  int bias_mode;  // 0 none, 1 f32 before the rounding, 2 bf16 after it
  const bf16* residual;
  bf16* out0;
  bf16* out1;
  int n_split;
  int M, N, K;
  const float* mask_add;  // [M / rows] 0/1: x_add becomes x_add / keep * mask
  const float* mask_out;  // [M / rows] 0/1: output becomes out / keep * mask
  float keep;             // the keep probability, rounded to bf16
  int rows;               // rows per sample (mask index = m / rows)
  int kc;                 // K chunks of BK
  int stages;             // ring slots
  int splits;             // blocks per row panel
  int tiles_per_split;    // N tiles each of them sweeps
  int direct;             // stores from the fragment, not TMA (see tma_out)
  float* out_f32;         // the f32 product alone: no bias, GELU, rounding,
                          // mask or residual (the tensor-parallel fc2's
                          // partial, summed across ranks before its bias)
};

// Shared memory, from the 1024-byte aligned base: [panel][ring][output tile
// (bf16, BN / SUB swizzled sub-tiles per consumer warpgroup)][bias (BN f32
// per consumer warpgroup)][LN weight | LN bias (kc * 64 f32 each, panel
// path)][full[stages] | empty[stages] | panel | residual[2] barriers].  The
// host sizes the launch with the same numbers (ops/ln_linear.py:
// ln_linear_smem mirrors them).
struct Layout {
  int ring, slot, ostg, sbias, lnp, bars, total;
  __host__ __device__ Layout(int bm, int ncw, bool panel, int kc,
                             int stages) {
    ring = panel ? bm * kc * 128 : 0;
    slot = BN * 128 + (panel ? 0 : bm * 128);
    ostg = ring + stages * slot;
    sbias = ostg + ncw * (BN / SUB) * SUB_BYTES;
    lnp = sbias + ncw * BN * 4;
    bars = lnp + (panel ? kc * BK * 8 : 0);
    total = bars + 8 * (2 * stages + 3);
  }
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// the 16-byte group j (columns 8j..8j+7) of row r of a bm-row panel: chunk
// j / 8, and within the row's 128-byte line the group index XOR (r mod 8),
// as TMA's 128-byte swizzle stores it
__device__ __forceinline__ uint4* panel_cell(uint8_t* panel, int bm, int r,
                                             int j) {
  return reinterpret_cast<uint4*>(panel + (j >> 3) * (bm * 128) + r * 128 +
                                   (((j & 7) ^ (r & 7)) << 4));
}

// s = round(x + round(round(x_add / keep) * ma)) in place, by the NC
// consumer threads
template <int NC>
__device__ __forceinline__ void form_sum(const Params& p, uint8_t* panel,
                                         int BM, uint64_t* panel_bar, int m0,
                                         int ctid) {
  const int G = p.K / 8, total = BM * G;
  for (int base = 0; base < total; base += 8 * NC) {
    uint4 xa[8];
    float ma[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {  // loads in flight before the panel lands
      const int gi = base + u * NC + ctid, r = gi / G;
      xa[u] = make_uint4(0, 0, 0, 0);
      ma[u] = 1.f;
      if (gi < total && m0 + r < p.M) {
        xa[u] = __ldg(reinterpret_cast<const uint4*>(
            p.x_add + (size_t)(m0 + r) * p.K + (gi - r * G) * 8));
        if (p.mask_add) ma[u] = __ldg(p.mask_add + (m0 + r) / p.rows);
      }
    }
    mbar_wait(panel_bar, 0);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int gi = base + u * NC + ctid, r = gi / G, j = gi - r * G;
      if (gi >= total || m0 + r >= p.M) continue;
      uint4* cell = panel_cell(panel, BM, r, j);
      float v[8], a[8];
      unpack8(*cell, v);
      unpack8(xa[u], a);
      if (p.mask_add) {  // a / keep * ma: two bf16 ops (the mask is exact)
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = round_bf16(a[i] / p.keep) * ma[u];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = v[i] + a[i];
      *cell = pack8(v);
    }
  }
}

// LayerNorm of each panel row in place, all rows at once: thread t takes
// part t / BM of row t % BM (NC / BM parts a row; a quarter warp reads 8
// rows' same group: 8 distinct swizzled slots), the parts' sums meet in
// ``red``; three passes over shared memory (sum; centred squares;
// normalise), in f32 with eps inside the rsqrt as the reference.  Rows
// past M are left as loaded.
template <int NC>
__device__ __forceinline__ void layer_norm_panel(const Params& p,
                                                 uint8_t* panel, int BM,
                                                 const float* lnp, float* red,
                                                 int m0, int tid) {
  const int parts = NC / BM, G = p.K / 8, per = (G + parts - 1) / parts;
  const int r = tid % BM, h = tid / BM, j0 = h * per, j1 = min(G, j0 + per);
  float v[8], sum = 0.f, sq = 0.f;
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    unpack8(*panel_cell(panel, BM, r, j), v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i];
  }
  red[h * BM + r] = sum;
  bar_sync<1, NC>();
  sum = 0.f;
  for (int q = 0; q < parts; ++q) sum += red[q * BM + r];
  const float mean = sum / p.K;
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    unpack8(*panel_cell(panel, BM, r, j), v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sq += (v[i] - mean) * (v[i] - mean);
  }
  bar_sync<1, NC>();  // every part has read the sums
  red[h * BM + r] = sq;
  bar_sync<1, NC>();
  sq = 0.f;
  for (int q = 0; q < parts; ++q) sq += red[q * BM + r];
  const float rstd = rsqrtf(sq / p.K + p.eps);
  if (m0 + r >= p.M) return;
#pragma unroll 2
  for (int j = j0; j < j1; ++j) {
    uint4* cell = panel_cell(panel, BM, r, j);
    unpack8(*cell, v);
    const float4* g4 = reinterpret_cast<const float4*>(lnp + 8 * j);
    const float4* b4 = reinterpret_cast<const float4*>(lnp + p.kc * BK + 8 * j);
    const float4 g0 = g4[0], g1 = g4[1], b0 = b4[0], b1 = b4[1];
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = (v[i] - mean) * rstd * g[i] + b[i];
    *cell = pack8(v);
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// One warpgroup's 64 x BN tile, straight from the f32 fragment: the ops in
// the contract's order (after the one rounding, each a correctly rounded
// bf16x2 op, as the contract's bf16 ops), into the bf16 tile ``ot`` (four
// 64 x 32 sub-tiles, 64-byte swizzled, the residual already in them), then
// one thread stores the sub-tiles with TMA.  ``direct``: each thread's
// column pairs go straight to out0 / out1 instead.  Fragment of m64nNk16:
// warp wl holds rows 16 wl + lane / 4 (+ 8), columns 8 j + 2 (lane % 4)
// (+ 1).
template <bool GELU, bool F32>
__device__ __forceinline__ void epilogue(const Params& p, float (&acc)[64],
                                         uint8_t* ot, const float* sb,
                                         const CUtensorMap* tm_o0,
                                         const CUtensorMap* tm_o1,
                                         const float (&my)[2], int mb, int n0,
                                         int wg, int wl, int lane) {
  const int tw = wl * 32 + lane, r0 = wl * 16 + lane / 4, c4 = 2 * (lane % 4);
  const uint32_t ot_a = smem_u32(ot);
  wg_sync(wg);  // the tile's bias is in; ``ot`` is free (or holds the residual)
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + c4;
    const float2 b = p.bias ? *reinterpret_cast<const float2*>(sb + col)
                            : make_float2(0.f, 0.f);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = r0 + 8 * h2;
      float t0 = acc[4 * j + 2 * h2], t1 = acc[4 * j + 2 * h2 + 1];
      if (F32) {  // a direct launch: each thread's column pairs
        const int m = mb + row, n = n0 + col;
        if (m < p.M && n < p.N)
          *reinterpret_cast<float2*>(p.out_f32 + (size_t)m * p.N + n) =
              make_float2(t0, t1);
        continue;
      }
      if (p.bias_mode == 1) {
        t0 += b.x;
        t1 += b.y;
      }
      if (GELU) {
        t0 = gelu_erf(t0);
        t1 = gelu_erf(t1);
      }
      __nv_bfloat162 h = __floats2bfloat162_rn(t0, t1);  // the one rounding
      if (p.bias_mode == 2) h = __hadd2(h, __floats2bfloat162_rn(b.x, b.y));
      if (p.mask_out) {  // round(y / keep) * mask: the mask is 0 or 1
        const float2 f = __bfloat1622float2(h);
        h = __hmul2(__floats2bfloat162_rn(f.x / p.keep, f.y / p.keep),
                    __floats2bfloat162_rn(my[h2], my[h2]));
      }
      if (!p.direct) {
        // sub-tile j / 4, 16-byte group j % 4 XOR bits 7-8 of the address
        const uint32_t a = ot_a + (j / 4) * SUB_BYTES + row * 64 +
                           (((j % 4) ^ ((row >> 1) & 3)) << 4) + c4 * 2;
        if (p.residual) {
          uint32_t r;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(r) : "r"(a));
          h = __hadd2(h, as_bf2(r));
        }
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(bits(h))
                     : "memory");
      } else {
        const int m = mb + row, n = n0 + col;
        if (m < p.M && n < p.N) {
          if (p.residual)
            h = __hadd2(h, as_bf2(__ldg(reinterpret_cast<const unsigned*>(
                               p.residual + (size_t)m * p.N + n))));
          if (n < p.n_split)
            *reinterpret_cast<uint32_t*>(p.out0 + (size_t)m * p.n_split + n) =
                bits(h);
          else
            *reinterpret_cast<uint32_t*>(p.out1 + (size_t)m * (p.N - p.n_split) +
                                         (n - p.n_split)) = bits(h);
        }
      }
    }
  }
  fence_async_smem();
  wg_sync(wg);  // every thread is done with ``sb`` (and has written ``ot``)
#pragma unroll
  for (int st = 0; st < BN / SUB; ++st) {
    const int nq = n0 + SUB * st;
    const bool go = tw == 0 && !p.direct && nq < p.N;
    tma_store_if(go && nq < p.n_split, tm_o0, ot + st * SUB_BYTES, nq, mb);
    tma_store_if(go && nq >= p.n_split, tm_o1, ot + st * SUB_BYTES,
                 nq - p.n_split, mb);
  }
  bulk_commit();
}

// Phase timestamps for a debug build (-DSVIT_K1_TRACE, k1_probe.py --trace):
// per block, 64 slots: 0 globaltimer at the start, 1 the SM, 2 clock64 at
// the start, 3 the prologue done, 4 + 30 wg + 3 j the tile j of warpgroup
// wg started, its products done, its epilogue done (j < 9), 62 clock64 and
// 63 globaltimer at the end.
#ifdef SVIT_K1_TRACE
__device__ unsigned long long* k1_trace;
__device__ __forceinline__ unsigned long long k1_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  return t;
}
#define K1_TRACE(pred, idx, val)                                   \
  do {                                                              \
    if (k1_trace && (pred)) k1_trace[blockIdx.x * 64 + (idx)] = (val); \
  } while (0)
#else
#define K1_TRACE(pred, idx, val) \
  do {                           \
  } while (0)
#endif

// The ring slot of K chunk c of the block's N tile t, and the round of
// that slot it fills.  Every waiter must consume its slots' loads in
// order: a wait more than one phase ahead of a barrier would take an old
// phase of the same parity for its own.  So in ping mode each warpgroup
// has half of the ring (the tiles alternate), else the loads go round the
// whole ring in order.
__device__ __forceinline__ void slot_of(int t, int c, int kc, int stages,
                                        bool ping, int& s, int& round) {
  const int half = ping ? stages / 2 : stages;
  const int li = ping ? (t / 2) * kc + c : t * kc + c;  // the owner's load
  s = (ping ? (t % 2) * half : 0) + li % half;
  round = li / half;
}

// Warp roles: NCW consumer warpgroups run wgmma and the epilogue; one
// producer warp (its lane 0) keeps the TMA ring full.  Each ring slot has a
// full barrier (the TMA bytes landed) and an empty one (every consuming warp
// is done with it), so a consumer never waits for a refill and keeps one
// wgmma group in flight: chunk c + 1 is issued before chunk c completes.
// NCW = 1: a 64-row block, up to three blocks an SM.  NCW = 2, one block an
// SM: with bm = 128 each warpgroup owns 64 rows and both read every W tile;
// with bm = 64 ("ping") both share the 64-row panel and take alternate N
// tiles, so one warpgroup's epilogue runs under the other's products.
// F32: the instance of the f32 mode (Params::out_f32), apart so that the
// others' epilogue carries no branch for it.
template <int NCW, bool PANEL, bool GELU, bool F32>
__global__ void __launch_bounds__(NCW * 128 + 32, NCW == 1 ? 3 : 1)
    ln_linear_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_s,
                     const __grid_constant__ CUtensorMap tm_o0,
                     const __grid_constant__ CUtensorMap tm_o1,
                     const __grid_constant__ CUtensorMap tm_r, Params p) {
  constexpr int NC = NCW * 128;  // consumer threads
  extern __shared__ __align__(1024) uint8_t smem[];  // 128-byte swizzle
  const int BM = NCW == 1 ? 64 : p.bm;
  const bool ping = BM < NCW * 64;
  const Layout L(BM, NCW, PANEL, p.kc, p.stages);
  uint8_t* panel = smem;
  uint8_t* ring = smem + L.ring;
  float* sbias = reinterpret_cast<float*>(smem + L.sbias);
  float* lnp = reinterpret_cast<float*>(smem + L.lnp);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + p.stages;
  uint64_t* panel_bar = empty + p.stages;
  uint64_t* res_bar = panel_bar + 1;  // one per consumer warpgroup

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x % p.splits;
  const int m0 = (blockIdx.x / p.splits) * BM;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int t_begin = split * p.tiles_per_split;
  const int nt = max(0, min(n_tiles, t_begin + p.tiles_per_split) - t_begin);
  // ring load i: K chunk i % kc of the block's N tile i / kc (W, and the A
  // tile of the streaming path), into the slot of slot_of
  const int total = nt * p.kc;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], ping ? 4 : 4 * NCW);  // lane 0 of each warp
    }
    for (int b = 0; b < 3; ++b) mbar_init(panel_bar + b, 1);
    mbar_init_fence();
  }
  if (PANEL && p.ln_g) {  // the LN weight and bias, once per block
    for (int k = tid; k < p.K; k += blockDim.x) {
      lnp[k] = __ldg(p.ln_g + k);
      lnp[p.kc * BK + k] = __ldg(p.ln_b + k);
    }
  }
  __syncthreads();
#ifdef SVIT_K1_TRACE
  if (tid == 0) {
    unsigned long long g, sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    asm volatile("{.reg .u32 r; mov.u32 r, %%smid; cvt.u64.u32 %0, r;}" : "=l"(sm));
    K1_TRACE(true, 0, g);
    K1_TRACE(true, 1, sm);
    K1_TRACE(true, 2, k1_clock());
  }
#endif

  if (warp == NCW * 4) {  // the producer warp
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_x))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_w))
                   : "memory");
      if (PANEL) {
        mbar_expect_tx(panel_bar, p.kc * BM * 128);
        for (int c = 0; c < p.kc; ++c)
          tma_load(panel + c * BM * 128, &tm_x, panel_bar, c * BK, m0);
      }
      for (int i = 0; i < total; ++i) {
        const int c = i % p.kc;
        int s, round;
        slot_of(i / p.kc, c, p.kc, p.stages, ping, s, round);
        mbar_wait(&empty[s], (round & 1) ^ 1);  // the slot is free
        uint8_t* dst = ring + s * L.slot;
        mbar_expect_tx(&full[s], L.slot);
        if (!PANEL) {
          tma_load(dst, &tm_x, &full[s], c * BK, m0);
          dst += BM * 128;
        }
        tma_load(dst, &tm_w, &full[s], c * BK, (t_begin + i / p.kc) * BN);
      }
    }
    return;
  }

  const int wg = warp / 4, wl = warp % 4, tw = tid % 128;
  const int row_off = ping ? 0 : wg * 64, mb = m0 + row_off;
  uint8_t* ot = smem + L.ostg + wg * (BN / SUB) * SUB_BYTES;
  float* sb = sbias + wg * BN;

  if (PANEL) {  // the prologue runs while the first W tiles arrive
    if (p.x_add) {
      form_sum<NC>(p, panel, BM, panel_bar, m0, tid);
      if (p.s_out && split == 0) {  // s leaves once, straight from the panel
        fence_async_smem();
        bar_sync<1, NC>();
        if (tid == 0) {
          for (int c = 0; c < p.kc; ++c)
            tma_store(&tm_s, panel + c * BM * 128, c * BK, m0);
          bulk_commit();
          bulk_wait_read();
        }
      }
      bar_sync<1, NC>();
    } else {
      mbar_wait(panel_bar, 0);
    }
    if (p.ln_g)
      layer_norm_panel<NC>(p, panel, BM, lnp,
                           reinterpret_cast<float*>(smem + L.ostg), m0, tid);
    fence_async_smem();  // the panel's generic writes, then wgmma reads it
    bar_sync<1, NC>();
  }
  K1_TRACE(tid == 0, 3, k1_clock());

  // this thread's two fragment rows keep their output mask for the block
  float my[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int m = mb + wl * 16 + lane / 4 + 8 * h2;
    my[h2] = p.mask_out && m < p.M ? __ldg(p.mask_out + m / p.rows) : 1.f;
  }
  const bool tma_residual = p.residual && !p.direct;
  const int t_step = ping ? 2 : 1;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int j = 0;  // this warpgroup's tiles so far (the residual barrier's phase)
  for (int t = ping ? wg : 0; t < nt; t += t_step, ++j) {
    const int n0 = (t_begin + t) * BN;
    K1_TRACE(tw == 0 && j < 9, 4 + wg * 30 + j * 3, k1_clock());
    // a tile starts: its bias, and its residual by TMA
    sb[tw] = p.bias && n0 + tw < p.N ? __ldg(p.bias + n0 + tw) : 0.f;
    bulk_wait_read();  // the last tile's stores have left ``ot``
    if (tma_residual) {
      const int subs = min(BN / SUB, (p.N - n0 + SUB - 1) / SUB);
      mbar_expect_tx_if(tw == 0, &res_bar[wg], subs * SUB_BYTES);
#pragma unroll
      for (int st = 0; st < BN / SUB; ++st)
        tma_load_if(tw == 0 && st < subs, ot + st * SUB_BYTES, &tm_r,
                    &res_bar[wg], n0 + SUB * st, mb);
    }
    int s = 0, round = 0, prev = 0;
    for (int c = 0; c < p.kc; ++c) {
      prev = s;
      slot_of(t, c, p.kc, p.stages, ping, s, round);
      mbar_wait(&full[s], round & 1);
      __syncwarp();  // wgmma is .aligned: the warp converged after the spin
      uint8_t* s_base = ring + s * L.slot;
      const uint8_t* a = PANEL ? panel + c * BM * 128 + row_off * 128
                               : s_base + row_off * 128;
      const uint8_t* b = PANEL ? s_base : s_base + BM * 128;
      const uint64_t da = desc_sw128(a), db = desc_sw128(b);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)  // +32 bytes along K per step
        wgmma_ss(acc, da + 2 * k, db + 2 * k, c > 0 || k > 0);
      wgmma_commit();
      // chunk c - 1's group is done: its slot goes back to the producer
      wgmma_wait<1>();
      mbar_arrive_if(c > 0 && lane == 0, &empty[prev]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive_if(lane == 0, &empty[s]);
    K1_TRACE(tw == 0 && j < 9, 5 + wg * 30 + j * 3, k1_clock());
    if (tma_residual) mbar_wait(&res_bar[wg], j & 1);
    epilogue<GELU, F32>(p, acc, ot, sb, &tm_o0, &tm_o1, my, mb, n0, wg, wl,
                        lane);
    K1_TRACE(tw == 0 && j < 9, 6 + wg * 30 + j * 3, k1_clock());
  }
  bulk_wait();  // this warpgroup's stores are done
#ifdef SVIT_K1_TRACE
  if (tid == 0) {
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    K1_TRACE(true, 63, g);
    K1_TRACE(true, 62, k1_clock());
  }
#endif
}

int encode(CUtensorMap* map, const bf16* ptr, int rows, int cols,
           int box_rows, int box_cols) {
  const long dims[3] = {cols, rows, 1};
  return encode_map(map, ptr, 2, dims, box_cols, box_rows,
                    box_cols == BK ? 128 : 64);
}

template <int NCW, bool PANEL, bool GELU, bool F32 = false>
int launch(const Params& p, const CUtensorMap (&maps)[6], int smem,
           cudaStream_t stream) {
  auto kernel = ln_linear_kernel<NCW, PANEL, GELU, F32>;
  static bool granted[64] = {};  // the shared-memory grant, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !granted[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BLOCK_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) granted[dev] = true;
  }
  const long blocks = (long)((p.M + p.bm - 1) / p.bm) * p.splits;
  kernel<<<(unsigned)blocks, NCW * 128 + 32, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return static_cast<int>(cudaGetLastError());
}

template <bool GELU>
int dispatch(const Params& p, const CUtensorMap (&maps)[6], int ncw,
             bool panel, int smem, cudaStream_t stream) {
  if (panel)
    return ncw == 2 ? launch<2, true, GELU>(p, maps, smem, stream)
                    : launch<1, true, GELU>(p, maps, smem, stream);
  return ncw == 2 ? launch<2, false, GELU>(p, maps, smem, stream)
                  : launch<1, false, GELU>(p, maps, smem, stream);
}

// K1's prologue pass, for an LN or x_add prologue past the resident panel
// (K > 1024; ops/ln_linear.py:ln_linear_plan picks it).  It replaces no TPU
// kernel of its own: it is the prologue of the same ones, the panel's rows
// written to device memory for the GEMM path.  Per row: s = round(x +
// round(round(x_add / keep) * ma)) (written where x_add is given, as the
// panel's s), then with the LN xn = round((s - mean) rstd g + b) with the
// statistics in f32 in the panel's own order, so that the two agree bit for
// bit wherever both apply: thread (r, h) of the block's R rows sums the
// 8-column groups h per .. (h + 1) per - 1 of row r in order, and the PARTS
// partial sums (the panel's consumer threads over its rows) meet in part
// order, as layer_norm_panel adds them.  A row reduction, bound by bytes: x
// (and x_add) read once, s and xn written once, coalesced.  The block's
// rows are staged in shared memory, each padded to an odd number of 16-byte
// units so that a quarter warp's eight rows fall on distinct banks.
struct RowsParams {
  const bf16* x;
  const bf16* x_add;      // or null
  const float* mask_add;  // [M / rows] 0/1, or null
  float keep;
  int rows;
  const float* ln_g;      // or null: s alone
  const float* ln_b;
  float eps;
  bf16* s_out;            // [M, K] where x_add is given
  bf16* xn;               // [M, K] with the LN
  int M, K, parts, R, stride;  // R rows a block; stride: a staged row's bytes
};

__global__ void __launch_bounds__(128) ln_rows_kernel(RowsParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* red = reinterpret_cast<float*>(smem + p.R * p.stride);  // [parts][R]
  float* stat = red + p.parts * p.R;                             // [R][2]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m0 = blockIdx.x * p.R, G = p.K / 8, total = p.R * G;
  for (int gi = tid; gi < total; gi += nt) {  // s, staged
    const int r = gi / G, j = gi - r * G, m = m0 + r;
    uint4 v4 = make_uint4(0, 0, 0, 0);
    if (m < p.M) {
      v4 = __ldg(reinterpret_cast<const uint4*>(p.x + (size_t)m * p.K) + j);
      if (p.x_add) {
        float v[8], a[8];
        unpack8(v4, v);
        unpack8(__ldg(reinterpret_cast<const uint4*>(p.x_add +
                                                     (size_t)m * p.K) + j),
                a);
        if (p.mask_add) {  // a / keep * ma: two bf16 ops (the mask is exact)
          const float ma = __ldg(p.mask_add + m / p.rows);
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = round_bf16(a[i] / p.keep) * ma;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = v[i] + a[i];
        v4 = pack8(v);
        if (p.s_out)
          reinterpret_cast<uint4*>(p.s_out + (size_t)m * p.K)[j] = v4;
      }
    }
    *reinterpret_cast<uint4*>(smem + r * p.stride + 16 * j) = v4;
  }
  if (!p.ln_g) return;  // no LN: the GEMM takes s
  __syncthreads();
  // the statistics, as layer_norm_panel takes them
  const int r = tid % p.R, h = tid / p.R, per = (G + p.parts - 1) / p.parts;
  const int j0 = h * per, j1 = min(G, j0 + per);
  const uint8_t* row = smem + r * p.stride;
  float v[8], sum = 0.f, sq = 0.f;
  for (int j = j0; j < j1; ++j) {
    unpack8(*reinterpret_cast<const uint4*>(row + 16 * j), v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i];
  }
  red[h * p.R + r] = sum;
  __syncthreads();
  sum = 0.f;
  for (int q = 0; q < p.parts; ++q) sum += red[q * p.R + r];
  const float mean = sum / p.K;
  for (int j = j0; j < j1; ++j) {
    unpack8(*reinterpret_cast<const uint4*>(row + 16 * j), v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sq += (v[i] - mean) * (v[i] - mean);
  }
  __syncthreads();  // every part has read the sums
  red[h * p.R + r] = sq;
  __syncthreads();
  sq = 0.f;
  for (int q = 0; q < p.parts; ++q) sq += red[q * p.R + r];
  if (h == 0) {
    stat[2 * r] = mean;
    stat[2 * r + 1] = rsqrtf(sq / p.K + p.eps);
  }
  __syncthreads();
  for (int gi = tid; gi < total; gi += nt) {  // normalise, round, store
    const int rr = gi / G, j = gi - rr * G, m = m0 + rr;
    if (m >= p.M) continue;
    const float mu = stat[2 * rr], rstd = stat[2 * rr + 1];
    unpack8(*reinterpret_cast<const uint4*>(smem + rr * p.stride + 16 * j), v);
    const float4* g4 = reinterpret_cast<const float4*>(p.ln_g + 8 * j);
    const float4* b4 = reinterpret_cast<const float4*>(p.ln_b + 8 * j);
    const float4 g0 = __ldg(g4), g1 = __ldg(g4 + 1);
    const float4 b0 = __ldg(b4), b1 = __ldg(b4 + 1);
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = (v[i] - mu) * rstd * g[i] + b[i];
    reinterpret_cast<uint4*>(p.xn + (size_t)m * p.K)[j] = pack8(v);
  }
}

// bytes of a staged row and of a block's shared memory, as
// ops/ln_linear.py:rows_pass_smem counts them
int rows_stride(int K) {
  const int units = K / 8;
  return 16 * (units % 2 ? units : units + 1);
}

int rows_smem(int K, int R, int parts) {
  return R * rows_stride(K) + 4 * (parts * R + 2 * R);
}

}  // namespace

extern "C" const char* svit_error_string(int err) {
  switch (err) {
    case ERR_PLAN:
      return "the launch plan does not fit the kernel";
    case ERR_ENTRY:
      return "cuTensorMapEncodeTiled not found in libcuda, or no context "
             "could be made current";
    case ERR_TMAP:
      return "cuTensorMapEncodeTiled refused a tensor map";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

#ifdef SVIT_K1_TRACE
extern "C" int svit_k1_set_trace(void* buf) {
  unsigned long long* p = static_cast<unsigned long long*>(buf);
  return static_cast<int>(cudaMemcpyToSymbol(k1_trace, &p, sizeof(p)));
}
#endif

// bm, ncw, stages, splits: the launch plan of ops/ln_linear.py:ln_linear_plan
extern "C" int svit_ln_linear(const bf16* x, const bf16* x_add, bf16* s_out,
                              const float* ln_g, const float* ln_b, float eps,
                              const bf16* w, const float* bias, int bias_mode,
                              int gelu, const bf16* residual, bf16* out0,
                              bf16* out1, float* out_f32, int n_split, int M,
                              int N, int K,
                              const float* mask_add, const float* mask_out,
                              float keep, int rows, int bm, int ncw,
                              int stages, int splits, cudaStream_t stream) {
  const bool panel = ln_g != nullptr || x_add != nullptr;
  const int kc = (K + BK - 1) / BK, n_tiles = (N + BN - 1) / BN;
  const bool ping = ncw == 2 && bm == 64;  // two slots each, at least
  if (!((ncw == 1 && bm == 64) || (ncw == 2 && (bm == 64 || bm == 128))) ||
      stages < (ping ? 4 : 2) || splits < 1 || splits > n_tiles || K % 8 ||
      N % 8)
    return ERR_PLAN;
  const Layout L(bm, ncw, panel, kc, stages);
  if (L.total > SMEM_BLOCK_MAX) return ERR_PLAN;
  // TMA stores need every output sub-tile inside one output of at least
  // SUB columns: the split on a sub-tile edge
  const bool tma_out = !out_f32 && n_split >= SUB &&
                       (n_split == N || n_split % SUB == 0) &&
                       (n_split == N || N - n_split >= SUB);
  if (out_f32 && (bias_mode || gelu || residual || mask_out ||
                  n_split != N || panel))
    return ERR_PLAN;
  Params p{bm, x, x_add, s_out, ln_g, ln_b, eps, bias, bias_mode, residual,
           out0, out1, n_split, M, N, K, mask_add, mask_out, keep, rows, kc,
           stages, splits, (n_tiles + splits - 1) / splits, !tma_out,
           out_f32};
  // x, w, s, out0, out1, residual (unused maps stay zero)
  CUtensorMap maps[6] = {};
  int rc = encode(&maps[0], x, M, K, bm, BK);
  if (!rc) rc = encode(&maps[1], w, N, K, BN, BK);
  if (!rc && s_out) rc = encode(&maps[2], s_out, M, K, bm, BK);
  if (!rc && tma_out) rc = encode(&maps[3], out0, M, n_split, 64, SUB);
  if (!rc && tma_out && out1)
    rc = encode(&maps[4], out1, M, N - n_split, 64, SUB);
  if (!rc && tma_out && residual) rc = encode(&maps[5], residual, M, N, 64, SUB);
  if (rc) return rc;
  if (out_f32)
    return ncw == 2 ? launch<2, false, false, true>(p, maps, L.total, stream)
                    : launch<1, false, false, true>(p, maps, L.total, stream);
  return gelu ? dispatch<true>(p, maps, ncw, panel, L.total, stream)
              : dispatch<false>(p, maps, ncw, panel, L.total, stream);
}

// K1's prologue pass (ln_rows_kernel): parts, R: the plan of
// ops/ln_linear.py:ln_linear_plan (the panel's parts a row, R rows a block)
extern "C" int svit_ln_rows(const bf16* x, const bf16* x_add,
                            const float* mask_add, float keep, int rows,
                            const float* ln_g, const float* ln_b, float eps,
                            bf16* s_out, bf16* xn, int M, int K, int parts,
                            int R, int smem, cudaStream_t stream) {
  if (K % 8 || parts < 1 || R < 1 || R * parts > 128 ||
      (ln_g != nullptr) != (xn != nullptr) || (x_add != nullptr) != (s_out != nullptr) ||
      (!x_add && !ln_g) || (mask_add && !x_add) || rows < 1 ||
      smem != rows_smem(K, R, parts) || smem > SMEM_BLOCK_MAX)
    return ERR_PLAN;
  static bool granted[64] = {};  // the shared-memory grant, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !granted[dev]) {
    e = cudaFuncSetAttribute(ln_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BLOCK_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) granted[dev] = true;
  }
  const RowsParams p{x, x_add, mask_add, keep, rows, ln_g, ln_b, eps,
                     s_out, xn, M, K, parts, R, rows_stride(K)};
  ln_rows_kernel<<<(unsigned)((M + R - 1) / R), R * parts, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
