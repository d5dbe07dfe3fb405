// K2 pool_ln, K3 pool_max, K6 depthwise_conv_dx and K7 depthwise_conv_dk
// over channels-last [B, T, H, W, C] bf16 grids.
//
// What each replaces:
// * K2 replaces svit_tpu/ops/pallas_pool.py _kernel_s1 (stride 1, reached by
//   fused_pool_ln through _forward) and _kernel_strided (through
//   _forward_strided): a depthwise (1|3) x 3 x 3 conv with zero padding k//2
//   at spatial strides 1 to 8, accumulated in f32, then LayerNorm (eps 1e-6)
//   over each 96-channel head group with full-width scale/bias, so the fused
//   k|v pool is one launch.  Its bare mode (apply_ln = 0) is the conv alone,
//   rounded once to bf16: pallas_depthwise_conv's forward, which
//   fused_pool_ln's backward recomputes (_pool_ln_recompute).
// * K7 replaces _dk_pallas (_kernel_dk_s1, _kernel_dk_strided): the filter
//   gradient [taps, C] in f32, dk[tap, c] = sum over batch and output
//   positions of x_pad[out * s + tap, c] * g[out, c].
// * K3 replaces _kernel_strided_max (fused_pool_max): MaxPool3d with -inf
//   padding k//2.  K6 replaces the dx half of _pdc_bwd (the pool kernel on
//   the zero-stuffed cotangent with flipped filters) by a transposed conv by
//   gather that never writes the stuffed tensor.
//
// What bounds them on the H100.  By bytes: K2 reads the input rows that
// some window touches (all of x at stride <= 3, 9/16 of it at stride 4,
// 9/64 at 8) and writes its output; K7 reads the same rows of x and all of
// g.  By operations: 27 f32 multiply-adds per output element (K2) or per
// element of g (K7) on the CUDA cores, a third (K2) and two thirds (K7) of
// the memory time at stride 1.  Measured (PERF.md), both are bound by
// instruction issue instead: K2 spends about 200 instructions per output
// position of a warp (81 FFMA, 18 LDS, 27 bf16 unpacks, the LN's shuffles,
// the stores), and the 81 filter registers (about 168 a thread) hold an SM
// to 8 to 16 warps, which issue about 1.3 instructions a cycle between them.
// The TMA halo ring alone (no arithmetic) runs near the memory bound.
//
// Design of K2 and K7 (K3 and K6 are gathers, 8 channels a thread):
// * A block owns one 96-channel slab (blockIdx.y) and walks a list of tiles
//   (blockIdx.x, then every gridDim.x-th): a tile is `rows` output rows by
//   `cols` output columns of `frames` consecutive output frames of one clip.
//   ops/pool.py:pool_plan picks the tile (from a table tuned on the card),
//   the ring depth and the grid from the call's shapes; the kernel checks
//   that its shared memory matches.
// * A producer warp loads the tile's input frames, one at a time, by TMA
//   from a 5-D tensor map over [C, W, H, T, B] into a ring of frame slots
//   under full and empty mbarriers; the ring runs on across tiles, so the
//   next tile's first frames load while this one's last are used.  At stride
//   <= 2 a frame is one dense halo box from signed coordinates (w0 s - 1,
//   h0 s - 1): the hardware zero-fills everything outside the grid, so the
//   padding, the ragged edges and a 1-frame clip cost no branch.  At stride
//   >= 3 a frame is nine boxes, one per (dh, dw), each with traversal strides
//   (sW, sH): only the touched positions are loaded.  Frames outside the
//   clip are never loaded; which of an output frame's window lie in the clip
//   is a template argument of the row loop (one branch per output frame, none
//   inside it), so the loads of one tap row overlap the products of another.
// * K2: one warp per output row; lane l holds channels 2l, 2l+1 (one bf16x2
//   word) and 64 + l of the slab, its 81 filter taps in registers (loaded
//   once per block) and the LN statistics by warp shuffles.  At stride 1 the
//   warp slides along the row four columns a step: each halo column (3 rows
//   per frame) is read once from shared memory and feeds the three outputs
//   that use it; the four outputs a step completes are normalised together,
//   their shuffle reductions interleaved.  At other strides each output
//   reads its 27 taps from the tile.  Bare mode is the same loop without the
//   LN.  Output rows leave as 128 + 64-byte coalesced stores.
// * K7: the g tile of the frame comes by TMA into a second ring (2 slots).
//   A walker of 48 threads per output row, one bf16x2 channel pair a thread,
//   holds the 27 x 2 tap sums in registers; at stride 1 it slides along W,
//   so each x word read feeds three taps against the last three g words.
//   The walkers' sums meet in shared memory in walker order and the block
//   writes one partial per slab; a second pass adds the partials in a fixed
//   order.  No atomics: a rerun is bit-identical.
#include "hopper.cuh"

namespace {

constexpr int SLAB = 96;               // channels a block owns: one head group
constexpr int SMEM_BLOCK_MAX = 232448;  // dynamic shared memory of one block
constexpr int G_SLOTS = 2;             // K7's g ring
#ifdef SVIT_POOL_NO_MATH
// a diagnostic build (pool_probe.py --no-math): the tiles' loads and
// barriers run, the arithmetic and the stores do not
constexpr bool NO_MATH = true;
#else
constexpr bool NO_MATH = false;
#endif

// The call's shapes and its launch plan, with the shared-memory layout that
// ops/pool.py:pool_plan derives the same way.
struct Geo {
  int B, T, H, W, C, kT, sH, sW, To, Ho, Wo;
  int rows, cols, frames, ring, sparse;
  int bw, bh;           // a dense halo box's landed width and height
  int box_elems;        // one landed box's stride in the slot, in bf16
  int slot_bytes;       // one frame slot: 1 box, or 9 at stride >= 3
  int slot_tx;          // bytes TMA lands in a frame slot
  int g_bytes, g_tx;    // K7: one g slot, and the bytes landed in it
  int g_off, bar_off;   // offsets of the g ring and of the barriers
  int nw, nh, ntc, items;
  int consumers;        // consumer threads (the producer warp follows)
};

struct Item {
  int b, t_lo, t_hi, h0, w0, f_lo, f_hi;
};

// tile ``item`` of the list: w fastest, then h, the frame chunk, the clip
__device__ __forceinline__ Item item_of(const Geo& g, int item) {
  Item it;
  const int wx = item % g.nw;
  int r = item / g.nw;
  const int hy = r % g.nh;
  r /= g.nh;
  const int tc = r % g.ntc;
  it.b = r / g.ntc;
  it.t_lo = tc * g.frames;
  it.t_hi = min(g.To, it.t_lo + g.frames);
  it.h0 = hy * g.rows;
  it.w0 = wx * g.cols;
  const int pT = g.kT / 2;
  it.f_lo = max(0, it.t_lo - pT);
  it.f_hi = min(g.T - 1, it.t_hi - 1 - pT + g.kT - 1);
  return it;
}

// named barrier 1 over ``threads`` (a multiple of 32) threads
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// The producer (one thread): every input frame of every tile of this block,
// in the order the consumers use them; for K7 the tile's g frame follows the
// last input frame its output frame needs.
template <bool DK>
__device__ void produce(const Geo& g, const CUtensorMap* tx,
                        const CUtensorMap* tg, unsigned char* smem,
                        uint64_t* full, uint64_t* empty, uint64_t* gfull,
                        uint64_t* gempty, int c0) {
  uint32_t xi = 0, gi = 0;
  const int pT = g.kT / 2;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const Item it = item_of(g, item);
    int f = it.f_lo;
    for (int to = it.t_lo; to < it.t_hi; ++to) {
      const int last = min(it.f_hi, to - pT + g.kT - 1);
      for (; f <= last; ++f, ++xi) {
        const int s = xi % g.ring;
        if (xi >= (uint32_t)g.ring) mbar_wait(&empty[s], (xi / g.ring - 1) & 1);
        mbar_expect_tx(&full[s], g.slot_tx);
        unsigned char* dst = smem + s * g.slot_bytes;
        if (g.sparse) {
          for (int dh = 0; dh < 3; ++dh)
            for (int dw = 0; dw < 3; ++dw)
              tma_load_5d(dst + (dh * 3 + dw) * g.box_elems * 2, tx, &full[s],
                          c0, it.w0 * g.sW - 1 + dw, it.h0 * g.sH - 1 + dh, f,
                          it.b);
        } else {
          tma_load_5d(dst, tx, &full[s], c0, it.w0 * g.sW - 1,
                      it.h0 * g.sH - 1, f, it.b);
        }
      }
      if constexpr (DK) {
        const int s = gi % G_SLOTS;
        if (gi >= (uint32_t)G_SLOTS) mbar_wait(&gempty[s], (gi / G_SLOTS - 1) & 1);
        mbar_expect_tx(&gfull[s], g.g_tx);
        tma_load_5d(smem + g.g_off + s * g.g_bytes, tg, &gfull[s], c0, it.w0,
                    it.h0, to, it.b);
        ++gi;
      }
    }
  }
}

// The input frames of output frame ``to``: which of its KT frames lie in
// the clip, and the byte offsets of their slots in shared memory (after
// waiting for them to land).  Offsets, not pointers, keep the loads in the
// shared state space (LDS) and off 64-bit registers.
template <int KT>
__device__ __forceinline__ void frames_of(const Geo& g, const Item& it, int to,
                                          uint32_t xi, uint64_t* full,
                                          int (&slot)[KT], bool (&valid)[KT]) {
#pragma unroll
  for (int dt = 0; dt < KT; ++dt) {
    const int f = to - KT / 2 + dt;
    valid[dt] = f >= it.f_lo && f <= it.f_hi;
    slot[dt] = 0;
    if (valid[dt]) {
      const uint32_t idx = xi + (f - it.f_lo);
      const int s = idx % g.ring;
      mbar_wait(&full[s], (idx / g.ring) & 1);
      slot[dt] = s * g.slot_bytes;
    }
  }
}

// After output frame ``to``: hand back every frame that the next output
// frame of the tile does not use (all of them after the tile's last).
__device__ __forceinline__ void release(const Geo& g, const Item& it, int to,
                                        uint32_t xi, int& rel, uint64_t* empty) {
  const int upto = to == it.t_hi - 1 ? it.f_hi : min(it.f_hi, to - g.kT / 2);
  for (; rel <= upto; ++rel)
    mbar_arrive_if(true, &empty[(xi + (rel - it.f_lo)) % g.ring]);
}

// the byte offset of tap (dh, dw) of output column ``o`` of consumer row
// ``r`` in a frame slot: MODE 0/1 dense halo, MODE 2 nine strided boxes
template <int MODE>
__device__ __forceinline__ int tap_at(const Geo& g, int r, int o, int dh,
                                      int dw) {
  if constexpr (MODE == 2)
    return 2 * ((dh * 3 + dw) * g.box_elems + (r * g.cols + o) * SLAB);
  else
    return 2 * (((g.sH * r + dh) * g.bw + g.sW * o + dw) * SLAB);
}

struct PoolArgs {
  const float* w;  // [KT*9, C], tap-major
  const float* ln_g;
  const float* ln_b;
  bf16* out;
  float eps;
  int apply_ln;
};

// a lane's LN scale and bias
struct LnArgs {
  float2 g, b;        // channels 2l, 2l + 1 of the slab
  float g1, b1;       // channel 64 + l
};

// four output positions of the warp's row, v[0..3] (positions o0 .. o0 + 3,
// those in [first, last) stored, or all four if ALL): the LN over the slab
// (or none), bf16.  The four positions' shuffle reductions run interleaved.
template <bool ALL = false, int M>
__device__ __forceinline__ void emit4(bf16* row, int o0, int first, int last,
                                      const float (&v)[M][3], int lane,
                                      const PoolArgs& a, int C,
                                      const LnArgs& ln) {
  float y[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) y[i][k] = v[i][k];
  if (a.apply_ln) {
    float m[4], q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = y[i][0] + y[i][1] + y[i][2];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] += __shfl_xor_sync(0xffffffffu, m[i], o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] *= 1.f / SLAB;
#pragma unroll
      for (int k = 0; k < 3; ++k) y[i][k] -= m[i];
      q[i] = y[i][0] * y[i][0] + y[i][1] * y[i][1] + y[i][2] * y[i][2];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] += __shfl_xor_sync(0xffffffffu, q[i], o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float rstd = rsqrtf(q[i] * (1.f / SLAB) + a.eps);
      y[i][0] = y[i][0] * rstd * ln.g.x + ln.b.x;
      y[i][1] = y[i][1] * rstd * ln.g.y + ln.b.y;
      y[i][2] = y[i][2] * rstd * ln.g1 + ln.b1;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!ALL && (i < first || i >= last)) continue;
    bf16* dst = row + (ptrdiff_t)(o0 + i) * C;
    *reinterpret_cast<uint32_t*>(dst + 2 * lane) = pack_bf16(y[i][0], y[i][1]);
    dst[64 + lane] = __float2bfloat16(y[i][2]);
  }
}

__device__ __forceinline__ void fma3(float (&s)[3], float2 va, float vb,
                                     float2 ka, float kb) {
  s[0] = fmaf(va.x, ka.x, s[0]);
  s[1] = fmaf(va.y, ka.y, s[1]);
  s[2] = fmaf(vb, kb, s[2]);
}

// a bf16 pair of shared memory at byte offset ``off``, as two floats (a
// shift and a mask)
__device__ __forceinline__ float2 lds2(const unsigned char* smem, int off) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(smem + off);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ float lds1(const unsigned char* smem, int off) {
  const uint32_t h = *reinterpret_cast<const uint16_t*>(smem + off);
  return __uint_as_float(h << 16);
}

// What a K2 consumer warp needs for one output row of one output frame.
template <int KT>
struct K2Row {
  const unsigned char* smem;
  const Geo* g;
  int slot[KT];       // byte offsets of the window's frames
  int r, ncols, lane;
  bf16* row;          // output position (row, w0)
};

// K2 at W stride 1 over the window's frames D0 .. D0 + ND - 1 (those in the
// clip; no branch on them inside the loop): halo column j feeds outputs j
// (dw 0), j - 1 (dw 1) and j - 2 (dw 2).  Four columns a step: acc[q] is
// output j0 - 2 + q, and after the step outputs j0 - 2 .. j0 + 1 are
// complete.
template <int KT, int D0, int ND, bool FULL>
__device__ __forceinline__ void k2_step(const K2Row<KT>& c, const int (&rowo)[ND][3],
                                        int j0, int jend,
                                        const float2 (&ka)[KT * 9],
                                        const float (&kb)[KT * 9],
                                        float (&acc)[6][3]) {
  constexpr int COL = 2 * SLAB;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (!FULL && j0 + u >= jend) break;
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const int off = rowo[i][dh] + (j0 + u) * COL;
        const float2 va = lds2(c.smem, off + 4 * c.lane);
        const float vb = lds1(c.smem, off + 128 + 2 * c.lane);
        const int k = ((D0 + i) * 3 + dh) * 3;
        fma3(acc[u + 2], va, vb, ka[k], kb[k]);
        fma3(acc[u + 1], va, vb, ka[k + 1], kb[k + 1]);
        fma3(acc[u], va, vb, ka[k + 2], kb[k + 2]);
      }
  }
}

template <int KT, int D0, int ND>
__device__ __forceinline__ void k2_slide(const K2Row<KT>& c,
                                         const float2 (&ka)[KT * 9],
                                         const float (&kb)[KT * 9],
                                         const PoolArgs& a, const LnArgs& ln) {
  int rowo[ND][3];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
      rowo[i][dh] = c.slot[D0 + i] + tap_at<0>(*c.g, c.r, 0, dh, 0);
  float acc[6][3];
#pragma unroll
  for (int q = 0; q < 6; ++q) acc[q][0] = acc[q][1] = acc[q][2] = 0.f;
  const int jend = c.ncols + 2;
  int j0 = 0;
  for (; j0 + 4 <= jend; j0 += 4) {
    k2_step<KT, D0, ND, true>(c, rowo, j0, jend, ka, kb, acc);
    if (j0 >= 2)  // outputs j0 - 2 .. j0 + 1 all in the row
      emit4<true>(c.row, j0 - 2, 0, 4, acc, c.lane, a, c.g->C, ln);
    else
      emit4(c.row, j0 - 2, 2 - j0, 4, acc, c.lane, a, c.g->C, ln);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      acc[0][k] = acc[4][k];
      acc[1][k] = acc[5][k];
      acc[2][k] = acc[3][k] = acc[4][k] = acc[5][k] = 0.f;
    }
  }
  if (j0 < jend) {
    k2_step<KT, D0, ND, false>(c, rowo, j0, jend, ka, kb, acc);
    emit4(c.row, j0 - 2, max(0, 2 - j0), min(4, jend - j0), acc, c.lane, a,
          c.g->C, ln);
  }
}

// K2 at other strides: each output reads its taps from the tile, four
// outputs a step
template <int KT, int MODE, int D0, int ND>
__device__ __forceinline__ void k2_strided(const K2Row<KT>& c,
                                           const float2 (&ka)[KT * 9],
                                           const float (&kb)[KT * 9],
                                           const PoolArgs& a, const LnArgs& ln) {
  for (int o0 = 0; o0 < c.ncols; o0 += 4) {
    float acc[4][3];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc[u][0] = acc[u][1] = acc[u][2] = 0.f;
      const int o = min(o0 + u, c.ncols - 1);  // past the row: a repeat, not stored
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const int off = c.slot[D0 + i] + tap_at<MODE>(*c.g, c.r, o, dh, dw);
            const int k = ((D0 + i) * 3 + dh) * 3 + dw;
            fma3(acc[u], lds2(c.smem, off + 4 * c.lane),
                 lds1(c.smem, off + 128 + 2 * c.lane), ka[k], kb[k]);
          }
    }
    emit4(c.row, o0, 0, min(4, c.ncols - o0), acc, c.lane, a, c.g->C, ln);
  }
}

template <int KT, int MODE, int D0, int ND>
__device__ __forceinline__ void k2_row(const K2Row<KT>& c,
                                       const float2 (&ka)[KT * 9],
                                       const float (&kb)[KT * 9],
                                       const PoolArgs& a, const LnArgs& ln) {
  if constexpr (MODE == 0)
    k2_slide<KT, D0, ND>(c, ka, kb, a, ln);
  else
    k2_strided<KT, MODE, D0, ND>(c, ka, kb, a, ln);
}

// K2: a consumer warp per output row of the tile, and one producer warp
template <int KT, int MODE>
__global__ void __launch_bounds__(160) pool_ln_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ PoolArgs a,
    const __grid_constant__ Geo g) {
  constexpr int TAPS = KT * 9;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * SLAB;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  uint64_t* empty = full + g.ring;
  if (threadIdx.x == 0) {
    for (int i = 0; i < g.ring; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], g.consumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == g.rows) {
    if (lane == 0) produce<false>(g, &tx, nullptr, smem, full, empty, nullptr,
                                  nullptr, c0);
    return;
  }

  float2 ka[TAPS];
  float kb[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    const float* wk = a.w + (size_t)k * g.C + c0;
    ka[k] = *reinterpret_cast<const float2*>(wk + 2 * lane);
    kb[k] = wk[64 + lane];
  }
  LnArgs ln{make_float2(0.f, 0.f), make_float2(0.f, 0.f), 0.f, 0.f};
  if (a.apply_ln) {
    ln.g = *reinterpret_cast<const float2*>(a.ln_g + c0 + 2 * lane);
    ln.b = *reinterpret_cast<const float2*>(a.ln_b + c0 + 2 * lane);
    ln.g1 = a.ln_g[c0 + 64 + lane];
    ln.b1 = a.ln_b[c0 + 64 + lane];
  }

  K2Row<KT> c;
  c.smem = smem;
  c.g = &g;
  c.r = warp;
  c.lane = lane;
  uint32_t xi = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const Item it = item_of(g, item);
    const int oh = it.h0 + warp;
    c.ncols = min(g.cols, g.Wo - it.w0);
    int rel = it.f_lo;
    for (int to = it.t_lo; to < it.t_hi; ++to) {
      bool valid[KT];
      frames_of<KT>(g, it, to, xi, full, c.slot, valid);
      if (!NO_MATH && oh < g.Ho) {
        c.row = a.out +
            ((((size_t)it.b * g.To + to) * g.Ho + oh) * g.Wo + it.w0) * g.C + c0;
        // the middle frame is always in the clip; branch once on the others
        if constexpr (KT == 1)
          k2_row<KT, MODE, 0, 1>(c, ka, kb, a, ln);
        else if (valid[0] && valid[2])
          k2_row<KT, MODE, 0, 3>(c, ka, kb, a, ln);
        else if (valid[2])
          k2_row<KT, MODE, 1, 2>(c, ka, kb, a, ln);
        else if (valid[0])
          k2_row<KT, MODE, 0, 2>(c, ka, kb, a, ln);
        else
          k2_row<KT, MODE, 1, 1>(c, ka, kb, a, ln);
      }
      release(g, it, to, xi, rel, empty);
    }
    xi += it.f_hi - it.f_lo + 1;
  }
}

// What a K7 walker needs for one output row of one output frame.
template <int KT>
struct K7Row {
  const unsigned char* smem;
  const Geo* g;
  int slot[KT];
  int r, ncols;
  int grow;           // byte offset of the thread's pair of g at (row, w0)
  int pair;           // byte offset of the thread's pair in a position
};

__device__ __forceinline__ void fma2(float2& s, float2 v, float2 w) {
  s.x = fmaf(v.x, w.x, s.x);
  s.y = fmaf(v.y, w.y, s.y);
}

// K7 at W stride 1 over the window's frames D0 .. D0 + ND - 1: x column j
// pairs with g at outputs j (dw 0), j - 1 (dw 1) and j - 2 (dw 2); the last
// two columns see only the last two outputs.
template <int KT, int D0, int ND>
__device__ __forceinline__ void k7_column(const K7Row<KT>& c, const int (&rowo)[ND][3],
                                          int j, float2 g0, float2 g1, float2 g2,
                                          float2 (&acc)[KT * 9]) {
  constexpr int COL = 2 * SLAB;
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const float2 v = lds2(c.smem, rowo[i][dh] + j * COL);
      const int k = ((D0 + i) * 3 + dh) * 3;
      fma2(acc[k], v, g0);
      fma2(acc[k + 1], v, g1);
      fma2(acc[k + 2], v, g2);
    }
}

template <int KT, int D0, int ND>
__device__ __forceinline__ void k7_slide(const K7Row<KT>& c, float2 (&acc)[KT * 9]) {
  constexpr int COL = 2 * SLAB;
  int rowo[ND][3];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
      rowo[i][dh] = c.slot[D0 + i] + tap_at<0>(*c.g, c.r, 0, dh, 0) + c.pair;
  const float2 z = make_float2(0.f, 0.f);
  float2 g1 = z, g2 = z;
#pragma unroll 2
  for (int j = 0; j < c.ncols; ++j) {
    const float2 g0 = lds2(c.smem, c.grow + j * COL);
    k7_column<KT, D0, ND>(c, rowo, j, g0, g1, g2, acc);
    g2 = g1;
    g1 = g0;
  }
  k7_column<KT, D0, ND>(c, rowo, c.ncols, z, g1, g2, acc);
  k7_column<KT, D0, ND>(c, rowo, c.ncols + 1, z, z, g1, acc);
}

template <int KT, int MODE, int D0, int ND>
__device__ __forceinline__ void k7_strided(const K7Row<KT>& c, float2 (&acc)[KT * 9]) {
  constexpr int COL = 2 * SLAB;
#pragma unroll 2
  for (int o = 0; o < c.ncols; ++o) {
    const float2 gv = lds2(c.smem, c.grow + o * COL);
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw)
          fma2(acc[((D0 + i) * 3 + dh) * 3 + dw],
               lds2(c.smem, c.slot[D0 + i] + tap_at<MODE>(*c.g, c.r, o, dh, dw) + c.pair),
               gv);
  }
}

template <int KT, int MODE, int D0, int ND>
__device__ __forceinline__ void k7_row(const K7Row<KT>& c, float2 (&acc)[KT * 9]) {
  if constexpr (MODE == 0)
    k7_slide<KT, D0, ND>(c, acc);
  else
    k7_strided<KT, MODE, D0, ND>(c, acc);
}

// K7, first pass: walkers of 48 threads (one per output row of the tile),
// one channel pair a thread; one f32 partial [TAPS, slab] per block.
template <int KT, int MODE>
__global__ void __launch_bounds__(224) conv_dk_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tg, float* partial,
    const __grid_constant__ Geo g) {
  constexpr int TAPS = KT * 9;
  constexpr int COL = 2 * SLAB;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = blockIdx.y * SLAB;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  uint64_t* empty = full + g.ring;
  uint64_t* gfull = empty + g.ring;
  uint64_t* gempty = gfull + G_SLOTS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < g.ring; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], g.consumers);
    }
    for (int i = 0; i < G_SLOTS; ++i) {
      mbar_init(&gfull[i], 1);
      mbar_init(&gempty[i], g.consumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if ((int)threadIdx.x >= g.consumers) {
    if (threadIdx.x == g.consumers)
      produce<true>(g, &tx, &tg, smem, full, empty, gfull, gempty, c0);
    return;
  }

  const int ct = threadIdx.x;
  const int walker = ct / 48, pr = ct % 48;
  const bool active = walker < g.rows;
  float2 acc[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) acc[k] = make_float2(0.f, 0.f);

  K7Row<KT> c;
  c.smem = smem;
  c.g = &g;
  c.r = walker;
  c.pair = 4 * pr;
  uint32_t xi = 0, gi = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const Item it = item_of(g, item);
    c.ncols = min(g.cols, g.Wo - it.w0);
    const bool live = active && it.h0 + walker < g.Ho;
    int rel = it.f_lo;
    for (int to = it.t_lo; to < it.t_hi; ++to) {
      bool valid[KT];
      frames_of<KT>(g, it, to, xi, full, c.slot, valid);
      const int gs = gi % G_SLOTS;
      mbar_wait(&gfull[gs], (gi / G_SLOTS) & 1);
      c.grow = g.g_off + gs * g.g_bytes + walker * g.cols * COL + c.pair;
      if (!NO_MATH && live) {
        if constexpr (KT == 1)
          k7_row<KT, MODE, 0, 1>(c, acc);
        else if (valid[0] && valid[2])
          k7_row<KT, MODE, 0, 3>(c, acc);
        else if (valid[2])
          k7_row<KT, MODE, 1, 2>(c, acc);
        else if (valid[0])
          k7_row<KT, MODE, 0, 2>(c, acc);
        else
          k7_row<KT, MODE, 1, 1>(c, acc);
      }
      release(g, it, to, xi, rel, empty);
      mbar_arrive_if(true, &gempty[gs]);
      ++gi;
    }
    xi += it.f_hi - it.f_lo + 1;
  }

  // every frame has landed and been read: the ring takes the walkers' sums,
  // added in walker order
  consumers_sync(g.consumers);
  float* red = reinterpret_cast<float*>(smem);  // [rows][TAPS][SLAB]
  if (active) {
#pragma unroll
    for (int k = 0; k < TAPS; ++k)
      *reinterpret_cast<float2*>(red + (walker * TAPS + k) * SLAB + 2 * pr) = acc[k];
  }
  consumers_sync(g.consumers);
  for (int e = ct; e < TAPS * SLAB; e += g.consumers) {
    float s = 0.f;
    for (int w = 0; w < g.rows; ++w) s += red[w * TAPS * SLAB + e];
    partial[((size_t)blockIdx.x * TAPS + e / SLAB) * g.C + c0 + e % SLAB] = s;
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

// K7, second pass: dk[i] = the sum over the partials of partial[k][i].  A
// block takes 32 outputs; lane group q (of 8) adds partials q, q + 8, ...,
// then the eight sums are added in group order.  The order is fixed: a
// rerun is bit-identical.
__global__ void __launch_bounds__(256) conv_dk_reduce_kernel(
    const float* partial, float* dk, int chunks, int n) {
  __shared__ float red[8][32];
  const int e = threadIdx.x % 32, q = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + e;
  float s = 0.f;
  if (i < n)
    for (int k = q; k < chunks; k += 8) s += partial[(size_t)k * n + i];
  red[q][e] = s;
  __syncthreads();
  if (q == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][e];
    dk[i] = t;
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }
int round128(int bytes) { return (bytes + 127) / 128 * 128; }

// the layout and tile list of a launch plan, as ops/pool.py:pool_plan
// derives them; ERR_PLAN unless the plan's shared memory is this layout's
// and it fits the kernel
int make_geo(Geo& g, bool dk, int B, int T, int H, int W, int C, int kT,
             int sH, int sW, int To, int Ho, int Wo, int rows, int cols,
             int frames, int ring, int grid, int smem) {
  g = Geo{};
  g.B = B, g.T = T, g.H = H, g.W = W, g.C = C, g.kT = kT, g.sH = sH, g.sW = sW;
  g.To = To, g.Ho = Ho, g.Wo = Wo;
  g.rows = rows, g.cols = cols, g.frames = frames, g.ring = ring;
  if (rows < 1 || rows > 4 || cols < 1 || frames < 1 || ring < kT || ring > 8)
    return ERR_PLAN;
  g.sparse = sH > 2 || sW > 2;
  int landed;
  if (g.sparse) {  // nine boxes of rows x cols positions
    if (sH > 8 || sW > 8 || cols * sW > 256 || rows * sH > 256) return ERR_PLAN;
    g.bw = cols, g.bh = rows;
    landed = SLAB * rows * cols * 2;
    g.slot_bytes = 9 * round128(landed);
    g.slot_tx = 9 * landed;
  } else {         // one dense halo box
    g.bw = (cols - 1) * sW + 3, g.bh = (rows - 1) * sH + 3;
    if (g.bw > 256 || g.bh > 256) return ERR_PLAN;
    landed = SLAB * g.bw * g.bh * 2;
    g.slot_bytes = round128(landed);
    g.slot_tx = landed;
  }
  g.box_elems = round128(landed) / 2;
  g.g_tx = dk ? SLAB * rows * cols * 2 : 0;
  g.g_bytes = round128(g.g_tx);
  const int red = dk ? rows * kT * 9 * SLAB * 4 : 0;
  g.g_off = ring * g.slot_bytes > red ? ring * g.slot_bytes : red;
  g.bar_off = g.g_off + (dk ? G_SLOTS * g.g_bytes : 0);
  const int total = g.bar_off + 8 * (2 * ring + (dk ? 2 * G_SLOTS : 0));
  g.nw = cdiv(Wo, cols), g.nh = cdiv(Ho, rows), g.ntc = cdiv(To, frames);
  g.items = B * g.ntc * g.nh * g.nw;
  g.consumers = dk ? cdiv(48 * rows, 32) * 32 : 32 * rows;
  if (total != smem || smem > SMEM_BLOCK_MAX || grid < 1 || grid > g.items)
    return ERR_PLAN;
  return 0;
}

// the input grid [B, T, H, W, C]: one dense halo box, or at stride >= 3 a
// box of rows x cols positions at traversal strides (sW, sH)
int encode_x(CUtensorMap* map, const bf16* x, const Geo& g) {
  const long dims[5] = {g.C, g.W, g.H, g.T, g.B};
  if (g.sparse) {
    const int box[5] = {SLAB, g.cols * g.sW, g.rows * g.sH, 1, 1};
    const int step[5] = {1, g.sW, g.sH, 1, 1};
    return encode_map_5d(map, x, dims, box, step);
  }
  const int box[5] = {SLAB, g.bw, g.bh, 1, 1};
  const int step[5] = {1, 1, 1, 1, 1};
  return encode_map_5d(map, x, dims, box, step);
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

// MODE: 0 dense at stride 1 (the sliding loop), 1 dense strided, 2 the nine
// strided boxes
int mode_of(const Geo& g) {
  return g.sparse ? 2 : g.sW == 1 && g.sH == 1 ? 0 : 1;
}

template <int KT, int MODE>
int launch_pool(const Geo& g, const CUtensorMap& tx, const PoolArgs& a,
                int grid, int smem, cudaStream_t stream) {
  const int rc = grant<pool_ln_kernel<KT, MODE>>();
  if (rc) return rc;
  pool_ln_kernel<KT, MODE><<<dim3(grid, g.C / SLAB), g.consumers + 32, smem,
                             stream>>>(tx, a, g);
  return static_cast<int>(cudaGetLastError());
}

template <int KT>
int pool_mode(const Geo& g, const CUtensorMap& tx, const PoolArgs& a, int grid,
              int smem, cudaStream_t stream) {
  switch (mode_of(g)) {
    case 0: return launch_pool<KT, 0>(g, tx, a, grid, smem, stream);
    case 1: return launch_pool<KT, 1>(g, tx, a, grid, smem, stream);
    default: return launch_pool<KT, 2>(g, tx, a, grid, smem, stream);
  }
}

template <int KT, int MODE>
int launch_dk(const Geo& g, const CUtensorMap& tx, const CUtensorMap& tg,
              float* partial, int grid, int smem, cudaStream_t stream) {
  const int rc = grant<conv_dk_kernel<KT, MODE>>();
  if (rc) return rc;
  conv_dk_kernel<KT, MODE><<<dim3(grid, g.C / SLAB), g.consumers + 32, smem,
                             stream>>>(tx, tg, partial, g);
  return static_cast<int>(cudaGetLastError());
}

template <int KT>
int dk_mode(const Geo& g, const CUtensorMap& tx, const CUtensorMap& tg,
            float* partial, int grid, int smem, cudaStream_t stream) {
  switch (mode_of(g)) {
    case 0: return launch_dk<KT, 0>(g, tx, tg, partial, grid, smem, stream);
    case 1: return launch_dk<KT, 1>(g, tx, tg, partial, grid, smem, stream);
    default: return launch_dk<KT, 2>(g, tx, tg, partial, grid, smem, stream);
  }
}

}  // namespace

// K2.  The plan (rows, cols, frames, ring, grid, smem) is
// ops/pool.py:pool_plan's; kernels (1|3, 3, 3), T stride 1, C a multiple of
// 96 and, with the LN, head_dim 96.
extern "C" int svit_pool_ln(const bf16* x, const float* w, const float* g,
                            const float* b, bf16* out, int B, int T, int H,
                            int W, int C, int kT, int kH, int kW, int sT,
                            int sH, int sW, int To, int Ho, int Wo, int hd,
                            float eps, int apply_ln, int rows, int cols,
                            int frames, int ring, int grid, int smem,
                            cudaStream_t stream) {
  if (kH != 3 || kW != 3 || (kT != 1 && kT != 3) || sT != 1 || C % SLAB ||
      (apply_ln && hd != SLAB))
    return static_cast<int>(cudaErrorInvalidValue);
  Geo geo;
  int rc = make_geo(geo, false, B, T, H, W, C, kT, sH, sW, To, Ho, Wo, rows,
                    cols, frames, ring, grid, smem);
  if (rc) return rc;
  CUtensorMap tx;
  rc = encode_x(&tx, x, geo);
  if (rc) return rc;
  const PoolArgs a{w, g, b, out, eps, apply_ln};
  return kT == 3 ? pool_mode<3>(geo, tx, a, grid, smem, stream)
                 : pool_mode<1>(geo, tx, a, grid, smem, stream);
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

// K7: ``grid`` partials [grid, kT*9, C] from the first pass, added in a
// fixed order into dk [kT*9, C] by the second.
extern "C" int svit_conv_dk(const bf16* x, const bf16* g, float* partial,
                            float* dk, int B, int T, int H, int W, int C,
                            int kT, int sT, int sH, int sW, int To, int Ho,
                            int Wo, int rows, int cols, int frames, int ring,
                            int grid, int smem, cudaStream_t stream) {
  if ((kT != 1 && kT != 3) || sT != 1 || C % SLAB)
    return static_cast<int>(cudaErrorInvalidValue);
  Geo geo;
  int rc = make_geo(geo, true, B, T, H, W, C, kT, sH, sW, To, Ho, Wo, rows,
                    cols, frames, ring, grid, smem);
  if (rc) return rc;
  CUtensorMap tx, tg;
  rc = encode_x(&tx, x, geo);
  if (rc) return rc;
  const long gdims[5] = {C, Wo, Ho, To, B};
  const int gbox[5] = {SLAB, cols, rows, 1, 1};
  const int step[5] = {1, 1, 1, 1, 1};
  rc = encode_map_5d(&tg, g, gdims, gbox, step);
  if (rc) return rc;
  rc = kT == 3 ? dk_mode<3>(geo, tx, tg, partial, grid, smem, stream)
               : dk_mode<1>(geo, tx, tg, partial, grid, smem, stream);
  if (rc) return rc;
  const int n = kT * 9 * C;
  conv_dk_reduce_kernel<<<(n + 31) / 32, 256, 0, stream>>>(partial, dk, grid,
                                                           n);
  return static_cast<int>(cudaGetLastError());
}
