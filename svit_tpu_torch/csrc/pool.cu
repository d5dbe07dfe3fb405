// K2 pool_ln, K3 pool_max, K6 depthwise_conv_dx and K7 depthwise_conv_dk
// over channels-last [B, T, H, W, C] bf16 grids.
//
// What each replaces:
// * K2 replaces svit_tpu/ops/pallas_pool.py _kernel_s1 (stride 1, reached by
//   fused_pool_ln through _forward) and _kernel_strided (through
//   _forward_strided): a depthwise conv with zero padding k//2, accumulated
//   in f32, then LayerNorm (eps 1e-6) over each head group with full-width
//   scale/bias, so the fused k|v pool is one launch.  Its bare mode
//   (apply_ln = 0) is the conv alone, rounded once to bf16:
//   pallas_depthwise_conv's forward, which fused_pool_ln's backward
//   recomputes (_pool_ln_recompute).
// * K7 replaces _dk_pallas (_kernel_dk_s1, _kernel_dk_strided): the filter
//   gradient [taps, C] in f32, dk[tap, c] = sum over batch and output
//   positions of x_pad[out * s + tap, c] * g[out, c].
// * K6 replaces the dx half of _pdc_bwd (the pool kernel on the
//   zero-stuffed cotangent with flipped filters): at stride 1 it is K2's
//   bare loop on the flipped filter (the caller passes it); at other
//   strides a kernel walks base positions, one stride-sized cell of dx
//   each, and writes every parity class of the cell from its own taps,
//   never the stuffed tensor (dx_kernel at the main path's shapes, the
//   general instance elsewhere).
// * K3 replaces _kernel_strided_max (fused_pool_max): MaxPool3d with -inf
//   padding k//2, a gather, 8 channels a thread.  Its backward
//   (pool_max_bwd_kernel) replaces the VJP of reduce_window that JAX's
//   _pool_max_bwd takes (no pallas_call): a gather over the windows that
//   cover each input cell, reading the argmax taps the forward wrote.
//
// Two instances of the halo tile.  The tuned one takes the main path's
// shapes: (1|3) x 3 x 3 kernels at T stride 1 on 96-channel slabs (K2's LN
// on 96-channel heads).  The general one takes kernels (1|3, 3|5, 3|5), T
// stride 1 or 2 (K7: 1), spatial strides 1 to 8 (K7: sH = sW) and slabs of
// 64, 96 or 128 channels (K2's LN: one head); ops/pool.py:pool_plan picks
// the instance by shape and raises outside both.
//
// What bounds them on the H100.  By bytes: K2 reads the input rows that
// some window touches (all of x at stride <= 3, 9/16 of it at stride 4,
// 9/64 at 8) and writes its output; K7 reads the same rows of x and all of
// g; K6 reads g and writes dx.  By operations: 27 f32 multiply-adds per
// output element (K2) or per element of g (K6, K7) on the CUDA cores, a
// third (K2) and two thirds (K7) of the memory time at stride 1.  Measured
// (PERF.md), the tuned K2 and K7 are bound by instruction issue instead:
// K2 spends about 200 instructions per output position of a warp (81
// FFMA, 18 LDS, 27 bf16 unpacks, the LN's shuffles, the stores), and the
// 81 filter registers (about 168 a thread) hold an SM to 8 to 16 warps,
// which issue about 1.3 instructions a cycle between them.  The TMA halo
// ring alone (no arithmetic) runs near the memory bound.
//
// Design of the tuned K2 and K7:
// * A block owns one slab (blockIdx.y) and walks a list of tiles
//   (blockIdx.x, then every gridDim.x-th): a tile is `rows` rows by `cols`
//   columns of `frames` consecutive frames of base positions (the output
//   of K2 and K7) of one clip.  ops/pool.py:pool_plan picks the tile (from
//   a table tuned on the card), the ring depth and the grid from the call's
//   shapes; the kernel checks that its shared memory matches.
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
// The general instance (halo_gen_kernel, dk_gen_kernel) is described where
// it is defined.
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
// ops/pool.py:pool_plan derives the same way.  The tiles walk a grid of
// base positions (To, Ho, Wo): the pooled output for K2 and K7, one
// stride-sized cell of dx each for K6.  Base position q of an axis reads
// the input (x, or K6's g) at q * qs + o .. + span - 1 and writes the
// outputs q * os + r, one per class r of the axis (ops/pool.py:conv_axis).
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
  // the general instance (the tuned ones: qs (1, sH, sW), o (-kT/2, -1,
  // -1), span kT, fshift 0)
  int kH, kW, sT, dx;   // kernel, T stride; dx: K6's parity classes
  int S;                // channels of a slab
  int qsT, qsH, qsW;    // input step per base position
  int oT, oH, oW;       // input origin of base position 0
  int spT;              // input frames one base frame reads
  int fshift;           // 1 where the ring loads every other frame
  int Tout, Hout, Wout; // the output's extents
  int taps, ngroups;    // kT*kH*kW; K7's thread groups of 27 taps
  int filt_off, tab_off;
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
  it.f_lo = max(0, it.t_lo * g.qsT + g.oT);
  it.f_hi = min(g.T - 1, (it.t_hi - 1) * g.qsT + g.oT + g.spT - 1);
  return it;
}

// input frames a tile loads
__device__ __forceinline__ int frames_in(const Geo& g, const Item& it) {
  return ((it.f_hi - it.f_lo) >> g.fshift) + 1;
}

// named barrier 1 over ``threads`` (a multiple of 32) threads
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// The producer (one thread): every input frame of every tile of this block,
// in the order the consumers use them; for K7 the tile's g frame follows the
// last input frame its output frame needs.
template <bool DK>
__device__ __forceinline__ void produce(const Geo& g, const CUtensorMap* tx,
                        const CUtensorMap* tg, unsigned char* smem,
                        uint64_t* full, uint64_t* empty, uint64_t* gfull,
                        uint64_t* gempty, int c0) {
  uint32_t xi = 0, gi = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const Item it = item_of(g, item);
    int f = it.f_lo;
    for (int to = it.t_lo; to < it.t_hi; ++to) {
      const int last = min(it.f_hi, to * g.qsT + g.oT + g.spT - 1);
      for (; f <= last; f += 1 << g.fshift, ++xi) {
        const int s = xi % g.ring;
        if (xi >= (uint32_t)g.ring) mbar_wait(&empty[s], (xi / g.ring - 1) & 1);
        mbar_expect_tx(&full[s], g.slot_tx);
        unsigned char* dst = smem + s * g.slot_bytes;
        const int w = it.w0 * g.qsW + g.oW, h = it.h0 * g.qsH + g.oH;
        if (g.sparse) {
          for (int dh = 0; dh < 3; ++dh)
            for (int dw = 0; dw < 3; ++dw)
              tma_load_5d(dst + (dh * 3 + dw) * g.box_elems * 2, tx, &full[s],
                          c0, w + dw, h + dh, f, it.b);
        } else {
          tma_load_5d(dst, tx, &full[s], c0, w, h, f, it.b);
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

// The input frames of base frame ``to``: which of its KT frames lie in
// the clip, and the byte offsets of their slots in shared memory (after
// waiting for them to land).  Offsets, not pointers, keep the loads in the
// shared state space (LDS) and off 64-bit registers.
template <int KT>
__device__ __forceinline__ void frames_of(const Geo& g, const Item& it, int to,
                                          uint32_t xi, uint64_t* full,
                                          int (&slot)[KT], bool (&valid)[KT]) {
#pragma unroll
  for (int dt = 0; dt < KT; ++dt) {
    const int f = to * g.qsT + g.oT + dt;
    valid[dt] = dt < g.spT && f >= it.f_lo && f <= it.f_hi;
    slot[dt] = 0;
    if (valid[dt]) {
      const uint32_t idx = xi + ((f - it.f_lo) >> g.fshift);
      const int s = idx % g.ring;
      mbar_wait(&full[s], (idx / g.ring) & 1);
      slot[dt] = s * g.slot_bytes;
    }
  }
}

// After base frame ``to``: hand back every frame that the next base frame
// of the tile does not use (all of them after the tile's last).
__device__ __forceinline__ void release(const Geo& g, const Item& it, int to,
                                        uint32_t xi, int& rel, uint64_t* empty) {
  const int upto = to == it.t_hi - 1
                       ? it.f_hi
                       : min(it.f_hi, (to + 1) * g.qsT + g.oT - 1);
  for (; rel <= upto; rel += 1 << g.fshift)
    mbar_arrive_if(true,
                   &empty[(xi + ((rel - it.f_lo) >> g.fshift)) % g.ring]);
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
    xi += frames_in(g, it);
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
    xi += frames_in(g, it);
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
  uint8_t* arg;  // ARG: the window's argmax tap per output cell and channel
  int B, T, H, W, C, kT, kH, kW, sT, sH, sW, To, Ho, Wo;
};

// K3.  ARG (the instance a differentiated forward launches) also writes,
// for each output cell and channel, the tap (dt kH + dh) kW + dw of the
// window's first maximum in (t, h, w) scan order, counted over the taps
// inside the grid only: the -inf padding is never a candidate, so it never
// wins a tie.  A window whose values are all -inf keeps its first valid tap.
template <bool ARG>
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
  int am[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mx[i] = -INFINITY;
    am[i] = -1;
  }
  for (int dt = 0; dt < p.kT; ++dt) {
    const int ti = to * p.sT - p.kT / 2 + dt;
    if (ti < 0 || ti >= p.T) continue;
    for (int dh = 0; dh < p.kH; ++dh) {
      const int hi = ho * p.sH - p.kH / 2 + dh;
      if (hi < 0 || hi >= p.H) continue;
      for (int dw = 0; dw < p.kW; ++dw) {
        const int wi = wo * p.sW - p.kW / 2 + dw;
        if (wi < 0 || wi >= p.W) continue;
        const int tap = (dt * p.kH + dh) * p.kW + dw;
        float v[8];
        unpack8(*reinterpret_cast<const uint4*>(
                    p.x + ((((size_t)b * p.T + ti) * p.H + hi) * p.W + wi) * p.C + c),
                v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (ARG && am[i] < 0) am[i] = tap;  // the first valid tap
          if (v[i] > mx[i] || v[i] != v[i]) {  // NaN propagates
            mx[i] = v[i];
            if (ARG) am[i] = tap;
          }
        }
      }
    }
  }
  const size_t o = ((((size_t)b * p.To + to) * p.Ho + ho) * p.Wo + wo) * p.C + c;
  *reinterpret_cast<uint4*>(p.out + o) = pack8(mx);
  if (ARG) {
    uint2 a{0u, 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a.x |= ((uint32_t)am[i] & 0xffu) << (8 * i);
      a.y |= ((uint32_t)am[4 + i] & 0xffu) << (8 * i);
    }
    *reinterpret_cast<uint2*>(p.arg + o) = a;
  }
}

// K3's backward (pool_max_bwd), the VJP of reduce_window's max in gather
// form: a thread owns 8 channels of one input cell, visits the windows
// that cover it (at most ceil(k / s) a dimension) in (to, ho, wo) order,
// adds g in f32 where the window's argmax tap is this cell, and writes dx
// once in bf16.  No atomics: every run adds in the same order.  Bound by
// bytes: g and the argmax are read (about once at stride 2, kernel 3: the
// overlapping windows' rows come from L2) and dx written.
struct MaxBwdParams {
  const bf16* g;
  const uint8_t* arg;
  bf16* dx;
  int B, T, H, W, C, kT, kH, kW, sT, sH, sW, To, Ho, Wo;
};

// the outputs o of one axis whose window (o s - k / 2 .. + k - 1) holds
// i: x the first, y the last
__device__ __forceinline__ int2 covering(int i, int k, int s, int n) {
  const int a = i + k / 2 - k + 1;  // o s >= a
  return make_int2(a > 0 ? (a + s - 1) / s : 0, min((i + k / 2) / s, n - 1));
}

__global__ void __launch_bounds__(256) pool_max_bwd_kernel(MaxBwdParams p) {
  const int C8 = p.C / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)p.B * p.T * p.H * p.W * C8;
  if (idx >= total) return;
  const int c = (idx % C8) * 8;
  long long pos = idx / C8;
  const int wi = pos % p.W;
  pos /= p.W;
  const int hi = pos % p.H;
  pos /= p.H;
  const int ti = pos % p.T;
  const int b = pos / p.T;
  const int2 ot = covering(ti, p.kT, p.sT, p.To);
  const int2 oh = covering(hi, p.kH, p.sH, p.Ho);
  const int2 ow = covering(wi, p.kW, p.sW, p.Wo);
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int to = ot.x; to <= ot.y; ++to) {
    const int dt = ti - (to * p.sT - p.kT / 2);
    for (int ho = oh.x; ho <= oh.y; ++ho) {
      const int dh = hi - (ho * p.sH - p.kH / 2);
      for (int wo = ow.x; wo <= ow.y; ++wo) {
        const int dw = wi - (wo * p.sW - p.kW / 2);
        const uint32_t tap = (dt * p.kH + dh) * p.kW + dw;
        const size_t o =
            ((((size_t)b * p.To + to) * p.Ho + ho) * p.Wo + wo) * p.C + c;
        const uint2 a = __ldg(reinterpret_cast<const uint2*>(p.arg + o));
        const uint32_t pick =  // one bit per channel whose argmax is here
            (__vcmpeq4(a.x, tap * 0x01010101u) & 0x80808080u) |
            ((__vcmpeq4(a.y, tap * 0x01010101u) & 0x80808080u) >> 4);
        if (!pick) continue;
        float v[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(p.g + o)), v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (pick >> (8 * i + 7) & 1) acc[i] += v[i];
          if (pick >> (8 * i + 3) & 1) acc[4 + i] += v[4 + i];
        }
      }
    }
  }
  *reinterpret_cast<uint4*>(
      p.dx + ((((size_t)b * p.T + ti) * p.H + hi) * p.W + wi) * p.C + c) =
      pack8(acc);
}

// ---- the general instance: K2 and K6 (halo_gen_kernel), K7 (dk_gen_kernel)
//
// Any kernel (1|3, 3|5, 3|5), T stride 1 or 2, spatial strides 1 to 8 (sH
// and sW apart), a slab of S = 64, 96 or 128 channels (K2's LN: head_dim).
// The tile, the ring and the producer are the tuned instances'; a frame is
// always one dense halo box.  The filter slab sits in shared memory (75
// taps x S channels do not fit registers) and the taps come from a table
// built per block: for each class of output (one for K2; K6's parity
// classes, kT s_T x s_H x s_W of them) its entries, each an input frame,
// a byte offset in the frame slot from the base position's corner and a
// filter row.  K6 at stride s is then, per base position, s_T s_H s_W
// small sums with fixed taps: at stride 2 and k = 3 these are 1, 2, 2 and 4
// spatial taps, times those of T, and at strides 4 and 8 the classes that
// touch no tap write zeros with no loads.

// the bf16 pairs a lane holds (channels 64 i + 2 l, + 1) and, at S = 96,
// channel 64 + l
template <int S>
struct Lanes {
  static constexpr int NP = S / 64;
  static constexpr bool ONE = S % 64 != 0;
  static constexpr int NV = 2 * NP + (ONE ? 1 : 0);
};

// one tap of a class: its input frame (0 .. spT - 1), its byte offset in a
// frame slot from the base position's corner, its filter row's byte offset
struct Entry {
  int dt, off, woff;
};

// whether tap u of an axis (kernel k, stride s; ``dx`` for K6's parity
// classes, else one class of every tap) is in class r, and its offset in
// the window: ops/pool.py:conv_axis
__device__ __forceinline__ bool axis_tap(int k, int s, int dx, int org, int r,
                                         int u, int& off) {
  if (!dx) {
    off = u;
    return true;
  }
  const int v = r + k / 2 - u;
  if (((v % s) + s) % s) return false;
  off = v / s - org;
  return true;
}

// the class tables of a block (one thread): entries of class c at
// ent[cls[c]] .. ent[cls[c + 1] - 1], classes in (rT, rH, rW) order, taps
// in (uT, uH, uW) order
__device__ __forceinline__ void build_tables(const Geo& g, Entry* ent,
                                             int* cls) {
  const int RT = g.dx ? g.sT : 1, RH = g.dx ? g.sH : 1, RW = g.dx ? g.sW : 1;
  int n = 0, c = 0;
  for (int rt = 0; rt < RT; ++rt)
    for (int rh = 0; rh < RH; ++rh)
      for (int rw = 0; rw < RW; ++rw, ++c) {
        cls[c] = n;
        int ot, oh, ow;
        for (int ut = 0; ut < g.kT; ++ut) {
          if (!axis_tap(g.kT, g.sT, g.dx, g.oT, rt, ut, ot)) continue;
          for (int uh = 0; uh < g.kH; ++uh) {
            if (!axis_tap(g.kH, g.sH, g.dx, g.oH, rh, uh, oh)) continue;
            for (int uw = 0; uw < g.kW; ++uw) {
              if (!axis_tap(g.kW, g.sW, g.dx, g.oW, rw, uw, ow)) continue;
              ent[n++] = Entry{ot, 2 * g.S * (oh * g.bw + ow),
                               4 * g.S * ((ut * g.kH + uh) * g.kW + uw)};
            }
          }
        }
      }
  cls[c] = n;
}

__device__ __forceinline__ int pick3(const int (&v)[3], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : v[2];
}

// K2 (any mode) and K6: a consumer warp per base row of the tile, and one
// producer warp
template <int S>
__global__ void __launch_bounds__(160) halo_gen_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ PoolArgs a,
    const __grid_constant__ Geo g) {
  using L = Lanes<S>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * S;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  uint64_t* empty = full + g.ring;
  const unsigned char* filt = smem + g.filt_off;
  Entry* ent = reinterpret_cast<Entry*>(smem + g.tab_off);
  int* cls = reinterpret_cast<int*>(ent + g.taps);
  if (threadIdx.x == 0) {
    for (int i = 0; i < g.ring; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], g.consumers);
    }
    mbar_init_fence();
    build_tables(g, ent, cls);
  }
  float* fw = reinterpret_cast<float*>(smem + g.filt_off);
  for (int e = threadIdx.x; e < g.taps * S; e += blockDim.x)
    fw[e] = a.w[(size_t)(e / S) * g.C + c0 + e % S];
  __syncthreads();
  if (warp == g.rows) {
    if (lane == 0) produce<false>(g, &tx, nullptr, smem, full, empty, nullptr,
                                  nullptr, c0);
    return;
  }

  float lg[L::NV], lb[L::NV];
#pragma unroll
  for (int i = 0; i < L::NP; ++i) {
    const int ch = c0 + 64 * i + 2 * lane;
    lg[2 * i] = a.apply_ln ? a.ln_g[ch] : 0.f;
    lg[2 * i + 1] = a.apply_ln ? a.ln_g[ch + 1] : 0.f;
    lb[2 * i] = a.apply_ln ? a.ln_b[ch] : 0.f;
    lb[2 * i + 1] = a.apply_ln ? a.ln_b[ch + 1] : 0.f;
  }
  if constexpr (L::ONE) {
    lg[L::NV - 1] = a.apply_ln ? a.ln_g[c0 + 64 + lane] : 0.f;
    lb[L::NV - 1] = a.apply_ln ? a.ln_b[c0 + 64 + lane] : 0.f;
  }
  const int RH = g.dx ? g.sH : 1, RW = g.dx ? g.sW : 1;
  const int ncls = (g.dx ? g.sT : 1) * RH * RW;
  uint32_t xi = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const Item it = item_of(g, item);
    const int qh = it.h0 + warp;
    const int ncols = min(g.cols, g.Wo - it.w0);
    int rel = it.f_lo;
    for (int to = it.t_lo; to < it.t_hi; ++to) {
      int slot[3];
      bool valid[3];
      frames_of<3>(g, it, to, xi, full, slot, valid);
#pragma unroll
      for (int i = 0; i < 3; ++i) slot[i] = valid[i] ? slot[i] : -1;
      for (int q = 0; !NO_MATH && qh < g.Ho && q < ncols * ncls; ++q) {
        // base column o, class (rt, rh, rw)
        const int o = q / ncls, c = q % ncls;
        const int rw = c % RW, rh = c / RW % RH, rt = c / (RW * RH);
        const int ot = to * (g.dx ? g.sT : 1) + rt;
        const int oh = qh * RH + rh, ow = (it.w0 + o) * RW + rw;
        if (ot >= g.Tout || oh >= g.Hout || ow >= g.Wout) continue;
        const int base = 2 * S * (warp * g.qsH * g.bw + o * g.qsW);
        float acc[L::NV];
#pragma unroll
        for (int i = 0; i < L::NV; ++i) acc[i] = 0.f;
        for (int e = cls[c]; e < cls[c + 1]; ++e) {
          const Entry en = ent[e];
          const int so = pick3(slot, en.dt);
          if (so < 0) continue;
          const int off = so + base + en.off;
#pragma unroll
          for (int i = 0; i < L::NP; ++i) {
            const float2 v = lds2(smem, off + 128 * i + 4 * lane);
            const float2 w = *reinterpret_cast<const float2*>(
                filt + en.woff + 256 * i + 8 * lane);
            acc[2 * i] = fmaf(v.x, w.x, acc[2 * i]);
            acc[2 * i + 1] = fmaf(v.y, w.y, acc[2 * i + 1]);
          }
          if constexpr (L::ONE) {
            const float v = lds1(smem, off + 128 + 2 * lane);
            const float w = *reinterpret_cast<const float*>(
                filt + en.woff + 256 + 4 * lane);
            acc[L::NV - 1] = fmaf(v, w, acc[L::NV - 1]);
          }
        }
        if (a.apply_ln) {
          float m = 0.f;
#pragma unroll
          for (int i = 0; i < L::NV; ++i) m += acc[i];
          m = warp_sum(m) * (1.f / S);
          float v2 = 0.f;
#pragma unroll
          for (int i = 0; i < L::NV; ++i) {
            acc[i] -= m;
            v2 += acc[i] * acc[i];
          }
          const float rstd = rsqrtf(warp_sum(v2) * (1.f / S) + a.eps);
#pragma unroll
          for (int i = 0; i < L::NV; ++i) acc[i] = acc[i] * rstd * lg[i] + lb[i];
        }
        bf16* dst = a.out +
            ((((size_t)it.b * g.Tout + ot) * g.Hout + oh) * g.Wout + ow) * g.C +
            c0;
#pragma unroll
        for (int i = 0; i < L::NP; ++i)
          *reinterpret_cast<uint32_t*>(dst + 64 * i + 2 * lane) =
              pack_bf16(acc[2 * i], acc[2 * i + 1]);
        if constexpr (L::ONE) dst[64 + lane] = __float2bfloat16(acc[L::NV - 1]);
      }
      release(g, it, to, xi, rel, empty);
    }
    xi += frames_in(g, it);
  }
}

// K6 at the main path's shapes: a (1|3) x 3 x 3 filter at stride (1, SS,
// SS), SS = 2, 4 or 8, on 96-channel slabs.  The general instance's plan
// and tile (a base position is an SS x SS cell of dx; its g window is 2 x
// 2 positions, span 2, origin 0), with everything the general instance
// reads from tables fixed at compile time: the filter in registers (lane l
// holds channels 2l, 2l + 1 and 64 + l, as the tuned K2), the window's four
// g vectors of each frame loaded once per base position, and the SS x SS
// classes unrolled, each summing its 1, 2 or 4 spatial taps (times the
// frames of T) or, where it has none, storing zeros with no loads.

// tap u of a k = 3 axis at stride SS is in class r when (r + 1 - u) % SS
// == 0, and then reads the window at (r + 1 - u) / SS (0 or 1)
__host__ __device__ constexpr bool k3_hit(int SS, int r, int u) {
  return ((r + 1 - u) % SS + SS) % SS == 0;
}

template <int KT, int SS>
__global__ void __launch_bounds__(160) dx_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ PoolArgs a,
    const __grid_constant__ Geo g) {
  constexpr int TAPS = KT * 9;
  constexpr int COL = 2 * SLAB;
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
  uint32_t xi = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const Item it = item_of(g, item);
    const int qh = it.h0 + warp;
    const int ncols = min(g.cols, g.Wo - it.w0);
    int rel = it.f_lo;
    for (int to = it.t_lo; to < it.t_hi; ++to) {
      int slot[3];
      bool valid[3];
      frames_of<3>(g, it, to, xi, full, slot, valid);
      if (!NO_MATH && qh < g.Ho) {
        bf16* plane = a.out + ((size_t)it.b * g.Tout + to) * g.Hout * g.Wout *
                                  (size_t)g.C + c0;
        for (int o = 0; o < ncols; ++o) {
          // the g window of the base position in each frame (zeros for a
          // frame outside the clip); frame slot dt holds filter frame
          // KT - 1 - dt
          float2 va[KT][2][2];
          float vb[KT][2][2];
#pragma unroll
          for (int dt = 0; dt < KT; ++dt)
#pragma unroll
            for (int dh = 0; dh < 2; ++dh)
#pragma unroll
              for (int dw = 0; dw < 2; ++dw) {
                va[dt][dh][dw] = make_float2(0.f, 0.f);
                vb[dt][dh][dw] = 0.f;
                if (valid[dt]) {
                  const int off =
                      slot[dt] + ((warp + dh) * g.bw + o + dw) * COL;
                  va[dt][dh][dw] = lds2(smem, off + 4 * lane);
                  vb[dt][dh][dw] = lds1(smem, off + 128 + 2 * lane);
                }
              }
#pragma unroll
          for (int rh = 0; rh < SS; ++rh) {
            const int oh = qh * SS + rh;
#pragma unroll
            for (int rw = 0; rw < SS; ++rw) {
              const int ow = (it.w0 + o) * SS + rw;
              float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
              for (int uh = 0; uh < 3; ++uh) {
                if (!k3_hit(SS, rh, uh)) continue;
#pragma unroll
                for (int uw = 0; uw < 3; ++uw) {
                  if (!k3_hit(SS, rw, uw)) continue;
                  const int dh = (rh + 1 - uh) / SS, dw = (rw + 1 - uw) / SS;
#pragma unroll
                  for (int dt = 0; dt < KT; ++dt) {
                    const int k = ((KT - 1 - dt) * 3 + uh) * 3 + uw;
                    fma3(acc, va[dt][dh][dw], vb[dt][dh][dw], ka[k], kb[k]);
                  }
                }
              }
              if (oh < g.Hout && ow < g.Wout) {
                bf16* dst = plane + ((size_t)oh * g.Wout + ow) * g.C;
                *reinterpret_cast<uint32_t*>(dst + 2 * lane) =
                    pack_bf16(acc[0], acc[1]);
                dst[64 + lane] = __float2bfloat16(acc[2]);
              }
            }
          }
        }
      }
      release(g, it, to, xi, rel, empty);
    }
    xi += frames_in(g, it);
  }
}

// K7, general first pass: thread group q (S / 2 threads, one channel pair
// each) sums taps 27 q .. 27 q + 26 over every base position of the tile;
// one f32 partial [taps, slab] per block, written by the thread that owns
// it.  Its ring is the tuned K7's: x frames and the g tile of each frame.
template <int S>
__global__ void __launch_bounds__(224) dk_gen_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tg, float* partial,
    const __grid_constant__ Geo g) {
  constexpr int COL = 2 * S;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = blockIdx.y * S;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  uint64_t* empty = full + g.ring;
  uint64_t* gfull = empty + g.ring;
  uint64_t* gempty = gfull + G_SLOTS;
  Entry* ent = reinterpret_cast<Entry*>(smem + g.tab_off);
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
    build_tables(g, ent, reinterpret_cast<int*>(ent + g.taps));
  }
  __syncthreads();
  if ((int)threadIdx.x >= g.consumers) {
    if (threadIdx.x == g.consumers)
      produce<true>(g, &tx, &tg, smem, full, empty, gfull, gempty, c0);
    return;
  }

  const int ct = threadIdx.x;
  const int pair = ct % (S / 2), grp = ct / (S / 2);
  const int k0 = grp * 27;
  const int nk = grp < g.ngroups ? min(27, g.taps - k0) : 0;
  float2 acc[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) acc[k] = make_float2(0.f, 0.f);
  uint32_t xi = 0, gi = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const Item it = item_of(g, item);
    const int ncols = min(g.cols, g.Wo - it.w0);
    const int nrows = min(g.rows, g.Ho - it.h0);
    int rel = it.f_lo;
    for (int to = it.t_lo; to < it.t_hi; ++to) {
      int slot[3];
      bool valid[3];
      frames_of<3>(g, it, to, xi, full, slot, valid);
#pragma unroll
      for (int i = 0; i < 3; ++i) slot[i] = valid[i] ? slot[i] : -1;
      const int gs = gi % G_SLOTS;
      mbar_wait(&gfull[gs], (gi / G_SLOTS) & 1);
      const int gbase = g.g_off + gs * g.g_bytes + 4 * pair;
      if (!NO_MATH) {
#pragma unroll
        for (int j = 0; j < 27; ++j) {
          if (j >= nk) break;
          const Entry en = ent[k0 + j];
          const int so = pick3(slot, en.dt);
          if (so < 0) continue;
          const int xb = so + en.off + 4 * pair;
          for (int r = 0; r < nrows; ++r)
            for (int o = 0; o < ncols; ++o)
              fma2(acc[j],
                   lds2(smem, xb + (r * g.qsH * g.bw + o * g.qsW) * COL),
                   lds2(smem, gbase + (r * g.cols + o) * COL));
        }
      }
      release(g, it, to, xi, rel, empty);
      mbar_arrive_if(true, &gempty[gs]);
      ++gi;
    }
    xi += frames_in(g, it);
  }
#pragma unroll
  for (int j = 0; j < 27; ++j)
    if (j < nk)
      *reinterpret_cast<float2*>(
          partial + ((size_t)blockIdx.x * g.taps + k0 + j) * g.C + c0 +
          2 * pair) = acc[j];
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
int out_size(int n, int k, int s) { return (n + 2 * (k / 2) - k) / s + 1; }

enum Kind { POOL = 0, DK = 1, DX = 2 };
constexpr int TAB_BYTES = 2048;  // the general instance's tap tables
constexpr int GROUP_TAPS = 27;

// one axis of the base grid (ops/pool.py:conv_axis): n is the conv's input
// extent; in_ext the extent of the tensor the ring loads (x, or K6's g)
void axis_of(int n, int k, int s, bool dx, int& qs, int& org, int& span,
             int& base, int& in_ext, int& out) {
  const int p = k / 2;
  if (!dx) {
    qs = s, org = -p, span = k;
    base = out = out_size(n, k, s);
    in_ext = n;
    return;
  }
  int dmin = 1 << 20, dmax = -(1 << 20);
  for (int r = 0; r < s; ++r)
    for (int u = 0; u < k; ++u) {
      const int v = r + p - u;
      if (((v % s) + s) % s) continue;
      dmin = v / s < dmin ? v / s : dmin;
      dmax = v / s > dmax ? v / s : dmax;
    }
  qs = 1, org = dmin, span = dmax - dmin + 1;
  base = cdiv(n, s);
  in_ext = out_size(n, k, s);
  out = n;
}

// the layout and tile list of a launch plan, as ops/pool.py:pool_plan
// derives them; ERR_PLAN unless the plan's shared memory is this layout's
// and it fits the kernel.  ``gen``: the general instance.  B .. W are the
// conv's input (K6: dx's shape).
int make_geo(Geo& g, int kind, bool gen, int S, int B, int T, int H, int W,
             int C, int kT, int kH, int kW, int sT, int sH, int sW, int rows,
             int cols, int frames, int ring, int grid, int smem) {
  g = Geo{};
  const bool dk = kind == DK, dx = kind == DX;
  g.B = B, g.C = C, g.kT = kT, g.kH = kH, g.kW = kW;
  g.sT = sT, g.sH = sH, g.sW = sW, g.dx = dx, g.S = S;
  axis_of(T, kT, sT, dx, g.qsT, g.oT, g.spT, g.To, g.T, g.Tout);
  int spH, spW;
  axis_of(H, kH, sH, dx, g.qsH, g.oH, spH, g.Ho, g.H, g.Hout);
  axis_of(W, kW, sW, dx, g.qsW, g.oW, spW, g.Wo, g.W, g.Wout);
  g.fshift = g.spT < g.qsT ? 1 : 0;
  if (g.fshift && g.qsT != 2) return ERR_PLAN;
  g.taps = kT * kH * kW;
  g.rows = rows, g.cols = cols, g.frames = frames, g.ring = ring;
  if (rows < 1 || rows > 4 || cols < 1 || frames < 1 || ring < g.spT ||
      ring > 8 || g.spT > 3 || C % S)
    return ERR_PLAN;
  g.sparse = !gen && (sH > 2 || sW > 2);
  int landed;
  if (g.sparse) {  // nine boxes of rows x cols positions
    if (sH > 8 || sW > 8 || cols * sW > 256 || rows * sH > 256) return ERR_PLAN;
    g.bw = cols, g.bh = rows;
    landed = S * rows * cols * 2;
    g.slot_bytes = 9 * round128(landed);
    g.slot_tx = 9 * landed;
  } else {         // one dense halo box
    g.bw = (cols - 1) * g.qsW + spW, g.bh = (rows - 1) * g.qsH + spH;
    if (g.bw > 256 || g.bh > 256) return ERR_PLAN;
    landed = S * g.bw * g.bh * 2;
    g.slot_bytes = round128(landed);
    g.slot_tx = landed;
  }
  g.box_elems = round128(landed) / 2;
  g.g_tx = dk ? S * rows * cols * 2 : 0;
  g.g_bytes = round128(g.g_tx);
  int total;
  if (!gen) {
    const int red = dk ? rows * kT * 9 * S * 4 : 0;
    g.g_off = ring * g.slot_bytes > red ? ring * g.slot_bytes : red;
    g.bar_off = g.g_off + (dk ? G_SLOTS * g.g_bytes : 0);
  } else {
    g.g_off = g.filt_off = ring * g.slot_bytes;
    g.tab_off = g.g_off + (dk ? G_SLOTS * g.g_bytes : round128(4 * S * g.taps));
    g.bar_off = g.tab_off + TAB_BYTES;
  }
  total = g.bar_off + 8 * (2 * ring + (dk ? 2 * G_SLOTS : 0));
  g.nw = cdiv(g.Wo, cols), g.nh = cdiv(g.Ho, rows), g.ntc = cdiv(g.To, frames);
  g.items = B * g.ntc * g.nh * g.nw;
  g.ngroups = cdiv(g.taps, GROUP_TAPS);
  const int n = !dk ? 32 * rows : gen ? S / 2 * g.ngroups : 48 * rows;
  g.consumers = cdiv(n, 32) * 32;
  if (total != smem || smem > SMEM_BLOCK_MAX || grid < 1 || grid > g.items ||
      g.consumers + 32 > (dk ? 224 : 160))
    return ERR_PLAN;
  return 0;
}

// the input grid [B, T, H, W, C]: one dense halo box, or at stride >= 3 a
// box of rows x cols positions at traversal strides (sW, sH)
int encode_x(CUtensorMap* map, const bf16* x, const Geo& g) {
  const long dims[5] = {g.C, g.W, g.H, g.T, g.B};
  if (g.sparse) {
    const int box[5] = {g.S, g.cols * g.sW, g.rows * g.sH, 1, 1};
    const int step[5] = {1, g.sW, g.sH, 1, 1};
    return encode_map_5d(map, x, dims, box, step);
  }
  const int box[5] = {g.S, g.bw, g.bh, 1, 1};
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

template <int S>
int launch_gen(const Geo& g, const CUtensorMap& tx, const PoolArgs& a,
               int grid, int smem, cudaStream_t stream) {
  const int rc = grant<halo_gen_kernel<S>>();
  if (rc) return rc;
  halo_gen_kernel<S><<<dim3(grid, g.C / S), g.consumers + 32, smem, stream>>>(
      tx, a, g);
  return static_cast<int>(cudaGetLastError());
}

int gen_slab(const Geo& g, const CUtensorMap& tx, const PoolArgs& a, int grid,
             int smem, cudaStream_t stream) {
  switch (g.S) {
    case 64: return launch_gen<64>(g, tx, a, grid, smem, stream);
    case 96: return launch_gen<96>(g, tx, a, grid, smem, stream);
    case 128: return launch_gen<128>(g, tx, a, grid, smem, stream);
    default: return ERR_PLAN;
  }
}

template <int KT, int SS>
int launch_dx(const Geo& g, const CUtensorMap& tx, const PoolArgs& a,
              int grid, int smem, cudaStream_t stream) {
  const int rc = grant<dx_kernel<KT, SS>>();
  if (rc) return rc;
  dx_kernel<KT, SS><<<dim3(grid, g.C / SLAB), g.consumers + 32, smem,
                      stream>>>(tx, a, g);
  return static_cast<int>(cudaGetLastError());
}

// K6 at the main path's shapes (dx_kernel), else the general instance
int dx_route(const Geo& g, const CUtensorMap& tx, const PoolArgs& a, int grid,
             int smem, cudaStream_t stream) {
  if (g.S == SLAB && g.kH == 3 && g.kW == 3 && g.sT == 1 && g.sH == g.sW) {
    const int s = g.sH;
    if (g.kT == 3 && s == 2) return launch_dx<3, 2>(g, tx, a, grid, smem, stream);
    if (g.kT == 3 && s == 4) return launch_dx<3, 4>(g, tx, a, grid, smem, stream);
    if (g.kT == 3 && s == 8) return launch_dx<3, 8>(g, tx, a, grid, smem, stream);
    if (g.kT == 1 && s == 2) return launch_dx<1, 2>(g, tx, a, grid, smem, stream);
    if (g.kT == 1 && s == 4) return launch_dx<1, 4>(g, tx, a, grid, smem, stream);
    if (g.kT == 1 && s == 8) return launch_dx<1, 8>(g, tx, a, grid, smem, stream);
  }
  return gen_slab(g, tx, a, grid, smem, stream);
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

template <int S>
int launch_dk_gen(const Geo& g, const CUtensorMap& tx, const CUtensorMap& tg,
                  float* partial, int grid, int smem, cudaStream_t stream) {
  const int rc = grant<dk_gen_kernel<S>>();
  if (rc) return rc;
  dk_gen_kernel<S><<<dim3(grid, g.C / S), g.consumers + 32, smem, stream>>>(
      tx, tg, partial, g);
  return static_cast<int>(cudaGetLastError());
}

// the shapes the tuned instances take: (1|3, 3, 3) kernels at T stride 1
// on 96-channel slabs; the LN on 96-channel heads
bool tuned_shape(int C, int kT, int kH, int kW, int sT) {
  return kH == 3 && kW == 3 && (kT == 1 || kT == 3) && sT == 1 && C % SLAB == 0;
}

// the shapes the general instance takes
bool gen_shape(int S, int kT, int kH, int kW, int sT, int sH, int sW) {
  return (S == 64 || S == 96 || S == 128) && (kT == 1 || kT == 3) &&
         (kH == 3 || kH == 5) && (kW == 3 || kW == 5) && (sT == 1 || sT == 2) &&
         sH >= 1 && sH <= 8 && sW >= 1 && sW <= 8;
}

}  // namespace

// K2.  The plan (route, slab, rows, cols, frames, ring, grid, smem) is
// ops/pool.py:pool_plan's.  The tuned route takes kernels (1|3, 3, 3) at T
// stride 1 with C a multiple of 96 and, with the LN, head_dim 96; the
// general route kernels (1|3, 3|5, 3|5), T stride 1 or 2, spatial strides
// 1 to 8, a slab of 64, 96 or 128 channels (with the LN, head_dim).
extern "C" int svit_pool_ln(const bf16* x, const float* w, const float* g,
                            const float* b, bf16* out, int B, int T, int H,
                            int W, int C, int kT, int kH, int kW, int sT,
                            int sH, int sW, int To, int Ho, int Wo, int hd,
                            float eps, int apply_ln, int gen, int slab,
                            int rows, int cols, int frames, int ring, int grid,
                            int smem, cudaStream_t stream) {
  if (gen ? !gen_shape(slab, kT, kH, kW, sT, sH, sW) || (apply_ln && hd != slab)
          : !tuned_shape(C, kT, kH, kW, sT) || slab != SLAB ||
                (apply_ln && hd != SLAB))
    return static_cast<int>(cudaErrorInvalidValue);
  Geo geo;
  int rc = make_geo(geo, POOL, gen, slab, B, T, H, W, C, kT, kH, kW, sT, sH,
                    sW, rows, cols, frames, ring, grid, smem);
  if (rc) return rc;
  if (geo.To != To || geo.Ho != Ho || geo.Wo != Wo) return ERR_PLAN;
  CUtensorMap tx;
  rc = encode_x(&tx, x, geo);
  if (rc) return rc;
  const PoolArgs a{w, g, b, out, eps, apply_ln};
  if (gen) return gen_slab(geo, tx, a, grid, smem, stream);
  return kT == 3 ? pool_mode<3>(geo, tx, a, grid, smem, stream)
                 : pool_mode<1>(geo, tx, a, grid, smem, stream);
}

// K3.  ``arg`` (or null): the argmax taps [B, To, Ho, Wo, C] as uint8,
// written by the ARG instance for the backward.
extern "C" int svit_pool_max(const bf16* x, bf16* out, uint8_t* arg, int B,
                             int T, int H, int W, int C, int kT, int kH,
                             int kW, int sT, int sH, int sW, int To, int Ho,
                             int Wo, cudaStream_t stream) {
  if (C % 8 || kT * kH * kW > 255) return static_cast<int>(cudaErrorInvalidValue);
  MaxParams p{x, out, arg, B, T, H, W, C, kT, kH, kW, sT, sH, sW, To, Ho, Wo};
  const long long threads = (long long)B * To * Ho * Wo * (C / 8);
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  if (arg)
    pool_max_kernel<true><<<blocks, 256, 0, stream>>>(p);
  else
    pool_max_kernel<false><<<blocks, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K3's backward: g [B, To, Ho, Wo, C] bf16 and its argmax taps (uint8) ->
// dx [B, T, H, W, C] bf16, every element written.
extern "C" int svit_pool_max_bwd(const bf16* g, const uint8_t* arg, bf16* dx,
                                 int B, int T, int H, int W, int C, int kT,
                                 int kH, int kW, int sT, int sH, int sW,
                                 int To, int Ho, int Wo, cudaStream_t stream) {
  if (C % 8 || kT * kH * kW > 255) return static_cast<int>(cudaErrorInvalidValue);
  MaxBwdParams p{g, arg, dx, B, T, H, W, C, kT, kH, kW, sT, sH, sW, To, Ho, Wo};
  const long long threads = (long long)B * T * H * W * (C / 8);
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  pool_max_bwd_kernel<<<blocks, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K6 at the strides of its parity classes: dx_kernel at the main path's
// shapes, else the general instance (at stride 1 of the tuned instance's
// shapes the caller runs K2's bare loop on the flipped filter).  g: [B, To, Ho,
// Wo, C]; w: [kT*kH*kW, C] tap-major, not flipped; dx: [B, T, H, W, C].
extern "C" int svit_conv_dx(const bf16* g, const float* w, bf16* dx, int B,
                            int T, int H, int W, int C, int kT, int kH,
                            int kW, int sT, int sH, int sW, int To, int Ho,
                            int Wo, int gen, int slab, int rows, int cols,
                            int frames, int ring, int grid, int smem,
                            cudaStream_t stream) {
  if (!gen || !gen_shape(slab, kT, kH, kW, sT, sH, sW))
    return static_cast<int>(cudaErrorInvalidValue);
  Geo geo;
  int rc = make_geo(geo, DX, true, slab, B, T, H, W, C, kT, kH, kW, sT, sH, sW,
                    rows, cols, frames, ring, grid, smem);
  if (rc) return rc;
  if (geo.T != To || geo.H != Ho || geo.W != Wo) return ERR_PLAN;
  CUtensorMap tg;
  rc = encode_x(&tg, g, geo);
  if (rc) return rc;
  const PoolArgs a{w, nullptr, nullptr, dx, 0.f, 0};
  return dx_route(geo, tg, a, grid, smem, stream);
}

// K7: ``grid`` partials [grid, kT*kH*kW, C] from the first pass, added in a
// fixed order into dk [kT*kH*kW, C] by the second.  The general route takes
// T stride 1 and sH = sW, as JAX _dk_pallas does.
extern "C" int svit_conv_dk(const bf16* x, const bf16* g, float* partial,
                            float* dk, int B, int T, int H, int W, int C,
                            int kT, int kH, int kW, int sT, int sH, int sW,
                            int To, int Ho, int Wo, int gen, int slab,
                            int rows, int cols, int frames, int ring,
                            int grid, int smem, cudaStream_t stream) {
  if (gen ? sT != 1 || sH != sW || !gen_shape(slab, kT, kH, kW, sT, sH, sW)
          : !tuned_shape(C, kT, kH, kW, sT) || slab != SLAB)
    return static_cast<int>(cudaErrorInvalidValue);
  Geo geo;
  int rc = make_geo(geo, DK, gen, slab, B, T, H, W, C, kT, kH, kW, sT, sH, sW,
                    rows, cols, frames, ring, grid, smem);
  if (rc) return rc;
  if (geo.To != To || geo.Ho != Ho || geo.Wo != Wo) return ERR_PLAN;
  CUtensorMap tx, tg;
  rc = encode_x(&tx, x, geo);
  if (rc) return rc;
  const long gdims[5] = {C, Wo, Ho, To, B};
  const int gbox[5] = {slab, cols, rows, 1, 1};
  const int step[5] = {1, 1, 1, 1, 1};
  rc = encode_map_5d(&tg, g, gdims, gbox, step);
  if (rc) return rc;
  if (gen) {
    switch (slab) {
      case 64: rc = launch_dk_gen<64>(geo, tx, tg, partial, grid, smem, stream); break;
      case 96: rc = launch_dk_gen<96>(geo, tx, tg, partial, grid, smem, stream); break;
      default: rc = launch_dk_gen<128>(geo, tx, tg, partial, grid, smem, stream);
    }
  } else {
    rc = kT == 3 ? dk_mode<3>(geo, tx, tg, partial, grid, smem, stream)
                 : dk_mode<1>(geo, tx, tg, partial, grid, smem, stream);
  }
  if (rc) return rc;
  const int n = geo.taps * C;
  conv_dk_reduce_kernel<<<(n + 31) / 32, 256, 0, stream>>>(partial, dk, grid,
                                                           n);
  return static_cast<int>(cudaGetLastError());
}
