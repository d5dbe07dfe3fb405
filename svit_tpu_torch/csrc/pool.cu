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
//   padding k//2, a gather, 8 channels a thread.  Its backward replaces the
//   VJP of reduce_window that JAX's _pool_max_bwd takes (no pallas_call),
//   reading the argmax taps the forward wrote: at the main path's skip
//   pool a TMA-fed tile over base positions (pool_max_bwd_tile_kernel),
//   elsewhere a gather over the windows that cover each input cell
//   (pool_max_bwd_kernel); ops/pool.py:max_bwd_plan picks the instance.
//
// Two instances of the halo tile.  The tuned one takes the main path's
// shapes: (1|3) x 3 x 3 kernels at T stride 1 on 96-channel slabs (K2's LN
// on 96-channel heads).  The general one takes kernels (1|3, 3|5, 3|5), T
// stride 1 or 2 (K7: 1), spatial strides 1 to 8 (K7: sH = sW) and a slab of
// any multiple of 8 channels up to 128 that divides C (K2's LN: one head);
// ops/pool.py:pool_plan picks the instance and the slab by shape and raises
// outside both.
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

// K3's compare.  A window's maximum is taken in (t, h, w) scan order over
// the taps inside the grid only: a tap replaces the maximum so far where it
// is greater, or where it is NaN and the maximum is not (NaN propagates and
// the first NaN holds; +0.0 and -0.0 tie, so the first holds).  The -inf
// padding is never a candidate, so it never wins a tie, and a window whose
// values are all -inf keeps its first valid tap.  ARG (the instance a
// differentiated forward launches) also writes, for each output cell and
// channel, that tap's index (dt kH + dh) kW + dw.  The maximum is selected
// as bits, never converted: the output is the winning tap's own bf16, NaN
// payloads included.
constexpr uint32_t NEG_INF2 = 0xff80ff80u;  // two bf16 -inf

// 0xffff in each bf16 half of the result where a > b or either is NaN
__device__ __forceinline__ uint32_t gtu2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("set.gtu.u32.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 0xffff in each bf16 half of the result where a is not NaN
__device__ __forceinline__ uint32_t num2(uint32_t a) {
  uint32_t d;
  asm("set.eq.u32.bf16x2 %0, %1, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// fold one bf16 pair ``v`` into the maximum pair ``m``; returns where it
// took (0xffff a half)
__device__ __forceinline__ uint32_t take2(uint32_t v, uint32_t& m) {
  const uint32_t t = gtu2(v, m) & num2(m);
  m = (v & t) | (m & ~t);
  return t;
}

// fold one tap (8 channels of bf16 ``v``, tap index ``tap`` in every byte
// of ``tap4``) into the window's maximum ``mx`` and, with ARG, its argmax
// bytes ``am`` (channels 0-3, 4-7).  Words, not arrays: nothing of it can
// land in local memory.
template <bool ARG>
__device__ __forceinline__ void max_take(uint4& mx, uint2& am, const uint4 v,
                                         uint32_t tap4) {
  const uint32_t t0 = take2(v.x, mx.x), t1 = take2(v.y, mx.y);
  const uint32_t t2 = take2(v.z, mx.z), t3 = take2(v.w, mx.w);
  if constexpr (ARG) {  // one mask byte per channel: the low byte of its half
    const uint32_t lo = __byte_perm(t0, t1, 0x6420);
    const uint32_t hi = __byte_perm(t2, t3, 0x6420);
    am.x = (tap4 & lo) | (am.x & ~lo);
    am.y = (tap4 & hi) | (am.y & ~hi);
  }
}

// K3: a thread gathers 8 channels of one output cell over the taps of its
// window inside the grid (the window clipped to the grid first: no branch
// per tap), any kernel and stride.  Its indices and offsets are 32-bit (the
// host keeps x and the output under 2^31 elements): with 64-bit ones ptxas
// spilled the decoded position around the loops, a 64-bit base per frame
// cost 5 to 10% on the main path's calls and one per clip spilled (PERF.md).
template <bool ARG>
__global__ void __launch_bounds__(256) pool_max_kernel(MaxParams p) {
  const int C8 = p.C / 8;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.B * p.To * p.Ho * p.Wo * C8) return;
  const int c = (idx % C8) * 8;
  int pos = idx / C8;
  const int wo = pos % p.Wo;
  pos /= p.Wo;
  const int ho = pos % p.Ho;
  pos /= p.Ho;
  const int to = pos % p.To;
  const int b = pos / p.To;
  // the window's first input cell on each axis, and its cells in the grid
  const int t0 = to * p.sT - p.kT / 2, h0 = ho * p.sH - p.kH / 2,
            w0 = wo * p.sW - p.kW / 2;
  const int t1 = max(t0, 0), t2 = min(t0 + p.kT, p.T);
  const int h1 = max(h0, 0), h2 = min(h0 + p.kH, p.H);
  const int w1 = max(w0, 0), w2 = min(w0 + p.kW, p.W);
  uint4 mx = make_uint4(NEG_INF2, NEG_INF2, NEG_INF2, NEG_INF2);
  const uint32_t first = ((t1 - t0) * p.kH + h1 - h0) * p.kW + w1 - w0;
  uint2 am = make_uint2(first * 0x01010101u, first * 0x01010101u);
  for (int ti = t1; ti < t2; ++ti)
    for (int hi = h1; hi < h2; ++hi) {
      const int row = ((b * p.T + ti) * p.H + hi) * p.W;
      const int tap = ((ti - t0) * p.kH + hi - h0) * p.kW - w0;
      for (int wi = w1; wi < w2; ++wi)
        max_take<ARG>(mx, am,
                      __ldg(reinterpret_cast<const uint4*>(p.x + (row + wi) * p.C + c)),
                      (tap + wi) * 0x01010101u);
    }
  *reinterpret_cast<uint4*>(p.out + 8 * idx) = mx;  // thread idx: 8 channels
  if (ARG) *reinterpret_cast<uint2*>(p.arg + 8 * idx) = am;
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
        // unpacked by shifts: unpack8 on the loaded temporary took its
        // address, which put it on the stack (8 bytes of spill)
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p.g + o));
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
        float v[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[2 * i] = __uint_as_float(w[i] << 16);
          v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
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

// K3's backward at the main path's skip pool (pool_max_bwd_tile_kernel):
// kernel (1, 3, 3), stride (1, 2, 2), padding (0, 1, 1), C a multiple of
// 96, fixed at compile time.  K6's dx_kernel geometry with the filter's
// multiply-add replaced by the argmax select.  A base position (t, m, n)
// owns the 2 x 2 cell of dx rows {2m, 2m + 1} x columns {2n, 2n + 1}; the
// windows that cover it are {m, m + 1} x {n, n + 1} (window o covers input
// rows 2o - 1 .. 2o + 1), so base position (m, n) of the tile reads window
// positions (m .. m + 1, n .. n + 1) of g and of the argmax.  Each cell adds
// its (window, tap) pairs in increasing (ho, wo) window order, the general
// instance's and the plain twin's order, in f32 from +0.0, rounded once:
//   (2m, 2n)         (m, n) tap 4
//   (2m, 2n + 1)     (m, n) tap 5; (m, n + 1) tap 3
//   (2m + 1, 2n)     (m, n) tap 7; (m + 1, n) tap 1
//   (2m + 1, 2n + 1) (m, n) tap 8; (m, n + 1) tap 6; (m + 1, n) tap 2;
//                    (m + 1, n + 1) tap 0
// A pair whose tap is not the window's argmax adds +0.0 (g masked to zero
// bits), as the plain twin's where(arg == tap, g, 0) does: a sum that starts
// at +0.0 is never -0.0, so adding +0.0 leaves it exactly as it is.  The
// windows m + 1 = Ho and n + 1 = Wo lie outside the grid: TMA zero-fills
// both boxes there, so their argmax reads as tap 0 (a real tap) but their g
// is +0.0, which adds nothing.  Cells past an odd H or W are not stored.
//
// What bounds it: bytes.  g (bf16) and its argmax (uint8) are read, dx
// (bf16, four times g's elements) written: at stride 2 dx is 73% of the
// bytes.  The design keeps every byte moving:
// * a block owns one 96-channel slab (blockIdx.y) and walks the tiles
//   blockIdx.x, + gridDim.x, ... (at most one wave of blocks): a tile is
//   ``rows`` x ``cols`` base positions of one frame;
// * a producer warp loads each tile's (rows + 1) x (cols + 1) windows of g
//   and of the argmax by TMA (two 5-D maps, bf16 and uint8) into a ring of
//   stages under full and empty mbarriers, so the next tiles' loads fly
//   while this one is used: every window leaves HBM once (the one-window
//   halo the next tile reads again comes from L2);
// * the consumer warps (``rows`` of them) share the tile's (base position,
//   16-byte channel chunk) items: each takes 8 channels of one base
//   position, reads its four windows' g and argmax from shared memory
//   (16- and 8-byte loads, neighbouring lanes on neighbouring addresses),
//   selects with __vcmpeq4 on four argmax bytes at a time, and writes the
//   four dx vectors with 16-byte stores that it never waits for: a warp's
//   store covers whole 32-byte sectors.
struct MaxBwdGeo {
  int B, T, H, W, C, Ho, Wo;
  int rows, cols, ring;
  int nh, nw, items;
  int g_bytes;      // a stage's g box (rounded to 128 bytes); the argmax box follows
  int stage_bytes;  // one stage: the g box and the argmax box
  int tx;           // bytes TMA lands in a stage
  int bar_off;      // the full and empty barriers, after the ring
  int consumers;    // consumer threads (the producer warp follows)
};

constexpr int MB_CHUNKS = SLAB / 8;   // 16-byte chunks of a slab in g
constexpr int MB_THREADS = 9 * 32;    // at most 8 consumer warps and the producer

// tile ``item``: w tiles fastest, then h tiles, the frame, the clip
__device__ __forceinline__ int4 max_bwd_item(const MaxBwdGeo& g, int item) {
  const int n0 = item % g.nw * g.cols;
  int r = item / g.nw;
  const int m0 = r % g.nh * g.rows;
  r /= g.nh;
  return make_int4(r / g.T, r % g.T, m0, n0);  // b, t, m0, n0
}

// acc += the 8 values of ``v`` whose argmax byte in ``a`` is ``tap``, +0.0
// for the others (their bits masked to zero)
__device__ __forceinline__ void add_tap(float (&acc)[8], const uint4& v,
                                        const uint2& a, uint32_t tap) {
  const uint32_t t = tap * 0x01010101u;
  const uint32_t m0 = __vcmpeq4(a.x, t), m1 = __vcmpeq4(a.y, t);
  const uint32_t w[4] = {v.x & __byte_perm(m0, 0, 0x1100),
                         v.y & __byte_perm(m0, 0, 0x3322),
                         v.z & __byte_perm(m1, 0, 0x1100),
                         v.w & __byte_perm(m1, 0, 0x3322)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}

__global__ void __launch_bounds__(MB_THREADS) pool_max_bwd_tile_kernel(
    const __grid_constant__ CUtensorMap tg,
    const __grid_constant__ CUtensorMap ta, bf16* dx,
    const __grid_constant__ MaxBwdGeo g) {
  extern __shared__ __align__(128) unsigned char smem[];
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
  if ((int)threadIdx.x >= g.consumers) {
    if ((int)threadIdx.x == g.consumers) {
      uint32_t i = 0;
      for (int item = blockIdx.x; item < g.items; item += gridDim.x, ++i) {
        const int s = i % g.ring;
        if (i >= (uint32_t)g.ring) mbar_wait(&empty[s], (i / g.ring - 1) & 1);
        const int4 it = max_bwd_item(g, item);
        unsigned char* dst = smem + s * g.stage_bytes;
        mbar_expect_tx(&full[s], g.tx);
        tma_load_5d(dst, &tg, &full[s], c0, it.w, it.z, it.y, it.x);
        tma_load_5d(dst + g.g_bytes, &ta, &full[s], c0, it.w, it.z, it.y,
                    it.x);
      }
    }
    return;
  }

  const int cols1 = g.cols + 1;
  const size_t row = (size_t)g.W * g.C;  // one dx row
  uint32_t i = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x, ++i) {
    const int s = i % g.ring;
    mbar_wait(&full[s], (i / g.ring) & 1);
    const int4 it = max_bwd_item(g, item);
    const int nrows = min(g.rows, g.Ho - it.z), ncols = min(g.cols, g.Wo - it.w);
    const unsigned char* gs = smem + s * g.stage_bytes;
    const unsigned char* as = gs + g.g_bytes;
    bf16* plane = dx + ((size_t)it.x * g.T + it.y) * g.H * row + c0;
    for (int e = threadIdx.x; !NO_MATH && e < nrows * ncols * MB_CHUNKS;
         e += g.consumers) {
      const int k = e % MB_CHUNKS, q = e / MB_CHUNKS;
      const int j = q % ncols, r = q / ncols;
      // windows (r, j), (r, j + 1), (r + 1, j), (r + 1, j + 1) of the box
      const int p0 = r * cols1 + j;
      const int pos[4] = {p0, p0 + 1, p0 + cols1, p0 + cols1 + 1};
      uint4 v[4];
      uint2 a[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        v[w] = *reinterpret_cast<const uint4*>(gs + pos[w] * 2 * SLAB + 16 * k);
        a[w] = *reinterpret_cast<const uint2*>(as + pos[w] * SLAB + 8 * k);
      }
      float c00[8], c01[8], c10[8], c11[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) c00[u] = c01[u] = c10[u] = c11[u] = 0.f;
      add_tap(c00, v[0], a[0], 4);
      add_tap(c01, v[0], a[0], 5);
      add_tap(c01, v[1], a[1], 3);
      add_tap(c10, v[0], a[0], 7);
      add_tap(c10, v[2], a[2], 1);
      add_tap(c11, v[0], a[0], 8);
      add_tap(c11, v[1], a[1], 6);
      add_tap(c11, v[2], a[2], 2);
      add_tap(c11, v[3], a[3], 0);
      const int h = 2 * (it.z + r), w = 2 * (it.w + j);
      bf16* d = plane + h * row + (size_t)w * g.C + 8 * k;
      const bool right = w + 1 < g.W, below = h + 1 < g.H;
      *reinterpret_cast<uint4*>(d) = pack8(c00);
      if (right) *reinterpret_cast<uint4*>(d + g.C) = pack8(c01);
      if (below) *reinterpret_cast<uint4*>(d + row) = pack8(c10);
      if (right && below)
        *reinterpret_cast<uint4*>(d + row + g.C) = pack8(c11);
    }
    mbar_arrive_if(true, &empty[s]);
  }
}

// ---- the general instance: K2 and K6 (halo_gen_kernel), K7 (dk_gen_kernel)
//
// Any kernel (1|3, 3|5, 3|5), T stride 1 or 2, spatial strides 1 to 8 (sH
// and sW apart), a slab of S channels, S a multiple of 8 (TMA's boxes are
// whole 16-byte units) up to 128, given at run time (K2's LN: head_dim, so
// the LN reduces over exactly one head).  A K2 or K6 lane holds the bf16
// pairs 64 i + 2 l, + 1 of the slab for i < NP (the instance: NP = 1 up to
// 64 channels, 2 up to 128), those past S masked.  K7's threads take one
// pair each, S / 2 a group of taps.  The tile, the ring and the producer
// are the tuned instances'; a frame is always one dense halo box.  The filter slab sits in shared memory (75
// taps x S channels do not fit registers) and the taps come from a table
// built per block: for each class of output (one for K2; K6's parity
// classes, kT s_T x s_H x s_W of them) its entries, each an input frame,
// a byte offset in the frame slot from the base position's corner and a
// filter row.  K6 at stride s is then, per base position, s_T s_H s_W
// small sums with fixed taps: at stride 2 and k = 3 these are 1, 2, 2 and 4
// spatial taps, times those of T, and at strides 4 and 8 the classes that
// touch no tap write zeros with no loads.

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
// producer warp; lane l holds the pairs 64 i + 2 l of the slab, i < NP
template <int NP>
__global__ void __launch_bounds__(160) halo_gen_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ PoolArgs a,
    const __grid_constant__ Geo g) {
  constexpr int NV = 2 * NP;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S = g.S, c0 = blockIdx.y * S;
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

  bool on[NP];  // the pair lies in the slab (S is even: both channels do)
  float lg[NV], lb[NV];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int ch = c0 + 64 * i + 2 * lane;
    on[i] = 64 * i + 2 * lane < S;
    const bool ln = a.apply_ln && on[i];
    lg[2 * i] = ln ? a.ln_g[ch] : 0.f;
    lg[2 * i + 1] = ln ? a.ln_g[ch + 1] : 0.f;
    lb[2 * i] = ln ? a.ln_b[ch] : 0.f;
    lb[2 * i + 1] = ln ? a.ln_b[ch + 1] : 0.f;
  }
  const float inv_s = 1.f / S;
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
        float acc[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[i] = 0.f;
        for (int e = cls[c]; e < cls[c + 1]; ++e) {
          const Entry en = ent[e];
          const int so = pick3(slot, en.dt);
          if (so < 0) continue;
          const int off = so + base + en.off;
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            if (!on[i]) continue;
            const float2 v = lds2(smem, off + 128 * i + 4 * lane);
            const float2 w = *reinterpret_cast<const float2*>(
                filt + en.woff + 256 * i + 8 * lane);
            acc[2 * i] = fmaf(v.x, w.x, acc[2 * i]);
            acc[2 * i + 1] = fmaf(v.y, w.y, acc[2 * i + 1]);
          }
        }
        if (a.apply_ln) {  // over the S channels of the slab (one head)
          float m = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) m += acc[i];
          m = warp_sum(m) * inv_s;
          float v2 = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            acc[i] = on[i / 2] ? acc[i] - m : 0.f;
            v2 += acc[i] * acc[i];
          }
          const float rstd = rsqrtf(warp_sum(v2) * inv_s + a.eps);
#pragma unroll
          for (int i = 0; i < NV; ++i) acc[i] = acc[i] * rstd * lg[i] + lb[i];
        }
        bf16* dst = a.out +
            ((((size_t)it.b * g.Tout + ot) * g.Hout + oh) * g.Wout + ow) * g.C +
            c0;
#pragma unroll
        for (int i = 0; i < NP; ++i)
          if (on[i])
            *reinterpret_cast<uint32_t*>(dst + 64 * i + 2 * lane) =
                pack_bf16(acc[2 * i], acc[2 * i + 1]);
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
__global__ void __launch_bounds__(224) dk_gen_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tg, float* partial,
    const __grid_constant__ Geo g) {
  const int S = g.S, COL = 2 * S;
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

// the tuned K3 backward's layout and tile list, as ops/pool.py:max_bwd_plan
// derives them (MaxBwdPlan); ERR_PLAN unless the plan's shared memory is
// this layout's and it fits the kernel
int max_bwd_geo(MaxBwdGeo& g, int B, int T, int H, int W, int C, int rows,
                int cols, int ring, int grid, int smem) {
  g = MaxBwdGeo{};
  g.B = B, g.T = T, g.H = H, g.W = W, g.C = C;
  g.Ho = out_size(H, 3, 2), g.Wo = out_size(W, 3, 2);
  g.rows = rows, g.cols = cols, g.ring = ring;
  if (rows < 1 || rows > 8 || cols < 1 || cols > 255 || ring < 2 ||
      ring > 8 || C % SLAB)
    return ERR_PLAN;
  const int win = (rows + 1) * (cols + 1) * SLAB;
  g.g_bytes = round128(2 * win);
  g.stage_bytes = g.g_bytes + round128(win);
  g.tx = 3 * win;
  g.bar_off = ring * g.stage_bytes;
  g.nh = cdiv(g.Ho, rows), g.nw = cdiv(g.Wo, cols);
  g.items = B * T * g.nh * g.nw;
  g.consumers = 32 * rows;
  if (g.bar_off + 16 * ring != smem || smem > SMEM_BLOCK_MAX || grid < 1 ||
      grid > g.items)
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

template <int NP>
int launch_gen(const Geo& g, const CUtensorMap& tx, const PoolArgs& a,
               int grid, int smem, cudaStream_t stream) {
  const int rc = grant<halo_gen_kernel<NP>>();
  if (rc) return rc;
  halo_gen_kernel<NP><<<dim3(grid, g.C / g.S), g.consumers + 32, smem,
                        stream>>>(tx, a, g);
  return static_cast<int>(cudaGetLastError());
}

// the general instance of the slab's width: one bf16 pair a lane up to 64
// channels, two up to 128
int gen_slab(const Geo& g, const CUtensorMap& tx, const PoolArgs& a, int grid,
             int smem, cudaStream_t stream) {
  return g.S <= 64 ? launch_gen<1>(g, tx, a, grid, smem, stream)
                   : launch_gen<2>(g, tx, a, grid, smem, stream);
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

int launch_dk_gen(const Geo& g, const CUtensorMap& tx, const CUtensorMap& tg,
                  float* partial, int grid, int smem, cudaStream_t stream) {
  const int rc = grant<dk_gen_kernel>();
  if (rc) return rc;
  dk_gen_kernel<<<dim3(grid, g.C / g.S), g.consumers + 32, smem, stream>>>(
      tx, tg, partial, g);
  return static_cast<int>(cudaGetLastError());
}

// the shapes the tuned instances take: (1|3, 3, 3) kernels at T stride 1
// on 96-channel slabs; the LN on 96-channel heads
bool tuned_shape(int C, int kT, int kH, int kW, int sT) {
  return kH == 3 && kW == 3 && (kT == 1 || kT == 3) && sT == 1 && C % SLAB == 0;
}

// the shapes the general instance takes (the slab S: a multiple of 8 up to
// 128, whole 16-byte TMA units and at most two bf16 pairs a lane)
bool gen_shape(int S, int kT, int kH, int kW, int sT, int sH, int sW) {
  return S % 8 == 0 && S >= 8 && S <= 128 && (kT == 1 || kT == 3) &&
         (kH == 3 || kH == 5) && (kW == 3 || kW == 5) && (sT == 1 || sT == 2) &&
         sH >= 1 && sH <= 8 && sW >= 1 && sW <= 8;
}

}  // namespace

// K2.  The plan (route, slab, rows, cols, frames, ring, grid, smem) is
// ops/pool.py:pool_plan's.  The tuned route takes kernels (1|3, 3, 3) at T
// stride 1 with C a multiple of 96 and, with the LN, head_dim 96; the
// general route kernels (1|3, 3|5, 3|5), T stride 1 or 2, spatial strides
// 1 to 8, a slab of a multiple of 8 channels up to 128 that divides C (with
// the LN, head_dim).
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
  if ((long long)B * T * H * W * C >= (1LL << 31) - 256 ||  // 32-bit offsets
      8 * threads >= (1LL << 31) - 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  if (arg)
    pool_max_kernel<true><<<blocks, 256, 0, stream>>>(p);
  else
    pool_max_kernel<false><<<blocks, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K3's backward: g [B, To, Ho, Wo, C] bf16 and its argmax taps (uint8) ->
// dx [B, T, H, W, C] bf16, every element written.  ``tile``: the tuned
// instance (pool_max_bwd_tile_kernel; kernel (1, 3, 3), stride (1, 2, 2), C
// a multiple of 96) at the plan (rows, cols, ring, grid, smem) of
// ops/pool.py:max_bwd_plan; else the general gather (the plan unused).
extern "C" int svit_pool_max_bwd(const bf16* g, const uint8_t* arg, bf16* dx,
                                 int B, int T, int H, int W, int C, int kT,
                                 int kH, int kW, int sT, int sH, int sW,
                                 int To, int Ho, int Wo, int tile, int rows,
                                 int cols, int ring, int grid, int smem,
                                 cudaStream_t stream) {
  if (C % 8 || kT * kH * kW > 255) return static_cast<int>(cudaErrorInvalidValue);
  if (tile) {
    if (kT != 1 || kH != 3 || kW != 3 || sT != 1 || sH != 2 || sW != 2 ||
        To != T)
      return static_cast<int>(cudaErrorInvalidValue);
    MaxBwdGeo geo;
    int rc = max_bwd_geo(geo, B, T, H, W, C, rows, cols, ring, grid, smem);
    if (rc) return rc;
    if (geo.Ho != Ho || geo.Wo != Wo) return ERR_PLAN;
    CUtensorMap tg, ta;
    const long dims[5] = {C, Wo, Ho, To, B};
    const int box[5] = {SLAB, cols + 1, rows + 1, 1, 1};
    const int step[5] = {1, 1, 1, 1, 1};
    rc = encode_map_5d(&tg, g, dims, box, step);
    if (!rc) rc = encode_map_5d(&ta, arg, dims, box, step, 1);
    if (!rc) rc = grant<pool_max_bwd_tile_kernel>();
    if (rc) return rc;
    pool_max_bwd_tile_kernel<<<dim3(grid, C / SLAB), geo.consumers + 32, smem,
                               stream>>>(tg, ta, dx, geo);
    return static_cast<int>(cudaGetLastError());
  }
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
    rc = launch_dk_gen(geo, tx, tg, partial, grid, smem, stream);
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
