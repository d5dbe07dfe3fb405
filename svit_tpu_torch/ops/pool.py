"""Pooling kernels K2, K3, K6 and K7 (counterpart of
``svit_tpu/ops/pallas_pool.py``).

- ``fused_pool_ln`` (K2): depthwise 3D conv with zero padding k//2 at any
  strides, accumulated in f32, then LayerNorm over each ``head_dim`` group of
  channels.  The LN scale/bias may be ``head_dim`` wide (shared by the heads)
  or full channel width, which lets the fused k|v pool (``pool_k | pool_v``
  params tiled over heads) run as one launch.
- ``fused_pool_max`` (K3): MaxPool3d with -inf padding k//2.  Where a
  gradient is wanted its forward also writes each window's argmax tap
  (uint8), and its backward ``pool_max_bwd`` gathers g over the windows
  that cover each input cell (JAX ``_pool_max_bwd``, the VJP of XLA's
  ``reduce_window``): ties go to the first maximum in window order, as
  ``reduce_window``'s VJP routes them, the sums are f32 in a fixed order
  (no atomics: a rerun is bit-identical) and dx is rounded once.  The
  forward selects bits: its output is the winning tap's own bf16 (NaN
  propagates, the first NaN holds).
- ``depthwise_conv`` (K2 in bare mode): the conv alone, rounded to the IO
  dtype (JAX ``pallas_depthwise_conv``'s forward).
- ``depthwise_conv_dx`` (K6) and ``depthwise_conv_dk`` (K7): its input and
  filter gradients (JAX ``_pdc_bwd`` and ``_dk_pallas``).
- ``max_bwd_plan``: the launch of K3's backward.  The tuned instance
  takes the main path's skip pool (kernel (1, 3, 3), stride (1, 2, 2), C a
  multiple of 96): a TMA-fed tile over base positions, one 2 x 2 cell of dx
  each; the general gather takes every other call.
- ``pool_plan``: the launch of K2, K6 and K7 (instance, slab, tile, TMA
  boxes, ring, grid), pure Python so that the CPU tests check it.  The
  tuned instance takes the main path's shapes ((1|3) x 3 x 3 kernels at T
  stride 1, 96-channel slabs; K6 at stride 1 as K2's bare loop on the
  flipped filter); the general one kernels (1|3, 3|5, 3|5), T stride 1 or
  2, spatial strides 1 to 8 (K7: T stride 1, sH = sW) and a slab of any
  multiple of 8 channels up to 128 that divides C: K2's LN over one head
  of that width, the other calls the widest such slab.  Other shapes
  raise.

``fused_pool_ln`` is differentiable.  Its backward follows JAX ``_fpl_bwd``
-> ``_pool_ln_recompute``: the conv is recomputed by K2's bare mode and
rounded (the forward does not round before the LN; the recompute does), the
per-head LN goes through autograd, then K6 gives dx and K7 the filter
gradient (the tap formulation where K7 does not take the stride, as JAX
``_pdc_bwd`` falls back to XLA's).

Streams are channels-last ``[B, T, H, W, C]`` at their exact widths; filters
keep the PyTorch depthwise layout ``[C, 1, kT, kH, kW]``.  On a CPU tensor
each wrapper runs its plain version; on a CUDA tensor it launches the kernel
(``csrc/pool.cu``) or raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from svit_tpu_torch.ops import _lib
from svit_tpu_torch.ops.pooling import max_pool3d, out_size
from svit_tpu_torch.ops.vjp import needs_grad

Triple = Tuple[int, int, int]
EPS = 1e-6

# The launch plans of K2, K6 and K7 (``csrc/pool.cu``: ``Geo``, ``make_geo``)
SLAB = 96                  # channels a block of the tuned instances owns
SLAB_MAX = 128             # a general slab's widest: two bf16 pairs a lane
SMEM_BLOCK_MAX = 232448    # shared memory one block may take
SMEM_SM = 233472           # shared memory of one SM; each block also
SMEM_RESERVED = 1024       # takes this much for the system
G_SLOTS = 2                # K7's g ring
TAB_BYTES = 2048           # a general instance's tap tables
GROUP_TAPS = 27            # the taps one thread of the general K7 sums
# registers a thread takes (``ptxas``, as chip_smoke.py prints it), rounded
# up to the allocation unit of 8: the tuned KT = 3 instances, and the
# general ones
REGS = {"pool": 168, "dk": 128, "gen": 128, "dkgen": 128, "max_bwd": 72}
REGS_SM = 65536
# the tile by spatial stride (1, 2, 3 and more): output rows (one K2
# consumer warp, or K7 walker, each) and the cap on its columns, as
# ``pool_probe.py --sweep`` found them best over the main path's calls on
# an H100 (PERF.md).  The general instance's tile is in base positions (K6:
# one stride-sized cell of dx each): "dx" by K6's stride (the sweep's best
# at 2, 4 and 8), "gen" for every other call.
TILES = {"pool": {1: (2, 16), 2: (4, 8), 3: (2, 4)},
         "dk": {1: (2, 16), 2: (4, 8), 3: (4, 4)},
         "dx": {2: (2, 16), 4: (3, 8), 8: (4, 8)},
         "gen": (4, 8)}
KINDS = ("pool", "dk", "dx")
# K3's backward: the call the tuned instance takes, and its tile (base rows,
# one consumer warp each, and the cap on its columns).  ``pool_probe.py
# --sweep`` put every tile of 1 to 8 rows, 4 to 28 columns and 2 to 4
# stages within 4% of this one over the main path's calls on an H100
# (PERF.md)
MAX_BWD_KERNEL, MAX_BWD_STRIDE = (1, 3, 3), (1, 2, 2)
MAX_BWD_TILE = (4, 16)


def pool_threads(kind: str, rows: int, route: str = "tuned", slab: int = SLAB,
                 taps: int = 27) -> int:
    """Threads of a block: the consumers and the producer warp.  Consumers:
    K2 and K6 a warp per row; the tuned K7 48 per row, the general K7
    ``slab / 2`` per group of ``GROUP_TAPS`` taps, in whole warps."""
    if kind != "dk":
        n = 32 * rows
    elif route == "tuned":
        n = 48 * rows
    else:
        n = slab // 2 * _cdiv(taps, GROUP_TAPS)
    return _cdiv(n, 32) * 32 + 32


def blocks_per_sm(kind: str, rows: int, smem: int, route: str = "tuned",
                  slab: int = SLAB, taps: int = 27) -> int:
    """Blocks an SM holds by shared memory and registers."""
    if route == "tuned":
        regs = REGS["dk" if kind == "dk" else "pool"]
    else:
        regs = REGS["dkgen" if kind == "dk" else "gen"]
    return min(SMEM_SM // (smem + SMEM_RESERVED),
               REGS_SM // (pool_threads(kind, rows, route, slab, taps) * regs))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round128(n: int) -> int:
    return _cdiv(n, 128) * 128


@dataclass(frozen=True)
class Axis:
    """One axis of a launch, in base positions: the pooled output (K2,
    K7), or a stride-sized cell of dx (K6).  Base position q reads input
    positions ``q * step + org`` .. ``+ span - 1`` (input: x, or K6's g) and
    writes outputs ``q * out_step + r`` for each class r; ``classes[r]``
    lists its taps as (offset in the window, filter tap)."""
    step: int
    org: int
    span: int
    out_step: int
    base: int                     # base positions
    out: int                      # output extent
    classes: Tuple[Tuple[Tuple[int, int], ...], ...]


def conv_axis(n: int, k: int, s: int, kind: str) -> Axis:
    """Axis of extent ``n`` (the conv's input) with kernel ``k`` (odd,
    padding k // 2) and stride ``s``.  For K2 and K7 one class holds every
    tap.  For K6 (``kind`` "dx") input position i = q s + r of dx takes
    tap u with ``(r + pad - u) % s == 0`` from g at ``q + (r + pad - u) //
    s``: the parity classes, some of them empty at s > 2."""
    p = k // 2
    if kind != "dx":
        o = out_size(n, k, s)
        return Axis(s, -p, k, 1, o, o, (tuple((u, u) for u in range(k)),))
    hits = [(r, (r + p - u) // s, u) for r in range(s) for u in range(k)
            if (r + p - u) % s == 0]
    dmin = min(d for _, d, _ in hits)
    dmax = max(d for _, d, _ in hits)
    classes = tuple(tuple((d - dmin, u) for rr, d, u in hits if rr == r)
                    for r in range(s))
    return Axis(1, dmin, dmax - dmin + 1, s, _cdiv(n, s), n, classes)


def pool_smem(kind: str, kT: int, rows: int, cols: int, ring: int,
              stride: Triple):
    """The tuned instances' (box extent, traversal strides, landed extent,
    slot bytes, g slot bytes, shared memory of one block), as ``make_geo``
    lays them out: the ring (or, if larger, K7's walker sums), K7's g ring,
    the barriers."""
    _, sH, sW = stride
    if max(sH, sW) > 2:
        box = (SLAB, cols * sW, rows * sH, 1, 1)
        step = (1, sW, sH, 1, 1)
        landed = (SLAB, cols, rows, 1, 1)
        slot = 9 * _round128(2 * SLAB * rows * cols)
    else:
        bw, bh = (cols - 1) * sW + 3, (rows - 1) * sH + 3
        box = landed = (SLAB, bw, bh, 1, 1)
        step = (1, 1, 1, 1, 1)
        slot = _round128(2 * SLAB * bw * bh)
    dk = kind == "dk"
    g_bytes = _round128(2 * SLAB * rows * cols) if dk else 0
    red = rows * kT * 9 * SLAB * 4 if dk else 0
    smem = (max(ring * slot, red) + G_SLOTS * g_bytes
            + 8 * (2 * ring + (2 * G_SLOTS if dk else 0)))
    return box, step, landed, slot, g_bytes, smem


def gen_smem(kind: str, slab: int, axes, rows: int, cols: int, ring: int):
    """The general instance's (box extent, slot bytes, g slot bytes, shared
    memory of one block), as ``make_geo`` lays them out: the ring of dense
    halo boxes, K7's g ring or the K2/K6 filter slab in f32, the tap
    tables, the barriers."""
    at, ah, aw = axes
    bw, bh = (cols - 1) * aw.step + aw.span, (rows - 1) * ah.step + ah.span
    box = (slab, bw, bh, 1, 1)
    slot = _round128(2 * slab * bw * bh)
    taps = _taps(axes)
    dk = kind == "dk"
    g_bytes = _round128(2 * slab * rows * cols) if dk else 0
    side = G_SLOTS * g_bytes if dk else _round128(4 * slab * taps)
    smem = (ring * slot + side + TAB_BYTES
            + 8 * (2 * ring + (2 * G_SLOTS if dk else 0)))
    return box, slot, g_bytes, smem


def _taps(axes) -> int:
    return math.prod(sum(len(c) for c in a.classes) for a in axes)


@dataclass(frozen=True)
class PoolPlan:
    """The launch of K2 (``kind`` "pool"), K6 ("dx") or K7 ("dk") for one
    call.

    ``route`` "tuned" is the main path's instance ((1|3) x 3 x 3 kernels at
    T stride 1 on 96-channel slabs; K6 at stride 1 is K2's bare loop on
    the flipped filter), "gen" the general one.  A block owns one
    ``slab``-channel slab (grid y) and walks the tiles ``blockIdx.x, +
    grid, ...``: a tile is ``rows`` rows by ``cols`` columns of ``frames``
    frames of base positions of one clip.  Its input frames pass through a
    ring of ``ring`` slots: a frame is one dense halo box (``sparse``
    False) or, in the tuned instance at a spatial stride of 3 or more, nine
    boxes, one per (dh, dw), at traversal strides ``step``."""
    kind: str
    route: str
    slab: int
    axes: Tuple[Axis, Axis, Axis]
    sparse: bool
    rows: int
    cols: int
    frames: int
    ring: int
    box: Tuple[int, ...]      # TMA box extent (C, W, H, T, B)
    step: Tuple[int, ...]     # TMA traversal strides
    landed: Tuple[int, ...]   # elements a box lands per dimension
    slot_bytes: int
    g_bytes: int
    smem: int
    tiles: Tuple[int, int, int, int]   # (B, frame chunks, h tiles, w tiles)
    items: int
    grid: int
    slabs: int
    threads: int
    per_sm: int

    @property
    def fstep(self) -> int:
        """Input frames between two that the ring loads: 2 where a T stride
        of 2 meets a one-frame kernel, else 1."""
        a = self.axes[0]
        return a.step if a.span < a.step else 1


def _tuned(C: int, kernel: Triple, stride: Triple) -> bool:
    """Whether the tuned instances take the conv: (1|3, 3, 3) kernels at T
    stride 1 and spatial strides 1 to 8 on 96-channel slabs."""
    return (tuple(kernel[1:]) == (3, 3) and kernel[0] in (1, 3)
            and stride[0] == 1 and 1 <= stride[1] <= 8
            and 1 <= stride[2] <= 8 and C % SLAB == 0)


def dk_takes(shape, kernel: Triple, stride: Triple) -> bool:
    """Whether K7 takes the call: the tuned instance's shapes, or else T
    stride 1 and sH = sW, as JAX ``_dk_pallas`` asserts."""
    return (_tuned(shape[-1], kernel, stride)
            or (stride[0] == 1 and stride[1] == stride[2]))


def _route(shape, kernel, stride, kind, head_dim):
    """(route, slab) of a call, or a ValueError naming the card's rule that
    the call breaks.  The general instance's slab: the head (K2's LN), else
    96, 128 or 64 channels where one divides C, else the widest multiple
    of 8 up to ``SLAB_MAX`` that does."""
    C = shape[-1]
    kT, kH, kW = kernel
    sT, sH, sW = stride
    tuned = _tuned(C, kernel, stride) and head_dim in (None, SLAB)
    if kind == "dx":
        tuned = tuned and (sH, sW) == (1, 1)
    if kind == "dk" and not dk_takes(shape, kernel, stride):
        raise ValueError(f"K7 takes T stride 1 and sH = sW, as JAX "
                         f"_dk_pallas does (stride {stride})")
    if tuned:
        return "tuned", SLAB
    if (kT not in (1, 3) or kH not in (3, 5) or kW not in (3, 5)
            or sT not in (1, 2) or not (1 <= sH <= 8 and 1 <= sW <= 8)):
        raise ValueError(
            f"K2, K6 and K7 take kernels (1|3, 3|5, 3|5), T stride 1 or 2 "
            f"and spatial strides 1 to 8 (kernel {kernel}, stride {stride})")
    if C % 8:
        raise ValueError(f"K2, K6 and K7 take C a multiple of 8: TMA loads "
                         f"a slab of channels as whole 16-byte units (C={C})")
    if head_dim is not None:
        if head_dim % 8 or C % head_dim:
            raise ValueError(
                f"K2's LN takes head_dim a multiple of 8 that divides C: the "
                f"slab is one head, loaded by TMA in 16-byte units "
                f"(head_dim={head_dim}, C={C})")
        if head_dim > SLAB_MAX:
            raise ValueError(
                f"K2's LN takes head_dim up to {SLAB_MAX}: one warp reduces "
                f"a head, two bf16 pairs a lane (head_dim={head_dim}, C={C})")
        return "gen", head_dim
    for slab in (96, 128, 64):
        if C % slab == 0:
            return "gen", slab
    return "gen", max(s for s in range(8, SLAB_MAX + 1, 8) if C % s == 0)


def pool_plan(shape, kernel: Triple, stride: Triple, kind: str = "pool", *,
              head_dim: Optional[int] = None, sms: int = 132,
              rows: Optional[int] = None, cols: Optional[int] = None,
              ring: Optional[int] = None,
              frames: Optional[int] = None) -> PoolPlan:
    """The launch of K2 (``kind`` "pool", both modes: ``head_dim`` for the
    LN, None for the bare conv), K6 ("dx") or K7 ("dk") for the conv's
    input grid ``shape`` [B, T, H, W, C] (K6: dx's shape).

    The route is the tuned instance where it takes the call, else the
    general one; anything else raises (``_route``).  A tile is ``rows``
    base rows (one K2 or K6 consumer warp, or tuned K7 walker, each) by
    ``cols`` base columns (the row cut into near-equal parts of at most the
    column cap, halved in the general instance until the block fits) by
    ``frames`` base frames.  Rows and the cap come from ``TILES``.  The
    ring takes 4 input-frame slots, or fewer (at least the frames a base
    frame reads, and 2) where that keeps more blocks an SM
    (``blocks_per_sm``).  The frames of a tile are all base frames, halved
    while the tiles would not fill half a wave of blocks on ``sms`` SMs.
    The grid is at most one wave, each block walking an equal share of the
    tiles (K7: one f32 partial a block).  The plan depends on the shape and
    ``sms`` only.  The keyword overrides are for sweeps
    (``pool_probe.py``)."""
    if kind not in KINDS:
        raise ValueError(f"pool_plan: kind {kind!r}")
    if kind != "pool":
        head_dim = None
    B, T, H, W, C = shape
    route, slab = _route(shape, kernel, stride, kind, head_dim)
    axes = tuple(conv_axis(n, k, s, kind)
                 for n, k, s in zip((T, H, W), kernel, stride))
    at, ah, aw = axes
    kT = kernel[0]
    taps = _taps(axes)
    sparse = route == "tuned" and max(stride[1:]) > 2
    if route == "tuned":
        tkind = "pool" if kind == "dx" else kind
        tile_rows, cap = TILES[tkind][min(max(stride[1:]), 3)]

        def layout(rows, cols, q):
            return pool_smem(tkind, kT, rows, cols, q, stride)
    else:
        tile_rows, cap = (TILES["dx"].get(stride[1], TILES["gen"])
                          if kind == "dx" and stride[1] == stride[2]
                          else TILES["gen"])

        def layout(rows, cols, q):
            box, slot, g_bytes, smem = gen_smem(kind, slab, axes, rows, cols,
                                                q)
            return box, (1,) * 5, box, slot, g_bytes, smem
    rows = rows or tile_rows
    cols = cols or _cdiv(aw.base, _cdiv(aw.base, cap))
    rings = (ring,) if ring else (4, 3) if route == "tuned" else (4, 3, 2)

    def fits(cols):
        return [(blocks_per_sm(kind, rows, smem, route, slab, taps), q)
                for q in rings if q >= max(at.span, 2)
                and (smem := layout(rows, cols, q)[-1]) <= SMEM_BLOCK_MAX]

    options = fits(cols)
    while route == "gen" and not options and cols > 1:
        cols = _cdiv(cols, 2)
        options = fits(cols)
    if not options or max(options)[0] < 1 or not 1 <= rows <= 4:
        raise ValueError(f"pool_plan: no tile fits ({shape}, {stride}, "
                         f"rows={rows}, cols={cols}, ring={ring})")
    per_sm, ring = max(options)
    box, step, landed, slot, g_bytes, smem = layout(rows, cols, ring)
    slabs = C // slab

    def tiles(tt):
        return (B, _cdiv(at.base, tt), _cdiv(ah.base, rows),
                _cdiv(aw.base, cols))

    if frames is None:
        frames = at.base
        while (frames > 1
               and 2 * math.prod(tiles(frames)) * slabs < per_sm * sms):
            frames = _cdiv(frames, 2)
    items = math.prod(tiles(frames))
    wave = max(1, per_sm * sms // slabs)  # blocks a slab gets in one wave
    grid = _cdiv(items, _cdiv(items, wave))
    return PoolPlan(kind, route, slab, axes, sparse, rows, cols, frames,
                    ring, box, step, landed, slot, g_bytes, smem,
                    tiles(frames), items, grid, slabs,
                    pool_threads(kind, rows, route, slab, taps), per_sm)


@dataclass(frozen=True)
class MaxBwdPlan:
    """The launch of K3's backward for one call.

    ``route`` "tile" is the tuned instance (``csrc/pool.cu:
    pool_max_bwd_tile_kernel``): a block owns one 96-channel slab (grid y)
    and walks the tiles ``blockIdx.x, + grid, ...``; a tile is ``rows`` x
    ``cols`` base positions of one frame (base position (m, n) is dx's cell
    rows 2m, 2m + 1 x columns 2n, 2n + 1) and loads the (rows + 1) x (cols
    + 1) windows of g and of the argmax that cover it (``box``) by TMA into
    a ring of ``ring`` stages.  ``rows`` consumer warps and a producer warp
    (``threads``).  "gather" is the general instance (a thread per 8
    channels of an input cell): its tile fields are 0."""
    route: str
    rows: int
    cols: int
    ring: int
    box: Tuple[int, ...]      # TMA box extent (C, W, H, T, B) of both maps
    g_bytes: int              # a stage's g box; the argmax box follows
    stage_bytes: int
    smem: int
    tiles: Tuple[int, ...]    # (B, T, h tiles, w tiles)
    items: int
    grid: int
    slabs: int
    threads: int
    per_sm: int


def max_bwd_tuned(in_shape, kernel: Triple, stride: Triple) -> bool:
    """Whether the tuned instance takes the call: the main path's skip pool
    (kernel (1, 3, 3), stride (1, 2, 2), padding (0, 1, 1)), C a multiple
    of 96."""
    return (tuple(kernel) == MAX_BWD_KERNEL
            and tuple(stride) == MAX_BWD_STRIDE and in_shape[-1] % SLAB == 0)


def max_bwd_smem(rows: int, cols: int, ring: int):
    """(g box bytes, stage bytes, shared memory of one block) of the tuned
    instance, as ``csrc/pool.cu:max_bwd_geo`` lays them out: the ring of
    stages (the g box, then the argmax box, each rounded to 128 bytes),
    then a full and an empty barrier a stage."""
    win = (rows + 1) * (cols + 1) * SLAB
    g_bytes = _round128(2 * win)
    stage = g_bytes + _round128(win)
    return g_bytes, stage, ring * stage + 16 * ring


def max_bwd_plan(in_shape, kernel: Triple, stride: Triple, *,
                 sms: int = 132, general: bool = False,
                 rows: Optional[int] = None, cols: Optional[int] = None,
                 ring: Optional[int] = None) -> MaxBwdPlan:
    """The launch of K3's backward for dx of ``in_shape`` [B, T, H, W, C].

    The tuned instance where it takes the call (``max_bwd_tuned``) and
    ``general`` is False, else the general gather.  The tile is ``rows`` x
    ``cols`` base positions: rows and the column cap from
    ``MAX_BWD_TILE``, the row of Wo base positions cut into near-equal
    parts of at most the cap.  The ring takes 4 stages, or 3 or 2 where
    that keeps more blocks an SM.  The grid is at most one wave, each block
    walking an equal share of the tiles.  The keyword overrides are for
    sweeps (``pool_probe.py``)."""
    B, T, H, W, C = in_shape
    if general or not max_bwd_tuned(in_shape, kernel, stride):
        return MaxBwdPlan("gather", 0, 0, 0, (), 0, 0, 0, (), 0, 0, 0, 0, 0)
    Ho, Wo = out_size(H, 3, 2), out_size(W, 3, 2)
    tile_rows, cap = MAX_BWD_TILE
    rows = rows or tile_rows
    cols = cols or _cdiv(Wo, _cdiv(Wo, cap))
    threads = 32 * rows + 32
    options = [
        (min(SMEM_SM // (smem + SMEM_RESERVED),
             REGS_SM // (threads * REGS["max_bwd"])), q)
        for q in ((ring,) if ring else (4, 3, 2))
        if (smem := max_bwd_smem(rows, cols, q)[-1]) <= SMEM_BLOCK_MAX]
    if (not options or max(options)[0] < 1 or not 1 <= rows <= 8
            or not 1 <= cols <= 255 or not 2 <= options[0][1] <= 8):
        raise ValueError(f"max_bwd_plan: no tile fits ({in_shape}, "
                         f"rows={rows}, cols={cols}, ring={ring})")
    per_sm, ring = max(options)
    g_bytes, stage, smem = max_bwd_smem(rows, cols, ring)
    tiles = (B, T, _cdiv(Ho, rows), _cdiv(Wo, cols))
    items = math.prod(tiles)
    slabs = C // SLAB
    wave = max(1, per_sm * sms // slabs)  # blocks a slab gets in one wave
    grid = _cdiv(items, _cdiv(items, wave))
    return MaxBwdPlan("tile", rows, cols, ring, (SLAB, cols + 1, rows + 1, 1, 1),
                      g_bytes, stage, smem, tiles, items, grid, slabs,
                      threads, per_sm)


def _plan_args(plan: PoolPlan):
    return (int(plan.route == "gen"), plan.slab, plan.rows, plan.cols,
            plan.frames, plan.ring, plan.grid, plan.smem)


def _full_width(p: torch.Tensor, C: int) -> torch.Tensor:
    return p if p.shape[0] == C else p.repeat(C // p.shape[0])


def group_layer_norm(x, ln_w, ln_b, head_dim: int, out_dtype=None):
    """LayerNorm in f32 over each ``head_dim`` group of the last axis;
    ``ln_w``/``ln_b`` are head_dim or full width.  Returns ``out_dtype``
    (default: ``x``'s dtype)."""
    C = x.shape[-1]
    h = C // head_dim
    xf = x.float().reshape(*x.shape[:-1], h, head_dim)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    g = _full_width(ln_w, C).float().view(h, head_dim)
    b = _full_width(ln_b, C).float().view(h, head_dim)
    o = (xf - mean) * torch.rsqrt(var + EPS) * g + b
    return o.reshape(x.shape).to(out_dtype or x.dtype).contiguous()


def pool_ln_reference(x, weight, ln_w, ln_b, stride: Triple, head_dim: int):
    """Plain twin of ``fused_pool_ln``: the conv in f32 on the IO-dtype input,
    per-head LN in f32, one rounding to the IO dtype."""
    pad = tuple(k // 2 for k in weight.shape[2:])
    y = torch.nn.functional.conv3d(
        x.float().permute(0, 4, 1, 2, 3), weight.float(), stride=tuple(stride),
        padding=pad, groups=x.shape[-1],
    ).permute(0, 2, 3, 4, 1)
    return group_layer_norm(y, ln_w, ln_b, head_dim, x.dtype)


def _pool_ln(x, weight, ln_w, ln_b, stride: Triple, head_dim: int,
             apply_ln: bool = True):
    """Kernel K2 (plain version on a CPU tensor)."""
    if x.device.type == "cpu":
        if not apply_ln:
            return depthwise_conv_reference(x, weight, stride)
        return pool_ln_reference(x, weight, ln_w, ln_b, stride, head_dim)
    C = x.shape[-1]
    kernel = tuple(weight.shape[2:])
    _lib.check(x, "x", torch.bfloat16)
    _lib.check(weight, "weight", torch.float32, (C, 1, *kernel), x.device)
    plan = pool_plan(x.shape, kernel, stride, "pool",
                     head_dim=head_dim if apply_ln else None,
                     sms=_lib.sm_count(x.device))
    g = b = None
    if apply_ln:
        g = _full_width(ln_w, C).contiguous()
        b = _full_width(ln_b, C).contiguous()
        _lib.check(g, "ln weight", torch.float32, (C,), x.device)
        _lib.check(b, "ln bias", torch.float32, (C,), x.device)
    return _launch_pool(x, _tap_major(weight), g, b, kernel, stride,
                        head_dim, plan, "pool_ln" if apply_ln else "pool_conv")


def _tap_major(weight):
    """[kT*kH*kW, C] filter: lanes read neighbouring channels."""
    return weight.reshape(weight.shape[0], -1).t().contiguous()


def _launch_pool(x, taps, g, b, kernel, stride, head_dim, plan, counter):
    B, T, H, W, C = x.shape
    To, Ho, Wo = (out_size(d, k, s) for d, k, s in
                  zip((T, H, W), kernel, stride))
    out = torch.empty((B, To, Ho, Wo, C), dtype=x.dtype, device=x.device)
    if out.numel():
        _lib.launch(
            "svit_pool_ln", counter,
            _lib.ptr(x), _lib.ptr(taps), _lib.ptr(g), _lib.ptr(b),
            _lib.ptr(out), B, T, H, W, C, *kernel, *stride,
            To, Ho, Wo, head_dim, EPS, int(g is not None),
            *_plan_args(plan), _lib.stream())
    return out


def depthwise_conv_reference(x, weight, stride: Triple):
    """Plain twin of ``depthwise_conv``: the conv in f32 on the IO-dtype
    input, one rounding to the IO dtype."""
    pad = tuple(k // 2 for k in weight.shape[2:])
    y = torch.nn.functional.conv3d(
        x.float().permute(0, 4, 1, 2, 3), weight.float(), stride=tuple(stride),
        padding=pad, groups=x.shape[-1])
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def depthwise_conv(x, weight, stride: Triple, head_dim: int):
    """K2 in bare mode: the depthwise conv rounded to bf16, no LN."""
    return _pool_ln(x, weight, None, None, stride, head_dim, apply_ln=False)


def depthwise_conv_dx_reference(g, weight, stride: Triple, in_shape):
    """Plain twin of ``depthwise_conv_dx``, step by step as JAX ``_pdc_bwd``:
    the f32 cotangent zero-stuffed to the strided positions, right-padded to
    the input extent, convolved at stride 1 with the flipped filters (same
    padding), rounded to ``g``'s dtype."""
    B, T, H, W, C = in_shape
    st, sh, sw = stride
    gf = g.float()
    To, Ho, Wo = gf.shape[1:4]
    stuffed = gf.new_zeros((B, (To - 1) * st + 1, (Ho - 1) * sh + 1,
                            (Wo - 1) * sw + 1, C))
    stuffed[:, ::st, ::sh, ::sw] = gf
    stuffed = torch.nn.functional.pad(
        stuffed, (0, 0, 0, W - stuffed.shape[3], 0, H - stuffed.shape[2],
                  0, T - stuffed.shape[1]))
    flipped = weight.float().flip(2, 3, 4)
    return depthwise_conv_reference(stuffed, flipped, (1, 1, 1)).to(g.dtype)


def depthwise_conv_dx(g, weight, stride: Triple, in_shape):
    """Kernel K6: the input gradient of the depthwise conv (padding k//2,
    ``stride``).  g: [B, To, Ho, Wo, C] bf16; weight: [C, 1, kT, kH, kW]
    f32; returns bf16 ``in_shape``.  At stride 1 it is the same-padding
    conv of g with the flipped filter: K2's bare loop (the tuned route).
    At other strides a tile of base positions (one stride-sized cell of dx
    each) reads a halo box of g and writes every parity class of its cells
    with the class's own taps."""
    if g.device.type == "cpu":
        return depthwise_conv_dx_reference(g, weight, stride, in_shape)
    B, T, H, W, C = in_shape
    kernel = tuple(weight.shape[2:])
    To, Ho, Wo = (out_size(d, k, s) for d, k, s in
                  zip((T, H, W), kernel, stride))
    _lib.check(g, "g", torch.bfloat16, (B, To, Ho, Wo, C))
    _lib.check(weight, "weight", torch.float32, (C, 1, *kernel), g.device)
    plan = pool_plan(tuple(in_shape), kernel, stride, "dx",
                     sms=_lib.sm_count(g.device))
    if plan.route == "tuned":
        return _launch_pool(g, _tap_major(weight.flip(2, 3, 4)), None, None,
                            kernel, (1, 1, 1), plan.slab, plan,
                            "pool_conv_dx")
    dx = torch.empty(tuple(in_shape), dtype=g.dtype, device=g.device)
    if dx.numel():
        _lib.launch("svit_conv_dx", "pool_conv_dx", _lib.ptr(g),
                    _lib.ptr(_tap_major(weight)), _lib.ptr(dx), B, T, H, W,
                    C, *kernel, *stride, To, Ho, Wo, *_plan_args(plan),
                    _lib.stream())
    return dx


def depthwise_conv_dk_reference(x, g, kernel: Triple, stride: Triple):
    """Plain twin of ``depthwise_conv_dk``: the tap formulation of JAX
    ``_dk_pallas`` (x and g in f32, one strided slice of the zero-padded x
    per tap, multiplied by g and summed over batch and positions).
    Returns [C, 1, kT, kH, kW] f32."""
    kT, kH, kW = kernel
    st, sh, sw = stride
    To, Ho, Wo = g.shape[1:4]
    xp = torch.nn.functional.pad(
        x.float(), (0, 0, kW // 2, kW // 2, kH // 2, kH // 2, kT // 2, kT // 2))
    gf = g.float()
    taps = []
    for dt in range(kT):
        for dh in range(kH):
            for dw in range(kW):
                sl = xp[:, dt:dt + (To - 1) * st + 1:st,
                        dh:dh + (Ho - 1) * sh + 1:sh,
                        dw:dw + (Wo - 1) * sw + 1:sw]
                taps.append((sl * gf).sum(dim=(0, 1, 2, 3)))
    return torch.stack(taps, dim=1).view(-1, 1, kT, kH, kW)


def depthwise_conv_dk(x, g, kernel: Triple, stride: Triple):
    """Kernel K7: the filter gradient ``dk[tap, c] = sum over batch and
    output positions of x_pad[out * s + tap, c] * g[out, c]`` in f32 (x and
    g bf16).  Returns [C, 1, kT, kH, kW] f32.  Shapes: ``dk_takes``."""
    if x.device.type == "cpu":
        return depthwise_conv_dk_reference(x, g, kernel, stride)
    B, T, H, W, C = x.shape
    kT, kH, kW = kernel
    To, Ho, Wo = g.shape[1:4]
    _lib.check(x, "x", torch.bfloat16)
    _lib.check(g, "g", torch.bfloat16, (B, To, Ho, Wo, C), x.device)
    plan = pool_plan(x.shape, kernel, stride, "dk",
                     sms=_lib.sm_count(x.device))
    partial = torch.empty((plan.grid, kT * kH * kW, C), dtype=torch.float32,
                          device=x.device)
    dk = torch.empty((kT * kH * kW, C), dtype=torch.float32, device=x.device)
    if g.numel():
        _lib.launch("svit_conv_dk", "pool_conv_dk", _lib.ptr(x), _lib.ptr(g),
                    _lib.ptr(partial), _lib.ptr(dk), B, T, H, W, C, *kernel,
                    *stride, To, Ho, Wo, *_plan_args(plan), _lib.stream())
    else:
        dk.zero_()
    return dk.t().reshape(C, 1, kT, kH, kW)


class _PoolLnFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, ln_w, ln_b, stride, head_dim):
        ctx.stride, ctx.head_dim = tuple(stride), head_dim
        ctx.save_for_backward(x, weight, ln_w, ln_b)
        return _pool_ln(x, weight, ln_w, ln_b, stride, head_dim)

    @staticmethod
    def backward(ctx, g):
        """Only the gradients autograd asks for (``needs_input_grad``): a
        backward that wants ``dx`` alone (Grad-CAM's) launches no K7, as
        XLA drops the JAX package's unused ``_dk_pallas`` call."""
        x, weight, ln_w, ln_b = ctx.saved_tensors
        stride, hd = ctx.stride, ctx.head_dim
        want_x, want_k, want_lw, want_lb = ctx.needs_input_grad[:4]
        y = depthwise_conv(x, weight, stride, hd)
        with torch.enable_grad():
            leaves = [y.detach().requires_grad_()] + [
                t.detach().requires_grad_(w)
                for t, w in ((ln_w, want_lw), (ln_b, want_lb))]
            out = group_layer_norm(*leaves, hd)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, g))
            gy, glw, glb = (next(got) if t.requires_grad else None
                            for t in leaves)
        gy = gy.contiguous()
        dx = depthwise_conv_dx(gy, weight, stride, x.shape) if want_x else None
        dk = None
        if want_k:
            # K7 where it takes the stride; else the tap formulation, as JAX
            # ``_pdc_bwd`` falls back to XLA's
            dk_fn = (depthwise_conv_dk
                     if dk_takes(x.shape, tuple(weight.shape[2:]), stride)
                     else depthwise_conv_dk_reference)
            dk = dk_fn(x, gy, tuple(weight.shape[2:]), stride)
        return dx, dk, glw, glb, None, None


def fused_pool_ln(x, weight, ln_w, ln_b, stride: Triple, head_dim: int):
    """Kernel K2.  x: [B, T, H, W, C] bf16; weight: [C, 1, kT, kH, kW] f32;
    ln_w/ln_b: f32 of size head_dim or C.  Returns [B, To, Ho, Wo, C].
    Differentiable: K2 bare, K6 and K7 in the backward."""
    if not needs_grad(x, weight, ln_w, ln_b):
        return _pool_ln(x, weight, ln_w, ln_b, stride, head_dim)
    return _PoolLnFn.apply(x, weight, ln_w, ln_b, tuple(stride), head_dim)


def pool_max_reference(x, kernel: Triple, stride: Triple):
    """Plain twin of ``fused_pool_max``."""
    return max_pool3d(x, kernel, stride)


def _windows(x, kernel: Triple, stride: Triple):
    """[B, To, Ho, Wo, C, taps] view of ``x`` padded with -inf (taps in
    (t, h, w) scan order)."""
    pad = [k // 2 for k in reversed(kernel) for _ in (0, 1)]
    xp = torch.nn.functional.pad(x.permute(0, 4, 1, 2, 3), pad,
                                 value=float("-inf"))
    for d, (k, s) in enumerate(zip(kernel, stride)):
        xp = xp.unfold(2 + d, k, s)
    # [B, C, To, Ho, Wo, kT, kH, kW]
    return xp.flatten(5).permute(0, 2, 3, 4, 1, 5)


def pool_max_argmax_reference(x, kernel: Triple, stride: Triple):
    """Each window's first maximum as its tap index ``(dt kH + dh) kW +
    dw`` (uint8 [B, To, Ho, Wo, C]), the argmax K3 writes for its
    backward.  The -inf padding never wins: a window's taps outside the
    grid rank below every value in it."""
    win = _windows(x, kernel, stride)
    valid = _windows(torch.ones_like(x[..., :1]), kernel, stride) > 0
    # rank by value, the padding below -inf; the first maximum wins a tie
    ranked = torch.where(valid, win.float(),
                         torch.tensor(float("-inf"), device=x.device))
    first_valid = valid.float().argmax(-1, keepdim=True)
    best = ranked.argmax(-1, keepdim=True)
    top = ranked.gather(-1, best)
    best = torch.where(top == float("-inf"), first_valid, best)
    return best[..., 0].to(torch.uint8)


def pool_max_backward_reference(g, arg, kernel: Triple, stride: Triple,
                                in_shape):
    """Plain twin of ``pool_max_bwd``: dx [in_shape] of ``g`` [B, To, Ho,
    Wo, C] routed to each window's argmax tap ``arg``, summed in f32 over
    the windows in (to, ho, wo) order (the kernel's order: taps in reverse
    scan order) and rounded once to ``g``'s dtype."""
    B, T, H, W, C = in_shape
    To, Ho, Wo = g.shape[1:4]
    pads = [k // 2 for k in kernel]
    acc = torch.zeros((B, T + 2 * pads[0] + stride[0], H + 2 * pads[1]
                       + stride[1], W + 2 * pads[2] + stride[2], C),
                      dtype=torch.float32, device=g.device)
    gf = g.float()
    kT, kH, kW = kernel
    sT, sH, sW = stride
    for dt in reversed(range(kT)):
        for dh in reversed(range(kH)):
            for dw in reversed(range(kW)):
                tap = (dt * kH + dh) * kW + dw
                view = acc[:, dt:dt + sT * To:sT, dh:dh + sH * Ho:sH,
                           dw:dw + sW * Wo:sW]
                view += torch.where(arg == tap, gf, 0.0)
    return acc[:, pads[0]:pads[0] + T, pads[1]:pads[1] + H,
               pads[2]:pads[2] + W].to(g.dtype).contiguous()


def pool_max_bwd(g, arg, kernel: Triple, stride: Triple, in_shape, *,
                 general: bool = False):
    """K3's backward: ``g`` [B, To, Ho, Wo, C] bf16 and the forward's argmax
    taps -> dx [in_shape] bf16 (plain version on a CPU tensor).  On the
    card the tuned instance takes the main path's skip pool and the general
    gather every other call, or this one where ``general`` asks for it (to
    hold the two against each other): ``max_bwd_plan``.  Both add in the
    plain twin's order: the three agree bit for bit."""
    if g.device.type == "cpu":
        return pool_max_backward_reference(g, arg, kernel, stride, in_shape)
    B, T, H, W, C = in_shape
    outs = tuple(out_size(d, k, s) for d, k, s in
                 zip((T, H, W), kernel, stride))
    _lib.check(g, "g", torch.bfloat16, (B, *outs, C))
    _lib.check(arg, "arg", torch.uint8, g.shape, g.device)
    if C % 8:
        raise ValueError(f"pool_max_bwd needs C a multiple of 8 (C={C})")
    plan = max_bwd_plan(tuple(in_shape), tuple(kernel), tuple(stride),
                        sms=_lib.sm_count(g.device), general=general)
    dx = torch.empty(tuple(in_shape), dtype=g.dtype, device=g.device)
    if dx.numel():
        _lib.launch(
            "svit_pool_max_bwd", "pool_max_bwd",
            _lib.ptr(g), _lib.ptr(arg), _lib.ptr(dx), B, T, H, W, C,
            *kernel, *stride, *outs, int(plan.route == "tile"), plan.rows,
            plan.cols, plan.ring, plan.grid, plan.smem, _lib.stream())
    return dx


class _PoolMaxFn(torch.autograd.Function):
    """K3 with its argmax, then ``pool_max_bwd`` (the plain twins on a CPU
    tensor)."""

    @staticmethod
    def forward(ctx, x, kernel, stride):
        ctx.kernel, ctx.stride, ctx.in_shape = kernel, stride, tuple(x.shape)
        out, arg = _pool_max(x, kernel, stride, with_arg=True)
        ctx.save_for_backward(arg)
        return out

    @staticmethod
    def backward(ctx, g):
        (arg,) = ctx.saved_tensors
        return pool_max_bwd(g.contiguous(), arg, ctx.kernel, ctx.stride,
                            ctx.in_shape), None, None


def fused_pool_max(x, kernel: Triple, stride: Triple):
    """Kernel K3: MaxPool3d of a channels-last bf16 grid, -inf padding k//2.
    Differentiable: K3 with its argmax, then ``pool_max_bwd``."""
    if not needs_grad(x):
        return _pool_max(x, tuple(kernel), tuple(stride))
    return _PoolMaxFn.apply(x, tuple(kernel), tuple(stride))


def _pool_max(x, kernel: Triple, stride: Triple, with_arg: bool = False):
    """K3 (the plain twins on a CPU tensor); ``with_arg`` also returns the
    argmax taps (the instance that writes them).  On the card a gather that
    selects bits in the plain twins' order: the two agree bit for bit."""
    if x.device.type == "cpu":
        out = pool_max_reference(x, kernel, stride)
        return ((out, pool_max_argmax_reference(x, kernel, stride))
                if with_arg else out)
    B, T, H, W, C = x.shape
    _lib.check(x, "x", torch.bfloat16)
    if C % 8:
        raise ValueError(f"pool_max needs C a multiple of 8 (C={C})")
    To, Ho, Wo = (out_size(d, k, s) for d, k, s in
                  zip((T, H, W), kernel, stride))
    if max(x.numel(), B * To * Ho * Wo * C) >= 2 ** 31 - 256:
        raise ValueError(f"pool_max takes x and its output under 2^31 "
                         f"elements (x {tuple(x.shape)})")
    out = torch.empty((B, To, Ho, Wo, C), dtype=x.dtype, device=x.device)
    arg = (torch.empty(out.shape, dtype=torch.uint8, device=x.device)
           if with_arg else None)
    if out.numel():
        _lib.launch(
            "svit_pool_max", "pool_max",
            _lib.ptr(x), _lib.ptr(out), _lib.ptr(arg), B, T, H, W, C,
            *kernel, *stride, To, Ho, Wo, _lib.stream())
    return (out, arg) if with_arg else out
