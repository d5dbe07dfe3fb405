"""A cell cut to a size the CPU runs in seconds, for the tests: the cell's
own files, with the trunk at 4 blocks over two stage changes, 4 frames at
64 px, f32, and batches of 2."""

from __future__ import annotations

import copy

from port_bench.core import cells


def tiny_cfg(cfg: dict) -> dict:
    c = copy.deepcopy(cfg)
    mv = c["MVIT"]
    mv["DEPTH"] = 4
    mv["DIM_MUL"] = [[1, 2.0], [3, 2.0]]
    mv["HEAD_MUL"] = [[1, 2.0], [3, 2.0]]
    mv["POOL_Q_STRIDE"] = [[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1],
                           [3, 1, 2, 2]]
    c["DATA"]["NUM_FRAMES"] = 4
    c["DATA"]["TRAIN_CROP_SIZE"] = c["DATA"]["TEST_CROP_SIZE"] = 64
    c["TRAIN"]["MIXED_PRECISION"] = False
    return c


def tiny_cell(name: str) -> cells.Cell:
    cell = cells.load_cell(name)
    cell.cfg = tiny_cfg(cell.cfg)
    mix = dict(cell.mix)
    for k in ("video_batch", "image_batch"):
        if k in mix:
            mix[k] = 2
    if mix["kind"] == "train":
        mix.update(pool=4, warmup_steps=1, trace_steps=2,
                   reference_chunk=1, reference_frames_chunk=4)
    else:
        mix.update(batch=6, temporal_views=2, spatial_crops=3, videos=2,
                   pool=2, warmup_batches=1, trace_batches=2,
                   check_batches=2, reference_chunk=4)
    cell.mix = mix
    return cell
