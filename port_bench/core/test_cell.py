"""A multi-view test cell: the program's captured test step
(``engine/steps.py:make_test_step`` through ``engine/graphs.py:
CapturedStep``) in a loop that mirrors ``engine/test.py:perform_test``:
per batch the step, the scores' copy to the host and ``TestMeter``'s
update, the timer ticks.  The views are staged on the card from a seeded
pool, so neither decoding nor the host-to-device copy enters the window.

The check takes a sample of the window's batches, drawn from the seed,
and holds their scores against the reference's eval forward of the same
views.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from port_bench.core import cells, check, traffic, weights, yardstick
from port_bench.core.train_cell import (_no_tf32, _sync, lap_clock,
                                        load_weights)
from port_bench.reference import step as ref_step
from port_bench.reference import svit


class TestCell:
    kind = "test"

    def __init__(self, cell: cells.Cell, seed: int, device):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.ref_cfg = cells.with_seed(cell.cfg, seed)
        self.arch = svit.arch_from_cfg(self.ref_cfg)
        self.specs = svit.param_specs(self.arch)
        self.mix = cell.mix
        self.per = traffic.views_per_video(self.mix)

    def setup(self) -> None:
        from svit_tpu_torch.engine import graphs, meters, steps
        from svit_tpu_torch.models import build_model

        lap, self.phases = lap_clock(self.device), {}
        cfg = cells.program_cfg(self.cell.cfg, self.seed)
        self.cfg = cfg
        model, arch = build_model(cfg, device=self.device)
        self.phases["build"] = lap()
        load_weights(model, self.specs, self.seed, self.device)
        self.phases["weights"] = lap()
        self.model = model
        self.step = graphs.CapturedStep(steps.make_test_step(model))
        self.views, self.labels = traffic.test_pool(self.mix, self.arch,
                                                    self.seed, self.device)
        self.phases["step_and_pool"] = lap()
        self.meter = meters.TestMeter(int(self.mix["videos"]), self.per,
                                      self.arch.num_classes, 1 << 20,
                                      cfg.DATA.ENSEMBLE_METHOD)
        self.k = 0
        self.scores = {}
        self._loop(int(self.mix["warmup_batches"]))
        self.scores = {}
        self.phases["capture_and_warmup"] = lap()

    def _loop(self, n=None, deadline=None) -> int:
        """Batches through the step, as ``perform_test`` runs them, until
        ``n`` are done or host time passes ``deadline``; keeps each
        batch's scores (host) by its index in the run."""
        meter, done = self.meter, 0
        P = len(self.views)
        meter.iter_tic()
        while (n is None or done < n) and (deadline is None
                                           or time.perf_counter() < deadline):
            k = self.k
            preds = self.step({"clips": self.views[k % P]})
            preds = preds.float().cpu().numpy()
            ids = traffic.test_ids(self.mix, k)
            labels = self.labels[ids // self.per]
            valid = np.ones(len(ids), bool)
            meter.update_stats(preds[valid], labels[valid], ids[valid])
            meter.iter_toc()
            meter.log_iter_stats(k)
            meter.iter_tic()
            self.scores[k] = preds
            self.k += 1
            done += 1
        return done

    def window(self, seconds: float):
        _sync(self.device)
        t0 = time.perf_counter()
        n = self._loop(deadline=t0 + seconds)
        _sync(self.device)
        return n, time.perf_counter() - t0

    def traced_units(self) -> int:
        return self._loop(int(self.mix["trace_batches"]))

    def flops_per_unit(self) -> float:
        return yardstick.forward_flops(self.arch, int(self.mix["batch"]),
                                       self.arch.num_frames)

    def bound_s_per_unit(self) -> float:
        return yardstick.bound_s(yardstick.kernel_ops(
            self.arch, int(self.mix["batch"]), self.arch.num_frames, "eval"))

    def release(self) -> None:
        self.model = self.step = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def sample(self):
        """The window's batches the check compares, drawn from the seed."""
        rng = np.random.default_rng(weights.sub_seed(self.seed,
                                                     weights.SAMPLE))
        ks = sorted(self.scores)
        n = min(int(self.mix["check_batches"]), len(ks))
        return sorted(rng.choice(ks, size=n, replace=False).tolist())

    def reference(self, prec: str = "f32", pool_index=()) -> dict:
        """The reference's scores of the pool's batches ``pool_index``."""
        W = weights.make_weights(self.specs, self.seed, self.device)
        return {i: ref_step.test_scores(
            self.ref_cfg, W, self.views[i], prec,
            chunk=int(self.mix.get("reference_chunk", 8))).cpu()
            for i in pool_index}

    def numbers(self) -> dict:
        ks = self.sample()
        P = len(self.views)
        with _no_tf32():
            ref = self.reference("f32", sorted({k % P for k in ks}))
        gaps = [check.score_gap(torch.from_numpy(self.scores[k]),
                                ref[k % P]) for k in ks]
        return {"score_gap": max(gaps) if gaps else None,
                "_sampled": ks}
