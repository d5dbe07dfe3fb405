"""A training cell: the program's joint train step driven by its own train
loop, ``engine/train.py:train_epoch``, on batches staged on the card.

Set-up builds one step object (the model, AdamW and the captured step,
``engine/graphs.py:CapturedTrainStep``), loads the run's weights, and
drives it through its first three steps on the pool's first three
batches, through the same loop, loader interface and hand-over the window
uses: those steps are what the check compares.  More steps warm up, then
the window runs whole steps until ``--seconds`` have passed, cycling the
pool; it ends when the loop's last metric fetch has waited for the last
step.  Decoding and the host-to-device copy stay outside: the loaders
would make the host pace the cell.

After the window the program's state is freed and the reference
(``reference/step.py``) takes three steps from the same weights, batches
and draws, in blocks of rows.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from port_bench.core import cells, check, traffic, weights, yardstick
from port_bench.reference import step as ref_step
from port_bench.reference import svit

CHECK_STEPS = 3


class _Loader:
    """Staged batches behind the loaders' iterator API: ``take(k)`` decides
    which pool entry the k-th batch is, and returns None to end."""

    def __init__(self, pool, take):
        self.pool, self.take = pool, take

    def __len__(self):
        return len(self.pool)

    def __iter__(self):
        return self.iter_batches(0)

    def iter_batches(self, start=0):
        k = start
        while True:
            i = self.take(k)
            if i is None:
                return
            yield self.pool[i]
            k += 1


class TrainCell:
    kind = "train"

    def __init__(self, cell: cells.Cell, seed: int, device):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.ref_cfg = cells.with_seed(cell.cfg, seed)
        self.arch = svit.arch_from_cfg(self.ref_cfg)
        self.specs = svit.param_specs(self.arch)
        self.mix = cell.mix
        self.spe = int(cell.meta["assumed"]["steps_per_epoch"])

    # -- the program ---------------------------------------------------------

    def setup(self) -> None:
        from svit_tpu_torch.config.defaults import num_image_ranks
        from svit_tpu_torch.engine import graphs, meters, steps
        from svit_tpu_torch.models import build_model
        from svit_tpu_torch.models.losses import get_loss_func
        from svit_tpu_torch.models.optimizer import construct_optimizer

        lap, self.phases = lap_clock(self.device), {}
        cfg = cells.program_cfg(self.cell.cfg, self.seed)
        self.cfg, self.meters = cfg, meters
        model, arch = build_model(cfg, device=self.device, train=True)
        self.phases["build"] = lap()
        load_weights(model, self.specs, self.seed, self.device)
        self.phases["weights"] = lap()
        tx, _ = construct_optimizer(cfg, model, self.spe)
        state = steps.create_train_state(model, tx)
        w_i = num_image_ranks(cfg) / max(cfg.NUM_GPUS, 1)
        self.with_consistency = bool(cfg.TRAIN.FORWARD_VIDEO_FRAMES
                                     and cfg.SVIT.CONSISTENCY_LOSS)
        packed, names = steps.make_packed_train_step(
            model, get_loss_func(cfg), tx, video_weight=1.0 - w_i,
            image_weight=w_i, with_image=True,
            with_consistency=self.with_consistency)
        pixels = torch.bfloat16 if cfg.TRAIN.MIXED_PRECISION else None
        self.pool = traffic.train_pool(self.mix, self.arch, self.seed,
                                       self.device, pixels or torch.float32)
        self.phases["step_and_pool"] = lap()
        on_device = {}
        for video, image in self.pool:
            for b in (video, image):
                on_device[id(b["weight"])] = torch.as_tensor(
                    b["weight"], device=self.device)

        def put_ahead(*batches):
            return [None if b is None else
                    dict(b, weight=on_device[id(b["weight"])])
                    for b in batches], None

        self.trainer = SimpleNamespace(
            arch=arch, step_fn=graphs.CapturedTrainStep(packed),
            metric_names=names, steps_per_epoch=self.spe,
            generator=torch.Generator(device=self.device), data_seconds=[],
            put_ahead=put_ahead, wait_for=lambda batches, ready: None)
        self.model, self.state = model, state
        self.epoch = 0
        # the first steps, the ones the check compares
        losses = self._epoch(list(range(1)))
        self.grad = {n: _first_gradient(tx, p)
                     for n, p in model.named_parameters()}
        losses += self._epoch(list(range(1, CHECK_STEPS)))
        self.losses = losses
        self.theta = {n: p.detach().cpu().clone()
                      for n, p in model.named_parameters()}
        self.phases["capture_and_checked_steps"] = lap()
        warm = int(self.mix["warmup_steps"])
        self._epoch([(CHECK_STEPS + k) % len(self.pool) for k in range(warm)])
        self.phases["warmup"] = lap()

    def _epoch(self, picks, deadline=None):
        """``train_epoch`` over the pool entries ``picks`` (or, with a
        ``deadline``, cycling the pool until host time passes it); returns
        the logged losses.  ``self.count`` is the number of steps."""
        P = len(self.pool)
        videos = [v for v, _ in self.pool]
        images = [i for _, i in self.pool]

        def take(k):
            if deadline is not None:
                return k % P if time.perf_counter() < deadline else None
            return picks[k] if k < len(picks) else None

        self.trainer.train_loader = _Loader(videos, take)
        # the image batch pairs with its video batch
        self.trainer.image_loader = _Loader(
            images, lambda k: picks[k] if picks and k < len(picks)
            else k % P)
        meter = _Recording(1 << 20, self.cfg, self.meters)
        from svit_tpu_torch.engine.train import train_epoch

        before = self.state.step
        self.state, _ = train_epoch(self.cfg, self.trainer, self.state,
                                    meter, self.epoch, start_iter=0)
        self.epoch += 1
        self.count = self.state.step - before
        return [md["loss"] for md in meter.records]

    def window(self, seconds: float):
        """Whole steps until ``seconds`` have passed; returns (steps,
        window seconds)."""
        _sync(self.device)
        t0 = time.perf_counter()
        self._epoch(None, deadline=t0 + seconds)
        _sync(self.device)
        return self.count, time.perf_counter() - t0

    def traced_units(self) -> int:
        n = int(self.mix["trace_steps"])
        self._epoch([k % len(self.pool) for k in range(n)])
        return self.count

    def flops_per_unit(self) -> float:
        return yardstick.train_step_flops(
            self.arch, int(self.mix["video_batch"]),
            int(self.mix["image_batch"]),
            with_consistency=self.with_consistency)

    def bound_s_per_unit(self) -> float:
        return yardstick.bound_s(yardstick.train_step_ops(
            self.arch, int(self.mix["video_batch"]),
            int(self.mix["image_batch"]), self.with_consistency))

    def release(self) -> None:
        """Free the program's state (after the peak has been read)."""
        self.trainer = self.model = self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def reference(self, prec: str = "f32", batches=None) -> dict:
        """The reference's three steps from the run's weights: its losses,
        its first clipped gradient and its change over the three steps."""
        W = weights.make_weights(self.specs, self.seed, self.device)
        ref = ref_step.TrainReference(
            self.ref_cfg, W, self.spe, prec,
            chunk=int(self.mix.get("reference_chunk", 4)),
            frames_chunk=int(self.mix.get("reference_frames_chunk", 64)))
        losses, grad = [], None
        for k in range(CHECK_STEPS):
            video, image = (batches or self.pool)[k]
            r = ref.step(video, image)
            losses.append(r["loss"])
            if k == 0:
                grad = {n: g.detach() for n, g in r["grads"].items()}
                reached = set(ref.image_reached)
        update = {n: (ref.P[n].detach() - W[n]) for n in W}
        return {"losses": losses, "grad": grad, "update": update,
                "image_reached": reached}

    def program_readings(self) -> dict:
        W = weights.make_weights(self.specs, self.seed, self.device)
        return {"losses": self.losses,
                "grad": {n: g.to(self.device) for n, g in self.grad.items()},
                "update": {n: self.theta[n].to(self.device) - W[n]
                           for n in self.theta}}

    def numbers(self) -> dict:
        prog = self.program_readings()
        with _no_tf32():
            ref = self.reference("f32")
        return check.train_numbers(prog, ref)


def _first_gradient(tx, p):
    """The gradient AdamW took at its first step, from its first moment
    (m = (1 - b1) g); zeros where it holds no state for ``p``."""
    m = tx.optimizer.state.get(p, {}).get("exp_avg")
    if m is None:
        return torch.zeros(p.shape)
    return (m / (1.0 - ref_step.BETAS[0])).detach().cpu()


def load_weights(model, specs, seed, device) -> None:
    """The run's weights into the program's module, by name; the names and
    shapes must be the reference's."""
    params = dict(model.named_parameters())
    want = {n: s for n, s, _ in specs}
    have = {n: tuple(p.shape) for n, p in params.items()}
    if want != have:
        raise RuntimeError(
            "the program's parameters are not the reference's: "
            f"{sorted(set(want.items()) ^ set(have.items()))[:8]}")
    W = weights.make_weights(specs, seed, device)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(W[n])


class _Recording:
    """The program's ``TrainMeter`` that also keeps each step's metrics as
    the loop fetched them."""

    def __new__(cls, iters, cfg, meters):
        class Meter(meters.TrainMeter):
            def __init__(self):
                super().__init__(iters, cfg)
                self.records = []

            def update_stats(self, lr, mb_size, dloss):
                self.records.append(dict(dloss))
                super().update_stats(lr, mb_size, dloss)

        return Meter()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lap_clock(device):
    """A function that waits for ``device`` and returns the seconds since
    its last call: the set-up's phases, for the run's log."""
    last = [time.perf_counter()]

    def lap():
        _sync(device)
        now = time.perf_counter()
        seconds, last[0] = now - last[0], now
        return round(seconds, 3)

    return lap


class _no_tf32:
    """TF32 off for the reference's f32 products and convolutions."""

    def __enter__(self):
        self.was = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.was
