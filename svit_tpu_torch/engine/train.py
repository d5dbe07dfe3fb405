"""Training engine (counterpart of ``svit_tpu/engine/train.py``, reference
``tools/train_net.py``).

One process drives one card: the fused video + image train step
(``engine/steps.py:make_packed_train_step``) runs on the batches that the
host loaders stream, captured in a CUDA graph per batch shape and replayed
(``engine/graphs.py``, the JAX package's ``jax.jit``), as are the eval
steps.  While a step replays, the host takes the next batch from the
loaders and issues its host-to-device copies on a copy stream, ordered
with the step by an event.  The step's metrics stay on the device as one
f32 vector a step, cloned out of the graph's output; they are fetched once
per ``LOG_PERIOD`` window (one stack, one device-to-host copy), where the
NaN guard runs, so no step waits on the host.  With ``TPU.DEVICE_AUG`` the
loaders ship raw uint8 frames and the step augments them on the card
(``data/device_aug.py``).  bf16 needs no loss scaling.

- Several cards: one process each (``utils/misc.py:launch_job``), over a
  (data, model) mesh (``parallel/mesh.py``).  Each rank reads its share
  of every global batch; the step sums the gradients over the data group
  inside its CUDA graph, before the clip (the reference's DDP hooks would
  run outside the graph, and DDP rebuilds its buckets during the warm-up
  that precedes a capture); ``TPU.MESH_MODEL > 1`` shards the MLPs.  The
  master logs, writes the checkpoints (full tensors, gathered over the
  model group) and holds the meters, whose eval counts are summed over
  the ranks.  With one process there is no group and no collective.

- Resume: ``TRAIN.AUTO_RESUME`` continues from the last checkpoint, at the
  next epoch or, after a mid-epoch save, at its iteration; else
  ``TRAIN.CHECKPOINT_FILE_PATH`` warm-starts by name and shape, else
  ``MODEL.LOAD_IN_PRETRAIN`` loads a timm image pretrain.
- Preemption: SIGTERM sets a flag that the loop polls after every step
  (with several processes, at each ``LOG_PERIOD`` boundary: ``_stop_now``);
  it then saves a mid-epoch checkpoint and returns.
- Multigrid long cycles rebuild the Trainer at a new (B, T, S), the
  parameters carried over by shape (``train_net.py:541-564``).
- ``TPU.PROFILE_DIR`` takes a ``torch.profiler`` trace of the first epoch.
- Stochastic depth and dropout draw from a generator on the model's device,
  seeded by (``RNG_SEED``, step) at every step as JAX folds the step into
  its key, so a resumed run draws what the uninterrupted one would; every
  rank seeds it alike and keeps its rows of the global batch's draws, so
  the masks do not depend on the mesh.

    python -m svit_tpu_torch.engine.train --cfg configs/ssv2.yaml [KEY VALUE ...]

runs on the card, and raises without one.
"""

from __future__ import annotations

import os
import pprint
import signal
import time

import numpy as np
import torch

from svit_tpu_torch.config import assert_and_infer_cfg, load_config, parse_args
from svit_tpu_torch.config.defaults import num_image_ranks
from svit_tpu_torch.data import device_aug
from svit_tpu_torch.data.loader import construct_loader, shuffle_dataset
from svit_tpu_torch.engine import graphs
from svit_tpu_torch.engine import meters as meters_lib
from svit_tpu_torch.engine import steps
from svit_tpu_torch.engine.multigrid import MultigridSchedule
from svit_tpu_torch.engine.test import to_device
from svit_tpu_torch.models import build_model, losses
from svit_tpu_torch.models.optimizer import construct_optimizer
from svit_tpu_torch.parallel import dist as du
from svit_tpu_torch.parallel import mesh as meshlib
from svit_tpu_torch.utils import checkpoint as cu
from svit_tpu_torch.utils import converter, logging, misc
from svit_tpu_torch.utils.lr_policy import get_lr_at_epoch

logger = logging.get_logger(__name__)

_IMAGE_KEYS = ("frames", "haog_bboxes", "contact_state", "weight")
_VIDEO_KEYS = ("clips", "labels", "weight")


def step_seed(seed: int, step: int) -> int:
    """The generator's seed at ``step`` (JAX ``fold_in(rng, step)``'s
    role), the same on every rank: each rank's step draws for the global
    batch and keeps its rows (``DataShare.draws``)."""
    return int(np.random.SeedSequence([int(seed), int(step)])
               .generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    """Everything that depends on the current (B, T, S) shape: the model,
    the loaders, the optimizer and the steps."""

    def __init__(self, cfg, device=None, mesh=None):
        self.cfg = cfg
        self.mesh = meshlib.Mesh(1, 1) if mesh is None else mesh
        self.model, self.arch = build_model(cfg, device=device, train=True)
        meshlib.shard_model(self.model, self.mesh)
        self.device = next(self.model.parameters()).device
        self.loss_obj = losses.get_loss_func(cfg)
        shard = meshlib.data_sharding(self.mesh)
        self.train_loader, self.image_loader = construct_loader(
            cfg, "train", shard)
        self.val_loader = construct_loader(cfg, "val", shard)
        self.steps_per_epoch = len(self.train_loader)
        self.tx, _ = construct_optimizer(cfg, self.model,
                                         self.steps_per_epoch)
        if self.mesh.model > 1:
            spec = meshlib.local_spec(self.mesh, self.model)
            self.tx.shard(self.mesh.model_group,
                          [p for n, p in self.model.named_parameters()
                           if n in spec])

        self.with_image = self.image_loader is not None
        w_i = (num_image_ranks(cfg) / max(cfg.NUM_GPUS, 1)
               if self.with_image else 0.0)
        if self.with_image and w_i >= 1.0:
            logger.warning(
                "video-loss weight is %.2f (image ranks %d / %d devices): "
                "the video objective contributes nothing to gradients",
                1.0 - w_i, num_image_ranks(cfg), cfg.NUM_GPUS)
        self.video_weight, self.image_weight = 1.0 - w_i, w_i
        with_consistency = bool(cfg.TRAIN.FORWARD_VIDEO_FRAMES
                                and cfg.SVIT.CONSISTENCY_LOSS)
        aug_cfg = (device_aug.config_from_cfg(cfg) if cfg.TPU.DEVICE_AUG
                   else None)
        packed, self.metric_names = steps.make_packed_train_step(
            self.model, self.loss_obj, self.tx,
            video_weight=self.video_weight, image_weight=self.image_weight,
            with_image=self.with_image,
            with_consistency=with_consistency, device_aug_cfg=aug_cfg,
            mesh=self.mesh)
        self.step_fn = graphs.CapturedTrainStep(packed)
        # the val loss dict carries the train loss keys (reference
        # eval_extra_metrics) when the loss object makes dicts
        val_loss_obj = (self.loss_obj if hasattr(self.loss_obj, "weighted_sum")
                        else None)
        self.eval_step = graphs.CapturedStep(steps.make_eval_step(
            self.model, self.arch.num_classes, loss_obj=val_loss_obj,
            with_consistency=with_consistency))
        self.image_val_loader = self.image_eval_step = None
        if self.with_image and val_loss_obj is not None:
            self.image_val_loader = construct_loader(cfg, "image_val", shard)
            if self.image_val_loader is not None:
                self.image_eval_step = graphs.CapturedStep(
                    steps.make_image_eval_step(self.model, val_loss_obj))
        # bf16 pixels over the wire under mixed precision: the model casts
        # to bf16 anyway, and it halves the host-to-device bytes
        self.pixel_dtype = (torch.bfloat16 if cfg.TRAIN.MIXED_PRECISION
                            else None)
        self.generator = torch.Generator(device=self.device)
        # host seconds of each step's data wait (loader, then the copies)
        self.data_seconds: list = []
        # the next batch's copies run here while the step replays
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

    def put_batch(self, batch):
        """The batch on the model's device: clips and frames in the pixel
        dtype (uint8 frames of the device augmentation pass untouched),
        other integer arrays as int64, each array one copy."""
        out = {}
        for k, v in batch.items():
            dtype = None
            if k in ("clips", "frames"):
                dtype = self.pixel_dtype if v.dtype == np.float32 else None
            elif np.issubdtype(v.dtype, np.integer):
                dtype = torch.int64
            out[k] = to_device(v, self.device, dtype)
        return out

    def put_ahead(self, *batches):
        """``put_batch`` of each batch (None stays None) with the copies
        issued on the copy stream; returns the device batches and the event
        that marks their arrival (None off the card)."""
        if self.copy_stream is None:
            return [b if b is None else self.put_batch(b)
                    for b in batches], None
        with torch.cuda.stream(self.copy_stream):
            out = [b if b is None else self.put_batch(b) for b in batches]
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        return out, ready

    def wait_for(self, batches, ready) -> None:
        """Order the current stream after the copies of ``put_ahead``, and
        keep their memory from reuse until the current stream is done with
        it."""
        if ready is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ready)
        for t in graphs.tensors(batches):
            t.record_stream(cur)

    def fresh_state(self) -> steps.TrainState:
        return steps.create_train_state(self.model, self.tx)

    def carry_over_state(self, old_state) -> steps.TrainState:
        """Shape-filtered parameter transfer on a multigrid shape change: a
        fresh optimizer, the step carried over."""
        merged = cu.shape_filtered_merge(self.model.state_dict(),
                                         old_state.model.state_dict())
        self.model.load_state_dict(merged)
        state = self.fresh_state()
        state.step = old_state.step
        return state


class _PreemptionGuard:
    """Save and exit on SIGTERM: the train loop polls ``fired`` after every
    step and checkpoints mid-epoch, so auto-resume continues at the exact
    iteration."""

    def __init__(self):
        self.fired = False
        self._prev = None
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handle)
        except ValueError:
            pass  # not in the main thread

    def _handle(self, signum, frame):
        self.fired = True

    def restore(self):
        if self._prev is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev)
            except ValueError:
                pass


def _warm_start(cfg, trainer):
    """``TRAIN.CHECKPOINT_FILE_PATH`` or ``MODEL.LOAD_IN_PRETRAIN`` into the
    model, merged by name and shape."""
    if cfg.TRAIN.CHECKPOINT_FILE_PATH:
        loaded = cu.read_params(cfg.TRAIN.CHECKPOINT_FILE_PATH, cfg)
        what = f"Warm-started from {cfg.TRAIN.CHECKPOINT_FILE_PATH}"
    elif cfg.MODEL.LOAD_IN_PRETRAIN:
        arch = trainer.arch
        loaded = converter.load_timm_pretrained(
            cfg.MODEL.LOAD_IN_PRETRAIN,
            num_patches=arch.patch_dims[1] * arch.patch_dims[2],
            patch_kernel_t=arch.patch_kernel[0],
            patch_kernel_hw=arch.patch_kernel[1:],
            num_classes=(arch.num_classes
                         if isinstance(arch.num_classes, int) else -1))
        what = f"Loaded image pretrain {cfg.MODEL.LOAD_IN_PRETRAIN}"
    else:
        return
    model = trainer.model
    loaded = meshlib.shard_state_dict(loaded, trainer.mesh, model)
    merged = cu.shape_filtered_merge(model.state_dict(), loaded)
    model.load_state_dict(merged)
    logger.info(what)


def train(cfg, device=None):
    """Train ``cfg``'s model on the card (or ``device``); returns the final
    train state."""
    np.random.seed(cfg.RNG_SEED)
    logging.setup_logging(cfg.OUTPUT_DIR, is_master=du.is_master_proc())
    logger.info("Train with config:")
    logger.info(pprint.pformat(cfg.to_dict()))

    multigrid = None
    if cfg.MULTIGRID.LONG_CYCLE or cfg.MULTIGRID.SHORT_CYCLE:
        multigrid = MultigridSchedule()
        cfg = multigrid.init_multigrid(cfg)

    mesh = meshlib.build_mesh(cfg)
    trainer = Trainer(cfg, device, mesh)
    state = trainer.fresh_state()

    def save(epoch, **kwargs):
        cu.save_checkpoint(cfg.OUTPUT_DIR, state, epoch, cfg, mesh=mesh,
                           **kwargs)

    start_epoch = start_iter = 0
    last = (cu.get_last_checkpoint(cfg.OUTPUT_DIR)
            if cfg.TRAIN.AUTO_RESUME else None)
    if last:
        restored, epoch = cu.load_train_state(last, state, mesh)
        if restored["step_in_epoch"] >= 0:
            # a mid-epoch (preemption) save: continue inside this epoch
            start_epoch, start_iter = epoch, restored["step_in_epoch"]
        else:
            start_epoch = epoch + 1
        logger.info("Auto-resumed from %s (epoch %d, iter %d)", last,
                    start_epoch, start_iter)
    else:
        _warm_start(cfg, trainer)

    if cfg.LOG_MODEL_INFO:
        misc.log_model_info(trainer.model, cfg)

    if cfg.TRAIN.VAL_ONLY:
        val_meter = meters_lib.ValMeter(len(trainer.val_loader), cfg)
        eval_epoch(cfg, trainer, state, val_meter, start_epoch)
        return state

    train_meter = meters_lib.TrainMeter(trainer.steps_per_epoch, cfg)
    val_meter = meters_lib.ValMeter(len(trainer.val_loader), cfg)
    epoch_timer = meters_lib.EpochTimer()
    guard = _PreemptionGuard()
    profile_dir = cfg.TPU.PROFILE_DIR

    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        if _any_rank(guard.fired):
            logger.warning("SIGTERM received: checkpointing at epoch %d and "
                           "exiting", cur_epoch - 1)
            save(cur_epoch - 1)
            break
        epoch_start_iter, start_iter = start_iter, 0
        if multigrid is not None and multigrid.schedule is not None:
            cfg, changed = multigrid.update_long_cycle(cfg, cur_epoch)
            if changed:
                trainer = Trainer(cfg, device, mesh)
                state = trainer.carry_over_state(state)
                train_meter = meters_lib.TrainMeter(trainer.steps_per_epoch,
                                                    cfg)
                val_meter = meters_lib.ValMeter(len(trainer.val_loader), cfg)

        shuffle_dataset((trainer.train_loader, trainer.image_loader),
                        cur_epoch)
        epoch_timer.epoch_tic()
        prof = None
        if profile_dir and cur_epoch == start_epoch:
            prof = _start_profile(trainer.device)
        state, preempted_at = train_epoch(
            cfg, trainer, state, train_meter, cur_epoch,
            start_iter=epoch_start_iter, guard=guard)
        if prof is not None:
            _stop_profile(prof, profile_dir)
        if preempted_at is not None:
            logger.warning("SIGTERM received: checkpointing mid-epoch %d "
                           "(iter %d) and exiting", cur_epoch, preempted_at)
            save(cur_epoch, step_in_epoch=preempted_at)
            break
        epoch_timer.epoch_toc()
        logger.info("Epoch %d took %.2fs (avg %.2fs, median %.2fs)",
                    cur_epoch, epoch_timer.last_epoch_time(),
                    epoch_timer.avg_epoch_time(),
                    epoch_timer.median_epoch_time())

        if cu.is_checkpoint_epoch(cfg, cur_epoch):
            save(cur_epoch)
        if ((cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0
                or cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH):
            eval_epoch(cfg, trainer, state, val_meter, cur_epoch)
    guard.restore()
    return state


def _start_profile(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir):
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"train_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    logger.info("Wrote the first epoch's trace to %s", path)


def train_epoch(cfg, trainer, state, train_meter, cur_epoch,
                start_iter: int = 0, guard=None):
    """One epoch from ``start_iter``, polling ``guard`` after every step.

    Returns ``(state, preempted_at)``: ``preempted_at`` is the number of
    completed iterations when SIGTERM arrived (the caller saves a mid-epoch
    checkpoint), or None when the epoch finished."""
    image_iter = None
    if trainer.image_loader is not None:
        image_iter = trainer.image_loader.iter_batches(
            start_iter % max(len(trainer.image_loader), 1))
    mixup_fn = None
    if cfg.MIXUP.ENABLE:
        from svit_tpu_torch.data.mixup import MixUp

        nc = trainer.arch.num_classes
        mixup_fn = MixUp(
            mixup_alpha=cfg.MIXUP.ALPHA, cutmix_alpha=cfg.MIXUP.CUTMIX_ALPHA,
            mix_prob=cfg.MIXUP.PROB, switch_prob=cfg.MIXUP.SWITCH_PROB,
            label_smoothing=cfg.MIXUP.LABEL_SMOOTH_VALUE,
            num_classes=nc if isinstance(nc, int) else 0,
            rng=np.random.default_rng(cfg.RNG_SEED + cur_epoch))
    # deferred metric fetch: the device vectors of a LOG_PERIOD window, then
    # one stack and one copy; the NaN guard names the exact step, up to
    # LOG_PERIOD - 1 steps late
    pending = []   # (cur_iter, lr, batch count, device metric vector)

    def flush_pending():
        if not pending:
            return
        fetched = torch.stack([m for (_, _, _, m) in pending]).cpu().numpy()
        names = trainer.metric_names
        for (it, lr_i, n_i, _), row in zip(pending, fetched):
            md = dict(zip(names, row.tolist()))
            steps.check_nan(md, f"(epoch {cur_epoch}, iter {it})")
            train_meter.update_stats(lr_i, n_i, md)
        pending.clear()

    batches = enumerate(trainer.train_loader.iter_batches(start_iter),
                        start=start_iter)

    def fetch():
        """The next batch from the loaders, its copies issued ahead."""
        nonlocal image_iter
        t_data = time.perf_counter()
        try:
            cur_iter, video_batch = next(batches)
        except StopIteration:
            return None
        if mixup_fn is not None:
            clips, soft = mixup_fn(video_batch["clips"], video_batch["labels"])
            video_batch = dict(video_batch, clips=clips, labels=soft)
        image_batch = None
        if image_iter is not None:
            try:
                image_batch = next(image_iter)
            except StopIteration:
                image_iter = iter(trainer.image_loader)
                image_batch = next(image_iter)
            image_batch = {k: image_batch[k] for k in _IMAGE_KEYS}
        on_device, ready = trainer.put_ahead(
            {k: video_batch[k] for k in _VIDEO_KEYS}, image_batch)
        trainer.data_seconds.append(time.perf_counter() - t_data)
        return (cur_iter, int(video_batch["weight"].sum()), on_device,
                ready)

    train_meter.iter_tic()
    nxt = fetch()
    while nxt is not None:
        cur_iter, n_videos, (vb, image_batch), ready = nxt
        train_meter.data_toc()
        trainer.wait_for((vb, image_batch), ready)
        trainer.generator.manual_seed(step_seed(cfg.RNG_SEED, state.step))
        state, metrics = trainer.step_fn(state, vb, image_batch,
                                         trainer.generator)
        lr = get_lr_at_epoch(cfg, cur_epoch
                             + cur_iter / trainer.steps_per_epoch)
        # the graph's output is overwritten by the next replay
        pending.append((cur_iter, lr, n_videos, metrics.clone()))
        # the next batch's wait and copies overlap the step; its wait is
        # this window's data time (``dt_data``, as JAX's loop counts it)
        train_meter.data_resume()
        nxt = fetch()
        train_meter.data_toc()
        train_meter.iter_toc()
        at_log = (cur_iter + 1) % cfg.LOG_PERIOD == 0
        if at_log:
            flush_pending()
            train_meter.log_iter_stats(cur_epoch, cur_iter)
        if guard is not None and _stop_now(guard, at_log):
            flush_pending()   # the mid-epoch checkpoint must be real
            train_meter.reset()
            return state, cur_iter + 1
        train_meter.iter_tic()
    flush_pending()
    train_meter.log_epoch_stats(cur_epoch)
    train_meter.reset()
    return state, None


def _any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (every rank stops at the same
    step); the flag itself with one process."""
    if du.get_world_size() == 1:
        return flag
    return any(du.all_gather_host(bool(flag)))


def _stop_now(guard, at_log: bool) -> bool:
    """Whether SIGTERM stops the epoch after this step.  With one process
    the flag is read after every step.  With several the ranks agree on it
    only at the ``LOG_PERIOD`` boundaries (``at_log``), where the loop
    waits for the device anyway, since the host gather syncs with it: a
    rank stops up to ``LOG_PERIOD - 1`` steps after its signal, and every
    rank at the same step."""
    if du.get_world_size() == 1:
        return guard.fired
    return at_log and _any_rank(guard.fired)


def _combine(outs):
    """One eval batch's scalars over the ranks' shares: counts and correct
    counts summed, losses weighted by each share's count."""
    if len(outs) == 1:
        return outs[0]
    total = sum(o["count"] for o in outs)
    out = {}
    for k in outs[0]:
        if k == "count" or k.endswith("_correct"):
            out[k] = sum(o[k] for o in outs)
        else:
            out[k] = sum(o[k] * o["count"] for o in outs) / max(total, 1.0)
    return out


def eval_epoch(cfg, trainer, state, val_meter, cur_epoch):
    """The val split through ``make_eval_step`` and, with an image val
    split, ``make_image_eval_step``, into ``val_meter``; returns its epoch
    stats.  One device-to-host copy a batch."""
    del state   # the steps hold the trainer's model, which the state holds
    for cur_iter, batch in enumerate(trainer.val_loader):
        vb = trainer.put_batch({k: batch[k] for k in _VIDEO_KEYS})
        val_meter.iter_tic()
        out = _fetch(trainer.eval_step(vb))
        if du.get_world_size() > 1:
            out = _combine(du.all_gather_host(out))
        # multitask: per-task weighted counts beside the joint ones
        task_correct = {
            k[:-len("_top1_correct")]: (
                v, out[k[:-len("_top1_correct")] + "_top5_correct"])
            for k, v in out.items() if k.endswith("_top1_correct")}
        val_meter.update_stats(
            out["top1_correct"], out["top5_correct"], out["count"],
            extra={k: v for k, v in out.items()
                   if k not in ("top1_correct", "top5_correct", "count")
                   and not k.endswith(("_top1_correct", "_top5_correct"))},
            task_correct=task_correct or None)
        val_meter.iter_toc()
        val_meter.log_iter_stats(cur_epoch, cur_iter)
    # the image branch's val pass: the HAOG losses on the image val split
    # (the reference's val loss is video-only, losses.py:124)
    if trainer.image_eval_step is not None:
        for batch in trainer.image_val_loader:
            ib = trainer.put_batch({k: batch[k] for k in _IMAGE_KEYS})
            out = _fetch(trainer.image_eval_step(ib))
            if du.get_world_size() > 1:
                out = _combine(du.all_gather_host(out))
            n = out.pop("count")
            out.pop("loss")   # keep the val "loss" video-only
            val_meter.update_image_stats(n, out)
    stats = val_meter.log_epoch_stats(cur_epoch)
    val_meter.reset()
    return stats


def _fetch(out):
    """The scalar entries of a step's output as floats, in one copy (the
    logits stay on the device)."""
    keys = [k for k, v in out.items() if torch.is_tensor(v) and v.dim() == 0]
    vals = torch.stack([out[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def main(argv=None):
    misc.launch_job(assert_and_infer_cfg(load_config(parse_args(argv))),
                    func=train)


if __name__ == "__main__":
    main()
