"""The port's training entry point (``svit_tpu_torch/engine/train.py``)
against the JAX package's, on the CPU at ``tests/test_train_engine.py``'s
reduced size (depth 2, width 32, 32 px, 4 frames, f32, batch 2 + 2 images
on ``tests/fixtures.py``'s mini-SSv2 tree), with ``configs/ssv2.yaml``'s
augmentation and the consistency term on and the random rates at 0.

- One epoch: from the JAX Trainer's initial parameters (through
  ``params_from_jax``), both ``train_epoch``s over the same batches (the
  loaders agree bit for bit, ``tests/test_torch_train_data.py``); every
  step's packed metric vector, by name, within
  ``tests/test_torch_train_step.py``'s tolerance (1e-5 relative: f32 on
  both sides, different summation orders), the learning rate and the
  sample count exactly.
- Checkpoints: a save at the end of an epoch, then auto-resume, restores
  parameters and optimizer state bit for bit; a SIGTERM guard fired after
  step 1 saves ``step_in_epoch`` 1 and the run resumes at iter 1.
- ``eval_epoch``'s stats keys (and values, to 1e-5) equal JAX's; the
  multigrid long-cycle schedule equals JAX's, and a two-phase long cycle
  rebuilds the Trainer with the parameters carried over by shape; a
  ``TRAIN.CHECKPOINT_FILE_PATH`` warm start and a timm pretrain merge by
  shape; ``TPU.PROFILE_DIR`` writes a trace and ``TRAIN.VAL_ONLY`` runs one
  eval epoch; the command line refuses to run without a card.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from svit_tpu.config import assert_and_infer_cfg as jax_infer
from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.data import shuffle_dataset as jax_shuffle
from svit_tpu.engine import meters as jax_meters
from svit_tpu.engine import train as jax_train
from svit_tpu.engine.multigrid import MultigridSchedule as JaxSchedule
from svit_tpu.parallel import mesh as meshlib
from svit_tpu.utils import converter as jax_converter
from svit_tpu_torch.config import assert_and_infer_cfg, get_cfg
from svit_tpu_torch.data.loader import shuffle_dataset
from svit_tpu_torch.engine import graphs, meters
from svit_tpu_torch.engine import train as ttrain
from svit_tpu_torch.engine.multigrid import MultigridSchedule
from svit_tpu_torch.utils import checkpoint as cu
from svit_tpu_torch.utils import converter
from svit_tpu_torch.utils.converter import params_from_jax
from tests.fixtures import make_ssv2_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _tiny_cfg(get, infer, root, out_dir, **kw):
    """``tests/test_train_engine.py:_tiny_cfg`` over ``configs/ssv2.yaml``
    (its augmentation on), with the consistency term."""
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.SSV2.DATA_ROOT = root
    cfg.MODEL.NUM_CLASSES = 5
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.TRAIN_JITTER_SCALES = [36, 44]
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.EMBED_DIM = 32
    cfg.MVIT.NUM_HEADS = 1
    cfg.MVIT.PATCH_KERNEL = [3, 7, 7]
    cfg.MVIT.PATCH_STRIDE = [2, 4, 4]
    cfg.MVIT.PATCH_PADDING = [1, 3, 3]
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.TRAIN.EVAL_PERIOD = 1
    cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.TRAIN.MIXED_PRECISION = False
    cfg.TRAIN.FORWARD_VIDEO_FRAMES = True
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    cfg.IMAGE_TRAIN.BATCH_SIZE = 2
    cfg.IMAGE_TRAIN.GPU_IDS = [1]
    cfg.NUM_GPUS = 2
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.SOLVER.BASE_LR = 1e-4
    cfg.SOLVER.WARMUP_EPOCHS = 0.0
    cfg.SOLVER.COSINE_END_LR = 1e-6
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.LOG_PERIOD = 1
    cfg.OUTPUT_DIR = out_dir
    cfg.TPU.MESH_DATA = 2
    cfg.TPU.MESH_MODEL = 1
    for k, v in kw.items():
        node, leaf = cfg, k.split(".")
        for p in leaf[:-1]:
            node = node[p]
        node[leaf[-1]] = v
    return infer(cfg)


def _cfgs(root, out, **kw):
    return (_tiny_cfg(get_cfg, assert_and_infer_cfg, root, out, **kw),
            _tiny_cfg(jax_get_cfg, jax_infer, root, out, **kw))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ssv2"))
    make_ssv2_fixture(path)
    return path


class _Recorder:
    """A train meter that keeps every step's (lr, count, metrics)."""

    def __init__(self):
        self.rows = []

    def update_stats(self, lr, n, md):
        self.rows.append((lr, n, md))

    def __getattr__(self, name):   # tics, tocs, logs, reset
        return lambda *a, **k: None


@pytest.fixture(scope="module")
def jax_run(root, tmp_path_factory):
    """The JAX Trainer's initial parameters, one epoch's per-step metrics
    and the eval stats of the initial parameters."""
    _, cfg = _cfgs(root, str(tmp_path_factory.mktemp("jax_out")))
    mesh = meshlib.build_mesh(cfg)
    with mesh:
        trainer = jax_train.Trainer(cfg, mesh)
        state = trainer.fresh_state()
        params = jax.device_get(state.params)
        stats = jax_train.eval_epoch(
            cfg, trainer, state,
            jax_meters.ValMeter(len(trainer.val_loader), cfg), 0)
        jax_shuffle((trainer.train_loader, trainer.image_loader), 0)
        rec = _Recorder()
        jax_train.train_epoch(cfg, trainer, state, rec, 0,
                              jax.random.PRNGKey(0))
    return params, rec.rows, stats


def _port_trainer(root, out, params):
    cfg, _ = _cfgs(root, out)
    trainer = ttrain.Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(params_from_jax(params))
    return cfg, trainer


def test_one_epoch_matches_jax(root, jax_run, tmp_path):
    params, want, _ = jax_run
    cfg, trainer = _port_trainer(root, str(tmp_path), params)
    assert (trainer.video_weight, trainer.image_weight) == (0.5, 0.5)
    state = trainer.fresh_state()
    shuffle_dataset((trainer.train_loader, trainer.image_loader), 0)
    rec = _Recorder()
    state, preempted = ttrain.train_epoch(cfg, trainer, state, rec, 0)
    assert preempted is None and state.step == len(want) == 2
    assert trainer.metric_names == sorted(want[0][2])
    for i, ((lr, n, md), (jlr, jn, jmd)) in enumerate(zip(rec.rows, want)):
        assert (lr, n) == (jlr, jn), i
        for k in jmd:
            np.testing.assert_allclose(md[k], jmd[k], rtol=RTOL,
                                       err_msg=f"step {i} {k}")


def test_one_epoch_through_a_graph_matches_jax(root, jax_run, tmp_path):
    """The Trainer's step captured, with a CPU stand-in for the CUDA graph
    whose replays write one static metric vector: every step still logs
    its own metrics (the loop clones each step's), equal to JAX's, and the
    warm-up before the capture leaves no trace."""
    from tests.test_torch_graphs import EagerGraph

    params, want, _ = jax_run
    cfg, trainer = _port_trainer(root, str(tmp_path), params)
    trainer.step_fn = graphs.CapturedTrainStep(trainer.step_fn.step,
                                               graph_factory=EagerGraph)
    state = trainer.fresh_state()
    shuffle_dataset((trainer.train_loader, trainer.image_loader), 0)
    rec = _Recorder()
    state, preempted = ttrain.train_epoch(cfg, trainer, state, rec, 0)
    assert preempted is None and state.step == len(want) == 2
    (entry,) = trainer.step_fn.entries.values()
    assert entry.replays == 2
    assert rec.rows[0][2] != rec.rows[1][2]
    for i, ((lr, n, md), (jlr, jn, jmd)) in enumerate(zip(rec.rows, want)):
        assert (lr, n) == (jlr, jn), i
        for k in jmd:
            np.testing.assert_allclose(md[k], jmd[k], rtol=RTOL,
                                       err_msg=f"step {i} {k}")


def test_eval_epoch_stats_match_jax(root, jax_run, tmp_path):
    params, _, want = jax_run
    cfg, trainer = _port_trainer(root, str(tmp_path), params)
    assert trainer.image_eval_step is not None
    stats = ttrain.eval_epoch(cfg, trainer, trainer.fresh_state(),
                              meters.ValMeter(len(trainer.val_loader), cfg), 0)
    assert set(stats) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(stats[k], v, rtol=RTOL, atol=1e-6,
                                       err_msg=k)


def _flat_opt(opt_state):
    return {f"{i}.{k}": v for i, s in opt_state["state"].items()
            for k, v in s.items()}


def test_checkpoint_resume_is_bit_exact(root, tmp_path):
    out = str(tmp_path / "out")
    cfg, _ = _cfgs(root, out)
    state = ttrain.train(cfg, device="cpu")
    assert state.step == 2
    ckpts = glob.glob(os.path.join(out, "checkpoints", "checkpoint_epoch_*"))
    assert [os.path.basename(c) for c in ckpts] == ["checkpoint_epoch_00001"]
    assert os.path.isfile(os.path.join(ckpts[0], "cfg.yaml"))

    # auto-resume restores the saved state bit for bit
    cfg2, _ = _cfgs(root, out, **{"SOLVER.MAX_EPOCH": 2})
    fresh = ttrain.Trainer(cfg2, device="cpu").fresh_state()
    restored, epoch = cu.load_train_state(cu.get_last_checkpoint(out), fresh)
    assert (epoch, restored["step_in_epoch"], fresh.step) == (0, -1, 2)
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    want = _flat_opt(state.tx.optimizer.state_dict())
    got = _flat_opt(fresh.tx.optimizer.state_dict())
    assert want.keys() == got.keys() and want
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]),
                           torch.as_tensor(want[k])), k
    # and the run continues at epoch 1
    assert ttrain.train(cfg2, device="cpu").step == 4
    # the test-time priority finds the last checkpoint and loads it
    assert cu.load_test_checkpoint_path(cfg2).endswith(
        "checkpoint_epoch_00002")


def test_preemption_resumes_at_iter(root, tmp_path, monkeypatch):
    """The guard fires at its second poll (after step 1 of epoch 0): a
    mid-epoch checkpoint with ``step_in_epoch`` 1; the rerun starts at iter
    1 and takes the one step left."""
    out = str(tmp_path / "out")
    cfg, _ = _cfgs(root, out)

    class FiredAfterStepOne:
        def __init__(self):
            self.polls = 0

        @property
        def fired(self):
            self.polls += 1
            return self.polls > 1

        def restore(self):
            pass

    monkeypatch.setattr(ttrain, "_PreemptionGuard", FiredAfterStepOne)
    assert ttrain.train(cfg, device="cpu").step == 1
    last = cu.get_last_checkpoint(out)
    assert last.endswith("checkpoint_epoch_00000_step_00000001")
    blob = torch.load(os.path.join(last, cu.STATE_FILE), weights_only=False)
    assert (blob["epoch"], blob["step_in_epoch"], blob["step"]) == (0, 1, 1)

    monkeypatch.undo()
    starts = []
    epoch_fn = ttrain.train_epoch

    def spy(*a, **k):
        starts.append(k["start_iter"])
        return epoch_fn(*a, **k)

    monkeypatch.setattr(ttrain, "train_epoch", spy)
    assert ttrain.train(cfg, device="cpu").step == 2
    assert starts == [1]


def test_profile_dir_and_val_only(root, tmp_path, monkeypatch):
    """``TPU.PROFILE_DIR`` writes a trace of the first epoch and, beside
    it, the owner tables (none off the card, where no graph is captured)
    and the loop's host spans; ``TRAIN.VAL_ONLY`` runs one eval epoch and
    no step."""
    cfg, _ = _cfgs(root, str(tmp_path / "p"),
                   **{"TPU.PROFILE_DIR": str(tmp_path / "trace")})
    assert ttrain.train(cfg, device="cpu").step == 2
    assert glob.glob(str(tmp_path / "trace" / "train_trace_*.json"))
    (owners,) = glob.glob(str(tmp_path / "trace" / "train_owners_*.json"))
    with open(owners) as f:
        got = json.load(f)
    assert got["graphs"] == []
    assert got["host_spans"]["train.dispatch"][0] >= 1
    evals = []
    eval_fn = ttrain.eval_epoch
    monkeypatch.setattr(ttrain, "eval_epoch",
                        lambda *a: evals.append(eval_fn(*a)) or evals[-1])
    cfg, _ = _cfgs(root, str(tmp_path / "v"), **{"TRAIN.VAL_ONLY": True})
    assert ttrain.train(cfg, device="cpu").step == 0
    assert len(evals) == 1 and "top1_err" in evals[0]


def test_multigrid_long_cycle_matches_jax():
    def base(get):
        cfg = get()
        cfg.MULTIGRID.LONG_CYCLE = True
        cfg.MULTIGRID.SHORT_CYCLE = True
        cfg.SOLVER.STEPS = [0, 20, 40, 60]
        cfg.SOLVER.LRS = [1.0, 0.1, 0.01]
        cfg.SOLVER.MAX_EPOCH = 70
        cfg.SOLVER.GAMMA = 0.1
        cfg.TRAIN.BATCH_SIZE = 64
        cfg.DATA.NUM_FRAMES = 16
        cfg.DATA.TRAIN_CROP_SIZE = 224
        return cfg

    ours, ref = MultigridSchedule(), JaxSchedule()
    cfg, jcfg = ours.init_multigrid(base(get_cfg)), ref.init_multigrid(
        base(jax_get_cfg))
    assert [(tuple(s[1]), s[2]) for s in ours.schedule] == \
        [(tuple(s[1]), s[2]) for s in ref.schedule]
    for key in ("STEPS", "LRS", "MAX_EPOCH"):
        assert cfg.SOLVER[key] == jcfg.SOLVER[key], key
    changes = 0
    for e in range(cfg.SOLVER.MAX_EPOCH):
        cfg, changed = ours.update_long_cycle(cfg, e)
        jcfg, jchanged = ref.update_long_cycle(jcfg, e)
        assert changed == jchanged, e
        changes += changed
        for a, b in ((cfg.TRAIN.BATCH_SIZE, jcfg.TRAIN.BATCH_SIZE),
                     (cfg.DATA.NUM_FRAMES, jcfg.DATA.NUM_FRAMES),
                     (cfg.DATA.TRAIN_CROP_SIZE, jcfg.DATA.TRAIN_CROP_SIZE)):
            assert a == b, e
    assert changes > 1


def test_multigrid_rebuilds_the_trainer(root, tmp_path, monkeypatch):
    """A two-phase long cycle (2 frames at batch 4 for epoch 0, then 4
    frames at batch 2; the model holds the train crop to the test crop, in
    JAX too, so only T changes) through ``train``: the Trainer is rebuilt
    at each shape, the parameters of equal shape are carried over, the
    temporal rel-pos tables (whose shape follows T) keep the new model's
    values, and the step count runs on."""
    cfg, _ = _cfgs(root, str(tmp_path / "mg"), **{
        "MULTIGRID.LONG_CYCLE": True,
        "MULTIGRID.LONG_CYCLE_FACTORS": [[0.5, 1.0], [1.0, 1.0]],
        "MULTIGRID.EPOCH_FACTOR": 1.0,
        "SOLVER.STEPS": [0, 2], "SOLVER.MAX_EPOCH": 2})
    built, carried = [], []
    base, carry = ttrain.Trainer, ttrain.Trainer.carry_over_state

    class Trainer(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append((self.arch.num_frames, self.cfg.TRAIN.BATCH_SIZE,
                          self.steps_per_epoch))

    def spy(self, old_state):
        old = {k: v.clone() for k, v in old_state.model.state_dict().items()}
        init = {k: v.clone() for k, v in self.model.state_dict().items()}
        state = carry(self, old_state)
        got = {k: v.clone() for k, v in state.model.state_dict().items()}
        carried.append((old, init, got, state.step))
        return state

    monkeypatch.setattr(ttrain, "Trainer", Trainer)
    monkeypatch.setattr(Trainer, "carry_over_state", spy)
    state = ttrain.train(cfg, device="cpu")
    # the first Trainer at the base shape, then one per long-cycle phase
    assert built == [(4, 2, 2), (2, 4, 1), (4, 2, 2)]
    assert len(carried) == 2
    assert state.step == 1 + 2
    for (old, init, got, step), before in zip(carried, (0, 1)):
        assert step == before
        differ = [k for k in old if old[k].shape != got[k].shape]
        assert differ and all("_t" in k for k in differ), differ
        for k, v in got.items():
            want = old[k] if old[k].shape == v.shape else init[k]
            assert torch.equal(v, want), k


def test_warm_start_merges_by_shape(root, tmp_path):
    """A checkpoint of a 7-class model: every other parameter is loaded,
    the head's projection keeps its initial values."""
    cfg, _ = _cfgs(root, str(tmp_path / "a"), **{"RNG_SEED": 3,
                                                 "MODEL.NUM_CLASSES": 7})
    other = ttrain.Trainer(cfg, device="cpu").model.state_dict()
    path = str(tmp_path / "other.pyth")
    torch.save({"model_state": other}, path)
    cfg, _ = _cfgs(root, str(tmp_path / "b"),
                   **{"TRAIN.CHECKPOINT_FILE_PATH": path})
    trainer = ttrain.Trainer(cfg, device="cpu")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    ttrain._warm_start(cfg, trainer)
    after = trainer.model.state_dict()
    for k, v in after.items():
        if k.startswith("head.projection"):
            assert torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, other[k]), k


def test_timm_pretrain_matches_jax(tmp_path):
    rs = np.random.RandomState(0)
    state = {
        "pos_embed": torch.from_numpy(rs.randn(1, 197, 96).astype(np.float32)),
        "patch_embed.proj.weight": torch.from_numpy(
            rs.randn(96, 3, 16, 16).astype(np.float32)),
        "patch_embed.proj.bias": torch.zeros(96),
        "head.weight": torch.zeros(1000, 96),
        "head.bias": torch.zeros(1000),
    }
    path = str(tmp_path / "timm.pth")
    torch.save(state, path)
    kw = dict(num_patches=3136, patch_kernel_t=3, patch_kernel_hw=(7, 7),
              num_classes=174)
    got = converter.load_timm_pretrained(path, **kw)
    want = jax_converter.load_timm_pretrained(path, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    w2d = state["patch_embed.proj.weight"]
    np.testing.assert_array_equal(
        converter.inflate_patch_kernel(w2d, 3).numpy(),
        jax_converter.inflate_patch_kernel(w2d.numpy(), 3))


def test_command_line_needs_a_card(root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--cfg", os.path.join(REPO, "configs", "ssv2.yaml"),
                     "SSV2.DATA_ROOT", root, "OUTPUT_DIR", str(tmp_path)])
