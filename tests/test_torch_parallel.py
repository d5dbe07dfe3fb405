"""The port's data and tensor parallelism (``svit_tpu_torch/parallel/``) on
the CPU: two processes in a gloo group (``tests/test_torch_parallel_worker.py``,
joined through a file, torch on one thread), held against one process and
against the JAX package.

- ``_param_spec``'s branches and the guard that replicates a tensor whose
  dim does not divide, against ``svit_tpu/parallel/mesh.py``'s rules;
- the loader's shares of each global batch, concatenated in rank order,
  are the one-process batch with its pads;
- data 2 x model 1: the train step on each rank's share equals one
  process's step on the concatenated batch, on a batch of 2 + 2, on one
  of 3 + 3 real rows padded to 4 + 4 (rank 1 alone holds a pad), and on
  the first with stochastic depth and dropout on (each rank keeps its
  rows of the global batch's masks, ``GlobalDraws``);
- ``GlobalDraws``: the ranks' draws, concatenated, are one process's;
- data 1 x model 2 (the MLPs sharded) against data 2 x model 1 (the
  counterpart of ``test_tp2_train_step_matches_dp8``), with the fused
  tail and with the unfused one (``MVIT.DROPOUT_RATE`` 0.1 beside
  drop-path and head dropout; ``MVIT.DIM_MUL_IN_ATT=False``);
- the model-2 forward against the JAX package's replicated forward at the
  same weights (``test_tp2_forward_matches_replicated``), and each
  unfused tail's deterministic forward the same way;
- the Trainer at data 1 x model 2 with ``TPU.REMAT=True`` through
  ``launch_job``, two one-step epochs against one process without remat:
  the logged losses, the first moments and the parameters of each
  epoch's checkpoint;
- a checkpoint written at model 2 loads at model 1 and holds the full
  tensors;
- the multi-view test on 2 ranks gives the 1-rank run's video scores.

Tolerances (f32, plain twins on the CPU; the ranks add in another order
than one process): losses and metrics within 1e-6 relative; each gradient
within 1e-5 of its tensor's largest magnitude (measured: 3.7e-6), floored
at 1e-3 of the model's largest gradient (a leaf whose true gradient is 0,
the k LN bias and the rel-pos tables behind it, holds rounding noise);
parameters after AdamW within 1e-6 of their tensor's scale plus what the
two runs' own gradients imply: Adam's first step moves an element by
``lr g / (|g| + 1e-8)``, which turns the rounding of a near-zero gradient
into a step of up to ``2 lr``.  The TP forward against JAX: 5e-5, as the
model tests.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import tests.test_torch_parallel_worker as worker
from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.models import build_model as jax_build
from svit_tpu.parallel import mesh as jax_mesh
from svit_tpu.utils.converter import torch_to_flax
from svit_tpu_torch.config import assert_and_infer_cfg, get_cfg
from svit_tpu_torch.data.loader import Loader, collate_video
from svit_tpu_torch.models import build_model
from svit_tpu_torch.parallel import mesh as meshlib
from svit_tpu_torch.utils import checkpoint as cu
from tests.fixtures import make_ssv2_fixture

SPAWN_TIMEOUT = 300


def _spawn(scenario, out_dir, extra=None):
    """Run ``scenario`` on two ranks; returns each rank's saved results."""
    ctx = mp.spawn(worker.main,
                   args=(2, os.path.join(out_dir, "init"), scenario,
                         str(out_dir), extra),
                   nprocs=2, join=False)
    try:
        while not ctx.join(SPAWN_TIMEOUT):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in (0, 1)]


@pytest.fixture(scope="module")
def one_process():
    """The one-process step on each global batch of ``worker.batches``."""
    torch.set_num_threads(1)
    cfg = worker.small_cfg()
    cases = [(cfg, b) for b in worker.batches(cfg)]
    cases += [(c, worker.batches(cfg)[0])
              for c in (worker.stochastic_cfg(), worker.proj_tail_cfg())]
    return [worker.train_step(c, meshlib.Mesh(1, 1), v, i)[:3]
            for c, (v, i) in cases]


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return _spawn("dp", tmp_path_factory.mktemp("dp2"))


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp2")
    return _spawn("tp", out), str(out)


def _lr(cfg):
    from svit_tpu_torch.models.optimizer import lr_table

    return float(lr_table(cfg, 10)[0])


def _assert_step_equal(got, want, lr):
    (m, g, p), (rm, rg, rp) = got, want
    assert set(m) == set(rm)
    for k in rm:
        np.testing.assert_allclose(m[k], rm[k], rtol=1e-6, err_msg=k)
    floor = 1e-3 * max(float(x.abs().max()) for x in rg.values())
    for k in rg:
        scale = max(float(rg[k].abs().max()), floor)
        np.testing.assert_allclose(g[k].numpy(), rg[k].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)

    def step(x):
        return x / (x.abs() + 1e-8)

    for k in rp:
        bound = (1e-6 * float(rp[k].abs().max()) + 1e-9
                 + lr * (step(g[k]) - step(rg[k])).abs())
        assert bool(((p[k] - rp[k]).abs() <= bound).all()), k


@pytest.mark.parametrize("case", [0, 1, 2, 3],
                         ids=["2+2", "3+3 padded", "2+2 drop-path",
                              "2+2 proj tail"])
def test_dp2_step_equals_one_process(dp2, one_process, case):
    lr = _lr(worker.small_cfg())
    for rank in dp2:
        _assert_step_equal(rank[case], one_process[case], lr)


@pytest.mark.parametrize("count", [2, 3])
def test_global_draws_concatenate_to_one_process(count):
    """Each share's ``rand`` and ``randn`` from one seed, concatenated in
    rank order, are one process's draws for the whole batch, in every call
    of a sequence; one share draws from the generator itself."""
    shapes = [(2, 3), (2,), (2, 4, 5)]
    kinds = ((meshlib.rand, torch.rand), (meshlib.randn, torch.randn))

    gen = torch.Generator().manual_seed(3)
    want = [plain((count * s[0], *s[1:]), generator=gen)
            for s in shapes for _, plain in kinds]
    parts = []
    for i in range(count):
        draws = meshlib.DataShare(None, i, count).draws(
            torch.Generator().manual_seed(3))
        assert isinstance(draws, meshlib.GlobalDraws)
        parts.append([f(s, draws, "cpu") for s in shapes for f, _ in kinds])
    for j, w in enumerate(want):
        assert torch.equal(torch.cat([p[j] for p in parts]), w), j
    assert meshlib.ONE.draws(gen) is gen
    gen.manual_seed(4)
    got = meshlib.rand((2, 3), gen, "cpu")
    assert torch.equal(got, torch.rand(
        (2, 3), generator=torch.Generator().manual_seed(4)))


def test_tp2_step_equals_dp2(tp2, dp2):
    """Data 1 x model 2 against data 2 x model 1 on the 2 + 2 batch: the
    gathered gradients and parameters of both model ranks."""
    lr = _lr(worker.small_cfg())
    ranks, _ = tp2
    for rank in ranks:
        _assert_step_equal(rank[0], dp2[0][0], lr)


@pytest.mark.parametrize("case", [1, 2], ids=["dropout", "proj tail"])
def test_tp2_unfused_tail_step_equals_dp2(tp2, dp2, case):
    """The unfused residual tail at data 1 x model 2 (fc1's columns and
    fc2's rows of this rank, the f32 partials summed before the bias, the
    hidden dropout this rank's columns of the whole mask) against data 2
    x model 1 on the 2 + 2 batch: with ``stochastic_cfg`` (dropout 0.1,
    drop-path 0.4, head dropout 0.5), and with ``proj_tail_cfg``."""
    lr = _lr(worker.small_cfg())
    ranks, _ = tp2
    for rank in ranks:
        _assert_step_equal(rank[case], dp2[0][case + 1], lr)


@pytest.mark.parametrize("case", ["dropout", "proj tail"])
def test_tp2_unfused_forward_equals_jax_replicated(tp2, case):
    """Each unfused tail's deterministic forward at model 2 against the
    JAX package's deterministic forward of the same weights, unsharded:
    ``proj_tail_cfg`` in eval mode; ``dropout_cfg`` in train mode with
    its dropout the identity (JAX's deterministic forward takes the
    unfused path whenever the rate is set)."""
    ranks, _ = tp2
    make = {"dropout": worker.dropout_cfg,
            "proj tail": worker.proj_tail_cfg}[case]
    model, _ = build_model(make(), device="cpu")
    params = torch_to_flax({k: v.detach().numpy().copy()
                            for k, v in model.state_dict().items()})
    jm, _ = jax_build(make(jax_get_cfg), use_pallas=False)
    video, _ = worker.batches(worker.small_cfg())[0]
    _, extra = jax.jit(lambda p, x: jm.apply(p, x, deterministic=True))(
        params, jnp.asarray(video["clips"]))
    for rank in ranks:
        logits, desc = rank[f"forward {case}"]
        np.testing.assert_allclose(logits.numpy(),
                                   np.asarray(extra["raw_logits"]),
                                   atol=5e-5, rtol=0)
        np.testing.assert_allclose(desc.numpy(),
                                   np.asarray(extra["obj_desc"]),
                                   atol=5e-5, rtol=0)
    assert torch.equal(ranks[0][f"forward {case}"][0],
                       ranks[1][f"forward {case}"][0])


def test_tp2_forward_equals_jax_replicated(tp2):
    """The model-2 eval forward (its MLPs sharded: K1's plain twin in its
    f32 mode, the partials summed across the ranks) against the JAX
    package's forward of the same weights, unsharded."""
    ranks, _ = tp2
    cfg = worker.small_cfg()
    model, _ = build_model(cfg, device="cpu")
    params = torch_to_flax({k: v.detach().numpy().copy()
                            for k, v in model.state_dict().items()})
    jcfg = worker.small_cfg(jax_get_cfg)
    jm, _ = jax_build(jcfg, use_pallas=False)
    video, _ = worker.batches(cfg)[0]
    logits, extra = jax.jit(lambda p, x: jm.apply(p, x, deterministic=True))(
        params, jnp.asarray(video["clips"]))
    for rank in ranks:
        got_logits, got_boxes = rank["forward"]
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                                   atol=5e-5, rtol=0)
        np.testing.assert_allclose(got_boxes.numpy(),
                                   np.asarray(extra["pred_bboxes"]),
                                   atol=5e-5, rtol=0)
    assert torch.equal(ranks[0]["forward"][0], ranks[1]["forward"][0])


def test_tp_checkpoint_loads_at_model_1(tp2):
    """The master of the model-2 run wrote full tensors: the checkpoint
    loads strictly into an unsharded model and its optimizer, and holds the
    gathered parameters."""
    ranks, out = tp2
    from svit_tpu_torch.engine import steps
    from svit_tpu_torch.models.optimizer import construct_optimizer

    cfg = worker.small_cfg()
    model, _ = build_model(cfg, device="cpu", train=True)
    tx, _ = construct_optimizer(cfg, model, steps_per_epoch=10)
    state = steps.create_train_state(model, tx)
    path = cu.get_last_checkpoint(out)
    restored, epoch = cu.load_train_state(path, state, meshlib.Mesh(1, 1))
    assert (restored["step"], epoch) == (1, 0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ranks[0][0][2][k]), k
    hidden = model.blocks[0].mlp.fc1.weight
    assert tx.optimizer.state[hidden]["exp_avg"].shape == hidden.shape


def test_param_spec_and_guard():
    """Every branch of ``_param_spec`` against the JAX package's rules (its
    flax [in, out] kernels transposed), and the guard: a dim the model axis
    does not divide replicates, and so does that MLP."""
    want = {"blocks.0.mlp.fc1.weight": 0, "blocks.0.mlp.fc1.bias": 0,
            "blocks.0.mlp.fc2.weight": 1, "blocks.0.mlp.fc2.bias": None,
            "blocks.0.attn.qkv.weight": None, "head.projection.weight": None,
            "cls_token": None}
    flax = {"fc1": {"kernel": (None, "model"), "bias": ("model",)},
            "fc2": {"kernel": ("model", None), "bias": ()}}
    for name, dim in want.items():
        assert meshlib._param_spec(name) == dim, name
    for parent, leaves in flax.items():
        for leaf, spec in leaves.items():
            got = jax_mesh._param_spec(("blocks_0", "mlp", parent, leaf),
                                       None)
            assert tuple(got) == spec
    jax_spec = jax_mesh._param_spec(("blocks_0", "attn", "qkv", "kernel"),
                                    None)
    assert tuple(jax_spec) == ()

    mesh = meshlib.Mesh(1, 2)
    shapes = {"blocks.0.mlp.fc1.weight": (384, 96),
              "blocks.0.mlp.fc1.bias": (384,),
              "blocks.0.mlp.fc2.weight": (96, 384),
              "blocks.0.mlp.fc2.bias": (96,),
              "blocks.1.mlp.fc1.weight": (385, 96),
              "blocks.1.mlp.fc2.weight": (96, 385)}
    spec = meshlib.param_sharding(mesh, shapes)
    assert spec["blocks.0.mlp.fc1.weight"] == 0
    assert spec["blocks.0.mlp.fc2.weight"] == 1
    assert spec["blocks.0.mlp.fc2.bias"] is None
    assert spec["blocks.1.mlp.fc1.weight"] is None   # 385 % 2
    assert spec["blocks.1.mlp.fc2.weight"] is None
    assert meshlib.param_sharding(meshlib.Mesh(2, 1), shapes)[
        "blocks.0.mlp.fc1.weight"] is None

    model, _ = build_model(worker.small_cfg(), device="cpu")
    assert set(meshlib.sharded_mlps(mesh, model)) == {"blocks.0.mlp",
                                                      "blocks.1.mlp"}
    model.blocks[1].mlp.fc1.weight = torch.nn.Parameter(torch.zeros(385, 96))
    assert set(meshlib.sharded_mlps(mesh, model)) == {"blocks.0.mlp"}


def test_build_mesh_without_a_group():
    """One process: one rank and no group, whatever the config asks."""
    cfg = get_cfg()
    cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL = 2, 2
    mesh = meshlib.build_mesh(cfg)
    assert (mesh.data, mesh.model, mesh.data_group, mesh.model_group) == (
        1, 1, None, None)


class _Items:
    """A dataset of numbered clips."""

    def __len__(self):
        return 7

    def __getitem__(self, i):
        return (np.full((1, 2, 2, 3), i, np.float32), i, i)


@pytest.mark.parametrize("count", [2, 3, 4])
def test_loader_shares_concatenate_to_the_batch(count):
    """Each rank's share, in rank order, is the one-process batch padded to
    a multiple of the data axis (pads at the end, zero weight, as JAX pads
    the global batch before sharding it)."""
    whole = Loader(_Items(), 3, shuffle=True, drop_last=False, seed=5,
                   collate_fn=collate_video)
    shares = [Loader(_Items(), 3, shuffle=True, drop_last=False, seed=5,
                     collate_fn=collate_video, shard=(i, count))
              for i in range(count)]
    for one, *parts in zip(whole, *shares):
        got = {k: np.concatenate([p[k] for p in parts]) for k in one}
        n = len(one["weight"])
        for k in one:
            np.testing.assert_array_equal(got[k][:n], one[k], err_msg=k)
        assert (got["weight"][n:] == 0).all()
        assert len(got["weight"]) % count == 0


def test_multiview_test_on_two_ranks_equals_one(tmp_path):
    """``engine/test.py:test`` with the clips of every batch shared by two
    ranks, the rows gathered for the ensemble: the 1-rank video scores."""
    root = str(tmp_path / "ssv2")
    make_ssv2_fixture(root)

    def cfg_of(out):
        cfg = worker.small_cfg()
        cfg.SSV2.DATA_ROOT = root
        cfg.TEST.BATCH_SIZE = 8
        cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
        cfg.TEST.NUM_SPATIAL_CROPS = 3
        cfg.TEST.SAVE_RESULTS_PATH = os.path.join(out, "results.pkl")
        cfg.DATA_LOADER.NUM_WORKERS = 0
        cfg.OUTPUT_DIR = out
        return assert_and_infer_cfg(cfg)

    from svit_tpu_torch.engine.test import test

    one, two = str(tmp_path / "one"), tmp_path / "two"
    os.makedirs(one)
    os.makedirs(two)
    test(cfg_of(one), device="cpu")
    _spawn("test", two, cfg_of(str(two)))
    with open(os.path.join(one, "results.pkl"), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(two, "results.pkl"), "rb") as f:
        got = pickle.load(f)
    np.testing.assert_array_equal(got["video_labels"], want["video_labels"])
    np.testing.assert_allclose(got["video_preds"], want["video_preds"],
                               rtol=0, atol=1e-6)


def _logged_losses(out):
    """The per-step losses of the master's ``json_stats`` lines (every
    step: ``LOG_PERIOD`` 1)."""
    import json

    with open(os.path.join(out, "stdout.log")) as f:
        stats = [json.loads(line.split("json_stats: ", 1)[1]) for line in f
                 if "json_stats: " in line]
    return [s["loss"] for s in stats if s["_type"] == "train_iter"]


def _adam_moments(blob, cfg):
    """A checkpoint's AdamW state by parameter name, with its lr."""
    from svit_tpu_torch.models.optimizer import construct_optimizer

    model, _ = build_model(cfg, device="cpu", train=True)
    tx, _ = construct_optimizer(cfg, model, 1)
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in tx.optimizer.param_groups
             for p in g["params"]]
    opt = blob["optimizer_state"]
    lr = float(opt["param_groups"][0]["lr"])
    return {order[int(i)]: st for i, st in opt["state"].items()}, lr


def test_trainer_epoch_at_model_2_with_remat_equals_one_process(tmp_path):
    """``engine/train.py:train`` through ``launch_job`` on two ranks at
    data 1 x model 2 with ``TPU.REMAT=True`` (the sharded MLPs inside
    recomputed blocks, their collectives run again in the backward) on
    ``tests/test_torch_trainer.py``'s tiny config, two epochs of one step
    (all 4 videos a step), against one process without remat.  Each
    epoch's checkpoint by the master (full tensors) against one process's:

    - the logged losses of both steps within 1e-6 relative;
    - the first moments (``exp_avg``: (1 - beta1) times the first step's
      clipped gradient, then a sum of both steps') at the gradient
      tolerance above;
    - the parameters within 1e-6 of their tensor's scale plus what the two
      runs' own updates imply: after the first step ``lr1`` times the
      difference of ``g / (|g| + eps)``, after the second the first step's
      difference plus ``lr2`` times the difference of Adam's update
      ``m_hat / (sqrt(v_hat) + eps)`` (the decay scales both alike)."""
    from svit_tpu_torch.engine.train import train
    from tests.test_torch_trainer import _tiny_cfg

    root = str(tmp_path / "ssv2")
    make_ssv2_fixture(root)
    one, two = str(tmp_path / "one"), tmp_path / "two"
    os.makedirs(two)
    kw = {"TRAIN.BATCH_SIZE": 4, "SOLVER.MAX_EPOCH": 2}
    one_cfg = _tiny_cfg(get_cfg, assert_and_infer_cfg, root, one, **kw)
    train(one_cfg, device="cpu")
    _spawn("trainer", two, _tiny_cfg(get_cfg, assert_and_infer_cfg, root,
                                     str(two), **kw, **{"TPU.REMAT": True}))

    want_losses = _logged_losses(one)
    assert len(want_losses) == 2
    np.testing.assert_allclose(_logged_losses(str(two)), want_losses,
                               rtol=1e-6, atol=0)

    b1, b2, eps = 0.9, 0.999, 1e-8
    start, _ = build_model(one_cfg, device="cpu", train=True)
    last = {k: torch.zeros_like(v, dtype=torch.float64)
            for k, v in start.named_parameters()}   # |p_got - p_want|
    for epoch in (1, 2):
        def blob(out):
            return torch.load(os.path.join(cu.checkpoint_path(out, epoch),
                                           cu.STATE_FILE), weights_only=False)

        got, want = blob(str(two)), blob(one)
        assert got["step"] == want["step"] == epoch
        assert got["epoch"] == want["epoch"] == epoch - 1
        (gm, _), (wm, lr) = (_adam_moments(b, one_cfg) for b in (got, want))
        assert set(gm) == set(wm) == set(last)
        floor = 1e-3 * max(float(st["exp_avg"].abs().max())
                           for st in wm.values())
        for k, w in wm.items():
            scale = max(float(w["exp_avg"].abs().max()), floor)
            np.testing.assert_allclose(gm[k]["exp_avg"].numpy(),
                                       w["exp_avg"].numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=k)

        def update(st):
            m, v = st["exp_avg"].double(), st["exp_avg_sq"].double()
            return ((m / (1 - b1 ** epoch))
                    / ((v / (1 - b2 ** epoch)).sqrt() + eps))

        for k, w in want["model_state"].items():
            g = got["model_state"][k]
            assert g.shape == w.shape, k
            if k not in wm:
                assert torch.equal(g, w), k
                continue
            bound = (1e-6 * float(w.abs().max()) + 1e-9 + last[k]
                     + lr * (update(gm[k]) - update(wm[k])).abs())
            diff = (g.double() - w.double()).abs()
            assert bool((diff <= bound).all()), k
            last[k] = diff
    moved = [k for k, v in start.state_dict().items()
             if not torch.equal(v, want["model_state"][k])]
    assert moved


def test_a_left_loader_lets_a_spawned_rank_exit():
    """A spawned process (each rank of ``launch_job`` is one) that leaves a
    process-pool loader's epoch before its end exits: the iterator's close
    shuts the pool down, where the process used to wait at its exit for
    workers that nothing told to end.  Run in a session of its own, killed
    whole if it hangs."""
    import signal
    import subprocess
    import sys

    code = ("import torch.multiprocessing as mp\n"
            "import tests.test_torch_parallel_worker as w\n"
            "mp.spawn(w.abandon_loader, nprocs=1)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=worker.REPO,
                            start_new_session=True)
    try:
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def test_one_rank_group_step_equals_no_group(tmp_path):
    """A process group of one rank (gloo here, NCCL on the card in
    ``chip_smoke.py`` phase 13) runs the step's collectives, which change
    nothing: the metrics, gradients and parameters equal the no-group
    step's bit for bit."""
    import torch.distributed as dist

    cfg = worker.small_cfg()
    video, image = worker.batches(cfg)[1]
    no_group = worker.train_step(cfg, meshlib.Mesh(1, 1), video, image)[:3]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        mesh = meshlib.build_mesh(data=1, model=1)
        assert mesh.data_group is dist.group.WORLD
        group = worker.train_step(cfg, mesh, video, image)[:3]
        # JAX's assert (``mesh.py:33-35``), and a mesh that leaves ranks out
        with pytest.raises(AssertionError, match="mesh 1x2 > 1 devices"):
            meshlib.build_mesh(data=1, model=2)
        with pytest.raises(ValueError, match="mesh 0x2"):
            meshlib.build_mesh(data=-1, model=2)
    finally:
        dist.destroy_process_group()
    assert group[0] == no_group[0]
    for got, want in zip(group[1:], no_group[1:]):
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_sigterm_is_agreed_at_log_boundaries_only(monkeypatch):
    """With one process the Trainer stops at the step after SIGTERM; with
    several the ranks gather the flag only at ``LOG_PERIOD`` boundaries
    (where the loop waits for the device anyway), and stop together if any
    rank saw it."""
    from svit_tpu_torch.engine import train as ttrain

    class Guard:
        fired = True

    gathers = []
    assert ttrain._stop_now(Guard, at_log=False)
    monkeypatch.setattr(ttrain.du, "get_world_size", lambda: 2)
    monkeypatch.setattr(ttrain.du, "all_gather_host",
                        lambda flag: gathers.append(flag) or [False, flag])
    assert not ttrain._stop_now(Guard, at_log=False)
    assert gathers == []
    assert ttrain._stop_now(Guard, at_log=True)
    Guard.fired = False
    assert not ttrain._stop_now(Guard, at_log=True)
    assert gathers == [True, False]
