"""The plain reference against the program's CPU path at a tiny size, and
the check against broken runs.

The program here runs its plain twins in f32 on the CPU; the reference is
written apart from it.  Their readings agree to rounding, so every number
the check compares reads far under its limit; a run whose timed path is
broken underneath (its state left unchanged, half of each batch left out,
an answer altered where it is produced) reads over it.

    python -m pytest port_bench/tests
"""

import pytest
import torch

from port_bench import run
from port_bench.core import check, weights
from port_bench.reference import step as ref_step
from port_bench.reference import svit
from port_bench.tests.tiny import tiny_cell

SEED = 2**31 + 11
CPU = torch.device("cpu")


def _measure(name, **kw):
    return run.measure(tiny_cell(name), SEED, 0.3, False, CPU, **kw)


@pytest.fixture(scope="module")
def sound_train():
    return _measure("s16.train")


def test_a_sound_train_run_is_correct(sound_train):
    result, rows = sound_train
    assert result["correct"]
    for name, value, limit in rows:
        assert value < 1e-3 * limit, (name, value, limit)
    assert list(result)[-1] == "checked"
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    m = result["metrics"]
    assert set(m) == {"train_clips_per_s", "setup_s"}
    assert all(v["value"] > 0 and v["unit"] for v in m.values())


def test_the_reference_step_equals_the_programs_plain_step():
    """One f32 step of the program's own step function, eager, against the
    reference: the loss, the global norm, every gradient and every updated
    parameter."""
    from svit_tpu_torch.engine import steps
    from svit_tpu_torch.engine.train import step_seed
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.models.losses import get_loss_func
    from svit_tpu_torch.models.optimizer import construct_optimizer

    from port_bench.core import cells, traffic
    from port_bench.core.train_cell import load_weights

    cell = tiny_cell("s16.train")
    cfg = cells.program_cfg(cell.cfg, SEED)
    arch = svit.arch_from_cfg(cell.cfg)
    specs = svit.param_specs(arch)
    model, _ = build_model(cfg, device="cpu", train=True)
    load_weights(model, specs, SEED, CPU)
    tx, _ = construct_optimizer(cfg, model, 2682)
    state = steps.create_train_state(model, tx)
    step = steps.make_train_step(model, get_loss_func(cfg), tx, 7 / 8,
                                 1 / 8, True, True)
    video, image = traffic.train_pool(cell.mix, arch, SEED, CPU,
                                      torch.float32)[0]
    video = dict(video, weight=torch.ones(2))
    image = dict(image, weight=torch.ones(2))
    W = weights.make_weights(specs, SEED, CPU)
    ref = ref_step.TrainReference(cells.with_seed(cell.cfg, SEED), W, 2682,
                                  chunk=1, frames_chunk=3)
    gen = torch.Generator().manual_seed(step_seed(SEED, 0))
    state, m = step(state, video, image, gen)
    r = ref.step(video, image)
    assert float(m["loss"]) == pytest.approx(r["loss"], rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(r["norm"], rel=1e-5)
    # leaves with a gradient nought to rounding move by round-off alone
    keep = set(check.kept_leaves(r["grads"]))
    for n, p in model.named_parameters():
        if n not in keep:
            continue
        g = tx.optimizer.state[p]["exp_avg"] / 0.1
        scale = max(float(r["grads"][n].norm()), 1e-3)
        assert float((g - r["grads"][n]).norm()) <= 1e-4 * scale, n
        change = max(float((ref.P[n] - W[n]).norm()), 1e-9)
        assert float((p - ref.P[n]).norm()) <= 1e-3 * change, n


def test_the_reference_scores_equal_the_programs_test_step():
    from svit_tpu_torch.engine import steps
    from svit_tpu_torch.models import build_model

    from port_bench.core import cells, traffic
    from port_bench.core.train_cell import load_weights

    cell = tiny_cell("s16.test")
    cfg = cells.program_cfg(cell.cfg, SEED)
    arch = svit.arch_from_cfg(cell.cfg)
    specs = svit.param_specs(arch)
    model, _ = build_model(cfg, device="cpu")
    load_weights(model, specs, SEED, CPU)
    views, _ = traffic.test_pool(cell.mix, arch, SEED, CPU)
    prog = steps.make_test_step(model)({"clips": views[0]})
    ref = ref_step.test_scores(cells.with_seed(cell.cfg, SEED),
                               weights.make_weights(specs, SEED, CPU),
                               views[0])
    assert check.score_gap(prog, ref) < 1e-4


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from svit_tpu_torch.models import optimizer

    def unchanged(self, params, step=None):
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return self.global_norm(params)

    monkeypatch.setattr(optimizer.Transform, "apply", unchanged)
    result, rows = _measure("s16.train")
    assert not result["correct"]
    got = {n: v for n, v, _ in rows}
    assert got["update_gap"] == pytest.approx(1.0)


def test_a_step_on_half_of_each_batch_is_not_correct(monkeypatch):
    from svit_tpu_torch.engine import steps

    make = steps.make_packed_train_step

    def half_step(*args, **kwargs):
        fn, names = make(*args, **kwargs)
        inner = fn.device_step

        def device_step(state, video, image, generator):
            def cut(b):
                return {k: v[: v.shape[0] // 2] for k, v in b.items()}
            return inner(state, cut(video), cut(image), generator)

        return steps._counted(device_step), names

    monkeypatch.setattr(steps, "make_packed_train_step", half_step)
    result, _ = _measure("s16.train")
    assert not result["correct"]


def test_an_altered_answer_is_not_correct(monkeypatch):
    from svit_tpu_torch.engine import steps

    make = steps.make_test_step

    def altered(model):
        fn = make(model)

        def test_step(batch):
            s = fn(batch).clone()
            s[:, [0, 1]] = s[:, [1, 0]]
            return s

        return test_step

    monkeypatch.setattr(steps, "make_test_step", altered)
    result, _ = _measure("s16.test")
    assert not result["correct"]


def test_a_sound_test_run_is_correct():
    result, rows = _measure("s16.test")
    assert result["correct"]
    assert set(result["metrics"]) == {"test_views_per_s", "setup_s"}
    assert all(v < 1e-3 * lim for _, v, lim in rows)


def test_the_backward_control_keeps_the_forward():
    """``fp8_bwd``: the f32 product's value, the fp8 product's gradient."""
    g = torch.Generator().manual_seed(SEED)
    a, b = (torch.randn(8, 16, generator=g) for _ in range(2))

    def run(prec):
        x, w = a.clone().requires_grad_(), b.clone().requires_grad_()
        y = svit.linear(x, w, None, prec)
        y.backward(torch.linspace(-1.0, 1.0, y.numel()).view_as(y))
        return y.detach(), x.grad, w.grad

    y32, _, gw32 = run("f32")
    y8, gx8, gw8 = run("fp8")
    yb, gxb, gwb = run("fp8_bwd")
    assert torch.equal(yb, y32) and not torch.equal(y8, y32)
    assert torch.equal(gxb, gx8) and torch.equal(gwb, gw8)
    assert not torch.equal(gwb, gw32)


@pytest.mark.cuda
def test_the_fp8_control_fails_the_check_on_the_card():
    """The control on the card: the reference with fp8 products in the
    program's place, against the f32 reference, at the tiny size in bf16
    inputs; it must read over the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from port_bench.calibrate import test_controls, train_controls

    dev = torch.device("cuda")
    got = train_controls(tiny_cell("s16.train"), SEED, dev)
    cell = tiny_cell("s16.train")
    ok, _ = check.judge(got["control_fp8"], cell.limits)
    assert not ok
    got = test_controls(tiny_cell("s16.test"), SEED, dev)
    ok, _ = check.judge(got["control_fp8"], tiny_cell("s16.test").limits)
    assert not ok
