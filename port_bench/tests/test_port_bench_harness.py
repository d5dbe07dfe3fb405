"""The harness's own parts on the CPU: the files found by name, the seeded
traffic, the yardstick's arithmetic against hand counts and against the
program's FLOP model, the metric readers and the module guard.

    python -m pytest port_bench/tests
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench.core import cells, guard, trace, traffic, weights, yardstick
from port_bench.reference import svit

ROOT = cells.ROOT


def test_every_cell_metric_and_file_is_found_by_name():
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"], bench)
        assert cell.mix["kind"] in ("train", "test")
        assert cell.limits["numbers"]
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"]))
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        cfg, meta = cells.load_config(c["name"])
        assert meta["source"] and "deployment" in meta
        assert sorted(meta["reduced"]) == sorted(c["reduced"])


def test_a_new_metric_file_is_read_with_no_edit(tmp_path, monkeypatch):
    here = tmp_path / "port_bench"
    shutil.copytree(os.path.join(ROOT, "port_bench", "metrics"),
                    here / "metrics")
    (here / "metrics" / "new_thing.train.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx['x']\n")
    monkeypatch.setattr(cells, "HERE", str(here))
    assert cells.reader("new_thing.train")({"x": 3}) == 6.0


def test_the_configs_build_the_programs_parameters():
    from svit_tpu_torch.models.svit import SViT, SViTArch

    for name in ("svit_s16_224", "svit_b32_224"):
        cfg, _ = cells.load_config(name)
        arch = SViTArch.from_cfg(cells.program_cfg(cfg, 1))
        with torch.device("meta"):
            model = SViT(arch)
        have = {n: tuple(p.shape) for n, p in model.named_parameters()}
        specs = svit.param_specs(svit.arch_from_cfg(cfg))
        assert have == {n: s for n, s, _ in specs}


@pytest.mark.parametrize("name,frames", [("svit_s16_224", 16),
                                         ("svit_b32_224", 32)])
def test_the_frozen_flops_equal_the_programs(name, frames):
    from svit_tpu_torch.models.svit import SViTArch
    from svit_tpu_torch.utils import flops

    cfg, _ = cells.load_config(name)
    port = SViTArch.from_cfg(cells.program_cfg(cfg, 1))
    mine = svit.arch_from_cfg(cfg)
    assert mine.num_frames == frames
    for b, t in ((16, frames), (16, 1), (64, frames)):
        assert yardstick.forward_flops(mine, b, t) == \
            flops.forward_flops(port, b, t)
    assert yardstick.train_step_flops(mine, 16, 16) == \
        flops.train_step_flops(port, 16, 16)


def test_the_step_flops_match_the_published_counts():
    s16 = svit.arch_from_cfg(cells.load_config("svit_s16_224")[0])
    b32 = svit.arch_from_cfg(cells.load_config("svit_b32_224")[0])
    assert yardstick.forward_flops(s16, 1, 16) / 1e9 == pytest.approx(
        137.0, abs=0.1)
    assert yardstick.train_step_flops(s16, 16, 16) / 1e12 == \
        pytest.approx(10.60, abs=0.01)
    assert yardstick.forward_flops(b32, 1, 32) / 1e9 == pytest.approx(
        487.2, abs=0.1)
    assert yardstick.train_step_flops(b32, 16, 16) / 1e12 == \
        pytest.approx(34.16, abs=0.01)


def test_bounds_against_hand_counts():
    # a K1 product of 1024 x 768 by 768 x 2304 with LN: bf16 in and out,
    # f32 bias and LN; bytes win over 989 TFLOP/s
    op = yardstick._ln_linear("k", 1024, 768, 2304, ln=True)
    byts = 1024 * 768 * 2 + 2304 * 768 * 2 + 2304 * 4 + 1024 * 2304 * 2 \
        + 2 * 768 * 4
    assert op[1] == byts and op[2] == 2.0 * 1024 * 2304 * 768
    assert yardstick.bound_s([op]) == pytest.approx(
        max(byts / 3.35e12, op[2] / 989e12))
    # a depthwise 3x3x3 pool at stride 1 reads every position once
    B, T, H, W, C = 2, 8, 56, 56, 96
    p = yardstick._pool_ln("p", (B, T, H, W, C), (3, 3, 3), (1, 1, 1), 96)
    out = B * T * H * W * C
    assert p[1] == out * 2 + C * 27 * 4 + 2 * C * 4 + out * 2
    assert p[3] == out * (2.0 * 27 + 8)
    # at stride 8 the 7 windows of 3 touch 3 rows each, the first 2 (its
    # third lies in the padding)
    assert yardstick._touched(56, 3, 8) == 20


def test_step_ops_count_the_launches_of_a_step():
    s16 = svit.arch_from_cfg(cells.load_config("svit_s16_224")[0])
    ops = yardstick.train_step_ops(s16, 16, 16)
    count = {}
    for name, *_ in ops:
        count[name] = count.get(name, 0) + 1
    # the program's launches a step (PERF.md's kernel table): 96 K4 and
    # K2, 62 K5, 62 each of the pool backward's three, 6 K3 backward
    assert count["K4 attention"] == 96
    assert count["K2 pool_ln"] == 96
    assert count["K5 attention_bwd"] == 62
    assert count["K6 conv_dx"] == count["K7 conv_dk"] == 62
    assert count["K2 pool_conv (recompute)"] == 62
    assert count["K3 pool_max_bwd"] == 6
    assert count["K3 pool_max"] == 9


def _ctx(kind, units=4, window=2.0, fams=None, busy=1.5):
    summary = {"units": units, "window_s": window, "busy_s": busy,
               "families": fams if fams is not None else
               {"K1 ln_linear": 0.4, "K5 attention_bwd": 0.2,
                "elementwise": 0.8, "GEMM": 0.1}}
    return {"kind": kind, "chips": 1, "summary": summary,
            "flops_per_unit": 1e12, "bound_s_per_unit": 0.03,
            "peak_flops": 989e12}


def test_the_readers_against_hand_counts():
    ctx = _ctx("train")
    read = {m: cells.reader(m) for m in (
        "mfu.train", "glue_ms.train", "kernels_roofline.train",
        "idle_share.train", "mfu.test")}
    assert read["mfu.train"](ctx) == pytest.approx(
        100 * 4e12 / (2.0 * 989e12))
    assert read["glue_ms.train"](ctx) == pytest.approx(1e3 * 0.9 / 4)
    assert read["kernels_roofline.train"](ctx) == pytest.approx(
        100 * 0.03 / (0.6 / 4))
    assert read["idle_share.train"](ctx) == pytest.approx(25.0)
    # a reader with nothing to read returns nothing, never 0
    assert read["mfu.test"](ctx) is None
    assert read["glue_ms.train"](_ctx("train", fams={})) is None
    assert read["kernels_roofline.train"](
        _ctx("train", fams={"GEMM": 1.0})) is None


def test_the_trace_reduction():
    events = [("ln_linear_kernel<1>", True, False, 0, 100),
              ("void at::elementwise_kernel", True, False, 50, 200),
              ("Memcpy DtoD", True, True, 300, 400),
              ("aten::copy_", False, False, 200, 300)]
    s = trace.reduce(events, 4e-7, 2)
    assert s["busy_s"] == pytest.approx(300e-9)
    assert s["families"]["K1 ln_linear"] == pytest.approx(100e-9)
    assert s["families"]["memcpy/memset"] == pytest.approx(100e-9)
    assert s["idle_gaps"] == [["aten::copy_", pytest.approx(100e-9)]]
    assert trace.per_unit(s, "hand") == pytest.approx(50e-9)


def test_seeded_traffic_repeats():
    arch = svit.arch_from_cfg(cells.load_config("svit_s16_224")[0])
    from port_bench.tests.tiny import tiny_cell

    cell = tiny_cell("s16.train")
    arch = svit.arch_from_cfg(cell.cfg)
    a = traffic.train_pool(cell.mix, arch, 2**31 + 5, "cpu", torch.float32)
    b = traffic.train_pool(cell.mix, arch, 2**31 + 5, "cpu", torch.float32)
    c = traffic.train_pool(cell.mix, arch, 2**31 + 6, "cpu", torch.float32)
    for (va, ia), (vb, ib) in zip(a, b):
        for k in ("clips", "labels"):
            assert torch.equal(va[k], vb[k])
        for k in ("frames", "haog_bboxes", "contact_state"):
            assert torch.equal(ia[k], ib[k])
    assert not torch.equal(a[0][0]["clips"], c[0][0]["clips"])
    # rows all differ, so the check's three steps see distinct inputs
    assert not torch.equal(a[0][0]["clips"], a[1][0]["clips"])
    t = tiny_cell("s16.test")
    v1, l1 = traffic.test_pool(t.mix, arch, 9, "cpu")
    v2, l2 = traffic.test_pool(t.mix, arch, 9, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(v1, v2))
    assert (l1 == l2).all()


def test_seeded_weights_repeat_and_follow_their_rules():
    arch = svit.arch_from_cfg(cells.load_config("svit_s16_224")[0])
    specs = svit.param_specs(arch)
    a = weights.make_weights(specs, 2**31 + 3, "cpu")
    b = weights.make_weights(specs, 2**31 + 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["blocks.0.norm1.weight"].min()) == 1.0
    assert float(a["blocks.0.attn.qkv.bias"].abs().max()) == 0.0
    w = a["blocks.5.mlp.fc1.weight"]
    assert float(w.std()) == pytest.approx(w.shape[1] ** -0.5, rel=0.02)
    pool = a["blocks.0.attn.pool_q.weight"]
    assert float(pool.abs().max()) <= (3 / 27) ** 0.5


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden(["svit_tpu_torch.ops", "jaxtyping", "os"]) == []
    assert guard.forbidden(["svit_tpu.models", "jax.numpy"]) == [
        "jax", "svit_tpu"]
    assert guard.forbidden(["flax.linen", "jaxlib"]) == ["flax", "jaxlib"]


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from port_bench import run\n"
        "from port_bench.core import guard\n"
        "from port_bench.tests.tiny import tiny_cell\n"
        "for name in ('s16.train', 's16.test'):\n"
        "    run.measure(tiny_cell(name), 11, 0.2, name == 's16.test',\n"
        "                torch.device('cpu'))\n"
        "print('FORBIDDEN', guard.forbidden())\n"
        "print('READS', 'bench' in sys.modules)\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    assert "READS False" in out.stdout


def test_no_file_of_the_harness_names_the_jax_benchmark():
    here = os.path.join(ROOT, "port_bench")
    for dirpath, _, files in os.walk(here):
        if ".cache" in dirpath:
            continue
        for f in files:
            if not f.endswith(".py") or f.startswith("test_port_bench"):
                continue
            text = open(os.path.join(dirpath, f)).read()
            for word in ("import jax", "from jax", "import svit_tpu\n",
                         "from svit_tpu ", "from svit_tpu.", "bench.py",
                         "BENCH_r", "BASELINE.json"):
                assert word not in text, (f, word)


def test_the_benchmark_file_keeps_the_contracts_limits():
    bench = cells.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    import re

    name_re = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit_re = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name_re.match(m["name"]) and unit_re.match(m["unit"])
    for m in bench["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
    for w in bench["workloads"]:
        assert name_re.match(w["name"]) and len(w["why"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024
