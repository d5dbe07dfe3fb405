"""The port's profiling tools against the JAX package's, on the CPU:

- ``profile_model``'s variants: the same architecture as JAX
  ``tools/profile_model.py:build(edit)`` at full size for every variant,
  and for ``maxpool`` and ``prefix:2`` at conftest's reduced size (56 px,
  4 frames, f32; ``maxpool`` cut to 3 blocks) the same forward outputs as
  JAX's on the port's weights carried across by the converter (5e-5 of
  the scale, as the model tests);
  ``time_forward`` runs the captured forward (eager on the CPU);
- ``benchmark_data_loading``: the same record ``_type``s, epochs, iters
  and clip counts as JAX ``tools/benchmark.py`` on one synthetic JPEG tree
  (``tests/fixtures.py``), two epochs;
- ``engine_steady_state``: the JAX tool's JSON keys (read from its source)
  from two steps of the real ``train_epoch`` at a tiny size.
"""

import ast
import dataclasses
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu_torch.tools import benchmark as tbench
from svit_tpu_torch.tools import engine_steady_state as tess
from svit_tpu_torch.tools import profile_model as tpm
from svit_tpu_torch.utils import converter
from tests.fixtures import make_ssv2_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small(cfg):
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.TRAIN.MIXED_PRECISION = False


def _edits():
    return {"full": None, "maxpool": tpm.maxpool,
            **{f"prefix:{k}": tpm.prefix(k) for k in tpm.PREFIXES}}


def _arch(arch):
    return {k: v for k, v in dataclasses.asdict(arch).items()
            if k != "remat"}


def test_variants_build_jax_s_architectures():
    from svit_tpu.models.svit import SViTArch as JaxArch
    from svit_tpu_torch.config import assert_and_infer_cfg, get_cfg
    from svit_tpu_torch.models.svit import SViTArch

    jpm = _jax_tool("profile_model")
    tags = [t for t, _, _ in tpm.variants()]
    assert tags == ["full", "no_kernels", "maxpool"] + [
        f"prefix:{k}" for k in (1, 2, 3, 8, 14, 16)]
    for tag, edit in _edits().items():
        _, jarch, _ = jpm.build(edit)
        cfg = get_cfg()
        cfg.merge_from_file(tpm.CFG)
        if edit:
            edit(cfg)
        arch = SViTArch.from_cfg(assert_and_infer_cfg(cfg))
        assert isinstance(jarch, JaxArch)
        assert _arch(arch) == _arch(jarch), tag


@pytest.mark.parametrize("tag", ["maxpool", "prefix:2"])
def test_variant_forward_matches_jax(tag):
    jpm = _jax_tool("profile_model")
    edit = _edits()[tag]

    def small_edit(cfg):
        _small(cfg)
        if tag == "maxpool":      # the mode at 3 blocks: JAX compiles fast
            tpm.prefix(3)(cfg)
        edit(cfg)

    model, arch, cfg = tpm.build(small_edit, device="cpu")
    jm, jarch, _ = jpm.build(small_edit, dtype=jnp.float32, use_pallas=False)
    assert _arch(arch) == _arch(jarch)
    assert model.dtype == torch.float32 and arch.depth == (
        2 if tag == "prefix:2" else 3) and arch.mode == (
        "max" if tag == "maxpool" else "conv")
    x = np.random.RandomState(0).randn(2, 4, 56, 56, 3).astype(np.float32)
    params = converter.params_to_jax(model.state_dict())
    _, want = jax.jit(lambda p, x: jm.apply(p, x, deterministic=True))(
        params, jnp.asarray(x))
    with torch.inference_mode():
        _, got = model(torch.from_numpy(x))
    for k in ("raw_logits", "pred_bboxes", "obj_desc"):
        ref = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(
            got[k].numpy(), ref, rtol=5e-5,
            atol=5e-5 * max(1.0, float(np.abs(ref).max())), err_msg=k)
    ms = tpm.time_forward(model, cfg, 1, 1, tag, torch.device("cpu"),
                          verbose=False)
    assert ms > 0


def _loader_cfg(get, root, out):
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.SSV2.DATA_ROOT = root
    cfg.OUTPUT_DIR = out
    cfg.MODEL.NUM_CLASSES = 5
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.TRAIN_JITTER_SCALES = [36, 44]
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.IMAGE_TRAIN.BATCH_SIZE = 2
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.BENCHMARK.NUM_EPOCHS = 2
    cfg.BENCHMARK.LOG_PERIOD = 1
    return cfg


def test_benchmark_data_loading_matches_jax(tmp_path, monkeypatch):
    from svit_tpu.config import get_cfg as jax_get_cfg
    from svit_tpu.utils import logging as jax_logging
    from svit_tpu_torch.config import get_cfg

    root = str(tmp_path / "ssv2")
    make_ssv2_fixture(root)
    jbench = _jax_tool("benchmark")
    theirs = []
    monkeypatch.setattr(jax_logging, "log_json_stats", theirs.append)
    jbench.benchmark_data_loading(
        _loader_cfg(jax_get_cfg, root, str(tmp_path / "jax")))
    mine = tbench.benchmark_data_loading(
        _loader_cfg(get_cfg, root, str(tmp_path / "port")))

    def shape(records):
        return [(r["_type"], r["epoch"], r.get("iter"), sorted(r))
                for r in records]

    def clips(records):
        return [round(r["clips_per_sec"] * r["seconds"])
                for r in records if r["_type"] == "benchmark_epoch"]

    assert shape(mine) == shape(theirs)
    assert clips(mine) == clips(theirs) == [4, 4]
    assert {r["_type"] for r in mine} == {"benchmark_iter",
                                          "benchmark_epoch"}


def _jax_engine_keys():
    """The keys of the JSON object ``tools/engine_steady_state.py`` writes
    (its ``out = {...}``)."""
    src = open(os.path.join(REPO, "tools", "engine_steady_state.py")).read()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "out"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no out = {...} in the JAX tool")


def test_engine_steady_state_reports_the_jax_tool_s_keys():
    tiny = ["DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
            "DATA.NUM_FRAMES", "2", "MVIT.DEPTH", "2",
            "MVIT.DIM_MUL", "[[1, 2.0]]", "MVIT.HEAD_MUL", "[[1, 2.0]]",
            "MVIT.POOL_Q_STRIDE", "[[0, 1, 1, 1], [1, 1, 2, 2]]",
            "TRAIN.MIXED_PRECISION", "False", "SVIT.CONSISTENCY_LOSS", "l1"]
    out = tess.measure(steps=2, warmup=1, device="cpu", opts=tiny,
                       verbose=False)
    # the JAX tool's keys but its comparison with a bench's step time, an
    # environment variable that nothing sets (the benchmark measures that)
    assert set(out) == _jax_engine_keys() - {"bench_train_step_ms",
                                             "overhead_vs_bench_pct"}
    assert out["steps"] == 2 and out["log_period"] == 10
    assert math.isfinite(out["engine_step_ms"]) and out["engine_step_ms"] > 0
    assert out["video_clips_per_sec_chip"] == pytest.approx(
        8 / out["engine_step_ms"] * 1e3)
