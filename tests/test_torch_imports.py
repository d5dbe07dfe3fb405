"""The PyTorch port imports without JAX and without the JAX package, and
its entry points refuse to run on the CPU unless asked to."""

import collections
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A meta-path finder that refuses jax, flax, optax, orbax and the JAX
# package (``svit_tpu`` or ``svit_tpu.*``, not ``svit_tpu_torch``).
_BLOCKER = r'''
import importlib.abc, sys

BLOCKED_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax")

def blocked(name):
    return (name.split(".")[0] in BLOCKED_ROOTS or name == "svit_tpu"
            or name.startswith("svit_tpu."))

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
'''

_IMPORT_ALL = _BLOCKER + r'''
import importlib, pkgutil
try:
    import svit_tpu
    raise SystemExit("the blocker let svit_tpu through")
except ImportError:
    pass
import svit_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    svit_tpu_torch.__path__, "svit_tpu_torch."))
for n in names:
    importlib.import_module(n)
import attention_probe
import bias_probe
import chip_smoke
import k1_probe
import parallel_probe
import pool_probe
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
print(len(names))
'''


def test_port_imports_with_jax_and_svit_tpu_blocked():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    # every subpackage and module of the port: config (4), data (6),
    # engine (6), models (9), native (2), ops (9), serving (3), utils (5)
    assert int(r.stdout.strip().splitlines()[-1]) >= 44


_IMPORT_ONE = _BLOCKER + r'''
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
'''


@pytest.mark.parametrize("module", [
    "svit_tpu_torch.engine.steps", "svit_tpu_torch.models.losses",
    "svit_tpu_torch.models.optimizer", "svit_tpu_torch.ops.box_ops",
    "svit_tpu_torch.utils.lr_policy", "svit_tpu_torch.engine.metrics",
    "svit_tpu_torch.engine.meters", "svit_tpu_torch.engine.ava_eval",
    "svit_tpu_torch.engine.test", "svit_tpu_torch.data.utils",
    "svit_tpu_torch.data.transform", "svit_tpu_torch.data.build",
    "svit_tpu_torch.data.ssv2", "svit_tpu_torch.data.loader",
    "svit_tpu_torch.native.jpeg", "svit_tpu_torch.utils.checkpoint",
    "svit_tpu_torch.data.random_erasing", "svit_tpu_torch.data.rand_augment",
    "svit_tpu_torch.data.mixup", "svit_tpu_torch.data.ssv2_frames",
    "svit_tpu_torch.data.doh_frames", "svit_tpu_torch.data.multi_images",
    "svit_tpu_torch.engine.multigrid", "svit_tpu_torch.engine.train",
    "svit_tpu_torch.utils.misc", "svit_tpu_torch.utils.converter",
    "svit_tpu_torch.engine.graphs", "svit_tpu_torch.data.device_aug",
    "svit_tpu_torch.utils.flops", "svit_tpu_torch.serving.server",
    # the periphery, one process a subpackage
    "svit_tpu_torch.native.video svit_tpu_torch.native.camera",
    "svit_tpu_torch.data.decoder svit_tpu_torch.data.kinetics",
    "svit_tpu_torch.visualization.gradcam svit_tpu_torch.visualization.draw "
    "svit_tpu_torch.visualization.demo "
    "svit_tpu_torch.visualization.tensorboard_vis "
    "svit_tpu_torch.visualization.run",
    "svit_tpu_torch.tools.run_net svit_tpu_torch.tools.train_net "
    "svit_tpu_torch.tools.test_net svit_tpu_torch.tools.demo_net "
    "svit_tpu_torch.tools.visualization svit_tpu_torch.tools.serve "
    "svit_tpu_torch.tools.convert_checkpoint",
    # the parallel package and the learning proof
    "svit_tpu_torch.parallel.dist svit_tpu_torch.parallel.mesh "
    "svit_tpu_torch.parallel.tensor svit_tpu_torch.tools.overfit_hw",
    # the measuring tools
    "svit_tpu_torch.tools.common", "svit_tpu_torch.tools.check_kernels_hw",
    "svit_tpu_torch.tools.trace_forward", "svit_tpu_torch.tools.trace_attrib",
    "svit_tpu_torch.tools.profile_model",
    "svit_tpu_torch.tools.engine_steady_state",
    "svit_tpu_torch.tools.benchmark"])
def test_train_modules_import_with_jax_and_svit_tpu_blocked(module):
    r = subprocess.run([sys.executable, "-c", _IMPORT_ONE, *module.split()],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_build_model_without_device_raises_when_cuda_absent(monkeypatch):
    from svit_tpu_torch.config import get_cfg
    from svit_tpu_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)


# the measuring tools, each pointed at an input that does not exist
TOOLS = ("check_kernels_hw", "trace_forward", "profile_model",
         "engine_steady_state", "trace_attrib", "benchmark")


def _tool(name):
    import importlib

    tool = importlib.import_module(f"svit_tpu_torch.tools.{name}")

    def run(cfg, device=None):
        absent = os.path.join(cfg.OUTPUT_DIR, "absent")
        if name == "trace_attrib":
            argv = [absent + ".json"]
        elif name == "benchmark":   # the config's data root is absent
            argv = ["--cfg", os.path.join(cfg.OUTPUT_DIR, "cfg.yaml")]
            with open(argv[1], "w") as f:
                f.write(cfg.dump())
        else:
            argv = ["--cfg", absent + ".yaml"]
        tool.main(argv, device=device)
    return run


def _entry(name):
    """An entry point that takes a config (and ``device``)."""
    if name in TOOLS:
        return _tool(name)
    if name == "demo":
        from svit_tpu_torch.visualization.demo import demo
        return demo
    if name == "visualize":
        from svit_tpu_torch.visualization.run import visualize
        return visualize
    from svit_tpu_torch.tools import run_net

    def run(cfg, device=None):
        path = os.path.join(cfg.OUTPUT_DIR, "cfg.yaml")
        with open(path, "w") as f:
            f.write(cfg.dump())
        run_net.main(["--cfg", path, "TRAIN.ENABLE", "False", "TEST.ENABLE",
                      "True"], device=device)
    return run


@pytest.mark.parametrize("name", ["demo", "visualize", "run_net", *TOOLS])
def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path, name):
    """Without a card the entry points raise before any work; given
    ``device="cpu"`` they get as far as their input (none exists here)."""
    from svit_tpu_torch.config import get_cfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.SSV2.DATA_ROOT = str(tmp_path / "absent")
    cfg.DEMO.INPUT_VIDEO = str(tmp_path / "absent")
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.NUM_FRAMES = 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry(name)(cfg)
    with pytest.raises((AssertionError, FileNotFoundError)):
        _entry(name)(cfg, device="cpu")


def test_chip_smoke_exits_nonzero_without_cuda():
    """Without a card the smoke run fails and prints no result line."""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("mode", ["--sweep", "--trace"])
def test_k1_probe_exits_nonzero_without_cuda(mode):
    r = subprocess.run([sys.executable, "k1_probe.py", mode], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 2, r.stdout + r.stderr
    assert "no CUDA device" in r.stderr


def test_bias_probe_exits_nonzero_without_cuda():
    r = subprocess.run([sys.executable, "bias_probe.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 2, r.stdout + r.stderr
    assert "no CUDA device" in r.stderr


def test_attention_probe_exits_nonzero_without_cuda():
    r = subprocess.run([sys.executable, "attention_probe.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 2, r.stdout + r.stderr
    assert "no CUDA device" in r.stderr


def test_pool_probe_lists_the_step_s_k6_calls():
    """pool_probe.py's rows (imported with JAX blocked above) hold every
    K6 call shape of the train step's two backward passes, at strides 1,
    2, 4 and 8, each with a plan: 2 x 32 pools (the step launches 62 of
    them: the last block's q pool takes no gradient); its WIDE rows plan on
    the general instance."""
    import pool_probe
    from svit_tpu_torch.ops import pool as tp

    rows = {k: v for k, v in pool_probe.calls().items()
            if k[0] == "pool_conv_dx"}
    assert sum(n for _, n in rows.values()) == 64
    assert {k[3][1] for k in rows} == {1, 2, 4, 8}
    for kind, shape, kernel, stride, hd in rows:
        plan = tp.pool_plan(shape, kernel, stride, "dx")
        assert plan.route == ("tuned" if stride == (1, 1, 1) else "gen")
    routes = collections.Counter(
        tp.pool_plan(shape, kernel, stride, pool_probe.PLAN_KIND[kind],
                     head_dim=hd if kind == "pool_ln" else None).route
        for kind, shape, kernel, stride, hd in pool_probe.wide_calls())
    assert routes["gen"] >= 20, routes


@pytest.mark.parametrize("args", [[], ["--sweep"], ["--no-math"]])
def test_pool_probe_exits_nonzero_without_cuda(args):
    r = subprocess.run([sys.executable, "pool_probe.py", *args], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 2, r.stdout + r.stderr
    assert "no CUDA device" in r.stderr
