"""The port's multi-view test engine against the JAX package's.

On the mini-SSv2 fixture (``tests/fixtures.py``), at the reduced size of
``tests/test_torch_model.py`` (the 16-block SViT-B schedule at 56 px, 4
frames, f32): both engines load one ``.pyth`` written from the port's
seeded weights and test 4 videos x 2 views x 3 crops at batch 8 (the last
batch padded).  The video-level scores (sums of 6 softmax rows) agree to
5e-5, the bound ``tests/test_torch_model.py`` holds the model to; the
labels and the final top-1/top-5 agree exactly.  The entry point
(``python -m svit_tpu_torch.engine.test``) refuses a typo'd key and, with
no card, raises.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from svit_tpu.config import assert_and_infer_cfg as jax_infer
from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu_torch.config import assert_and_infer_cfg, get_cfg
from svit_tpu_torch.engine import test as port_test
from svit_tpu_torch.models import build_model
from tests.fixtures import make_ssv2_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(get, infer, root, out, ckpt, workers):
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.NUM_GPUS = 0
    cfg.TRAIN.MIXED_PRECISION = False
    cfg.SSV2.DATA_ROOT = root
    cfg.TEST.BATCH_SIZE = 8
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.TEST.NUM_SPATIAL_CROPS = 3
    cfg.TEST.CHECKPOINT_FILE_PATH = ckpt
    cfg.TEST.SAVE_RESULTS_PATH = os.path.join(out, "results.pkl")
    cfg.DATA_LOADER.NUM_WORKERS = workers
    cfg.TPU.MESH_DATA = 1
    cfg.OUTPUT_DIR = out
    return infer(cfg)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ssv2"))
    make_ssv2_fixture(root)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "weights.pyth")
    cfg = _cfg(get_cfg, assert_and_infer_cfg, root, ".", "", 0)
    cfg.RNG_SEED = 7
    model, _ = build_model(cfg, device="cpu")
    torch.save({"model_state": model.state_dict()}, ckpt)
    return root, ckpt, tmp_path_factory


def test_port_test_engine_matches_jax(env):
    root, ckpt, tmp = env
    from svit_tpu.engine.test import test as jax_test

    out_j, out_t = str(tmp.mktemp("jax")), str(tmp.mktemp("port"))
    stats_j = jax_test(_cfg(jax_get_cfg, jax_infer, root, out_j, ckpt, 0))
    stats_t = port_test.test(
        _cfg(get_cfg, assert_and_infer_cfg, root, out_t, ckpt, 2),
        device="cpu")
    with open(os.path.join(out_j, "results.pkl"), "rb") as f:
        res_j = pickle.load(f)
    with open(os.path.join(out_t, "results.pkl"), "rb") as f:
        res_t = pickle.load(f)
    assert res_t["video_preds"].shape == (4, 174)
    np.testing.assert_array_equal(res_t["video_labels"], res_j["video_labels"])
    np.testing.assert_allclose(res_t["video_preds"], res_j["video_preds"],
                               atol=5e-5)
    # six softmax rows summed into each video slot
    np.testing.assert_allclose(res_t["video_preds"].sum(-1), 6.0, rtol=1e-5)
    assert stats_t == stats_j and "top1_acc" in stats_t


def test_entry_point_refuses_a_typo_and_needs_a_card(env, monkeypatch,
                                                     tmp_path):
    root, ckpt, _ = env
    cfg_file = os.path.join(REPO, "configs", "ssv2.yaml")
    with pytest.raises(KeyError):
        port_test.main(["--cfg", cfg_file, "TEST.BATCH_SIZ", "8"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_test.main(["--cfg", cfg_file, "SSV2.DATA_ROOT", root,
                        "TEST.CHECKPOINT_FILE_PATH", ckpt,
                        "OUTPUT_DIR", str(tmp_path)])


def test_checkpoint_paths_match_jax(tmp_path):
    """The names, the last checkpoint and the TEST > last > TRAIN priority
    of ``utils/checkpoint.py`` are the JAX package's."""
    from svit_tpu.utils import checkpoint as jax_cu
    from svit_tpu_torch.utils import checkpoint as cu

    job = str(tmp_path)
    for args in ((job, 3), (job, 3, 17), (job, 12)):
        assert cu.checkpoint_path(*args) == jax_cu.checkpoint_path(*args)
    assert cu.get_last_checkpoint(job) is None and not cu.has_checkpoint(job)
    for args in ((job, 1), (job, 2, 5), (job, 2)):
        os.makedirs(cu.checkpoint_path(*args))
    assert cu.get_last_checkpoint(job) == jax_cu.get_last_checkpoint(job) \
        == cu.checkpoint_path(job, 2, 5)
    assert cu.has_checkpoint(job)

    def cfgs(test, train, out):
        pair = []
        for get in (get_cfg, jax_get_cfg):
            cfg = get()
            cfg.TEST.CHECKPOINT_FILE_PATH = test
            cfg.TRAIN.CHECKPOINT_FILE_PATH = train
            cfg.OUTPUT_DIR = out
            pair.append(cfg)
        return pair

    empty = str(tmp_path / "empty")
    for test, train, out in (("t.pyth", "r.pyth", job), ("", "r.pyth", job),
                             ("", "r.pyth", empty), ("", "", empty)):
        ours, ref = cfgs(test, train, out)
        assert cu.load_test_checkpoint_path(ours) == \
            jax_cu.load_test_checkpoint_path(ref)


def test_load_params_any_is_strict_and_refuses_orbax(env, tmp_path):
    from svit_tpu_torch.utils import checkpoint as cu

    _, ckpt, _ = env
    cfg = _cfg(get_cfg, assert_and_infer_cfg, "", ".", "", 0)
    model, _ = build_model(cfg, device="cpu")
    cu.load_params_any(model, ckpt, cfg)
    state = torch.load(ckpt, weights_only=False)["model_state"]
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, state[k], atol=0, rtol=0)
    bad = str(tmp_path / "partial.pt")
    torch.save({k: v for k, v in list(state.items())[1:]}, bad)
    with pytest.raises(RuntimeError, match="Missing"):
        cu.load_params_any(model, bad, cfg)
    with pytest.raises(ValueError, match="Orbax"):
        cu.load_params_any(model, str(tmp_path), cfg)
