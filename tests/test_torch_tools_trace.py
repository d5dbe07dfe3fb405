"""The port's trace tools (``svit_tpu_torch/tools/trace_attrib.py``,
``trace_forward.py``) on the CPU.

- ``trace_attrib`` on a hand-built Chrome trace in the event form that
  torch 2.11's profiler exports on the card (``cpu_op`` and
  ``user_annotation`` ranges, ``cuda_runtime`` launches, ``kernel`` and
  ``gpu_memcpy`` events with a ``correlation``, ``ac2g`` flows): a forward
  op inside a module scope, a backward node linked to it by sequence
  number (with a range of the backward's own inside), a graph replay's
  kernels, a copy linked only by its flow and a kernel whose launch is
  missing.  The family, owner and unowned sums are exact (the durations
  are whole microseconds).
- A trace without device events, or without links, raises.
- The program's owner ranges (``utils/tracing.py``) on a CPU profile of
  the tiny port model's train step (conftest's 56 px, 4 frames): every
  block's owners are named, no module holds a hook, and kernels stood in
  for the train step's aten ops map through the profiler's fwdbwd flows
  to the owner that ran their forward.
"""

import gzip
import json

import numpy as np
import pytest
import torch

from svit_tpu_torch.tools import common
from svit_tpu_torch.tools import trace_attrib as ta
from svit_tpu_torch.tools import trace_forward as tf

TINY = ["DATA.TRAIN_CROP_SIZE", "56", "DATA.TEST_CROP_SIZE", "56",
        "DATA.NUM_FRAMES", "4", "MVIT.DEPTH", "3",
        "MVIT.DIM_MUL", "[[1, 2.0]]", "MVIT.HEAD_MUL", "[[1, 2.0]]",
        "MVIT.POOL_Q_STRIDE", "[[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1]]",
        "TRAIN.MIXED_PRECISION", "False"]
HOST, MAIN, BWD, DEV, STREAM = 1234, 1234, 1300, 0, 7
BWD_RANGE = "svit::rel_pos_bias_bwd"    # a range inside a backward node


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(cat, name, tid, ts, dur, pid=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _launch(tid, ts, corr, name="cudaLaunchKernel"):
    return [_x("cuda_runtime", name, tid, ts, 2, correlation=corr,
               cbid=211),
            {"ph": "s", "id": corr, "pid": HOST, "tid": tid, "ts": ts,
             "cat": "ac2g", "name": "ac2g"}]


def _kernel(name, ts, dur, corr=None, cat="kernel", flow=True):
    args = {"device": DEV, "stream": STREAM}
    if corr is not None:
        args["correlation"] = corr
    out = [_x(cat, name, STREAM, ts, dur, pid=DEV, **args)]
    if flow:
        out.append({"ph": "f", "id": corr, "pid": DEV, "tid": STREAM,
                    "ts": ts, "cat": "ac2g", "name": "ac2g", "bp": "e"})
    return out


def _hand_trace():
    ev = [{"ph": "M", "name": "process_name", "pid": DEV,
           "args": {"name": "GPU 0"}}]
    # forward, on the main thread, inside a module scope
    ev.append(_x("user_annotation", "module::blocks.0.attn", MAIN, 0, 100))
    ev.append(_x("cpu_op", "aten::mm", MAIN, 10, 20,
                 **{"Sequence number": 5, "Fwd thread id": 0}))
    ev += _launch(MAIN, 15, 11)
    ev += _kernel("nvjet_tst_64x8_64x16_4x1_v_bz_TNT", 1000, 30, 11)
    ev.append(_x("cpu_op", "_AttentionFn", MAIN, 40, 15,
                 **{"Sequence number": 6, "Fwd thread id": 0}))
    ev += _launch(MAIN, 45, 12)
    ev += _kernel("void attn_fwd_kernel<96, 3>(CUtensorMap, FwdParams)",
                  1040, 50, 12)
    # a copy whose event lacks its correlation: linked by its flow
    ev.append(_x("cpu_op", "aten::copy_", MAIN, 60, 10))
    ev += _launch(MAIN, 62, 16, "cudaMemcpyAsync")
    ev += _kernel("Memcpy DtoD (Device -> Device)", 1100, 8,
                  cat="gpu_memcpy", flow=False)
    ev.append({"ph": "f", "id": 16, "pid": DEV, "tid": STREAM, "ts": 1100,
               "cat": "ac2g", "name": "ac2g", "bp": "e"})
    # the backward, on autograd's thread: the node of sequence number 6
    ev.append(_x("cpu_op", ta.NODE + "_AttentionFnBackward", BWD, 500, 50,
                 **{"Sequence number": 6, "Fwd thread id": 1}))
    ev.append(_x("cpu_op", "_AttentionFnBackward", BWD, 501, 45,
                 **{"Sequence number": 6, "Fwd thread id": 1}))
    ev.append(_x("user_annotation", BWD_RANGE, BWD, 505, 20))
    ev.append(_x("cpu_op", "aten::bmm", BWD, 506, 10))
    ev += _launch(BWD, 507, 13)
    ev += _kernel("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 1200, 20, 13)
    ev += _launch(BWD, 530, 14)
    ev += _kernel("void attn_bwd_q_kernel<96, 3>(CUtensorMap, BwdParams)",
                  1230, 60, 14)
    # a graph replay: one launch, no op around it
    ev += _launch(MAIN, 800, 15, "cudaGraphLaunch")
    ev += _kernel("void ln_linear_kernel<1>(CUtensorMap, CUtensorMap)",
                  1300, 40, 15)
    ev += _kernel("void at::native::vectorized_elementwise_kernel<4, "
                  "at::native::CUDAFunctor_add<float>>(int, ...)", 1340, 10,
                  15)
    # a kernel whose launch the trace lost: no runtime event, no flow
    ev += _kernel("void at::native::reduce_kernel<512, 1>(...)", 1400, 5,
                  99, flow=False)
    # the device lane's copy of a user annotation: not device time
    ev.append(_x("gpu_user_annotation", "module::blocks.0.attn", STREAM,
                 1000, 400, pid=DEV))
    return ev


def test_trace_attrib_families_owners_and_unowned():
    tr = ta.Trace(_hand_trace())
    s = ta.summarize(tr, iters=2, top=40)
    ms = 1e-3 / 2                     # us -> ms per iteration
    total = 30 + 50 + 8 + 20 + 60 + 40 + 10 + 5
    assert s["device_ms"] == pytest.approx(total * ms)
    fam = {f: (v, n) for f, v, n in s["families"]}
    want = {"GEMM": (50, 2), "K4 attention": (50, 1),
            "K5 attention_bwd": (60, 1), "K1 ln_linear": (40, 1),
            "elementwise": (10, 1), "reduction": (5, 1),
            "memcpy/memset": (8, 1)}
    assert set(fam) == set(want)
    for f, (us, n) in want.items():
        assert fam[f] == (pytest.approx(us * ms), n / 2), f
    own = {o: (v, n) for o, v, n in s["owners"]}
    want = {"blocks.0.attn": (30 + 50 + 8, 3),
            "blocks.0.attn" + ta.BACKWARD: (20 + 60, 2),
            ta.GRAPH: (50, 2), ta.UNOWNED: (5, 1)}
    assert set(own) == set(want)
    for o, (us, n) in want.items():
        assert own[o] == (pytest.approx(us * ms), n / 2), o
    assert s["owner_families"]["blocks.0.attn"] == {
        "K4 attention": pytest.approx(50 * ms), "GEMM": pytest.approx(30 * ms),
        "memcpy/memset": pytest.approx(8 * ms)}
    assert ta.glue_ms(s, "blocks.0.attn") == pytest.approx(38 * ms)
    assert ta.glue_ms(s, "blocks.0.attn" + ta.BACKWARD) == \
        pytest.approx(20 * ms)
    assert s["unowned_ms"] == pytest.approx(5 * ms)
    assert s["unowned_share"] == pytest.approx(5 / total)
    assert s["graph_replay_share"] == pytest.approx(50 / total)
    assert set(ta.hand_written(s)) == {"K1 ln_linear", "K4 attention",
                                       "K5 attention_bwd"}
    # the walks chip_smoke.py takes: launching op, anchor, tagged ranges
    by_name = {k.name: k for k in tr.kernels}
    bwd_gemm = by_name["sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n"]
    assert bwd_gemm.op.name == "aten::bmm"
    assert ta.anchor(bwd_gemm.op).name.startswith(ta.NODE)
    assert ta.within(bwd_gemm.op, (BWD_RANGE,))
    fwd_gemm = by_name["nvjet_tst_64x8_64x16_4x1_v_bz_TNT"]
    assert ta.anchor(fwd_gemm.op).name == "module::blocks.0.attn"
    assert not ta.within(fwd_gemm.op, (BWD_RANGE,))
    assert by_name["void ln_linear_kernel<1>(CUtensorMap, CUtensorMap)"] \
        .op is None


def test_trace_attrib_main_reads_a_file(tmp_path, capsys):
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": _hand_trace()}, f)
    out = tmp_path / "report.json"
    s = ta.main([str(tmp_path), "--by-owner", "--ops", "--iters", "2",
                 "--out", str(out)], device="cpu")
    printed = capsys.readouterr().out
    assert "by owner" in printed and "graph replay" in printed
    assert json.loads(out.read_text())["device_ms"] == \
        pytest.approx(s["device_ms"])
    gemm = ta.summarize(ta.Trace(ta.load(str(path))), match="gemm|nvjet")
    assert gemm["device_ms"] == pytest.approx(50e-3)


def test_trace_attrib_refuses_traces_it_cannot_read():
    host_only = [e for e in _hand_trace()
                 if e.get("cat") not in ta.DEVICE_CATS]
    with pytest.raises(ValueError, match="no device events"):
        ta.Trace(host_only)
    unlinked = [dict(e, args={}) if e.get("cat") in ta.DEVICE_CATS else e
                for e in _hand_trace() if e.get("cat") != "ac2g"]
    with pytest.raises(ValueError, match="links to its launch"):
        ta.Trace(unlinked)


def test_family_names_the_hand_written_kernels():
    for name, fam in (
            ("void pool_ln_kernel<3, true>(CUtensorMap, PoolArgs, Geo)",
             "K2 pool_ln"),
            ("void halo_gen_kernel<96>(CUtensorMap, PoolArgs, Geo)",
             "K2 pool_ln"),
            ("void pool_max_kernel<true>(MaxParams)", "K3 pool_max"),
            ("pool_max_bwd_tile_kernel(CUtensorMap, CUtensorMap, ...)",
             "K3 pool_max_bwd"),
            ("void attn_bwd_kv_kernel<96, 3>(...)", "K5 attention_bwd"),
            ("void dx_kernel<3>(CUtensorMap, PoolArgs, Geo)", "K6 conv_dx"),
            ("void conv_dk_reduce_kernel(float const*, float*, int, int)",
             "K7 conv_dk"),
            ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)", "NCCL"),
            ("void at::native::(anonymous namespace)::CatArrayBatchedCopy"
             "<...>", "CatArrayBatchedCopy"),
            ("void at::native::unrolled_elementwise_kernel<at::native::"
             "direct_copy_kernel_cuda(...)>", "cast/copy"),
            ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", "convolution"),
            ("void cunn_SoftMaxForward<4, float>(...)", "reduction")):
        assert ta.family(name) == fam, name


def test_kernel_name_reads_demangled_and_mangled_names():
    """``KERNELS`` sorts both forms of a kernel's name: the profiler's and
    a graph's DOT dump's; a name that only ends in one of them is not it."""
    for text, name in (
            ("void pool_max_bwd_tile_kernel<96>(CUtensorMap, ...)",
             "pool_max_bwd_tile_kernel"),
            ('"_Z14pool_ln_kernelILi3ELb1EEv14CUtensorMap_st" topoId=4',
             "pool_ln_kernel"),
            ("_Z9dx_kernelILi3EEv14CUtensorMap_st8PoolArgs3Geo", "dx_kernel"),
            ("_Z21conv_dk_reduce_kernelPKfPfii", "conv_dk_reduce_kernel"),
            ("void conv_dx_kernel<3>(...)", None),
            ("void at::native::vectorized_elementwise_kernel<4>(...)", None)):
        assert ta.kernel_name(text) == name, text
        assert ta.is_hand_written(ta.family(text)) == (name is not None)
    assert set(ta.KERNELS.values()) == ta.HAND_WRITTEN
    assert {f.split()[0] for f in ta.HAND_WRITTEN} == {
        f"K{i}" for i in range(1, 8)}


def test_module_scopes_name_every_block_on_a_cpu_profile(tmp_path):
    """The tiny train step traced on the CPU: every block's owner ranges,
    and the backward's ops owned by the owner of their forward, under the
    names of a replay's owner table."""
    from svit_tpu_torch.models import build_model

    res = tf.trace(train=True, batch=2, iters=1, out=str(tmp_path),
                   device="cpu", opts=TINY, verbose=False)
    events = ta.load(res["eager"]["trace"])
    scopes = {e["name"] for e in events if e.get("ph") == "X"
              and e["name"].startswith(ta.MODULE)}
    for phase in ("consistency", "video", "image"):
        assert {f"{ta.MODULE}{phase}/blocks.{i}/attn{sub}" for i in range(3)
                for sub in ("", "/bias", "/core")} <= scopes
        assert {ta.MODULE + f"{phase}/{n}" for n in ("stem", "head")} \
            <= scopes
    assert {ta.MODULE + n for n in ("backward", "optimizer")} <= scopes
    # a kernel stood in for each product and multiply (launched inside
    # the op, as a CUDA op launches)
    extra, corr = [], 0
    for e in list(events):
        if e.get("ph") == "X" and e.get("cat") == "cpu_op" and \
                e["name"] in ("aten::mm", "aten::bmm", "aten::mul"):
            corr += 1
            mid = e["ts"] + e["dur"] / 2
            extra.append(_x("cuda_runtime", "cudaLaunchKernel", e["tid"],
                            mid, 0.001, pid=e["pid"], correlation=corr))
            extra += _kernel("k", mid + 1, 1, corr, flow=False)
    s = ta.summarize(ta.Trace(events + extra), top=1000)
    owners = {o for o, _, _ in s["owners"]}
    assert s["unowned_share"] == 0
    assert {f"video/blocks.{i}/attn{ta.BACKWARD}" for i in range(3)} <= owners
    assert {f"image/blocks.{i}/mlp{ta.BACKWARD}" for i in range(3)} <= owners
    # no backward node is left without its forward's owner or op
    assert not [o for o in owners if "Backward" in o]
    # the owners need no hooks on the model
    model, _ = build_model(common.load_cfg(opts=TINY), device="cpu")
    assert not any(m._forward_pre_hooks or m._forward_hooks
                   for m in model.modules())
    np.testing.assert_equal(res["eager"]["iters"], 1)
