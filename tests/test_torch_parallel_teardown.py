"""Leaving a process group destroys every captured CUDA graph first: a
graph that captured an NCCL collective keeps its communicator alive, and
``ncclCommDestroy`` waits for it without end (on four cards the timed
pass's ranks stalled in ``destroy_process_group`` with their all-reduce's
graph alive).  On the CPU, a one-rank gloo group and stand-in graphs hold
the order; ``tests/test_torch_parallel_cuda.py`` holds it with NCCL on two
cards."""

import torch
import torch.distributed as dist

from svit_tpu_torch.engine import graphs
from svit_tpu_torch.parallel import dist as du
from svit_tpu_torch.utils import misc


class StandIn:
    """A captured graph's stand-in: records whether the group was up when
    it was released."""

    def __init__(self):
        self.released_in_group = None

    def release(self):
        self.released_in_group = dist.is_initialized()


def _group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)


def test_leaving_releases_every_graph_first(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    live = [StandIn(), StandIn()]
    for g in live:
        graphs._LIVE.add(g)
    _group(tmp_path)
    du.destroy_process_group()
    assert not dist.is_initialized()
    assert [g.released_in_group for g in live] == [True, True]
    assert not list(graphs._LIVE)


def test_leaving_without_a_group_does_nothing():
    assert not dist.is_initialized()
    du.destroy_process_group()


def test_release_all_forgets_dead_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    g = StandIn()
    graphs._LIVE.add(g)
    del g   # no one refers to it: the weak set drops it
    graphs.release_all()
    assert not list(graphs._LIVE)


def test_a_launch_job_rank_leaves_through_the_port(tmp_path, monkeypatch):
    """``launch_job``'s spawned rank (``_run_job``) leaves its group through
    ``du.destroy_process_group``, so its graphs go first."""
    calls = []
    monkeypatch.setattr(du, "init_distributed",
                        lambda cfg, rank, procs: _group(tmp_path))
    real = du.destroy_process_group

    def leave():
        calls.append(dist.is_initialized())
        real()

    monkeypatch.setattr(du, "destroy_process_group", leave)
    misc._run_job(0, 1, lambda cfg: calls.append("ran"), object(), None)
    assert calls == ["ran", True]
    assert not dist.is_initialized()
