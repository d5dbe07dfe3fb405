"""The process group and host-side collectives (counterpart of
``svit_tpu/parallel/dist.py``, reference ``slowfast/utils/distributed.py``).

The JAX package runs one process per host over all of its chips; the port
runs one process per card, as the reference does: NCCL between cards, gloo
on the CPU.  ``NUM_GPUS`` keeps its reference meaning, the ranks of a host
(it fixes the video/image loss ratio), so a host runs ``min(NUM_GPUS,
cards)`` processes (``local_processes``) and a one-card host one process
with no group at all.  Rank ``SHARD_ID * local + local_rank`` of
``NUM_SHARDS * local``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def local_processes(cfg, device=None) -> int:
    """Processes this host runs: one per card it uses, at most
    ``NUM_GPUS``; one on the CPU."""
    if (device is not None and torch.device(device).type != "cuda") or \
            not torch.cuda.is_available():
        return 1
    return max(1, min(int(cfg.NUM_GPUS), torch.cuda.device_count()))


def init_distributed(cfg, local_rank: int = 0, local_world=None,
                     backend=None) -> None:
    """Join the job's process group at ``INIT_METHOD``: a no-op for a job
    of one process (reference ``misc.py:283-299``), or when the group is
    up already.  ``local_world`` is the processes of this host
    (``local_processes`` by default); ``backend`` defaults to NCCL on the
    card and gloo on the CPU."""
    local = local_processes(cfg) if local_world is None else local_world
    world = int(cfg.NUM_SHARDS) * local
    if world <= 1 or dist.is_initialized():
        return
    rank = int(cfg.SHARD_ID) * local + local_rank
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=cfg.INIT_METHOD,
                            world_size=world, rank=rank)
    logger.info("Joined the process group: rank %d of %d (%s) at %s", rank,
                world, backend, cfg.INIT_METHOD)


def is_master_proc() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def all_gather_host(obj):
    """Every rank's ``obj`` (any picklable nest of host arrays), as a list
    in rank order; ``[obj]`` in a job of one process (JAX
    ``process_allgather``, whose leading axis is the process)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
