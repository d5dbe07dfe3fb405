"""Find a cell's files by name.

``BENCHMARK.json`` at the checkout's root names each cell (``workloads``)
with its configuration and traffic mix, and each metric with the cells that
report it.  Everything that belongs to one name sits in files of its own
under ``port_bench/``, found by that name, so a new configuration, mix,
metric or cell is new files and new entries, never an edit:

- ``configs/<config>.yaml``: the whole configuration as it is run (the
  program's keys, and a ``BENCH`` section with the source, the keys cut,
  the sizes assumed and the deployment it stands for);
- ``traffic/<mix>.json``: the mix's parameters, read by ``traffic.py``;
- ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(ctx)`` that returns a number or None;
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``, with the readings each was set from.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional

import yaml

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    cfg: dict             # the configuration's YAML, without BENCH
    meta: dict            # its BENCH section
    mix: dict             # the traffic mix
    limits: dict          # the limits of the correctness numbers
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(path: str = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, end_to_end_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in end_to_end_names


def load_config(name: str):
    """(the program's configuration as a nested dict, the BENCH section)."""
    with open(os.path.join(HERE, "configs", name + ".yaml")) as f:
        data = yaml.safe_load(f)
    meta = data.pop("BENCH")
    return data, meta


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    cfg, meta = load_config(w["config"])
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, config=w["config"], traffic=w["traffic"],
                chips=int(w["chips"]), cfg=cfg, meta=meta,
                mix=load_json("traffic", w["traffic"] + ".json"),
                limits=load_json("limits", name + ".json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_cfg(cfg: dict, seed: int):
    """The program's configuration object for ``cfg`` (its defaults, then
    every key of the cell's file), with ``RNG_SEED`` the run's seed."""
    from svit_tpu_torch.config import assert_and_infer_cfg
    from svit_tpu_torch.config.defaults import get_cfg

    c = get_cfg()
    c.merge_from_other_cfg(copy.deepcopy(cfg))
    c.RNG_SEED = int(seed)
    return assert_and_infer_cfg(c)


def with_seed(cfg: dict, seed: int) -> Dict:
    """The cell's configuration as the reference reads it, with the run's
    seed."""
    out = copy.deepcopy(cfg)
    out["RNG_SEED"] = int(seed)
    return out
