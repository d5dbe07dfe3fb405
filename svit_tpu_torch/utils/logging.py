"""Structured logging (reference ``slowfast/utils/logging.py``).

Master-process-only logger writing to stdout and ``OUTPUT_DIR/stdout.log``;
stats are emitted as greppable ``json_stats: {...}`` lines — the same format
the reference greps back out of its own logs (checkpoint.py:497-509).
"""

from __future__ import annotations

import builtins
import decimal
import functools
import json
import logging
import os
import sys


def _suppress_print():
    def ignore(*args, **kwargs):
        pass

    builtins.print = ignore


@functools.lru_cache(maxsize=None)
def _configure(output_dir: str | None, is_master: bool):
    logger = logging.getLogger("svit_tpu_torch")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s][%(levelname)s] %(filename)s: %(lineno)3d: %(message)s",
        datefmt="%m/%d %H:%M:%S",
    )
    if is_master:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            fh = logging.FileHandler(
                os.path.join(output_dir, "stdout.log"), mode="a"
            )
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        _suppress_print()
    return logger


def setup_logging(output_dir: str | None = None, is_master: bool = True):
    return _configure(output_dir, is_master)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger("svit_tpu_torch").getChild(name)


def _round_floats(obj):
    if isinstance(obj, float):
        return float(decimal.Decimal(f"{obj:.6f}"))
    if isinstance(obj, dict):
        return {k: _round_floats(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_round_floats(v) for v in obj]
    return obj


def log_json_stats(stats: dict) -> None:
    """Emit a ``json_stats:`` line (reference logging.py:89-101)."""
    stats = _round_floats(stats)
    logger = logging.getLogger("svit_tpu_torch")
    logger.info("json_stats: {:s}".format(json.dumps(stats, sort_keys=True)))
