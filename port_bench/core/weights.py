"""The weights of a run, made from its seed on the device.

One ``torch.Generator`` on the run's device, seeded from ``--seed``, draws
all the normal values in one call and all the uniform ones in another;
each parameter takes its slice, scaled by its rule (``reference/svit.py:
param_specs``: std 1 / sqrt(fan-in) for dense and convolution weights,
0.02 for tokens and rel-pos tables, uniform within sqrt(3 / fan-in) for
the pool filters, LayerNorms 1 and 0, biases 0).  The parameters are taken
in name order, so the same seed gives the same weights to the program and
to the reference.  They are f32, the master weights' type.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each stream of a run (weights,
    traffic, samples)."""
    return int(np.random.SeedSequence([int(seed), int(stream)])
               .generate_state(1, np.uint64)[0] >> 1)


WEIGHTS, TRAFFIC, SAMPLE = 1, 2, 3


def make_weights(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> f32 tensor on ``device`` for ``specs`` ((name, shape,
    init) sorted by name)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, WEIGHTS))
    sizes = {k: sum(math.prod(s) for _, s, i in specs if i in k)
             for k in (("fan_in", "token"), ("pool",))}
    normal = torch.randn(sizes[("fan_in", "token")], generator=gen,
                         device=device)
    uniform = torch.rand(sizes[("pool",)], generator=gen, device=device)
    out, at_n, at_u = {}, 0, 0
    for name, shape, init in specs:
        n = math.prod(shape)
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
        if init in ("fan_in", "token"):
            std = 1.0 / math.sqrt(fan_in) if init == "fan_in" else 0.02
            t = normal[at_n:at_n + n] * std
            at_n += n
        elif init == "pool":
            bound = math.sqrt(3.0 / fan_in)
            t = (uniform[at_u:at_u + n] * 2.0 - 1.0) * bound
            at_u += n
        elif init == "one":
            t = torch.ones(n, device=device)
        elif init == "zero":
            t = torch.zeros(n, device=device)
        else:
            raise ValueError(init)
        out[name] = t.view(shape)
    return out
