"""Patchification stem (counterpart of ``svit_tpu/models/stem.py``).

One Conv3d over the channels-last clip: kernel (3, 7, 7), stride (2, 4, 4),
padding (1, 3, 3) in the SSv2 recipe, so 16x224x224 frames become an
8x56x56 grid.  The conv stays ``F.conv3d``: the JAX package leaves it to XLA
outside any kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from svit_tpu_torch.models.common import cast


class PatchEmbed(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, kernel: Tuple[int, ...],
                 stride: Tuple[int, ...], padding: Tuple[int, ...]):
        super().__init__()
        self.proj = nn.Conv3d(dim_in, dim_out, tuple(kernel), tuple(stride),
                              tuple(padding))

    def forward(self, x: torch.Tensor, cache=None):
        """x: [B, T, H, W, C_in] -> (grid [B, T', H', W', dim_out], (T', H', W'));
        ``cache``: a train step's ``StepCache``."""
        w = cast(self.proj.weight, x.dtype, cache)
        b = cast(self.proj.bias, x.dtype, cache)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, self.proj.stride,
                     self.proj.padding)
        y = y.permute(0, 2, 3, 4, 1).contiguous()
        return y, tuple(y.shape[1:4])
