"""Model construction (counterpart of ``svit_tpu/models/build.py``).

``build_model`` returns the module on its device, for serving (eval mode,
no gradients) or, with ``train=True``, for training, with random weights
drawn from ``cfg.RNG_SEED``; load real weights with ``load_state_dict`` (see
``svit_tpu_torch/utils/converter.py``).  The model runs on the card unless
the caller passes ``device="cpu"``; without a card that raises.
"""

from __future__ import annotations

import torch

from svit_tpu_torch.models.registry import MODEL_REGISTRY
from svit_tpu_torch.models.svit import SViT, SViTArch

MODEL_REGISTRY.register("SViT")(SViT)

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def compute_dtype(cfg) -> torch.dtype:
    if cfg.TRAIN.MIXED_PRECISION:
        return _DTYPES[cfg.TPU.COMPUTE_DTYPE]
    return torch.float32


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the card; raises when no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)


def build_model(cfg, dtype=None, use_kernels=None, device=None, train=False):
    """Return (module, arch) for cfg.MODEL.MODEL_NAME.

    ``use_kernels`` defaults to ``TPU.USE_PALLAS_ATTENTION``: route the
    forward and backward through the hand-written kernels (bf16 only on the
    card; a CPU tensor always takes the plain versions).  With ``train`` the
    module is in train mode and its f32 master weights require grad;
    otherwise it serves: eval mode, no gradients."""
    device = resolve_device(device)
    arch = SViTArch.from_cfg(cfg)
    if dtype is None:
        dtype = compute_dtype(cfg)
    if use_kernels is None:
        use_kernels = bool(cfg.TPU.USE_PALLAS_ATTENTION)
    if use_kernels and device.type == "cuda" and dtype != torch.bfloat16:
        raise ValueError(
            f"the CUDA kernels take bfloat16, not {dtype}: set "
            "TRAIN.MIXED_PRECISION True with TPU.COMPUTE_DTYPE bfloat16, or "
            "TPU.USE_PALLAS_ATTENTION False")
    model = MODEL_REGISTRY.get(cfg.MODEL.MODEL_NAME)(
        arch, dtype=dtype, use_kernels=use_kernels)
    model.init_weights(torch.Generator().manual_seed(int(cfg.RNG_SEED)))
    return model.to(device).train(train).requires_grad_(train), arch
