from svit_tpu_torch.models.build import build_model, compute_dtype  # noqa: F401
from svit_tpu_torch.models.registry import MODEL_REGISTRY  # noqa: F401
from svit_tpu_torch.models.svit import SViT, SViTArch, SViTHead  # noqa: F401
