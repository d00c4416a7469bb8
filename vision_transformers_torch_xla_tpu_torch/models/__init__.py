"""ViT and ConvNeXt models with timm parameter names; importing registers
the names."""
from vision_transformers_torch_xla_tpu_torch.models import (  # noqa: F401
    convnext,
    my_vit,
    vision_transformer_zoo,
)
from vision_transformers_torch_xla_tpu_torch.models.factory import create_model
from vision_transformers_torch_xla_tpu_torch.models.registry import (
    get_default_cfg,
    list_models,
    model_entrypoint,
)

__all__ = ["create_model", "get_default_cfg", "list_models",
           "model_entrypoint"]
