"""Attention ops: plain PyTorch versions and the hand-written CUDA kernel."""
from vision_transformers_torch_xla_tpu_torch.ops.attention import (  # noqa: F401
    multi_head_attention,
)
