"""PyTorch / CUDA port of ddm_tpu (Distributional Diffusion Models).

The first slice: the DiT-S/4 sampling path (``generate_torch.py``) on one
NVIDIA H100, with the DiT block's two half-block forwards as hand-written
CUDA kernels (K1 MLP, K2 attention). Imports torch and numpy, never JAX.
"""

from .models.dit import DDDMDiT, init_params
from .models.factory import MODEL_DEFAULTS, SAMPLER_DEFAULTS, build_model
from .ops.attention import fused_attention_block
from .ops.mlp_block import fused_mlp_block
from .sampling import sample_dddm, sample_dddm_batched
from .utils.checkpoint import load_params, save_checkpoint

__all__ = [
    "DDDMDiT",
    "init_params",
    "MODEL_DEFAULTS",
    "SAMPLER_DEFAULTS",
    "build_model",
    "fused_attention_block",
    "fused_mlp_block",
    "sample_dddm",
    "sample_dddm_batched",
    "load_params",
    "save_checkpoint",
]
