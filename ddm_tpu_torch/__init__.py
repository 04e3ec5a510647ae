"""PyTorch / CUDA port of ddm_tpu (Distributional Diffusion Models).

Five slices on one NVIDIA H100: the DiT-S/4 sampling path
(``generate_torch.py``), the CIFAR-10 training path
(``train_cifar10_dit_torch.py``), both at ``--image-size`` 128 to 512
(N = 1024 to 16384 tokens), both with routed experts in place of the
dense MLP halves (``--moe-experts``), and both at the DiT-B and DiT-L widths,
where each half-block takes the JAX package's kernel tier for its shapes
(``ops/tiers.py``), and training with Megatron tensor parallelism and
data parallelism over ``torch.distributed`` ranks (``--tp``,
``parallel/``), whose checkpoints sample on one card. The DiT block's
half-blocks and their backwards, the long-sequence attention core, the MoE
layer and the energy score are hand-written CUDA kernels (K1f/K1b MLP, K6f
its partial and K6b the partial's backward, K2f/K2b attention, K4 its split
backward, K7f/K7b the standalone core, K8f/K8b flash attention, K11f/K11b
MoE dispatch, K10f/K10b expert FFN, K10p its F-chunked partial, K12f/K12b
MoE combine, K3f/K3b energy). Imports torch and numpy, never JAX.
"""

from .models.dit import DDDMDiT, init_params
from .models.factory import MODEL_DEFAULTS, SAMPLER_DEFAULTS, build_model, make_tokens_apply
from .models.moe import MoEMLP
from .ops.attention import fused_attention, fused_attention_block
from .ops.energy import fused_energy_terms
from .ops.flash import flash_attention
from .ops.mlp_block import fused_mlp_block, fused_mlp_partial
from .sampling import sample_dddm, sample_dddm_batched
from .training import distributional_training_step, make_optimizer, make_train_step
from .utils.checkpoint import load_params, save_checkpoint

__all__ = [
    "DDDMDiT",
    "init_params",
    "MODEL_DEFAULTS",
    "SAMPLER_DEFAULTS",
    "build_model",
    "make_tokens_apply",
    "MoEMLP",
    "fused_attention",
    "fused_attention_block",
    "fused_energy_terms",
    "flash_attention",
    "fused_mlp_block",
    "fused_mlp_partial",
    "sample_dddm",
    "sample_dddm_batched",
    "distributional_training_step",
    "make_optimizer",
    "make_train_step",
    "load_params",
    "save_checkpoint",
]
