"""Flagship-model construction for the port: DiT-S/4 defaults and
:func:`build_model`.

Port of ``ddm_tpu/models/factory.py``. The defaults match the JAX package's
(and the reference trainer's model flags). The port runs the replicated
path, dense or mixture-of-experts (``moe_experts > 1``), and dense
tensor parallelism (``tp > 1``: a rank's shard given a model group, else
the full instance a TP checkpoint samples with): every key that selects
another path raises ``NotImplementedError`` naming its ``ROADMAP.md`` item,
and none is silently ignored.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from .dit import DDDMDiT
from .moe import make_moe_aux_apply

__all__ = ["MODEL_DEFAULTS", "SAMPLER_DEFAULTS", "build_model", "make_tokens_apply"]

MODEL_DEFAULTS: dict = {
    "image_size": 32,
    "patch_size": 4,
    "embed_dim": 384,
    "depth": 8,
    "heads": 6,
    "time_embed": 256,
    "mlp_ratio": 4.0,
    "dtype": "bfloat16",
    "attention": "auto",
    "remat": False,
    "tp": 1,
    "sp": False,
    "mlp_persist": 0,
    "moe_experts": 0,
    "moe_capacity": 1.25,
    "moe_group_size": 256,
    "moe_topk": 1,
}

SAMPLER_DEFAULTS: dict = {
    "sample_steps": 20,
    "eps_churn": 1.0,
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_WIDE = "Queue 1 item 8 (remat and mlp_persist at the wide widths)"


def _as_mapping(cfg: Any) -> Mapping:
    return cfg if isinstance(cfg, Mapping) else vars(cfg)


def build_model(cfg: Any, device: torch.device | str = "cpu", tp_group=None) -> DDDMDiT:
    """Construct ``DDDMDiT`` from a config mapping or namespace on ``device``;
    with ``tp > 1``, the shard of ``tp_group``'s rank (with no group, the
    full tensor-parallel instance, as JAX's ``tp_axis=None``).

    Keys missing from ``cfg`` (or ``None``) take :data:`MODEL_DEFAULTS`.
    Parameters are left uninitialised: load a ``state_dict`` or call
    :func:`ddm_tpu_torch.models.dit.init_params`.

    Every width and image size builds. Each half-block picks its kernel
    tier per call from its shapes, as the JAX ladder does
    (:mod:`ddm_tpu_torch.ops.tiers`): K2 where the ladder has a half-block
    tier, else the third rung around K7, K8 or the plain core. A call on
    CUDA tensors launches the port's kernel wherever the JAX package runs
    one: every kernel of the package is ported. ``attention`` is ``"auto"``,
    ``"flash"`` (the same) or ``"xla"`` (the unfused attention half).
    ``fast_gelu`` (default False; an environment switch in the JAX package,
    ``DDM_TPU_FAST_GELU=1``, so no key of its ``MODEL_DEFAULTS``) takes the
    sigmoid GELU in every MLP half-block.
    """
    m = _as_mapping(cfg)

    def get(key: str):
        value = m.get(key)
        return MODEL_DEFAULTS[key] if value is None else value

    unsupported = [
        (bool(get("sp")), "sp", "Queue 1 item 11 (parallelism)"),
        (bool(get("remat")), "remat", _WIDE),
        (int(get("mlp_persist")) > 0, "mlp_persist > 0", _WIDE),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"the PyTorch port does not support {what} yet: ROADMAP.md {item}")

    if int(get("moe_experts")) > 1 and int(get("moe_topk")) not in (1, 2):
        raise ValueError(f"moe_topk must be 1 or 2, got {get('moe_topk')}")

    return DDDMDiT(
        img_size=int(get("image_size")),
        patch_size=int(get("patch_size")),
        in_channels=3 * 2,  # channel-concat xi
        out_channels=3,
        embed_dim=int(get("embed_dim")),
        depth=int(get("depth")),
        num_heads=int(get("heads")),
        time_embed_dim=int(get("time_embed")),
        mlp_ratio=float(get("mlp_ratio")),
        dtype=_DTYPES[str(get("dtype"))],
        device=torch.device(device),
        moe_experts=int(get("moe_experts")),
        moe_capacity=float(get("moe_capacity")),
        moe_group_size=int(get("moe_group_size")),
        moe_topk=int(get("moe_topk")),
        attention=str(get("attention")),
        tp=int(get("tp")),  # DDDMDiT refuses tp > 1 with experts (expert parallelism)
        tp_group=tp_group,
        fast_gelu=bool(m.get("fast_gelu") or False),
    )


def make_tokens_apply(model: DDDMDiT, moe_aux_weight: float = 0.01):
    """Token-space denoiser apply for the training step: ``model.tokens`` for
    a dense model, and for an MoE model with a positive aux weight
    :func:`~ddm_tpu_torch.models.moe.make_moe_aux_apply`, so the Switch
    load-balance loss reaches the optimizer (``ddm_tpu/models/factory.py``
    ``make_tokens_apply``)."""
    if model.moe_experts > 1 and moe_aux_weight > 0:
        return make_moe_aux_apply(model, moe_aux_weight)
    return model.tokens
