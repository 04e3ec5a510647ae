"""The global-norm clip of gradients that are sharded over a model group.

Port of ``ddm_tpu/parallel/fsdp.py`` ``clip_by_global_norm_sharded``
(``:128``) for Megatron tensor parallelism (``axis='model'``); the ZeRO-3
placement of the same JAX module waits for ``--fsdp`` (ROADMAP.md Queue 1
item 11). A sharded gradient holds a disjoint slice of the whole, so its
squared sum adds as it is; a replicated one is the same on all ``tp``
ranks, so its squared sum is divided by ``tp`` before the sum over the
group. The norm is the square root of that all-reduced sum, and the clip
keeps optax's rule (:func:`ddm_tpu_torch.training.clip_grads_by_global_norm_`):
gradients stay as they are when ``norm < max_norm`` and become ``g / norm *
max_norm`` otherwise. Gradients over the data group must already be
averaged.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from .sharding import spec_for_name
from .tp import all_reduce_sum

__all__ = ["clip_grads_by_global_norm_sharded_"]


@torch.no_grad()
def clip_grads_by_global_norm_sharded_(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                                       max_norm: float, group, tp: int) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place over the ``tp`` ranks of
    ``group``, each holding its shard of every parameter that
    ``DIT_TP_RULES`` shards; returns the global norm (the same on every
    rank)."""
    named = [(n, p.grad) for n, p in named_params if p.grad is not None]
    if not named:
        return torch.zeros(())
    sq = torch.stack([g.float().pow(2).sum() / (1 if spec_for_name(n) else tp)
                      for n, g in named]).sum()
    norm = all_reduce_sum(sq, group).sqrt()
    keep = norm < max_norm
    for _, g in named:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
