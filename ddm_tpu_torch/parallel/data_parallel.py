"""The training step over a ``(data, model)`` grid of ranks.

Port of ``ddm_tpu/parallel/data_parallel.py`` ``make_sharded_train_step``
(``:54-170``), its ``shard_map`` body with tensor parallelism beside data
parallelism. The model on each rank holds its model-group shard
(``DDDMDiT(tp=..., tp_group=...)``), whose f and g operators
(:mod:`ddm_tpu_torch.parallel.tp`) own every collective over the model
group, so the step itself:

* cuts the global batch into the data ranks' equal slices;
* folds the data index, and only it, into the step's generator (JAX folds
  ``axis_index('data')`` into its key, ``:136``): every model rank of one
  data rank draws the same augmentation, t, eps and xi;
* runs the loss and ``backward()``, then averages the gradients (one flat
  fp32 all-reduce) and the metrics over the data group;
* clips by the global norm over the model group
  (:func:`~ddm_tpu_torch.parallel.fsdp.clip_grads_by_global_norm_sharded_`),
  and steps AdamW on the local shards.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..training import distributional_training_step, split_generator
from .fsdp import clip_grads_by_global_norm_sharded_
from .mesh import Mesh
from .tp import all_reduce_sum

__all__ = ["make_sharded_train_step"]


def make_sharded_train_step(
    model: torch.nn.Module,
    apply_fn: Callable,
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    *,
    m: int,
    beta: float,
    lam: float,
    w_bias: float,
    grad_clip: Optional[float] = None,
    preprocess: Optional[Callable[[torch.Tensor, torch.Generator], torch.Tensor]] = None,
    target_transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Build ``step(batch, generator, noise=None) -> metrics``: one in-place
    update of this rank's shard from the GLOBAL ``batch`` (the same on every
    rank). ``noise``, where given, is this data rank's injected ``(t, eps,
    xi)`` in place of the draws."""
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    def step(batch: torch.Tensor, generator: torch.Generator, noise=None):
        if batch.shape[0] % mesh.dp:
            raise ValueError(f"batch {batch.shape[0]} does not divide over {mesh.dp} data ranks")
        b = batch.shape[0] // mesh.dp
        local = batch[mesh.data_rank * b:(mesh.data_rank + 1) * b]
        # this data rank's generator from the step's (the same on every rank)
        folded = split_generator(generator, mesh.dp)[mesh.data_rank]
        kpre, key = split_generator(folded, 2, batch.device)
        x0 = preprocess(local, kpre) if preprocess is not None else local
        optimizer.zero_grad(set_to_none=True)
        t, eps, xi = noise if noise is not None else (None, None, None)
        loss, metrics = distributional_training_step(
            apply_fn, x0, m=m, beta=beta, lam=lam, w_bias=w_bias, generator=key, t=t, eps=eps,
            xi=xi, target_transform=target_transform)
        loss.backward()
        if mesh.dp > 1:
            grads = [p.grad for _, p in params]
            flat = all_reduce_sum(torch.cat([g.reshape(-1).float() for g in grads]),
                                  mesh.data_group) / mesh.dp
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
            keys = list(metrics)
            mean = all_reduce_sum(torch.stack([metrics[k].detach().float() for k in keys]),
                                  mesh.data_group) / mesh.dp
            metrics = dict(zip(keys, mean))
        if grad_clip is not None and grad_clip > 0:
            clip_grads_by_global_norm_sharded_(params, grad_clip, mesh.model_group, mesh.tp)
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step
