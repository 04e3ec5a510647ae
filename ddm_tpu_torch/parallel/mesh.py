"""The ``(data, model)`` layout of a run's ranks as ``torch.distributed``
process groups.

Port of ``ddm_tpu/parallel/mesh.py`` ``make_mesh``. JAX reshapes its devices
to a ``(dp, tp)`` grid with the model axis fastest-varying, so that the
tensor-parallel collectives take the nearest links; here rank ``r`` sits
at data index ``r // tp`` and model index ``r % tp``. Each data index owns
one model group (its ``tp`` ranks, which hold one shard each of one
replica), and each model index one data group (its ``dp`` ranks, which hold
the same shard and split the batch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist

__all__ = ["Mesh", "make_mesh"]


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``(data, model)`` grid and its two groups
    (None where the run has one process)."""

    dp: int
    tp: int
    rank: int
    data_rank: int
    model_rank: int
    data_group: Optional[Any]
    model_group: Optional[Any]


def make_mesh(tp: int = 1) -> Mesh:
    """The ``(data, model)`` grid of ``world_size // tp`` data ranks over the
    initialised process group (one rank where none is initialised). Raises
    where the ranks do not divide by ``tp`` (a ``tp`` of 2 on one rank too),
    as JAX's raises for devices. Every rank must call it, in the same order
    as its other group constructions."""
    initialised = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    if tp < 1 or n % tp:
        raise ValueError(f"{n} ranks not divisible by tp={tp}")
    dp = n // tp
    data_group = model_group = None
    if initialised:
        # every rank constructs every group, in one order
        for d in range(dp):
            g = dist.new_group([d * tp + j for j in range(tp)])
            if d == rank // tp:
                model_group = g
        for j in range(tp):
            g = dist.new_group([d * tp + j for d in range(dp)])
            if j == rank % tp:
                data_group = g
    return Mesh(dp=dp, tp=tp, rank=rank, data_rank=rank // tp, model_rank=rank % tp,
                data_group=data_group, model_group=model_group)
