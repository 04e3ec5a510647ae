"""Megatron tensor-parallel region operators over a ``torch.distributed``
process group.

Port of ``ddm_tpu/parallel/tp.py``: Megatron's conjugate pair (Shoeybi et
al. 2019, section 3) as ``torch.autograd.Function``s.

* :func:`tp_region_enter`, the **f** operator: identity forward, all-reduce
  backward. It wraps the replicated activation (or parameter) that feeds a
  column-parallel product or a kernel that runs on every rank's shard: each
  rank's backward holds only its own columns' share of the cotangent, and
  the all-reduce reassembles the whole.
* :func:`tp_region_exit`, the **g** operator: all-reduce forward, identity
  backward. It wraps the partial products of a row-parallel product: the
  forward sum replicates the activation, and since everything after it is
  replicated, the incoming cotangent is already the whole on every rank.

With both in place every activation outside a sharded region has
replicated cotangents, so replicated parameters get whole gradients on
every rank with no further collective over the model group, and sharded
parameters get their shard's gradient. The all-reduces sum in fp32 and
return the input's dtype (a bf16 cotangent is rounded once, after the
sum). ``sp_region_exit`` waits for sequence parallelism (ROADMAP.md Queue 1
item 11).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["tp_region_enter", "tp_region_exit", "all_reduce_sum"]


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, in fp32, returned as a
    new tensor in ``t``'s dtype (``t`` itself where the group is one rank)."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    buf = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def tp_region_enter(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward over ``group`` (Megatron's f)."""
    return _Enter.apply(x, group)


def tp_region_exit(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward over ``group``, identity backward (Megatron's g)."""
    return _Exit.apply(x, group)
