"""Megatron tensor-parallel layout of the DiT's parameters, as rules on the
port's ``state_dict`` names, and the helpers that cut a full ``state_dict``
into a rank's shard and put the shards back together.

Port of the dense rows of ``ddm_tpu/parallel/sharding.py`` ``DIT_TP_RULES``
(``:50-60``). JAX's kernels are ``(in, out)`` and name the sharded axis in
a ``PartitionSpec``; the port's weights are ``nn.Linear``'s ``(out, in)``,
so a column-parallel product shards dim 0 of its weight and a row-parallel
one dim 1:

* ``attn.qkv``: column-parallel q, k and v. The port keeps the reference
  checkpoint's one fused key with rows ``[q | k | v]``
  (:mod:`ddm_tpu_torch.utils.convert` maps it to JAX's three ``attn/{q,k,v}``
  projections), so the rule cuts each third alike: a rank's shard is
  ``[q_r | k_r | v_r]``, whole heads of each;
* ``attn.proj``: row-parallel (its input axis), bias replicated;
* ``ff.net.0`` (``ff_in``): column-parallel, weight and bias;
* ``ff.net.2`` (``ff_out``): row-parallel, bias replicated.

Everything else (embeddings, LayerNorms, the unembed) is replicated. The
MoE rows (expert parallelism) wait for ROADMAP.md Queue 1 item 11.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["DIT_TP_RULES", "spec_for_name", "shard_tensor", "gather_tensors",
           "shard_state_dict", "gather_state_dicts", "gather_full_state_dict"]

# (name regex, sharded dim or None for replicated, parts cut alike) -- first
# match wins; no match -> replicated
DIT_TP_RULES: Tuple[Tuple[str, Optional[int], int], ...] = (
    (r"attn\.qkv\.(weight|bias)$", 0, 3),
    (r"attn\.proj\.weight$", 1, 1),
    (r"attn\.proj\.bias$", None, 1),
    (r"ff\.net\.0\.(weight|bias)$", 0, 1),
    (r"ff\.net\.2\.weight$", 1, 1),
    (r"ff\.net\.2\.bias$", None, 1),
)


def spec_for_name(name: str) -> Optional[Tuple[int, int]]:
    """``(dim, parts)`` of a sharded parameter, None for a replicated one."""
    for pattern, dim, parts in DIT_TP_RULES:
        if re.search(pattern, name):
            return None if dim is None else (dim, parts)
    return None


def shard_tensor(t: torch.Tensor, dim: int, parts: int, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``t``: each of its ``parts`` equal slices
    along ``dim`` cut in ``tp``, the ``rank``-th piece of each, in order."""
    if t.shape[dim] % (parts * tp):
        raise ValueError(f"dim {dim} of shape {tuple(t.shape)} does not split into "
                         f"{parts} x tp={tp}")
    pieces = [p.chunk(tp, dim)[rank] for p in t.chunk(parts, dim)]
    return torch.cat(pieces, dim).contiguous()


def gather_tensors(shards: List[torch.Tensor], dim: int, parts: int) -> torch.Tensor:
    """The inverse of :func:`shard_tensor` over every rank's shard, in rank order."""
    cut = [s.chunk(parts, dim) for s in shards]
    return torch.cat([torch.cat([c[p] for c in cut], dim) for p in range(parts)], dim)


def shard_state_dict(sd: Mapping[str, torch.Tensor], tp: int, rank: int
                     ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s ``state_dict`` of a ``tp``-way model from the full one."""
    out = {}
    for name, t in sd.items():
        spec = spec_for_name(name)
        out[name] = t if spec is None else shard_tensor(t, *spec, tp, rank)
    return out


def gather_state_dicts(shards: List[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` from every rank's, in rank order (replicated
    entries from rank 0)."""
    out = {}
    for name, t in shards[0].items():
        spec = spec_for_name(name)
        out[name] = t if spec is None else gather_tensors([s[name] for s in shards], *spec)
    return out


def gather_full_state_dict(tensors: Mapping[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The full ``{name: tensor}`` (CPU tensors) from this rank's shards of
    a model's parameters (or of their gradients), gathered over ``group``
    (a collective: every rank of the group calls it). NCCL gathers the
    card's tensors; gloo has no all-gather of CUDA tensors, so there the
    shards go through the CPU."""
    sd = {k: v.detach() for k, v in tensors.items()}
    n = 1 if group is None else dist.get_world_size(group)
    on_card = n > 1 and dist.get_backend(group) == "nccl"
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    for name, t in sd.items():
        if n > 1 and spec_for_name(name) is not None:
            t = t.contiguous() if on_card else t.cpu().contiguous()
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=group)
        else:
            parts = [t.cpu()] * n
        for shard, part in zip(shards, parts):
            shard[name] = part.cpu()
    return gather_state_dicts(shards)
