"""Mixture-of-Experts MLP half-block on the replicated path (PyTorch port).

Port of ``ddm_tpu/models/moe.py`` (``MoEMLP`` with ``tp_axis=None``, its
fused chain ``_fused`` and the Switch aux loss) and of
``make_moe_aux_apply``. Each block's MLP half routes its token rows to
``num_experts`` GELU expert FFNs, top-1 (Switch) or top-2 (GShard, gates
renormalised, second choices queued after all first choices), in routing
groups of ``group_size`` rows with a static per-group capacity
``cap = ceil(gs * capacity * topk / E)``; tokens over capacity pass through
the residual. The chain is the JAX fused path's:

    moe_dispatch_thru (K11)  ->  Switch aux  ->  expert_ffn (K10)
        ->  moe_combine_res (K12, the block's residual added in the combine)

on CUDA tensors through the hand-written kernels, on CPU tensors through
their plain versions. A row count that is not a whole number of groups is
zero-padded to the next group boundary; the padded rows take no route,
use no capacity, add nothing to the aux statistics and are sliced off
(the same kernels run with a valid-row count; the JAX package sends that
case to its einsum path, whose numbers these match).
:func:`moe_mlp_reference` is the plain version of the whole layer, after
that einsum path.

Parameters (the JAX names, ``blocks.{i}.moe.*`` in the port's
``state_dict``): ``router.weight (E, D)`` and ``router.bias (E,)`` in
``nn.Linear``'s layout (the JAX ``router_kernel`` is its transpose),
``experts_in (E, D, F)``, ``experts_in_bias (E, F)``, ``experts_out
(E, F, D)``, ``experts_out_bias (E, D)`` in the JAX layout. The reference
checkpoint has no MoE, so these keys are the port's own.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from ..ops.expert_ffn import expert_ffn, expert_ffn_reference
from ..ops.mlp_block import layer_norm
from ..ops.moe_dispatch import moe_cfg, moe_combine_res, moe_dispatch_thru

__all__ = ["MoEMLP", "moe_mlp_reference", "make_moe_aux_apply"]


class _Router(nn.Module):
    def __init__(self, dim: int, num_experts: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((num_experts, dim), device=device))
        self.bias = nn.Parameter(torch.empty((num_experts,), device=device))


class MoEMLP(nn.Module):
    """Expert-routed GELU MLP over pre-LN token rows ``(T, D) -> (T, D)``,
    owning no LayerNorm: the block hands it LN2's parameters. Parameters
    start uninitialised (see :func:`ddm_tpu_torch.models.dit.init_params`)."""

    def __init__(self, dim: int, hidden: int, num_experts: int, capacity: float = 1.25,
                 group_size: int = 0, topk: int = 1, device=None, fast_gelu: bool = False):
        super().__init__()
        if topk not in (1, 2):
            raise ValueError(f"topk must be 1 or 2, got {topk}")
        self.num_experts, self.capacity = num_experts, capacity
        self.group_size, self.topk = group_size, topk
        self.fast_gelu = fast_gelu  # the experts' GELU: exact erf, or the sigmoid GELU
        E = num_experts
        self.router = _Router(dim, E, device)
        self.experts_in = nn.Parameter(torch.empty((E, dim, hidden), device=device))
        self.experts_in_bias = nn.Parameter(torch.empty((E, hidden), device=device))
        self.experts_out = nn.Parameter(torch.empty((E, hidden, dim), device=device))
        self.experts_out_bias = nn.Parameter(torch.empty((E, dim), device=device))

    def forward(self, rows: torch.Tensor, ln_scale: torch.Tensor,
                ln_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(out, aux)``: ``out`` the MLP half's rows ``rows + MoE(LN(rows))``
        in ``rows.dtype`` with the add in fp32 (JAX's ``residual="rows"``),
        and ``aux`` this block's Switch load-balance term ``E * sum_e f_e P_e``."""
        T, D = rows.shape
        E = self.num_experts
        cfg, T_pad = moe_cfg(T, E, self.group_size, self.capacity, self.topk)
        if T_pad != T:
            rows = nn.functional.pad(rows, (0, 0, 0, T_pad - T))
        xin, gates, pos1, pos2, cnt, psum, thru = moe_dispatch_thru(
            cfg, rows, ln_scale, ln_bias, self.router.weight.t(), self.router.bias, T)
        aux = E * torch.sum((cnt / float(T)) * (psum / float(T)))
        out = expert_ffn(xin, self.experts_in, self.experts_in_bias, self.experts_out,
                         self.experts_out_bias, self.fast_gelu)
        tok = moe_combine_res(cfg, out, gates, pos1, pos2, thru)
        return tok[:T], aux


def moe_mlp_reference(layer: MoEMLP, rows: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor):
    """Plain PyTorch version of the whole layer, ``layer(rows, ...)``'s
    ``(out, aux)``, written after the JAX einsum path
    (``ddm_tpu/models/moe.py:276-446``, replicated branch): one-hot dispatch
    and combine tensors ``(G, gs, E, cap)`` contracted with einsums, the
    plain expert FFN, and autograd for the backward. It shares no routing
    code with K11/K12 or their plain versions, so it holds the fused chain
    to the JAX package's own formulation."""
    T, D = rows.shape
    E, dtype = layer.num_experts, rows.dtype
    cfg, T_pad = moe_cfg(T, E, layer.group_size, layer.capacity, layer.topk)
    gs, cap, G = cfg.gs, cfg.cap, T_pad // cfg.gs
    x = nn.functional.pad(rows, (0, 0, 0, T_pad - T))
    rows_g = layer_norm(x.float(), ln_scale, ln_bias).to(dtype).view(G, gs, D)
    logits = torch.einsum("gtd,de->gte", rows_g.float(), layer.router.weight.t()) \
        + layer.router.bias
    probs = torch.softmax(logits, -1)
    valid = (torch.arange(T_pad, device=rows.device) < T).view(G, gs, 1).float()
    slots = torch.arange(cap, device=rows.device)

    def queue(oh, offset=0.0):
        # dispatch[g, t, e, c] = 1 iff token t holds slot c of expert e
        pos = oh.cumsum(1) * oh - 1.0 + offset * oh
        return oh[..., None] * (pos[..., None] == slots).float()

    if layer.topk == 1:
        gate, idx = probs.max(-1)  # the first index on ties
        onehot = nn.functional.one_hot(idx, E).float() * valid
        parts = [(queue(onehot), gate)]
    else:
        p2, i2 = torch.topk(probs, 2, dim=-1)
        onehot = nn.functional.one_hot(i2[..., 0], E).float() * valid
        oh2 = nn.functional.one_hot(i2[..., 1], E).float() * valid
        denom = p2[..., 0] + p2[..., 1] + 1e-9
        parts = [(queue(onehot), p2[..., 0] / denom),
                 (queue(oh2, onehot.sum(1, keepdim=True)), p2[..., 1] / denom)]
    aux = E * torch.sum(onehot.sum((0, 1)) / T * (probs * valid).sum((0, 1)) / T)
    local = sum(d for d, _ in parts)
    combine = sum(d * g[..., None, None] for d, g in parts)
    xin = torch.einsum("gtec,gtd->egcd", local.to(dtype), rows_g).reshape(E, G * cap, D)
    out = expert_ffn_reference(xin, layer.experts_in, layer.experts_in_bias,
                               layer.experts_out, layer.experts_out_bias, layer.fast_gelu)
    part = torch.einsum("gtec,egcd->gtd", combine, out.view(E, G, cap, D).float())
    out = part.reshape(T_pad, D)[:T].to(dtype)
    return (rows.float() + out.float()).to(dtype), aux


def make_moe_aux_apply(model, weight: float) -> Callable:
    """Token-space apply ``(xt, t, xi) -> (x0hat, aux)`` that surfaces the
    Switch load-balance loss: the mean of the model's per-block aux terms
    times ``weight`` (Switch uses 1e-2), which
    :func:`ddm_tpu_torch.training.distributional_training_step` adds to the
    energy loss and reports as ``moe_aux``."""

    def apply_fn(xt, t, xi):
        out, terms = model.tokens_and_aux(xt, t, xi)
        if not terms:
            raise ValueError("make_moe_aux_apply wrapped a model with no MoE blocks "
                             "(moe_experts <= 1?)")
        return out, (weight / len(terms)) * sum(terms)

    return apply_fn
