"""MoE dispatch (LN2 + router + top-k capacity queue) and combine (K11, K12).

Port of ``ddm_tpu/ops/moe_dispatch.py`` for the replicated path:

* :func:`moe_dispatch` / :func:`moe_dispatch_thru`: pre-LN rows ``x (T, D)``
  -> ``xin (E, G*Cp, D)`` slot rows in the compute dtype, ``gates
  (G, gs, 2)``, ``pos1``/``pos2 (G, gs, E)`` (fp32 slot positions, -1 off
  route, ``>= cap`` dropped), and the Switch aux statistics ``cnt`` and
  ``psum`` (E,): pre-capacity first-choice counts and router-prob sums.
  The router probabilities stay a backward residual. ``_thru`` also
  returns ``x`` itself, so the residual's cotangent joins ``dx`` inside
  the backward kernel in fp32;
* :func:`moe_combine` / :func:`moe_combine_res`: expert outputs
  ``(E, G*Cp, D)`` -> token rows ``(T, D)``, ``sum_k gate_k *
  out[e_k, slot_k]``; ``_res`` rounds that to the compute dtype, adds the
  fp32 residual and rounds again (the einsum path's order, bit for bit).

``T`` is a whole number of groups; ``n_valid`` rows at the front are real
and the rest are padding that takes no route, uses no capacity and adds
nothing to ``cnt`` or ``psum`` (the JAX package sends that case to its
einsum path, ``ddm_tpu/models/moe.py:214-222``). On CUDA tensors the ops
launch the hand-written kernels of ``csrc/moe.cu`` (K11f/K11b, K12f/K12b),
one routing group per block; on CPU tensors, and where the JAX gate runs its
einsum path instead (D % 128 != 0, gs % 8 != 0 or gs > 2048), the plain
versions here.
Routing is in fp32 on the compute-dtype LN output; argmax keeps the first
index on ties.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .kernel_config import LaunchCounter, check_status, current_stream, load_library, uses_kernel
from .mlp_block import layer_norm_bwd, ln_stats

__all__ = [
    "MoEDispatchCfg",
    "moe_cfg",
    "moe_dispatch_ok",
    "moe_dispatch",
    "moe_dispatch_thru",
    "moe_combine",
    "moe_combine_res",
    "moe_dispatch_fwd",
    "moe_dispatch_bwd",
    "moe_combine_fwd",
    "moe_combine_bwd",
    "moe_dispatch_reference",
    "moe_dispatch_bwd_reference",
    "moe_combine_reference",
    "moe_combine_bwd_reference",
    "chosen",
]

DISPATCH_LAUNCHES = LaunchCounter("K11f")
DISPATCH_BWD_LAUNCHES = LaunchCounter("K11b")
COMBINE_LAUNCHES = LaunchCounter("K12f")
COMBINE_BWD_LAUNCHES = LaunchCounter("K12b")


class MoEDispatchCfg(NamedTuple):
    """Static routing geometry."""

    gs: int           # routing group size (rows)
    cap: int          # per-expert capacity per group
    cpad: int         # slot rows per expert and group: roundup(cap, 8)
    num_experts: int
    topk: int         # 1 (Switch) or 2 (GShard)


def moe_cfg(T: int, num_experts: int, group_size: int, capacity: float,
            topk: int) -> Tuple[MoEDispatchCfg, int]:
    """``(cfg, T_pad)`` of ``MoEMLP`` for T rows: gs = min(group_size, T)
    (all rows when 0), T padded to whole groups, cap = ceil(gs * capacity *
    topk / E) per group (``ddm_tpu/models/moe.py:214-227``)."""
    if topk not in (1, 2):
        raise ValueError(f"topk must be 1 or 2, got {topk}")
    gs = min(group_size, T) if group_size > 0 else T
    cap = int(-(-gs * capacity * topk // num_experts))
    cfg = MoEDispatchCfg(gs=gs, cap=cap, cpad=-(-cap // 8) * 8, num_experts=num_experts,
                         topk=topk)
    return cfg, -(-T // gs) * gs


def moe_dispatch_ok(gs: int, E: int, cap: int, D: int, topk: int) -> bool:
    """The shapes K11 and K12 take, the JAX gate's (``moe_dispatch_ok`` of
    ``ddm_tpu/ops/moe_dispatch.py:633``): one routing group per block of 256
    threads with gs <= 2048 rows (gs % 8 == 0), E >= 2 experts, a
    lane-aligned row (D % 128 == 0), top-1 or top-2 and cap >= 1; no bound
    on D or E. Where it refuses, JAX runs its einsum path, and the port its
    plain versions, on any device. A shape whose per-row and per-expert
    state passes the card's shared memory (E past ~2,700 at gs 2048) raises
    at launch."""
    return (topk in (1, 2) and 0 < gs <= 2048 and gs % 8 == 0 and D % 128 == 0 and E >= 2
            and cap >= 1)


# K11b's per-group partials (G, 2D + D*E + E) fp32 are reduced in column
# slabs past this many bytes (a slab reruns the backward's first pass)
MOE_BWD_SCRATCH_BYTES = 1 << 30


def _bwd_slab(G: int, D: int, E: int) -> int:
    """Columns per slab of K11b's partials: all D where they fit in
    MOE_BWD_SCRATCH_BYTES, else the most multiples of 128 that do (at least 128)."""
    if G * (2 * D + D * E + E) * 4 <= MOE_BWD_SCRATCH_BYTES:
        return D
    per_column = G * (2 + E) * 4
    return min(D, max(128, (MOE_BWD_SCRATCH_BYTES - G * E * 4) // per_column // 128 * 128))


def chosen(pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(expert, slot)`` of each row's routed choice from ``pos (..., E)``:
    expert -1 where the row takes no route."""
    hit = pos >= 0
    e = torch.where(hit.any(-1), hit.int().argmax(-1), torch.full_like(hit[..., 0], -1,
                                                                       dtype=torch.int64))
    p = pos.gather(-1, e.clamp_min(0)[..., None])[..., 0].long()
    return e, p


# ---------------------------------------------------------------- plain versions

def moe_dispatch_reference(cfg: MoEDispatchCfg, x, scale, bias, wr, br,
                           n_valid: Optional[int] = None, choices=None):
    """Plain PyTorch version of K11f: ``(xin, gates, pos1, pos2, probs, cnt,
    psum)`` in the compute dtype ``x.dtype`` (xin) and fp32.

    ``choices = (idx1, idx2)`` (T,) replaces the argmax routing with given
    experts (-1 for none): the routing a caller measured elsewhere, so
    that two runs which differ in the last bits of their logits can be
    compared on one routing."""
    Tp, D = x.shape
    E, gs, cap, cpad = cfg.num_experts, cfg.gs, cfg.cap, cfg.cpad
    G = Tp // gs
    dtype = x.dtype
    n_valid = Tp if n_valid is None else n_valid
    xhat, _ = ln_stats(x.float())
    yb = (xhat * scale.float() + bias.float()).to(dtype)
    logits = yb.float() @ wr.float() + br.float()
    ex = torch.exp(logits - logits.max(-1, keepdim=True).values)
    probs = ex / ex.sum(-1, keepdim=True)
    valid = torch.arange(Tp, device=x.device) < n_valid
    if choices is None:
        idx1 = probs.argmax(-1)
        idx2 = (probs.masked_fill(torch.nn.functional.one_hot(idx1, E).bool(), -torch.inf)
                .argmax(-1) if cfg.topk == 2 else None)
    else:
        idx1, idx2 = (c.to(x.device).long() for c in choices)
    p1v = probs.gather(-1, idx1.clamp_min(0)[:, None])[:, 0]
    if cfg.topk == 2:
        p2v = probs.gather(-1, idx2.clamp_min(0)[:, None])[:, 0]
        denom = p1v + p2v + 1e-9
        gates = torch.stack([p1v / denom, p2v / denom], -1)
    else:
        gates = torch.stack([p1v, torch.zeros_like(p1v)], -1)
    gates = torch.where(valid[:, None], gates, 0.0)
    idx1 = torch.where(valid & (idx1 >= 0), idx1, -1)

    def one_hot(idx):
        return (idx[:, None] == torch.arange(E, device=x.device)).view(G, gs, E).long()

    oh1 = one_hot(idx1)
    cnt1 = oh1.sum(1, keepdim=True)
    pos1 = torch.where(oh1 > 0, oh1.cumsum(1) - 1, -1)
    pos2 = torch.full_like(pos1, -1)
    if cfg.topk == 2:
        oh2 = one_hot(torch.where(valid & (idx2 >= 0), idx2, -1))
        pos2 = torch.where(oh2 > 0, oh2.cumsum(1) - 1 + cnt1, -1)
    pos1, pos2 = pos1.float(), pos2.float()

    xin = torch.zeros((E, G, cpad, D), dtype=dtype, device=x.device)
    rows = yb.view(G, gs, D)
    grp = torch.arange(G, device=x.device)[:, None].expand(G, gs)
    for pos in (pos1, pos2)[:cfg.topk]:
        e, p = chosen(pos)
        kept = (e >= 0) & (p < cap)
        xin[e[kept], grp[kept], p[kept]] = rows[kept]
    cnt = oh1.sum((0, 1)).float()
    psum = (probs * valid[:, None]).sum(0)
    return (xin.view(E, G * cpad, D), gates.view(G, gs, 2), pos1, pos2, probs.view(G, gs, E),
            cnt, psum)


def moe_dispatch_bwd_reference(cfg: MoEDispatchCfg, x, scale, bias, wr, pos1, pos2, probs,
                               dxin, dgates, dpsum, dres=None, n_valid: Optional[int] = None):
    """Plain PyTorch version of K11b: ``(dx, dscale, dbias, dwr, dbr)``
    following ``_dispatch_bwd_kernel`` (the residual cotangent ``dres``
    joins dx in fp32 for the ``_thru`` form)."""
    Tp, D = x.shape
    E, gs, cap, cpad = cfg.num_experts, cfg.gs, cfg.cap, cfg.cpad
    G = Tp // gs
    dtype = x.dtype
    n_valid = Tp if n_valid is None else n_valid
    xhat, inv = ln_stats(x.float())
    yb = (xhat * scale.float() + bias.float()).to(dtype).float()
    dslots = dxin.view(E, G, cpad, D).float()
    grp = torch.arange(G, device=x.device)[:, None].expand(G, gs)
    dyb = torch.zeros((G, gs, D), device=x.device)
    ohs = []
    for pos in (pos1, pos2)[:cfg.topk]:
        e, p = chosen(pos)
        kept = (e >= 0) & (p < cap)
        dyb[kept] = dyb[kept] + dslots[e[kept], grp[kept], p[kept]]
        ohs.append((pos >= 0).float().reshape(Tp, E))
    dyb = dyb.view(Tp, D)
    probs = probs.reshape(Tp, E)
    valid = (torch.arange(Tp, device=x.device) < n_valid).float()[:, None]
    dg = dgates.reshape(Tp, 2).float()
    dprobs = valid * dpsum.float()[None, :]
    if cfg.topk == 1:
        dprobs = dprobs + dg[:, :1] * ohs[0]
    else:
        oh1, oh2 = ohs
        p1v = (probs * oh1).sum(-1, keepdim=True)
        p2v = (probs * oh2).sum(-1, keepdim=True)
        s = p1v + p2v + 1e-9
        dg1, dg2 = dg[:, :1], dg[:, 1:]
        inv_s2 = 1.0 / (s * s)
        dp1 = (dg1 * (p2v + 1e-9) - dg2 * p2v) * inv_s2
        dp2 = (dg2 * (p1v + 1e-9) - dg1 * p1v) * inv_s2
        dprobs = dprobs + dp1 * oh1 + dp2 * oh2
    dlogits = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
    dwr = yb.t() @ dlogits
    dbr = dlogits.sum(0)
    dy = dyb + dlogits @ wr.float().t()
    res = torch.zeros((), device=x.device) if dres is None else dres.float()
    dx, dscale, dbias = layer_norm_bwd(dy, xhat, inv, scale, res)
    return dx.to(dtype), dscale, dbias, dwr, dbr


def _gather_choices(cfg, out, gates, pos1, pos2):
    """``[(kept, gate, fp32 slot row)]`` for each routed choice of the rows."""
    E, S, D = out.shape
    G = S // cfg.cpad
    outf = out.view(E, G, cfg.cpad, D).float()
    grp = torch.arange(G, device=out.device)[:, None].expand(G, cfg.gs)
    picks = []
    for k, pos in enumerate((pos1, pos2)[:cfg.topk]):
        e, p = chosen(pos)
        kept = (e >= 0) & (p < cfg.cap)
        rows = outf[e.clamp_min(0), grp, p.clamp(0, cfg.cpad - 1)]
        picks.append((kept, gates[..., k:k + 1].float(), rows, e, p))
    return picks


def moe_combine_reference(cfg: MoEDispatchCfg, out, gates, pos1, pos2, res=None):
    """Plain PyTorch version of K12f: ``(T, D)`` rows in ``out.dtype``."""
    dtype = out.dtype
    part = None
    for kept, g, rows, _, _ in _gather_choices(cfg, out, gates, pos1, pos2):
        term = torch.where(kept[..., None], g * rows, 0.0)
        part = term if part is None else part + term
    part = part.reshape(-1, out.shape[-1])
    if res is not None:
        return (part.to(dtype).float() + res.float()).to(dtype)
    return part.to(dtype)


def moe_combine_bwd_reference(cfg: MoEDispatchCfg, out, gates, pos1, pos2, dpart):
    """Plain PyTorch version of K12b: ``(dout, dgates)``; every slot row no
    token holds is zero."""
    E, S, D = out.shape
    G = S // cfg.cpad
    dy = dpart.reshape(G, cfg.gs, D).float()
    grp = torch.arange(G, device=out.device)[:, None].expand(G, cfg.gs)
    dout = torch.zeros((E, G, cfg.cpad, D), dtype=out.dtype, device=out.device)
    dgates = torch.zeros((G, cfg.gs, 2), device=out.device)
    for k, (kept, g, rows, e, p) in enumerate(_gather_choices(cfg, out, gates, pos1, pos2)):
        dgates[..., k] = torch.where(kept, (rows * dy).sum(-1), 0.0)
        dout[e[kept], grp[kept], p[kept]] = (g * dy)[kept].to(out.dtype)
    return dout.view(E, S, D), dgates


# ---------------------------------------------------------------- kernels

def _check_dispatch(cfg: MoEDispatchCfg, x, scale, bias, wr, br=None):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K11 takes bf16 rows, got {x.dtype}")
    Tp, D = x.shape
    E = cfg.num_experts
    if not moe_dispatch_ok(cfg.gs, E, cfg.cap, D, cfg.topk) or cfg.cpad % 8 or cfg.cpad < cfg.cap:
        raise ValueError(f"K11/K12 do not take gs={cfg.gs}, E={E}, cap={cfg.cap}, "
                         f"cpad={cfg.cpad}, D={D}, topk={cfg.topk} (see moe_dispatch_ok)")
    if Tp % cfg.gs:
        raise ValueError(f"K11 takes whole groups of {cfg.gs} rows, got T={Tp}")
    if wr.shape != (D, E) or scale.shape != (D,) or bias.shape != (D,) or \
            (br is not None and br.shape != (E,)):
        raise ValueError("K11 needs scale, bias (D,), wr (D, E) and br (E,)")
    if not x.is_contiguous():
        raise ValueError("K11 needs contiguous rows")


def _f32(t):
    return t.float().contiguous()


def _bf16(t):
    return t.to(torch.bfloat16).contiguous()


def _ptrs(*tensors):
    """``data_ptr()`` of each tensor (None stays None). The caller keeps the
    tensors bound until the launch: a converted copy freed earlier could
    hand its memory to the next copy before the kernel reads it."""
    return [None if t is None else t.data_ptr() for t in tensors]


def _k11f(cfg, x, scale, bias, wr, br, n_valid):
    Tp, D = x.shape
    E, gs = cfg.num_experts, cfg.gs
    G = Tp // gs
    dev = x.device
    params = (_f32(scale), _f32(bias), _f32(wr.t()), _f32(br))  # wr^T (E, D)
    xin = torch.empty((E, G * cfg.cpad, D), dtype=x.dtype, device=dev)
    gates = torch.empty((G, gs, 2), dtype=torch.float32, device=dev)
    pos1, pos2, probs = (torch.empty((G, gs, E), dtype=torch.float32, device=dev)
                         for _ in range(3))
    part = torch.empty((G, 2, E), dtype=torch.float32, device=dev)
    cnt_psum = torch.empty((2, E), dtype=torch.float32, device=dev)
    check_status(load_library().ddm_moe_dispatch_fwd(
        *_ptrs(x, *params, xin, gates, pos1, pos2, probs, part, cnt_psum), G, gs, n_valid, D,
        E, cfg.cap, cfg.cpad, cfg.topk, current_stream(dev)),
        f"moe_dispatch_fwd at gs={gs}, D={D}, E={E}")
    DISPATCH_LAUNCHES.add()
    return xin, gates, pos1, pos2, probs, cnt_psum[0].clone(), cnt_psum[1].clone()


def _k11b(cfg, x, scale, bias, wr, pos1, pos2, probs, dxin, dgates, dpsum, dres, n_valid):
    Tp, D = x.shape
    E, gs = cfg.num_experts, cfg.gs
    G = Tp // gs
    dev = x.device
    if dxin.shape != (E, G * cfg.cpad, D) or dgates.shape != (G, gs, 2) or \
            (dres is not None and dres.shape != x.shape):
        raise ValueError("K11b cotangents must match xin, gates and x")
    ins = (_f32(scale), _f32(bias), _f32(wr.t()), _f32(pos1), _f32(pos2), _f32(probs),
           _bf16(dxin), _f32(dgates), _f32(dpsum), None if dres is None else _bf16(dres))
    slab = _bwd_slab(G, D, E)
    width = 2 * slab + slab * E + E
    dx = torch.empty_like(x)
    dl = torch.empty((Tp, E), dtype=torch.float32, device=dev)  # the rows' dlogits
    part = torch.empty((G, width), dtype=torch.float32, device=dev)
    tmp = torch.empty((width,), dtype=torch.float32, device=dev) if slab < D else None
    sums = torch.empty((2 * D + D * E + E,), dtype=torch.float32, device=dev)
    check_status(load_library().ddm_moe_dispatch_bwd(
        *_ptrs(x, *ins, dx, dl, part, tmp, sums), G, gs, n_valid, D, E, cfg.cap, cfg.cpad,
        cfg.topk, slab, current_stream(dev)),
        f"moe_dispatch_bwd at gs={gs}, D={D}, E={E}")
    DISPATCH_BWD_LAUNCHES.add()
    return dx, sums[:D], sums[D:2 * D], sums[2 * D:2 * D + D * E].view(D, E), sums[2 * D + D * E:]


def _check_combine(cfg, out, gates, pos1, pos2, res):
    if out.dtype != torch.bfloat16 or (res is not None and res.dtype != torch.bfloat16):
        raise TypeError(f"K12 takes bf16 expert outputs and residual, got {out.dtype}")
    E, S, D = out.shape
    if E != cfg.num_experts or S % cfg.cpad or not moe_dispatch_ok(cfg.gs, E, cfg.cap, D,
                                                                     cfg.topk):
        raise ValueError(f"K12 does not take expert outputs {tuple(out.shape)} with {cfg}")
    G = S // cfg.cpad
    if gates.shape != (G, cfg.gs, 2) or pos1.shape != (G, cfg.gs, E) or pos2.shape != pos1.shape:
        raise ValueError("K12 routing tensors must be gates (G, gs, 2) and pos (G, gs, E)")
    if res is not None and res.shape != (G * cfg.gs, D):
        raise ValueError(f"K12 residual must be {(G * cfg.gs, D)}, got {tuple(res.shape)}")


def _k12f(cfg, out, gates, pos1, pos2, res):
    E, S, D = out.shape
    G = S // cfg.cpad
    ins = (out.contiguous(), _f32(gates), _f32(pos1), _f32(pos2),
           None if res is None else res.contiguous())
    tok = torch.empty((G * cfg.gs, D), dtype=out.dtype, device=out.device)
    check_status(load_library().ddm_moe_combine_fwd(
        *_ptrs(*ins, tok), G, cfg.gs, D, E, cfg.cap, cfg.cpad, cfg.topk,
        current_stream(out.device)), "moe_combine_fwd")
    COMBINE_LAUNCHES.add()
    return tok


def _k12b(cfg, out, gates, pos1, pos2, dpart):
    E, S, D = out.shape
    G = S // cfg.cpad
    if dpart.shape != (G * cfg.gs, D):
        raise ValueError(f"K12b cotangent must be {(G * cfg.gs, D)}, got {tuple(dpart.shape)}")
    ins = (out.contiguous(), _f32(gates), _f32(pos1), _f32(pos2), _bf16(dpart))
    dout = torch.empty((E, S, D), dtype=out.dtype, device=out.device)
    dgates = torch.empty((G, cfg.gs, 2), dtype=torch.float32, device=out.device)
    check_status(load_library().ddm_moe_combine_bwd(
        *_ptrs(*ins, dout, dgates), G, cfg.gs, D, E, cfg.cap, cfg.cpad, cfg.topk,
        current_stream(out.device)), f"moe_combine_bwd at E={E}")
    COMBINE_BWD_LAUNCHES.add()
    return dout, dgates


# ---------------------------------------------------------------- dispatch by device

def _einsum_path(cfg: MoEDispatchCfg, D: int) -> bool:
    """Where the JAX gate refuses K11/K12 and JAX runs its einsum path."""
    return not moe_dispatch_ok(cfg.gs, cfg.num_experts, cfg.cap, D, cfg.topk)


def moe_dispatch_fwd(cfg, x, scale, bias, wr, br, n_valid=None):
    """K11f on CUDA tensors (or raise), :func:`moe_dispatch_reference` on CPU
    and where the JAX gate runs no kernel: ``(xin, gates, pos1, pos2, probs,
    cnt, psum)``."""
    n_valid = x.shape[0] if n_valid is None else n_valid
    if not uses_kernel(x, scale, bias, wr, br) or _einsum_path(cfg, x.shape[1]):
        return moe_dispatch_reference(cfg, x, scale, bias, wr, br, n_valid)
    _check_dispatch(cfg, x, scale, bias, wr, br)
    return _k11f(cfg, x, scale, bias, wr, br, n_valid)


def moe_dispatch_bwd(cfg, x, scale, bias, wr, pos1, pos2, probs, dxin, dgates, dpsum,
                     dres=None, n_valid=None):
    """K11b on CUDA tensors (or raise), :func:`moe_dispatch_bwd_reference` on
    CPU and where the JAX gate runs no kernel: ``(dx, dscale, dbias, dwr,
    dbr)``."""
    n_valid = x.shape[0] if n_valid is None else n_valid
    if not uses_kernel(x, scale, bias, wr, dxin, dgates, dpsum) or \
            _einsum_path(cfg, x.shape[1]):
        return moe_dispatch_bwd_reference(cfg, x, scale, bias, wr, pos1, pos2, probs, dxin,
                                          dgates, dpsum, dres, n_valid)
    _check_dispatch(cfg, x, scale, bias, wr)
    return _k11b(cfg, x, scale, bias, wr, pos1, pos2, probs, dxin, dgates, dpsum, dres, n_valid)


def moe_combine_fwd(cfg, out, gates, pos1, pos2, res=None):
    """K12f on CUDA tensors (or raise), :func:`moe_combine_reference` on CPU
    and where the JAX gate runs no kernel."""
    if not uses_kernel(out, gates, pos1, pos2) or _einsum_path(cfg, out.shape[-1]):
        return moe_combine_reference(cfg, out, gates, pos1, pos2, res)
    _check_combine(cfg, out, gates, pos1, pos2, res)
    return _k12f(cfg, out, gates, pos1, pos2, res)


def moe_combine_bwd(cfg, out, gates, pos1, pos2, dpart):
    """K12b on CUDA tensors (or raise), :func:`moe_combine_bwd_reference` on
    CPU and where the JAX gate runs no kernel: ``(dout, dgates)``."""
    if not uses_kernel(out, gates, pos1, pos2, dpart) or \
            _einsum_path(cfg, out.shape[-1]):
        return moe_combine_bwd_reference(cfg, out, gates, pos1, pos2, dpart)
    _check_combine(cfg, out, gates, pos1, pos2, None)
    return _k12b(cfg, out, gates, pos1, pos2, dpart)


# ---------------------------------------------------------------- autograd

class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, n_valid, thru, x, scale, bias, wr, br):
        xin, gates, pos1, pos2, probs, cnt, psum = moe_dispatch_fwd(
            cfg, x, scale, bias, wr, br, n_valid)
        ctx.cfg, ctx.n_valid = cfg, n_valid
        ctx.save_for_backward(x, scale, bias, wr, br, pos1, pos2, probs)
        ctx.mark_non_differentiable(pos1, pos2, cnt)
        return (xin, gates, pos1, pos2, cnt, psum) + ((x,) if thru else ())

    @staticmethod
    def backward(ctx, dxin, dgates, _dp1, _dp2, _dcnt, dpsum, dthru=None):
        x, scale, bias, wr, br, pos1, pos2, probs = ctx.saved_tensors
        cfg = ctx.cfg
        if dxin is None:
            dxin = torch.zeros((cfg.num_experts, probs.shape[0] * cfg.cpad, x.shape[1]),
                               dtype=x.dtype, device=x.device)
        if dgates is None:
            dgates = torch.zeros(probs.shape[:2] + (2,), device=x.device)
        if dpsum is None:
            dpsum = torch.zeros((cfg.num_experts,), device=x.device)
        dx, ds, db, dwr, dbr = moe_dispatch_bwd(
            cfg, x, scale, bias, wr, pos1, pos2, probs, dxin.contiguous(), dgates, dpsum,
            dthru, ctx.n_valid)
        return (None, None, None, dx.to(x.dtype), ds.to(scale.dtype), db.to(bias.dtype),
                dwr.to(wr.dtype), dbr.to(br.dtype))


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, out, gates, pos1, pos2, res):
        ctx.cfg, ctx.has_res = cfg, res is not None
        ctx.save_for_backward(out, gates, pos1, pos2)
        return moe_combine_fwd(cfg, out, gates, pos1, pos2, res)

    @staticmethod
    def backward(ctx, dpart):
        out, gates, pos1, pos2 = ctx.saved_tensors
        dout, dgates = moe_combine_bwd(ctx.cfg, out, gates, pos1, pos2, dpart.contiguous())
        # the residual enters through an fp32 add and leaves through the
        # rounding: its cotangent is dpart itself
        return None, dout, dgates.to(gates.dtype), None, None, dpart if ctx.has_res else None


def moe_dispatch(cfg: MoEDispatchCfg, x, scale, bias, wr, br, n_valid: Optional[int] = None):
    """Fused LN2 + router + top-k capacity dispatch with its backward:
    ``(xin, gates, pos1, pos2, cnt, psum)``. ``pos*`` and ``cnt`` carry no
    gradient; ``gates`` and ``psum`` reach the router's parameters."""
    return _Dispatch.apply(cfg, n_valid, False, x, scale, bias, wr, br)


def moe_dispatch_thru(cfg: MoEDispatchCfg, x, scale, bias, wr, br,
                      n_valid: Optional[int] = None):
    """:func:`moe_dispatch` plus ``x`` itself as a seventh output, for a
    caller whose residual stream is the dispatch input: the pass-through's
    cotangent joins ``dx`` inside the backward kernel, in fp32."""
    return _Dispatch.apply(cfg, n_valid, True, x, scale, bias, wr, br)


def moe_combine(cfg: MoEDispatchCfg, out, gates, pos1, pos2):
    """Gate-scaled combine: expert outputs ``(E, G*Cp, D)`` -> token rows
    ``(T, D)`` in the compute dtype."""
    return _Combine.apply(cfg, out, gates, pos1, pos2, None)


def moe_combine_res(cfg: MoEDispatchCfg, out, gates, pos1, pos2, res):
    """:func:`moe_combine` with the block's residual: ``(fp32(res) +
    fp32(combine rounded to the compute dtype))`` rounded; the residual's
    cotangent is the output's."""
    return _Combine.apply(cfg, out, gates, pos1, pos2, res)
