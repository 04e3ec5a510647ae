"""JAX param tree <-> the port's ``state_dict`` (the reference checkpoint layout).

Reimplements the DiT mapping of ``ddm_tpu.utils.convert.
reference_state_dict_from_dit`` without importing the JAX package:

  * flax ``Dense`` kernels are ``(in, out)``; ``nn.Linear`` weights are
    ``(out, in)`` -> transpose;
  * the patch kernel's rows are token features ``(ph, pw, c)``; the conv
    weight is ``(D, c, ph, pw)``;
  * the unembed columns are ``(ph, pw, c)``; the reference rows ``(c, ph, pw)``;
  * LayerNorm ``scale`` -> ``weight``;
  * a tp>1 tree's separate q/k/v projections re-fuse into one qkv weight
    (rows ``[q | k | v]``, heads contiguous). The port's tensor-parallel
    model keeps this one fused key (the reference checkpoint's) and splits
    it by rows into q, k and v, and a rank's shard into each third's heads
    (:mod:`ddm_tpu_torch.parallel.sharding`), so one ``state_dict`` loads
    into the replicated and the tensor-parallel model alike;
    :func:`jax_tree_from_state_dict` with ``tp > 1`` gives JAX's three
    ``attn/{q,k,v}`` projections back;
  * an MoE block's ``moe`` leaves (``block_i/moe/{router_kernel,
    router_bias, experts_in, experts_in_bias, experts_out,
    experts_out_bias}``) take the port's own keys, since the reference
    checkpoint has no MoE: ``blocks.{i}.moe.router.weight`` (E, D) in
    ``nn.Linear``'s layout (the transposed ``router_kernel``),
    ``blocks.{i}.moe.router.bias`` and ``blocks.{i}.moe.experts_*`` in
    the JAX layout; ``norm2`` stays the block's own.

A JAX-trained ``.ckpt`` reaches the port without flax through
``python scripts/convert_reference_ckpt.py --to-torch run/model_final.ckpt
model.pt``, which writes the same ``{"model", "config"}`` payload that
:func:`ddm_tpu_torch.utils.checkpoint.load_params` reads. That script
predates the port and maps no MoE leaves: a JAX-trained MoE ``.ckpt`` needs
the msgpack reader of ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "jax_tree_from_state_dict"]


_EXPERT_LEAVES = ("experts_in", "experts_in_bias", "experts_out", "experts_out_bias")


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def state_dict_from_jax(
    variables: Mapping[str, Any],
    patch_size: int,
    in_channels: int = 6,
    out_channels: int = 3,
) -> Dict[str, torch.Tensor]:
    """ddm_tpu ``DDDMDiT`` variables (numpy leaves) -> the port's state_dict."""
    p = variables["params"]
    ps, ci, co = patch_size, in_channels, out_channels
    d = _np(p["patch_proj"]["kernel"]).shape[-1]

    def dense(tree, key):
        return {f"{key}.weight": _np(tree["kernel"]).T, f"{key}.bias": _np(tree["bias"])}

    def ln(tree, key):
        return {f"{key}.weight": _np(tree["scale"]), f"{key}.bias": _np(tree["bias"])}

    sd: Dict[str, np.ndarray] = {
        "patch_embed.proj.weight": _np(p["patch_proj"]["kernel"])
        .reshape(ps, ps, ci, d).transpose(3, 2, 0, 1),
        "patch_embed.proj.bias": _np(p["patch_proj"]["bias"]),
        "pos_embed": _np(p["pos_embed"]),
        **dense(p["time_mlp_0"], "time_mlp.0"),
        **dense(p["time_mlp_1"], "time_mlp.2"),
        **ln(p["final_norm"], "norm"),
        "unembed.proj.weight": _np(p["unembed"]["kernel"])
        .reshape(d, ps, ps, co).transpose(3, 1, 2, 0).reshape(co * ps * ps, d),
        "unembed.proj.bias": _np(p["unembed"]["bias"])
        .reshape(ps, ps, co).transpose(2, 0, 1).reshape(-1),
    }

    i = 0
    while f"block_{i}" in p:
        b, rb = p[f"block_{i}"], f"blocks.{i}"
        attn = b["attn"]
        if "qkv" in attn:
            sd.update(dense(attn["qkv"], f"{rb}.attn.qkv"))
        else:  # tp>1 canonical tree: separate column-parallel q/k/v
            sd[f"{rb}.attn.qkv.weight"] = np.concatenate(
                [_np(attn[k]["kernel"]).T for k in ("q", "k", "v")], axis=0)
            sd[f"{rb}.attn.qkv.bias"] = np.concatenate(
                [_np(attn[k]["bias"]) for k in ("q", "k", "v")], axis=0)
        sd.update(dense(attn["proj"], f"{rb}.attn.proj"))
        sd.update(ln(b["norm1"], f"{rb}.norm1"))
        sd.update(ln(b["norm2"], f"{rb}.norm2"))
        if "moe" in b:
            moe = b["moe"]
            sd[f"{rb}.moe.router.weight"] = _np(moe["router_kernel"]).T
            sd[f"{rb}.moe.router.bias"] = _np(moe["router_bias"])
            for key in _EXPERT_LEAVES:
                sd[f"{rb}.moe.{key}"] = _np(moe[key])
        else:
            sd.update(dense(b["ff_in"], f"{rb}.ff.net.0"))
            sd.update(dense(b["ff_out"], f"{rb}.ff.net.2"))
        i += 1
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def jax_tree_from_state_dict(
    tensors: Mapping[str, Any],
    patch_size: int,
    in_channels: int = 6,
    out_channels: int = 3,
    tp: int = 1,
) -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_jax`: the port's ``{name:
    array}`` (parameters or their gradients, as numpy or tensors) ->
    ``{"params": ...}`` in ``ddm_tpu``'s layout, as numpy fp32: the fused
    ``attn/qkv`` tree, or with ``tp > 1`` (a tensor-parallel model's full
    ``state_dict``) the separate ``attn/{q,k,v}`` of JAX's tp>1 tree. Pure
    numpy, so ``jax.grad``'s tree and the port's ``.grad`` compare leaf by
    leaf."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else _np(v))
          for k, v in tensors.items()}
    ps, ci, co = patch_size, in_channels, out_channels
    w_patch = _np(sd["patch_embed.proj.weight"])
    d = w_patch.shape[0]

    def dense(key):
        return {"kernel": _np(sd[f"{key}.weight"]).T.copy(), "bias": _np(sd[f"{key}.bias"])}

    def ln(key):
        return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}

    p: Dict[str, Any] = {
        "patch_proj": {"kernel": w_patch.transpose(2, 3, 1, 0).reshape(ps * ps * ci, d).copy(),
                       "bias": _np(sd["patch_embed.proj.bias"])},
        "pos_embed": _np(sd["pos_embed"]),
        "time_mlp_0": dense("time_mlp.0"),
        "time_mlp_1": dense("time_mlp.2"),
        "final_norm": ln("norm"),
        "unembed": {
            "kernel": _np(sd["unembed.proj.weight"]).reshape(co, ps, ps, d)
            .transpose(3, 1, 2, 0).reshape(d, ps * ps * co).copy(),
            "bias": _np(sd["unembed.proj.bias"]).reshape(co, ps, ps)
            .transpose(1, 2, 0).reshape(-1).copy(),
        },
    }
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        rb = f"blocks.{i}"
        qkv = dense(f"{rb}.attn.qkv")
        if tp > 1:  # JAX's column-parallel q, k and v: the thirds of [q | k | v]
            w, b = np.split(qkv["kernel"], 3, axis=1), np.split(qkv["bias"], 3)
            attn = {n: {"kernel": w[i].copy(), "bias": b[i].copy()}
                    for i, n in enumerate(("q", "k", "v"))}
        else:
            attn = {"qkv": qkv}
        block = {
            "attn": {**attn, "proj": dense(f"{rb}.attn.proj")},
            "norm1": ln(f"{rb}.norm1"),
            "norm2": ln(f"{rb}.norm2"),
        }
        if f"{rb}.moe.router.weight" in sd:
            block["moe"] = {"router_kernel": _np(sd[f"{rb}.moe.router.weight"]).T.copy(),
                            "router_bias": _np(sd[f"{rb}.moe.router.bias"]),
                            **{k: _np(sd[f"{rb}.moe.{k}"]) for k in _EXPERT_LEAVES}}
        else:
            block["ff_in"] = dense(f"{rb}.ff.net.0")
            block["ff_out"] = dense(f"{rb}.ff.net.2")
        p[f"block_{i}"] = block
        i += 1
    return {"params": p}
