"""DiT distributional denoiser for images (PyTorch port, replicated path).

Port of ``ddm_tpu/models/dit.py`` as ``ddm_tpu.models.factory.build_model``
builds it: NHWC images, xi-conditioning by channel concatenation, additive
sinusoidal time embedding (no AdaLN), pre-LN blocks, learned positional
embedding, final LayerNorm and unembedding. Each block is two fused ops:
:func:`~ddm_tpu_torch.ops.attention.fused_attention_block` then
:func:`~ddm_tpu_torch.ops.mlp_block.fused_mlp_block` over (B*N, D) rows,
which launch kernels K2 (or the third rung's K7 or K8) and K1 on CUDA
tensors. ``attention="xla"`` (the JAX model's ``attention_impl='xla'``)
unfuses the attention half: fp32 LN, the qkv and projection Dense
products in the compute dtype with their biases, the plain attention
core, the residual added in the stream dtype, as ``MultiheadSelfAttention``
(``ddm_tpu/models/dit.py:89-125``) computes it; the MLP half stays fused
and the parameters are the same. ``"flash"`` is ``"auto"``, as in the JAX
model (``dit.py:357``). ``fast_gelu`` (the JAX package's
``DDM_TPU_FAST_GELU=1``) takes ``h sigmoid(1.702 h)`` in place of the
exact-erf GELU in every MLP half-block, dense, mixture-of-experts or
tensor-parallel, through the kernels and the plain versions alike. With
``moe_experts > 1`` the MLP half is :class:`~ddm_tpu_torch.models.moe.MoEMLP` (kernels K11,
K10, K12), with ``norm2`` still owned by the block
(``ddm_tpu/models/dit.py:297-324``), and :meth:`DDDMDiT.tokens_and_aux`
hands each block's Switch aux term to the training step.

With ``tp > 1`` every block is the JAX model's tensor-parallel block
(``DiTBlock._tp_call`` and ``_TPAttention``, ``ddm_tpu/models/dit.py:181-249``
and ``:402-494``, without sequence parallelism), in Megatron's layout: fp32
LN1 rounded to the compute dtype; f; q, k and v as three compute-dtype
products with their biases (the rows of the fused ``attn.qkv`` weight,
``[q | k | v]``); :func:`~ddm_tpu_torch.ops.attention.fused_attention` on
the rank's heads (K7, K8 or the plain core); the projection in fp32; g;
``(x + out + bproj)`` rounded once. The MLP half is f on the rows and the
LN2 parameters,
:func:`~ddm_tpu_torch.ops.mlp_block.fused_mlp_partial` (K6f, K6b) on the
rank's hidden shard, g, then ``(x + part + b2)`` rounded once. Given a
process group (``tp_group``), a block holds only its shard: whole heads of
q, k and v, rows of ``ff_in``, columns of ``proj`` and ``ff_out``
(:mod:`ddm_tpu_torch.parallel.sharding`); with none it holds the full
weights and runs the same code with no collective, the replicated instance
that sampling uses (JAX's ``tp_axis=None``).

Parameters carry the reference checkpoint's ``state_dict`` names and
layouts (``patch_embed.proj.weight`` (D, C, p, p), ``blocks.{i}.attn.qkv.*``,
``blocks.{i}.ff.net.0.*``, ``norm.*``, ``unembed.proj.*``), so a reference
``.pt`` payload loads with ``load_state_dict``. The patch embed is applied
as a matmul over :func:`patchify_images` tokens (cuDNN convolutions default
to TF32) and the unembed rows are permuted from the reference's (c, ph, pw)
order to the token order (ph, pw, c).

dtype plan (the JAX module's): inputs concatenated then cast to the compute
dtype; ``patch_proj``, ``time_mlp`` and ``unembed`` are compute-dtype
products; ``h + temb + pos_embed`` is summed in the compute dtype in that
order; the final LayerNorm is fp32 with eps 1e-6; the output is fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.attention import attention_reference, fused_attention, fused_attention_block
from ..ops.mlp_block import fused_mlp_block, fused_mlp_partial, layer_norm, matmul_f32
from ..parallel.tp import tp_region_enter, tp_region_exit
from .moe import MoEMLP

__all__ = [
    "sinusoidal_time_embedding",
    "patchify_images",
    "DiTBlock",
    "DDDMDiT",
    "init_params",
]


def patchify_images(x: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC images -> ``(B, N, p*p*C)`` patch tokens, features (ph, pw, c)."""
    B, H, W, C = x.shape
    gh, gw = H // patch, W // patch
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def sinusoidal_time_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """``[sin(t f), cos(t f)]`` with geometric frequencies; odd ``dim`` is
    zero-padded by one."""
    t = t.reshape(-1)
    half = dim // 2
    exponent = (-math.log(max_period)
                * torch.arange(half, dtype=t.dtype, device=t.device) / max(half - 1, 1))
    args = t[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = nn.functional.pad(emb, (0, 1))
    return emb


def _linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """Compute-dtype ``x W^T + b`` (the product rounded, then the bias added
    in the compute dtype, as flax's Dense with a bf16 dtype)."""
    return torch.matmul(x.to(dtype), weight.to(dtype).t()) + bias.to(dtype)


def _dense(x: torch.Tensor, p: "_Affine", dtype: torch.dtype) -> torch.Tensor:
    return _linear(x, p.weight, p.bias, dtype)


class _Affine(nn.Module):
    """A ``weight`` and a ``bias`` in the reference layout; the caller
    applies them. Parameters start uninitialised (see :func:`init_params`)."""

    def __init__(self, weight_shape, bias_shape, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight_shape, device=device))
        self.bias = nn.Parameter(torch.empty(bias_shape, device=device))


class _Attn(nn.Module):
    """``qkv`` and ``proj``; ``width`` is the q, k, v width a rank holds."""

    def __init__(self, dim: int, device=None, width: Optional[int] = None):
        super().__init__()
        width = dim if width is None else width
        self.qkv = _Affine((3 * width, dim), (3 * width,), device)
        self.proj = _Affine((dim, width), (dim,), device)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        # keys net.0 / net.2 as the reference's Sequential(Linear, GELU, Linear)
        self.net = nn.ModuleDict({
            "0": _Affine((hidden, dim), (hidden,), device),
            "2": _Affine((dim, hidden), (dim,), device),
        })


ATTENTION_IMPLS = ("auto", "xla", "flash")


class DiTBlock(nn.Module):
    """Pre-LN block: the attention half-block (fused, or with ``attention=
    "xla"`` the unfused one) then the MLP half-block, dense or (``moe``
    given: ``num_experts``, ``capacity``, ``group_size``, ``topk``)
    mixture-of-experts; with ``tp > 1`` the tensor-parallel block, holding
    the shard of ``tp_group``'s rank (the full weights with no group)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, device=None,
                 moe: Optional[dict] = None, attention: str = "auto", tp: int = 1,
                 tp_group=None, fast_gelu: bool = False):
        super().__init__()
        if dim % num_heads:
            raise ValueError("dim must be divisible by num_heads")
        if attention not in ATTENTION_IMPLS:
            raise ValueError(f"attention must be one of {ATTENTION_IMPLS}, got {attention!r}")
        self.num_heads = num_heads
        self.attention = attention
        self.tp, self.tp_group = tp, tp_group
        self.fast_gelu = fast_gelu
        shards = tp if tp_group is not None else 1
        hidden = int(dim * mlp_ratio)
        self.norm1 = _Affine((dim,), (dim,), device)
        self.attn = _Attn(dim, device, dim // shards)
        self.norm2 = _Affine((dim,), (dim,), device)
        if moe:
            self.moe = MoEMLP(dim, hidden, device=device, fast_gelu=fast_gelu, **moe)
        else:
            self.ff = _FeedForward(dim, hidden // shards, device)

    def _unfused_attention(self, x: torch.Tensor) -> torch.Tensor:
        D, dt = x.shape[-1], x.dtype
        h = layer_norm(x.float(), self.norm1.weight, self.norm1.bias).to(dt)
        q, k, v = _dense(h, self.attn.qkv, dt).split(D, dim=-1)
        return x + _dense(attention_reference(q, k, v, self.num_heads), self.attn.proj, dt)

    def _tp_attention(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``_TPAttention``: column-parallel q, k, v on the rank's heads, the
        core, the row-parallel projection in fp32, g, the bias and the
        residual added once."""
        group, dt = self.tp_group, x.dtype
        heads = self.num_heads // (self.tp if group is not None else 1)
        if group is not None:
            h = tp_region_enter(h, group)
        w, b = self.attn.qkv.weight, self.attn.qkv.bias
        width = w.shape[0] // 3
        q, k, v = (_linear(h, w[i * width:(i + 1) * width], b[i * width:(i + 1) * width], dt)
                   for i in range(3))
        core = attention_reference if self.attention == "xla" else fused_attention
        out = matmul_f32(core(q, k, v, heads), self.attn.proj.weight, dt)
        if group is not None:
            out = tp_region_exit(out, group)
        return (x.float() + out + self.attn.proj.bias.float()).to(dt)

    def _tp_forward(self, x: torch.Tensor) -> torch.Tensor:
        """``DiTBlock._tp_call`` without sequence parallelism."""
        B, N, D = x.shape
        group = self.tp_group
        h = layer_norm(x.float(), self.norm1.weight, self.norm1.bias).to(x.dtype)
        x = self._tp_attention(h, x)
        rows = x.reshape(B * N, D)
        rows_in, s2, b2 = rows, self.norm2.weight, self.norm2.bias
        if group is not None:
            # the LayerNorm runs inside the partial on every rank: its input
            # and parameters get partial cotangents that f sums
            rows_in, s2, b2 = (tp_region_enter(t, group) for t in (rows, s2, b2))
        ff_in, ff_out = self.ff.net["0"], self.ff.net["2"]
        part = fused_mlp_partial(rows_in, s2, b2, ff_in.weight, ff_in.bias, ff_out.weight,
                                 self.fast_gelu)
        if group is not None:
            part = tp_region_exit(part, group)
        return (rows.float() + part + ff_out.bias.float()).to(x.dtype).reshape(B, N, D)

    def forward(self, x: torch.Tensor):
        """``(x, aux)``: the block's output and its MoE aux term (None for a
        dense block)."""
        if self.tp > 1:
            return self._tp_forward(x), None
        B, N, D = x.shape
        if self.attention == "xla":
            x = self._unfused_attention(x)
        else:
            x = fused_attention_block(
                x, self.norm1.weight, self.norm1.bias, self.attn.qkv.weight,
                self.attn.qkv.bias, self.attn.proj.weight, self.attn.proj.bias,
                self.num_heads,
            )
        if hasattr(self, "moe"):
            out, aux = self.moe(x.reshape(B * N, D), self.norm2.weight, self.norm2.bias)
            return out.reshape(B, N, D), aux
        ff_in, ff_out = self.ff.net["0"], self.ff.net["2"]
        out = fused_mlp_block(
            x.reshape(B * N, D), self.norm2.weight, self.norm2.bias,
            ff_in.weight, ff_in.bias, ff_out.weight, ff_out.bias, self.fast_gelu,
        )
        return out.reshape(B, N, D), None


class DDDMDiT(nn.Module):
    """Distributional diffusion denoiser with a DiT backbone, NHWC images.

    ``model(xt, t, xi) -> x0_hat`` with ``xt``/``xi`` of identical shape
    ``(B, H, W, C)`` and ``t`` of shape ``[B]``. ``in_channels`` counts the
    concatenated [xt, xi] input. Defaults are DiT-S/4 on 32x32 images.
    ``tp > 1`` selects the tensor-parallel blocks; ``tp_group``, a process
    group of ``tp`` ranks, makes this instance one rank's shard (None: the
    full weights, no collective). ``fast_gelu`` selects the sigmoid GELU in
    every MLP half-block.
    """

    def __init__(
        self,
        img_size: int = 32,
        patch_size: int = 4,
        in_channels: int = 6,
        out_channels: int = 3,
        embed_dim: int = 384,
        depth: int = 8,
        num_heads: int = 6,
        time_embed_dim: int = 256,
        mlp_ratio: float = 4.0,
        dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
        moe_experts: int = 0,
        moe_capacity: float = 1.25,
        moe_group_size: int = 0,
        moe_topk: int = 1,
        attention: str = "auto",
        tp: int = 1,
        tp_group=None,
        fast_gelu: bool = False,
    ):
        super().__init__()
        if img_size % patch_size:
            raise ValueError("Image size must be divisible by patch size")
        hidden = int(embed_dim * mlp_ratio)
        if tp > 1 and (embed_dim % tp or num_heads % tp or hidden % tp):
            raise ValueError("tp must divide embed_dim, num_heads, and the MLP hidden size (got "
                             f"tp={tp}, dim={embed_dim}, heads={num_heads}, hidden={hidden})")
        if tp > 1 and moe_experts > 1:
            raise NotImplementedError("the PyTorch port does not support tp > 1 with moe_experts "
                                      "> 1 (expert parallelism) yet: ROADMAP.md Queue 1 item 11")
        if tp_group is not None and torch.distributed.get_world_size(tp_group) != tp:
            raise ValueError(f"tp={tp} but the model group has "
                             f"{torch.distributed.get_world_size(tp_group)} ranks")
        self.tp, self.tp_group = tp, tp_group
        self.img_size, self.patch_size = img_size, patch_size
        self.in_channels, self.out_channels = in_channels, out_channels
        self.embed_dim, self.time_embed_dim = embed_dim, time_embed_dim
        self.dtype = dtype
        self.moe_experts = moe_experts
        self.fast_gelu = fast_gelu
        self.num_patches = (img_size // patch_size) ** 2
        D, p = embed_dim, patch_size
        self.patch_embed = nn.ModuleDict(
            {"proj": _Affine((D, in_channels, p, p), (D,), device)})
        self.pos_embed = nn.Parameter(torch.empty((1, self.num_patches, D), device=device))
        self.time_mlp = nn.ModuleDict({
            "0": _Affine((D, time_embed_dim), (D,), device),
            "2": _Affine((D, D), (D,), device),
        })
        moe = (dict(num_experts=moe_experts, capacity=moe_capacity, group_size=moe_group_size,
                    topk=moe_topk) if moe_experts > 1 else None)
        self.blocks = nn.ModuleList(
            [DiTBlock(D, num_heads, mlp_ratio, device, moe, attention, tp, tp_group, fast_gelu)
             for _ in range(depth)])
        self.norm = _Affine((D,), (D,), device)
        self.unembed = nn.ModuleDict(
            {"proj": _Affine((out_channels * p * p, D), (out_channels * p * p,), device)})

    def _patch_weight(self) -> torch.Tensor:
        """Conv weight (D, C, p, p) -> (D, p*p*C) over (ph, pw, c) features."""
        w = self.patch_embed["proj"].weight
        return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)

    def embed_tokens(self, xt: torch.Tensor, t: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        """``(xt, t, xi) -> (B, N, D)`` tokens in the compute dtype."""
        if xt.shape != xi.shape:
            raise ValueError("xt and xi must have the same shape")
        if xt.dim() != 4:
            raise ValueError("Expecting image tensors of rank 4")
        dt = self.dtype
        x = torch.cat([xt, xi], dim=-1).to(dt)
        proj = self.patch_embed["proj"]
        h = torch.matmul(patchify_images(x, self.patch_size), self._patch_weight().to(dt).t())
        h = h + proj.bias.to(dt)
        temb = sinusoidal_time_embedding(t.reshape(-1).float(), self.time_embed_dim).to(dt)
        temb = _dense(nn.functional.silu(_dense(temb, self.time_mlp["0"], dt)),
                      self.time_mlp["2"], dt)
        return h + temb[:, None, :] + self.pos_embed.to(dt)

    def head_tokens(self, h: torch.Tensor) -> torch.Tensor:
        """``(B, N, D) -> (B, N, p*p*C_out)`` fp32 tokens, features (ph, pw, c)."""
        h = layer_norm(h.float(), self.norm.weight, self.norm.bias).to(self.dtype)
        u, p, c = self.unembed["proj"], self.patch_size, self.out_channels
        D = u.weight.shape[1]
        w = u.weight.reshape(c, p, p, D).permute(1, 2, 0, 3).reshape(p * p * c, D)
        b = u.bias.reshape(c, p, p).permute(1, 2, 0).reshape(-1)
        out = torch.matmul(h, w.to(self.dtype).t()) + b.to(self.dtype)
        return out.float()

    def tokens_and_aux(self, xt: torch.Tensor, t: torch.Tensor, xi: torch.Tensor):
        """``(tokens, aux_terms)``: :meth:`tokens` and the list of the MoE
        blocks' Switch aux terms (empty for a dense model), the port's
        counterpart of flax's sown ``"losses"`` collection."""
        h = self.embed_tokens(xt, t, xi)
        terms = []
        for block in self.blocks:
            h, aux = block(h)
            if aux is not None:
                terms.append(aux)
        return self.head_tokens(h), terms

    def tokens(self, xt: torch.Tensor, t: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        """Denoiser output as patch tokens, ``__call__`` minus the unpatchify."""
        return self.tokens_and_aux(xt, t, xi)[0]

    def _unpatchify(self, tokens: torch.Tensor) -> torch.Tensor:
        B, N, _ = tokens.shape
        p, g = self.patch_size, self.img_size // self.patch_size
        if N != g * g:
            raise ValueError("Token count does not match image dimensions")
        x = tokens.reshape(B, g, g, p, p, self.out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, self.img_size, self.img_size, self.out_channels)

    def forward(self, xt: torch.Tensor, t: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        return self._unpatchify(self.tokens(xt, t, xi))


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # flax's lecun_normal: truncated normal (+-2 sd) with variance 1 / fan_in,
    # drawn as jax.random.truncated_normal draws it: the inverse normal CDF of
    # one uniform draw between the bounds' CDF values (nn.init.trunc_normal_
    # redraws its rejects over the whole tensor, minutes for DiT-XL's experts)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = math.erf(-2.0 / math.sqrt(2.0))
    w.uniform_(lo, -lo, generator=generator).erfinv_().mul_(std * math.sqrt(2.0))
    w.clamp_(-2 * std, 2 * std)


@torch.no_grad()
def init_params(model: DDDMDiT, generator: torch.Generator) -> DDDMDiT:
    """Fill every parameter from ``generator`` with the JAX package's
    initialisers: lecun-normal weights, zero biases, unit LayerNorm scales,
    truncated-normal (0.02) positional embedding. A 3-D expert weight
    ``(E, fan_in, fan_out)`` takes flax's fan-in for it, ``E * fan_in``
    (``ddm_tpu/models/moe.py:229-240``). Values are drawn on the CPU
    (``generator`` is a CPU generator) and copied to the parameters'
    device, so a seed gives the same weights on every device."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = name.rsplit(".", 2)[-2] if "." in name else ""
        v = torch.empty(p.shape)
        if name == "pos_embed":
            nn.init.trunc_normal_(v, std=0.02, a=-0.04, b=0.04, generator=generator)
        elif owner.startswith("norm"):
            v.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias" or leaf.endswith("_bias"):
            v.zero_()
        elif leaf.startswith("experts_"):
            _lecun_normal_(v, v.shape[0] * v.shape[1], generator)
        else:
            _lecun_normal_(v, v[0].numel(), generator)
        p.copy_(v)
    return model
