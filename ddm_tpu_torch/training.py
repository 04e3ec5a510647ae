"""DDDM training core in PyTorch: the loss step, global-norm clip and AdamW.

Port of ``ddm_tpu/training.py`` (``distributional_training_step``,
``make_loss_fn``, ``make_train_step``) and of the optimizer chain of
``train_cifar10_dit.py`` (``optax.chain(clip_by_global_norm, adamw)``):

* :func:`distributional_training_step` draws ``t ~ U[0, 1]``, ``eps`` and
  the m latents ``xi`` (from an explicit generator, or injected), forms the
  forward marginal ``x_t``, runs ONE batched denoiser call on ``B * m``
  rows, and combines the energy-score terms (kernel K3 on CUDA tensors)
  with the batch-mean logistic weight: ``loss = w (conf - lam / (2 (m-1))
  inter)``, metric keys {loss, confidence, interaction, weight}; an
  ``apply_fn`` that returns ``(x0hat, aux)`` (an MoE model's weighted
  Switch loss) adds ``aux`` to the loss and reports it as ``moe_aux``;
* :func:`clip_grads_by_global_norm_` follows optax's rule, not
  ``torch.nn.utils.clip_grad_norm_``: gradients are left alone when
  ``norm < max_norm`` and become ``g / norm * max_norm`` otherwise;
* :func:`make_optimizer` is ``torch.optim.AdamW`` with optax's ``adamw``
  defaults over every parameter (no mask);
* :func:`make_train_step` builds the one-device step of
  ``ddm_tpu/parallel/data_parallel.py``: split the step's generator, run
  ``preprocess`` (augmentation) on the first part, the loss on the second,
  ``backward()``, the clip, ``optimizer.step()``. The step updates the
  model in place and returns the metrics as device scalars (no host sync).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from .ops.energy import fused_energy_terms
from .ops.losses import sigmoid_weight
from .ops.schedules import forward_marginal_sample

__all__ = [
    "distributional_training_step",
    "make_loss_fn",
    "clip_grads_by_global_norm_",
    "make_optimizer",
    "make_train_step",
    "split_generator",
]

Apply = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def split_generator(generator: torch.Generator, n: int,
                    device: torch.device | str = "cpu") -> List[torch.Generator]:
    """``n`` new generators on ``device``, seeded from 63-bit draws of
    ``generator`` (a CPU generator, so no device sync): the counterpart of
    ``jax.random.split``."""
    seeds = torch.randint(0, 2 ** 63 - 1, (n,), generator=generator, dtype=torch.int64)
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def distributional_training_step(
    apply_fn: Apply,
    x0: torch.Tensor,
    *,
    m: int,
    beta: float,
    lam: float,
    w_bias: float,
    generator: Optional[torch.Generator] = None,
    t: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
    xi: Optional[torch.Tensor] = None,
    target_transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Metrics]:
    """Generalized energy training loss (paper eqs. (12)-(14)) of one batch.

    ``t`` ([B]), ``eps`` (like ``x0``) and ``xi`` ((B, m) + ``x0.shape[1:]``)
    are drawn from ``generator`` in that order unless injected. ``apply_fn``
    may emit any fixed permutation of the data (e.g. ``DDDMDiT.tokens``) as
    long as ``target_transform`` applies the same one to ``x0``: the energy
    terms reduce over the flattened data axis. It may return ``(x0hat,
    aux)``: ``aux``, an already-weighted scalar, is added to the loss and
    reported under ``moe_aux`` (``ddm_tpu/training.py:136-190``).
    """
    if m < 2:
        raise ValueError("m must be >= 2 to form interaction pairs")
    batch = x0.shape[0]
    dev, dtype = x0.device, x0.dtype

    if t is None:
        t = torch.rand((batch,), generator=generator, device=dev, dtype=dtype)
    if eps is None:
        eps = torch.randn(x0.shape, generator=generator, device=dev, dtype=dtype)
    xt = forward_marginal_sample(x0, t, eps)
    if xi is None:
        xi = torch.randn((batch, m) + tuple(x0.shape[1:]), generator=generator, device=dev,
                         dtype=dtype)

    # m-expansion: one batched forward over B*m rows (reference training.py:70-74)
    xt_rep = xt[:, None].expand((batch, m) + tuple(xt.shape[1:])).reshape(
        (batch * m,) + tuple(xt.shape[1:]))
    xi_flat = xi.reshape((batch * m,) + tuple(x0.shape[1:]))
    t_rep = t.repeat_interleave(m)
    out = apply_fn(xt_rep, t_rep, xi_flat)
    x0hat, aux = out if isinstance(out, tuple) else (out, None)
    x0hat = x0hat.reshape(batch, m, -1)

    target = x0 if target_transform is None else target_transform(x0)
    conf, inter = fused_energy_terms(x0hat, target.reshape(batch, -1).float(), beta)
    weight = sigmoid_weight(t.float(), bias=w_bias).mean()
    loss = weight * (conf - (lam / (2.0 * (m - 1))) * inter)
    metrics = {"loss": loss, "confidence": conf, "interaction": inter, "weight": weight}
    if aux is not None:
        loss = loss + aux
        metrics["loss"] = loss
        metrics["moe_aux"] = aux
    return loss, metrics


def make_loss_fn(apply_fn: Apply, *, m: int, beta: float, lam: float, w_bias: float,
                 target_transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """Bind the hyperparameters: ``(x0, generator) -> (loss, metrics)``."""

    def loss_fn(x0: torch.Tensor, generator: Optional[torch.Generator] = None):
        return distributional_training_step(
            apply_fn, x0, m=m, beta=beta, lam=lam, w_bias=w_bias, generator=generator,
            target_transform=target_transform)

    return loss_fn


@torch.no_grad()
def clip_grads_by_global_norm_(params: Iterable[torch.nn.Parameter],
                               max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place; returns the global norm.

    ``norm = sqrt(sum of every gradient's squared entries)``; gradients stay
    as they are when ``norm < max_norm`` and become ``g / norm * max_norm``
    otherwise (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``
    and also clips at ``norm == max_norm``). No host sync.
    """
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.stack([g.float().pow(2).sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float) -> torch.optim.AdamW:
    """AdamW with optax ``adamw``'s defaults (b1 0.9, b2 0.999, eps 1e-8, no
    eps_root), decaying every parameter as optax does with no mask."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def make_train_step(
    model: torch.nn.Module,
    apply_fn: Apply,
    optimizer: torch.optim.Optimizer,
    *,
    m: int,
    beta: float,
    lam: float,
    w_bias: float,
    grad_clip: Optional[float] = None,
    preprocess: Optional[Callable[[torch.Tensor, torch.Generator], torch.Tensor]] = None,
    target_transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Build ``step(batch, generator) -> metrics``, one in-place update of
    ``model`` (the single-device body of ``make_sharded_train_step``).

    ``generator`` is split in two as the JAX step splits its key:
    ``preprocess(batch, first)`` makes ``x0`` (augmentation), the loss draws
    its noise from the second. Then ``backward()``, the optax-rule clip when
    ``grad_clip > 0``, and ``optimizer.step()``.
    """
    loss_fn = make_loss_fn(apply_fn, m=m, beta=beta, lam=lam, w_bias=w_bias,
                           target_transform=target_transform)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: torch.Tensor, generator: torch.Generator) -> Metrics:
        kpre, key = split_generator(generator, 2, batch.device)
        x0 = preprocess(batch, kpre) if preprocess is not None else batch
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(x0, key)
        loss.backward()
        if grad_clip is not None and grad_clip > 0:
            clip_grads_by_global_norm_(params, grad_clip)
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step
