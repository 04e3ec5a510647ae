"""One training step on a ``(data, model)`` grid of ranks, held against the
one-process oracle.

Each rank is a process of its own, started by :func:`launch` with a
``file://`` rendezvous and the gloo backend (on the CPU, or on a card that
the ranks share: gloo's CUDA all-reduce carries tensor parallelism's f and
g and the data-parallel average, and the gathers go through the CPU). Every
rank draws the same full weights and the same global inputs from the seed
and keeps its shard (:func:`~ddm_tpu_torch.parallel.sharding.shard_state_dict`);
data rank d takes the d-th slice of the batch and of the injected t, eps
and xi. For each model configuration the ranks run
:func:`~ddm_tpu_torch.parallel.data_parallel.make_sharded_train_step` twice
from the same start: with no clip, for the data-averaged gradients, and
with a global-norm clip that engages, for the clipped gradients and the
parameters after AdamW. Rank 0 gathers each over the model group and saves
them with the metrics and every rank's kernel launches.

:func:`oracle_step` is the same step in one process: the full
tensor-parallel instance (no group), each data slice's loss differentiated
in turn, the gradients averaged, clipped by optax's rule and stepped.

Run one rank (``launch`` starts them all)::

    python -m ddm_tpu_torch.parallel.check --rank 0 --world-size 2 --tp 2 \\
        --init file:///tmp/rdzv --device cpu --configs '[{...}]' --out /tmp/tp.pt
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..models.dit import init_params, patchify_images
from ..models.factory import build_model, make_tokens_apply
from ..ops.kernel_config import launch_counts, reset_launch_counts
from ..training import clip_grads_by_global_norm_, distributional_training_step, make_optimizer
from .data_parallel import make_sharded_train_step
from .mesh import make_mesh
from .sharding import gather_full_state_dict, shard_state_dict

__all__ = ["full_weights", "step_inputs", "oracle_step", "launch", "BETA", "LAM", "LR", "CLIP"]

BETA, LAM, LR, WEIGHT_DECAY = 0.1, 1.0, 1e-4, 0.01
CLIP = 1e-3  # far below the gradients' norm: the clip always engages
_REPO = Path(__file__).resolve().parents[2]


def full_weights(cfg: dict, seed: int) -> Dict[str, torch.Tensor]:
    """The full fp32 ``state_dict`` (CPU) drawn from ``seed``: the JAX
    initialisers, then LayerNorm parameters and biases moved off 1 and 0 so
    that their gradients are not special."""
    model = build_model({**cfg, "dtype": "float32"}, "meta").to_empty(device="cpu")
    init_params(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model.state_dict()


def step_inputs(cfg: dict, batch: int, m: int, seed: int):
    """``(x0, t, eps, xi)`` of a global batch on the CPU, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    size = cfg["image_size"]
    shape = (batch, size, size, 3)
    return (torch.rand(shape, generator=gen) * 2 - 1, torch.rand((batch,), generator=gen),
            torch.randn(shape, generator=gen), torch.randn((batch, m) + shape[1:], generator=gen))


def _loss(model, cfg, x0, t, eps, xi):
    return distributional_training_step(
        make_tokens_apply(model), x0, m=xi.shape[1], beta=BETA, lam=LAM, w_bias=0.0, t=t,
        eps=eps, xi=xi, target_transform=lambda a: patchify_images(a, cfg["patch_size"]))


def oracle_step(cfg: dict, weights, inputs, dp: int, device, clip: Optional[float] = None):
    """The step in one process on the full instance of ``cfg`` (its
    ``dtype`` the compute dtype): ``{"metrics", "grads", "params"}``, the
    data-averaged gradients (clipped by optax's rule where ``clip`` is
    given) and, with a clip, the parameters after AdamW."""
    model = build_model(cfg, device)
    model.load_state_dict(weights)
    opt = make_optimizer(model.parameters(), LR, WEIGHT_DECAY)
    opt.zero_grad(set_to_none=True)
    b = inputs[0].shape[0] // dp
    metrics = []
    for d in range(dp):
        x0, t, eps, xi = (a[d * b:(d + 1) * b].to(device) for a in inputs)
        loss, mets = _loss(model, cfg, x0, t, eps, xi)
        loss.backward()
        metrics.append({k: float(v.detach()) for k, v in mets.items()})
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad /= dp
    if clip is not None:
        clip_grads_by_global_norm_(params.values(), clip)
        opt.step()
    return {"metrics": {k: sum(m[k] for m in metrics) / dp for k in metrics[0]},
            "grads": {k: p.grad.detach().cpu() for k, p in params.items()},
            "params": {k: p.detach().cpu() for k, p in params.items()} if clip else None}


def _rank_step(cfg: dict, mesh, weights, inputs, device, clip):
    """This rank's step: ``{"metrics", "grads", "params"}`` gathered over its
    model group (full tensors on every rank), and its kernel launches."""
    model = build_model(cfg, device, mesh.model_group if mesh.tp > 1 else None)
    model.load_state_dict(shard_state_dict(weights, mesh.tp, mesh.model_rank)
                          if mesh.tp > 1 else weights)
    opt = make_optimizer(model.parameters(), LR, WEIGHT_DECAY)
    step = make_sharded_train_step(
        model, make_tokens_apply(model), opt, mesh, m=inputs[3].shape[1], beta=BETA, lam=LAM,
        w_bias=0.0, grad_clip=clip,
        target_transform=lambda a: patchify_images(a, cfg["patch_size"]))
    b = inputs[0].shape[0] // mesh.dp
    sl = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    reset_launch_counts()
    metrics = step(inputs[0].to(device), torch.Generator().manual_seed(0),
                   noise=tuple(a[sl].to(device) for a in inputs[1:]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    named = dict(model.named_parameters())
    grads = gather_full_state_dict({k: p.grad for k, p in named.items()}, mesh.model_group)
    params = gather_full_state_dict(named, mesh.model_group) if clip else None
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "params": params}, launches


def run_rank(args: argparse.Namespace) -> None:
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)  # the ranks share one card
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=args.init, world_size=args.world_size,
                            rank=args.rank)
    try:
        mesh = make_mesh(args.tp)
        results = []
        for spec in json.loads(args.configs):
            cfg = spec["model"]
            weights = full_weights(cfg, spec["seed"])
            inputs = step_inputs(cfg, spec["batch"], spec["m"], spec["seed"] + 2)
            t0 = time.perf_counter()
            plain, launches = _rank_step(cfg, mesh, weights, inputs, device, None)
            seconds = time.perf_counter() - t0
            clipped = (_rank_step(cfg, mesh, weights, inputs, device, CLIP)[0]
                       if spec.get("clip", True) else {"grads": None, "params": None})
            every = [None] * mesh.dp * mesh.tp
            dist.all_gather_object(every, launches)
            results.append({"spec": spec, "metrics": plain["metrics"], "grads": plain["grads"],
                            "clipped": clipped["grads"], "params": clipped["params"],
                            "launches": every, "first_step_seconds": seconds})
        if mesh.rank == 0:
            torch.save(results, args.out)
    finally:
        dist.destroy_process_group()


def launch(world_size: int, tp: int, configs: List[dict], out: str, rdzv: str,
           device: str = "cpu", timeout: float = 300.0) -> list:
    """Start ``world_size`` ranks (one process each, rendezvous at the file
    ``rdzv``, which must not exist yet), wait for them within ``timeout``
    seconds, and return rank 0's results; kill every rank and raise, with
    the failing rank's output, on a fault or at the deadline."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(_REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    env.setdefault("OMP_NUM_THREADS", "1")
    logs = [f"{out}.rank{r}.log" for r in range(world_size)]
    procs = []
    try:
        for r in range(world_size):
            with open(logs[r], "w", encoding="utf-8") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ddm_tpu_torch.parallel.check", "--rank", str(r),
                     "--world-size", str(world_size), "--tp", str(tp), "--init",
                     f"file://{rdzv}", "--device", device, "--configs", json.dumps(configs),
                     "--out", out],
                    cwd=_REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                r = failed[0] if failed else 0
                what = (f"exited with {procs[r].returncode}" if failed else
                        f"did not finish in {timeout} s")
                raise RuntimeError(f"rank {r} of {world_size} {what}:\n"
                                   f"{Path(logs[r]).read_text()[-4000:]}")
            time.sleep(0.1)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {world_size} exited with {p.returncode}:\n"
                                   f"{Path(logs[r]).read_text()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return torch.load(out, weights_only=False)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--tp", type=int, required=True)
    p.add_argument("--init", type=str, required=True, help="file:// rendezvous")
    p.add_argument("--device", type=str, default="cpu")
    p.add_argument("--configs", type=str, required=True,
                   help='JSON list of {"model": build_model cfg, "batch", "m", "seed"[, "clip": '
                        'false: no clipped second step]}')
    p.add_argument("--out", type=str, required=True)
    run_rank(p.parse_args(argv))


if __name__ == "__main__":
    main()
