"""Train a DiT-backed Distributional Diffusion Model on CIFAR-10 with the
PyTorch port (one GPU, or a (data, model) grid of ranks with ``--tp``).

The port's counterpart of ``train_cifar10_dit.py``: the same flags and
defaults, YAML ``--config`` fill-only-defaults merge, AdamW with optax's
global-norm clip, the shared distributional training step, per-step and
per-epoch histories, epoch checkpoints and ``model_final.pt`` in the
reference ``{"model", "config"}`` payload (``generate_torch.py --ckpt``
samples from it), ``config.json`` and a ``samples.png`` grid.

Each step: the uint8 batch goes to the device, is augmented there
(reflect-pad crop + flip), noised to x_t, expanded m-fold through the DiT
(kernels K2f/K1f on CUDA), scored by the energy score (K3f), differentiated
(K3b, K1b, K2b), clipped and stepped with AdamW. ``--image-size 64`` (N =
256 tokens) resizes the data once and runs K2's attention cores past 128
tokens (one block per query tile forward, two passes backward) and K3 in
its D-tiled design (D = 12,288); 128, 256 or 512 (N = 1024 to 16384) runs
the attention core through K8f/K8b instead of K2's, and the energy score
through its plain version, as the JAX package's gate does at that size.
``--m`` from 17 to 64 (a multiple of 8, e.g. the m-sweep point 32) takes
the anchor-streaming energy kernels K9f/K9b in place of K3's. ``--moe-experts E`` (> 1) replaces every block's dense MLP half with
E routed expert FFNs (kernels K11f/K10f/K12f forward, K12b/K10b/K11b
backward in place of K1f/K1b), whose Switch load-balance loss, times
``--moe-aux-weight``, joins the loss and is logged as ``moe_aux``. At the
DiT-B and DiT-L widths (``--embed-dim`` 768 and 1024, the widths of
``configs/cifar10_dit_b.yaml`` and ``_l.yaml``) each half-block takes the
JAX package's tier for its shapes: the split attention backward K4 in place
of K2b, the MLP forward as K1f (DiT-B) or as k F-chunked partials K6f
(DiT-L), and the expert FFN's forward as k partials K10p. Where the JAX
ladder has no half-block tier it runs its third rung, the XLA half-block
around the standalone core, and so does the port: DiT-L at ``--image-size
64`` (N = 256) through K7f/K7b, ``--image-size 96`` (N = 576) through the
plain core (JAX runs XLA's there), and K8 at every head width the JAX
gate admits (4, 8, 16, 32, 64, 128 and 256-896) from 128 px; where the
half-block GEMMs do not take D (D % 64 != 0 or past 1344) the third rung's
LN, qkv and projection are plain torch products around its core.
DiT-XL/4 (``--embed-dim 1152 --depth 28 --heads 16``: 16 heads of Dh 72)
runs K2f and K4 at 32 px and K7f/K7b at 64 px, their cores on head tiles
padded to 80 columns, and the F-chunked MLP (two K6f, K1b) at
D 1152; with ``--moe-experts 8`` (top-1 or top-2) its dispatch and combine
run K11 and K12 at D 1152 (any D % 128 == 0 up to 4096, 2 to 64 experts)
and its experts' FFN four K10p partials and K10b. ``--fast-gelu`` takes x sigmoid(1.702 x) in place of the exact-erf
GELU in every MLP half-block's kernels (K1, K6, K10) and plain versions, as
the JAX trainer's ``DDM_TPU_FAST_GELU=1`` does. ``--attention xla`` unfuses
the attention half as the JAX model does (plain attention core, MLP still
fused); ``flash`` is ``auto``.
On ``--device cpu`` the same step runs the plain PyTorch versions.

``--tp N`` is Megatron tensor parallelism with data parallelism beside it,
over ``world_size = dp x N`` ranks launched by ``python -m
torch.distributed.run`` (rank r at data index r // N, model index r % N;
``--batch`` is the global batch, split over the dp data ranks). Each rank
holds its shard of every block (whole heads of q, k and v, rows of
``ff_in``, columns of ``proj`` and ``ff_out``) and runs the tensor-parallel
block: the attention core on its heads (K7f/K7b where the JAX gate takes
them at the local width, else the plain core), the MLP partial K6f forward
and K6b backward, and the energy score K3 on its data rank's slice; the
global-norm clip sums over the model group. The backend is NCCL where each
rank on a node has a card of its own, and gloo on the CPU and where ranks
share one card (gloo's CUDA support covers the all-reduces this needs;
the checkpoint's gathers go through the CPU). Rank 0 gathers the shards
and writes the full checkpoint, whose config carries ``tp``, and samples
from the full instance; every rank writes what ``main`` returns (step
times, metrics, kernel launches) to ``result_rank{r}.json``. ``--tp`` on
one rank raises, as JAX's mesh does.

Not written: the ``*_dynamics.png`` plots (they need matplotlib, which the
GPU machine does not have); the histories are in ``train_metrics.json`` and
``epoch_metrics.json``. The port reads ``--synthetic`` data only, and every
flag of a path not ported yet raises ``NotImplementedError`` naming its
ROADMAP.md item when set away from its default.

Usage:
    python train_cifar10_dit_torch.py --synthetic --epochs 1 --out run/
    python train_cifar10_dit_torch.py --synthetic --image-size 64 --batch 64 --m 4 \
        --epochs 1 --out run64/
    python train_cifar10_dit_torch.py --synthetic --m 32 --batch 256 --epochs 1 --out m32/
    python train_cifar10_dit_torch.py --synthetic --image-size 128 --batch 16 --m 8 \
        --epochs 1 --out run128/
    python train_cifar10_dit_torch.py --synthetic --batch 256 --m 8 --moe-experts 8 \
        --moe-capacity 1.25 --moe-group-size 256 --moe-aux-weight 0.01 --epochs 1 --out moe/
    python train_cifar10_dit_torch.py --synthetic --batch 256 --m 8 --embed-dim 1024 \
        --depth 24 --heads 16 --epochs 1 --out dit_l/
    python train_cifar10_dit_torch.py --synthetic --embed-dim 1024 --depth 24 --heads 16 \
        --image-size 64 --batch 64 --m 4 --epochs 1 --out dit_l64/
    python train_cifar10_dit_torch.py --synthetic --batch 256 --m 8 --embed-dim 1152 \
        --depth 28 --heads 16 --epochs 1 --out dit_xl/
    python train_cifar10_dit_torch.py --synthetic --batch 256 --m 8 --embed-dim 1152 \
        --depth 28 --heads 16 --moe-experts 8 --moe-capacity 1.25 --moe-group-size 256 \
        --moe-topk 2 --epochs 1 --out moe_xl/
    python train_cifar10_dit_torch.py --synthetic --fast-gelu --epochs 1 --out fast/
    python -m torch.distributed.run --standalone --nproc-per-node 2 -- \
        train_cifar10_dit_torch.py --synthetic --tp 2 --epochs 1 --out tp2/
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ddm_tpu_torch.data.augment import augment_cifar10, normalize_images
from ddm_tpu_torch.data.cifar10 import CIFAR10DataConfig, build_cifar10_dataloaders
from ddm_tpu_torch.models.dit import init_params, patchify_images
from ddm_tpu_torch.models.factory import (
    MODEL_DEFAULTS,
    SAMPLER_DEFAULTS,
    build_model,
    make_tokens_apply,
)
from ddm_tpu_torch.ops.kernel_config import cli_device, launch_counts, load_library
from ddm_tpu_torch.parallel import (
    gather_full_state_dict,
    make_mesh,
    make_sharded_train_step,
    shard_state_dict,
)
from ddm_tpu_torch.sampling import sample_dddm_batched
from ddm_tpu_torch.training import make_optimizer, make_train_step, split_generator
from ddm_tpu_torch.utils.checkpoint import save_checkpoint
from ddm_tpu_torch.utils.config import apply_config
from ddm_tpu_torch.utils.plotting import save_image_grid

_PARALLEL = "Queue 1 item 11 (parallelism)"
_OPTIONS = "Queue 1 item 2 (lr schedules, grad-accum, EMA, resume)"
_EVAL = "Queue 1 item 3 (eval)"
_UTILS = "Queue 1 item 7 (data, utils)"
# flags of paths the port does not run yet: set away from its default, each
# raises NotImplementedError naming its ROADMAP.md item
NOT_PORTED = {
    "sp": _PARALLEL, "pp": _PARALLEL, "pp_microbatches": _PARALLEL,
    "fsdp": _PARALLEL, "multihost": _PARALLEL,
    "lr_schedule": _OPTIONS, "warmup_steps": _OPTIONS, "lr_min": _OPTIONS,
    "grad_accum": _OPTIONS, "ema_decay": _OPTIONS, "resume": _OPTIONS,
    "eval_every": _EVAL, "dry_eval": _EVAL, "eval_batch": _EVAL, "eval_samples": _EVAL,
    "fid_samples": _EVAL, "mmd_samples": _EVAL, "mmd_sigma": _EVAL, "fid_bf16": _EVAL,
    "wandb": _UTILS, "wandb_project": _UTILS, "wandb_name": _UTILS,
    "profile_dir": _UTILS, "debug_nans": _UTILS,
    "remat": "Queue 1 item 8 (remat and mlp_persist at the wide widths)",
    "mlp_persist": "Queue 1 item 8 (remat and mlp_persist at the wide widths)",
}
METRIC_KEYS = ("loss", "confidence", "interaction", "weight", "moe_aux")


def _serialize_history(history: Dict[str, list]) -> dict:
    return {k: [int(v) if k in {"step", "epoch"} else float(v) for v in values]
            for k, values in history.items()}


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _distributed(args: argparse.Namespace, device: torch.device):
    """``(mesh, device)``: the ``(data, model)`` grid of the ranks that
    ``torch.distributed.run`` started (its environment), with the process
    group initialised; one rank where none was started (``--tp`` > 1 then
    raises, as ``make_mesh`` does)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return make_mesh(args.tp), device
    backend = "gloo"
    if device.type == "cuda":
        local, cards = int(os.environ.get("LOCAL_RANK", "0")), torch.cuda.device_count()
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
        # NCCL takes one rank per card; ranks that share a card talk through gloo
        if cards >= int(os.environ.get("LOCAL_WORLD_SIZE", str(world))):
            backend = "nccl"
    dist.init_process_group(backend, init_method="env://")
    mesh = make_mesh(args.tp)
    print(f"[rank {mesh.rank}] torch.distributed backend {backend}, {world} ranks = dp "
          f"{mesh.dp} x tp {mesh.tp}, data rank {mesh.data_rank}, model rank {mesh.model_rank}, "
          f"{device}", flush=True)
    return mesh, device


def train(args: argparse.Namespace) -> dict:
    """Run the training loop; returns ``{"step_seconds", "seconds_per_step",
    "images_per_sec", "metrics", "launches"}``."""
    device = cli_device(args.device)
    mesh, device = _distributed(args, device)
    try:
        return _train(args, mesh, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args: argparse.Namespace, mesh, device: torch.device) -> dict:
    ranks = mesh.dp * mesh.tp
    lead = mesh.rank == 0  # writes the files, prints the logs, samples
    os.makedirs(args.out, exist_ok=True)
    root = torch.Generator().manual_seed(args.seed)

    model = build_model(vars(args), device)  # raises for a size no kernel takes
    train_loader, _ = build_cifar10_dataloaders(CIFAR10DataConfig(
        batch_size=args.batch, image_size=args.image_size, synthetic=args.synthetic,
        seed=args.seed))
    init_params(model, split_generator(root, 1)[0])
    n_params = sum(p.numel() for p in model.parameters())
    if mesh.tp > 1:  # every rank drew the full weights from the seed; keep its shard
        full = model.state_dict()
        model = build_model(vars(args), device, mesh.model_group)
        model.load_state_dict(shard_state_dict(full, mesh.tp, mesh.model_rank))
        del full
    if lead:
        print(f"DDDMDiT: {n_params / 1e6:.2f}M params, {ranks} device(s) ({device}; dp "
              f"{mesh.dp} x tp {mesh.tp})", flush=True)
    if device.type == "cuda":
        load_library()  # build the kernels before the first step

    optimizer = make_optimizer(model.parameters(), args.lr, args.weight_decay)
    augment = not args.no_augment

    def preprocess(batch: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return augment_cifar10(batch, generator) if augment else normalize_images(batch)

    hp = dict(m=args.m, beta=args.beta, lam=args.lam, w_bias=args.w_bias,
              grad_clip=args.grad_clip, preprocess=preprocess,
              target_transform=lambda x0: patchify_images(x0, args.patch_size))
    apply_fn = make_tokens_apply(model, args.moe_aux_weight)
    if ranks > 1:
        step_fn = make_sharded_train_step(model, apply_fn, optimizer, mesh, **hp)
    else:
        step_fn = make_train_step(model, apply_fn, optimizer, **hp)

    def full_state_dict():
        # a collective over the model group: every rank calls it
        return (gather_full_state_dict(model.state_dict(), mesh.model_group) if mesh.tp > 1
                else model.state_dict())

    train_history: Dict[str, list] = {"step": []}
    epoch_history: Dict[str, list] = {"epoch": []}
    step_seconds: list = []
    global_step = 0
    img_per_sec = 0.0
    counts0 = launch_counts()
    for epoch in range(1, args.epochs + 1):
        epoch_t0 = time.perf_counter()
        sums: Dict[str, float] = defaultdict(float)
        pending: list = []
        window_t0 = epoch_t0
        num_batches = 0

        def flush() -> None:
            # one device sync per log window
            nonlocal pending, window_t0, num_batches
            if not pending:
                return
            keys = [k for k in METRIC_KEYS if k in pending[0]]
            values = torch.stack([torch.stack([m[k] for k in keys])
                                  for m in pending]).float().cpu().numpy()
            now = time.perf_counter()
            step_seconds.extend([(now - window_t0) / len(pending)] * len(pending))
            window_t0 = now
            base = global_step - len(pending)
            for i, row in enumerate(values):
                train_history["step"].append(base + i + 1)
                for k, v in zip(keys, row):
                    train_history.setdefault(k, []).append(float(v))
                    sums[k] += float(v)
            num_batches += len(pending)
            pending = []

        train_loader.set_epoch(epoch)
        for batch_idx, (images, _) in enumerate(train_loader):
            batch = torch.from_numpy(images).to(device, non_blocking=True)
            pending.append(step_fn(batch, split_generator(root, 1)[0]))
            global_step += 1
            if (batch_idx + 1) % max(args.log_every, 1) == 0:
                flush()
        flush()

        num_batches = max(num_batches, 1)
        avg = {k: sums[k] / num_batches for k in sums}
        img_per_sec = num_batches * args.batch / (time.perf_counter() - epoch_t0)
        summary = " ".join(f"{k}={avg[k]:.4f}" for k in sorted(avg))
        if lead:
            print(f"[epoch {epoch:03d}] {summary} ({img_per_sec:.0f} img/s, "
                  f"{img_per_sec / ranks:.0f} img/s/chip)", flush=True)
        epoch_history["epoch"].append(epoch)
        for k, v in avg.items():
            epoch_history.setdefault(k, []).append(v)
        epoch_history.setdefault("images_per_sec", []).append(img_per_sec)
        if epoch % args.ckpt_every == 0 or epoch == args.epochs:
            state = full_state_dict()
            if lead:
                save_checkpoint(os.path.join(args.out, f"model_epoch{epoch:03d}.pt"), state,
                                vars(args) | {"epoch": epoch})
    counts1 = launch_counts()

    state = full_state_dict()
    if lead:
        save_checkpoint(os.path.join(args.out, "model_final.pt"), state,
                        vars(args) | {"epoch": args.epochs})
        with open(os.path.join(args.out, "config.json"), "w", encoding="utf-8") as f:
            json.dump(vars(args), f, indent=2)

    if args.sample_batch > 0 and lead:
        size = args.image_size
        sampler = model
        if mesh.tp > 1:  # the full instance, as JAX samples with tp_axis=None
            sampler = build_model(vars(args), device)
            sampler.load_state_dict(state)
        samples = sample_dddm_batched(
            sampler, args.sample_batch, steps=args.sample_steps, eps_churn=args.eps_churn,
            data_shape=(size, size, 3), generator=split_generator(root, 1, device)[0],
            device=device, chunk_size=args.sample_batch)
        samples = np.clip(samples, -1.0, 1.0)
        grid_rows = int(args.sample_batch ** 0.5)
        if grid_rows * grid_rows < args.sample_batch:
            grid_rows += 1
        save_image_grid((samples + 1.0) / 2.0, os.path.join(args.out, "samples.png"),
                        nrow=grid_rows)
        print(f"Saved samples and checkpoints to {args.out}", flush=True)

    if lead:
        for name, hist in (("train", train_history), ("epoch", epoch_history)):
            with open(os.path.join(args.out, f"{name}_metrics.json"), "w",
                      encoding="utf-8") as f:
                json.dump(_serialize_history(hist), f, indent=2)

    warm = step_seconds[1:] or step_seconds
    result = {
        "step_seconds": step_seconds,
        "seconds_per_step": float(np.median(warm)) if warm else float("nan"),
        "images_per_sec": img_per_sec,
        "metrics": {k: train_history[k][-1] for k in METRIC_KEYS if train_history.get(k)},
        "launches": {"train": _diff(counts1, counts0), "sample": _diff(launch_counts(), counts1)},
    }
    if ranks > 1:
        with open(os.path.join(args.out, f"result_rank{mesh.rank}.json"), "w",
                  encoding="utf-8") as f:
            json.dump(result, f, indent=2)
    return result


def build_parser() -> argparse.ArgumentParser:
    """The JAX trainer's flags with its defaults (``--device`` defaults to
    ``cuda``); see :data:`NOT_PORTED` for the flags of paths not ported."""
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    later = "not ported yet: ROADMAP.md "
    p.add_argument("--config", type=str, default=None,
                   help="Optional YAML config (needs pyyaml)")
    p.add_argument("--data-dir", type=str, default="./data",
                   help="real CIFAR-10 is " + later + _UTILS + "; pass --synthetic")
    p.add_argument("--out", type=str, default="./cifar10_dit_out")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-schedule", type=str, dest="lr_schedule", default="constant",
                   choices=["constant", "cosine", "linear"],
                   help="only constant; " + later + _OPTIONS)
    p.add_argument("--warmup-steps", type=int, dest="warmup_steps", default=0,
                   help=later + _OPTIONS)
    p.add_argument("--lr-min", type=float, dest="lr_min", default=0.0, help=later + _OPTIONS)
    p.add_argument("--grad-accum", type=int, dest="grad_accum", default=1, help=later + _OPTIONS)
    p.add_argument("--ema-decay", type=float, dest="ema_decay", default=0.0, help=later + _OPTIONS)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--beta", type=float, default=0.1)
    p.add_argument("--lam", type=float, default=1.0)
    p.add_argument("--m", type=int, default=8)
    p.add_argument("--w-bias", type=float, default=0.0, dest="w_bias")
    p.add_argument("--grad-clip", type=float, default=1.0,
                   help="global-norm clip with optax's rule (0 disables)")
    p.add_argument("--ckpt-every", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (the plain versions)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image-size", type=int, default=MODEL_DEFAULTS["image_size"])
    p.add_argument("--patch-size", type=int, default=MODEL_DEFAULTS["patch_size"])
    p.add_argument("--embed-dim", type=int, default=MODEL_DEFAULTS["embed_dim"])
    p.add_argument("--depth", type=int, default=MODEL_DEFAULTS["depth"])
    p.add_argument("--heads", type=int, default=MODEL_DEFAULTS["heads"])
    p.add_argument("--time-embed", type=int, default=MODEL_DEFAULTS["time_embed"])
    p.add_argument("--mlp-ratio", type=float, default=MODEL_DEFAULTS["mlp_ratio"])
    p.add_argument("--workers", type=int, default=4,
                   help="accepted for parity; the dataset is memory-resident")
    p.add_argument("--sample-batch", type=int, default=64)
    p.add_argument("--sample-steps", type=int, default=SAMPLER_DEFAULTS["sample_steps"])
    p.add_argument("--eps-churn", type=float, default=SAMPLER_DEFAULTS["eps_churn"])
    p.add_argument("--no-augment", action="store_true", help="Disable data augmentation")
    for flag, kind, default in (("--eval-every", int, 0), ("--eval-batch", int, 256),
                                ("--eval-samples", int, 1024), ("--fid-samples", int, 10000),
                                ("--mmd-samples", int, 2048), ("--mmd-sigma", float, 1.0)):
        p.add_argument(flag, type=kind, default=default, help=later + _EVAL)
    p.add_argument("--wandb", action="store_true", help=later + _UTILS)
    p.add_argument("--wandb-project", type=str, default="dddm", help=later + _UTILS)
    p.add_argument("--wandb-name", type=str, default=None, help=later + _UTILS)
    p.add_argument("--dtype", type=str, default=MODEL_DEFAULTS["dtype"],
                   choices=["float32", "bfloat16"],
                   help="compute dtype (the CUDA kernels take bfloat16)")
    p.add_argument("--tp", type=int, default=MODEL_DEFAULTS["tp"],
                   help="tensor-parallel degree over the ranks of torch.distributed.run "
                        "(dp = ranks / tp); 1 with one rank is the one-device step")
    p.add_argument("--sp", action="store_true", help=later + _PARALLEL)
    p.add_argument("--attention", type=str, default=MODEL_DEFAULTS["attention"],
                   choices=["auto", "xla", "flash"],
                   help="auto/flash: the fused half-block kernels; xla: the unfused attention "
                        "half (plain attention core), the MLP half still fused")
    p.add_argument("--synthetic", action="store_true",
                   help="use synthetic CIFAR-shaped data (the only data the port reads)")
    p.add_argument("--resume", action="store_true", help=later + _OPTIONS)
    p.add_argument("--dry-eval", action="store_true", dest="dry_eval", help=later + _EVAL)
    p.add_argument("--profile-dir", type=str, default=None, help=later + _UTILS)
    p.add_argument("--log-every", type=int, default=50,
                   help="metric flush cadence in batches (each flush syncs the device)")
    p.add_argument("--debug-nans", action="store_true", help=later + _UTILS)
    p.add_argument("--remat", action="store_true", help=later + NOT_PORTED["remat"])
    p.add_argument("--moe-experts", type=int, dest="moe_experts",
                   default=MODEL_DEFAULTS["moe_experts"],
                   help="> 1 replaces every block's dense MLP with this many routed expert "
                        "FFNs (replicated; excludes --mlp-persist)")
    p.add_argument("--moe-capacity", type=float, dest="moe_capacity",
                   default=MODEL_DEFAULTS["moe_capacity"],
                   help="per-expert capacity factor: cap = ceil(group * factor * topk / "
                        "experts); over-capacity tokens pass through the residual")
    p.add_argument("--moe-group-size", type=int, dest="moe_group_size",
                   default=MODEL_DEFAULTS["moe_group_size"],
                   help="routing group size (0 = all rows in one group); ragged row counts "
                        "pad to the group boundary")
    p.add_argument("--fid-bf16", action="store_true", dest="fid_bf16", help=later + _EVAL)
    p.add_argument("--moe-topk", type=int, dest="moe_topk", default=MODEL_DEFAULTS["moe_topk"],
                   help="routed experts per token: 1 (Switch) or 2 (GShard)")
    p.add_argument("--moe-aux-weight", type=float, dest="moe_aux_weight", default=0.01,
                   help="weight of the Switch load-balance loss (mean over MoE blocks, added "
                        "to the loss and logged as moe_aux); 0 disables it")
    p.add_argument("--mlp-persist", type=int, default=MODEL_DEFAULTS["mlp_persist"],
                   help=later + NOT_PORTED["mlp_persist"])
    p.add_argument("--fsdp", action="store_true", help=later + _PARALLEL)
    p.add_argument("--pp", type=int, default=1, help=later + _PARALLEL)
    p.add_argument("--pp-microbatches", type=int, default=4, dest="pp_microbatches",
                   help=later + _PARALLEL)
    p.add_argument("--multihost", action="store_true", help=later + _PARALLEL)
    p.add_argument("--fast-gelu", action="store_true",
                   help="sigmoid-GELU approximation x sigmoid(1.702 x) in every MLP half-block "
                        "(kernel epilogues and plain versions), as the JAX trainer's "
                        "DDM_TPU_FAST_GELU=1; the checkpoint's config records it")
    return p


def main(argv: Optional[list] = None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    apply_config(parser, args)
    if args.tp > 1:  # the JAX parser's checks (train_cifar10_dit.py:856-860, :869-878)
        hidden = int(args.embed_dim * args.mlp_ratio)
        if args.embed_dim % args.tp or args.heads % args.tp or hidden % args.tp:
            parser.error("--tp must divide --embed-dim, --heads, and the MLP hidden size")
    if args.moe_experts > 1:
        if args.moe_experts % args.tp:
            parser.error("--moe-experts must be divisible by --tp")
        if args.mlp_persist:
            parser.error("--mlp-persist applies to the dense MLP half, which --moe-experts "
                         "replaces")
        if args.moe_topk not in (1, 2):
            parser.error("--moe-topk must be 1 or 2")
    for dest, item in NOT_PORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            raise NotImplementedError(
                f"--{dest.replace('_', '-')} is not ported to the PyTorch port yet: "
                f"ROADMAP.md {item}")
    if args.tp > 1 and args.moe_experts > 1:
        raise NotImplementedError("--tp with --moe-experts (expert parallelism) is not ported "
                                  f"to the PyTorch port yet: ROADMAP.md {_PARALLEL}")
    if not args.synthetic:
        raise NotImplementedError(
            f"the PyTorch port reads synthetic data only (pass --synthetic): ROADMAP.md {_UTILS}")
    if args.m < 2:
        parser.error("m must be >= 2 for the generalized energy score")
    if args.batch < 1 or args.epochs < 1 or args.ckpt_every < 1:
        parser.error("--batch, --epochs and --ckpt-every must be positive")
    return train(args)


if __name__ == "__main__":
    main()
