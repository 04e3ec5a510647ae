"""Sample images from a DDDM DiT checkpoint with the PyTorch port.

The port's counterpart of ``generate.py``: load a ``.pt`` checkpoint (the
reference ``{"model", "config"}`` payload), rebuild the model from the
config embedded in it, run the reverse sampler (paper Algorithm 2) and
write a PNG grid and/or an NPZ of raw samples. The image size is the
checkpoint's. On a CUDA device the DiT blocks run the hand-written kernels
K1f and K2f (K2f through its query-tile core at ``image_size`` 64, N = 256
tokens; K1f and K8f at ``image_size`` 128 to 512; K11f, K10f and K12f
in place of K1f for a checkpoint trained with ``--moe-experts``; K6f, the
F-chunked MLP partial, in place of K1f at the DiT-L width, and K10p in place
of K10f for an MoE at D >= 768; the third rung's K7f at DiT-L and 64 px,
and the plain attention core at 96 px or with ``attention: xla``). A
checkpoint at DiT-XL width runs K2f (32 px) or K7f (64 px) on 16 heads of
72 and two K6f per block, or with ``--moe-experts`` K11f, four K10p and K12f. A
checkpoint at SD3-Medium's width (D 1536, 24 heads of 64) runs K7f and eight
K6f per block (the streamed LN-prologue GEMM). ``--fast-gelu`` takes the sigmoid GELU in every
MLP half-block, and only when asked, as ``generate.py`` sets
``DDM_TPU_FAST_GELU`` only for the flag: a checkpoint trained with it
samples with the exact-erf GELU unless the flag is given. A
checkpoint trained with ``--tp N`` (``tp: N`` in its config) samples on one
card through the full tensor-parallel instance, as JAX's ``generate.py``
rebuilds it with ``tp_axis=None``: q, k and v as three products around the
standalone core (K7f where the JAX gate takes it) and the MLP as the
partial K6f, whose fp32 sum takes the bias and the residual once.
``train_cifar10_dit_torch.py`` writes checkpoints in the payload this
script reads.

Usage:
    python generate_torch.py --ckpt model_final.pt --n 64 --out samples.png
    python generate_torch.py --ckpt out/ --npz samples.npz   # dir -> final/latest
A checkpoint trained with the JAX package converts first:
    python scripts/convert_reference_ckpt.py --to-torch run/model_final.ckpt model.pt
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ddm_tpu_torch.models.factory import MODEL_DEFAULTS, SAMPLER_DEFAULTS, build_model
from ddm_tpu_torch.ops.kernel_config import cli_device, load_library
from ddm_tpu_torch.sampling import sample_dddm_batched
from ddm_tpu_torch.utils import checkpoint as ckpt_lib
from ddm_tpu_torch.utils.plotting import save_image_grid


def _resolve_ckpt(path: str) -> str:
    if os.path.isdir(path):
        final = os.path.join(path, "model_final.pt")
        if os.path.exists(final):
            return final
        latest = ckpt_lib.latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no .pt checkpoints under {path}")
        return latest
    return path


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", type=str, required=True,
                   help="checkpoint file, or a training output dir "
                        "(model_final.pt, else the latest model_epoch*.pt)")
    p.add_argument("--config", type=str, default=None,
                   help="config.json overlaid on the ckpt-embedded config")
    p.add_argument("--n", type=int, default=64, help="number of samples")
    p.add_argument("--batch", type=int, default=256, help="sampler chunk size")
    p.add_argument("--steps", type=int, default=None,
                   help="reverse steps (default: the run's sample_steps)")
    p.add_argument("--eps-churn", type=float, default=None,
                   help="bridge churn (default: the run's eps_churn)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="samples.png",
                   help="PNG grid path ('' disables)")
    p.add_argument("--npz", type=str, default=None,
                   help="also save raw samples ([-1,1] NHWC float32) as NPZ")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--fast-gelu", action="store_true",
                   help="sigmoid-GELU approximation x sigmoid(1.702 x) in every MLP half-block "
                        "(generate.py's DDM_TPU_FAST_GELU=1); off, the exact-erf GELU, whatever "
                        "the checkpoint was trained with")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel sampling: not ported yet (ROADMAP.md Queue 1 item 6)")
    p.add_argument("--ema", action="store_true",
                   help="sample from EMA params: not ported yet (ROADMAP.md Queue 1 item 2)")
    args = p.parse_args(argv)
    for flag, on, item in (("--dp > 1", args.dp > 1, 6), ("--ema", args.ema, 2)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported to the PyTorch port yet: ROADMAP.md Queue 1 item {item}")
    if args.n < 1:
        raise SystemExit("--n must be positive")
    device = cli_device(args.device)

    state_dict, config = ckpt_lib.load_params(_resolve_ckpt(args.ckpt))
    if args.config:
        with open(args.config, "r", encoding="utf-8") as f:
            config = {**config, **json.load(f)}
    cfg = {**SAMPLER_DEFAULTS, **{k: v for k, v in config.items() if v is not None},
           "fast_gelu": args.fast_gelu}

    model = build_model(cfg, device)
    model.load_state_dict(state_dict)
    model.eval()
    steps = args.steps if args.steps is not None else int(cfg["sample_steps"])
    churn = args.eps_churn if args.eps_churn is not None else float(cfg["eps_churn"])
    size = int(cfg.get("image_size", MODEL_DEFAULTS["image_size"]))
    if device.type == "cuda":
        load_library()  # build the kernels before the timed run

    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    samples = sample_dddm_batched(
        model, args.n, steps=steps, eps_churn=churn, data_shape=(size, size, 3),
        generator=generator, device=device, chunk_size=min(args.batch, args.n),
    )
    seconds = time.perf_counter() - t0
    samples = np.clip(samples, -1.0, 1.0)
    print(f"Sampled {args.n} in {seconds:.3f} s ({args.n / seconds:.2f} samples/s) "
          f"on {device}, {steps} steps, eps_churn={churn}")

    if args.out:
        nrow = 1
        while nrow * nrow < args.n:
            nrow += 1
        save_image_grid((samples + 1.0) / 2.0, args.out, nrow=nrow)
        print(f"Saved {args.n} samples to {args.out}")
    if args.npz:
        np.savez(args.npz, samples=samples.astype(np.float32))
        print(f"Saved raw samples to {args.npz}")
    return {"samples": samples, "seconds": seconds}


if __name__ == "__main__":
    main()
