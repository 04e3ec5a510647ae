"""Profile the PyTorch port's training step (and, optionally, its sampler)
on one NVIDIA GPU: where a warm step's time goes, by phase and by kernel.

Takes the trainer's flags (``train_cifar10_dit_torch.py``; the data is
always the synthetic set), for example the MoE recipe of
``configs/cifar10_dit_moe.yaml``, or DiT-L/4 (``configs/cifar10_dit_l.yaml``'s
widths):

    python3 profile_torch_step.py --batch 256 --m 8 --moe-experts 8 \\
        --moe-capacity 1.25 --moe-group-size 256 --moe-aux-weight 0.01 \\
        --profile-samples 64
    python3 profile_torch_step.py --batch 256 --m 8 --embed-dim 1024 --depth 24 \\
        --heads 16 --profile-samples 64
    python3 profile_torch_step.py --image-size 64 --batch 64 --m 4 --profile-samples 64
    python3 profile_torch_step.py --batch 256 --m 32 --profile-samples 64
    python3 profile_torch_step.py --embed-dim 1024 --depth 24 --heads 16 --image-size 64 \
        --batch 64 --m 4 --profile-samples 64
    python3 profile_torch_step.py --tp 2 --profile-samples 256
    python3 profile_torch_step.py --batch 256 --m 8 --embed-dim 1152 --depth 28 \
        --heads 16 --profile-samples 64
    python3 profile_torch_step.py --batch 256 --m 8 --embed-dim 1152 --depth 28 \
        --heads 16 --moe-experts 8 --moe-capacity 1.25 --moe-group-size 256 \
        --moe-topk 1 --profile-samples 64

(``--tp N`` profiles the full tensor-parallel instance in one process: the
layout a ``--tp`` checkpoint samples with, K7 and the partial K6f/K6b.)

On one seeded model and one batch it runs 3 warm-up steps, then

* 10 steps on the host clock, each ending in a device sync (wall per step);
* 10 steps with CUDA events between the phases: augment + forward + loss,
  backward, the global-norm clip, AdamW;
* one step under ``torch.profiler``: the device time of every kernel row
  (summed per name, with its calls; user-annotated ranges left out), the
  device's busy share (kernel time over the profiled wall time) and the
  peak memory;
* one more step with CUDA events around each port kernel's launcher (K1f,
  K10b, ...; K6f and K10p once per hidden chunk): the device time from its
  first kernel's start to its last kernel's end, per step.

``--profile-samples N`` then times the sampler on N samples x
``--sample-steps`` steps (one warm-up, median of 3) and profiles one call
the same way. Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WARMUP, TIMED, TOP_ROWS = 3, 10, 24  # steps before timing, steps timed, kernel rows shown
# the launcher behind each kernel counter: (module, function, label); one
# launcher serves K2b and K4, and its span takes the label whose count rose
LAUNCHERS = [
    ("mlp_block", "_k1f", "K1f"), ("mlp_block", "_k1b", "K1b"),
    ("mlp_block", "_k6f", "K6f"), ("mlp_block", "_k6b", "K6b"),
    ("attention", "_k2f", "K2f"), ("attention", "_k2b", ("K2b", "K4")),
    ("energy", "energy_terms", ("K3f", "K9f")), ("energy", "energy_terms_bwd", ("K3b", "K9b")),
    ("attention", "launch_k7f", "K7f"), ("attention", "launch_k7b", "K7b"),
    ("flash", "launch_k8f", "K8f"), ("flash", "launch_k8b", "K8b"),
    ("expert_ffn", "_k10f", "K10f"), ("expert_ffn", "_k10b", "K10b"),
    ("expert_ffn", "_k10p", "K10p"),
    ("moe_dispatch", "_k11f", "K11f"), ("moe_dispatch", "_k11b", "K11b"),
    ("moe_dispatch", "_k12f", "K12f"), ("moe_dispatch", "_k12b", "K12b"),
]


@contextlib.contextmanager
def timed_launchers(spans: dict):
    """Record a pair of CUDA events around each call of a kernel launcher
    that launched its kernel (the energy score's takes its plain version
    where the JAX gates are off), appended to ``spans[label]``."""
    import importlib

    from ddm_tpu_torch.ops.kernel_config import launch_counts

    saved = []
    for mod_name, fn_name, label in LAUNCHERS:
        mod = importlib.import_module(f"ddm_tpu_torch.ops.{mod_name}")
        real = getattr(mod, fn_name)
        labels = (label,) if isinstance(label, str) else label

        def wrapped(*args, _real=real, _labels=labels, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            before = launch_counts()
            start.record()
            out = _real(*args, **kwargs)
            end.record()
            after = launch_counts()
            for lab in _labels:
                if after[lab] > before[lab]:
                    spans.setdefault(lab, []).append((start, end))
            return out

        saved.append((mod, fn_name, real))
        setattr(mod, fn_name, wrapped)
    try:
        yield
    finally:
        for mod, fn_name, real in saved:
            setattr(mod, fn_name, real)


def _device_ms(evt) -> float:
    return evt.self_device_time_total / 1e3


def profile_once(fn, label: str) -> None:
    """One call of ``fn`` under the profiler (kernel rows, busy share, peak
    memory), then one with its launchers timed by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and _device_ms(e) > 0]
    busy = sum(_device_ms(e) for e in kernels)
    print(f"[profile] {label}: wall {wall:.2f} ms under the profiler; kernel rows {busy:.2f} ms "
          f"= device busy {100 * busy / wall:.1f}%; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not kernels:
        print("[profile] no kernel rows: this profiler recorded no device time")
        return
    for e in sorted(kernels, key=lambda e: -_device_ms(e))[:TOP_ROWS]:
        print(f"[profile]   kernel {e.key[:70]:70s} {_device_ms(e):9.3f} ms "
              f"{e.count:5d} calls")
    spans: dict = {}
    with timed_launchers(spans):
        fn()
    torch.cuda.synchronize()
    for label, pairs in sorted(spans.items()):
        print(f"[profile]   launcher {label:5s} "
              f"{sum(s.elapsed_time(e) for s, e in pairs):9.3f} ms device, {len(pairs):4d} calls")


def main(argv=None) -> None:
    import train_cifar10_dit_torch as cli
    from ddm_tpu_torch.data.augment import augment_cifar10, normalize_images
    from ddm_tpu_torch.data.cifar10 import CIFAR10DataConfig, build_cifar10_dataloaders
    from ddm_tpu_torch.models.dit import init_params, patchify_images
    from ddm_tpu_torch.models.factory import build_model, make_tokens_apply
    from ddm_tpu_torch.ops.kernel_config import load_library
    from ddm_tpu_torch.sampling import sample_dddm_batched
    from ddm_tpu_torch.training import (clip_grads_by_global_norm_, make_loss_fn,
                                        make_optimizer, split_generator)

    parser = cli.build_parser()
    parser.add_argument("--profile-samples", type=int, default=0,
                        help="also time and profile the sampler on this many samples")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]

    model = build_model(vars(args), dev)
    init_params(model, torch.Generator().manual_seed(args.seed))
    load_library()
    loader, _ = build_cifar10_dataloaders(CIFAR10DataConfig(
        batch_size=args.batch, image_size=args.image_size, synthetic=True, seed=args.seed))
    images = torch.from_numpy(next(iter(loader))[0]).to(dev)
    optimizer = make_optimizer(model.parameters(), args.lr, args.weight_decay)
    loss_fn = make_loss_fn(make_tokens_apply(model, args.moe_aux_weight), m=args.m,
                           beta=args.beta, lam=args.lam, w_bias=args.w_bias,
                           target_transform=lambda a: patchify_images(a, args.patch_size))
    params = list(model.parameters())
    root = torch.Generator().manual_seed(args.seed)

    def step(mark=lambda i: None):
        kpre, key = split_generator(root, 2, dev)
        mark(0)
        x0 = normalize_images(images) if args.no_augment else augment_cifar10(images, kpre)
        optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(x0, key)
        mark(1)
        loss.backward()
        mark(2)
        if args.grad_clip > 0:
            clip_grads_by_global_norm_(params, args.grad_clip)
        mark(3)
        optimizer.step()
        mark(4)

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    phases = []
    for _ in range(TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        step(lambda i: ev[i].record())
        ev[4].synchronize()
        phases.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    med = np.median(np.asarray(phases), axis=0)
    wall = statistics.median(walls)
    what = (f"batch {args.batch} x m {args.m} at {args.image_size} px, depth {args.depth}"
            + (f", {args.moe_experts} experts top-{args.moe_topk}" if args.moe_experts > 1 else ""))
    print(f"[step] {what}: wall {wall:.2f} ms median of {len(walls)} "
          f"({min(walls):.2f}-{max(walls):.2f}) = {args.batch / wall * 1e3:.2f} img/s; "
          f"augment + forward + loss {med[0]:.2f} ms, backward {med[1]:.2f}, clip {med[2]:.2f}, "
          f"AdamW {med[3]:.2f} (CUDA events, median of {len(phases)}) on {smi}")
    profile_once(step, f"one training step ({what})")

    if args.profile_samples > 0:
        n, size = args.profile_samples, args.image_size

        def sample():
            return sample_dddm_batched(
                model, n, steps=args.sample_steps, eps_churn=args.eps_churn,
                data_shape=(size, size, 3), generator=split_generator(root, 1, dev)[0],
                device=dev, chunk_size=n)

        model.eval()
        with torch.inference_mode():
            sample()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                sample()
                times.append(time.perf_counter() - t0)
            s = statistics.median(times)
            print(f"[sample] {n} samples x {args.sample_steps} steps at {size} px: "
                  f"{s:.4f} s median of 3 ({min(times):.4f}-{max(times):.4f}) = "
                  f"{n / s:.2f} samples/s on {smi}")
            profile_once(sample, f"one sampler call ({n} x {args.sample_steps})")


if __name__ == "__main__":
    main()
