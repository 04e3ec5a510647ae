"""Drive the PyTorch port's DiT-S/4 sampling path once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises, so the exit code
is non-zero and no result line is printed:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles ``ddm_tpu_torch/csrc/*.cu`` with nvcc from the checkout;
3. kernels: K1 (MLP half-block) at (16384, 384, F=1536) and K2 (attention
   half-block) at (256, 64, 384, H=6) in bf16 against their plain PyTorch
   versions on the same seeded inputs, with median times from CUDA events;
4. model: a full-width DiT-S/4 with seeded weights, one forward through the
   kernels against one through the plain versions;
5. slice: that model saved as a checkpoint and sampled with
   ``generate_torch.main`` (256 samples, 20 steps), checking the outputs and
   that each kernel's launch counter rose by exactly 8 blocks x 20 steps.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

DEPTH, STEPS, N_SAMPLES = 8, 20, 256
# bf16 outputs: two units in the last place at the largest output magnitude
# (one rounding of a sum that the kernel and the plain version accumulate in
# different orders), and a mean error far below one unit.
KERNEL_MEAN_TOL = 1e-3


def _ulp2(ref: torch.Tensor) -> float:
    top = float(ref.float().abs().max())
    return 2.0 * 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name, smi


def phase_build(kc):
    path = kc.library_path()
    if path.exists():
        path.unlink()  # build from the checkout's sources in this run
    t0 = time.perf_counter()
    kc.load_library()
    seconds = time.perf_counter() - t0
    srcs = sorted(os.path.relpath(str(p)) for p in kc._CSRC.glob("*.cu*"))
    print(f"[build] nvcc sm_90a built {os.path.relpath(str(path))} from {srcs} "
          f"in {seconds:.2f} s")
    return seconds


def _kernel_args(gen, shape_x, weights):
    def r(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device="cuda") * scale
    x = r(*shape_x).to(torch.bfloat16)
    return (x,) + tuple(r(*s, scale=sc) + off for s, sc, off in weights)


def phase_kernels(M, A, smi):
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, D, F, B, N, H = 16384, 384, 1536, 256, 64, 6
    cases = [
        ("K1_mlp_half_block_fwd", "ddm_tpu_torch/csrc/gemm.cu",
         ["ddm_tpu_torch/csrc/gemm.cu", "ddm_tpu_torch/csrc/common.cuh"],
         "ddm_tpu/ops/mlp_block.py:144", M.fused_mlp_block, M.mlp_block_reference,
         _kernel_args(gen, (T, D), [((D,), 0.1, 1.0), ((D,), 0.1, 0.0),
                                    ((F, D), D ** -0.5, 0.0), ((F,), 0.1, 0.0),
                                    ((D, F), F ** -0.5, 0.0), ((D,), 0.1, 0.0)]),
         (), f"(T={T}, D={D}, F={F})"),
        ("K2_attention_half_block_fwd", "ddm_tpu_torch/csrc/attention.cu",
         ["ddm_tpu_torch/csrc/attention.cu", "ddm_tpu_torch/csrc/gemm.cu",
          "ddm_tpu_torch/csrc/common.cuh"],
         "ddm_tpu/ops/attention.py:341", A.fused_attention_block,
         A.attention_block_reference,
         _kernel_args(gen, (B, N, D), [((D,), 0.1, 1.0), ((D,), 0.1, 0.0),
                                       ((3 * D, D), D ** -0.5, 0.0), ((3 * D,), 0.1, 0.0),
                                       ((D, D), D ** -0.5, 0.0), ((D,), 0.1, 0.0)]),
         (H,), f"(B={B}, N={N}, D={D}, H={H})"),
    ]
    results = []
    with torch.inference_mode():
        for name, source, sources, replaces, kern, plain, args, extra, shape in cases:
            got = kern(*args, *extra)
            torch.cuda.synchronize()
            want = plain(*args, *extra)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            max_err, mean_err = float(err.max()), float(err.mean())
            tol = _ulp2(want)
            ms = _median_ms(lambda: kern(*args, *extra))
            plain_ms = _median_ms(lambda: plain(*args, *extra))
            print(f"[kernel] {name} {shape} bf16: max_abs_err={max_err:.6g} (tol {tol:.6g}), "
                  f"mean_abs_err={mean_err:.6g} (tol {KERNEL_MEAN_TOL:g}); "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20) on {smi}")
            if not (np.isfinite(max_err) and max_err <= tol and mean_err <= KERNEL_MEAN_TOL):
                raise AssertionError(f"{name} disagrees with its plain version")
            results.append({"name": name, "route": "cuda", "source": source,
                            "sources": sources, "replaces": replaces,
                            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms})
    return results


def plain_tokens(model, xt, t, xi):
    """The model's forward with every block through the plain versions."""
    from ddm_tpu_torch.ops.attention import attention_block_reference
    from ddm_tpu_torch.ops.mlp_block import mlp_block_reference

    h = model.embed_tokens(xt, t, xi)
    for blk in model.blocks:
        B, N, D = h.shape
        h = attention_block_reference(
            h, blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight, blk.attn.qkv.bias,
            blk.attn.proj.weight, blk.attn.proj.bias, blk.num_heads)
        ff_in, ff_out = blk.ff.net["0"], blk.ff.net["2"]
        h = mlp_block_reference(
            h.reshape(B * N, D), blk.norm2.weight, blk.norm2.bias, ff_in.weight,
            ff_in.bias, ff_out.weight, ff_out.bias).reshape(B, N, D)
    return model.head_tokens(h)


def phase_model(cfg):
    from ddm_tpu_torch.models.dit import init_params
    from ddm_tpu_torch.models.factory import build_model

    model = init_params(build_model(cfg, "cuda"), torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (N_SAMPLES, cfg["image_size"], cfg["image_size"], 3)
    xt = torch.randn(shape, generator=gen, device="cuda")
    xi = torch.randn(shape, generator=gen, device="cuda")
    t = torch.rand((N_SAMPLES,), generator=gen, device="cuda")
    model32 = init_params(build_model({**cfg, "dtype": "float32"}, "cuda"),
                          torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got = model.tokens(xt, t, xi)
        torch.cuda.synchronize()
        want = plain_tokens(model, xt, t, xi)
        want32 = plain_tokens(model32, xt, t, xi)
    err = float((got - want).abs().max())
    # tolerance: bf16's own rounding noise on this model. The plain bf16
    # forward lies within e = max |plain bf16 - plain fp32| of the fp32 one;
    # a kernel forward as accurate as it lies within 2e of the plain bf16.
    tol = 2.0 * float((want - want32).abs().max())
    print(f"[model] DiT-S/4 forward (B={N_SAMPLES}, depth {DEPTH}, bf16) kernels vs plain: "
          f"max_abs_err={err:.6g} (tol {tol:.6g} = 2 max |plain bf16 - plain fp32|), "
          f"output max |x| {float(want.abs().max()):.4g}")
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError("the kernel forward disagrees with the plain forward")
    return model


def phase_slice(model, cfg, M, A, name, smi):
    import generate_torch
    from ddm_tpu_torch.utils.checkpoint import save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model_final.pt")
        save_checkpoint(ckpt, model.state_dict(), cfg)
        npz, png = os.path.join(tmp, "samples.npz"), os.path.join(tmp, "samples.png")
        M.LAUNCHES.reset()
        A.LAUNCHES.reset()
        result = generate_torch.main([
            "--ckpt", ckpt, "--n", str(N_SAMPLES), "--batch", str(N_SAMPLES),
            "--steps", str(STEPS), "--device", "cuda", "--npz", npz, "--out", png])
        launches = {"K1_mlp_half_block_fwd": M.LAUNCHES.count,
                    "K2_attention_half_block_fwd": A.LAUNCHES.count}
        samples = np.load(npz)["samples"]
        if samples.shape != (N_SAMPLES, cfg["image_size"], cfg["image_size"], 3):
            raise AssertionError(f"samples have shape {samples.shape}")
        if not (np.isfinite(samples).all() and samples.min() >= -1 and samples.max() <= 1):
            raise AssertionError("samples are not finite values in [-1, 1]")
        if not os.path.getsize(png):
            raise AssertionError("no PNG written")
    want = DEPTH * STEPS
    for k, n in launches.items():
        if n != want:
            raise AssertionError(f"{k} launched {n} times in the slice, expected {want}")
    rate = N_SAMPLES / result["seconds"]
    print(f"[slice] generate_torch: {N_SAMPLES} samples x {STEPS} steps in "
          f"{result['seconds']:.3f} s = {rate:.2f} samples/s on {name} ({smi}); "
          f"launches {launches}; samples std {float(samples.std()):.4f}")
    return launches, rate


def main() -> None:
    name, smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False

    from ddm_tpu_torch.models.factory import MODEL_DEFAULTS
    from ddm_tpu_torch.ops import attention as A
    from ddm_tpu_torch.ops import kernel_config as kc
    from ddm_tpu_torch.ops import mlp_block as M

    phase_build(kc)
    kernels = phase_kernels(M, A, smi)
    cfg = {**MODEL_DEFAULTS, "depth": DEPTH, "sample_steps": STEPS, "eps_churn": 1.0}
    model = phase_model(cfg)
    launches, _ = phase_slice(model, cfg, M, A, name, smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
