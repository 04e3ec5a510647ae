"""Drive the PyTorch port's DiT-S/4 sampling and training paths once on one
NVIDIA GPU, at 32 px (N = 64 tokens) and at 128 px (N = 1024 tokens, the
long-sequence path through the flash-attention kernel K8).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises, so the exit code
is non-zero and no result line is printed:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles ``ddm_tpu_torch/csrc/*.cu`` with nvcc from the checkout
   (one nvcc per source, in parallel);
3. kernels: K1f (MLP half-block) at (16384, 384, F=1536) and K2f (attention
   half-block) at (256, 64, 384, H=6) in bf16 against their plain PyTorch
   versions on the same seeded inputs, with median times from CUDA events;
   3b. backward kernels: K1b at (131072, 384, F=1536) and K2b at
   (2048, 64, 384, H=6), the training shapes, against their plain backward
   versions, and a second call that must be bit-identical;
   3c. energy: K3f and K3b at (B=256, m=8, D=3072) fp32, beta 0.1 and 2.0;
   3d. flash: K8f and K8b at H = 6, Dh = 64 and (B, N) = (128, 1024) (the
   128-px training shape), (64, 1024) (sampling), (2, 4096) and (1, 16384)
   (image sizes 256 and 512), q, k and v read in place from a [q | k | v]
   buffer, against their plain versions (computed head by head) on the
   same inputs: o, dq, dk, dv by the bf16 rule below, lse to 1e-5
   relative; K8b's second call bit-identical;
4. model: a full-width DiT-S/4 with seeded weights, one forward through the
   kernels against one through the plain versions;
5. slice: that model saved as a checkpoint and sampled with
   ``generate_torch.main`` (256 samples, 20 steps), checking the outputs and
   that each forward kernel's launch counter rose by exactly 8 blocks x 20
   steps;
6. train step: one training step of the full-width DiT-S/4 (batch 256,
   m = 8, injected t, eps, xi) through the kernels, twice (bit-identical
   gradients), against one through the plain versions, within twice bf16's
   own noise on this step (plain bf16 against plain fp32);
   6b. the same at 128 px: batch 16 x m 8 at full width and depth, whose
   plain step holds one head's (128, 1024, 1024) fp32 scores (0.5 GB) at a
   time;
7. training slice: ``train_cifar10_dit_torch.main`` for one epoch of the
   2048 synthetic images (8 steps), checking finite losses, the launch
   counts (8 blocks x 8 steps for K1f/K2f/K1b/K2b, 8 for K3f/K3b) and that
   ``generate_torch.main`` samples from its ``model_final.pt``;
   7b. the long-sequence slice: ``--image-size 128 --batch 16 --m 8`` for
   one epoch (128 steps), checking finite losses and the launch counts
   (8 blocks x 128 steps for K8f/K8b/K1f/K1b, none of K2 or K3: the energy
   score takes its plain version at D = 49,152, as the JAX gate does), then
   64 samples of (128, 128, 3) from its ``model_final.pt`` (K8f = 8 x 20).

Every phase runs at full DiT-S/4 width and depth 8; the whole run takes a
few minutes of the 20 allowed, the kernels' build included.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

DEPTH, STEPS, N_SAMPLES = 8, 20, 256
TRAIN_BATCH, TRAIN_M, TRAIN_STEPS = 256, 8, 8  # 2048 synthetic images / 256
# bf16 outputs: two units in the last place at the largest output magnitude
# (one rounding of a sum that the kernel and the plain version accumulate in
# different orders), and a mean error far below one unit.
KERNEL_MEAN_TOL = 1e-3
# fp32 weight, bias and LN gradients of the backward kernels: sums over T
# rows where a flipped bf16 rounding upstream moves single entries
GRAD_MAX_REL, GRAD_FROB_REL = 1e-2, 1e-3
ENERGY_RTOL, ENERGY_GRAD_RTOL = 1e-5, 1e-4
LSE_RTOL = 1e-5
FLASH_HEADS = 6
FLASH_SHAPES = [(128, 1024), (64, 1024), (2, 4096), (1, 16384)]  # (B, N); the first is timed
LONG_SIZE, LONG_BATCH, LONG_M = 128, 16, 8
LONG_STEPS = 2048 // LONG_BATCH


def _ulp2(ref: torch.Tensor) -> float:
    top = float(ref.float().abs().max())
    return 2.0 * 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


def _bf16_errors(got: torch.Tensor, want: torch.Tensor):
    """``(max_err, mean_err, tol, ok)`` of a bf16 output by the kernel rule."""
    err = (got.float() - want.float()).abs()
    max_err, mean_err, tol = float(err.max()), float(err.mean()), _ulp2(want)
    return max_err, mean_err, tol, np.isfinite(max_err) and max_err <= tol and \
        mean_err <= KERNEL_MEAN_TOL


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


def _rel_frob(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm((a - b).float()) / torch.linalg.norm(b.float()).clamp_min(1e-30))


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


def _mlp_args(gen, T, D, F):
    return _kernel_args(gen, (T, D), [((D,), 0.1, 1.0), ((D,), 0.1, 0.0),
                                      ((F, D), D ** -0.5, 0.0), ((F,), 0.1, 0.0),
                                      ((D, F), F ** -0.5, 0.0), ((D,), 0.1, 0.0)])


def _attn_args(gen, B, N, D):
    return _kernel_args(gen, (B, N, D), [((D,), 0.1, 1.0), ((D,), 0.1, 0.0),
                                         ((3 * D, D), D ** -0.5, 0.0), ((3 * D,), 0.1, 0.0),
                                         ((D, D), D ** -0.5, 0.0), ((D,), 0.1, 0.0)])


def _entry(name, source, sources, replaces, max_err, ms, plain_ms):
    return {"name": name, "route": "cuda", "source": source, "sources": sources,
            "replaces": replaces, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def phase_kernels(M, A, smi):
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, D, F, B, N, H = 16384, 384, 1536, 256, 64, 6
    cases = [
        ("K1f", "ddm_tpu_torch/csrc/gemm.cu",
         ["ddm_tpu_torch/csrc/gemm.cu", "ddm_tpu_torch/csrc/common.cuh"],
         "ddm_tpu/ops/mlp_block.py:144", M.fused_mlp_block, M.mlp_block_reference,
         _mlp_args(gen, T, D, F), (), f"(T={T}, D={D}, F={F})"),
        ("K2f", "ddm_tpu_torch/csrc/attention.cu",
         ["ddm_tpu_torch/csrc/attention.cu", "ddm_tpu_torch/csrc/gemm.cu",
          "ddm_tpu_torch/csrc/common.cuh"],
         "ddm_tpu/ops/attention.py:341", A.fused_attention_block,
         A.attention_block_reference, _attn_args(gen, B, N, D), (H,),
         f"(B={B}, N={N}, D={D}, H={H})"),
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
            results.append(_entry(name, source, sources, replaces, max_err, ms, plain_ms))
    return results


def _check_grads(name, got, want, smi, ms, plain_ms):
    """dx (bf16) to two units in the last place and a mean below 1e-3; each
    fp32 gradient to 1e-2 of its largest entry and 1e-3 in Frobenius norm."""
    labels = ["dx", "dscale", "dbias", "dW_in", "db_in", "dW_out", "db_out"]
    worst = 0.0
    parts = []
    for i, (lab, g, w) in enumerate(zip(labels, got, want)):
        err = (g.float() - w.float()).abs()
        max_err, mean_err = float(err.max()), float(err.mean())
        worst = max(worst, max_err)
        if i == 0:
            tol = _ulp2(w)
            ok = max_err <= tol and mean_err <= KERNEL_MEAN_TOL
            parts.append(f"{lab} max {max_err:.4g} (tol {tol:.4g}) mean {mean_err:.3g}")
        else:
            tol = GRAD_MAX_REL * float(w.abs().max())
            frob = _rel_frob(g, w)
            ok = max_err <= tol and frob <= GRAD_FROB_REL
            parts.append(f"{lab} max {max_err:.4g} (tol {tol:.4g}) mean {mean_err:.3g} "
                         f"relF {frob:.3g}")
        if not (np.isfinite(max_err) and ok):
            raise AssertionError(f"{name} {lab} disagrees with its plain version")
    print(f"[kernel] {name}: " + "; ".join(parts)
          + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20) on {smi}")
    return worst


def phase_backward(M, A, smi):
    gen = torch.Generator(device="cuda").manual_seed(1)
    D, F, H, N = 384, 1536, 6, 64
    B = TRAIN_BATCH * TRAIN_M
    T = B * N
    mlp = _mlp_args(gen, T, D, F)
    attn = _attn_args(gen, B, N, D)
    dout_m = torch.randn(T, D, generator=gen, device="cuda").to(torch.bfloat16)
    dout_a = torch.randn(B, N, D, generator=gen, device="cuda").to(torch.bfloat16)
    cases = [
        ("K1b", "ddm_tpu_torch/csrc/gemm_bwd.cu",
         ["ddm_tpu_torch/csrc/gemm_bwd.cu", "ddm_tpu_torch/csrc/gemm.cu",
          "ddm_tpu_torch/csrc/common.cuh"],
         "ddm_tpu/ops/mlp_block.py:211",
         lambda: M.mlp_block_bwd(*mlp, dout_m), lambda: M.mlp_block_bwd_reference(*mlp, dout_m),
         f"(T={T}, D={D}, F={F})"),
        ("K2b", "ddm_tpu_torch/csrc/attention.cu",
         ["ddm_tpu_torch/csrc/attention.cu", "ddm_tpu_torch/csrc/gemm_bwd.cu",
          "ddm_tpu_torch/csrc/gemm.cu", "ddm_tpu_torch/csrc/common.cuh"],
         "ddm_tpu/ops/attention.py:358",
         lambda: A.attention_block_bwd(*attn, H, dout_a),
         lambda: A.attention_block_bwd_reference(*attn, H, dout_a),
         f"(B={B}, N={N}, D={D}, H={H})"),
    ]
    results = []
    with torch.no_grad():
        for name, source, sources, replaces, kern, plain, shape in cases:
            got = kern()
            again = kern()
            torch.cuda.synchronize()
            if not all(torch.equal(g, h) for g, h in zip(got, again)):
                raise AssertionError(f"{name} is not deterministic: two calls differ")
            want = plain()
            ms = _median_ms(kern)
            plain_ms = _median_ms(plain)
            worst = _check_grads(f"{name} {shape} bf16 (second call bit-identical)",
                                 got, want, smi, ms, plain_ms)
            results.append(_entry(name, source, sources, replaces, worst, ms, plain_ms))
            del got, again, want
            torch.cuda.empty_cache()
    return results


def phase_energy(E, smi):
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, m, D = TRAIN_BATCH, TRAIN_M, 3072
    xh = torch.randn(B, m, D, generator=gen, device="cuda")
    x0 = torch.randn(B, D, generator=gen, device="cuda")
    gconf, ginter = (torch.tensor(v, device="cuda") for v in (0.7, -0.3))
    timings = {}
    worst = {"K3f": 0.0, "K3b": 0.0}
    for beta in (0.1, 2.0):
        conf, inter = E.energy_terms(xh, x0, beta)
        dxh, dx0 = E.energy_terms_bwd(xh, x0, beta, gconf, ginter)
        torch.cuda.synchronize()
        want_c, want_i = E.energy_terms_reference(xh, x0, beta)
        want_dxh, want_dx0 = E.energy_terms_bwd_reference(xh, x0, beta, gconf, ginter)
        rc = abs(float(conf - want_c)) / abs(float(want_c))
        ri = abs(float(inter - want_i)) / abs(float(want_i))
        gx = float((dxh - want_dxh).abs().max()) / float(want_dxh.abs().max())
        g0 = float((dx0 - want_dx0).abs().max()) / float(want_dx0.abs().max())
        worst["K3f"] = max(worst["K3f"], abs(float(conf - want_c)), abs(float(inter - want_i)))
        worst["K3b"] = max(worst["K3b"], float((dxh - want_dxh).abs().max()),
                           float((dx0 - want_dx0).abs().max()))
        if beta == 0.1:  # time at the recipe's beta
            timings = {
                "K3f": (_median_ms(lambda: E.energy_terms(xh, x0, beta)),
                        _median_ms(lambda: E.energy_terms_reference(xh, x0, beta))),
                "K3b": (_median_ms(lambda: E.energy_terms_bwd(xh, x0, beta, gconf, ginter)),
                        _median_ms(lambda: E.energy_terms_bwd_reference(
                            xh, x0, beta, gconf, ginter))),
            }
        print(f"[kernel] K3 (B={B}, m={m}, D={D}) fp32 beta={beta}: conf rel err {rc:.3g}, "
              f"inter rel err {ri:.3g} (tol {ENERGY_RTOL:g}); dxh {gx:.3g}, dx0 {g0:.3g} "
              f"of their max (tol {ENERGY_GRAD_RTOL:g}) on {smi}")
        if not (rc <= ENERGY_RTOL and ri <= ENERGY_RTOL and gx <= ENERGY_GRAD_RTOL
                and g0 <= ENERGY_GRAD_RTOL):
            raise AssertionError(f"K3 disagrees with its plain version at beta={beta}")
    for name in ("K3f", "K3b"):
        print(f"[kernel] {name} (B={B}, m={m}, D={D}) beta=0.1: kernel {timings[name][0]:.4f} ms, "
              f"plain {timings[name][1]:.4f} ms (median of 20) on {smi}")
    return [_entry(name, "ddm_tpu_torch/csrc/energy.cu",
                   ["ddm_tpu_torch/csrc/energy.cu", "ddm_tpu_torch/csrc/common.cuh"],
                   f"ddm_tpu/ops/energy.py:{line}", worst[name], *timings[name])
            for name, line in (("K3f", 88), ("K3b", 112))]


def phase_flash(FL, smi):
    gen = torch.Generator(device="cuda").manual_seed(4)
    H, D = FLASH_HEADS, FLASH_HEADS * FL.HEAD_DIM
    worst = {"K8f": 0.0, "K8b": 0.0}
    shapes = []
    for B, N in FLASH_SHAPES:
        qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.split(D, dim=-1)  # read in place, row stride 3D
        do = torch.randn(B, N, D, generator=gen, device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            o, lse = FL.flash_attention_fwd(q, k, v, H)
            grads = FL.flash_attention_bwd(q, k, v, o, lse, do, H)
            again = FL.flash_attention_bwd(q, k, v, o, lse, do, H)
            torch.cuda.synchronize()
            if not all(torch.equal(g, h) for g, h in zip(grads, again)):
                raise AssertionError(f"K8b is not deterministic at (B={B}, N={N})")
            want_o, want_lse = FL.flash_attention_reference(q, k, v, H)
            want = FL.flash_attention_bwd_reference(q, k, v, o, lse, do, H)
            torch.cuda.synchronize()
        lse_rel = float(((lse - want_lse).abs() / want_lse.abs()).max())
        parts, ok = [], lse_rel <= LSE_RTOL
        for label, g, w in zip(("o", "dq", "dk", "dv"), (o, *grads), (want_o, *want)):
            max_err, mean_err, tol, good = _bf16_errors(g, w)
            ok = ok and good
            key = "K8f" if label == "o" else "K8b"
            worst[key] = max(worst[key], max_err)
            parts.append(f"{label} max {max_err:.4g} (tol {tol:.4g}) mean {mean_err:.3g}")
        del grads, again, want, want_o, want_lse
        times = {"fwd": _median_ms(lambda: FL.flash_attention_fwd(q, k, v, H)),
                 "plain_fwd": _median_ms(lambda: FL.flash_attention_reference(q, k, v, H)),
                 "bwd": _median_ms(lambda: FL.flash_attention_bwd(q, k, v, o, lse, do, H)),
                 "plain_bwd": _median_ms(
                     lambda: FL.flash_attention_bwd_reference(q, k, v, o, lse, do, H))}
        print(f"[kernel] K8 (B={B}, N={N}, H={H}, Dh={FL.HEAD_DIM}) bf16: " + "; ".join(parts)
              + f"; lse max rel err {lse_rel:.3g} (tol {LSE_RTOL:g}); K8b second call "
              f"bit-identical; K8f {times['fwd']:.4f} ms, plain {times['plain_fwd']:.4f} ms; "
              f"K8b {times['bwd']:.4f} ms, plain {times['plain_bwd']:.4f} ms (median of 20) "
              f"on {smi}")
        if not ok:
            raise AssertionError(f"K8 disagrees with its plain version at (B={B}, N={N})")
        shapes.append({"B": B, "N": N, **times})
        del qkv, q, k, v, do, o, lse
        torch.cuda.empty_cache()
    srcs = ["ddm_tpu_torch/csrc/flash.cu", "ddm_tpu_torch/csrc/common.cuh"]
    entries = [_entry("K8f", srcs[0], srcs, "ddm_tpu/ops/flash.py:330", worst["K8f"],
                      shapes[0]["fwd"], shapes[0]["plain_fwd"]),
               _entry("K8b", srcs[0], srcs, "ddm_tpu/ops/flash.py:372", worst["K8b"],
                      shapes[0]["bwd"], shapes[0]["plain_bwd"])]
    for e in entries:
        e["shapes"] = [{"B": t["B"], "N": t["N"],
                        "ms": t["fwd" if e["name"] == "K8f" else "bwd"],
                        "plain_ms": t["plain_fwd" if e["name"] == "K8f" else "plain_bwd"]}
                       for t in shapes]
    return entries


def phase_model(cfg, smi):
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
        with plain_ops():
            want = model.tokens(xt, t, xi)
            want32 = model32.tokens(xt, t, xi)
    err = float((got - want).abs().max())
    # tolerance: bf16's own rounding noise on this model. The plain bf16
    # forward lies within e = max |plain bf16 - plain fp32| of the fp32 one;
    # a kernel forward as accurate as it lies within 2e of the plain bf16.
    tol = 2.0 * float((want - want32).abs().max())
    print(f"[model] DiT-S/4 forward (B={N_SAMPLES}, depth {DEPTH}, bf16) kernels vs plain: "
          f"max_abs_err={err:.6g} (tol {tol:.6g} = 2 max |plain bf16 - plain fp32|), "
          f"output max |x| {float(want.abs().max()):.4g} on {smi}")
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError("the kernel forward disagrees with the plain forward")
    return model


def phase_slice(model, cfg, kc, name, smi):
    import generate_torch
    from ddm_tpu_torch.utils.checkpoint import save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model_final.pt")
        save_checkpoint(ckpt, model.state_dict(), cfg)
        npz, png = os.path.join(tmp, "samples.npz"), os.path.join(tmp, "samples.png")
        kc.reset_launch_counts()
        result = generate_torch.main([
            "--ckpt", ckpt, "--n", str(N_SAMPLES), "--batch", str(N_SAMPLES),
            "--steps", str(STEPS), "--device", "cuda", "--npz", npz, "--out", png])
        launches = kc.launch_counts()
        samples = np.load(npz)["samples"]
        if samples.shape != (N_SAMPLES, cfg["image_size"], cfg["image_size"], 3):
            raise AssertionError(f"samples have shape {samples.shape}")
        if not (np.isfinite(samples).all() and samples.min() >= -1 and samples.max() <= 1):
            raise AssertionError("samples are not finite values in [-1, 1]")
        if not os.path.getsize(png):
            raise AssertionError("no PNG written")
    want = {k: DEPTH * STEPS if k in ("K1f", "K2f") else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"sampling launched {launches}, expected {want}")
    rate = N_SAMPLES / result["seconds"]
    print(f"[slice] generate_torch: {N_SAMPLES} samples x {STEPS} steps in "
          f"{result['seconds']:.3f} s = {rate:.2f} samples/s on {name} ({smi}); "
          f"launches {launches}; samples std {float(samples.std()):.4f}")
    return launches


class _Plain(torch.autograd.Function):
    """A plain forward with its explicit plain backward, on any device."""

    @staticmethod
    def forward(ctx, fwd, bwd, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.bwd = bwd
        return fwd(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.bwd(*ctx.saved_tensors, *grads))


@contextlib.contextmanager
def plain_ops():
    """Route the model's half-blocks and the step's energy score through the
    plain versions (forward and backward) on the card."""
    from ddm_tpu_torch import training
    from ddm_tpu_torch.models import dit
    from ddm_tpu_torch.ops import attention as A
    from ddm_tpu_torch.ops import energy as E
    from ddm_tpu_torch.ops import mlp_block as M

    def mlp(*t):
        return _Plain.apply(M.mlp_block_reference, M.mlp_block_bwd_reference, *t)

    def attn(*t_and_h):
        *t, H = t_and_h
        fwd, bwd = ((A.attention_block_reference, A.attention_block_bwd_reference)
                    if t[0].shape[1] <= A.MAX_TOKENS else
                    (A.long_attention_block_reference, A.long_attention_block_bwd_reference))
        return _Plain.apply(lambda *a: fwd(*a, H), lambda *a: bwd(*a[:7], H, a[7]), *t)

    def energy(xh, x0, beta):
        return _Plain.apply(lambda *a: E.energy_terms_reference(*a, beta),
                            lambda xh_, x0_, gc, gi: E.energy_terms_bwd_reference(
                                xh_, x0_, beta, gc, gi),
                            xh.float().contiguous(), x0.float().contiguous())

    saved = (dit.fused_mlp_block, dit.fused_attention_block, training.fused_energy_terms)
    dit.fused_mlp_block, dit.fused_attention_block, training.fused_energy_terms = mlp, attn, energy
    try:
        yield
    finally:
        dit.fused_mlp_block, dit.fused_attention_block, training.fused_energy_terms = saved


def phase_train_step(cfg, smi, batch=TRAIN_BATCH, m=TRAIN_M, label="train-step"):
    from ddm_tpu_torch.data.augment import normalize_images
    from ddm_tpu_torch.data.cifar10 import CIFAR10DataConfig, build_cifar10_dataloaders
    from ddm_tpu_torch.models.dit import init_params, patchify_images
    from ddm_tpu_torch.models.factory import build_model
    from ddm_tpu_torch.training import distributional_training_step

    beta, size = 0.1, cfg["image_size"]
    data = CIFAR10DataConfig(batch_size=batch, image_size=size, synthetic=True)
    if size != 32:
        data.synthetic_size = batch  # resize one batch, not the whole set
    loader, _ = build_cifar10_dataloaders(data)
    images, _ = next(iter(loader))
    x0 = normalize_images(torch.from_numpy(images).cuda())
    gen = torch.Generator(device="cuda").manual_seed(3)
    t = torch.rand((batch,), generator=gen, device="cuda")
    eps = torch.randn(x0.shape, generator=gen, device="cuda")
    xi = torch.randn((batch, m, size, size, 3), generator=gen, device="cuda")

    def step(dtype):
        model = init_params(build_model({**cfg, "dtype": dtype}, "cuda"),
                            torch.Generator().manual_seed(0))
        loss, metrics = distributional_training_step(
            model.tokens, x0, m=m, beta=beta, lam=1.0, w_bias=0.0, t=t, eps=eps, xi=xi,
            target_transform=lambda a: patchify_images(a, cfg["patch_size"]))
        loss.backward()
        torch.cuda.synchronize()
        grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        return {k: float(v.detach()) for k, v in metrics.items()}, grads

    t0 = time.perf_counter()
    got, g_got = step("bfloat16")
    seconds = time.perf_counter() - t0
    again, g_again = step("bfloat16")
    if again != got or any(not torch.equal(g_got[k], g_again[k]) for k in g_got):
        raise AssertionError("two kernel training steps on the same inputs differ")
    with plain_ops():
        want, g_want = step("bfloat16")
        want32, g_want32 = step("float32")

    lines = []
    for k in ("loss", "confidence", "interaction"):
        err, tol = abs(got[k] - want[k]), 2.0 * abs(want[k] - want32[k])
        lines.append(f"{k} {got[k]:.6f} vs plain {want[k]:.6f} (err {err:.3g}, tol {tol:.3g})")
        if not (np.isfinite(got[k]) and err <= tol):
            raise AssertionError(f"the kernel step's {k} disagrees with the plain step")
    worst = ("", 0.0)
    for k in g_want:
        err, tol = _rel_frob(g_got[k], g_want[k]), 2.0 * _rel_frob(g_want[k], g_want32[k])
        if not (torch.isfinite(g_got[k]).all() and err <= tol):
            raise AssertionError(f"gradient of {k} disagrees: relF {err:.3g} > tol {tol:.3g}")
        worst = max(worst, (k, err / tol), key=lambda kv: kv[1])
    print(f"[{label}] DiT-S/4 at {size} px (N = {(size // cfg['patch_size']) ** 2} tokens, "
          f"depth {cfg['depth']}) one step (batch {batch} x m {m}, injected t/eps/xi) "
          f"kernels vs plain (tol = 2 |plain bf16 - plain fp32|): " + "; ".join(lines)
          + f"; {len(g_want)} parameter gradients within tol (relative Frobenius), "
          f"tightest {worst[0]} at {worst[1]:.3f} of tol; second kernel step bit-identical; "
          f"first (cold) step {seconds:.3f} s on {smi}")


def phase_train(kc, name, smi):
    import generate_torch
    import train_cifar10_dit_torch

    with tempfile.TemporaryDirectory() as tmp:
        kc.reset_launch_counts()
        result = train_cifar10_dit_torch.main([
            "--synthetic", "--epochs", "1", "--batch", str(TRAIN_BATCH), "--m", str(TRAIN_M),
            "--sample-batch", "64", "--log-every", "1", "--device", "cuda", "--out", tmp])
        total = kc.launch_counts()
        with open(os.path.join(tmp, "train_metrics.json"), encoding="utf-8") as f:
            losses = json.load(f)["loss"]
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"training losses are not {TRAIN_STEPS} finite values: {losses}")
        npz = os.path.join(tmp, "s.npz")
        generate_torch.main(["--ckpt", os.path.join(tmp, "model_final.pt"), "--n", "64",
                             "--batch", "64", "--device", "cuda", "--npz", npz, "--out", ""])
        samples = np.load(npz)["samples"]
        if not (np.isfinite(samples).all() and samples.min() >= -1 and samples.max() <= 1):
            raise AssertionError("samples from the trained checkpoint are not in [-1, 1]")
        for art in ("model_epoch001.pt", "config.json", "samples.png", "epoch_metrics.json"):
            if not os.path.getsize(os.path.join(tmp, art)):
                raise AssertionError(f"the trainer wrote no {art}")
    per_block = DEPTH * TRAIN_STEPS
    train, sample = result["launches"]["train"], result["launches"]["sample"]
    want_train = {k: 0 for k in train}  # K8f/K8b: none at 32 px
    want_train.update({"K1f": per_block, "K2f": per_block, "K1b": per_block, "K2b": per_block,
                       "K3f": TRAIN_STEPS, "K3b": TRAIN_STEPS})
    want_sample = {k: DEPTH * STEPS if k in ("K1f", "K2f") else 0 for k in want_train}
    if train != want_train or sample != want_sample:
        raise AssertionError(f"training launched {train} and its sampler {sample}, expected "
                             f"{want_train} and {want_sample}")
    if total != {k: train[k] + sample[k] for k in train}:
        raise AssertionError(f"the counts read after the run, {total}, do not add up")
    ms = 1e3 * result["seconds_per_step"]
    print(f"[train] train_cifar10_dit_torch: {TRAIN_STEPS} steps (batch {TRAIN_BATCH} x "
          f"m {TRAIN_M}), losses {[round(v, 6) for v in losses]}; warm step {ms:.2f} ms "
          f"(median of steps 2-{TRAIN_STEPS}) = {TRAIN_BATCH / ms * 1e3:.2f} img/s, "
          f"{TRAIN_BATCH * TRAIN_M / ms * 1e3:.2f} denoiser rows/s; epoch incl. first step "
          f"{result['images_per_sec']:.2f} img/s on {name} ({smi}); launches in training "
          f"{train}, in its sampler {sample}; model_final.pt sampled by generate_torch")
    return train


def phase_train_long(kc, name, smi):
    import generate_torch
    import train_cifar10_dit_torch

    with tempfile.TemporaryDirectory() as tmp:
        kc.reset_launch_counts()
        result = train_cifar10_dit_torch.main([
            "--synthetic", "--image-size", str(LONG_SIZE), "--epochs", "1",
            "--batch", str(LONG_BATCH), "--m", str(LONG_M), "--sample-batch", "64",
            "--log-every", "1", "--device", "cuda", "--out", tmp])
        total = kc.launch_counts()
        with open(os.path.join(tmp, "train_metrics.json"), encoding="utf-8") as f:
            losses = json.load(f)["loss"]
        if len(losses) != LONG_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"128-px training losses are not {LONG_STEPS} finite values")
        npz = os.path.join(tmp, "s.npz")
        kc.reset_launch_counts()
        sampled = generate_torch.main([
            "--ckpt", os.path.join(tmp, "model_final.pt"), "--n", "64", "--batch", "64",
            "--device", "cuda", "--npz", npz, "--out", ""])
        generated = kc.launch_counts()
        samples = np.load(npz)["samples"]
    if samples.shape != (64, LONG_SIZE, LONG_SIZE, 3):
        raise AssertionError(f"128-px samples have shape {samples.shape}")
    if not (np.isfinite(samples).all() and samples.min() >= -1 and samples.max() <= 1):
        raise AssertionError("128-px samples are not finite values in [-1, 1]")
    per_block = DEPTH * LONG_STEPS
    train, sample = result["launches"]["train"], result["launches"]["sample"]
    want_train = {k: per_block if k in ("K1f", "K1b", "K8f", "K8b") else 0 for k in train}
    want_sample = {k: DEPTH * STEPS if k in ("K1f", "K8f") else 0 for k in train}
    if train != want_train or sample != want_sample or generated != want_sample:
        raise AssertionError(f"the 128-px run launched {train} in training, {sample} in its "
                             f"sampler and {generated} in generate_torch, expected "
                             f"{want_train}, {want_sample} and {want_sample}")
    if total != {k: train[k] + sample[k] for k in train}:
        raise AssertionError(f"the counts read after the 128-px run, {total}, do not add up")
    ms = 1e3 * result["seconds_per_step"]
    print(f"[train-128] train_cifar10_dit_torch --image-size {LONG_SIZE}: {LONG_STEPS} steps "
          f"(batch {LONG_BATCH} x m {LONG_M}, N = 1024 tokens), losses first "
          f"{[round(v, 6) for v in losses[:3]]} last {[round(v, 6) for v in losses[-3:]]}; "
          f"warm step {ms:.2f} ms (median of steps 2-{LONG_STEPS}) = "
          f"{LONG_BATCH / ms * 1e3:.2f} img/s, {LONG_BATCH * LONG_M / ms * 1e3:.2f} denoiser "
          f"rows/s; generate_torch 64 samples (128, 128, 3) x {STEPS} steps in "
          f"{sampled['seconds']:.3f} s = {64 / sampled['seconds']:.2f} samples/s; launches in "
          f"training {train}, in its sampler {sample}, in generate_torch {generated}; "
          f"on {name} ({smi})")
    return train, generated


def main() -> None:
    name, smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False

    from ddm_tpu_torch.models.factory import MODEL_DEFAULTS
    from ddm_tpu_torch.ops import attention as A
    from ddm_tpu_torch.ops import energy as E
    from ddm_tpu_torch.ops import flash as FL
    from ddm_tpu_torch.ops import kernel_config as kc
    from ddm_tpu_torch.ops import mlp_block as M

    phase_build(kc)
    kernels = phase_kernels(M, A, smi)
    kernels += phase_backward(M, A, smi)
    kernels += phase_energy(E, smi)
    flash = phase_flash(FL, smi)
    torch.cuda.empty_cache()
    cfg = {**MODEL_DEFAULTS, "depth": DEPTH, "sample_steps": STEPS, "eps_churn": 1.0}
    model = phase_model(cfg, smi)
    sampled = phase_slice(model, cfg, kc, name, smi)
    del model
    torch.cuda.empty_cache()
    phase_train_step(cfg, smi)
    torch.cuda.empty_cache()
    phase_train_step({**cfg, "image_size": LONG_SIZE}, smi, LONG_BATCH, LONG_M, "train-step-128")
    torch.cuda.empty_cache()
    trained = phase_train(kc, name, smi)
    torch.cuda.empty_cache()
    trained_long, sampled_long = phase_train_long(kc, name, smi)
    for k in kernels:
        k["launches"] = trained[k["name"]]
        if k["name"] in ("K1f", "K2f"):
            k["sample_launches"] = sampled[k["name"]]
    for k in flash:
        k["launches"] = trained_long[k["name"]]
        if k["name"] == "K8f":
            k["sample_launches"] = sampled_long["K8f"]
    kernels += flash
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
