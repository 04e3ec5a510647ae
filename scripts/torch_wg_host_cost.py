"""The host cost of the dense wgmma launchers (``ops/gemm.py``,
``csrc/gemm_wg.cu``) and the DiT-S/4 sampler that they serve, on one card.
Run it from the root of each checkout to compare, in turns (A, B, B, A):

    PYTHONPATH=. python scripts/torch_wg_host_cost.py [--sampler-reps 15]

It prints:

- a TMA descriptor's encoding on the host (``ddm_wg_encode_cost``, the mean
  of 10,000 encodings of one map);
- each dense launcher's host time a call, the median of 2,000 readings of the
  host clock around the call alone (the launches queue; the device runs
  behind) at a small shape, (T 256, D 64, F 256): the LN-prologue product,
  the residual product, the NN products (fp32; dh with db1), the TN product
  with its column sums, and the K1f and K1b chains. A checkout whose dense
  NN and TN products still have launchers of their own (``gemm_nn_wg``,
  ``gemm_tn_wg``) is timed through those, else through ``expert_nn_wg`` and
  ``expert_tn_wg`` on 2-D operands;
- the DiT-S/4 sampler (256 samples x 20 steps at 32 px, the trainer's
  defaults, random weights from its seed): two warm-up calls, then the
  median, the spread and every reading of ``--sampler-reps`` calls.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import time

import torch


def _host_us(fn, n: int = 2000) -> float:
    """Median host microseconds of ``fn()`` alone over n calls."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    got = []
    for i in range(n):
        t0 = time.perf_counter()
        fn()
        got.append(1e6 * (time.perf_counter() - t0))
        if i % 200 == 199:
            torch.cuda.synchronize()  # keep the launch queue short
    torch.cuda.synchronize()
    return statistics.median(got)


def launchers() -> None:
    from ddm_tpu_torch.ops import gemm as G
    from ddm_tpu_torch.ops import mlp_block as M
    from ddm_tpu_torch.ops.kernel_config import check_status, load_library

    T, D, F = 256, 64, 256
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn(T, D, generator=gen, device="cuda").to(bf)
    s, b = torch.ones(D, device="cuda"), torch.zeros(D, device="cuda")
    w1 = (0.1 * torch.randn(F, D, generator=gen, device="cuda")).to(bf)
    b1 = torch.zeros(F, device="cuda")
    w2 = (0.1 * torch.randn(D, F, generator=gen, device="cuda")).to(bf)
    g, dfac, y = G.ln_gemm_wg(x, s, b, w1, b1, G.EPI_GELU_GRAD, with_y=True)
    dense = hasattr(G, "gemm_nn_wg")
    nn = G.gemm_nn_wg if dense else G.expert_nn_wg
    tn = G.gemm_tn_wg if dense else G.expert_tn_wg
    us = ctypes.c_float()
    check_status(load_library().ddm_wg_encode_cost(x.data_ptr(), T, D, 10000,
                                                   ctypes.addressof(us)), "encode_cost")
    via = "gemm_nn_wg / gemm_tn_wg" if dense else "expert_nn_wg / expert_tn_wg"
    print(f"[host] TMA descriptor encoding: {us.value:.4f} us a map (mean of 10,000); dense "
          f"products through {via}", flush=True)
    fns = {
        "ln_gemm_wg (GELU)": lambda: G.ln_gemm_wg(x, s, b, w1, b1, G.EPI_GELU),
        "gemm_residual_wg": lambda: G.gemm_residual_wg(g, w2, b, x),
        "NN fp32 (dy)": lambda: nn(g, w1, G.NN_F32),
        "NN dh + db1": lambda: nn(x, w2, G.NN_DGELU, dfac=dfac),
        "TN + colsum (dW2, db2)": lambda: tn(x, g, with_colsum=True),
        "K1f chain": lambda: M._k1f(x, s, b, w1, b1, w2, b),
        "K1b chain": lambda: M._k1b(x, s, b, w1, b1, w2, b, x),
    }
    with torch.no_grad():
        for name, fn in fns.items():
            print(f"[host] {name}: {_host_us(fn):.2f} us a call on the host (median of 2,000)",
                  flush=True)


def sampler(reps: int) -> None:
    import train_cifar10_dit_torch as cli
    from ddm_tpu_torch.models.dit import init_params
    from ddm_tpu_torch.models.factory import build_model
    from ddm_tpu_torch.sampling import sample_dddm_batched
    from ddm_tpu_torch.training import split_generator

    args = cli.build_parser().parse_args([])
    dev = torch.device("cuda")
    model = build_model(vars(args), dev)
    init_params(model, torch.Generator().manual_seed(args.seed))
    model.eval()
    root = torch.Generator().manual_seed(args.seed)
    n, size = 256, args.image_size

    def sample():
        return sample_dddm_batched(model, n, steps=args.sample_steps, eps_churn=args.eps_churn,
                                   data_shape=(size, size, 3),
                                   generator=split_generator(root, 1, dev)[0], device=dev,
                                   chunk_size=n)

    with torch.inference_mode():
        for _ in range(2):
            sample()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            sample()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    print(f"[host] DiT-S/4 sampler ({n} x {args.sample_steps} at {size} px): "
          f"{statistics.median(times):.4f} s median of {reps} ({min(times):.4f}-{max(times):.4f}); "
          f"every reading {[round(t, 4) for t in times]}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sampler-reps", type=int, default=15)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_wg_host_cost: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"[host] on {smi}", flush=True)
    launchers()
    sampler(args.sampler_reps)


if __name__ == "__main__":
    main()
