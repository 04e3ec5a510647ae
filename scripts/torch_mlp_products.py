"""Time the wgmma products of K1f and K1b (``csrc/gemm_wg.cu``) one by one on
one NVIDIA GPU, beside the WMMA kernel that computed each before
(``csrc/gemm.cu``, ``csrc/gemm_bwd.cu``) and one ``torch.matmul`` of the same
operands.

From the repository root:

    PYTHONPATH=. python scripts/torch_mlp_products.py

On seeded inputs at DiT-S/4's (131,072, 384, F 1536) and DiT-XL/4's
(131,072, 1152, F 4608) training shapes it times, by CUDA events (median of
20 after 3 warm-up, in turns wgmma, WMMA, matmul, matmul, WMMA, wgmma): the
LN-prologue product (GELU; GELU with gelu' and y), the residual product, dh
(NN with the gelu' epilogue and db1) and dy (NN, fp32), dW2 + db2 and dW1
(TN, split-K). It prints the card's name and power limit, one table, and
one JSON line with every number.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ddm_tpu_torch.ops import gemm as G

SHAPES = ((131072, 384, 1536), (131072, 1152, 4608))


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def inputs(T, D, F, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*s, scale=1.0, off=0.0):
        return torch.randn(*s, generator=gen, device="cuda") * scale + off

    bf = torch.bfloat16
    return dict(x=r(T, D).to(bf), scale=r(D, scale=0.1, off=1.0), bias=r(D, scale=0.1),
                w1=(r(F, D) * D ** -0.5).to(bf), b1=r(F, scale=0.1),
                w2=(r(D, F) * F ** -0.5).to(bf), b2=r(D, scale=0.1),
                g=r(T, F).to(bf), dfac=torch.rand(T, F, generator=gen, device="cuda"),
                do=r(T, D).to(bf))


def products(a):
    """Each product as (wgmma, WMMA, one torch.matmul of its operands)."""
    x, s, b, w1, b1, w2, b2, g, dfac, do = (a[k] for k in (
        "x", "scale", "bias", "w1", "b1", "w2", "b2", "g", "dfac", "do"))
    return {
        "LN product GELU": (lambda: G.ln_gemm_wg(x, s, b, w1, b1, G.EPI_GELU),
                            lambda: G.ln_gemm(x, s, b, w1, b1, G.EPI_GELU),
                            lambda: x @ w1.t()),
        "LN product gelu' y": (
            lambda: G.ln_gemm_wg(x, s, b, w1, b1, G.EPI_GELU_GRAD, with_y=True),
            lambda: G.ln_gemm(x, s, b, w1, b1, G.EPI_GELU_GRAD, with_y=True),
            lambda: x @ w1.t()),
        "residual": (lambda: G.gemm_residual_wg(g, w2, b2, x),
                     lambda: G.gemm_residual(g, w2, b2, x), lambda: g @ w2.t()),
        "dh": (lambda: G.expert_nn_wg(do, w2, G.NN_DGELU, dfac=dfac),
               lambda: G.gemm_nn(do, w2, G.NN_DGELU, dfac=dfac), lambda: do @ w2),
        "dy": (lambda: G.expert_nn_wg(g, w1, G.NN_F32), lambda: G.gemm_nn(g, w1, G.NN_F32),
               lambda: g @ w1),
        "dW2 + db2": (lambda: G.expert_tn_wg(do, g, with_colsum=True),
                      lambda: G.gemm_tn(do, g, with_colsum=True), lambda: do.t() @ g),
        "dW1": (lambda: G.expert_tn_wg(g, x), lambda: G.gemm_tn(g, x), lambda: g.t() @ x),
    }


def product_times() -> dict:
    out = {}
    for T, D, F in SHAPES:
        a = inputs(T, D, F)
        rows = {}
        with torch.no_grad():
            for name, (wg, wmma, mm) in products(a).items():
                fns = {"wgmma": wg, "wmma": wmma, "matmul": mm}
                got = {k: [] for k in fns}
                for k in list(fns) + list(fns)[::-1]:
                    got[k].append(median_ms(fns[k]))
                rows[name] = {k: float(np.mean(v)) for k, v in got.items()}
                print(f"  ({T}, {D}, {F}) {name:20s} wgmma {rows[name]['wgmma']:.4f}  "
                      f"WMMA {rows[name]['wmma']:.4f}  matmul {rows[name]['matmul']:.4f} ms")
        out[f"{T},{D},{F}"] = rows
        del a
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_mlp_products.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print("ms, means of two medians of 20 (in turns wgmma, WMMA, matmul, matmul, WMMA, wgmma):")
    res = {"device": smi, "products": product_times()}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
