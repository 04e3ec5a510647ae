"""The attention-backward ablation on one NVIDIA GPU: X3's variants of K2b's
chain and core (``ddm_tpu_torch/ops/attention_ablate.py``), each with one
phase removed, timed against the whole; and K1f with its GELU removed. The
port of ``tools/kbench_ablate.py``'s measurement.

From the repository root:

    PYTHONPATH=. python scripts/torch_kbench_ablate.py [--reps 30] [--turns 1]

It prints the card's name and power limit, then, on the same seeded inputs
(the tool's: bf16 normal x and cotangent, unit LN scale, zero biases, 0.02
x normal weights):

- whether the all-off variant equals K2b's chain on its one-block core (the
  core X3's instances ablate, forced by name) bit for bit (``torch.equal``);
- ``attn-bwd`` rows at (B 2048, N 64, D 384, H 6), DiT-S/4's training
  shape: the tool's eight variants, each timed in turns with the baseline
  (baseline, variant, variant, baseline, ``--turns`` times; median ms of
  ``--reps`` calls by CUDA events), and the time it saves;
- ``mlp-fwd`` rows at (T 131,072, D 384, F 1536): K1f and K1f with the
  identity GELU, in the same turns;
- the per-launch split of K2b's chain at the attention shape: the qkv
  recompute, datt, the core (the plan's pick, and the one-block core the
  variants start from), dWproj, dWqkv, dy and the LN backward, each timed
  alone on the chain's own operands, beside the whole chain (both cores);

and, last, one JSON line with every number. The variants compute something
else on purpose; chip_smoke.py and the card tests hold each to its plain
version.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_exp_phase_softmax import block_inputs  # noqa: E402
from torch_exp_whole_block import in_turns, median_ms  # noqa: E402

SHAPE = (2048, 64, 384, 6)  # B, N, D, H
MLP_SHAPE = (SHAPE[0] * SHAPE[1], SHAPE[2], 4 * SHAPE[2])  # T, D, F


def mlp_inputs(seed: int = 4):
    """The tool's MLP draws at :data:`MLP_SHAPE` in nn.Linear's layout."""
    T, D, F = MLP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    z = lambda *s: torch.zeros(*s, device="cuda")  # noqa: E731
    return (r(T, D).to(torch.bfloat16), torch.ones(D, device="cuda"), z(D), r(F, D) * 0.02,
            z(F), r(D, F) * 0.02, z(D))


def variant_times(reps: int, turns: int) -> dict:
    """Each variant in turns with the baseline: ``{variant: {"baseline":
    [ms, ...], "variant": [ms, ...]}}``."""
    from ddm_tpu_torch.ops import attention_ablate as X

    x, p, dout = block_inputs(SHAPE)
    H = SHAPE[3]
    out = {}
    with torch.no_grad():
        for name, skips in X.VARIANTS:
            fns = {"baseline": lambda: X.attention_block_bwd_ablate(x, *p, H, dout),
                   "variant": lambda s=skips: X.attention_block_bwd_ablate(x, *p, H, dout, **s)}
            out[name] = in_turns(lambda n: median_ms(fns[n], reps), ("baseline", "variant"),
                                 turns)
    return out


def mlp_times(reps: int, turns: int) -> dict:
    from ddm_tpu_torch.ops import attention_ablate as X
    from ddm_tpu_torch.ops import mlp_block as M

    args = mlp_inputs()
    fns = {"K1f": lambda: M.fused_mlp_block(*args),
           "identity-gelu": lambda: X.mlp_block_fwd_identity_gelu(*args)}
    with torch.inference_mode():
        return in_turns(lambda n: median_ms(fns[n], reps), ("K1f", "identity-gelu"), turns)


def chain_split(reps: int) -> dict:
    """K2b's chain (``ops/attention.py`` ``_bwd_chain``: the wgmma products,
    the core backward, ``ln_bwd``) launch by launch on its own operands, and
    the whole chain: ``{launch: ms}``."""
    from ddm_tpu_torch.ops import attention as A
    from ddm_tpu_torch.ops import gemm

    x, p, dout = block_inputs(SHAPE)
    B, N, D, H = SHAPE
    s, bb, wqkv_b, bqkv_f, wproj_b, _ = A._kernel_operands(*p)
    x2 = x.reshape(B * N, D)
    dob = dout.reshape(B * N, D)
    with torch.no_grad():
        qkv, _, y = gemm.ln_gemm_wg(x2, s, bb, wqkv_b, bqkv_f, gemm.EPI_BIAS, with_y=True)
        datt = gemm.gemm_nn_wg(dob, wproj_b, gemm.NN_BF16).view(B, N, D)
        att, dqkv = A._core_bwd_att(qkv.view(B, N, 3 * D), datt, H)
        dqkv = dqkv.view(B * N, 3 * D)
        dy = gemm.gemm_nn_wg(dqkv, wqkv_b, gemm.NN_F32)
        launches = {
            "qkv recompute": lambda: gemm.ln_gemm_wg(x2, s, bb, wqkv_b, bqkv_f, gemm.EPI_BIAS,
                                                     with_y=True),
            "datt": lambda: gemm.gemm_nn_wg(dob, wproj_b, gemm.NN_BF16),
            "core": lambda: A._core_bwd_att(qkv.view(B, N, 3 * D), datt, H),
            "core (one-block)": lambda: A._core_bwd_att(qkv.view(B, N, 3 * D), datt, H,
                                                        "one-block"),
            "dWproj": lambda: gemm.gemm_tn_wg(dob, att.view(B * N, D), with_colsum=True),
            "dWqkv": lambda: gemm.gemm_tn_wg(dqkv, y, with_colsum=True),
            "dy": lambda: gemm.gemm_nn_wg(dqkv, wqkv_b, gemm.NN_F32),
            "ln_bwd": lambda: gemm.ln_bwd(x2, dy, dob, s),
            "chain (K2b)": lambda: A.attention_block_bwd(x, *p, H, dout),
            "chain (one-block core)": lambda: A._k2b(x, *p, H, dout, design="one-block"),
        }
        return {name: median_ms(fn, reps) for name, fn in launches.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30, help="timed calls per reading")
    ap.add_argument("--turns", type=int, default=1, help="rounds of base, variant, variant, base")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kbench_ablate: needs an NVIDIA GPU")
    from ddm_tpu_torch.ops import attention as A
    from ddm_tpu_torch.ops import attention_ablate as X

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi)
    x, p, dout = block_inputs(SHAPE)
    H = SHAPE[3]
    with torch.no_grad():
        same = all(torch.equal(g, w) for g, w in zip(X.attention_block_bwd_ablate(
            x, *p, H, dout), A._k2b(x, *p, H, dout, design="one-block")))
    del x, p, dout
    print(f"all-off variant bit for bit K2b's chain on the one-block core at (B, N, D, H) = "
          f"{SHAPE}: {same}")
    res = {"device": smi, "shape": dict(zip("BNDH", SHAPE)), "baseline_is_k2b": same,
           "attn_bwd": variant_times(args.reps, args.turns)}
    for name, t in res["attn_bwd"].items():
        base, var = np.mean(t["baseline"]), np.mean(t["variant"])
        print(f"attn-bwd {name:18s}: {var:.4f} ms (baseline {base:.4f} ms, saves "
              f"{base - var:+.4f} ms) {t['variant']}")
    res["mlp_shape"] = dict(zip("TDF", MLP_SHAPE))
    res["mlp_fwd"] = mlp_times(args.reps, args.turns)
    for name, t in res["mlp_fwd"].items():
        print(f"mlp-fwd {name:14s}: {np.mean(t):.4f} ms {t}")
    res["split"] = chain_split(args.reps)
    parts = sum(v for k, v in res["split"].items()
                if not k.startswith("chain") and k != "core (one-block)")
    for name, ms in res["split"].items():
        print(f"split {name:22s}: {ms:.4f} ms")
    print(f"split sum of launches {parts:.4f} ms against the chain's "
          f"{res['split']['chain (K2b)']:.4f} ms")
    print(json.dumps(res))
    if not same:
        raise SystemExit("torch_kbench_ablate: the all-off variant is not K2b's chain on the "
                         "one-block core bit for bit")
    return res


if __name__ == "__main__":
    main()
