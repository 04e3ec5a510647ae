"""The phase-batched attention experiment on one NVIDIA GPU: X1f and X1b,
the head-batched cores of ``ddm_tpu_torch/ops/phase_softmax.py``, against
the production cores of K2f and K2b. The port of
``tools/exp_phase_softmax.py``'s measurement.

From the repository root:

    PYTHONPATH=. python scripts/torch_exp_phase_softmax.py [--dit-b] [--reps 50] [--turns 2]

It prints the card's name and power limit, then, on the same seeded inputs
(the tool's: bf16 normal x, unit LN scale, zero biases, 0.02 x normal
weights, a normal cotangent) at (B 2048, N 64, D 384, H 6), DiT-S/4's
training shape, or with ``--dit-b`` (2048, 64, 768, 12):

- whether X1f's core and half-block equal the resident forward core's and
  K2f's around it (the design X1f reproduces, forced), and X1b's at every
  head group G that fits and divides H equal the one-block backward core's
  and K2b's around it (forced likewise), bit for bit (``torch.equal``);
- the forward core and the half-block K2f, X1f against the production
  core, and the backward core and the half-block K2b, X1b at each G against
  the production backward (the plan's picks: the registers designs at these
  widths): median ms of ``--reps`` calls by CUDA events, taken in turns
  (production, X1, X1, production, ``--turns`` times);
- one 20-step DiT-S/4 sampler call's worth of forward cores (8 blocks x 20
  steps = 160 calls at B 256), X1f against the production core, in the
  same turns;

and, last, one JSON line with every number. The tool's third body,
``persist_bwd_call``, is the production K2b line for line: the production
rows are its times.
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
from torch_exp_whole_block import in_turns, median_ms  # noqa: E402

SHAPES = {"dit-s": (2048, 64, 384, 6), "dit-b": (2048, 64, 768, 12)}
SAMPLER = (256, 64, 384, 6)
SAMPLER_CALLS = 8 * 20  # DiT-S/4's depth x the sampler's steps


def block_inputs(shape, seed: int = 0):
    """``(x, params, dout)`` at (B, N, D, H) on the card, the tool's draws:
    bf16 normal x and cotangent, LN scale 1 and bias 0, 0.02 x normal
    weights in nn.Linear's layout, zero biases."""
    B, N, D, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    z = lambda *s: torch.zeros(*s, device="cuda")  # noqa: E731
    x = r(B, N, D).to(torch.bfloat16)
    params = (torch.ones(D, device="cuda"), z(D), r(3 * D, D) * 0.02, z(3 * D),
              r(D, D) * 0.02, z(D))
    return x, params, r(B, N, D).to(torch.bfloat16)


def core_inputs(shape, seed: int = 1):
    """``(q, k, v, do)``: the thirds of a seeded (B, N, 3D) bf16 [q | k | v]
    buffer, read in place, and a (B, N, D) cotangent."""
    B, N, D, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn(B, N, D, generator=gen, device="cuda").to(torch.bfloat16)
    return (*qkv.split(D, dim=-1), do)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def bits(shape) -> dict:
    """Whether X1f and X1b (at every group) give the production cores' and
    half-blocks' outputs bit for bit, the resident forward and the one-block
    backward forced."""
    from ddm_tpu_torch.ops import attention as A
    from ddm_tpu_torch.ops import phase_softmax as X

    H = shape[3]
    q, k, v, do = core_inputs(shape)
    x, p, dout = block_inputs(shape)
    groups = X.library_plan(*shape[1:])["groups"]
    with torch.no_grad():
        res = {"x1f_core": torch.equal(X.launch_x1f(q, k, v, H),
                                       A._launch_core(q, k, v, H, "resident")),
               "x1f_block": torch.equal(X.phase_attention_block_fwd(x, *p, H),
                                        A._k2f(x, *p, H, "resident"))}
        want = A._launch_core_bwd(q, k, v, do, H, True, "one-block")
        for G in groups:
            res[f"x1b_core_g{G}"] = _equal(X.launch_x1b(q, k, v, do, H, G), want)
        del want
        want = A._k2b(x, *p, H, dout, design="one-block")
        for G in groups:
            res[f"x1b_block_g{G}"] = _equal(X.phase_attention_block_bwd(x, *p, H, dout, G), want)
    return res


def times(shape, reps: int, turns: int) -> dict:
    """Each X1 row against its production row, in turns: ``{row: {"prod":
    [ms, ...], "x1": [ms, ...]}}``."""
    from ddm_tpu_torch.ops import attention as A
    from ddm_tpu_torch.ops import phase_softmax as X

    H = shape[3]
    q, k, v, do = core_inputs(shape)
    x, p, dout = block_inputs(shape)
    rows = {"fwd core": (lambda: A._launch_core(q, k, v, H), lambda: X.launch_x1f(q, k, v, H)),
            "fwd block (K2f)": (lambda: A.fused_attention_block(x, *p, H),
                                lambda: X.phase_attention_block_fwd(x, *p, H))}
    for G in X.library_plan(*shape[1:])["groups"]:
        rows[f"bwd core G={G}"] = (lambda: A._launch_core_bwd(q, k, v, do, H, True),
                                   lambda G=G: X.launch_x1b(q, k, v, do, H, G))
        rows[f"bwd block (K2b) G={G}"] = (lambda: A.attention_block_bwd(x, *p, H, dout),
                                          lambda G=G: X.phase_attention_block_bwd(
                                              x, *p, H, dout, G))
    out = {}
    with torch.no_grad():
        for row, fns in rows.items():
            fn = dict(zip(("prod", "x1"), fns))
            out[row] = in_turns(lambda n: median_ms(fn[n], reps), ("prod", "x1"), turns)
    return out


def sampler_times(reps: int, turns: int) -> dict:
    """:data:`SAMPLER_CALLS` forward cores at :data:`SAMPLER`, X1f against
    the production core, in turns (ms a sampler call's worth)."""
    from ddm_tpu_torch.ops import attention as A
    from ddm_tpu_torch.ops import phase_softmax as X

    H = SAMPLER[3]
    q, k, v, _ = core_inputs(SAMPLER)
    fns = {"prod": lambda: A._launch_core(q, k, v, H), "x1": lambda: X.launch_x1f(q, k, v, H)}

    def calls(name):
        for _ in range(SAMPLER_CALLS):
            fns[name]()

    with torch.no_grad():
        return in_turns(lambda n: median_ms(lambda: calls(n), max(reps // 10, 3)),
                        ("prod", "x1"), turns)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dit-b", action="store_true", help="(2048, 64, 768, 12): DiT-B/4's shape")
    ap.add_argument("--reps", type=int, default=50, help="timed calls per reading")
    ap.add_argument("--turns", type=int, default=2, help="rounds of production, X1, X1, production")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_exp_phase_softmax: needs an NVIDIA GPU")
    from ddm_tpu_torch.ops import phase_softmax as X

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi)
    shape = SHAPES["dit-b" if args.dit_b else "dit-s"]
    plan = X.library_plan(*shape[1:])
    print(f"shape (B, N, D, H) = {shape}; plan {plan}")
    res = {"device": smi, "shape": dict(zip("BNDH", shape)), "plan": plan, "bits": bits(shape)}
    print("bit for bit: " + ", ".join(f"{k} {v}" for k, v in res["bits"].items()))
    res["times"] = times(shape, args.reps, args.turns)
    for row, t in res["times"].items():
        prod, x1 = np.mean(t["prod"]), np.mean(t["x1"])
        print(f"{row:24s} production {prod:.4f} ms {t['prod']}  X1 {x1:.4f} ms {t['x1']}  "
              f"({(prod / x1 - 1) * 100:+.1f}%)")
    if not args.dit_b:
        res["sampler"] = sampler_times(args.reps, args.turns)
        t = res["sampler"]
        print(f"sampler cores {SAMPLER_CALLS} x {SAMPLER}: production {np.mean(t['prod']):.4f} ms "
              f"{t['prod']}  X1f {np.mean(t['x1']):.4f} ms {t['x1']}")
    print(json.dumps(res))
    if not all(res["bits"].values()):
        raise SystemExit("torch_exp_phase_softmax: X1 is not the production cores bit for bit")
    return res


if __name__ == "__main__":
    main()
