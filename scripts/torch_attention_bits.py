"""Dump the attention cores' outputs (K2's and K7's forward core, the backward
core with and without att) for one checkout of the PyTorch port and time
them, or compare two dumps bit for bit: the check that a change to
csrc/attention.cu keeps the bits, and the speed, of the designs it did not
mean to change.

Each core is dumped twice. The forward: with the earlier design forced
(the resident design where its tile fits, else the streamed one: ``o``,
held bit for bit), and as the plan picks it (``o_pick``: the registers
design where a checkout has it, whose sums run in another order). The
backward (att, dq, dk, dv): with the earlier design forced (the one-block
core where it fits, else the two whole-head passes where they fit, else
the streamed passes: ``att``, ``dqkv_att``, ``dqkv``, held bit for bit),
and as the plan picks it (``*_pick``: the registers designs where a
checkout has them). ``compare``
holds each dump's picks to the plain versions' outputs (``*_plain``), and
the second dump's picks to the first dump's forced designs, by the bf16
rule: two units in the last place at the largest output, a mean error below
1e-3.

On one card, from the root of each checkout (its package is imported from
the current directory), on the same seeded inputs, q, k and v read in place
from a [q | k | v] buffer, at (B, N, H, Dh): (2048, 64, 6, 64) (DiT-S/4's
training shape; the earlier backward one block per (image, head)), (256,
256, 6, 64) (64 px, two passes), (256, 256, 16, 64) (DiT-L/4 at 64 px, K7)
and (256, 64, 16, 72) (DiT-XL/4, heads padded to 80 columns); then past a
padded head of 128 (the wide registers forward and backward): (64, 256, 1,
384) (DiT-S/4 at --heads 1 and 64 px), (512, 64, 1, 768) (DiT-B/4 at
--heads 1), (64, 256, 2, 512) (DiT-L/4 at --heads 2 and 64 px, K7), (64,
256, 4, 256) (DiT-B/4 at --heads 3 and DiT-L/4 at --heads 4, 64 px), (16,
80, 2, 136) (ragged tiles, a head padded to 144 columns) and (4, 512, 1,
896) (the widest head the wide designs take at the longest N: the
backward's dq side on 16-row blocks):

    PYTHONPATH=. python scripts/torch_attention_bits.py dump /tmp/new.pt
    cd parent && PYTHONPATH=. python ../scripts/torch_attention_bits.py dump /tmp/old.pt
    python scripts/torch_attention_bits.py compare /tmp/old.pt /tmp/new.pt

``dump`` prints each core's median time over 20 calls (CUDA events, after 3
warm-up calls); ``compare`` prints whether every output agrees bit for bit
(the picks: whether each is within the rule of its plain version and of
the first dump's earlier design) and exits non-zero where one does not.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

SHAPES = ((2048, 64, 6, 64), (256, 256, 6, 64), (256, 256, 16, 64), (256, 64, 16, 72),
          (64, 256, 1, 384), (512, 64, 1, 768), (64, 256, 2, 512), (64, 256, 4, 256),
          (16, 80, 2, 136), (4, 512, 1, 896))


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def _first_taken(A, N: int, Dh: int, backward: bool, designs) -> str:
    """The first of ``designs`` that takes (N, Dh)."""
    for design in designs:
        try:
            A.core_plan(N, Dh, backward, design)
            return design
        except RuntimeError:
            continue
    raise ValueError(f"none of {designs} takes N={N}, Dh={Dh}")


def _earlier_fwd(A, N: int, Dh: int) -> str:
    """The forward design the plan picked before the registers designs."""
    return _first_taken(A, N, Dh, False, ("resident", "streamed"))


def _earlier_bwd(A, N: int, Dh: int) -> str:
    """The backward design the plan picked before the registers designs."""
    return _first_taken(A, N, Dh, True, ("one-block", "two-pass", "streamed"))


def dump(path: str) -> None:
    from ddm_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    out, lines = {}, []
    for B, N, H, Dh in SHAPES:
        D = H * Dh
        qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda").to(torch.bfloat16)
        do = torch.randn(B, N, D, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.split(D, dim=-1)
        earlier, earlier_fwd = _earlier_bwd(A, N, Dh), _earlier_fwd(A, N, Dh)
        calls = {"fwd": lambda: A._launch_core(q, k, v, H, earlier_fwd),
                 "fwd_pick": lambda: A._launch_core(q, k, v, H),
                 "bwd_att": lambda: A._launch_core_bwd(q, k, v, do, H, True, earlier),
                 "bwd": lambda: A._launch_core_bwd(q, k, v, do, H, False, earlier),
                 "bwd_att_pick": lambda: A._launch_core_bwd(q, k, v, do, H, True),
                 "bwd_pick": lambda: A._launch_core_bwd(q, k, v, do, H, False)}
        with torch.no_grad():
            key = f"{B}x{N}x{H}x{Dh}"
            o, o_pick = calls["fwd"](), calls["fwd_pick"]()
            att, dqkv_att = calls["bwd_att"]()
            _, dqkv = calls["bwd"]()
            att_pick, dqkv_att_pick = calls["bwd_att_pick"]()
            _, dqkv_pick = calls["bwd_pick"]()
            o_plain = A.attention_reference(q, k, v, H)
            att_plain, *grads = A.attention_core_bwd_att_reference(q, k, v, do, H)
            torch.cuda.synchronize()
            out[key] = {"o": o.cpu(), "att": att.cpu(), "dqkv_att": dqkv_att.cpu(),
                        "dqkv": dqkv.cpu(), "o_pick": o_pick.cpu(), "o_plain": o_plain.cpu(),
                        "att_pick": att_pick.cpu(), "dqkv_att_pick": dqkv_att_pick.cpu(),
                        "dqkv_pick": dqkv_pick.cpu(), "att_plain": att_plain.cpu(),
                        "dqkv_plain": torch.cat(grads, dim=-1).cpu()}
            del grads
            ms = {name: _median_ms(fn) for name, fn in calls.items()}
        lines.append(f"(B={B}, N={N}, H={H}, Dh={Dh}, the plan's forward "
                     f"{A.core_plan(N, Dh)['design']}, backward "
                     f"{A.core_plan(N, Dh, True)['design']}, earlier forward {earlier_fwd}, "
                     f"backward {earlier}): "
                     + ", ".join(f"{name} {t:.4f} ms" for name, t in ms.items()))
    torch.save(out, path)
    print(f"dumped the attention cores' outputs from {A.__file__} to {path}; median of 20 on "
          f"{torch.cuda.get_device_name(0)}:\n  " + "\n  ".join(lines))


def _within_rule(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Two bf16 units in the last place at the largest output, mean < 1e-3."""
    top = float(want.float().abs().max())
    err = (got.float() - want.float()).abs()
    return bool(float(err.max()) <= 2.0 * 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)
                and float(err.mean()) <= 1e-3)


# each pick: (its plain version, the forced design of the first dump it is
# held to by the bf16 rule); a dump from a checkout without the backward's
# picks is held on the forward's alone
PICKS = {"o_pick": ("o_plain", "o"), "att_pick": ("att_plain", "att"),
         "dqkv_att_pick": ("dqkv_plain", "dqkv_att"), "dqkv_pick": ("dqkv_plain", "dqkv")}


def compare(a: str, b: str) -> bool:
    x, y = torch.load(a), torch.load(b)
    same = {f"{shape} {name}": torch.equal(t, y[shape][name])
            for shape, outs in x.items() for name, t in outs.items()
            if not name.endswith(("_pick", "_plain"))}
    rule = {}
    for tag, d in (("a", x), ("b", y)):
        for shape, outs in d.items():
            for pick, (plain, forced) in PICKS.items():
                if pick in outs:
                    rule[f"{shape} {pick} ({tag}) against the plain version"] = _within_rule(
                        outs[pick], outs[plain])
                    if tag == "b":
                        rule[f"{shape} {pick} (b) against a's {forced}"] = _within_rule(
                            outs[pick], x[shape][forced])
    print("attention core outputs bit for bit: " + ", ".join(
        f"{n} {'equal' if s else 'DIFFERENT'}" for n, s in same.items()))
    print("the plan's picks by the bf16 rule: " + ", ".join(
        f"{n} {'within' if s else 'OUTSIDE'}" for n, s in rule.items()))
    return all(same.values()) and all(rule.values())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("dump").add_argument("path")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = p.parse_args(argv)
    if args.cmd == "dump":
        dump(args.path)
        return 0
    return 0 if compare(args.a, args.b) else 1


if __name__ == "__main__":
    sys.exit(main())
