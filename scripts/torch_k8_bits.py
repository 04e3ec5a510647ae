"""Dump K8f's and K8b's outputs for one checkout of the PyTorch port, or
compare two dumps bit for bit: the check that a change to csrc/flash.cu
keeps the kernels' bits at a head width it did not mean to change.

K8f's "tiles" design (forced where a checkout has ``design=``, else its
only one; at Dh 256-896 forced where a checkout has the wide registers
design, else the chunked kernel it picks there) gives o and lse, and K8b's
"tiles" design (forced likewise; at Dh 256-896 the chunked kernels, forced
where a checkout has K8b's wide registers design, else its pick there)
runs on them: these are held bit for bit. K8f and K8b as the launchers pick
them (the "registers" designs, whose
sums run in another order) are dumped beside the plain versions' outputs,
and ``compare`` holds each dump's to them: o, dq, dk and dv by the bf16
rule (two units in the last place at the largest output, a mean error
below 1e-3), lse to 1e-5 relative. K8b as picked also runs on the tiles
forward's o and lse, and ``compare`` holds the second dump's to the first
dump's held K8b by the same rule.

On one card, from the root of each checkout (its package is imported from
the current directory), on the same seeded inputs, q, k and v read in place
from a [q | k | v] buffer: (B, N) = (128, 1024) over 6 heads of Dh = 64
(the 128-px training shape), and at N = 1024 and B = 8 the narrow widths,
96 heads of Dh 4, 48 of Dh 8 and 24 of Dh 16 (a checkout before the narrow
registers designs picks the tiles design there), and every wide width: 2
heads of Dh 256, 384 and 512, one of 640, 768 and 896:

    PYTHONPATH=. python scripts/torch_k8_bits.py dump /tmp/new.pt
    cd parent && PYTHONPATH=. python ../scripts/torch_k8_bits.py dump /tmp/old.pt
    python scripts/torch_k8_bits.py compare /tmp/old.pt /tmp/new.pt

``compare`` prints whether o, lse, dq, dk and dv agree bit for bit at each
shape, and whether each pick is within its rule, and exits non-zero where
one is not.
"""

from __future__ import annotations

import argparse
import inspect
import sys

import numpy as np
import torch

NAMES = ("o", "lse", "dq", "dk", "dv")
LSE_RTOL = 1e-5


SHAPES = ((128, 1024, 6, 64), (8, 1024, 96, 4), (8, 1024, 48, 8), (8, 1024, 24, 16),
          (8, 1024, 2, 256), (8, 1024, 2, 384), (8, 1024, 2, 512),
          (8, 1024, 1, 640), (8, 1024, 1, 768), (8, 1024, 1, 896))


def _held_k8b(flash, q, k, v, o, lse, do, H: int):
    """K8b's tiles design, forced where the checkout has ``design=`` and
    takes "tiles" at this width; a checkout before the wide registers
    backward refuses it at Dh 256-896, where its own pick is the chunked
    tiles kernels."""
    D, Dh = q.shape[-1], q.shape[-1] // H
    if "design" in inspect.signature(flash.launch_k8b).parameters:
        try:
            return flash.launch_k8b(q, k, v, o, lse, do, H, Dh ** -0.5, "tiles").split(D, dim=-1)
        except RuntimeError:
            pass
    return flash.flash_attention_bwd(q, k, v, o, lse, do, H)


def _dump_shape(flash, gen, B: int, N: int, H: int, Dh: int) -> dict:
    D = H * Dh
    qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn(B, N, D, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    wide = Dh > 128
    designs = "design" in inspect.signature(flash.launch_k8f).parameters and (
        not wide or hasattr(flash, "WIDE_DIMS"))
    with torch.no_grad():
        o, lse = (flash.launch_k8f(q, k, v, H, Dh ** -0.5, "tiles") if designs else
                  flash.flash_attention_fwd(q, k, v, H))
        grads = _held_k8b(flash, q, k, v, o, lse, do, H)
        held_pick = flash.flash_attention_bwd(q, k, v, o, lse, do, H)
        pick = flash.flash_attention_fwd(q, k, v, H)
        pick_grads = flash.flash_attention_bwd(q, k, v, *pick, do, H)
        plain = flash.flash_attention_reference(q, k, v, H)
        plain_grads = flash.flash_attention_bwd_reference(q, k, v, *pick, do, H)
    torch.cuda.synchronize()
    out = {n: t.cpu() for n, t in zip(NAMES, (o, lse, *grads))}
    out.update({f"{n}_held_pick": t.cpu() for n, t in zip(NAMES[2:], held_pick)})
    for tag, ts in (("pick", (*pick, *pick_grads)), ("plain", (*plain, *plain_grads))):
        out.update({f"{n}_{tag}": t.cpu() for n, t in zip(NAMES, ts)})
    return out


def dump(path: str) -> None:
    from ddm_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {f"{B}x{N}x{H}x{Dh}": _dump_shape(flash, gen, B, N, H, Dh) for B, N, H, Dh in SHAPES}
    torch.save(out, path)
    print(f"dumped K8 outputs at (B, N, H, Dh) {list(out)} from {flash.__file__} to {path}")


def _within_rule(name: str, got: torch.Tensor, want: torch.Tensor) -> bool:
    if name == "lse":
        return bool(((got - want).abs() / want.abs()).max() <= LSE_RTOL)
    top = float(want.float().abs().max())
    err = (got.float() - want.float()).abs()
    return bool(float(err.max()) <= 2.0 * 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)
                and float(err.mean()) <= 1e-3)


def compare(a: str, b: str) -> bool:
    x, y = torch.load(a), torch.load(b)
    same = {f"{shape} {n}": torch.equal(x[shape][n], y[shape][n]) for shape in x for n in NAMES}
    rule = {f"{shape} {n} ({tag})": _within_rule(n, d[shape][f"{n}_pick"], d[shape][f"{n}_plain"])
            for tag, d in (("a", x), ("b", y)) for shape in d for n in NAMES}
    # b's K8b as picked on the held forward, against a's held K8b
    rule.update({f"{shape} {n} (b's pick against a's held)":
                 _within_rule(n, y[shape][f"{n}_held_pick"], x[shape][n])
                 for shape in y for n in NAMES[2:]})
    print("K8 outputs bit for bit: " + ", ".join(f"{n} {'equal' if s else 'DIFFERENT'}"
                                                for n, s in same.items()))
    # where both checkouts pick the same design the picks may keep their bits too;
    # shown, not held (a new design's pick differs by design)
    picks = {f"{shape} {n}": torch.equal(x[shape][f"{n}_pick"], y[shape][f"{n}_pick"])
             for shape in x if shape in y for n in NAMES}
    print("K8f and K8b as picked, a's against b's, bit for bit (not held): " + ", ".join(
        f"{n} {'equal' if e else 'different'}" for n, e in picks.items()))
    print("K8f and K8b as picked against the plain versions and the held K8b: " + ", ".join(
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
