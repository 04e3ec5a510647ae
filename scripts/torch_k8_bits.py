"""Dump K8f's and K8b's outputs for one checkout of the PyTorch port, or
compare two dumps bit for bit: the check that a change to csrc/flash.cu
keeps the kernels' bits at a head width it did not mean to change.

On one card, from the root of each checkout (its package is imported from
the current directory), on the same seeded inputs: (B, N) = (128, 1024), 6
heads of Dh = 64 (the 128-px training shape), q, k and v read in place from
a [q | k | v] buffer:

    PYTHONPATH=. python scripts/torch_k8_bits.py dump /tmp/new.pt
    cd parent && PYTHONPATH=. python ../scripts/torch_k8_bits.py dump /tmp/old.pt
    python scripts/torch_k8_bits.py compare /tmp/old.pt /tmp/new.pt

``compare`` prints whether o, lse, dq, dk and dv agree bit for bit and
exits non-zero where one does not.
"""

from __future__ import annotations

import argparse
import sys

import torch

NAMES = ("o", "lse", "dq", "dk", "dv")


def dump(path: str, B: int = 128, N: int = 1024, H: int = 6, Dh: int = 64) -> None:
    from ddm_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(0)
    D = H * Dh
    qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn(B, N, D, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    with torch.no_grad():
        o, lse = flash.flash_attention_fwd(q, k, v, H)
        grads = flash.flash_attention_bwd(q, k, v, o, lse, do, H)
    torch.cuda.synchronize()
    torch.save({n: t.cpu() for n, t in zip(NAMES, (o, lse, *grads))}, path)
    print(f"dumped K8 outputs at (B={B}, N={N}, H={H}, Dh={Dh}) from {flash.__file__} to {path}")


def compare(a: str, b: str) -> bool:
    x, y = torch.load(a), torch.load(b)
    same = {n: torch.equal(x[n], y[n]) for n in NAMES}
    print("K8 outputs bit for bit: " + ", ".join(f"{n} {'equal' if s else 'DIFFERENT'}"
                                                for n, s in same.items()))
    return all(same.values())


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
