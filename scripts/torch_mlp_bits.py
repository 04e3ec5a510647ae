"""Dump the MLP half-block kernels' outputs and times for one checkout of the
PyTorch port, or compare two dumps: the check that a change to csrc/gemm.cu
or csrc/gemm_bwd.cu keeps the bits (and the speed) of the widths it did not
mean to change.

On one card, from the root of each checkout (its package is imported from
the current directory), on the same seeded inputs:

- K1f at DiT-S/4's sampling shape (16,384 x 384, F 1536) and K1b at its
  training shape (131,072 x 384, F 1536);
- the F-chunked half-block (two K6f) and K1b at DiT-XL/4's training shape
  (131,072 x 1152, F 4608).

Each is timed by CUDA events, median of 20 calls after 3 warm-up:

    PYTHONPATH=. python scripts/torch_mlp_bits.py dump /tmp/new.pt
    cd parent && PYTHONPATH=. python ../scripts/torch_mlp_bits.py dump /tmp/old.pt
    python scripts/torch_mlp_bits.py compare /tmp/old.pt /tmp/new.pt

``compare`` prints whether every output agrees bit for bit, and each case's
two times, and exits non-zero where an output does not agree.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# (name, T, D, F, backward)
CASES = (("K1f dit-s", 16384, 384, 1536, False), ("K1b dit-s", 131072, 384, 1536, True),
         ("K6f x 2 dit-xl", 131072, 1152, 4608, False), ("K1b dit-xl", 131072, 1152, 4608, True))


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


def dump(path: str) -> None:
    from ddm_tpu_torch.ops import mlp_block as M

    out = {}
    for name, T, D, F, backward in CASES:
        gen = torch.Generator(device="cuda").manual_seed(T + D)

        def r(*s, scale=1.0, off=0.0):
            return torch.randn(*s, generator=gen, device="cuda") * scale + off

        args = (r(T, D).to(torch.bfloat16), r(D, scale=0.1, off=1.0), r(D, scale=0.1),
                r(F, D, scale=D ** -0.5), r(F, scale=0.1), r(D, F, scale=F ** -0.5),
                r(D, scale=0.1))
        dout = r(T, D).to(torch.bfloat16)
        with torch.no_grad():
            fn = ((lambda: M.mlp_block_bwd(*args, dout)) if backward else
                  (lambda: M.fused_mlp_block(*args)))
            got = fn()
            torch.cuda.synchronize()
            ms = _median_ms(fn)
        got = got if backward else (got,)
        out[name] = {"outputs": [t.cpu() for t in got], "ms": ms}
        print(f"{name} (T={T}, D={D}, F={F}): {ms:.4f} ms (median of 20)")
        del args, dout, got
        torch.cuda.empty_cache()
    torch.save(out, path)
    print(f"dumped the MLP kernels' outputs from {M.__file__} to {path}")


def compare(a: str, b: str) -> bool:
    x, y = torch.load(a), torch.load(b)
    ok = True
    for name in x:
        same = all(torch.equal(p, q) for p, q in zip(x[name]["outputs"], y[name]["outputs"]))
        ok &= same
        print(f"{name}: {'bit-identical' if same else 'DIFFERENT'}; {x[name]['ms']:.4f} ms "
              f"against {y[name]['ms']:.4f} ms")
    return ok


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
