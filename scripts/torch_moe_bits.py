"""Dump the MoE dispatch and combine kernels' outputs and times for one
checkout of the PyTorch port, or compare two dumps: the check that a change
to csrc/moe.cu keeps the bits (and the speed) of the shapes it did not mean
to change.

On one card, from the root of each checkout (its package is imported from
the current directory), on the same seeded inputs, K11f, K11b (with the
residual's cotangent), K12f (with the residual) and K12b through the ops'
public entries at:

- DiT-XL/4's MoE training shape (T 131,072 rows of D 1152, 8 experts,
  groups of 256, capacity 1.25), top-1 and top-2;
- T 32,768 with 16 experts at D 1152 (top-2), 64 experts at D 384, and 8
  experts at D 2048 and D 4096 (top-1 and top-2);
- DiT-S/4's MoE training shape at 128 experts (T 131,072 rows of D 384),
  top-1 and top-2. A checkout whose kernels refuse a shape (one from before
  they took more than 64 experts) leaves it out of its dump, and ``compare``
  compares the cases both dumps hold.

Each kernel is timed by CUDA events, median of 20 calls after 3 warm-up.
The dump keeps a SHA-256 digest of each output's bytes, not the outputs:

    PYTHONPATH=. python scripts/torch_moe_bits.py dump /tmp/new.pt
    cd parent && PYTHONPATH=. python ../scripts/torch_moe_bits.py dump /tmp/old.pt
    python scripts/torch_moe_bits.py compare /tmp/old.pt /tmp/new.pt

``compare`` prints whether every output agrees bit for bit, and each
kernel's two times, and exits non-zero where an output does not agree.
"""

from __future__ import annotations

import argparse
import hashlib
import sys

import numpy as np
import torch

# (name, T, D, E, top-k)
CASES = (("xl top-1", 131072, 1152, 8, 1), ("xl top-2", 131072, 1152, 8, 2),
         ("e16 top-2", 32768, 1152, 16, 2), ("e64 top-1", 32768, 384, 64, 1),
         ("e64 top-2", 32768, 384, 64, 2), ("d2048 top-1", 32768, 2048, 8, 1),
         ("d2048 top-2", 32768, 2048, 8, 2), ("d4096 top-1", 32768, 4096, 8, 1),
         ("d4096 top-2", 32768, 4096, 8, 2), ("e128 top-1", 131072, 384, 128, 1),
         ("e128 top-2", 131072, 384, 128, 2))
GS, CAPACITY = 256, 1.25


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


def _digest(t: torch.Tensor) -> str:
    data = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return f"{tuple(t.shape)} {t.dtype} {hashlib.sha256(data).hexdigest()}"


def dump(path: str) -> None:
    from ddm_tpu_torch.ops import moe_dispatch as MD

    out = {}
    for name, T, D, E, topk in CASES:
        gen = torch.Generator(device="cuda").manual_seed(T + D + E)

        def r(*s, scale=1.0, off=0.0):
            return torch.randn(*s, generator=gen, device="cuda") * scale + off

        cfg, _ = MD.moe_cfg(T, E, GS, CAPACITY, topk)
        G = T // GS
        x = r(T, D).to(torch.bfloat16)
        scale, bias, wr, br = (r(D, scale=0.1, off=1.0), r(D, scale=0.1),
                               r(D, E, scale=D ** -0.5), r(E, scale=0.1))
        with torch.no_grad():
            try:
                fwd = MD.moe_dispatch_fwd(cfg, x, scale, bias, wr, br)
            except NotImplementedError as err:
                print(f"{name} (T={T}, D={D}, E={E}, top-{topk}): refused here ({err})")
                continue
            _, gates, pos1, pos2, probs = fwd[:5]
            dxin = r(*fwd[0].shape).to(torch.bfloat16)
            dgates, dpsum, dres = r(G, GS, 2), r(E), r(T, D).to(torch.bfloat16)
            eout, dpart = r(*fwd[0].shape).to(torch.bfloat16), r(T, D).to(torch.bfloat16)
            calls = {
                "K11f": lambda: MD.moe_dispatch_fwd(cfg, x, scale, bias, wr, br),
                "K11b": lambda: MD.moe_dispatch_bwd(cfg, x, scale, bias, wr, pos1, pos2, probs,
                                                    dxin, dgates, dpsum, dres),
                "K12f": lambda: (MD.moe_combine_fwd(cfg, eout, gates, pos1, pos2, x),),
                "K12b": lambda: MD.moe_combine_bwd(cfg, eout, gates, pos1, pos2, dpart)}
            case = {}
            for kernel, fn in calls.items():
                got = fn()
                torch.cuda.synchronize()
                case[kernel] = {"digests": [_digest(t) for t in got], "ms": _median_ms(fn)}
                del got
        out[name] = case
        print(f"{name} (T={T}, D={D}, E={E}, top-{topk}): " + ", ".join(
            f"{k} {v['ms']:.4f} ms" for k, v in case.items()) + " (median of 20)")
        del x, fwd, dxin, dres, eout, dpart
        torch.cuda.empty_cache()
    torch.save(out, path)
    print(f"dumped the MoE kernels' output digests from {MD.__file__} to {path}")


def compare(a: str, b: str) -> bool:
    x, y = torch.load(a), torch.load(b)
    ok = True
    for name in x.keys() - y.keys() | y.keys() - x.keys():
        print(f"{name}: in one dump only")
    for name in (n for n in x if n in y):
        for kernel in x[name]:
            p, q = x[name][kernel], y[name][kernel]
            same = p["digests"] == q["digests"]
            ok &= same
            print(f"{name} {kernel}: {'bit-identical' if same else 'DIFFERENT'}; "
                  f"{p['ms']:.4f} ms against {q['ms']:.4f} ms")
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
