"""K6f's fp32 partial against the partial rule at the F-chunked tier's wide
widths, on one card: for each (T, D, F, k) and the first chunks of the hidden
axis, the relative Frobenius error of the wgmma partial (``mlp_block._k6f``)
and of the earlier WMMA design's (``gemm.ln_gemm`` + ``gemm.gemm_partial``)
against the plain version, their distance from each other, and the plain
version's own spread with its contraction axes permuted (the rule holds a
partial to max(1e-4, twice that spread)). Then the same partial by stages
against fp64, as the card tests and ``chip_smoke.py`` (``_k6f_stages``)
hold it: the largest share of its bound that the kernel's bf16 LN output y,
its bf16 hidden g and the fp32 partial each take (bounds derived from each
product's depth), and the share of y's entries rounded otherwise than the
fp64 LN's:

    PYTHONPATH=. python scripts/torch_k6f_partial_rule.py
"""

from __future__ import annotations

import numpy as np
import torch

import chip_smoke
from ddm_tpu_torch.ops import gemm as G
from ddm_tpu_torch.ops import mlp_block as M

# (T, D, F, k): D 1536 at the training and the sampler's rows, then past D 2048 (D 4096 at a ragged T)
SHAPES = ((131072, 1536, 6144, 8), (16384, 1536, 6144, 8), (65536, 2048, 8192, 8),
          (65536, 2560, 10240, 8), (65536, 3072, 6144, 8), (4133, 4096, 4096, 8))
CHUNKS = 3


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _inputs(T, D, F, seed=80):
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    return (t(r.standard_normal((T, D))).to(torch.bfloat16),
            t(1 + 0.1 * r.standard_normal(D)), t(0.1 * r.standard_normal(D)),
            t(D ** -0.5 * r.standard_normal((F, D))), t(0.1 * r.standard_normal(F)),
            t(F ** -0.5 * r.standard_normal((D, F))))


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = torch.cuda.get_device_name(0)
    for T, D, F, k in SHAPES:
        x, sc, bi, w1, b1, w2 = _inputs(T, D, F)
        fc = F // k
        gen = torch.Generator(device="cuda").manual_seed(16)
        out = []
        for c in range(CHUNKS):
            hid = slice(c * fc, (c + 1) * fc)
            part = (x, sc, bi, w1.to(torch.bfloat16)[hid], b1[hid], w2.to(torch.bfloat16)[:, hid])
            want = M.mlp_partial_reference(*part)
            got, old = (torch.empty(T, D, device="cuda") for _ in range(2))
            with torch.no_grad():
                M._k6f(*part, G.PART_STORE, got)
                hidden, _, _ = G.ln_gemm(*part[:5], G.EPI_GELU)
                G.gemm_partial(hidden, part[5], G.PART_STORE, old)
            pd, pf = (torch.randperm(n, generator=gen, device="cuda") for n in (D, fc))
            a = part
            reordered = M.mlp_partial_reference(
                a[0][:, pd].contiguous(), a[1][pd], a[2][pd], a[3][pf][:, pd], a[4][pf],
                a[5][pd][:, pf])[:, torch.argsort(pd)]
            plain_spread = _rel(reordered, want)
            del reordered
            y_used, flips, g_used, p_used = chip_smoke._k6f_stages(M, G, part, got, False)
            out.append(f"chunk {c}: wgmma {_rel(got, want):.3g}, WMMA {_rel(old, want):.3g}, "
                       f"apart {_rel(got, old):.3g}, reordered plain {plain_spread:.3g}; by "
                       f"stages against fp64 y {y_used:.3g} of its bound ({flips:.3g} rounded "
                       f"otherwise), g {g_used:.3g}, the partial {p_used:.3g}")
        print(f"(T={T}, D={D}, F={F}, k={k}) relative Frobenius error: " + "; ".join(out) +
              f" on {smi}", flush=True)
        del x, w1, w2
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
