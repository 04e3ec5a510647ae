"""The whole-block experiment on one NVIDIA GPU: X2f, a pre-LN DiT block's
forward in one kernel (``ddm_tpu_torch/ops/whole_block.py``), against the
port's K2f -> K1f pair, the two half-block kernels every DiT path runs.
The port of ``tools/exp_whole_block.py``'s measurement.

From the repository root:

    PYTHONPATH=. python scripts/torch_exp_whole_block.py [--reps 100] [--turns 2]

It prints the card's name and power limit, then, on the same seeded inputs
at (B 256, N 64, D 384, H 6, F 1536), the sampler's block of DiT-S/4:

- the largest |merged - pair| and whether the two agree bit for bit, the
  pair's core forced to the resident design and its MLP half run by the
  WMMA products (``gemm.ln_gemm`` + ``gemm.gemm_residual``), what X2f
  reproduces (K1f itself runs the wgmma products, whose sums run in
  another order);
- one block and an 8-block chain (the block's weights applied 8 times),
  X2f against the pair: median ms of ``--reps`` calls by CUDA events, taken
  in turns (pair, merged, merged, pair, ``--turns`` times);
- a 20-step DiT-S/4 sampler call (256 samples of 32 px, depth 8, seeded
  random weights) with every block merged (:class:`MergedBlock`) against the
  model as it is, host clock around a synchronised call, in the same turns,
  and the largest difference of the two calls' samples (the model's blocks
  run K2f's own pick, the registers core, whose sums run in another order
  than the resident core's, so the samples agree within bf16 noise, not bit
  for bit);

and, last, one JSON line with every number.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ddm_tpu_torch.models.dit import DiTBlock

SHAPE = (256, 64, 384, 6, 1536)  # B, N, D, H, F
CHAIN = 8
N_SAMPLES, STEPS = 256, 20


class MergedBlock(DiTBlock):
    """A dense DiT block whose forward is one X2f launch (forward only)."""

    def forward(self, x):
        from ddm_tpu_torch.ops.whole_block import whole_block_fwd

        ff_in, ff_out = self.ff.net["0"], self.ff.net["2"]
        return whole_block_fwd(
            x, self.norm1.weight, self.norm1.bias, self.attn.qkv.weight, self.attn.qkv.bias,
            self.attn.proj.weight, self.attn.proj.bias, self.norm2.weight, self.norm2.bias,
            ff_in.weight, ff_in.bias, ff_out.weight, ff_out.bias, self.num_heads), None


def block_params(D: int, F: int, seed: int = 0):
    """A block's 12 parameters on the card in nn.Linear's layout (fp32): the
    JAX experiment's weights (0.05 x normal), and LN parameters and biases
    drawn about 1 and 0 (0.1 x normal) so that every epilogue is exercised."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale, off=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + off

    return (r(D, scale=0.1, off=1.0), r(D, scale=0.1), r(3 * D, D, scale=0.05),
            r(3 * D, scale=0.1), r(D, D, scale=0.05), r(D, scale=0.1), r(D, scale=0.1, off=1.0),
            r(D, scale=0.1), r(F, D, scale=0.05), r(F, scale=0.1), r(D, F, scale=0.05),
            r(D, scale=0.1))


def wmma_mlp(a, scale, bias, w1, b1, w2, b2):
    """The MLP half-block through the WMMA products that K6f and K2 still
    launch (the LN-prologue GEMM with the GELU epilogue, then the residual
    GEMM): the products X2f reproduces bit for bit."""
    from ddm_tpu_torch.ops import gemm
    from ddm_tpu_torch.ops.mlp_block import _kernel_operands

    s, bb, w1b, b1f, w2b, b2f = _kernel_operands(scale, bias, w1, b1, w2, b2)
    hidden, _, _ = gemm.ln_gemm(a, s, bb, w1b, b1f, gemm.EPI_GELU)
    return gemm.gemm_residual(hidden, w2b, b2f, a)


def pair(x, p, H: int, design=None):
    """The port's two half-blocks, as every DiT path runs them (K2f, K1f);
    ``design`` forces K2f's core design and runs the MLP half on the WMMA
    products (:func:`wmma_mlp`): X2f reproduces the resident core and those."""
    from ddm_tpu_torch.ops import attention as A
    from ddm_tpu_torch.ops.mlp_block import fused_mlp_block

    B, N, D = x.shape
    if design is None:
        a = A.fused_attention_block(x, *p[:6], H)
        return fused_mlp_block(a.reshape(B * N, D), *p[6:]).reshape(B, N, D)
    a = A._k2f(x, *p[:6], H, design)
    return wmma_mlp(a.reshape(B * N, D), *p[6:]).reshape(B, N, D)


def merged(x, p, H: int):
    from ddm_tpu_torch.ops.whole_block import whole_block_fwd

    return whole_block_fwd(x, *p, H)


def chain(fn, n: int = CHAIN):
    def run(x, p, H):
        for _ in range(n):
            x = fn(x, p, H)
        return x
    return run


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` calls by CUDA events, after ``warmup`` calls."""
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


def in_turns(measure, names, turns: int) -> dict:
    """``measure(name)`` in the order a, b, b, a, ``turns`` times over; each
    name's readings in order."""
    order = [names[0], names[1], names[1], names[0]] * turns
    out = {n: [] for n in names}
    for n in order:
        out[n].append(measure(n))
    return out


def block_inputs(shape=SHAPE):
    """``(x, params)`` at ``shape``: bf16 tokens and :func:`block_params`,
    seeded."""
    B, N, D, H, F = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    return torch.randn(B, N, D, generator=gen, device="cuda").to(torch.bfloat16), \
        block_params(D, F)


def block_times(reps: int, turns: int, shape=SHAPE) -> dict:
    """The bit check (against the pair with the resident core and the WMMA
    MLP products) and the 1-block and 8-block times (against the pair as the
    paths run it) at ``shape``."""
    H = shape[3]
    x, p = block_inputs(shape)
    with torch.inference_mode():
        got, want = merged(x, p, H), pair(x, p, H, "resident")
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        res = {"shape": dict(zip("BNDHF", shape)), "max_abs_diff": err,
               "bit_identical": bool(torch.equal(got, want))}
        fns = {"merged": merged, "pair": pair}
        for label, n in (("1blk", 1), (f"{CHAIN}blk", CHAIN)):
            times = in_turns(lambda k: median_ms(lambda: chain(fns[k], n)(x, p, H), reps),
                             ("pair", "merged"), turns)
            res[label] = times
    return res


def sampler_seconds(turns: int) -> dict:
    """A 20-step DiT-S/4 sampler call of 256 samples, blocks merged against
    the pair, in turns; one warm-up call of each first."""
    from ddm_tpu_torch.models.dit import init_params
    from ddm_tpu_torch.models.factory import MODEL_DEFAULTS, build_model
    from ddm_tpu_torch.sampling import sample_dddm

    model = init_params(build_model(MODEL_DEFAULTS, "cuda"), torch.Generator().manual_seed(0))
    model.eval()

    def run(kind):
        for blk in model.blocks:
            blk.__class__ = MergedBlock if kind == "merged" else DiTBlock
        gen = torch.Generator(device="cuda").manual_seed(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = sample_dddm(model, N_SAMPLES, steps=STEPS, eps_churn=1.0, data_shape=(32, 32, 3),
                        generator=gen, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0, x

    samples = {k: run(k)[1] for k in ("pair", "merged")}  # warm-up, and the comparison
    times = in_turns(lambda k: run(k)[0], ("pair", "merged"), turns)
    return {"seconds": times, "samples_max_abs_diff":
            float((samples["pair"] - samples["merged"]).abs().max())}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=100, help="timed calls per reading")
    p.add_argument("--turns", type=int, default=2, help="rounds of pair, merged, merged, pair")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_exp_whole_block: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi)
    res = block_times(args.reps, args.turns)
    print(f"max |merged - pair| = {res['max_abs_diff']:.2e} "
          f"(bit-identical: {res['bit_identical']})")
    for label in ("1blk", f"{CHAIN}blk"):
        t = res[label]
        print(f"merged {label} {np.mean(t['merged']):.4f} ms {t['merged']}   "
              f"pair {label} {np.mean(t['pair']):.4f} ms {t['pair']}")
    sam = sampler_seconds(args.turns)
    s = sam["seconds"]
    print(f"sampler {N_SAMPLES} x {STEPS} steps: merged {np.mean(s['merged']):.4f} s "
          f"{s['merged']}   pair {np.mean(s['pair']):.4f} s {s['pair']} (samples "
          f"max |merged - pair| {sam['samples_max_abs_diff']:.2e})")
    out = {"device": smi, **res, "sampler": sam}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
