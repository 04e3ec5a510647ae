"""Drive the PyTorch port's DiT-S/4 sampling and training paths once on one
NVIDIA GPU, at 32 px (N = 64 tokens), at 128 px (N = 1024 tokens, the
long-sequence path through the flash-attention kernel K8), and with 8 top-1
routed experts in every block (the MoE path of configs/cifar10_dit_moe.yaml,
through kernels K10, K11 and K12); then the wide tiers: DiT-L/4 at full
width and depth (configs/cifar10_dit_l.yaml's widths: D 1024, depth 24, 16
heads, through the split attention backward K4 and the F-chunked MLP
partial K6f) and the MoE recipe at DiT-B/4 width (D 768, depth 12, 12 heads,
through K4 and the expert FFN's F-chunked partial K10p); then the 64-px path
(``--image-size 64 --batch 64 --m 4``, N = 256 tokens through K2's cores past
N = 128, the energy score's K3 at D = 12,288), the
m = 32 energy score (``--m 32``, kernel K9) and dense DiT-B/4
(configs/cifar10_dit_b.yaml's widths: D 768, depth 12, 12 heads); then the
JAX ladder's third attention rung: DiT-L/4 at 64 px (N = 256, where no
half-block tier fits) through the standalone attention core K7, K8 at head
widths 32 and 128, and the plain core at 96 px; then dense tensor
parallelism (``--tp 2``): the MLP partial's backward K6b, the TP callers of
K6f and K7, a two-rank step and trainer on the one card, and sampling the
TP checkpoint on one card; then DiT-XL/4 (D 1152, depth 28, 16 heads of Dh
72, through K2f/K4 at 32 px and K7f/K7b at 64 px on head tiles padded to 80
columns, and the F-chunked MLP K6f/K1b at D 1152), DiT-S at Dh 24, the
fast GELU (``--fast-gelu``) in K1, K6 and K10, and the MoE at DiT-XL/4 width
(8 experts, top-1 and top-2: K11 and K12 at D 1152, the expert FFN through
K10p and K10b); then K8 at every other head width the JAX gate admits (Dh
4, 8, 16 and 256-896), DiT-B/4 at ``--heads 3`` (Dh 256) and DiT-S/4 at
``--heads 24`` (Dh 16) training and sampling at 128 px, and the third
rung's plain products at D 1472.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises, so the exit code
is non-zero and no result line is printed:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles ``ddm_tpu_torch/csrc/*.cu`` with nvcc from the checkout
   (one nvcc per source, in parallel);
3. kernels: K1f (MLP half-block) at (16384, 384, F=1536) and K2f (attention
   half-block) at (256, 64, 384, H=6) in bf16 against their plain PyTorch
   versions on the same seeded inputs, with median times from CUDA events;
   3b. backward kernels: K1b at (131072, 384, F=1536) and K2b at
   (2048, 64, 384, H=6), the training shapes, against their plain backward
   versions, and a second call that must be bit-identical;
   3c. energy: K3f and K3b at (B=256, m=8, D=3072) fp32, beta 0.1 and 2.0;
   K3 at (64, 4, 12288) (the 64-px recipe's shape) and K9f/K9b at (256, 32,
   3072) (the m = 32 recipe's), each against its route's plain versions,
   the second backward bit-identical;
   3d. flash: K8f and K8b at H = 6, Dh = 64 and (B, N) = (128, 1024) (the
   128-px training shape), (64, 1024) (sampling), (2, 4096) and (1, 16384)
   (image sizes 256 and 512), q, k and v read in place from a [q | k | v]
   buffer, against their plain versions (computed head by head) on the
   same inputs: o, dq, dk, dv by the bf16 rule below, lse to 1e-5
   relative; K8b's second call bit-identical;
   3e. MoE: K11f/K11b (dispatch) and K12f/K12b (combine) at the MoE
   training shape (T = 131,072 rows, D = 384, E = 8, groups of 256), top-1
   and top-2, and K10f/K10b (expert FFN) on the top-1 dispatch's (8, 20480,
   384) slot rows with F = 1536, against their plain versions. Routing is
   discrete: the tokens whose experts differ are counted, each must have
   its top logits within two bf16 units of yb times max |wr| of each other,
   and the slot rows, gates and backward outputs are compared on the groups
   whose routing agrees; slot rows no token holds must be zeros; every
   backward's second call bit-identical; a full-width DiT-S/4 with seeded weights, one forward through the
   kernels against one through the plain versions;
5. slice: that model saved as a checkpoint and sampled with
   ``generate_torch.main`` (256 samples, 20 steps), checking the outputs and
   that each forward kernel's launch counter rose by exactly 8 blocks x 20
   steps;
6. train step: one training step of the full-width DiT-S/4 (batch 256,
   m = 8, injected t, eps, xi) through the kernels, twice (bit-identical
   gradients), against one through the plain versions, within twice bf16's
   own noise on this step (plain bf16 against plain fp32; for the loss and
   energy terms at least the energy kernel's 1e-5 relative, since that
   noise on one scalar can come out near zero by chance);
   6b. the same at 128 px: batch 16 x m 8 at full width and depth, whose
   plain step holds one head's (128, 1024, 1024) fp32 scores (0.5 GB) at a
   time;
   6c. the same for the MoE model at 32 px (batch 256 x m 8), moe_aux
   included; the plain steps replay the kernel step's routing, and the
   tokens each plain step would route otherwise are counted;
7. training slice: ``train_cifar10_dit_torch.main`` for one epoch of the
   2048 synthetic images (8 steps), checking finite losses, the launch
   counts (8 blocks x 8 steps for K1f/K2f/K1b/K2b, 8 for K3f/K3b) and that
   ``generate_torch.main`` samples from its ``model_final.pt``;
   7b. the long-sequence slice: ``--image-size 128 --batch 16 --m 8`` for
   32 steps (512 synthetic images; an epoch of 128 steps before PR 12),
   checking finite losses and the launch counts (8 blocks a step for
   K8f/K8b/K1f/K1b, none of K2 or K3: the energy score takes its plain
   version at D = 49,152, as the JAX gate does), then 64 samples of (128,
   128, 3) from its ``model_final.pt`` (K8f = 8 x 20);
   7c. the MoE slice: the trainer with ``--moe-experts 8 --moe-capacity
   1.25 --moe-group-size 256 --moe-topk 1 --moe-aux-weight 0.01`` for one
   epoch (8 steps), checking finite losses and moe_aux and the launch
   counts (8 blocks x 8 steps for K2f/K2b/K11f/K11b/K10f/K10b/K12f/K12b, 8
   for K3f/K3b, none of K1), then 64 samples from its ``model_final.pt``
   (K2f, K11f, K10f, K12f = 8 x 20 each).

The wide tiers, after every phase above:

3f. K4 at the DiT-B and DiT-L training shapes (2048, 64, 768, H 12) and
    (2048, 64, 1024, H 16), against the plain backward, the second call
    bit-identical; K6f, one partial on the second hidden chunk of (131,072 x
    1024, F 4096) read in place (fp32, relative Frobenius error within 1e-4
    or twice the plain version's own spread under reordered sums), and the
    F-chunked half-block at k = 2 (bf16 rule), beside K1f unchunked on the
    same inputs; K10p at (8, 20480, 768, F 3072): one chunk (fp32, the same
    rule) and the k = 2 forward (bf16 rule); then (wide-shapes) the earlier
    slices' kernels at the shapes the wide paths give them, each against its
    plain version by its own rule above and timed: K2f at DiT-L sampling and
    training (64 and 2048 images of (64, 1024), H 16), K1b at (131,072 x
    1024, F 4096), and K11f/K11b, K12f/K12b and K10b at the DiT-B MoE
    training shape (T 131,072, D 768, F 3072, top-1); the kernels line
    carries these as each entry's ``shapes``;
6d. one DiT-L step at full width and depth 24, through the kernels twice
    (bit-identical gradients), against the plain step within twice bf16's
    own noise, at batch 16 x m 8 (a plain step at 256 x 8 would keep a
    2.1 GB fp32 h per block alive for autograd);
6e. the same for the DiT-B MoE model, moe_aux included, replaying the kernel
    step's routing as 6c does;
7d. the DiT-L trainer (``--embed-dim 1024 --depth 12 --heads 16``: depth
    cut from 24 in PR 9, 7k running the same kernels at DiT-XL's depth 28)
    for one epoch (8 steps of batch 256 x m 8), its peak memory, then 64
    samples from its ``model_final.pt``; launches per step 12 each of K2f, K4
    and K1b (the counterpart of the JAX wide tier's XLA backward), 24 of K6f,
    1 each of K3f and K3b; per sampler call 240 of K2f and 480 of K6f;
7e. the DiT-B MoE trainer (``--embed-dim 768 --depth 12 --heads 12`` and the
    MoE flags) for one epoch, then 64 samples; launches per step 12 each of
    K2f, K4, K11f, K11b, K10b, K12f, K12b, 24 of K10p, 1 each of K3f, K3b; per
    sampler call 240 each of K2f, K11f, K12f and 480 of K10p.

The 64-px path, the m = 32 energy score and dense DiT-B, after those:

3g. (attention-256) K2f at (64, 256, 384, H 6) and (256, 256, 384, H 6), K2b
    at (256, 256, 384, H 6) and K4 at (256, 256, 768, H 12), through the
    query-tile forward core and the two-pass backward, against their plain
    versions (second backward bit-identical); the attention cores alone
    timed beside PyTorch's scaled_dot_product_attention forward and forward
    + backward on the same q, k, v (a yardstick; the port never calls it);
3h. (dit-b-kernels) K1f and K1b at DiT-B's training shape (131,072 x 768, F
    3072), K2f at its training and sampling shapes (2048 and 64 images of
    (64, 768), H 12), against their plain versions;
3i. (m32-kernels) the m = 32 path's training shapes (256 x 32 = 8,192
    denoiser images): K1f and K1b at (524,288 x 384, F 1536), K2f and K2b at
    (8192, 64, 384, H 6), against their plain versions, the backwards'
    second call bit-identical; 3h and 3i go into the kernels line as each
    entry's ``shapes``;
6f. one 64-px step at full width and depth 8 (batch 64 x m 4), kernels twice
    (bit-identical) against the plain step within twice bf16's own noise;
6g. the same for m = 32 at 32 px, at batch 64 x m 32 (2,048 denoiser images,
    as phase 6; the plain fp32 step at the recipe's 256 x 32 would hold four
    times phase 6's activations); K9 itself is checked at (256, 32, 3072)
    in 3c;
6h. the same for dense DiT-B/4 at full depth 12, batch 16 x m 8;
7f. the 64-px trainer for one epoch (32 steps of 64 x m 4), then 64 samples
    of (64, 64, 3); launches per step 8 each of K2f, K2b, K1f, K1b, 1 each of
    K3f, K3b, no K8 or K9; per sampler call 160 each of K2f and K1f;
7g. the m = 32 trainer (batch 256 x m 32) for one epoch (8 steps), then 64
    samples; per step 8 each of K2f, K2b, K1f, K1b, 1 each of K9f, K9b, no K3;
7h. the dense DiT-B trainer (``--embed-dim 768 --depth 12 --heads 12``) for
    one epoch (8 steps of 256 x m 8), then 64 samples; per step 12 each of
    K2f, K4, K1f, K1b, 1 each of K3f, K3b; per sampler call 240 each of K2f
    and K1f.

The third rung, after those:

3j. (attention-core) K7f at (256, 256, 1024, H 16), the DiT-L 64-px training
    shape, and at 64 images (sampling), K7b at 256 images, on q, k, v read in
    place from a [q | k | v] buffer, against their plain versions by the bf16
    rule, K7b's second call bit-identical, timed beside SDPA's forward and
    forward + backward on the same q, k, v; K8f/K8b at (128, 1024) at H 12
    (Dh 32) and H 3 (Dh 128), D 384, held as 3d holds Dh 64;
6i. (train-step-l64) one DiT-L/4 step at 64 px, full depth 24, batch 8 x m 4,
    kernels twice (bit-identical) against the plain step within twice bf16's
    own noise; the same for a 96-px DiT-S step (N = 576: the third rung's
    plain core on the card, K1f/K1b counted) and a 128-px step at --heads 3
    (Dh 128) at depth 2, each with its launches counted;
7i. (train-l64) the trainer with --embed-dim 1024 --depth 8 --heads 16
    --image-size 64 --batch 64 --m 4 for 8 steps (512 images; an epoch of 32
    steps before PR 10), then 64 samples; launches per step 8 each of K7f,
    K7b, K1b, 16 of K6f, 1 each of K3f, K3b, none of K2f, K2b, K4, K1f; per
    sampler call 160 of K7f and 320 of K6f; its peak memory and img/s (depth
    cut from 24 in PR 9 to make room for 7l, which runs the third rung at
    DiT-XL's full depth 28).

Dense tensor parallelism (``--tp``, Megatron layout), after those:

3k. (tp-kernels) K6f's tensor-parallel entry (``fused_mlp_partial``, one
    partial in fp32) and K6b (its backward) at the DiT-S ``--tp 2`` shard
    (131,072 x 384, F 768), K6b at the DiT-B shard (131,072 x 768, F 1536),
    and K7f/K7b through ``fused_attention`` on three separate q, k, v at
    (2048, 64, 384) H 6 (the full DiT-S instance's training shape), each
    against its plain version (K6f by the fp32 partial rule, K6b by the
    gradient rule and bit-identical on a second call, K7 by the bf16 rule),
    timed, K7 beside SDPA;
6j. (train-step-tp) one step of the full tensor-parallel DiT-S instance
    (the layout a ``--tp`` checkpoint samples with, depth 8, batch 256 x m
    8) through the kernels twice (bit-identical) against the plain step
    within twice bf16's own noise; launches 8 each of K7f, K7b, K6f, K6b, 1
    each of K3f, K3b;
7j. (train-tp) two ranks on the one card over gloo (NCCL takes one rank
    per card): (a) one sharded step from the same seeded full weights and
    injected noise at DiT-S (depth 8) and DiT-B (depth 12) widths, batch 32
    x m 8, its gathered gradients and loss held to the one-process plain
    step within twice bf16's noise, each rank launching per step K6f 8, K6b
    8, K3f 1, K3b 1 and no K7 (DiT-S: the local attention width 192 takes
    the plain core, as JAX's gate does) and K7f, K7b, K6f, K6b 12 each, K3f,
    K3b 1 (DiT-B); (b) ``python -m torch.distributed.run --nproc-per-node 2
    train_cifar10_dit_torch.py --synthetic --tp 2`` at DiT-S depth 8 for one
    epoch of 8 steps at batch 256 x m 2 (m cut from 8: every step moves four
    (T, 384) tensors a block through the host), its step time, launches per
    rank and step, and its rank-0 sampler through the full instance; (c)
    ``generate_torch`` on its checkpoint (``tp: 2`` in the config), 256 x 20
    on one card through the full instance: K7f 160, K6f 160.

DiT-XL/4 and the fast GELU, after those:

3l. (xl-kernels) K2f at 2048 and 256 images of (64, 1152) H 16 and K4 at
    2048 (DiT-XL at 32 px), K7f at 256 and 64 images of (256, 1152) and K7b at
    256 beside SDPA (64 px), one K6f partial on a chunk of 2304 of (131,072 x
    1152, F 4608) and the k = 2 half-block, K1b at (131,072, 1152, 4608); K2f
    at (256, 64, 384, H 16) and K2b at (2048, 64, 384, H 16) (Dh 24); each by
    its rule above, every backward's second call bit-identical;
3m. (fast-gelu-kernels) the seven fast-GELU variants at their rows' shapes
    against their plain versions with ``fast_gelu``: K1f, K1b, one K6f
    partial (DiT-L's chunk), K6b (the DiT-S --tp 2 shard), K10f, K10b and one
    K10p partial (DiT-B width);
6k. (train-step-xl) one DiT-XL/4 step at full depth 28, batch 16 x m 8 at
    32 px (K2f, K4, K6f, K1b) and 8 x m 4 at 64 px (K7f, K7b, K6f, K1b),
    twice (bit-identical) against the plain step within twice bf16's own
    noise, launches counted;
6l. (train-step-fast-gelu) the DiT-S and DiT-S MoE steps of 6 and 6c with
    ``fast_gelu``, against the plain steps with it, launches counted;
7k. (train-xl) the trainer with ``--embed-dim 1152 --depth 28 --heads 16``
    for 4 steps of 256 x m 8 (an epoch of 8 before PR 10), its peak memory,
    then 64 samples:
    per step 28 each of K2f, K4, K1b, 56 of K6f, 1 each of K3f, K3b; per
    sampler call 560 of K2f and 1,120 of K6f;
7l. (train-xl64) the same at ``--image-size 64 --batch 64 --m 4`` (8 steps;
    32 before PR 10):
    per step 28 each of K7f, K7b, K1b, 56 of K6f, 1 each of K3f, K3b, none of
    K2f, K2b, K4, K1f; per sampler call 560 of K7f and 1,120 of K6f.

The MoE at DiT-XL/4 width (8 experts of F 4608 a block, top-1 and top-2),
after those:

3n. (moe-xl-kernels) K11f/K11b and K12f/K12b at the XL training shape (T
    131,072 rows of D 1152, E 8, groups of 256; top-1 cap 40, S 20,480 slot
    rows an expert; top-2 cap 80, S 40,960), K10b on the top-1 slot rows and
    one K10p partial on a chunk of 1152 of F 4608; K11/K12 at T 32,768 with
    E 16 (top-2), D 2048 and D 4096 (E 8) and E 64 at D 384; each by its rule
    above (routing, rows, partials), every backward's second call
    bit-identical;
6n. (train-step-moe-xl) one step of the XL MoE at depth 28, batch 16 x m 8,
    top-1 and top-2 on one seeded draw of the weights, against the plain
    step with the kernel step's routing replayed (as 6c), within twice
    bf16's own noise; launches per step 28 each of K2f, K4, K11f, K11b, K10b,
    K12f, K12b, 112 of K10p, 1 each of K3f, K3b;
7m. (train-moe-xl) the trainer at XL MoE width for 4 steps, top-1 at batch
    256 x m 8 and top-2 at 128 x m 8, its peak memory, then 64 samples from
    its ``model_final.pt``; launches per step as 6n, per sampler call 560
    each of K2f, K11f, K12f and 2,240 of K10p.

K8 at every head width the JAX gate admits, after those:

3o. (flash-widths) K8f and K8b against their plain versions at N 1024 for
    Dh 4, 8 and 16 (D 384 over 96, 48, 24 heads), Dh 256, 384 and 768 (D 768
    over 3, 2, 1), Dh 512 (D 1024 over 2), Dh 640 and 896 (one head), B 128
    at Dh 16, 256 and 768 and B 8 elsewhere, then Dh 16 at N 2304 and Dh 256
    at N 4096 (B 2), each held as 3d holds Dh 64, timed (the plain versions
    past 32 heads over 5 calls), with its bound, its exp count, and SDPA's
    forward and forward + backward through its first fused backend that
    takes the width (named; none where none does);
6o. (train-step-heads) one step of DiT-B/4 --heads 3 (depth 12) and of
    DiT-S/4 --heads 24 (depth 8) at 128 px, batch 8 x m 4, through the
    kernels twice (bit-identical) against the plain step within twice bf16's
    own noise, launches 12 (8) each of K8f, K8b, K1f, K1b; and one 32-px step
    at D 1472 over 8 heads, depth 2, batch 16 x m 4, whose attention half
    runs plain products around the plain core (as JAX runs XLA there),
    launching only K3f and K3b;
7n. (train-heads) the trainer at 128 px with --embed-dim 768 --depth 12
    --heads 3 and with --embed-dim 384 --depth 8 --heads 24, 4 steps of 16 x
    m 8 each, finite losses, peak memory and img/s, then 64 samples; launches
    per step 12 (8) each of K8f, K8b, K1f, K1b, per sampler call 240 (160)
    each of K8f and K1f.

The DiT-S phases run at full width and depth 8. PERF.md gives the whole
run's measured time on the card, the kernels' build included, against the
20 minutes allowed.

Before the result lines, a line lists the head widths K8 was checked at;
the second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

DEPTH, STEPS, N_SAMPLES = 8, 20, 256
TRAIN_BATCH, TRAIN_M, TRAIN_STEPS = 256, 8, 8  # 2048 synthetic images / 256
# bf16 outputs: two units in the last place at the largest output magnitude
# (one rounding of a sum that the kernel and the plain version accumulate in
# different orders), and a mean error far below one unit.
KERNEL_MEAN_TOL = 1e-3
# fp32 weight, bias and LN gradients of the backward kernels: sums over T
# rows where a flipped bf16 rounding upstream moves single entries
GRAD_MAX_REL, GRAD_FROB_REL = 1e-2, 1e-3
ENERGY_RTOL, ENERGY_GRAD_RTOL = 1e-5, 1e-4
LSE_RTOL = 1e-5
FLASH_HEADS = 6
FLASH_SHAPES = [(128, 1024), (64, 1024), (2, 4096), (1, 16384)]  # (B, N); the first is timed
LONG_SIZE, LONG_BATCH, LONG_M = 128, 16, 8
# 7b's trainer runs 32 steps of 16 x m 8 (512 synthetic images; an epoch of
# 128 steps before PR 12, cut to make room for 3o, 6o and 7n)
LONG_IMAGES = 512
# the MoE path: configs/cifar10_dit_moe.yaml's recipe, 8 top-1 experts per block
MOE = {"moe_experts": 8, "moe_capacity": 1.25, "moe_group_size": 256, "moe_topk": 1}
MOE_AUX_WEIGHT = 0.01
# the router's psum: fp32 sums of the probabilities in another order
PSUM_RTOL = 1e-5
# the wide paths: configs/cifar10_dit_l.yaml's widths, and the MoE recipe at
# configs/cifar10_dit_b.yaml's widths
DIT_L = {"embed_dim": 1024, "depth": 24, "heads": 16}
DIT_B = {"embed_dim": 768, "depth": 12, "heads": 12}
WIDE_STEP_BATCH = 16  # 6d, 6e, 6h: batch 16 x m 8
# the 64-px recipe (PARITY.md: bench.py --image-size 64 --batch 64 --m 4) and
# the m-sweep point m = 32 at the 32-px recipe's batch
PX64_SIZE, PX64_BATCH, PX64_M = 64, 64, 4
M32, M32_STEP_BATCH = 32, 64  # 6g: batch 64 x m 32
L64_STEP_BATCH, L64_STEP_M = 8, 4  # 6i: the DiT-L 64-px step at batch 8 x m 4
PX96_SIZE, H3_DEPTH = 96, 2  # 6i: the 96-px DiT-S step; the 128-px --heads 3 step's depth
K8_WIDE_HEADS = (12, 3)  # 3j: K8 at D 384 over 12 heads (Dh 32) and 3 (Dh 128)
# 3o: K8 at the other head widths the JAX gate admits, (B, N, H, Dh): D 384
# over 96, 48 and 24 heads (Dh 4, 8, 16), D 768 over 3, 2 and 1 (Dh 256, 384,
# 768), D 1024 over 2 (Dh 512), D 640 and 896 over 1; B 128 (the 128-px
# training batch) at Dh 16, 256 and 768, the other widths at B 8; then Dh 16
# at N 2304 (192 px) and Dh 256 at N 4096 (256 px), B 2. The plain versions
# loop over heads: past FEW_REPS_HEADS heads they are timed over FEW_REPS calls.
FLASH_WIDTHS = [(8, 1024, 96, 4), (8, 1024, 48, 8), (128, 1024, 24, 16), (128, 1024, 3, 256),
                (8, 1024, 2, 384), (8, 1024, 2, 512), (8, 1024, 1, 640),
                (128, 1024, 1, 768), (8, 1024, 1, 896), (2, 2304, 24, 16), (2, 4096, 3, 256)]
FEW_REPS, FEW_REPS_HEADS = 5, 32
# 6o and 7n: DiT-B/4 at --heads 3 (Dh 256, full depth 12) and DiT-S/4 at
# --heads 24 (Dh 16, depth 8) at 128 px; 6o's steps at 6i's batch 8 x m 4,
# 7n's trainers at 16 x m 8 for HEADS_STEPS steps each; and the third rung's
# plain products at D 1472 over 8 heads (6o: depth 2, 32 px, batch 16 x m 4)
B_H3 = {**DIT_B, "heads": 3}
S_H24 = {"embed_dim": 384, "depth": DEPTH, "heads": 24}
HEADS_STEPS = 4
WIDE_PLAIN, WIDE_PLAIN_BATCH = {"embed_dim": 1472, "depth": 2, "heads": 8}, 16
# an fp32 partial (K6f, K10p), relative Frobenius error: at least 1e-4, and
# at least twice the plain version's own spread when its fp32 sums run in
# another order (the contraction axes permuted): a flipped bf16 rounding of
# an LN output or hidden entry moves single entries by up to ~1e-3 of the
# largest, while the bulk agrees to the fp32 sums
PARTIAL_RTOL = 1e-4
# DiT-XL/4 (Peebles & Xie 2023, Table 1: hidden 1152, depth 28, 16 heads)
# at patch 4, as flags; its 32-px step check's batch (6k: 16 x m 8; 64 px
# takes 6i's 8 x m 4); DiT-S's D 384 over 16 heads of Dh 24 (3l)
DIT_XL = {"embed_dim": 1152, "depth": 28, "heads": 16}
XL_STEP_BATCH, DH24_HEADS = 16, 16
# tensor parallelism: the two-rank step's batch (7j a) and the trainer's m (7j b)
TP, TP_STEP_BATCH, TP_TRAIN_M = 2, 32, 2
# roofline: the published H100 SXM peaks (bf16 tensor cores, fp32 outside
# them) and the HBM rate; a bound is the larger of bytes / HBM and ops / peak
PEAK = {"bf16": 989e12, "fp32": 67e12}
HBM = 3.35e12


def _ulp2(ref: torch.Tensor) -> float:
    top = float(ref.float().abs().max())
    return 2.0 * 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


def _bf16_errors(got: torch.Tensor, want: torch.Tensor):
    """``(max_err, mean_err, tol, ok)`` of a bf16 output by the kernel rule."""
    err = (got.float() - want.float()).abs()
    max_err, mean_err, tol = float(err.max()), float(err.mean()), _ulp2(want)
    return max_err, mean_err, tol, np.isfinite(max_err) and max_err <= tol and \
        mean_err <= KERNEL_MEAN_TOL


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(nbytes: float, flops: float, kind: str = "bf16") -> dict:
    """The least time the card could take: each input read and each output
    written once at the HBM rate, or the operations at the peak rate for
    their type, whichever is longer; with the bytes and operations counted."""
    t_bytes, t_ops = nbytes / HBM, flops / PEAK[kind]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": int(nbytes), "bound_ops": int(flops), "bound_ops_type": kind}


def _rel_frob(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm((a - b).float()) / torch.linalg.norm(b.float()).clamp_min(1e-30))


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name, smi


def phase_build(kc):
    path = kc.library_path()
    if path.exists():
        path.unlink()  # build from the checkout's sources in this run
    t0 = time.perf_counter()
    kc.load_library()
    seconds = time.perf_counter() - t0
    srcs = sorted(os.path.relpath(str(p)) for p in kc._CSRC.glob("*.cu*"))
    print(f"[build] nvcc sm_90a built {os.path.relpath(str(path))} from {srcs} "
          f"in {seconds:.2f} s")
    return seconds


def _kernel_args(gen, shape_x, weights):
    def r(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device="cuda") * scale
    x = r(*shape_x).to(torch.bfloat16)
    return (x,) + tuple(r(*s, scale=sc) + off for s, sc, off in weights)


def _mlp_args(gen, T, D, F):
    return _kernel_args(gen, (T, D), [((D,), 0.1, 1.0), ((D,), 0.1, 0.0),
                                      ((F, D), D ** -0.5, 0.0), ((F,), 0.1, 0.0),
                                      ((D, F), F ** -0.5, 0.0), ((D,), 0.1, 0.0)])


def _attn_args(gen, B, N, D):
    return _kernel_args(gen, (B, N, D), [((D,), 0.1, 1.0), ((D,), 0.1, 0.0),
                                         ((3 * D, D), D ** -0.5, 0.0), ((3 * D,), 0.1, 0.0),
                                         ((D, D), D ** -0.5, 0.0), ((D,), 0.1, 0.0)])


def _entry(name, source, sources, replaces, max_err, ms, plain_ms, bound, library_ms=None):
    return {"name": name, "route": "cuda", "source": source, "sources": sources,
            "replaces": replaces, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            **bound, "library_ms": library_ms}


def _fast(fast):
    return " fast-GELU" if fast else ""


def _k1f_case(M, gen, T, D, F, fast=False):
    return ("K1f", f"(T={T}, D={D}, F={F}){_fast(fast)}",
            lambda *a: M.fused_mlp_block(*a, fast_gelu=fast),
            lambda *a: M.mlp_block_reference(*a, fast_gelu=fast), _mlp_args(gen, T, D, F),
            4 * T * D * F)


def _k2f_case(A, gen, B, N, D, H):
    # qkv and projection GEMMs, then QK^T and PV per image and head
    return ("K2f", f"(B={B}, N={N}, D={D}, H={H})",
            lambda *a: A.fused_attention_block(*a, H),
            lambda *a: A.attention_block_reference(*a, H), _attn_args(gen, B, N, D),
            8 * B * N * D * D + 4 * B * N * N * D)


def _time_forward(case, smi):
    """A forward kernel against its plain version on the same inputs (bf16
    rule), both timed: ``(max_abs_err, ms, plain_ms, bound)``."""
    name, shape, kern, plain, args, flops = case
    with torch.inference_mode():
        got = kern(*args)
        torch.cuda.synchronize()
        max_err, mean_err, tol, ok = _bf16_errors(got, plain(*args))
        ms = _median_ms(lambda: kern(*args))
        plain_ms = _median_ms(lambda: plain(*args))
    print(f"[kernel] {name} {shape} bf16: max_abs_err={max_err:.6g} (tol {tol:.6g}), "
          f"mean_abs_err={mean_err:.6g} (tol {KERNEL_MEAN_TOL:g}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20) on {smi}")
    if not ok:
        raise AssertionError(f"{name} {shape} disagrees with its plain version")
    return max_err, ms, plain_ms, _bound(_nbytes(*args, got), flops)


def phase_kernels(M, A, smi):
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, D, F, B, N, H = 16384, 384, 1536, 256, 64, 6
    srcs = {"K1f": (["ddm_tpu_torch/csrc/gemm.cu", "ddm_tpu_torch/csrc/common.cuh"],
                    "ddm_tpu/ops/mlp_block.py:144"),
            "K2f": (["ddm_tpu_torch/csrc/attention.cu", "ddm_tpu_torch/csrc/gemm.cu",
                     "ddm_tpu_torch/csrc/common.cuh"], "ddm_tpu/ops/attention.py:341")}
    results = []
    for case in (_k1f_case(M, gen, T, D, F), _k2f_case(A, gen, B, N, D, H)):
        sources, replaces = srcs[case[0]]
        results.append(_entry(case[0], sources[0], sources, replaces, *_time_forward(case, smi)))
    return results


def _check_grads(name, got, want, smi, ms, plain_ms,
                 labels=("dx", "dscale", "dbias", "dW_in", "db_in", "dW_out", "db_out")):
    """dx (bf16) to two units in the last place and a mean below 1e-3; each
    fp32 gradient to 1e-2 of its largest entry and 1e-3 in Frobenius norm."""
    worst = 0.0
    parts = []
    for i, (lab, g, w) in enumerate(zip(labels, got, want)):
        err = (g.float() - w.float()).abs()
        max_err, mean_err = float(err.max()), float(err.mean())
        worst = max(worst, max_err)
        if i == 0:
            tol = _ulp2(w)
            ok = max_err <= tol and mean_err <= KERNEL_MEAN_TOL
            parts.append(f"{lab} max {max_err:.4g} (tol {tol:.4g}) mean {mean_err:.3g}")
        else:
            tol = GRAD_MAX_REL * float(w.abs().max())
            frob = _rel_frob(g, w)
            ok = max_err <= tol and frob <= GRAD_FROB_REL
            parts.append(f"{lab} max {max_err:.4g} (tol {tol:.4g}) mean {mean_err:.3g} "
                         f"relF {frob:.3g}")
        if not (np.isfinite(max_err) and ok):
            raise AssertionError(f"{name} {lab} disagrees with its plain version")
    print(f"[kernel] {name}: " + "; ".join(parts)
          + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20) on {smi}")
    return worst


def _k1b_case(M, gen, T, D, F, fast=False):
    mlp = _mlp_args(gen, T, D, F)
    dout = torch.randn(T, D, generator=gen, device="cuda").to(torch.bfloat16)
    return ("K1b", f"(T={T}, D={D}, F={F}){_fast(fast)}",
            lambda: M.mlp_block_bwd(*mlp, dout, fast_gelu=fast),
            lambda: M.mlp_block_bwd_reference(*mlp, dout, fast_gelu=fast), (*mlp, dout),
            # the W1 recompute, dW2, dh, dW1 and dy products
            10 * T * D * F)


def _attn_bwd_case(A, gen, B, N, D, H, name):
    attn = _attn_args(gen, B, N, D)
    dout = torch.randn(B, N, D, generator=gen, device="cuda").to(torch.bfloat16)
    return (name, f"(B={B}, N={N}, D={D}, H={H})", lambda: A.attention_block_bwd(*attn, H, dout),
            lambda: A.attention_block_bwd_reference(*attn, H, dout), (*attn, dout),
            # the qkv recompute, dWproj, datt, dWqkv and dx GEMMs; S, att, dV,
            # dP, dQ and dK per image and head
            2 * B * N * D * D * (3 + 1 + 1 + 3 + 3) + 12 * B * N * N * D)


def _time_backward(case, smi, counters=None,
                   labels=("dx", "dscale", "dbias", "dW_in", "db_in", "dW_out", "db_out")):
    """A backward kernel twice (bit-identical) against its plain version on
    the same inputs (:func:`_check_grads`), both timed: ``(worst max_abs_err,
    ms, plain_ms, bound)``. ``counters`` ``{counter: launches}`` are the
    launch counts the two checked calls must add."""
    name, shape, kern, plain, inputs, flops = case
    before = {c: c.count for c in counters or {}}
    with torch.no_grad():
        got, again = kern(), kern()
        torch.cuda.synchronize()
        for c, n in (counters or {}).items():
            if c.count - before[c] != n:
                raise AssertionError(f"{name} {shape}: {c.name} rose by {c.count - before[c]}, "
                                     f"not {n}: the tier took another kernel")
        if not all(torch.equal(g, h) for g, h in zip(got, again)):
            raise AssertionError(f"{name} {shape} is not deterministic: two calls differ")
        del again
        ms, plain_ms = _median_ms(kern), _median_ms(plain)
        worst = _check_grads(f"{name} {shape} bf16 (second call bit-identical)", got, plain(),
                             smi, ms, plain_ms, labels)
    bound = _bound(_nbytes(*inputs, *got), flops)
    del got
    torch.cuda.empty_cache()
    return worst, ms, plain_ms, bound


def phase_backward(M, A, smi):
    gen = torch.Generator(device="cuda").manual_seed(1)
    D, F, H, N = 384, 1536, 6, 64
    B = TRAIN_BATCH * TRAIN_M
    srcs = {"K1b": (["ddm_tpu_torch/csrc/gemm_bwd.cu", "ddm_tpu_torch/csrc/gemm.cu",
                     "ddm_tpu_torch/csrc/common.cuh"], "ddm_tpu/ops/mlp_block.py:211"),
            "K2b": (["ddm_tpu_torch/csrc/attention.cu", "ddm_tpu_torch/csrc/gemm_bwd.cu",
                     "ddm_tpu_torch/csrc/gemm.cu", "ddm_tpu_torch/csrc/common.cuh"],
                    "ddm_tpu/ops/attention.py:358")}
    results = []
    for case in (_k1b_case(M, gen, B * N, D, F), _attn_bwd_case(A, gen, B, N, D, H, "K2b")):
        sources, replaces = srcs[case[0]]
        counters = {A.BWD_LAUNCHES: 2, A.SPLIT_BWD_LAUNCHES: 0} if case[0] == "K2b" else None
        results.append(_entry(case[0], sources[0], sources, replaces,
                              *_time_backward(case, smi, counters)))
    return results


def _energy_case(E, smi, gen, B, m, D, betas=(0.1, 2.0)):
    """The energy kernels of (B, m, D)'s route (K3 or K9) against the
    route's plain versions at each beta:
    the values to ENERGY_RTOL, the gradients to ENERGY_GRAD_RTOL of their
    largest entry, a second backward bit-identical; timed at the recipe's
    beta 0.1. ``{"f": (max_abs_err, ms, plain_ms, bound), "b": ...}``."""
    route = E.energy_route(B, m, D)
    k9 = route == "K9"
    fwd_ref = E.energy_terms_stream_reference if k9 else E.energy_terms_reference
    bwd_ref = E.energy_terms_stream_bwd_reference if k9 else E.energy_terms_bwd_reference
    xh = torch.randn(B, m, D, generator=gen, device="cuda")
    x0 = torch.randn(B, D, generator=gen, device="cuda")
    gconf, ginter = (torch.tensor(v, device="cuda") for v in (0.7, -0.3))
    worst, timed = {"f": 0.0, "b": 0.0}, {}
    for beta in betas:
        conf, inter = E.energy_terms(xh, x0, beta)
        dxh, dx0 = E.energy_terms_bwd(xh, x0, beta, gconf, ginter)
        again = E.energy_terms_bwd(xh, x0, beta, gconf, ginter)
        torch.cuda.synchronize()
        if not (torch.equal(dxh, again[0]) and torch.equal(dx0, again[1])):
            raise AssertionError(f"{route}b at (B={B}, m={m}, D={D}) is not deterministic")
        want_c, want_i = fwd_ref(xh, x0, beta)
        want_dxh, want_dx0 = bwd_ref(xh, x0, beta, gconf, ginter)
        rc = abs(float(conf - want_c)) / abs(float(want_c))
        ri = abs(float(inter - want_i)) / abs(float(want_i))
        gx = float((dxh - want_dxh).abs().max()) / float(want_dxh.abs().max())
        g0 = float((dx0 - want_dx0).abs().max()) / float(want_dx0.abs().max())
        worst["f"] = max(worst["f"], abs(float(conf - want_c)), abs(float(inter - want_i)))
        worst["b"] = max(worst["b"], float((dxh - want_dxh).abs().max()),
                         float((dx0 - want_dx0).abs().max()))
        if beta == 0.1:  # time at the recipe's beta
            timed = {
                "f": (_median_ms(lambda: E.energy_terms(xh, x0, beta)),
                      _median_ms(lambda: fwd_ref(xh, x0, beta))),
                "b": (_median_ms(lambda: E.energy_terms_bwd(xh, x0, beta, gconf, ginter)),
                      _median_ms(lambda: bwd_ref(xh, x0, beta, gconf, ginter))),
            }
        print(f"[kernel] {route} (B={B}, m={m}, D={D}) fp32 beta={beta}: conf rel err "
              f"{rc:.3g}, inter rel err {ri:.3g} (tol {ENERGY_RTOL:g}); dxh {gx:.3g}, dx0 "
              f"{g0:.3g} of their max (tol {ENERGY_GRAD_RTOL:g}); second backward "
              f"bit-identical on {smi}")
        if not (rc <= ENERGY_RTOL and ri <= ENERGY_RTOL and gx <= ENERGY_GRAD_RTOL
                and g0 <= ENERGY_GRAD_RTOL):
            raise AssertionError(f"{route} disagrees with its plain version at beta={beta}")
        del dxh, dx0, again, want_dxh, want_dx0
    for k in ("f", "b"):
        print(f"[kernel] {route}{k} (B={B}, m={m}, D={D}) beta=0.1: kernel "
              f"{timed[k][0]:.4f} ms, plain {timed[k][1]:.4f} ms (median of 20) on {smi}")
    # fp32 work: |xh_i - x0| over the B*m rows and |xh_i - xh_j| over the
    # B*m(m-1)/2 pairs, a subtract, square and add per element (twice that
    # in the backward); the forward reads xh and x0, the backward also
    # writes their gradients
    flops = 3 * B * m * D * (1 + (m - 1) / 2)
    bounds = {"f": _bound(_nbytes(xh, x0, gconf, ginter), flops, "fp32"),
              "b": _bound(2 * _nbytes(xh, x0) + _nbytes(gconf, ginter), 2 * flops, "fp32")}
    out = {k: (worst[k], *timed[k], bounds[k]) for k in ("f", "b")}
    del xh, x0
    torch.cuda.empty_cache()
    return out


def phase_energy(E, smi):
    """3c: K3 at the 32-px recipe's shape and at the 64-px recipe's, K9 at
    the m = 32 recipe's."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    main = _energy_case(E, smi, gen, TRAIN_BATCH, TRAIN_M, 3072)
    px64 = _energy_case(E, smi, gen, PX64_BATCH, PX64_M, 3 * PX64_SIZE ** 2)
    m32 = _energy_case(E, smi, gen, TRAIN_BATCH, M32, 3072)
    srcs = ["ddm_tpu_torch/csrc/energy.cu", "ddm_tpu_torch/csrc/common.cuh"]
    keys = ("max_abs_err", "ms", "plain_ms")
    entries = []
    for name, line, k in (("K3f", 88, "f"), ("K3b", 112, "b")):
        e = _entry(name, srcs[0], srcs, f"ddm_tpu/ops/energy.py:{line}", *main[k])
        e["shapes"] = [
            {"path": "64px", "shape": f"(B={PX64_BATCH}, m={PX64_M}, D={3 * PX64_SIZE ** 2})",
             **dict(zip(keys, px64[k])), **px64[k][3]}]
        entries.append(e)
    for name, line, k in (("K9f", 244, "f"), ("K9b", 274, "b")):
        entries.append(_entry(name, srcs[0], srcs, f"ddm_tpu/ops/energy.py:{line}", *m32[k]))
    return entries


def _sdpa_ms(q, k, v, do, H):
    """PyTorch's own attention on the same inputs, copied once into its
    (B, H, N, Dh) layout: the forward, and the forward with the backward.
    A yardstick only; the port never calls it."""
    B, N, D = q.shape
    qs, ks, vs, dos = (t.reshape(B, N, H, D // H).transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        fwd = _median_ms(lambda: sdpa(qs, ks, vs))
    leaves = [t.detach().requires_grad_() for t in (qs, ks, vs)]
    both = _median_ms(lambda: torch.autograd.grad(sdpa(*leaves), leaves, dos))
    return {"K8f": fwd, "K8b": both}


def _sdpa_backend_ms(q, k, v, do, H):
    """SDPA's forward and forward + backward on the same q, k, v (copied once
    into its (B, H, N, Dh) layout) through the first of its fused backends,
    in its own order of preference, that takes this head width both ways:
    ``(backend, {"K8f": ms, "K8b": ms})``, or ``("none", None)`` where none
    does (its plain math backend would hold the N x N scores). A yardstick
    only; the port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, N, D = q.shape
    qs, ks, vs, dos = (t.reshape(B, N, H, D // H).transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().requires_grad_() for t in (qs, ks, vs)]
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION)):
        with sdpa_kernel([backend]):
            try:
                torch.autograd.grad(sdpa(*leaves), leaves, dos)
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            with torch.no_grad():
                fwd = _median_ms(lambda: sdpa(qs, ks, vs))
            both = _median_ms(lambda: torch.autograd.grad(sdpa(*leaves), leaves, dos))
        return name, {"K8f": fwd, "K8b": both}
    return "none", None


def _k8_case(FL, smi, gen, B, N, H, Dh, library=False, plain_reps=20):
    """K8f and K8b at (B, N) over H heads of width Dh, q, k and v read in
    place from a [q | k | v] buffer, against their plain versions: o, dq, dk,
    dv by the bf16 rule, lse to LSE_RTOL, K8b's second call bit-identical;
    timed (the plain versions, which loop over heads, over ``plain_reps``
    calls), with bounds and (``library``) SDPA's times on the same q, k, v
    (``library="backend"``: through its first fused backend that takes
    Dh, named, or none)."""
    D = H * Dh
    qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)  # read in place, row stride 3D
    do = torch.randn(B, N, D, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        o, lse = FL.flash_attention_fwd(q, k, v, H)
        grads = FL.flash_attention_bwd(q, k, v, o, lse, do, H)
        again = FL.flash_attention_bwd(q, k, v, o, lse, do, H)
        torch.cuda.synchronize()
        if not all(torch.equal(g, h) for g, h in zip(grads, again)):
            raise AssertionError(f"K8b is not deterministic at (B={B}, N={N}, Dh={Dh})")
        want_o, want_lse = FL.flash_attention_reference(q, k, v, H)
        want = FL.flash_attention_bwd_reference(q, k, v, o, lse, do, H)
        torch.cuda.synchronize()
    lse_rel = float(((lse - want_lse).abs() / want_lse.abs()).max())
    parts, ok = [], lse_rel <= LSE_RTOL
    worst = {"K8f": 0.0, "K8b": 0.0}
    for label, g, w in zip(("o", "dq", "dk", "dv"), (o, *grads), (want_o, *want)):
        max_err, mean_err, tol, good = _bf16_errors(g, w)
        ok = ok and good
        key = "K8f" if label == "o" else "K8b"
        worst[key] = max(worst[key], max_err)
        parts.append(f"{label} max {max_err:.4g} (tol {tol:.4g}) mean {mean_err:.3g}")
    del grads, again, want, want_o, want_lse
    times = {"fwd": _median_ms(lambda: FL.flash_attention_fwd(q, k, v, H)),
             "plain_fwd": _median_ms(lambda: FL.flash_attention_reference(q, k, v, H),
                                     reps=plain_reps),
             "bwd": _median_ms(lambda: FL.flash_attention_bwd(q, k, v, o, lse, do, H)),
             "plain_bwd": _median_ms(
                 lambda: FL.flash_attention_bwd_reference(q, k, v, o, lse, do, H),
                 reps=plain_reps)}
    print(f"[kernel] K8 (B={B}, N={N}, H={H}, Dh={Dh}) bf16: " + "; ".join(parts)
          + f"; lse max rel err {lse_rel:.3g} (tol {LSE_RTOL:g}); K8b second call "
          f"bit-identical; K8f {times['fwd']:.4f} ms, plain {times['plain_fwd']:.4f} ms; "
          f"K8b {times['bwd']:.4f} ms, plain {times['plain_bwd']:.4f} ms (kernels median of "
          f"20, plain versions of {plain_reps}) on {smi}")
    if not ok:
        raise AssertionError(f"K8 disagrees with its plain version at (B={B}, N={N}, Dh={Dh})")
    core = 2 * B * H * N * N * Dh  # one (N x N x Dh) product per image and head
    exps = B * H * N * N  # one exp per score, each way (the backward replays p from lse)
    case = {"B": B, "N": N, "H": H, "Dh": Dh, **times, "max_f": worst["K8f"],
            "max_b": worst["K8b"],
            "bound_f": {**_bound(_nbytes(qkv, o, lse), 2 * core), "bound_exps": exps},
            # the least backward: S, dV, dP, dQ and dK
            "bound_b": {**_bound(_nbytes(qkv, o, lse, do) + _nbytes(qkv), 5 * core),
                        "bound_exps": exps}}
    if library == "backend":
        backend, lib = _sdpa_backend_ms(q, k, v, do, H)
        case["library_f"], case["library_b"] = (lib["K8f"], lib["K8b"]) if lib else (None, None)
        case["library_backend"] = backend
        print(f"[library] torch scaled_dot_product_attention (B={B}, H={H}, N={N}, Dh={Dh}) "
              f"bf16 in its own layout: " + (
                  f"{backend} backend, forward {lib['K8f']:.4f} ms, forward + backward "
                  f"{lib['K8b']:.4f} ms (median of 20)" if lib else
                  "none of its fused backends (flash, efficient, cudnn) takes this head "
                  "width") + f" on {smi}")
    elif library:
        lib = _sdpa_ms(q, k, v, do, H)
        case["library_f"], case["library_b"] = lib["K8f"], lib["K8b"]
        print(f"[library] torch scaled_dot_product_attention (B={B}, H={H}, N={N}, Dh={Dh}) "
              f"bf16 in its own layout: forward {lib['K8f']:.4f} ms, forward + backward "
              f"{lib['K8b']:.4f} ms (median of 20) on {smi}")
    del qkv, q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return case


def _k8_shape(case, name):
    f = name == "K8f"
    return {"B": case["B"], "N": case["N"], "H": case["H"], "Dh": case["Dh"],
            "max_abs_err": case["max_f" if f else "max_b"],
            "ms": case["fwd" if f else "bwd"], "plain_ms": case["plain_fwd" if f else "plain_bwd"],
            **case["bound_f" if f else "bound_b"],
            **({"library_ms": case["library_f" if f else "library_b"]}
               if "library_f" in case else {}),
            **({"library_backend": case["library_backend"]} if "library_backend" in case
               else {})}


def phase_flash(FL, smi):
    """3d: K8 at Dh 64 over the 128-px path's shapes and the larger image
    sizes'; the first (the training shape) carries the bounds and SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [_k8_case(FL, smi, gen, B, N, FLASH_HEADS, 64, library=not i)
             for i, (B, N) in enumerate(FLASH_SHAPES)]
    srcs = ["ddm_tpu_torch/csrc/flash.cu", "ddm_tpu_torch/csrc/common.cuh"]
    first = cases[0]
    entries = [_entry("K8f", srcs[0], srcs, "ddm_tpu/ops/flash.py:330",
                      max(c["max_f"] for c in cases), first["fwd"], first["plain_fwd"],
                      first["bound_f"], first["library_f"]),
               _entry("K8b", srcs[0], srcs, "ddm_tpu/ops/flash.py:372",
                      max(c["max_b"] for c in cases), first["bwd"], first["plain_bwd"],
                      first["bound_b"], first["library_b"])]
    for e in entries:
        e["shapes"] = [_k8_shape(c, e["name"]) for c in cases]
    return entries


def phase_flash_widths(FL, smi):
    """3o: K8f and K8b at every head width the JAX gate admits beyond 32,
    64 and 128 (FLASH_WIDTHS), each against its plain versions, timed, with
    its bound (and exp count) and SDPA's fused backend beside it. Returns
    ``{"K8f": [...], "K8b": [...]}``."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {"K8f": [], "K8b": []}
    for B, N, H, Dh in FLASH_WIDTHS:
        case = _k8_case(FL, smi, gen, B, N, H, Dh, library="backend",
                        plain_reps=FEW_REPS if H > FEW_REPS_HEADS else 20)
        for name in out:
            out[name].append({"path": f"dh{Dh}", **_k8_shape(case, name)})
    widths = sorted({Dh for *_, Dh in FLASH_WIDTHS} | {32, 64, 128})
    if widths != sorted(FL.HEAD_DIMS):
        raise AssertionError(f"3o and 3d/3j checked K8 at Dh {widths}, not at every width the "
                             f"port takes, {sorted(FL.HEAD_DIMS)}")
    return out


def _kept(cfg, pos1, pos2) -> int:
    """Slot rows held by a token: routed choices within capacity."""
    return sum(int(((p >= 0) & (p < cfg.cap)).sum()) for p in (pos1, pos2))


def _routing(MD, ML, cfg, got, want, x, scale, bias, wr, br):
    """The routing rule: ``(tokens whose experts differ, groups whose slot
    positions all agree, the largest logit gap among the differing tokens,
    its tolerance)``. The kernel's LN statistics differ from the plain
    version's in the last fp32 bits, which can flip the bf16 rounding of a
    yb entry by one unit and so move a logit by up to ulp(max |yb|) times
    max |wr|. A token may route otherwise only where its top ``topk + 1``
    logits (the plain version's) lie within twice that of each other; the
    same bound holds the gates and router probabilities."""
    experts = [torch.stack([MD.chosen(p)[0].reshape(-1) for p in out[2:4]]) for out in (got, want)]
    moved = (experts[0] != experts[1]).any(0)
    agree = ((got[2] == want[2]) & (got[3] == want[3])).flatten(1).all(1)
    y = ML.layer_norm(x.float(), scale, bias).to(x.dtype).float()
    tol = _ulp2(y) * float(wr.abs().max())  # _ulp2: two bf16 units at max |yb|
    gap = 0.0
    if moved.any():
        top = (y[moved] @ wr.float() + br.float()).topk(cfg.topk + 1, dim=-1).values
        gap = float((top[:, :-1] - top[:, 1:]).min(-1).values.max())
    return int(moved.sum()), agree, gap, tol


def _moe_kernel_times(MD, X, ML, smi, D, F, topks, k10f=True, E=MOE["moe_experts"],
                      T=TRAIN_BATCH * TRAIN_M * 64, k10b=True):
    """K11 (dispatch), K12 (combine) and, where ``k10b``, K10b (expert FFN
    backward on the top-1 slot rows), with K10f where ``k10f``, at T rows of
    width D routed to E experts (the MoE training shape by default), against
    their plain versions: ``{(name, topk): (max_abs_err, ms, plain_ms, bound)}``."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    GS = 256

    def r(*shape, scale=1.0, off=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + off

    bf = torch.bfloat16
    x = r(T, D).to(bf)
    scale, bias, wr, br = r(D, scale=0.1, off=1.0), r(D, scale=0.1), r(D, E, scale=D ** -0.5), \
        r(E, scale=0.1)
    timed = {}
    for topk in topks:
        cfg, _ = MD.moe_cfg(T, E, GS, MOE["moe_capacity"], topk)
        G = T // GS
        shape = f"(T={T}, D={D}, E={E}, gs={GS}, cap={cfg.cap}, top-{topk})"
        args = (cfg, x, scale, bias, wr, br)
        with torch.no_grad():
            got = MD.moe_dispatch_fwd(*args)
            torch.cuda.synchronize()
            want = MD.moe_dispatch_reference(*args)
        xin, gates, pos1, pos2, probs, cnt, psum = got
        moved, agree, gap, rtol = _routing(MD, ML, cfg, got, want, x, scale, bias, wr, br)
        slots = lambda t: t.view(E, G, cfg.cpad, D)[:, agree]  # noqa: E731
        xerr, xmean, xtol, ok = _bf16_errors(slots(xin), slots(want[0]))
        empty = ~slots(want[0]).any(-1)
        ok = ok and not slots(xin)[empty].any()  # unheld slot rows are written as zeros
        router_err = max(float((gates[agree] - want[1][agree]).abs().max()),
                         float((probs - want[4]).abs().max()))
        psum_rel = float(((psum - want[6]).abs() / want[6].abs()).max())
        cnt_err = float((cnt - want[5]).abs().max())
        ok = ok and router_err <= rtol and psum_rel <= PSUM_RTOL and cnt_err <= moved
        ok = ok and gap < rtol and int(agree.sum()) >= G - moved
        ms = _median_ms(lambda: MD.moe_dispatch_fwd(*args))
        plain_ms = _median_ms(lambda: MD.moe_dispatch_reference(*args))
        print(f"[kernel] K11f {shape} bf16: {moved} tokens routed otherwise than by the plain "
              f"version (largest top-logit gap among them {gap:.3g}, tol {rtol:.3g} = one bf16 "
              f"unit of yb times max |wr|, twice), {int(agree.sum())} of {G} groups agree; on "
              f"those xin max {xerr:.4g} (tol {xtol:.4g}) mean {xmean:.3g}, unheld slot rows "
              f"zero; gates/probs max {router_err:.3g} (tol {rtol:.3g}), psum rel {psum_rel:.3g} "
              f"(tol {PSUM_RTOL:g}), cnt max {cnt_err:g}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (median of 20) on {smi}")
        if not ok:
            raise AssertionError(f"K11f disagrees with its plain version at top-{topk}")
        kept = _kept(cfg, pos1, pos2)
        ln_router = 2 * T * D * E + 8 * T * D  # fp32: the router product and the LN
        timed[("K11f", topk)] = (xerr, ms, plain_ms, _bound(
            _nbytes(x, scale, bias, wr, br, *got), ln_router, "fp32"))

        # the backward, both sides on the kernel's routing state
        dxin, dgates, dpsum, dres = r(*xin.shape).to(bf), r(G, GS, 2), r(E), r(T, D).to(bf)
        for res in (dres, None):
            kern = lambda: MD.moe_dispatch_bwd(  # noqa: E731
                cfg, x, scale, bias, wr, pos1, pos2, probs, dxin, dgates, dpsum, res)
            plain = lambda: MD.moe_dispatch_bwd_reference(  # noqa: E731
                cfg, x, scale, bias, wr, pos1, pos2, probs, dxin, dgates, dpsum, res)
            with torch.no_grad():
                g1, g2 = kern(), kern()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
                    raise AssertionError(f"K11b is not deterministic at top-{topk}")
                ms, plain_ms = _median_ms(kern), _median_ms(plain)
                worst = _check_grads(
                    f"K11b {shape}{' thru' if res is not None else ''} bf16 (second call "
                    "bit-identical)", g1, plain(), smi, ms, plain_ms,
                    labels=("dx", "dscale", "dbias", "dwr", "dbr"))
            if res is not None:
                # dxin read at the held slot rows only; dres read, dx written
                nbytes = _nbytes(x, scale, bias, wr, pos1, pos2, probs, dgates, dpsum, dres,
                                 *g1) + kept * D * 2
                timed[("K11b", topk)] = (worst, ms, plain_ms,
                                         _bound(nbytes, 2 * ln_router, "fp32"))

        # K12 on the kernel's routing state: forward with and without the
        # residual, then the backward
        eout, dpart = r(*xin.shape).to(bf), r(T, D).to(bf)
        for res in (x, None):
            with torch.no_grad():
                part = MD.moe_combine_fwd(cfg, eout, gates, pos1, pos2, res)
                torch.cuda.synchronize()
                perr, pmean, ptol, ok = _bf16_errors(
                    part, MD.moe_combine_reference(cfg, eout, gates, pos1, pos2, res))
            if not ok:
                raise AssertionError(f"K12f disagrees with its plain version at top-{topk}")
            worst_f = perr if res is not None else max(worst_f, perr)
        ms = _median_ms(lambda: MD.moe_combine_fwd(cfg, eout, gates, pos1, pos2, x))
        plain_ms = _median_ms(lambda: MD.moe_combine_reference(cfg, eout, gates, pos1, pos2, x))
        print(f"[kernel] K12f {shape} bf16, with and without the residual: max {worst_f:.4g} "
              f"(tol {ptol:.4g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20, "
              f"with the residual) on {smi}")
        # the held slot rows of eout are read; gates, pos, res read, the tokens written
        timed[("K12f", topk)] = (worst_f, ms, plain_ms, _bound(
            _nbytes(gates, pos1, pos2, x, part) + kept * D * 2, 2 * kept * D, "fp32"))
        with torch.no_grad():
            kern = lambda: MD.moe_combine_bwd(cfg, eout, gates, pos1, pos2, dpart)  # noqa: E731
            plain = lambda: MD.moe_combine_bwd_reference(  # noqa: E731
                cfg, eout, gates, pos1, pos2, dpart)
            (dout, dg), again = kern(), kern()
            torch.cuda.synchronize()
            if not (torch.equal(dout, again[0]) and torch.equal(dg, again[1])):
                raise AssertionError(f"K12b is not deterministic at top-{topk}")
            want_dout, want_dg = plain()
            derr, dmean, dtol, ok = _bf16_errors(dout, want_dout)
            ok = ok and not dout[~want_dout.any(-1)].any()  # unheld slot rows: zeros
            gerr = float((dg - want_dg).abs().max())
            ok = ok and gerr <= ENERGY_GRAD_RTOL * float(want_dg.abs().max())
            ms, plain_ms = _median_ms(kern), _median_ms(plain)
        print(f"[kernel] K12b {shape} bf16 (second call bit-identical): dout max {derr:.4g} "
              f"(tol {dtol:.4g}) mean {dmean:.3g}, unheld slot rows zero; dgates max {gerr:.4g} "
              f"(tol {ENERGY_GRAD_RTOL:g} of its max); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (median of 20) on {smi}")
        if not ok:
            raise AssertionError(f"K12b disagrees with its plain version at top-{topk}")
        timed[("K12b", topk)] = (max(derr, gerr), ms, plain_ms, _bound(
            _nbytes(gates, pos1, pos2, dpart, dout, dg) + kept * D * 2, 4 * kept * D, "fp32"))
        if topk == 1 and k10b:
            slot_rows = xin
        del got, want, eout, dpart, dxin, dres
        torch.cuda.empty_cache()
    if not k10b:
        return timed

    # K10 on the top-1 dispatch's slot rows (its unheld rows are zeros)
    w1, b1 = r(E, D, F, scale=D ** -0.5), r(E, F, scale=0.1)
    w2, b2 = r(E, F, D, scale=F ** -0.5), r(E, D, scale=0.1)
    dout = r(*slot_rows.shape).to(bf)
    ffn = (slot_rows, w1, b1, w2, b2)
    S = slot_rows.shape[1]
    shape = f"(E={E}, S={S}, D={D}, F={F})"
    if k10f:
        with torch.no_grad():
            got = X.expert_ffn(*ffn)
            torch.cuda.synchronize()
            ferr, fmean, ftol, ok = _bf16_errors(got, X.expert_ffn_reference(*ffn))
            ms = _median_ms(lambda: X.expert_ffn(*ffn))
            plain_ms = _median_ms(lambda: X.expert_ffn_reference(*ffn))
        print(f"[kernel] K10f {shape} bf16: max_abs_err={ferr:.6g} (tol {ftol:.6g}), "
              f"mean_abs_err={fmean:.6g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of "
              f"20) on {smi}")
        if not ok:
            raise AssertionError("K10f disagrees with its plain version")
        timed[("K10f", 1)] = (ferr, ms, plain_ms, _bound(_nbytes(*ffn, got), 4 * E * S * D * F))
        del got
    with torch.no_grad():
        kern = lambda: X.expert_ffn_bwd(*ffn, dout)  # noqa: E731
        g1, g2 = kern(), kern()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
            raise AssertionError("K10b is not deterministic")
        del g2
        ms, plain_ms = _median_ms(kern), _median_ms(lambda: X.expert_ffn_bwd_reference(*ffn, dout))
        worst = _check_grads(f"K10b {shape} bf16 (second call bit-identical)", g1,
                             X.expert_ffn_bwd_reference(*ffn, dout), smi, ms, plain_ms,
                             labels=("dx", "dW1", "db1", "dW2", "db2"))
    # the h recompute, dW2, dg, dW1 and dx products
    timed[("K10b", 1)] = (worst, ms, plain_ms, _bound(_nbytes(*ffn, dout, *g1),
                                                      10 * E * S * D * F))
    return timed


def phase_moe_kernels(MD, X, ML, smi):
    """K11 (dispatch), K12 (combine) and K10 (expert FFN) at the MoE
    training shape, top-1 and (K11, K12) top-2, against their plain versions."""
    timed = _moe_kernel_times(MD, X, ML, smi, 384, 1536, (1, 2))
    moe_src = ["ddm_tpu_torch/csrc/moe.cu", "ddm_tpu_torch/csrc/common.cuh"]
    entries = {}
    for name, line, src in (("K10f", "expert_ffn.py:55", "gemm_bwd.cu"),
                            ("K10b", "expert_ffn.py:63", "gemm_bwd.cu"),
                            ("K11f", "moe_dispatch.py:150", "moe.cu"),
                            ("K11b", "moe_dispatch.py:198", "moe.cu"),
                            ("K12f", "moe_dispatch.py:481", "moe.cu"),
                            ("K12b", "moe_dispatch.py:510", "moe.cu")):
        sources = (moe_src if src == "moe.cu" else
                   ["ddm_tpu_torch/csrc/gemm_bwd.cu", "ddm_tpu_torch/csrc/common.cuh"])
        entry = _entry(name, sources[0], sources, f"ddm_tpu/ops/{line}", *timed[(name, 1)])
        if (name, 2) in timed:
            entry["top2"] = dict(zip(("max_abs_err", "ms", "plain_ms"), timed[(name, 2)][:3]),
                                 **timed[(name, 2)][3])
        entries[name] = entry
    return list(entries.values())


def phase_model(cfg, smi):
    from ddm_tpu_torch.models.dit import init_params
    from ddm_tpu_torch.models.factory import build_model

    model = init_params(build_model(cfg, "cuda"), torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (N_SAMPLES, cfg["image_size"], cfg["image_size"], 3)
    xt = torch.randn(shape, generator=gen, device="cuda")
    xi = torch.randn(shape, generator=gen, device="cuda")
    t = torch.rand((N_SAMPLES,), generator=gen, device="cuda")
    model32 = init_params(build_model({**cfg, "dtype": "float32"}, "cuda"),
                          torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got = model.tokens(xt, t, xi)
        torch.cuda.synchronize()
        with plain_ops():
            want = model.tokens(xt, t, xi)
            want32 = model32.tokens(xt, t, xi)
    err = float((got - want).abs().max())
    # tolerance: bf16's own rounding noise on this model. The plain bf16
    # forward lies within e = max |plain bf16 - plain fp32| of the fp32 one;
    # a kernel forward as accurate as it lies within 2e of the plain bf16.
    tol = 2.0 * float((want - want32).abs().max())
    print(f"[model] DiT-S/4 forward (B={N_SAMPLES}, depth {DEPTH}, bf16) kernels vs plain: "
          f"max_abs_err={err:.6g} (tol {tol:.6g} = 2 max |plain bf16 - plain fp32|), "
          f"output max |x| {float(want.abs().max()):.4g} on {smi}")
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError("the kernel forward disagrees with the plain forward")
    return model


def phase_slice(model, cfg, kc, name, smi):
    import generate_torch
    from ddm_tpu_torch.utils.checkpoint import save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model_final.pt")
        save_checkpoint(ckpt, model.state_dict(), cfg)
        npz, png = os.path.join(tmp, "samples.npz"), os.path.join(tmp, "samples.png")
        kc.reset_launch_counts()
        result = generate_torch.main([
            "--ckpt", ckpt, "--n", str(N_SAMPLES), "--batch", str(N_SAMPLES),
            "--steps", str(STEPS), "--device", "cuda", "--npz", npz, "--out", png])
        launches = kc.launch_counts()
        samples = np.load(npz)["samples"]
        if samples.shape != (N_SAMPLES, cfg["image_size"], cfg["image_size"], 3):
            raise AssertionError(f"samples have shape {samples.shape}")
        if not (np.isfinite(samples).all() and samples.min() >= -1 and samples.max() <= 1):
            raise AssertionError("samples are not finite values in [-1, 1]")
        if not os.path.getsize(png):
            raise AssertionError("no PNG written")
    want = {k: DEPTH * STEPS if k in ("K1f", "K2f") else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"sampling launched {launches}, expected {want}")
    rate = N_SAMPLES / result["seconds"]
    print(f"[slice] generate_torch: {N_SAMPLES} samples x {STEPS} steps in "
          f"{result['seconds']:.3f} s = {rate:.2f} samples/s on {name} ({smi}); "
          f"launches {launches}; samples std {float(samples.std()):.4f}")
    return launches


class _Plain(torch.autograd.Function):
    """A plain forward with its explicit plain backward, on any device."""

    @staticmethod
    def forward(ctx, fwd, bwd, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.bwd = bwd
        return fwd(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.bwd(*ctx.saved_tensors, *grads))


class _PlainDispatch(torch.autograd.Function):
    """The plain K11 forward and backward on any device, as
    ``moe_dispatch_thru`` returns them; ``choices`` replays a given routing."""

    @staticmethod
    def forward(ctx, cfg, n_valid, choices, x, scale, bias, wr, br):
        from ddm_tpu_torch.ops import moe_dispatch as MD

        xin, gates, pos1, pos2, probs, cnt, psum = MD.moe_dispatch_reference(
            cfg, x, scale, bias, wr, br, n_valid, choices)
        ctx.cfg, ctx.n_valid = cfg, n_valid
        ctx.save_for_backward(x, scale, bias, wr, pos1, pos2, probs)
        ctx.mark_non_differentiable(pos1, pos2, cnt)
        return xin, gates, pos1, pos2, cnt, psum, x

    @staticmethod
    def backward(ctx, dxin, dgates, _dp1, _dp2, _dcnt, dpsum, dthru):
        from ddm_tpu_torch.ops import moe_dispatch as MD

        return (None, None, None, *MD.moe_dispatch_bwd_reference(
            ctx.cfg, *ctx.saved_tensors, dxin, dgates, dpsum, dthru, ctx.n_valid))


@contextlib.contextmanager
def _patched(module, **fns):
    saved = {k: getattr(module, k) for k in fns}
    for k, v in fns.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


@contextlib.contextmanager
def plain_ops(replay=None):
    """Route the model's half-blocks, its MoE layers and the step's energy
    score through the plain versions (forward and backward) on the card.
    ``replay``, a list of routings from :func:`record_routes`, makes the
    MoE layers route as recorded, block by block, in place of their argmax."""
    from ddm_tpu_torch import training
    from ddm_tpu_torch.models import dit
    from ddm_tpu_torch.models import moe as MM
    from ddm_tpu_torch.models.factory import MODEL_DEFAULTS
    from ddm_tpu_torch.ops import attention as A
    from ddm_tpu_torch.ops import energy as E
    from ddm_tpu_torch.ops import expert_ffn as X
    from ddm_tpu_torch.ops import mlp_block as M
    from ddm_tpu_torch.ops import moe_dispatch as MD
    from ddm_tpu_torch.ops import tiers

    def mlp(*t_and_fast):
        # the plain version of the tier the kernels take at these shapes
        *t, fast = t_and_fast
        tier = tiers.mlp_tier(*t[0].shape, t[3].shape[0])
        fwd = lambda *a: M.mlp_block_reference(*a, fast)  # noqa: E731
        if tier is not None and tier[0] == "fchunked":
            fwd = lambda *a: M.mlp_block_fchunked_reference(*a, tier[1], fast)  # noqa: E731
        return _Plain.apply(fwd, lambda *a: M.mlp_block_bwd_reference(*a, fast), *t)

    def attn(*t_and_h):
        # the plain version of the path the kernels take at these shapes:
        # K2's half-block where the ladder has a tier, else the third rung
        *t, H = t_and_h
        if tiers.attention_tier(*t[0].shape, H) is not None:
            return _Plain.apply(lambda *a: A.attention_block_reference(*a, H),
                                lambda *a: A.attention_block_bwd_reference(*a[:7], H, a[7]), *t)
        core = tiers.core_tier(*t[0].shape, H)
        return _Plain.apply(lambda *a: A.rung3_block_reference(*a, H, core),
                            lambda *a: A.rung3_block_bwd_reference(*a[:7], H, a[7], core), *t)

    def energy(xh, x0, beta):
        # the plain versions of the route the kernels take at these shapes
        k9 = E.energy_route(*xh.shape) == "K9"
        fwd = E.energy_terms_stream_reference if k9 else E.energy_terms_reference
        bwd = E.energy_terms_stream_bwd_reference if k9 else E.energy_terms_bwd_reference
        return _Plain.apply(lambda *a: fwd(*a, beta),
                            lambda xh_, x0_, gc, gi: bwd(xh_, x0_, beta, gc, gi),
                            xh.float().contiguous(), x0.float().contiguous())

    routes = iter(replay or ())

    def dispatch(cfg, x, scale, bias, wr, br, n_valid):
        choices = tuple(next(routes)) if replay else None
        return _PlainDispatch.apply(cfg, n_valid, choices, x, scale, bias, wr, br)

    def ffn(*t_and_fast):
        *t, fast = t_and_fast
        tier = tiers.expert_tier(*t[0].shape, t[1].shape[-1])
        fwd = lambda *a: X.expert_ffn_reference(*a, fast)  # noqa: E731
        if tier is not None and tier[1] > 1:
            fwd = lambda *a: X.expert_ffn_fchunked_reference(*a, tier[1], fast)  # noqa: E731
        return _Plain.apply(fwd, lambda *a: X.expert_ffn_bwd_reference(*a, fast), *t)

    def combine_res(cfg, out, gates, pos1, pos2, res):
        return _Plain.apply(
            lambda *a: MD.moe_combine_reference(cfg, *a),
            lambda o, g, p1, p2, r, dp: (
                *MD.moe_combine_bwd_reference(cfg, o, g, p1, p2, dp), None, None, dp),
            out, gates, pos1, pos2, res)

    def partial(*t_and_fast):
        *t, fast = t_and_fast
        return _Plain.apply(lambda *a: M.mlp_partial_reference(*a, fast),
                            lambda *a: M.mlp_partial_bwd_reference(*a, fast), *t)

    def core(q, k, v, H):
        # the plain version of the core fused_attention takes at these shapes
        if tiers.core_tier(*q.shape, H) == "K8":
            return _Plain.apply(lambda *a: A._flash_core(*a, H),
                                lambda *a: A._flash_core_bwd(*a, H)[1:], q, k, v)
        return _Plain.apply(lambda *a: A.attention_reference(*a, H),
                            lambda *a: A.attention_core_bwd_reference(*a, H), q, k, v)

    with _patched(dit, fused_mlp_block=mlp, fused_attention_block=attn,
                  fused_mlp_partial=partial, fused_attention=core), \
            _patched(training, fused_energy_terms=energy), \
            _patched(MM, moe_dispatch_thru=dispatch, expert_ffn=ffn, moe_combine_res=combine_res):
        yield


@contextlib.contextmanager
def record_routes(routes):
    """Append each MoE layer's routing, in block order, to ``routes``: the
    expert of every token's first and second choice (-1 for none), (2, T)."""
    from ddm_tpu_torch.models import moe as MM
    from ddm_tpu_torch.ops.moe_dispatch import chosen

    real = MM.moe_dispatch_thru

    def dispatch(*args):
        out = real(*args)
        routes.append(torch.stack([chosen(p)[0].reshape(-1) for p in out[2:4]]))
        return out

    with _patched(MM, moe_dispatch_thru=dispatch):
        yield


def _moved(a, b) -> int:
    """Tokens routed to other experts in two runs' routings, over all blocks."""
    return sum(int((x != y).any(0).sum()) for x, y in zip(a, b))


def phase_train_step(cfg, smi, batch=TRAIN_BATCH, m=TRAIN_M, label="train-step",
                     model_name="DiT-S/4", launches=None, weights=None):
    """One training step through the kernels, twice (bit-identical), against
    the plain step within twice bf16's own noise; ``launches`` ``{kernel:
    count}``, where given, are the first kernel step's launches (every
    other kernel none); ``weights``, where given, the fp32 state dict every
    step's model loads (else one seeded draw)."""
    from ddm_tpu_torch.ops import kernel_config as kc
    from ddm_tpu_torch.data.augment import normalize_images
    from ddm_tpu_torch.data.cifar10 import CIFAR10DataConfig, build_cifar10_dataloaders
    from ddm_tpu_torch.models.dit import patchify_images
    from ddm_tpu_torch.models.factory import build_model, make_tokens_apply
    from ddm_tpu_torch.training import distributional_training_step

    beta, size = 0.1, cfg["image_size"]
    moe = cfg["moe_experts"] > 1
    data = CIFAR10DataConfig(batch_size=batch, image_size=size, synthetic=True)
    if size != 32:
        data.synthetic_size = batch  # resize one batch, not the whole set
    loader, _ = build_cifar10_dataloaders(data)
    images, _ = next(iter(loader))
    x0 = normalize_images(torch.from_numpy(images).cuda())
    gen = torch.Generator(device="cuda").manual_seed(3)
    t = torch.rand((batch,), generator=gen, device="cuda")
    eps = torch.randn(x0.shape, generator=gen, device="cuda")
    xi = torch.randn((batch, m, size, size, 3), generator=gen, device="cuda")
    # one seeded draw of the weights, loaded into every step's model
    if weights is None:
        weights = _seeded_weights(cfg)

    def step(dtype, routes=None, backward=True):
        model = build_model({**cfg, "dtype": dtype}, "cuda")
        model.load_state_dict(weights)
        with record_routes([] if routes is None else routes), \
                torch.set_grad_enabled(backward):
            loss, metrics = distributional_training_step(
                make_tokens_apply(model, MOE_AUX_WEIGHT), x0, m=m, beta=beta, lam=1.0,
                w_bias=0.0, t=t, eps=eps, xi=xi,
                target_transform=lambda a: patchify_images(a, cfg["patch_size"]))
        if not backward:
            return None, None
        loss.backward()
        torch.cuda.synchronize()
        grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        return {k: float(v.detach()) for k, v in metrics.items()}, grads

    t0 = time.perf_counter()
    routes = []
    kc.reset_launch_counts()
    got, g_got = step("bfloat16", routes)
    seconds = time.perf_counter() - t0
    counted = {k: v for k, v in kc.launch_counts().items() if v}
    if launches is not None and counted != launches:
        raise AssertionError(f"{label}: the kernel step launched {counted}, expected {launches}")
    again, g_again = step("bfloat16")
    same = again == got and all(torch.equal(g_got[k], g_again[k]) for k in g_got)
    del g_again
    if not same:
        raise AssertionError("two kernel training steps on the same inputs differ")
    routing = ""
    if moe:
        # routing is discrete: count the tokens that each plain step, left to
        # its own argmax, routes otherwise, then give both plain steps the
        # kernel step's routing so that the yardstick measures arithmetic
        r16, r32 = [], []
        with plain_ops():
            step("bfloat16", r16, backward=False)
            step("float32", r32, backward=False)
        routing = (f"; routing over {cfg['depth']} blocks: the plain bf16 step routes "
                   f"{_moved(routes, r16)} tokens otherwise than the kernel step and the plain "
                   f"fp32 step {_moved(r16, r32)} otherwise than the plain bf16 one, so both "
                   "plain steps take the kernel step's routing")
    with plain_ops(replay=routes if moe else None):
        want, g_want = step("bfloat16")
    with plain_ops(replay=routes if moe else None):
        want32, g_want32 = step("float32")

    lines, failed = [], []
    for k in ("loss", "confidence", "interaction") + (("moe_aux",) if moe else ()):
        # twice bf16's own noise on this scalar, which can come out near zero
        # by chance; no tighter than the energy kernel's own rule against its
        # plain version (3c: fp32 sums in another order). The floor decides
        # only where the noise falls below it, and the line says which did.
        err = abs(got[k] - want[k])
        noise, floor = 2.0 * abs(want[k] - want32[k]), ENERGY_RTOL * abs(want[k])
        tol, rule = max((noise, "noise"), (floor, "floor"))
        lines.append(f"{k} {got[k]:.6f} vs plain {want[k]:.6f} (err {err:.3g}, tol {tol:.3g} "
                     f"by {rule}; plain fp32 {want32[k]:.6f})")
        if not (np.isfinite(got[k]) and err <= tol):
            failed.append(f"the kernel step's {k} disagrees with the plain step")
    worst = ("", 0.0)
    for k in g_want:
        err, tol = _rel_frob(g_got[k], g_want[k]), 2.0 * _rel_frob(g_want[k], g_want32[k])
        if not (torch.isfinite(g_got[k]).all() and err <= tol):
            failed.append(f"gradient of {k} disagrees: relF {err:.3g} > tol {tol:.3g}")
        worst = max(worst, (k, err / tol), key=lambda kv: kv[1])
    print(f"[{label}] {model_name}{' MoE' if moe else ''} at {size} px "
          f"(N = {(size // cfg['patch_size']) ** 2} tokens, depth {cfg['depth']}) one step "
          f"(batch {batch} x m {m}, injected t/eps/xi) kernels vs plain (tol = 2 |plain bf16 - "
          f"plain fp32| by noise; for the scalars at least {ENERGY_RTOL:g} relative by floor): "
          + "; ".join(lines)
          + f"; {len(g_want)} parameter gradients against tol (relative Frobenius), "
          f"tightest {worst[0]} at {worst[1]:.3f} of tol; second kernel step bit-identical"
          f"{routing}; launches {counted}; first (cold) step {seconds:.3f} s on {smi}")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))


def _seeded_weights(cfg):
    """The fp32 state dict of ``cfg``'s model, drawn on the CPU from seed 0."""
    from ddm_tpu_torch.models.dit import init_params
    from ddm_tpu_torch.models.factory import build_model

    return init_params(build_model({**cfg, "dtype": "float32"}, "meta").to_empty(device="cpu"),
                       torch.Generator().manual_seed(0)).state_dict()


def phase_train(kc, name, smi):
    import generate_torch
    import train_cifar10_dit_torch

    with tempfile.TemporaryDirectory() as tmp:
        kc.reset_launch_counts()
        result = train_cifar10_dit_torch.main([
            "--synthetic", "--epochs", "1", "--batch", str(TRAIN_BATCH), "--m", str(TRAIN_M),
            "--sample-batch", "64", "--log-every", "1", "--device", "cuda", "--out", tmp])
        total = kc.launch_counts()
        with open(os.path.join(tmp, "train_metrics.json"), encoding="utf-8") as f:
            losses = json.load(f)["loss"]
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"training losses are not {TRAIN_STEPS} finite values: {losses}")
        npz = os.path.join(tmp, "s.npz")
        generate_torch.main(["--ckpt", os.path.join(tmp, "model_final.pt"), "--n", "64",
                             "--batch", "64", "--device", "cuda", "--npz", npz, "--out", ""])
        samples = np.load(npz)["samples"]
        if not (np.isfinite(samples).all() and samples.min() >= -1 and samples.max() <= 1):
            raise AssertionError("samples from the trained checkpoint are not in [-1, 1]")
        for art in ("model_epoch001.pt", "config.json", "samples.png", "epoch_metrics.json"):
            if not os.path.getsize(os.path.join(tmp, art)):
                raise AssertionError(f"the trainer wrote no {art}")
    per_block = DEPTH * TRAIN_STEPS
    train, sample = result["launches"]["train"], result["launches"]["sample"]
    want_train = {k: 0 for k in train}  # K8f/K8b: none at 32 px
    want_train.update({"K1f": per_block, "K2f": per_block, "K1b": per_block, "K2b": per_block,
                       "K3f": TRAIN_STEPS, "K3b": TRAIN_STEPS})
    want_sample = {k: DEPTH * STEPS if k in ("K1f", "K2f") else 0 for k in want_train}
    if train != want_train or sample != want_sample:
        raise AssertionError(f"training launched {train} and its sampler {sample}, expected "
                             f"{want_train} and {want_sample}")
    if total != {k: train[k] + sample[k] for k in train}:
        raise AssertionError(f"the counts read after the run, {total}, do not add up")
    ms = 1e3 * result["seconds_per_step"]
    print(f"[train] train_cifar10_dit_torch: {TRAIN_STEPS} steps (batch {TRAIN_BATCH} x "
          f"m {TRAIN_M}), losses {[round(v, 6) for v in losses]}; warm step {ms:.2f} ms "
          f"(median of steps 2-{TRAIN_STEPS}) = {TRAIN_BATCH / ms * 1e3:.2f} img/s, "
          f"{TRAIN_BATCH * TRAIN_M / ms * 1e3:.2f} denoiser rows/s; epoch incl. first step "
          f"{result['images_per_sec']:.2f} img/s on {name} ({smi}); launches in training "
          f"{train}, in its sampler {sample}; model_final.pt sampled by generate_torch")
    return train


def phase_train_moe(kc, name, smi):
    """The MoE path end to end: the trainer with configs/cifar10_dit_moe.yaml's
    flags for one epoch, its sampler, then generate_torch on its checkpoint."""
    import generate_torch
    import train_cifar10_dit_torch

    flags = ["--moe-experts", str(MOE["moe_experts"]), "--moe-capacity", str(MOE["moe_capacity"]),
             "--moe-group-size", str(MOE["moe_group_size"]), "--moe-topk", str(MOE["moe_topk"]),
             "--moe-aux-weight", str(MOE_AUX_WEIGHT)]
    with tempfile.TemporaryDirectory() as tmp:
        kc.reset_launch_counts()
        result = train_cifar10_dit_torch.main([
            "--synthetic", "--epochs", "1", "--batch", str(TRAIN_BATCH), "--m", str(TRAIN_M),
            *flags, "--sample-batch", "64", "--log-every", "1", "--device", "cuda",
            "--out", tmp])
        total = kc.launch_counts()
        with open(os.path.join(tmp, "train_metrics.json"), encoding="utf-8") as f:
            history = json.load(f)
        for key in ("loss", "moe_aux"):
            if len(history[key]) != TRAIN_STEPS or not np.isfinite(history[key]).all():
                raise AssertionError(f"MoE training {key} is not {TRAIN_STEPS} finite values")
        npz = os.path.join(tmp, "s.npz")
        kc.reset_launch_counts()
        sampled = generate_torch.main(["--ckpt", os.path.join(tmp, "model_final.pt"), "--n", "64",
                                       "--batch", "64", "--device", "cuda", "--npz", npz,
                                       "--out", ""])
        generated = kc.launch_counts()
        samples = np.load(npz)["samples"]
    if not (samples.shape == (64, 32, 32, 3) and np.isfinite(samples).all()
            and samples.min() >= -1 and samples.max() <= 1):
        raise AssertionError("MoE samples are not 64 finite images in [-1, 1]")
    per_block = DEPTH * TRAIN_STEPS
    train, sample = result["launches"]["train"], result["launches"]["sample"]
    want_train = {k: 0 for k in train}
    want_train.update({k: per_block for k in ("K2f", "K2b", "K11f", "K11b", "K10f", "K10b",
                                              "K12f", "K12b")})
    want_train.update({"K3f": TRAIN_STEPS, "K3b": TRAIN_STEPS})
    want_sample = {k: DEPTH * STEPS if k in ("K2f", "K11f", "K10f", "K12f") else 0
                   for k in train}
    if train != want_train or sample != want_sample or generated != want_sample:
        raise AssertionError(f"the MoE run launched {train} in training, {sample} in its "
                             f"sampler and {generated} in generate_torch, expected "
                             f"{want_train}, {want_sample} and {want_sample}")
    if total != {k: train[k] + sample[k] for k in train}:
        raise AssertionError(f"the counts read after the MoE run, {total}, do not add up")
    ms = 1e3 * result["seconds_per_step"]
    print(f"[train-moe] train_cifar10_dit_torch {' '.join(flags)}: {TRAIN_STEPS} steps (batch "
          f"{TRAIN_BATCH} x m {TRAIN_M}), losses {[round(v, 6) for v in history['loss']]}, "
          f"moe_aux {[round(v, 6) for v in history['moe_aux']]}; warm step {ms:.2f} ms (median "
          f"of steps 2-{TRAIN_STEPS}) = {TRAIN_BATCH / ms * 1e3:.2f} img/s, "
          f"{TRAIN_BATCH * TRAIN_M / ms * 1e3:.2f} denoiser rows/s; generate_torch 64 samples x "
          f"{STEPS} steps in {sampled['seconds']:.3f} s = {64 / sampled['seconds']:.2f} "
          f"samples/s; launches in training {train}, in its sampler {sample}, in generate_torch "
          f"{generated}; on {name} ({smi})")
    return train, generated


def _wide_flags(widths, moe=False, topk=MOE["moe_topk"]):
    out = ["--embed-dim", str(widths["embed_dim"]), "--depth", str(widths["depth"]),
           "--heads", str(widths["heads"])]
    if moe:
        out += ["--moe-experts", str(MOE["moe_experts"]), "--moe-capacity",
                str(MOE["moe_capacity"]), "--moe-group-size", str(MOE["moe_group_size"]),
                "--moe-topk", str(topk), "--moe-aux-weight", str(MOE_AUX_WEIGHT)]
    return out


def _partial_check(name, shape, got, want, reordered, ms, plain_ms, smi):
    """An fp32 partial against its plain version: relative Frobenius error
    within max(PARTIAL_RTOL, 2 relF(plain, plain with its sums reordered))."""
    err = float((got - want).abs().max())
    frob, spread = _rel_frob(got, want), _rel_frob(reordered, want)
    tol = max(PARTIAL_RTOL, 2.0 * spread)
    print(f"[kernel] {name} {shape} fp32 partial: relF {frob:.3g} (tol {tol:.3g}: the plain "
          f"version with its sums reordered lies at {spread:.3g}), max_abs_err={err:.6g} of "
          f"largest entry {float(want.abs().max()):.4g}, mean_abs_err="
          f"{float((got - want).abs().mean()):.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of 20) on {smi}")
    if not (np.isfinite(err) and frob <= tol):
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def _k6f_partial(M, smi, gen, T, D, F, fast=False):
    """One K6f on the second hidden chunk of F, read in place from the bf16
    weights, by the fp32 partial rule: ``(max_abs_err, ms, plain_ms, bound)``."""
    from ddm_tpu_torch.ops import gemm

    x, sc, bi, w1, b1, w2, _ = _mlp_args(gen, T, D, F)
    fc = F // 2
    part = (x, sc, bi, w1.to(torch.bfloat16)[fc:], b1[fc:], w2.to(torch.bfloat16)[:, fc:])
    plain = lambda *a: M.mlp_partial_reference(*a, fast_gelu=fast)  # noqa: E731
    shape = f"(T={T}, D={D}, chunk {fc} of F={F}){_fast(fast)}"
    got = torch.empty(T, D, device="cuda")
    with torch.no_grad():
        one = lambda: M._k6f(*part, gemm.PART_STORE, got, fast_gelu=fast)  # noqa: E731
        one()
        torch.cuda.synchronize()
        ms = _median_ms(one)
        plain_ms = _median_ms(lambda: plain(*part))
        # the plain version with the D and hidden axes permuted: the same
        # function, every fp32 sum in another order
        pd, pf = (torch.randperm(n, generator=gen, device="cuda") for n in (D, fc))
        x_, s_, b_, w1_, b1_, w2_ = part
        reordered = plain(x_[:, pd].contiguous(), s_[pd], b_[pd], w1_[pf][:, pd], b1_[pf],
                          w2_[pd][:, pf])[:, torch.argsort(pd)]
        err = _partial_check("K6f", shape, got, plain(*part), reordered, ms, plain_ms, smi)
    bound = _bound(_nbytes(*part, got), 4 * T * D * fc)
    del got, reordered, part, x, w1, w2
    torch.cuda.empty_cache()
    return err, ms, plain_ms, bound


def _fchunked_half_block(M, smi, gen, T, D, F):
    """The F-chunked MLP half-block (two K6f) by the bf16 rule, beside K1f
    unchunked on the same inputs."""
    mlp = _mlp_args(gen, T, D, F)
    with torch.inference_mode():
        before = (M.PARTIAL_LAUNCHES.count, M.LAUNCHES.count)
        got = M.fused_mlp_block(*mlp)
        torch.cuda.synchronize()
        if (M.PARTIAL_LAUNCHES.count - before[0], M.LAUNCHES.count - before[1]) != (2, 0):
            raise AssertionError(f"the MLP half-block at D={D} did not take two K6f")
        herr, hmean, htol, ok = _bf16_errors(got, M.mlp_block_fchunked_reference(*mlp, 2))
        hms = _median_ms(lambda: M.fused_mlp_block(*mlp))
        hplain = _median_ms(lambda: M.mlp_block_fchunked_reference(*mlp, 2))
        k1f_ms = _median_ms(lambda: M._k1f(*mlp))  # unchunked, on the same inputs
    print(f"[kernel] K6f x 2, the F-chunked half-block (T={T}, D={D}, F={F}, k=2) bf16: "
          f"max_abs_err={herr:.6g} (tol {htol:.6g}), mean_abs_err={hmean:.6g}; kernels "
          f"{hms:.4f} ms, plain {hplain:.4f} ms, K1f unchunked on the same inputs {k1f_ms:.4f} ms "
          f"(median of 20) on {smi}")
    if not ok:
        raise AssertionError("the F-chunked half-block disagrees with its plain version")
    out = {"k": 2, "max_abs_err": herr, "ms": hms, "plain_ms": hplain,
           "k1f_unchunked_ms": k1f_ms, **_bound(_nbytes(*mlp, got), 4 * T * D * F)}
    del mlp, got
    torch.cuda.empty_cache()
    return out


def _slot_rows_ffn(gen, E, S, D, F):
    """Expert FFN operands on (E, S, D) bf16 slot rows whose last fifth is
    empty, as the dispatch leaves it."""
    x = torch.randn(E, S, D, generator=gen, device="cuda")
    x[:, S - S // 5:] = 0.0
    return (x.to(torch.bfloat16),
            torch.randn(E, D, F, generator=gen, device="cuda") * D ** -0.5,
            torch.randn(E, F, generator=gen, device="cuda") * 0.1,
            torch.randn(E, F, D, generator=gen, device="cuda") * F ** -0.5,
            torch.randn(E, D, generator=gen, device="cuda") * 0.1)


def _k10p_partial(X, smi, gen, ffn, fast=False, k=2):
    """One K10p on the first of ``k`` hidden chunks of ``ffn``'s F by the
    fp32 partial rule: ``(max_abs_err, ms, plain_ms, bound)``."""
    from ddm_tpu_torch.ops import gemm

    x, w1, b1, w2, _ = ffn
    E, S, D = x.shape
    F = w1.shape[-1]
    fc, bf = F // k, torch.bfloat16
    chunk = (x, w1.to(bf)[:, :, :fc], b1[:, :fc], w2.to(bf)[:, :fc])
    plain = lambda *a: X.expert_partial_reference(*a, fast_gelu=fast)  # noqa: E731
    acc = torch.empty(E, S, D, device="cuda")
    shape = f"(E={E}, S={S}, D={D}, chunk {fc} of F={F}){_fast(fast)}"
    with torch.no_grad():
        one = lambda: X._k10p(*chunk, gemm.NN_F32, acc, fast_gelu=fast)  # noqa: E731
        one()
        torch.cuda.synchronize()
        ms = _median_ms(one)
        plain_ms = _median_ms(lambda: plain(*chunk))
        pd, pf = (torch.randperm(n, generator=gen, device="cuda") for n in (D, fc))
        x_, w1_, b1_, w2_ = chunk
        reordered = plain(x_[:, :, pd].contiguous(), w1_[:, pd][:, :, pf], b1_[:, pf],
                          w2_[:, pf][:, :, pd])
        err = _partial_check("K10p", shape, acc, plain(*chunk),
                             reordered[:, :, torch.argsort(pd)], ms, plain_ms, smi)
    bound = _bound(_nbytes(*chunk, acc), 4 * E * S * D * fc)
    del acc, reordered, chunk
    torch.cuda.empty_cache()
    return err, ms, plain_ms, bound


def phase_wide_kernels(M, A, X, smi):
    """3f: K4, K6f and K10p at the wide paths' training shapes."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    B, N = TRAIN_BATCH * TRAIN_M, 64
    T = B * N
    k4 = []
    for D, H in ((DIT_B["embed_dim"], DIT_B["heads"]), (DIT_L["embed_dim"], DIT_L["heads"])):
        worst, ms, plain_ms, bound = _time_backward(
            _attn_bwd_case(A, gen, B, N, D, H, "K4"), smi,
            {A.SPLIT_BWD_LAUNCHES: 2, A.BWD_LAUNCHES: 0})
        k4.append({"D": D, "H": H, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bound})

    # K6f at DiT-L: one partial on the second hidden chunk, read in place
    # from the bf16 weights, then the F-chunked half-block (k = 2)
    D, F = DIT_L["embed_dim"], 4 * DIT_L["embed_dim"]
    k6f = _entry("K6f", "ddm_tpu_torch/csrc/gemm.cu",
                 ["ddm_tpu_torch/csrc/gemm.cu", "ddm_tpu_torch/csrc/common.cuh"],
                 "ddm_tpu/ops/mlp_block.py:559", *_k6f_partial(M, smi, gen, T, D, F))
    k6f["half_block"] = _fchunked_half_block(M, smi, gen, T, D, F)
    torch.cuda.empty_cache()

    # K10p at DiT-B width: one chunk, then the k = 2 forward, on slot rows
    # whose tail is empty as the dispatch leaves it
    E, S, D, F = MOE["moe_experts"], 20480, DIT_B["embed_dim"], 4 * DIT_B["embed_dim"]
    ffn = _slot_rows_ffn(gen, E, S, D, F)
    k10p = _entry("K10p", "ddm_tpu_torch/csrc/gemm_bwd.cu",
                  ["ddm_tpu_torch/csrc/gemm_bwd.cu", "ddm_tpu_torch/csrc/common.cuh"],
                  "ddm_tpu/ops/expert_ffn.py:213", *_k10p_partial(X, smi, gen, ffn))
    with torch.no_grad():
        before = X.PARTIAL_LAUNCHES.count
        got = X.expert_ffn(*ffn)
        torch.cuda.synchronize()
        if X.PARTIAL_LAUNCHES.count != before + 2:
            raise AssertionError("the DiT-B expert FFN did not take two K10p")
        ferr, fmean, ftol, ok = _bf16_errors(got, X.expert_ffn_fchunked_reference(*ffn, 2))
        fms = _median_ms(lambda: X.expert_ffn(*ffn))
        fplain = _median_ms(lambda: X.expert_ffn_fchunked_reference(*ffn, 2))
    print(f"[kernel] K10p x 2, the F-chunked expert FFN (E={E}, S={S}, D={D}, F={F}, k=2) bf16: "
          f"max_abs_err={ferr:.6g} (tol {ftol:.6g}), mean_abs_err={fmean:.6g}; kernels "
          f"{fms:.4f} ms, plain {fplain:.4f} ms (median of 20) on {smi}")
    if not ok:
        raise AssertionError("the F-chunked expert FFN disagrees with its plain version")
    k10p["forward"] = {"k": 2, "max_abs_err": ferr, "ms": fms, "plain_ms": fplain,
                       **_bound(_nbytes(*ffn, got), 4 * E * S * D * F)}
    srcs = ["ddm_tpu_torch/csrc/attention.cu", "ddm_tpu_torch/csrc/gemm_bwd.cu",
            "ddm_tpu_torch/csrc/gemm.cu", "ddm_tpu_torch/csrc/common.cuh"]
    last = k4[-1]  # the DiT-L shape, the main path's
    k4e = _entry("K4", srcs[0], srcs, "ddm_tpu/ops/attention.py:685", last["max_abs_err"],
                 last["ms"], last["plain_ms"],
                 {k: v for k, v in last.items() if k.startswith("bound")})
    k4e["shapes"] = k4
    return [k4e, k6f, k10p]


def phase_wide_shapes(M, A, MD, X, smi):
    """3f, continued: the kernels of earlier slices at the shapes the wide
    paths give them, each against its plain version by its own rule: K2f at
    DiT-L sampling (64 images) and training (2048), K1b at the DiT-L training
    shape (the F-chunked tier's backward), and K11f/K11b, K12f/K12b and K10b
    at the DiT-B MoE training shape (D 768, F 3072, top-1). Returns
    ``{name: [{"path", "shape", "max_abs_err", "ms", "plain_ms", bound...}]}``,
    which the kernels line carries as each entry's ``shapes``."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    D, H, N, B = DIT_L["embed_dim"], DIT_L["heads"], 64, TRAIN_BATCH * TRAIN_M
    keys = ("max_abs_err", "ms", "plain_ms")
    shapes = {}
    for b in (64, B):
        case = _k2f_case(A, gen, b, N, D, H)
        times = _time_forward(case, smi)
        shapes.setdefault("K2f", []).append(
            {"path": "dit-l", "shape": case[1], **dict(zip(keys, times)), **times[3]})
        del case
        torch.cuda.empty_cache()
    case = _k1b_case(M, gen, B * N, D, 4 * D)
    times = _time_backward(case, smi, {M.BWD_LAUNCHES: 2})
    shapes["K1b"] = [{"path": "dit-l", "shape": case[1], **dict(zip(keys, times)), **times[3]}]
    del case
    torch.cuda.empty_cache()
    D, F = DIT_B["embed_dim"], 4 * DIT_B["embed_dim"]
    for (name, _), times in _moe_kernel_times(MD, X, M, smi, D, F, (1,), k10f=False).items():
        shapes[name] = [{"path": "moe-b", "shape": f"(D={D}, F={F}, top-1)",
                         **dict(zip(keys, times)), **times[3]}]
    return shapes


def _core_inputs(M, attn):
    """The attention core's (B, N, 3D) bf16 [q | k | v] as the half-block
    forms it from its inputs (plain LN and qkv product)."""
    x, scale, bias, wqkv, bqkv = attn[:5]
    bf = torch.bfloat16
    y = M.layer_norm(x.float(), scale, bias).to(bf)
    qkv = (M.matmul_f32(y, wqkv, bf) + bqkv.float()).to(bf)
    return qkv


def _core_library(M, A, gen, attn, H, backward):
    """K2's attention core alone (forward, or K2b's and K4's backward) on the
    half-block's q, k, v, beside PyTorch's SDPA on the same inputs:
    ``{"core_ms", "library_ms"}``."""
    qkv = _core_inputs(M, attn)
    D = qkv.shape[-1] // 3
    datt = torch.randn(*qkv.shape[:2], D, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        core = (_median_ms(lambda: A._core_bwd_att(qkv, datt, H)) if backward else
                _median_ms(lambda: A._k2_core(qkv, H)))
    sdpa = _sdpa_ms(*qkv.split(D, dim=-1), datt, H)["K8b" if backward else "K8f"]
    return {"core_ms": core, "library_ms": sdpa}


def phase_attention_256(M, A, smi):
    """3g: the half-blocks at N = 256 through the query-tile forward core and
    the two-pass backward, with the cores alone timed beside SDPA on the same
    q, k, v. ``{name: [{"path", "shape", ...}]}`` for the kernels line."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    N, keys = PX64_SIZE ** 2 // 16, ("max_abs_err", "ms", "plain_ms")
    B = PX64_BATCH * PX64_M  # 256 denoiser images per training step
    shapes = {}
    library = functools.partial(_core_library, M, A, gen)

    for b in (PX64_BATCH, B):
        case = _k2f_case(A, gen, b, N, 384, 6)
        times = _time_forward(case, smi)
        lib = library(case[4], 6, False)
        print(f"[library] K2f's core alone {lib['core_ms']:.4f} ms, torch "
              f"scaled_dot_product_attention forward {lib['library_ms']:.4f} ms on the same q, k, "
              f"v {case[1]} (median of 20) on {smi}")
        shapes.setdefault("K2f", []).append({"path": "64px", "shape": case[1],
                                             **dict(zip(keys, times)), **times[3], **lib})
        del case
        torch.cuda.empty_cache()
    for name, D, H, counters in (
            ("K2b", 384, 6, {A.BWD_LAUNCHES: 2, A.SPLIT_BWD_LAUNCHES: 0}),
            ("K4", 768, 12, {A.SPLIT_BWD_LAUNCHES: 2, A.BWD_LAUNCHES: 0})):
        case = _attn_bwd_case(A, gen, B, N, D, H, name)
        times = _time_backward(case, smi, counters)
        lib = library(case[4], H, True)
        print(f"[library] {name}'s core alone {lib['core_ms']:.4f} ms, torch "
              f"scaled_dot_product_attention forward + backward {lib['library_ms']:.4f} ms on the "
              f"same q, k, v {case[1]} (median of 20) on {smi}")
        shapes[name] = [{"path": "64px" if name == "K2b" else "64px-dit-b", "shape": case[1],
                         **dict(zip(keys, times)), **times[3], **lib}]
        del case
        torch.cuda.empty_cache()

    # where both backward designs take a shape (N <= 112 at Dh = 64) the
    # one-block core runs: the two passes timed against it at the 32-px
    # training shape, in turns
    B, N, H, Dh = TRAIN_BATCH * TRAIN_M, 64, 6, 64
    qkv = torch.randn(B, N, 3 * H * Dh, generator=gen, device="cuda").to(torch.bfloat16)
    datt = torch.randn(B, N, H * Dh, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        cores = {tiled: _median_ms(lambda t=tiled: A._core_bwd_att(qkv, datt, H, tiled=t))
                 for tiled in (False, True, False, True)}
    print(f"[kernel] K2b's core at (B={B}, N={N}, H={H}, Dh={Dh}): one block per (image, head) "
          f"{cores[False]:.4f} ms, two passes {cores[True]:.4f} ms (median of 20, the second of "
          f"two turns each) on {smi}")
    shapes["K2b"].append({"path": "dit-s", "shape": f"(B={B}, N={N}, H={H}) core only",
                          "one_block_core_ms": cores[False], "two_pass_core_ms": cores[True]})
    return shapes


def _shape_entry(path, case, times):
    return {"path": path, "shape": case[1], **dict(zip(("max_abs_err", "ms", "plain_ms"), times)),
            **times[3]}


def _path_shapes(M, A, smi, gen, path, T, D, F, attn):
    """K1f and K1b at (T, D, F), then each attention half-block of ``attn``
    ``[(name, B, N, D, H), ...]`` (K2f forward; K2b backward), against its
    plain version by its rule above, the backward's second call
    bit-identical. ``{name: [{"path", "shape", ...}]}`` for the kernels line."""
    shapes = {}

    def check(case, backward, counters):
        times = _time_backward(case, smi, counters) if backward else _time_forward(case, smi)
        shapes.setdefault(case[0], []).append(_shape_entry(path, case, times))
        torch.cuda.empty_cache()

    check(_k1f_case(M, gen, T, D, F), False, None)
    check(_k1b_case(M, gen, T, D, F), True, {M.BWD_LAUNCHES: 2})
    for name, B, N, Da, H in attn:
        if name == "K2f":
            check(_k2f_case(A, gen, B, N, Da, H), False, None)
        else:
            check(_attn_bwd_case(A, gen, B, N, Da, H, name), True,
                  {A.BWD_LAUNCHES: 2, A.SPLIT_BWD_LAUNCHES: 0})
    return shapes


def phase_dit_b_kernels(M, A, smi):
    """3h: dense DiT-B's shapes: K1f and K1b at its training shape (the
    fwd-only tier's K1f, then K1b's chain), K2f at its training (2048
    images) and sampling (64) shapes; its K4 is 3f's."""
    D, H = DIT_B["embed_dim"], DIT_B["heads"]
    B = TRAIN_BATCH * TRAIN_M
    return _path_shapes(M, A, smi, torch.Generator(device="cuda").manual_seed(9), "dit-b",
                        B * 64, D, 4 * D, [("K2f", B, 64, D, H), ("K2f", 64, 64, D, H)])


def phase_m32_kernels(M, A, smi):
    """3i: the m = 32 path's training shapes, 256 x 32 = 8,192 denoiser images
    of N = 64: K1f and K1b at T = 524,288, K2f and K2b at B = 8,192."""
    B, D = TRAIN_BATCH * M32, 384
    return _path_shapes(M, A, smi, torch.Generator(device="cuda").manual_seed(10), "m32",
                        B * 64, D, 4 * D, [("K2f", B, 64, D, 6), ("K2b", B, 64, D, 6)])


def phase_attention_core(A, FL, smi):
    """3j: the standalone core K7 at the DiT-L 64-px shapes, against its
    plain versions and beside SDPA, and K8 at head widths 32 and 128.
    Returns ``([K7f entry, K7b entry], {"K8f": [...], "K8b": [...]})``."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    D, H, N = DIT_L["embed_dim"], DIT_L["heads"], PX64_SIZE ** 2 // 16
    srcs = ["ddm_tpu_torch/csrc/attention.cu", "ddm_tpu_torch/csrc/common.cuh"]
    fwd, bwd = _k7_shapes(A, smi, gen, "dit-l64", N, D, H)
    first = fwd[0]
    k7f = _entry("K7f", srcs[0], srcs, "ddm_tpu/ops/attention.py:89", first["max_abs_err"],
                 first["ms"], first["plain_ms"],
                 {k: v for k, v in first.items() if k.startswith("bound")}, first["library_ms"])
    k7f["shape"], k7f["shapes"] = first["shape"], fwd[1:]
    k7b = _entry("K7b", srcs[0], srcs, "ddm_tpu/ops/attention.py:113", bwd["max_abs_err"],
                 bwd["ms"], bwd["plain_ms"],
                 {k: v for k, v in bwd.items() if k.startswith("bound")}, bwd["library_ms"])
    k7b["shape"] = bwd["shape"]
    k8 = {"K8f": [], "K8b": []}
    for H8 in K8_WIDE_HEADS:
        case = _k8_case(FL, smi, gen, 128, 1024, H8, 384 // H8, library=True)
        for name in k8:
            k8[name].append({"path": f"128px-dh{case['Dh']}", **_k8_shape(case, name)})
    return [k7f, k7b], k8


def _k7_shapes(A, smi, gen, path, N, D, H):
    """K7f at the 64-px paths' training (256 images) and sampling (64)
    shapes and K7b at the training one, on q, k, v read in place from a
    [q | k | v] buffer, against their plain versions by the bf16 rule (K7b's
    second call bit-identical), beside SDPA: ``([K7f shapes], K7b shape)``."""
    Dh = D // H
    fwd, bwd = [], None
    for B in (PX64_BATCH * PX64_M, PX64_BATCH):  # training (256 images), sampling (64)
        qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.split(D, dim=-1)  # read in place, row stride 3D
        do = torch.randn(B, N, D, generator=gen, device="cuda").to(torch.bfloat16)
        shape = f"(B={B}, N={N}, D={D}, H={H})"
        core = 2 * B * H * N * N * Dh  # one (N x N x Dh) product per image and head
        with torch.no_grad():
            o = A.attention_core_fwd(q, k, v, H)
            torch.cuda.synchronize()
            max_err, mean_err, tol, ok = _bf16_errors(o, A.attention_reference(q, k, v, H))
            ms = _median_ms(lambda: A.attention_core_fwd(q, k, v, H))
            plain_ms = _median_ms(lambda: A.attention_reference(q, k, v, H))
        lib = _sdpa_ms(q, k, v, do, H)
        print(f"[kernel] K7f {shape} bf16: max_abs_err={max_err:.6g} (tol {tol:.6g}), "
              f"mean_abs_err={mean_err:.6g} (tol {KERNEL_MEAN_TOL:g}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; torch scaled_dot_product_attention forward "
              f"{lib['K8f']:.4f} ms on the same q, k, v (median of 20) on {smi}")
        if not ok:
            raise AssertionError(f"K7f {shape} disagrees with its plain version")
        fwd.append({"path": path, "shape": shape, "max_abs_err": max_err, "ms": ms,
                    "plain_ms": plain_ms, **_bound(_nbytes(qkv, o), 2 * core),
                    "library_ms": lib["K8f"]})
        if bwd is None:
            with torch.no_grad():
                grads = A.attention_core_bwd(q, k, v, do, H)
                again = A.attention_core_bwd(q, k, v, do, H)
                torch.cuda.synchronize()
                if not all(torch.equal(g, h) for g, h in zip(grads, again)):
                    raise AssertionError(f"K7b {shape} is not deterministic: two calls differ")
                del again
                want = A.attention_core_bwd_reference(q, k, v, do, H)
                parts, worst, ok = [], 0.0, True
                for label, g, w in zip(("dq", "dk", "dv"), grads, want):
                    e, mean, tol, good = _bf16_errors(g, w)
                    ok, worst = ok and good, max(worst, e)
                    parts.append(f"{label} max {e:.4g} (tol {tol:.4g}) mean {mean:.3g}")
                del want
                bms = _median_ms(lambda: A.attention_core_bwd(q, k, v, do, H))
                bplain = _median_ms(lambda: A.attention_core_bwd_reference(q, k, v, do, H))
            print(f"[kernel] K7b {shape} bf16 (second call bit-identical): " + "; ".join(parts)
                  + f"; kernel {bms:.4f} ms, plain {bplain:.4f} ms; torch "
                  f"scaled_dot_product_attention forward + backward {lib['K8b']:.4f} ms on the "
                  f"same q, k, v (median of 20) on {smi}")
            if not ok:
                raise AssertionError(f"K7b {shape} disagrees with its plain version")
            # q, k, v and do read, dq, dk and dv written; S, dV, dP, dQ, dK
            bwd = {"path": path, "shape": shape, "max_abs_err": worst, "ms": bms,
                   "plain_ms": bplain, **_bound(_nbytes(qkv, do) + _nbytes(qkv), 5 * core),
                   "library_ms": lib["K8b"]}
            del grads
        del qkv, q, k, v, do, o
        torch.cuda.empty_cache()
    return fwd, bwd


def _energy_launches(B, m, D):
    """The energy kernels one step at (B, m, D) launches: its route's pair."""
    from ddm_tpu_torch.ops import energy as E

    route = E.energy_route(B, m, D)
    return {f"{route}f": 1, f"{route}b": 1} if route else {}


def phase_train_step_rung3(cfg, smi):
    """6i: one DiT-L/4 step at 64 px (K7f/K7b, K6f, K1b), one 96-px DiT-S
    step (the plain core, K1f/K1b) and one 128-px step at --heads 3 (K8 at
    Dh 128), each against the plain step, with its launches counted."""
    depth = DIT_L["depth"]
    phase_train_step(
        {**cfg, **DIT_L, "image_size": PX64_SIZE}, smi, L64_STEP_BATCH, L64_STEP_M,
        "train-step-l64", "DiT-L/4",
        {"K7f": depth, "K7b": depth, "K6f": 2 * depth, "K1b": depth,
         **_energy_launches(L64_STEP_BATCH, L64_STEP_M, 3 * PX64_SIZE ** 2)})
    phase_train_step(
        {**cfg, "image_size": PX96_SIZE}, smi, LONG_BATCH, LONG_M, "train-step-96", "DiT-S/4",
        {"K1f": DEPTH, "K1b": DEPTH, **_energy_launches(LONG_BATCH, LONG_M, 3 * PX96_SIZE ** 2)})
    phase_train_step(
        {**cfg, "image_size": LONG_SIZE, "heads": 3, "depth": H3_DEPTH}, smi, LONG_BATCH, LONG_M,
        "train-step-128-h3", "DiT-S/4 --heads 3",
        {"K8f": H3_DEPTH, "K8b": H3_DEPTH, "K1f": H3_DEPTH, "K1b": H3_DEPTH,
         **_energy_launches(LONG_BATCH, LONG_M, 3 * LONG_SIZE ** 2)})


def _k8_launches(depth):
    """Launches per training step and per 20-step sampler call of a 128-px
    DiT of ``depth`` blocks at 16 x m 8: K8 and K1 a block (the MLP tier at
    D 768 is fwdonly, at D 384 fused: K1f and K1b either way), the energy
    score's plain version at D 49,152."""
    return ({k: depth for k in ("K8f", "K8b", "K1f", "K1b")},
            {"K8f": depth * STEPS, "K1f": depth * STEPS})


def phase_train_step_heads(cfg, smi):
    """6o: one step of DiT-B/4 at --heads 3 (Dh 256) and of DiT-S/4 at
    --heads 24 (Dh 16) at 128 px, through K8 at those widths (and K1), and
    one 32-px step at D 1472 over 8 heads, depth 2 (no GEMM tier: the third
    rung's plain products around the plain core, as JAX's XLA), each
    against the plain step, with its launches counted."""
    size, energy = LONG_SIZE, _energy_launches(L64_STEP_BATCH, L64_STEP_M, 3 * LONG_SIZE ** 2)
    for widths, label, model_name in ((B_H3, "train-step-b-h3", "DiT-B/4 --heads 3"),
                                      (S_H24, "train-step-s-h24", "DiT-S/4 --heads 24")):
        phase_train_step(
            {**cfg, **widths, "image_size": size}, smi, L64_STEP_BATCH, L64_STEP_M, label,
            model_name, {**_k8_launches(widths["depth"])[0], **energy})
    phase_train_step({**cfg, **WIDE_PLAIN}, smi, WIDE_PLAIN_BATCH, L64_STEP_M, "train-step-d1472",
                     "DiT --embed-dim 1472 --heads 8",
                     _energy_launches(WIDE_PLAIN_BATCH, L64_STEP_M, 3 * 32 ** 2))


def phase_train_wide(kc, name, smi, label, flags, per_step, per_sample, batch=TRAIN_BATCH,
                     m=TRAIN_M, size=32, images=2048):
    """7d-7m: the trainer with ``flags`` for one epoch of ``images`` synthetic
    images (batch x m, images of ``size`` px), its peak memory and launches
    per step (``per_step``), then generate_torch's 64 samples from its
    ``model_final.pt`` and the sampler's launches per call (``per_sample``)."""
    import generate_torch
    import train_cifar10_dit_torch
    from ddm_tpu_torch.data.cifar10 import CIFAR10DataConfig

    keys = ("loss", "moe_aux") if "--moe-experts" in flags else ("loss",)
    steps = images // batch
    data = functools.partial(CIFAR10DataConfig, synthetic_size=images)
    with tempfile.TemporaryDirectory() as tmp, \
            _patched(train_cifar10_dit_torch, CIFAR10DataConfig=data):
        torch.cuda.reset_peak_memory_stats()
        kc.reset_launch_counts()
        result = train_cifar10_dit_torch.main([
            "--synthetic", "--epochs", "1", "--batch", str(batch), "--m", str(m),
            "--image-size", str(size), *flags, "--sample-batch", "64", "--log-every", "1",
            "--device", "cuda", "--out", tmp])
        total = kc.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(tmp, "train_metrics.json"), encoding="utf-8") as f:
            history = json.load(f)
        for key in keys:
            if len(history[key]) != steps or not np.isfinite(history[key]).all():
                raise AssertionError(f"{label}: {key} is not {steps} finite values")
        npz = os.path.join(tmp, "s.npz")
        kc.reset_launch_counts()
        sampled = generate_torch.main(["--ckpt", os.path.join(tmp, "model_final.pt"), "--n", "64",
                                       "--batch", "64", "--device", "cuda", "--npz", npz,
                                       "--out", ""])
        generated = kc.launch_counts()
        samples = np.load(npz)["samples"]
    if not (samples.shape == (64, size, size, 3) and np.isfinite(samples).all()
            and samples.min() >= -1 and samples.max() <= 1):
        raise AssertionError(f"{label}: samples are not 64 finite images of {size} px in "
                             "[-1, 1]")
    train, sample = result["launches"]["train"], result["launches"]["sample"]
    want_train = {k: steps * per_step.get(k, 0) for k in train}
    want_sample = {k: per_sample.get(k, 0) for k in train}
    if train != want_train or sample != want_sample or generated != want_sample:
        raise AssertionError(f"{label} launched {train} in training, {sample} in its sampler and "
                             f"{generated} in generate_torch, expected {want_train}, "
                             f"{want_sample} and {want_sample}")
    if total != {k: train[k] + sample[k] for k in train}:
        raise AssertionError(f"{label}: the counts read after the run, {total}, do not add up")
    ms = 1e3 * result["seconds_per_step"]
    print(f"[{label}] train_cifar10_dit_torch {' '.join(['--image-size', str(size), *flags])}: "
          f"{steps} "
          f"steps (batch {batch} x m {m}), " + "; ".join(
              f"{k} first {[round(v, 6) for v in history[k][:3]]} last "
              f"{[round(v, 6) for v in history[k][-3:]]}" for k in keys)
          + f"; warm step {ms:.2f} ms (median of steps 2-{steps}) = "
          f"{batch / ms * 1e3:.2f} img/s, {batch * m / ms * 1e3:.2f} denoiser rows/s; peak "
          f"memory {peak:.2f} GiB; generate_torch 64 samples x {STEPS} steps in "
          f"{sampled['seconds']:.3f} s = {64 / sampled['seconds']:.2f} samples/s; launches per "
          f"training step { {k: v // steps for k, v in train.items() if v} }, per sampler call "
          f"{ {k: v for k, v in generated.items() if v} }; on {name} ({smi})")
    return train, generated


def _k6b_case(M, gen, T, D, F, fast=False):
    x, sc, bi, w1, b1, w2, _ = _mlp_args(gen, T, D, F)
    do = torch.randn(T, D, generator=gen, device="cuda")  # fp32: the all-reduced partial's
    args = (x, sc, bi, w1, b1, w2, do)
    return ("K6b", f"(T={T}, D={D}, F={F}){_fast(fast)}",
            lambda: M.mlp_partial_bwd(*args, fast_gelu=fast),
            lambda: M.mlp_partial_bwd_reference(*args, fast_gelu=fast), args,
            # the W1 recompute, dW2, dh, dW1 and dy products
            10 * T * D * F)


def phase_tp_kernels(M, A, smi):
    """3k: K6f's TP entry and K6b at the DiT-S --tp 2 shard, K6b at the DiT-B
    shard, K7f/K7b through ``fused_attention`` on separate q, k, v. Returns
    ``([K6b entry], {"K6f": [...], "K7f": [...], "K7b": [...]})``."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    T = TRAIN_BATCH * TRAIN_M * 64
    shapes = {}
    D, F = 384, 4 * 384 // TP
    x, sc, bi, w1, b1, w2, _ = _mlp_args(gen, T, D, F)
    part = (x, sc, bi, w1, b1, w2)
    shape = f"(T={T}, D={D}, F={F}) the DiT-S --tp {TP} shard"
    with torch.no_grad():
        before = M.PARTIAL_LAUNCHES.count
        got = M.fused_mlp_partial(*part)
        torch.cuda.synchronize()
        if M.PARTIAL_LAUNCHES.count - before != 1:
            raise AssertionError("fused_mlp_partial did not launch one K6f")
        pd, pf = (torch.randperm(n, generator=gen, device="cuda") for n in (D, F))
        reordered = M.mlp_partial_reference(
            x[:, pd].contiguous(), sc[pd], bi[pd], w1[pf][:, pd], b1[pf], w2[pd][:, pf])
        reordered = reordered[:, torch.argsort(pd)]
        ms = _median_ms(lambda: M.fused_mlp_partial(*part))
        plain_ms = _median_ms(lambda: M.mlp_partial_reference(*part))
        err = _partial_check("K6f (TP entry)", shape, got, M.mlp_partial_reference(*part),
                             reordered, ms, plain_ms, smi)
    shapes["K6f"] = [{"path": "tp", "shape": shape, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, **_bound(_nbytes(*part, got), 4 * T * D * F)}]
    del got, reordered, part, x, w1, w2
    torch.cuda.empty_cache()

    k6b = []
    for D, F, path in ((384, 4 * 384 // TP, "tp"), (DIT_B["embed_dim"],
                                                     4 * DIT_B["embed_dim"] // TP, "tp-dit-b")):
        case = _k6b_case(M, gen, T, D, F)
        times = _time_backward(case, smi, {M.PARTIAL_BWD_LAUNCHES: 2, M.BWD_LAUNCHES: 0})
        k6b.append(_shape_entry(path, case, times))
        del case
        torch.cuda.empty_cache()
    srcs = ["ddm_tpu_torch/csrc/gemm_bwd.cu", "ddm_tpu_torch/csrc/gemm.cu",
            "ddm_tpu_torch/csrc/common.cuh"]
    first = k6b[0]
    entry = _entry("K6b", srcs[0], srcs, "ddm_tpu/ops/mlp_block.py:218", first["max_abs_err"],
                   first["ms"], first["plain_ms"],
                   {k: v for k, v in first.items() if k.startswith("bound")})
    entry["shape"], entry["shapes"] = first["shape"], k6b[1:]

    # K7 through fused_attention on three separate (B, N, D) tensors
    B, N, D, H = TRAIN_BATCH * TRAIN_M, 64, 384, 6
    q, k, v, do = (torch.randn(B, N, D, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    shape = f"(B={B}, N={N}, D={D}, H={H}) separate q, k, v"
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (A.CORE_LAUNCHES.count, A.CORE_BWD_LAUNCHES.count)
    o = A.fused_attention(*leaves, H)
    grads = torch.autograd.grad(o, leaves, do)
    again = torch.autograd.grad(A.fused_attention(*leaves, H), leaves, do)
    torch.cuda.synchronize()
    if (A.CORE_LAUNCHES.count - before[0], A.CORE_BWD_LAUNCHES.count - before[1]) != (2, 2):
        raise AssertionError(f"fused_attention at {shape} did not take K7f and K7b")
    if not all(torch.equal(g, h) for g, h in zip(grads, again)):
        raise AssertionError(f"K7b {shape} is not deterministic: two calls differ")
    with torch.no_grad():
        ferr, fmean, ftol, ok = _bf16_errors(o, A.attention_reference(q, k, v, H))
        parts, berr = [], 0.0
        for label, g, w in zip(("dq", "dk", "dv"), grads,
                               A.attention_core_bwd_reference(q, k, v, do, H)):
            e, mean, tol, good = _bf16_errors(g, w)
            ok, berr = ok and good, max(berr, e)
            parts.append(f"{label} max {e:.4g} (tol {tol:.4g}) mean {mean:.3g}")
        fms = _median_ms(lambda: A.fused_attention(q, k, v, H))
        fplain = _median_ms(lambda: A.attention_reference(q, k, v, H))
        bms = _median_ms(lambda: A.attention_core_bwd(q, k, v, do, H))
        bplain = _median_ms(lambda: A.attention_core_bwd_reference(q, k, v, do, H))
    lib = _sdpa_ms(q, k, v, do, H)
    print(f"[kernel] K7f/K7b through fused_attention {shape} bf16: o max_abs_err={ferr:.6g} "
          f"(tol {ftol:.6g}) mean {fmean:.3g}; " + "; ".join(parts) + f" (second backward "
          f"bit-identical); K7f {fms:.4f} ms (plain {fplain:.4f}), K7b {bms:.4f} ms (plain "
          f"{bplain:.4f}); torch scaled_dot_product_attention forward {lib['K8f']:.4f} ms, "
          f"forward + backward {lib['K8b']:.4f} ms on the same q, k, v (median of 20) on {smi}")
    if not ok:
        raise AssertionError(f"K7 through fused_attention {shape} disagrees with its plain version")
    core = 2 * B * H * N * N * (D // H)
    shapes["K7f"] = [{"path": "tp", "shape": shape, "max_abs_err": ferr, "ms": fms,
                      "plain_ms": fplain, **_bound(_nbytes(q, k, v, o), 2 * core),
                      "library_ms": lib["K8f"]}]
    shapes["K7b"] = [{"path": "tp", "shape": shape, "max_abs_err": berr, "ms": bms,
                      "plain_ms": bplain, **_bound(_nbytes(q, k, v, do, *grads), 5 * core),
                      "library_ms": lib["K8b"]}]
    return [entry], shapes


def _tp_spec(cfg, widths, seed):
    # no clipped second step: this check holds the gradients and the loss
    return {"model": {**cfg, **widths, "tp": TP}, "batch": TP_STEP_BATCH, "m": TRAIN_M,
            "seed": seed, "clip": False}


def _tp_parity(cfg, smi, tmp):
    """7j (a): the two-rank step at DiT-S and DiT-B widths against the
    one-process plain step, within twice bf16's own noise on it."""
    from ddm_tpu_torch.parallel import check

    specs = [_tp_spec(cfg, {}, 20), _tp_spec(cfg, DIT_B, 21)]
    t0 = time.perf_counter()
    results = check.launch(TP, TP, [{**sp, "model": {**sp["model"], "dtype": "bfloat16"}}
                                    for sp in specs],
                           os.path.join(tmp, "tp_step.pt"), os.path.join(tmp, "rdzv"),
                           device="cuda", timeout=600)
    seconds = time.perf_counter() - t0
    for spec, got in zip(specs, results):
        cfg, depth = spec["model"], spec["model"]["depth"]
        name = "DiT-S/4" if cfg["embed_dim"] == 384 else "DiT-B/4"
        weights = check.full_weights(cfg, spec["seed"])
        inputs = check.step_inputs(cfg, spec["batch"], spec["m"], spec["seed"] + 2)
        with plain_ops():
            want = check.oracle_step({**cfg, "dtype": "bfloat16"}, weights, inputs, 1, "cuda")
            want32 = check.oracle_step({**cfg, "dtype": "float32"}, weights, inputs, 1, "cuda")
        lines, failed = [], []
        for k in ("loss", "confidence", "interaction"):
            g, w, w32 = got["metrics"][k], want["metrics"][k], want32["metrics"][k]
            err, noise, floor = abs(g - w), 2.0 * abs(w - w32), ENERGY_RTOL * abs(w)
            tol, rule = max((noise, "noise"), (floor, "floor"))
            lines.append(f"{k} {g:.6f} vs {w:.6f} (err {err:.3g}, tol {tol:.3g} by {rule})")
            if not (np.isfinite(g) and err <= tol):
                failed.append(f"{name}: the two-rank {k} disagrees with the one-process step")
        worst = ("", 0.0)
        for k, w in want["grads"].items():
            err = _rel_frob(got["grads"][k], w)
            tol = 2.0 * _rel_frob(w, want32["grads"][k])
            if not (torch.isfinite(got["grads"][k]).all() and err <= tol):
                failed.append(f"{name}: gradient of {k} disagrees: relF {err:.3g} > tol {tol:.3g}")
            worst = max(worst, (k, err / tol), key=lambda kv: kv[1])
        local_d = cfg["embed_dim"] // TP
        want_launches = {"K6f": depth, "K6b": depth, "K3f": 1, "K3b": 1}
        if local_d % 128 == 0:  # the JAX gate takes K7 at the local width
            want_launches.update({"K7f": depth, "K7b": depth})
        if any(r != want_launches for r in got["launches"]):
            failed.append(f"{name}: the ranks launched {got['launches']}, each expected "
                          f"{want_launches}")
        print(f"[train-tp] {name} two ranks (tp {TP}, gloo, one card) one step (batch "
              f"{spec['batch']} x m {spec['m']}, depth {depth}, injected t/eps/xi) against the "
              f"one-process plain step (tol = 2 |plain bf16 - plain fp32|): " + "; ".join(lines)
              + f"; {len(want['grads'])} gathered gradients, tightest {worst[0]} at "
              f"{worst[1]:.3f} of tol; launches per rank {got['launches']}; first step "
              f"{got['first_step_seconds']:.3f} s on {smi}")
        if failed:
            raise AssertionError("train-tp: " + "; ".join(failed))
    return seconds


def phase_train_tp(cfg, kc, name, smi):
    """7j: the two-rank step (a), the trainer through torch.distributed.run
    (b), and generate_torch on its checkpoint (c). Returns ``(training
    launches of rank 0, generate_torch's launches)`` for the kernels line."""
    import generate_torch

    with tempfile.TemporaryDirectory() as tmp:
        parity_s = _tp_parity(cfg, smi, tmp)
        out = os.path.join(tmp, "run")
        # "--" ends torch.distributed.run's own options: its parser may take the
        # trainer's --m for an abbreviation of one of them
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
               str(TP), "--", "train_cifar10_dit_torch.py", "--synthetic", "--tp", str(TP),
               "--epochs", "1", "--batch", str(TRAIN_BATCH), "--m", str(TP_TRAIN_M),
               "--sample-batch", "64", "--log-every", "1", "--device", "cuda", "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            log, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the --tp {TP} trainer exited with {proc.returncode}:\n"
                                 f"{log[-6000:]}")
        backend = [ln for ln in log.splitlines() if "torch.distributed backend" in ln]
        ranks = []
        for r in range(TP):
            with open(os.path.join(out, f"result_rank{r}.json"), encoding="utf-8") as f:
                ranks.append(json.load(f))
        with open(os.path.join(out, "train_metrics.json"), encoding="utf-8") as f:
            losses = json.load(f)["loss"]
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"--tp {TP} training losses are not {TRAIN_STEPS} finite values")
        npz = os.path.join(tmp, "s.npz")
        kc.reset_launch_counts()
        sampled = generate_torch.main([
            "--ckpt", os.path.join(out, "model_final.pt"), "--n", str(N_SAMPLES), "--batch",
            str(N_SAMPLES), "--steps", str(STEPS), "--device", "cuda", "--npz", npz,
            "--out", ""])
        generated = kc.launch_counts()
        samples = np.load(npz)["samples"]
    if not (samples.shape == (N_SAMPLES, 32, 32, 3) and np.isfinite(samples).all()
            and samples.min() >= -1 and samples.max() <= 1):
        raise AssertionError("the TP checkpoint's samples are not finite images in [-1, 1]")
    per_step = {"K6f": DEPTH, "K6b": DEPTH, "K3f": 1, "K3b": 1}
    full_sample = {"K7f": DEPTH * STEPS, "K6f": DEPTH * STEPS}
    failed = []
    for r, res in enumerate(ranks):
        train = {k: v for k, v in res["launches"]["train"].items() if v}
        sample = {k: v for k, v in res["launches"]["sample"].items() if v}
        want_sample = full_sample if r == 0 else {}  # rank 0 samples 64 through the full instance
        if train != {k: TRAIN_STEPS * v for k, v in per_step.items()} or sample != want_sample:
            failed.append(f"rank {r} launched {train} in training and {sample} in its sampler")
    gen_counts = {k: v for k, v in generated.items() if v}
    if gen_counts != full_sample:
        failed.append(f"generate_torch launched {gen_counts}, expected {full_sample}")
    if failed:
        raise AssertionError(f"train-tp: {'; '.join(failed)}; expected {per_step} per step and "
                             f"rank, {full_sample} per sampler call")
    ms = 1e3 * ranks[0]["seconds_per_step"]
    rate = N_SAMPLES / sampled["seconds"]
    print(f"[train-tp] python {' '.join(cmd[1:8])} --tp {TP} --batch {TRAIN_BATCH} --m "
          f"{TP_TRAIN_M}: {backend}; {TRAIN_STEPS} steps, losses "
          f"{[round(v, 6) for v in losses]}; warm step {ms:.2f} ms (median of steps "
          f"2-{TRAIN_STEPS}, rank 0) = {TRAIN_BATCH / ms * 1e3:.2f} img/s on the one card; "
          f"launches per rank and step {per_step}; the run {seconds:.1f} s, the two-rank step "
          f"check {parity_s:.1f} s; generate_torch on its checkpoint (tp {TP}): {N_SAMPLES} "
          f"samples x {STEPS} steps in {sampled['seconds']:.3f} s = {rate:.2f} samples/s through "
          f"the full instance, launches {gen_counts}; on {name} ({smi})")
    return {k: ranks[0]["launches"]["train"].get(k, 0) for k in generated}, generated


def phase_train_step_xl(cfg, smi):
    """6k: one DiT-XL/4 step at full depth 28, at 32 px (batch 16 x m 8: K2f,
    K4, K6f, K1b) and at 64 px (8 x m 4: K7f, K7b, K6f, K1b), each against
    the plain step with its launches counted."""
    depth, size = DIT_XL["depth"], 32
    phase_train_step(
        {**cfg, **DIT_XL}, smi, XL_STEP_BATCH, TRAIN_M, "train-step-xl", "DiT-XL/4",
        {"K2f": depth, "K4": depth, "K6f": 2 * depth, "K1b": depth,
         **_energy_launches(XL_STEP_BATCH, TRAIN_M, 3 * size ** 2)})
    phase_train_step(
        {**cfg, **DIT_XL, "image_size": PX64_SIZE}, smi, L64_STEP_BATCH, L64_STEP_M,
        "train-step-xl64", "DiT-XL/4",
        {"K7f": depth, "K7b": depth, "K6f": 2 * depth, "K1b": depth,
         **_energy_launches(L64_STEP_BATCH, L64_STEP_M, 3 * PX64_SIZE ** 2)})


def phase_xl_kernels(M, A, smi):
    """3l: DiT-XL/4's shapes (D 1152, 16 heads of Dh 72, F 4608) and Dh 24:
    K2f at 2048 and 256 images of (64, 1152) and K4 at 2048 (the 32-px
    path), K7f at 256 and 64 images of (256, 1152) and K7b at 256 beside
    SDPA (the 64-px path), one K6f partial on a chunk of 2304 of (131,072 x
    1152, F 4608) and the k = 2 half-block, K1b at (131,072, 1152, 4608);
    K2f at (256, 64, 384, H 16) and K2b at (2048, 64, 384, H 16). Each
    against its plain version by its rule above, every backward's second
    call bit-identical. ``{name: [{"path", "shape", ...}]}`` for the kernels
    line."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    D, H, N = DIT_XL["embed_dim"], DIT_XL["heads"], 64
    B = TRAIN_BATCH * TRAIN_M
    T, F = B * N, 4 * D
    shapes = {}

    def add(path, case, times):
        shapes.setdefault(case[0], []).append(_shape_entry(path, case, times))
        torch.cuda.empty_cache()

    for b in (B, N_SAMPLES):
        case = _k2f_case(A, gen, b, N, D, H)
        add("dit-xl", case, _time_forward(case, smi))
        if b == B:  # the training shape's core alone, beside SDPA
            shapes["K2f"][0].update(_core_library(M, A, gen, case[4], H, False))
    case = _attn_bwd_case(A, gen, B, N, D, H, "K4")
    add("dit-xl", case, _time_backward(case, smi, {A.SPLIT_BWD_LAUNCHES: 2, A.BWD_LAUNCHES: 0}))
    shapes["K4"][0].update(_core_library(M, A, gen, case[4], H, True))
    for name in ("K2f", "K4"):
        lib = shapes[name][0]
        print(f"[library] {name}'s core alone {lib['core_ms']:.4f} ms, torch "
              f"scaled_dot_product_attention {'forward + backward' if name == 'K4' else 'forward'} "
              f"{lib['library_ms']:.4f} ms on the same q, k, v {lib['shape']} (median of 20) on "
              f"{smi}")
    fwd, bwd = _k7_shapes(A, smi, gen, "dit-xl64", PX64_SIZE ** 2 // 16, D, H)
    shapes["K7f"], shapes["K7b"] = fwd, [bwd]
    err, ms, plain_ms, bound = _k6f_partial(M, smi, gen, T, D, F)
    shapes["K6f"] = [{"path": "dit-xl", "shape": f"(T={T}, D={D}, chunk {F // 2} of F={F})",
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
                      "half_block": _fchunked_half_block(M, smi, gen, T, D, F)}]
    case = _k1b_case(M, gen, T, D, F)
    add("dit-xl", case, _time_backward(case, smi, {M.BWD_LAUNCHES: 2}))
    case = _k2f_case(A, gen, N_SAMPLES, N, 384, DH24_HEADS)
    add("dh24", case, _time_forward(case, smi))
    case = _attn_bwd_case(A, gen, B, N, 384, DH24_HEADS, "K2b")
    add("dh24", case, _time_backward(case, smi, {A.BWD_LAUNCHES: 2, A.SPLIT_BWD_LAUNCHES: 0}))
    return shapes


def phase_fast_gelu_kernels(M, X, smi):
    """3m: the fast-GELU variants (``--fast-gelu``, the GELU epilogues'
    launch parameter) at their rows' shapes, against their plain versions
    with ``fast_gelu``, each by its rule above, every backward's second call
    bit-identical: K1f at (16,384, 384, F 1536), K1b at (131,072, 384, 1536),
    one K6f partial at DiT-L's (131,072 x 1024, chunk 2048 of F 4096), K6b at
    the DiT-S --tp 2 shard (131,072, 384, F 768), K10f and K10b at (8,
    20480, 384, F 1536) and one K10p partial at (8, 20480, 768, chunk 1536 of
    F 3072), on slot rows whose last fifth is empty. ``{name: [...]}``."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    T = TRAIN_BATCH * TRAIN_M * 64
    shapes = {}

    def add(case, times):
        shapes.setdefault(case[0], []).append(_shape_entry("fast-gelu", case, times))
        torch.cuda.empty_cache()

    def partial(name, shape, times):
        shapes[name] = [{"path": "fast-gelu", "shape": shape,
                         **dict(zip(("max_abs_err", "ms", "plain_ms"), times)), **times[3]}]

    case = _k1f_case(M, gen, N_SAMPLES * 64, 384, 1536, fast=True)
    add(case, _time_forward(case, smi))
    case = _k1b_case(M, gen, T, 384, 1536, fast=True)
    add(case, _time_backward(case, smi, {M.BWD_LAUNCHES: 2}))
    D, F = DIT_L["embed_dim"], 4 * DIT_L["embed_dim"]
    partial("K6f", f"(T={T}, D={D}, chunk {F // 2} of F={F}) fast-GELU",
            _k6f_partial(M, smi, gen, T, D, F, fast=True))
    case = _k6b_case(M, gen, T, 384, 4 * 384 // TP, fast=True)
    add(case, _time_backward(case, smi, {M.PARTIAL_BWD_LAUNCHES: 2, M.BWD_LAUNCHES: 0}))
    E, S, D, F = MOE["moe_experts"], 20480, 384, 1536
    ffn = _slot_rows_ffn(gen, E, S, D, F)
    dout = torch.randn(E, S, D, generator=gen, device="cuda").to(torch.bfloat16)
    shape = f"(E={E}, S={S}, D={D}, F={F}) fast-GELU"
    case = ("K10f", shape, lambda *a: X.expert_ffn(*a, fast_gelu=True),
            lambda *a: X.expert_ffn_reference(*a, fast_gelu=True), ffn, 4 * E * S * D * F)
    add(case, _time_forward(case, smi))
    case = ("K10b", shape, lambda: X.expert_ffn_bwd(*ffn, dout, fast_gelu=True),
            lambda: X.expert_ffn_bwd_reference(*ffn, dout, fast_gelu=True), (*ffn, dout),
            # the h recompute, dW2, dg, dW1 and dx products
            10 * E * S * D * F)
    add(case, _time_backward(case, smi, {X.BWD_LAUNCHES: 2},
                             labels=("dx", "dW1", "db1", "dW2", "db2")))
    del ffn, dout, case
    torch.cuda.empty_cache()
    D, F = DIT_B["embed_dim"], 4 * DIT_B["embed_dim"]
    partial("K10p", f"(E={E}, S={S}, D={D}, chunk {F // 2} of F={F}) fast-GELU",
            _k10p_partial(X, smi, gen, _slot_rows_ffn(gen, E, S, D, F), fast=True))
    return shapes


def phase_moe_xl_kernels(MD, X, ML, smi):
    """3n: the MoE at DiT-XL/4's width. K11f/K11b and K12f/K12b at the
    training shape (T 131,072 rows of D 1152, E 8, groups of 256), top-1 (cap
    40, S 20,480) and top-2 (cap 80, S 40,960), K10b on the top-1 slot rows
    (F 4608) and one K10p partial on a chunk of 1152 of F 4608 (the tier's
    k = 4); then K11/K12 at T 32,768 with E 16 (top-2), D 2048 and D 4096 (E
    8, top-1 and top-2) and E 64 at D 384 (top-1 and top-2). Each against its
    plain version by its rule above (routing identical but for near ties,
    rows by the bf16 rule, psum to PSUM_RTOL), every backward's second call
    bit-identical. ``{name: [{"path", "shape", ...}]}`` for the kernels line."""
    D, F, E = DIT_XL["embed_dim"], 4 * DIT_XL["embed_dim"], MOE["moe_experts"]
    T, S = TRAIN_BATCH * TRAIN_M * 64, 20480  # S: the top-1 slot rows an expert
    keys = ("max_abs_err", "ms", "plain_ms")
    shapes = {}

    def add(path, timed, T, D, E):
        for (name, topk), times in timed.items():
            shape = (f"(E={E}, S={S}, D={D}, F={F})" if name == "K10b" else
                     f"(T={T}, D={D}, E={E}, gs=256, top-{topk})")
            shapes.setdefault(name, []).append({"path": path, "shape": shape,
                                                **dict(zip(keys, times)), **times[3]})
        torch.cuda.empty_cache()

    add("moe-xl", _moe_kernel_times(MD, X, ML, smi, D, F, (1, 2), k10f=False), T, D, E)
    gen = torch.Generator(device="cuda").manual_seed(15)
    err, ms, plain_ms, bound = _k10p_partial(X, smi, gen, _slot_rows_ffn(gen, E, S, D, F), k=4)
    shapes["K10p"] = [{"path": "moe-xl", "shape": f"(E={E}, S={S}, D={D}, chunk {F // 4} of "
                       f"F={F})", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound}]
    torch.cuda.empty_cache()
    for e, d, topks in MOE_WIDE_SHAPES:
        add("moe-wide", _moe_kernel_times(MD, X, ML, smi, d, None, topks, k10f=False, E=e,
                                          T=MOE_WIDE_T, k10b=False), MOE_WIDE_T, d, e)
    return shapes


def phase_train_step_moe_xl(cfg, smi):
    """6n: one step of the DiT-XL/4 MoE (D 1152, depth 28, 8 experts) at
    batch 16 x m 8, top-1 and top-2 on one seeded draw of the weights,
    against the plain step with the kernel step's routing replayed, as 6c
    does; launches counted."""
    xl = {**cfg, **MOE, **DIT_XL}
    weights = _seeded_weights(xl)
    for topk in (1, 2):
        phase_train_step(
            {**xl, "moe_topk": topk}, smi, XL_STEP_BATCH, TRAIN_M, f"train-step-moe-xl-top{topk}",
            "DiT-XL/4", MOE_XL_STEP, weights)


def phase_train_moe_xl(kc, name, smi):
    """7m: the trainer at DiT-XL/4 MoE width, top-1 and top-2, for a few
    steps each, its peak memory, then 64 samples from its checkpoint."""
    out = []
    for topk in (1, 2):
        batch = MOE_XL_BATCH[topk]
        out.append(phase_train_wide(
            kc, name, smi, f"train-moe-xl-top{topk}",
            _wide_flags(DIT_XL, moe=True, topk=topk), MOE_XL_STEP, MOE_XL_SAMPLE, batch,
            images=MOE_XL_STEPS * batch))
    return out


PHASES = ("kernels", "backward", "energy", "flash", "moe-kernels", "slice", "train-step",
          "train-step-128", "train-step-moe", "train", "train-128", "train-moe", "wide-kernels",
          "wide-shapes", "train-step-l", "train-step-moe-b", "train-l", "train-moe-b",
          "attention-256", "dit-b-kernels", "m32-kernels", "train-step-64", "train-step-m32", "train-step-b",
          "train-64", "train-m32", "train-b", "attention-core", "train-step-l64", "train-l64",
          "tp-kernels", "train-step-tp", "train-tp", "xl-kernels", "fast-gelu-kernels",
          "train-step-xl", "train-step-fast-gelu", "train-xl", "train-xl64", "moe-xl-kernels",
          "train-step-moe-xl", "train-moe-xl", "flash-widths", "train-step-heads", "train-heads")
# launches per training step and per 20-step sampler call on the wide paths;
# the DiT-L trainer (7d) runs depth 12 since PR 9 (7k runs its kernels at
# DiT-XL's full depth 28)
L_DEPTH = 12
L_STEP = {"K2f": L_DEPTH, "K4": L_DEPTH, "K1b": L_DEPTH, "K6f": 2 * L_DEPTH, "K3f": 1, "K3b": 1}
L_SAMPLE = {"K2f": L_DEPTH * STEPS, "K6f": 2 * L_DEPTH * STEPS}
MOE_B_STEP = {**{k: DIT_B["depth"] for k in ("K2f", "K4", "K11f", "K11b", "K10b", "K12f",
                                             "K12b")}, "K10p": 2 * DIT_B["depth"], "K3f": 1,
              "K3b": 1}
MOE_B_SAMPLE = {**{k: DIT_B["depth"] * STEPS for k in ("K2f", "K11f", "K12f")},
                "K10p": 2 * DIT_B["depth"] * STEPS}
# ... on the 64-px path, the m = 32 path and dense DiT-B
PX64_STEP = {"K2f": DEPTH, "K2b": DEPTH, "K1f": DEPTH, "K1b": DEPTH, "K3f": 1, "K3b": 1}
M32_STEP = {"K2f": DEPTH, "K2b": DEPTH, "K1f": DEPTH, "K1b": DEPTH, "K9f": 1, "K9b": 1}
S_SAMPLE = {"K2f": DEPTH * STEPS, "K1f": DEPTH * STEPS}
B_STEP = {**{k: DIT_B["depth"] for k in ("K2f", "K4", "K1f", "K1b")}, "K3f": 1, "K3b": 1}
B_SAMPLE = {"K2f": DIT_B["depth"] * STEPS, "K1f": DIT_B["depth"] * STEPS}
# ... and on DiT-L at 64 px (the third rung: K7, no half-block tier), its
# trainer cut to depth 8 since PR 9 (7l runs the third rung at full depth)
L64_DEPTH = 8
L64_STEP = {"K7f": L64_DEPTH, "K7b": L64_DEPTH, "K1b": L64_DEPTH, "K6f": 2 * L64_DEPTH,
            "K3f": 1, "K3b": 1}
L64_SAMPLE = {"K7f": L64_DEPTH * STEPS, "K6f": 2 * L64_DEPTH * STEPS}
# ... and the full tensor-parallel DiT-S instance's step (6j)
TP_STEP = {"K7f": DEPTH, "K7b": DEPTH, "K6f": DEPTH, "K6b": DEPTH, "K3f": 1, "K3b": 1}
# ... and DiT-XL at 32 px (K2f, K4) and at 64 px (the third rung: K7)
XL_STEP = {"K2f": DIT_XL["depth"], "K4": DIT_XL["depth"], "K1b": DIT_XL["depth"],
           "K6f": 2 * DIT_XL["depth"], "K3f": 1, "K3b": 1}
XL_SAMPLE = {"K2f": DIT_XL["depth"] * STEPS, "K6f": 2 * DIT_XL["depth"] * STEPS}
XL64_STEP = {"K7f": DIT_XL["depth"], "K7b": DIT_XL["depth"], "K1b": DIT_XL["depth"],
             "K6f": 2 * DIT_XL["depth"], "K3f": 1, "K3b": 1}
XL64_SAMPLE = {"K7f": DIT_XL["depth"] * STEPS, "K6f": 2 * DIT_XL["depth"] * STEPS}
# ... and the --fast-gelu steps (6l): DiT-S and its MoE at 256 x m 8
FAST_STEP = {"K2f": DEPTH, "K2b": DEPTH, "K1f": DEPTH, "K1b": DEPTH, "K3f": 1, "K3b": 1}
FAST_MOE_STEP = {**{k: DEPTH for k in ("K2f", "K2b", "K11f", "K11b", "K10f", "K10b", "K12f",
                                       "K12b")}, "K3f": 1, "K3b": 1}
# ... and the DiT-XL/4 MoE (3n, 6n, 7m): the expert FFN takes the F-chunked
# tier at k = 4 (K10p forward, K10b backward); the trainer runs a few steps,
# top-1 at the recipe's batch 256 x m 8 and top-2 at 128 x m 8 (at 256 its
# slot rows alone would take ~20 GiB more: PERF.md §5)
MOE_XL_STEP = {**{k: DIT_XL["depth"] for k in ("K2f", "K4", "K11f", "K11b", "K10b", "K12f",
                                               "K12b")}, "K10p": 4 * DIT_XL["depth"],
               "K3f": 1, "K3b": 1}
MOE_XL_SAMPLE = {**{k: DIT_XL["depth"] * STEPS for k in ("K2f", "K11f", "K12f")},
                 "K10p": 4 * DIT_XL["depth"] * STEPS}
MOE_XL_BATCH, MOE_XL_STEPS = {1: 256, 2: 128}, 4
# to keep the whole run near its earlier length with 3n, 6n and 7m added
# (PR 10), the DiT-L 64-px trainer (7i) and the XL trainers (7k, 7l) run 512
# synthetic images (1024 for 7k: 4 steps of 256), not an epoch of 2048
SHORT_IMAGES = 512
# 3n's further K11/K12 shapes at T 32,768: (E, D, top-k)
MOE_WIDE_T = 32768
MOE_WIDE_SHAPES = ((16, 1152, (2,)), (8, 2048, (1, 2)), (8, 4096, (1, 2)), (64, 384, (1, 2)))


def main(argv=None) -> None:
    """Run every phase, or (for debugging) only the phases named in ``argv``;
    the result lines are printed only after a run of every phase."""
    only = list(sys.argv[1:] if argv is None else argv)
    unknown = sorted(set(only) - set(PHASES))
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; the phases are {PHASES}")
    run = set(only or PHASES)
    name, smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False

    from ddm_tpu_torch.models.factory import MODEL_DEFAULTS
    from ddm_tpu_torch.ops import attention as A
    from ddm_tpu_torch.ops import energy as E
    from ddm_tpu_torch.ops import expert_ffn as X
    from ddm_tpu_torch.ops import flash as FL
    from ddm_tpu_torch.ops import kernel_config as kc
    from ddm_tpu_torch.ops import mlp_block as M
    from ddm_tpu_torch.ops import moe_dispatch as MD

    phase_build(kc)
    cfg = {**MODEL_DEFAULTS, "depth": DEPTH, "sample_steps": STEPS, "eps_churn": 1.0}
    moe_cfg = {**cfg, **MOE}
    steps = [
        ("kernels", lambda: phase_kernels(M, A, smi)),
        ("backward", lambda: phase_backward(M, A, smi)),
        ("energy", lambda: phase_energy(E, smi)),
        ("flash", lambda: phase_flash(FL, smi)),
        ("moe-kernels", lambda: phase_moe_kernels(MD, X, M, smi)),
        ("slice", lambda: phase_slice(phase_model(cfg, smi), cfg, kc, name, smi)),
        ("train-step", lambda: phase_train_step(cfg, smi)),
        ("train-step-128", lambda: phase_train_step(
            {**cfg, "image_size": LONG_SIZE}, smi, LONG_BATCH, LONG_M, "train-step-128")),
        ("train-step-moe", lambda: phase_train_step(moe_cfg, smi, label="train-step-moe")),
        ("train", lambda: phase_train(kc, name, smi)),
        ("train-128", lambda: phase_train_wide(kc, name, smi, "train-128", [],
                                               *_k8_launches(DEPTH), LONG_BATCH, LONG_M,
                                               LONG_SIZE, images=LONG_IMAGES)),
        ("train-moe", lambda: phase_train_moe(kc, name, smi)),
        ("wide-kernels", lambda: phase_wide_kernels(M, A, X, smi)),
        ("wide-shapes", lambda: phase_wide_shapes(M, A, MD, X, smi)),
        ("train-step-l", lambda: phase_train_step(
            {**cfg, **DIT_L}, smi, WIDE_STEP_BATCH, TRAIN_M, "train-step-l", "DiT-L/4")),
        ("train-step-moe-b", lambda: phase_train_step(
            {**moe_cfg, **DIT_B}, smi, WIDE_STEP_BATCH, TRAIN_M, "train-step-moe-b", "DiT-B/4")),
        ("train-l", lambda: phase_train_wide(
            kc, name, smi, "train-l", _wide_flags({**DIT_L, "depth": L_DEPTH}), L_STEP,
            L_SAMPLE)),
        ("train-moe-b", lambda: phase_train_wide(
            kc, name, smi, "train-moe-b", _wide_flags(DIT_B, moe=True), MOE_B_STEP,
            MOE_B_SAMPLE)),
        ("attention-256", lambda: phase_attention_256(M, A, smi)),
        ("dit-b-kernels", lambda: phase_dit_b_kernels(M, A, smi)),
        ("m32-kernels", lambda: phase_m32_kernels(M, A, smi)),
        ("train-step-64", lambda: phase_train_step(
            {**cfg, "image_size": PX64_SIZE}, smi, PX64_BATCH, PX64_M, "train-step-64")),
        ("train-step-m32", lambda: phase_train_step(cfg, smi, M32_STEP_BATCH, M32,
                                                    "train-step-m32")),
        ("train-step-b", lambda: phase_train_step(
            {**cfg, **DIT_B}, smi, WIDE_STEP_BATCH, TRAIN_M, "train-step-b", "DiT-B/4")),
        ("train-64", lambda: phase_train_wide(kc, name, smi, "train-64", [], PX64_STEP,
                                              S_SAMPLE, PX64_BATCH, PX64_M, PX64_SIZE)),
        ("train-m32", lambda: phase_train_wide(kc, name, smi, "train-m32", [], M32_STEP,
                                               S_SAMPLE, TRAIN_BATCH, M32)),
        ("train-b", lambda: phase_train_wide(kc, name, smi, "train-b", _wide_flags(DIT_B),
                                             B_STEP, B_SAMPLE)),
        ("attention-core", lambda: phase_attention_core(A, FL, smi)),
        ("train-step-l64", lambda: phase_train_step_rung3(cfg, smi)),
        ("train-l64", lambda: phase_train_wide(
            kc, name, smi, "train-l64", _wide_flags({**DIT_L, "depth": L64_DEPTH}), L64_STEP,
            L64_SAMPLE, PX64_BATCH, PX64_M, PX64_SIZE, images=SHORT_IMAGES)),
        ("tp-kernels", lambda: phase_tp_kernels(M, A, smi)),
        ("train-step-tp", lambda: phase_train_step(
            {**cfg, "tp": TP}, smi, label="train-step-tp", model_name="DiT-S/4 (full TP instance)",
            launches=TP_STEP)),
        ("train-tp", lambda: phase_train_tp(cfg, kc, name, smi)),
        ("xl-kernels", lambda: phase_xl_kernels(M, A, smi)),
        ("fast-gelu-kernels", lambda: phase_fast_gelu_kernels(M, X, smi)),
        ("train-step-xl", lambda: phase_train_step_xl(cfg, smi)),
        ("train-step-fast-gelu", lambda: (
            phase_train_step({**cfg, "fast_gelu": True}, smi, label="train-step-fast-gelu",
                             model_name="DiT-S/4 --fast-gelu", launches=FAST_STEP),
            phase_train_step({**moe_cfg, "fast_gelu": True}, smi, label="train-step-moe-fast-gelu",
                             model_name="DiT-S/4 --fast-gelu", launches=FAST_MOE_STEP))),
        ("train-xl", lambda: phase_train_wide(kc, name, smi, "train-xl", _wide_flags(DIT_XL),
                                              XL_STEP, XL_SAMPLE, images=2 * SHORT_IMAGES)),
        ("train-xl64", lambda: phase_train_wide(kc, name, smi, "train-xl64", _wide_flags(DIT_XL),
                                                XL64_STEP, XL64_SAMPLE, PX64_BATCH, PX64_M,
                                                PX64_SIZE, images=SHORT_IMAGES)),
        ("moe-xl-kernels", lambda: phase_moe_xl_kernels(MD, X, M, smi)),
        ("train-step-moe-xl", lambda: phase_train_step_moe_xl(cfg, smi)),
        ("train-moe-xl", lambda: phase_train_moe_xl(kc, name, smi)),
        ("flash-widths", lambda: phase_flash_widths(FL, smi)),
        ("train-step-heads", lambda: phase_train_step_heads(cfg, smi)),
        ("train-heads", lambda: tuple(
            phase_train_wide(kc, name, smi, label, _wide_flags(widths),
                             *_k8_launches(widths["depth"]), LONG_BATCH, LONG_M, LONG_SIZE,
                             images=LONG_BATCH * HEADS_STEPS)
            for label, widths in (("train-b-h3", B_H3), ("train-s-h24", S_H24)))),
    ]
    out = {}
    t_run = time.perf_counter()
    for phase, fn in steps:
        if phase in run:
            t0 = time.perf_counter()
            out[phase] = fn()
            torch.cuda.empty_cache()
            print(f"[time] {phase} {time.perf_counter() - t0:.1f} s (run so far "
                  f"{time.perf_counter() - t_run:.1f} s)", flush=True)
    if run != set(PHASES):
        print(f"chip_smoke: ran only {sorted(run)}; no result line")
        return
    # launches: each kernel's count in its path's training run, and in that
    # path's sampler for the forward kernels; and its counts on every path
    energy = {e["name"]: e for e in out["energy"]}
    paths = {"dit-s": (out["kernels"] + out["backward"] + [energy["K3f"], energy["K3b"]],
                       out["train"], out["slice"]),
             "128px": (out["flash"], *out["train-128"]),
             "moe": (out["moe-kernels"], *out["train-moe"]),
             "dit-l": ([e for e in out["wide-kernels"] if e["name"] != "K10p"],
                       *out["train-l"]),
             "moe-b": ([e for e in out["wide-kernels"] if e["name"] == "K10p"],
                       *out["train-moe-b"]),
             "64px": ([], *out["train-64"]),
             "m32": ([energy["K9f"], energy["K9b"]], *out["train-m32"]),
             "dit-b": ([], *out["train-b"]),
             "dit-l64": (out["attention-core"][0], *out["train-l64"]),
             "tp": (out["tp-kernels"][0], *out["train-tp"]),
             "dit-xl": ([], *out["train-xl"]),
             "dit-xl64": ([], *out["train-xl64"]),
             "moe-xl-top1": ([], *out["train-moe-xl"][0]),
             "moe-xl-top2": ([], *out["train-moe-xl"][1]),
             "128px-b-h3": ([], *out["train-heads"][0]),
             "128px-s-h24": ([], *out["train-heads"][1])}
    kernels = []
    for entries, trained, sampled in paths.values():
        for k in entries:
            k["launches"] = trained[k["name"]]
            if k["name"].endswith("f") or k["name"] == "K10p":
                k["sample_launches"] = sampled[k["name"]]
            k["launches_by_path"] = {p: {"train": tr[k["name"]], "sample": sa[k["name"]]}
                                     for p, (_, tr, sa) in paths.items()}
        kernels += entries
    for k in kernels:  # the kernels at the other paths' shapes
        for shapes in (out["wide-shapes"], out["attention-256"], out["dit-b-kernels"],
                       out["m32-kernels"], out["attention-core"][1], out["tp-kernels"][1],
                       out["xl-kernels"], out["fast-gelu-kernels"], out["moe-xl-kernels"],
                       out["flash-widths"]):
            k.setdefault("shapes", []).extend(shapes.get(k["name"], []))
    k8 = sorted({s["Dh"] for k in kernels if k["name"] == "K8f" for s in k["shapes"]})
    print(f"[k8-widths] K8f and K8b held against their plain versions on the card at Dh {k8}; "
          f"the port's K8 takes Dh {list(FL.HEAD_DIMS)}, every width the JAX gate admits")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
