"""Tensor and data parallelism across processes on the CPU (gloo): the
sharded step against the one-process oracle, the sharded clip against
optax's, and the ``--tp`` trainer through ``torch.distributed.run``.

Each rank is an OS process. The step checks rendezvous through a
``file://`` store under the test's temporary directory (pytest-xdist runs
several test processes at once, so no fixed TCP port);
``torch.distributed.run --standalone`` picks a free local port itself.
Every launch has a deadline that kills its ranks.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import generate_torch  # noqa: E402
import train_cifar10_dit_torch as cli  # noqa: E402
from ddm_tpu_torch.parallel import check  # noqa: E402
from ddm_tpu_torch.utils.checkpoint import load_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# fp32 on the CPU: a sharded sum and the whole one differ only in the order
# of their fp32 additions
RTOL = 1e-5
CFG = {"image_size": 8, "patch_size": 2, "embed_dim": 256, "depth": 2, "heads": 4,
       "time_embed": 16, "dtype": "float32", "tp": 2}


def _close(got: dict, want: dict, what: str):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        rel = float(torch.linalg.norm(g - w) / torch.linalg.norm(w))
        assert rel <= RTOL, f"{what} {k}: relative Frobenius {rel:.3g}"
        assert float((g - w).abs().max()) <= RTOL * float(w.abs().max()), f"{what} {k}"


@pytest.fixture(scope="module")
def oracle():
    """The one-process steps (full instance) for dp 1 and dp 2."""
    weights = check.full_weights(CFG, 0)
    inputs = check.step_inputs(CFG, 4, 2, 2)
    return {dp: (check.oracle_step(CFG, weights, inputs, dp, "cpu"),
                 check.oracle_step(CFG, weights, inputs, dp, "cpu", clip=check.CLIP))
            for dp in (1, 2)}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """``sharded(world)``: rank 0's results of one step on ``world`` ranks
    (tp 2), launched once per world size."""
    runs = {}

    def run(world):
        if world not in runs:
            tmp = tmp_path_factory.mktemp(f"world{world}")
            spec = {"model": CFG, "batch": 4, "m": 2, "seed": 0}
            runs[world], = check.launch(world, 2, [spec], str(tmp / "out.pt"),
                                        str(tmp / "rdzv"), timeout=240)
        return runs[world]

    return run


@pytest.mark.parametrize("world", [2, 4], ids=["tp2", "dp2-tp2"])
def test_sharded_step_matches_the_one_process_oracle(sharded, oracle, world):
    """A tp 2 rank pair, and a dp 2 x tp 2 group of four: the loss, the
    data-averaged gradients gathered over the model group, the clipped
    gradients (the clip engages) and the parameters after AdamW equal the
    one-process step on the full instance to 1e-5 relative."""
    got = sharded(world)
    want, want_clipped = oracle[world // 2]
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= RTOL * abs(w), k
    _close(got["grads"], want["grads"], "gradient")
    _close(got["clipped"], want_clipped["grads"], "clipped gradient")
    params = got["params"]
    for k, w in want_clipped["params"].items():
        assert float((params[k] - w).abs().max()) <= RTOL * float(w.abs().max()), k
    assert got["launches"] == [{}] * world  # CPU tensors: the plain versions


@pytest.mark.parametrize("world", [2, 4], ids=["tp2", "dp2-tp2"])
def test_sharded_clip_equals_optax_on_the_full_gradients(sharded, oracle, world):
    """The ranks' clip over the model group (sharded leaves' squared sums as
    they are, replicated ones divided by tp) gives what optax's
    ``clip_by_global_norm`` gives on the full data-averaged gradients."""
    got = sharded(world)
    full = {k: jnp.asarray(g.numpy()) for k, g in oracle[world // 2][0]["grads"].items()}
    clip = optax.clip_by_global_norm(check.CLIP)
    want, _ = clip.update(full, clip.init(full))
    assert float(optax.global_norm(full)) > check.CLIP  # it engages
    _close(got["clipped"], {k: torch.from_numpy(np.array(v)) for k, v in want.items()},
           "clipped gradient")


def test_tp_cli_trains_through_torchrun_and_its_checkpoint_samples(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2
    train_cifar10_dit_torch.py --tp 2`` on the CPU: two gloo ranks train two
    steps, rank 0 writes the full checkpoint with ``tp`` in its config, each
    rank its result, and ``generate_torch --device cpu`` samples from the
    checkpoint through the full instance."""
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "--", "train_cifar10_dit_torch.py", "--synthetic", "--device", "cpu", "--tp", "2",
           "--epochs", "1", "--batch", "1024", "--m", "2", "--image-size", "16",
           "--embed-dim", "64", "--depth", "1", "--heads", "2", "--time-embed", "16",
           "--sample-batch", "2", "--sample-steps", "1", "--log-every", "1", "--out", str(out)]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    assert "torch.distributed backend gloo, 2 ranks = dp 1 x tp 2" in log
    history = json.loads((out / "train_metrics.json").read_text())
    assert history["step"] == [1, 2] and np.isfinite(history["loss"]).all()
    results = [json.loads((out / f"result_rank{r}.json").read_text()) for r in range(2)]
    assert results[0]["metrics"] == results[1]["metrics"]  # replicated over the model group
    state, config = load_params(str(out / "model_final.pt"))
    assert config["tp"] == 2
    assert state["blocks.0.attn.qkv.weight"].shape == (3 * 64, 64)  # the full weights
    assert state["blocks.0.ff.net.2.weight"].shape == (64, 256)
    npz = tmp_path / "s.npz"
    generate_torch.main(["--ckpt", str(out), "--device", "cpu", "--n", "2", "--steps", "2",
                         "--out", "", "--npz", str(npz)])
    samples = np.load(npz)["samples"]
    assert samples.shape == (2, 16, 16, 3) and np.isfinite(samples).all()


@pytest.mark.parametrize("flags,error", [
    (["--tp", "2"], ValueError), (["--sp"], NotImplementedError),
    (["--tp", "2", "--moe-experts", "4"], NotImplementedError)],
    ids=["tp-on-one-rank", "sp", "tp-with-moe"])
def test_tp_cli_refuses_what_it_cannot_run(tmp_path, monkeypatch, flags, error):
    """``--tp 2`` on one rank raises (JAX's ``make_mesh(tp=2)`` on one
    device does), and so do ``--sp`` and ``--tp`` with ``--moe-experts``
    (ROADMAP.md Queue 1 item 11)."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(error, match="not divisible by tp=2|item 11"):
        cli.main(["--synthetic", "--device", "cpu", "--epochs", "1", "--out", str(tmp_path),
                  *flags])
    assert not (tmp_path / "model_final.pt").exists()
