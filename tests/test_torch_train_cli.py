"""``train_cifar10_dit_torch.py`` end to end on the CPU: artifacts, the
checkpoint that ``generate_torch.py`` samples from, the flags left for later,
and the CLI defaults against the JAX trainer's."""

import functools
import json
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import generate_torch  # noqa: E402
import train_cifar10_dit as jax_cli  # noqa: E402
import train_cifar10_dit_torch as cli  # noqa: E402
from ddm_tpu_torch.data.cifar10 import CIFAR10DataConfig  # noqa: E402
from ddm_tpu_torch.models.factory import MODEL_DEFAULTS, SAMPLER_DEFAULTS  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402
from ddm_tpu_torch.ops.kernel_config import launch_counts  # noqa: E402

TINY = ["--synthetic", "--epochs", "1", "--batch", "64", "--m", "2", "--embed-dim", "64",
        "--depth", "2", "--heads", "2", "--time-embed", "16", "--sample-batch", "4",
        "--sample-steps", "2", "--log-every", "8", "--device", "cpu"]


def test_train_cli_end_to_end_on_cpu(tmp_path):
    result = cli.main([*TINY, "--out", str(tmp_path)])
    for artifact in ("model_epoch001.pt", "model_final.pt", "config.json", "samples.png",
                     "train_metrics.json", "epoch_metrics.json"):
        assert (tmp_path / artifact).stat().st_size > 0, artifact
    history = json.loads((tmp_path / "train_metrics.json").read_text())
    assert history["step"] == list(range(1, 33))  # 2048 synthetic images / 64
    assert set(history) == {"step", "loss", "confidence", "interaction", "weight"}
    assert np.isfinite(history["loss"]).all()
    epochs = json.loads((tmp_path / "epoch_metrics.json").read_text())
    assert epochs["epoch"] == [1] and epochs["images_per_sec"][0] > 0
    assert json.loads((tmp_path / "config.json").read_text())["embed_dim"] == 64
    assert result["metrics"]["loss"] == history["loss"][-1]
    assert len(result["step_seconds"]) == 32 and result["seconds_per_step"] > 0
    # CPU tensors: the plain versions, no kernel launched in either phase
    assert not any(result["launches"]["train"].values())
    assert not any(result["launches"]["sample"].values())
    assert set(result["launches"]["train"]) == set(launch_counts())

    npz = tmp_path / "s.npz"
    out = generate_torch.main(["--ckpt", str(tmp_path / "model_final.pt"), "--n", "3",
                               "--steps", "2", "--device", "cpu", "--out", "",
                               "--npz", str(npz)])
    samples = np.load(npz)["samples"]
    assert samples.shape == (3, 32, 32, 3) and np.isfinite(samples).all()
    assert samples.min() >= -1 and samples.max() <= 1
    np.testing.assert_array_equal(samples, out["samples"])


def test_train_cli_at_image_size_128_on_cpu(tmp_path, monkeypatch):
    """--image-size 128 (N = 1024 tokens): the loader resizes, the blocks take
    the long-sequence half-block's plain versions, and generate_torch samples
    128 px images from the checkpoint. Eight synthetic images keep it small."""
    monkeypatch.setattr(cli, "CIFAR10DataConfig",
                        functools.partial(CIFAR10DataConfig, synthetic_size=8))
    result = cli.main(["--synthetic", "--image-size", "128", "--epochs", "1", "--batch", "4",
                       "--m", "2", "--embed-dim", "128", "--depth", "2", "--heads", "2",
                       "--time-embed", "16", "--sample-batch", "2", "--sample-steps", "2",
                       "--log-every", "1", "--device", "cpu", "--out", str(tmp_path)])
    history = json.loads((tmp_path / "train_metrics.json").read_text())
    assert history["step"] == [1, 2] and np.isfinite(history["loss"]).all()
    assert json.loads((tmp_path / "config.json").read_text())["image_size"] == 128
    assert not any(result["launches"]["train"].values())
    npz = tmp_path / "s.npz"
    generate_torch.main(["--ckpt", str(tmp_path), "--n", "2", "--steps", "2", "--device", "cpu",
                         "--out", "", "--npz", str(npz)])
    samples = np.load(npz)["samples"]
    assert samples.shape == (2, 128, 128, 3) and np.isfinite(samples).all()


def test_train_cli_at_image_size_64_on_cpu(tmp_path, monkeypatch):
    """--image-size 64 --m 4 (N = 256 tokens, the 64-px recipe's shape at a
    tiny width): the loader resizes, the blocks take K2's plain versions,
    the energy score K3's route at D = 12,288, and generate_torch samples
    64 px images from the checkpoint. Eight synthetic images keep it small."""
    monkeypatch.setattr(cli, "CIFAR10DataConfig",
                        functools.partial(CIFAR10DataConfig, synthetic_size=8))
    result = cli.main(["--synthetic", "--image-size", "64", "--epochs", "1", "--batch", "4",
                       "--m", "4", "--embed-dim", "128", "--depth", "2", "--heads", "2",
                       "--time-embed", "16", "--sample-batch", "2", "--sample-steps", "2",
                       "--log-every", "1", "--device", "cpu", "--out", str(tmp_path)])
    history = json.loads((tmp_path / "train_metrics.json").read_text())
    assert history["step"] == [1, 2] and np.isfinite(history["loss"]).all()
    assert json.loads((tmp_path / "config.json").read_text())["image_size"] == 64
    assert not any(result["launches"]["train"].values())
    npz = tmp_path / "s.npz"
    generate_torch.main(["--ckpt", str(tmp_path), "--n", "2", "--steps", "2", "--device", "cpu",
                         "--out", "", "--npz", str(npz)])
    samples = np.load(npz)["samples"]
    assert samples.shape == (2, 64, 64, 3) and np.isfinite(samples).all()


def test_train_cli_with_m_32_on_cpu(tmp_path, monkeypatch):
    """--m 32 (the m-sweep point: K9's route at D = 3072) trains on the
    anchor-streaming plain versions, and generate_torch samples from it."""
    monkeypatch.setattr(cli, "CIFAR10DataConfig",
                        functools.partial(CIFAR10DataConfig, synthetic_size=8))
    result = cli.main([*TINY[:TINY.index("--batch")], "--batch", "4", "--m", "32",
                       *TINY[TINY.index("--embed-dim"):], "--log-every", "1",
                       "--out", str(tmp_path)])
    history = json.loads((tmp_path / "train_metrics.json").read_text())
    assert history["step"] == [1, 2] and np.isfinite(history["loss"]).all()
    assert json.loads((tmp_path / "config.json").read_text())["m"] == 32
    assert not any(result["launches"]["train"].values())
    npz = tmp_path / "s.npz"
    generate_torch.main(["--ckpt", str(tmp_path), "--n", "2", "--steps", "2", "--device", "cpu",
                         "--out", "", "--npz", str(npz)])
    assert np.isfinite(np.load(npz)["samples"]).all()


@pytest.mark.parametrize("size", [96, 112])
def test_train_cli_refuses_image_sizes_no_kernel_takes(tmp_path, size):
    """N = 576 and 784 lie between K2's N <= 512 and K8's N >= 1024, where
    no attention kernel of either package runs: the JAX ladder's third rung
    takes XLA's attention there, and the port's its plain core. The trainer
    no longer refuses these sizes: it builds the model and goes on to make
    the data."""
    with mock.patch.object(cli, "build_cifar10_dataloaders",
                           side_effect=LookupError("data")) as loaders:
        with pytest.raises(LookupError, match="data"):
            cli.main(["--synthetic", "--image-size", str(size), "--device", "cpu",
                      "--out", str(tmp_path)])
    loaders.assert_called_once()
    N = (size // 4) ** 2
    assert tiers.attention_tier(16, N, 384, 6) is None and tiers.core_tier(16, N, 384, 6) is None


@pytest.mark.parametrize("flags,item", [
    (["--multihost"], "item 11"), (["--sp"], "item 11"), (["--pp", "2"], "item 11"),
    (["--fsdp"], "item 11"), (["--moe-experts", "4", "--tp", "2"], "item 11"),
    (["--remat"], "item 8"),
    (["--mlp-persist", "2"], "item 8"), (["--lr-min", "0.1"], "item 2"),
    (["--grad-accum", "2"], "item 2"),
    (["--ema-decay", "0.999"], "item 2"), (["--lr-schedule", "cosine"], "item 2"),
    (["--warmup-steps", "10"], "item 2"), (["--eval-every", "1"], "item 3"),
    (["--dry-eval"], "item 3"), (["--wandb"], "item 7"), (["--resume"], "item 2"),
    (["--profile-dir", "prof"], "item 7"), ([], "item 7"),
])
def test_train_cli_refuses_flags_left_for_later(tmp_path, flags, item):
    argv = ["--device", "cpu", "--out", str(tmp_path), *flags]
    if flags:
        argv.append("--synthetic")
    with mock.patch.object(cli, "train") as train:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
            cli.main(argv)
    train.assert_not_called()


def test_train_cli_moe_run_on_cpu(tmp_path, monkeypatch):
    """--moe-experts 4: every MLP half routed to 4 expert FFNs (plain
    versions on the CPU); the Switch aux joins the loss and is logged as
    moe_aux, and generate_torch rebuilds the MoE model from the checkpoint,
    here with a row count (6 images x 16 tokens) that pads to its group."""
    monkeypatch.setattr(cli, "CIFAR10DataConfig",
                        functools.partial(CIFAR10DataConfig, synthetic_size=128))
    result = cli.main([*TINY, "--image-size", "16", "--moe-experts", "4",
                       "--moe-group-size", "64", "--out", str(tmp_path)])
    history = json.loads((tmp_path / "train_metrics.json").read_text())
    assert history["step"] == [1, 2]
    assert set(history) == {"step", "loss", "confidence", "interaction", "weight", "moe_aux"}
    assert np.isfinite(history["moe_aux"]).all() and min(history["moe_aux"]) > 0
    assert result["metrics"]["moe_aux"] == history["moe_aux"][-1]
    assert not any(result["launches"]["train"].values())
    state = torch.load(tmp_path / "model_final.pt", weights_only=False)
    assert state["config"]["moe_experts"] == 4
    assert state["model"]["blocks.1.moe.experts_in"].shape == (4, 64, 256)
    npz = tmp_path / "s.npz"
    generate_torch.main(["--ckpt", str(tmp_path), "--n", "6", "--steps", "2", "--device", "cpu",
                         "--out", "", "--npz", str(npz)])
    samples = np.load(npz)["samples"]
    assert samples.shape == (6, 16, 16, 3) and np.isfinite(samples).all()


def test_train_cli_moe_top2_16_experts_on_cpu(tmp_path, monkeypatch):
    """--moe-experts 16 --moe-topk 2 (more experts than the dispatch kernel
    had lanes before, two choices a token) at a tiny width, then
    generate_torch on its checkpoint."""
    monkeypatch.setattr(cli, "CIFAR10DataConfig",
                        functools.partial(CIFAR10DataConfig, synthetic_size=128))
    cli.main([*TINY, "--image-size", "16", "--moe-experts", "16", "--moe-topk", "2",
              "--moe-group-size", "64", "--out", str(tmp_path)])
    history = json.loads((tmp_path / "train_metrics.json").read_text())
    assert history["step"] == [1, 2]
    assert np.isfinite(history["loss"]).all() and np.isfinite(history["moe_aux"]).all()
    state = torch.load(tmp_path / "model_final.pt", weights_only=False)
    assert (state["config"]["moe_experts"], state["config"]["moe_topk"]) == (16, 2)
    assert state["model"]["blocks.0.moe.router.weight"].shape == (16, 64)
    assert state["model"]["blocks.1.moe.experts_in"].shape == (16, 64, 256)
    npz = tmp_path / "s.npz"
    generate_torch.main(["--ckpt", str(tmp_path), "--n", "4", "--steps", "2", "--device", "cpu",
                         "--out", "", "--npz", str(npz)])
    samples = np.load(npz)["samples"]
    assert samples.shape == (4, 16, 16, 3) and np.isfinite(samples).all()


@pytest.mark.parametrize("flags", [["--moe-topk", "3"], ["--mlp-persist", "2"]])
def test_train_cli_refuses_what_the_jax_parser_refuses_with_moe(tmp_path, flags):
    with mock.patch.object(cli, "train") as train:
        with pytest.raises(SystemExit):
            cli.main(["--synthetic", "--device", "cpu", "--out", str(tmp_path),
                      "--moe-experts", "4", *flags])
    train.assert_not_called()


def test_train_cli_defaults_match_the_jax_trainer():
    ours = vars(cli.build_parser().parse_args([]))
    theirs = vars(jax_cli.build_parser().parse_args([]))
    assert set(theirs) <= set(ours)  # every JAX flag exists in the port
    for key, value in theirs.items():
        if key != "device":  # tpu there, cuda here
            assert ours[key] == value, key
    assert ours["device"] == "cuda"
    for key, value in {**MODEL_DEFAULTS, **SAMPLER_DEFAULTS}.items():
        assert ours[key] == value, key


def test_train_cli_validates_and_merges_config(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["--synthetic", "--m", "1", "--device", "cpu"])
    cfg = tmp_path / "run.yaml"
    cfg.write_text("epochs: 3\nbatch: 32\nlr: 0.001\n")
    with mock.patch.object(cli, "train") as train:
        cli.main(["--config", str(cfg), "--synthetic", "--batch", "16", "--device", "cpu"])
    args = train.call_args[0][0]
    assert (args.epochs, args.batch, args.lr) == (3, 16, 0.001)


def test_train_cli_on_cuda_without_a_gpu_exits(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--synthetic", "--device", "cuda", "--out", str(tmp_path)])
