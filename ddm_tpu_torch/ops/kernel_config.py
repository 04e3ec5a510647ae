"""Where a fused op runs, and how its CUDA kernels are built and reached.

The rule is the tensor's device, nothing else: a CPU tensor takes the op's
plain PyTorch version, a CUDA tensor launches the hand-written kernel or
raises. There is no interpret mode and no fallback on a build or launch
failure.

The kernels are CUDA C++ for ``sm_90a`` in ``ddm_tpu_torch/csrc``. At first
use each source is compiled by its own ``nvcc``, all started together, and
the objects are linked into one shared library with a plain C interface,
keyed by a hash of the sources and flags, under ``ddm_tpu_torch/_build/``,
and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = [
    "LaunchCounter",
    "launch_counts",
    "reset_launch_counts",
    "uses_kernel",
    "cli_device",
    "load_library",
    "library_path",
    "build_library",
    "check_status",
    "current_stream",
]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of csrc/*.cu: name -> argtypes. Each returns cudaError_t.
_SIGNATURES = {
    # x, ln_scale, ln_bias, w, bias, out, out2, y_out, T, K, Nout, epi, fast, stream
    "ddm_ln_gemm": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the same through the streamed kernel at any K % 64 == 0
    "ddm_ln_gemm_streamed": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # a, w, bias, residual, out, T, K, Nout, stream
    "ddm_gemm_residual": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # q, k, v, ld, out, B, N, H, Dh, scale, design, stream
    "ddm_attention_core": [_P, _P, _P, _I, _P] + [_I] * 4 + [_F, _I, _P],
    # q, k, v, ld, dout, att, dqkv, stats, B, N, H, Dh, scale, design, stream
    "ddm_attention_core_bwd": [_P, _P, _P, _I, _P, _P, _P, _P] + [_I] * 4 + [_F, _I, _P],
    # N, Dh, backward, design, plan (int[7])
    "ddm_attention_core_plan": [_I, _I, _I, _I, _P],
    # attrs (int[14]: registers and local bytes of the seven core kernels)
    "ddm_attention_kernel_attrs": [_P],
    # a, w, ldw, acc, bias, res, out, T, K, Nout, epi, stream
    "ddm_gemm_partial": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # a, w, bias, aux, out, colsum_ws, colsum_out, T, K, Nout, ldw, wstride, epi, batch,
    # fast, stream
    "ddm_gemm_nn": [_P] * 7 + [_I] * 8 + [_P],
    # a, b, ws, dw, colsum_ws, colsum_out, T, Ma, Nb, splits, rows, colsum_of_b, batch, stream
    "ddm_gemm_tn": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, dy, dres, scale, dx, partial, dscale_dbias, T, D, stream
    "ddm_ln_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # src, dst, n, stream
    "ddm_cast_bf16": [_P, _P, _I, _P],
    # xh, x0, part, partial, out, B, m, D, L, beta, stream
    "ddm_energy_fwd": [_P] * 5 + [_I] * 4 + [_F, _P],
    # xh, x0, g, part, coef, dxh, dx0, B, m, D, L, beta, stream
    "ddm_energy_bwd": [_P] * 7 + [_I] * 4 + [_F, _P],
    # q, k, v, ld, o, lse, B, N, H, Dh, scale, stream
    "ddm_flash_fwd": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, Dh, scale, stream
    "ddm_flash_bwd": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # x, scale, bias, wrt, br, xin, gates, pos1, pos2, probs, part, cnt_psum,
    # G, gs, n_valid, D, E, cap, cpad, topk, stream
    "ddm_moe_dispatch_fwd": [_P] * 12 + [_I] * 8 + [_P],
    # x, scale, bias, wrt, pos1, pos2, probs, dxin, dgates, dpsum, dres, dx, dl, part, tmp,
    # sums, G, gs, n_valid, D, E, cap, cpad, topk, slab, stream
    "ddm_moe_dispatch_bwd": [_P] * 16 + [_I] * 9 + [_P],
    # eout, gates, pos1, pos2, res, tok, G, gs, D, E, cap, cpad, topk, stream
    "ddm_moe_combine_fwd": [_P] * 6 + [_I] * 7 + [_P],
    # eout, gates, pos1, pos2, dpart, deout, dgates, G, gs, D, E, cap, cpad, topk, stream
    "ddm_moe_combine_bwd": [_P] * 7 + [_I] * 7 + [_P],
    # x, ln_scale, ln_bias, w, b, out, T, D, K, stream
    "ddm_ln_dense_fwd": [_P] * 6 + [_I] * 3 + [_P],
    # x, ln_scale, ln_bias, w, dout, dx, stats, part_ln, part_db, ws, dscale_dbias, dw, db,
    # T, D, K, splits, rows, stream
    "ddm_ln_dense_bwd": [_P] * 13 + [_I] * 5 + [_P],
    # x, s1, b1, wqkv, bqkv, wproj, bproj, s2, b2, w1, bb1, w2, bb2, out, B, N, D, H, F,
    # scale, stream
    "ddm_whole_block_fwd": [_P] * 14 + [_I] * 5 + [_F, _P],
}

_COUNTERS: dict = {}


class LaunchCounter:
    """Count of kernel launches made by one wrapper (reset by callers that
    need to prove a run went through the kernel). Each counter registers
    under its kernel's name for :func:`launch_counts`."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        _COUNTERS[name] = self

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def launch_counts() -> dict:
    """``{kernel name: launches}`` of every registered wrapper."""
    return {name: c.count for name, c in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.reset()


def uses_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (take the plain version). Mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors must all lie on the CPU or all on CUDA, got {sorted(kinds)}")


def cli_device(name: str) -> torch.device:
    """The device an entry point's ``--device`` flag (or a YAML's ``device``
    key) names, ``tpu`` meaning the card; exits with a message when it names
    CUDA and no card is available (no fallback)."""
    # the JAX package's configs name its accelerator "tpu"; the port's is the card
    device = torch.device("cuda" if name == "tpu" else name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run the plain versions on the CPU)")
    return device


def _sources():
    return sorted(list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD / f"libddm_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link the
    shared library, unless it is already built. The ``-Xptxas -v`` report
    lands beside the library."""
    path = library_path()
    if path.exists():
        return path
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objs, procs = [], []
        try:
            for src in (s for s in _sources() if s.suffix == ".cu"):
                obj = os.path.join(tmp, src.stem + ".o")
                objs.append(obj)
                procs.append((src.name, subprocess.Popen(
                    [nvcc, *_NVCC_FLAGS, "-c", "-o", obj, str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            logs, failed = [], []
            for name, proc in procs:
                out, err = proc.communicate()
                logs.append(f"== {name}\n{out}{err}")
                if proc.returncode != 0:
                    failed.append(f"{name} ({proc.returncode}):\n{out}\n{err}")
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        lib = os.path.join(tmp, path.name)
        link = subprocess.run([nvcc, "-shared", "-o", lib, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        (_BUILD / (path.stem + ".ptxas.txt")).write_text("".join(logs))
        os.replace(lib, path)
    return path


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ddm_error_string.argtypes = [ctypes.c_int]
    lib.ddm_error_string.restype = ctypes.c_char_p
    return lib


def check_status(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launches."""
    if status != 0:
        msg = load_library().ddm_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} at launch ({msg})")


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
