"""Where a fused op runs, and how its CUDA kernels are built and reached.

The rule is the tensor's device, nothing else: a CPU tensor takes the op's
plain PyTorch version, a CUDA tensor launches the hand-written kernel or
raises. There is no interpret mode and no fallback on a build or launch
failure.

The kernels are CUDA C++ for ``sm_90a`` in ``ddm_tpu_torch/csrc``. At first
use they are compiled with ``nvcc`` into one shared library with a plain C
interface, keyed by a hash of the sources and flags, under
``ddm_tpu_torch/_build/``, and loaded with ``ctypes``.
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
    "uses_kernel",
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of csrc/*.cu: name -> argtypes. Each returns cudaError_t.
_SIGNATURES = {
    # x, ln_scale, ln_bias, w, bias, out, T, K, Nout, gelu, stream
    "ddm_ln_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # a, w, bias, residual, out, T, K, Nout, stream
    "ddm_gemm_residual": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # qkv, out, B, N, H, Dh, scale, stream
    "ddm_attention_core": [_P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
}


class LaunchCounter:
    """Count of kernel launches made by one wrapper (reset by callers that
    need to prove a run went through the kernel)."""

    def __init__(self):
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def uses_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (take the plain version). Mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors must all lie on the CPU or all on CUDA, got {sorted(kinds)}")


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
    """Compile csrc/*.cu into the shared library unless it is already built."""
    path = library_path()
    if path.exists():
        return path
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        (_BUILD / (path.stem + ".ptxas.txt")).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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
