"""Build and load the port's CUDA kernels.

Each source under `pulpo_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into its own shared library with a plain C interface, and
loaded with `ctypes`. Nothing is built when a module is imported: a
kernel's library is built at its first launch (or by `build_all`, which
starts one `nvcc` per source, all at once). Libraries are named by a
hash of their source and flags, in `pulpo_tpu_torch/_build/` (listed
in .gitignore), so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH = "-gencode=arch=compute_90a,code=sm_90a"
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v", ARCH]

# The gathers (warp, squaring and their backward) are compiled without
# FMA contraction so that their coordinate arithmetic rounds exactly as
# the plain PyTorch version's separate multiply and add do: a source
# coordinate one ulp off can land on the other side of a voxel
# boundary. The box sum only adds; it takes the same flag.
SOURCES = {
    "warp": ("warp.cu", ["-fmad=false"]),
    "squaring": ("squaring.cu", ["-fmad=false"]),
    "vel_head": ("vel_head.cu", []),
    "warp_bwd": ("warp_bwd.cu", ["-fmad=false"]),
    "squaring_bwd": ("squaring_bwd.cu", ["-fmad=false"]),
    "box_sum": ("box_sum.cu", ["-fmad=false"]),
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> tuple[Path, list[str]]:
    src, extra = SOURCES[name]
    path = CSRC / src
    flags = BASE_FLAGS + extra
    h = hashlib.sha256(path.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{h}.so", [str(path)] + flags


def _start(name: str):
    lib, args = _target(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *args, "-o", str(tmp)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, lib = started
    out, _ = proc.communicate()
    BUILD_LOGS[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{out}")
    os.replace(tmp, lib)


def build_all(names=None) -> dict[str, str]:
    """Build every kernel library that is not built yet, one `nvcc` per
    source, all started together. Returns the compiler output by name."""
    names = list(SOURCES) if names is None else list(names)
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])
    return {n: BUILD_LOGS.get(n, "(already built)") for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)[0]))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
