"""Build and load the port's CUDA source csrc/<name>.cu at first use.

The source is compiled by nvcc for sm_90a into a shared library with a plain
C interface, loaded with ctypes.  The library goes to meshdqn_tpu_torch/_build/
under a name that carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are compiled at first use on a machine with the CUDA "
            "toolkit"
        )
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, compiling it first if its library
    is missing.  Raises with nvcc's output when the compile fails."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Compile to a private name, then rename: concurrent first uses
            # never load a half-written library.
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            p = subprocess.run(cmd, capture_output=True, text=True)
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for csrc/{name}.cu:\n{p.stdout}{p.stderr}"
                )
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
