"""Build and load the port's CUDA source csrc/<name>.cu at first use.

The source is compiled by nvcc for sm_90a into a shared library with a plain
C interface, loaded with ctypes.  The library goes to meshdqn_tpu_torch/_build/
under a name that carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  The first load
builds every source whose library is missing, all at once: a step that
launches kernels of several sources (the fused step: matvec and convection)
waits for one round of nvcc, not one per source.
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


def compile_all(names) -> None:
    """Compile every csrc/<name>.cu whose library is missing, one nvcc per
    source, all started together.  Raises with nvcc's output when a compile
    fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        # Compile to a private name, then rename: concurrent first uses
        # never load a half-written library.
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))


def sources() -> list[str]:
    """The names of the port's CUDA sources, csrc/<name>.cu."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, compiling first every source
    whose library is missing (see the module's note)."""
    lib = _loaded.get(name)
    if lib is None:
        compile_all(sources())
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
