"""
Builds the port's native code into ``xugrid_tpu_torch/_build`` (listed
in ``.gitignore``) on first use:

* the Hopper kernels, ``xugrid_tpu_torch/csrc/*.cu``, with nvcc for
  ``sm_90a`` into one shared library with a plain C interface, loaded
  with ctypes (pointers and the stream pass as ``c_void_p``; every
  entry point returns ``cudaGetLastError()`` so the wrapper can raise);
* the host library ``csrc/host_kernels.cpp`` (see ``utils/native.py``).

A library is named by a hash of its sources and flags, so a checkout
never loads a stale build, and is published by an atomic rename, so
concurrent processes never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE_DIR / "_build"
KERNEL_SOURCES_DIR = PACKAGE_DIR / "csrc"

#: -fmad=false: no fused multiply-add contraction, so each kernel rounds
#: after every multiply and add exactly as its plain PyTorch version
#: does (the selection kernel's percentile interpolation is held to it
#: bit for bit).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_kernel_lib = None


def compile_shared(
    command: Sequence[str], sources: Sequence[Path], stem: str, headers: Sequence[Path] = ()
) -> Path:
    """Compile ``sources`` with ``command`` into a shared library under
    BUILD_DIR, unless a build of the same sources, ``headers`` and flags
    exists.  The compiler's output goes to ``BUILD_DIR/<stem>.log``.
    Raises RuntimeError when the compiler fails."""
    digest = hashlib.blake2b(" ".join(command).encode(), digest_size=8)
    for source in [*sources, *headers]:
        digest.update(source.read_bytes())
    lib_path = BUILD_DIR / f"{stem}-{digest.hexdigest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_path = lib_path.with_name(f"{lib_path.name}.tmp{os.getpid()}")
    cmd = [*command, *map(str, sources), "-o", str(tmp_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    (BUILD_DIR / f"{stem}.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {stem} failed (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp_path, lib_path)
    return lib_path


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def kernel_library() -> ctypes.CDLL:
    """The Hopper kernel library, built on first use.  Raises when nvcc
    is missing or the build fails."""
    global _kernel_lib
    if _kernel_lib is None:
        path = compile_shared(
            [_nvcc(), *NVCC_FLAGS],
            sorted(KERNEL_SOURCES_DIR.glob("*.cu")),
            "kernels",
            headers=sorted(KERNEL_SOURCES_DIR.glob("*.cuh")),
        )
        _kernel_lib = ctypes.CDLL(str(path))
    return _kernel_lib
