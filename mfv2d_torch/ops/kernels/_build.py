"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface.  At
first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/mfv2d_torch/`` at the checkout root and loaded with
``ctypes``.  The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.

Nothing here runs at import: ``nvcc`` is only called when a kernel is
first launched on a CUDA tensor, so the package imports where there is no
CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "mfv2d_torch"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else under torch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of mfv2d_torch are built at first"
        " use and need the CUDA toolkit (nvcc on PATH or CUDA_HOME set)."
    )


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    if name in _loaded:
        return _loaded[name]
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"lib{name}-{digest}.so"
    if not target.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                capture_output=True,
                text=True,
                check=False,
            )
            build_logs[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {source.name}"
                    f" (exit {proc.returncode}):\n{build_logs[name]}"
                )
            # Atomic publish: a concurrent process sees either no library
            # or a complete one.
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(target))
    _loaded[name] = lib
    return lib
