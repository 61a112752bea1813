"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with :mod:`ctypes`.  The library
lands in ``build/repro_torch/`` at the root of the checkout, named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["NVCC_FLAGS", "build_dir", "find_nvcc", "load"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

# No --use_fast_math: the kernels' 1/w must stay an IEEE division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    """``build/repro_torch/`` beside ``src/`` in the checkout."""
    return pathlib.Path(__file__).resolve().parents[3] / "build" / \
        "repro_torch"


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, PyTorch's ``CUDA_HOME``, or ``PATH``."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, torch's CUDA_HOME and "
            "PATH): the CUDA kernels cannot be built")
    return nvcc


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = build_dir() / f"lib{name}_{digest[:16]}.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        # Build to a private name, then rename: concurrent builds never
        # load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                  str(src)], capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} (exit {res.returncode}):\n"
                    f"{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = lib
    return lib
