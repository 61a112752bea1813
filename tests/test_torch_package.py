"""Package rules of the port: no JAX and no ``repro`` at run time, the
default device is the card, and the kernel wrapper refuses what the
kernel does not take."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.geometry import Geometry

REPO = pathlib.Path(__file__).resolve().parents[1]
G = Geometry().scaled(16, n_proj=6)


def _is_forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def test_import_pulls_in_no_jax_and_no_reference():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.convert, "
            "repro_torch.kernels, repro_torch.kernels._build, "
            "repro_torch.core.phantom, repro_torch.core.quality\n"
            "print('\\n'.join(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    bad = [m for m in out.split() if _is_forbidden(m)]
    assert bad == []


def _sources():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_module_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_is_forbidden(n) for n in names), (path, names)


def test_default_device_is_the_card():
    from repro_torch.core.backproject import reconstruct
    from repro_torch.core.filtering import filter_projections
    from repro_torch.core.phantom import make_dataset
    from repro_torch.streaming import ReconstructionEngine

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    x = np.zeros((G.n_proj, G.n_v, G.n_u), np.float32)
    mats = np.zeros((G.n_proj, 3, 4), np.float32)
    for call in (lambda: filter_projections(x, G),
                 lambda: reconstruct(x, mats, G),
                 lambda: make_dataset(G),
                 lambda: ReconstructionEngine(G)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    from repro_torch.kernels import backproject_batch, backproject_one

    vol = torch.zeros(G.L, G.L, G.L)
    imgs = torch.zeros(2, G.n_v, G.n_u)
    mats = np.zeros((2, 3, 4), np.float32)
    with pytest.raises(TypeError, match="float32"):
        backproject_batch(vol.double(), imgs, mats, G)
    with pytest.raises(TypeError, match="float32"):
        backproject_batch(vol, imgs.double(), mats, G)
    with pytest.raises(ValueError, match="volume must be"):
        backproject_batch(vol[:, :5], imgs, mats, G)
    with pytest.raises(ValueError, match="images must be"):
        backproject_batch(vol, imgs[:, :-1], mats, G)
    with pytest.raises(ValueError, match="matrices"):
        backproject_batch(vol, imgs, mats[:1], G)
    with pytest.raises(ValueError, match="one"):
        backproject_one(vol, imgs, mats[0], G)


def test_launcher_refuses_host_tensors():
    from repro_torch.kernels.backproject import launch_backproject

    vol = torch.zeros(4, G.L, G.L)
    padded = torch.zeros(1, G.n_v + 2, G.n_u + 2)
    with pytest.raises(ValueError, match="CUDA"):
        launch_backproject(vol, padded, torch.zeros(1, 3, 4), z0=0, O=G.O,
                           MM=G.MM)


def test_build_finds_no_compiler_without_one(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    if torch.cuda.is_available():
        pytest.skip("a CUDA toolkit may be installed here")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None,
                        raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
    assert _build.build_dir().parts[-2:] == ("build", "repro_torch")
    assert "--use_fast_math" not in _build.NVCC_FLAGS
