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
            "repro_torch.kernels.quant, repro_torch.quant, "
            "repro_torch.dispatch, repro_torch.tune, "
            "repro_torch.tune.sweep, repro_torch.tune.audit, "
            "repro_torch.core.clipping, "
            "repro_torch.core.phantom, repro_torch.core.quality, "
            "repro_torch.configs, repro_torch.core.gather_ops, "
            "repro_torch.kernels.gather, repro_torch.kernels.gather_ref, "
            "repro_torch.kernels.gather_kernel_ops, "
            "repro_torch.kernels.slstm, repro_torch.kernels.slstm_ref, "
            "repro_torch.kernels.slstm_ops, repro_torch.models, "
            "repro_torch.models.layers, repro_torch.models.ssm, "
            "repro_torch.models.attention, "
            "repro_torch.models.blocks, repro_torch.models.model, "
            "repro_torch.serving, repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.launch.mesh, "
            "repro_torch.dist, repro_torch.core.pipeline, "
            "repro_torch.training, repro_torch.training.optim, "
            "repro_torch.training.train, repro_torch.data, "
            "repro_torch.data.tokens, repro_torch.ckpt, "
            "repro_torch.ckpt.checkpoint, repro_torch.ft, "
            "repro_torch.ft.manager, repro_torch.launch.train\n"
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
    from repro_torch.configs import ARCHS
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.core.pipeline import sharded_reconstruct
    from repro_torch.data import TokenDataset
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_cache, init_model
    from repro_torch.tune import autotune, sweep_strategies

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    x = np.zeros((G.n_proj, G.n_v, G.n_u), np.float32)
    mats = np.zeros((G.n_proj, 3, 4), np.float32)
    cfg = ARCHS["xlstm-125m"].reduced()
    for call in (lambda: filter_projections(x, G),
                 lambda: reconstruct(x, mats, G),
                 lambda: make_dataset(G),
                 lambda: ReconstructionEngine(G),
                 lambda: sweep_strategies(G),
                 lambda: autotune(G),
                 lambda: init_model(cfg),
                 lambda: init_cache(cfg, 2, 16),
                 lambda: lm_params_from_reference({}, cfg),
                 lambda: serve.main(["--requests", "1"]),
                 lambda: make_local_mesh(1, 1),
                 lambda: train.main(["--reduced", "--steps", "1"]),
                 lambda: TokenDataset(8, 4, 1).batch(0),
                 lambda: sharded_reconstruct(x, mats, G, None)):
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


def test_strip_launcher_refuses_what_the_kernels_do_not_take():
    from repro_torch.kernels.backproject import launch_strip, pitch_stack

    vol = torch.zeros(4, G.L, G.L)
    stack = torch.zeros(1, G.n_v + 2, G.n_u + 2)
    kw = dict(kind="db", z0=0, O=G.O, MM=G.MM, n_u=G.n_u, n_v=G.n_v, ty=8,
              chunk=16, band=16, width=128, pad_rows=32, pad_cols=128)
    with pytest.raises(ValueError, match="CUDA"):
        launch_strip(vol, stack, torch.zeros(1, 3, 4), **kw)
    with pytest.raises(ValueError, match="unknown strip kernel"):
        launch_strip(vol, stack, torch.zeros(1, 3, 4), **dict(kw,
                                                              kind="ring"))
    # A row of 1-byte codes is padded with zeros to whole 16-byte units.
    codes = torch.ones(2, 3, 5, dtype=torch.int8)
    pitched = pitch_stack(codes)
    assert pitched.shape == (2, 3, 16) and torch.equal(pitched[..., :5],
                                                       codes)
    assert not pitched[..., 5:].any()
    whole = torch.zeros(1, G.n_v + 2, 44)
    assert pitch_stack(whole) is whole


def test_lm_launchers_refuse_host_tensors():
    from repro_torch.kernels.gather import (launch_onehot_gather,
                                            launch_onehot_gather_grad)
    from repro_torch.kernels.slstm import (launch_slstm,
                                           launch_slstm_backward,
                                           launch_slstm_train)

    with pytest.raises(ValueError, match="CUDA"):
        launch_onehot_gather(torch.zeros(4, 8), torch.zeros(3,
                                                           dtype=torch.long))
    with pytest.raises(TypeError, match="int64"):
        launch_onehot_gather(torch.zeros(4, 8), torch.zeros(3,
                                                           dtype=torch.int32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch_onehot_gather(torch.zeros(4, 8, dtype=torch.float64),
                             torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="CUDA"):
        launch_slstm(torch.zeros(1, 2, 4, 8), torch.zeros(4, 8),
                     torch.zeros(4, 1, 8))
    with pytest.raises(TypeError, match="float32"):
        launch_slstm(torch.zeros(1, 2, 4, 8, dtype=torch.float64),
                     torch.zeros(4, 8), torch.zeros(4, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        launch_slstm_train(torch.zeros(1, 2, 4, 8), torch.zeros(4, 8),
                           torch.zeros(4, 1, 8))
    z = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        launch_slstm_backward(z, torch.zeros(4, 8), torch.zeros(4, 1, 8),
                              torch.zeros(1, 2, 8), torch.zeros(1, 2, 3, 8),
                              torch.zeros(1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        launch_onehot_gather_grad(torch.zeros(3, dtype=torch.long),
                                  torch.zeros(3, 8), 4)
    with pytest.raises(TypeError, match="int64"):
        launch_onehot_gather_grad(torch.zeros(3, dtype=torch.int32),
                                  torch.zeros(3, 8), 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch_onehot_gather_grad(torch.zeros(3, dtype=torch.long),
                                  torch.zeros(3, 8, dtype=torch.float64), 4)
