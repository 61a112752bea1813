"""The port's training launcher (``python -m repro_torch.launch.train``)
on the CPU, as ``tests/test_launch.py`` and the verify recipe run the
reference's: reduced chatglm3-6b, 6 steps, a checkpoint every 3; on a
world of one (a 1x1 mesh) and of two gloo ranks."""

import argparse
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.launch import train

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_launcher_trains_and_checkpoints(tmp_path):
    ck = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "chatglm3-6b", "--reduced", "--steps", "6", "--seq", "16",
         "--batch", "2", "--save-every", "3", "--device", "cpu", "--ckpt",
         str(ck)], env=env, capture_output=True, text=True, timeout=300,
        check=True).stdout
    assert "arch=chatglm3-6b-smoke" in out
    assert "finished at step 6 (0 restarts)" in out
    assert "step    0 loss=" in out
    assert "the update median" in out
    assert sorted(p.name for p in ck.iterdir()) == ["step_000000003"]
    # A second launch resumes from the checkpoint and finishes at once.
    step, restarts = train.main(["--arch", "chatglm3-6b", "--reduced",
                                 "--steps", "5", "--seq", "16", "--batch",
                                 "2", "--device", "cpu", "--ckpt", str(ck)])
    assert (step, restarts) == (5, 0)


def test_production_mesh_needs_its_world(capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(["--production-mesh", "--device", "cpu"])
    assert exc.value.code != 0
    assert ("make_production_mesh: the 16x16 mesh needs a world of 256 "
            "ranks, not 1") in capsys.readouterr().err


def _losses(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("losses ")][-1]
    return json.loads(line.removeprefix("losses "))


@pytest.mark.parametrize("batch,accum", [(2, 1), (4, 2)])
def test_launcher_trains_on_two_gloo_ranks(tmp_path, batch, accum):
    """Two processes joined through a file store train on a 2x1 mesh:
    rank 0 reports the mesh, the loop finishes and checkpoints, and each
    step's loss (the global mean) is the one-rank launcher's, also with
    gradients accumulated over two microbatches."""
    args = ["--arch", "chatglm3-6b", "--reduced", "--steps", "3", "--seq",
            "16", "--batch", str(batch), "--accum-steps", str(accum),
            "--save-every", "2", "--device", "cpu"]
    base = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    base.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args]
    env = dict(base, WORLD_SIZE="2",
               REPRO_TORCH_INIT_METHOD=f"file://{tmp_path / 'store'}")
    procs = [subprocess.Popen(cmd + ["--ckpt", str(tmp_path / "ck2")],
                              env=dict(env, RANK=str(r)), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-3000:]
    out = outs[0][0]
    assert "mesh={'data': 2, 'model': 1}" in out
    assert "batch->data (split), fsdp->data (split)" in out
    assert "finished at step 3 (0 restarts)" in out
    assert not outs[1][0].strip()                 # rank 0 prints
    assert sorted(p.name for p in (tmp_path / "ck2").iterdir()) == [
        "step_000000002"]
    one = subprocess.run(cmd + ["--ckpt", str(tmp_path / "ck1")], env=base,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert "mesh={'data': 1, 'model': 1}" in one
    got, want = _losses(out), _losses(one)
    assert sorted(got) == sorted(want) == ["0", "1", "2"]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)


def test_train_launchers_have_the_same_defaults(monkeypatch):
    """The reference's ``main()`` reads ``sys.argv``; both parsers are
    caught at ``parse_args`` and their defaults compared (the port's
    ``--device`` aside)."""
    from repro.launch import train as ref_train

    class Parsed(Exception):
        pass

    def grab(self, args=None, namespace=None):
        raise Parsed({a.dest: a.default for a in self._actions
                      if a.dest != "help"})

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    monkeypatch.setattr("sys.argv", ["train"])
    found = []
    for main in (ref_train.main, train.main):
        with pytest.raises(Parsed) as exc:
            main()
        found.append(exc.value.args[0])
    ref, port = found
    assert port.pop("device") == "cuda"
    assert port == ref and port["arch"] == "chatglm3-6b"
