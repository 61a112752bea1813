"""The port's training launcher (``python -m repro_torch.launch.train``)
on the CPU, as ``tests/test_launch.py`` and the verify recipe run the
reference's: reduced chatglm3-6b, 6 steps, a checkpoint every 3."""

import argparse
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


def test_production_mesh_names_the_roadmap_item(capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(["--production-mesh", "--device", "cpu"])
    assert exc.value.code != 0
    assert "item 8b" in capsys.readouterr().err


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
