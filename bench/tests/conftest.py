"""Shared set-up of the benchmark's tests: the checkout's root and
``src`` on the path, and the cells at a size a CPU run holds."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# RabbitCT's geometry cut by 32 in every length (the port's
# Geometry.scaled(16)), 32 views in chunks of 8, and 3 clients.
TINY = {"config": {"geometry": {"n_u": 39, "n_v": 30, "du": 10.24,
                                "dv": 10.24, "L": 16, "voxel_mm": 16.0,
                                "n_proj": 32}},
        "traffic": {"chunk": 8, "clients": 3}}


@pytest.fixture(scope="session")
def bench():
    from bench.harness import registry

    return registry.benchmark()
