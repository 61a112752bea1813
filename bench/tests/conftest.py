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

# A paced mix at that size: one view a submit at 500 frames a second
# (62 ms a scan), 2 scanners.
TINY_PACED = {"config": TINY["config"],
              "traffic": {"chunk": 1, "clients": 2, "fps": 500}}


def tiny(bench, name: str) -> dict:
    """The overrides that bring cell ``name`` to the tiny size."""
    from bench.harness import registry

    mix = registry.traffic(registry.cell(bench, name)["traffic"])
    return TINY_PACED if "fps" in mix else TINY


@pytest.fixture(scope="session")
def bench():
    from bench.harness import registry

    return registry.benchmark()
