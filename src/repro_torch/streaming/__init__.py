"""Streamed reconstruction: serve CT scans as they arrive (DESIGN.md §8)."""

from .engine import ProjectionChunk, ReconstructionEngine, ScanState

__all__ = ["ProjectionChunk", "ReconstructionEngine", "ScanState"]
