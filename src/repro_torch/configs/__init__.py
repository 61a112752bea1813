"""Architecture registry: --arch <id> resolves here (copies of the JAX
package's configs, as data)."""

from .base import SHAPES, ModelConfig, ShapeConfig
from .registry import ARCHS, cell_supported, cells, get_arch

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig",
           "cell_supported", "cells", "get_arch"]
