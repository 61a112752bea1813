"""Cone-beam CT core of the port: geometry, phantom, filtering, back
projection, strip planning and quality metrics (counterparts of
``repro.core``)."""

from .backproject import (DEFAULT_PBATCH, STRATEGIES, GeomStatic,
                          accumulate, backproject_batch, backproject_one,
                          backproject_plane, backproject_plane_batch,
                          contribution, fold_projections, plane_coords,
                          reconstruct, sample_gather, sample_onehot,
                          sample_scalar, sample_strip, sample_strip2,
                          strip_wire_dtype, validate_strip_opts)
from .filtering import (FilterPlan, apply_filter, filter_projections,
                        make_filter_plan, ramlak_kernel)
from .geometry import Geometry, default_geometry, projection_matrices, \
    projection_matrix
from .phantom import (Ellipsoid, forward_project, make_dataset,
                      shepp_logan_3d, voxelize)
from .quality import psnr, quality_report, roi_mask

__all__ = [
    "DEFAULT_PBATCH", "STRATEGIES", "GeomStatic", "accumulate",
    "backproject_batch", "backproject_one", "backproject_plane",
    "backproject_plane_batch", "contribution", "fold_projections",
    "plane_coords", "reconstruct", "sample_gather", "sample_onehot",
    "sample_scalar", "sample_strip", "sample_strip2", "strip_wire_dtype",
    "validate_strip_opts",
    "FilterPlan", "apply_filter", "filter_projections", "make_filter_plan",
    "ramlak_kernel", "Geometry", "default_geometry", "projection_matrices",
    "projection_matrix", "Ellipsoid", "forward_project", "make_dataset",
    "shepp_logan_3d", "voxelize", "psnr", "quality_report", "roi_mask",
]
