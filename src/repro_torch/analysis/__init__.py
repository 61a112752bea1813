"""Analysis of the eager port: op census, collectives, roofline.

The port's counterpart of ``repro/analysis/__init__.py``, with the same
exports (:mod:`.census` holds them; :mod:`.trace` records a call's ops,
:mod:`.report` renders dry-run records, :mod:`.lint` is the contract
checker).
"""

from .census import (  # noqa: F401
    collective_bytes,
    op_census,
    parse_shape_bytes,
    roofline_terms,
)
