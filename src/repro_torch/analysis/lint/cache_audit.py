"""Tuned-cache audit: re-check persisted decisions against today's
planner.

The port's counterpart of ``repro/analysis/lint/cache_audit.py``.
``load_tuned`` rejects wrong-schema and corrupt files silently, by
treating them as untuned, and never re-checks a schema-current decision
against the current planner.  A decision tuned before a planner or
kernel change can therefore name a window the planner now proves too
small, options the resolver would shed, or a kernel config over the
card's shared memory.  This pass runs
:func:`repro_torch.tune.audit.audit_tuned_config`, the audit the
dispatcher runs before it replays a decision, on every JSON file of the
port's tune directory (:func:`repro_torch.tune.cache.tune_dir`:
``.repro_torch_tune/`` or ``$REPRO_TORCH_TUNE_DIR``) and makes each
reason a finding.  Beyond the reference it also audits the decision
``strategy="auto"`` replays where nothing is cached (the resolver's
:data:`~repro_torch.tune.cache.DEFAULT_STRATEGY` with no options) at
:data:`_DEFAULT_SCALES`, so a clean checkout, which has no tune
directory, still audits what it would run.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from .common import Finding, PassResult

__all__ = ["parse_cache_key", "geometry_for", "audit_tuned_config",
           "audit_cache_file", "run_cache_audit_pass"]

# cache_key() layout: ct-L{L}-u{n_u}-v{n_v}-O{O:g}-MM{MM:g}--{backend}--
# {device_kind}.  O/MM are %g floats (may carry '-' or exponents), so
# the geometry fields anchor on their labels, non-greedily.
# Scales (L) of the geometries the untuned default is audited at: the
# test shapes.  (At L = 512 the planner's check takes ~20 s on a CPU.)
_DEFAULT_SCALES = (8, 32)

_KEY_RE = re.compile(
    r"^ct-L(?P<L>\d+)-u(?P<u>\d+)-v(?P<v>\d+)"
    r"-O(?P<O>.+?)-MM(?P<MM>.+?)--(?P<backend>.+?)--(?P<device>.+)$")


def audit_tuned_config(gs, cfg, geom=None) -> list:
    """Reasons the decision ``cfg`` must not be replayed (the port's
    :func:`repro_torch.tune.audit.audit_tuned_config`, on the CPU)."""
    from ...tune.audit import audit_tuned_config as audit

    return audit(gs, cfg, geom=geom)


def parse_cache_key(stem: str):
    """``(GeomStatic, backend, device_kind)`` from a cache-file stem, or
    ``None`` when the name is not a cache key."""
    from ...core.backproject import GeomStatic

    m = _KEY_RE.match(stem)
    if not m:
        return None
    try:
        gs = GeomStatic(L=int(m["L"]), n_u=int(m["u"]), n_v=int(m["v"]),
                        O=float(m["O"]), MM=float(m["MM"]))
    except ValueError:
        return None
    return gs, m["backend"], m["device"]


def geometry_for(gs):
    """The full ``Geometry`` matching ``gs``, when one is reconstructible.

    A cache file stores only the static key; the repo's geometries are
    all ``default_geometry().scaled(L)``, so that round-trip is tried and
    verified.  ``None`` when the key belongs to another parameterisation:
    the audit then runs its static checks only."""
    from ...core.backproject import GeomStatic
    from ...core.geometry import default_geometry

    try:
        geom = default_geometry().scaled(gs.L)
    except ValueError:
        return None
    return geom if GeomStatic.of(geom) == gs else None


def audit_cache_file(path) -> list:
    """Findings for one tune-directory JSON file."""
    from ...tune.cache import TUNE_SCHEMA_VERSION, TunedConfig

    path = Path(path)
    where = str(path)
    parsed = parse_cache_key(path.stem)
    if parsed is None:
        return [Finding("cache", "unparseable-key", where,
                        "file name is not a cache key — load_tuned can "
                        "never hit it; delete or re-tune")]
    gs, _backend, _device = parsed
    try:
        data = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [Finding("cache", "corrupt-file", where,
                        f"not valid JSON ({e}); load_tuned silently "
                        f"treats this as untuned")]
    version = data.get("version") if isinstance(data, dict) else None
    if version != TUNE_SCHEMA_VERSION:
        return [Finding(
            "cache", "stale-schema", where,
            f"schema version {version!r} != current {TUNE_SCHEMA_VERSION}; "
            f"load_tuned silently ignores it — re-tune or delete")]
    try:
        cfg = TunedConfig(**data)
    except TypeError as e:
        return [Finding("cache", "malformed-config", where,
                        f"fields do not load into TunedConfig ({e})")]
    return [Finding("cache", "planner-invalid", where, reason)
            for reason in audit_tuned_config(gs, cfg,
                                             geom=geometry_for(gs))]


def audit_default() -> list:
    """Findings for the decision ``"auto"`` replays where nothing is
    cached, at each of :data:`_DEFAULT_SCALES`."""
    from ...core.backproject import GeomStatic
    from ...core.geometry import default_geometry
    from ...tune.cache import DEFAULT_STRATEGY, TunedConfig

    cfg = TunedConfig(strategy=DEFAULT_STRATEGY, opts={}, backend="any",
                      device_kind="any", us_per_call=0.0)
    findings = []
    for L in _DEFAULT_SCALES:
        geom = default_geometry().scaled(L)
        findings += [Finding("cache", "planner-invalid",
                             f"default:{DEFAULT_STRATEGY}:L={L}", reason)
                     for reason in audit_tuned_config(
                         GeomStatic.of(geom), cfg, geom=geom)]
    return findings


def run_cache_audit_pass(dirpath=None) -> PassResult:
    """Audit the untuned default (:func:`audit_default`) and every JSON
    file under the tune dir (default
    :func:`repro_torch.tune.cache.tune_dir`)."""
    from ...tune.cache import tune_dir

    d = Path(dirpath) if dirpath is not None else tune_dir()
    findings, checked = audit_default(), len(_DEFAULT_SCALES)
    notes = []
    if not d.is_dir():
        notes.append(f"tune dir {d} does not exist — nothing cached")
        return PassResult("cache", findings, checked, notes)
    for path in sorted(d.glob("*.json")):
        findings += audit_cache_file(path)
        checked += 1
    if checked == 0:
        notes.append(f"tune dir {d} holds no cache files")
    return PassResult("cache", findings, checked, notes)
