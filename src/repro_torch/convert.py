"""Carry state across from the JAX package to the port.

CT has no weights: what both sides must share to compute the same thing
is the geometry, the filter plan, the execution plan, the int8 wire's
encodings and the slot volumes.  The language model shares its
parameters and its decode cache.  The reference's objects arrive here as
plain Python and numpy values (this package never imports ``repro``): a
geometry as ``dataclasses.asdict(geom)``, a filter plan as its fields,
an execution plan as ``plan.as_dict()``, a ``RowQuant`` as its three
numpy arrays, volumes and projection stacks as numpy arrays, a model's
parameters and cache as nested dicts of numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import as_f32, resolve_device
from .core.filtering import FilterPlan
from .core.geometry import Geometry
from .dispatch.plan import ExecutionPlan
from .models.model import GenericLM
from .quant import RowQuant

__all__ = ["geometry_from_reference", "filter_plan_from_reference",
           "tensor_from_reference", "rowquant_from_reference",
           "plan_from_reference", "lm_params_from_reference",
           "lm_cache_from_reference", "opt_state_from_reference",
           "lm_tree_to_reference"]


def geometry_from_reference(fields: dict) -> Geometry:
    """A port :class:`Geometry` from ``dataclasses.asdict`` of the
    reference's; unknown or missing fields raise."""
    return Geometry(**fields)


def filter_plan_from_reference(pad, n_u, n_proj, scale, hf, cosw, parker,
                               *, device="cuda") -> FilterPlan:
    """A port :class:`FilterPlan` from the reference plan's fields
    (``hf`` complex64, ``cosw``/``parker`` float32 numpy; ``parker`` may
    be ``None``), as tensors on ``device``.  Values are carried bitwise."""
    dev = resolve_device(device)
    hf = np.asarray(hf)
    if hf.dtype != np.complex64:
        raise TypeError(f"hf must be complex64, got {hf.dtype}")
    return FilterPlan(
        pad=int(pad), n_u=int(n_u), n_proj=int(n_proj), scale=float(scale),
        hf=torch.tensor(hf, device=dev),
        cosw=tensor_from_reference(cosw, device=dev),
        parker=(None if parker is None
                else tensor_from_reference(parker, device=dev)))


def tensor_from_reference(array, *, device="cuda") -> torch.Tensor:
    """A float32 tensor on ``device`` from a reference volume or
    projection stack handed over as numpy."""
    return as_f32(array, resolve_device(device))


def rowquant_from_reference(rq, *, device="cuda") -> RowQuant:
    """A port :class:`RowQuant` from the reference's ``(codes, scale,
    offset)`` (int8 and float32 numpy, any leading stack axes), carried
    bitwise to ``device``."""
    codes, scale, offset = (np.asarray(a) for a in rq)
    if codes.dtype != np.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    if scale.shape != codes.shape[:-1] or offset.shape != scale.shape:
        raise ValueError(f"scale/offset must be {codes.shape[:-1]} for "
                         f"codes {codes.shape}; got {scale.shape} and "
                         f"{offset.shape}")
    dev = resolve_device(device)
    return RowQuant(torch.tensor(codes, device=dev),
                    tensor_from_reference(scale, device=dev),
                    tensor_from_reference(offset, device=dev))


def plan_from_reference(fields: dict) -> ExecutionPlan:
    """A port :class:`ExecutionPlan` from the reference plan's
    ``as_dict()``: the strategy part revalidated as an explicit plan,
    the tuned kernel config (``pallas``, ``use_pallas``) carried as it
    is.  A kernel config key the port's kernels do not take raises."""
    from .tune.cache import _PALLAS_KEYS

    plan = ExecutionPlan.explicit(fields["strategy"], fields["opts"],
                                  fields["pbatch"])
    pallas = fields.get("pallas")
    if not pallas:
        if fields.get("use_pallas"):
            raise ValueError("use_pallas=True needs a kernel config")
        return plan
    stray = sorted(set(pallas) - set(_PALLAS_KEYS))
    if stray:
        raise ValueError(f"kernel config keys {stray} are not taken by the "
                         f"port's kernels {_PALLAS_KEYS}")
    return plan._replace(pallas=tuple(sorted(pallas.items())),
                         use_pallas=bool(fields.get("use_pallas")))


def _array(leaf) -> torch.Tensor:
    """A reference leaf as a host tensor of its own dtype; bfloat16
    (``ml_dtypes``, which numpy cannot hand to torch) widens to float32
    exactly and narrows back."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)


def _load(module, tree: dict, period: int | None, where: str):
    own = dict(module.named_parameters(recurse=False))
    kids = dict(module.named_children())
    if set(tree) != set(own) | set(kids):
        raise ValueError(f"{where}: the reference has {sorted(tree)}, the "
                         f"port {sorted(set(own) | set(kids))}")
    for name, param in own.items():
        t = _array(tree[name])
        if period is not None:
            t = t[period]
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{where}/{name}: shape {tuple(t.shape)}, the "
                             f"port's is {tuple(param.shape)}")
        param.copy_(t.to(param.dtype))
    for name, child in kids.items():
        _load(child, tree[name], period, f"{where}/{name}")


@torch.no_grad()
def lm_params_from_reference(params: dict, cfg, *,
                             device="cuda") -> GenericLM:
    """The port's model on ``device`` holding the reference's parameters.

    ``params`` is the reference's tree as numpy arrays: top-level leaves
    (``embed``, ``norm_f_*``, ``frontend``, ``norm_enc_*``),
    ``blocks/b{j}/...`` stacked on a leading ``n_periods`` axis, and for
    an encoder-decoder ``enc_blocks/b0/...`` stacked on
    ``n_enc_layers``.  Layer ``i`` of the port takes period ``i //
    period`` of slot ``b{i % period}``; encoder layer ``i`` takes entry
    ``i`` of ``enc_blocks/b0``.  Values are carried bitwise; a missing
    or extra leaf, or a shape that differs, raises."""
    model = GenericLM(cfg, device=resolve_device(device), generator=None)
    stacks = ("blocks", "enc_blocks")
    top = {k: v for k, v in params.items() if k not in stacks}
    own = {name for name, _ in model.named_parameters(recurse=False)}
    if set(top) != own:
        raise ValueError(f"the reference has top-level leaves {sorted(top)}, "
                         f"the port {sorted(own)}")
    want = {"blocks"} | ({"enc_blocks"} if cfg.enc_dec else set())
    if set(params) & set(stacks) != want:
        raise ValueError(f"the reference has stacks "
                         f"{sorted(set(params) & set(stacks))}, the port "
                         f"{sorted(want)}")
    for name, param in model.named_parameters(recurse=False):
        param.copy_(_array(top[name]).to(param.dtype))
    for i, block in enumerate(model.layers):
        p, j = divmod(i, cfg.period)
        _load(block, params["blocks"][f"b{j}"], p, f"blocks/b{j}[{p}]")
    if cfg.enc_dec:
        if set(params["enc_blocks"]) != {"b0"}:
            raise ValueError(f"enc_blocks has {sorted(params['enc_blocks'])}"
                             f", the port ['b0']")
        for i, block in enumerate(model.enc_layers):
            _load(block, params["enc_blocks"]["b0"], i,
                  f"enc_blocks/b0[{i}]")
    return model


def lm_cache_from_reference(cache: dict, *, device="cuda") -> dict:
    """The reference's decode cache (``{"blocks": {"b{j}": {leaf:
    (n_periods, B, ...)}}}`` as numpy arrays) in the port's layout, which
    is the same, as tensors on ``device``, bitwise and in each leaf's
    dtype: the recurrent states, ``k``/``v`` in the compute dtype or
    int8 with bfloat16 ``k_s``/``v_s``, and ``cross_k``/``cross_v``."""
    dev = resolve_device(device)

    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        return _array(tree).to(dev)

    return convert(cache)


# ----------------------------------------------------------------------
# Training state: the reference's stacked layout <-> the port's names
# ----------------------------------------------------------------------

_STACKS = {"blocks": "layers", "enc_blocks": "enc_layers"}
_PORT_STACKS = {v: k for k, v in _STACKS.items()}


def _is_q8(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "s"}


def _per_layer(tree: dict, cfg) -> dict:
    """``{port name: (reference leaf, index or None)}`` of a tree in the
    reference's layout (a leaf an array or an int8 moment ``{"q",
    "s"}``): layer ``i`` of ``layers`` is entry ``i // period`` of
    ``blocks/b{i % period}``, encoder layer ``i`` entry ``i`` of
    ``enc_blocks/b0``."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict) and not _is_q8(node):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        if path[0] not in _STACKS:
            out[".".join(path)] = (node, None)
            return
        stack, slot, rest = path[0], path[1], ".".join(path[2:])
        j = int(slot.removeprefix("b"))
        n = (node["q"] if _is_q8(node) else np.asarray(node)).shape[0]
        for idx in range(n):
            i = idx * cfg.period + j if stack == "blocks" else idx
            out[f"{_STACKS[stack]}.{i}.{rest}"] = (node, idx)

    walk(tree, ())
    return out


def opt_state_from_reference(opt_state: dict, cfg, *,
                             device="cuda") -> dict:
    """The reference's AdamW state (``{"m", "v", "step"}``, moments in its
    stacked layout as numpy, int8 moments as ``{"q", "s"}``) in the
    port's layout (:func:`repro_torch.training.init_opt_state`): moments
    keyed by parameter name, each layer's slice of the stack, on
    ``device``, bitwise in each leaf's dtype."""
    dev = resolve_device(device)

    def take(node, idx):
        t = _array(node)
        return (t if idx is None else t[idx]).contiguous().to(dev)

    def moments(tree):
        out = {}
        for name, (node, idx) in _per_layer(tree, cfg).items():
            out[name] = ({"q": take(node["q"], idx), "s": take(node["s"], idx)}
                         if _is_q8(node) else take(node, idx))
        return out

    return {"m": moments(opt_state["m"]), "v": moments(opt_state["v"]),
            "step": _array(opt_state["step"]).to(torch.int32).to(dev)}


def lm_tree_to_reference(named: dict, cfg) -> dict:
    """The inverse for parameters and gradients: ``{port name: tensor}``
    (``dict(model.named_parameters())``, or gradients keyed alike) as the
    reference's stacked tree of float32 numpy arrays (bfloat16 widens
    exactly), each stack in layer order."""
    stacks: dict = {}
    out: dict = {}
    for name, t in named.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        head, _, rest = name.partition(".")
        stack = _PORT_STACKS.get(head)
        if stack is None:
            out[name] = arr
            continue
        i_str, _, leaf = rest.partition(".")
        i = int(i_str)
        p, j = (divmod(i, cfg.period) if stack == "blocks" else (i, 0))
        stacks.setdefault((stack, f"b{j}", leaf), {})[p] = arr
    for (stack, slot, leaf), by_index in stacks.items():
        node = out.setdefault(stack, {}).setdefault(slot, {})
        *dirs, last = leaf.split(".")
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = np.stack([by_index[k] for k in sorted(by_index)])
    return out
