"""AdamW with float32, bfloat16 or int8 moments, counterpart of
``repro/training/optim.py``: bias-corrected AdamW, decoupled weight
decay, global-norm clipping, a cosine schedule with warmup, and the
``state_dtype`` knob:

``float32``   classic (8 bytes a parameter of moments)
``bfloat16``  half-cost moments
``int8``      moments quantised per last-axis channel (a symmetric
              scale per row of the last axis, rounded half to even),
              about 2 bytes a parameter

The reference is functional and jitted; the port updates the parameters
and the moments in place (a model's parameters are its ``nn.Module``'s),
leaf by leaf and, within a leaf, a block of rows at a time, so that the
float32 temporaries stay at :data:`CHUNK_ELEMS` elements whatever the
leaf (chatglm3-6b's 65024 x 4096 embedding is 1.07 GB in float32).

**The weight-decay rank rule.**  The reference decays leaves of rank >= 2
(``p.ndim >= 2``) and stacks each block parameter over the model's
periods, so a block's norm scales and biases, ``(n_periods, d)`` there,
are decayed, and only the top-level ``norm_f_*``/``norm_enc_*`` are not.
The port keeps one module per layer, where those leaves are 1-D: a leaf
under ``layers.`` or ``enc_layers.`` counts with one more axis
(:func:`reference_ndim`), so the same leaves decay as in the reference.

**Under a mesh** (parameters placed by
:func:`repro_torch.dist.place_params`) each moment is placed as its
parameter (an int8 moment's scales replicate their last axis, as
:func:`opt_state_specs` says), and each rank updates its own blocks.
:func:`global_norm` counts every element once: a leaf's sum of squares
is summed over the mesh dimensions that split it, not over those that
replicate it.  Where an int8 moment's last axis is split, its absmax is
all-reduced (MAX) over those mesh dimensions, so the scales are the
one-device ones.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch import nn

from ..dist import fsdp

__all__ = ["AdamWConfig", "CHUNK_ELEMS", "adamw_update", "cosine_schedule",
           "global_norm", "init_opt_state", "opt_state_specs",
           "reference_ndim"]

# Elements of one leaf updated at a time (a block of whole rows of its
# last axis): 128 MB of float32 per temporary.
CHUNK_ELEMS = 1 << 25

# The parameter trees whose leaves the reference stacks over a leading
# layer axis.
_STACKED = ("layers.", "enc_layers.")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # float32 | bfloat16 | int8
    warmup_steps: int = 100
    total_steps: int = 10_000


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as an IEEE division (on a CUDA tensor PyTorch divides by
    a Python scalar as a multiply by its reciprocal)."""
    return a / torch.full_like(a, b)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32: linear warmup
    over ``warmup_steps``, then a cosine to 0 at ``total_steps``."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(_div(step, max(cfg.warmup_steps, 1)), 1.0)
    t = torch.clamp(_div(step - cfg.warmup_steps,
                         max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


# ----------------------------------------------------------------------
# int8 moment quantisation
# ----------------------------------------------------------------------

def _q8(x: torch.Tensor, split=None):
    """Symmetric per-channel int8 quantisation along the last axis:
    ``(codes, scales)``, scales ``x.shape[:-1] + (1,)`` float32; with
    ``split`` (the process groups of the mesh dimensions that split the
    last axis), the absmax is the whole row's."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    if split is not None:
        for g in split:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g)
        fsdp.COUNTS["all_reduce"] += len(split)
    scale = _div(torch.clamp_min(amax, 1e-20), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _encode(x: torch.Tensor, state_dtype: str):
    if state_dtype == "int8":
        q, s = _q8(x)
        return {"q": q, "s": s}
    return x.to(torch.bfloat16 if state_dtype == "bfloat16"
                else torch.float32)


def _decode(enc, state_dtype: str) -> torch.Tensor:
    if state_dtype == "int8":
        return _dq8(enc["q"], enc["s"])
    return enc.to(torch.float32)


# ----------------------------------------------------------------------

def _named(params) -> dict:
    """``{name: tensor}`` of a module's parameters or of a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def opt_state_specs(param_specs: dict, state_dtype: str) -> dict:
    """Logical specs of the optimizer state, parallel to
    :func:`init_opt_state` (moments keyed by parameter name, as
    ``param_specs``); an int8 moment's scales replicate the last axis."""
    def spec_of(s):
        s = tuple(s)
        if state_dtype == "int8":
            return {"q": s, "s": s[:-1] + ("null",)}
        return s

    moments = {k: spec_of(s) for k, s in param_specs.items()}
    return {"m": moments, "v": dict(moments), "step": ("null",)}


def _scale_placements(p):
    """An int8 moment's scales: placed as ``p``, the last axis whole."""
    from torch.distributed.tensor import Replicate

    last = p.ndim - 1
    return [Replicate() if pl.is_shard() and pl.dim == last else pl
            for pl in p.placements]


def _last_axis_groups(p):
    """Process groups of the mesh dimensions splitting ``p``'s last
    axis, or ``None``."""
    if not fsdp.is_placed(p):
        return None
    mesh, last = p.device_mesh, p.ndim - 1
    groups = [mesh.get_group(i) for i, pl in enumerate(p.placements)
              if pl.is_shard() and pl.dim == last and mesh.size(i) > 1]
    return groups or None


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The rank the reference gives leaf ``name``: one more for a block
    parameter, which the reference stacks over its layers."""
    return p.ndim + (1 if name.startswith(_STACKED) else 0)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """``{"m": {name: moment}, "v": {...}, "step": int32 0}``, zeros
    encoded in ``cfg.state_dtype`` on each parameter's device (an int8
    zero's scale is ``1e-20 / 127``, as the reference encodes it).  A
    placed parameter's moments are placed as it is (module docstring)."""
    def zero_local(shape, device):
        if cfg.state_dtype == "int8":
            s = torch.full(tuple(shape[:-1]) + (1,), 1e-20,
                           dtype=torch.float32, device=device)
            return {"q": torch.zeros(shape, dtype=torch.int8,
                                     device=device),
                    "s": _div(s, 127.0)}
        return torch.zeros(shape, dtype=(
            torch.bfloat16 if cfg.state_dtype == "bfloat16"
            else torch.float32), device=device)

    def zero_like(p):
        if not fsdp.is_placed(p):
            return zero_local(p.shape, p.device)
        z = zero_local(p.to_local().shape, p.device)
        mesh = p.device_mesh
        if cfg.state_dtype != "int8":
            return fsdp.like(z, mesh, p.placements, p.shape)
        return {"q": fsdp.like(z["q"], mesh, p.placements, p.shape),
                "s": fsdp.like(z["s"], mesh, _scale_placements(p),
                               tuple(p.shape[:-1]) + (1,))}

    named = _named(params)
    device = next(iter(named.values())).device if named else "cpu"
    return {"m": {k: zero_like(p) for k, p in named.items()},
            "v": {k: zero_like(p) for k, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _row_step(p: torch.Tensor) -> int:
    """Rows of ``p``'s last axis in a block of at most
    :data:`CHUNK_ELEMS` elements."""
    return max(1, CHUNK_ELEMS // max(p.shape[-1], 1)) if p.ndim else 1


def _rows(t: torch.Tensor, step: int):
    """``t`` as views of ``step`` rows of its last axis at a time (a 0-d
    or 1-D leaf is one block); an int8 moment's scales ``shape[:-1] +
    (1,)`` block as its codes do."""
    if t.ndim < 2:
        yield t
        return
    flat = t.reshape(-1, t.shape[-1])
    for r0 in range(0, flat.shape[0], step):
        yield flat[r0:r0 + step]


def global_norm(grads) -> torch.Tensor:
    """``sqrt(sum of g^2)`` over every leaf, in float32; a placed leaf's
    elements each once (module docstring)."""
    totals = {}             # mesh dims splitting the leaves -> their sum
    for g in _named(grads).values():
        key = None
        if fsdp.is_placed(g):
            mesh = g.device_mesh
            key = (mesh, tuple(i for i, pl in enumerate(g.placements)
                               if pl.is_shard() and mesh.size(i) > 1))
            g = g.to_local()
        for block in _rows(g, _row_step(g)):
            sq = torch.sum(torch.square(block.to(torch.float32)))
            totals[key] = sq if key not in totals else totals[key] + sq
    if not totals:
        return torch.zeros((), dtype=torch.float32)
    total = None
    for key, sq in totals.items():
        if key is not None and key[1]:
            sq = fsdp.all_reduce(sq.clone(), key[0], key[1])
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _local_moment(enc):
    if isinstance(enc, dict):
        return {k: fsdp.local(v) for k, v in enc.items()}
    return fsdp.local(enc)


@torch.no_grad()
def adamw_update(grads, params, opt_state: dict, cfg: AdamWConfig):
    """One AdamW step, in place: the parameters (a module's, or a mapping
    of tensors) and ``opt_state``'s moments and step are updated.
    ``grads`` maps each parameter's name to its gradient.  Returns
    ``(params, opt_state, {"grad_norm", "lr"})`` as the reference."""
    named = {k: fsdp.local(p) for k, p in _named(params).items()}
    splits = {k: _last_axis_groups(p) for k, p in _named(params).items()}
    gnorm_in = _named(grads)
    grads = {k: fsdp.local(g) for k, g in gnorm_in.items()}
    dev = next(iter(named.values())).device
    step = opt_state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(gnorm_in).to(dev)
    clip = torch.clamp_max(torch.full_like(gnorm, cfg.clip_norm)
                           / torch.clamp_min(gnorm, 1e-9), 1.0)
    stepf = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=dev)
    bc1 = 1.0 - torch.pow(one * cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(one * cfg.b2, stepf)
    int8 = cfg.state_dtype == "int8"

    for name, p in named.items():
        g_all = grads[name]
        m_enc, v_enc = (_local_moment(opt_state[k][name]) for k in "mv")
        decay = reference_ndim(name, p) >= 2
        n = _row_step(p)
        parts = [p, g_all] + [t for e in (m_enc, v_enc)
                              for t in ((e["q"], e["s"]) if int8 else (e,))]
        for pb, gb, *enc in zip(*(_rows(t, n) for t in parts)):
            if int8:
                mq, ms, vq, vs = enc
                m_old, v_old = _dq8(mq, ms), _dq8(vq, vs)
            else:
                mb, vb = enc
                m_old, v_old = mb.to(torch.float32), vb.to(torch.float32)
            g = gb.to(torch.float32) * clip
            m = cfg.b1 * m_old + (1 - cfg.b1) * g
            v = cfg.b2 * v_old + (1 - cfg.b2) * g * g
            update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            pf = pb.to(torch.float32)
            if decay:
                update = update + cfg.weight_decay * pf
            pb.copy_((pf - lr * update).to(p.dtype))
            if int8:
                for (q, s), x in (((mq, ms), m), ((vq, vs), v)):
                    q_new, s_new = _q8(x, splits[name])
                    q.copy_(q_new)
                    s.copy_(s_new)
            else:
                mb.copy_(m)
                vb.copy_(v)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
