"""Tensor and sequence parallelism of the LM stack (Megatron-style).

The reference gets both from GSPMD: its ``shard_constraint`` calls put
the heads, the Mamba channels and the vocabulary on ``tp``
(``repro/models/attention.py``, ``ssm.py``, ``model.py``) and the
residual stream on ``sp_act``.  This module is the port's counterpart,
beside :mod:`repro_torch.dist.fsdp` (GSPMD's ZeRO-3).  Every collective
goes through c10d (:mod:`~repro_torch.dist.fsdp`'s groups and
:data:`~repro_torch.dist.fsdp.COUNTS`).  The values stay those of the
single-device run; each rank computes only its block.

Design rules:

* **Where the split applies.**  Where the active context's ``tp`` axes
  resolve to mesh dimensions larger than 1 (:func:`split`).  A mesh of
  one rank, or ``tp`` on size-1 dimensions, runs the one-device code.
* **Column-parallel, then row-parallel.**  A column-parallel weight
  (``wq``/``wk``/``wv``, ``w_gate``/``w_up``/``w_in``, ``up``) keeps its
  ``tp`` block and is gathered over ``fsdp`` only (:func:`read`).  A
  row-parallel one (``wo``, ``w_down``, every ``out_proj``) is read the
  same way, and its output is all-reduced over ``tp``.  The input of a
  split sub-layer goes through :func:`copy_to_tp` (identity; its
  gradient all-reduced), the output through :func:`reduce_from_tp`
  (all-reduce; its gradient the identity).  A ``tp``-split leaf's
  gradient is then the rank's own block: no sum over ``tp``.  Replicated
  leaves (norms, the router, the frontends) keep ``Replicate()`` on
  ``tp``: every rank computes them whole, on equal inputs.
* **Fused projections** (Mamba's ``in_proj``, mLSTM's ``qkv`` and
  ``gates``, sLSTM's gate-major ``zifo``): a contiguous block of their
  columns would hand a rank whole gates.  They are gathered over ``tp``
  too, with their gradient summed over it, and each part's block is cut
  (:func:`cut_parts`).  Placement, checkpoints and ``param_specs`` keep
  the reference's layout.
* **KV heads.**  A rank takes query heads ``[r H/tp, (r+1) H/tp)``.
  Where ``n_kv_heads % tp == 0`` it takes its own block of KV heads;
  where not, ``wk``/``wv`` are gathered over ``tp`` (gradient summed)
  and the rank computes only the KV heads its query heads read
  (:func:`kv_heads`).  Where its query heads straddle GQA groups
  unevenly, each local query head reads its own group's KV head
  (:func:`head_map`).
* **Mamba.**  ``in_proj`` is cut as two parts; ``conv_*``, ``dt_bias``,
  ``A_log``, ``D`` are per-channel blocks; ``x_proj`` is row-parallel
  into the shared ``2 ds + 1`` outputs, which :func:`shared` all-reduces
  forward and backward (each rank's channels read all of them).
* **mLSTM / sLSTM.**  ``qkv`` is cut as three parts, ``gates`` as two
  (by heads), ``zifo`` as four and ``r_zifo`` by
  its block: every normaliser is per head and the sLSTM recurrence is
  diagonal, so kernel rows 10 and 10b run unchanged on ``di / tp``.
* **Vocabulary-parallel embedding and loss.**  A rank holds rows
  ``[r V/tp, (r+1) V/tp)`` of ``embed``; it gathers ``ids - offset``
  from its block (rows 9 and 9b give zero rows for ids outside it; the
  ``take`` gather masks them) and the rows are all-reduced.  The logits
  are each rank's block of the vocabulary, and :func:`vocab_nll` is the
  cross-entropy over the blocks: a detached max all-reduced with MAX,
  the sums of exponentials and the target logits all-reduced, the
  gradient ``softmax - onehot`` on the local block.  ``forward``,
  ``prefill`` and ``decode_step`` gather the blocks (:func:`full_vocab`).
* **sp_act.**  Where ``rules.sp_act`` resolves to the same mesh
  dimensions as ``tp`` (the reference's ``pick_rules``), the full-
  sequence paths keep the residual stream as this rank's block of the
  sequence: all-gathered before each sub-layer (:func:`enter`),
  reduce-scattered after a split one (:func:`leave`).  Norms then read a
  block of the sequence, so their gradients are summed over ``sp_act``
  (:func:`read`).  A decode step computes its one token whole, and so
  does a call whose sequence (or, for an encoder-decoder, the encoder's)
  the ranks do not divide.  Any other ``sp_act`` layout computes the
  stream whole.
* **Flash-decoding beside tp.**  Under ``rules.flash_decode`` with ``sp``
  axes the attention keeps its heads whole and splits the cache's
  positions (PR 24's path); ``tp`` splits the MLP and the mixers.
* **The divisibility guard** (the reference's ``valid_spec``,
  ``repro/dist/sharding.py``): any dimension that does not divide by the
  total size of its mesh axes falls back to replication.  Here the unit
  is the sub-layer: attention (its query heads), the mLSTM (its heads
  and ``d_inner``), the sLSTM and Mamba (``d_inner``), the MLP
  (``d_ff``), and the vocabulary embedding with the logits and the loss
  (the vocabulary).  Where ``tp`` does not divide one of those widths
  the sub-layer runs whole on every rank (:func:`sub_split` is
  ``None``): its ``tp`` leaves are gathered whole (each rank computes
  the same values, so their gradients are not summed over ``tp``), its
  input skips :func:`copy_to_tp`, its output :func:`reduce_from_tp`,
  and its cache leaves keep their full width.  The placement keeps
  ``valid_spec``'s per-leaf rule: a leaf whose own dimension divides
  stays placed on ``tp`` and is gathered.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from . import fsdp

__all__ = ["Split", "split", "attention_split", "divides", "sub_split",
           "vocab_split", "block_of", "kv_heads", "head_map", "read",
           "cut_parts", "FUSED", "copy_to_tp", "reduce_from_tp", "shared",
           "enter", "leave", "seq_full", "full_vocab", "vocab_nll",
           "local_inner", "local_kv"]

# Fused projections: the number of parts their split dimension holds.
FUSED = {"in_proj": 2, "qkv": 3, "gates": 2, "zifo": 4}
# Attention leaves whose split follows the KV heads.
_KV_LEAVES = ("wk", "wv", "wk_b", "wv_b")
# Top-level leaves split over the vocabulary.
_VOCAB_LEAVES = ("embed", "unembed")
_NORM_SUFFIXES = ("_scale", "_bias")


class Split(NamedTuple):
    """The tensor-parallel split of the active context: its mesh, the
    ``tp`` mesh dimensions (size > 1, mesh order), their ranks ``n``,
    this rank's index ``r`` along them (major first, as DTensor lays a
    dimension out over several mesh dimensions), and whether ``sp_act``
    splits the stream over the same dimensions."""

    mesh: object
    dims: tuple
    n: int
    r: int
    sp: bool


def split() -> Split | None:
    """The active context's :class:`Split`, or ``None`` where ``tp``
    splits nothing."""
    ctx = fsdp.active()
    if ctx is None:
        return None
    mesh, rules = ctx
    dims = fsdp.axis_dims(mesh, rules.tp)
    if not dims:
        return None
    coord = mesh.get_coordinate()
    r, n = 0, 1
    for i in dims:
        r = r * mesh.size(i) + coord[i]
        n *= mesh.size(i)
    return Split(mesh, dims, n, r,
                 fsdp.axis_dims(mesh, rules.sp_act) == dims)


def attention_split(s: Split | None = None) -> Split | None:
    """The split the attention takes: ``None`` under flash-decoding,
    where it keeps its heads whole (module docstring)."""
    s = split() if s is None else s
    if s is None:
        return None
    _, rules = fsdp.active()
    if rules.flash_decode and fsdp.axis_dims(s.mesh, rules.sp):
        return None
    return s


def divides(total: int, s: Split) -> bool:
    """Whether the ``s.n`` tensor-parallel shards divide ``total``."""
    return total % s.n == 0


def _widths(cfg, kind: str) -> tuple:
    """The widths a sub-layer of ``kind`` splits over ``tp`` (module
    docstring); ``()`` for one that is never split."""
    return {"attn": (cfg.n_heads,), "cross": (cfg.n_heads,),
            "mlstm": (cfg.n_heads, cfg.d_inner), "mamba": (cfg.d_inner,),
            "slstm": (cfg.d_inner,), "mlp": (cfg.d_ff,),
            "vocab": (cfg.vocab,)}.get(kind, ())


def sub_split(cfg, kind: str, s: Split | None) -> Split | None:
    """The split a sub-layer of ``kind`` (``attn``, ``cross``, ``mlstm``,
    ``slstm``, ``mamba``, ``mlp``, ``vocab``) takes under ``s``: ``s``
    itself, or ``None`` where it runs whole (the divisibility guard, or
    the attention under flash-decoding).  The MoE layer, the norms and
    the frontends are whole under every split."""
    if s is None or kind in ("attn", "cross") and attention_split(s) is None:
        return None
    widths = _widths(cfg, kind)
    return s if widths and all(divides(w, s) for w in widths) else None


def vocab_split(vocab: int | None = None) -> Split | None:
    """The active split where it divides ``vocab`` (``None``: the
    caller's table is already this rank's block), else ``None``."""
    s = split()
    if s is None or vocab is not None and not divides(vocab, s):
        return None
    return s


def block_of(total: int, s: Split, what: str) -> tuple[int, int]:
    """``(start, size)`` of this rank's block of ``total``.  The callers
    check :func:`divides` first (:func:`sub_split`); a ``total`` that
    ``s.n`` does not divide here is a fault, named by ``what``."""
    if not divides(total, s):
        raise ValueError(f"{what}: {total} does not divide the {s.n} "
                         f"tensor-parallel shards")
    size = total // s.n
    return s.r * size, size


def kv_heads(cfg, s: Split) -> tuple[int, int]:
    """``(k0, k1)``: the KV heads this rank's query heads read."""
    h0, hn = block_of(cfg.n_heads, s, "n_heads (wq, wo)")
    if divides(cfg.n_kv_heads, s):
        k0, kn = block_of(cfg.n_kv_heads, s, "n_kv_heads")
        return k0, k0 + kn
    g = cfg.n_heads // cfg.n_kv_heads
    return h0 // g, (h0 + hn - 1) // g + 1


def head_map(cfg, s: Split) -> list | None:
    """Each of this rank's query heads' KV head, counted from
    :func:`kv_heads`'s first, where the rank's query heads straddle GQA
    groups unevenly (6 heads over 3 KV heads at tp = 2: rank 0 holds
    heads 0-2, which read KV heads 0, 0, 1); ``None`` where they are
    whole groups or lie in one, and grouping them in order is right."""
    h0, hn = block_of(cfg.n_heads, s, "n_heads (wq, wo)")
    k0, k1 = kv_heads(cfg, s)
    g = cfg.n_heads // cfg.n_kv_heads
    if k1 - k0 == 1 or (h0 % g == 0 and hn % g == 0):
        return None
    return [(h0 + i) // g - k0 for i in range(hn)]


def local_kv(cfg) -> int:
    """This rank's KV heads (all of them off a split, or where the
    attention runs whole)."""
    s = sub_split(cfg, "attn", split())
    if s is None:
        return cfg.n_kv_heads
    k0, k1 = kv_heads(cfg, s)
    return k1 - k0


def local_inner(cfg, kind: str) -> int:
    """This rank's channels of ``cfg.d_inner`` in a ``kind`` mixer
    (``mamba``, ``slstm``): all of them where it runs whole."""
    s = sub_split(cfg, kind, split())
    return cfg.d_inner if s is None else cfg.d_inner // s.n


# ----------------------------------------------------------------------
# Reading a placed parameter
# ----------------------------------------------------------------------

def cut_parts(full: torch.Tensor, d: int, parts: int, s: Split,
              what: str) -> torch.Tensor:
    """This rank's block of each of ``parts`` equal parts of dimension
    ``d``, concatenated in part order."""
    chunks = full.chunk(parts, d)
    off, size = block_of(chunks[0].shape[d], s, what)
    return torch.cat([c.narrow(d, off, size) for c in chunks], d)


def read(p: torch.Tensor, name: str, spec, kind: str, cfg, mesh, rules,
         s: Split, seq: bool) -> torch.Tensor:
    """Parameter ``name`` (logical axes ``spec``) of a ``kind`` module
    (``attn``, ``cross``, ``mamba``, ``mlstm``, ``slstm``, ``mlp``,
    ``block`` for a block's norms, ``top``) as this rank computes with
    it under the split ``s``; ``seq`` when the stream is split along the
    sequence (its norms then read a block of it).  A leaf of a sub-layer
    that runs whole (:func:`sub_split`) is gathered whole."""
    d = spec.index("tp") if "tp" in spec else None
    sub = kind if kind != "top" else "vocab" if name in _VOCAB_LEAVES \
        else None
    if d is None or sub_split(cfg, sub, s) is None:
        norm = seq and kind in ("block", "top") \
            and name.endswith(_NORM_SUFFIXES)
        return fsdp.gather(p, mesh, rules,
                           sum_axes=rules.sp_act if norm else ())
    what = f"{kind} leaf {name!r} {tuple(p.shape)}"
    if not fsdp.is_placed(p) and p.requires_grad and torch.is_grad_enabled():
        raise ValueError(f"{what}: a trainable parameter under a "
                         f"tensor-parallel mesh must be placed first "
                         f"(place_params)")
    if name in FUSED:
        full = fsdp.gather(p, mesh, rules, sum_axes=rules.tp)
        return cut_parts(full, d, FUSED[name], s, what)
    if kind in ("attn", "cross") and name in _KV_LEAVES \
            and not divides(cfg.n_kv_heads, s):
        full = fsdp.gather(p, mesh, rules, sum_axes=rules.tp)
        k0, k1 = kv_heads(cfg, s)
        return full.narrow(d, k0 * cfg.hd, (k1 - k0) * cfg.hd)
    t = fsdp.gather(p, mesh, rules, keep_axes=rules.tp)
    total = p.shape[d]
    off, size = block_of(total, s, what)
    if t.shape[d] == total:             # not placed on tp: cut it here
        return t.narrow(d, off, size)
    if t.shape[d] != size:
        raise ValueError(f"{what}: holds {t.shape[d]} of {total}, not the "
                         f"block of {size}")
    return t


# ----------------------------------------------------------------------
# The Megatron operators
# ----------------------------------------------------------------------

def _ar(t: torch.Tensor, s: Split) -> torch.Tensor:
    return fsdp.all_reduce(t.contiguous().clone(), s.mesh, s.dims)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ar(g, ctx.s), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        return _ar(x, s)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Shared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return _ar(x, s)

    @staticmethod
    def backward(ctx, g):
        return _ar(g, ctx.s), None


def copy_to_tp(x: torch.Tensor, s: Split | None) -> torch.Tensor:
    """The input of a split sub-layer: ``x`` itself; its gradient
    all-reduced over ``tp`` (each rank's covers its block)."""
    return x if s is None else _Copy.apply(x, s)


def reduce_from_tp(x: torch.Tensor, s: Split | None) -> torch.Tensor:
    """A row-parallel output: the partial sums all-reduced over ``tp``;
    the gradient the identity (every rank's is the whole one)."""
    return x if s is None else _Reduce.apply(x, s)


def shared(x: torch.Tensor, s: Split | None) -> torch.Tensor:
    """A row-parallel output read by split consumers (Mamba's
    ``x_proj``): all-reduced forward and backward."""
    return x if s is None else _Shared.apply(x, s)


# ----------------------------------------------------------------------
# The sequence split of the stream
# ----------------------------------------------------------------------

def _all_gather(t: torch.Tensor, s: Split, d: int) -> torch.Tensor:
    """Every rank's block along dimension ``d``, in rank order."""
    for i in reversed(s.dims):
        t = fsdp._all_gather_dim(t, s.mesh, i, d)
    return t


def _reduce_scatter(t: torch.Tensor, s: Split, d: int) -> torch.Tensor:
    """The sum over the ranks of ``t``, this rank's block along ``d``."""
    for i in s.dims:                    # major first: blocks nest
        parts = [c.contiguous() for c in t.chunk(s.mesh.size(i), d)]
        t = torch.empty_like(parts[0])
        dist.reduce_scatter(t, parts, group=s.mesh.get_group(i))
        fsdp.COUNTS["reduce_scatter"] += 1
    return t


def _own(t: torch.Tensor, s: Split, d: int) -> torch.Tensor:
    off, size = block_of(t.shape[d], s, f"dimension {d} of {tuple(t.shape)}")
    return t.narrow(d, off, size).contiguous()


class _Gather(torch.autograd.Function):
    """All-gather along dimension ``d``; gradient reduce-scattered
    (``summed``, a split consumer) or cut to this rank's block (a whole
    one, every rank holding the same value)."""

    @staticmethod
    def forward(ctx, x, s, d, summed):
        ctx.s, ctx.d, ctx.summed = s, d, summed
        return _all_gather(x.contiguous(), s, d)

    @staticmethod
    def backward(ctx, g):
        s, d = ctx.s, ctx.d
        return (_reduce_scatter(g, s, d) if ctx.summed else _own(g, s, d),
                None, None, None)


class _SeqScatter(torch.autograd.Function):
    """This rank's block of the sequence: reduce-scattered (``sum``, a
    split producer's partial sums) or cut (a whole one); the gradient
    all-gathered."""

    @staticmethod
    def forward(ctx, x, s, summed):
        ctx.s = s
        return _reduce_scatter(x, s, 1) if summed else _own(x, s, 1)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.s, 1), None, None


def enter(h: torch.Tensor, s: Split | None, split_sub: bool,
          seq: bool) -> torch.Tensor:
    """A sub-layer's input from the stream ``h``: gathered along the
    sequence where the stream is split (``seq``), and for a split
    sub-layer (``split_sub``) with its gradient summed over ``tp``."""
    if s is None:
        return h
    if seq:
        return _Gather.apply(h, s, 1, split_sub)
    return copy_to_tp(h, s) if split_sub else h


def leave(y: torch.Tensor, s: Split | None, split_sub: bool,
          seq: bool) -> torch.Tensor:
    """A sub-layer's output back into the stream: a split one's partial
    sums reduced (all-reduce, or reduce-scatter where the stream is split
    along the sequence), a whole one's cut to this rank's block."""
    if s is None:
        return y
    if seq:
        return _SeqScatter.apply(y, s, split_sub)
    return reduce_from_tp(y, s) if split_sub else y


def seq_full(x: torch.Tensor, s: Split | None, seq: bool) -> torch.Tensor:
    """The whole sequence of a split stream (every rank's equal copy)."""
    return x if s is None or not seq else _Gather.apply(x, s, 1, False)


# ----------------------------------------------------------------------
# The vocabulary split
# ----------------------------------------------------------------------

def full_vocab(logits: torch.Tensor, s: Split | None) -> torch.Tensor:
    """Every rank's block of the vocabulary, in order; the gradient is
    cut back to this rank's block (every rank holds the same logits)."""
    if s is None:
        return logits
    return _Gather.apply(logits, s, logits.ndim - 1, False)


class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, s):
        lf = logits.float()
        V = lf.shape[-1]
        m = fsdp.all_reduce(lf.amax(-1), s.mesh, s.dims, dist.ReduceOp.MAX)
        e = torch.exp(lf - m[..., None])
        total = _ar(e.sum(-1), s)
        local = labels - s.r * V
        inside = (local >= 0) & (local < V)
        tgt = torch.gather(lf, -1, local.clamp(0, V - 1)[..., None])[..., 0]
        tgt = _ar(torch.where(inside, tgt, torch.zeros_like(tgt)), s)
        ctx.save_for_backward(e / total[..., None], local, inside)
        return torch.log(total) + m - tgt

    @staticmethod
    def backward(ctx, g):
        soft, local, inside = ctx.saved_tensors
        V = soft.shape[-1]
        grad = soft * g[..., None]
        hit = torch.where(inside, g, torch.zeros_like(g))
        grad.scatter_add_(-1, local.clamp(0, V - 1)[..., None],
                          -hit[..., None])
        return grad, None, None


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor,
              s: Split) -> torch.Tensor:
    """``-log softmax(logits)[label]`` per position (float32) from this
    rank's block of the vocabulary; ``labels`` in ``[0, V)``."""
    return _VocabNLL.apply(logits, labels, s)

