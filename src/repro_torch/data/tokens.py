"""Deterministic synthetic LM data, counterpart of
``repro/data/tokens.py``.

No corpus: the stream is a hidden Markov chain of ``n_states`` states
(transition logits ``2 g``, emission logits over the vocabulary ``4 g``,
``g`` Gumbel draws), which a model learns fast, so a training loss
visibly falls.

**Stateless addressing**: batch ``step`` is a function of ``(seed,
step)`` alone, drawn from a :class:`torch.Generator` seeded from the
two, so any process makes any batch and a resumed run needs only the
step counter.  The draws are PyTorch's, not ``jax.random``'s, and a
generator on the card draws other numbers than one on the CPU: the
stream is the same function of ``(seed, step)`` on one device, not the
reference's tokens.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .._device import resolve_device

__all__ = ["TokenDataset", "make_lm_batches"]


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, tiny, 1.0)))


@dataclasses.dataclass(frozen=True)
class TokenDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64      # Markov states (kept small: learnable fast)
    device: str = "cuda"

    def _generator(self, key: int) -> torch.Generator:
        dev = resolve_device(self.device)
        return torch.Generator(device=dev).manual_seed(key)

    @functools.cached_property
    def _tables(self):
        """Transition and emission probabilities, from ``seed``."""
        dev = resolve_device(self.device)
        g = self._generator(self.seed)
        trans = _gumbel((self.n_states, self.n_states), g, dev) * 2.0
        emit = _gumbel((self.n_states, self.vocab), g, dev) * 4.0
        return torch.softmax(trans, -1), torch.softmax(emit, -1)

    def batch(self, step: int) -> dict:
        """Batch for global step ``step``: ``tokens`` and ``labels``,
        ``(global_batch, seq_len)`` int32 on the dataset's device, the
        labels the tokens shifted by one."""
        trans, emit = self._tables
        # (seed + 1, step) -> one 64-bit seed: distinct for steps < 2^32.
        g = self._generator(((self.seed + 1) << 32) + int(step))
        B = self.global_batch
        s = torch.randint(0, self.n_states, (B,), generator=g,
                          device=trans.device)
        toks = []
        for _ in range(self.seq_len + 1):
            s = torch.multinomial(trans[s], 1, generator=g)[:, 0]
            toks.append(torch.multinomial(emit[s], 1, generator=g)[:, 0])
        toks = torch.stack(toks, dim=1).to(torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_lm_batches(vocab: int, seq_len: int, global_batch: int,
                    seed: int = 0, *, device="cuda"):
    """``(dataset, at)``: ``at(step)`` is batch ``step``; restartable at
    any step."""
    ds = TokenDataset(vocab, seq_len, global_batch, seed,
                      device=str(resolve_device(device)))
    return ds, ds.batch
