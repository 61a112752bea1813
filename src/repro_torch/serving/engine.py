"""Batched serving engine, counterpart of ``repro/serving/engine.py``:
slot-based continuous batching over the port's ``prefill`` /
``decode_step``.

* ``n_slots`` concurrent sequences share one decode cache;
* each arriving request is prefilled alone and spliced into a free slot
  (its first token drawn through :meth:`ServingEngine._sample`;
  ``max_tokens``/EOS honoured at once);
* a tick decodes every active slot, in groups of equal position index:
  each group call runs the full batch, and the cache is merged by slot
  mask so that rows outside the group stay bit-identical;
* finished slots (EOS, ``max_tokens`` or ``max_len``) are freed and
  refilled (continuous batching);
* greedy or temperature sampling, from a :class:`torch.Generator` seeded
  by ``seed``.  The reference samples with ``jax.random``, so only greedy
  requests serve the same tokens in both packages.

Every architecture of ``repro_torch.configs`` serves: attention (a KV
cache), Mamba, mLSTM and sLSTM (recurrent states), MoE or the dense MLP.
On the card the sLSTM recurrence of every prefill and decode step runs
in kernel row 10, and with ``gather_impl="onehot"`` the embedding in
kernel row 9.  The splice writes into the cache in place.  One position
index per decode call is the reference's design; per-slot positions
would be a feature it lacks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..models.model import decode_step, init_cache, prefill

__all__ = ["Request", "ServingEngine"]


def _map_cache(fn, *trees):
    """``fn`` over the leaves of equally shaped nested dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_cache(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _masked_decode_step(params, cfg, cache, tokens, index, slot_mask):
    """One decode step whose cache writes land only on masked-in slots.

    The engine advances slots in groups of equal position index, but
    ``decode_step`` runs the full batch: without the mask every group
    call would also rewrite the cache rows of slots outside the group (an
    attention block's at the group's index, the wrong position; a
    recurrent state advanced by a token it never saw).  Every leaf has
    the slots on axis 1: the recurrent states (Mamba ``conv``/``h``,
    mLSTM, sLSTM; no time axis) and the KV leaves ``(n_periods, B, T, KV,
    hd)`` alike, so the merge takes whole rows; rows outside the group
    stay bit-identical.
    """
    logits, new_cache = decode_step(params, cfg, cache, tokens, index)

    def merge(old, new):
        m = slot_mask.reshape((1, slot_mask.shape[0])
                              + (1,) * (new.ndim - 2))
        return torch.where(m, new, old)

    return logits, _map_cache(merge, cache, new_cache)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_tokens: int = 32
    temperature: float = 0.0
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Continuous batching of :class:`Request` s over ``params`` (a
    :class:`repro_torch.models.GenericLM` on ``device``, the card by
    default)."""

    def __init__(self, cfg, params, *, n_slots: int = 8,
                 max_len: int = 512, eos_id: int | None = None,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"the model lies on {params.device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.cache = init_cache(cfg, n_slots, max_len, device=self.device)
        self.index = np.zeros(n_slots, np.int32)      # per-slot position
        self.slot_req: list[Request | None] = [None] * n_slots
        self.queue: list[Request] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _free_slots(self):
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self):
        """Prefill queued requests into free slots (one at a time).

        The first token is drawn through ``_sample``, and
        ``max_tokens``/EOS are honoured at once: a ``max_tokens=1``
        request retires here without occupying a decode slot.
        """
        for slot in self._free_slots():
            while self.queue:
                req = self.queue.pop(0)
                toks = torch.as_tensor(np.asarray(req.prompt),
                                       dtype=torch.int64,
                                       device=self.device)[None, :]
                logits, cache1 = prefill(self.params, self.cfg,
                                         {"tokens": toks},
                                         max_len=self.max_len)

                def splice(full, one, slot=slot):
                    full[:, slot] = one[:, 0]

                _map_cache(splice, self.cache, cache1)
                self.index[slot] = len(req.prompt)
                tok = int(self._sample(
                    logits[:, -1].float(),
                    torch.tensor([req.temperature], dtype=torch.float32,
                                 device=self.device))[0])
                req.out_tokens.append(tok)
                if (self.eos_id is not None and tok == self.eos_id) \
                        or len(req.out_tokens) >= req.max_tokens:
                    req.done = True
                    continue        # slot still free: admit the next one
                self.slot_req[slot] = req
                break

    # ------------------------------------------------------------------
    def _sample(self, logits: torch.Tensor,
                temps: torch.Tensor) -> torch.Tensor:
        """Greedy where ``temps`` is 0, else a draw from
        ``softmax(logits / temp)`` by the Gumbel-max rule (as
        ``jax.random.categorical``), from the engine's generator."""
        greedy = torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=self.generator,
                       dtype=torch.float32, device=logits.device)
        gumbel = -torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny)))
        sampled = torch.argmax(
            logits / torch.clamp_min(temps[:, None], 1e-6) + gumbel, dim=-1)
        return torch.where(temps > 0, sampled, greedy)

    def step(self) -> bool:
        """One engine tick: admit, decode every active slot, retire."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        last = np.zeros((self.n_slots, 1), np.int64)
        temps = np.zeros((self.n_slots,), np.float32)
        for i in active:
            req = self.slot_req[i]
            last[i, 0] = req.out_tokens[-1]
            temps[i] = req.temperature
        tokens = torch.as_tensor(last, device=self.device)
        temps_t = torch.as_tensor(temps, device=self.device)
        # Slots share one position index per decode call, so slots are
        # stepped in groups of equal index, each call masked to its group.
        by_index: dict[int, list[int]] = {}
        for i in active:
            by_index.setdefault(int(self.index[i]), []).append(i)
        for idx in sorted(by_index):
            slot_mask = np.zeros((self.n_slots,), bool)
            slot_mask[by_index[idx]] = True
            logits, self.cache = _masked_decode_step(
                self.params, self.cfg, self.cache, tokens, idx,
                torch.as_tensor(slot_mask, device=self.device))
            toks = self._sample(logits[:, -1].float(), temps_t).cpu().numpy()
            for i in by_index[idx]:
                req = self.slot_req[i]
                tok = int(toks[i])
                req.out_tokens.append(tok)
                self.index[i] += 1
                if (self.eos_id is not None and tok == self.eos_id) \
                        or len(req.out_tokens) >= req.max_tokens \
                        or self.index[i] >= self.max_len - 1:
                    req.done = True
                    self.slot_req[i] = None
        return True

    def run_until_done(self, max_ticks: int = 10_000) -> int:
        ticks = 0
        while (self.queue or any(self.slot_req)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks
