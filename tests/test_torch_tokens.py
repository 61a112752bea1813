"""The port's synthetic token stream (``repro_torch.data.tokens``): a
function of ``(seed, step)`` on one device, learnable.  Its draws are
PyTorch's, not ``jax.random``'s, so the reference's tokens are not
reproduced: the training parity tests carry numpy batches over instead.
The stream keeps the reference's structure: its shapes and dtypes, the
labels the tokens shifted by one, and a hidden Markov chain of 64
states."""

import dataclasses

import pytest
import torch

from repro.data.tokens import TokenDataset as RefDataset
from repro_torch.configs import ARCHS
from repro_torch.data import TokenDataset, make_lm_batches
from repro_torch.models import init_model
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  make_eval_step, make_train_step)


def test_batches_are_addressed_by_step():
    ds = TokenDataset(vocab=97, seq_len=12, global_batch=3, seed=5,
                      device="cpu")
    a, b = ds.batch(4), ds.batch(9)
    again = TokenDataset(vocab=97, seq_len=12, global_batch=3, seed=5,
                         device="cpu").batch(4)
    assert torch.equal(a["tokens"], again["tokens"])
    assert torch.equal(a["labels"], again["labels"])
    assert not torch.equal(a["tokens"], b["tokens"])
    other = TokenDataset(vocab=97, seq_len=12, global_batch=3, seed=6,
                         device="cpu").batch(4)
    assert not torch.equal(a["tokens"], other["tokens"])
    # Addressed, not sequential: a batch does not depend on the ones
    # drawn before it.
    assert torch.equal(ds.batch(4)["tokens"], a["tokens"])


def test_stream_keeps_the_reference_structure():
    ref = RefDataset(vocab=97, seq_len=12, global_batch=3).batch(0)
    ds = TokenDataset(vocab=97, seq_len=12, global_batch=3, device="cpu")
    got = ds.batch(0)
    assert ds.n_states == RefDataset(97, 12, 3).n_states == 64
    for k in ("tokens", "labels"):
        assert tuple(got[k].shape) == tuple(ref[k].shape) == (3, 12)
        assert got[k].dtype == torch.int32
        assert int(got[k].min()) >= 0 and int(got[k].max()) < 97
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_make_lm_batches_restarts_anywhere():
    ds, at = make_lm_batches(50, 8, 2, seed=1, device="cpu")
    assert isinstance(ds, TokenDataset)
    assert torch.equal(at(3)["tokens"], ds.batch(3)["tokens"])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        TokenDataset(vocab=10, seq_len=4, global_batch=1).batch(0)


def test_reduced_model_learns_the_stream():
    """chatglm3-6b reduced (vocab 256, as the launcher's ``--reduced``)
    trained 40 steps at lr 3e-3: the held-out loss of a fixed batch
    falls well below its start."""
    cfg = dataclasses.replace(ARCHS["chatglm3-6b"].reduced(), vocab=256)
    ds = TokenDataset(vocab=cfg.vocab, seq_len=32, global_batch=4,
                      device="cpu")
    model = init_model(cfg, seed=0, device="cpu")
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40)
    opt = init_opt_state(model, ocfg)
    step = make_train_step(cfg, ocfg)
    held_out = ds.batch(10_000)
    evaluate = make_eval_step(cfg)
    before = float(evaluate(model, held_out)["loss"])
    for i in range(40):
        model, opt, _ = step(model, opt, ds.batch(i))
    after = float(evaluate(model, held_out)["loss"])
    assert after < before - 1.0, (before, after)
