"""How far a prefill's decode cache moves with the sLSTM recurrence's
error, for xlstm-125m at full width on one CUDA card.

    python3 tools/prefill_cache_sweep.py [--prompts N]

For the first ``N`` prompts of ``chip_smoke.py``'s phase 11 (default 2)
and the model in bfloat16 and in float32 (seeded weights on the card),
it prefills on the plain versions and compares with the same prefill on
the kernels and on the plain versions with the recurrence changed: its
h off by the factor ``1 + eps`` (``chip_smoke.faulty_recurrence``) for
eps from 1e-7 to 1e-1, and its state rounded to bfloat16 after every
step.  Prints, for each, the whole cache's ``max |d| / (1 + |ref|)``
(``chip_smoke.cache_err``, the measure of phase 11's cache bound), the
leaf where it is largest, and the logits' max |d|.  This is what
``chip_smoke.LM_CACHE_TOL`` and ``LM_CACHE_FAULT`` were set from.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import numpy as np
import torch

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def bf16_state_recurrence(zifo, r, state):
    """The plain recurrence with its state rounded to bfloat16 after
    every step."""
    from repro_torch.kernels.slstm_ref import slstm_cell_ref

    hs = []
    for t in range(zifo.shape[1]):
        state = slstm_cell_ref(zifo[:, t], r, state).bfloat16().float()
        hs.append(state[2])
    return torch.stack(hs, 1), state


def worst_leaf(got: dict, want: dict) -> str:
    errs = {f"{n}.{k}": float(((a - b).abs() / (1 + b.abs())).max())
            for n in got["blocks"] for (k, a), b in
            zip(got["blocks"][n].items(), want["blocks"][n].values())}
    return max(errs, key=errs.get)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompts", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    import repro_torch.kernels.gather_kernel_ops as gops
    import repro_torch.kernels.slstm_ops as sops
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.gather_ref import gather_ref
    from repro_torch.kernels.slstm_ref import slstm_recurrence_ref
    from repro_torch.models import init_model, prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    dev = torch.device("cuda", 0)
    cfg0 = ARCHS[cs.LM_ARCH]
    rng = np.random.default_rng(cs.SEED)
    lengths = rng.integers(cs.LM_PROMPT[0], cs.LM_PROMPT[1] + 1,
                           cs.LM_REQUESTS)
    prompts = [rng.integers(0, cfg0.vocab, int(n)) for n in lengths]
    variants = [("kernels", None)] + [
        (f"h off by {eps:g}", cs.faulty_recurrence(eps))
        for eps in (1e-7, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)] + [
        ("bf16 state", bf16_state_recurrence)]
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(cfg0, param_dtype=dtype,
                                  gather_impl="onehot")
        model = init_model(cfg, seed=cs.SEED, device=dev)
        for p in prompts[:args.prompts]:
            toks = torch.as_tensor(p, device=dev)[None]

            def run(fn):
                if fn is None:
                    return prefill(model, cfg, {"tokens": toks},
                                   cs.LM_MAX_LEN)
                with cs.patched(sops, "launch_slstm", fn), \
                        cs.patched(gops, "launch_onehot_gather", gather_ref):
                    return prefill(model, cfg, {"tokens": toks},
                                   cs.LM_MAX_LEN)

            lp, cp = run(slstm_recurrence_ref)
            for name, fn in variants:
                lg, cg = run(fn)
                print(f"{dtype} prompt of {toks.shape[1]} tokens, {name}: "
                      f"cache max |d|/(1+|ref|) {cs.cache_err(cg, cp):.3e} "
                      f"(at {worst_leaf(cg, cp)}), logits max|d| "
                      f"{float((lg - lp).abs().max()):.3e} of "
                      f"{float(lp.abs().max()):.2f}", flush=True)
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
