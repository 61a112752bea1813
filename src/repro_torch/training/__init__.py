"""Training (counterpart of ``repro.training``): AdamW, the train step,
the cosine schedule."""

from .optim import (AdamWConfig, adamw_update, cosine_schedule,  # noqa: F401
                    global_norm, init_opt_state, opt_state_specs)
from .train import make_eval_step, make_train_step  # noqa: F401
