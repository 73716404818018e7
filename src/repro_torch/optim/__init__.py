"""Optimizers (port of ``repro.optim``)."""

from .adamw import (AdamWConfig, adamw_apply, adamw_init, global_norm,
                    lr_at_step, opt_state_specs)

__all__ = ["AdamWConfig", "adamw_apply", "adamw_init", "global_norm",
           "lr_at_step", "opt_state_specs"]
