"""Dtype policy: float32 on the accelerator, float64 (x64 enabled) for
reference-parity tests (the reference pipeline is f64 end-to-end —
pkpd/utils.py:2, run.py:8; SURVEY.md §7 'hard parts')."""

import jax
import jax.numpy as jnp


def default_float():
    return jnp.float64 if jax.config.read('jax_enable_x64') else jnp.float32
