"""Masking utilities for ragged, fixed-shape sequence batches.

XLA programs are static-shape; variable-length trajectories are represented as
fixed-width arrays plus `sequence_lengths` / `active_entries` masks
(reference: pkpd/dataset.py:159-168, pkpd/utils.py:367-370).
"""

from __future__ import annotations

import jax.numpy as jnp


def prefix_mask(length: int, n, dtype=jnp.float32):
    """``[1]*n + [0]*(length-n)`` — the reference ``create_mask``
    (pkpd/utils.py:367-370).  ``n`` may be a traced scalar or a batch of
    scalars (mask is then batched on the leading axis)."""
    idx = jnp.arange(length)
    n = jnp.asarray(n)
    return (idx < n[..., None] if n.ndim else idx < n).astype(dtype)


def length_mask(lengths, max_length: int, dtype=jnp.float32):
    """Batched active-entries mask: shape ``[B, max_length]`` with row ``i``
    having ``lengths[i]`` ones."""
    idx = jnp.arange(max_length)
    return (idx[None, :] < jnp.asarray(lengths)[:, None]).astype(dtype)
