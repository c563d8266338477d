"""Mesh / sharding helpers: 1-D batch data parallelism.

The reference's cross-device story is `jax.pmap` over CPU host devices
spoofed via XLA_FLAGS, with a manual shard-and-pad hack
(run.py:5-7, sindy.py:668-699,810-841).  Replacement: a 1-D
`jax.sharding.Mesh` on the batch axis + `NamedSharding` annotations; XLA
GSPMD partitions the already-`vmap`-ed programs (simulation, rollout,
INSITE fine-tune) with zero code change to the math.  The mesh follows the
algorithm alone: on cards joined all to all by NVLink every device reaches
every other at the same rate, and the only collective is the all-reduce of
cross-row sums such as the STLSQ gram (see `row_mask`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def batch_mesh(devices=None, axis_name: str = 'batch') -> Mesh:
    """1-D mesh over all (or given) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis_name,))


def pad_rows(x, multiple: int):
    """Pad the leading axis up to a multiple by repeating the last row
    (values are discarded by unpad_rows; repeated rows keep numerics sane,
    replacing the reference's repeat_last_row hack at sindy.py:819-841)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = jnp.repeat(x[-1:], rem, axis=0)
    return jnp.concatenate([x, pad], axis=0)


def unpad_rows(x, n: int):
    return x[:n]


def row_mask(n: int, mesh: Mesh, axis_name: str = 'batch'):
    """Sharded 0/1 validity mask for rows padded by shard_rows: 1.0 for the
    first n (real) rows, 0.0 for padding.  Use as the sample weight of any
    cross-row reduction (e.g. the STLSQ gram accumulation) so padded rows
    contribute nothing."""
    n_dev = mesh.devices.size
    total = n + ((-n) % n_dev)
    mask = (jnp.arange(total) < n).astype(jnp.float32)
    return jax.device_put(mask, NamedSharding(mesh, P(axis_name)))


def shard_rows(tree, mesh: Mesh, axis_name: str = 'batch'):
    """Pad every leaf's leading axis to the mesh size and place it with a
    batch-axis NamedSharding; returns (sharded tree, original row count)."""
    n_dev = mesh.devices.size
    leaves = jax.tree_util.tree_leaves(tree)
    n = leaves[0].shape[0]

    def place(x):
        x = pad_rows(jnp.asarray(x), n_dev)
        spec = P(axis_name, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(place, tree), n
