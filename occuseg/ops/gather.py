"""Safe padded row-gather shared by all sparse ops.

jnp.take(mode='fill') wraps negative indices rather than filling, so the framework-wide '-1 = missing' sentinel is remapped to
a huge positive (guaranteed out-of-bounds) index first.
"""

from __future__ import annotations

import jax.numpy as jnp


def gather_rows(feats: jnp.ndarray, idx: jnp.ndarray,
                fill_value=0) -> jnp.ndarray:
    idx = jnp.where(idx < 0, jnp.iinfo(idx.dtype).max, idx)
    return jnp.take(feats, idx, axis=0, mode="fill", fill_value=fill_value,
                    unique_indices=False, indices_are_sorted=False)
