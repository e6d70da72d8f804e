"""SparseTensor — the framework's tensor abstraction.

The analog of the reference's `SparseConvNetTensor`
(`sparseconvnet/sparseConvNetTensor.py:67-121`): there, a tensor is
`{features, metadata (opaque mutable C++ handle), spatial_size}`. Here it is a
pure pytree — features over a statically-padded row axis plus the integer id
of the topology level it lives at. All coordinate/rulebook state lives in a
separate immutable `Topology` plan (see `core/topology.py`), so jitted
functions close over structure instead of mutating shared host state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def active_mask(num_active: jnp.ndarray, cap: int) -> jnp.ndarray:
    """Bool [cap] active-row mask for either row layout.

    `num_active` is a scalar count (active rows are the prefix [0, n)) or
    an [ns] vector of per-scene counts under the BLOCKED batch layout
    (`native/blocked.py`): scene s owns rows [s*(cap//ns), s*(cap//ns)+n_s),
    each scene padded to its own static sub-cap so staging gathers stay at
    single-scene table footprints (PERF.md batch-4 breakdown)."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (cap, 1), 0)[:, 0]
    if jnp.ndim(num_active) == 0:
        return rows < num_active
    ns = num_active.shape[0]
    assert cap % ns == 0, (
        f"blocked layout requires cap ({cap}) to be a multiple of the "
        f"scene count ({ns}); with a remainder, tail rows would be "
        f"silently masked by the last scene's count")
    sc = cap // ns
    return rows % sc < num_active[rows // sc]


def total_active(num_active: jnp.ndarray) -> jnp.ndarray:
    """Scalar count of real rows for either num_active layout."""
    return num_active if jnp.ndim(num_active) == 0 else jnp.sum(num_active)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """Features over the active sites of one topology level.

    Attributes:
      features:   [N_cap, C] float array. Rows >= num_active are zero.
      num_active: int32 scalar — count of real (non-padding) rows — or an
                  [ns] vector of per-scene counts (blocked batch layout,
                  see `active_mask`).
      level:      static int — index into the Topology plan's levels.
    """

    features: jnp.ndarray
    num_active: jnp.ndarray
    level: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def cap(self) -> int:
        return self.features.shape[0]

    @property
    def num_channels(self) -> int:
        return self.features.shape[-1]

    def mask(self) -> jnp.ndarray:
        """Bool [N_cap] — True for real rows."""
        return active_mask(self.num_active, self.cap)

    def with_features(self, features: jnp.ndarray) -> "SparseTensor":
        return dataclasses.replace(self, features=features)

    def zero_padding(self) -> "SparseTensor":
        """Force padding rows to zero (cheap; use after ops that may smear)."""
        f = jnp.where(self.mask()[:, None], self.features, 0)
        return self.with_features(f)


def concat_features(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    """Channel concat of two tensors on the same level (JoinTable analog,
    reference `sparseconvnet/tables.py:28-43`)."""
    assert a.level == b.level, "JoinTable requires same topology level"
    return a.with_features(jnp.concatenate([a.features, b.features], axis=-1))


def add_features(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    """Elementwise add (AddTable analog, reference `tables.py:45-55`)."""
    assert a.level == b.level, "AddTable requires same topology level"
    return a.with_features(a.features + b.features)
