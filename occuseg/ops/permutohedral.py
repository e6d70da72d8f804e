"""Permutohedral-lattice submanifold convolution support.

The reference (`permutohedralSubmanifoldConvolution.py`,
`SCN/Metadata/PermutohedralSubmanifoldConvolutionRules.h`) runs a
submanifold convolution whose filter support is the d^2+d+1 nearest
lattice-neighbor offsets of the permutohedral (A_d) lattice instead of the
3^d cube. The user maps coordinates into lattice space with the inverse
basis first ("Use torch.mm(coordinates, a_inverse) ... before input goes
to SparseConvNet"); the rulebook generator then probes the offset table
with the same hash lookups as the cubic case.

Here the offset table is GENERATED from the documented derivation
(enumerate integer vectors in [-1,0,1]^d whose image under the basis has
norm <= 1, the derivation in the reference header's comment block) rather
than hard-coded, `build_level(offsets=...)` builds the neighbor map with
one batched searchsorted like the cubic path, and the ordinary
`gather_conv` consumes it — the filter count K is just 13 instead of 27.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def permutohedral_basis(dimension: int):
    """Lower-triangular basis `a` whose rows are unit vectors at 60
    degrees pairwise (the A_d simplex basis) and its inverse. Map
    coordinates into lattice space with `x @ a_inverse` (reference
    `permutohedral_basis`, `permutohedralSubmanifoldConvolution.py:14-27`:
    row i is built so <a_i, a_j> = 1/2 for j < i and |a_i| = 1)."""
    a = np.zeros((dimension, dimension))
    for i in range(dimension):
        for j in range(i):
            a[i, j] = (0.5 - a[i] @ a[j]) / a[j, j]
        a[i, i] = np.sqrt(1.0 - a[i] @ a[i])
    return a, np.linalg.inv(a)


@functools.lru_cache(maxsize=None)
def permutohedral_offsets(dimension: int) -> np.ndarray:
    """[d^2+d+1, d] integer lattice offsets whose embedded length is <= 1:
    the site itself plus its 2(d^2+d)/2 nearest lattice neighbors
    (generated per the derivation in
    `PermutohedralSubmanifoldConvolutionRules.h:10-31`)."""
    a, _ = permutohedral_basis(dimension)
    grid = np.stack(np.meshgrid(*([[-1, 0, 1]] * dimension),
                                indexing="ij"), axis=-1).reshape(-1, dimension)
    v = grid @ a
    keep = grid[(v * v).sum(axis=1) <= 1.0 + 0.01]
    # deterministic order: the zero offset first, then lexicographic
    order = np.lexsort(keep.T[::-1])
    keep = keep[order]
    zero = np.where((keep == 0).all(axis=1))[0][0]
    keep = np.concatenate([keep[zero:zero + 1], keep[:zero],
                           keep[zero + 1:]])
    assert keep.shape[0] == dimension ** 2 + dimension + 1
    return keep.astype(np.int32)


def embed_points(xyz: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Map float positions [P, d] into integer permutohedral-lattice
    coordinates (the pre-transform the reference asks callers to apply)."""
    d = xyz.shape[-1]
    _, ai = permutohedral_basis(d)
    return np.rint(np.asarray(xyz) * scale @ ai).astype(np.int32)
