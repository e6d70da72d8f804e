"""Normal-guided (rotation-invariant) filter support.

The reference rotates each output site's 3^3 filter so its principal axis
aligns with the voxel normal's dominant axis: `OrientedFilter(normal)`
selects an orientation class in {0,2,4} (`RectangularRegions.h:12-31`), and
rulebook entries are remapped through a fixed 6x27 permutation table
(`SubmanifoldConvolutionRules.h:161-167` / `:218-245`,
`remap_rules_with_normal`). Here the same effect is a per-row permutation of
the neighbor map's offset axis, after which the standard gather-matmul
applies unchanged.

The permutation constants below are the reference's table verbatim (they
are the rotation group elements mapping the filter cube between dominant
axes — required bit-for-bit for checkpoint parity).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# [6, 27]: row o maps old offset index k -> weight index under orientation o
# (reference SubmanifoldConvolutionRules.h:161-167; rows 0/2/4 are the ones
# OrientedFilter can return).
ORIENT_PERM = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
     20, 21, 22, 23, 24, 25, 26],
    [24, 25, 26, 21, 22, 23, 18, 19, 20, 15, 16, 17, 12, 13, 14, 9, 10, 11,
     6, 7, 8, 3, 4, 5, 0, 1, 2],
    [6, 7, 8, 15, 16, 17, 24, 25, 26, 3, 4, 5, 12, 13, 14, 21, 22, 23, 0, 1,
     2, 9, 10, 11, 18, 19, 20],
    [18, 19, 20, 9, 10, 11, 0, 1, 2, 21, 22, 23, 12, 13, 14, 3, 4, 5, 24,
     25, 26, 15, 16, 17, 6, 7, 8],
    [2, 11, 20, 5, 14, 23, 8, 17, 26, 1, 10, 19, 4, 13, 22, 7, 16, 25, 0, 9,
     18, 3, 12, 21, 6, 15, 24],
    [18, 9, 0, 21, 12, 3, 24, 15, 6, 19, 10, 1, 22, 13, 4, 25, 16, 7, 20,
     11, 2, 23, 14, 5, 26, 17, 8],
], np.int32)

# inverse permutations: nbr'[r, j] = nbr[r, ORIENT_PERM_INV[o_r, j]]
ORIENT_PERM_INV = np.zeros_like(ORIENT_PERM)
for _o in range(6):
    ORIENT_PERM_INV[_o, ORIENT_PERM[_o]] = np.arange(27)


def oriented_filter(normals: jnp.ndarray) -> jnp.ndarray:
    """Per-site orientation class {0, 2, 4} from normals [N,3] (x,y,z)
    (reference `OrientedFilter`, `RectangularRegions.h:12-31`)."""
    a = jnp.abs(normals)
    x, y, z = a[:, 0], a[:, 1], a[:, 2]
    face = jnp.where((x >= y) & (x >= z), 0,
                     jnp.where((y >= x) & (y >= z), 2, 4))
    return face.astype(jnp.int32)


def permute_neighbor_map(nbr: jnp.ndarray, orient: jnp.ndarray
                         ) -> jnp.ndarray:
    """nbr'[r, j] = nbr[r, perm_inv[orient_r, j]] so that
    sum_j feats[nbr'[r,j]] @ W[j] applies the rotated filter."""
    perm_inv = jnp.asarray(ORIENT_PERM_INV)
    sel = perm_inv[orient]  # [N, 27]
    return jnp.take_along_axis(nbr, sel, axis=1)


def normal_guided_conv(feats: jnp.ndarray, nbr: jnp.ndarray,
                       orient: jnp.ndarray, weight: jnp.ndarray,
                       bias: jnp.ndarray | None = None) -> jnp.ndarray:
    """Submanifold conv with per-site rotated filters.

    Uses plain autodiff under jax.checkpoint (the per-row permutation has no
    clean transpose map, so the scatter-free backward does not apply; remat
    keeps the 27x gather residuals from materializing).
    """
    from occuseg.ops.conv import _gather_conv_fwd_impl

    nbr_p = permute_neighbor_map(nbr, orient)
    out = jax.checkpoint(
        lambda f, w: _gather_conv_fwd_impl(f, nbr_p, w))(feats, weight)
    if bias is not None:
        out = out + bias.astype(out.dtype)
    return out
