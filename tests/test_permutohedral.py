"""Permutohedral-lattice submanifold convolution (reference
`permutohedralSubmanifoldConvolution.py`,
`PermutohedralSubmanifoldConvolutionRules.h`)."""

import numpy as np

import jax
import jax.numpy as jnp

from occuseg.core import topology as T
from occuseg.core.sparse_tensor import SparseTensor
from occuseg.nn.extras import PermutohedralSubmanifoldConvolution
from occuseg.ops.permutohedral import (
    embed_points,
    permutohedral_basis,
    permutohedral_offsets,
)

from tests.utils import random_points


def test_basis_properties():
    for d in (2, 3, 4):
        a, ai = permutohedral_basis(d)
        g = a @ a.T
        assert np.allclose(np.diag(g), 1.0)
        off = g[~np.eye(d, dtype=bool)]
        assert np.allclose(off, 0.5)  # 60-degree basis
        assert np.allclose(a @ ai, np.eye(d), atol=1e-12)


def test_offset_set_matches_reference_table():
    # the 13 offsets listed at PermutohedralSubmanifoldConvolutionRules.h:38-51
    ref = {(0, 0, 0), (0, 0, -1), (1, 0, -1), (0, 1, -1), (0, -1, 0),
           (1, -1, 0), (-1, 0, 0), (1, 0, 0), (-1, 1, 0), (0, 1, 0),
           (0, -1, 1), (-1, 0, 1), (0, 0, 1)}
    got = set(map(tuple, permutohedral_offsets(3).tolist()))
    assert got == ref
    assert permutohedral_offsets(2).shape == (7, 2)
    assert permutohedral_offsets(4).shape == (21, 4)


def test_permutohedral_conv_matches_oracle():
    rng = np.random.default_rng(3)
    cap = 256
    raw = rng.standard_normal((150, 3)) * 4
    lattice = embed_points(raw, scale=1.0)
    pts = np.concatenate([np.zeros((150, 1), np.int32), lattice], axis=1)
    pts = np.concatenate(
        [pts, -np.ones((cap - 150, 4), np.int32)]).astype(np.int32)
    spec = T.PlanSpec(caps=(cap,), lattice="permutohedral")
    plan = T.build_plan(jnp.asarray(pts), spec)
    lvl = plan.levels[0]
    n = int(lvl.num_active)
    K = int(lvl.nbr.shape[1])
    assert K == 13

    cin, cout = 4, 6
    feats = np.zeros((cap, cin), np.float32)
    feats[:n] = rng.standard_normal((n, cin), dtype=np.float32)
    x = SparseTensor(features=jnp.asarray(feats), num_active=lvl.num_active,
                     level=0)
    model = PermutohedralSubmanifoldConvolution(cout)
    variables = model.init(jax.random.PRNGKey(0), x, plan, False)
    out = np.asarray(model.apply(variables, x, plan, False).features)

    # oracle: explicit gather over the 13 lattice offsets
    w = np.asarray(variables["params"]["weight"], np.float64)
    coords = np.asarray(lvl.coords)
    active = {tuple(coords[r]): r for r in range(n)}
    offs = permutohedral_offsets(3)
    want = np.zeros((n, cout))
    for r in range(n):
        for k in range(13):
            nb = (coords[r][0], *(coords[r][1:] + offs[k]))
            if nb in active:
                want[r] += feats[active[nb]].astype(np.float64) @ w[k]
    np.testing.assert_allclose(out[:n], want, rtol=1e-4, atol=1e-5)
