"""Extras modules + alternative losses."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from occuseg.core import topology as T
from occuseg.core.sparse_tensor import SparseTensor
from occuseg.losses.semantic import (
    focal_loss,
    lovasz_softmax,
    weighted_cross_entropy,
)
from occuseg.nn import extras

from tests.utils import random_points

CAP = 256


def _tensor(seed=0, cin=4):
    rng = np.random.default_rng(seed)
    pts = random_points(rng, 200, extent=8, batch_size=2, pad_to=CAP)
    spec = T.PlanSpec(caps=(CAP, 128))
    plan = T.build_plan(jnp.asarray(pts), spec)
    n = int(plan.levels[0].num_active)
    f = np.zeros((CAP, cin), np.float32)
    f[:n] = rng.standard_normal((n, cin), dtype=np.float32)
    x = SparseTensor(features=jnp.asarray(f), num_active=plan.levels[0].num_active,
                     level=0)
    return rng, plan, x, n


def test_activations_and_dropout():
    rng, plan, x, n = _tensor()
    relu = extras.ReLU()
    out = relu.apply({}, x, plan)
    assert np.all(np.asarray(out.features) >= 0)
    drop = extras.Dropout(p=0.5)
    out2 = drop.apply({}, x, plan, True, rngs={"dropout": jax.random.PRNGKey(0)})
    kept = np.asarray(out2.features) != 0
    frac = kept[:n].mean()
    assert 0.3 < frac < 0.7


def test_shape_context_channels():
    rng, plan, x, n = _tensor(1)
    sc = extras.ShapeContext()
    out = sc.apply({}, x, plan)
    assert out.features.shape == (CAP, 27 * 4)


def test_active_pooling_shape():
    rng, plan, x, n = _tensor(2)
    ap = extras.ActivePooling(num_samples=2)
    out = ap.apply({}, x, plan)
    assert out.shape == (2, 4)
    assert np.isfinite(np.asarray(out)).all()


def test_sparse_to_dense_roundtrip():
    rng, plan, x, n = _tensor(3)
    dense = extras.sparse_to_dense(x, plan, spatial_size=8, batch_size=2)
    assert dense.shape == (2, 8, 8, 8, 4)
    coords = np.asarray(plan.levels[0].coords)
    f = np.asarray(x.features)
    d = np.asarray(dense)
    for r in range(0, n, 7):
        b, z, y, xx = coords[r]
        np.testing.assert_allclose(d[b, z, y, xx], f[r], rtol=1e-6)
    mask = extras.dense_to_sparse_coords(
        jnp.asarray((np.abs(d).sum(-1) > 0)), cap=CAP)
    got = {tuple(c) for c in np.asarray(mask) if c[0] >= 0}
    want = {tuple(coords[r]) for r in range(n)
            if np.abs(f[r]).sum() > 0}
    assert got == want


def test_upsample_feature_nearest_and_bilinear():
    rng, plan, x, n = _tensor(4)
    m = int(plan.levels[1].num_active)
    cf = np.zeros((128, 4), np.float32)
    cf[:m] = rng.standard_normal((m, 4), dtype=np.float32)
    lr = SparseTensor(features=jnp.asarray(cf),
                      num_active=plan.levels[1].num_active, level=1)
    up = extras.upsample_feature(lr, 0, plan, stride=2, bilinear=False)
    fc = np.asarray(plan.levels[0].coords)
    cc = np.asarray(plan.levels[1].coords)
    cvox = {tuple(cc[r]): r for r in range(m)}
    out = np.asarray(up.features)
    for r in range(n):
        b, z, y, xx = fc[r]
        j = cvox[(b, z // 2, y // 2, xx // 2)]
        np.testing.assert_allclose(out[r], cf[j], rtol=1e-6)
    up2 = extras.upsample_feature(lr, 0, plan, stride=2, bilinear=True)
    assert np.isfinite(np.asarray(up2.features)).all()


def test_compare_sparse_zero_for_identical():
    rng, plan, x, n = _tensor(5)
    d = extras.compare_sparse(plan, x, plan, x)
    assert float(d) < 1e-10
    y = x.with_features(x.features * 2)
    d2 = extras.compare_sparse(plan, x, plan, y)
    assert float(d2) > 0.1


def test_alternative_semantic_losses():
    rng = np.random.default_rng(6)
    logits = jnp.asarray(rng.standard_normal((100, 5)).astype(np.float32))
    labels = jnp.asarray(
        np.concatenate([rng.integers(0, 5, 90), -np.ones(10)]).astype(np.int32))
    for fn in (lovasz_softmax, focal_loss):
        v = fn(logits, labels)
        assert np.isfinite(float(v)) and float(v) >= 0
    w = jnp.ones((5,), jnp.float32)
    v = weighted_cross_entropy(logits, labels, w)
    assert np.isfinite(float(v))
    # perfect predictions -> near-zero losses
    perfect = jax.nn.one_hot(jnp.maximum(labels, 0), 5) * 20.0
    assert float(focal_loss(perfect, labels)) < 1e-6
    assert float(lovasz_softmax(perfect, labels)) < 1e-3
