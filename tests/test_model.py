"""Model family: forward shapes, BN state updates, gradient flow."""

import numpy as np

import jax
import jax.numpy as jnp

from occuseg.core import topology as T
from occuseg.models import LearningBWDenseUNet, ThreeVoxelKernel

from tests.utils import random_points

P_CAP = 512
NUM_PTS = 400


def _inputs(seed=0, levels=4):
    rng = np.random.default_rng(seed)
    pts = random_points(rng, NUM_PTS, extent=32, batch_size=2, pad_to=P_CAP)
    caps = tuple(max(P_CAP >> l, 64) for l in range(levels))
    spec = T.PlanSpec(caps=caps)
    plan = T.build_plan(jnp.asarray(pts), spec)
    feats = np.zeros((P_CAP, 3), np.float32)
    feats[:NUM_PTS] = rng.standard_normal((NUM_PTS, 3), dtype=np.float32)
    return plan, jnp.asarray(feats)


def test_flagship_forward():
    plan, feats = _inputs()
    model = LearningBWDenseUNet(n_planes=(8, 16, 24, 32), num_classes=20)
    variables = model.init(jax.random.PRNGKey(0), feats, plan, False)
    out, mutated = model.apply(variables, feats, plan, True,
                               mutable=["batch_stats"])
    assert out.semantics.shape == (P_CAP, 20)
    assert out.features.shape == (P_CAP, 8)
    assert out.embedding.shape == (P_CAP, 8)
    assert out.offset.shape == (P_CAP, 1)
    assert out.displacement.shape == (P_CAP, 3)
    assert out.bw.shape == (P_CAP, 2)
    assert out.occupancy.shape == (P_CAP, 1)
    for f in out:
        if f is not None:
            assert np.isfinite(np.asarray(f)).all()
    assert np.all(np.asarray(out.offset) >= 0)
    assert np.all(np.asarray(out.offset) <= 1)
    assert np.all(np.asarray(out.bw) >= 0)
    # BN batch_stats actually update in train mode
    flat_old = jax.tree_util.tree_leaves(variables["batch_stats"])
    flat_new = jax.tree_util.tree_leaves(mutated["batch_stats"])
    changed = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(flat_old, flat_new))
    assert changed


def test_eval_mode_deterministic():
    plan, feats = _inputs(1)
    model = ThreeVoxelKernel(n_planes=(8, 16, 24, 32))
    variables = model.init(jax.random.PRNGKey(1), feats, plan, False)
    o1 = model.apply(variables, feats, plan, False)
    o2 = model.apply(variables, feats, plan, False)
    np.testing.assert_array_equal(np.asarray(o1.semantics),
                                  np.asarray(o2.semantics))


def test_gradients_flow_through_model():
    plan, feats = _inputs(2)
    model = ThreeVoxelKernel(n_planes=(8, 16, 24, 32))
    variables = model.init(jax.random.PRNGKey(2), feats, plan, False)

    def loss_fn(params):
        out, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            feats, plan, True, mutable=["batch_stats"])
        return jnp.sum(out.semantics ** 2) + jnp.sum(out.embedding ** 2)

    grads = jax.grad(loss_fn)(variables["params"])
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(np.isfinite(np.asarray(g)).all() for g in leaves)
    # every deep UNet conv gets gradient signal
    total = sum(float(jnp.abs(g).sum()) for g in leaves)
    assert total > 0
    nonzero = sum(float(jnp.abs(g).sum()) > 0 for g in leaves)
    assert nonzero / len(leaves) > 0.9, f"{nonzero}/{len(leaves)} grads nonzero"


def test_dense_unet_bn_forward():
    """DenseUNet_BN (model.py:133-257): dense-skip decoder with gated
    cross-scale fusion; output at full resolution, width n_planes[0]."""
    from occuseg.core.sparse_tensor import SparseTensor
    from occuseg.models.occuseg import DenseUNet_BN

    plan, feats = _inputs(3)
    lvl0 = plan.levels[0]
    x = SparseTensor(features=jnp.asarray(np.asarray(feats)),
                     num_active=lvl0.num_active, level=0)
    # channel count must match n_planes[0] at input (reference feeds the
    # backbone's stem output)
    x = x.with_features(jnp.tile(x.features, (1, 3))[:, :8])
    model = DenseUNet_BN(n_planes=(8, 16, 24, 32), block_reps=1)
    variables = model.init(jax.random.PRNGKey(2), x, plan, False)
    out = model.apply(variables, x, plan, False)
    assert out.features.shape == (x.features.shape[0], 8)
    assert out.level == 0
    assert np.isfinite(np.asarray(out.features)).all()
    # train mode touches every BN's batch_stats
    out2, mut = model.apply(variables, x, plan, True,
                            mutable=["batch_stats"])
    assert np.isfinite(np.asarray(out2.features)).all()
