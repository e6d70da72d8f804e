"""Sorted point layout (core/point_layout.py).

The layout must be a pure permutation of the batch (training semantics are
order-invariant) that leaves p2v non-decreasing with the padding last, and
voxelize/devoxelize over it — with or without telling the segment sum that
its ids are sorted — must equal the plain segment ops in f32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from occuseg.core.point_layout import (
    apply_point_layout, augment_plan_with_point_layout, build_point_layout,
)
from occuseg.core.topology import PlanSpec
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.native.plan import build_plan_host
from occuseg.ops import pool as pool_ops

CAPS = (12_288, 8_192, 4_096, 2_048, 1_024, 512)
P_CAP = 24_576


@pytest.fixture(scope="module")
def setup():
    batch = make_batch(SceneConfig(num_points=12_000, extent=128,
                                   num_objects=8),
                       num_scenes=1, p_cap=P_CAP, num_instances=16, seed=3)
    plan = build_plan_host(batch["coords"], PlanSpec(caps=CAPS))
    if plan is None:
        pytest.skip("native plan builder unavailable")
    return batch, plan


def test_layout_invariants(setup):
    batch, plan = setup
    p2v = np.asarray(plan.p2v)
    lay = build_point_layout(p2v, CAPS[0])
    perm = lay["perm"]
    # a permutation: every valid point appears exactly once, pads last
    valid = np.nonzero(p2v >= 0)[0]
    n = valid.size
    assert sorted(perm[:n]) == sorted(valid) and np.all(perm[n:] == -1)
    # the permuted p2v is the old one read through perm, sorted, -1 last
    new = lay["p2v"]
    assert np.array_equal(new[:n], p2v[perm[:n]])
    assert np.all(np.diff(new[:n]) >= 0) and np.all(new[n:] == -1)
    # counts match a bincount of the original p2v
    ref = np.bincount(p2v[valid], minlength=CAPS[0])[:CAPS[0]]
    assert np.array_equal(lay["counts"], ref.astype(np.float32))


@pytest.mark.parametrize("sorted_ids", [False, True])
def test_kernel_equals_segment_sum(setup, sorted_ids):
    batch, plan = setup
    lay = build_point_layout(np.asarray(plan.p2v), CAPS[0])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((P_CAP, 64)).astype(np.float32)
    got = np.asarray(pool_ops.voxelize_features(
        jnp.asarray(x), jnp.asarray(lay["p2v"]), CAPS[0], mode="sum",
        indices_are_sorted=sorted_ids))
    p2v = lay["p2v"]
    seg = np.where(p2v >= 0, p2v, CAPS[0])
    ref = np.zeros((CAPS[0] + 1, 64), np.float32)
    np.add.at(ref, seg, x)
    np.testing.assert_allclose(got, ref[:CAPS[0]], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sorted_ids", [False, True])
def test_module_paths_agree(setup, sorted_ids):
    """voxelize/devoxelize (values AND gradients) agree between the
    original point order and the sorted layout."""
    batch, plan = setup
    plan2 = augment_plan_with_point_layout(plan)
    assert plan2.vox_counts is not None
    batch2 = apply_point_layout(batch, plan2)

    feats = jnp.asarray(batch["features"])
    feats2 = jnp.asarray(batch2["features"])

    v_ref = pool_ops.voxelize_features(feats, jnp.asarray(plan.p2v),
                                       CAPS[0], mode="mean")
    v_new = pool_ops.voxelize_features(
        feats2, jnp.asarray(plan2.p2v), CAPS[0], mode="mean",
        vox_counts=jnp.asarray(plan2.vox_counts),
        indices_are_sorted=sorted_ids)
    np.testing.assert_allclose(np.asarray(v_new), np.asarray(v_ref),
                               rtol=1e-5, atol=1e-5)

    # devoxelize gradient: d_voxels must match the scatter-add of d_points
    vfeats = jnp.asarray(
        np.random.default_rng(1).standard_normal((CAPS[0], 32)), jnp.float32)

    def loss_new(v):
        pts = pool_ops.devoxelize_features(v, jnp.asarray(plan2.p2v))
        w = jnp.asarray(batch2["features"][:, :1])
        return jnp.sum(pts * pts * w)

    def loss_ref(v):
        pts = pool_ops.devoxelize_features(v, jnp.asarray(plan.p2v))
        w = jnp.asarray(batch["features"][:, :1])
        return jnp.sum(pts * pts * w)

    g_new = jax.grad(loss_new)(vfeats)
    g_ref = jax.grad(loss_ref)(vfeats)
    np.testing.assert_allclose(np.asarray(g_new), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-4)


def test_losses_order_invariant(setup):
    """The 6-term loss is identical on the permuted batch (the layout is a
    pure relabeling of point rows; every term is a segment reduction)."""
    import types

    from occuseg.losses.instance import occuseg_total_loss

    batch, plan = setup
    plan2 = augment_plan_with_point_layout(plan)
    batch2 = apply_point_layout(batch, plan2)
    perm = np.asarray(plan2.point_perm)
    rng = np.random.default_rng(7)
    P = P_CAP

    def head(shape):
        return rng.standard_normal(shape).astype(np.float32)

    outs = dict(semantics=head((P, 20)), embedding=head((P, 8)),
                offset=head((P, 1)), displacement=head((P, 3)),
                occupancy=head((P, 1)), bw=head((P, 2)))

    def permuted(a):
        pad = perm < 0
        out = a[np.maximum(perm, 0)]
        out[pad] = 0
        return out

    o1 = types.SimpleNamespace(**{k: jnp.asarray(v)
                                  for k, v in outs.items()})
    o2 = types.SimpleNamespace(**{k: jnp.asarray(permuted(v))
                                  for k, v in outs.items()})
    b1 = {k: jnp.asarray(v) for k, v in batch.items()}
    b2 = {k: jnp.asarray(v) for k, v in batch2.items()}
    l1, parts1 = occuseg_total_loss(o1, b1, 1, 16)
    l2, parts2 = occuseg_total_loss(o2, b2, 1, 16)
    for k in parts1:
        np.testing.assert_allclose(np.asarray(parts2[k]),
                                   np.asarray(parts1[k]), rtol=2e-4,
                                   atol=2e-5, err_msg=k)


def test_no_fit_fallback():
    """Dropped points (-1) go after every kept point, in their old order,
    and an all-dropped batch is all padding."""
    p2v = np.asarray([3, -1, 0, 3, -1, 1], np.int32)
    lay = build_point_layout(p2v, 4)
    assert lay["perm"].tolist() == [2, 5, 0, 3, -1, -1]
    assert lay["p2v"].tolist() == [0, 1, 3, 3, -1, -1]
    assert lay["counts"].tolist() == [1, 1, 0, 2]
    empty = build_point_layout(np.full(5, -1, np.int32), 4)
    assert np.all(empty["perm"] == -1) and np.all(empty["p2v"] == -1)
