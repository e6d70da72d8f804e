"""Blocked multi-scene batch layout (native/blocked.py).

Verifies the per-scene sub-cap row layout against the concatenated plan:
same topology per scene, same model outputs per POINT (point order is
layout-invariant), the sorted point layout over a blocked plan, and the
train-step losses match the concatenated layout.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from occuseg.core.topology import PlanSpec
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.native import _load
from occuseg.native.blocked import (
    blocked_scene_caps,
    build_plan_host_blocked,
)
from occuseg.native.plan import build_plan_host

pytestmark = pytest.mark.skipif(_load() is None,
                                reason="native library unavailable")

NS = 2
P_CAP = 4096
I_CAP = 16
CAPS = (2304, 2304, 1536, 1152)


def _batch(seed=7):
    # sparse enough that no level truncates in EITHER layout (truncation
    # points differ between the layouts by construction)
    cfg = SceneConfig(num_points=900, extent=64, num_objects=6)
    return make_batch(cfg, NS, P_CAP, I_CAP, seed=seed)


def _plans(batch):
    spec = PlanSpec(caps=CAPS)
    blocked = build_plan_host_blocked(batch["coords"], spec, NS)
    concat = build_plan_host(batch["coords"], spec)
    assert blocked is not None and concat is not None
    return blocked, concat


def test_scene_caps_alignment():
    assert blocked_scene_caps((2304, 1000), 2) == (1152, 768)
    assert blocked_scene_caps((384,), 4) == (384,)
    for c in blocked_scene_caps((786432, 300000, 100000), 4):
        assert c % 384 == 0


def test_blocked_plan_invariants():
    batch = _batch()
    blocked, concat = _plans(batch)
    scaps = blocked_scene_caps(CAPS, NS)
    coords = batch["coords"]
    # num_active: [ns] vector whose sum matches the concatenated count
    for li, lvl in enumerate(blocked.levels):
        n = np.asarray(lvl.num_active)
        assert n.shape == (NS,)
        assert int(n.sum()) == int(concat.levels[li].num_active)
        assert lvl.keys.shape[0] == NS * scaps[li]
    # p2v points at rows whose stored coords equal the point's voxel
    p2v = np.asarray(blocked.p2v)
    vc = np.asarray(blocked.levels[0].coords)
    valid = p2v >= 0
    np.testing.assert_array_equal(vc[p2v[valid]], coords[valid])
    # every real point of a real scene is mapped (caps are ample here)
    real = coords[:, 0] >= 0
    assert valid[real].all()
    # neighbor maps stay scene-pure: values of scene s's rows lie in
    # scene s's block (or -1)
    for li, lvl in enumerate(blocked.levels):
        nbr = np.asarray(lvl.nbr)
        sc = scaps[li]
        for s in range(NS):
            blk = nbr[s * sc:(s + 1) * sc]
            hit = blk >= 0
            assert ((blk[hit] >= s * sc) & (blk[hit] < (s + 1) * sc)).all()


def test_blocked_plan_validates():
    """validate_plan's invariant checks hold on the blocked layout."""
    from occuseg.core.topology import validate_plan

    batch = _batch(12)
    blocked, concat = _plans(batch)
    for plan in (blocked, concat):
        report = validate_plan(plan)
        assert all(v == 0 for v in report.values()), report


def test_blocked_forward_matches_concat():
    """Per-point eval outputs are layout-invariant (XLA conv path)."""
    from occuseg.models import InstanceDenseUNet

    batch = _batch(8)
    blocked, concat = _plans(batch)
    feats = jnp.asarray(batch["features"])
    model = InstanceDenseUNet(n_planes=(8, 16, 24, 32), num_classes=20)
    variables = model.init(jax.random.PRNGKey(0), feats, concat, False)
    out_c = model.apply(variables, feats, concat, False)
    out_b = model.apply(variables, feats, blocked, False)
    np.testing.assert_allclose(np.asarray(out_b.semantics),
                               np.asarray(out_c.semantics),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_b.embedding),
                               np.asarray(out_c.embedding),
                               rtol=1e-5, atol=1e-5)


def test_blocked_train_step_matches_concat():
    """Full train step (6-term loss + Adam) gives the same losses on the
    blocked and concatenated layouts (BN reduction order differs -> tol)."""
    from occuseg.models import LearningBWDenseUNet
    from occuseg.train.state import (
        TrainConfig, create_train_state, make_train_step,
    )

    batch = _batch(11)
    blocked, concat = _plans(batch)
    spec = PlanSpec(caps=CAPS)
    model = LearningBWDenseUNet(n_planes=(8, 16, 24, 32), num_classes=20)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    state = create_train_state(model, jax.random.PRNGKey(0), bj, spec,
                               TrainConfig())
    step = jax.jit(make_train_step(model, spec, num_scenes=NS,
                                   num_instances=I_CAP))
    _, parts_c = step(state, bj, jax.tree.map(jnp.asarray, concat))
    _, parts_b = step(state, bj, jax.tree.map(jnp.asarray, blocked))
    for k in parts_c:
        np.testing.assert_allclose(float(parts_b[k]), float(parts_c[k]),
                                   rtol=1e-3, atol=1e-4,
                                   err_msg=f"loss part {k}")


def test_blocked_point_gather_matches_global():
    """The sorted point layout over a blocked plan: devoxelize equals the
    global gather, and the layout's voxelize (with its host counts and
    sorted segment ids) equals the plain segment mean, values and
    gradients."""
    from occuseg.core.point_layout import (
        apply_point_layout, augment_plan_with_point_layout,
    )
    from occuseg.ops import pool as pool_ops
    from occuseg.ops.gather import gather_rows

    batch = _batch(13)
    blocked, _ = _plans(batch)
    plan = augment_plan_with_point_layout(blocked)
    batch2 = apply_point_layout(batch, plan)
    p2v = jnp.asarray(plan.p2v)
    rng = np.random.default_rng(0)
    vox = jnp.asarray(rng.normal(size=(CAPS[0], 8)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(pool_ops.devoxelize_features(vox, p2v)),
        np.asarray(gather_rows(vox, p2v)))

    x = jnp.asarray(batch["features"])
    x2 = jnp.asarray(batch2["features"])

    def vox_ref(f):
        return pool_ops.voxelize_features(f, jnp.asarray(blocked.p2v),
                                          CAPS[0], mode="mean")

    def vox_lay(f):
        return pool_ops.voxelize_features(
            f, p2v, CAPS[0], mode="mean",
            vox_counts=jnp.asarray(plan.vox_counts),
            indices_are_sorted=True)

    np.testing.assert_allclose(np.asarray(vox_lay(x2)),
                               np.asarray(vox_ref(x)), rtol=1e-5, atol=1e-6)
    w = jnp.asarray(rng.normal(size=(CAPS[0], 3)).astype(np.float32))
    g_ref = jax.grad(lambda f: jnp.sum(vox_ref(f) * w))(x)
    g_lay = jax.grad(lambda f: jnp.sum(vox_lay(f) * w))(x2)
    perm = np.asarray(plan.point_perm)
    keep = perm >= 0
    np.testing.assert_allclose(np.asarray(g_lay)[keep],
                               np.asarray(g_ref)[perm[keep]],
                               rtol=1e-6, atol=1e-7)
