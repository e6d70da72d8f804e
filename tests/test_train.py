"""End-to-end training step: single device and 8-virtual-device DP mesh."""

import numpy as np

import jax
import jax.numpy as jnp

from occuseg.core.topology import PlanSpec
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.models import LearningBWDenseUNet
from occuseg.parallel.data_parallel import (
    make_dp_train_step,
    make_mesh,
    replicate_state,
    shard_batch,
)
from occuseg.train.state import (
    TrainConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
)

P_CAP = 2048
I_CAP = 16
SPEC = PlanSpec(caps=(2048, 1024, 512, 256))
SCENE = SceneConfig(num_points=1500, extent=48, num_objects=6)
MODEL = LearningBWDenseUNet(n_planes=(8, 16, 24, 32), num_classes=20)


def _np_batch(seed=0):
    b = make_batch(SCENE, num_scenes=1, p_cap=P_CAP, num_instances=I_CAP,
                   seed=seed)
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_single_device_training_reduces_loss():
    batch = _np_batch(0)
    state = create_train_state(MODEL, jax.random.PRNGKey(0), batch, SPEC)
    step = jax.jit(make_train_step(MODEL, SPEC, num_scenes=1,
                                   num_instances=I_CAP))
    losses = []
    for i in range(8):
        state, parts = step(state, batch)
        losses.append(float(parts["total"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert int(state.step) == 8


def test_eval_step_runs():
    batch = _np_batch(1)
    state = create_train_state(MODEL, jax.random.PRNGKey(1), batch, SPEC)
    ev = jax.jit(make_eval_step(MODEL, SPEC))
    out = ev(state, batch)
    assert np.isfinite(np.asarray(out.semantics)).all()


def _stacked_plans(per_dev_batches, mesh):
    from occuseg.parallel.data_parallel import shard_plans, stack_plans
    from occuseg.train.loop import _host_plan_any

    plans = [_host_plan_any(b["coords"], SPEC) for b in per_dev_batches]
    return shard_plans(stack_plans(plans), mesh)


def test_data_parallel_training_on_8_virtual_devices():
    n_dev = len(jax.devices())
    assert n_dev == 8, f"conftest should give 8 CPU devices, got {n_dev}"
    mesh = make_mesh()
    per_dev = [make_batch(SCENE, 1, P_CAP, I_CAP, seed=10 + d)
               for d in range(n_dev)]
    stacked = {k: np.stack([b[k] for b in per_dev]) for k in per_dev[0]}
    batch = shard_batch(stacked, mesh)
    plans = _stacked_plans(per_dev, mesh)

    state = create_train_state(
        MODEL, jax.random.PRNGKey(2),
        {k: jnp.asarray(v[0]) for k, v in stacked.items()}, SPEC)
    state = replicate_state(state, mesh)
    dp_step = make_dp_train_step(MODEL, SPEC, mesh, num_scenes=1,
                                 num_instances=I_CAP)
    state, parts = dp_step(state, batch, plans)
    assert np.isfinite(float(parts["total"]))
    state, parts2 = dp_step(state, batch, plans)
    assert np.isfinite(float(parts2["total"]))
    # replicated params remain identical across devices after update
    p0 = jax.tree_util.tree_leaves(state.params)[0]
    assert np.isfinite(np.asarray(p0)).all()


def test_dp_matches_mean_of_single_device_grads():
    """One DP step over identical per-device batches == single-device step."""
    mesh = make_mesh()
    b = make_batch(SCENE, 1, P_CAP, I_CAP, seed=42)
    stacked = {k: np.stack([b[k]] * 8) for k in b}
    batch = shard_batch(stacked, mesh)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    plans = _stacked_plans([b] * 8, mesh)

    state = create_train_state(MODEL, jax.random.PRNGKey(3), jb, SPEC)
    sstate = jax.tree.map(lambda x: x, state)

    dp_step = make_dp_train_step(MODEL, SPEC, mesh, num_scenes=1,
                                 num_instances=I_CAP)
    single = jax.jit(make_train_step(MODEL, SPEC, num_scenes=1,
                                     num_instances=I_CAP))
    dstate = replicate_state(state, mesh)
    dstate, dparts = dp_step(dstate, batch, plans)
    sstate, sparts = single(sstate, jb)
    np.testing.assert_allclose(float(dparts["total"]), float(sparts["total"]),
                               rtol=1e-5)
    d_leaf = np.asarray(jax.tree_util.tree_leaves(dstate.params)[3])
    s_leaf = np.asarray(jax.tree_util.tree_leaves(sstate.params)[3])
    np.testing.assert_allclose(d_leaf, s_leaf, rtol=1e-4, atol=1e-6)


def test_dp_weighted_remainder_matches_unpadded_group():
    """A group padded with w=0 copies must produce the same update as the
    unpadded group on fewer devices (no scene double-counted)."""
    from occuseg.parallel.data_parallel import shard_plans, stack_plans
    from occuseg.train.loop import _host_plan_any

    n_dev = len(jax.devices())
    real = [make_batch(SCENE, 1, P_CAP, I_CAP, seed=50 + d)
            for d in range(3)]
    jb = {k: jnp.asarray(v) for k, v in real[0].items()}
    state0 = create_train_state(MODEL, jax.random.PRNGKey(7), jb, SPEC)

    # padded to 8 devices with weight-0 copies of the last batch
    mesh8 = make_mesh()
    group = real + [real[-1]] * (n_dev - 3)
    w = np.asarray([1.0] * 3 + [0.0] * (n_dev - 3), np.float32)
    stacked = {k: np.stack([b[k] for b in group]) for k in group[0]}
    stacked["_w"] = w
    batch8 = shard_batch(stacked, mesh8)
    plans8 = shard_plans(stack_plans(
        [_host_plan_any(b["coords"], SPEC) for b in group]), mesh8)
    dp8 = make_dp_train_step(MODEL, SPEC, mesh8, num_scenes=1,
                             num_instances=I_CAP)
    s8, parts8 = dp8(replicate_state(state0, mesh8), batch8, plans8)

    # reference: unweighted group on 3 devices (uses pmean path)
    mesh3 = make_mesh(3)
    stacked3 = {k: np.stack([b[k] for b in real]) for k in real[0]}
    batch3 = shard_batch(stacked3, mesh3)
    plans3 = shard_plans(stack_plans(
        [_host_plan_any(b["coords"], SPEC) for b in real]), mesh3)
    dp3 = make_dp_train_step(MODEL, SPEC, mesh3, num_scenes=1,
                             num_instances=I_CAP)
    s3, parts3 = dp3(replicate_state(state0, mesh3), batch3, plans3)

    np.testing.assert_allclose(float(parts8["total"]),
                               float(parts3["total"]), rtol=1e-5)
    l8 = np.asarray(jax.tree_util.tree_leaves(s8.params)[3])
    l3 = np.asarray(jax.tree_util.tree_leaves(s3.params)[3])
    np.testing.assert_allclose(l8, l3, rtol=1e-4, atol=1e-6)


def test_overfits_single_scene():
    """Full multi-task model fits one synthetic scene: total loss drops
    ~8x in 60 steps (measured 72.6 -> 9.0; threshold leaves slack)."""
    spec = PlanSpec(caps=(2048, 2048, 1024, 512))
    scene = SceneConfig(num_points=1500, extent=48, num_objects=6)
    b = make_batch(scene, 1, 2048, 16, seed=0)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    model = LearningBWDenseUNet(n_planes=(16, 32, 48, 64))
    state = create_train_state(model, jax.random.PRNGKey(0), batch, spec)
    step = jax.jit(make_train_step(model, spec, num_scenes=1,
                                   num_instances=16))
    first = None
    for i in range(60):
        state, parts = step(state, batch)
        if first is None:
            first = float(parts["total"])
    last = float(parts["total"])
    assert np.isfinite(last)
    assert last < 15.0 and last < first / 3, (first, last)


def test_gradient_accumulation_matches_mean_gradient():
    """accum_steps=2 over two batches == one step on the averaged gradient
    (the sequential replacement for multi-scene batches)."""
    import optax
    from occuseg.train.state import TrainConfig

    b1 = _np_batch(20)
    b2 = _np_batch(21)
    cfg = TrainConfig(accum_steps=2)
    state = create_train_state(MODEL, jax.random.PRNGKey(5), b1, SPEC, cfg)
    step = jax.jit(make_train_step(MODEL, SPEC, cfg, num_scenes=1,
                                   num_instances=I_CAP))
    s1, _ = step(state, b1)
    # after the first accumulation micro-step params must be UNCHANGED
    p_old = jax.tree_util.tree_leaves(state.params)[0]
    p_mid = jax.tree_util.tree_leaves(s1.params)[0]
    np.testing.assert_array_equal(np.asarray(p_old), np.asarray(p_mid))
    s2, _ = step(s1, b2)
    p_new = jax.tree_util.tree_leaves(s2.params)[0]
    assert not np.allclose(np.asarray(p_old), np.asarray(p_new))
