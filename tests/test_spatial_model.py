"""Spatially-sharded flagship-model inference vs the unsharded apply."""

import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from occuseg.core.point_layout import (
    apply_point_layout, augment_plan_with_point_layout,
)
from occuseg.core.topology import PlanSpec
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.models import LearningBWDenseUNet
from occuseg.native import have_native
from occuseg.native.plan import build_plan_host
from occuseg.parallel.spatial import SPACE_AXIS
from occuseg.parallel.spatial_model import sharded_occuseg_infer

pytestmark = pytest.mark.skipif(not have_native(),
                                reason="needs the C++ host plan builder")

D = 8
CAPS = (2048, 1024, 512)
PLANES = (8, 16, 24)


def test_sharded_infer_matches_unsharded():
    batch = make_batch(SceneConfig(num_points=2500, extent=40,
                                   num_objects=6), 1, 4096, 16, seed=0)
    plan = build_plan_host(batch["coords"], PlanSpec(caps=CAPS))
    plan_j = jax.tree.map(jnp.asarray, plan)
    pf = jnp.asarray(batch["features"])

    model = LearningBWDenseUNet(n_planes=PLANES, num_classes=20,
                                block_reps=1, residual_blocks=True)
    variables = model.init(jax.random.PRNGKey(0), pf, plan_j, False)
    # perturb running stats so eval-BN is a real affine, not near-identity
    rng = np.random.default_rng(1)
    variables = jax.tree.map(lambda a: a, variables)  # to mutable dicts

    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k == "running_mean":
                out[k] = jnp.asarray(
                    rng.standard_normal(v.shape).astype(np.float32) * 0.3)
            else:
                out[k] = jnp.asarray(
                    rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        return out

    variables = {"params": variables["params"],
                 "batch_stats": perturb(variables["batch_stats"])}

    ref = model.apply(variables, pf, plan_j, False)

    mesh = Mesh(np.asarray(jax.devices()[:D]), (SPACE_AXIS,))
    got = sharded_occuseg_infer(variables, plan, pf, mesh, PLANES,
                                halo=256, pool=256)

    valid = np.asarray(plan.p2v) >= 0
    assert valid.sum() > 2000
    for name in ("features", "semantics", "embedding", "offset",
                 "displacement", "bw", "occupancy"):
        a = np.asarray(getattr(ref, name))[valid]
        b = np.asarray(getattr(got, name))[valid]
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4,
                                   err_msg=name)


def test_sharded_train_forward_matches_unsharded():
    """Train-mode sharded forward: outputs, updated BN running stats, AND
    parameter gradients all match the unsharded model.apply(train=True)."""
    from occuseg.parallel.spatial_model import (
        prepare_shard_args,
        sharded_train_forward,
    )

    batch = make_batch(SceneConfig(num_points=2500, extent=40,
                                   num_objects=6), 1, 4096, 16, seed=1)
    plan = build_plan_host(batch["coords"], PlanSpec(caps=CAPS))
    plan_j = jax.tree.map(jnp.asarray, plan)
    pf = jnp.asarray(batch["features"])

    model = LearningBWDenseUNet(n_planes=PLANES, num_classes=20,
                                block_reps=1, residual_blocks=True)
    variables = model.init(jax.random.PRNGKey(3), pf, plan_j, False)
    params, stats = variables["params"], variables["batch_stats"]
    mesh = Mesh(np.asarray(jax.devices()[:D]), (SPACE_AXIS,))
    sa = prepare_shard_args(plan, D, halo=256, pool=256)
    p2v = jnp.asarray(plan.p2v)
    valid = np.asarray(plan.p2v) >= 0

    vmask = jnp.asarray(valid)[:, None]

    def loss_ref(p):
        out, mut = model.apply({"params": p, "batch_stats": stats},
                               pf, plan_j, True, mutable=["batch_stats"])
        return jnp.sum(jnp.where(vmask, out.features, 0) ** 2) * 1e-3, \
            (out, mut["batch_stats"])

    def loss_sh(p):
        out, ns = sharded_train_forward(
            {"params": p, "batch_stats": stats}, sa, p2v, pf, mesh, PLANES)
        return jnp.sum(jnp.where(vmask, out.features, 0) ** 2) * 1e-3, \
            (out, ns)

    (l_ref, (o_ref, s_ref)), g_ref = jax.jit(jax.value_and_grad(
        loss_ref, has_aux=True))(params)
    (l_sh, (o_sh, s_sh)), g_sh = jax.jit(jax.value_and_grad(
        loss_sh, has_aux=True))(params)

    np.testing.assert_allclose(float(l_sh), float(l_ref), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(o_sh.features)[valid],
                               np.asarray(o_ref.features)[valid],
                               rtol=2e-3, atol=2e-4)
    def by_path(tree):
        return {jax.tree_util.keystr(p): v
                for p, v in jax.tree_util.tree_leaves_with_path(tree)}

    # updated running stats match (global psum'd masked statistics)
    sh_stats, ref_stats = by_path(s_sh), by_path(s_ref)
    assert set(sh_stats) == set(ref_stats)
    for k in ref_stats:
        np.testing.assert_allclose(np.asarray(sh_stats[k]),
                                   np.asarray(ref_stats[k]),
                                   rtol=2e-3, atol=2e-5, err_msg=k)
    # gradients agree (relative to the parameter-wise gradient scale)
    sh_g, ref_g = by_path(g_sh), by_path(g_ref)
    assert set(sh_g) == set(ref_g)
    for k in ref_g:
        a, b = np.asarray(sh_g[k]), np.asarray(ref_g[k])
        denom = np.maximum(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / denom, b / denom, atol=5e-3,
                                   err_msg=k)
    assert len(ref_g) > 50


def test_spatial_train_step_matches_unsharded_step():
    """End-to-end: the sharded training step (OccuSeg 6-term loss + Adam)
    produces the same loss parts and parameter updates as the unsharded
    make_train_step on the same batch/plan."""
    from occuseg.parallel.spatial_model import (
        make_spatial_train_step,
        prepare_shard_args,
    )
    from occuseg.train.state import (
        TrainConfig,
        create_train_state,
        make_train_step,
    )

    batch = make_batch(SceneConfig(num_points=2500, extent=40,
                                   num_objects=6), 1, 4096, 16, seed=2)
    spec = PlanSpec(caps=CAPS)
    plan = build_plan_host(batch["coords"], spec)
    plan_j = jax.tree.map(jnp.asarray, plan)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}

    model = LearningBWDenseUNet(n_planes=PLANES, num_classes=20,
                                block_reps=1, residual_blocks=True)
    cfg = TrainConfig(lr=1e-3)
    state = create_train_state(model, jax.random.PRNGKey(4), batch_j, spec,
                               cfg)

    ref_step = jax.jit(make_train_step(model, spec, cfg,
                                       num_instances=16))
    st_ref, parts_ref = ref_step(state, batch_j, plan_j)

    mesh = Mesh(np.asarray(jax.devices()[:D]), (SPACE_AXIS,))
    sa = prepare_shard_args(plan, D, halo=256, pool=256)
    sp_step = jax.jit(make_spatial_train_step(mesh, PLANES, cfg,
                                              num_instances=16))
    st_sp, parts_sp = sp_step(state, batch_j, sa)

    for k in parts_ref:
        np.testing.assert_allclose(float(parts_sp[k]), float(parts_ref[k]),
                                   rtol=2e-3, atol=1e-4, err_msg=k)
    # parameter updates agree
    pa = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_leaves_with_path(st_sp.params)}
    pb = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_leaves_with_path(st_ref.params)}
    for k in pb:
        np.testing.assert_allclose(np.asarray(pa[k]), np.asarray(pb[k]),
                                   rtol=5e-3, atol=5e-5, err_msg=k)


def test_sharded_infer_bf16_matches_unsharded_bf16():
    """compute_dtype=bfloat16 sharded inference vs the unsharded bf16
    model (the production mixed-precision recipe)."""
    batch = make_batch(SceneConfig(num_points=2500, extent=40,
                                   num_objects=6), 1, 4096, 16, seed=4)
    plan = build_plan_host(batch["coords"], PlanSpec(caps=CAPS))
    plan_j = jax.tree.map(jnp.asarray, plan)
    pf = jnp.asarray(batch["features"])

    model = LearningBWDenseUNet(n_planes=PLANES, num_classes=20,
                                block_reps=1, residual_blocks=True,
                                compute_dtype=jnp.bfloat16)
    variables = model.init(jax.random.PRNGKey(5), pf, plan_j, False)
    ref = model.apply(variables, pf, plan_j, False)

    mesh = Mesh(np.asarray(jax.devices()[:D]), (SPACE_AXIS,))
    got = sharded_occuseg_infer(variables, plan, pf, mesh, PLANES,
                                halo=256, pool=256,
                                compute_dtype=jnp.bfloat16)
    valid = np.asarray(plan.p2v) >= 0
    a = np.asarray(ref.features, np.float32)[valid]
    b = np.asarray(got.features, np.float32)[valid]
    # bf16 activations: compare within a few bf16 ulps of the value scale
    np.testing.assert_allclose(b, a, rtol=5e-2,
                               atol=0.05 * np.abs(a).max())


def test_chip_smoke_multicard_rehearsal(capsys):
    """`chip_smoke.py --cards 4`'s phase on 4 virtual CPU devices: the
    spatially sharded and data-parallel steps of a 6-level UNet (small
    widths, tiny rooms) against their single-device comparisons."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    mod_spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(chip_smoke)

    spec = PlanSpec(caps=(2048, 1024, 256, 64, 16, 8))
    scenes = []
    for seed in range(4):
        b = make_batch(SceneConfig(num_points=3000, extent=40,
                                   num_objects=6), 1, 4096, 16, seed=seed)
        plan = augment_plan_with_point_layout(
            build_plan_host(b["coords"], spec))
        scenes.append((apply_point_layout(b, plan), plan))
    chip_smoke.phase_multicard(4, scenes, (8, 16, 24, 32, 40, 48), spec,
                               num_instances=16, halo=256, pool=256)
    out = capsys.readouterr().out
    assert "(spatial) 4 shards" in out and "(dp) 4 cards" in out
