"""Normal-guided rotation-invariant filters."""

import numpy as np

import jax
import jax.numpy as jnp

from occuseg.core import topology as T
from occuseg.ops import conv as conv_ops
from occuseg.ops.normal_guide import (
    ORIENT_PERM,
    normal_guided_conv,
    oriented_filter,
    permute_neighbor_map,
)

from tests.utils import random_points


def _scene(seed, cin=3, cap=256):
    rng = np.random.default_rng(seed)
    pts = random_points(rng, 200, extent=8, batch_size=2, pad_to=cap)
    keys, _ = T.voxelize_coords(jnp.asarray(pts), cap)
    lvl = T.build_level(keys, kernel=3)
    n = int(lvl.num_active)
    feats = np.zeros((cap, cin), np.float32)
    feats[:n] = rng.standard_normal((n, cin), dtype=np.float32)
    return rng, lvl, feats, n


def test_oriented_filter_classes():
    normals = jnp.asarray(np.array([
        [1, 0, 0], [-2, 1, 0], [0, 3, 1], [0, -1, 0.5], [0.1, 0.2, -5],
    ], np.float32))
    np.testing.assert_array_equal(np.asarray(oriented_filter(normals)),
                                  [0, 0, 2, 2, 4])


def test_orientation_zero_is_identity():
    rng, lvl, feats, n = _scene(0)
    w = jnp.asarray(rng.standard_normal((27, 3, 5)).astype(np.float32))
    orient = jnp.zeros((256,), jnp.int32)
    a = normal_guided_conv(jnp.asarray(feats), lvl.nbr, orient, w)
    b = conv_ops.gather_conv(jnp.asarray(feats), lvl.nbr, w)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-6)


def test_constant_orientation_equals_weight_permutation():
    """Applying orientation o everywhere == permuting the weight axis by the
    reference's table row o."""
    rng, lvl, feats, n = _scene(1)
    w = jnp.asarray(rng.standard_normal((27, 3, 5)).astype(np.float32))
    for o in (2, 4):
        orient = jnp.full((256,), o, jnp.int32)
        a = normal_guided_conv(jnp.asarray(feats), lvl.nbr, orient, w)
        # out = sum_k feats[nbr[k]] @ W[perm[o,k]]
        w_perm = w[jnp.asarray(ORIENT_PERM[o])]
        b = conv_ops.gather_conv(jnp.asarray(feats), lvl.nbr, w_perm)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_normal_guided_gradients():
    rng, lvl, feats, n = _scene(2)
    w = jnp.asarray(rng.standard_normal((27, 3, 4)).astype(np.float64))
    orient = jnp.asarray((np.arange(256) % 3 * 2).astype(np.int32))
    f = jnp.asarray(feats.astype(np.float64))

    def loss(f, w):
        return jnp.sum(jnp.sin(normal_guided_conv(f, lvl.nbr, orient, w)))

    gf, gw = jax.grad(loss, argnums=(0, 1))(f, w)
    eps = 1e-6
    for (r, c) in [(0, 0), (5, 2)]:
        num = (loss(f.at[r, c].add(eps), w)
               - loss(f.at[r, c].add(-eps), w)) / (2 * eps)
        np.testing.assert_allclose(float(gf[r, c]), float(num), rtol=1e-5,
                                   atol=1e-8)


def test_plan_with_normals():
    rng = np.random.default_rng(3)
    pts = random_points(rng, 300, extent=16, batch_size=2, pad_to=512)
    normals = rng.standard_normal((512, 3)).astype(np.float32)
    spec = T.PlanSpec(caps=(512, 256))
    plan = T.build_plan(jnp.asarray(pts), spec, jnp.asarray(normals))
    for lvl in plan.levels:
        o = np.asarray(lvl.orient)
        assert set(np.unique(o)).issubset({0, 2, 4})


def test_normal_guided_model_forward():
    """SubmanifoldConvolution(normal_guided=True) through a plan built with
    point normals."""
    from occuseg.nn import core as nn
    from occuseg.core.sparse_tensor import SparseTensor
    from occuseg.nn.modules import SubmanifoldConvolution

    rng = np.random.default_rng(9)
    pts = random_points(rng, 300, extent=16, batch_size=2, pad_to=512)
    normals = rng.standard_normal((512, 3)).astype(np.float32)
    spec = T.PlanSpec(caps=(512, 256))
    plan = T.build_plan(jnp.asarray(pts), spec, jnp.asarray(normals))
    x = SparseTensor(
        features=jnp.asarray(rng.standard_normal((512, 3)).astype(np.float32)),
        num_active=plan.levels[0].num_active, level=0)
    m = SubmanifoldConvolution(8, normal_guided=True)
    v = m.init(jax.random.PRNGKey(0), x, plan, False)
    out = m.apply(v, x, plan, False)
    assert np.isfinite(np.asarray(out.features)).all()
    # differs from the unguided conv with the same weights (orientations mix)
    m2 = SubmanifoldConvolution(8, normal_guided=False)
    out2 = m2.apply(v, x, plan, False)
    assert not np.allclose(np.asarray(out.features),
                           np.asarray(out2.features))


def test_host_plan_orientation_matches_jit_plan():
    """The C++ host planner's orientation classes (--use_normal fast path)
    equal the jitted builder's (VERDICT r1 #5: native/plan.py previously
    hardcoded orient=zeros)."""
    import jax
    import jax.numpy as jnp
    from occuseg.core.topology import PlanSpec, build_plan
    from occuseg.data.synthetic import SceneConfig, make_batch
    from occuseg.native.plan import build_plan_host

    spec = PlanSpec(caps=(2048, 1024, 512))
    b = make_batch(SceneConfig(num_points=3000, extent=64, num_objects=6),
                   1, 4096, 8, seed=21)
    host = build_plan_host(b["coords"], spec, b["normals"])
    assert host is not None
    jit_plan = jax.jit(lambda c, n: build_plan(c, spec, n))(
        jnp.asarray(b["coords"]), jnp.asarray(b["normals"]))
    for li, (h, j) in enumerate(zip(host.levels, jit_plan.levels)):
        n = int(h.num_active)
        ho = np.asarray(h.orient)[:n]
        jo = np.asarray(j.orient)[:n]
        match = (ho == jo).mean()
        # normalize/argmax ties can flip a handful of sites; demand
        # near-exact agreement
        assert match > 0.995, (li, match)
        assert set(np.unique(ho)) <= {0, 2, 4}
        assert (ho != 0).any(), "orientation classes must not be all-zero"


def test_use_normal_train_step_end_to_end():
    """Flagship model with normal_guided=True trains on a synthetic batch
    using a host plan that carries orientation classes."""
    import jax
    import jax.numpy as jnp
    from occuseg.core.topology import PlanSpec
    from occuseg.data.synthetic import SceneConfig, make_batch
    from occuseg.models import LearningBWDenseUNet
    from occuseg.native.plan import build_plan_host
    from occuseg.train.state import create_train_state, make_train_step

    spec = PlanSpec(caps=(2048, 1024, 512))
    b = make_batch(SceneConfig(num_points=1500, extent=48, num_objects=6),
                   1, 2048, 16, seed=5)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    model = LearningBWDenseUNet(n_planes=(8, 16, 24), num_classes=20,
                                normal_guided=True)
    state = create_train_state(model, jax.random.PRNGKey(0), batch, spec)
    step = jax.jit(make_train_step(model, spec, num_scenes=1,
                                   num_instances=16, use_normals=True))
    plan = jax.tree.map(jnp.asarray,
                        build_plan_host(b["coords"], spec, b["normals"]))
    losses = []
    for _ in range(4):
        state, parts = step(state, batch, plan)
        losses.append(float(parts["total"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

    # parity: host-plan step == in-jit-plan step (same orient path)
    state2 = create_train_state(model, jax.random.PRNGKey(0), batch, spec)
    state3 = jax.tree.map(lambda x: x, state2)
    _, parts_host = step(state2, batch, plan)
    _, parts_jit = step(state3, batch, None)
    np.testing.assert_allclose(float(parts_host["total"]),
                               float(parts_jit["total"]), rtol=1e-4)


def test_guide_levels_cutoff():
    """PlanSpec.guide_levels reproduces the reference's normal_guide_scale
    cutoff (`ConvolutionRules.h:774`, `model.py:662-663`): orientation
    classes exist only at levels 0..rotation_guide_level; coarser levels
    stay identity. Host and jit builders agree on the cutoff."""
    from occuseg.data.synthetic import SceneConfig, make_batch
    from occuseg.native.plan import build_plan_host

    spec = T.PlanSpec(caps=(2048, 1024, 512), guide_levels=2)
    b = make_batch(SceneConfig(num_points=3000, extent=64, num_objects=6),
                   1, 4096, 8, seed=21)
    for plan in (build_plan_host(b["coords"], spec, b["normals"]),
                 jax.jit(lambda c, n: T.build_plan(c, spec, n))(
                     jnp.asarray(b["coords"]), jnp.asarray(b["normals"]))):
        for li, lvl in enumerate(plan.levels):
            o = np.asarray(lvl.orient)[:int(lvl.num_active)]
            if li < 2:
                assert (o != 0).any(), (li, "guided level lost orientation")
            else:
                assert (o == 0).all(), (li, "orientation leaked past cutoff")
