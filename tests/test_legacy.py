"""sparseconvnet-compatible shim: the reference docstring example ports."""

import numpy as np

import jax
import jax.numpy as jnp

import occuseg.legacy as scn
from occuseg.core import topology as T
from occuseg.core.sparse_tensor import SparseTensor

from tests.utils import random_points


def test_reference_docstring_example():
    """Model from the reference UNet docstring
    (`networkArchitectures.py:207-213`), built with scn-style calls."""
    rng = np.random.default_rng(0)
    pts = random_points(rng, 500, extent=32, batch_size=2, pad_to=1024)
    spec = T.PlanSpec(caps=(1024, 1024, 512, 256))
    plan = T.build_plan(jnp.asarray(pts), spec)
    n = int(plan.levels[0].num_active)

    model = scn.Sequential().add(
        scn.SubmanifoldConvolution(3, 3, 8, 3, False)).add(
        scn.UNet(3, 1, [8, 16, 24, 32], residual_blocks=True)).add(
        scn.BatchNormReLU(8))

    f = np.zeros((1024, 3), np.float32)
    f[:n] = rng.standard_normal((n, 3), dtype=np.float32)
    x = SparseTensor(features=jnp.asarray(f),
                     num_active=plan.levels[0].num_active, level=0)
    variables = model.init(jax.random.PRNGKey(0), x, plan, False)
    out = model.apply(variables, x, plan, False)
    assert out.features.shape == (1024, 8)
    assert np.isfinite(np.asarray(out.features)).all()


def test_tables():
    rng = np.random.default_rng(1)
    pts = random_points(rng, 300, extent=16, batch_size=1, pad_to=512)
    spec = T.PlanSpec(caps=(512, 256))
    plan = T.build_plan(jnp.asarray(pts), spec)
    x = SparseTensor(features=jnp.asarray(
        rng.standard_normal((512, 4)).astype(np.float32)),
        num_active=plan.levels[0].num_active, level=0)

    ct = scn.ConcatTable().add(scn.Identity()).add(
        scn.NetworkInNetwork(4, 4, False))
    model = scn.Sequential().add(ct).add(scn.AddTable())
    variables = model.init(jax.random.PRNGKey(0), x, plan, False)
    out = model.apply(variables, x, plan, False)
    assert out.features.shape == (512, 4)

    model2 = scn.Sequential().add(ct).add(scn.JoinTable())
    v2 = model2.init(jax.random.PRNGKey(0), x, plan, False)
    out2 = model2.apply(v2, x, plan, False)
    assert out2.features.shape == (512, 8)


def test_append_tensors():
    """append_tensors (reference utils.py:142-151 + Metadata appendMetadata):
    two single-scene tensors concatenate into a blocked 2-scene tensor whose
    merged plan runs the same convolution as each scene separately."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import occuseg.legacy as scn
    from occuseg.core.sparse_tensor import SparseTensor
    from occuseg.core.topology import PlanSpec
    from occuseg.data.synthetic import SceneConfig, make_batch
    from occuseg.native.plan import build_plan_host
    from occuseg.ops.conv import gather_conv

    spec = PlanSpec(caps=(512, 256))
    rng = np.random.default_rng(0)
    entries, feats_list, plans = [], [], []
    for seed in (1, 2):
        batch = make_batch(SceneConfig(num_points=900, extent=40,
                                       num_objects=4),
                           num_scenes=1, p_cap=2048, num_instances=8,
                           seed=seed)
        plan = build_plan_host(batch["coords"], spec)
        assert plan is not None
        f = jnp.asarray(rng.standard_normal((512, 8)), jnp.float32)
        n = jnp.asarray(np.asarray(plan.levels[0].num_active))
        entries.append((SparseTensor(features=f, num_active=n), plan))
        feats_list.append(f)
        plans.append(plan)

    out, merged = scn.append_tensors(entries)
    assert out.cap == 1024 and out.num_active.shape == (2,)
    assert np.asarray(merged.levels[0].keys).shape[0] == 1024
    # batch columns renumbered
    c0 = np.asarray(merged.levels[0].coords)
    assert set(np.unique(c0[:512, 0])) <= {-1, 0}
    assert set(np.unique(c0[512:, 0])) <= {-1, 1}

    # a conv over the merged plan equals per-scene convs
    w = jnp.asarray(rng.standard_normal((27, 8, 8)) * 0.1, jnp.float32)
    merged_out = gather_conv(out.features,
                             jnp.asarray(merged.levels[0].nbr), w)
    for s in range(2):
        ref = gather_conv(feats_list[s],
                          jnp.asarray(plans[s].levels[0].nbr), w)
        np.testing.assert_allclose(
            np.asarray(merged_out[s * 512:(s + 1) * 512]),
            np.asarray(ref), rtol=1e-5, atol=1e-5)
