"""The sparse conv implementations and their custom VJPs against the plain
reference (`utils/conv_check.reference_conv`) on real host-plan maps:
submanifold, strided and transposed convs, f32 and bf16, at a tiny input
width, a UNet width and the widest decoder concat. The XLA conv is the CPU
path; the fused GPU kernel (`ops/triton_conv.py`) runs here in the Pallas
interpreter."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from occuseg.core.topology import PlanSpec
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.native.plan import build_plan_host
from occuseg.ops import dispatch
from occuseg.ops.conv import gather_conv
from occuseg.ops.triton_conv import triton_gather_conv
from occuseg.utils.conv_check import (
    check_plan_convs, conv_errors, plan_conv_cases, reference_conv,
)

CAPS = (512, 256)
# bf16 rounds operands and the output to 8 mantissa bits
TOL = {jnp.float32: 1e-5, jnp.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def plan():
    b = make_batch(SceneConfig(num_points=700, extent=24, num_objects=4),
                   1, 1024, 8, seed=5)
    p = build_plan_host(b["coords"], PlanSpec(caps=CAPS))
    assert p is not None, "native planner unavailable"
    return jax.tree.map(jnp.asarray, p)


def _maps(plan, kind):
    lv, tr = plan.levels, plan.transitions
    if kind == "submanifold":
        return lv[0].nbr, None, lv[0].cap
    if kind == "strided":
        return tr[0].child, tr[0].up[:, ::-1], lv[0].cap
    return tr[0].up, tr[0].child[:, ::-1], lv[1].cap


IMPLS = {"xla": gather_conv,
         "triton": functools.partial(triton_gather_conv, interpret=True)}


@pytest.mark.parametrize("impl", ["xla", "triton"])
@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 64), (640, 320)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["submanifold", "strided", "deconv"])
def test_conv_matches_reference(plan, kind, dtype, cin, cout, impl):
    nbr, nbr_t, n = _maps(plan, kind)
    kf, kw = jax.random.split(jax.random.PRNGKey(cin + cout))
    feats = jax.random.normal(kf, (n, cin), jnp.float32)
    w = jax.random.normal(kw, (nbr.shape[1], cin, cout), jnp.float32) \
        * (2.0 / (cin * nbr.shape[1])) ** 0.5
    err = conv_errors(IMPLS[impl], feats, nbr, nbr_t, w, dtype,
                      ref_dtype=jnp.float64)
    assert max(err.values()) < TOL[dtype], err


def test_reference_conv_handles_missing_rows():
    feats = jnp.arange(6.0).reshape(3, 2)
    nbr = jnp.asarray([[0, -1], [2, 1]])
    w = jnp.stack([jnp.eye(2), 2 * jnp.eye(2)])
    out = np.asarray(reference_conv(feats, nbr, w))
    np.testing.assert_allclose(out, [[0, 1], [4 + 4, 5 + 6]])


def test_plan_conv_cases_cover_the_unet(plan):
    names = [c[0] for c in plan_conv_cases(plan, (8, 16))]
    assert names == ["input_sub_L0", "sub_L0", "sub_L1", "down_L0", "up_L1"]
    rows = check_plan_convs(dispatch.impl().conv, plan, (8, 16),
                            jnp.float32, 1e-4)
    assert all(r["ok"] for r in rows), rows


@pytest.mark.parametrize("cin,cout,bk,bn", [(3, 64, 16, 64), (64, 128, 64, 64),
                                            (640, 320, 64, 64),
                                            (20, 8, 32, 16)])
def test_triton_block_sizes(cin, cout, bk, bn):
    """Powers of two, at least 16 (the dot's minimum), at most 64."""
    from occuseg.ops.triton_conv import _blocks
    assert _blocks(cin, cout) == (bk, bn)


def test_triton_conv_traces_under_shard_map(plan):
    """Inside shard_map (check_vma) the kernel's output is typed as varying
    over the mesh axis, with replicated weights lifted to match."""
    from jax.sharding import Mesh, PartitionSpec as P

    nbr = plan.levels[0].nbr
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("d",))
    feats = jnp.zeros((2, nbr.shape[0], 8), jnp.bfloat16)
    w = jnp.zeros((27, 8, 16), jnp.float32)

    def per_device(f, w):
        out = triton_gather_conv(f[0], nbr, w)
        g = jax.grad(lambda w: jnp.sum(
            triton_gather_conv(f[0], nbr, jax.lax.pcast(w, "d",
                                                        to="varying"))
            .astype(jnp.float32)))(w)
        return out[None], jax.lax.psum(g, "d")

    out, g = jax.eval_shape(jax.shard_map(
        per_device, mesh=mesh, in_specs=(P("d"), P()),
        out_specs=(P("d"), P())), feats, w)
    assert out.shape == (2, nbr.shape[0], 16) and g.shape == w.shape


@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 64), (640, 320)])
def test_triton_conv_lowers_for_cuda(cin, cout):
    """The kernel and its VJP lower to Triton IR for the GPU (JAX lowers
    for a platform it does not run on), so a construct the Triton route
    cannot express fails here and not first on the card."""
    nbr = jnp.zeros((300, 27), jnp.int32)
    f = jnp.zeros((300, cin), jnp.bfloat16)
    w = jnp.zeros((27, cin, cout), jnp.float32)
    g = jax.jit(jax.grad(lambda f, w: jnp.sum(
        triton_gather_conv(f, nbr, w).astype(jnp.float32)), argnums=(0, 1)))
    text = g.trace(f, w).lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" in text.lower()
