"""Compute ops vs dense NumPy oracles (the role the reference's CPU backend
plays, SURVEY.md §4.1)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from occuseg.core import topology as T
from occuseg.ops import conv as conv_ops
from occuseg.ops import norm as norm_ops
from occuseg.ops import pool as pool_ops

from tests.utils import (
    dense_from_sparse,
    dense_strided_conv,
    dense_submanifold_conv,
    random_points,
)

EXTENT = 8
BATCH = 2


def _scene(seed, cin, num=200, cap=256):
    rng = np.random.default_rng(seed)
    pts = random_points(rng, num, extent=EXTENT, batch_size=BATCH, pad_to=cap)
    keys, p2v = T.voxelize_coords(jnp.asarray(pts), cap)
    lvl = T.build_level(keys, kernel=3)
    n = int(lvl.num_active)
    feats = np.zeros((cap, cin), np.float32)
    feats[:n] = rng.standard_normal((n, cin), dtype=np.float32)
    return rng, lvl, feats, n


def test_submanifold_conv_matches_dense():
    cin, cout = 5, 7
    rng, lvl, feats, n = _scene(10, cin)
    w = rng.standard_normal((27, cin, cout)).astype(np.float32) * 0.2
    out = np.asarray(
        conv_ops.gather_conv(jnp.asarray(feats), lvl.nbr, jnp.asarray(w))
    )
    coords = np.asarray(lvl.coords)
    dense = dense_from_sparse(coords[:n], feats[:n], EXTENT, BATCH, cin)
    active = dense_from_sparse(
        coords[:n], np.ones((n, 1)), EXTENT, BATCH, 1)[..., 0] > 0
    ref = dense_submanifold_conv(dense, active, w.astype(np.float64))
    for r in range(n):
        b, z, y, x = coords[r]
        np.testing.assert_allclose(out[r], ref[b, z, y, x], rtol=1e-4,
                                   atol=1e-4)
    # padding rows produce zeros
    assert np.all(out[n:] == 0)


def test_fused_conv_matches_loop():
    cin, cout = 4, 6
    rng, lvl, feats, n = _scene(11, cin)
    w = jnp.asarray(rng.standard_normal((27, cin, cout)).astype(np.float32))
    a = conv_ops.gather_conv(jnp.asarray(feats), lvl.nbr, w)
    b = conv_ops.gather_conv_fused(jnp.asarray(feats), lvl.nbr, w)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("size,stride", [(2, 2), (3, 2)])
def test_strided_conv_matches_dense(size, stride):
    cin, cout = 3, 4
    rng, fine, feats, n = _scene(12, cin)
    ckeys = T.downsample_keys(fine, size, stride, 256)
    coarse = T.build_level(ckeys, kernel=3)
    tr = T.build_transition(fine, coarse, size, stride)
    w = rng.standard_normal((size ** 3, cin, cout)).astype(np.float32) * 0.3
    out = np.asarray(
        conv_ops.gather_conv(jnp.asarray(feats), tr.child, jnp.asarray(w))
    )
    fc = np.asarray(fine.coords)
    dense = dense_from_sparse(fc[:n], feats[:n], EXTENT, BATCH, cin)
    ref = dense_strided_conv(dense, w.astype(np.float64), size, stride)
    cc = np.asarray(coarse.coords)
    for j in range(int(coarse.num_active)):
        b, z, y, x = cc[j]
        np.testing.assert_allclose(out[j], ref[b, z, y, x], rtol=1e-4,
                                   atol=1e-4)


def test_deconv_is_transpose_of_conv():
    """<conv(x), y>_coarse == <x, deconv(y)>_fine for shared weights — the
    defining property the reference exploits by reusing the conv rulebook
    with swapped direction (`Deconvolution.cu`)."""
    cin = 3
    rng, fine, feats, n = _scene(13, cin)
    ckeys = T.downsample_keys(fine, 2, 2, 256)
    coarse = T.build_level(ckeys, kernel=3)
    tr = T.build_transition(fine, coarse, 2, 2)
    m = int(coarse.num_active)
    w = jnp.asarray(rng.standard_normal((8, cin, cin)).astype(np.float32))
    y = np.zeros((256, cin), np.float32)
    y[:m] = rng.standard_normal((m, cin), dtype=np.float32)

    conv_out = np.asarray(conv_ops.gather_conv(jnp.asarray(feats), tr.child, w))
    # deconv with weight transposed on channel axes
    wt = jnp.transpose(w, (0, 2, 1))
    deconv_out = np.asarray(conv_ops.gather_conv(jnp.asarray(y), tr.up, wt))
    lhs = np.sum(conv_out[:m] * y[:m])
    rhs = np.sum(deconv_out[:n] * feats[:n])
    np.testing.assert_allclose(lhs, rhs, rtol=1e-3)


def test_pooling():
    cin = 4
    rng, fine, feats, n = _scene(14, cin)
    ckeys = T.downsample_keys(fine, 2, 2, 256)
    coarse = T.build_level(ckeys, kernel=3)
    tr = T.build_transition(fine, coarse, 2, 2)
    child = np.asarray(tr.child)
    mx = np.asarray(pool_ops.max_pool(jnp.asarray(feats), tr.child))
    av = np.asarray(pool_ops.avg_pool(jnp.asarray(feats), tr.child))
    for j in range(int(coarse.num_active)):
        rows = child[j][child[j] >= 0]
        assert rows.size > 0
        np.testing.assert_allclose(mx[j], feats[rows].max(axis=0), rtol=1e-6)
        np.testing.assert_allclose(av[j], feats[rows].mean(axis=0), rtol=1e-5,
                                   atol=1e-6)


def test_voxelize_devoxelize_roundtrip():
    rng = np.random.default_rng(15)
    cap = 256
    pts = random_points(rng, 180, extent=6, batch_size=2, pad_to=cap)
    keys, p2v = T.voxelize_coords(jnp.asarray(pts), cap)
    pf = rng.standard_normal((cap, 3)).astype(np.float32)
    pf[180:] = 0
    vox = pool_ops.voxelize_features(jnp.asarray(pf), p2v, cap, mode="mean")
    back = np.asarray(pool_ops.devoxelize_features(vox, p2v))
    # each point's devoxelized feature == mean of the points in its voxel
    p2v_np = np.asarray(p2v)
    for i in range(180):
        same = [j for j in range(180) if p2v_np[j] == p2v_np[i]]
        np.testing.assert_allclose(back[i], pf[same].mean(axis=0), rtol=1e-4,
                                   atol=1e-5)
    assert np.all(back[180:] == 0)


def test_batchnorm_matches_reference_semantics():
    rng = np.random.default_rng(16)
    cap, c, n = 64, 5, 50
    feats = np.zeros((cap, c), np.float32)
    feats[:n] = rng.standard_normal((n, c), dtype=np.float32) * 3 + 1
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    st = norm_ops.init_state(c)
    out, st2 = norm_ops.batch_norm(
        jnp.asarray(feats), jnp.int32(n), jnp.asarray(scale),
        jnp.asarray(bias), st, leakiness=0.0, training=True)
    out = np.asarray(out)
    x = feats[:n].astype(np.float64)
    mean = x.mean(0)
    var_b = x.var(0)
    ref = (x - mean) / np.sqrt(var_b + 1e-4) * scale + bias
    ref = np.maximum(ref, 0)
    np.testing.assert_allclose(out[:n], ref, rtol=1e-3, atol=1e-4)
    assert np.all(out[n:] == 0)
    np.testing.assert_allclose(np.asarray(st2.running_mean),
                               0.1 * mean, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(st2.running_var),
                               0.9 + 0.1 * x.var(0, ddof=1), rtol=1e-4)
    # eval mode uses running stats
    out_e, _ = norm_ops.batch_norm(
        jnp.asarray(feats), jnp.int32(n), jnp.asarray(scale),
        jnp.asarray(bias), st2, leakiness=0.0, training=False)
    ref_e = (x - np.asarray(st2.running_mean)) / np.sqrt(
        np.asarray(st2.running_var) + 1e-4) * scale + bias
    np.testing.assert_allclose(np.asarray(out_e)[:n], np.maximum(ref_e, 0),
                               rtol=1e-3, atol=1e-4)


def test_conv_gradients_flow():
    """Autodiff through gather_conv scatters into the right rows (the
    reference implements this by hand in `Convolution.cu:265-446`)."""
    cin, cout = 3, 4
    rng, lvl, feats, n = _scene(17, cin)
    w = jnp.asarray(rng.standard_normal((27, cin, cout)).astype(np.float32))

    def loss(f, w):
        out = conv_ops.gather_conv(f, lvl.nbr, w)
        return jnp.sum(out ** 2)

    g_f, g_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats), w)
    g_f, g_w = np.asarray(g_f), np.asarray(g_w)
    assert np.isfinite(g_f).all() and np.isfinite(g_w).all()
    assert np.abs(g_f[:n]).sum() > 0 and np.abs(g_w).sum() > 0
    # padding rows get no gradient
    assert np.all(g_f[n:] == 0)
    # numeric check on a few entries (float64 to keep fd noise down)
    f0 = jnp.asarray(feats.astype(np.float64))
    w64 = w.astype(jnp.float64)
    eps = 1e-5
    for (r, c) in [(0, 0), (5, 2), (n - 1, 1)]:
        fp = f0.at[r, c].add(eps)
        fm = f0.at[r, c].add(-eps)
        num = (loss(fp, w64) - loss(fm, w64)) / (2 * eps)
        np.testing.assert_allclose(g_f[r, c], float(num), rtol=1e-3,
                                   atol=1e-4)


def test_conv_flops_counter():
    rng, lvl, feats, n = _scene(18, 4)
    fl = int(conv_ops.conv_flops(lvl.nbr, 4, 8))
    pairs = int(np.sum(np.asarray(lvl.nbr) >= 0))
    assert fl == pairs * 32


def test_strided_conv_and_deconv_gradients_numeric():
    """Scatter-free backward via transpose maps must match finite
    differences for both transition directions."""
    cin, cout = 3, 4
    rng, fine, feats, n = _scene(19, cin)
    ckeys = T.downsample_keys(fine, 2, 2, 256)
    coarse = T.build_level(ckeys, kernel=3)
    tr = T.build_transition(fine, coarse, 2, 2)
    m = int(coarse.num_active)
    w = jnp.asarray(rng.standard_normal((8, cin, cout)).astype(np.float64))
    f64 = jnp.asarray(feats.astype(np.float64))

    def loss_down(f):
        out = conv_ops.gather_conv(f, tr.child, w, nbr_t=tr.up[:, ::-1])
        return jnp.sum(jnp.sin(out))

    g = jax.grad(loss_down)(f64)
    eps = 1e-6
    for (r, c) in [(0, 0), (7, 2), (n - 1, 1)]:
        num = (loss_down(f64.at[r, c].add(eps))
               - loss_down(f64.at[r, c].add(-eps))) / (2 * eps)
        np.testing.assert_allclose(float(g[r, c]), float(num), rtol=1e-5,
                                   atol=1e-8)

    cf = np.zeros((256, cin), np.float64)
    cf[:m] = rng.standard_normal((m, cin))
    cf = jnp.asarray(cf)
    w2 = jnp.asarray(rng.standard_normal((8, cin, cout)).astype(np.float64))

    def loss_up(f):
        out = conv_ops.gather_conv(f, tr.up, w2, nbr_t=tr.child[:, ::-1])
        return jnp.sum(jnp.sin(out))

    g2 = jax.grad(loss_up)(cf)
    for (r, c) in [(0, 0), (m - 1, 2)]:
        num = (loss_up(cf.at[r, c].add(eps))
               - loss_up(cf.at[r, c].add(-eps))) / (2 * eps)
        np.testing.assert_allclose(float(g2[r, c]), float(num), rtol=1e-5,
                                   atol=1e-8)

    # weight gradients too
    gw = jax.grad(lambda ww: jnp.sum(
        jnp.sin(conv_ops.gather_conv(f64, tr.child, ww,
                                     nbr_t=tr.up[:, ::-1]))))(w)
    for idx in [(0, 0, 0), (3, 1, 2), (7, 2, 3)]:
        num = (jnp.sum(jnp.sin(conv_ops.gather_conv(
                   f64, tr.child, w.at[idx].add(eps), nbr_t=tr.up[:, ::-1])))
               - jnp.sum(jnp.sin(conv_ops.gather_conv(
                   f64, tr.child, w.at[idx].add(-eps),
                   nbr_t=tr.up[:, ::-1])))) / (2 * eps)
        np.testing.assert_allclose(float(gw[idx]), float(num), rtol=1e-5,
                                   atol=1e-8)


def test_loop_and_fused_conv_paths_agree():
    """The size heuristic switches between two custom-VJP implementations;
    both must produce identical outputs AND gradients."""
    cin, cout = 3, 4
    rng, lvl, feats, n = _scene(20, cin)
    w = jnp.asarray(rng.standard_normal((27, cin, cout)).astype(np.float64))
    f64 = jnp.asarray(feats.astype(np.float64))

    def loss(core):
        def f(x, ww):
            return jnp.sum(jnp.sin(core(x, lvl.nbr, lvl.nbr, ww)))
        return f

    loop_f = loss(conv_ops._gather_conv_core)
    fused_f = loss(conv_ops._gather_conv_fused_core)
    np.testing.assert_allclose(float(loop_f(f64, w)), float(fused_f(f64, w)),
                               rtol=1e-12)
    gl = jax.grad(loop_f, argnums=(0, 1))(f64, w)
    gf = jax.grad(fused_f, argnums=(0, 1))(f64, w)
    np.testing.assert_allclose(np.asarray(gl[0]), np.asarray(gf[0]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(gl[1]), np.asarray(gf[1]),
                               rtol=1e-10, atol=1e-12)

    # and for a transition (asymmetric maps)
    ckeys = T.downsample_keys(lvl, 2, 2, 256)
    coarse = T.build_level(ckeys, kernel=3)
    tr = T.build_transition(lvl, coarse, 2, 2)
    w2 = jnp.asarray(rng.standard_normal((8, cin, cout)).astype(np.float64))

    def lossT(core):
        def f(x, ww):
            return jnp.sum(jnp.sin(core(x, tr.child, tr.up[:, ::-1], ww)))
        return f

    gl = jax.grad(lossT(conv_ops._gather_conv_core), argnums=(0, 1))(f64, w2)
    gf = jax.grad(lossT(conv_ops._gather_conv_fused_core),
                  argnums=(0, 1))(f64, w2)
    np.testing.assert_allclose(np.asarray(gl[0]), np.asarray(gf[0]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(gl[1]), np.asarray(gf[1]),
                               rtol=1e-10, atol=1e-12)


def test_voxelize_modes_first_last():
    """IO modes 0/2 = first point per voxel, 1 = last (IOLayersRules.h:18)."""
    import numpy as np
    p2v = jnp.asarray(np.array([0, 0, 1, 2, 2, 2, -1, -1], np.int32))
    pf = jnp.asarray(np.arange(8, dtype=np.float32)[:, None] * 10)
    cap = 4
    first = np.asarray(pool_ops.voxelize_features(pf, p2v, cap, mode="first"))
    last = np.asarray(pool_ops.voxelize_features(pf, p2v, cap, mode="last"))
    np.testing.assert_array_equal(first[:, 0], [0, 20, 30, 0])
    np.testing.assert_array_equal(last[:, 0], [10, 20, 50, 0])
