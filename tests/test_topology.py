"""Topology planner correctness vs brute-force NumPy."""

import numpy as np
import pytest

import jax.numpy as jnp

from occuseg.core import coords as C
from occuseg.core import topology as T

from tests.utils import random_points


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    pts = random_points(rng, 300, extent=4000, batch_size=7, pad_to=384)
    keys = C.pack(jnp.asarray(pts))
    back = np.asarray(C.unpack(keys))
    np.testing.assert_array_equal(back[:300], pts[:300])
    assert np.all(back[300:] == -1)
    assert np.all(np.asarray(keys[300:]) == np.asarray(C.KEY_PAD))


def test_pack_is_injective_and_batch_major():
    rng = np.random.default_rng(1)
    pts = random_points(rng, 500, extent=4095, batch_size=3)
    keys = np.asarray(C.pack(jnp.asarray(pts)))
    # injective: distinct coords -> distinct keys
    uniq_pts = {tuple(p) for p in pts}
    assert len(np.unique(keys)) == len(uniq_pts)
    # batch-major: all keys of batch b sort before batch b+1
    for b in range(2):
        assert keys[pts[:, 0] == b].max() < keys[pts[:, 0] == b + 1].min()
    # stride-2 parent keys of sorted keys are sorted (Morton property)
    ks = np.sort(keys)
    par = np.asarray(C.parent_keys(jnp.asarray(ks)))
    assert np.all(np.diff(par) >= 0)


def test_voxelize_unique_and_p2v():
    rng = np.random.default_rng(2)
    pts = random_points(rng, 400, extent=8, batch_size=2, pad_to=512)
    cap = 512
    keys, p2v = T.voxelize_coords(jnp.asarray(pts), cap)
    keys, p2v = np.asarray(keys), np.asarray(p2v)
    # expected unique voxels (via the same packing, order-independent)
    real = pts[:400]
    expected = np.unique(np.asarray(C.pack(jnp.asarray(real))))
    n = expected.shape[0]
    np.testing.assert_array_equal(keys[:n], expected)
    assert np.all(keys[n:] == np.asarray(C.KEY_PAD))
    # p2v maps each point to the row holding its own voxel key
    own = np.asarray(C.pack(jnp.asarray(real)))
    for i in range(400):
        assert keys[p2v[i]] == own[i]
    assert np.all(p2v[400:] == -1)


def test_submanifold_neighbor_map():
    rng = np.random.default_rng(3)
    pts = random_points(rng, 300, extent=6, batch_size=2, pad_to=400)
    cap = 400
    keys, _ = T.voxelize_coords(jnp.asarray(pts), cap)
    lvl = T.build_level(keys, kernel=3)
    coords = np.asarray(lvl.coords)
    nbr = np.asarray(lvl.nbr)
    n = int(lvl.num_active)
    vox = {tuple(coords[r]): r for r in range(n)}
    k = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                for r in range(n):
                    b, z, y, x = coords[r]
                    want = vox.get((b, z + dz, y + dy, x + dx), -1)
                    assert nbr[r, k] == want, (r, k, (dz, dy, dx))
                k += 1
    # center offset is identity
    np.testing.assert_array_equal(nbr[:n, 13], np.arange(n))
    # padding rows have no neighbors
    assert np.all(nbr[n:] == -1)


@pytest.mark.parametrize("size,stride", [(2, 2), (3, 2)])
def test_transition_maps(size, stride):
    rng = np.random.default_rng(4)
    pts = random_points(rng, 200, extent=8, batch_size=2, pad_to=256)
    keys, _ = T.voxelize_coords(jnp.asarray(pts), 256)
    fine = T.build_level(keys, kernel=3)
    ckeys = T.downsample_keys(fine, size, stride, 256)
    coarse = T.build_level(ckeys, kernel=3)
    tr = T.build_transition(fine, coarse, size, stride)

    fc = np.asarray(fine.coords)
    nf = int(fine.num_active)
    cc = np.asarray(coarse.coords)
    nc = int(coarse.num_active)
    child = np.asarray(tr.child)
    up = np.asarray(tr.up)

    # Expected coarse set: every j covering an active input
    expected = set()
    for r in range(nf):
        b, z, y, x = fc[r]
        for jz in range(max(0, (z - size + stride) // stride), z // stride + 1):
            for jy in range(max(0, (y - size + stride) // stride), y // stride + 1):
                for jx in range(max(0, (x - size + stride) // stride), x // stride + 1):
                    if (jz * stride + size > z and jy * stride + size > y
                            and jx * stride + size > x):
                        expected.add((b, jz, jy, jx))
    got = {tuple(cc[r]) for r in range(nc)}
    assert got == expected

    fvox = {tuple(fc[r]): r for r in range(nf)}
    cvox = {tuple(cc[r]): r for r in range(nc)}
    k = 0
    for dz in range(size):
        for dy in range(size):
            for dx in range(size):
                for j in range(nc):
                    b, z, y, x = cc[j]
                    want = fvox.get(
                        (b, z * stride + dz, y * stride + dy, x * stride + dx), -1)
                    assert child[j, k] == want
                for i in range(nf):
                    b, z, y, x = fc[i]
                    zz, yy, xx = z - dz, y - dy, x - dx
                    want = -1
                    if (zz >= 0 and yy >= 0 and xx >= 0 and zz % stride == 0
                            and yy % stride == 0 and xx % stride == 0):
                        want = cvox.get((b, zz // stride, yy // stride,
                                         xx // stride), -1)
                    assert up[i, k] == want
                k += 1


def test_build_plan_levels_consistent():
    rng = np.random.default_rng(5)
    pts = random_points(rng, 600, extent=32, batch_size=2, pad_to=1024)
    spec = T.PlanSpec(caps=(1024, 1024, 512, 256))
    plan = T.build_plan(jnp.asarray(pts), spec)
    assert not bool(plan.overflow())
    # each coarser level has <= active sites of the finer one (stride 2)
    na = [int(l.num_active) for l in plan.levels]
    assert all(na[i + 1] <= na[i] for i in range(len(na) - 1))
    assert na[0] > 0
    # every active coarse site has at least one child
    for l, tr in enumerate(plan.transitions):
        nc = int(plan.levels[l + 1].num_active)
        child = np.asarray(tr.child)
        assert np.all((child[:nc] >= 0).any(axis=1))


def test_validate_plan_clean():
    rng = np.random.default_rng(6)
    pts = random_points(rng, 600, extent=32, batch_size=2, pad_to=1024)
    spec = T.PlanSpec(caps=(1024, 1024, 768, 512))
    plan = T.build_plan(jnp.asarray(pts), spec)
    report = T.validate_plan(plan)
    assert all(v == 0 for v in report.values()), report


def test_nn_search_dilated_neighbors():
    """nn_search dilated lookup: exact hit preferred, else nearest active
    site by Chebyshev shell (reference SubmanifoldConvolutionRules.h:38-150
    intent; its shell loop never perturbs the probe point — see
    build_level docstring)."""
    import numpy as np
    from occuseg.core import topology as T
    from occuseg.core import coords as C
    from tests.utils import random_points

    rng = np.random.default_rng(7)
    pts = random_points(rng, 150, extent=16, batch_size=1, pad_to=256)
    keys, _ = T.voxelize_coords(jnp.asarray(pts), 256)
    plain = T.build_level(keys, kernel=3, dilation=2)
    nns = T.build_level(keys, kernel=3, dilation=2, nn_search=True)
    coords = np.asarray(plain.coords)
    n = int(plain.num_active)
    active = {tuple(coords[r]): r for r in range(n)}
    offs = T._offsets(3, 2)
    shells = T._chebyshev_shells(1)
    p_nbr, s_nbr = np.asarray(plain.nbr), np.asarray(nns.nbr)
    checked_fallback = 0
    for r in range(n):
        for k in range(offs.shape[0]):
            target = coords[r] + np.concatenate([[0], offs[k]])
            if p_nbr[r, k] >= 0:
                # exact site exists -> identical to the plain dilated map
                assert s_nbr[r, k] == p_nbr[r, k]
                continue
            # oracle: first active site over radius-then-lex ordered shells
            want = -1
            for d in shells:
                cand = tuple(target + np.concatenate([[0], d]))
                if cand in active:
                    want = active[cand]
                    break
            assert s_nbr[r, k] == want, (r, k)
            checked_fallback += want >= 0
    assert checked_fallback > 0  # the fallback path was actually exercised
