"""Voxel-axis spatial sharding with halo exchange vs the unsharded conv."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from occuseg.core import topology as T
from occuseg.ops.conv import gather_conv
from occuseg.parallel.spatial import (
    SPACE_AXIS,
    halo_exchange,
    shard_level,
)
from occuseg.ops.conv import gather_conv_fused

from tests.utils import random_points

D = 8
CAP = 1024
HALO = 256


def _level(seed=0):
    rng = np.random.default_rng(seed)
    pts = random_points(rng, 700, extent=24, batch_size=1, pad_to=CAP)
    keys, _ = T.voxelize_coords(jnp.asarray(pts), CAP)
    lvl = T.build_level(keys, kernel=3)
    return rng, lvl


def test_sharded_conv_matches_unsharded():
    rng, lvl = _level()
    n = int(lvl.num_active)
    nbr = np.asarray(lvl.nbr)
    sh, dropped = shard_level(nbr, n, D, HALO)

    cin, cout = 8, 8
    feats = np.zeros((CAP, cin), np.float32)
    feats[:n] = rng.standard_normal((n, cin), dtype=np.float32)
    w = jnp.asarray(rng.standard_normal((27, cin, cout)).astype(np.float32)
                    * 0.2)

    ref = np.asarray(gather_conv(jnp.asarray(feats), lvl.nbr, w))

    mesh = Mesh(np.asarray(jax.devices()[:D]), (SPACE_AXIS,))
    S = CAP // D
    feats_sh = jnp.asarray(feats)

    def per_shard(f, nbr_l, s_l, s_r):
        f, nbr_l, s_l, s_r = f[0], nbr_l[0], s_l[0], s_r[0]
        ext = halo_exchange(f, s_l, s_r, HALO)
        out = gather_conv_fused(ext, nbr_l, w)
        return out[None]

    out = jax.jit(jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(SPACE_AXIS), P(SPACE_AXIS), P(SPACE_AXIS),
                  P(SPACE_AXIS)),
        out_specs=P(SPACE_AXIS),
    ))(feats_sh.reshape(D, S, cin),
       jnp.asarray(sh.nbr_local),
       jnp.asarray(sh.send_left),
       jnp.asarray(sh.send_right))
    out = np.asarray(out).reshape(CAP, cout)
    # rows whose every neighbor survived sharding must match exactly;
    # rows with dropped refs (beyond the +-1-shard halo envelope, reported
    # by the planner) are excluded
    S = CAP // D
    full = np.ones(CAP, bool)
    for d in range(D):
        lo = d * S
        covered = (sh.nbr_local[d] >= 0)
        orig = nbr[lo:lo + S] >= 0
        full[lo:lo + S] = (covered == orig).all(axis=1)
    assert full.mean() > 0.9
    np.testing.assert_allclose(out[full], ref[full], rtol=1e-4, atol=1e-5)


def test_shard_planner_drops_nothing_with_big_halo():
    rng, lvl = _level(1)
    n = int(lvl.num_active)
    sh, dropped = shard_level(np.asarray(lvl.nbr), n, D, HALO)
    # every non-local neighbor within +-1 shard must be present: verify by
    # reconstructing global ids
    S = CAP // D
    nbr = np.asarray(lvl.nbr)
    recon_valid = 0
    total_valid = 0
    for d in range(D):
        lo = d * S
        for s in range(S):
            for k in range(27):
                g = nbr[lo + s, k]
                if g < 0:
                    continue
                total_valid += 1
                l = sh.nbr_local[d, s, k]
                if l < 0:
                    continue
                if l < S:
                    rg = lo + l
                elif l < S + HALO:
                    rg = (lo - S) + sh.send_right[d - 1, l - S]
                else:
                    rg = (lo + S) + sh.send_left[d + 1, l - S - HALO]
                assert rg == g, (d, s, k)
                recon_valid += 1
    assert recon_valid / total_valid > 0.95  # Morton locality keeps most
