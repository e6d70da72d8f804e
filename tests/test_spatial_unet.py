"""Full sharded mini-UNet forward over the 8-device CPU mesh vs unsharded.

A 3-level UNet-shaped stack (subconv -> down conv -> subconv -> deconv ->
subconv) where every op runs under shard_map with per-level halo exchange,
compared to the plain single-device computation on rows whose references
survived sharding."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from occuseg.core.topology import PlanSpec
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.native.plan import build_plan_host
from occuseg.native import have_native
from occuseg.ops.conv import gather_conv, gather_conv_fused
from occuseg.parallel.spatial import SPACE_AXIS, extend_features, shard_plan

pytestmark = pytest.mark.skipif(not have_native(),
                                reason="needs the C++ host plan builder")

D = 8
HALO = 256
POOL = 256
CAPS = (4096, 4096, 2048)


def test_sharded_unet_forward_matches():
    batch = make_batch(SceneConfig(num_points=3000, extent=48, num_objects=6),
                       1, 4096, 16, seed=0)
    plan = build_plan_host(batch["coords"], PlanSpec(caps=CAPS))
    sp = shard_plan(plan, D, HALO, pool=POOL)

    rng = np.random.default_rng(0)
    c0, c1 = 8, 16
    n0 = int(plan.levels[0].num_active)
    feats = np.zeros((CAPS[0], c0), np.float32)
    feats[:n0] = rng.standard_normal((n0, c0), dtype=np.float32)
    w_sub0 = jnp.asarray(rng.standard_normal((27, c0, c0)).astype(np.float32) * .2)
    w_down = jnp.asarray(rng.standard_normal((8, c0, c1)).astype(np.float32) * .2)
    w_sub1 = jnp.asarray(rng.standard_normal((27, c1, c1)).astype(np.float32) * .2)
    w_up = jnp.asarray(rng.standard_normal((8, c1, c0)).astype(np.float32) * .2)
    w_sub2 = jnp.asarray(rng.standard_normal((27, c0, c0)).astype(np.float32) * .2)

    # ---- unsharded reference
    l0, l1 = plan.levels[0], plan.levels[1]
    tr = plan.transitions[0]
    x0 = gather_conv(jnp.asarray(feats), jnp.asarray(l0.nbr), w_sub0)
    x1 = gather_conv(x0, jnp.asarray(tr.child), w_down,
                     nbr_t=jnp.asarray(tr.up)[:, ::-1])
    x1 = gather_conv(x1, jnp.asarray(l1.nbr), w_sub1)
    x2 = gather_conv(x1, jnp.asarray(tr.up), w_up,
                     nbr_t=jnp.asarray(tr.child)[:, ::-1])
    ref = np.asarray(gather_conv(x2, jnp.asarray(l0.nbr), w_sub2))

    # ---- sharded
    mesh = Mesh(np.asarray(jax.devices()[:D]), (SPACE_AXIS,))
    s0, s1 = sp.levels[0], sp.levels[1]
    t = sp.transitions[0]

    def per_shard(f, a):
        f = f[0]
        def sub(x, sh_nbr, exch, w):
            ext = extend_features(x, exch[0][0], exch[1][0], exch[2][0],
                                  HALO)
            return gather_conv_fused(ext, sh_nbr[0], w)
        x0 = sub(f, a["n0"], (a["n0_sl"], a["n0_sr"], a["n0_pub"]), w_sub0)
        # down: coarse rows gather fine [local|halos|pool]
        ext = extend_features(x0, a["c_sl"][0], a["c_sr"][0],
                              a["c_pub"][0], HALO)
        x1 = gather_conv_fused(ext, a["child"][0], w_down)
        x1 = sub(x1, a["n1"], (a["n1_sl"], a["n1_sr"], a["n1_pub"]), w_sub1)
        # up: fine rows gather coarse [local|halos|pool]
        ext = extend_features(x1, a["u_sl"][0], a["u_sr"][0],
                              a["u_pub"][0], HALO)
        x2 = gather_conv_fused(ext, a["up"][0], w_up)
        x2 = sub(x2, a["n0"], (a["n0_sl"], a["n0_sr"], a["n0_pub"]), w_sub2)
        return x2[None]

    arrs = {
        "n0": s0.nbr_local, "n0_sl": s0.send_left, "n0_sr": s0.send_right,
        "n0_pub": s0.publish,
        "n1": s1.nbr_local, "n1_sl": s1.send_left, "n1_sr": s1.send_right,
        "n1_pub": s1.publish,
        "child": t["child"], "c_sl": t["child_send_left"],
        "c_sr": t["child_send_right"], "c_pub": t["child_publish"],
        "up": t["up"], "u_sl": t["up_send_left"],
        "u_sr": t["up_send_right"], "u_pub": t["up_publish"],
    }
    arrs = {k: jnp.asarray(v) for k, v in arrs.items()}

    S0 = CAPS[0] // D
    new_to_old0, old_to_new0 = sp.layouts[0]
    feats_sh = jnp.asarray(feats[new_to_old0]).reshape(D, S0, c0)
    out = jax.jit(jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(SPACE_AXIS), jax.tree.map(lambda _: P(SPACE_AXIS), arrs)),
        out_specs=P(SPACE_AXIS),
    ))(feats_sh, arrs)
    out = np.asarray(out).reshape(CAPS[0], c0)[old_to_new0]

    # the active-balanced layout aligns levels spatially; with this halo
    # nothing is dropped, so every active row must match exactly
    assert sp.dropped == 0, f"shard_plan dropped {sp.dropped} refs"
    np.testing.assert_allclose(out[:n0], ref[:n0], rtol=2e-3, atol=2e-4)


def test_shard_plan_reconstruction_invariant():
    """Every surviving ref in every sharded map must reconstruct to the
    ORIGINAL global row through its slot class (local / left halo / right
    halo / pool) — validates layouts, send lists, and publish sets
    together."""
    batch = make_batch(SceneConfig(num_points=3000, extent=48,
                                   num_objects=6), 1, 4096, 16, seed=3)
    plan = build_plan_host(batch["coords"], PlanSpec(caps=CAPS))
    sp = shard_plan(plan, D, HALO, pool=POOL)
    assert sp.dropped == 0

    def check(map_new, sh_map, sl, sr, pub, dst_layout, src_layout,
              src_cap):
        Ddim, Sdst, K = sh_map.shape
        Ssrc = src_cap // Ddim
        new_to_old_dst, _ = dst_layout
        new_to_old_src, old_to_new_src = src_layout
        checked = 0
        for d in range(Ddim):
            for s in range(Sdst):
                old_dst = new_to_old_dst[d * Sdst + s]
                for k in range(K):
                    l = sh_map[d, s, k]
                    want = map_new[d * Sdst + s, k]
                    if want < 0:
                        assert l < 0
                        continue
                    if l < Ssrc:                      # local
                        got = d * Ssrc + l
                    elif l < Ssrc + HALO:             # left halo
                        got = (d - 1) * Ssrc + sr[d - 1, l - Ssrc]
                    elif l < Ssrc + 2 * HALO:         # right halo
                        got = (d + 1) * Ssrc + sl[d + 1, l - Ssrc - HALO]
                    else:                             # pool
                        pslot = l - Ssrc - 2 * HALO
                        o, i = pslot // POOL, pslot % POOL
                        got = o * Ssrc + pub[o, i]
                    assert got == want, (d, s, k)
                    checked += 1
        return checked

    import numpy as np
    for li, (lvl, sh) in enumerate(zip(plan.levels, sp.levels)):
        lay = sp.layouts[li]
        from occuseg.parallel.spatial import _relay_map
        relaid = _relay_map(np.asarray(lvl.nbr), lay, lay)
        n = check(relaid, sh.nbr_local, sh.send_left, sh.send_right,
                  sh.publish, lay, lay, np.asarray(lvl.nbr).shape[0])
        assert n > 0, f"level {li} had no refs"


@pytest.mark.parametrize("d", [2, 4])
def test_shard_plan_other_shard_counts(d):
    """shard_plan correctness is not specific to D=8: zero drops and the
    reconstruction invariant hold at other shard counts."""
    batch = make_batch(SceneConfig(num_points=3000, extent=48,
                                   num_objects=6), 1, 4096, 16, seed=5)
    plan = build_plan_host(batch["coords"], PlanSpec(caps=CAPS))
    sp = shard_plan(plan, d, HALO, pool=POOL)
    assert sp.dropped == 0
    # active-balanced layout: each shard's actives are a slot-range prefix
    for li, (new_to_old, old_to_new) in enumerate(sp.layouts):
        n = int(plan.levels[li].num_active)
        cap = new_to_old.shape[0]
        S = cap // d
        active_new = np.sort(old_to_new[:n])
        for dd in range(d):
            in_shard = active_new[(active_new >= dd * S)
                                  & (active_new < (dd + 1) * S)]
            if in_shard.size:
                assert in_shard[0] == dd * S
                assert (np.diff(in_shard) == 1).all()
