"""The bench geometry must hold across scenes, not just the bench seed.

Builds FULL-SIZE bench scenes (bench.py's caps) for several seeds with the
C++ host planner and checks that no level truncates its voxels and that
the conv implementation the platform dispatches to matches the plain
reference on the coarse levels of each seed's real maps. Robustness at toy
sizes proves nothing, so the scenes are real size; the conv checks run on
the coarse levels, where the CPU reference is cheap.
"""

import jax.numpy as jnp
import pytest

from occuseg.core.topology import PlanSpec
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.native.plan import build_plan_host
from occuseg.ops import dispatch
from occuseg.utils.conv_check import conv_errors

# bench.py's geometry
CAPS = (196_608, 139_264, 63_488, 17_408, 4_096, 1_024)
WIDTHS = (64, 128, 192, 256, 320, 384)
SCENE = SceneConfig(num_points=200_000, extent=512, num_objects=24)


def _plan(seed, num_scenes=1):
    batch = make_batch(SCENE, num_scenes=num_scenes,
                       p_cap=262_144 * num_scenes, num_instances=64,
                       seed=seed)
    caps = tuple(c * num_scenes for c in CAPS)
    plan = build_plan_host(batch["coords"], PlanSpec(caps=caps))
    assert plan is not None, "native planner unavailable"
    return plan


@pytest.mark.parametrize("seed", range(6))
def test_all_levels_chunked_across_seeds(seed):
    """Every level of the seed's scene fits its cap, and the dispatched
    conv agrees with the reference on the level-4/5 maps and the
    4->5 transition (f32)."""
    import jax

    plan = _plan(seed)
    assert not bool(plan.overflow()), f"seed {seed}: a level truncated"
    conv = dispatch.impl().conv
    key = jax.random.PRNGKey(seed)
    lv, tr = plan.levels, plan.transitions
    cases = [(lv[4].nbr, None, lv[4].cap, 8, 8),
             (lv[5].nbr, None, lv[5].cap, 8, 8),
             (tr[4].child, tr[4].up[:, ::-1], lv[4].cap, 8, 16)]
    for nbr, nbr_t, n, cin, cout in cases:
        feats = jax.random.normal(key, (n, cin), jnp.float32)
        w = jax.random.normal(key, (nbr.shape[1], cin, cout), jnp.float32)
        err = conv_errors(conv, feats, jnp.asarray(nbr),
                          None if nbr_t is None else jnp.asarray(nbr_t),
                          w, jnp.float32)
        assert max(err.values()) < 1e-5, (seed, err)


def test_multi_scene_batch_chunked():
    """A 4-scene batch at 4x the caps fits every level."""
    plan = _plan(1, num_scenes=4)
    assert not bool(plan.overflow()), "multi-scene batch truncated"
