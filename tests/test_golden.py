"""Golden-value regression: frozen outputs of a fixed-seed model on a fixed
scene. Catches silent numeric changes when compute paths are swapped (XLA ->
Pallas, layout changes, dtype work). Regenerate with:
    python -m tests.test_golden regen
"""

import os

import numpy as np

import jax
import jax.numpy as jnp

from occuseg.core.topology import PlanSpec, build_plan
from occuseg.models import LearningBWDenseUNet

from tests.utils import random_points

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "flagship_small.npz")


def _compute():
    rng = np.random.default_rng(1234)
    pts = random_points(rng, 400, extent=24, batch_size=2, pad_to=512)
    spec = PlanSpec(caps=(512, 512, 512))  # no overflow: sparse
    # random scenes barely shrink under stride-2
    plan = build_plan(jnp.asarray(pts), spec)
    assert not bool(plan.overflow()), "golden scene must not overflow caps"
    feats = jnp.asarray(rng.standard_normal((512, 3)).astype(np.float32))
    model = LearningBWDenseUNet(n_planes=(8, 16, 24), num_classes=20)
    variables = model.init(jax.random.PRNGKey(7), feats, plan, False)
    out = model.apply(variables, feats, plan, False)
    return {
        "semantics": np.asarray(out.semantics),
        "embedding": np.asarray(out.embedding),
        "offset": np.asarray(out.offset),
        "occupancy": np.asarray(out.occupancy),
    }


def test_golden_outputs_stable():
    got = _compute()
    if not os.path.exists(GOLDEN):
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        np.savez_compressed(GOLDEN, **got)
        raise AssertionError(
            "golden file created on first run; re-run to compare")
    ref = np.load(GOLDEN)
    for k in got:
        np.testing.assert_allclose(
            got[k], ref[k], rtol=2e-3, atol=2e-4,
            err_msg=f"{k} drifted from golden values")


if __name__ == "__main__":
    import sys
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        np.savez_compressed(GOLDEN, **_compute())
        print("regenerated", GOLDEN)
