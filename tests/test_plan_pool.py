"""Multi-process plan pool (native/pool.py): ordered results identical to
the in-process builder, window bounded, bucket assignment preserved."""

import numpy as np
import pytest

from occuseg.core.topology import PlanSpec
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.native.plan import build_plan_host
from occuseg.native.pool import PlanPool

SPEC = PlanSpec(caps=(1024, 512))
SCENE = SceneConfig(num_points=1500, extent=48, num_objects=5)


def _batches(n):
    return [make_batch(SCENE, 1, 2048, 8, seed=s) for s in range(n)]


def test_pool_matches_inprocess_and_order():
    batches = _batches(4)
    ref = [build_plan_host(b["coords"], SPEC) for b in batches]
    if ref[0] is None:
        pytest.skip("native planner unavailable")
    with PlanPool(SPEC, workers=2) as pool:
        out = list(pool.imap(iter(batches)))
    assert len(out) == 4
    for (b, plan, bi), b_in, r in zip(out, batches, ref):
        assert b is b_in  # batches never round-trip through the pool
        assert bi == 0
        np.testing.assert_array_equal(np.asarray(plan.levels[0].keys),
                                      np.asarray(r.levels[0].keys))
        np.testing.assert_array_equal(np.asarray(plan.levels[0].nbr),
                                      np.asarray(r.levels[0].nbr))


def test_pool_reuse_across_epochs():
    batches = _batches(2)
    if build_plan_host(batches[0]["coords"], SPEC) is None:
        pytest.skip("native planner unavailable")
    with PlanPool(SPEC, workers=2) as pool:
        a = list(pool.imap(iter(batches)))
        b = list(pool.imap(iter(batches)))
    assert len(a) == len(b) == 2
