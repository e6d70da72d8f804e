"""Bucketed static shapes: bucket selection, overflow retry, padding win."""

import numpy as np

from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.train.bucketing import (
    bucket_specs,
    count_voxels,
    pick_bucket,
    plan_for_batch,
)


def test_bucket_specs_shapes():
    specs = bucket_specs(262_144, 6, num_buckets=3)
    assert len(specs) == 3
    assert specs[0].caps[0] < specs[1].caps[0] < specs[2].caps[0]
    assert specs[2].caps[0] >= 262_144
    for s in specs:
        assert len(s.caps) == 6
        assert all(c % 1024 == 0 for c in s.caps)


def test_small_scene_picks_small_bucket():
    small = make_batch(SceneConfig(num_points=3000, extent=64), 1, 16384, 16,
                       seed=0)
    big = make_batch(SceneConfig(num_points=120_000, extent=512), 1,
                     262_144, 16, seed=0)
    specs = bucket_specs(262_144, 4, num_buckets=3)
    i_small = pick_bucket(specs, small["coords"])
    i_big = pick_bucket(specs, big["coords"])
    assert i_small == 0
    assert i_big > i_small


def test_plan_for_batch_no_overflow():
    b = make_batch(SceneConfig(num_points=20000, extent=128), 1, 65536, 16,
                   seed=1)
    specs = bucket_specs(131_072, 4, num_buckets=3)
    i, plan = plan_for_batch(specs, b["coords"])
    assert plan is not None
    for l in plan.levels:
        assert int(l.num_active) < l.keys.shape[0]
    # count matches the plan's level-0 active count
    assert count_voxels(b["coords"]) == int(plan.levels[0].num_active)
