"""Checkpoint import: the generated reference-name map must cover exactly
the flax parameter tree of LearningBWDenseUNet (structural parity with the
reference's state dict), and importing synthetic torch tensors must land in
the right leaves with the right transforms."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from occuseg.core.topology import PlanSpec, build_plan
from occuseg.models import LearningBWDenseUNet
from occuseg.train.checkpoint import (
    _flatten,
    import_torch_state_dict,
)
from occuseg.train.torch_import import learning_bw_name_map

from tests.utils import random_points

N_PLANES = (8, 16, 24)


def _variables():
    rng = np.random.default_rng(0)
    pts = random_points(rng, 300, extent=16, batch_size=1, pad_to=512)
    spec = PlanSpec(caps=(512, 256, 128))
    plan = build_plan(jnp.asarray(pts), spec)
    feats = jnp.asarray(rng.standard_normal((512, 3)).astype(np.float32))
    model = LearningBWDenseUNet(n_planes=N_PLANES, num_classes=20,
                                block_reps=1, residual_blocks=True)
    return model.init(jax.random.PRNGKey(0), feats, plan, False)


def test_name_map_covers_every_flax_leaf():
    variables = _variables()
    name_map = learning_bw_name_map(N_PLANES)
    flax_targets = set(name_map.values())
    param_paths = {"/".join(p) for p in _flatten(variables["params"])}
    stat_paths = {"/".join(p) for p in _flatten(variables["batch_stats"])}
    # batch_stats flax paths end in running_mean/running_var leaves
    missing_params = param_paths - flax_targets
    assert not missing_params, f"unmapped flax params: {sorted(missing_params)[:10]}"
    missing_stats = stat_paths - flax_targets
    assert not missing_stats, f"unmapped flax stats: {sorted(missing_stats)[:10]}"
    # and nothing in the map points at a non-existent leaf
    bogus = flax_targets - param_paths - stat_paths
    assert not bogus, f"map targets without leaves: {sorted(bogus)[:10]}"


def test_import_applies_values_and_transposes():
    variables = _variables()
    name_map = learning_bw_name_map(N_PLANES)
    flat_p = _flatten(variables["params"])
    flat_s = _flatten(variables["batch_stats"])
    rng = np.random.default_rng(1)
    sd = {}
    for tkey, fpath in name_map.items():
        path = tuple(fpath.split("/"))
        if tkey.endswith(("running_mean", "running_var")):
            shape = tuple(flat_s[path].shape)
            sd[tkey] = rng.standard_normal(shape).astype(np.float32)
        else:
            shape = tuple(flat_p[path].shape)
            if path[-1] == "kernel":
                shape = (shape[1], shape[0])  # torch Linear [out, in]
            sd[tkey] = rng.standard_normal(shape).astype(np.float32)
    params, stats = import_torch_state_dict(
        sd, variables["params"], variables["batch_stats"], name_map)
    new_p = _flatten(params)
    new_s = _flatten(stats)
    for tkey, fpath in name_map.items():
        path = tuple(fpath.split("/"))
        if tkey.endswith(("running_mean", "running_var")):
            np.testing.assert_array_equal(np.asarray(new_s[path]), sd[tkey])
        elif path[-1] == "kernel":
            np.testing.assert_array_equal(np.asarray(new_p[path]), sd[tkey].T)
        else:
            np.testing.assert_array_equal(np.asarray(new_p[path]), sd[tkey])
