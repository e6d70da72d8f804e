"""Checkpoint save/restore roundtrip, GC policy, metrics, counters, PLY."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from occuseg.core.topology import PlanSpec, build_plan
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.models import ThreeVoxelKernel
from occuseg.train import checkpoint as ckpt
from occuseg.train.state import create_train_state
from occuseg.utils.metrics import confusion_matrix, iou_from_confusion
from occuseg.utils.ply import write_labeled_ply
from occuseg.utils.profiling import plan_muladd_count
from occuseg.ops.conv import conv_flops
from occuseg.data.prepare import read_ply


def test_checkpoint_roundtrip_and_gc(tmp_path):
    spec = PlanSpec(caps=(1024, 1024, 512))
    b = make_batch(SceneConfig(num_points=600, extent=32, num_objects=4),
                   1, 1024, 8, seed=0)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    model = ThreeVoxelKernel(n_planes=(8, 16, 24))
    state = create_train_state(model, jax.random.PRNGKey(0), batch, spec)

    root = str(tmp_path / "ckpts")
    for step in (1, 2, 3, 64, 65):
        ckpt.save_checkpoint(root, jax.device_get(state), step=step)
    assert ckpt.latest_checkpoint(root).endswith("step_65")
    restored = ckpt.restore_checkpoint(ckpt.latest_checkpoint(root),
                                       jax.device_get(state))
    for a, b_ in zip(jax.tree_util.tree_leaves(state.params),
                     jax.tree_util.tree_leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
    ckpt.gc_checkpoints(root)
    kept = sorted(os.listdir(root))
    # powers of two + multiples of 64 + latest survive; 3 and 65... 65 is
    # the max -> kept; 3 is neither -> gone
    assert "step_3" not in kept
    assert "step_64" in kept and "step_65" in kept


def test_checkpoint_restore_rejects_other_tree(tmp_path):
    state = {"a": np.arange(3.0), "b": {"c": np.ones((2, 2), np.float32)}}
    path = ckpt.save_checkpoint(str(tmp_path), state, step=4)
    assert path.endswith("step_4")
    back = ckpt.restore_checkpoint(path, state)
    np.testing.assert_array_equal(back["b"]["c"], state["b"]["c"])
    assert back["b"]["c"].dtype == np.float32
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore_checkpoint(path, {"a": np.arange(3.0)})


def test_checkpoint_write_leaves_no_temp_file(tmp_path):
    path = ckpt.save_checkpoint(str(tmp_path), {"x": np.zeros(2)}, step=1)
    assert os.listdir(path) == ["state.npz"]


def test_confusion_matrix_and_iou():
    gt = jnp.asarray(np.array([0, 0, 1, 1, 2, -1], np.int32))
    pred = jnp.asarray(np.array([0, 1, 1, 1, 0, 0], np.int32))
    conf = np.asarray(confusion_matrix(pred, gt, num_classes=3))
    assert conf.sum() == 5  # -1 ignored
    assert conf[0, 0] == 1 and conf[0, 1] == 1 and conf[1, 1] == 2
    res = iou_from_confusion(conf)
    np.testing.assert_allclose(res["iou_per_class"][1], 2 / 3, rtol=1e-6)
    assert 0 < res["mean_iou"] < 1


def test_muladd_counter_consistent_with_conv_flops():
    spec = PlanSpec(caps=(512, 512, 256))
    b = make_batch(SceneConfig(num_points=400, extent=16, num_objects=4),
                   1, 512, 8, seed=1)
    plan = build_plan(jnp.asarray(b["coords"]), spec)
    planes = (8, 16, 24)
    total = plan_muladd_count(plan, planes, block_reps=1, residual=True,
                              input_channels=3)
    # must at least include the input subconv + one enc conv at level 0
    base = int(conv_flops(plan.levels[0].nbr, 3, 8))
    assert total > base
    # and scale roughly with the rulebook pair count
    pairs0 = int(np.sum(np.asarray(plan.levels[0].nbr) >= 0))
    assert total > pairs0 * 8 * 8


def test_ply_export_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.uniform(0, 5, (50, 3)).astype(np.float32)
    labels = rng.integers(0, 20, 50).astype(np.int32)
    p = str(tmp_path / "out.ply")
    write_labeled_ply(p, xyz, labels)
    v = read_ply(p)
    np.testing.assert_allclose(v["x"], xyz[:, 0], rtol=1e-6)
    assert "red" in v
