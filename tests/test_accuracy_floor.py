"""Accuracy-floor regression gate (VERDICT r2 #9).

A short deterministic overfit run on one synthetic batch must reach loss
and instance-IoU floors. A silent quality regression anywhere in the
training path (augmentation GT, loss masking, conv/BN math, optimizer
wiring) fails this test instead of passing CI with plausible-looking but
wrong numbers. Thresholds are ~2x slack off the measured trajectory
(see values in asserts; calibrated on the round-3 tree).
"""

import numpy as np

import jax
import jax.numpy as jnp

from occuseg.core.topology import PlanSpec
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.models import LearningBWDenseUNet
from occuseg.native.plan import build_plan_host
from occuseg.train.state import (
    TrainConfig,
    create_train_state,
    make_train_step,
)

N_STEPS = 50


def test_short_overfit_reaches_floors():
    spec = PlanSpec(caps=(2048, 1024, 512))
    batch = make_batch(SceneConfig(num_points=2500, extent=40,
                                   num_objects=6),
                       num_scenes=1, p_cap=4096, num_instances=16, seed=7)
    plan = build_plan_host(batch["coords"], spec)
    plan_j = (jax.tree.map(jnp.asarray, plan) if plan is not None else None)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}

    model = LearningBWDenseUNet(n_planes=(8, 16, 24), num_classes=20,
                                block_reps=1, residual_blocks=True)
    cfg = TrainConfig(lr=1e-3)
    state = create_train_state(model, jax.random.PRNGKey(0), batch_j, spec,
                               cfg)
    step = jax.jit(make_train_step(model, spec, cfg, num_instances=16))

    first = None
    parts = None
    for _ in range(N_STEPS):
        state, parts = step(state, batch_j, plan_j)
        if first is None:
            first = {k: float(v) for k, v in parts.items()}
    last = {k: float(v) for k, v in parts.items()}

    assert np.isfinite(last["total"]), last
    # measured trajectory (seed 7, 50 steps, round-3 tree): total 70.3 ->
    # 21.4, instance_iou 0.07 -> 0.50, regression 37.7 -> 8.9 (the
    # semantic term barely moves at this tiny width — not asserted)
    assert last["total"] < 0.5 * first["total"], (first, last)
    assert last["total"] < 30.0, last
    assert last["regression_loss"] < 0.5 * first["regression_loss"], (
        first, last)
    assert last["instance_iou"] > 0.3, last
