"""Instance-AP accuracy gate (VERDICT r3 task 8, hardened in r5).

A deterministic synthetic overfit soak must reach an instance AP@0.5
floor through the REAL clustering cascade (aggregate_regions ->
mean-shift -> occupancy merge -> filter_proposals -> benchmark AP) — so
a quality regression anywhere in the model, losses, GT plumbing, or the
cluster cascade fails CI even when losses still look plausible.

Calibration evidence (experiments/r4_ap_gate_calib.py round 4;
/tmp/r5_ap_floor_calib round 5, 450 steps, lr 1e-3):

  baseline   seed 7/8/9: AP@0.5 = 1.000 / 0.562 / 0.800  (mean 0.787)
  occ_zeroed seed 7 (300 steps): AP 0.000 — loss still falls; the
             untrained occupancy head breaks filter_proposals' size
             filter and occupancy_merge (the canonical silent regression)
  emb_zeroed seed 7 (300 steps): AP 0.417 — mean-shift degrades

The gate: mean AP over seeds {7,8,9} > 0.6 AND each seed > 0.35.

Displacement is gated DIRECTLY (not via AP): r5 calibration showed no
AP formulation makes it load-bearing at gate scale — the overfit
embedding separates even face-sharing same-class triples
(disp_zeroed AP 1.000 on that family), and the gate-sized model does
not generalize to held-out scenes at all (everything 0.000), see
experiments/r5_ap_triples_calib.py. But the CONTRACTION RATIO
separates cleanly: per-instance spread of regressed poses
(pose - displacement) over spread of raw poses is ~0.99 for the
trained head vs 4.84 with the displacement loss zeroed (the untrained
head emits large noise that EXPANDS instances 5x). Floor: ratio < 1.5
— the regressed poses a broken displacement head/loss/GT pipeline
produces would wreck the reference's pose_embedding clustering
(train_instance.py:217-236, aggregate_regions pose term).
"""

import numpy as np

import jax
import jax.numpy as jnp

from occuseg.cluster import (
    aggregate_regions,
    filter_proposals,
    meanshift_cluster,
    occupancy_merge,
)
from occuseg.cluster.evaluator import (
    gt_instances,
    instance_average_precision,
)
from occuseg.cluster.meanshift import labels_to_points
from occuseg.core.topology import PlanSpec
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.models import LearningBWDenseUNet
from occuseg.native.plan import build_plan_host
from occuseg.train.state import (
    TrainConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
)

SPEC = PlanSpec(caps=(2048, 1024, 512))
N_STEPS = 450
SEEDS = (7, 8, 9)
R_CAP = 256
# synthetic objects are ~260 points; the reference class-size filter
# (DEFAULT_CLASS_SIZES) is scaled for real ScanNet rooms
CLASS_SIZES = np.full(20, 100.0, np.float32)


def _gt_regions(batch, valid):
    """GT-derived supervoxels: spatial subgroups within each instance.

    Held constant across code changes — the gate tests the model + losses
    + cluster cascade, not supervoxel generation (covered by
    test_data_native.py)."""
    iid = np.asarray(batch["instance_id"])
    cell = (batch["coords"][:, 1:] // 8).astype(np.int64)
    key = (iid.astype(np.int64) + 1) * 1_000_000 + (
        cell[:, 0] * 10_000 + cell[:, 1] * 100 + cell[:, 2])
    _, region = np.unique(key, return_inverse=True)
    return np.where(valid, region, -1).astype(np.int32)


def _instance_ap(model, state, batch, plan_j, region, valid):
    ev = jax.jit(make_eval_step(model, SPEC))
    out = ev(state, {k: jnp.asarray(v) for k, v in batch.items()}, plan_j)
    sem_pred = np.asarray(jnp.argmax(out.semantics, -1))

    region_j = jnp.asarray(region)
    regions = aggregate_regions(
        out.embedding.astype(jnp.float32),
        out.displacement.astype(jnp.float32),
        jnp.asarray(batch["pose"], jnp.float32),
        out.bw.astype(jnp.float32),
        out.offset.astype(jnp.float32).reshape(-1),
        jnp.asarray(sem_pred),
        out.occupancy.astype(jnp.float32).reshape(-1),
        region_j, R_CAP)
    labels, _ = meanshift_cluster(regions)
    labels_np = occupancy_merge(
        np.asarray(labels), np.asarray(regions.embedding),
        np.asarray(regions.pose_embedding), np.asarray(regions.bw),
        np.asarray(regions.count), np.asarray(regions.occupancy))
    pts = np.asarray(labels_to_points(jnp.asarray(labels_np), region_j))
    props = filter_proposals(
        pts[valid], sem_pred[valid],
        np.asarray(out.occupancy).reshape(-1)[valid],
        class_sizes=CLASS_SIZES, occupancy_lo=0.1, occupancy_hi=10.0)
    gts = gt_instances(batch["instance_id"][valid].astype(np.int64),
                       batch["labels"][valid].astype(np.int64))
    return instance_average_precision([props], [gts],
                                      iou_threshold=0.5)["mAP"]


def _soak(seed):
    batch = make_batch(SceneConfig(num_points=2500, extent=40,
                                   num_objects=6),
                       num_scenes=1, p_cap=4096, num_instances=16,
                       seed=seed)
    plan = build_plan_host(batch["coords"], SPEC)
    plan_j = (jax.tree.map(jnp.asarray, plan) if plan is not None else None)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    valid = np.asarray(batch["labels"]) >= 0
    region = _gt_regions(batch, valid)

    model = LearningBWDenseUNet(n_planes=(8, 16, 24), num_classes=20,
                                block_reps=1, residual_blocks=True)
    cfg = TrainConfig(lr=1e-3)
    state = create_train_state(model, jax.random.PRNGKey(0), batch_j, SPEC,
                               cfg)
    step = jax.jit(make_train_step(model, SPEC, cfg, num_instances=16))
    parts = None
    for _ in range(N_STEPS):
        state, parts = step(state, batch_j, plan_j)
    assert np.isfinite(float(parts["total"])), parts
    return model, state, batch, plan_j, region, valid


def _contraction(model, state, batch, plan_j):
    """Per-instance spread of regressed poses over spread of raw poses."""
    ev = jax.jit(make_eval_step(model, SPEC))
    out = ev(state, {k: jnp.asarray(v) for k, v in batch.items()}, plan_j)
    pose = np.asarray(batch["pose"], np.float32)
    disp = np.asarray(out.displacement, np.float32)
    reg = pose - disp
    iid = np.asarray(batch["instance_id"])
    fg = (iid >= 0) & (np.asarray(batch["labels"]) >= 2)
    num = den = 0.0
    for i in np.unique(iid[fg]):
        m = fg & (iid == i)
        num += float(np.linalg.norm(reg[m] - reg[m].mean(0), axis=1).mean())
        den += float(np.linalg.norm(pose[m] - pose[m].mean(0),
                                    axis=1).mean())
    return num / den


def test_soak_reaches_instance_ap_floor():
    aps = {}
    contraction = None
    for seed in SEEDS:
        model, state, batch, plan_j, region, valid = _soak(seed)
        aps[seed] = _instance_ap(model, state, batch, plan_j, region, valid)
        if contraction is None:
            contraction = _contraction(model, state, batch, plan_j)
    mean_ap = float(np.mean(list(aps.values())))
    # calibrated r5 @450 steps: per-seed 1.000/0.562/0.800, mean 0.787;
    # occ-zeroed collapses seed 7 to 0.000 and emb-zeroed to ~0.4 (r4)
    assert mean_ap > 0.6, f"mean instance AP@0.5 regressed: {aps}"
    assert min(aps.values()) > 0.35, f"per-seed AP@0.5 regressed: {aps}"
    # displacement gate: trained head ~0.99 vs 4.84 with its loss zeroed
    assert contraction < 1.5, (
        f"displacement head regressed: regressed-pose contraction "
        f"{contraction:.3f} (trained ~0.99, broken ~4.8)")
