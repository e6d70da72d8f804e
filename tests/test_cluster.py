"""Instance extraction pipeline: supervoxel aggregation -> mean-shift ->
proposals -> precision/recall, on a synthetic scene where ground truth is
recoverable."""

import numpy as np

import jax.numpy as jnp

from occuseg.cluster import (
    aggregate_regions,
    filter_proposals,
    instance_precision_recall,
    meanshift_cluster,
    occupancy_merge,
)
from occuseg.cluster.evaluator import gt_instances
from occuseg.cluster.meanshift import labels_to_points

P = 2000
NUM_INST = 6
E = 8
R_CAP = 256


def _scene(seed=0):
    """Instances well-separated in embedding + space; supervoxels = spatial
    groups of ~8 points within one instance."""
    rng = np.random.default_rng(seed)
    iid = (np.arange(P) * NUM_INST // P).astype(np.int64)
    centers_e = rng.standard_normal((NUM_INST, E)) * 6
    centers_x = rng.uniform(0, 10, (NUM_INST, 3))
    emb = centers_e[iid] + rng.standard_normal((P, E)) * 0.15
    xyz = centers_x[iid] + rng.standard_normal((P, 3)) * 0.2
    displacement = xyz - centers_x[iid]  # perfect displacement regression
    bw = np.full((P, 2), 1.2, np.float32)
    offset = np.exp(-np.linalg.norm(displacement, axis=1) ** 2)[:, None]
    sem = (iid % 17 + 2).astype(np.int32)  # all foreground classes
    occupancy = np.full((P, 1), np.log(P // NUM_INST), np.float32)
    # supervoxels: consecutive groups of 8 points (within one instance)
    region = (np.arange(P) // 8).astype(np.int32)
    return dict(emb=emb.astype(np.float32), xyz=xyz.astype(np.float32),
                displacement=displacement.astype(np.float32), bw=bw,
                offset=offset.astype(np.float32), sem=sem,
                occupancy=occupancy, region=region, iid=iid)


def test_meanshift_recovers_instances():
    s = _scene()
    regions = aggregate_regions(
        jnp.asarray(s["emb"]), jnp.asarray(s["displacement"]),
        jnp.asarray(s["xyz"]), jnp.asarray(s["bw"]),
        jnp.asarray(s["offset"][:, 0]), jnp.asarray(s["sem"]),
        jnp.asarray(s["occupancy"][:, 0]), jnp.asarray(s["region"]), R_CAP)
    labels, count = meanshift_cluster(regions, max_instances=50)
    pt_labels = np.asarray(labels_to_points(labels, jnp.asarray(s["region"])))
    assert int(count) >= NUM_INST
    # each GT instance should map to exactly one predicted cluster
    for k in range(NUM_INST):
        got = pt_labels[s["iid"] == k]
        assert got.min() >= 0
        vals, cnts = np.unique(got, return_counts=True)
        assert cnts.max() / got.size > 0.95, f"instance {k} fragmented"
    # and distinct GT instances get distinct clusters
    modes = [np.bincount(pt_labels[s["iid"] == k]).argmax()
             for k in range(NUM_INST)]
    assert len(set(modes)) == NUM_INST


def test_end_to_end_precision_recall():
    s = _scene(1)
    regions = aggregate_regions(
        jnp.asarray(s["emb"]), jnp.asarray(s["displacement"]),
        jnp.asarray(s["xyz"]), jnp.asarray(s["bw"]),
        jnp.asarray(s["offset"][:, 0]), jnp.asarray(s["sem"]),
        jnp.asarray(s["occupancy"][:, 0]), jnp.asarray(s["region"]), R_CAP)
    labels, _ = meanshift_cluster(regions, max_instances=50)
    pt_labels = np.asarray(labels_to_points(labels, jnp.asarray(s["region"])))
    class_sizes = np.full(20, 10.0, np.float32)
    props = filter_proposals(pt_labels, s["sem"], s["occupancy"],
                             class_sizes=class_sizes)
    gts = gt_instances(s["iid"], s["sem"])
    res = instance_precision_recall([props], [gts], iou_threshold=0.5)
    assert res["mAP"] > 0.95, res
    assert res["mRecall"] > 0.95, res


def test_occupancy_merge_joins_fragments():
    """Two half-instances with identical embeddings and under-filled
    occupancy should merge into one cluster."""
    rng = np.random.default_rng(2)
    R = 8
    emb = np.zeros((R, 4), np.float32)
    emb[:4] = 1.0   # cluster A+B share an embedding region
    emb[4:] = -5.0  # cluster C far away
    pose = np.zeros((R, 3), np.float32)
    pose[4:] = 10.0
    bw = np.full((R, 2), 1.0, np.float32)
    count = np.full(R, 50.0, np.float32)
    occ = np.full(R, np.log(400.0), np.float32)  # objects "should" have 400
    cluster = np.array([0, 0, 1, 1, 2, 2, 2, 2], np.int32)
    merged = occupancy_merge(cluster, emb, pose, bw, count, occ)
    # A (regions 0-1, 100 pts) and B (regions 2-3, 100 pts) under-fill 400
    assert merged[0] == merged[2], merged
    # C stays separate
    assert merged[4] != merged[0]
    assert len({merged[4], merged[5], merged[6], merged[7]}) == 1


def test_submission_writer_and_fake_judge(tmp_path):
    from occuseg.cluster.submission import write_scene_submission

    rng = np.random.default_rng(5)
    n = 300
    proposals = [[] for _ in range(20)]
    proposals[4] = [rng.random(n) < 0.3, rng.random(n) < 0.2]
    proposals[7] = [rng.random(n) < 0.1]
    main = write_scene_submission(str(tmp_path), "scene0000_00", proposals)
    lines = open(main).read().strip().splitlines()
    assert len(lines) == 3
    rel, label, conf = lines[0].split()
    assert label == "5"  # class 4 -> NYU40 id 5
    mask = np.loadtxt(str(tmp_path / rel))
    assert mask.shape == (n,)
    assert set(np.unique(mask)).issubset({0.0, 1.0})


def test_joint_refine_recovers_and_refines_semantics():
    """joint_semantic_instance_segmentation analog: instances recovered in
    one shot from seeds; noisy per-point semantics corrected by the
    membership-weighted vote (evaluate_instance.py:809-964)."""
    from occuseg.cluster import joint_refine, region_semantic_probability

    s = _scene(2)
    # logits: mostly the true class, 20% of points corrupted
    rng = np.random.default_rng(0)
    true_cls = s["sem"]
    noisy = true_cls.copy()
    corrupt = rng.random(P) < 0.2
    noisy[corrupt] = rng.integers(0, 20, corrupt.sum())
    logits = np.full((P, 20), -4.0, np.float32)
    logits[np.arange(P), noisy] = 4.0

    regions = aggregate_regions(
        jnp.asarray(s["emb"]), jnp.asarray(s["displacement"]),
        jnp.asarray(s["xyz"]), jnp.asarray(s["bw"]),
        jnp.asarray(s["offset"][:, 0]), jnp.asarray(noisy),
        jnp.asarray(s["occupancy"][:, 0]), jnp.asarray(s["region"]), R_CAP)
    sem_prob = region_semantic_probability(
        jnp.asarray(logits), jnp.asarray(s["region"]), R_CAP)
    labels, sem_ref, count = joint_refine(regions, sem_prob,
                                          max_instances=50)
    pt_labels = np.asarray(labels_to_points(labels, jnp.asarray(s["region"])))
    pt_sem = np.asarray(labels_to_points(sem_ref, jnp.asarray(s["region"])))
    assert int(count) >= NUM_INST
    for k in range(NUM_INST):
        got = pt_labels[s["iid"] == k]
        assert got.min() >= 0
        vals, cnts = np.unique(got, return_counts=True)
        assert cnts.max() / got.size > 0.95, f"instance {k} fragmented"
        # refined semantics: the instance-wide vote overrides the 20% noise
        ref = pt_sem[s["iid"] == k]
        true_k = true_cls[s["iid"] == k][0]
        assert (ref == true_k).mean() > 0.95


def test_instance_average_precision_known_values():
    """Constructed scenes with hand-computable AP (benchmark protocol:
    ranked PR curve, one-to-one matching, duplicates are FPs)."""
    from occuseg.cluster.evaluator import instance_average_precision

    def mask(idx, n=100):
        m = np.zeros(n, bool)
        m[idx] = True
        return m

    g1 = mask(range(0, 10))
    g2 = mask(range(20, 30))
    # scene with two GT instances of class 0
    gts = [[[g1, g2]] + [[] for _ in range(19)]]

    # case 1: one perfect proposal, conf 1.0 -> AP = recall 0.5 area
    props = [[[g1]] + [[] for _ in range(19)]]
    r = instance_average_precision(props, gts)
    assert abs(r["mAP"] - 0.5) < 1e-6

    # case 2: perfect proposal at high conf + junk at low conf:
    # PR = (1.0 @ r=0.5), junk doesn't reduce achieved area -> AP 0.5
    junk = mask(range(50, 60))
    props = [[[g1, junk]] + [[] for _ in range(19)]]
    conf = [[[0.9, 0.1]] + [[] for _ in range(19)]]
    r = instance_average_precision(props, gts, conf)
    assert abs(r["mAP"] - 0.5) < 1e-6

    # case 3: junk ranked FIRST: precision at recall 0.5 is 1/2 -> AP 0.25
    conf = [[[0.1, 0.9]] + [[] for _ in range(19)]]
    r = instance_average_precision(props, gts, conf)
    assert abs(r["mAP"] - 0.25) < 1e-6

    # case 4: DUPLICATE detections of one GT: second match is a FP
    # (the reference's per-proposal metric would count both as TP)
    props = [[[g1, g1, g2]] + [[] for _ in range(19)]]
    conf = [[[0.9, 0.8, 0.7]] + [[] for _ in range(19)]]
    r = instance_average_precision(props, gts, conf)
    # PR points: (r=.5, p=1), dup fp, (r=1.0, p=2/3) -> 0.5*1 + 0.5*2/3
    assert abs(r["mAP"] - (0.5 + 0.5 * 2 / 3)) < 1e-6

    # case 5: both found perfectly -> AP 1.0
    props = [[[g1, g2]] + [[] for _ in range(19)]]
    r = instance_average_precision(props, gts)
    assert abs(r["mAP"] - 1.0) < 1e-6

    # multi-scene accumulation: one GT per scene, found in scene 1 only
    gts2 = [[[g1]] + [[] for _ in range(19)],
            [[g2]] + [[] for _ in range(19)]]
    props2 = [[[g1]] + [[] for _ in range(19)],
              [[]] + [[] for _ in range(19)]]
    r = instance_average_precision(props2, gts2)
    assert abs(r["mAP"] - 0.5) < 1e-6
