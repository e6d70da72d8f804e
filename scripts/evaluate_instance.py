#!/usr/bin/env python
"""Instance-segmentation evaluation (reference
`examples/ScanNet/evaluate_instance.py`): run the model on the val split,
extract instances via supervoxel mean-shift (+ optional occupancy merge),
filter proposals, report precision/recall at IoU 0.25 / 0.5.

Two-stage workflow (reference parity: `train_instance.py:143-163` dumps
per-scene .npz predictions, `evaluate_instance.py:1249-1316` clusters and
scores them OFFLINE so clustering hyperparameters can be swept without
re-running the net):

  * default: inference + clustering inline;
  * `--dump DIR`: inference only — write one .npz per scene with the
    reference's offline_data schema (xyz, pred_embedding, pred_semantic,
    pred_semantic_probability, pred_offsets, pred_displacements, pred_bw,
    occupancy, regions, true_*, scale);
  * `--from_dump DIR`: no model, no accelerator — load the .npz files and run
    clustering/merge/refine/metrics; `--bw_relax_factor`,
    `--merge_threshold` etc. can be swept cheaply. Reproduces the inline
    numbers exactly (both paths share `cluster_and_score`).
"""

import glob
import logging
import os
import sys

sys.path.insert(0, ".")

import numpy as np
import jax
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
from occuseg.train.config import args_to_config, get_parser
from occuseg.utils.runtime import enable_compile_cache


def cluster_and_score(scene: dict, args) -> tuple:
    """One scene's clustering: dump-schema dict -> (proposals, gts).

    `scene` uses the reference offline_data keys (train_instance.py:143-163)
    as numpy arrays over the scene's REAL points (no padding rows).
    """
    num_classes = int(scene["pred_semantic_probability"].shape[1])
    pose = scene["xyz"].astype(np.float32) / float(scene["scale"])
    region = jnp.asarray(scene["regions"].astype(np.int32))
    sem_pred = jnp.asarray(scene["pred_semantic"].astype(np.int32))
    regions = aggregate_regions(
        jnp.asarray(scene["pred_embedding"]),
        jnp.asarray(scene["pred_displacements"]),
        jnp.asarray(pose),
        jnp.asarray(scene["pred_bw"]),
        jnp.asarray(scene["pred_offsets"].reshape(-1)),
        sem_pred,
        jnp.asarray(scene["occupancy"].reshape(-1)),
        region, args.region_cap, num_classes=num_classes)
    if args.use_joint_refine:
        from occuseg.cluster import joint_refine

        # per-region mean class probability from the dumped point probs
        p = jnp.asarray(scene["pred_semantic_probability"], jnp.float32)
        seg = jnp.where(region >= 0, region, args.region_cap)
        num = jax.ops.segment_sum(p, seg, num_segments=args.region_cap + 1)
        cnt = jax.ops.segment_sum(jnp.ones(p.shape[:1], jnp.float32), seg,
                                  num_segments=args.region_cap + 1)
        sem_prob = (num / jnp.maximum(cnt[:, None], 1))[:args.region_cap]
        labels, sem_ref, _ = joint_refine(regions, sem_prob)
        sem_pred = labels_to_points(sem_ref, region)
    else:
        labels, _ = meanshift_cluster(
            regions, bw_relax_factor=args.bw_relax_factor)
    labels_np = np.asarray(labels)
    if args.use_merge:
        labels_np = occupancy_merge(
            labels_np, np.asarray(regions.embedding),
            np.asarray(regions.pose_embedding), np.asarray(regions.bw),
            np.asarray(regions.count), np.asarray(regions.occupancy),
            bw_relax_factor=args.bw_relax_factor,
            similarity_threshold=args.merge_threshold)
    pts = np.asarray(labels_to_points(jnp.asarray(labels_np), region))
    props = filter_proposals(pts, np.asarray(sem_pred),
                             np.asarray(scene["occupancy"]),
                             occupancy_lo=args.occupancy_lo,
                             occupancy_hi=args.occupancy_hi,
                             num_classes=num_classes)
    gts = gt_instances(scene["true_instance"].astype(np.int64),
                       scene["true_semantic"].astype(np.int64),
                       num_classes=num_classes)
    return props, gts, np.asarray(sem_pred)


def infer_scenes(config, args):
    """Yield (scene_name, dump-schema dict) for each val scene."""
    from occuseg.train.loop import build_model, build_spec, get_dataset
    from occuseg.train.state import create_train_state, make_eval_step

    model = build_model(config)
    spec = build_spec(config)
    dataset = get_dataset(config)
    p_cap, i_cap = config["point_cap"], config["instance_cap"]

    sample = next(iter(dataset.val_batches(p_cap, i_cap, 1)))
    sample_j = {k: jnp.asarray(v) for k, v in sample.items()
                if k != "region"}
    state = create_train_state(model, jax.random.PRNGKey(0), sample_j, spec)
    if config.get("load"):
        from occuseg.train.checkpoint import (
            latest_checkpoint,
            restore_checkpoint,
        )
        path = config["load"]
        if os.path.isdir(path) and latest_checkpoint(path):
            path = latest_checkpoint(path)
        state = restore_checkpoint(path, jax.device_get(state))
        logging.info("restored %s", path)

    ev = jax.jit(make_eval_step(model, spec))
    for i, raw in enumerate(dataset.val_batches(p_cap, i_cap, 1)):
        batch = {k: jnp.asarray(v) for k, v in raw.items() if k != "region"}
        out = ev(state, batch)
        valid = np.asarray(raw["coords"])[:, 0] >= 0
        region = np.asarray(raw.get(
            "region", np.arange(p_cap, dtype=np.int32) // 16))
        probs = np.asarray(jax.nn.softmax(
            out.semantics.astype(jnp.float32), axis=-1))
        scale = float(config.get("scale", 20))
        # reference offline_data schema (train_instance.py:143-163)
        scene = {
            "xyz": np.asarray(raw["pose"], np.float32)[valid] * scale,
            "feature": np.asarray(raw["features"])[valid],
            "occupancy": np.asarray(out.occupancy)[valid, 0],
            "true_occupancy": np.asarray(raw["occupancy"])[valid, 0],
            "pred_semantic": np.asarray(
                jnp.argmax(out.semantics, axis=-1))[valid],
            "pred_semantic_probability": probs[valid],
            "pred_embedding": np.asarray(out.embedding)[valid],
            "regions": region[valid],
            "true_semantic": np.asarray(raw["labels"])[valid],
            "true_instance": np.asarray(raw["instance_id"])[valid],
            "pred_offsets": np.asarray(out.offset)[valid],
            "true_offsets": np.asarray(raw["offsets"])[valid],
            "pred_displacements": np.asarray(out.displacement)[valid],
            "true_displacements": np.asarray(raw["displacements"])[valid],
            "pred_bw": np.asarray(out.bw)[valid],
            "scale": scale,
        }
        yield f"scene{i:04d}", scene


def score_scenes(scenes, args) -> dict:
    from occuseg.cluster.evaluator import per_proposal_statistics

    all_props, all_gts, per_scene_stats = [], [], []
    gt_pts = None
    pred_pts = None
    for name, scene in scenes:
        props, gts, sem_pred = cluster_and_score(scene, args)
        all_props.append(props)
        all_gts.append(gts)
        # per-proposal statistics block (reference instance_stat.mat
        # schema, evaluate_instance.py:1548-1552)
        per_scene_stats.append(
            per_proposal_statistics(props, gts, sem_pred))
        c_num = len(props)
        if gt_pts is None:
            gt_pts = np.zeros(c_num)
            pred_pts = np.zeros(c_num)
        for c in range(c_num):
            gt_pts[c] += sum(int(v.sum()) for v in gts[c])
            pred_pts[c] += sum(int(u.sum()) for u in props[c])

    stats = {"per_proposal": np.stack(per_scene_stats)
             if per_scene_stats else np.zeros((0, 0, 5, 1000)),
             "pts_per_class": gt_pts,
             "predict_pts_per_class": pred_pts}
    for thr in (0.25, 0.5):
        # reference-parity metric (precision reported as "mAP",
        # evaluate_instance.py:1703-1741) ...
        res = instance_precision_recall(all_props, all_gts,
                                        iou_threshold=thr)
        logging.info("ref-mAP@%.2f: %.4f  mRecall@%.2f: %.4f", thr,
                     res["mAP"], thr, res["mRecall"])
        stats[f"precision_{int(thr*100)}"] = res["precision_per_class"]
        stats[f"recall_{int(thr*100)}"] = res["recall_per_class"]
        # ... and the benchmark-grade AP (ranked PR curve, one-to-one
        # matching — the ScanNet protocol)
        from occuseg.cluster.evaluator import instance_average_precision
        ap = instance_average_precision(all_props, all_gts,
                                        iou_threshold=thr)
        logging.info("AP@%.2f: %.4f (benchmark protocol)", thr, ap["mAP"])
        stats[f"ap_{int(thr*100)}"] = ap["ap_per_class"]
    return stats


def main() -> None:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO)
    parser = get_parser()
    parser.add_argument("--use_merge", action="store_true", default=False)
    parser.add_argument("--use_joint_refine", action="store_true",
                        default=False,
                        help="joint semantic-instance refinement "
                             "(evaluate_instance.py:809-964): single-shot "
                             "seeded membership + membership-weighted "
                             "semantic re-vote")
    parser.add_argument("--region_cap", type=int, default=4096)
    parser.add_argument("--dump", default="",
                        help="write per-scene prediction .npz to this dir "
                             "and exit (no clustering)")
    parser.add_argument("--from_dump", default="",
                        help="cluster + score .npz predictions from this "
                             "dir (no model / accelerator needed)")
    parser.add_argument("--bw_relax_factor", type=float, default=1.0)
    parser.add_argument("--merge_threshold", type=float, default=0.5)
    parser.add_argument("--occupancy_lo", type=float, default=0.3)
    parser.add_argument("--occupancy_hi", type=float, default=3.0)
    args = parser.parse_args()
    config = args_to_config(args)
    config["use_dense_model"] = True

    if args.from_dump:
        files = sorted(glob.glob(os.path.join(args.from_dump, "*.npz")))
        if not files:
            raise SystemExit(f"no .npz files under {args.from_dump}")
        logging.info("offline clustering over %d dumped scenes", len(files))
        scenes = ((os.path.basename(f),
                   dict(np.load(f, allow_pickle=False))) for f in files)
        stats = score_scenes(scenes, args)
    elif args.dump:
        os.makedirs(args.dump, exist_ok=True)
        for name, scene in infer_scenes(config, args):
            fn = os.path.join(args.dump, f"{name}.npz")
            np.savez(fn, **scene)
            logging.info("save: %s", fn)
        return
    else:
        stats = score_scenes(infer_scenes(config, args), args)

    # instance statistics export (reference writes instance_stat.mat,
    # evaluate_instance.py:1548-1552, :1699, schema
    # {'stats': [files, class_num, 5, 1000], 'pts_per_class',
    #  'predict_pts_per_class'}); per-class PR/AP aggregates ride along
    try:
        import scipy.io
        mat = {"stats": stats.pop("per_proposal"),
               "pts_per_class": stats.pop("pts_per_class"),
               "predict_pts_per_class": stats.pop("predict_pts_per_class")}
        mat.update(stats)
        scipy.io.savemat("instance_stat.mat", mat)
        logging.info("wrote instance_stat.mat")
    except Exception as e:
        logging.warning("could not write instance_stat.mat: %s", e)


if __name__ == "__main__":
    main()
