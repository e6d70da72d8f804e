#!/usr/bin/env python
"""Checkpoint-parity gate: validate a reference-format .pth in one command
(VERDICT r2 #6; reference README Quickstart §3 `baseline_m64.pth`,
consumed by `training_script/evaluate_instance.sh`).

    python scripts/checkpoint_parity.py --checkpoint_file ckpts/baseline_m64.pth \
        --m 64 --residual_blocks --use_dense_model [--data_dir data/scannet]

Stages:
  1. IMPORT — load the torch state dict into LearningBWDenseUNet
     (`train/torch_import.py`): verifies every key maps and every shape
     matches. Unmapped/missing keys are a hard failure.
  2. ACTIVATION DIFF — run the torch oracle (`tests/torch_oracle.py`, the
     re-derivation of the reference module tree) WITH THE CHECKPOINT'S OWN
     WEIGHTS and this model side-by-side on a fixed deterministic scene;
     report max abs diff per head. Expected: < 1e-3 in f32 (the golden test
     holds 1e-4 on random weights; trained weights can amplify slightly).
     Skipped (with a warning) if torch cannot load the oracle.
  3. VAL mAP — unless --skip_eval, run the full instance-eval pipeline
     (scripts/evaluate_instance.py machinery) on the val split and print
     mAP@0.25/0.5. Expected: within 0.5 pts of the reference's number for
     the same checkpoint (BASELINE.md rebuild target).

Exit code 0 only if stages 1-2 pass their tolerances.
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp

from occuseg.utils.runtime import enable_compile_cache

TOL = 1e-3


def main() -> None:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO)
    from occuseg.train.config import args_to_config, get_parser
    parser = get_parser()
    parser.add_argument("--skip_eval", action="store_true", default=False,
                        help="stop after the activation diff (no val mAP)")
    parser.add_argument("--region_cap", type=int, default=4096)
    parser.add_argument("--use_merge", action="store_true", default=True)
    parser.add_argument("--use_joint_refine", action="store_true",
                        default=False)
    parser.add_argument("--bw_relax_factor", type=float, default=1.0)
    parser.add_argument("--merge_threshold", type=float, default=0.5)
    parser.add_argument("--occupancy_lo", type=float, default=0.3)
    parser.add_argument("--occupancy_hi", type=float, default=3.0)
    args = parser.parse_args()
    config = args_to_config(args)
    config["use_dense_model"] = True
    path = config.get("load")
    if not path or not os.path.exists(path):
        raise SystemExit(f"--checkpoint_file {path!r} not found")

    from occuseg.core.topology import PlanSpec
    from occuseg.data.synthetic import SceneConfig, make_batch
    from occuseg.models import LearningBWDenseUNet
    from occuseg.native.plan import build_plan_host
    from occuseg.train.torch_import import load_baseline_checkpoint

    planes = tuple(int(x) for x in config["unet_structure"])
    reps = int(config.get("block_reps", 1))

    # fixed deterministic probe scene (small caps so this runs anywhere)
    p_cap = 8192
    spec = PlanSpec(caps=(4096, 2048, 1024, 1024, 1024, 1024)[:len(planes)])
    batch = make_batch(SceneConfig(num_points=6000, extent=96,
                                   num_objects=8),
                       num_scenes=1, p_cap=p_cap, num_instances=16, seed=11)
    plan = build_plan_host(batch["coords"], spec)
    if plan is None:
        raise SystemExit("native plan builder unavailable")
    feats = np.random.default_rng(5).standard_normal(
        (p_cap, config["input_feature_number"])).astype(np.float32)

    model = LearningBWDenseUNet(n_planes=planes, num_classes=config
                                ["class_num"], block_reps=reps,
                                residual_blocks=config["residual_blocks"])
    plan_j = jax.tree.map(jnp.asarray, plan)
    feats_j = jnp.asarray(feats)
    variables = jax.jit(
        lambda r: model.init(r, feats_j, plan_j, False))(
        jax.random.PRNGKey(0))

    # ---- stage 1: import ----
    logging.info("stage 1: importing %s", path)
    params, stats = load_baseline_checkpoint(
        path, model, variables["params"], variables.get("batch_stats", {}),
        planes, reps, config["residual_blocks"])
    logging.info("stage 1 PASS: all keys mapped, all shapes match")

    out = model.apply({"params": params, "batch_stats": stats},
                      feats_j, plan_j, False)

    # ---- stage 2: activation diff vs the torch oracle ----
    stage2_ok = True
    try:
        import torch
        from tests.torch_oracle import OracleLearningBWDenseUNet

        oracle = OracleLearningBWDenseUNet(
            planes, config["class_num"], plan,
            in_ch=config["input_feature_number"], reps=reps)
        sd = torch.load(path, map_location="cpu")
        sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
        sd = {k[7:] if k.startswith("module.") else k: v
              for k, v in sd.items()}
        oracle.load_state_dict(sd, strict=True)
        oracle.eval()
        with torch.no_grad():
            t_out = oracle(torch.from_numpy(feats))
        heads = ("semantics", "features", "embedding", "offset",
                 "displacement", "bw", "occupancy")
        for name, t in zip(heads, t_out):
            j = np.asarray(getattr(out, name), np.float32)
            d = float(np.max(np.abs(j - t.numpy())))
            ok = d < TOL
            stage2_ok &= ok
            logging.info("stage 2 %-12s max|Δ| = %.2e %s", name, d,
                         "OK" if ok else f"FAIL (tol {TOL})")
        logging.info("stage 2 %s", "PASS" if stage2_ok else "FAIL")
    except Exception as e:
        logging.warning("stage 2 skipped (torch oracle unavailable): %r", e)

    # ---- stage 3: full val instance eval ----
    if not args.skip_eval:
        import importlib.util
        spec_ = importlib.util.spec_from_file_location(
            "eval_script",
            os.path.join(os.path.dirname(__file__),
                         "evaluate_instance.py"))
        ev = importlib.util.module_from_spec(spec_)
        spec_.loader.exec_module(ev)
        logging.info("stage 3: val instance mAP (expected within 0.5 pts "
                     "of the reference for the same checkpoint)")
        ev.score_scenes(ev.infer_scenes(config, args), args)

    raise SystemExit(0 if stage2_ok else 1)


if __name__ == "__main__":
    main()
