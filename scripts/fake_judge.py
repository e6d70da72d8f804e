#!/usr/bin/env python
"""Offline ScanNet-benchmark self-check (reference
`examples/ScanNet/fake_judge.py`): re-implements the benchmark's semantic
IoU scorer over submission .txt files so results can be validated before
uploading. Usage:
    python scripts/fake_judge.py --pred_dir preds/ --gt_dir gts/
Each file: one label id per line, aligned with the scene's vertices.
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, ".")

import numpy as np

from occuseg.utils.metrics import iou_from_confusion


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--num_classes", type=int, default=20)
    args = p.parse_args()

    conf = np.zeros((args.num_classes, args.num_classes), np.int64)
    for pf in sorted(glob.glob(os.path.join(args.pred_dir, "*.txt"))):
        gf = os.path.join(args.gt_dir, os.path.basename(pf))
        if not os.path.exists(gf):
            print(f"missing GT for {os.path.basename(pf)}; skipping")
            continue
        pred = np.loadtxt(pf, dtype=np.int64)
        gt = np.loadtxt(gf, dtype=np.int64)
        assert pred.shape == gt.shape, pf
        valid = (gt >= 0) & (gt < args.num_classes)
        np.add.at(conf, (gt[valid], np.clip(pred[valid], 0,
                                            args.num_classes - 1)), 1)
    res = iou_from_confusion(conf)
    print("per-class IoU:", np.round(res["iou_per_class"], 4))
    print("mean IoU: %.4f  accuracy: %.4f" % (res["mean_iou"],
                                              res["accuracy"]))


if __name__ == "__main__":
    main()
