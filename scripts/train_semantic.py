#!/usr/bin/env python
"""Semantic-only training (reference legacy `examples/ScanNet/train.py`):
ThreeVoxelKernel backbone, semantic CE only."""

import logging
import sys

sys.path.insert(0, ".")

from occuseg.train.config import args_to_config, get_parser
from occuseg.train.loop import evaluate_semantic, train
from occuseg.utils.runtime import enable_compile_cache


def main() -> None:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args()
    config = args_to_config(args)
    config["use_dense_model"] = False  # InstanceDenseUNet w/o bw heads
    result = train(config)
    m = evaluate_semantic(config, result["state"], result["model"],
                          result["spec"])
    logging.info("val mean IoU: %.4f", m["mean_iou"])


if __name__ == "__main__":
    main()
