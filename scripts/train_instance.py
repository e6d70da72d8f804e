#!/usr/bin/env python
"""CLI training entry point (reference `examples/ScanNet/train_instance.py`).

Canonical hyperparams as in `training_script/train_instance.sh`:
  python scripts/train_instance.py --m 64 --batch_size 5 --scale 50 \
      --residual_blocks --use_rotation_noise --use_dense_model \
      --lr 1e-3 --gamma 1e-2 --step_size 48000 --taskname instance_m64
"""

import logging
import sys

sys.path.insert(0, ".")

from occuseg.train.config import args_to_config, get_parser
from occuseg.train.loop import evaluate_semantic, train
from occuseg.utils.runtime import enable_compile_cache


def main() -> None:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args()
    config = args_to_config(args)
    if config["evaluate"]:
        raise SystemExit(
            "use scripts/evaluate_instance.py for instance evaluation")
    result = train(config)
    metrics = evaluate_semantic(config, result["state"], result["model"],
                                result["spec"])
    logging.info("val mean IoU: %.4f", metrics["mean_iou"])


if __name__ == "__main__":
    main()
