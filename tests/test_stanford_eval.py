"""Stanford3D / S3DIS class-count handling (VERDICT r2 #8).

--dataset stanford3d must flow class_num=14 (reference
`evaluate_instance.py:1332-1337`) through model output width, the eval
confusion matrix, and the weighted-CE table — no hardcoded 20s.
"""

import numpy as np

import jax.numpy as jnp

from occuseg.train.config import args_to_config, get_parser
from occuseg.utils.metrics import (
    STANFORD_CLASS_LABELS,
    confusion_matrix,
    iou_from_confusion,
)


def test_stanford_config_class_num():
    args = get_parser().parse_args(["--dataset", "stanford3d"])
    config = args_to_config(args)
    assert config["class_num"] == 14
    args = get_parser().parse_args([])
    assert args_to_config(args)["class_num"] == 20


def test_confusion_matrix_respects_class_num():
    gt = jnp.asarray(np.array([0, 5, 13, 14, 19, -1], np.int32))
    pred = jnp.asarray(np.array([0, 5, 13, 2, 3, 1], np.int32))
    conf = np.asarray(confusion_matrix(pred, gt, num_classes=14))
    assert conf.shape == (14, 14)
    # out-of-range gt rows (14, 19) and padding (-1) are ignored
    assert conf.sum() == 3
    assert conf[0, 0] == 1 and conf[5, 5] == 1 and conf[13, 13] == 1
    res = iou_from_confusion(conf)
    assert res["mean_iou"] == 1.0


def test_stanford_eval_loop_14_classes(tmp_path):
    """evaluate_semantic on a 14-class model: 14x14 confusion, finite IoU
    (synthetic labels beyond 13 count as ignored)."""
    from occuseg.train.loop import (
        build_model,
        build_spec,
        evaluate_semantic,
        train,
    )

    args = get_parser().parse_args([
        "--dataset", "stanford3d", "--m", "8", "--batch_size", "1",
        "--residual_blocks", "--use_dense_model", "--max_epoch", "1",
        "--point_cap", "2048", "--voxel_cap", "2048",
        "--instance_cap", "8", "--num_devices", "1",
        "--checkpoints_dir", str(tmp_path),
        "--data_dir", str(tmp_path / "nodata"),
    ])
    config = args_to_config(args)
    config["unet_structure"] = [8, 16]
    result = train(config, max_steps=1)
    model = result["model"]
    assert model.num_classes == 14
    metrics = evaluate_semantic(config, result["state"], model,
                                result["spec"])
    assert len(metrics["iou_per_class"]) == 14
    assert 0.0 <= metrics["mean_iou"] <= 1.0
    assert len(STANFORD_CLASS_LABELS) == 13  # reference utils.py table
