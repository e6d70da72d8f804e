#!/usr/bin/env python
"""Semantic test-split inference + ScanNet benchmark submission files
(reference `examples/ScanNet/test.py`): run the semantic model on each
test scene (multi-rotation logit averaging like `val_reps`), map the 20
class ids back to NYU40 label ids, and write one `<scene>.txt` per scene
with a per-point label id — the ScanNet semantic-benchmark upload format.
"""

import logging
import os
import sys

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp

from occuseg.train.config import args_to_config, get_parser
from occuseg.train.loop import build_model, build_spec, get_dataset
from occuseg.train.state import create_train_state, make_eval_step
from occuseg.utils.runtime import enable_compile_cache

# 20-class index -> NYU40 label id (reference test.py SELECTED_LABEL_IDS)
SELECTED_LABEL_IDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24,
                      28, 33, 34, 36, 39]


def main() -> None:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO)
    parser = get_parser()
    parser.add_argument("--out_dir", default="submission_semantic")
    args = parser.parse_args()
    config = args_to_config(args)

    model = build_model(config)
    spec = build_spec(config)
    dataset = get_dataset(config)
    p_cap, i_cap = config["point_cap"], config["instance_cap"]
    reps = max(int(config.get("val_reps", 1)), 1)

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
    os.makedirs(args.out_dir, exist_ok=True)
    per_rep = [dataset.val_batches(p_cap, i_cap, 1, val_rep=r)
               for r in range(reps)]
    for si, raws in enumerate(zip(*per_rep)):
        store = None
        valid = None
        for raw in raws:
            batch = {k: jnp.asarray(v) for k, v in raw.items()
                     if k != "region"}
            out = ev(state, batch)
            logits = np.asarray(out.semantics)
            store = logits if store is None else store + logits
            valid = np.asarray(raw["coords"])[:, 0] >= 0
        pred = np.argmax(store, axis=-1)
        labels = np.asarray(SELECTED_LABEL_IDS, np.int64)[pred]
        name = f"scene{si:04d}"
        fn = os.path.join(args.out_dir, f"{name}.txt")
        np.savetxt(fn, labels[valid], fmt="%d")
        logging.info("wrote %s (%d points)", fn, int(valid.sum()))


if __name__ == "__main__":
    main()
