"""Generic classification train/validate harness (reference
`sparseconvnet/classificationTrainValidate.py:42` — the SparseConvNet
utility for whole-shape classification datasets). Runs an ActivePooling-
headed model over (point cloud, class) datasets with the same reporting."""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from occuseg.core.topology import PlanSpec, build_plan

log = logging.getLogger("occuseg")


def classification_train_validate(model, spec: PlanSpec,
                                  train_iter: Callable[[], Iterable],
                                  val_iter: Callable[[], Iterable],
                                  num_epochs: int = 10, lr: float = 1e-3
                                  ) -> Dict:
    """Batches: dicts with 'coords' [P,4], 'features' [P,C], 'label' [B]."""
    tx = optax.adam(lr)

    sample = next(iter(train_iter()))
    init_fn = jax.jit(
        lambda r, f, c: model.init(r, f, build_plan(c, spec), False))
    variables = init_fn(jax.random.PRNGKey(0),
                        jnp.asarray(sample["features"]),
                        jnp.asarray(sample["coords"]))
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    opt_state = tx.init(params)

    @jax.jit
    def step(params, stats, opt_state, feats, coords, labels):
        def loss_fn(p):
            plan = build_plan(coords, spec)
            logits, mut = model.apply(
                {"params": p, "batch_stats": stats}, feats, plan, True,
                mutable=["batch_stats"])
            logp = jax.nn.log_softmax(logits)
            nll = -jnp.take_along_axis(logp, labels[:, None], axis=1).mean()
            return nll, (mut.get("batch_stats", stats), logits)

        (loss, (new_stats, logits)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        acc = jnp.mean(jnp.argmax(logits, -1) == labels)
        return params, new_stats, opt_state, loss, acc

    @jax.jit
    def infer(params, stats, feats, coords):
        plan = build_plan(coords, spec)
        return model.apply({"params": params, "batch_stats": stats}, feats,
                           plan, False)

    history = []
    for epoch in range(num_epochs):
        t0 = time.time()
        losses, accs = [], []
        for b in train_iter():
            params, stats, opt_state, loss, acc = step(
                params, stats, opt_state, jnp.asarray(b["features"]),
                jnp.asarray(b["coords"]), jnp.asarray(b["label"]))
            losses.append(float(loss))
            accs.append(float(acc))
        v_accs = []
        for b in val_iter():
            logits = infer(params, stats, jnp.asarray(b["features"]),
                           jnp.asarray(b["coords"]))
            v_accs.append(
                float(jnp.mean(jnp.argmax(logits, -1)
                               == jnp.asarray(b["label"]))))
        log.info("epoch %d: loss %.4f train acc %.3f val acc %.3f (%.1fs)",
                 epoch, np.mean(losses), np.mean(accs),
                 np.mean(v_accs) if v_accs else float("nan"),
                 time.time() - t0)
        history.append({"loss": float(np.mean(losses)),
                        "train_acc": float(np.mean(accs)),
                        "val_acc": float(np.mean(v_accs)) if v_accs else None})
    return {"params": params, "batch_stats": stats, "history": history}
