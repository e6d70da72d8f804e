"""Train state + single-device training step.

Replaces the reference training loop internals (`train_instance.py:345-485`):
Adam (lr 1e-3) with stepwise gamma decay (`:475-482`), full fwd/bwd over the
multi-task model, loss assembly via `losses.instance`. The step is one
jitted function that either takes a precomputed topology plan (the fast
path: built by the C++ host runtime in the loader, `native/plan.py`) or
builds it in-jit — either way the reference's lazy host-side rulebook
caching (`Metadata.cpp:503-530`) is replaced by explicit plan data.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import optax

from occuseg.core.topology import PlanSpec, build_plan
from occuseg.losses.instance import LossConfig, occuseg_total_loss


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrainState:
    params: Any
    batch_stats: Any
    opt_state: Any
    step: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Canonical hyperparams (reference `training_script/train_instance.sh`):
    Adam lr 1e-3, gamma 1e-2 every 200 epochs."""

    lr: float = 1e-3
    lr_decay_gamma: float = 1e-2
    lr_decay_steps: int = 200 * 240  # 200 epochs * ~240 steps/epoch
    optimizer: str = "adam"
    momentum: float = 0.9
    weight_decay: float = 1e-4
    # optax.flatten the whole transformation: one fused elementwise update
    # over a single concatenated vector instead of ~100 per-leaf fusions,
    # most of them tiny and launch-bound. Elementwise optimizers are
    # numerically identical under flattening.
    flatten_updates: bool = True
    # Gradient accumulation: the reference trains batch 5; N sequential
    # single-scene steps with accumulated gradients (optax.MultiSteps) give
    # mathematically the same mean-gradient update at batch-1 memory.
    accum_steps: int = 1


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    schedule = optax.exponential_decay(
        init_value=cfg.lr, transition_steps=cfg.lr_decay_steps,
        decay_rate=cfg.lr_decay_gamma, staircase=True)
    if cfg.optimizer == "adam":
        tx = optax.adam(schedule)
    elif cfg.optimizer == "sgd":
        # reference SGD branch (`train_instance.py` config['optim']=='SGD')
        tx = optax.chain(
            optax.add_decayed_weights(cfg.weight_decay),
            optax.sgd(schedule, momentum=cfg.momentum),
        )
    else:
        raise ValueError(cfg.optimizer)
    if cfg.accum_steps > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=cfg.accum_steps)
    if cfg.flatten_updates:
        tx = optax.flatten(tx)
    return tx


def create_train_state(model, rng, sample_batch: Dict[str, jnp.ndarray],
                       spec: PlanSpec, cfg: TrainConfig = TrainConfig()
                       ) -> TrainState:
    # jit the whole init: one compiled program instead of eager per-op
    # dispatch
    init_fn = jax.jit(
        lambda r, f, c: model.init(r, f, build_plan(c, spec), False))
    variables = init_fn(rng, sample_batch["features"], sample_batch["coords"])
    tx = make_optimizer(cfg)
    return TrainState(
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"]),
        step=jnp.zeros((), jnp.int32),
    )


def make_train_step(model, spec: PlanSpec, cfg: TrainConfig = TrainConfig(),
                    loss_cfg: LossConfig = LossConfig(),
                    num_scenes: int = 1, num_instances: int = 64,
                    axis_name: str | None = None,
                    use_normals: bool = False) -> Callable:
    """Build the (un-jitted) train step; wrap in jit/shard_map by caller.

    If `axis_name` is set, gradients and metrics are psum-averaged across the
    named mesh axis (data parallelism — SURVEY.md §2.5).
    `use_normals` makes the in-jit plan fallback consume batch["normals"]
    for orientation classes (--use_normal; host plans carry them already).
    """
    tx = make_optimizer(cfg)

    def loss_fn(params, batch_stats, batch, plan, w):
        if plan is None:
            plan = build_plan(batch["coords"], spec,
                              batch.get("normals") if use_normals else None)
        outputs, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats},
            batch["features"], plan, True, mutable=["batch_stats"])
        total, parts = occuseg_total_loss(
            outputs, batch, num_scenes, num_instances, loss_cfg)
        if w is not None:
            # per-device weight (DP remainder groups pad with w=0 copies so
            # no epoch batch is dropped); grad(w*L) = w*grad(L), psum'd and
            # normalized by psum(w) below
            total = total * w
        return total, (parts, mutated["batch_stats"])

    def train_step(state: TrainState, batch: Dict[str, jnp.ndarray],
                   plan=None) -> Tuple[TrainState, Dict[str, jnp.ndarray]]:
        """`plan`: optional precomputed Topology (host-built,
        `native/plan.py`); None builds it in-jit. batch may carry "_w", a
        per-device scalar loss weight (0 = padding device)."""
        batch = dict(batch)
        w = batch.pop("_w", None)
        params = state.params
        if axis_name is not None:
            # Differentiate w.r.t. a per-device (mesh-varying) copy of the
            # replicated params: each device gets its own gradient, which
            # the psum/pmean below averages. Against the replicated params
            # themselves, shard_map would psum the gradient implicitly, and
            # the custom-VJP conv's varying weight cotangent would not
            # match its replicated primal.
            params = jax.lax.pcast(params, axis_name, to="varying")
        (_, (parts, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, state.batch_stats, batch,
                                   plan, w)
        if axis_name is not None:
            if w is not None:
                denom = jnp.maximum(jax.lax.psum(w, axis_name), 1e-8)
                psum_mean = lambda t, s: jax.tree.map(
                    lambda x: jax.lax.psum(x * s, axis_name) / denom, t)
                grads = psum_mean(grads, 1.0)  # loss already scaled by w
                parts = psum_mean(parts, w)
                new_stats = psum_mean(new_stats, w)
            else:
                grads = jax.lax.pmean(grads, axis_name)
                parts = jax.lax.pmean(parts, axis_name)
                new_stats = jax.lax.pmean(new_stats, axis_name)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        return TrainState(params=new_params, batch_stats=new_stats,
                          opt_state=new_opt, step=state.step + 1), parts

    return train_step


def make_eval_step(model, spec: PlanSpec, use_normals: bool = False
                   ) -> Callable:
    """Forward pass in eval mode (running BN stats), jitted by caller."""

    def eval_step(state: TrainState, batch: Dict[str, jnp.ndarray],
                  plan=None):
        if plan is None:
            plan = build_plan(batch["coords"], spec,
                              batch.get("normals") if use_normals else None)
        return model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            batch["features"], plan, False)

    return eval_step
