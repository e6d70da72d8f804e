"""Training / evaluation driver (reference `train_instance.py:345-485`).

Epoch loop over the ScanNet dataset (or the synthetic generator when no
data directory exists): jitted DP train step, per-epoch losses + MulAdd
counters + wall time to stdout and TensorBoard, periodic IoU eval and
snapshots with power-of-2 GC, KeyboardInterrupt snapshot
(`train_instance.py:612-618`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Dict, Iterable, Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from occuseg.core.topology import PlanSpec
from occuseg.data.scannet import ScanNetData
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.losses.instance import LossConfig
from occuseg.models import LearningBWDenseUNet, InstanceDenseUNet
from occuseg.parallel.data_parallel import (
    make_dp_train_step,
    make_mesh,
    replicate_state,
    shard_batch,
    shard_plans,
)
from occuseg.train import checkpoint as ckpt
from occuseg.train.config import plan_caps
from occuseg.train.state import (
    TrainConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from occuseg.utils.metrics import confusion_matrix, iou_from_confusion
from occuseg.utils.profiling import CounterState, plan_muladd_count

log = logging.getLogger("occuseg")


def build_model(config: Dict):
    planes = tuple(int(x) for x in config["unet_structure"])
    cls = (LearningBWDenseUNet if config.get("use_dense_model")
           else InstanceDenseUNet)
    return cls(n_planes=planes, num_classes=config.get("class_num", 20),
               block_reps=config.get("block_reps", 1),
               residual_blocks=config.get("residual_blocks", True),
               normal_guided=bool(config.get("use_normal", False)))


def build_spec(config: Dict) -> PlanSpec:
    # --use_normal: orientation classes only at levels
    # 0..rotation_guide_level (reference `model.py:662-663`
    # normal_guide_scale = (full_scale >> rotation_guide_level) + 1)
    guide = (int(config.get("rotation_guide_level", 0)) + 1
             if config.get("use_normal") else None)
    return PlanSpec(caps=tuple(plan_caps(config)),
                    kernel=config.get("kernel_size", 3),
                    guide_levels=guide)


def _synthetic_dataset(config: Dict):
    """Stand-in dataset when --data_dir has no scenes."""
    class _Synth:
        def __init__(self):
            self.train = list(range(32))
            self.val = list(range(4))
            self.scene = SceneConfig(num_points=20000, extent=256,
                                     scale=config["scale"])

        def train_batches(self, rng, p_cap, i_cap, batch_size):
            for s in range(0, len(self.train), batch_size):
                yield make_batch(self.scene, min(batch_size, 4), p_cap,
                                 i_cap, seed=int(rng.integers(1 << 30)))

        def val_batches(self, p_cap, i_cap, batch_size, val_rep=0):
            for s in range(0, len(self.val), batch_size):
                yield make_batch(self.scene, min(batch_size, 4), p_cap,
                                 i_cap, seed=1000 + s)

    return _Synth()


def get_dataset(config: Dict):
    ds = ScanNetData(config)
    try:
        ds.load_data()
    except Exception:
        pass
    if not ds.train:
        log.warning("no scenes under %s — using the synthetic generator",
                    config.get("data_dir"))
        return _synthetic_dataset(config)
    return ds


def plan_prefetcher(batches: Iterable[Dict], spec, depth: int = 2,
                    bucket_specs_list=None, spatial: Optional[Dict] = None,
                    use_normals: bool = False, ns: int = 1
                    ) -> Iterator[Tuple[Dict, Optional[object], int]]:
    """Yield (batch, host_plan, bucket_index) with the C++ plan built one
    batch ahead in a worker thread — the loader-side analog of the
    reference's DataLoader workers overlapping rulebook prep with GPU
    compute. host_plan is None when the native library is unavailable (step
    builds it in-jit). With `bucket_specs_list`, each batch gets the
    smallest cap bucket that fits (train/bucketing.py). With `spatial`
    (dict of shards/halo/pool), the sharded plan (prepare_shard_args) is
    ALSO built in the worker and yielded as the second element. `ns` > 1
    (multi-scene batches, no spatial): the BLOCKED layout
    (native/blocked.py)."""
    from occuseg.native import retain_malloc
    from occuseg.native.plan import build_plan_host

    retain_malloc()  # plan arrays are ~150 MB/batch; avoid refaulting
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()
    blocked = ns > 1 and spatial is None

    def worker():
        try:
            for b in batches:
                if bucket_specs_list is not None:
                    from occuseg.train.bucketing import plan_for_batch
                    bi, plan = plan_for_batch(
                        bucket_specs_list, b["coords"],
                        b.get("normals") if use_normals else None,
                        ns=ns if blocked else 1)
                elif blocked:
                    from occuseg.native.blocked import (
                        build_plan_host_blocked,
                    )
                    bi, plan = 0, build_plan_host_blocked(
                        b["coords"], spec, ns,
                        b.get("normals") if use_normals else None)
                else:
                    bi, plan = 0, build_plan_host(
                        b["coords"], spec,
                        b.get("normals") if use_normals else None)
                if plan is not None and spatial is None:
                    from occuseg.core.point_layout import (
                        apply_point_layout, augment_plan_with_point_layout,
                    )
                    plan = augment_plan_with_point_layout(plan)
                    b = apply_point_layout(b, plan)
                if spatial is not None and plan is not None:
                    from occuseg.parallel.spatial_model import (
                        prepare_shard_args,
                    )
                    plan = prepare_shard_args(
                        plan, spatial["shards"], halo=spatial["halo"],
                        pool=spatial["pool"])
                q.put((b, plan, bi))
        finally:
            q.put(DONE)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            break
        yield item


def _host_plan_any(coords: np.ndarray, spec, normals=None,
                   ns: int = 1) -> object:
    """Host plan via the C++ builder, or the jitted builder when the spec
    is one the C++ builder does not cover (returns NumPy leaves either
    way). `normals` [P,3] enable the plan's per-level orientation classes
    (--use_normal). `ns` > 1 builds the BLOCKED multi-scene layout
    (native/blocked.py: per-scene sub-caps)."""
    from occuseg.core.topology import build_plan
    from occuseg.native import retain_malloc
    from occuseg.native.plan import build_plan_host

    retain_malloc()  # plan arrays are ~150 MB/batch; avoid refaulting
    if ns > 1:
        from occuseg.native.blocked import build_plan_host_blocked
        plan = build_plan_host_blocked(coords, spec, ns, normals)
    else:
        plan = build_plan_host(coords, spec, normals)
    if plan is None:
        if normals is not None:
            plan = jax.device_get(jax.jit(
                lambda c, n: build_plan(c, spec, n))(
                jnp.asarray(coords), jnp.asarray(normals)))
        else:
            plan = jax.device_get(
                jax.jit(lambda c: build_plan(c, spec))(jnp.asarray(coords)))
    return plan


def dp_plan_prefetcher(batches: Iterable[Dict], spec, n_dev: int,
                       depth: int = 2, use_normals: bool = False,
                       bucket_specs_list=None, ns: int = 1
                       ) -> Iterator[Tuple[Dict, object, int]]:
    """Group `n_dev` consecutive per-device batches, build each one's
    topology plan on the host, and yield (stacked_batch, stacked_plans, 0)
    — all prepared one group ahead in a worker thread so no plan is ever
    built inside the DP trace (VERDICT r1 #2).

    The epoch's remainder group is padded with copies of its last batch at
    loss weight 0 ("_w"), so no scenes are dropped. With
    `bucket_specs_list`, the whole group shares the smallest bucket that
    fits its largest member (stacked plans need identical caps)."""
    from occuseg.parallel.data_parallel import stack_plans

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()

    def pack(group, weights):
        bi = 0
        group_spec = spec
        if bucket_specs_list is not None:
            from occuseg.train.bucketing import pick_bucket
            bi = max(pick_bucket(bucket_specs_list, b["coords"])
                     for b in group)
            group_spec = bucket_specs_list[bi]
        plans = [_host_plan_any(b["coords"], group_spec,
                                b.get("normals") if use_normals else None,
                                ns=ns)
                 for b in group]
        from occuseg.core.point_layout import (
            apply_point_layout, augment_plan_with_point_layout,
        )
        plans = [augment_plan_with_point_layout(p) for p in plans]
        group = [apply_point_layout(b, p) for b, p in zip(group, plans)]
        stacked = {k: np.stack([b[k] for b in group])
                   for k in group[0] if k != "region"}
        stacked["_w"] = np.asarray(weights, np.float32)
        return stacked, stack_plans(plans), bi

    def worker():
        try:
            group = []
            for b in batches:
                group.append(b)
                if len(group) == n_dev:
                    q.put(pack(group, [1.0] * n_dev))
                    group = []
            if group:
                pad = n_dev - len(group)
                w = [1.0] * len(group) + [0.0] * pad
                q.put(pack(group + [group[-1]] * pad, w))
        finally:
            q.put(DONE)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            break
        yield item


def train(config: Dict, max_steps: Optional[int] = None) -> Dict:
    rng = np.random.default_rng(100)  # reference seeds (scannet.py:44-47)
    model = build_model(config)
    spec = build_spec(config)
    dataset = get_dataset(config)
    p_cap = config["point_cap"]
    i_cap = config["instance_cap"]
    n_dev = config.get("num_devices") or len(jax.devices())
    n_dev = min(n_dev, len(jax.devices()))
    batch_per_dev = max(config["batch_size"] // n_dev, 1)
    # multi-scene per-device batches default to the BLOCKED row layout
    # (native/blocked.py): per-scene sub-caps so each scene's gathers read
    # a single-scene-sized table window. Spatial sharding splits by voxel
    # range instead and keeps the concatenated layout.
    blocked_ns = (batch_per_dev
                  if batch_per_dev > 1 and config.get("blocked_batch", True)
                  and int(config.get("spatial_shards", 0) or 0) <= 1
                  else 1)

    tcfg = TrainConfig(
        lr=config["lr"],
        lr_decay_gamma=config["gamma"] if config["gamma"] > 0 else 1e-2,
        lr_decay_steps=config.get("step_size", 60000),
        optimizer=config.get("optim", "Adam").lower(),
        accum_steps=int(config.get("accum_steps", 1)),
    )
    from occuseg.losses.semantic import (
        SCANNET_CE_WEIGHTS,
        STANFORD_CE_WEIGHTS,
    )
    lcfg = LossConfig(
        regress_weight=config.get("regress_weight", 100.0),
        num_classes=config.get("class_num", 20),
        semantic_loss=config.get("loss", "cross_entropy"),
        ce_weights=(STANFORD_CE_WEIGHTS
                    if config.get("dataset") == "stanford3d"
                    else SCANNET_CE_WEIGHTS),
        drift_weight=float(config.get("drift_weight", 0.0)))

    sample = next(iter(dataset.train_batches(rng, p_cap, i_cap,
                                             batch_per_dev)))
    sample_j = {k: jnp.asarray(v) for k, v in sample.items()
                if k != "region"}
    state = create_train_state(model, jax.random.PRNGKey(0), sample_j, spec,
                               tcfg)

    # Resume (reference `train_instance.py:579-581` --checkpoint_file and
    # `:377` --checkpoint epoch offset): restore the full TrainState
    # (params, BN stats, optimizer state, step) before any replication.
    start_epoch = int(config.get("checkpoint", 0) or 0)
    if config.get("load"):
        path = config["load"]
        if os.path.isdir(path) and ckpt.latest_checkpoint(path):
            path = ckpt.latest_checkpoint(path)
        if str(path).endswith((".pth", ".pt")):
            # reference torch checkpoint: import weights + BN stats only
            from occuseg.train.torch_import import (
                load_baseline_checkpoint,
            )
            params, stats = load_baseline_checkpoint(
                path, model, state.params, state.batch_stats,
                tuple(int(x) for x in config["unet_structure"]),
                config.get("block_reps", 1),
                config.get("residual_blocks", True))
            state = dataclasses.replace(state, params=params,
                                        batch_stats=stats)
        else:
            state = ckpt.restore_checkpoint(path, state)
        log.info("resumed from %s (start epoch %d)", path, start_epoch)

    # cap buckets: one jitted step per bucket (params/opt state shared —
    # they do not depend on the caps)
    num_buckets = int(config.get("num_buckets", 1))
    buckets = None
    if num_buckets > 1:
        from occuseg.train.bucketing import bucket_specs
        buckets = bucket_specs(config["voxel_cap"],
                               len(config["unet_structure"]), num_buckets,
                               kernel=config.get("kernel_size", 3))

    mesh = None
    n_spatial = int(config.get("spatial_shards", 0) or 0)
    if n_spatial > 1:
        # CP-style spatial sharding: every batch's voxels split over
        # `spatial_shards` chips (parallel/spatial_model.py); the plan is
        # host-sharded per batch (prepare_shard_args)
        from jax.sharding import Mesh
        from occuseg.parallel.spatial import SPACE_AXIS
        from occuseg.parallel.spatial_model import make_spatial_train_step

        n_spatial = min(n_spatial, len(jax.devices()))
        smesh = Mesh(np.asarray(jax.devices()[:n_spatial]), (SPACE_AXIS,))
        planes = tuple(int(x) for x in config["unet_structure"])
        step_fn = jax.jit(make_spatial_train_step(
            smesh, planes, tcfg, lcfg, num_scenes=batch_per_dev,
            num_instances=i_cap,
            block_reps=config.get("block_reps", 1),
            residual_blocks=config.get("residual_blocks", True),
            num_classes=config.get("class_num", 20)),
            donate_argnums=0)
        step_fns = None
        # buckets compose with spatial sharding: the prefetcher picks the
        # bucket BEFORE prepare_shard_args (plan_prefetcher worker order),
        # and the spatial step takes shard args as data, so the single jit
        # retraces once per bucket's shard-arg shapes — no per-bucket
        # closures needed
        n_dev = 1  # batches flow through the single-stream prefetcher
    elif n_dev > 1:
        mesh = make_mesh(n_dev)

        def make_dp_fn(s):
            return make_dp_train_step(model, s, mesh, tcfg, lcfg,
                                      num_scenes=batch_per_dev,
                                      num_instances=i_cap)
        if buckets is not None:
            # buckets compose with DP: the prefetcher assigns one bucket
            # per GROUP (stacked plans share caps), one jitted step each
            step_fns = [make_dp_fn(s) for s in buckets]
            step_fn = step_fns[-1]
        else:
            step_fn = make_dp_fn(spec)
            step_fns = [step_fn]
        state = replicate_state(state, mesh)
    else:
        def make_fn(s):
            # donate_argnums=0: the TrainState is consumed every step —
            # aliasing params/opt-state buffers saves the copy traffic
            return jax.jit(make_train_step(
                model, s, tcfg, lcfg, num_scenes=batch_per_dev,
                num_instances=i_cap,
                use_normals=bool(config.get("use_normal"))),
                donate_argnums=0)
        if buckets is not None:
            step_fns = [make_fn(s) for s in buckets]
            step_fn = step_fns[-1]
        else:
            step_fn = make_fn(spec)
            step_fns = [step_fn]

    ckpt_dir = os.path.join(config["checkpoints_dir"],
                            config.get("taskname", "default"))
    writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter
        writer = SummaryWriter(os.path.join(ckpt_dir, "tb"))
        writer.add_text("config", str(config))
    except Exception:
        pass

    # multi-threaded plan building (reference DataLoader num_workers
    # analog; threads are fork-safe under the live JAX runtime and the
    # C++ planner releases the GIL — native/pool.py). Single-stream path
    # only — DP groups and spatial shard-prep keep the single prefetch
    # thread (their per-group packing is already overlapped)
    plan_pool = None
    n_workers = int(config.get("plan_workers", 0) or 0)
    if n_workers > 1 and n_dev == 1 and n_spatial <= 1:
        from occuseg.native.pool import PlanPool
        plan_pool = PlanPool(
            spec, n_workers,
            use_normals=bool(config.get("use_normal")),
            bucket_specs_list=buckets, ns=blocked_ns)

    step = 0
    try:
        for epoch in range(start_epoch, int(config.get("max_epoch", 1))):
            t0 = time.time()
            agg: Dict[str, float] = {}
            nb = 0
            counters = CounterState()
            batches = dataset.train_batches(rng, p_cap, i_cap, batch_per_dev)
            if n_dev > 1:
                # group n_dev consecutive per-device batches (each a whole
                # set of scenes — never split a scene's rows across chips);
                # host plans are built in the prefetch thread and fed to the
                # step as sharded pytree inputs
                source = dp_plan_prefetcher(
                    batches, spec, n_dev,
                    use_normals=bool(config.get("use_normal")),
                    bucket_specs_list=buckets,
                    ns=blocked_ns)
            elif plan_pool is not None:
                source = plan_pool.imap(batches)
            else:
                spatial = (dict(shards=n_spatial,
                                halo=int(config.get("spatial_halo", 4096)),
                                pool=int(config.get("spatial_pool", 4096)))
                           if n_spatial > 1 else None)
                source = plan_prefetcher(
                    batches, spec, bucket_specs_list=buckets,
                    spatial=spatial,
                    use_normals=bool(config.get("use_normal")),
                    ns=blocked_ns)
            counters = CounterState()
            planes = tuple(int(x) for x in config["unet_structure"])
            for raw, host_plan, bucket_i in source:
                if host_plan is not None and n_spatial <= 1 and n_dev == 1:
                    # per-epoch MulAdd/hidden counters, protocol parity with
                    # the reference's per-epoch printout
                    # (train_instance.py:459-462)
                    counters.add(
                        plan_muladd_count(
                            host_plan, planes, config.get("block_reps", 1),
                            config.get("residual_blocks", True),
                            config["input_feature_number"]),
                        sum(int(np.sum(l.num_active))
                            * planes[min(i, len(planes) - 1)]
                            for i, l in enumerate(host_plan.levels)),
                        scenes=batch_per_dev)
                if n_dev > 1:
                    # host_plan is the [D]-stacked plan pytree; count the
                    # real (weight-1) devices' plans
                    for d in range(n_dev):
                        if raw["_w"][d] <= 0:
                            continue
                        plan_d = jax.tree.map(lambda x: x[d], host_plan)
                        counters.add(
                            plan_muladd_count(
                                plan_d, planes, config.get("block_reps", 1),
                                config.get("residual_blocks", True),
                                config["input_feature_number"]),
                            sum(int(np.sum(l.num_active))
                                * planes[min(i, len(planes) - 1)]
                                for i, l in enumerate(plan_d.levels)),
                            scenes=batch_per_dev)
                    batch = shard_batch(raw, mesh)
                    plans = shard_plans(host_plan, mesh)
                    fn = step_fns[bucket_i] if step_fns else step_fn
                    state, parts = fn(state, batch, plans)
                elif n_spatial > 1:
                    raw = {k: v for k, v in raw.items() if k != "region"}
                    batch = {k: jnp.asarray(v) for k, v in raw.items()}
                    sa = host_plan  # prefetcher yields shard args here
                    if sa is None:  # no native builder: in-jit plan
                        from occuseg.core.topology import build_plan
                        from occuseg.parallel.spatial_model import (
                            prepare_shard_args,
                        )
                        plan = jax.device_get(jax.jit(
                            lambda c: build_plan(c, spec))(batch["coords"]))
                        sa = prepare_shard_args(
                            plan, n_spatial,
                            halo=int(config.get("spatial_halo", 4096)),
                            pool=int(config.get("spatial_pool", 4096)))
                    state, parts = step_fn(state, batch, sa)
                else:
                    raw = {k: v for k, v in raw.items() if k != "region"}
                    batch = {k: jnp.asarray(v) for k, v in raw.items()}
                    plan = (jax.tree.map(jnp.asarray, host_plan)
                            if host_plan is not None else None)
                    fn = step_fns[bucket_i] if host_plan is not None \
                        else step_fns[-1]
                    state, parts = fn(state, batch, plan)
                for k, v in parts.items():
                    agg[k] = agg.get(k, 0.0) + float(v)
                nb += 1
                step += 1
                if max_steps is not None and step >= max_steps:
                    break
            dt = time.time() - t0
            msg = " ".join(f"{k}={v / max(nb, 1):.4f}"
                           for k, v in sorted(agg.items()))
            log.info("epoch %d: %s (%.1fs, %d steps)", epoch, msg, dt, nb)
            if writer:
                for k, v in agg.items():
                    writer.add_scalar(f"train/{k}", v / max(nb, 1), epoch)
                writer.add_scalar("train/epoch_time", dt, epoch)
            if (epoch + 1) % max(int(config.get("snapshot", 1)), 1) == 0:
                ckpt.save_checkpoint(ckpt_dir, jax.device_get(state),
                                     step=epoch + 1)
                ckpt.gc_checkpoints(ckpt_dir)
                # reference evaluates at every snapshot
                # (train_instance.py:465-473)
                if config.get("eval_on_snapshot", True) and                         max_steps is None:
                    try:
                        metrics = evaluate_semantic(config, state, model,
                                                    spec, dataset=dataset)
                        log.info("epoch %d val mean IoU: %.4f", epoch,
                                 metrics["mean_iou"])
                        if writer:
                            writer.add_scalar("val/mean_iou",
                                              metrics["mean_iou"], epoch)
                    except Exception as e:  # eval must never kill training
                        log.warning("snapshot eval failed: %r", e)
            if max_steps is not None and step >= max_steps:
                break
    except KeyboardInterrupt:
        ckpt.save_checkpoint(os.path.join(ckpt_dir, "INTERRUPTED"),
                             jax.device_get(state), step=step)
        raise
    finally:
        if plan_pool is not None:
            plan_pool.close()
    return {"state": state, "model": model, "spec": spec, "steps": step}


_EVAL_STEP_CACHE: Dict = {}


def _cached_eval_step(model, spec):
    """One jitted eval step per (model, spec) — snapshot-epoch evals would
    otherwise rebuild the closure and recompile every time."""
    key = (model, spec)
    if key not in _EVAL_STEP_CACHE:
        _EVAL_STEP_CACHE[key] = jax.jit(make_eval_step(model, spec))
    return _EVAL_STEP_CACHE[key]


def evaluate_semantic(config: Dict, state, model, spec,
                      dataset=None) -> Dict:
    """Per-epoch semantic eval: mean IoU over the val split, averaging
    logits over `val_reps` rotated views (reference `evaluate`,
    `train_instance.py:258-342`, accumulation into `store`)."""
    if dataset is None:
        dataset = get_dataset(config)
    p_cap = config["point_cap"]
    i_cap = config["instance_cap"]
    reps = max(int(config.get("val_reps", 1)), 1)
    ev = _cached_eval_step(model, spec)
    # class count follows the dataset (20 ScanNet / 14 Stanford3D —
    # reference `evaluate_instance.py:1332-1337`), not a hardcoded 20
    ncls = int(config.get("class_num", 20))
    conf = np.zeros((ncls, ncls), np.int64)
    per_rep = [dataset.val_batches(p_cap, i_cap, 1, val_rep=r)
               for r in range(reps)]
    use_normal = bool(config.get("use_normal"))
    for raws in zip(*per_rep):
        store = None
        gt = None
        for raw in raws:
            batch = {k: jnp.asarray(v) for k, v in raw.items()
                     if k != "region"}
            # host plan (C++ planner) as in training; no point layout, so
            # the per-rep logits stay in the same point order
            plan = _host_plan_any(raw["coords"], spec,
                                  raw.get("normals") if use_normal else None)
            out = ev(state, batch, jax.tree.map(jnp.asarray, plan))
            logits = np.asarray(out.semantics)
            store = logits if store is None else store + logits
            gt = np.asarray(batch["labels"])
        pred = np.argmax(store, axis=-1)
        conf += np.asarray(confusion_matrix(jnp.asarray(pred),
                                            jnp.asarray(gt),
                                            num_classes=ncls))
    return iou_from_confusion(conf)
