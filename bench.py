"""Benchmark harness: voxels/s for the m=64 UNet on one GPU.

Prints JSON lines, each naming the device it ran on (`device`: JAX's
platform, device kind and count, and the card's name and power limit):

* the m=64 backbone forward+backward (semantic head, CE loss);
* the full flagship train step (LearningBWDenseUNet, 6-term loss, Adam);
* with ``--seeds 0,1,...``: the min/max ratio of backbone throughput over
  scene seeds;
* with ``--kernels``, instead of the lines above: the submanifold conv of
  every UNet level (the GPU kernel and XLA's plain conv; forward, and the
  gradient of sum(out)) and the voxelize segment sum, sorted vs unsorted
  ids.

Protocol mirrors the reference's throughput proxy (per-scene MulAdd counters
+ epoch wall time, `train_instance.py:459-462`): a synthetic ScanNet-like
scene is voxelized and jitted steps of the m=64 UNet (widths [64..384],
residual blocks — `config.py:92`, `training_script/train_instance.sh`) are
timed as active voxels per second. Each timed step is one dispatch; the
clock stops after `block_until_ready` on the last step's outputs.

The topology plan is built by the C++ host runtime (native/plan.py) and
passed to the step as data, as the training loader does. Host plan build
time is reported on stderr.

vs_baseline: the reference repo publishes no numbers (BASELINE.md). We use
an ESTIMATED GV100 throughput of 1.0e6 voxels/s (fwd+bwd): a ScanNet epoch
(1201 scenes, ~250k active voxels each at scale=50) in the ~5 min/epoch
regime typical for SparseConvNet-UNet training on Volta-class GPUs. It is
an estimate, not a measurement.

Run on a GPU only: without one, or without the C++ planner library, it
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

GV100_EST_VOXELS_PER_SEC = 1.0e6

# One ~180k-voxel scene per step (typical 2cm ScanNet room is 100k-300k
# voxels, SURVEY.md §5.7). Caps sized snugly to the scene's measured
# per-level actives — padded rows are pure overhead, and a bucketing loader
# sizes caps per batch the same way.
SCENE_P_CAP = 262_144
SCENE_CAPS = (196_608, 139_264, 63_488, 17_408, 4_096, 1_024)
SCENE = dict(num_points=200_000, extent=512, num_objects=24)
N_PLANES = (64, 128, 192, 256, 320, 384)
N_TIMED = 20


def caps_for(num_scenes: int):
    return (SCENE_P_CAP * num_scenes,
            tuple(c * num_scenes for c in SCENE_CAPS))


def prepare(seed: int, num_scenes: int = 1):
    """Synthetic batch + host plan (C++ planner, sorted point layout) for
    one scene seed. Returns (numpy batch, device plan, active voxels)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from occuseg.core.point_layout import (
        apply_point_layout, augment_plan_with_point_layout,
    )
    from occuseg.core.topology import PlanSpec
    from occuseg.data.synthetic import SceneConfig, make_batch
    from occuseg.native import have_native
    from occuseg.native.blocked import build_plan_host_blocked

    if not have_native():
        raise SystemExit("error: the C++ planner library (csrc/) did not "
                         "build or load")
    p_cap, caps = caps_for(num_scenes)
    spec = PlanSpec(caps=caps)
    scene = SceneConfig(**SCENE)
    batch = make_batch(scene, num_scenes=num_scenes, p_cap=p_cap,
                       num_instances=64, seed=seed)
    t0 = time.perf_counter()
    host_plan = build_plan_host_blocked(batch["coords"], spec, num_scenes)
    if host_plan is None:
        raise SystemExit("error: the C++ planner does not cover this spec")
    host_plan = augment_plan_with_point_layout(host_plan)
    batch = apply_point_layout(batch, host_plan, num_scenes=num_scenes)
    t_plan = time.perf_counter() - t0
    num_voxels = int(np.sum(host_plan.levels[0].num_active))
    print(f"seed {seed}: host plan build {t_plan * 1e3:.1f} ms, "
          f"{num_voxels} active voxels", file=sys.stderr)
    return batch, jax.tree.map(jnp.asarray, host_plan), num_voxels


def time_steps(step, args, n: int = N_TIMED) -> float:
    """Seconds per call of `step(*args)`: one warm-up call (compiles),
    then `n` calls timed to `block_until_ready` of the last result."""
    import jax

    jax.block_until_ready(step(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = step(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def emit(device, **fields) -> None:
    print(json.dumps(dict(fields, device=device)), flush=True)


def bench_backbone(batch, plan, num_voxels):
    """(seconds per m=64 backbone fwd+bwd step, the jitted step)."""
    import jax
    import jax.numpy as jnp

    from occuseg.losses.instance import semantic_cross_entropy
    from occuseg.models.occuseg import _Backbone
    from occuseg.nn import core as nn

    class SemModel(nn.Module):
        @nn.compact
        def __call__(self, feats, plan, train=False):
            f = _Backbone(N_PLANES, block_reps=1, residual_blocks=True,
                          compute_dtype=jnp.bfloat16,
                          name="backbone")(feats, plan, train)
            return nn.Dense(20, name="linear")(f)

    model = SemModel()
    feats = jnp.asarray(batch["features"])
    labels = jnp.asarray(batch["labels"])
    variables = jax.jit(lambda r, f, p: model.init(r, f, p, False))(
        jax.random.PRNGKey(0), feats, plan)

    def loss_fn(params, batch_stats, feats, plan, labels):
        logits, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, feats, plan,
            True, mutable=["batch_stats"])
        return semantic_cross_entropy(logits, labels), mutated["batch_stats"]

    @jax.jit
    def fwd_bwd(params, batch_stats, feats, plan, labels):
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch_stats, feats, plan, labels)
        return loss, bs, grads

    args = (variables["params"], variables["batch_stats"], feats, plan,
            labels)
    return time_steps(fwd_bwd, args), fwd_bwd, args


def bench_flagship(batch, plan, num_scenes):
    """Seconds per full flagship train step (donated state)."""
    import jax
    import jax.numpy as jnp

    from occuseg.core.topology import PlanSpec
    from occuseg.models import LearningBWDenseUNet
    from occuseg.train.state import create_train_state, make_train_step

    spec = PlanSpec(caps=caps_for(num_scenes)[1])
    model = LearningBWDenseUNet(n_planes=N_PLANES, num_classes=20,
                                compute_dtype=jnp.bfloat16)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    state = create_train_state(model, jax.random.PRNGKey(0), batch_j, spec)
    step = jax.jit(make_train_step(model, spec, num_scenes=num_scenes,
                                   num_instances=64), donate_argnums=0)
    state, parts = step(state, batch_j, plan)  # compile
    jax.block_until_ready(parts)
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        state, parts = step(state, batch_j, plan)
    jax.block_until_ready((state, parts))
    dt = (time.perf_counter() - t0) / N_TIMED
    total = float(parts["total"])
    if not jnp.isfinite(total):
        raise SystemExit(f"error: flagship loss is not finite: {total}")
    return dt, total


def bench_kernels(batch, plan, device) -> None:
    """Per-level conv timings (forward, and the gradient of sum(out) w.r.t.
    feats and weight) of the GPU kernel and of XLA's plain conv, and the
    voxelize segment sum with and without sorted ids, at the bench scene's
    shapes; one JSON line each."""
    import jax
    import jax.numpy as jnp

    from occuseg.ops.conv import gather_conv
    from occuseg.ops.triton_conv import triton_gather_conv

    key = jax.random.PRNGKey(0)
    for li, lvl in enumerate(plan.levels):
        c = N_PLANES[li]
        n = lvl.nbr.shape[0]
        feats = jax.random.normal(key, (n, c), jnp.bfloat16)
        w = (jax.random.normal(key, (27, c, c), jnp.float32)
             * (2.0 / (27 * c)) ** 0.5)
        for name, conv in (("triton", triton_gather_conv),
                           ("xla", gather_conv)):
            fwd = jax.jit(lambda f, w, nbr, conv=conv: conv(f, nbr, w))
            grad = jax.jit(jax.grad(
                lambda f, w, nbr, conv=conv: jnp.sum(
                    conv(f, nbr, w).astype(jnp.float32)), argnums=(0, 1)))
            emit(device, metric="conv_level_ms", level=li, rows=n, cin=c,
                 cout=c, impl=name,
                 fwd_ms=time_steps(fwd, (feats, w, lvl.nbr)) * 1e3,
                 grad_ms=time_steps(grad, (feats, w, lvl.nbr)) * 1e3)
    p2v = plan.p2v
    cap0 = plan.levels[0].nbr.shape[0]
    x = jax.random.normal(key, (p2v.shape[0], 3), jnp.float32)
    seg = jnp.where(p2v >= 0, p2v, cap0).astype(jnp.int32)
    for sorted_ids in (False, True):
        f = jax.jit(lambda x, s, srt=sorted_ids: jax.ops.segment_sum(
            x, s, num_segments=cap0 + 1, indices_are_sorted=srt))
        emit(device, metric="voxelize_segment_sum_ms",
             indices_are_sorted=sorted_ids, points=int(p2v.shape[0]),
             ms=time_steps(f, (x, seg)) * 1e3)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=1,
                    help="scenes per step (blocked batch layout)")
    ap.add_argument("--seeds", default="0",
                    help="comma list of scene seeds; more than one adds "
                         "the seed-sweep line")
    ap.add_argument("--kernels", action="store_true",
                    help="time only the conv of every level and the "
                         "voxelize segment sum")
    args = ap.parse_args(argv)

    from occuseg.utils.runtime import (
        device_info, enable_compile_cache, require_gpu,
    )

    require_gpu()
    enable_compile_cache()
    device = device_info()
    seeds = [int(s) for s in args.seeds.split(",") if s.strip()]

    batch, plan, num_voxels = prepare(seeds[0], args.scenes)
    if args.kernels:
        bench_kernels(batch, plan, device)
        return
    dt, fwd_bwd, bb_args = bench_backbone(batch, plan, num_voxels)
    print(f"fwd+bwd step: {dt * 1e3:.2f} ms", file=sys.stderr)
    voxels_per_sec = num_voxels / dt

    if len(seeds) > 1:
        import jax.numpy as jnp
        sweep = {seeds[0]: voxels_per_sec}
        for seed in seeds[1:]:
            b, p, nv = prepare(seed, args.scenes)
            a = (bb_args[0], bb_args[1], jnp.asarray(b["features"]), p,
                 jnp.asarray(b["labels"]))
            sweep[seed] = nv / time_steps(fwd_bwd, a)
        vals = list(sweep.values())
        emit(device, metric="unet_m64_seed_sweep_min_over_max",
             value=min(vals) / max(vals), unit="ratio",
             per_seed_voxels_per_sec=sweep)

    dt_full, total = bench_flagship(batch, plan, args.scenes)
    print(f"flagship train step: {dt_full * 1e3:.2f} ms "
          f"(last total={total:.4f})", file=sys.stderr)
    emit(device, metric="flagship_train_step_voxels_per_sec",
         value=num_voxels / dt_full, unit="voxels/s", scenes=args.scenes,
         vs_baseline=num_voxels / dt_full / GV100_EST_VOXELS_PER_SEC)
    emit(device, metric="unet_m64_fwd_bwd_voxels_per_sec",
         value=voxels_per_sec, unit="voxels/s", scenes=args.scenes,
         vs_baseline=voxels_per_sec / GV100_EST_VOXELS_PER_SEC)


if __name__ == "__main__":
    main()
