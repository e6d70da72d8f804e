"""Smoke run of the main path on one GPU.

    python chip_smoke.py              # one card: phases (a)-(d)
    python chip_smoke.py --cards 4    # four cards: the multi-card phases

Phases on one card:

(a) the card (name, power limit) and JAX's platform, device kind, count;
(b) the flagship train step (LearningBWDenseUNet, m=64 widths, residual
    blocks, 20 classes, bfloat16 compute) on the synthetic ~182k-voxel
    bench scene with the C++ host plan, through `train/state.make_train_step`:
    compile, a few steps with finite losses, step time, memory;
(c) accuracy on the card: every conv of the UNet (L0-L5 widths, forward,
    d_feats, dW) in bfloat16 against a float32 HIGHEST-precision
    reference, and one bfloat16 flagship forward+backward against the
    float32 HIGHEST path (loss and gradient norm);
(d) the trainer CLI (`scripts/train_instance.py`, `--m 64 --batch_size 1
    --scale 50 --residual_blocks --use_dense_model`) on the synthetic
    fallback data for one epoch, ending with its `val mean IoU` line.

With ``--cards 4``, only the multi-card phases, both on the flagship at
full widths and depth over bench scenes (seeds 0-3): the spatially sharded
train step (scene 0 split over the 4 cards) against the unsharded step on
one card, and the data-parallel step on a 4-card mesh (one scene per card)
against the update from the mean of the four single-card gradients.

It exits non-zero without a GPU, without the C++ planner library, or when
any phase fails. The last line of stdout is a JSON object
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import os
import sys
import tempfile
import time

# tolerances (normwise relative error; see PERF.md "Correctness")
CONV_BF16_TOL = 2e-2      # bf16 operands/outputs: ~2^-8 per element
STEP_LOSS_RTOL = 2e-2     # bf16 vs f32 flagship loss
STEP_GNORM_RTOL = 5e-2    # bf16 vs f32 flagship gradient norm
DP_RTOL = 1e-3            # DP update vs mean of single-card grads (f32)
SPATIAL_RTOL = 2e-3       # spatially sharded vs unsharded loss (f32)

N_PLANES = (64, 128, 192, 256, 320, 384)
I_CAP = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import jax

    from occuseg.native import have_native
    from occuseg.utils.runtime import device_info, gpu_name_and_power_limit

    log(gpu_name_and_power_limit())
    info = device_info()
    log(f"(a) platform={info['platform']} kind={info['kind']} "
        f"count={info['count']} jax={jax.__version__}")
    if not have_native():
        raise SystemExit("error: the C++ planner library (csrc/) did not "
                         "build or load")
    return info


def phase_flagship_step(batch, plan, spec, steps: int = 5):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from occuseg.models import LearningBWDenseUNet
    from occuseg.train.state import create_train_state, make_train_step

    model = LearningBWDenseUNet(n_planes=N_PLANES, num_classes=20,
                                compute_dtype=jnp.bfloat16)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    state = create_train_state(model, jax.random.PRNGKey(0), batch_j, spec)
    step = jax.jit(make_train_step(model, spec, num_scenes=1,
                                   num_instances=I_CAP), donate_argnums=0)
    t0 = time.perf_counter()
    compiled = step.lower(state, batch_j, plan).compile()
    t_compile = time.perf_counter() - t0
    log(f"(b) flagship step compile {t_compile:.1f} s")
    log(f"(b) memory_analysis: {compiled.memory_analysis()}")
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, parts = compiled(state, batch_j, plan)
        jax.block_until_ready((state, parts))
        times.append(time.perf_counter() - t0)
        losses.append(float(parts["total"]))
    log(f"(b) losses {losses}")
    log(f"(b) step times ms {[round(t * 1e3, 3) for t in times]}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"(b) peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"error: non-finite flagship loss {losses}")
    return state


def phase_accuracy(batch, plan):
    import jax
    import jax.numpy as jnp

    from occuseg.models import LearningBWDenseUNet
    from occuseg.ops import dispatch
    from occuseg.utils.conv_check import (
        check_plan_convs, step_loss_and_grad_norm,
    )

    rows = check_plan_convs(dispatch.impl().conv, plan, N_PLANES,
                            jnp.bfloat16, CONV_BF16_TOL)
    for r in rows:
        log(f"(c) conv {r['case']:<13} rows={r['rows']:>6} "
            f"{r['cin']:>3}->{r['cout']:<3} fwd={r['fwd']:.2e} "
            f"d_feats={r['d_feats']:.2e} d_weight={r['d_weight']:.2e} "
            f"{'ok' if r['ok'] else 'FAIL'}")
    bad = [r["case"] for r in rows if not r["ok"]]

    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    model = LearningBWDenseUNet(n_planes=N_PLANES, num_classes=20)
    variables = jax.jit(lambda r, f, p: model.init(r, f, p, False))(
        jax.random.PRNGKey(3), batch_j["features"], plan)
    lb, gb = step_loss_and_grad_norm(LearningBWDenseUNet, N_PLANES,
                                     variables, batch_j, plan,
                                     jnp.bfloat16, I_CAP)
    with jax.default_matmul_precision("highest"):
        lf, gf = step_loss_and_grad_norm(LearningBWDenseUNet, N_PLANES,
                                         variables, batch_j, plan,
                                         jnp.float32, I_CAP)
    dl, dg = abs(lb - lf) / abs(lf), abs(gb - gf) / abs(gf)
    log(f"(c) flagship fwd+bwd bf16 vs f32-highest: loss {lb:.6f} vs "
        f"{lf:.6f} (rel {dl:.2e}), grad norm {gb:.6f} vs {gf:.6f} "
        f"(rel {dg:.2e})")
    if dl > STEP_LOSS_RTOL or dg > STEP_GNORM_RTOL:
        bad.append("flagship_step")
    if bad:
        raise SystemExit(f"error: accuracy checks failed: {bad}")


def phase_trainer() -> None:
    import runpy

    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    root = logging.getLogger()
    root.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("(d) %(message)s"))
    grab = Grab()
    root.addHandler(handler)
    root.addHandler(grab)
    with tempfile.TemporaryDirectory() as tmp:
        argv = sys.argv
        sys.argv = ["train_instance.py", "--m", "64", "--batch_size", "1",
                    "--scale", "50", "--residual_blocks",
                    "--use_dense_model", "--max_epoch", "1",
                    "--data_dir", os.path.join(tmp, "no_scenes"),
                    "--checkpoints_dir", os.path.join(tmp, "ckpts"),
                    "--taskname", "smoke"]
        try:
            t0 = time.perf_counter()
            runpy.run_path(os.path.join("scripts", "train_instance.py"),
                           run_name="__main__")
            log(f"(d) trainer finished in {time.perf_counter() - t0:.1f} s")
        finally:
            sys.argv = argv
            root.removeHandler(handler)
            root.removeHandler(grab)
    if not any(m.startswith("val mean IoU") for m in lines):
        raise SystemExit("error: the trainer did not report val mean IoU")
    if not any(m.startswith("epoch 0:") for m in lines):
        raise SystemExit("error: the trainer ran no epoch")


def _peaks(devs):
    """Each card's `peak_bytes_in_use`; None where the backend keeps no
    memory stats (the CPU of a rehearsal on virtual devices)."""
    return [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]


def _grew(before, after) -> bool:
    """Whether the peak of every card but the first rose across a step: the
    step placed work on those cards. (The first card ran the model's init
    and the single-card comparisons, so its peak may already be higher.)"""
    return all(a is None or b is None or a > b
               for b, a in zip(before[1:], after[1:]))


def compile_concurrently(jobs):
    """Lower each `(jitted, args)` in turn, then compile them all at once on
    threads (XLA releases the GIL while it compiles), so the multi-card
    phase pays about one flagship compile of wall time, not three."""
    from concurrent.futures import ThreadPoolExecutor

    lowered = [f.lower(*a) for f, a in jobs]
    with ThreadPoolExecutor(len(lowered)) as ex:
        return list(ex.map(lambda lw: lw.compile(), lowered))


def phase_multicard(n: int, scenes, planes, spec, num_instances: int = I_CAP,
                    halo: int = 4096, pool: int = 4096) -> None:
    """Data-parallel and spatially sharded train steps on `n` cards, each
    against its single-card comparison. `scenes` holds `n` (batch, plan)
    pairs built for the caps of `spec`: the DP step takes one per card, the
    spatial step splits the first over all `n` cards (`halo`/`pool` rows
    per shard for the halo exchange, as `--spatial_halo/--spatial_pool`)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from occuseg.models import LearningBWDenseUNet
    from occuseg.parallel.data_parallel import (
        make_dp_train_step, make_mesh, replicate_state, shard_batch,
        shard_plans, stack_plans,
    )
    from occuseg.parallel.spatial import SPACE_AXIS
    from occuseg.parallel.spatial_model import (
        make_spatial_train_step, prepare_shard_args,
    )
    from occuseg.train.state import (
        TrainConfig, create_train_state, make_train_step,
    )
    from occuseg.utils.conv_check import rel_err

    devs = jax.devices()
    if len(devs) < n or len(scenes) != n:
        raise SystemExit(f"error: {n} cards and scenes asked for, "
                         f"{len(devs)} cards and {len(scenes)} scenes found")
    devs = devs[:n]
    # f32 at HIGHEST precision and SGD (update linear in the gradient, so
    # the mean of single-card updates is the update of the mean gradient):
    # the comparisons measure the parallel paths, not TF32 or Adam
    cfg = TrainConfig(optimizer="sgd")
    model = LearningBWDenseUNet(n_planes=tuple(planes), num_classes=20)
    flat = lambda t: np.concatenate(
        [np.ravel(np.asarray(x, np.float64)) for x in jax.tree.leaves(t)])
    dev = lambda t: jax.tree.map(jnp.asarray, t)

    with jax.default_matmul_precision("highest"):
        b0, plan0 = dev(scenes[0][0]), dev(scenes[0][1])
        state0 = create_train_state(model, jax.random.PRNGKey(0), b0, spec,
                                    cfg)
        p0 = flat(state0.params)
        ref_step = jax.jit(make_train_step(model, spec, cfg,
                                           num_instances=num_instances))
        mesh = make_mesh(n, devices=devs)
        dp_step = make_dp_train_step(model, spec, mesh, cfg, num_scenes=1,
                                     num_instances=num_instances)
        stacked = {k: np.stack([b[k] for b, _ in scenes])
                   for k in scenes[0][0]}
        dp_args = (replicate_state(state0, mesh), shard_batch(stacked, mesh),
                   shard_plans(stack_plans([p for _, p in scenes]), mesh))
        smesh = Mesh(np.asarray(devs), (SPACE_AXIS,))
        sa = prepare_shard_args(scenes[0][1], n, halo=halo, pool=pool)
        sa.pop("num_shards")
        sp_step = jax.jit(make_spatial_train_step(
            smesh, planes, cfg, num_instances=num_instances))
        t0 = time.perf_counter()
        ref_c, dp_c, sp_c = compile_concurrently([
            (ref_step, (state0, b0, plan0)), (dp_step, dp_args),
            (sp_step, (state0, b0, sa))])
        log(f"(multi) single-card, DP and spatial steps compiled in "
            f"{time.perf_counter() - t0:.1f} s")

    bad = []

    # ---- spatial sharding: scene 0 over n cards (first, so that the
    # peaks of cards 1.. show its work) ----
    before = _peaks(devs)
    sstate, sparts = sp_c(state0, b0, sa)
    jax.block_until_ready(sstate)
    mem = _peaks(devs)
    ref = [ref_c(state0, dev(b), dev(p)) for b, p in scenes]
    ref_upd = np.mean([flat(s.params) - p0 for s, _ in ref], axis=0)
    ref_loss = float(np.mean([float(t["total"]) for _, t in ref]))
    rstate, rparts = ref[0]
    e_l = abs(float(sparts["total"]) - float(rparts["total"])) \
        / abs(float(rparts["total"]))
    e_u = rel_err(flat(sstate.params) - p0, flat(rstate.params) - p0)
    log(f"(spatial) per-card peak_bytes_in_use {before} -> {mem}")
    log(f"(spatial) {n} shards: loss {float(sparts['total']):.6f} vs "
        f"unsharded {float(rparts['total']):.6f} (rel {e_l:.2e}), "
        f"update rel err {e_u:.2e}")
    if e_l > SPATIAL_RTOL or e_u > SPATIAL_RTOL or not _grew(before, mem):
        bad.append("spatial")
    del sstate
    gc.collect()

    # ---- data parallel: one scene per card ----
    before = _peaks(devs)
    dstate, dparts = dp_c(*dp_args)
    jax.block_until_ready(dstate)
    mem = _peaks(devs)
    e_dp = rel_err(flat(dstate.params) - p0, ref_upd)
    e_loss = abs(float(dparts["total"]) - ref_loss) / abs(ref_loss)
    log(f"(dp) per-card peak_bytes_in_use {before} -> {mem}")
    log(f"(dp) {n} cards: update rel err {e_dp:.2e} vs the mean of "
        f"{n} single-card updates; loss {float(dparts['total']):.6f} "
        f"vs {ref_loss:.6f} (rel {e_loss:.2e})")
    if e_dp > DP_RTOL or e_loss > DP_RTOL or not _grew(before, mem):
        bad.append("data-parallel")
    if bad:
        raise SystemExit(f"error: multi-card steps do not match: {bad}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card phases")
    args = ap.parse_args()
    try:
        import jax

        import bench
        from occuseg.utils.runtime import enable_compile_cache, require_gpu
    except ImportError as e:
        raise SystemExit(f"error: run from the root of an occuseg checkout "
                         f"({e})")
    require_gpu()
    log(f"compile cache: {enable_compile_cache()}")
    info = phase_device()
    from occuseg.core.topology import PlanSpec

    spec = PlanSpec(caps=bench.SCENE_CAPS)
    if args.cards == 4:
        scenes = [bench.prepare(seed)[:2] for seed in range(4)]
        phase_multicard(4, scenes, N_PLANES, spec)
    else:
        batch, plan, nvox = bench.prepare(0, 1)
        log(f"scene: {nvox} active voxels, caps {bench.SCENE_CAPS}")
        phase_flagship_step(batch, plan, spec)
        gc.collect()
        phase_accuracy(batch, plan)
        del batch, plan
        gc.collect()
        phase_trainer()
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
