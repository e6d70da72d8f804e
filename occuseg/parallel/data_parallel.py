"""Data parallelism over a device mesh.

The reference is strictly single-GPU (SURVEY.md §2.5): batch index is just an
extra coordinate column. Here the batch axis becomes a `jax.sharding.Mesh`
axis: each chip plans topology and runs fwd/bwd for ITS scenes (topology is
scene-local, so no cross-chip communication until the gradient `pmean`),
and parameters/optimizer state stay replicated. Built on `shard_map` so the
per-chip plan (different num_active per chip) never leaks dynamic shapes.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from occuseg.core.topology import PlanSpec
from occuseg.losses.instance import LossConfig
from occuseg.train.state import TrainConfig, TrainState, make_train_step

DATA_AXIS = "data"


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), (DATA_AXIS,))


def make_dp_train_step(model, spec: PlanSpec, mesh: Mesh,
                       cfg: TrainConfig = TrainConfig(),
                       loss_cfg: LossConfig = LossConfig(),
                       num_scenes: int = 1, num_instances: int = 64
                       ) -> Callable:
    """Jitted data-parallel train step.

    `batch` arrays must carry a leading device axis [D, ...] (one scene-group
    per chip, padded identically; optional "_w" [D] per-device loss weights
    for remainder groups). `plans` is the host-built topology pytree stacked
    the same way (`stack_plans`) — plan construction NEVER runs inside the
    trace, matching the single-device fast path where the C++ builder
    (`native/plan.py`) overlaps with device compute in the loader thread.
    State is replicated; gradients are psum-reduced across devices
    inside the shard_mapped step.
    """
    step = make_train_step(model, spec, cfg, loss_cfg, num_scenes,
                           num_instances, axis_name=DATA_AXIS)

    def sharded(state: TrainState, batch: Dict[str, jax.Array], plans):
        def per_device(state, batch, plans):
            # strip the leading per-device axis of size 1
            local = jax.tree.map(lambda x: x[0], batch)
            local_plan = jax.tree.map(lambda x: x[0], plans)
            new_state, parts = step(state, local, local_plan)
            return new_state, parts

        return jax.shard_map(
            per_device, mesh=mesh,
            in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(P(), P()),
        )(state, batch, plans)

    # donate the replicated state: params/opt-state buffers are consumed
    # and rebuilt every step — aliasing them saves the copy traffic
    return jax.jit(sharded, donate_argnums=0)


def stack_plans(plans: Sequence):
    """Stack D per-device Topology pytrees into one with a leading [D] axis
    (NumPy — runs in the loader thread, off the device critical path)."""
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *plans)


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh
                ) -> Dict[str, jax.Array]:
    """Place host-stacked [D, ...] arrays on the mesh's data axis."""
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    return {k: jax.device_put(v, sharding) for k, v in batch.items()}


def shard_plans(plans, mesh: Mesh):
    """Place a `stack_plans` result on the mesh's data axis."""
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), plans)


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Replicate a TrainState onto the mesh, with buffers the result OWNS.

    The DP step donates its state argument (`donate_argnums=0` above), and
    a bare `device_put` onto a same-backend mesh (the virtual CPU mesh in
    tests/dryrun) ALIASES the input's buffers — donating the alias would
    invalidate the caller's original state. `jnp.array` forces a copy."""
    import jax.numpy as jnp

    sharding = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda x: jax.device_put(jnp.array(x), sharding), state)
