"""Multi-host (DCN) data parallelism.

SURVEY.md §2.5/§5.8: the optional multi-host analog of the single-host DP
path. The reference has no distributed story at all (strictly one GPU);
the design scales the SAME shard_mapped train step
(`data_parallel.make_dp_train_step`) over a GLOBAL mesh spanning several
hosts: XLA inserts the intra-host and cross-host collectives, nothing in
the step changes.

What this module adds over `data_parallel`:
  * `init_multihost` — `jax.distributed.initialize` wiring (coordinator
    address / process count / process id, straight from the launcher's
    env or flags).
  * `global_dp_batch` / `global_dp_plans` — assemble a GLOBAL jax.Array
    batch from each process's HOST-LOCAL scenes
    (`jax.make_array_from_process_local_data`): every process loads and
    plans only the scenes for its own chips, exactly like the single-host
    loader thread; nothing is gathered to one host.

Verified by `tests/test_multihost.py`: two REAL processes on the CPU
backend (gloo cross-process collectives), each owning half the virtual
devices of one global mesh, run the full DP train step and reproduce the
single-process loss bit-for-bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from occuseg.parallel.data_parallel import DATA_AXIS, stack_plans


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   local_device_ids: Optional[Sequence[int]] = None) -> None:
    """`jax.distributed.initialize` with explicit or env-provided wiring.

    Pass coordinator "host:port", the world size, and
    this process's rank (e.g. from SLURM/MPI env vars). Must run before
    the first jax device query in the process."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)


def global_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """One data-axis mesh over ALL processes' devices (jax.devices() is
    global after init_multihost)."""
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devs), (DATA_AXIS,))


def global_dp_batch(local_batch: Dict[str, np.ndarray], mesh: Mesh
                    ) -> Dict[str, jax.Array]:
    """Host-local [D_local, ...] stacked scenes -> global [D_global, ...]
    jax.Arrays sharded one scene-group per device over the whole mesh.

    Each process passes ONLY its own chips' scenes (loaded and planned
    locally); the global array is assembled without any cross-host copy
    of the data itself."""
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    return {k: jax.make_array_from_process_local_data(sharding, v)
            for k, v in local_batch.items()}


def global_dp_plans(local_plans: Sequence, mesh: Mesh):
    """Host-local per-device Topology plans -> one globally sharded
    stacked-plan pytree (`data_parallel.stack_plans` layout)."""
    stacked = stack_plans(list(local_plans))
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            sharding, np.asarray(x)), stacked)
