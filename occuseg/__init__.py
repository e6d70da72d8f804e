"""occuseg — sparse 3D segmentation framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of OccuSeg
(THU-luvision/OccuSeg, itself a fork of Facebook SparseConvNet): submanifold
sparse convolutions over voxelized point clouds, multi-task UNet backbones
(semantics / embeddings / offsets / displacements / bandwidth / occupancy),
instance clustering with occupancy-guided merging, and the ScanNet
train/evaluate pipeline.

Architecture (see SURVEY.md §7): instead of mutable hash-map metadata and
host-built rulebooks (reference `sparseconvnet/SCN/Metadata/Metadata.h`), all
sparse topology lives in a `Topology` pytree of sorted int64 coordinate keys
and dense neighbor-index maps, built *inside jit* from XLA sort / searchsorted
/ segment ops, with static bucketed shapes throughout.

NOTE: we globally enable x64 so that packed 42-bit coordinate keys fit in
int64. All compute-path dtypes are explicit (f32 / bf16) — the flag only
unlocks wide integer keys; it does not change any op we emit.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from occuseg.core.sparse_tensor import SparseTensor  # noqa: E402
from occuseg.core import coords  # noqa: E402
from occuseg.core.topology import (  # noqa: E402
    Topology,
    LevelTopology,
    build_plan,
)

__version__ = "0.1.0"
