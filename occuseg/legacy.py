"""sparseconvnet-compatible API surface.

Lets code written against the reference's `import sparseconvnet as scn`
builder calls port with minimal edits: same constructor signatures
(dimension first, explicit nIn/nOut, filter/stride sizes, bias flag), the
`Sequential().add(...)` chaining style, and the container tables
(`sequential.py`, `tables.py`). Everything returns modules whose
__call__ takes `(x, plan, train)`; `dimension` must be 3 and nIn is checked
at trace time by the underlying module shapes.

Example (reference `networkArchitectures.py:207-213` docstring):
    import occuseg.legacy as scn
    m = scn.Sequential().add(
        scn.SubmanifoldConvolution(3, 3, 64, 3, False)).add(
        scn.UNet(3, 2, [64, 128, 192, 256], residual_blocks=True))
"""

from __future__ import annotations

from occuseg.nn import core as nn

from occuseg.core.sparse_tensor import (
    SparseTensor,
    add_features,
    concat_features,
)
from occuseg.nn import modules as _m
from occuseg.nn import unet as _u
from occuseg.nn.extras import (
    ELU,
    Identity,
    LeakyReLU,
    ReLU,
    SELU,
    Sigmoid,
    Tanh,
    BatchwiseDropout,
    Dropout,
)


def _check3(dimension: int) -> None:
    assert dimension == 3, "occuseg supports dimension=3"


def SubmanifoldConvolution(dimension, nIn, nOut, filter_size, bias=False,
                           dilated_rate=1):
    _check3(dimension)
    return _m.SubmanifoldConvolution(out_features=nOut, kernel=filter_size,
                                     use_bias=bias)


def ValidConvolution(dimension, nIn, nOut, filter_size, bias=False):
    return SubmanifoldConvolution(dimension, nIn, nOut, filter_size, bias)


def Convolution(dimension, nIn, nOut, filter_size, filter_stride, bias=False):
    _check3(dimension)
    return _m.Convolution(out_features=nOut, size=filter_size,
                          stride=filter_stride, use_bias=bias)


def Deconvolution(dimension, nIn, nOut, filter_size, filter_stride,
                  bias=False):
    _check3(dimension)
    return _m.Deconvolution(out_features=nOut, size=filter_size,
                            stride=filter_stride, use_bias=bias)


def FullConvolution(dimension, nIn, nOut, filter_size, filter_stride,
                    bias=False):
    """TRUE active-set-growing transposed conv (`fullConvolution.py`,
    `FullConvolutionRules.h:11-56`): returns (tensor, fresh plan) like the
    reference returns a tensor with fresh Metadata. `Sequential` threads
    the new plan to subsequent layers automatically."""
    _check3(dimension)
    return _m.FullConvolution(out_features=nOut, size=filter_size,
                              stride=filter_stride, use_bias=bias)


TransposeConvolution = FullConvolution


def RandomizedStrideConvolution(dimension, nIn, nOut, filter_size,
                                filter_stride, bias=False):
    """Jittered-window strided conv (`randomizedStrideConvolution.py`);
    feed a `core.randomized.build_randomized_plan` topology at train time."""
    _check3(dimension)
    return _m.RandomizedStrideConvolution(out_features=nOut,
                                          size=filter_size,
                                          stride=filter_stride,
                                          use_bias=bias)


def RandomizedStrideMaxPooling(dimension, pool_size, pool_stride):
    """Jittered-window max pool (`randomizedStrideMaxPooling.py`)."""
    _check3(dimension)
    return _m.RandomizedStrideMaxPooling(size=pool_size, stride=pool_stride)


def NetworkInNetwork(nIn, nOut, bias=False):
    return _m.NetworkInNetwork(out_features=nOut, use_bias=bias)


def BatchNormalization(nPlanes, eps=1e-4, momentum=0.9, leakiness=1.0):
    return _m.BatchNormalization(eps=eps, momentum=momentum,
                                 leakiness=leakiness)


def BatchNormReLU(nPlanes, eps=1e-4, momentum=0.9):
    return _m.BatchNormalization(eps=eps, momentum=momentum, leakiness=0.0)


def BatchNormLeakyReLU(nPlanes, eps=1e-4, momentum=0.9, leakiness=0.333):
    return _m.BatchNormalization(eps=eps, momentum=momentum,
                                 leakiness=leakiness)


def MaxPooling(dimension, pool_size, pool_stride):
    _check3(dimension)
    return _m.MaxPooling(size=pool_size, stride=pool_stride)


def AveragePooling(dimension, pool_size, pool_stride):
    _check3(dimension)
    return _m.AveragePooling(size=pool_size, stride=pool_stride)


def UnPooling(dimension, pool_size, pool_stride):
    _check3(dimension)
    return _m.UnPooling(size=pool_size, stride=pool_stride)


def InputLayer(dimension, spatial_size, mode=4, normal_guide_scale=None):
    _check3(dimension)
    # IOLayersRules.h:18 — 0 unique / 2 keep take the first point per
    # voxel, 1 overwrite the last, 3 sum, 4 mean
    return _m.InputLayer(mode={0: "first", 1: "last", 2: "first", 3: "sum",
                               4: "mean"}.get(mode, "mean"))


def OutputLayer(dimension):
    return _m.OutputLayer()


def UNet(dimension, reps, nPlanes, residual_blocks=False, downsample=(2, 2),
         leakiness=0):
    _check3(dimension)
    return _u.UNet(reps=reps, n_planes=tuple(nPlanes),
                   residual_blocks=residual_blocks,
                   down_size=downsample[0], down_stride=downsample[1],
                   leakiness=leakiness)


def FullyConvolutionalNet(dimension, reps, nPlanes, residual_blocks=False,
                          downsample=(2, 2)):
    _check3(dimension)
    return _u.FullyConvolutionalNet(reps=reps, n_planes=tuple(nPlanes),
                                    residual_blocks=residual_blocks,
                                    down_size=downsample[0],
                                    down_stride=downsample[1])


def SparseVggNet(dimension, nInputPlanes, layers):
    _check3(dimension)
    return _u.SparseVggNet(layers=tuple(
        tuple(l) if isinstance(l, (list, tuple)) else l for l in layers))


def SparseResNet(dimension, nInputPlanes, layers):
    _check3(dimension)
    return _u.SparseResNet(layers=tuple(tuple(l) for l in layers))


class Sequential(nn.Module):
    """`scn.Sequential().add(m1).add(m2)` chaining (reference
    `sequential.py`). Must be fully built before first use (modules are
    frozen dataclasses), so call .add() only at construction time."""

    layers: tuple = ()

    @nn.nowrap
    def add(self, module) -> "Sequential":
        return Sequential(layers=self.layers + (module,))

    @nn.compact
    def __call__(self, x, plan, train: bool = False):
        # layers held in the `layers` field are named layers_0, layers_1, ...
        for layer in self.layers:
            x = layer(x, plan, train)
            if isinstance(x, tuple) and len(x) == 2:
                # FullConvolution grew a fresh topology: thread it to the
                # remaining layers (the reference threads fresh Metadata
                # inside its SparseConvNetTensor)
                x, plan = x
        return x


class ConcatTable(nn.Module):
    """Apply each branch to the same input, return list (reference
    `tables.py:13-27`)."""

    branches: tuple = ()

    @nn.nowrap
    def add(self, module) -> "ConcatTable":
        return ConcatTable(branches=self.branches + (module,))

    @nn.compact
    def __call__(self, x, plan, train: bool = False):
        return [b(x, plan, train) for b in self.branches]


class JoinTable(nn.Module):
    """Channel-concat a list (reference `tables.py:28-43`)."""

    @nn.compact
    def __call__(self, xs, plan=None, train: bool = False):
        out = xs[0]
        for other in xs[1:]:
            out = concat_features(out, other)
        return out


class AddTable(nn.Module):
    """Elementwise-add a list (reference `tables.py:45-55`)."""

    @nn.compact
    def __call__(self, xs, plan=None, train: bool = False):
        out = xs[0]
        for other in xs[1:]:
            out = add_features(out, other)
        return out


def ShapeContext(dimension, nIn, filter_size=3):
    _check3(dimension)
    from occuseg.nn.extras import ShapeContext as _SC
    return _SC()


def MultiscaleShapeContext(dimension, nIn, n_scales=3, **_):
    _check3(dimension)
    from occuseg.nn.extras import MultiscaleShapeContext as _MSC
    return _MSC(num_scales=n_scales)


def PermutohedralSubmanifoldConvolution(dimension, nIn, nOut, bias=False):
    """(reference `permutohedralSubmanifoldConvolution.py:29`) — plan must
    use PlanSpec(lattice="permutohedral")."""
    _check3(dimension)
    from occuseg.nn.extras import (
        PermutohedralSubmanifoldConvolution as _P,
    )
    return _P(out_features=nOut, use_bias=bias)


def InputLayerInput(coords, features):
    """(reference `inputBatch.py` InputLayerInput): pair container for the
    raw (coords, features) fed to InputLayer."""
    return (coords, features)


class InputBatch:
    """Thin compat shim for the reference's InputBatch (`inputBatch.py`):
    accumulates per-sample point clouds and produces the padded batch dict +
    host plan used by this framework."""

    def __init__(self, dimension: int, spatial_size: int, p_cap: int = None):
        _check3(dimension)
        self.spatial_size = spatial_size
        self.p_cap = p_cap
        self._coords = []
        self._features = []

    def add_sample(self, coords, features) -> None:
        import numpy as np
        b = len(self._coords)
        c = np.asarray(coords)
        self._coords.append(
            np.concatenate([np.full((c.shape[0], 1), b, c.dtype), c], axis=1))
        self._features.append(np.asarray(features))

    def precompute_metadata(self, spec):
        """Build the topology plan (host) for the accumulated batch."""
        import numpy as np
        from occuseg.native.plan import build_plan_host
        coords, _ = self.arrays()
        return build_plan_host(coords, spec)

    def arrays(self):
        import numpy as np
        coords = np.concatenate(self._coords).astype(np.int32)
        feats = np.concatenate(self._features).astype(np.float32)
        cap = self.p_cap or coords.shape[0]
        out_c = np.full((cap, 4), -1, np.int32)
        out_f = np.zeros((cap,) + feats.shape[1:], np.float32)
        n = min(coords.shape[0], cap)
        out_c[:n] = coords[:n]
        out_f[:n] = feats[:n]
        return out_c, out_f


def Identity_():
    return Identity()


Dropout_ = Dropout
BatchwiseDropout = BatchwiseDropout


class SparseToDense(nn.Module):
    """Module wrapper over extras.sparse_to_dense (reference
    `sparseToDense.py`)."""

    dimension: int = 3
    nPlanes: int = 0
    spatial_size: int = 64
    batch_size: int = 1

    @nn.compact
    def __call__(self, x, plan, train: bool = False):
        from occuseg.nn.extras import sparse_to_dense
        return sparse_to_dense(x, plan, self.spatial_size, self.batch_size)


def DenseToSparse(dimension=3, cap: int = 65536):
    """Returns a function dense_mask -> padded active coords (reference
    `denseToSparse.py`); feed the coords to build_plan to continue sparse."""
    _check3(dimension)
    from occuseg.nn.extras import dense_to_sparse_coords

    def convert(dense_mask):
        return dense_to_sparse_coords(dense_mask, cap)

    return convert


def Sparsify(dimension=3, cap: int = 65536, threshold: float = 0.0):
    """Returns a function (x, plan) -> padded coords of surviving sites
    (reference `sparsify.py`); replan with build_plan afterwards."""
    _check3(dimension)
    from occuseg.nn.extras import sparsify_coords

    def convert(x, plan):
        return sparsify_coords(x, plan, cap, threshold)

    return convert


def append_tensors(entries):
    """Concatenate sparse tensors batch-wise (reference `utils.py:142-151`
    append_tensors + `Metadata.cpp:245-258` appendMetadata: later tensors'
    scenes become additional batch entries with their active rows offset).

    `entries`: sequence of (SparseTensor, Topology) pairs, all built at the
    SAME per-level caps (the reference analogously requires one
    spatial_size) and with scalar num_active (single-scene tensors).
    Returns (SparseTensor, Topology): features row-concatenated, num_active
    an [ns] per-scene vector, and a BLOCKED-layout merged plan (scene s owns
    rows [s*cap, s*cap+n_s) at every level — `native/blocked.py`); batch
    columns of the merged coords are renumbered 0..ns-1.
    """
    import dataclasses as _dc

    import numpy as np

    from occuseg.native.blocked import merge_scene_plans

    tensors = [t for t, _ in entries]
    plans = [jax.device_get(p) for _, p in entries]
    lvl = tensors[0].level
    assert all(t.level == lvl for t in tensors), \
        "append_tensors requires tensors on the same topology level"
    scaps = tuple(np.asarray(l.keys).shape[0] for l in plans[0].levels)
    for p in plans[1:]:
        pc = tuple(np.asarray(l.keys).shape[0] for l in p.levels)
        assert pc == scaps, f"per-level caps differ: {pc} vs {scaps}"

    merged = merge_scene_plans(plans, scaps)
    # renumber batch columns: scene s's voxels become batch entry s
    new_levels = []
    for li, mlvl in enumerate(merged.levels):
        coords = np.asarray(mlvl.coords).copy()
        for s in range(len(plans)):
            blk = coords[s * scaps[li]:(s + 1) * scaps[li]]
            blk[:, 0] = np.where(blk[:, 0] >= 0, s, blk[:, 0])
        new_levels.append(_dc.replace(mlvl, coords=coords))
    # p2v: original point order per scene, rows shifted into scene blocks
    p2v = np.concatenate([
        np.where(np.asarray(p.p2v) >= 0,
                 np.asarray(p.p2v) + s * scaps[0], -1).astype(np.int32)
        for s, p in enumerate(plans)])
    merged = _dc.replace(merged, levels=tuple(new_levels), p2v=p2v)

    import jax.numpy as jnp
    feats = jnp.concatenate([t.features for t in tensors], axis=0)
    num_active = jnp.stack(
        [jnp.asarray(t.num_active, jnp.int32).reshape(()) for t in tensors])
    out = SparseTensor(features=feats, num_active=num_active, level=lvl)
    return out, merged


import jax  # noqa: E402  (used by append_tensors' device_get)
