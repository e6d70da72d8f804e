"""Sparse NN modules — the reference's Python op library (L4).

Mirrors `sparseconvnet/*.py` module-for-module: SubmanifoldConvolution
(`submanifoldConvolution.py:35-53`), Convolution (`convolution.py`),
Deconvolution (`deconvolution.py`), BatchNorm family
(`batchNormalization.py`), NetworkInNetwork (`networkInNetwork.py`), poolings
(`maxPooling.py` etc.), IO layers (`ioLayers.py`). Weight layout
[K^3, Cin, Cout] and He init std (2 / (Cin * K^3))^0.5 match the reference
(`submanifoldConvolution.py:26-29`) for checkpoint-import parity.

Every module's __call__ signature is `(x: SparseTensor, plan: Topology,
train: bool)`; topology is read from the plan (never mutated), and level
transitions just change the tensor's static `level` index.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from occuseg.nn import core as nn

from occuseg.core.sparse_tensor import SparseTensor
from occuseg.core.topology import Topology
from occuseg.ops import conv as conv_ops
from occuseg.ops import dispatch
from occuseg.ops import norm as norm_ops
from occuseg.ops import pool as pool_ops


def _conv(feats, nbr, w, b, nbr_t=None):
    return dispatch.impl().conv(feats, nbr, w, b, nbr_t=nbr_t)


def _sharded_conv(feats, map_arr, ex, w, b, axis_name):
    """Convolution over a spatially sharded map (plan built by
    parallel/spatial_model.build_spatial_topology; runs inside shard_map):
    extend local features with halo/pool rows from the neighbouring
    shards, then run the same conv as the unsharded path over the
    extended space with the extended-space transpose map."""
    from occuseg.parallel.spatial import extend_features

    ext = extend_features(feats, ex.send_left, ex.send_right, ex.publish,
                          ex.halo, axis_name)
    # custom_vjp blocks shard_map's replication inference — lift the
    # replicated weights to varying so the weight cotangent psums
    w_v = jax.lax.pcast(w, axis_name, to="varying")
    out = _conv(ext, map_arr, w_v, None, nbr_t=ex.nbr_t)
    if b is not None:
        out = out + b.astype(out.dtype)
    return out


def _he_conv_init(volume: int):
    def init(key, shape, dtype=jnp.float32):
        cin = shape[1]
        std = (2.0 / (cin * volume)) ** 0.5
        return std * jnp.asarray(
            nn.initializers.normal(1.0)(key, shape, jnp.float32), dtype)
    return init


class SubmanifoldConvolution(nn.Module):
    """Same-topology K^3 convolution (reference `submanifoldConvolution.py`).

    normal_guided=True applies the reference's rotation-invariant filter
    remap (`remap_rules_with_normal`) using the plan's per-site orientation
    classes; requires the plan to have been built with point normals.
    """

    out_features: int
    kernel: int = 3
    use_bias: bool = False
    normal_guided: bool = False
    param_dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology,
                 train: bool = False) -> SparseTensor:
        lvl = plan.levels[x.level]
        nbr = lvl.nbr
        K = nbr.shape[1]
        assert K == self.kernel ** 3, (
            f"plan built with kernel {int(round(K ** (1/3)))}, "
            f"module wants {self.kernel}")
        w = self.param("weight", _he_conv_init(K),
                       (K, x.num_channels, self.out_features),
                       self.param_dtype)
        b = (self.param("bias", nn.initializers.zeros, (self.out_features,),
                        self.param_dtype) if self.use_bias else None)
        if lvl.halo_ex is not None:
            out = _sharded_conv(x.features, nbr, lvl.halo_ex, w, b,
                                plan.axis_name)
        elif self.normal_guided:
            from occuseg.ops.normal_guide import normal_guided_conv
            out = normal_guided_conv(x.features, nbr, lvl.orient, w, b)
        else:
            out = _conv(x.features, nbr, w, b)
        return dataclasses.replace(x, features=out)


class Convolution(nn.Module):
    """Strided convolution to the next-coarser level (reference
    `convolution.py`; rulebook = transition child map)."""

    out_features: int
    size: int = 2
    stride: int = 2
    use_bias: bool = False
    param_dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology,
                 train: bool = False) -> SparseTensor:
        tr = plan.transitions[x.level]
        assert tr.size == self.size and tr.stride == self.stride
        K = tr.child.shape[1]
        w = self.param("weight", _he_conv_init(K),
                       (K, x.num_channels, self.out_features),
                       self.param_dtype)
        b = (self.param("bias", nn.initializers.zeros, (self.out_features,),
                        self.param_dtype) if self.use_bias else None)
        if tr.child_ex is not None:
            out = _sharded_conv(x.features, tr.child, tr.child_ex, w, b,
                                plan.axis_name)
        else:
            out = _conv(x.features, tr.child, w, b, nbr_t=tr.up[:, ::-1])
        lvl = plan.levels[x.level + 1]
        return SparseTensor(features=out, num_active=lvl.num_active,
                            level=x.level + 1)


class Deconvolution(nn.Module):
    """Transposed strided convolution back to the finer level (reference
    `deconvolution.py`; rulebook = transition up map)."""

    out_features: int
    size: int = 2
    stride: int = 2
    use_bias: bool = False
    param_dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology,
                 train: bool = False) -> SparseTensor:
        assert x.level > 0, "Deconvolution needs a finer level to return to"
        tr = plan.transitions[x.level - 1]
        assert tr.size == self.size and tr.stride == self.stride
        K = tr.up.shape[1]
        w = self.param("weight", _he_conv_init(K),
                       (K, x.num_channels, self.out_features),
                       self.param_dtype)
        b = (self.param("bias", nn.initializers.zeros, (self.out_features,),
                        self.param_dtype) if self.use_bias else None)
        if tr.up_ex is not None:
            out = _sharded_conv(x.features, tr.up, tr.up_ex, w, b,
                                plan.axis_name)
        else:
            out = _conv(x.features, tr.up, w, b, nbr_t=tr.child[:, ::-1])
        lvl = plan.levels[x.level - 1]
        return SparseTensor(features=out, num_active=lvl.num_active,
                            level=x.level - 1)


class FullConvolution(nn.Module):
    """Active-set-GROWING transposed convolution (reference
    `fullConvolution.py:48-65` / `FullConvolutionRules.h:11-56`): output
    sites are ALL in*stride + [0,size)^3 positions — a fresh topology, not
    a return to an existing finer level (that is `Deconvolution`).

    Returns (SparseTensor at level 0 of a NEW single-level Topology,
    new_plan) — the analog of the reference's fresh Metadata. `cap_out` is
    the static output-site budget (default cap_in * size^3, the exact
    upper bound); `build_nbr=True` also builds the grown level's
    submanifold neighbor map so further same-level convs can follow.
    """

    out_features: int
    size: int = 2
    stride: int = 2
    cap_out: int | None = None
    use_bias: bool = False
    build_nbr: bool = True
    param_dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology,
                 train: bool = False):
        from occuseg.core.topology import full_conv_plan

        lvl = plan.levels[x.level]
        cap_out = self.cap_out or lvl.cap * self.size ** 3
        out_lvl, tr = full_conv_plan(lvl, self.size, self.stride, cap_out,
                                     build_nbr=self.build_nbr)
        K = tr.up.shape[1]
        w = self.param("weight", _he_conv_init(K),
                       (K, x.num_channels, self.out_features),
                       self.param_dtype)
        b = (self.param("bias", nn.initializers.zeros, (self.out_features,),
                        self.param_dtype) if self.use_bias else None)
        out = _conv(x.features, tr.up, w, b, nbr_t=tr.child[:, ::-1])
        new_plan = Topology(
            levels=(out_lvl,), transitions=(),
            p2v=jnp.full((1,), -1, jnp.int32),
            num_points=jnp.zeros((), jnp.int32))
        return (SparseTensor(features=out, num_active=out_lvl.num_active,
                             level=0), new_plan)


class TransposeConvolution(FullConvolution):
    """Reference alias (`fullConvolution.py`)."""


class NetworkInNetwork(nn.Module):
    """1x1 convolution = row matmul (reference `networkInNetwork.py`)."""

    out_features: int
    use_bias: bool = False
    param_dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology,
                 train: bool = False) -> SparseTensor:
        w = self.param("weight", _he_conv_init(1),
                       (x.num_channels, self.out_features), self.param_dtype)
        b = (self.param("bias", nn.initializers.zeros, (self.out_features,),
                        self.param_dtype) if self.use_bias else None)
        return x.with_features(conv_ops.nin(x.features, w, b))


class BatchNormalization(nn.Module):
    """Masked BN + optional fused leaky activation; reference semantics
    (eps=1e-4, decay-momentum=0.9, leakiness: 0=ReLU, 1=none)."""

    eps: float = 1e-4
    momentum: float = 0.9
    leakiness: float = 1.0

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology,
                 train: bool = False) -> SparseTensor:
        c = x.num_channels
        scale = self.param("weight", nn.initializers.ones, (c,), jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (c,), jnp.float32)
        ra_mean = self.variable("batch_stats", "running_mean",
                                lambda: jnp.zeros((c,), jnp.float32))
        ra_var = self.variable("batch_stats", "running_var",
                               lambda: jnp.ones((c,), jnp.float32))
        state = norm_ops.BNState(ra_mean.value, ra_var.value)
        out, new_state = norm_ops.batch_norm(
            x.features, x.num_active, scale, bias, state,
            eps=self.eps, momentum=self.momentum, leakiness=self.leakiness,
            training=train,
            # spatial sharding: psum batch stats over the mesh axis
            axis_name=getattr(plan, "axis_name", None))
        if train and not self.is_initializing():
            ra_mean.value = new_state.running_mean
            ra_var.value = new_state.running_var
        return x.with_features(out)


class BatchNormReLU(BatchNormalization):
    leakiness: float = 0.0


class BatchNormLeakyReLU(BatchNormalization):
    leakiness: float = 0.333


class MaxPooling(nn.Module):
    """(reference `maxPooling.py`)"""

    size: int = 2
    stride: int = 2

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology,
                 train: bool = False) -> SparseTensor:
        tr = plan.transitions[x.level]
        out = pool_ops.max_pool(x.features, tr.child)
        lvl = plan.levels[x.level + 1]
        return SparseTensor(features=out, num_active=lvl.num_active,
                            level=x.level + 1)


class AveragePooling(nn.Module):
    """(reference `averagePooling.py`)"""

    size: int = 2
    stride: int = 2

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology,
                 train: bool = False) -> SparseTensor:
        tr = plan.transitions[x.level]
        out = pool_ops.avg_pool(x.features, tr.child)
        lvl = plan.levels[x.level + 1]
        return SparseTensor(features=out, num_active=lvl.num_active,
                            level=x.level + 1)


class UnPooling(nn.Module):
    """(reference `unPooling.py`)"""

    size: int = 2
    stride: int = 2

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology,
                 train: bool = False) -> SparseTensor:
        assert x.level > 0
        tr = plan.transitions[x.level - 1]
        out = pool_ops.unpool(x.features, tr.up)
        lvl = plan.levels[x.level - 1]
        return SparseTensor(features=out, num_active=lvl.num_active,
                            level=x.level - 1)


class InputLayer(nn.Module):
    """Point cloud -> level-0 sparse tensor (reference `ioLayers.py:47-63`,
    mode 4 = mean pooling of point features into voxels)."""

    mode: str = "mean"

    @nn.compact
    def __call__(self, point_features: jnp.ndarray, plan: Topology,
                 train: bool = False) -> SparseTensor:
        lvl = plan.levels[0]
        vox = _voxelize(point_features, plan, self.mode)
        return SparseTensor(features=vox, num_active=lvl.num_active, level=0)


def _voxelize(point_features, plan: Topology, mode: str):
    # the sorted point layout (vox_counts set) makes p2v non-decreasing
    return pool_ops.voxelize_features(
        point_features, plan.p2v, plan.levels[0].cap, mode=mode,
        vox_counts=plan.vox_counts,
        indices_are_sorted=plan.vox_counts is not None)


class OutputLayer(nn.Module):
    """Level-0 sparse tensor -> per-point features (reference
    `ioLayers.py:66-87`)."""

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology,
                 train: bool = False) -> jnp.ndarray:
        assert x.level == 0, "OutputLayer expects level-0 features"
        return pool_ops.devoxelize_features(x.features, plan.p2v)


class BLInputLayer(nn.Module):
    """Batch x length point-cloud input (reference `ioLayers.py`
    BLInputLayer / `IOLayersRules.h` blRules): dense [B, L, 4] coords +
    [B, L, C] features -> level-0 sparse tensor. Rows with coords < 0 are
    padding. The plan must have been built from the flattened coords."""

    mode: str = "mean"

    @nn.compact
    def __call__(self, point_features: jnp.ndarray, plan: Topology,
                 train: bool = False) -> SparseTensor:
        B, L, C = point_features.shape
        flat = point_features.reshape(B * L, C)
        lvl = plan.levels[0]
        vox = _voxelize(flat, plan, self.mode)
        return SparseTensor(features=vox, num_active=lvl.num_active, level=0)


class BLOutputLayer(nn.Module):
    """Inverse of BLInputLayer: sparse level-0 features -> [B, L, C]."""

    batch_size: int = 1

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology,
                 train: bool = False) -> jnp.ndarray:
        assert x.level == 0
        flat = pool_ops.devoxelize_features(x.features, plan.p2v)
        L = flat.shape[0] // self.batch_size
        return flat.reshape(self.batch_size, L, -1)


class RandomizedStrideConvolution(Convolution):
    """Strided conv whose train-time windows are jittered (reference
    `randomizedStrideConvolution.py` / `RandomizedStrideRules.h`). The
    jitter lives in the PLAN: feed a `core.randomized.build_randomized_plan`
    topology during training and a regular plan at eval — this module is
    the regular strided conv over whichever transition the plan carries."""


class RandomizedStrideMaxPooling(MaxPooling):
    """Max pool over jittered windows (reference
    `randomizedStrideMaxPooling.py`); see RandomizedStrideConvolution."""
