"""OccuSeg model family (reference `examples/ScanNet/model.py`).

* `ThreeVoxelKernel` (`model.py:748-784`): InputLayer -> SubmanifoldConv ->
  UNet -> BN-ReLU -> OutputLayer backbone + semantic/embedding/offset heads.
* `InstanceDenseUNet` (`model.py:657-691`): same backbone + embedding /
  offset(sigmoid) / displacement heads.
* `LearningBWDenseUNet` (`model.py:693-717`): the full OccuSeg model —
  backbone + per-point bandwidth (2-dim Softplus) and occupancy (1-dim
  Softplus) heads.

Head wiring copies the reference exactly: each head is fc -> linear with NO
intermediate activation (`model.py:687-691`), sigmoid on offset, Softplus on
bw/occupancy.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from occuseg.nn import core as nn
import jax.numpy as jnp

from occuseg.core.topology import Topology
from occuseg.nn.modules import (
    BatchNormReLU,
    InputLayer,
    OutputLayer,
    SubmanifoldConvolution,
)
from occuseg.nn.unet import UNet


class OccuSegOutputs(NamedTuple):
    """Per-point predictions, all [P_cap, ...]; padding rows are zero."""

    semantics: jnp.ndarray       # [P, num_classes] logits
    features: jnp.ndarray        # [P, m] backbone features
    embedding: jnp.ndarray       # [P, m]
    offset: jnp.ndarray          # [P, 1] sigmoid centredness
    displacement: jnp.ndarray    # [P, 3] regressed offset to instance center
    bw: jnp.ndarray | None = None         # [P, 2] softplus bandwidths
    occupancy: jnp.ndarray | None = None  # [P, 1] softplus log-occupancy


class _Backbone(nn.Module):
    """InputLayer -> SubConv(in, m) -> UNet -> BN-ReLU -> OutputLayer.

    compute_dtype=bfloat16 runs all conv activations in bf16 (params stay
    f32; BN statistics and matmul accumulation are f32 regardless). Head features are returned in f32.
    """

    n_planes: Tuple[int, ...]
    block_reps: int = 1
    residual_blocks: bool = True
    compute_dtype: jnp.dtype = jnp.float32
    normal_guided: bool = False  # --use_normal: rotation-invariant filters
                                 # via the plan's per-site orientation
                                 # classes (reference use_normal rulebooks)

    @nn.compact
    def __call__(self, point_features: jnp.ndarray, plan: Topology,
                 train: bool = False) -> jnp.ndarray:
        point_features = point_features.astype(self.compute_dtype)
        x = InputLayer(mode="mean", name="input")(point_features, plan, train)
        x = SubmanifoldConvolution(self.n_planes[0],
                                   normal_guided=self.normal_guided,
                                   name="sub")(x, plan, train)
        x = UNet(self.block_reps, tuple(self.n_planes),
                 residual_blocks=self.residual_blocks,
                 normal_guided=self.normal_guided, name="unet")(
            x, plan, train)
        x = BatchNormReLU(name="bn")(x, plan, train)
        out = OutputLayer(name="output")(x, plan, train)
        return out.astype(jnp.float32)


class ThreeVoxelKernel(nn.Module):
    """Semantic + embedding + offset model (reference `model.py:748-784`)."""

    n_planes: Tuple[int, ...]
    num_classes: int = 20
    block_reps: int = 1
    residual_blocks: bool = True
    compute_dtype: jnp.dtype = jnp.float32
    normal_guided: bool = False

    @nn.compact
    def __call__(self, point_features: jnp.ndarray, plan: Topology,
                 train: bool = False) -> OccuSegOutputs:
        m = self.n_planes[0]
        feature = _Backbone(tuple(self.n_planes), self.block_reps,
                            self.residual_blocks, self.compute_dtype,
                            self.normal_guided,
                            name="backbone")(point_features, plan, train)
        y = nn.Dense(self.num_classes, name="linear")(feature)
        embedding = nn.Dense(m, name="linear_embedding")(
            nn.Dense(m, name="fc_embedding")(feature))
        offset = nn.sigmoid(nn.Dense(1, name="linear_regress")(
            nn.Dense(m, name="fc_regress")(feature)))
        return OccuSegOutputs(semantics=y, features=feature,
                              embedding=embedding, offset=offset,
                              displacement=jnp.zeros(
                                  feature.shape[:1] + (3,), feature.dtype))


class InstanceDenseUNet(nn.Module):
    """Backbone + semantic/embedding/offset/displacement heads
    (reference `model.py:657-691`)."""

    n_planes: Tuple[int, ...]
    num_classes: int = 20
    block_reps: int = 1
    residual_blocks: bool = True
    compute_dtype: jnp.dtype = jnp.float32
    normal_guided: bool = False

    @nn.compact
    def __call__(self, point_features: jnp.ndarray, plan: Topology,
                 train: bool = False) -> OccuSegOutputs:
        m = self.n_planes[0]
        feature = _Backbone(tuple(self.n_planes), self.block_reps,
                            self.residual_blocks, self.compute_dtype,
                            self.normal_guided,
                            name="backbone")(point_features, plan, train)
        y = nn.Dense(self.num_classes, name="linear")(feature)
        embedding = nn.Dense(m, name="linear_embedding")(
            nn.Dense(m, name="fc_embedding")(feature))
        offset = nn.sigmoid(nn.Dense(1, name="linear_regress")(
            nn.Dense(m, name="fc_regress")(feature)))
        displacement = nn.Dense(3, name="linear_displacement")(
            nn.Dense(m, name="fc_displacement")(feature))
        return OccuSegOutputs(semantics=y, features=feature,
                              embedding=embedding, offset=offset,
                              displacement=displacement)


class LearningBWDenseUNet(nn.Module):
    """The flagship OccuSeg model (reference `model.py:693-717`)."""

    n_planes: Tuple[int, ...]
    num_classes: int = 20
    block_reps: int = 1
    residual_blocks: bool = True
    compute_dtype: jnp.dtype = jnp.float32
    normal_guided: bool = False

    @nn.compact
    def __call__(self, point_features: jnp.ndarray, plan: Topology,
                 train: bool = False) -> OccuSegOutputs:
        m = self.n_planes[0]
        base = InstanceDenseUNet(
            tuple(self.n_planes), self.num_classes, self.block_reps,
            self.residual_blocks, self.compute_dtype, self.normal_guided,
            name="backbone")(point_features, plan, train)
        bw = nn.softplus(nn.Dense(2, name="linear_bw")(
            nn.Dense(m, name="fc_bw")(base.features)))
        occupancy = nn.softplus(nn.Dense(1, name="linear_occupancy")(
            nn.Dense(m, name="fc_occupancy")(base.features)))
        return base._replace(bw=bw, occupancy=occupancy)


class ClusterSegNet(nn.Module):
    """Supervoxel-cluster semantic classifier (reference `model.py:719-745`):
    point MLP -> per-cluster max-pool -> cluster MLP -> class logits.
    Clusters are given as a per-point segment id (padded, -1 = none)."""

    num_classes: int = 20
    num_clusters: int = 1024

    @nn.compact
    def __call__(self, features: jnp.ndarray, cluster_index: jnp.ndarray,
                 train: bool = False) -> jnp.ndarray:
        import jax

        def bn_relu(x, name):
            h = nn.BatchNorm(use_running_average=not train,
                             momentum=0.9, epsilon=1e-4, name=f"{name}_bn")(x)
            return nn.leaky_relu(h)

        y = nn.Dense(128, name="mlp1")(features)
        y = bn_relu(y, "l1")
        y = nn.Dense(256, name="mlp2")(y)
        y = bn_relu(y, "l2")
        seg = jnp.where(cluster_index >= 0, cluster_index,
                        self.num_clusters).astype(jnp.int32)
        pooled = jax.ops.segment_max(y, seg,
                                     num_segments=self.num_clusters + 1)
        pooled = jnp.where(jnp.isfinite(pooled), pooled, 0)[:self.num_clusters]
        z = nn.Dense(128, name="mlp3")(pooled)
        z = bn_relu(z, "l3")
        return nn.Dense(self.num_classes, name="mlp4")(z)


class CrossScaleFusion(nn.Module):
    """Gated linear projection (reference `model.py:115-130`): linear(x) *
    sigmoid(reweight(x)), broadcast over the output width."""

    out_features: int

    @nn.compact
    def __call__(self, x, plan: Topology, train: bool = False):
        import jax

        lin = nn.Dense(self.out_features, name="linear")(x.features)
        gate = jax.nn.sigmoid(nn.Dense(1, name="reweight")(x.features))
        return x.with_features(lin * gate)


class _RepResidualBlock(nn.Module):
    """`reps` chained pre-activated residual blocks (reference
    `model.py:70-82`; ResidualBlock at :15-33 == nn/unet._Block)."""

    in_features: int
    out_features: int
    reps: int = 1
    leakiness: float = 0.0

    @nn.compact
    def __call__(self, x, plan: Topology, train: bool = False):
        from occuseg.nn.unet import _Block

        for i in range(self.reps):
            cin = self.in_features if i == 0 else self.out_features
            x = _Block(cin, self.out_features, residual=True,
                       leakiness=self.leakiness, name=f"res{i}")(
                x, plan, train)
        return x


class DenseUNet_BN(nn.Module):
    """Dense-skip UNet with gated cross-scale fusion (reference
    `model.py:133-257`): encoder pyramid of residual blocks + strided
    convs; decoder merges each deconv with the encoder skip through a
    gated linear (`linearReweight`), then ADDS `CrossScaleFusion`
    projections of the deepest encoder feature and of every earlier
    decoder output, each upsampled (nearest, stride 2^k) to the current
    scale — a densely-connected decoder rather than plain U-skips."""

    n_planes: Tuple[int, ...]
    block_reps: int = 1
    leakiness: float = 0.0
    output_feature_lvl: int = 0  # 0 = full resolution

    @nn.compact
    def __call__(self, x, plan: Topology, train: bool = False):
        from occuseg.nn.extras import upsample_feature
        from occuseg.nn.modules import (
            BatchNormLeakyReLU,
            Convolution,
            Deconvolution,
            NetworkInNetwork,
        )
        from occuseg.core.sparse_tensor import add_features

        p = tuple(self.n_planes)
        L = len(p)
        lk = self.leakiness

        def up_by(t, to_level):
            # repeated x2 nearest upsample == one 2^k-stride nearest lookup
            # (`utils.py:72-101` ResolutionBasedScattering path)
            while t.level > to_level:
                t = upsample_feature(t, t.level - 1, plan, stride=2)
            return t

        # encoder (model.py:198-209)
        features = []
        cur = x
        for idx in range(L - 1):
            cur = _RepResidualBlock(p[idx], p[idx], self.block_reps, lk,
                                    name=f"res{idx}")(cur, plan, train)
            features.append(cur)
            y = BatchNormLeakyReLU(leakiness=lk, name=f"bn0_{idx}")(
                cur, plan, train)
            cur = Convolution(p[idx + 1], 2, 2, name=f"conv{idx}")(
                y, plan, train)
        cur = _RepResidualBlock(p[L - 1], p[L - 1], self.block_reps, lk,
                                name=f"res{L-1}")(cur, plan, train)
        features.append(cur)

        # decoder (model.py:211-256)
        features2 = []
        for count in range(L - 1 - self.output_feature_lvl):
            li = L - 2 - count
            src = features[li + 1] if count == 0 else features2[-1]
            u = Deconvolution(p[li], 2, 2, name=f"deconv{li}")(
                BatchNormLeakyReLU(leakiness=lk, name=f"bn1_{li}")(
                    src, plan, train), plan, train)
            u = NetworkInNetwork(p[li], use_bias=True,
                                 name=f"reweight{li}")(u, plan, train)
            a = _RepResidualBlock(p[li], p[li], self.block_reps, lk,
                                  name=f"res2_{li}")(
                add_features(features[li], u), plan, train)
            b = CrossScaleFusion(p[li], name=f"csf_deep_{li}")(
                features[-1], plan, train)
            a = add_features(a, up_by(b, li))
            for j in range(count):
                b = CrossScaleFusion(p[li], name=f"csf{j}_{li}")(
                    features2[j], plan, train)
                a = add_features(a, up_by(b, li))
            features2.append(BatchNormLeakyReLU(leakiness=lk,
                                                name=f"bn2_{li}")(
                a, plan, train))
        out = features2[-1]
        if self.output_feature_lvl > 0:
            out = up_by(out, 0)
        return out
