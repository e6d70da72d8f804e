"""Remaining op-library parity modules (reference `sparseconvnet/*.py`).

Activations (`activations.py`), dropouts (`dropout.py`), Identity
(`identity.py`), ActivePooling (`activePooling.py`), SparseToDense /
DenseToSparse (`sparseToDense.py`, `denseToSparse.py`),
AffineReluTrivialConvolution (`affineReluTrivialConvolution.py`),
MeanOnlyBNLeakyReLU / BatchNormELU (`batchNormalization.py:264-309`,
`activations.py`), ShapeContext (`shapeContext.py` — identity-weight
submanifold conv), cross-scale `upsample_feature` (`utils.py:72-132`),
AddCoords (`utils.py:153-166`) and compare_sparse (`utils.py:168-182`).
"""

from __future__ import annotations

from occuseg.nn import core as nn
import jax
import jax.numpy as jnp

from occuseg.core import coords as C
from occuseg.core.sparse_tensor import SparseTensor
from occuseg.core.topology import Topology
from occuseg.ops import conv as conv_ops
from occuseg.ops.gather import gather_rows
from occuseg.ops.norm import leaky_relu


class Identity(nn.Module):
    @nn.compact
    def __call__(self, x, plan=None, train=False):
        return x


def _act_module(name, fn):
    class _Act(nn.Module):
        @nn.compact
        def __call__(self, x: SparseTensor, plan=None, train=False):
            return x.with_features(fn(x.features))
    _Act.__name__ = name
    return _Act


ReLU = _act_module("ReLU", lambda f: jnp.maximum(f, 0))
Tanh = _act_module("Tanh", jnp.tanh)
Sigmoid = _act_module("Sigmoid", jax.nn.sigmoid)
ELU = _act_module("ELU", jax.nn.elu)
SELU = _act_module("SELU", jax.nn.selu)


class LeakyReLU(nn.Module):
    leakiness: float = 0.01

    @nn.compact
    def __call__(self, x: SparseTensor, plan=None, train=False):
        return x.with_features(leaky_relu(x.features, self.leakiness))


class Dropout(nn.Module):
    """Elementwise dropout (reference `dropout.py` Dropout)."""

    p: float = 0.5

    @nn.compact
    def __call__(self, x: SparseTensor, plan=None, train=False):
        if not train or self.p == 0:
            return x
        rng = self.make_rng("dropout")
        keep = jax.random.bernoulli(rng, 1 - self.p, x.features.shape)
        return x.with_features(
            jnp.where(keep, x.features / (1 - self.p), 0))


class BatchwiseDropout(nn.Module):
    """Per-channel (batchwise multiplicative) dropout (reference
    `BatchwiseMultiplicativeDropout`, `SCN/CUDA/BatchwiseMultiplicativeDropout.cu`)."""

    p: float = 0.5

    @nn.compact
    def __call__(self, x: SparseTensor, plan=None, train=False):
        if not train or self.p == 0:
            return x
        rng = self.make_rng("dropout")
        keep = jax.random.bernoulli(rng, 1 - self.p,
                                    (1, x.num_channels))
        return x.with_features(
            jnp.where(keep, x.features / (1 - self.p), 0))


class AffineReluTrivialConvolution(nn.Module):
    """y = relu(x * a + b) @ W — fused (reference
    `affineReluTrivialConvolution.py`)."""

    out_features: int
    param_dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: SparseTensor, plan=None, train=False):
        c = x.num_channels
        a = self.param("affine_weight", nn.initializers.ones, (c,),
                       self.param_dtype)
        b = self.param("affine_bias", nn.initializers.zeros, (c,),
                       self.param_dtype)
        w = self.param("weight", nn.initializers.lecun_normal(),
                       (c, self.out_features), self.param_dtype)
        f = jnp.maximum(x.features * a + b, 0)
        return x.with_features(conv_ops.nin(f, w))


class MeanOnlyBNLeakyReLU(nn.Module):
    """Mean-only batchnorm + leaky ReLU (reference
    `batchNormalization.py:264-309`)."""

    momentum: float = 0.9
    leakiness: float = 0.0

    @nn.compact
    def __call__(self, x: SparseTensor, plan=None, train=False):
        c = x.num_channels
        bias = self.param("bias", nn.initializers.zeros, (c,), jnp.float32)
        ra = self.variable("batch_stats", "running_mean",
                           lambda: jnp.zeros((c,), jnp.float32))
        f = x.features.astype(jnp.float32)
        mask = x.mask()[:, None]
        if train:
            from occuseg.core.sparse_tensor import total_active
            n = jnp.maximum(total_active(x.num_active).astype(jnp.float32),
                            1.0)
            mean = jnp.sum(jnp.where(mask, f, 0), axis=0) / n
            if not self.is_initializing():
                ra.value = (self.momentum * ra.value
                            + (1 - self.momentum) * mean)
        else:
            mean = ra.value
        y = f - mean + bias
        y = jnp.where(y > 0, y, self.leakiness * y)
        y = jnp.where(mask, y, 0)
        return x.with_features(y.astype(x.features.dtype))


class ActivePooling(nn.Module):
    """Global pool over every active site of each batch sample (reference
    `activePooling.py`, rules `ActivePoolingRules.h`). Returns [B, C]."""

    mode: str = "mean"
    num_samples: int = 32

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology, train=False):
        lvl = plan.levels[x.level]
        b = lvl.coords[:, 0]
        seg = jnp.where(b >= 0, b, self.num_samples).astype(jnp.int32)
        f = x.features.astype(jnp.float32)
        if self.mode == "mean":
            s = jax.ops.segment_sum(f, seg, num_segments=self.num_samples + 1)
            cnt = jax.ops.segment_sum(jnp.ones_like(f[:, :1]), seg,
                                      num_segments=self.num_samples + 1)
            out = s[:-1] / jnp.maximum(cnt[:-1], 1)
        else:
            out = jax.ops.segment_max(f, seg,
                                      num_segments=self.num_samples + 1)[:-1]
            out = jnp.where(jnp.isfinite(out), out, 0)
        return out.astype(x.features.dtype)


class ShapeContext(nn.Module):
    """Fixed identity-weight submanifold conv: output = concat of the K^3
    neighbors' features, nIn*K^3 channels (reference `shapeContext.py`)."""

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology, train=False):
        nbr = plan.levels[x.level].nbr
        g = gather_rows(x.features, nbr.reshape(-1))
        g = g.reshape(nbr.shape[0], -1)
        return x.with_features(g)


def sparse_to_dense(x: SparseTensor, plan: Topology,
                    spatial_size: int, batch_size: int) -> jnp.ndarray:
    """[B, E, E, E, C] dense grid (reference `sparseToDense.py`)."""
    lvl = plan.levels[x.level]
    c = lvl.coords
    flat = ((c[:, 0] * spatial_size + c[:, 1]) * spatial_size
            + c[:, 2]) * spatial_size + c[:, 3]
    n_cells = batch_size * spatial_size ** 3
    valid = c[:, 0] >= 0
    flat = jnp.where(valid, flat, n_cells)
    dense = jnp.zeros((n_cells + 1, x.num_channels), x.features.dtype)
    dense = dense.at[flat].add(x.features, mode="drop")
    return dense[:n_cells].reshape(batch_size, spatial_size, spatial_size,
                                   spatial_size, x.num_channels)


def dense_to_sparse_coords(dense_mask: jnp.ndarray, cap: int) -> jnp.ndarray:
    """Active coords [cap, 4] from a boolean [B,E,E,E] grid, padded with -1
    (reference `denseToSparse.py` semantics; cap-bounded for static shape)."""
    B, E = dense_mask.shape[0], dense_mask.shape[1]
    flat = dense_mask.reshape(-1)
    (idx,) = jnp.nonzero(flat, size=cap, fill_value=-1)
    b = idx // (E * E * E)
    r = idx % (E * E * E)
    z = r // (E * E)
    y = (r // E) % E
    x_ = r % E
    out = jnp.stack([b, z, y, x_], axis=1).astype(jnp.int32)
    return jnp.where((idx >= 0)[:, None], out, -1)


def upsample_feature(lr: SparseTensor, hr_level: int, plan: Topology,
                     stride: int = 2, bilinear: bool = False) -> SparseTensor:
    """Cross-scale nearest/trilinear upsample (reference
    `utils.py:72-132`): nearest = gather the covering coarse site; trilinear
    = 8-tap weighted gather at (hr - (stride-1)/2)/stride."""
    assert lr.level == hr_level + 1, "lr must be one level coarser than hr"
    hr_lvl = plan.levels[hr_level]
    lr_lvl = plan.levels[lr.level]
    hc = hr_lvl.coords
    if not bilinear:
        q = jnp.concatenate([hc[:, :1], hc[:, 1:] // stride], axis=-1)
        q = jnp.where(hc[:, :1] >= 0, q, -1)
        idx = C.lookup(lr_lvl.keys, C.pack(q))
        out = gather_rows(lr.features, idx)
    else:
        cand = (hc[:, 1:].astype(jnp.float32) - (stride - 1) / 2) / stride
        lo = jnp.floor(cand)
        hi = jnp.ceil(cand)
        acc = jnp.zeros((hc.shape[0], lr.num_channels), jnp.float32)
        wtot = jnp.zeros((hc.shape[0], 1), jnp.float32)
        for xx in range(2):
            for yy in range(2):
                for zz in range(2):
                    az = jnp.where(zz == 0, hi[:, 0], lo[:, 0])
                    ay = jnp.where(yy == 0, hi[:, 1], lo[:, 1])
                    ax = jnp.where(xx == 0, hi[:, 2], lo[:, 2])
                    wz = 1 - jnp.abs(az - cand[:, 0])
                    wy = 1 - jnp.abs(ay - cand[:, 1])
                    wx = 1 - jnp.abs(ax - cand[:, 2])
                    w = jnp.maximum(wz, 0) * jnp.maximum(wy, 0) \
                        * jnp.maximum(wx, 0)
                    q = jnp.stack([hc[:, 0], az.astype(jnp.int32),
                                   ay.astype(jnp.int32),
                                   ax.astype(jnp.int32)], axis=1)
                    q = jnp.where(hc[:, :1] >= 0, q, -1)
                    idx = C.lookup(lr_lvl.keys, C.pack(q))
                    w = jnp.where(idx >= 0, w, 0)[:, None]
                    acc = acc + gather_rows(lr.features, idx).astype(
                        jnp.float32) * w
                    wtot = wtot + w
        out = (acc / jnp.maximum(wtot, 1e-12)).astype(lr.features.dtype)
    return SparseTensor(features=out, num_active=hr_lvl.num_active,
                        level=hr_level)


def add_coords(x: SparseTensor, plan: Topology,
               scale: float = 1.0) -> SparseTensor:
    """Append normalized (z,y,x) as 3 extra channels (reference AddCoords,
    `utils.py:153-166`)."""
    c = plan.levels[x.level].coords[:, 1:].astype(x.features.dtype)
    c = jnp.where(c >= 0, c * scale, 0)
    return x.with_features(jnp.concatenate([x.features, c], axis=-1))


def compare_sparse(plan_a: Topology, a: SparseTensor,
                   plan_b: Topology, b: SparseTensor) -> jnp.ndarray:
    """Normalized squared difference across two tensors with possibly
    different topologies (reference `utils.py:168-182`,
    `Metadata::compareSparseHelper`): sum over the union of sites of
    ||fa - fb||^2 (missing side = 0) / sum max(||fa||^2, ||fb||^2)."""
    la, lb = plan_a.levels[a.level], plan_b.levels[b.level]
    idx_ab = C.lookup(lb.keys, la.keys)
    fb_on_a = gather_rows(b.features, idx_ab)
    da = jnp.sum((a.features - fb_on_a) ** 2)
    # sites only in b
    idx_ba = C.lookup(la.keys, lb.keys)
    only_b = (idx_ba < 0) & (lb.keys < C.KEY_PAD)
    db = jnp.sum(jnp.where(only_b[:, None], b.features ** 2, 0))
    na = jnp.sum(a.features ** 2)
    nb = jnp.sum(b.features ** 2)
    return (da + db) / jnp.maximum(jnp.maximum(na, nb), 1e-12)


class MultiscaleShapeContext(nn.Module):
    """ShapeContext at several scales, upsampled back and concatenated
    (reference `shapeContext.py` MultiscaleShapeContext: input layers at
    power-of-2 downsamplings + shape context + nearest upsample)."""

    num_scales: int = 3

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology, train=False):
        from occuseg.nn.extras import upsample_feature

        assert self.num_scales <= len(plan.levels) - x.level
        parts = [ShapeContext(name="sc0")(x, plan, train)]
        cur = x
        for s in range(1, self.num_scales):
            from occuseg.ops import pool as _pool
            tr = plan.transitions[cur.level]
            pooled = _pool.avg_pool(cur.features, tr.child)
            lvl = plan.levels[cur.level + 1]
            cur = SparseTensor(features=pooled, num_active=lvl.num_active,
                               level=cur.level + 1)
            sc = ShapeContext(name=f"sc{s}")(cur, plan, train)
            up = sc
            for back in range(cur.level, x.level, -1):
                up = upsample_feature(up, back - 1, plan, stride=2)
            parts.append(up)
        feats = jnp.concatenate([p.features for p in parts], axis=-1)
        return x.with_features(feats)


def sparsify_coords(x: SparseTensor, plan: Topology, cap: int,
                    threshold: float = 0.0) -> jnp.ndarray:
    """Coords of sites whose feature norm exceeds `threshold`, padded to
    `cap` with -1 (reference `sparsify.py`: new Metadata keeping only
    'active' sites). Feed the result to a new `build_plan` to continue on
    the sparsified topology."""
    lvl = plan.levels[x.level]
    mag = jnp.sum(jnp.abs(x.features.astype(jnp.float32)), axis=-1)
    keep = (mag > threshold) & (lvl.coords[:, 0] >= 0)
    (idx,) = jnp.nonzero(keep, size=cap, fill_value=-1)
    safe = jnp.where(idx < 0, 0, idx)
    out = lvl.coords[safe]
    return jnp.where((idx >= 0)[:, None], out, -1)


class PermutohedralSubmanifoldConvolution(nn.Module):
    """Submanifold convolution over the permutohedral (A_3) lattice's
    d^2+d+1 = 13 nearest-neighbor offsets (reference
    `permutohedralSubmanifoldConvolution.py:29-63`). Requires a plan built
    with `PlanSpec(lattice="permutohedral")` on coordinates pre-mapped via
    `ops/permutohedral.embed_points`; the conv itself is the ordinary
    gather + matmul with K = 13."""

    out_features: int
    use_bias: bool = False
    param_dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology,
                 train: bool = False) -> SparseTensor:
        from occuseg.nn.modules import _he_conv_init
        from occuseg.ops import conv as _conv

        lvl = plan.levels[x.level]
        K = lvl.nbr.shape[1]
        w = self.param("weight", _he_conv_init(K),
                       (K, x.num_channels, self.out_features),
                       self.param_dtype)
        b = (self.param("bias", nn.initializers.zeros,
                        (self.out_features,), self.param_dtype)
             if self.use_bias else None)
        out = _conv.gather_conv(x.features, lvl.nbr, w, b)
        return x.with_features(out)


class SpatialDropOut(nn.Module):
    """Channel dropout with the reference's exact (non-inverted) scaling
    (`model.py:97-113`): train multiplies by a per-channel bernoulli mask
    with NO 1/(1-p) rescale; eval multiplies all features by (1-p)."""

    p: float = 0.5

    @nn.compact
    def __call__(self, x: SparseTensor, plan=None, train=False):
        if not train:
            return x.with_features(x.features * (1 - self.p))
        rng = self.make_rng("dropout")
        keep = jax.random.bernoulli(rng, 1 - self.p, (1, x.num_channels))
        return x.with_features(jnp.where(keep, x.features, 0))
