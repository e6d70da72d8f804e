"""Network architecture builders (reference `networkArchitectures.py`).

`UNet` reproduces the reference's recursive builder exactly
(`networkArchitectures.py:202-306`): per level `reps` blocks (VGG or
pre-activated residual), then [Identity | BN-LeakyReLU -> strided Conv ->
U(deeper) -> BN-LeakyReLU -> Deconv] joined by channel concat, then `reps`
decoder blocks (first one consuming 2x channels).

`FullyConvolutionalNet` (`:308-361`), `SparseVggNet` (`:9-130`, including
the multi-branch 'Plus' specs via `_PlusBranch`) and `SparseResNet`
(`:132-200`, basic blocks) are provided for builder parity.
"""

from __future__ import annotations

from typing import Tuple

from occuseg.nn import core as nn

from occuseg.core.sparse_tensor import (
    SparseTensor,
    add_features,
    concat_features,
)
from occuseg.core.topology import Topology
from occuseg.nn.modules import (
    BatchNormalization,
    BatchNormReLU,
    Convolution,
    Deconvolution,
    MaxPooling,
    NetworkInNetwork,
    SubmanifoldConvolution,
)


class _Block(nn.Module):
    """One VGG or pre-activated-residual block (reference `block()` closure,
    `networkArchitectures.py:220-245`)."""

    in_features: int
    out_features: int
    residual: bool
    leakiness: float = 0.0
    normal_guided: bool = False

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology, train: bool = False):
        a, b = self.in_features, self.out_features
        ng = self.normal_guided
        if self.residual:
            if a == b:
                shortcut = x
            else:
                shortcut = NetworkInNetwork(b, name="shortcut")(x, plan, train)
            y = BatchNormalization(leakiness=self.leakiness, name="bn1")(
                x, plan, train)
            y = SubmanifoldConvolution(b, normal_guided=ng, name="conv1")(
                y, plan, train)
            y = BatchNormalization(leakiness=self.leakiness, name="bn2")(
                y, plan, train)
            y = SubmanifoldConvolution(b, normal_guided=ng, name="conv2")(
                y, plan, train)
            return add_features(shortcut, y)
        y = BatchNormalization(leakiness=self.leakiness, name="bn1")(
            x, plan, train)
        return SubmanifoldConvolution(b, normal_guided=ng, name="conv1")(
            y, plan, train)


class UNet(nn.Module):
    """Recursive sparse UNet (reference `networkArchitectures.py:276-305`)."""

    reps: int
    n_planes: Tuple[int, ...]
    residual_blocks: bool = False
    down_size: int = 2
    down_stride: int = 2
    leakiness: float = 0.0
    normal_guided: bool = False

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology, train: bool = False):
        p = tuple(self.n_planes)
        ng = self.normal_guided
        for i in range(self.reps):
            x = _Block(p[0], p[0], self.residual_blocks, self.leakiness,
                       normal_guided=ng, name=f"enc{i}")(x, plan, train)
        if len(p) == 1:
            return x
        skip = x
        y = BatchNormalization(leakiness=self.leakiness, name="down_bn")(
            x, plan, train)
        y = Convolution(p[1], self.down_size, self.down_stride,
                        name="down_conv")(y, plan, train)
        y = UNet(self.reps, p[1:], self.residual_blocks, self.down_size,
                 self.down_stride, self.leakiness, normal_guided=ng,
                 name="inner")(y, plan, train)
        y = BatchNormalization(leakiness=self.leakiness, name="up_bn")(
            y, plan, train)
        y = Deconvolution(p[0], self.down_size, self.down_stride,
                          name="up_conv")(y, plan, train)
        x = concat_features(skip, y)
        for i in range(self.reps):
            cin = p[0] * (2 if i == 0 else 1)
            x = _Block(cin, p[0], self.residual_blocks, self.leakiness,
                       normal_guided=ng, name=f"dec{i}")(x, plan, train)
        return x


class FullyConvolutionalNet(nn.Module):
    """Encoder pyramid whose every scale is upsampled (by repeated deconv)
    and concatenated at full resolution (reference
    `networkArchitectures.py:308-361`)."""

    reps: int
    n_planes: Tuple[int, ...]
    residual_blocks: bool = False
    down_size: int = 2
    down_stride: int = 2
    leakiness: float = 0.0

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology, train: bool = False):
        p = tuple(self.n_planes)
        for i in range(self.reps):
            x = _Block(p[0], p[0], self.residual_blocks, self.leakiness,
                       name=f"enc{i}")(x, plan, train)
        if len(p) == 1:
            return x
        y = BatchNormalization(leakiness=self.leakiness, name="down_bn")(
            x, plan, train)
        y = Convolution(p[1], self.down_size, self.down_stride,
                        name="down_conv")(y, plan, train)
        y = FullyConvolutionalNet(
            self.reps, p[1:], self.residual_blocks, self.down_size,
            self.down_stride, self.leakiness, name="inner")(y, plan, train)
        y = BatchNormalization(leakiness=self.leakiness, name="up_bn")(
            y, plan, train)
        y = Deconvolution(y.num_channels, self.down_size, self.down_stride,
                          name="up_conv")(y, plan, train)
        return concat_features(x, y)


class _PlusBranch(nn.Module):
    """One 'Plus' side branch: descend `depth` levels (strided Conv +
    BNReLU + SubConv + BNReLU each), ascend with Deconv, interleaving
    BNReLU + SubConv + BNReLU between deconvs (reference
    `networkArchitectures.py:34-129`, the ConcatTable Sequentials of the
    len(x)==3/4/5 specs — the same pattern at depths 1/2/3)."""

    channels: int
    depth: int

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology, train: bool = False):
        n = self.channels
        for j in range(self.depth):
            x = Convolution(n, 3, 2, name=f"down{j}")(x, plan, train)
            x = BatchNormReLU(name=f"down{j}_bn")(x, plan, train)
            x = SubmanifoldConvolution(n, name=f"down{j}_sub")(x, plan, train)
            x = BatchNormReLU(name=f"down{j}_sub_bn")(x, plan, train)
        for j in range(self.depth):
            x = Deconvolution(n, 3, 2, name=f"up{j}")(x, plan, train)
            if j < self.depth - 1:
                x = BatchNormReLU(name=f"up{j}_bn")(x, plan, train)
                x = SubmanifoldConvolution(n, name=f"up{j}_sub")(
                    x, plan, train)
                x = BatchNormReLU(name=f"up{j}_sub_bn")(x, plan, train)
        return x


class SparseVggNet(nn.Module):
    """VGG-style builder (reference `networkArchitectures.py:9-130`):
    'MP', ('MP',sz,st), 'C3/2', ('C3/2',n), ('C',n), and the 'Plus'
    multi-branch specs ('C',n1,n2[,n3[,n4]]) — a submanifold conv joined
    (channel concat) with side branches that descend 1/2/3 levels and
    deconv back, BNReLU after the join. The plan must be built with
    down_size=3, down_stride=2 and enough levels for the deepest branch."""

    layers: Tuple

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology, train: bool = False):
        for i, spec in enumerate(self.layers):
            if spec == "MP":
                x = MaxPooling(3, 2, name=f"mp{i}")(x, plan, train)
            elif isinstance(spec, (tuple, list)) and spec[0] == "MP":
                x = MaxPooling(spec[1], spec[2], name=f"mp{i}")(x, plan, train)
            elif spec == "C3/2":
                x = Convolution(x.num_channels, 3, 2, name=f"conv{i}")(
                    x, plan, train)
                x = BatchNormReLU(name=f"bn{i}")(x, plan, train)
            elif isinstance(spec, (tuple, list)) and spec[0] == "C3/2":
                x = Convolution(spec[1], 3, 2, name=f"conv{i}")(x, plan, train)
                x = BatchNormReLU(name=f"bn{i}")(x, plan, train)
            elif isinstance(spec, (tuple, list)) and spec[0] == "C" and len(spec) == 2:
                x = SubmanifoldConvolution(spec[1], name=f"conv{i}")(
                    x, plan, train)
                x = BatchNormReLU(name=f"bn{i}")(x, plan, train)
            elif isinstance(spec, (tuple, list)) and spec[0] == "C" and len(spec) <= 5:
                parts = [SubmanifoldConvolution(spec[1], name=f"conv{i}")(
                    x, plan, train)]
                for b, n in enumerate(spec[2:]):
                    parts.append(_PlusBranch(n, b + 1, name=f"plus{i}b{b}")(
                        x, plan, train))
                y = parts[0]
                for p in parts[1:]:
                    y = concat_features(y, p)
                x = BatchNormReLU(name=f"bn{i}")(y, plan, train)
            else:
                raise NotImplementedError(f"SparseVggNet spec {spec!r}")
        return x


class SparseResNet(nn.Module):
    """Pre-activated ResNet with 'basic' blocks (reference
    `networkArchitectures.py:132-200`)."""

    layers: Tuple  # of (block_type, n, reps, stride)

    @nn.compact
    def __call__(self, x: SparseTensor, plan: Topology, train: bool = False):
        for li, (block_type, n, reps, stride) in enumerate(self.layers):
            assert block_type.startswith("b"), "only basic blocks supported"
            for rep in range(reps):
                name = f"l{li}r{rep}"
                if rep == 0:
                    x = BatchNormReLU(name=f"{name}_bn0")(x, plan, train)
                    if stride == 1:
                        y = SubmanifoldConvolution(n, name=f"{name}_conv1")(
                            x, plan, train)
                    else:
                        y = Convolution(n, 3, stride, name=f"{name}_conv1")(
                            x, plan, train)
                    y = BatchNormReLU(name=f"{name}_bn1")(y, plan, train)
                    y = SubmanifoldConvolution(n, name=f"{name}_conv2")(
                        y, plan, train)
                    if stride > 1:
                        sc = Convolution(n, 3, stride, name=f"{name}_sc")(
                            x, plan, train)
                    elif x.num_channels != n:
                        sc = NetworkInNetwork(n, name=f"{name}_sc")(
                            x, plan, train)
                    else:
                        sc = x
                    x = add_features(y, sc)
                else:
                    y = BatchNormReLU(name=f"{name}_bn0")(x, plan, train)
                    y = SubmanifoldConvolution(n, name=f"{name}_conv1")(
                        y, plan, train)
                    y = BatchNormReLU(name=f"{name}_bn1")(y, plan, train)
                    y = SubmanifoldConvolution(n, name=f"{name}_conv2")(
                        y, plan, train)
                    x = add_features(y, x)
        return BatchNormReLU(name="final_bn")(x, plan, train)
