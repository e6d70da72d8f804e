"""Architecture builders: VGG (incl. 'Plus' multi-branch specs), ResNet,
FCN forward shapes and finiteness (reference `networkArchitectures.py`)."""

import numpy as np

import jax
import jax.numpy as jnp

from occuseg.core import topology as T
from occuseg.core.sparse_tensor import SparseTensor
from occuseg.nn.unet import (
    FullyConvolutionalNet,
    SparseResNet,
    SparseVggNet,
)

from tests.utils import random_points

P_CAP = 512


def _plan_and_input(seed=0, levels=4, cin=4, down_size=2, down_stride=2):
    rng = np.random.default_rng(seed)
    pts = random_points(rng, 400, extent=32, batch_size=1, pad_to=P_CAP)
    caps = tuple(max(P_CAP >> l, 64) for l in range(levels))
    spec = T.PlanSpec(caps=caps, down_size=down_size,
                      down_stride=down_stride)
    plan = T.build_plan(jnp.asarray(pts), spec)
    n0 = int(plan.levels[0].num_active)
    feats = np.zeros((caps[0], cin), np.float32)
    feats[:n0] = rng.standard_normal((n0, cin), dtype=np.float32)
    x = SparseTensor(features=jnp.asarray(feats),
                     num_active=plan.levels[0].num_active, level=0)
    return plan, x


def _run(model, plan, x):
    variables = model.init(jax.random.PRNGKey(0), x, plan, False)
    out = model.apply(variables, x, plan, False)
    assert np.isfinite(np.asarray(out.features)).all()
    return out


def test_vgg_simple():
    plan, x = _plan_and_input()
    model = SparseVggNet(layers=(("C", 8), ("C", 8), "MP", ("C", 16)))
    out = _run(model, plan, x)
    assert out.features.shape[-1] == 16
    assert out.level == 1


def test_vgg_plus_specs():
    # 'Plus' branches descend with size-3/stride-2 convs
    # (networkArchitectures.py:34-129) — plan built to match
    plan, x = _plan_and_input(seed=1, down_size=3, down_stride=2)
    model = SparseVggNet(layers=(("C", 8), ("C", 8, 8), ("C", 4, 4, 4)))
    out = _run(model, plan, x)
    assert out.features.shape[-1] == 4 + 4 + 4
    assert out.level == 0


def test_resnet_builder():
    # reference basic blocks downsample with size-3/stride-2 convs
    # (networkArchitectures.py:142)
    plan, x = _plan_and_input(seed=2, down_size=3, down_stride=2)
    model = SparseResNet(layers=(("b", 8, 2, 1), ("b", 16, 2, 2)))
    out = _run(model, plan, x)
    assert out.features.shape[-1] == 16
    assert out.level == 1


def test_fcn_builder():
    plan, x = _plan_and_input(seed=3)
    model = FullyConvolutionalNet(reps=1, n_planes=(8, 16, 24))
    out = _run(model, plan, x)
    # FCN concatenates every upsampled scale at full resolution
    assert out.features.shape[-1] == 8 + 16 + 24
    assert out.level == 0
