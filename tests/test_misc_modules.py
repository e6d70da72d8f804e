"""SpectralDense, classification harness, drift loss."""

import numpy as np

import jax
import jax.numpy as jnp
from occuseg.nn import core as nn

from occuseg.core.topology import PlanSpec
from occuseg.nn.extras import ActivePooling
from occuseg.nn.modules import SubmanifoldConvolution, InputLayer
from occuseg.nn.spectral_norm import SpectralDense
from occuseg.train.classification import classification_train_validate

from tests.utils import random_points


def test_spectral_dense_unit_norm():
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (16, 8)).astype(np.float32))
    m = SpectralDense(4, n_power_iterations=20)
    v = m.init(jax.random.PRNGKey(0), x, False)
    # after normalization the kernel's top singular value is ~1
    y, mut = m.apply(v, x, True, mutable=["spectral"])
    k = np.asarray(v["params"]["kernel"])
    u = np.asarray(mut["spectral"]["u"])
    sv = np.linalg.svd(k, compute_uv=False)
    # effective weight = k / sigma_est; sigma_est converges to sv[0]
    vvec = k @ u
    vvec /= np.linalg.norm(vvec)
    uvec = k.T @ vvec
    sigma_est = vvec @ (k @ (uvec / np.linalg.norm(uvec)))
    assert abs(sigma_est - sv[0]) / sv[0] < 0.05


class TinyClassifier(nn.Module):
    @nn.compact
    def __call__(self, feats, plan, train=False):
        x = InputLayer(name="in")(feats, plan, train)
        x = SubmanifoldConvolution(8, name="conv")(x, plan, train)
        pooled = ActivePooling(num_samples=2, name="pool")(x, plan, train)
        return nn.Dense(3, name="head")(pooled)


def _batches(seed):
    def gen():
        rng = np.random.default_rng(seed)
        for _ in range(3):
            pts = random_points(rng, 200, extent=8, batch_size=2, pad_to=256)
            feats = rng.standard_normal((256, 3)).astype(np.float32)
            yield {"coords": pts, "features": feats,
                   "label": rng.integers(0, 3, 2).astype(np.int32)}
    return gen


def test_classification_harness_runs():
    spec = PlanSpec(caps=(256, 128))
    res = classification_train_validate(
        TinyClassifier(), spec, _batches(0), _batches(1), num_epochs=1)
    assert len(res["history"]) == 1
    assert np.isfinite(res["history"][0]["loss"])
