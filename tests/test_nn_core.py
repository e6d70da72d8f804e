"""The in-repo module layer (`occuseg/nn/core.py`): naming, parameter and
variable collections, rng derivation, and errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from occuseg.nn import core as nn


class Inner(nn.Module):
    features: int = 3

    @nn.compact
    def __call__(self, x):
        return nn.Dense(self.features)(x) + nn.Dense(self.features)(x)


class Outer(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        y = Inner(name="named")(x)
        y = Inner()(y)
        stat = self.variable("batch_stats", "count",
                             lambda: jnp.zeros((), jnp.int32))
        if train and not self.is_initializing():
            stat.value = stat.value + 1
        return y


class Holder(nn.Module):
    layers: tuple = ()

    @nn.compact
    def __call__(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


def test_param_tree_names():
    v = Outer().init(jax.random.PRNGKey(0), jnp.ones((2, 4)))
    assert set(v) == {"params", "batch_stats"}
    assert set(v["params"]) == {"named", "Inner_0"}
    assert set(v["params"]["named"]) == {"Dense_0", "Dense_1"}
    assert v["params"]["named"]["Dense_0"]["kernel"].shape == (4, 3)
    assert v["params"]["Inner_0"]["Dense_0"]["kernel"].shape == (3, 3)


def test_attribute_held_modules_named_by_field():
    m = Holder(layers=(nn.Dense(5), nn.Dense(2)))
    v = m.init(jax.random.PRNGKey(0), jnp.ones((1, 3)))
    assert set(v["params"]) == {"layers_0", "layers_1"}
    assert m.apply(v, jnp.ones((1, 3))).shape == (1, 2)


def test_init_is_deterministic_and_keys_differ():
    a = Outer().init(jax.random.PRNGKey(1), jnp.ones((2, 4)))
    b = Outer().init(jax.random.PRNGKey(1), jnp.ones((2, 4)))
    jax.tree.map(np.testing.assert_array_equal, a, b)
    k0 = np.asarray(a["params"]["named"]["Dense_0"]["kernel"])
    k1 = np.asarray(a["params"]["named"]["Dense_1"]["kernel"])
    assert not np.allclose(k0, k1)


def test_apply_mutable_returns_updates_and_leaves_input():
    m = Outer()
    v = m.init(jax.random.PRNGKey(0), jnp.ones((2, 4)))
    out, upd = m.apply(v, jnp.ones((2, 4)), True, mutable=["batch_stats"])
    assert out.shape == (2, 3)
    assert int(upd["batch_stats"]["count"]) == 1
    assert int(v["batch_stats"]["count"]) == 0
    assert set(upd) == {"batch_stats"}


def test_apply_errors():
    m = Outer()
    v = m.init(jax.random.PRNGKey(0), jnp.ones((2, 4)))
    with pytest.raises(ValueError, match="not mutable"):
        m.apply(v, jnp.ones((2, 4)), True)
    with pytest.raises(KeyError, match="no parameter"):
        m.apply({"batch_stats": v["batch_stats"]}, jnp.ones((2, 4)))
    with pytest.raises(RuntimeError, match="unbound"):
        m(jnp.ones((2, 4)))


def test_batch_norm_train_and_eval():
    x = jnp.asarray(np.random.default_rng(0).normal(2.0, 3.0, (64, 4)),
                    jnp.float32)
    bn = nn.BatchNorm(momentum=0.5)
    v = bn.init(jax.random.PRNGKey(0), x)
    y, upd = bn.apply(v, x, mutable=["batch_stats"])
    np.testing.assert_allclose(np.asarray(y).mean(0), 0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(y).std(0), 1, atol=1e-3)
    np.testing.assert_allclose(np.asarray(upd["batch_stats"]["mean"]),
                               0.5 * np.asarray(x).mean(0), rtol=1e-5)
    ev = nn.BatchNorm(use_running_average=True).apply(
        {"params": v["params"], "batch_stats": upd["batch_stats"]}, x)
    assert ev.shape == x.shape
