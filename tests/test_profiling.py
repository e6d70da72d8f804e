"""Profiling utilities: named scopes under jit, counter reports."""

import numpy as np

import jax
import jax.numpy as jnp

from occuseg.utils.profiling import CounterState, scope


def test_scope_under_jit():
    @jax.jit
    def f(x):
        with scope("my_block"):
            return (x * 2).sum()

    out = f(jnp.ones((8, 8)))
    assert float(out) == 128.0  # scope must not perturb tracing/execution


def test_counter_state_report():
    c = CounterState()
    c.add(2_000_000, 500_000, scenes=2)
    r = c.report()
    assert "MegaMulAdd=1.0/scene" in r
    assert "MegaHidden=0.2" in r
