"""Tracing / profiling / counters.

The reference instruments every native function with easy_profiler scopes
(SURVEY.md §5.1) and keeps global MulAdd/hidden-state counters
(`sparseconvnet/__init__.py:7-8`, printed per epoch at
`train_instance.py:459-462`). Equivalents here:
  * `scope(name)` — jax.named_scope + jax.profiler.TraceAnnotation, so
    blocks show up both in HLO op names and host traces;
  * `start_trace`/`stop_trace` — jax.profiler capture for TensorBoard;
  * `plan_muladd_count` / `plan_hidden_count` — exact counter parity
    computed from the topology plan (only real rulebook pairs count, like
    the reference's per-op accumulation);
  * `CounterState` — accumulates Mega MulAdd / Mega Hidden per epoch.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from occuseg.core.topology import Topology
from occuseg.ops.conv import conv_flops


@contextlib.contextmanager
def scope(name: str) -> Iterator[None]:
    with jax.named_scope(name), jax.profiler.TraceAnnotation(name):
        yield


def start_trace(logdir: str) -> None:
    jax.profiler.start_trace(logdir)


def stop_trace() -> None:
    jax.profiler.stop_trace()


def plan_muladd_count(plan: Topology, n_planes: Sequence[int],
                      block_reps: int = 1, residual: bool = True,
                      input_channels: int = 3) -> int:
    """MulAdds of one UNet forward on this plan — the analog of
    `forward_pass_multiplyAdd_count` (`submanifoldConvolution.py:97-107`).

    Counts: input subconv, per level 2*reps (residual) or reps (vgg)
    submanifold convs + NIN shortcuts, strided conv down / deconv up pairs,
    decoder blocks at 2x input width for the first rep.
    """
    total = 0
    L = len(n_planes)

    def sub(level, cin, cout):
        return int(conv_flops(plan.levels[level].nbr, cin, cout))

    def nin_pairs(level, cin, cout):
        return int(np.sum(plan.levels[level].num_active)) * cin * cout

    total += sub(0, input_channels, n_planes[0])
    for l in range(L):
        a = n_planes[l]
        for _ in range(block_reps):
            if residual:
                total += 2 * sub(l, a, a)
            else:
                total += sub(l, a, a)
        if l < L - 1:
            tr = plan.transitions[l]
            pairs_down = int(jnp.sum((tr.child >= 0)))
            pairs_up = int(jnp.sum((tr.up >= 0)))
            total += pairs_down * n_planes[l] * n_planes[l + 1]
            total += pairs_up * n_planes[l + 1] * n_planes[l]
            # decoder blocks at this level
            for i in range(block_reps):
                cin = a * (2 if i == 0 else 1)
                if residual:
                    total += sub(l, cin, a) + sub(l, a, a)
                    if cin != a:
                        total += nin_pairs(l, cin, a)
                else:
                    total += sub(l, cin, a)
    return total


def plan_hidden_count(plan: Topology, n_planes: Sequence[int]) -> int:
    """Hidden-state count analog (`forward_pass_hidden_states`)."""
    total = 0
    for l, lvl in enumerate(plan.levels):
        total += (int(np.sum(lvl.num_active))
                  * n_planes[min(l, len(n_planes) - 1)])
    return total


@dataclasses.dataclass
class CounterState:
    muladd: float = 0.0
    hidden: float = 0.0
    scenes: int = 0

    def add(self, muladd: int, hidden: int, scenes: int = 1) -> None:
        self.muladd += muladd
        self.hidden += hidden
        self.scenes += scenes

    def report(self) -> str:
        s = max(self.scenes, 1)
        return (f"MegaMulAdd={self.muladd / s / 1e6:.1f}/scene "
                f"MegaHidden={self.hidden / s / 1e6:.1f}/scene")
