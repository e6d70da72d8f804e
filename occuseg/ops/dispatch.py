"""Which implementation of the sparse conv each platform gets — decided
here and nowhere else.

The platform is that of the first JAX device:

* ``gpu``: the fused Pallas (Triton route) gather-GEMM conv
  (`ops/triton_conv.py`), measured faster than the plain form on an H100
  (PERF.md, PR 1);
* ``cpu``: the plain XLA conv, which is also the reference the tests
  compare against.

Any other platform raises: nothing falls back silently, and nothing runs
in an interpreter unless a test asks for it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax

from occuseg.ops import conv as conv_ops
from occuseg.ops import triton_conv


@dataclasses.dataclass(frozen=True)
class Impl:
    platform: str
    # gather_conv(feats, nbr, weight, bias=None, nbr_t=None) -> [M, Cout]
    conv: Callable


_IMPLS = {
    "cpu": Impl("cpu", conv_ops.gather_conv),
    "gpu": Impl("gpu", triton_conv.triton_gather_conv),
}


def impl(platform: Optional[str] = None) -> Impl:
    """The implementations for `platform` (default: the first device's)."""
    p = platform or jax.devices()[0].platform
    if p not in _IMPLS:
        raise RuntimeError(
            f"no sparse-conv implementation for platform {p!r} "
            f"(supported: {', '.join(sorted(_IMPLS))})")
    return _IMPLS[p]
