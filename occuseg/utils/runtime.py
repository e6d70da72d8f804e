"""Process set-up shared by the command-line entry points (`bench.py`,
`chip_smoke.py`, `scripts/*.py`): the persistent compile cache, the
accelerator check, and the device description printed beside every
measurement."""

from __future__ import annotations

import os
import subprocess
from typing import Dict

import jax

# checkout-local cache directory (listed in .gitignore)
_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
DEFAULT_CACHE_DIR = os.path.join(_REPO, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory:
    `JAX_COMPILATION_CACHE_DIR` when set (JAX reads it itself), else a
    fixed directory inside the checkout."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> None:
    """Stop unless JAX's first device is a GPU: a measurement or a smoke
    run never falls back to the CPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"error: needs a GPU, but JAX's first device is "
                         f"{platform!r}")


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30).stdout
    return out.strip().splitlines()[0]


def device_info() -> Dict:
    """What every result line names: JAX's platform, device kind and
    count, and the card's name and power limit."""
    d = jax.devices()
    info = {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}
    if info["platform"] == "gpu":
        info["card"] = gpu_name_and_power_limit()
    return info
