"""Checks that need the card (marked `gpu`; they skip elsewhere). Run them
on a machine with a GPU with

    OCCUSEG_TEST_GPU=1 python -m pytest -m gpu tests/test_gpu.py

`chip_smoke.py` phase (c) runs the same checks at the flagship's widths.
"""

import jax
import jax.numpy as jnp
import pytest

from occuseg.core.topology import PlanSpec
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.native.plan import build_plan_host
from occuseg.ops import dispatch
from occuseg.utils.conv_check import check_plan_convs

WIDTHS = (64, 128, 192, 256, 320, 384)


@pytest.mark.gpu
def test_dispatch_picks_gpu_path(gpu):
    assert dispatch.impl().platform == "gpu"


@pytest.mark.gpu
def test_unet_convs_bf16_match_f32_reference(gpu):
    b = make_batch(SceneConfig(num_points=20_000, extent=128,
                               num_objects=8), 1, 32_768, 16, seed=0)
    plan = build_plan_host(b["coords"], PlanSpec(
        caps=(24_576, 16_384, 8_192, 4_096, 2_048, 1_024)))
    rows = check_plan_convs(dispatch.impl().conv,
                            jax.tree.map(jnp.asarray, plan), WIDTHS,
                            jnp.bfloat16, 2e-2)
    assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]
