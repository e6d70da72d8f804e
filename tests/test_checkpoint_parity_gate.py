"""The one-command checkpoint-parity gate (scripts/checkpoint_parity.py)
runs end-to-end against a reference-format .pth generated by the torch
oracle — the stand-in for baseline_m64.pth until the real artifact lands
(VERDICT r2 #6; reference README Quickstart §3)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from occuseg.train.config import args_to_config, get_parser


def test_parity_gate_passes_on_oracle_checkpoint(tmp_path, monkeypatch):
    from occuseg.core.topology import PlanSpec
    from occuseg.data.synthetic import SceneConfig, make_batch
    from occuseg.native.plan import build_plan_host
    from tests.torch_oracle import OracleLearningBWDenseUNet

    if build_plan_host(make_batch(SceneConfig(num_points=100, extent=16,
                                              num_objects=2), 1, 256, 4,
                                  seed=0)["coords"],
                       PlanSpec(caps=(256, 128))) is None:
        pytest.skip("needs the C++ host plan builder")

    # the gate's fixed probe geometry for --m 4 (script: p_cap 8192, caps
    # (4096, 2048, 1024, ...)); the oracle needs SOME plan to build its
    # conv modules — the script rebuilds the same probe scene
    m = 4
    planes = tuple(m * i for i in range(1, 7))
    spec = PlanSpec(caps=(4096, 2048, 1024, 1024, 1024, 1024))
    batch = make_batch(SceneConfig(num_points=6000, extent=96,
                                   num_objects=8),
                       num_scenes=1, p_cap=8192, num_instances=16, seed=11)
    plan = build_plan_host(batch["coords"], spec)
    torch.manual_seed(0)
    oracle = OracleLearningBWDenseUNet(planes, 20, plan, in_ch=3, reps=1)
    pth = tmp_path / "oracle_m4.pth"
    torch.save(oracle.state_dict(), pth)

    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "checkpoint_parity.py")
    spec_ = importlib.util.spec_from_file_location("ckpt_gate", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)

    monkeypatch.setattr(sys, "argv", [
        "checkpoint_parity", "--checkpoint_file", str(pth),
        "--m", str(m), "--residual_blocks", "--use_dense_model",
        "--skip_eval"])
    with pytest.raises(SystemExit) as e:
        mod.main()
    assert e.value.code == 0, "activation diff exceeded tolerance"
