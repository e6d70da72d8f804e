"""Golden-activation checkpoint parity (SURVEY §4c / VERDICT r1 #3).

A torch oracle (`tests/torch_oracle.py`) re-derives the reference
LearningBWDenseUNet semantics and module tree. Its state_dict keys must be
exactly what `train/torch_import.learning_bw_name_map` expects (the
reference checkpoint key contract), and importing those weights into the
model must reproduce the oracle's ACTIVATIONS on a real scene — the
end-to-end proof that a real `baseline_m64.pth` would load correctly:
key names, [K^3,Cin,Cout] conv layout, [out,in] Linear transpose, NIN
[in,out] shortcut layout, BN eval semantics, UNet wiring and join order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from occuseg.core.topology import PlanSpec
from occuseg.data.synthetic import SceneConfig, make_batch
from occuseg.models import LearningBWDenseUNet
from occuseg.native.plan import build_plan_host
from occuseg.train.torch_import import learning_bw_name_map
from occuseg.train.checkpoint import import_torch_state_dict

from tests.torch_oracle import OracleLearningBWDenseUNet

N_PLANES = (8, 16, 24)
P_CAP = 2048
SPEC = PlanSpec(caps=(1024, 512, 256))


@pytest.fixture(scope="module")
def setup():
    batch = make_batch(SceneConfig(num_points=1500, extent=48,
                                   num_objects=6),
                       num_scenes=1, p_cap=P_CAP, num_instances=8, seed=11)
    plan = build_plan_host(batch["coords"], SPEC)
    assert plan is not None
    torch.manual_seed(0)
    oracle = OracleLearningBWDenseUNet(N_PLANES, 20, plan, in_ch=3, reps=1)
    oracle.eval()
    feats = np.random.default_rng(5).standard_normal(
        (P_CAP, 3)).astype(np.float32)
    return batch, plan, oracle, feats


def test_oracle_state_dict_keys_match_name_map(setup):
    """The torch oracle's module tree == the reference checkpoint contract
    == what the name map was written against."""
    _, _, oracle, _ = setup
    sd_keys = set(oracle.state_dict().keys())
    map_keys = set(learning_bw_name_map(N_PLANES).keys())
    assert sd_keys == map_keys, (
        f"only in oracle: {sorted(sd_keys - map_keys)[:8]}; "
        f"only in map: {sorted(map_keys - sd_keys)[:8]}")


def test_imported_weights_reproduce_oracle_activations(setup):
    batch, plan, oracle, feats = setup
    with torch.no_grad():
        t_out = oracle(torch.from_numpy(feats))
    t_sem, t_feat, t_emb, t_off, t_disp, t_bw, t_occ = [
        o.numpy() for o in t_out]

    model = LearningBWDenseUNet(n_planes=N_PLANES, num_classes=20,
                                block_reps=1, residual_blocks=True)
    plan_j = jax.tree.map(jnp.asarray, plan)
    feats_j = jnp.asarray(feats)
    variables = model.init(jax.random.PRNGKey(0), feats_j, plan_j, False)

    sd = {k: v.numpy() for k, v in oracle.state_dict().items()}
    name_map = learning_bw_name_map(N_PLANES)
    params, stats = import_torch_state_dict(
        sd, variables["params"], variables["batch_stats"], name_map)
    out = model.apply({"params": params, "batch_stats": stats},
                      feats_j, plan_j, False)

    np.testing.assert_allclose(np.asarray(out.semantics), t_sem,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.embedding), t_emb,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.offset), t_off,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.displacement), t_disp,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.bw), t_bw,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.occupancy), t_occ,
                               rtol=1e-4, atol=1e-4)
