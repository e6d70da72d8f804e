"""Accuracy checks of the sparse conv and of the whole train step against
plain float32/float64 references. `chip_smoke.py` runs them on the GPU at
the flagship's widths; the tests run them on the CPU at small sizes.

Errors are normwise: ||got - ref|| / ||ref|| over the whole array, so one
number per output says how far the implementation under test is from the
reference.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def reference_conv(feats, nbr, weight):
    """out[r] = sum_k feats[nbr[r, k]] @ weight[k], missing (-1) rows read
    0 — written without the custom VJP or the loop of `ops/conv.py`, in the
    dtype of its inputs."""
    valid = (nbr >= 0)[..., None]
    g = jnp.where(valid, feats[jnp.maximum(nbr, 0)], 0)      # [M, K, Cin]
    return jnp.einsum("mkc,kco->mo", g, weight,
                      precision=jax.lax.Precision.HIGHEST)


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def conv_errors(conv: Callable, feats, nbr, nbr_t, weight, dtype,
                ref_dtype=jnp.float32) -> Dict[str, float]:
    """Forward, d_feats and dW of `conv(feats, nbr, weight, None,
    nbr_t=nbr_t)` run in `dtype`, against `reference_conv` in `ref_dtype`
    (HIGHEST precision) on the same `dtype`-rounded inputs. The cotangent
    is a fixed random array, so the backward is checked in full."""
    x = feats.astype(dtype)
    w = weight.astype(jnp.float32)
    ct = jax.random.normal(jax.random.PRNGKey(1),
                           (nbr.shape[0], weight.shape[2]), jnp.float32)

    def run(f, x, w, ct):
        out, vjp = jax.vjp(f, x, w)
        dx, dw = vjp(ct.astype(out.dtype))
        return out, dx, dw

    got = jax.jit(lambda x, w, ct: run(
        lambda a, b: conv(a, nbr, b, None, nbr_t=nbr_t), x, w, ct))(x, w, ct)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda x, w, ct: run(
            lambda a, b: reference_conv(a, nbr, b), x, w, ct))(
            x.astype(ref_dtype), w.astype(ref_dtype)
            .astype(dtype).astype(ref_dtype), ct.astype(ref_dtype))
    return {"fwd": rel_err(got[0], ref[0]), "d_feats": rel_err(got[1], ref[1]),
            "d_weight": rel_err(got[2], ref[2])}


def plan_conv_cases(plan, widths: Tuple[int, ...], in_channels: int = 3
                    ) -> List[Tuple[str, int, int, object, object, object]]:
    """(name, rows_in, cin, cout, map, transpose map) of every conv the
    UNet runs over a host plan: the input conv, the submanifold conv of
    each level, and the strided conv / deconv of each transition."""
    lv, tr = plan.levels, plan.transitions
    cases = [("input_sub_L0", lv[0].cap, in_channels, widths[0],
              lv[0].nbr, None)]
    for i, l in enumerate(lv):
        cases.append((f"sub_L{i}", l.cap, widths[i], widths[i], l.nbr, None))
    for i, t in enumerate(tr):
        cases.append((f"down_L{i}", lv[i].cap, widths[i], widths[i + 1],
                      t.child, t.up[:, ::-1]))
        cases.append((f"up_L{i + 1}", lv[i + 1].cap, widths[i + 1],
                      widths[i], t.up, t.child[:, ::-1]))
    return cases


def check_plan_convs(conv: Callable, plan, widths, dtype, tol: float,
                     seed: int = 0) -> List[Dict]:
    """`conv_errors` for every `plan_conv_cases` entry with He-scaled
    random weights; each row reports whether all three errors are under
    `tol`."""
    rows = []
    key = jax.random.PRNGKey(seed)
    for name, n, cin, cout, nbr, nbr_t in plan_conv_cases(plan, widths):
        kf, kw, key = jax.random.split(key, 3)
        feats = jax.random.normal(kf, (n, cin), jnp.float32)
        w = jax.random.normal(kw, (nbr.shape[1], cin, cout), jnp.float32) \
            * (2.0 / (cin * nbr.shape[1])) ** 0.5
        err = conv_errors(conv, feats, jnp.asarray(nbr),
                          None if nbr_t is None else jnp.asarray(nbr_t),
                          w, dtype)
        rows.append(dict(case=name, rows=int(nbr.shape[0]), cin=cin,
                         cout=cout, ok=max(err.values()) < tol, **err))
    return rows


def step_loss_and_grad_norm(model_cls, n_planes, variables, batch, plan,
                            compute_dtype, num_instances: int):
    """Total loss and global gradient norm of one train-mode forward +
    backward of `model_cls` in `compute_dtype` with the given variables."""
    from occuseg.losses.instance import LossConfig, occuseg_total_loss

    model = model_cls(n_planes=tuple(n_planes), num_classes=20,
                      compute_dtype=compute_dtype)

    def loss(params):
        out, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch["features"], plan, True, mutable=["batch_stats"])
        total, _ = occuseg_total_loss(out, batch, 1, num_instances,
                                      LossConfig())
        return total

    total, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                         for g in jax.tree.leaves(grads)))
    return float(total), float(gnorm)
