"""Masked batch normalization with fused (leaky-)ReLU.

Matches the reference's semantics exactly
(`SCN/CPU/BatchNormalization.cpp:18-64`, params at
`sparseconvnet/batchNormalization.py:114-191`):
  * statistics over ACTIVE rows only (padding rows excluded via num_active);
  * eps = 1e-4 (inside the sqrt of the normalizer);
  * running stats: r = momentum * r + (1-momentum) * batch  (momentum=0.9,
    i.e. momentum is a DECAY, unlike torch.nn.BatchNorm);
  * running_var uses the unbiased (n-1) estimate; normalization the biased n;
  * activation fused on the output: y > 0 ? y : leakiness * y
    (leakiness 0 = ReLU, 1 = identity, 0.333 = BatchNormLeakyReLU default).

Statistics are computed in float32 regardless of feature dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class BNState(NamedTuple):
    running_mean: jnp.ndarray  # [C] f32
    running_var: jnp.ndarray   # [C] f32


def init_state(num_channels: int) -> BNState:
    return BNState(running_mean=jnp.zeros((num_channels,), jnp.float32),
                   running_var=jnp.ones((num_channels,), jnp.float32))


def _batch_norm_impl(feats: jnp.ndarray,
                     num_active: jnp.ndarray,
                     scale: jnp.ndarray,
                     bias: jnp.ndarray,
                     state: BNState,
                     *,
                     eps: float = 1e-4,
                     momentum: float = 0.9,
                     leakiness: float = 1.0,
                     training: bool = True,
                     axis_name: str | None = None
                     ) -> Tuple[jnp.ndarray, BNState]:
    from occuseg.core.sparse_tensor import active_mask, total_active

    f = feats.astype(jnp.float32)
    mask = active_mask(num_active, feats.shape[0])[:, None]
    n = total_active(num_active).astype(jnp.float32)
    if axis_name is not None:
        n = jax.lax.psum(n, axis_name)
    n = jnp.maximum(n, 1.0)
    if training:
        sum_f = jnp.sum(jnp.where(mask, f, 0), axis=0)
        sumsq = jnp.sum(jnp.where(mask, f * f, 0), axis=0)
        if axis_name is not None:
            sum_f = jax.lax.psum(sum_f, axis_name)
            sumsq = jax.lax.psum(sumsq, axis_name)
        mean = sum_f / n
        var_b = sumsq / n - mean * mean                  # biased
        var_u = (sumsq - mean * mean * n) / jnp.maximum(n - 1.0, 1.0)
        inv_std = jax.lax.rsqrt(var_b + eps)
        new_state = BNState(
            running_mean=momentum * state.running_mean
            + (1 - momentum) * jax.lax.stop_gradient(mean),
            running_var=momentum * state.running_var
            + (1 - momentum) * jax.lax.stop_gradient(var_u),
        )
    else:
        mean = state.running_mean
        inv_std = jax.lax.rsqrt(state.running_var + eps)
        new_state = state
    w = inv_std * scale.astype(jnp.float32)
    b = bias.astype(jnp.float32) - mean * w
    # normalize in the INPUT dtype: for f32 features this is the exact same
    # expression as before (f*w+b); for bf16 it stops XLA from materializing
    # (and autodiff from SAVING) a full f32 copy of every conv output —
    # the per-BN `convert` ops measured 0.2-0.4 ms each on the flagship
    # profile (exp_r4_a). Statistics stay f32 above.
    dt = feats.dtype
    y = feats * w.astype(dt) + b.astype(dt)
    if leakiness != 1.0:
        y = jnp.where(y > 0, y, jnp.asarray(leakiness, dt) * y)
    y = jnp.where(mask, y, jnp.zeros((), dt))
    return y, new_state


def batch_norm(feats: jnp.ndarray,
               num_active: jnp.ndarray,
               scale: jnp.ndarray,
               bias: jnp.ndarray,
               state: BNState,
               *,
               eps: float = 1e-4,
               momentum: float = 0.9,
               leakiness: float = 1.0,
               training: bool = True,
               axis_name: str | None = None) -> Tuple[jnp.ndarray, BNState]:
    """Fused masked BN + leaky activation. Returns (out, new_state).

    `axis_name` (spatial sharding, inside shard_map): batch statistics are
    psum'd over the mesh axis so every shard normalizes with the GLOBAL
    statistics — identical math to the unsharded call on the union of
    rows, just a distributed summation order.

    The training path is wrapped in `jax.checkpoint`: without it, autodiff
    saves the f32 upcast of the (bf16) input for the statistics backward —
    a second full-size residual per BN. Rematerializing recomputes the
    cheap stats reductions in the backward instead; values and gradients
    are identical.
    """
    import functools
    if not training:
        return _batch_norm_impl(feats, num_active, scale, bias, state,
                                eps=eps, momentum=momentum,
                                leakiness=leakiness, training=False,
                                axis_name=axis_name)
    impl = functools.partial(_batch_norm_impl, eps=eps, momentum=momentum,
                             leakiness=leakiness, training=True,
                             axis_name=axis_name)
    return jax.checkpoint(impl)(feats, num_active, scale, bias, state)


def leaky_relu(feats: jnp.ndarray, leakiness: float = 0.0) -> jnp.ndarray:
    """Standalone LeakyReLU (reference `SCN/CUDA/LeakyReLU.cu`)."""
    return jnp.where(feats > 0, feats, leakiness * feats)
