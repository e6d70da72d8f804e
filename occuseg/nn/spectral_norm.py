"""Spectral normalization wrapper (reference `sparseconvnet/spectral_norm.py`,
a port of torch's): divides a weight by its largest singular value, estimated
by power iteration whose u vector persists in a mutable collection."""

from __future__ import annotations

from occuseg.nn import core as nn
import jax
import jax.numpy as jnp


class SpectralDense(nn.Module):
    """Dense layer with spectral normalization of its kernel."""

    features: int
    n_power_iterations: int = 1
    eps: float = 1e-12
    use_bias: bool = True

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False) -> jnp.ndarray:
        k = self.param("kernel", nn.initializers.lecun_normal(),
                       (x.shape[-1], self.features), jnp.float32)
        u_var = self.variable(
            "spectral", "u",
            lambda: jax.random.normal(jax.random.PRNGKey(0),
                                      (self.features,)) )
        u = u_var.value
        w = k.astype(jnp.float32)
        for _ in range(self.n_power_iterations):
            v = w @ u
            v = v / jnp.maximum(jnp.linalg.norm(v), self.eps)
            u = w.T @ v
            u = u / jnp.maximum(jnp.linalg.norm(u), self.eps)
        sigma = v @ (w @ u)
        if train and not self.is_initializing():
            u_var.value = jax.lax.stop_gradient(u)
        w_sn = w / jnp.maximum(sigma, self.eps)
        y = x @ w_sn.astype(x.dtype)
        if self.use_bias:
            y = y + self.param("bias", nn.initializers.zeros,
                               (self.features,), jnp.float32).astype(y.dtype)
        return y
