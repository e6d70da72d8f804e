"""Sparse convolution compute ops (XLA path).

Replacement for the reference's gather-GEMM-scatter CUDA kernels
(`SCN/CUDA/Convolution.cu:77-146` tiled kernels, `:1059-1253` chunk-based).
Key structural difference: because topology maps are built from the OUTPUT
side (`core/topology.py`), every op here is gather + matmul with NO scatter —
the scatter-accumulate problem that forces atomicAdd on GPU
(`Convolution.cu:1148`) does not exist on this path. Missing neighbors gather
zeros via out-of-bounds `take(mode='fill')`.

Weight layout [K^3, Cin, Cout] matches the reference
(`submanifoldConvolution.py:27-29`) for checkpoint-import parity.

All matmuls accumulate in float32 via `preferred_element_type`;
feature dtype (f32/bf16) is preserved on output.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from occuseg.ops.gather import gather_rows as _gather_rows


def _acc_dtype(dtype) -> jnp.dtype:
    """f32 accumulation for f32/bf16; full f64 when running as an
    oracle with f64 inputs (tests only)."""
    return jnp.float64 if dtype == jnp.float64 else jnp.float32


def _gather_conv_fwd_impl(feats: jnp.ndarray, nbr: jnp.ndarray,
                          weight: jnp.ndarray) -> jnp.ndarray:
    out_dtype = feats.dtype
    acc_t = _acc_dtype(out_dtype)
    weight = weight.astype(out_dtype)  # bf16 feats -> bf16 matmul operands
    K = weight.shape[0]
    # one transpose so each offset's index slice is a CONTIGUOUS row read
    # (column slices of [M,K] are ~8x index-traffic waste per offset)
    nbr_kn = nbr.T

    # fori_loop (not an unrolled Python loop): the K gathers are mutually
    # independent, and XLA's scheduler hoists unrolled ones ahead of the
    # dots, keeping K big [M,Cin] temps alive at once (observed 19GB on the
    # m=64 UNet). The loop pins memory to one gather + the accumulator.
    def body(k, acc):
        idx = jax.lax.dynamic_index_in_dim(nbr_kn, k, axis=0, keepdims=False)
        g = _gather_rows(feats, idx)
        w_k = jax.lax.dynamic_index_in_dim(weight, k, axis=0, keepdims=False)
        return acc + jax.lax.dot_general(
            g, w_k, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=acc_t)

    from occuseg.core.coords import full_varying_like
    acc = full_varying_like(feats, (nbr.shape[0], weight.shape[2]), 0, acc_t)
    # unroll a little so the gather of iteration k+1 can overlap the matmul
    # of iteration k, while still bounding live temps (full unroll OOMed)
    acc = jax.lax.fori_loop(0, K, body, acc, unroll=3)
    return acc.astype(out_dtype)


@jax.custom_vjp
def _gather_conv_core(feats: jnp.ndarray, nbr: jnp.ndarray,
                      nbr_t: jnp.ndarray, weight: jnp.ndarray) -> jnp.ndarray:
    return _gather_conv_fwd_impl(feats, nbr, weight)


def _gather_conv_core_fwd(feats, nbr, nbr_t, weight):
    # Residuals: inputs only. Naive autodiff saves every gathered [M,Cin]
    # block (K of them) as dot residuals — 27x activation memory, which OOMs
    # a 6-level m=64 UNet at 260k voxels. We recompute the gathers in bwd.
    return _gather_conv_fwd_impl(feats, nbr, weight), (feats, nbr, nbr_t,
                                                       weight)


def _gather_conv_core_bwd(res, ct):
    """Scatter-free backward.

    Every rulebook map in the plan has an exact transpose (submanifold:
    offset k transposes to K-1-k on the same map; strided conv: child <->
    up), so d_feats is ANOTHER gather-matmul:
        d_feats[i] = sum_k ct[nbr_t[i,k]] @ W[K-1-k]^T
    (for (r,k) with nbr[r,k]==i we have nbr_t[i,K-1-k]==r). No scatter
    anywhere in fwd+bwd — the problem that costs the reference an atomicAdd
    (`Convolution.cu:1148`) disappears entirely.
    """
    feats, nbr, nbr_t, weight = res
    acc_t = _acc_dtype(feats.dtype)
    w_dtype = weight.dtype
    weight = weight.astype(feats.dtype)
    ctc = ct.astype(feats.dtype)
    K, Cin, Cout = weight.shape
    nbr_kn = nbr.T
    nbr_t_kn = nbr_t.T

    def body(k, carry):
        d_feats, d_w = carry
        # ONE gather serves both gradients: with gct = ct[nbr_t[:, k]],
        #   d_feats  += gct @ W[K-1-k]^T             (transpose-map identity)
        #   dW[K-1-k] = feats^T @ gct                (same pairing: the rows
        # of ct that saw feats[i] through offset K-1-k are exactly
        # gct[i]). This removes the feats re-gather — a third of all
        # fwd+bwd gather traffic.
        idx_t = jax.lax.dynamic_index_in_dim(nbr_t_kn, k, axis=0,
                                             keepdims=False)
        gct = _gather_rows(ctc, idx_t)                      # [N, Cout]
        dwk = jax.lax.dot_general(
            feats, gct, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=acc_t)                   # [Cin, Cout]
        d_w = jax.lax.dynamic_update_index_in_dim(d_w, dwk, K - 1 - k,
                                                  axis=0)
        w_rev = jax.lax.dynamic_index_in_dim(weight, K - 1 - k, axis=0,
                                             keepdims=False)
        contrib = jax.lax.dot_general(
            gct, w_rev, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=acc_t)                   # [N, Cin]
        return d_feats + contrib, d_w

    from occuseg.core.coords import full_varying_like
    d_feats = full_varying_like(feats, (feats.shape[0], Cin), 0, acc_t)
    d_w = full_varying_like(feats, (K, Cin, Cout), 0, acc_t)
    d_feats, d_w = jax.lax.fori_loop(0, K, body, (d_feats, d_w), unroll=3)
    return (d_feats.astype(feats.dtype), None, None, d_w.astype(w_dtype))


_gather_conv_core.defvjp(_gather_conv_core_fwd, _gather_conv_core_bwd)


# Below this many bytes for the materialized [M, K, C] gathered block, use
# the single-matmul fused path: one big gather + one [M, K*Cin] x
# [K*Cin, Cout] matmul instead of K loop iterations. The gathered temp
# costs an extra write and read of K times the input, so the fused path is
# off (0 bytes); it has not been measured on the GPU.
_FUSED_BYTES = 0


def _fused_fwd_impl(feats, nbr, weight):
    out_dtype = feats.dtype
    acc_t = _acc_dtype(out_dtype)
    K, Cin, Cout = weight.shape
    g = _gather_rows(feats, nbr.reshape(-1)).reshape(nbr.shape[0], K * Cin)
    out = jax.lax.dot_general(
        g, weight.astype(out_dtype).reshape(K * Cin, Cout),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=acc_t)
    return out.astype(out_dtype)


@jax.custom_vjp
def _gather_conv_fused_core(feats, nbr, nbr_t, weight):
    return _fused_fwd_impl(feats, nbr, weight)


def _gather_conv_fused_fwd(feats, nbr, nbr_t, weight):
    return _fused_fwd_impl(feats, nbr, weight), (feats, nbr_t, weight)


def _gather_conv_fused_bwd(res, ct):
    # Fused analog of _gather_conv_core_bwd (same transpose-map algebra):
    #   gct[i,k]  = ct[nbr_t[i,k]]                       [N, K, Cout]
    #   d_feats   = [N, K*Cout] @ stack_k(W[K-1-k]^T)    [N, Cin]
    #   dW[K-1-k] = einsum('nc,nko->cko', feats, gct) transposed to [k,c,o]
    feats, nbr_t, weight = res
    acc_t = _acc_dtype(feats.dtype)
    w_dtype = weight.dtype
    K, Cin, Cout = weight.shape
    w = weight.astype(feats.dtype)
    ctc = ct.astype(feats.dtype)
    N = nbr_t.shape[0]
    gct = _gather_rows(ctc, nbr_t.reshape(-1)).reshape(N, K, Cout)
    w_rev_t = jnp.transpose(w[::-1], (0, 2, 1)).reshape(K * Cout, Cin)
    d_feats = jax.lax.dot_general(
        gct.reshape(N, K * Cout), w_rev_t,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=acc_t)
    dw_rev = jax.lax.dot_general(
        feats, gct, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=acc_t)           # [Cin, K, Cout]
    d_w = jnp.transpose(dw_rev, (1, 0, 2))[::-1]  # [K, Cin, Cout], un-rev
    return (d_feats.astype(feats.dtype), None, None, d_w.astype(w_dtype))


_gather_conv_fused_core.defvjp(_gather_conv_fused_fwd, _gather_conv_fused_bwd)


def gather_conv(feats: jnp.ndarray, nbr: jnp.ndarray, weight: jnp.ndarray,
                bias: jnp.ndarray | None = None,
                nbr_t: jnp.ndarray | None = None) -> jnp.ndarray:
    """out[r] = sum_k feats[nbr[r,k]] @ weight[k]  (+ bias).

    The single primitive behind submanifold conv (nbr = same-level neighbor
    map), strided conv (nbr = transition.child), and deconvolution
    (nbr = transition.up). feats [N,Cin], nbr [M,K], weight [K,Cin,Cout].

    nbr_t is the transpose map used by the scatter-free backward, which
    computes d_feats[i] = sum_k ct[nbr_t[i,k]] @ W[K-1-k]^T. The required
    pairing nbr_t[i,k] = (row r with nbr[r, K-1-k] == i) holds when:
      * submanifold conv: nbr_t = nbr itself (r(i,k) = nbr[i, rev(k)]
        because offset rev(k) = -offset(k) under z-major enumeration);
      * strided conv (nbr=child): nbr_t = up[:, ::-1] (child[j,k]==i <=>
        up[i,k]==j, so the column reversal cancels the W reversal);
      * deconv (nbr=up): nbr_t = child[:, ::-1].
    """
    if nbr_t is None:
        assert nbr.shape[0] == feats.shape[0], (
            "non-submanifold gather_conv needs an explicit transpose map")
        nbr_t = nbr
    K, Cin, _ = weight.shape
    block_bytes = max(nbr.shape[0], nbr_t.shape[0]) * K * Cin \
        * jnp.dtype(feats.dtype).itemsize
    if block_bytes <= _FUSED_BYTES:
        out = _gather_conv_fused_core(feats, nbr, nbr_t, weight)
    else:
        out = _gather_conv_core(feats, nbr, nbr_t, weight)
    if bias is not None:
        out = out + bias.astype(out.dtype)
    return out


def gather_conv_fused(feats: jnp.ndarray, nbr: jnp.ndarray,
                      weight: jnp.ndarray,
                      bias: jnp.ndarray | None = None) -> jnp.ndarray:
    """Same contraction as `gather_conv` but as one [M, K*Cin] @ [K*Cin, Cout]
    matmul — one large matmul when Cin is small, at the cost of
    materializing the gathered block.
    """
    out_dtype = feats.dtype
    acc_t = _acc_dtype(out_dtype)
    K, Cin, Cout = weight.shape
    g = _gather_rows(feats, nbr.reshape(-1))          # [M*K, Cin]
    g = g.reshape(nbr.shape[0], K * Cin)
    w = weight.reshape(K * Cin, Cout)
    out = jax.lax.dot_general(
        g, w, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=acc_t,
    )
    if bias is not None:
        out = out + bias.astype(acc_t)
    return out.astype(out_dtype)


def nin(feats: jnp.ndarray, weight: jnp.ndarray,
        bias: jnp.ndarray | None = None) -> jnp.ndarray:
    """NetworkInNetwork: 1x1 conv = plain row matmul (reference
    `SCN/CUDA/NetworkInNetwork.cu`, `networkInNetwork.py`)."""
    acc_t = _acc_dtype(feats.dtype)
    out = jax.lax.dot_general(
        feats, weight.astype(feats.dtype),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=acc_t,
    )
    if bias is not None:
        out = out + bias.astype(acc_t)
    return out.astype(feats.dtype)


def conv_flops(nbr: jnp.ndarray, cin: int, cout: int) -> jnp.ndarray:
    """MulAdd count of a gather_conv — the analog of the reference's
    `forward_pass_multiplyAdd_count` (`submanifoldConvolution.py:97-107`).
    Counts only real (non-missing) rulebook pairs, like the reference."""
    pairs = jnp.sum((nbr >= 0).astype(jnp.int64))
    return pairs * cin * cout
