"""Fused gather-GEMM sparse conv for the GPU (Pallas, Triton route).

out[r] = sum_k feats[nbr[r, k]] @ weight[k]: the contraction of
`ops/conv.gather_conv`, written as one kernel. A program owns BM output
rows x BN output channels and loops over the K offsets inside itself: it
loads the BM neighbour indices of offset k, gathers the [BM, BK] feature
rows (missing neighbours, -1, read 0), multiplies them with W[k] into a
float32 accumulator held in registers, and writes the output once. The
XLA form instead materialises every offset's gathered [M, Cin] block and
reads and writes the [M, Cout] float32 accumulator K times.

Backward (the transpose-map identity of `ops/conv.py`):
  * d_feats is this same kernel over the transpose map with W[K-1-k]^T;
  * dW[K-1-k] = feats^T @ ct[nbr_t[:, k]] stays XLA's per-offset product.

The kernel names its route (`backend="triton"`); `interpret=True` runs it
in the Pallas interpreter, which only the CPU tests ask for.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from occuseg.ops.gather import gather_rows

BM = 64          # output rows per program
BN_MAX = 64      # output channels per program
BK_MAX = 64      # input channels per gathered block
NUM_WARPS = 4
NUM_STAGES = 3


def _pow2_at_least(n: int, lo: int = 16) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _blocks(cin: int, cout: int):
    # tl.dot needs every dimension >= 16; channel counts that are not a
    # multiple of the block are masked, not padded in memory
    return min(_pow2_at_least(cin), BK_MAX), min(_pow2_at_least(cout),
                                                 BN_MAX)


def _kernel(nbr_ref, x_ref, w_ref, o_ref, *, m, k_off, cin, cout, bk, bn):
    # every load/store uses integer-array indexers (they lower to pointer
    # arithmetic on the Triton route and have an interpreter rule)
    i = pl.program_id(0)
    j = pl.program_id(1)
    rows = i * BM + jnp.arange(BM, dtype=jnp.int32)
    rmask = rows < m
    cols = j * bn + jnp.arange(bn, dtype=jnp.int32)
    nmask = cols < cout
    n_chunks = pl.cdiv(cin, bk)

    # one pipelined loop over (offset, input-channel chunk) pairs: its
    # shared memory is num_stages x ([BM, bk] + [bk, bn]) whatever Cin is
    def body(t, acc):
        # t >= 0: truncating div/rem (jnp's floor forms do not lower here)
        nc = jnp.int32(n_chunks)
        k = jax.lax.div(t, nc)
        ch = jax.lax.rem(t, nc) * bk + jnp.arange(bk, dtype=jnp.int32)
        kmask = ch < cin
        idx = plgpu.load(nbr_ref.at[rows, k], mask=rmask, other=-1)
        valid = idx >= 0
        safe = jnp.where(valid, idx, 0)
        a = plgpu.load(x_ref.at[safe[:, None], ch[None, :]],
                       mask=valid[:, None] & kmask[None, :], other=0)
        b = plgpu.load(w_ref.at[k, ch[:, None], cols[None, :]],
                       mask=kmask[:, None] & nmask[None, :], other=0)
        return acc + pl.dot(a, b)

    acc = jax.lax.fori_loop(0, k_off * n_chunks, body,
                            jnp.zeros((BM, bn), jnp.float32))
    plgpu.store(o_ref.at[rows[:, None], cols[None, :]],
                acc.astype(o_ref.dtype), mask=rmask[:, None] & nmask[None, :])


def gather_matmul(feats, nbr, weight, interpret: bool = False):
    """[M, Cout] = sum_k feats[nbr[:, k]] @ weight[k] in one kernel;
    operands in feats.dtype, float32 accumulation, output in feats.dtype.
    """
    m, k_off = nbr.shape
    _, cin, cout = weight.shape
    bk, bn = _blocks(cin, cout)
    kernel = functools.partial(_kernel, m=m, k_off=k_off, cin=cin,
                               cout=cout, bk=bk, bn=bn)
    args = (nbr.astype(jnp.int32), feats, weight.astype(feats.dtype))
    # under shard_map the output varies over every mesh axis an input does
    # (pallas_call needs that stated); inputs are lifted to match
    vma = frozenset().union(*(jax.typeof(a).vma for a in args))
    args = tuple(
        jax.lax.pcast(a, tuple(vma - jax.typeof(a).vma), to="varying")
        if vma - jax.typeof(a).vma else a for a in args)
    with jax.enable_x64(False):
        return pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct((m, cout), feats.dtype, vma=vma),
            grid=(pl.cdiv(m, BM), pl.cdiv(cout, bn)),
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=NUM_STAGES),
            interpret=interpret,
            name=f"gather_conv_{cin}x{cout}",
        )(*args)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def _conv(feats, nbr, nbr_t, weight, interpret):
    return gather_matmul(feats, nbr, weight, interpret)


def _conv_fwd(feats, nbr, nbr_t, weight, interpret):
    return gather_matmul(feats, nbr, weight, interpret), (feats, nbr_t,
                                                           weight)


def _conv_bwd(interpret, res, ct):
    feats, nbr_t, weight = res
    K = weight.shape[0]
    ctc = ct.astype(feats.dtype)
    w_rev_t = jnp.transpose(weight[::-1], (0, 2, 1))      # [K, Cout, Cin]
    d_feats = gather_matmul(ctc, nbr_t, w_rev_t, interpret)
    nbr_t_kn = nbr_t.T

    def body(k, d_w):
        gct = gather_rows(ctc, jax.lax.dynamic_index_in_dim(
            nbr_t_kn, k, axis=0, keepdims=False))
        dwk = jax.lax.dot_general(
            feats, gct, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        return jax.lax.dynamic_update_index_in_dim(d_w, dwk, K - 1 - k,
                                                   axis=0)

    from occuseg.core.coords import full_varying_like
    d_w = full_varying_like(feats, weight.shape, 0, jnp.float32)
    d_w = jax.lax.fori_loop(0, K, body, d_w, unroll=3)
    return d_feats, None, None, d_w.astype(weight.dtype)


_conv.defvjp(_conv_fwd, _conv_bwd)


def triton_gather_conv(feats, nbr, weight, bias=None, nbr_t=None,
                       interpret: bool = False):
    """Drop-in for `ops/conv.gather_conv` (same arguments and transpose-map
    contract) running the fused kernel forward and for d_feats."""
    if nbr_t is None:
        assert nbr.shape[0] == feats.shape[0], (
            "non-submanifold gather_conv needs an explicit transpose map")
        nbr_t = nbr
    out = _conv(feats, nbr, nbr_t, weight, interpret)
    if bias is not None:
        out = out + bias.astype(out.dtype)
    return out
