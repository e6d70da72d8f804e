"""Occupancy-aware cross-modal mean-shift instance extraction, on device.

Reference: `occupancy_aware_region_based_cross_modal_meanshift_clustering`
(`evaluate_instance.py:485-645`), a Python while-loop over GPU tensors.
Rebuilt as one `lax.while_loop` over region-level arrays (R ~ 1-3k per
scene), with the mean-shift inner loop (1 seeded iteration + 10
refinements, early-exit at shift < 1e-5 emulated by freezing the carry)
as `lax.fori_loop`. Assignment parity vs a NumPy port of the reference
loop is pinned by `tests/test_cluster_parity.py` / `tests/cluster_oracle.py`:

  repeat until no seeds left (or 300 instances):
    seed   = argmax remaining region offset               (:542)
    prob_r = exp(-(||e_r-c_e||*b1)^2 - (||p_r-c_p||*b2)^2) (:546, note the
             learned bandwidths MULTIPLY the distances, as in training)
    flag   = prob > 0.5 & background                       (:547)
    c      = sum_r w_r * feat_r / sum w_r,
             w_r = N(||(e,p)_r - c||; mean bw) * count_r   (:548-551)
    b      = mean bw over flagged regions * bw_relax       (:554)
    stop inner loop when ||shift|| < 1e-5                  (:563-565)
    assign instance, clear background + offsets            (:617-645)

Regions whose majority class is wall/floor (< 2) are pre-removed (:535-539).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from occuseg.cluster.supervoxel import RegionFeatures


def _cross_modal_prob(emb, pose, c_emb, c_pose, b1, b2):
    d1 = jnp.sqrt(jnp.sum((emb - c_emb) ** 2, axis=1) + 1e-12) * b1
    d2 = jnp.sqrt(jnp.sum((pose - c_pose) ** 2, axis=1) + 1e-12) * b2
    return jnp.exp(-d1 * d1 - d2 * d2)


@functools.partial(jax.jit, static_argnames=("max_instances", "ms_iters"))
def meanshift_cluster(regions: RegionFeatures,
                      bw_relax_factor: float = 1.0,
                      max_instances: int = 300,
                      ms_iters: int = 11,
                      foreground_class_threshold: int = 2
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (region_instance [R] int32 with -1 = background/none,
    num_instances int32)."""
    R = regions.count.shape[0]
    emb = regions.embedding.astype(jnp.float32)
    pose = regions.pose_embedding.astype(jnp.float32)
    feat = jnp.concatenate([emb, pose], axis=1)
    bw = regions.bw.astype(jnp.float32)
    cnt = regions.count.astype(jnp.float32)

    background = regions.valid & (
        regions.semantic >= foreground_class_threshold)
    offsets = jnp.where(background, regions.offset, 0.0)
    labels0 = jnp.full((R,), -1, jnp.int32)

    def one_instance(state):
        labels, background, offsets, count = state
        seed = jnp.argmax(offsets)
        c = feat[seed]
        b = bw[seed] * bw_relax_factor

        def ms_body(i, carry):
            c, b, flag, done = carry
            prob = _cross_modal_prob(emb, pose, c[: emb.shape[1]],
                                     c[emb.shape[1]:], b[0], b[1])
            new_flag = (prob > 0.5) & background
            d = jnp.sqrt(jnp.sum((feat - c) ** 2, axis=1) + 1e-12)
            bm = jnp.mean(b)
            w = jnp.exp(-0.5 * (d / jnp.maximum(bm, 1e-8)) ** 2) \
                / (jnp.maximum(bm, 1e-8) * jnp.sqrt(2 * jnp.pi))
            w = jnp.where(new_flag, w * cnt, 0.0)
            wsum = jnp.maximum(jnp.sum(w), 1e-12)
            new_c = jnp.sum(feat * w[:, None], axis=0) / wsum
            nflag = jnp.maximum(jnp.sum(new_flag.astype(jnp.float32)), 1.0)
            new_b = (jnp.sum(jnp.where(new_flag[:, None], bw, 0), axis=0)
                     / nflag) * bw_relax_factor
            # keep old centroid if nothing was flagged (degenerate seed)
            any_flag = jnp.any(new_flag)
            new_c = jnp.where(any_flag, new_c, c)
            new_b = jnp.where(any_flag, new_b, b)
            # reference break (:563-565): stop refining once the shift is
            # < 1e-5. The first (seeded) iteration has no break check
            # (:545-551 runs before the `for k in range(10)` loop), hence
            # the i > 0 guard. Freezing the carry == the reference's break.
            shift = jnp.sqrt(jnp.sum((c - new_c) ** 2))
            new_done = done | ((i > 0) & (shift < 1e-5))
            keep = lambda old, new: jnp.where(done, old, new)
            return (keep(c, new_c), keep(b, new_b), keep(flag, new_flag),
                    new_done)

        c, b, flag, _ = jax.lax.fori_loop(
            0, ms_iters, ms_body,
            (c, b, jnp.zeros((R,), bool), jnp.bool_(False)))
        new_labels = jnp.where(flag, count, labels)
        new_background = background & ~flag
        new_offsets = jnp.where(flag, 0.0, offsets)
        # always consume the seed even if its cluster was empty, so the loop
        # can't spin on the same seed forever
        new_background = new_background.at[seed].set(False)
        new_offsets = new_offsets.at[seed].set(0.0)
        return new_labels, new_background, new_offsets, count + 1

    def cond(state):
        labels, background, offsets, count = state
        return (count < max_instances) & jnp.any(background)

    labels, _, _, count = jax.lax.while_loop(
        cond, one_instance,
        (labels0, background, offsets, jnp.int32(0)))
    return labels, count


def labels_to_points(region_labels: jnp.ndarray, region: jnp.ndarray
                     ) -> jnp.ndarray:
    """Broadcast region instance ids back to points (-1 for padding)."""
    safe = jnp.clip(region, 0, region_labels.shape[0] - 1)
    out = region_labels[safe]
    return jnp.where(region >= 0, out, -1)
