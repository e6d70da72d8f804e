"""Joint semantic-instance refinement.

Reference `joint_semantic_instance_segmentation`
(`evaluate_instance.py:809-964`): greedily seed instances at the region
with the largest remaining centredness offset, take single-shot
cross-modal gaussian membership around the seed's (embedding, regressed
pose) with the seed's learned bandwidths x `bw_relax_factor`
(probabilities below 0.3 zeroed, membership at > 0.5), and REFINE the
instance's semantic class as the argmax of region softmax probabilities
weighted by membership probability x region point count — instance
evidence overrides noisy per-point semantics.

One divergence, documented: the reference stores the refined label only at
the seed region (`pred_semantic_label[keypoint] = ...`) and gathers
per-region labels at the end, leaving non-seed regions at the init value 1
— here every member region of the instance receives the refined label,
which is the computation the weighted vote exists to produce.

Rebuilt as one jitted `lax.while_loop` over region-level arrays.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from occuseg.cluster.meanshift import _cross_modal_prob
from occuseg.cluster.supervoxel import RegionFeatures


def region_semantic_probability(logits: jnp.ndarray, region: jnp.ndarray,
                                r_cap: int) -> jnp.ndarray:
    """Per-region mean softmax class probability [R, C] (reference
    `evaluate_instance.py:825-827`: point softmax then scatter_mean)."""
    p = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    seg = jnp.where(region >= 0, region, r_cap)
    num = jax.ops.segment_sum(p, seg, num_segments=r_cap + 1)[:r_cap]
    cnt = jax.ops.segment_sum(jnp.ones(p.shape[:1], jnp.float32), seg,
                              num_segments=r_cap + 1)[:r_cap]
    return num / jnp.maximum(cnt[:, None], 1.0)


@functools.partial(jax.jit, static_argnames=("max_instances",))
def joint_refine(regions: RegionFeatures, region_sem_prob: jnp.ndarray,
                 bw_relax_factor: float = 1.0,
                 max_instances: int = 300,
                 min_instance_size: int = 0
                 ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (region_instance [R] int32, -1 = none;
    region_semantic_refined [R] int32, unassigned regions keep the
    majority-vote class; num_instances)."""
    R = regions.count.shape[0]
    emb = regions.embedding.astype(jnp.float32)
    pose = regions.pose_embedding.astype(jnp.float32)
    bw = regions.bw.astype(jnp.float32)
    cnt = regions.count.astype(jnp.float32)
    E = emb.shape[1]

    background = regions.valid
    offsets = jnp.where(background, regions.offset, 0.0)
    labels0 = jnp.full((R,), -1, jnp.int32)
    sem0 = regions.semantic.astype(jnp.int32)

    def cond(state):
        _, _, background, offsets, count = state
        return (count < max_instances) & jnp.any(background)

    def body(state):
        labels, sem, background, offsets, count = state
        seed = jnp.argmax(offsets)
        b = bw[seed] * bw_relax_factor
        prob = _cross_modal_prob(emb, pose, emb[seed], pose[seed],
                                 b[0], b[1])
        prob = jnp.where(prob < 0.3, 0.0, prob)        # :872
        flag = (prob > 0.5) & background               # :873
        # semantic refinement: membership- and size-weighted vote (:928)
        w = cnt * prob
        vote = jnp.argmax(jnp.sum(region_sem_prob * w[:, None], axis=0)
                          / jnp.maximum(jnp.sum(w), 1e-12)).astype(jnp.int32)
        big = jnp.sum(flag.astype(jnp.int32)) > min_instance_size
        inst = jnp.where(big, count + 1, -1)
        labels = jnp.where(flag, inst.astype(jnp.int32), labels)
        sem = jnp.where(flag & big, vote, sem)
        background = background & ~flag & (jnp.arange(R) != seed)
        offsets = jnp.where(background, offsets, 0.0)
        return labels, sem, background, offsets, count + 1

    labels, sem, _, _, count = jax.lax.while_loop(
        cond, body, (labels0, sem0, background, offsets,
                     jnp.asarray(0, jnp.int32)))
    return labels, sem, count
