"""OccuSeg multi-task losses, fully batched as segment reductions.

Reference semantics (all file:line into /root/reference):
  * semantic CE: `train_instance.py:189` (F.cross_entropy, ignore -100);
  * discriminative embedding loss: `discriminative.py:117-226`
    (delta_v=0.2, delta_d=1.5 at `train_instance.py:38-39`; pull
    clamp(||e-mu||-dv,0)^2, push clamp(2*dd-||mu_a-mu_b||,0)^2 over
    same-scene centroid pairs / n(n-1), regularizer gamma=0.001 * mean||mu||);
  * offset regression: L1 over foreground (label>1) * regress_weight=100
    (`train_instance.py:252`, `config.py:9`);
  * displacement: per-instance (GT class>1) mean of ||d_p - d_gt||_2,
    averaged over instances then scenes (`train_instance.py:217-236`);
  * occupancy: per-instance mean |occ_p - log(size)| + per-instance std of
    occ, same averaging (`train_instance.py:221-236`);
  * classification (soft-membership BCE): `discriminative.py:40-117` —
    per instance with >=30 points: prob_p = exp(-(||e_p-mu||*s1)^2
    - (||x_p-mean_pose||*s2)^2) where (s1,s2)=instance-mean bandwidths,
    sampled at points with spatial distance < 4*max-instance-radius; BCE vs
    membership, mean over instances, *10; instance IoU metric alongside.

The reference loops over scenes and instances in Python; here instances are
globally-numbered segments [0, I_cap) across the whole padded batch and every
per-instance quantity is one `segment_*` call. The [P, I] membership matrix
in `classification_loss` is formed via matmul-friendly |a|^2+|b|^2-2ab.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class LossConfig:
    delta_v: float = 0.2
    delta_d: float = 1.5
    gamma: float = 0.001
    regress_weight: float = 100.0
    classification_weight: float = 10.0
    min_instance_points: int = 30
    num_classes: int = 20
    foreground_class_threshold: int = 2  # label > 1, skip wall/floor
    # --loss selection (reference `train_instance.py:354-365`):
    # cross_entropy | lovasz | focal | weighted_cross_entropy
    semantic_loss: str = "cross_entropy"
    # per-class CE weights for weighted_cross_entropy (tuple → hashable /
    # static under jit; tables in losses/semantic.py). None = ScanNet table.
    ce_weights: Tuple[float, ...] | None = None
    # DriftLoss coefficient (reference `train_instance.py:240`, commented
    # there with weight 50; off by default to match)
    drift_weight: float = 0.0


def _safe_norm(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """||x||_2 with a bounded gradient at 0 (norm's grad is 0/0 there; a
    singleton instance has e == mu exactly, so this is hit in practice)."""
    return jnp.sqrt(jnp.sum(x * x, axis=axis) + 1e-12)


def _seg_sum(x, seg, num, axis_name=None):
    """Segment sum. For the small segment counts here (instances/scenes)
    a one-hot [num, P] @ [P, C] product replaces the scatter-add that
    jax.ops.segment_sum lowers to; which is faster on the GPU has not
    been measured.

    `axis_name`: the rows of x are sharded over that mesh axis (spatial
    training) — partial sums are psum'd so the result is the global
    segment sum, replicated."""
    if num <= 128:
        oh = (seg[None, :]
              == jnp.arange(num, dtype=seg.dtype)[:, None]).astype(
            jnp.float32)
        xf = x.astype(jnp.float32)
        if x.ndim == 1:
            out = jax.lax.dot_general(
                oh, xf[:, None], dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)[:, 0]
        else:
            out = jax.lax.dot_general(
                oh, xf, dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
    else:
        out = jax.ops.segment_sum(x.astype(jnp.float32), seg,
                                  num_segments=num)
    if axis_name is not None:
        out = jax.lax.psum(out, axis_name)
    return out.astype(x.dtype)


def _seg_max(x, seg, num, fill, axis_name=None):
    """Segment max via masked [P, num] reduction (scatter-free) for small
    num; `fill` is the empty-segment value."""
    if num <= 128:
        m = seg[:, None] == jnp.arange(num, dtype=seg.dtype)[None, :]
        vals = jnp.where(m, x[:, None], fill)
        out = jnp.max(vals, axis=0)
    else:
        out = jax.ops.segment_max(x, seg, num_segments=num)
    if axis_name is not None:
        out = jax.lax.pmax(out, axis_name)
    return out


def _seg_mean(x, seg, num, axis_name=None):
    s = _seg_sum(x, seg, num, axis_name)
    cnt = _seg_sum(jnp.ones(x.shape[:1], x.dtype), seg, num, axis_name)
    return s / jnp.maximum(cnt[..., None] if x.ndim > 1 else cnt, 1), cnt


def _sanitize_seg(instance_id, num):
    """-1 (invalid) -> num, so reductions with num_segments=num drop them."""
    return jnp.where(instance_id >= 0, instance_id, num).astype(jnp.int32)


def _seg_lookup(table, seg, num):
    """Per-point lookup `table[seg]` as a one-hot dot.

    The autodiff transpose of a dot is another dot, whereas the transpose
    of a row gather is a scatter-add over P >> num duplicate indices.
    Whether the dot or a plain gather is faster on the GPU has not been
    measured. Rows with seg >= num (padding) read 0 — callers mask those
    points anyway."""
    oh = (seg[:, None] == jnp.arange(num, dtype=seg.dtype)[None, :]
          ).astype(jnp.float32)
    t = table.astype(jnp.float32)
    out = jax.lax.dot_general(
        oh, t[:, None] if t.ndim == 1 else t,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    return out[:, 0] if table.ndim == 1 else out


def semantic_cross_entropy(logits: jnp.ndarray, labels: jnp.ndarray,
                           axis_name: str | None = None) -> jnp.ndarray:
    """Mean CE over points with label >= 0 (torch ignore_index=-100).

    The label pick is a one-hot masked sum, not take_along_axis: the
    [P, C] compare+reduce fuses into the log_softmax pass instead of a
    separate per-row 4-byte gather. `axis_name`: points sharded over that
    mesh axis (spatial training) — sums psum'd."""
    valid = labels >= 0
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    onehot = labels[:, None] == jnp.arange(logits.shape[-1],
                                           dtype=labels.dtype)[None, :]
    nll = -jnp.sum(jnp.where(onehot, logp, 0.0), axis=-1)
    num = jnp.sum(jnp.where(valid, nll, 0))
    den = jnp.sum(valid.astype(jnp.float32))
    if axis_name is not None:
        num = jax.lax.psum(num, axis_name)
        den = jax.lax.psum(den, axis_name)
    return num / jnp.maximum(den, 1)


def _instance_stats(instance_id: jnp.ndarray, point_scene: jnp.ndarray,
                    labels: jnp.ndarray, num_instances: int,
                    axis_name: str | None = None):
    """Per-instance scene id, point count, and (first) GT class."""
    seg = _sanitize_seg(instance_id, num_instances)
    ones = jnp.ones_like(seg, jnp.float32)
    count = _seg_sum(jnp.where(instance_id >= 0, ones, 0), seg,
                     num_instances + 1, axis_name)[:num_instances]
    scene = _seg_max(jnp.where(instance_id >= 0, point_scene, -1), seg,
                     num_instances + 1, -1, axis_name)[:num_instances]
    cls = _seg_max(jnp.where(instance_id >= 0, labels, -10000), seg,
                   num_instances + 1, -10000, axis_name)[:num_instances]
    exists = count > 0
    return scene, count, cls, exists


def discriminative_loss(embedding: jnp.ndarray, instance_id: jnp.ndarray,
                        point_scene: jnp.ndarray, num_scenes: int,
                        num_instances: int,
                        cfg: LossConfig = LossConfig(),
                        axis_name: str | None = None) -> jnp.ndarray:
    e = embedding.astype(jnp.float32)
    I = num_instances
    an = axis_name
    seg = _sanitize_seg(instance_id, I)
    mu, cnt = _seg_mean(jnp.where((instance_id >= 0)[:, None], e, 0), seg,
                        I + 1, an)
    mu, cnt = mu[:I], cnt[:I]
    exists = cnt > 0
    valid_pt = instance_id >= 0

    # pull (variance) term: per-scene mean over points, then mean over scenes
    # (mu per point via one-hot dot: its backward is a dot, not a scatter)
    dev = _safe_norm(e - _seg_lookup(mu, seg, I), axis=1)
    dev = jnp.maximum(dev - cfg.delta_v, 0.0) ** 2
    pscene = jnp.where(valid_pt, point_scene, num_scenes)
    per_scene_sum = _seg_sum(jnp.where(valid_pt, dev, 0), pscene,
                             num_scenes + 1, an)
    per_scene_cnt = _seg_sum(valid_pt.astype(jnp.float32), pscene,
                             num_scenes + 1, an)
    scene_has = per_scene_cnt[:num_scenes] > 0
    l_v = jnp.sum(per_scene_sum[:num_scenes]
                  / jnp.maximum(per_scene_cnt[:num_scenes], 1))

    # push (distance) term: same-scene centroid pairs (mu/iscene are global
    # after the psums above, so the [I, I] work below is replicated — no
    # further cross-shard reduction)
    iscene = _seg_max(jnp.where(valid_pt, point_scene, -1), seg,
                      I + 1, -1, an)[:I]
    d = _safe_norm(mu[:, None, :] - mu[None, :, :], axis=-1)
    same_scene = (iscene[:, None] == iscene[None, :])
    pair_ok = (same_scene & exists[:, None] & exists[None, :]
               & ~jnp.eye(I, dtype=bool))
    hinge = jnp.maximum(2 * cfg.delta_d - d, 0.0) ** 2
    # per-scene normalization n(n-1)
    n_per_scene = _seg_sum(exists.astype(jnp.float32),
                           jnp.where(iscene >= 0, iscene, num_scenes),
                           num_scenes + 1)[:num_scenes]
    pair_scene = jnp.where(pair_ok, iscene[:, None], num_scenes)
    pair_sum = _seg_sum(jnp.where(pair_ok, hinge, 0).reshape(-1),
                        pair_scene.reshape(-1), num_scenes + 1)[:num_scenes]
    denom = jnp.maximum(n_per_scene * (n_per_scene - 1), 1.0)
    l_d = jnp.sum(jnp.where(n_per_scene > 1, pair_sum / denom, 0.0))

    # regularization: per-scene mean centroid norm
    mu_norm = _safe_norm(mu, axis=1)
    reg_sum = _seg_sum(jnp.where(exists, mu_norm, 0),
                       jnp.where((iscene >= 0) & exists, iscene, num_scenes),
                       num_scenes + 1)[:num_scenes]
    l_r = jnp.sum(jnp.where(n_per_scene > 0, reg_sum / jnp.maximum(n_per_scene, 1), 0))

    n_scenes = jnp.maximum(jnp.sum(scene_has.astype(jnp.float32)), 1.0)
    return (l_v + l_d + cfg.gamma * l_r) / n_scenes


def classification_loss(embedding: jnp.ndarray, bw: jnp.ndarray,
                        regressed_pose: jnp.ndarray, pose: jnp.ndarray,
                        instance_id: jnp.ndarray, point_scene: jnp.ndarray,
                        labels: jnp.ndarray, num_scenes: int,
                        num_instances: int,
                        cfg: LossConfig = LossConfig(),
                        axis_name: str | None = None
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Soft-membership BCE + instance IoU (reference
    `discriminative.py:40-117`, weight *10 applied here)."""
    I = num_instances
    an = axis_name
    e = embedding.astype(jnp.float32)
    x = pose.astype(jnp.float32)
    rx = regressed_pose.astype(jnp.float32)
    seg = _sanitize_seg(instance_id, I)
    valid_pt = instance_id >= 0

    mu, cnt = _seg_mean(jnp.where(valid_pt[:, None], e, 0), seg, I + 1, an)
    mean_pose, _ = _seg_mean(jnp.where(valid_pt[:, None], x, 0), seg,
                             I + 1, an)
    sig, _ = _seg_mean(jnp.where(valid_pt[:, None],
                                 bw.astype(jnp.float32), 0), seg, I + 1, an)
    mu, mean_pose, sig, cnt = mu[:I], mean_pose[:I], sig[:I], cnt[:I]
    scene_i, count_i, cls_i, exists = _instance_stats(
        instance_id, point_scene, labels, I, an)
    use = exists & (count_i >= cfg.min_instance_points)

    # [P, I] squared distances via |a|^2 + |b|^2 - 2 a.b (matmul form)
    def sqdist(a, b):
        an = jnp.sum(a * a, axis=1, keepdims=True)
        bn = jnp.sum(b * b, axis=1, keepdims=True)
        return jnp.maximum(
            an + bn.T - 2.0 * jax.lax.dot_general(
                a, b, dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32), 0.0)

    d_emb = jnp.sqrt(sqdist(e, mu) + 1e-12)          # [P, I]
    d_spat_r = jnp.sqrt(sqdist(rx, mean_pose) + 1e-12)
    d_spat = jnp.sqrt(sqdist(x, mean_pose) + 1e-12)

    # instance radius = max spatial distance of its own points to its
    # center: a masked column max over the (gradient-free: x and mean_pose
    # are GT) d_spat matrix, which fuses into a reduce of the
    # already-materialized [P, I] pass instead of an element gather plus
    # a separate segment max.
    member = (seg[:, None] == jnp.arange(I)[None, :]) & valid_pt[:, None]
    radius = jnp.max(jnp.where(member, d_spat, 0.0), axis=0)
    if an is not None:
        radius = jax.lax.pmax(radius, an)

    same_scene = point_scene[:, None] == scene_i[None, :]
    sample = (d_spat < 4.0 * radius[None, :]) & same_scene & use[None, :]

    d1 = d_emb * sig[None, :, 0]
    d2 = d_spat_r * sig[None, :, 1]
    # prob = exp(-s); BCE computed directly in s-space: -log(prob) = s and
    # -log1p(-prob) = -log(-expm1(-s)). Identical to the exp/clip/log/log1p
    # chain (the clip on prob maps to a clip on s) but two transcendental
    # passes over [P, I] instead of four — this loss is the largest single
    # cost of the flagship step after the convs.
    s = d1 * d1 + d2 * d2
    s = jnp.clip(s, 1.0000001e-7, 16.11809565095832)  # prob in [1e-7, 1-1e-7]
    bce = jnp.where(member, s, -jnp.log(-jnp.expm1(-s)))
    bce = jnp.where(sample, bce, 0)
    n_samp = jnp.sum(sample, axis=0)
    bce_sum = jnp.sum(bce, axis=0)
    if an is not None:
        n_samp = jax.lax.psum(n_samp, an)
        bce_sum = jax.lax.psum(bce_sum, an)
    per_inst = bce_sum / jnp.maximum(n_samp, 1)
    n_inst = jnp.maximum(jnp.sum(use.astype(jnp.float32)), 1.0)
    loss = jnp.sum(jnp.where(use, per_inst, 0)) / n_inst * cfg.classification_weight

    pred = (s < 0.6931471805599453) & sample  # prob = exp(-s) > 0.5
    gt = member & sample
    tp = jnp.sum((pred & gt), axis=0).astype(jnp.float32)
    fp = jnp.sum((pred & ~gt), axis=0).astype(jnp.float32)
    tot = jnp.sum(gt, axis=0).astype(jnp.float32)
    if an is not None:
        tp = jax.lax.psum(tp, an)
        fp = jax.lax.psum(fp, an)
        tot = jax.lax.psum(tot, an)
    iou = tp / jnp.maximum(tot + fp, 1.0)
    miou = jnp.sum(jnp.where(use, iou, 0)) / n_inst
    return loss, miou


def _cluster_losses(disp_err: jnp.ndarray, occ_err: jnp.ndarray,
                    occ: jnp.ndarray, instance_id: jnp.ndarray,
                    point_scene: jnp.ndarray, labels: jnp.ndarray,
                    num_scenes: int, num_instances: int, cfg: LossConfig,
                    axis_name: str | None = None):
    """Displacement + occupancy cluster terms in one pass: per-instance mean
    errors (and the occ prediction std), restricted to GT class > 1,
    averaged over instances within a scene then over scenes
    (reference `train_instance.py:217-236`)."""
    I = num_instances
    an = axis_name
    seg = _sanitize_seg(instance_id, I)
    valid_pt = instance_id >= 0
    scene_i, count_i, cls_i, exists = _instance_stats(
        instance_id, point_scene, labels, I, an)
    fg = exists & (cls_i >= cfg.foreground_class_threshold)

    def inst_mean(v):
        m, _ = _seg_mean(jnp.where(valid_pt, v, 0)[:, None], seg, I + 1, an)
        return m[:I, 0]

    disp_mean = inst_mean(disp_err)
    occ_err_mean = inst_mean(occ_err)
    occ_mean = inst_mean(occ[:, 0])
    # centered two-pass variance (E[x^2]-E[x]^2 cancels catastrophically);
    # unbiased, matching torch_scatter scatter_std default
    centered = occ[:, 0] - _seg_lookup(occ_mean, seg, I)
    sq_sum = _seg_sum(jnp.where(valid_pt, centered * centered, 0), seg,
                      I + 1, an)
    n = jnp.maximum(count_i, 1.0)
    occ_std = jnp.sqrt(jnp.maximum(sq_sum[:I] / jnp.maximum(n - 1, 1), 0)
                       + 1e-12)

    iscene_fg = jnp.where(fg, scene_i, num_scenes)
    n_fg = _seg_sum(fg.astype(jnp.float32), iscene_fg,
                    num_scenes + 1)[:num_scenes]

    def per_scene(v):
        s = _seg_sum(jnp.where(fg, v, 0), iscene_fg,
                     num_scenes + 1)[:num_scenes]
        return jnp.sum(jnp.where(n_fg > 0, s / jnp.maximum(n_fg, 1), 0))

    scene_has = _seg_sum(exists.astype(jnp.float32),
                         jnp.where(exists, scene_i, num_scenes),
                         num_scenes + 1)[:num_scenes] > 0
    n_scenes = jnp.maximum(jnp.sum(scene_has.astype(jnp.float32)), 1.0)
    displacement = per_scene(disp_mean) / n_scenes
    occupancy = (per_scene(occ_err_mean) + per_scene(occ_std)) / n_scenes
    return displacement, occupancy


def occuseg_total_loss(outputs, batch: Dict[str, jnp.ndarray],
                       num_scenes: int, num_instances: int,
                       cfg: LossConfig = LossConfig(),
                       axis_name: str | None = None,
                       ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Assemble the 6-term training loss (reference
    `train_instance.py:186-255`, combination at `:416`).

    batch keys (all padded to P_cap, padding rows label=-1/instance=-1):
      labels [P] int32, instance_id [P] int32, point_scene [P] int32,
      pose [P,3] f32 (coords/scale), offsets [P,1] f32, displacements [P,3]
      f32, occupancy [P,1] f32 (log instance size).

    `axis_name` (spatial training): the point rows are SHARDED over that
    mesh axis; every point-level reduction is psum'd so the returned loss
    equals the unsharded loss on the union of rows, replicated per shard.
    """
    labels = batch["labels"]
    iid = batch["instance_id"]
    pscene = batch["point_scene"]
    an = axis_name
    fg_pt = labels >= cfg.foreground_class_threshold

    sem = _semantic_term(outputs.semantics, labels, cfg, an)
    emb = discriminative_loss(outputs.embedding, iid, pscene, num_scenes,
                              num_instances, cfg, an)

    # offset (centredness) regression: L1 over foreground points * 100
    n_fg = jnp.sum(fg_pt.astype(jnp.float32))
    off_l1 = jnp.abs(outputs.offset.astype(jnp.float32) - batch["offsets"])
    off_sum = jnp.sum(jnp.where(fg_pt[:, None], off_l1, 0))
    if an is not None:
        n_fg = jax.lax.psum(n_fg, an)
        off_sum = jax.lax.psum(off_sum, an)
    regression = (off_sum / jnp.maximum(n_fg, 1.0)
                  / off_l1.shape[1] * cfg.regress_weight)

    disp_err = _safe_norm(
        outputs.displacement.astype(jnp.float32) - batch["displacements"],
        axis=1)
    occ_err = _safe_norm(
        outputs.occupancy.astype(jnp.float32) - batch["occupancy"], axis=1)
    displacement, occupancy = _cluster_losses(
        disp_err, occ_err, outputs.occupancy.astype(jnp.float32), iid,
        pscene, labels, num_scenes, num_instances, cfg, an)

    regressed_pose = batch["pose"] - outputs.displacement.astype(jnp.float32)
    classification, miou = classification_loss(
        outputs.embedding, outputs.bw, regressed_pose, batch["pose"], iid,
        pscene, labels, num_scenes, num_instances, cfg, an)

    total = sem + regression + emb + displacement + classification + occupancy
    parts = {
        "semantic_loss": sem, "embedding_loss": emb,
        "regression_loss": regression, "displacement_loss": displacement,
        "classification_loss": classification, "occupancy_loss": occupancy,
        "instance_iou": miou,
    }
    if cfg.drift_weight:
        drift = drift_loss(outputs.embedding, regressed_pose, batch["pose"],
                           outputs.offset, iid, labels, pscene, num_scenes,
                           num_instances, cfg, an)
        total = total + cfg.drift_weight * drift
        parts["drift_loss"] = cfg.drift_weight * drift
    parts["total"] = total
    return total, parts


def _semantic_term(logits: jnp.ndarray, labels: jnp.ndarray,
                   cfg: LossConfig,
                   axis_name: str | None = None) -> jnp.ndarray:
    """--loss dispatch (reference `train_instance.py:354-365`)."""
    kind = cfg.semantic_loss
    if kind in ("cross_entropy", "nll"):
        return semantic_cross_entropy(logits, labels, axis_name)
    if axis_name is not None:
        # lovasz needs a global sort; focal/weighted need psum'd means —
        # none are wired for point-sharded rows yet
        raise NotImplementedError(
            f"--loss {kind!r} under spatial sharding (use cross_entropy)")
    from occuseg.losses import semantic as sem_losses
    if kind == "lovasz":
        return sem_losses.lovasz_softmax(logits, labels)
    if kind == "focal":
        return sem_losses.focal_loss(logits, labels)
    if kind in ("weighted", "weighted_cross_entropy"):
        w = cfg.ce_weights or sem_losses.SCANNET_CE_WEIGHTS
        return sem_losses.weighted_cross_entropy(
            logits, labels, jnp.asarray(w, jnp.float32)[:logits.shape[-1]])
    raise NotImplementedError(f"--loss {kind!r}")


def drift_loss(embedding: jnp.ndarray, regressed_pose: jnp.ndarray,
               pose: jnp.ndarray, offset_pred: jnp.ndarray,
               instance_id: jnp.ndarray, labels: jnp.ndarray,
               point_scene: jnp.ndarray, num_scenes: int,
               num_instances: int,
               cfg: LossConfig = LossConfig(),
               axis_name: str | None = None) -> jnp.ndarray:
    """DriftLoss (reference `discriminative.py:7-36`; disabled by default at
    `train_instance.py:240` but part of the loss library): for foreground
    instances, L1 between offset-weighted embeddings/regressed poses and the
    offset-weighted instance means, over points with offset > 0.01."""
    I = num_instances
    seg = _sanitize_seg(instance_id, I)
    valid = (instance_id >= 0) & (offset_pred.reshape(-1) > 0.01)
    e = embedding.astype(jnp.float32)
    rp = regressed_pose.astype(jnp.float32)
    w = offset_pred.reshape(-1, 1).astype(jnp.float32)

    an = axis_name
    mu_e, _ = _seg_mean(jnp.where((instance_id >= 0)[:, None], e, 0), seg,
                        I + 1, an)
    mu_p, _ = _seg_mean(jnp.where((instance_id >= 0)[:, None],
                                  pose.astype(jnp.float32), 0), seg,
                        I + 1, an)
    scene_i, count_i, cls_i, exists = _instance_stats(
        instance_id, point_scene, labels, I, an)
    fg = exists & (cls_i >= cfg.foreground_class_threshold)

    segc = jnp.clip(seg, 0, I - 1)
    err = (jnp.abs(e * w - _seg_lookup(mu_e[:I], seg, I) * w).mean(axis=1)
           + jnp.abs(rp * w - _seg_lookup(mu_p[:I], seg, I) * w).mean(axis=1))
    use = valid & fg[segc]
    per_inst = _seg_sum(jnp.where(use, err, 0), seg, I + 1, an)[:I]
    per_cnt = _seg_sum(use.astype(jnp.float32), seg, I + 1, an)[:I]
    per_inst = jnp.where(per_cnt > 0, per_inst / jnp.maximum(per_cnt, 1), 0)
    n_fg = jnp.maximum(jnp.sum((fg & (per_cnt > 0)).astype(jnp.float32)), 1)
    return jnp.sum(per_inst) / n_fg
