"""Matcher variants over the Hamming core: projection-guided, descriptor-NN,
rotation-consistency — each a masked dense candidate matrix.

Capability analogs (semantics, not structure) of
`/root/reference/src/ORBmatcher.cc`:
- `match_descriptors`        <- SearchForInitialization (:614) / SearchByBoW (:452,:696)
- `search_by_projection`     <- SearchByProjection frame<-mappoints (:315)
- `search_last_frame`        <- SearchByProjection frame<-lastFrame (:1279)
- `rotation_consistency`     <- CheckOrientation 30-bin histogram (:249-309)
The reference's BoW-node candidate gating is an *acceleration* of full
descriptor NN on CPU; on the device the full masked matrix is the fast path,
so BoW gating is unnecessary for speed (it is kept for place recognition only).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import projection as proj
from ..geometry import se3
from . import hamming

HISTO_BINS = 30  # src/ORBmatcher.cc HISTO_LENGTH


class Matches(NamedTuple):
    idx: jnp.ndarray    # i32[M] target index per query row (-1 = none)
    dist: jnp.ndarray   # i32[M]
    valid: jnp.ndarray  # bool[M]


def match_descriptors(
    desc_a,
    desc_b,
    valid_a,
    valid_b,
    max_dist: int = hamming.TH_LOW,
    nn_ratio: float = 0.9,
    mutual: bool = True,
    extra_mask=None,
) -> Matches:
    """Best-match a->b with distance threshold + Lowe ratio + optional
    mutual-NN check. extra_mask: bool[M,N] candidate gate (e.g. window)."""
    d = hamming.hamming_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    if extra_mask is not None:
        mask = mask & extra_mask
    idx, best, second = hamming.masked_best2(d, mask)
    ok = (best <= max_dist) & (best.astype(jnp.float32) <= nn_ratio * second.astype(jnp.float32))
    if mutual:
        idx_b, _, _ = hamming.masked_best2(d.T, mask.T)
        ok = ok & hamming.mutual_filter(idx, idx_b)
    keep = hamming.resolve_duplicates(idx, best, ok, desc_b.shape[0])
    return Matches(jnp.where(keep, idx, -1), best, keep)


def rotation_consistency(angle_a, angle_b, valid):
    """Keep only matches whose angular difference falls in the 3 dominant
    30-bin histogram bins (CheckOrientation semantics)."""
    diff = angle_a - angle_b
    two_pi = 2.0 * jnp.pi
    diff = jnp.mod(diff, two_pi)
    bins = jnp.clip((diff * (HISTO_BINS / two_pi)).astype(jnp.int32), 0, HISTO_BINS - 1)
    counts = jnp.zeros((HISTO_BINS,), jnp.int32).at[bins].add(valid.astype(jnp.int32))
    top_c, top_i = jax.lax.top_k(counts, 3)
    # keep top-1 always; top-2/3 only if within 10x of the max
    # (ComputeThreeMaxima semantics, src/ORBmatcher.cc:249-309)
    keep2 = top_c[1].astype(jnp.float32) > 0.1 * top_c[0].astype(jnp.float32)
    keep3 = top_c[2].astype(jnp.float32) > 0.1 * top_c[0].astype(jnp.float32)
    good_bin = jnp.zeros((HISTO_BINS,), bool).at[top_i[0]].set(True)
    good_bin = good_bin.at[top_i[1]].set(keep2 | good_bin[top_i[1]])
    good_bin = good_bin.at[top_i[2]].set(keep3 | good_bin[top_i[2]])
    return valid & good_bin[bins]


def search_by_projection(
    frame_xy,
    frame_level,
    frame_desc,
    frame_valid,
    mp_pos,
    mp_desc,
    mp_normal,
    mp_min_dist,
    mp_max_dist,
    mp_valid,
    pose_cw,
    cam: proj.CameraIntrinsics,
    scale_factors,
    radius: float = 4.0,
    max_dist: int = hamming.TH_HIGH,
    check_view_angle: bool = True,
    image_bounds=None,
    candidate_cap: int = 8192,
) -> Matches:
    """Match local-map points into a frame by projecting and searching a
    radius window at the predicted scale (SearchByProjection :315 + IsInFrustum
    `src/Tracking.cc:554-605` semantics, fused).

    Returns per-POINT matches: idx[i] = feature index for map point i.

    candidate_cap: when the point capacity exceeds it, the [P,N] candidate
    matrices (pixel window, level gate, Hamming) are built only for the
    top-`cap` frustum-passing points — the per-point gates are O(P) and
    cheap, the pairwise matrices dominate memory traffic. Points beyond the
    cap in one frame are dropped for that frame only (maps with >8k
    concurrently visible landmarks should track through the covisibility
    window, `TrackerConfig.local_map_window`). 0 disables the compaction.
    """
    n_levels = scale_factors.shape[0]
    log_sf = jnp.log(scale_factors[1] / scale_factors[0])

    xc = se3.transform(pose_cw, mp_pos)  # [P,3]
    z = xc[..., 2]
    uv = proj.project(cam, xc)
    in_front = z > 0.05

    if image_bounds is not None:
        min_x, max_x, min_y, max_y = image_bounds
        in_img = (
            (uv[..., 0] >= min_x) & (uv[..., 0] < max_x)
            & (uv[..., 1] >= min_y) & (uv[..., 1] < max_y)
        )
    else:
        in_img = jnp.ones_like(in_front)

    # distance band + predicted scale (MapPoint::PredictScale, src/MapPoint.cc:394-414)
    cam_center = se3.translation(se3.inverse(pose_cw))
    po = mp_pos - cam_center[None, :]
    dist = jnp.linalg.norm(po, axis=-1)
    in_band = (dist >= mp_min_dist * 0.8) & (dist <= mp_max_dist * 1.2)
    pred_level = jnp.clip(
        jnp.ceil(jnp.log(jnp.maximum(mp_max_dist, 1e-6) / jnp.maximum(dist, 1e-6)) / log_sf),
        0,
        n_levels - 1,
    ).astype(jnp.int32)

    if check_view_angle:
        # viewing angle < 60 deg vs mean normal (IsInFrustum :586)
        cosang = jnp.sum(po * mp_normal, axis=-1) / jnp.maximum(
            dist * jnp.linalg.norm(mp_normal, axis=-1), 1e-6
        )
        view_ok = cosang > 0.5
    else:
        view_ok = jnp.ones_like(in_front)

    point_ok = mp_valid & in_front & in_img & in_band & view_ok

    # window radius at the predicted scale
    r = radius * scale_factors[pred_level]  # [P]

    P = mp_pos.shape[0]
    compact = bool(candidate_cap) and candidate_cap < P
    if compact:
        # all per-point gates are computed; only frustum-passing points get
        # rows in the pairwise matrices below
        _, cand = jax.lax.top_k(point_ok.astype(jnp.float32), candidate_cap)
        uv_r = uv[cand]
        r_r = r[cand]
        lvl_r = pred_level[cand]
        ok_r = point_ok[cand]
        desc_r = mp_desc[cand]
    else:
        uv_r, r_r, lvl_r, ok_r, desc_r = uv, r, pred_level, point_ok, mp_desc

    # window gate: pixel distance < radius * scale(pred_level), level within +-1
    d2 = jnp.sum((uv_r[:, None, :] - frame_xy[None, :, :]) ** 2, axis=-1)
    win = d2 <= (r_r[:, None] ** 2)
    lvl_ok = jnp.abs(frame_level[None, :] - lvl_r[:, None]) <= 1
    mask = ok_r[:, None] & frame_valid[None, :] & win & lvl_ok

    d = hamming.hamming_matrix(desc_r, frame_desc)
    idx, best, _ = hamming.masked_best2(d, mask)
    ok = ok_r & (best <= max_dist)
    keep = hamming.resolve_duplicates(idx, best, ok, frame_desc.shape[0])
    if compact:
        # scatter the candidate-row results back onto point rows
        idx_p = jnp.full((P,), -1, idx.dtype).at[cand].set(
            jnp.where(keep, idx, -1)
        )
        best_p = jnp.full((P,), hamming.BIG, best.dtype).at[cand].set(best)
        keep_p = jnp.zeros((P,), bool).at[cand].set(keep)
        return Matches(idx_p, best_p, keep_p)
    return Matches(jnp.where(keep, idx, -1), best, keep)


def search_by_projection_with_vis(*args, **kwargs):
    """`search_by_projection` variant that also returns the per-point
    frustum-visibility mask (the IncreaseVisible signal of
    `src/Tracking.cc:607-649` SearchLocalPoints)."""
    return _search_by_projection_inner(*args, **kwargs)


def _search_by_projection_inner(
    frame_xy, frame_level, frame_desc, frame_valid,
    mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
    pose_cw, cam, scale_factors, radius=4.0, max_dist=hamming.TH_HIGH,
    check_view_angle=True, image_bounds=None,
):
    res = search_by_projection(
        frame_xy, frame_level, frame_desc, frame_valid,
        mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
        pose_cw, cam, scale_factors, radius=radius, max_dist=max_dist,
        check_view_angle=check_view_angle, image_bounds=image_bounds,
    )
    # recompute the cheap frustum predicate (XLA CSEs it with the main call)
    xc = se3.transform(pose_cw, mp_pos)
    uv = proj.project(cam, xc)
    vis = mp_valid & (xc[..., 2] > 0.05)
    if image_bounds is not None:
        min_x, max_x, min_y, max_y = image_bounds
        vis = vis & (
            (uv[..., 0] >= min_x) & (uv[..., 0] < max_x)
            & (uv[..., 1] >= min_y) & (uv[..., 1] < max_y)
        )
    cam_center = se3.translation(se3.inverse(pose_cw))
    dist = jnp.linalg.norm(mp_pos - cam_center[None, :], axis=-1)
    vis = vis & (dist >= mp_min_dist * 0.8) & (dist <= mp_max_dist * 1.2)
    return res, vis


def search_last_frame(
    curr_xy,
    curr_level,
    curr_desc,
    curr_valid,
    last_xy,
    last_level,
    last_desc,
    last_valid,
    last_has_point,
    last_point_xc,  # f32[N,3] 3D position (world) of last frame's points
    pose_cw,
    cam: proj.CameraIntrinsics,
    scale_factors,
    radius: float = 7.0,
    max_dist: int = hamming.TH_HIGH,
) -> Matches:
    """Motion-model matching: project last frame's map points into the
    predicted current pose and search a window at the feature's own level
    (SearchByProjection frame<-lastFrame, :1279-1362). Returns per-LAST-FEATURE
    match indices into the current frame."""
    xc = se3.transform(pose_cw, last_point_xc)
    z = xc[..., 2]
    uv = proj.project(cam, xc)
    ok_pt = last_valid & last_has_point & (z > 0.05)

    r = radius * scale_factors[last_level]
    d2 = jnp.sum((uv[:, None, :] - curr_xy[None, :, :]) ** 2, axis=-1)
    win = d2 <= (r[:, None] ** 2)
    # level gate: current level within [last_level-1, last_level+1] (:1320)
    lvl_ok = jnp.abs(curr_level[None, :] - last_level[:, None]) <= 1
    mask = ok_pt[:, None] & curr_valid[None, :] & win & lvl_ok

    d = hamming.hamming_matrix(last_desc, curr_desc)
    idx, best, _ = hamming.masked_best2(d, mask)
    ok = ok_pt & (best <= max_dist)
    keep = hamming.resolve_duplicates(idx, best, ok, curr_desc.shape[0])
    return Matches(jnp.where(keep, idx, -1), best, keep)
