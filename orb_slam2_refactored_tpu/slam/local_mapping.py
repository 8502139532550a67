"""Local mapping stage: local bundle adjustment, point culling, outlier pruning.

Capability analog of the reference `LocalMapping`
(`/root/reference/src/LocalMapping.cc:93-130`): per-keyframe map refinement.
Redesigned for an accelerator:

- `LocalBundleAdjustment` (`src/Optimizer.cc:491-736`) builds a g2o graph
  from the covisibility window plus a fixed frontier. Here the WHOLE map is
  the BA problem (the SoA arrays already are the observation tensors —
  `kf_xy/kf_uright/kf_mp` rows), and "local" is just the free-frame mask:
  fixed frames participate exactly like g2o's fixed vertices, with zero
  graph-construction cost. At padded capacity [K,N] the dense formulation is
  small work for the device, so sparse windowing machinery would only add
  latency.
- MapPointCulling (`src/LocalMapping.cc:335-369`) keeps its semantics
  (young points must earn >=3 observations / adequate found-ratio) on the
  host graph, with a batched device invalidation.
- Outlier observations flagged by BA's chi2 gate are erased both device-side
  (kf_mp -> -1) and in the host observation lists (the analog of g2o edge
  removal + `EraseObservation`, `src/Optimizer.cc:677-716`).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import projection as proj
from ..geometry import se3
from ..optim.ba import BAProblem, ba_solve
from .frame import scale_factors
from .map_state import INVALID, MapArrays, MapGraph




def _pad_bucket(v, fill, min_size: int = 512):
    """Pad an index list into a power-of-2-bucketed i32 array.

    Shape variety is compile variety: every distinct padded length compiles a
    fresh program, so buckets grow
    geometrically from a generous floor instead of rounding to the next 128.
    """
    n = max(int(len(v)), 1)
    size = min_size
    while size < n:
        size *= 2
    out = np.full(size, fill, np.int32)
    out[: len(v)] = v
    return out


class LocalMapper:
    # total window rows in the compacted local-BA problem: free KFs
    # (1 + `window` covisibles) + fixed frontier, padded to a static shape
    BA_WINDOW = 32
    # compacted point capacities of the window solve (local ids; the last
    # id of the chosen bucket is the "not selected" sentinel). A W=32 x
    # N=1000 window observes far fewer unique landmarks in practice — the
    # smallest bucket that fits is chosen per solve (each bucket is its own
    # compiled program; the T-scatter that dominates the LM iteration is
    # ~6x cheaper at 2048 rows than 8192). Overflow beyond the largest
    # bucket drops the extras from THIS solve only.
    BA_POINT_BUCKETS = (2048, 4096, 8192)

    def __init__(self, cam: proj.CameraIntrinsics, n_levels: int,
                 scale_factor: float, ba_iters: int = 6, cg_iters: int = 30,
                 window: int = 12, lambda0: float = 1e-4, min_kfs: int = 2,
                 tri_neighbors: int = 6):
        self.cam = cam
        self.window = window
        self.min_kfs = min_kfs
        self.tri_neighbors = tri_neighbors
        sf, sigma2, inv_sigma2 = scale_factors(n_levels, scale_factor)
        self.sf = sf
        self.inv_sigma2 = inv_sigma2
        # no donation: callers (tests, GBA snapshots) may hold references
        # into the pre-BA map arrays
        self._ba = jax.jit(
            lambda m, wi, wf, wv, lut, pl: self._ba_impl(
                m, wi, wf, wv, lut, pl, ba_iters, cg_iters, lambda0
            )
        )
        self._cull = jax.jit(self._cull_impl, donate_argnums=(0,))
        self._tri = jax.jit(self._triangulate_impl)
        def _tri_pack(m, kf, nbs):
            xw, idx_b, good = jax.vmap(
                lambda nb: self._triangulate_impl(m, kf, nb)
            )(nbs)
            # host only needs (idx_b, good) for slot allocation + graph
            # bookkeeping — ONE small transfer; the triangulated positions
            # stay device-resident and feed _tri_insert_all directly
            small = jnp.stack([idx_b, good.astype(jnp.int32)], -1)  # [B,N,2]
            return small, idx_b, xw

        self._tri_batch = jax.jit(_tri_pack)

        def _tri_insert_all(m, kf_a, nbs, slots_all, idx_all, xw_all):
            for b in range(self.tri_neighbors):
                m = self._tri_insert_impl(
                    m, kf_a, nbs[b], slots_all[b], idx_all[b], xw_all[b]
                )
            return m

        self._tri_insert_all = jax.jit(_tri_insert_all, donate_argnums=(0,))

        def _fuse_pack(m, srcs, dsts):
            idx, dst_pt, keep, src_mp = jax.vmap(
                lambda a, b: self._fuse_pair_impl(m, a, b)
            )(srcs, dsts)
            return jnp.stack(
                [idx, dst_pt, keep.astype(jnp.int32), src_mp], -1
            )

        self._fuse_batch = jax.jit(_fuse_pack)
        self._tri_insert = jax.jit(self._tri_insert_impl, donate_argnums=(0,))
        # one fetch worker: device->host reads block in this thread (the
        # transfer releases the GIL), so the frame loop never stalls on a
        # mapping-stage readback — the thread-shaped part of the reference's
        # LocalMapping thread (src/LocalMapping.cc:57-91)
        self._fetch_pool = ThreadPoolExecutor(1, "map-fetch")

    def _fetch(self, dev_arr):
        """Start an off-thread device->host fetch; returns a Future."""
        dev_arr.copy_to_host_async()
        return self._fetch_pool.submit(np.asarray, dev_arr)

    def tri_ready(self) -> bool:
        p = getattr(self, "_pending_tri", None)
        return p is None or p[3].done()

    def fuse_ready(self) -> bool:
        p = getattr(self, "_pending_fuse", None)
        return p is None or p[2].done()

    def ratio_ready(self) -> bool:
        p = getattr(self, "_pending_ratio", None)
        return p is None or p[1].done()

    # -- jitted programs -------------------------------------------------

    def _ba_impl(self, m: MapArrays, win_idx, win_free, win_valid,
                 pt_lut, pts_local, iters, cg_iters, lambda0):
        """Window-compacted local BA with fused write-back.

        The reference's LocalBundleAdjustment builds a g2o graph over the
        covisibility window plus a fixed frontier (`src/Optimizer.cc:491-736`).
        Running BA over the FULL padded [K,N] capacity does ~4x the work of
        gathering the W=32 window rows at K=128; the gather cuts the
        Jacobian/scatter work ~4x while keeping the whole solve + application
        in ONE dispatch (no host round trips). Round 3 also compacts the
        POINT axis: the host covisibility mirror knows which landmarks the
        window observes, so the solver's point arrays shrink from the 32k
        capacity to BA_POINTS rows — the per-iteration scatter/segment-sum
        targets (the hot spot of the dense-Schur LM step) shrink
        with them.

        win_idx: i32[W] keyframe slots; padding rows use slot=K (OOB, dropped
        on scatter) with win_valid=False. win_free: rows optimized; fixed
        rows are the frontier. pt_lut: i32[P] mapping point slot -> local id
        (Q-1 = "not selected"); pts_local: i32[Q] local id -> point slot
        (padding = P). Points observed by any valid KF OUTSIDE the window
        are frozen (the point-side analog of fixed frontier cameras); stray
        observations whose landmark missed the host selection (mirror lag)
        are dropped for this solve.
        Returns (new_map, outlier_mask[K,N], cost0, cost1).
        """
        K, N = m.kf_mp.shape
        P = m.point_capacity
        Q = pts_local.shape[0]
        gather = jnp.clip(win_idx, 0, K - 1)
        obs_pt_g = jnp.where(win_valid[:, None], m.kf_mp[gather], INVALID)

        in_win = jnp.zeros((K,), bool).at[gather].max(win_valid)
        outside_obs = (m.kf_mp >= 0) & (~in_win & m.kf_valid)[:, None]
        pt_frozen = jnp.zeros((P,), bool).at[
            jnp.clip(m.kf_mp, 0, P - 1).reshape(-1)
        ].max(outside_obs.reshape(-1))

        # local (compacted) point domain
        local = pt_lut[jnp.clip(obs_pt_g, 0, P - 1)]
        obs_pt = jnp.where((obs_pt_g >= 0) & (local < Q - 1), local, INVALID)
        pl = jnp.clip(pts_local, 0, P - 1)
        pl_ok = pts_local < P
        pt_pos_l = m.mp_pos[pl]
        pt_valid_l = m.mp_valid[pl] & pl_ok
        pt_frozen_l = pt_frozen[pl] | ~pl_ok

        prob = BAProblem(
            kf_pose=m.kf_pose[gather],
            kf_fixed=~(win_free & win_valid),
            obs_uv=m.kf_xy[gather],
            obs_ur=m.kf_uright[gather],
            obs_pt=obs_pt,
            obs_inv_s2=self.inv_sigma2[m.kf_level[gather]],
            pt_pos=pt_pos_l,
            pt_valid=pt_valid_l,
            pt_frozen=pt_frozen_l,
        )
        # dense Schur: at W=32 the reduced camera system is [192,192] —
        # direct formation from per-point camera-block sums + a dense solve
        # replaces cg_iters sequential latency-bound dispatches per LM step
        res = ba_solve(prob, self.cam, iters=iters, cg_iters=cg_iters,
                       lambda0=lambda0, dense_schur=True)

        # scatter window poses back (padding scatters to row K -> dropped)
        scatter = jnp.where(win_valid & win_free, win_idx, K)
        new_kf_pose = m.kf_pose.at[scatter].set(res.kf_pose, mode="drop")
        out_w = (obs_pt >= 0) & ~res.obs_inlier & win_free[:, None]
        outlier = jnp.zeros((K, N), bool).at[scatter].max(out_w, mode="drop")
        # scatter refined landmark positions back (frozen rows carry their
        # original values; padding rows target P -> dropped)
        upd = jnp.where(pt_valid_l[:, None], res.pt_pos, pt_pos_l)
        new_mp_pos = m.mp_pos.at[pts_local].set(upd, mode="drop")
        m = m._replace(
            kf_pose=new_kf_pose,
            mp_pos=new_mp_pos,
            kf_mp=jnp.where(outlier, INVALID, m.kf_mp),
        )
        return m, outlier, res.initial_cost, res.final_cost

    def _cull_impl(self, m: MapArrays, kill, pair_kf, pair_feat):
        """kill: i32[B] point slots; (pair_kf, pair_feat): observation cells
        to clear. All padded with out-of-range values (mode='drop')."""
        return m._replace(
            mp_valid=m.mp_valid.at[kill].set(False, mode="drop"),
            kf_mp=m.kf_mp.at[pair_kf, pair_feat].set(INVALID, mode="drop"),
        )

    def _triangulate_impl(self, m: MapArrays, kf_a, kf_b):
        """Two-view triangulation candidates between keyframes a and b.

        CreateNewMapPoints semantics (`/root/reference/src/LocalMapping.cc:380-578`):
        epipolar-gated descriptor matching of landmark-free features
        (`SearchByTriangulation` + `CheckDistEpipolarLine`,
        `src/ORBmatcher.cc:768,384`), SVD/DLT triangulation (`:473-491`),
        cheirality + reprojection + parallax + scale-consistency gates.
        Returns per-feature-of-a: (xw[N,3], idx_b[N], good[N]).
        """
        from ..ops import hamming

        pose_a = m.kf_pose[kf_a]
        pose_b = m.kf_pose[kf_b]
        xy_a, xy_b = m.kf_xy[kf_a], m.kf_xy[kf_b]
        lvl_a, lvl_b = m.kf_level[kf_a], m.kf_level[kf_b]
        free_a = m.kf_feat_valid[kf_a] & (m.kf_mp[kf_a] < 0)
        free_b = m.kf_feat_valid[kf_b] & (m.kf_mp[kf_b] < 0)

        # fundamental matrix F_ab from relative pose (ComputeF12, :55)
        T_ab = se3.compose(pose_a, se3.inverse(pose_b))
        R = se3.quat_to_matrix(se3.rotation(T_ab))
        t = se3.translation(T_ab)
        tx = jnp.array([
            [0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]
        ])
        Km = jnp.array([[self.cam.fx, 0, self.cam.cx],
                        [0, self.cam.fy, self.cam.cy], [0, 0, 1.0]])
        Kinv = jnp.linalg.inv(Km)
        F = Kinv.T @ tx @ R @ Kinv  # maps b-pixels to epipolar lines in a? (below)

        ones_a = jnp.ones_like(xy_a[:, :1])
        ones_b = jnp.ones_like(xy_b[:, :1])
        pa = jnp.concatenate([xy_a, ones_a], -1)
        pb = jnp.concatenate([xy_b, ones_b], -1)
        # line in b for each a-feature: l_b = F^T p_a; distance of p_b to it
        lb = pa @ F  # [N,3]
        d = (pb @ lb.T) ** 2 / jnp.maximum(
            (lb[:, 0] ** 2 + lb[:, 1] ** 2)[None, :], 1e-12
        )  # [Nb, Na] distance^2 of each b to each a's line
        epi_ok = d.T < 3.84 * (self.sf[lvl_b] ** 2)[None, :]  # [Na,Nb]

        dmat = hamming.hamming_matrix(m.kf_desc[kf_a], m.kf_desc[kf_b])
        mask = free_a[:, None] & free_b[None, :] & epi_ok
        idx_b, best, _ = hamming.masked_best2(dmat, mask)
        matched = free_a & (best <= hamming.TH_LOW)
        keep = hamming.resolve_duplicates(idx_b, best, matched, xy_b.shape[0])

        # midpoint triangulation (closed form, no per-point SVD): intersect
        # the two viewing rays in world space; same gates as the reference's
        # SVD/DLT guard quality (the reprojection gate dominates accuracy)
        xb = xy_b[jnp.clip(idx_b, 0, xy_b.shape[0] - 1)]
        pose_a_wc = se3.inverse(pose_a)
        pose_b_wc = se3.inverse(pose_b)
        ca = se3.translation(pose_a_wc)
        cb_c = se3.translation(pose_b_wc)

        def rays(xy, pose_wc):
            xn = jnp.stack([
                (xy[:, 0] - self.cam.cx) / self.cam.fx,
                (xy[:, 1] - self.cam.cy) / self.cam.fy,
                jnp.ones_like(xy[:, 0]),
            ], -1)
            d = se3.quat_rotate(se3.rotation(pose_wc)[None, :], xn)
            return d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)

        da = rays(xy_a, pose_a_wc)
        db = rays(xb, pose_b_wc)
        # closed-form midpoint: solve [1 -d; -d 1][s;t] = [da.(cb-ca); -db.(cb-ca)]
        w0 = cb_c[None, :] - ca[None, :]
        dd = jnp.sum(da * db, -1)
        da_w = jnp.sum(da * w0, -1)
        db_w = jnp.sum(db * w0, -1)
        denom = jnp.maximum(1.0 - dd * dd, 1e-9)
        s_par = (da_w - dd * db_w) / denom
        t_par = (dd * da_w - db_w) / denom
        pa_pt = ca[None, :] + s_par[:, None] * da
        pb_pt = cb_c[None, :] + t_par[:, None] * db
        xw = 0.5 * (pa_pt + pb_pt)

        # gates
        xca = se3.transform(pose_a, xw)
        xcb = se3.transform(pose_b, xw)
        za, zb = xca[:, 2], xcb[:, 2]
        ra = proj.project(self.cam, xca) - xy_a
        rb = proj.project(self.cam, xcb) - xb
        s2a = self.sf[lvl_a] ** 2
        s2b = self.sf[jnp.clip(lvl_b[jnp.clip(idx_b, 0, lvl_b.shape[0] - 1)], 0, None)] ** 2
        reproj_ok = (jnp.sum(ra * ra, -1) < 5.991 * s2a) & (
            jnp.sum(rb * rb, -1) < 5.991 * s2b
        )
        # parallax between rays
        ca = se3.translation(se3.inverse(pose_a))
        cb = se3.translation(se3.inverse(pose_b))
        va = xw - ca[None]
        vb = xw - cb[None]
        na = jnp.linalg.norm(va, axis=-1)
        nb = jnp.linalg.norm(vb, axis=-1)
        cosp = jnp.sum(va * vb, -1) / jnp.maximum(na * nb, 1e-12)
        # scale consistency (:553-571): distance ratio within scale ratio*1.5
        ratio_dist = na / jnp.maximum(nb, 1e-9)
        ratio_octave = self.sf[lvl_a] / self.sf[
            jnp.clip(lvl_b[jnp.clip(idx_b, 0, lvl_b.shape[0] - 1)], 0, None)
        ]
        scale_ok = (ratio_dist < ratio_octave * 1.5) & (
            ratio_dist * 1.5 > ratio_octave
        )
        finite = jnp.all(jnp.isfinite(xw), -1)
        good = (
            keep & finite & (za > 0) & (zb > 0) & (cosp < 0.9998)
            & reproj_ok & scale_ok
        )
        return xw, idx_b, good

    def _tri_insert_impl(self, m: MapArrays, kf_a, kf_b, slots, idx_b, xw):
        """Scatter triangulated points (slot<0 = skip) + both observations."""
        create = slots >= 0
        tgt = jnp.where(create, slots, m.point_capacity)
        desc = m.kf_desc[kf_a]
        lvl = m.kf_level[kf_a]
        ca = se3.translation(se3.inverse(m.kf_pose[kf_a]))
        view = xw - ca[None]
        dist = jnp.linalg.norm(view, axis=-1)
        max_dist = dist * self.sf[lvl]
        min_dist = max_dist / self.sf[-1]
        m = m._replace(
            mp_pos=m.mp_pos.at[tgt].set(xw, mode="drop"),
            mp_valid=m.mp_valid.at[tgt].set(True, mode="drop"),
            mp_desc=m.mp_desc.at[tgt].set(desc, mode="drop"),
            mp_normal=m.mp_normal.at[tgt].set(
                view / jnp.maximum(dist, 1e-6)[:, None], mode="drop"
            ),
            mp_min_dist=m.mp_min_dist.at[tgt].set(min_dist, mode="drop"),
            mp_max_dist=m.mp_max_dist.at[tgt].set(max_dist, mode="drop"),
        )
        n = slots.shape[0]
        rows_a = jnp.arange(n)
        kf_mp = m.kf_mp.at[kf_a, rows_a].max(jnp.where(create, slots, INVALID))
        safe_b = jnp.where(create, idx_b, 0)
        kf_mp = kf_mp.at[kf_b, safe_b].max(jnp.where(create, slots, INVALID))
        return m._replace(kf_mp=kf_mp)

    def _fuse_pair_impl(self, m: MapArrays, kf_src, kf_dst):
        """Project kf_src's landmarks into kf_dst and find feature matches
        (ORBmatcher::Fuse semantics, `src/ORBmatcher.cc:868-980`): radius
        search at predicted scale + Hamming gate. Returns per-src-feature:
        (dst_feature_idx, dst_has_point, ok)."""
        from ..ops import hamming

        mp = m.kf_mp[kf_src]
        pt = jnp.clip(mp, 0, m.point_capacity - 1)
        src_ok = (mp >= 0) & m.mp_valid[pt]
        xw = m.mp_pos[pt]
        pose = m.kf_pose[kf_dst]
        xc = se3.transform(pose, xw)
        uv = proj.project(self.cam, xc)
        in_front = xc[:, 2] > 0.05

        dst_xy = m.kf_xy[kf_dst]
        dst_lvl = m.kf_level[kf_dst]
        dst_valid = m.kf_feat_valid[kf_dst]
        d2 = jnp.sum((uv[:, None, :] - dst_xy[None, :, :]) ** 2, -1)
        src_lvl = m.kf_level[kf_src]
        r = 3.0 * self.sf[src_lvl]
        win = d2 <= (r[:, None] ** 2)
        lvl_ok = jnp.abs(dst_lvl[None, :] - src_lvl[:, None]) <= 1
        mask = src_ok[:, None] & dst_valid[None, :] & win & lvl_ok & in_front[:, None]
        dmat = hamming.hamming_matrix(m.mp_desc[pt], m.kf_desc[kf_dst])
        idx, best, _ = hamming.masked_best2(dmat, mask)
        ok = src_ok & (best <= hamming.TH_LOW)
        keep = hamming.resolve_duplicates(idx, best, ok, dst_xy.shape[0])
        safe_idx = jnp.clip(idx, 0, dst_xy.shape[0] - 1)
        dst_pt = m.kf_mp[kf_dst][safe_idx]
        return jnp.where(keep, idx, INVALID), dst_pt, keep, mp

    def _kill_kf_impl(self, m: MapArrays, kf):
        return m._replace(
            kf_valid=m.kf_valid.at[kf].set(False),
            kf_feat_valid=m.kf_feat_valid.at[kf].set(False),
            kf_mp=m.kf_mp.at[kf].set(INVALID),
        )

    def _fuse_apply_impl(self, m: MapArrays, add_kf, add_feat, add_pt,
                         rm_src, rm_dst):
        """Apply ALL fusion results in one program: new observations
        (kf_mp[add_kf, add_feat] = add_pt) and duplicate-landmark merges
        (every reference to rm_src becomes rm_dst; rm_src dies). Arrays are
        padded with out-of-range values (mode='drop'). rm_dst must be
        chain-resolved by the caller."""
        kf_mp = m.kf_mp.at[add_kf, add_feat].max(add_pt, mode="drop")
        lut = jnp.arange(m.point_capacity, dtype=jnp.int32)
        lut = lut.at[rm_src].set(rm_dst, mode="drop")
        kf_mp = jnp.where(
            kf_mp >= 0, lut[jnp.clip(kf_mp, 0, m.point_capacity - 1)], kf_mp
        )
        mp_valid = m.mp_valid.at[rm_src].set(False, mode="drop")
        return m._replace(kf_mp=kf_mp, mp_valid=mp_valid)

    MAXOBS = 8  # observers considered per point for descriptor/normal refresh

    def _refresh_points_impl(self, m: MapArrays, pts, obs_kf, obs_feat, n_obs):
        """Recompute distinctive descriptors + viewing normals + scale bands
        for a batch of points from their observer lists.

        ComputeDistinctiveDescriptors (`/root/reference/src/MapPoint.cc:257-320`):
        the descriptor with least median Hamming distance to the others.
        UpdateNormalAndDepth (`:341-392`): mean unit viewing ray; distance
        band from the reference (first) observation's level.
        pts: i32[B] (point_capacity = padding); obs_kf/obs_feat: i32[B,M].
        """
        from ..ops import hamming

        B, M = obs_kf.shape
        safe_kf = jnp.clip(obs_kf, 0, m.kf_capacity - 1)
        safe_ft = jnp.clip(obs_feat, 0, m.kf_mp.shape[1] - 1)
        valid = (jnp.arange(M)[None, :] < n_obs[:, None])

        descs = m.kf_desc[safe_kf, safe_ft]          # [B,M,8]
        # median Hamming distance of each candidate to the rest
        def med_dist(d_row, v_row):
            dm = hamming.hamming_matrix(d_row, d_row)  # [M,M]
            dm = jnp.where(v_row[None, :], dm, hamming.BIG)
            meds = jnp.median(dm, axis=1)
            return jnp.argmin(jnp.where(v_row, meds, 1e9))

        best_idx = jax.vmap(med_dist)(descs, valid)   # [B]
        best_desc = jnp.take_along_axis(
            descs, best_idx[:, None, None].astype(jnp.int32), axis=1
        )[:, 0]

        # normals: mean unit ray from observer camera centers
        pose_wc = se3.inverse(m.kf_pose[safe_kf].reshape(-1, 7)).reshape(B, M, 7)
        centers = pose_wc[..., 4:7]
        safe_pts = jnp.clip(pts, 0, m.point_capacity - 1)
        xw = m.mp_pos[safe_pts]                        # [B,3]
        rays = xw[:, None, :] - centers
        rays = rays / jnp.maximum(
            jnp.linalg.norm(rays, axis=-1, keepdims=True), 1e-9
        )
        normal = jnp.sum(jnp.where(valid[..., None], rays, 0.0), axis=1)
        normal = normal / jnp.maximum(
            jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-9
        )
        # scale band from the first (reference) observation
        ref_kf = safe_kf[:, 0]
        ref_ft = safe_ft[:, 0]
        ref_center = se3.translation(se3.inverse(m.kf_pose[ref_kf]))
        dist = jnp.linalg.norm(xw - ref_center, axis=-1)
        lvl = m.kf_level[ref_kf, ref_ft]
        max_dist = dist * self.sf[lvl]
        min_dist = max_dist / self.sf[-1]

        ok = (pts < m.point_capacity) & (n_obs > 0)
        tgt = jnp.where(ok, pts, m.point_capacity)
        return m._replace(
            mp_desc=m.mp_desc.at[tgt].set(best_desc, mode="drop"),
            mp_normal=m.mp_normal.at[tgt].set(normal, mode="drop"),
            mp_min_dist=m.mp_min_dist.at[tgt].set(min_dist, mode="drop"),
            mp_max_dist=m.mp_max_dist.at[tgt].set(max_dist, mode="drop"),
            mp_nobs=m.mp_nobs.at[tgt].set(n_obs, mode="drop"),
        )

    def refresh_points(self, m: MapArrays, graph: MapGraph, new_kf: int,
                       batch: int = 1024):
        """Refresh stats of every multi-observation point seen by the new KF."""
        if not hasattr(self, "_refresh"):
            self._refresh = jax.jit(self._refresh_points_impl, donate_argnums=(0,))
        # one batched export call (native: mg_refresh_export) instead of
        # ~1000 per-point n_obs/obs_pairs FFI round trips
        pts, okf, oft, nob, n = graph.refresh_export(
            graph.kf_row[new_kf], min_obs=2, M=self.MAXOBS, B=batch
        )
        if n == 0:
            return m
        pts[n:] = m.point_capacity  # pad rows scatter nowhere (mode=drop)
        return self._refresh(
            m, jnp.asarray(pts), jnp.asarray(okf), jnp.asarray(oft),
            jnp.asarray(nob),
        )

    # -- host orchestration ----------------------------------------------

    def fuse_neighbors(self, m: MapArrays, graph: MapGraph, new_kf: int,
                       n_neighbors: int = 5):
        """SearchInNeighbors analog (`src/LocalMapping.cc:580-639`): fuse the
        new KF's landmarks into its covisible ring and vice versa."""
        if not hasattr(self, "_kill_kf"):
            self._kill_kf = jax.jit(self._kill_kf_impl, donate_argnums=(0,))
            self._fuse_apply = jax.jit(self._fuse_apply_impl, donate_argnums=(0,))
        neighbors = graph.covis_neighbors(new_kf, top_k=n_neighbors)
        if not neighbors:
            return m, {"merged": 0, "added": 0}
        pairs = [(new_kf, nb) for nb in neighbors] + [
            (nb, new_kf) for nb in neighbors
        ]
        B = 2 * n_neighbors
        srcs = np.full(B, new_kf, np.int32)
        dsts = np.full(B, new_kf, np.int32)  # self-pair -> no fusable features
        for i, (a, b) in enumerate(pairs[:B]):
            srcs[i], dsts[i] = a, b
        packed_dev = self._fuse_batch(m, jnp.asarray(srcs), jnp.asarray(dsts))
        # decisions fetch off-thread; application drains at the next pump
        self._pending_fuse = (new_kf, pairs[:B], self._fetch(packed_dev))
        return m, {"merged": -1, "added": -1}

    def _drain_fuse(self, m: MapArrays, graph: MapGraph):
        pend = getattr(self, "_pending_fuse", None)
        if pend is None:
            return m
        self._pending_fuse = None
        new_kf, pairs, packed_fut = pend
        packed = packed_fut.result()
        idx_all = packed[..., 0]
        dst_pt_all = packed[..., 1]
        keep_all = packed[..., 2] > 0
        src_mp_all = packed[..., 3]
        if hasattr(graph, "apply_fuse"):
            # arena-side decision loop (native mg_apply_fuse): one FFI call
            # instead of a Python per-feature loop
            srcs = np.asarray([a for a, _ in pairs], np.int32)
            dsts = np.asarray([b for _, b in pairs], np.int32)
            res = graph.apply_fuse(srcs, dsts, idx_all, dst_pt_all,
                                   keep_all, src_mp_all)
            if res is not None:
                (a_kf, a_ft, a_pt), (m_src, m_dst), _killed = res
                if len(a_kf) or len(m_src):
                    nmax = max(len(a_kf), len(m_src))
                    bkt = 512 if nmax <= 512 else 2048
                    m = self._fuse_apply(
                        m,
                        jnp.asarray(_pad_bucket(a_kf.tolist(),
                                                m.kf_capacity, bkt)),
                        jnp.asarray(_pad_bucket(a_ft.tolist(), 0, bkt)),
                        jnp.asarray(_pad_bucket(a_pt.tolist(), INVALID, bkt)),
                        jnp.asarray(_pad_bucket(m_src.tolist(),
                                                m.point_capacity, bkt)),
                        jnp.asarray(_pad_bucket(m_dst.tolist(),
                                                m.point_capacity, bkt)),
                    )
                    graph.update_connections(new_kf, graph.kf_row[new_kf])
                return m
        n_merged = n_added = 0
        # collect every host-graph decision, then apply ALL device writes in
        # one program (one dispatch instead of one per pair)
        add_kf, add_feat, add_pt = [], [], []
        merge_src, merge_dst = [], []
        for bi, (a, b) in enumerate(pairs):
            if a == b:
                continue  # padding self-pair
            idx = idx_all[bi]
            dst_pt = dst_pt_all[bi]
            keep = keep_all[bi]
            src_mp = src_mp_all[bi]
            for f_src in np.nonzero(keep)[0]:
                p_src = int(src_mp[f_src])
                f_dst = int(idx[f_src])
                p_dst = int(dst_pt[f_src])
                if not graph.pt_alive[p_src]:
                    continue
                if p_dst < 0:
                    # dst feature has no landmark: add observation
                    if graph.obs_feat_in_kf(p_src, int(b)) < 0:
                        graph.add_observation(p_src, int(b), f_dst, False)
                        add_kf.append(int(b))
                        add_feat.append(f_dst)
                        add_pt.append(p_src)
                        n_added += 1
                elif p_dst != p_src and graph.pt_alive[p_dst]:
                    # duplicate landmark: keep the better-observed one
                    if graph.n_obs(p_dst) >= graph.n_obs(p_src):
                        lo, hi = p_src, p_dst
                    else:
                        lo, hi = p_dst, p_src
                    for okf, feat in graph.obs_pairs(lo):
                        if graph.obs_feat_in_kf(hi, okf) < 0:
                            graph.add_observation(hi, okf, feat, False)
                    graph.kill_point(lo)
                    merge_src.append(lo)
                    merge_dst.append(hi)
                    n_merged += 1
        if n_merged or n_added:
            # resolve merge chains (x->y then y->z must land on z, matching
            # the sequential host merges above)
            remap = dict(zip(merge_src, merge_dst))
            def _resolve(d):
                while d in remap:
                    d = remap[d]
                return d
            merge_dst = [_resolve(d) for d in merge_dst]
            nmax = max(len(add_kf), len(merge_src))
            m = self._fuse_apply(
                m,
                jnp.asarray(_pad_bucket(add_kf, m.kf_capacity, 512 if nmax <= 512 else 2048)),
                jnp.asarray(_pad_bucket(add_feat, 0, 512 if nmax <= 512 else 2048)),
                jnp.asarray(_pad_bucket(add_pt, INVALID, 512 if nmax <= 512 else 2048)),
                jnp.asarray(_pad_bucket(merge_src, m.point_capacity, 512 if nmax <= 512 else 2048)),
                jnp.asarray(_pad_bucket(merge_dst, m.point_capacity, 512 if nmax <= 512 else 2048)),
            )
            graph.update_connections(new_kf, graph.kf_row[new_kf])
        return m

    def cull_keyframes(self, m: MapArrays, graph: MapGraph, new_kf: int):
        """KeyFrameCulling analog (`src/LocalMapping.cc:641-701`): a covisible
        KF dies when >=90% of its landmarks are observed by >=3 other KFs at
        the same or finer scale."""
        if not hasattr(self, "_kill_kf"):
            self._kill_kf = jax.jit(self._kill_kf_impl, donate_argnums=(0,))
        killed = []
        cands = [kf for kf in graph.covis_neighbors(new_kf, top_k=self.window)
                 if kf != graph.origin_kf and kf != new_kf]
        if not cands:
            return m, killed
        # host mirrors: zero device reads in the culling decision
        kf_level = graph.kf_levels
        for kf in cands:
            # copy: erase_observation mutates the kf_row mirror in place
            mp_row = graph.kf_row[kf].copy()
            obs_feats = np.nonzero(mp_row >= 0)[0]
            if len(obs_feats) < 20:
                continue
            n_redundant, n_total = graph.redundant_obs(kf, mp_row, kf_level)
            if n_total >= 20 and n_redundant > 0.9 * n_total:
                # detach observations, repair spanning tree, free the row
                for f in obs_feats:
                    graph.erase_observation(int(mp_row[f]), kf)
                parent = int(graph.parent[kf])
                graph.kill_keyframe(kf)
                m = self._kill_kf(m, jnp.int32(kf))
                killed.append((kf, parent))
                # orphan cascade: points this KF observed may have fallen
                # below 2 observers
                m, _ = self.kill_orphan_points(
                    m, graph, mp_row[obs_feats].tolist()
                )
        if killed:
            # record Tcp = Tc_w * Tw_parent at cull time so culled reference
            # KFs stay walkable in trajectory export (KeyFrame::SetBadFlag
            # stores mTcp, src/KeyFrame.cc:464; used src/System.cc:725-734).
            # ONE batched device eval; the small transfer streams back
            # off-thread (kf_tcp is consumed only at trajectory save — the
            # drain resolves it long before then).
            self._resolve_tcp(graph)
            if not hasattr(self, "_tcp"):
                self._tcp = jax.jit(lambda mm, a, b: se3.compose(
                    mm.kf_pose[a], se3.inverse(mm.kf_pose[b])))
            # fixed pad: one compiled variant regardless of kill count
            PAD = 16
            ks_np = np.zeros(PAD, np.int32)
            ps_np = np.zeros(PAD, np.int32)
            for i, (k, p) in enumerate(killed[:PAD]):
                ks_np[i], ps_np[i] = k, max(p, 0)
            tcp_fut = self._fetch(
                self._tcp(m, jnp.asarray(ks_np), jnp.asarray(ps_np))
            )
            self._pending_tcp = (list(killed[:PAD]), tcp_fut)
        return m, [k for k, _ in killed]

    def _resolve_tcp(self, graph: MapGraph):
        pend = getattr(self, "_pending_tcp", None)
        if pend is None:
            return
        self._pending_tcp = None
        killed, fut = pend
        tcp = fut.result()
        if not hasattr(graph, "kf_tcp"):
            graph.kf_tcp = {}
        for i, (k, p) in enumerate(killed):
            graph.kf_tcp[k] = (p, tcp[i])

    def local_ba(self, m: MapArrays, graph: MapGraph, new_kf: int):
        """Window BA: free set = new KF + covisible window; fixed frontier =
        their covisible ring (the reference's fixed observers,
        `src/Optimizer.cc:493-537`); points shared with KFs outside the
        window are frozen inside the program. ONE device dispatch, ONE
        device->host read (the outlier mask, requested async)."""
        if len(graph.alive_kfs()) < self.min_kfs:
            return m, None
        W = self.BA_WINDOW
        K = graph.cap.max_keyframes
        free_list = [new_kf] + graph.covis_neighbors(new_kf, top_k=self.window)
        free_list = free_list[:W - 1]  # always leave room for one fixed row
        seen = set(free_list)
        frontier = []
        for k in free_list:
            for nb in graph.covis_neighbors(int(k)):
                if nb not in seen:
                    seen.add(nb)
                    frontier.append(nb)
                    if len(free_list) + len(frontier) >= W:
                        break
            if len(free_list) + len(frontier) >= W:
                break
        # gauge: at least one fixed row among alive KFs
        if not frontier:
            if graph.origin_kf in free_list and len(free_list) > 1:
                free_list.remove(graph.origin_kf)
                frontier = [graph.origin_kf]
            elif len(free_list) > 1:
                frontier = [free_list.pop()]
            else:
                return m, None
        win_idx = np.full(W, K, np.int32)      # K = OOB padding (dropped)
        win_free = np.zeros(W, bool)
        win_valid = np.zeros(W, bool)
        n_f = len(free_list)
        win_idx[:n_f] = free_list
        win_free[:n_f] = True
        win_valid[:n_f] = True
        win_idx[n_f:n_f + len(frontier)] = frontier
        win_valid[n_f:n_f + len(frontier)] = True

        # window-point compaction: the host kf_row mirror knows the window's
        # landmarks, so the device solve runs on BA_POINTS compacted rows
        # instead of the full point capacity (see _ba_impl). Any device-side
        # association the mirror lags on maps to the sentinel and is dropped
        # from this solve only.
        P = m.point_capacity
        win_all = [int(k) for k in win_idx[: n_f + len(frontier)]]
        rows = graph.kf_row[win_all]
        pts = np.unique(rows[rows >= 0]).astype(np.int64)
        Q = next((b for b in self.BA_POINT_BUCKETS if len(pts) < b),
                 self.BA_POINT_BUCKETS[-1])
        if len(pts) > Q - 1:
            pts = pts[: Q - 1]
        lut = np.full(P, Q - 1, np.int32)
        lut[pts] = np.arange(len(pts), dtype=np.int32)
        pts_local = np.full(Q, P, np.int32)
        pts_local[: len(pts)] = pts

        old_rows = graph.kf_row.copy()  # pre-BA rows (what outliers refer to)
        m, outlier_dev, c0, c1 = self._ba(
            m, jnp.asarray(win_idx), jnp.asarray(win_free),
            jnp.asarray(win_valid), jnp.asarray(lut), jnp.asarray(pts_local),
        )
        outlier_fut = self._fetch(outlier_dev)
        for x in (c0, c1):
            x.copy_to_host_async()
        # host-side outlier erasure defers to the NEXT keyframe: by then the
        # async copy has landed (zero blocking read), and the
        # one-keyframe lag matches the reference's mapping-thread asynchrony.
        # The device kf_mp was already cleaned in-graph by _ba_impl.
        self._pending_ba_erase = (old_rows, outlier_fut)
        return m, {"cost0_dev": c0, "cost1_dev": c1, "free": n_f}

    def drain_pending(self, m: MapArrays, graph: MapGraph):
        """Drain every one-keyframe-deferred mapping product, in the
        original stage order: triangulation insert+bookkeeping, fusion
        decisions+apply, BA outlier erasure, found/visible-ratio culling.
        Called at the top of each keyframe stage, at flush, and before map
        serialization."""
        m = self._drain_tri(m, graph)
        m = self._drain_fuse(m, graph)
        m = self.drain_ba_erase(m, graph)
        m = self._drain_ratio_cull(m, graph)
        self._resolve_tcp(graph)
        return m

    def _drain_ratio_cull(self, m: MapArrays, graph: MapGraph):
        pend = getattr(self, "_pending_ratio", None)
        if pend is None:
            return m
        self._pending_ratio = None
        ref_kf, packed_fut = pend
        packed = packed_fut.result()
        vis, found = packed[0], packed[1]
        ratio = found / np.maximum(vis, 1)
        kill = []
        cur_seq = int(graph.kf_seq[ref_kf])
        for pt in graph.young_points(cur_seq, max_age=4):
            first = graph.pt_first_kf[pt]
            if first < 0 or cur_seq - first > 4:
                continue
            if vis[pt] >= 4 and ratio[pt] < 0.25:
                kill.append(pt)
        if not kill:
            return m
        pairs = []
        for pt in kill:
            pairs.extend(graph.kill_point(pt))
        arr = _pad_bucket(kill, m.point_capacity)
        pk = _pad_bucket([p[0] for p in pairs], m.kf_capacity)
        pf = _pad_bucket([p[1] for p in pairs], 0)
        return self._cull(m, jnp.asarray(arr), jnp.asarray(pk), jnp.asarray(pf))

    def queue_ratio_cull(self, ref_kf: int, vis_dev, found_dev):
        """Stash the found/visible counters (device, functional snapshot)
        for ratio culling at the next drain. The async copy lands during
        the frames in between — zero blocking reads. ONE stacked readback
        instead of two."""
        if not hasattr(self, "_stack_counters"):
            self._stack_counters = jax.jit(lambda a, b: jnp.stack([a, b]))
        self._pending_ratio = (ref_kf,
                               self._fetch(self._stack_counters(vis_dev,
                                                                found_dev)))

    def drain_ba_erase(self, m: MapArrays, graph: MapGraph):
        """Apply the PREVIOUS keyframe's BA outlier erasure to the host
        graph (+ orphan cascade). Called at the start of the next keyframe
        stage, when the async outlier copy has long since landed."""
        p = getattr(self, "_pending_ba_erase", None)
        if p is None:
            return m
        self._pending_ba_erase = None
        old_rows, outlier_fut = p
        outlier = outlier_fut.result()
        touched = self.erase_outlier_obs(graph, old_rows, outlier)
        m, _ = self.kill_orphan_points(m, graph, touched)
        return m

    def erase_outlier_obs(self, graph: MapGraph, old_kf_mp: np.ndarray,
                          outlier: np.ndarray):
        """Remove erased observations from the host graph. Returns the set
        of touched points (candidates for the orphan cascade)."""
        kfs, feats = np.nonzero(outlier)
        touched = set()
        for k, f in zip(kfs, feats):
            pt = int(old_kf_mp[k, f])
            if pt >= 0:
                graph.erase_observation(pt, int(k))
                touched.add(pt)
        return touched

    def kill_orphan_points(self, m: MapArrays, graph: MapGraph, cand_pts):
        """SetBadFlag cascade (`/root/reference/src/MapPoint.cc:131-150`:
        EraseObservation kills a point at nObs<=2, where stereo counts
        double — i.e. fewer than 2 observing keyframes): after batch
        erasures, points left with <2 observers die on host AND device, so
        tracking stops matching landmarks BA can no longer update."""
        kill, pairs = [], []
        for pt in {int(p) for p in cand_pts}:
            if pt >= 0 and graph.pt_alive[pt] and graph.n_obs(pt) < 2:
                pairs.extend(graph.kill_point(pt))
                kill.append(pt)
        if not kill:
            return m, 0
        arr = _pad_bucket(kill, m.point_capacity)
        pk = _pad_bucket([p[0] for p in pairs], m.kf_capacity)
        pf = _pad_bucket([p[1] for p in pairs], 0)
        m = self._cull(m, jnp.asarray(arr), jnp.asarray(pk), jnp.asarray(pf))
        return m, len(kill)

    def triangulate_new_points(self, m: MapArrays, graph: MapGraph, new_kf: int):
        """Dispatch triangulation for `new_kf`; the candidate readback, slot
        allocation, insert and graph bookkeeping happen at the NEXT keyframe
        (`drain_pending`) — by then the async copy has landed, so the stage
        never blocks. The one-keyframe lag matches the reference's
        mapping-thread asynchrony (its CreateNewMapPoints also runs behind
        tracking, src/LocalMapping.cc:133-170)."""
        neighbors = graph.covis_neighbors(new_kf, top_k=self.tri_neighbors)
        if not neighbors:
            return m, 0
        B = self.tri_neighbors
        nbs = np.full(B, new_kf, np.int32)  # self-pair produces no free pairs
        nbs[: len(neighbors)] = neighbors[:B]
        nbs_j = jnp.asarray(nbs)
        small, idx_dev, xw_dev = self._tri_batch(m, jnp.int32(new_kf), nbs_j)
        self._pending_tri = (new_kf, nbs, nbs_j, self._fetch(small),
                             idx_dev, xw_dev)
        return m, -1  # created count known at drain time

    def _drain_tri(self, m: MapArrays, graph: MapGraph):
        pend = getattr(self, "_pending_tri", None)
        if pend is None:
            return m
        self._pending_tri = None
        new_kf, nbs, nbs_j, small_fut, idx_dev, xw_dev = pend
        packed = small_fut.result()  # [B,N,2]: (idx_b, good)
        idx_b_b = packed[..., 0]
        good_b = packed[..., 1] > 0
        n_created = 0
        N = good_b.shape[1]
        slots_all = np.full((self.tri_neighbors, N), -1, np.int32)
        taken = np.zeros(N, bool)  # feature of new_kf already used
        for bi in range(self.tri_neighbors):
            nb = int(nbs[bi])
            if nb == new_kf:
                continue  # padding self-pair
            feats = np.nonzero(good_b[bi] & ~taken)[0]
            if len(feats) == 0:
                continue
            new_slots = graph.alloc_point_slots(len(feats))
            if len(new_slots) == 0:
                break  # point capacity exhausted: stop creating, keep running
            feats = feats[: len(new_slots)]
            taken[feats] = True
            slots_all[bi, feats] = new_slots
            for f, ss in zip(feats, new_slots):
                ss = int(ss)
                graph.pt_alive[ss] = True
                graph.note_new_point(ss, new_kf)
                graph.add_observation(ss, new_kf, int(f), False)
                graph.add_observation(ss, int(nb), int(idx_b_b[bi][f]), False)
            n_created += len(feats)
        if n_created:
            # ONE scatter program inserts every neighbor's new points; the
            # triangulated positions never left the device
            m = self._tri_insert_all(
                m, jnp.int32(new_kf), nbs_j, jnp.asarray(slots_all),
                idx_dev, xw_dev,
            )
            graph.update_connections(new_kf, graph.kf_row[new_kf])
        return m

    def cull_points(self, m: MapArrays, graph: MapGraph, new_kf: int,
                    min_obs: int = 3, age: int = 2, vis_found=None):
        """Young points (first seen within `age` KFs) with too few
        observations die; so do recent points whose found/visible ratio
        drops below 0.25 (MapPointCulling, src/LocalMapping.cc:335-369 +
        MapPoint::GetFoundRatio, src/MapPoint.cc:322-339).

        vis_found: optional (visible, found) device i32[P] counter pair
        maintained by the tracker's fused step program."""
        ratio = None
        if vis_found is not None:
            packed = np.asarray(jnp.stack(list(vis_found)))  # ONE transfer
            vis, found = packed[0], packed[1]
            ratio = found / np.maximum(vis, 1)
        kill: List[int] = []
        # only points created within the trial window can die here: the
        # graph maintains the young-point list (slot allocation is not
        # contiguous once recycling starts, so a next_point range scan
        # would miss recycled slots)
        cur_seq = int(graph.kf_seq[new_kf])
        for pt in graph.young_points(cur_seq, max_age=age + 2):
            first = graph.pt_first_kf[pt]
            if first < 0:
                continue
            # only "recent" points are on trial (age just past the grace
            # period); established points are never re-culled here
            pt_age = cur_seq - first
            if age < pt_age <= age + 2 and graph.n_obs(pt) < min_obs:
                kill.append(pt)
            elif (ratio is not None and pt_age <= age + 2
                  and vis[pt] >= 4 and ratio[pt] < 0.25):
                kill.append(pt)
        if not kill:
            return m, 0
        pairs = []
        for pt in kill:
            pairs.extend(graph.kill_point(pt))
        arr = _pad_bucket(kill, m.point_capacity)
        pk = _pad_bucket([p[0] for p in pairs], m.kf_capacity)
        pf = _pad_bucket([p[1] for p in pairs], 0)
        m = self._cull(m, jnp.asarray(arr), jnp.asarray(pk), jnp.asarray(pf))
        return m, len(kill)
