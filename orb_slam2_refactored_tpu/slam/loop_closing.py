"""Loop closing: detection, Sim3 estimation, correction, pose graph, global BA.

Capability analog of the reference `LoopClosing`
(`/root/reference/src/LoopClosing.cc`):
- detection via BoW scores + covisibility-consistency over consecutive
  keyframes (`LoopDetector::Detect` :157-296, minConsistency=3 :60)
- Sim3 between current KF and loop KF from matched landmark pairs
  (`FindLoopInCandidateKFs` :62-155 — Sim3Solver RANSAC + guided matching)
- correction: propagate the corrected similarity to the covisible group,
  remap their landmarks, fuse duplicates, optimize the essential graph,
  then run full-map BA (`LoopCorrector::Correct` :521-692, `GlobalBA` :349-499)

Accelerator-first: detection scoring is a dense matvec over the keyframe BoW matrix
(slam/vocabulary.py); the Sim3 solve is a vmapped Horn RANSAC over 3D-3D
landmark pairs; the essential graph is the matrix-free Sim3 LM+CG
(optim/pose_graph.py); global BA is `ba_solve` over the whole SoA map (the
reference's transient GBA thread becomes a bounded synchronous call here —
async scheduling is an orchestration concern above this module).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import projection as proj
from ..geometry import se3, sim3
from ..ops import matching
from ..optim.ba import ba_solve
from ..optim.pose_graph import (
    PoseGraphProblem, edge_measurement, pose_graph_solve,
)
from ..solvers.ransac import horn_ransac
from .frame import scale_factors
from .map_state import INVALID, MapArrays, MapGraph
from .vocabulary import KeyFrameDatabase, Vocabulary


class LoopCloser:
    MIN_CONSISTENCY = 3   # src/LoopClosing.cc:60
    MIN_SIM3_INLIERS = 20  # :137 (>=20 accepts the Sim3)

    def __init__(
        self,
        voc: Vocabulary,
        cam: proj.CameraIntrinsics,
        kf_capacity: int,
        n_levels: int = 8,
        scale_factor: float = 1.2,
        fix_scale: bool = True,   # stereo/RGB-D: Sim3 scale fixed to 1
        gba_iters: int = 10,
        gba_cg_iters: int = 40,
    ):
        self.db = KeyFrameDatabase(voc, kf_capacity)
        self.cam = cam
        self.fix_scale = fix_scale
        self.gba_iters = gba_iters
        self.gba_cg_iters = gba_cg_iters
        sf, _, self.inv_sigma2 = scale_factors(n_levels, scale_factor)
        self._sf_arr = sf
        # consistency groups: list of (set_of_kfs, count)
        self.consistent_groups: List = []
        self.last_loop_kf = -1
        # cooldowns compare creation SEQUENCE numbers (graph.kf_seq), not
        # slot indices: slots are recycled on long sequences
        self.last_loop_seq = -1
        self.loops_closed = 0
        self._match_kfs = jax.jit(self._match_kfs_impl)
        self._sim3_refine = jax.jit(self._sim3_refine_impl)
        self._gba = jax.jit(self._gba_impl)

    # ------------------------------------------------------------------

    def add_keyframe_bow(self, m: MapArrays, kf: int):
        """Compute + store the BoW vector of a keyframe (ComputeBoW analog).
        Refits the idf weights to the live corpus every 8 keyframes (the
        reference's idf comes baked into ORBvoc.txt; a live-trained
        vocabulary must track its own document frequencies)."""
        v, _ = self.db.compute_bow(m.kf_desc[kf], m.kf_feat_valid[kf])
        self.db.add(kf, v)
        self._n_indexed = getattr(self, "_n_indexed", 0) + 1
        if self._n_indexed % 8 == 0:
            self.db.refit_idf()
        return v

    def dispatch_detection(self, m: MapArrays, kf: int, fetch):
        """Index keyframe `kf` and start the corpus-scoring query as an
        off-thread fetch; `resolve_detection` consumes the result a frame
        later. The device side (BoW transform + scoring matvec) needs no
        host state, so it overlaps the keyframe-insert readback instead of
        waiting on its own."""
        v = self.add_keyframe_bow(m, kf)
        s_dev, cw_dev = self.db.score_query(v)
        # ONE stacked readback instead of two (common counts are < 2^24 —
        # exact in f32)
        if not hasattr(self, "_stack2"):
            self._stack2 = jax.jit(
                lambda a, b: jnp.stack([a, b.astype(jnp.float32)]))
        return (kf, fetch(self._stack2(s_dev, cw_dev)))

    def resolve_detection(self, graph: MapGraph, kf: int, pending) -> Optional[int]:
        """Finish a `dispatch_detection` query: apply the host-side active
        mask and run the detection policy."""
        pkf, packed_fut = pending
        assert pkf == kf
        packed = packed_fut.result()
        s = packed[0].copy()
        cw = packed[1].astype(np.int32)
        s[~self.db.active] = -1.0
        cw[~self.db.active] = 0
        return self._detect_policy(graph, kf, s, cw)

    def detect(self, m: MapArrays, graph: MapGraph, kf: int, bow_vec) -> Optional[int]:
        """Returns a loop KF id when a consistent candidate exists.

        Mirrors LoopDetector::Detect: gate on >=10 KFs since the last loop,
        min-score from covisible neighbors, candidate consistency across
        MIN_CONSISTENCY consecutive detections (:164-241).
        """
        if (graph.kf_seq[kf] - self.last_loop_seq < 10
                or len(graph.alive_kfs()) < 10):
            return None  # still indexed; just no detection this early
        s, cw = self.db._score_common(bow_vec)
        return self._detect_policy(graph, kf, s, cw)

    def _detect_policy(self, graph: MapGraph, kf: int, scores, common) -> Optional[int]:
        import os as _os
        _dbg = _os.environ.get("TPU_SLAM_DEBUG_LOOP")
        if (graph.kf_seq[kf] - self.last_loop_seq < 10
                or len(graph.alive_kfs()) < 10):
            return None
        neighbors = graph.covis_neighbors(kf, top_k=30)
        min_score = 1.0
        for nb in neighbors:
            if scores[nb] >= 0:
                min_score = min(min_score, float(scores[nb]))
        # DOCUMENTED DEVIATION from the reference: the
        # reference uses the raw min-of-covisible-scores as the retrieval
        # floor (`src/LoopClosing.cc:170-178`, all covisibles, no clamps).
        # Our live-trained vocabularies are far smaller than ORBvoc, so
        # covisible scores sit higher and the raw min over-prunes; the 0.8
        # relax admits near-threshold true revisits and the 0.02 absolute
        # floor rejects the noise band of tiny vocabularies. top_k=30 bounds
        # the neighbor scan (the reference takes all covisibles; beyond 30
        # the min changes negligibly). Every candidate that passes retrieval
        # still faces the full Sim3 + TH_LOW projection gates.
        min_score = max(min_score * 0.8, 0.02)
        exclude = set(neighbors) | {kf}
        cands = self.db.candidates_from_scores(
            scores, common, exclude, min_score, graph
        )
        if _dbg:
            import numpy as _np
            top = _np.argsort(scores)[::-1][:6]
            print(f"[loop] kf={kf} min_score={min_score:.4f} "
                  f"nb={sorted(neighbors)[:12]} cands={cands} "
                  f"top={[(int(t), round(float(scores[t]), 4)) for t in top]}",
                  flush=True)
        if not cands:
            self.consistent_groups = []
            return None
        # covisibility-consistency bookkeeping (:194-241)
        new_groups = []
        loop_kf = None
        for c in cands:
            group = set(graph.covis_neighbors(c, top_k=30)) | {c}
            count = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= self.MIN_CONSISTENCY and loop_kf is None:
                loop_kf = c
        self.consistent_groups = new_groups
        return loop_kf

    # ------------------------------------------------------------------

    def _match_kfs_impl(self, m: MapArrays, kf_a, kf_b):
        """Descriptor-match two keyframes' features that carry landmarks;
        return the 3D-3D landmark pairs (SearchByBoW KF<->KF analog,
        src/ORBmatcher.cc:696)."""
        desc_a = m.kf_desc[kf_a]
        desc_b = m.kf_desc[kf_b]
        mp_a = m.kf_mp[kf_a]
        mp_b = m.kf_mp[kf_b]
        ok_a = (mp_a >= 0) & m.mp_valid[jnp.clip(mp_a, 0, m.point_capacity - 1)]
        ok_b = (mp_b >= 0) & m.mp_valid[jnp.clip(mp_b, 0, m.point_capacity - 1)]
        mm = matching.match_descriptors(
            desc_a, desc_b, ok_a, ok_b, max_dist=50, nn_ratio=0.9
        )
        idx_b = jnp.clip(mm.idx, 0, desc_b.shape[0] - 1)
        pt_a = jnp.clip(mp_a, 0, m.point_capacity - 1)
        pt_b = jnp.clip(mp_b[idx_b], 0, m.point_capacity - 1)
        # positions in each keyframe's CAMERA frame (Sim3Solver works camera-frame,
        # src/Sim3Solver.cc:206-233)
        xa = se3.transform(m.kf_pose[kf_a], m.mp_pos[pt_a])
        xb = se3.transform(m.kf_pose[kf_b], m.mp_pos[pt_b])
        return xa, xb, pt_a, pt_b, mm.valid

    def _sim3_refine_impl(self, m: MapArrays, kf_a, kf_b, S0):
        """Guided Sim3 matching + relative-Sim3 refinement.

        SearchBySim3 (`/root/reference/src/ORBmatcher.cc:1090-1277`): project
        each KF's landmarks through S0 (resp. S0^-1) into the OTHER image,
        window-match at the predicted scale, keep mutually-agreeing pairs.
        Then OptimizeSim3 (`src/Optimizer.cc:944-1100`) refines S0 over the
        paired reprojections. Returns per-b-feature pair arrays.
        """
        from ..optim.sim3_opt import optimize_sim3
        from ..ops import hamming

        P = m.point_capacity
        mp_a, mp_b = m.kf_mp[kf_a], m.kf_mp[kf_b]
        pa = jnp.clip(mp_a, 0, P - 1)
        pb = jnp.clip(mp_b, 0, P - 1)
        ok_a = (mp_a >= 0) & m.kf_feat_valid[kf_a] & m.mp_valid[pa]
        ok_b = (mp_b >= 0) & m.kf_feat_valid[kf_b] & m.mp_valid[pb]
        xa = se3.transform(m.kf_pose[kf_a], m.mp_pos[pa])  # a-cam, per a-feat
        xb = se3.transform(m.kf_pose[kf_b], m.mp_pos[pb])
        lvl_a, lvl_b = m.kf_level[kf_a], m.kf_level[kf_b]
        sf = self._sf_arr

        def guided(x_src, ok_src, desc_src, xy_dst, lvl_dst, ok_dst,
                   desc_dst, S):
            """Project src-cam points through S into dst image; window-match.
            Returns per-src best dst feature (or -1)."""
            xc = sim3.transform(S, x_src)
            uv = proj.project(self.cam, xc)
            in_front = xc[:, 2] > 0.05
            dist = jnp.linalg.norm(xc, axis=-1)
            # predicted octave from distance (SearchBySim3 radius semantics)
            r = 7.5 * sf[jnp.clip(lvl_dst, 0, sf.shape[0] - 1)]  # [Nd]
            d2 = jnp.sum((uv[:, None, :] - xy_dst[None, :, :]) ** 2, -1)
            win = d2 <= (r[None, :] ** 2)
            mask = (ok_src & in_front)[:, None] & ok_dst[None, :] & win
            d = hamming.hamming_matrix(desc_src, desc_dst)
            idx, best, _ = hamming.masked_best2(d, mask)
            return jnp.where(
                ok_src & in_front & (best <= hamming.TH_HIGH), idx, -1
            )

        S0_inv = sim3.inverse(S0)
        b_to_a = guided(xb, ok_b, m.kf_desc[kf_b], m.kf_xy[kf_a], lvl_a,
                        ok_a, m.kf_desc[kf_a], S0)
        a_to_b = guided(xa, ok_a, m.kf_desc[kf_a], m.kf_xy[kf_b], lvl_b,
                        ok_b, m.kf_desc[kf_b], S0_inv)
        # mutual agreement (`src/ORBmatcher.cc:1238-1260` "check agreement")
        Nb = mp_b.shape[0]
        a_sel = jnp.clip(b_to_a, 0, mp_a.shape[0] - 1)
        agree = (b_to_a >= 0) & (a_to_b[a_sel] == jnp.arange(Nb))

        x1 = xa[a_sel]
        uv1 = m.kf_xy[kf_a][a_sel]
        res = optimize_sim3(
            S0, x1, xb, uv1, m.kf_xy[kf_b],
            self.inv_sigma2[lvl_a[a_sel]], self.inv_sigma2[lvl_b],
            agree, self.cam, fix_scale=self.fix_scale,
        )
        pairs_ok = res.inliers & agree
        return (res.S, pairs_ok, mp_a[a_sel], mp_b, res.num_inliers,
                jnp.sum(agree.astype(jnp.int32)))

    def compute_sim3(self, m: MapArrays, kf: int, loop_kf: int, key):
        """Estimate S_{kf<-loop}: descriptor matching -> Horn RANSAC ->
        guided Sim3 matching -> relative-Sim3 LM refinement
        (`FindLoopInCandidateKFs`, src/LoopClosing.cc:62-155)."""
        xa, xb, pt_a, pt_b, valid = self._match_kfs(
            m, jnp.int32(kf), jnp.int32(loop_kf)
        )
        n = int(np.asarray(valid).sum())
        if n < self.MIN_SIM3_INLIERS:
            return None
        res = horn_ransac(
            xb, xa, valid, key, with_scale=not self.fix_scale,
            inlier_th=0.09, min_inliers=self.MIN_SIM3_INLIERS,
        )
        if not bool(res.success):
            return None
        # S0: maps loop-KF camera coords -> current-KF camera coords
        S0 = sim3.from_se3(res.pose, res.scale)
        S, pairs_ok, pt_a2, pt_b2, n_inl, n_guided = self._sim3_refine(
            m, jnp.int32(kf), jnp.int32(loop_kf), S0
        )
        # reference accepts the refined Sim3 at >=20 inliers (:137); fall
        # back to the RANSAC estimate if guided matching starved (degenerate
        # geometry) but RANSAC itself was confident
        if int(n_inl) >= self.MIN_SIM3_INLIERS:
            return S, np.asarray(pairs_ok), np.asarray(pt_a2), np.asarray(pt_b2)
        return S0, np.asarray(res.inliers), np.asarray(pt_a), np.asarray(pt_b)

    def verify_by_projection(self, m: MapArrays, graph: MapGraph, kf: int,
                             loop_kf: int, S_cl, min_matches: int = 40):
        """Project the loop neighborhood's landmarks through the corrected
        pose into the current KF and count matches — the reference's final
        acceptance gate (`src/LoopClosing.cc:259-295`: SearchByProjection
        via Scw, >= 40 matches accepts)."""
        if not hasattr(self, "_proj_verify"):
            def impl(m, kf, pose_cw, loop_mask):
                return matching.search_by_projection(
                    m.kf_xy[kf], m.kf_level[kf], m.kf_desc[kf],
                    m.kf_feat_valid[kf],
                    m.mp_pos, m.mp_desc, m.mp_normal,
                    m.mp_min_dist, m.mp_max_dist,
                    m.mp_valid & loop_mask,
                    pose_cw, self.cam, self._sf_arr,
                    # strict TH_LOW + viewing-angle gate, as the reference's
                    # Scw projection (src/ORBmatcher.cc:518-604,570): a loose
                    # TH_HIGH gate lets repetitive-texture aliases accumulate
                    # 40+ spurious matches and accept a false loop
                    radius=10.0, max_dist=50, check_view_angle=True,
                )
            self._proj_verify = jax.jit(impl)
        # corrected world->camera pose of the current KF
        S_loop_cw = sim3.from_se3(m.kf_pose[loop_kf])
        pose_corr = sim3.to_se3(sim3.compose(S_cl, S_loop_cw))
        loop_mask = np.zeros(m.point_capacity, bool)
        group = [loop_kf] + graph.covis_neighbors(loop_kf, top_k=10)
        kf_mp = np.asarray(m.kf_mp)
        for g in group:
            row = kf_mp[g]
            loop_mask[row[row >= 0]] = True
        res = self._proj_verify(m, jnp.int32(kf), pose_corr,
                                jnp.asarray(loop_mask))
        n = int(np.asarray(res.valid).sum())
        return n >= min_matches, n

    # ------------------------------------------------------------------

    def correct(self, m: MapArrays, graph: MapGraph, kf: int, loop_kf: int,
                S_cl, inliers, pt_a, pt_b, async_gba: bool = True):
        """Loop correction + essential-graph optimization + global BA.

        S_cl: Sim3 mapping loop-KF CAMERA frame to current-KF CAMERA frame.
        Corrected current pose: Scw_corrected = S_cl * S_loop_cw  (:498-style).
        """
        kf_poses = np.asarray(m.kf_pose)
        alive = graph.alive_kfs()

        # corrected Sim3 world->camera for current KF
        S_loop_cw = sim3.from_se3(jnp.asarray(kf_poses[loop_kf]))
        S_corr_cw = sim3.compose(S_cl, S_loop_cw)

        # ---- essential-graph problem over all alive KFs -----------------
        K = m.kf_capacity
        poses_s = np.asarray(sim3.from_se3(jnp.asarray(kf_poses)))
        fixed = np.ones(K, bool)
        fixed[alive] = False
        fixed[loop_kf] = True  # gauge: loop KF holds (reference fixes it, :773)

        ei, ej, rel, w = [], [], [], []
        # spanning-tree + strong covisibility edges from CURRENT estimates
        seen = set()
        for a in alive:
            pa = int(graph.parent[a])
            if pa >= 0 and graph.kf_alive[pa]:
                ei.append(a); ej.append(pa); w.append(1.0)
                rel.append(None)
            for b in graph.covis_neighbors(int(a), min_weight=100):
                if (b, a) not in seen:
                    seen.add((int(a), int(b)))
                    ei.append(int(a)); ej.append(int(b)); w.append(1.0)
                    rel.append(None)
            for b in graph.loop_edges.get(int(a), set()):
                if (b, a) not in seen:
                    seen.add((int(a), int(b)))
                    ei.append(int(a)); ej.append(int(b)); w.append(1.0)
                    rel.append(None)
        # measurements from current (pre-correction) estimates
        ei_a = jnp.asarray(ei, jnp.int32)
        ej_a = jnp.asarray(ej, jnp.int32)
        poses_dev = jnp.asarray(poses_s)
        rels = jax.vmap(edge_measurement)(poses_dev[ei_a], poses_dev[ej_a])

        # the NEW loop edge: measured relative Sim3 from the computed S_cl
        S_kf_cw_corr = S_corr_cw
        loop_rel = edge_measurement(S_kf_cw_corr, sim3.from_se3(jnp.asarray(kf_poses[loop_kf])))
        ei_a = jnp.concatenate([ei_a, jnp.asarray([kf], jnp.int32)])
        ej_a = jnp.concatenate([ej_a, jnp.asarray([loop_kf], jnp.int32)])
        rels = jnp.concatenate([rels, loop_rel[None]])
        w_a = jnp.concatenate([jnp.asarray(w, jnp.float32),
                               jnp.asarray([5.0], jnp.float32)])

        # seed the current KF (and, through optimization, its neighborhood)
        # at the corrected pose
        poses0 = poses_dev.at[kf].set(S_kf_cw_corr)

        prob = PoseGraphProblem(
            poses=poses0, fixed=jnp.asarray(fixed),
            edge_i=ei_a, edge_j=ej_a, edge_rel=rels, edge_w=w_a,
        )
        new_poses_s, c0, c1 = pose_graph_solve(prob, iters=20, cg_iters=50)

        # ---- apply: poses + landmark correction via reference KF ---------
        # each landmark moves with its first-observing keyframe:
        # x' = S_new^-1 * S_old * x   (OptimizeEssentialGraph point correction,
        # src/Optimizer.cc:925-941)
        ref_kf = np.zeros(m.point_capacity, np.int64)
        for pt in graph.points_with_obs():
            if graph.pt_alive[pt]:
                pairs = graph.obs_pairs(pt)
                if pairs:
                    ref_kf[pt] = min(kf for kf, _ in pairs)
        ref_kf_dev = jnp.asarray(ref_kf, jnp.int32)
        S_old = poses_dev[ref_kf_dev]
        S_new = new_poses_s[ref_kf_dev]
        corr = jax.vmap(sim3.compose)(jax.vmap(sim3.inverse)(S_new), S_old)
        new_pts = jax.vmap(sim3.transform)(corr, m.mp_pos)
        new_pts = jnp.where(m.mp_valid[:, None], new_pts, m.mp_pos)

        new_kf_pose = jax.vmap(sim3.to_se3)(new_poses_s)
        m = m._replace(kf_pose=new_kf_pose, mp_pos=new_pts)

        # ---- fuse matched loop landmark pairs (Replace analog, :615-658) --
        # landmark seen in both: keep the loop-KF one (older, better observed)
        inl = inliers
        merged_src, merged_dst = [], []
        for a, b, ok in zip(pt_a, pt_b, inl):
            if not ok:
                continue
            a, b = int(a), int(b)
            if a == b or not graph.pt_alive[a] or not graph.pt_alive[b]:
                continue
            # merge a's observations into b
            for okf, feat in graph.obs_pairs(a):
                if graph.obs_feat_in_kf(b, okf) < 0:
                    graph.add_observation(b, okf, feat, False)
            graph.kill_point(a)
            merged_src.append(a)
            merged_dst.append(b)
        # device-side remap mirrors EXACTLY the pairs the host loop merged
        # (pairs skipped above — self-pairs, dead endpoints — must not
        # touch device state, or host/device maps diverge)
        remap_src = np.asarray(merged_src, np.int32)
        remap_dst = np.asarray(merged_dst, np.int32)
        if len(remap_src):
            lut = jnp.arange(m.point_capacity, dtype=jnp.int32)
            lut = lut.at[remap_src].set(remap_dst)
            kf_mp = m.kf_mp
            kf_mp = jnp.where(kf_mp >= 0, lut[jnp.clip(kf_mp, 0, m.point_capacity - 1)], kf_mp)
            # destinations are host-alive (checked above), so their device
            # mp_valid is already True — no resurrection writes
            mp_valid = m.mp_valid.at[remap_src].set(False)
            m = m._replace(kf_mp=kf_mp, mp_valid=mp_valid)

        # loop edges recorded both ways (:684-685)
        graph.loop_edges.setdefault(kf, set()).add(loop_kf)
        graph.loop_edges.setdefault(loop_kf, set()).add(kf)
        self.last_loop_kf = kf
        self.last_loop_seq = int(graph.kf_seq[kf])
        self.loops_closed += 1

        # ---- global BA: async dispatch (merged at the next keyframe) or
        # synchronous bounded run
        if async_gba:
            pending = self.launch_gba(m, graph)
            return m, {"pg_cost": (float(c0), float(c1)),
                       "gba_pending": pending}
        free = np.zeros(K, bool)
        free[alive] = True
        free[graph.origin_kf] = False
        kf_pose2, pt_pos2, inlier, g0, g1 = self._gba(m, jnp.asarray(free))
        m = m._replace(kf_pose=kf_pose2, mp_pos=pt_pos2)
        return m, {"pg_cost": (float(c0), float(c1)),
                   "gba_cost": (float(g0), float(g1))}

    def _merge_gba_impl(self, m: MapArrays, new_pose, gba_pts,
                        pt_launched, pt_ref_kf):
        """Async-GBA result merge (GlobalBA::_Run merge semantics,
        `/root/reference/src/LoopClosing.cc:393-446`): `new_pose` carries the
        final pose for every keyframe (launched ones: the GBA pose; late
        ones: corrected through the spanning tree on host — see merge_gba);
        points created since launch move with their reference keyframe's
        correction, launched points adopt the GBA positions."""
        new_pose = jnp.where(m.kf_valid[:, None], new_pose, m.kf_pose)
        ref = jnp.clip(pt_ref_kf, 0, m.kf_capacity - 1)
        corr = se3.compose(se3.inverse(new_pose[ref]), m.kf_pose[ref])
        moved = se3.transform(corr, m.mp_pos)
        new_pts = jnp.where(pt_launched[:, None], gba_pts, moved)
        new_pts = jnp.where(m.mp_valid[:, None], new_pts, m.mp_pos)
        return m._replace(kf_pose=new_pose, mp_pos=new_pts)

    def launch_gba(self, m: MapArrays, graph: MapGraph):
        """Dispatch global BA asynchronously (device compute overlaps the
        frames tracked until the merge — the reference's detached GBA
        thread, `src/LoopClosing.cc:309-347`). Returns a pending handle."""
        K = m.kf_capacity
        alive = graph.alive_kfs()
        free = np.zeros(K, bool)
        free[alive] = True
        free[graph.origin_kf] = False
        kf_pose2, pt_pos2, inlier, g0, g1 = self._gba(m, jnp.asarray(free))
        kf_launched = np.zeros(K, bool)
        kf_launched[alive] = True
        pt_launched = np.zeros(m.point_capacity, bool)
        pt_launched[graph.alive_points()] = True
        return {
            "gba_pose": kf_pose2, "gba_pts": pt_pos2,
            "kf_launched": kf_launched, "pt_launched": pt_launched,
            "costs": (g0, g1),
        }

    def merge_gba(self, m: MapArrays, graph: MapGraph, pending):
        """Apply a pending GBA result to the (possibly grown) map.

        Late keyframes (created since launch) correct through the spanning
        tree RELATIVE TO THE PARENT'S POSE AT MERGE TIME — the reference
        records TcwBefGBA during the merge walk, not at launch
        (`src/LoopClosing.cc:393-446`). Using the launch snapshot here was
        measurably wrong: the window BA that runs between launch and merge
        moves the parent, and a child corrected against the stale snapshot
        lands offset by exactly that motion (0.3 m on the organic-loop
        circuit — the post-loop keyframe chain sat 0.55 m off). The walk
        runs host-side in creation order so late-parent chains cascade
        correctly (a rare, few-KF event)."""
        if not hasattr(self, "_merge_gba"):
            self._merge_gba = jax.jit(self._merge_gba_impl)
        from .system import _np_compose, _np_inverse

        cur = np.asarray(m.kf_pose)  # rare event: one fetch
        gba = np.asarray(pending["gba_pose"])
        kl = pending["kf_launched"]
        new_pose = np.where(kl[:, None], gba, cur).astype(np.float32)
        late = sorted((int(k) for k in graph.alive_kfs() if not kl[k]),
                      key=lambda k: graph.kf_seq[k])
        for k in late:
            p = graph.parent[k]
            p = int(p) if p >= 0 else graph.origin_kf
            rel = _np_compose(cur[k], _np_inverse(cur[p]))
            new_pose[k] = _np_compose(rel, new_pose[p])
        pt_ref = np.zeros(m.point_capacity, np.int32)
        kf_seq = graph.kf_seq
        for pt in graph.points_with_obs():
            pairs = graph.obs_pairs(pt)
            if pairs:
                # earliest observer BY CREATION SEQUENCE (slot index is not
                # a temporal order once slots recycle)
                pt_ref[pt] = min((kf for kf, _ in pairs),
                                 key=lambda k: kf_seq[k])
        m = self._merge_gba(
            m, jnp.asarray(new_pose), pending["gba_pts"],
            jnp.asarray(pending["pt_launched"]), jnp.asarray(pt_ref),
        )
        g0, g1 = float(pending["costs"][0]), float(pending["costs"][1])
        return m, {"gba_cost": (g0, g1)}

    def _gba_impl(self, m: MapArrays, free_mask):
        from ..optim.ba import problem_from_map

        prob = problem_from_map(m, free_mask, self.inv_sigma2)
        res = ba_solve(prob, self.cam, iters=self.gba_iters,
                       cg_iters=self.gba_cg_iters, lambda0=1e-3)
        return res.kf_pose, res.pt_pos, res.obs_inlier, res.initial_cost, res.final_cost
