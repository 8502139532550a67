"""Tests for the BoW vocabulary/database and RANSAC solvers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orb_slam2_refactored_tpu.geometry import projection, se3, sim3
from orb_slam2_refactored_tpu.slam.vocabulary import (
    KeyFrameDatabase, train_vocabulary, transform,
)
from orb_slam2_refactored_tpu.solvers.ransac import (
    horn_ransac, p6p_ransac, pnp_ransac,
)


def rand_desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def perturb_desc(rng, desc, n_bits=12):
    out = desc.copy()
    for i in range(len(out)):
        for _ in range(n_bits):
            w = rng.integers(0, 8)
            out[i, w] ^= np.uint32(1) << np.uint32(rng.integers(0, 32))
    return out


class TestVocabulary:
    def test_transform_normalized(self):
        rng = np.random.default_rng(0)
        voc = train_vocabulary(rand_desc(rng, 512), n_words=64, iters=4)
        desc = jnp.asarray(rand_desc(rng, 100))
        v, words = transform(voc, desc, jnp.ones(100, bool))
        assert abs(float(v.sum()) - 1.0) < 1e-5
        assert words.shape == (100,)

    def test_place_recognition(self):
        """A revisited place must out-score unrelated places."""
        rng = np.random.default_rng(1)
        base = rand_desc(rng, 800)
        voc = train_vocabulary(base, n_words=128, iters=4)
        db = KeyFrameDatabase(voc, kf_capacity=16)

        place_descs = [base[i * 150 : i * 150 + 120] for i in range(5)]
        for k, d in enumerate(place_descs):
            v, _ = db.compute_bow(jnp.asarray(d), jnp.ones(len(d), bool))
            db.add(k, v)
        # query = noisy revisit of place 2
        q = perturb_desc(rng, place_descs[2])
        qv, _ = db.compute_bow(jnp.asarray(q), jnp.ones(len(q), bool))
        scores = db.scores_against_all(qv)
        assert scores.argmax() == 2
        cands = db.detect_candidates(qv, exclude=set(), min_score=0.05)
        assert cands and cands[0] == 2

    def test_exclude_set(self):
        rng = np.random.default_rng(2)
        voc = train_vocabulary(rand_desc(rng, 400), n_words=64, iters=3)
        db = KeyFrameDatabase(voc, kf_capacity=8)
        d = rand_desc(rng, 80)
        v, _ = db.compute_bow(jnp.asarray(d), jnp.ones(80, bool))
        db.add(0, v)
        db.add(1, v)
        cands = db.detect_candidates(v, exclude={0}, min_score=0.01)
        assert 0 not in cands and 1 in cands


class TestHornRansac:
    def test_recovers_sim3(self):
        rng = np.random.default_rng(3)
        src = rng.uniform(-2, 2, (80, 3)).astype(np.float32)
        g = sim3.make(
            se3.quat_normalize(jnp.asarray([0.9, 0.1, -0.2, 0.15])),
            jnp.asarray([0.5, -0.3, 1.0]), jnp.asarray(1.4),
        )
        dst = np.array(sim3.transform(g, jnp.asarray(src)))
        dst += rng.normal(0, 0.005, dst.shape)
        out = rng.choice(80, 16, replace=False)
        dst[out] += rng.uniform(0.5, 2.0, (16, 3))
        res = horn_ransac(
            jnp.asarray(src), jnp.asarray(dst), jnp.ones(80, bool),
            jax.random.PRNGKey(0), with_scale=True, inlier_th=0.01,
        )
        assert bool(res.success)
        assert abs(float(res.scale) - 1.4) < 0.02
        err = np.asarray(se3.boxminus(res.pose, g[:7]))
        assert np.linalg.norm(err[:3]) < 0.02
        inl = np.asarray(res.inliers)
        assert not inl[out].any()

    def test_fixed_scale(self):
        rng = np.random.default_rng(4)
        src = rng.uniform(-2, 2, (60, 3)).astype(np.float32)
        p = se3.exp(jnp.asarray(np.array([0.1, -0.2, 0.05, 0.3, 0.1, -0.2], np.float32)))
        dst = np.asarray(se3.transform(p, jnp.asarray(src)))
        res = horn_ransac(
            jnp.asarray(src), jnp.asarray(dst), jnp.ones(60, bool),
            jax.random.PRNGKey(1), with_scale=False, inlier_th=0.01,
        )
        assert bool(res.success)
        assert float(res.scale) == 1.0
        err = np.asarray(se3.boxminus(res.pose, p))
        assert np.linalg.norm(err) < 0.01


class TestP6P:
    def test_resection_with_outliers(self):
        rng = np.random.default_rng(5)
        cam = projection.CameraIntrinsics.create(400.0, 400.0, 160.0, 120.0)
        pts = np.stack(
            [rng.uniform(-2, 2, 100), rng.uniform(-1.5, 1.5, 100), rng.uniform(3, 8, 100)],
            -1,
        ).astype(np.float32)
        pose = se3.exp(jnp.asarray(np.array([0.05, -0.1, 0.02, 0.2, 0.1, -0.3], np.float32)))
        uv = np.array(projection.project_world(cam, pose, jnp.asarray(pts))[0])
        uv += rng.normal(0, 0.5, uv.shape)
        out = rng.choice(100, 20, replace=False)
        uv[out] += rng.uniform(30, 80, (20, 2)) * rng.choice([-1, 1], (20, 2))
        res = p6p_ransac(
            jnp.asarray(pts), jnp.asarray(uv, jnp.float32), jnp.ones(100, bool),
            cam, jax.random.PRNGKey(2),
        )
        assert bool(res.success)
        err = np.asarray(se3.boxminus(res.pose, pose))
        assert np.linalg.norm(err) < 0.02
        assert int(res.n_inliers) > 60


def _one_wall_problem(seed=7):
    """All visible landmarks on ONE plane (a wall at z=5 tilted 20 deg) —
    the geometry that defeats a pure DLT resection (2-D nullspace) and that
    the reference's EPnP survives (`src/PnPsolver.cc:375-568`). A mono
    kidnap in front of a wall must relocalize through this."""
    rng = np.random.default_rng(seed)
    cam = projection.CameraIntrinsics.create(400.0, 400.0, 160.0, 120.0)
    n = 120
    uvp = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-1.8, 1.8, n)], -1)
    nrm = np.array([np.sin(0.35), 0.0, -np.cos(0.35)])
    u_ax = np.array([np.cos(0.35), 0.0, np.sin(0.35)])
    v_ax = np.array([0.0, 1.0, 0.0])
    pts = (np.array([0.3, 0.1, 5.0])[None]
           + uvp[:, :1] * u_ax[None] + uvp[:, 1:] * v_ax[None]).astype(np.float32)
    pose = se3.exp(jnp.asarray(
        np.array([0.08, -0.12, 0.03, 0.3, -0.1, 0.2], np.float32)))
    uv = np.array(projection.project_world(cam, pose, jnp.asarray(pts))[0])
    uv += rng.normal(0, 0.4, uv.shape)
    out = rng.choice(n, 20, replace=False)
    uv[out] += rng.uniform(30, 80, (20, 2)) * rng.choice([-1, 1], (20, 2))
    return cam, pts, uv.astype(np.float32), pose


class TestPlanarPnP:
    def test_one_wall_pnp_succeeds(self):
        """pnp_ransac recovers the pose from a purely coplanar landmark set
       ."""
        cam, pts, uv, pose = _one_wall_problem()
        res = pnp_ransac(jnp.asarray(pts), jnp.asarray(uv),
                         jnp.ones(len(pts), bool), cam, jax.random.PRNGKey(3))
        assert bool(res.success)
        err = np.asarray(se3.boxminus(res.pose, pose))
        assert np.linalg.norm(err) < 0.03, err
        assert int(res.n_inliers) > 70

    def test_one_wall_dlt_fails(self):
        """The DLT-only solver does NOT recover the coplanar pose — the
        degeneracy pnp_ransac exists to fix. (If this ever starts passing,
        the planar family is redundant; revisit.)"""
        cam, pts, uv, pose = _one_wall_problem()
        res = p6p_ransac(jnp.asarray(pts), jnp.asarray(uv),
                         jnp.ones(len(pts), bool), cam, jax.random.PRNGKey(3))
        err = np.linalg.norm(np.asarray(se3.boxminus(res.pose, pose)))
        assert (not bool(res.success)) or err > 0.03

    def test_general_structure_unharmed(self):
        """On general (non-planar) structure the hybrid matches the DLT
        solver's accuracy — the planar family only adds hypotheses."""
        rng = np.random.default_rng(11)
        cam = projection.CameraIntrinsics.create(400.0, 400.0, 160.0, 120.0)
        pts = np.stack(
            [rng.uniform(-2, 2, 100), rng.uniform(-1.5, 1.5, 100),
             rng.uniform(3, 8, 100)], -1).astype(np.float32)
        pose = se3.exp(jnp.asarray(
            np.array([0.05, -0.1, 0.02, 0.2, 0.1, -0.3], np.float32)))
        uv = np.array(projection.project_world(cam, pose, jnp.asarray(pts))[0])
        uv += rng.normal(0, 0.5, uv.shape)
        res = pnp_ransac(jnp.asarray(pts), jnp.asarray(uv, jnp.float32),
                         jnp.ones(100, bool), cam, jax.random.PRNGKey(2))
        assert bool(res.success)
        err = np.asarray(se3.boxminus(res.pose, pose))
        assert np.linalg.norm(err) < 0.02
        assert int(res.n_inliers) > 80


class _StubGraph:
    """Minimal MapGraph stand-in for detection-policy boundary tests."""

    def __init__(self, neighbors=None, kf_seq=None, alive=None):
        self.neighbors = neighbors or {}
        self.kf_seq = kf_seq or {}
        self._alive = alive if alive is not None else list(range(16))

    def covis_neighbors(self, kf, top_k=10):
        return list(self.neighbors.get(kf, []))[:top_k]

    def alive_kfs(self):
        return list(self._alive)


class TestDetectionPolicyBoundaries:
    """Boundary semantics of the retrieval policy:
    the min-score floor, the 0.8 shared-word gate and the 0.75 group
    retention are all >=-inclusive gates; the floor deviation
    (`max(min_covis * 0.8, 0.02)`, documented in loop_closing.py) is
    pinned here so a silent policy change fails a test."""

    def _cands(self, s, cw, min_score, graph=None, exclude=()):
        from orb_slam2_refactored_tpu.slam.vocabulary import KeyFrameDatabase
        g = graph or _StubGraph()
        return KeyFrameDatabase.candidates_from_scores(
            None, np.asarray(s, np.float64), np.asarray(cw, np.int64),
            set(exclude), min_score, g)

    def test_min_score_boundary_inclusive(self):
        # score EXACTLY at the floor is admitted (s >= min_score); just
        # below is not (reference: minScore gate, KeyFrameDatabase.cc:96)
        assert self._cands([0.30, 0.2999], [5, 5], 0.30) == [0]
        assert self._cands([0.30, 0.30], [5, 5], 0.30) == [0, 1]

    def test_shared_word_gate_boundary(self):
        # min_common = int(0.8 * max_common): cw == that bound passes,
        # one word fewer fails (KeyFrameDatabase.cc:87-95)
        out = self._cands([0.50, 0.45, 0.44], [10, 8, 7], 0.1)
        assert out == [0, 1]

    def test_group_retention_075_boundary(self):
        # group accumulated score >= 0.75 * best is kept; below dropped.
        # kf0's group = {0, 3}: acc = 0.5 + 0.5 = 1.0; kf1 is a singleton
        g = _StubGraph(neighbors={0: [3]})
        out_drop = self._cands([0.5, 0.74, -1.0, 0.5], [8, 8, 0, 8], 0.1, g)
        out_keep = self._cands([0.5, 0.76, -1.0, 0.5], [8, 8, 0, 8], 0.1, g)
        # best group acc = 1.0 -> th = 0.75; the group's best-scoring kf
        # represents it (here 0 and 3 tie at 0.5; max() picks first)
        assert 1 not in out_drop
        assert 1 in out_keep

    def test_group_reported_by_best_member(self):
        # the returned keyframe is the best-scoring member of the kept
        # group, which can be a NEIGHBOR of the retrieved candidate
        g = _StubGraph(neighbors={0: [2]})
        out = self._cands([0.4, -1.0, 0.9, -1.0], [8, 0, 0, 0], 0.1, g)
        assert out == [2]

    def _closer(self):
        from orb_slam2_refactored_tpu.geometry.projection import (
            CameraIntrinsics,
        )
        from orb_slam2_refactored_tpu.slam.loop_closing import LoopCloser
        rng = np.random.default_rng(5)
        voc = train_vocabulary(rand_desc(rng, 256), n_words=32, iters=2)
        cam = CameraIntrinsics.create(200.0, 200.0, 160.0, 120.0)
        return LoopCloser(voc, cam, kf_capacity=32, n_levels=4)

    def test_floor_formula_relax_and_absolute(self):
        """The documented deviation: floor = max(0.8 * min covisible
        score, 0.02); unindexed covisibles (score < 0) are ignored."""
        lc = self._closer()
        g = _StubGraph(
            neighbors={8: [1, 2, 3]},
            kf_seq={8: 100}, alive=list(range(12)),
        )
        lc.last_loop_seq = 0
        seen = {}

        def capture(s, cw, exclude, min_score, graph, max_candidates=10):
            seen["floor"] = min_score
            return []

        lc.db.candidates_from_scores = capture
        scores = np.zeros(32)
        scores[1], scores[2], scores[3] = 0.5, 0.10, -1.0  # 3 not indexed
        common = np.full(32, 4)
        lc._detect_policy(g, 8, scores.copy(), common.copy())
        assert seen["floor"] == pytest.approx(0.8 * 0.10)
        scores[2] = 0.01  # 0.8*0.01 < absolute floor 0.02
        lc._detect_policy(g, 8, scores.copy(), common.copy())
        assert seen["floor"] == pytest.approx(0.02)

    def test_min_consistency_escalation(self):
        """A candidate group must recur MIN_CONSISTENCY=3 times before a
        loop fires (src/LoopClosing.cc:60,164-241)."""
        lc = self._closer()
        g = _StubGraph(
            neighbors={8: [], 0: [1]},
            kf_seq={8: 100}, alive=list(range(12)),
        )
        lc.last_loop_seq = 0
        lc.db.candidates_from_scores = (
            lambda s, cw, exclude, min_score, graph, max_candidates=10: [0])
        scores = np.full(32, 0.001)
        common = np.full(32, 4)
        fired = [lc._detect_policy(g, 8, scores.copy(), common.copy())
                 for _ in range(4)]
        assert fired[:3] == [None, None, None]
        assert fired[3] == 0
