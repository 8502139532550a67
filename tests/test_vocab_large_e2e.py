"""Large-vocabulary END-TO-END loop closure.

The reference engine always runs with the ~1M-word ORBvoc.txt
(`/root/reference/src/System.cc:343`); the live tracker here had only ever run
with a 512-1024-word live-trained vocabulary. This test injects a >=100k-word
vocabulary (built from real scene descriptors + bit-flip augmentation — the
same "leaf words are descriptor prototypes" structure a DBoW2 tree bottoms
out at) via `Tracker.set_vocabulary`, runs the organic loop circuit through
the chunked quantize path (W > 65536 never materializes an [N, W] matrix,
vocabulary.quantize), and checks:

- loop detection still fires organically and the corrected ATE is tight
  (at 100k+ words the aliasing that plagues tiny vocabularies is gone);
- per-keyframe BoW cost is bounded (recorded to stdout for the perf log).
"""

import time

import numpy as np
import jax.numpy as jnp
import pytest

from orb_slam2_refactored_tpu.io.evaluation import ate_rmse
from orb_slam2_refactored_tpu.io.synthetic import SyntheticScene, box_room
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity
from orb_slam2_refactored_tpu.slam.system import corrected_frame_poses
from orb_slam2_refactored_tpu.slam.tracking import Tracker, TrackerConfig
from orb_slam2_refactored_tpu.slam.vocabulary import Vocabulary

from test_organic_loop import circuit_trajectory

W_TARGET = 100_000


def build_big_vocab(frames, cfg) -> Vocabulary:
    """>=100k words from real corpus descriptors + bit-flip augmentation.

    A throwaway tracker's extractor pulls ORB descriptors from a handful of
    views; each seed descriptor spawns variants with a few random bits
    flipped — prototypes densely covering the descriptor manifold near the
    corpus, exactly what the deep leaves of a k^L DBoW2 tree are."""
    t = Tracker(cfg)
    descs = []
    for img, depth in frames[:: max(1, len(frames) // 8)][:8]:
        fr = t._prepare(jnp.asarray(img, jnp.float32),
                        jnp.asarray(depth, jnp.float32))
        d = np.asarray(fr.desc)[np.asarray(fr.valid)]
        descs.append(d)
    seed_desc = np.unique(np.concatenate(descs), axis=0)
    rng = np.random.default_rng(7)
    reps = -(-W_TARGET // len(seed_desc))  # ceil
    out = [seed_desc]
    for r in range(1, reps + 1):
        v = seed_desc.copy()
        # flip 2-10 random bits per word
        for _ in range(2 + 2 * (r % 5)):
            bit = rng.integers(0, 256, size=len(v))
            v[np.arange(len(v)), bit // 32] ^= (
                np.uint32(1) << (bit % 32).astype(np.uint32)
            )
        out.append(v)
    words = np.unique(np.concatenate(out), axis=0)
    assert len(words) >= W_TARGET, len(words)
    return Vocabulary(words=jnp.asarray(words),
                      idf=jnp.ones((len(words),), jnp.float32))


@pytest.fixture(scope="module")
def circuit():
    planes = box_room(half_x=1.7, half_y=1.3, z_far=2.7, z_near=-2.7,
                      distinct_textures=True)
    scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                           planes=planes)
    n = 170
    gt = circuit_trajectory(n)
    rng = np.random.default_rng(23)
    frames = []
    for i in range(n):
        img, depth = scene.render(gt[i])
        depth = depth * (1 + rng.normal(0, 0.02, depth.shape).astype(np.float32))
        frames.append((img, depth))
    return frames, gt


class TestLargeVocabE2E:
    def test_loop_circuit_with_100k_words(self, circuit):
        frames, gt = circuit
        cfg = TrackerConfig(
            width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
            bf=0.08 * 260.0, n_features=600, n_levels=4,
            enable_loop_closing=True,
            kf_max_interval=8,
            local_map_window=10,
            map_capacity=MapCapacity(max_keyframes=96, max_points=16384,
                                     max_features=600),
        )
        voc = build_big_vocab(frames, cfg)
        W = voc.n_words
        assert W >= W_TARGET
        print(f"[vocab-large] {W} words")

        tracker = Tracker(cfg)
        tracker.set_vocabulary(voc)
        for i, (img, depth) in enumerate(frames):
            tracker.track_rgbd(img, depth, timestamp=i / 30.0)
        tracker.flush()
        assert tracker.state == 1, tracker.track_info[-3:]

        lc = tracker.loop_closer
        assert lc is not None
        assert lc.db.voc.n_words == W, "tracker must run the injected vocab"
        n_loops = lc.loops_closed
        print(f"[vocab-large] loops closed: {n_loops}, "
              f"info: {tracker.last_loop_info}")
        assert n_loops >= 1, "loop must fire with the large vocabulary"

        est = corrected_frame_poses(tracker)
        rmse, _ = ate_rmse(est, gt, align="se3")
        print(f"[vocab-large] corrected ATE {rmse:.4f} m")
        assert rmse < 0.06

        # per-KF BoW cost through the chunked quantize path (W > 65536):
        # one warm timing, median of 5
        kf = int(tracker.graph.alive_kfs()[0])
        d, v = tracker.map.kf_desc[kf], tracker.map.kf_feat_valid[kf]
        lc.db.compute_bow(d, v)[0][0].block_until_ready()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            lc.db.compute_bow(d, v)[0][0].block_until_ready()
            ts.append(time.perf_counter() - t0)
        per_kf = float(np.median(ts))
        print(f"[vocab-large] per-KF BoW cost (W={W}): {per_kf*1e3:.1f} ms")
        assert per_kf < 5.0, "chunked quantize must stay bounded"


class TestOrbvocScaleDatabase:
    """ORBvoc-scale place recognition: the reference ships a
    ~1M-word vocabulary (`/root/reference/build.sh:22-24` untars ORBvoc.txt);
    the database must quantize, index, refit idf, and retrieve at that scale
    without a dense [KF, W] matrix (2 GB at KF_cap=512)."""

    W_BIG = 1_000_000

    def test_quantize_index_retrieve_1m_words(self):
        from orb_slam2_refactored_tpu.slam.vocabulary import (
            KeyFrameDatabase, quantize,
        )

        rng = np.random.default_rng(3)
        W = self.W_BIG
        words = np.unique(
            rng.integers(0, 2**32, (W + 2048, 8), np.uint32), axis=0)[:W]
        voc = Vocabulary(words=jnp.asarray(words),
                         idf=jnp.ones((W,), jnp.float32))

        # two "places": descriptor pools drawn AS vocabulary words with a
        # couple of bit flips (what real corpus descriptors look like to
        # their nearest leaves)
        def place_pool(seed, n=96):
            r = np.random.default_rng(seed)
            base = words[r.integers(0, W, n)].copy()
            bit = r.integers(0, 256, n)
            base[np.arange(n), bit // 32] ^= (
                np.uint32(1) << (bit % 32).astype(np.uint32))
            return base

        pool_a, pool_b = place_pool(10), place_pool(20)

        # chunked quantize at W=1M: never materializes [N, W]
        wa = np.asarray(quantize(voc, jnp.asarray(pool_a)))
        wb = np.asarray(quantize(voc, jnp.asarray(pool_b)))
        assert wa.shape == (96,) and wa.max() < W

        KF_CAP = 512
        db = KeyFrameDatabase(voc, KF_CAP, row_capacity=128)
        # index rows straight from quantized words (sparse-row format)
        def row_of(word_ids, jitter_seed):
            r = np.random.default_rng(jitter_seed)
            sel = r.choice(len(word_ids), 80, replace=False)
            ids = np.full(128, W, np.int32)
            cnt = np.zeros(128, np.float32)
            uniq, c = np.unique(word_ids[sel], return_counts=True)
            ids[: len(uniq)] = uniq
            cnt[: len(uniq)] = c
            return jnp.asarray(ids), jnp.asarray(cnt)

        for k in range(10):
            db.add(k, row_of(wa if k < 5 else wb, 100 + k))
        db.refit_idf()

        # sparse index memory stays bounded (the dense design would be 2 GB)
        nbytes = (db.bow_ids.size * 4 + db.bow_cnt.size * 4
                  + np.asarray(db.idf).size * 4)
        assert nbytes < 64e6, f"index unexpectedly large: {nbytes/1e6:.0f} MB"

        # retrieval: an A-query must rank A-rows above B-rows, exactly
        qs = db._score_common(row_of(wa, 999))[0]
        assert qs[:5].min() > qs[5:10].max() + 0.05, qs[:10]
        # and a B-query the reverse
        qs = db._score_common(row_of(wb, 998))[0]
        assert qs[5:10].min() > qs[:5].max() + 0.05, qs[:10]

    def test_sparse_scoring_matches_dense_reference(self):
        """The sparse gather scoring must equal the dense weighted-L1 it
        replaces, bit-for-bit in semantics (small W so the dense form is
        computable)."""
        from orb_slam2_refactored_tpu.slam.vocabulary import KeyFrameDatabase

        rng = np.random.default_rng(0)
        W, T, K = 512, 64, 8
        words = rng.integers(0, 2**32, (W, 8), np.uint32)
        voc = Vocabulary(words=jnp.asarray(words),
                         idf=jnp.asarray(rng.uniform(0.2, 1.0, W), jnp.float32))
        db = KeyFrameDatabase(voc, K, row_capacity=T)

        dense_rows = np.zeros((K, W), np.float32)
        for k in range(K):
            ids = rng.choice(W, 40, replace=False).astype(np.int32)
            cnt = rng.integers(1, 4, 40).astype(np.float32)
            dense_rows[k, ids] = cnt
            row_ids = np.full(T, W, np.int32)
            row_cnt = np.zeros(T, np.float32)
            row_ids[:40] = ids
            row_cnt[:40] = cnt
            db.add(k, (jnp.asarray(row_ids), jnp.asarray(row_cnt)))

        q_ids = rng.choice(W, 30, replace=False).astype(np.int32)
        q_cnt = rng.integers(1, 4, 30).astype(np.float32)
        qi = np.full(T, W, np.int32)
        qc = np.zeros(T, np.float32)
        qi[:30] = q_ids
        qc[:30] = q_cnt
        s_sparse, cw_sparse = db.score_query((jnp.asarray(qi), jnp.asarray(qc)))

        idf = np.asarray(db.idf)
        q_dense = np.zeros(W, np.float32)
        q_dense[q_ids] = q_cnt
        wq = q_dense * idf
        wq /= wq.sum()
        wk = dense_rows * idf[None, :]
        wk /= np.maximum(wk.sum(-1, keepdims=True), 1e-9)
        s_dense = 2.0 * np.minimum(wk, wq[None, :]).sum(-1)
        cw_dense = ((dense_rows > 0) & (q_dense > 0)[None, :]).sum(-1)
        np.testing.assert_allclose(np.asarray(s_sparse), s_dense,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(cw_sparse), cw_dense)
