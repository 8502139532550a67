"""Vocabulary hygiene at scale: multi-view training, idf refit, chunked
quantization for huge vocabularies, grouped loop-candidate scoring, and
place-recognition recall at >=2048 words.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orb_slam2_refactored_tpu.slam.vocabulary import (
    KeyFrameDatabase, Vocabulary, load_dbow2_text, quantize, save_dbow2_text,
    train_vocabulary, word_counts,
)


def rand_desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


class TestChunkedQuantize:
    def test_matches_direct_argmin(self, tmp_path):
        """quantize() must give identical word ids through the chunked path
        (W > 65536) as the direct [N,W] argmin computes for the same data."""
        rng = np.random.default_rng(0)
        W = (1 << 16) + 4096
        words = rand_desc(rng, W)
        desc = jnp.asarray(rand_desc(rng, 64))
        voc_big = Vocabulary(words=jnp.asarray(words),
                             idf=jnp.ones((W,), jnp.float32))
        got = np.asarray(quantize(voc_big, desc))

        # direct reference on the same data, done in manageable slabs
        from orb_slam2_refactored_tpu.ops import hamming
        best_d = np.full(64, 10_000, np.int64)
        best_i = np.zeros(64, np.int64)
        for s in range(0, W, 16384):
            d = np.asarray(hamming.hamming_matrix(
                desc, jnp.asarray(words[s:s + 16384])))
            i = d.argmin(1)
            dm = d.min(1)
            # strict < keeps the FIRST best word, matching argmin semantics
            take = dm < best_d
            best_d[take] = dm[take]
            best_i[take] = i[take] + s
        np.testing.assert_array_equal(got, best_i)

    def test_large_text_vocab_roundtrip(self, tmp_path):
        """A >64k-word DBoW2-format text file loads and quantizes through
        the chunked path (streaming parse, no [N,W] blowup)."""
        rng = np.random.default_rng(1)
        W = (1 << 16) + 512
        voc = Vocabulary(words=jnp.asarray(rand_desc(rng, W)),
                         idf=jnp.ones((W,), jnp.float32))
        path = str(tmp_path / "bigvoc.txt")
        save_dbow2_text(voc, path)
        voc2 = load_dbow2_text(path)
        assert voc2.n_words == W
        q = jnp.asarray(rand_desc(rng, 32))
        np.testing.assert_array_equal(
            np.asarray(quantize(voc, q)), np.asarray(quantize(voc2, q))
        )


class TestIdfRefit:
    def test_refit_downweights_ubiquitous_words(self):
        rng = np.random.default_rng(2)
        voc = train_vocabulary(rand_desc(rng, 512), n_words=64, iters=3)
        db = KeyFrameDatabase(voc, kf_capacity=8)
        # word 0's centroid descriptor appears in EVERY keyframe
        common = np.asarray(voc.words[0])[None].repeat(20, 0)
        for k in range(6):
            d = np.concatenate([common, rand_desc(rng, 60)])
            v, _ = db.compute_bow(jnp.asarray(d), jnp.ones(len(d), bool))
            db.add(k, v)
        db.refit_idf()
        idf = np.asarray(db.idf)
        w0 = int(np.asarray(quantize(voc, jnp.asarray(common[:1])))[0])
        assert idf[w0] <= idf.mean(), "ubiquitous word must be downweighted"


class TestGroupedCandidates:
    def test_covis_group_accumulation(self):
        """A place represented by a GROUP of covisible keyframes must beat a
        single isolated keyframe with a slightly higher individual score
        (DetectLoopCandidates accumulation, src/KeyFrameDatabase.cc:119-152)."""
        from orb_slam2_refactored_tpu.slam.map_state import MapCapacity, MapGraph

        rng = np.random.default_rng(3)
        base = rand_desc(rng, 600)
        voc = train_vocabulary(base, n_words=128, iters=3)
        db = KeyFrameDatabase(voc, kf_capacity=8)
        g = MapGraph(MapCapacity(max_keyframes=8, max_points=64, max_features=8))
        place = base[:120]
        for k in (0, 1, 2):  # covisible group showing the same place
            sel = rng.choice(120, 90, replace=False)
            v, _ = db.compute_bow(jnp.asarray(place[sel]), jnp.ones(90, bool))
            db.add(k, v)
            g.kf_alive[k] = True
        g.set_covis(0, 1, 30)
        g.set_covis(1, 2, 30)
        g.set_covis(0, 2, 30)
        v, _ = db.compute_bow(jnp.asarray(base[200:290]), jnp.ones(90, bool))
        db.add(3, v)  # unrelated isolated KF
        g.kf_alive[3] = True

        q, _ = db.compute_bow(jnp.asarray(place[:90]), jnp.ones(90, bool))
        cands = db.detect_candidates_grouped(q, exclude=set(), min_score=0.01,
                                             graph=g)
        assert cands and cands[0] in (0, 1, 2)
        assert 3 not in cands


class TestRecallAtScale:
    def test_place_recall_2048_words(self):
        """Render 12 distinct-texture views, train a 2048-word vocabulary on
        4 of them, index all, and require >=80% top-1 recall for noisy
        revisits."""
        from orb_slam2_refactored_tpu.io.synthetic import (
            SyntheticScene, box_room, orbit_trajectory,
        )
        from orb_slam2_refactored_tpu.ops.orb import OrbExtractor

        planes = box_room(half_x=1.6, half_y=1.3, z_far=2.6, z_near=-2.6,
                          distinct_textures=True)
        scene = SyntheticScene(width=320, height=240, fx=260.0, fy=260.0,
                               planes=planes)
        ex = OrbExtractor(240, 320, n_features=900, n_levels=4)
        poses = orbit_trajectory(20, radius=0.6, yaw_amp=2.2)  # wide sweep
        views = []
        for i in range(20):
            img, _ = scene.render(poses[i])
            f = ex(jnp.asarray(img))
            views.append((np.asarray(f.desc), np.asarray(f.valid)))

        # train over the whole corpus (the reference's ORBvoc trains on an
        # external corpus; live training pools every view)
        train_pool = np.concatenate([d[v] for d, v in views])
        assert len(train_pool) >= 2048, f"pool too small: {len(train_pool)}" 
        voc = train_vocabulary(train_pool, n_words=2048, iters=5)
        assert voc.n_words == 2048
        db = KeyFrameDatabase(voc, kf_capacity=24)
        for k, (d, v) in enumerate(views):
            vec, _ = db.compute_bow(jnp.asarray(d), jnp.asarray(v))
            db.add(k, vec)
        db.refit_idf()

        # noisy revisits: same poses, perturbed camera
        hits = 0
        for i in range(20):
            jitter = poses[i].copy()
            jitter[4:7] += np.random.default_rng(i).normal(0, 0.015, 3)
            img, _ = scene.render(jitter)
            f = ex(jnp.asarray(img))
            vec, _ = db.compute_bow(f.desc, f.valid)
            s = db.scores_against_all(vec)
            # neighbors on the sweep see nearly the same wall: top-1 within
            # +-1 view counts as a correct retrieval
            if abs(int(s.argmax()) - i) <= 1:
                hits += 1
        print(f"top-1(+-1) recall: {hits}/20")
        assert hits >= 16
