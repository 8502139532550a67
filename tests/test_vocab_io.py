"""DBoW2 text vocabulary round-trip tests."""

import numpy as np

from orb_slam2_refactored_tpu.slam.vocabulary import (
    Vocabulary, load_dbow2_text, save_dbow2_text, save_dbow2_tree,
    train_vocabulary, transform,
)

import jax.numpy as jnp


class TestVocabIO:
    def test_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        desc = rng.integers(0, 2**32, (400, 8), dtype=np.uint32)
        voc = train_vocabulary(desc, n_words=64, iters=3)
        p = tmp_path / "voc.txt"
        save_dbow2_text(voc, str(p))
        voc2 = load_dbow2_text(str(p))
        np.testing.assert_array_equal(np.asarray(voc.words), np.asarray(voc2.words))
        q = jnp.asarray(desc[:50])
        v1, w1 = transform(voc, q, jnp.ones(50, bool))
        v2, w2 = transform(voc2, q, jnp.ones(50, bool))
        np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))

    def test_loads_tree_format(self, tmp_path):
        """Internal (non-leaf) nodes must be skipped like the reference's
        tree walk effectively does for word lookup."""
        rng = np.random.default_rng(1)
        p = tmp_path / "tree_voc.txt"
        with open(p, "w") as f:
            f.write("2 2 0 0\n")
            # internal node
            bytes0 = " ".join(str(int(x)) for x in rng.integers(0, 256, 32))
            f.write(f"0 0 {bytes0} 0\n")
            # two leaves
            for _ in range(2):
                b = " ".join(str(int(x)) for x in rng.integers(0, 256, 32))
                f.write(f"1 1 {b} 0.5\n")
        voc = load_dbow2_text(str(p))
        assert voc.n_words == 2

    def test_tree_export_k10(self, tmp_path):
        """save_dbow2_tree writes a REAL k-ary hierarchy:
        k=10 header, depth > 1, parents precede children, every leaf is an
        original word with its idf weight, and our own loader recovers the
        exact word set."""
        rng = np.random.default_rng(2)
        W = 3000
        words = np.unique(
            rng.integers(0, 2**32, (W + 64, 8), np.uint32), axis=0)[:W]
        voc = Vocabulary(
            words=jnp.asarray(words),
            idf=jnp.asarray(rng.uniform(0.1, 1.0, W), np.float32),
        )
        p = tmp_path / "tree10.txt"
        save_dbow2_tree(voc, str(p), k=10)

        with open(p) as f:
            k, L = map(int, f.readline().split()[:2])
            assert k == 10 and L >= 3  # 3000 words need >= 3 levels at k=10
            n_leaves = 0
            n_nodes = 0
            for line in f:
                parts = line.split()
                parent, is_leaf = int(parts[0]), int(parts[1])
                n_nodes += 1
                assert 0 <= parent < n_nodes  # parents precede children
                n_leaves += is_leaf
        assert n_leaves == W

        voc2 = load_dbow2_text(str(p))
        assert voc2.n_words == W
        a = np.sort(np.asarray(voc.words).view(np.uint8).reshape(W, -1)
                    .view([("", np.uint8)] * 32), axis=0)
        b = np.sort(np.asarray(voc2.words).view(np.uint8).reshape(W, -1)
                    .view([("", np.uint8)] * 32), axis=0)
        assert (a == b).all(), "leaf word SET must survive the tree export"
