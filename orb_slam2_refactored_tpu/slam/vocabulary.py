"""Bag-of-binary-words vocabulary + place-recognition database on the device.

Capability analog of DBoW2's `TemplatedVocabulary` + `KeyFrameDatabase`
(`/root/reference/Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h`,
`src/KeyFrameDatabase.cc:68-265`): transform a frame's ORB descriptors into a
tf-idf weighted word vector; retrieve loop / relocalization candidates by
vector similarity.

Redesigned for an accelerator (not a port):
- The k=10, L=5 vocabulary TREE exists to make per-descriptor quantization
  O(k*L) on CPU. On the device, brute-force Hamming argmin against ALL W leaf words
  is one [N,W] XOR-popcount matrix — faster than tree traversal and exact,
  so the tree is dropped.
- The inverted file (word -> keyframe list) exists to sparsify scoring. Here
  every keyframe's (L1-normalized, tf-idf) word vector is a row of a dense
  [KF, W] matrix; scoring every keyframe against a query is one matvec.
  DBoW2's L1 score `2 + sum(|a-b| - |a| - |b|)` reduces to
  `2 * sum(min(a_i, b_i))` for normalized nonneg vectors — computed exactly.
- Vocabulary training = k-majority (binary k-means with bitwise-majority
  centroids, the FORB::meanValue analog,
  `Thirdparty/DBoW2/DBoW2/FORB.cpp:17-80`) run as vmapped Hamming argmin.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import hamming


class Vocabulary(NamedTuple):
    words: jnp.ndarray    # u32[W,8] leaf centroids
    idf: jnp.ndarray      # f32[W] inverse document frequency weights

    @property
    def n_words(self) -> int:
        return self.words.shape[0]


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1)


def _majority_centroid(bits: np.ndarray) -> np.ndarray:
    """bits: [M, 256] -> packed u32[8] majority vote (FORB::meanValue)."""
    maj = (bits.sum(0) * 2 >= bits.shape[0]).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def train_vocabulary(
    descriptors: np.ndarray, n_words: int = 2048, iters: int = 8, seed: int = 0
) -> Vocabulary:
    """k-majority clustering of packed descriptors u32[M,8] -> Vocabulary.

    Assignment runs on device (Hamming matrices); the centroid majority vote
    is a cheap host bit op. idf starts uniform and is refitted by the
    database as keyframes arrive (reference computes weights at training
    time from the training corpus; we fit to the live corpus).
    """
    rng = np.random.default_rng(seed)
    M = descriptors.shape[0]
    n_words = min(n_words, M)
    centroids = descriptors[rng.choice(M, n_words, replace=False)].copy()
    desc_dev = jnp.asarray(descriptors)

    @jax.jit
    def assign(cents):
        d = hamming.hamming_matrix(desc_dev, cents)
        return jnp.argmin(d, axis=1)

    bits = _popcount_rows(descriptors)
    for _ in range(iters):
        a = np.asarray(assign(jnp.asarray(centroids)))
        for w in range(n_words):
            sel = a == w
            if sel.any():
                centroids[w] = _majority_centroid(bits[sel])
            else:
                centroids[w] = descriptors[rng.integers(0, M)]
    return Vocabulary(
        words=jnp.asarray(centroids), idf=jnp.ones((n_words,), jnp.float32)
    )


def load_dbow2_text(path: str, max_words: Optional[int] = None) -> Vocabulary:
    """Load a DBoW2 text vocabulary (the reference's ORBvoc.txt format,
    `TemplatedVocabulary::loadFromTextFile`): header `k L scoring weighting`,
    then one node per line `parent is_leaf b0..b31 weight`. Only leaves
    become words here (the tree is unused — transform is a
    brute-force Hamming argmin over all leaf centroids)."""
    words = []
    weights = []
    with open(path) as f:
        header = f.readline().split()
        assert len(header) >= 2, "not a DBoW2 text vocabulary"
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            is_leaf = int(parts[1])
            if not is_leaf:
                continue
            desc_bytes = np.asarray([int(x) for x in parts[2:34]], np.uint8)
            words.append(desc_bytes.view(np.uint32))
            weights.append(float(parts[34]))
            if max_words and len(words) >= max_words:
                break
    assert words, "vocabulary contained no leaf words"
    w = np.stack(words)
    idf = np.asarray(weights, np.float32)
    idf = idf / max(idf.max(), 1e-9)
    return Vocabulary(words=jnp.asarray(w), idf=jnp.asarray(idf))


_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _host_hamming(a_bytes: np.ndarray, b_bytes: np.ndarray) -> np.ndarray:
    """u8[M,32] x u8[N,32] -> i32[M,N] Hamming distances (host numpy —
    tree building is an offline export, not a device path)."""
    x = np.bitwise_xor(a_bytes[:, None, :], b_bytes[None, :, :])
    return _POPCNT8[x].sum(-1, dtype=np.int32)


def save_dbow2_tree(voc: Vocabulary, path: str, k: int = 10,
                    iters: int = 4, seed: int = 0):
    """Write the vocabulary as a PROPER hierarchical k-ary tree in the
    DBoW2 text schema (`TemplatedVocabulary::saveToTextFile` format:
    header `k L scoring weighting`, then one node per line
    `parent is_leaf b0..b31 weight`, ids implicit in write order, root
    omitted) — loadable by EXTERNAL DBoW2 readers that expect a k=10/L=5
    style tree, unlike `save_dbow2_text`'s flat form.

    The engine itself never uses the tree (transform is brute-force leaf
    argmin — exact); the tree here is synthesized OVER the
    existing leaf words by recursive k-majority clustering, so every leaf
    carries the original word descriptor + idf weight and an external
    DBoW2 traversal bottoms out on the same word set (its greedy descent
    is approximate by design, as in stock DBoW2)."""
    words = np.asarray(voc.words).view(np.uint8).reshape(voc.n_words, 32)
    idf = np.asarray(voc.idf)
    rng = np.random.default_rng(seed)
    # rows: (parent_id, is_leaf, bytes[32], weight), ids = write order (1-based)
    rows: list = []
    depth_max = [1]

    def cluster(indices: np.ndarray, parent: int, depth: int):
        depth_max[0] = max(depth_max[0], depth)
        if len(indices) <= k:
            for i in indices:
                rows.append((parent, 1, words[i], float(idf[i])))
            return
        cents = words[rng.choice(indices, k, replace=False)].copy()
        sub = indices if len(indices) <= 4096 else rng.choice(
            indices, 4096, replace=False)
        for _ in range(iters):
            a = np.argmin(_host_hamming(words[sub], cents), axis=1)
            for c in range(k):
                sel = sub[a == c]
                if len(sel):
                    bits = np.unpackbits(words[sel], axis=-1)
                    cents[c] = np.packbits(
                        (bits.sum(0) * 2 >= len(sel)).astype(np.uint8))
        a = np.argmin(_host_hamming(words[indices], cents), axis=1)
        for c in range(k):
            sel = indices[a == c]
            if len(sel) == 0:
                continue
            rows.append((parent, 0, cents[c], 0.0))
            cluster(sel, len(rows), depth + 1)

    cluster(np.arange(voc.n_words), 0, 1)
    L = depth_max[0]
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")  # L1_NORM scoring, TF_IDF weighting
        for parent, leaf, b, w in rows:
            byte_str = " ".join(str(int(x)) for x in b)
            f.write(f"{parent} {leaf} {byte_str} {w:.6f}\n")


def save_dbow2_text(voc: Vocabulary, path: str):
    """Write a flat (depth-1) vocabulary in the DBoW2 text schema so it can
    round-trip through `load_dbow2_text` EXACTLY (leaf order preserved).
    NOTE: external DBoW2 readers expecting a k=10/L=5 tree should use
    `save_dbow2_tree` instead — this flat form declares k=n_words, L=1,
    which stock DBoW2 parses but descends in one giant fan-out."""
    words = np.asarray(voc.words).view(np.uint8).reshape(voc.n_words, 32)
    idf = np.asarray(voc.idf)
    with open(path, "w") as f:
        f.write(f"{voc.n_words} 1 0 0\n")
        for i in range(voc.n_words):
            byte_str = " ".join(str(int(b)) for b in words[i])
            f.write(f"0 1 {byte_str} {float(idf[i]):.6f}\n")


def quantize(voc: Vocabulary, desc):
    """Per-descriptor word ids u32[N,8] -> i32[N] (nearest leaf centroid).

    Chunks the word axis so 1M-word vocabularies (full ORBvoc.txt scale)
    never materialize an [N, W] distance matrix (4GB at N=1000, W=1M)."""
    W = voc.n_words
    CHUNK = 1 << 16
    if W <= CHUNK:
        return jnp.argmin(hamming.hamming_matrix(desc, voc.words), axis=1)
    n = desc.shape[0]
    best_d = jnp.full((n,), hamming.BIG, jnp.int32)
    best_i = jnp.zeros((n,), jnp.int32)
    for s in range(0, W, CHUNK):
        e = min(s + CHUNK, W)
        d = hamming.hamming_matrix(desc, voc.words[s:e])
        i = jnp.argmin(d, axis=1)
        dm = jnp.min(d, axis=1)
        take = dm < best_d
        best_d = jnp.where(take, dm, best_d)
        best_i = jnp.where(take, i.astype(jnp.int32) + s, best_i)
    return best_i


def word_counts(voc: Vocabulary, desc, valid):
    """Raw word-count vector f32[W] + per-feature word ids (tf part of
    TemplatedVocabulary::transform; idf applies at scoring time so it can be
    refit to the live corpus without recomputing stored rows)."""
    word = quantize(voc, desc)
    counts = jnp.zeros((voc.n_words,), jnp.float32).at[word].add(
        valid.astype(jnp.float32)
    )
    return counts, word


def transform(voc: Vocabulary, desc, valid):
    """Descriptors u32[N,8] -> L1-normalized tf-idf word vector f32[W]
    (TemplatedVocabulary::transform analog) plus per-feature word ids."""
    counts, word = word_counts(voc, desc, valid)
    v = counts * voc.idf
    v = v / jnp.maximum(v.sum(), 1e-9)
    return v, word


def l1_similarity(a, b):
    """DBoW2 L1 score for L1-normalized nonneg vectors (ScoringObject.cpp):
    1 - 0.5*|a-b|_1 == sum(min(a,b)); scaled by 2 to match DBoW2's range."""
    return 2.0 * jnp.sum(jnp.minimum(a, b), axis=-1)


class KeyFrameDatabase:
    """Sparse-row place recognition index over keyframe words.

    A keyframe observes at most n_features distinct words, so each row
    stores (word_ids i32[T], counts f32[T]) instead of a dense [W] vector —
    the device form of DBoW2's inverted file
    (`/root/reference/src/KeyFrameDatabase.cc:39-66`): at the reference's
    shipped ORBvoc scale (W~1M words, `build.sh:22-24`) a dense
    [KF_cap, W] matrix would be ~2 GB of device memory at KF_cap=512, while
    sparse rows are ~8 MB. Scoring stays EXACT: the query scatters into one
    transient dense [W] vector (4 MB) and every row gathers its own words from it —
    the weighted-L1 `2*sum_w min(a_w, b_w)` only has support on the row's
    stored words.

    idf weighting and L1 normalization apply inside the scoring program, so
    `refit_idf` retunes the index to the live corpus without recomputing
    stored rows (the reference bakes idf at vocabulary-training time,
    `Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h`; a live-trained
    vocabulary must refit as keyframes arrive).
    """

    def __init__(self, voc: Vocabulary, kf_capacity: int,
                 row_capacity: int = 1024):
        self.voc = voc
        W = voc.n_words
        T = min(row_capacity, W)
        self.row_capacity = T
        # sparse rows: padding id = W (weight 0 in every program)
        self.bow_ids = jnp.full((kf_capacity, T), W, jnp.int32)
        self.bow_cnt = jnp.zeros((kf_capacity, T), jnp.float32)
        self.active = np.zeros(kf_capacity, bool)
        self.idf = jnp.asarray(voc.idf)

        def count_fn(d, v):
            counts, word = word_counts(self.voc, d, v)
            cnt, ids = jax.lax.top_k(counts, T)  # all nonzero words fit in T
            ids = jnp.where(cnt > 0, ids, W).astype(jnp.int32)
            return ids, cnt, word

        self._count = jax.jit(count_fn)

        def scores_fn(row_ids, row_cnt, q_ids, q_cnt, idf):
            # query -> transient dense tf-idf vector, L1-normalized
            safe_q = jnp.clip(q_ids, 0, W - 1)
            q_w = jnp.where(q_ids < W, q_cnt * idf[safe_q], 0.0)
            wq = jnp.zeros((W,), jnp.float32).at[q_ids].add(
                q_w / jnp.maximum(q_w.sum(), 1e-9), mode="drop"
            )
            # rows: per-entry tf-idf weight, row-normalized
            safe = jnp.clip(row_ids, 0, W - 1)
            ok = row_ids < W
            r_w = jnp.where(ok, row_cnt * idf[safe], 0.0)
            r_w = r_w / jnp.maximum(r_w.sum(-1, keepdims=True), 1e-9)
            q_at = jnp.where(ok, wq[safe], 0.0)
            sim = 2.0 * jnp.sum(jnp.minimum(r_w, q_at), axis=-1)
            q_has = jnp.zeros((W,), bool).at[q_ids].max(
                q_cnt > 0, mode="drop")
            common = jnp.sum(
                (ok & (row_cnt > 0) & q_has[safe]).astype(jnp.int32), -1)
            return sim, common

        self._scores2 = jax.jit(scores_fn)

        def refit_fn(row_ids, row_cnt, act):
            df = jnp.zeros((W,), jnp.float32).at[row_ids].add(
                ((row_cnt > 0) & act[:, None]).astype(jnp.float32),
                mode="drop",
            )
            return jnp.log(jnp.maximum(act.sum(), 1.0) / (1.0 + df))

        self._refit = jax.jit(refit_fn)

    def compute_bow(self, desc, valid):
        """-> (sparse row (ids i32[T], counts f32[T]), per-feature word ids)."""
        ids, cnt, word = self._count(desc, valid)
        return (ids, cnt), word

    def add(self, kf: int, bow_vec):
        ids, cnt = bow_vec
        self.bow_ids = self.bow_ids.at[kf].set(ids)
        self.bow_cnt = self.bow_cnt.at[kf].set(cnt)
        self.active[kf] = True

    def erase(self, kf: int):
        self.bow_ids = self.bow_ids.at[kf].set(self.voc.n_words)
        self.bow_cnt = self.bow_cnt.at[kf].set(0.0)
        self.active[kf] = False

    def clear(self):
        self.bow_ids = jnp.full_like(self.bow_ids, self.voc.n_words)
        self.bow_cnt = jnp.zeros_like(self.bow_cnt)
        self.active[:] = False

    def refit_idf(self):
        """Refit idf to the indexed corpus: idf_w = log(N / (1 + df_w))."""
        idf = self._refit(self.bow_ids, self.bow_cnt,
                          jnp.asarray(self.active))
        self.idf = jnp.maximum(idf, 0.0)

    def score_query(self, bow_vec):
        """Device-side (scores, common-words) of a sparse query vs all rows."""
        ids, cnt = bow_vec
        return self._scores2(self.bow_ids, self.bow_cnt, ids, cnt, self.idf)

    def _score_common(self, query_vec):
        s, cw = self.score_query(query_vec)
        s = np.array(s)
        cw = np.array(cw)
        s[~self.active] = -1.0
        cw[~self.active] = 0
        return s, cw

    def scores_against_all(self, query_vec) -> np.ndarray:
        """Weighted L1 similarity of `query_vec` vs every stored keyframe."""
        return self._score_common(query_vec)[0]

    def detect_candidates(
        self, query_vec, exclude: set, min_score: float, max_candidates: int = 10
    ):
        """Simple candidate logic: score all, drop the excluded (connected)
        set, keep >= max(min_score, 0.75 * best)."""
        s = self.scores_against_all(query_vec)
        for k in exclude:
            if 0 <= k < len(s):
                s[k] = -1.0
        best = s.max() if len(s) else -1.0
        if best < min_score:
            return []
        th = max(min_score, 0.75 * float(best))
        cands = np.nonzero(s >= th)[0]
        order = np.argsort(-s[cands])
        return [int(c) for c in cands[order][:max_candidates]]

    def detect_candidates_grouped(
        self, query_vec, exclude: set, min_score: float, graph,
        max_candidates: int = 10,
    ):
        """Full DetectLoopCandidates semantics
        (`/root/reference/src/KeyFrameDatabase.cc:68-171`): shared-word 0.8
        gate, per-candidate covisibility-group accumulated scores, retain
        groups >= 0.75 * best accumulated score, return each kept group's
        best-scoring keyframe."""
        s, cw = self._score_common(query_vec)
        return self.candidates_from_scores(
            s, cw, exclude, min_score, graph, max_candidates
        )

    def candidates_from_scores(
        self, s, cw, exclude: set, min_score: float, graph,
        max_candidates: int = 10,
    ):
        """DetectLoopCandidates policy over already-fetched (score,
        common-word) arrays — lets callers overlap the device query with
        other transfers (see LoopCloser.dispatch_detection)."""
        for k in exclude:
            if 0 <= k < len(s):
                s[k] = -1.0
                cw[k] = 0
        if cw.max() == 0:
            return []
        min_common = max(int(0.8 * cw.max()), 1)
        cands = [int(k) for k in np.nonzero((cw >= min_common) & (s >= min_score))[0]]
        if not cands:
            return []
        # accumulate scores over each candidate's covisibility group (:119-152)
        groups = []
        for c in cands:
            group = [c] + [g for g in graph.covis_neighbors(c, top_k=10)
                           if s[g] >= 0]
            acc = float(sum(s[g] for g in group if s[g] > 0))
            best_kf = max(group, key=lambda g: s[g])
            groups.append((acc, best_kf))
        best_acc = max(a for a, _ in groups)
        th = 0.75 * best_acc
        kept = sorted({bk for a, bk in groups if a >= th},
                      key=lambda k: -s[k])
        return kept[:max_candidates]
