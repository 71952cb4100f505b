"""Binary visual vocabulary: flat word centroids, matmul quantization.

Replaces DBoW2::TemplatedVocabulary (Thirdparty/DBoW2). Training is
k-majority (binary k-means: Hamming assignment via int8 matmul + per-bit
majority vote update); quantization of a frame's descriptors is one
(N, 256) x (256, W) int8 matmul + argmin. tf-idf weighting and L1 scoring
follow DBoW2 (TF_IDF / L1_NORM defaults used by ORBVocabulary).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from fasttrack_tpu.ops.hamming import hamming_matrix


class Vocabulary(NamedTuple):
    words_signed: np.ndarray  # (W, 256) int8 +-1 centroids
    idf: np.ndarray           # (W,) float32

    @property
    def n_words(self) -> int:
        return len(self.words_signed)

    def save(self, path: str):
        np.savez_compressed(path, words=self.words_signed, idf=self.idf)

    @staticmethod
    def load(path: str) -> "Vocabulary":
        d = np.load(path)
        return Vocabulary(d["words"], d["idf"])


class TreeVocabulary(NamedTuple):
    """Two-level hierarchical vocabulary (the DBoW2 TemplatedVocabulary
    replacement at scale): B level-1 nodes, C children per node, B*C leaf
    words. Quantization is a STAGED Hamming argmin — one small matrix
    against the nodes, then one against the chosen node's children
    (SURVEY 2.3: matmul-able on a device; on host it runs through the native
    popcount kernel grouped by node). Descriptors stored PACKED (32 bytes)
    so a 32k-leaf vocabulary ships at ~1 MB vs the reference's 145 MB
    text ORBvoc."""

    nodes_packed: np.ndarray   # (B, 32) uint8
    leaves_packed: np.ndarray  # (B, C, 32) uint8
    idf: np.ndarray            # (B*C,) float32

    @property
    def n_words(self) -> int:
        return self.leaves_packed.shape[0] * self.leaves_packed.shape[1]

    def save(self, path: str):
        np.savez_compressed(
            path, nodes=self.nodes_packed, leaves=self.leaves_packed,
            idf=self.idf,
        )

    @staticmethod
    def load(path: str) -> "TreeVocabulary":
        d = np.load(path)
        return TreeVocabulary(d["nodes"], d["leaves"], d["idf"])


def vocabulary_checksum(vocab) -> str:
    """Stable content hash of a vocabulary's arrays — the analog of the
    MD5 guard the reference writes next to a saved atlas so a map built
    with one vocabulary is never silently loaded under another
    (System.cc:1424-1464, System::CalculateCheckSum). Returns '' for
    vocab None/False (loop closing disabled)."""
    if vocab is None or vocab is False:
        return ""
    import hashlib

    h = hashlib.md5()
    if isinstance(vocab, TreeVocabulary):
        h.update(vocab.nodes_packed.tobytes())
        h.update(vocab.leaves_packed.tobytes())
    else:
        h.update(np.ascontiguousarray(vocab.words_signed).tobytes())
    return h.hexdigest()


def load_vocabulary(path: str):
    """Load either vocabulary flavor by file content."""
    d = np.load(path)
    if "nodes" in d:
        return TreeVocabulary(d["nodes"], d["leaves"], d["idf"])
    return Vocabulary(d["words"], d["idf"])


_DEFAULT_VOCAB = None


def load_default_vocabulary():
    """The shipped vocabulary artifact (the reference always loads
    Vocabulary/ORBvoc.txt, System.cc:130-146). Prefers the 32k-leaf
    hierarchical artifact (tools/train_tree_vocab.py) and falls back to the
    flat 4k vocabulary (tools/train_default_vocab.py). Cached per
    process."""
    global _DEFAULT_VOCAB
    if _DEFAULT_VOCAB is None:
        import os

        here = os.path.dirname(__file__)
        tree = os.path.join(here, "orb_vocab_32k.npz")
        if os.path.exists(tree):
            _DEFAULT_VOCAB = TreeVocabulary.load(tree)
        else:
            _DEFAULT_VOCAB = Vocabulary.load(
                os.path.join(here, "orb_vocab.npz")
            )
    return _DEFAULT_VOCAB


@jax.jit
def _assign(descs: jnp.ndarray, words: jnp.ndarray) -> jnp.ndarray:
    d = hamming_matrix(descs, words)
    return jnp.argmin(d, axis=1).astype(jnp.int32)


def train_vocabulary(
    descs_signed: np.ndarray, n_words: int = 2048, iters: int = 8, seed: int = 0
) -> Vocabulary:
    """k-majority clustering of +-1 descriptors."""
    rng = np.random.default_rng(seed)
    n = len(descs_signed)
    if n < n_words:
        raise ValueError(f"need >= {n_words} descriptors, got {n}")
    centers = descs_signed[rng.choice(n, n_words, replace=False)].copy()
    dj = jnp.asarray(descs_signed)
    for _ in range(iters):
        assign = np.asarray(_assign(dj, jnp.asarray(centers)))
        # per-cluster per-bit majority vote
        sums = np.zeros((n_words, descs_signed.shape[1]), np.int32)
        np.add.at(sums, assign, descs_signed.astype(np.int32))
        counts = np.bincount(assign, minlength=n_words)
        new = np.where(sums >= 0, 1, -1).astype(np.int8)
        # keep old center for empty clusters; re-seed tiny ones
        empty = counts == 0
        new[empty] = centers[empty]
        centers = new
    # idf from training corpus treated as one document per descriptor burst:
    assign = np.asarray(_assign(dj, jnp.asarray(centers)))
    df = np.bincount(assign, minlength=n_words).astype(np.float64)
    idf = np.log(n / np.maximum(df, 1.0)).astype(np.float32)
    return Vocabulary(centers, idf)


def _bow_from_wids(wid, valid, idf, n_words):
    sel = wid[valid] if valid is not None else wid
    if len(sel) == 0:
        return {}
    counts = np.bincount(sel, minlength=n_words).astype(np.float64)
    w = counts * idf
    s = w.sum()
    if s > 0:
        w /= s
    nz = np.nonzero(w)[0]
    return {int(i): float(w[i]) for i in nz}


def _pack_signed(descs_signed: np.ndarray) -> np.ndarray:
    return np.packbits((np.asarray(descs_signed) > 0).astype(np.uint8), axis=1)


def _host_hamming(a_packed: np.ndarray, b_packed: np.ndarray) -> np.ndarray:
    """Packed Hamming matrix on host: native popcount kernel when the C++
    library is available, unpackbits fallback otherwise."""
    from fasttrack_tpu import native

    if native.available():
        return native.hamming_matrix_packed(a_packed, b_packed)
    a = np.unpackbits(a_packed, axis=1).astype(np.int32)
    b = np.unpackbits(b_packed, axis=1).astype(np.int32)
    return (a[:, None, :] != b[None, :, :]).sum(-1)


def quantize_tree(voc: TreeVocabulary, descs_signed: np.ndarray,
                  valid: np.ndarray | None = None):
    """Staged argmin quantization: nodes first, then the winning node's
    children (grouped by node so each group is one small Hamming matrix)."""
    if len(descs_signed) == 0:
        return np.empty(0, np.int32), {}
    packed = _pack_signed(descs_signed)
    d1 = _host_hamming(packed, voc.nodes_packed)     # (N, B)
    nid = d1.argmin(1)
    C = voc.leaves_packed.shape[1]
    wid = np.empty(len(packed), np.int32)
    for b in np.unique(nid):
        sel = nid == b
        d2 = _host_hamming(packed[sel], voc.leaves_packed[b])
        wid[sel] = b * C + d2.argmin(1).astype(np.int32)
    return wid, _bow_from_wids(wid, valid, voc.idf, voc.n_words)


def quantize(voc, descs_signed: np.ndarray, valid: np.ndarray | None = None):
    """Descriptors -> (word_ids (N,), bow dict word -> tf-idf weight).

    The bow vector is L1-normalized (DBoW2 L1_NORM). Dispatches on the
    vocabulary flavor (flat matmul argmin vs staged tree argmin)."""
    if isinstance(voc, TreeVocabulary):
        return quantize_tree(voc, descs_signed, valid)
    if len(descs_signed) == 0:
        return np.empty(0, np.int32), {}
    wid = np.asarray(_assign(jnp.asarray(descs_signed), jnp.asarray(voc.words_signed)))
    return wid, _bow_from_wids(wid, valid, voc.idf, voc.n_words)


def train_tree_vocabulary(
    descs_signed: np.ndarray, branches: int = 64, children: int = 512,
    iters: int = 8, seed: int = 0,
) -> TreeVocabulary:
    """Hierarchical k-majority: coarse clustering into `branches` nodes,
    then an independent k-majority per node over its assigned descriptors
    (64 small problems instead of one 32k-cluster problem — the same
    recursive construction as DBoW2's k-means++ tree)."""
    rng = np.random.default_rng(seed)
    coarse = train_vocabulary(descs_signed, n_words=branches, iters=iters,
                              seed=seed)
    nid = np.asarray(_assign(jnp.asarray(descs_signed),
                             jnp.asarray(coarse.words_signed)))
    leaves = np.empty((branches, children, descs_signed.shape[1]), np.int8)
    for b in range(branches):
        sub = descs_signed[nid == b]
        if len(sub) >= children:
            leaves[b] = train_vocabulary(
                sub, n_words=children, iters=iters, seed=seed + b + 1
            ).words_signed
        else:
            # thin node: its descriptors become leaves; the rest of the
            # block is filled with random words (never closest in practice)
            fill = (2 * rng.integers(0, 2, (children - len(sub),
                                            descs_signed.shape[1])) - 1)
            leaves[b] = np.concatenate([sub, fill.astype(np.int8)])
    voc = TreeVocabulary(
        _pack_signed(coarse.words_signed),
        _pack_signed(leaves.reshape(-1, leaves.shape[-1])).reshape(
            branches, children, 32
        ),
        np.ones(branches * children, np.float32),
    )
    # idf over the training corpus through the tree itself
    wid, _ = quantize_tree(voc, descs_signed)
    df = np.bincount(wid, minlength=voc.n_words).astype(np.float64)
    idf = np.log(len(descs_signed) / np.maximum(df, 1.0)).astype(np.float32)
    return TreeVocabulary(voc.nodes_packed, voc.leaves_packed, idf)


def l1_score(v1: dict, v2: dict) -> float:
    """DBoW2 L1 score between L1-normalized bow vectors:
    s = 1 - 0.5 * |v1 - v2|_1 in [0, 1]; computed sparsely."""
    if not v1 or not v2:
        return 0.0
    score = 0.0
    for w, x in v1.items():
        y = v2.get(w)
        if y is not None:
            score += abs(x) + abs(y) - abs(x - y)
    return 0.5 * score


def make_random_vocabulary(n_words: int = 2048, seed: int = 7) -> Vocabulary:
    """A deterministic random vocabulary for bootstrapping (usable before
    any training data exists; words are random +-1 vectors, uniform idf)."""
    rng = np.random.default_rng(seed)
    words = (2 * rng.integers(0, 2, size=(n_words, 256)) - 1).astype(np.int8)
    return Vocabulary(words, np.ones(n_words, np.float32))
