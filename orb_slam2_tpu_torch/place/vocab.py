"""Binary bag-of-words vocabulary (port of orb_slam2_tpu/place/vocab.py:
the stored vocabulary, the descriptor transform and the scores).

A k^L hierarchical k-medians tree over 256-bit ORB descriptors with TF-IDF
weights and L1 scoring (the reference's DBoW2 `TemplatedVocabulary`),
stored as flat arrays:

    node_children [n_nodes, k] i32 (-1 none)
    node_desc     [n_nodes, 32] u8 centroid descriptors
    word_id       [n_nodes] i32 (leaf index, -1 for internal)
    word_weight   [W] f32 IDF

The system's default vocabulary is `data/vocab_default.npz`.
`table_scores` scores one query against the listed rows of a keyframe
table: on CUDA tensors one call of the kernel in csrc/bow_score.cu
(`bow_cuda`), on CPU tensors `table_scores_plain`.
`load_orbvoc_text` / `save_orbvoc_text` read and write the reference's
DBoW2 text format (ORBvoc.txt), parsed by the native helper
`native/voc_parser.cpp` (built with g++ at first use) or, as its plain
version, in Python; `train_vocabulary` builds a tree from descriptors.
These host-side parts are numpy, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from orb_slam2_tpu_torch import native_build, resolve_device
from orb_slam2_tpu_torch.matching.hamming import pm1_from_packed
from orb_slam2_tpu_torch.place import bow_cuda


@dataclasses.dataclass
class Vocabulary:
    k: int
    depth: int
    node_children: np.ndarray   # [n_nodes, k] i32
    node_desc: np.ndarray       # [n_nodes, 32] u8
    word_id: np.ndarray         # [n_nodes] i32
    word_weight: np.ndarray     # [W] f32
    n_words: int
    levels_up: int = 2

    def save(self, path: str):
        np.savez_compressed(path, k=self.k, depth=self.depth,
                            node_children=self.node_children,
                            node_desc=self.node_desc, word_id=self.word_id,
                            word_weight=self.word_weight,
                            n_words=self.n_words, levels_up=self.levels_up)

    @staticmethod
    def load(path: str) -> "Vocabulary":
        z = np.load(path)
        return Vocabulary(k=int(z["k"]), depth=int(z["depth"]),
                          node_children=z["node_children"],
                          node_desc=z["node_desc"], word_id=z["word_id"],
                          word_weight=z["word_weight"],
                          n_words=int(z["n_words"]),
                          levels_up=int(z["levels_up"]))


# ---------------------------------------------------------------------------
# DBoW2 text format (ORBvoc.txt) interchange
# ---------------------------------------------------------------------------

def _load_orbvoc_native(path: str):
    """(k, L, parents, leaves, descs, weights) through the native parser,
    or None when no compiler is present or the file does not parse."""
    lib = native_build.load("voc_parser")
    if lib is None:
        return None
    lp = ctypes.POINTER(ctypes.c_long)
    lib.voc_text_stats.argtypes = [ctypes.c_char_p, lp, lp, lp]
    lib.voc_text_stats.restype = ctypes.c_int
    lib.voc_text_parse.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.voc_text_parse.restype = ctypes.c_long
    k, L, n = ctypes.c_long(), ctypes.c_long(), ctypes.c_long()
    if lib.voc_text_stats(path.encode(), ctypes.byref(k), ctypes.byref(L),
                          ctypes.byref(n)) != 0 or n.value <= 0:
        return None
    cap = n.value
    parents = np.empty(cap, np.int32)
    leaves = np.empty(cap, np.uint8)
    descs = np.empty((cap, 32), np.uint8)
    weights = np.empty(cap, np.float32)
    got = lib.voc_text_parse(
        path.encode(),
        parents.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        leaves.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        descs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
    if got <= 0:
        return None
    return (k.value, L.value, parents[:got], leaves[:got].astype(bool),
            descs[:got], weights[:got])


def _load_orbvoc_python(path: str):
    """The plain version of `_load_orbvoc_native`."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leaves, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaves.append(int(parts[1]))
            descs.append([int(x) for x in parts[2:34]])
            weights.append(float(parts[34]))
    return k, L, parents, leaves, descs, weights


def _child_table(parents: np.ndarray, n: int, k: int) -> np.ndarray:
    """[n, k] children of each node in file order (-1 none) from the
    parent of each node 1..n-1."""
    node_children = np.full((n, k), -1, np.int32)
    order = np.argsort(parents, kind="stable")
    by_parent = parents[order]
    rank = np.arange(len(order)) - np.searchsorted(by_parent, by_parent)
    node_children[by_parent, rank] = order + 1
    return node_children


def _depths(parents: np.ndarray) -> np.ndarray:
    """Each node's depth (root 0) from the parent of each node 1..n-1, a
    parent coming before its children in the file as DBoW2 writes them."""
    dep = np.zeros(len(parents) + 1, np.int32)
    for _ in range(len(parents)):
        nxt = dep[parents] + 1
        if np.array_equal(nxt, dep[1:]):
            break
        dep[1:] = nxt
    return dep


def load_orbvoc_text(path: str, levels_up: int = 4,
                     truncate_depth: Optional[int] = None,
                     native: Optional[bool] = None) -> Vocabulary:
    """Load a DBoW2 text vocabulary (the reference's ORBvoc.txt; written by
    TemplatedVocabulary::saveToTextFile, parsed at
    TemplatedVocabulary.h:1338-1420):

        k L scoring_type weighting_type
        <parent_id> <is_leaf> <32 descriptor bytes> <weight>   (per node)

    Node ids are implicit (1..n in file order, root = 0).  Word ids go to
    leaves in increasing node-id order (createWords).

    `truncate_depth` cuts the tree at a shallower depth, turning its nodes
    into words (weight = the sum of their leaves' weights): the shipped
    ORBvoc is k=10 L=6 (~1M words) and a dense BoW wants ~10-100k.

    `native`: True parses with the native helper (raising when it cannot
    be built), False with the plain Python parser, None with the native
    one where a compiler is present."""
    parsed = _load_orbvoc_native(path) if native is not False else None
    if native and parsed is None:
        raise RuntimeError(f"the native ORBvoc parser could not read {path}")
    if parsed is None:
        parsed = _load_orbvoc_python(path)
    k, L, parents, leaves, descs, weights = parsed
    n = len(parents) + 1                      # + root
    parents = np.asarray(parents, np.int32)
    leaves = np.asarray(leaves, bool)
    node_desc = np.zeros((n, 32), np.uint8)
    node_desc[1:] = np.asarray(descs, np.uint8).reshape(-1, 32)
    w_all = np.zeros((n,), np.float32)
    w_all[1:] = np.asarray(weights, np.float32)

    node_children = _child_table(parents, n, k)

    depth = L
    is_leaf = np.zeros((n,), bool)
    is_leaf[1:] = leaves
    if truncate_depth is not None and truncate_depth < L:
        dep = _depths(parents)
        # each original leaf's weight goes up to its cut-depth ancestor
        anc = np.arange(n)
        for _ in range(L - truncate_depth):
            deeper = dep[anc] > truncate_depth
            anc = np.where(deeper, np.concatenate([[0], parents])[anc], anc)
        agg_w = np.zeros((n,), np.float32)
        np.add.at(agg_w, anc[is_leaf], w_all[is_leaf])
        is_leaf = dep == truncate_depth
        node_children[is_leaf] = -1
        w_all = agg_w
        depth = truncate_depth

    word_id = np.full((n,), -1, np.int32)
    leaf_ids = np.nonzero(is_leaf)[0]
    word_id[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
    return Vocabulary(k=k, depth=depth, node_children=node_children,
                      node_desc=node_desc, word_id=word_id,
                      word_weight=w_all[leaf_ids].astype(np.float32),
                      n_words=len(leaf_ids),
                      levels_up=levels_up if depth > levels_up else
                      max(depth - 2, 0))


_TEXT_BLOCK_ROWS = 1 << 17     # ~20 MB of text rows laid out at once


def save_orbvoc_text(vocab: Vocabulary, path: str) -> None:
    """Write the vocabulary in the DBoW2 text format (readable by the
    reference's loadFromTextFile): scoring L1_NORM (0), weighting TF_IDF
    (0).  One line a node after the root,

        <parent> <is_leaf> <32 descriptor bytes> <weight>

    the weight as Python prints the float32 (0.0 for an internal node).
    The lines are laid out as byte rows with numpy, _TEXT_BLOCK_ROWS nodes
    at a time, each field right-aligned in a fixed width whose padding
    bytes are then dropped."""
    n = vocab.node_children.shape[0]
    ch = vocab.node_children
    parent = np.zeros((n,), np.int32)
    parent[ch[ch >= 0]] = np.nonzero(ch >= 0)[0]
    leaf = vocab.word_id >= 0
    # a weight's text once for each distinct float32 bit pattern
    w = np.zeros((n,), np.float32)
    w[leaf] = vocab.word_weight[vocab.word_id[leaf]]
    bits, inv = np.unique(w.view(np.uint32), return_inverse=True)
    w_txt = [f" {v}\n" if b else " 0.0\n"
             for b, v in zip(bits.tolist(), bits.view(np.float32))]
    w_tab = _text_table(w_txt)
    byte_tab = _text_table([f" {b}" for b in range(256)])
    p_width = len(str(max(n - 1, 0)))
    with open(path, "wb") as f:
        f.write(f"{vocab.k} {vocab.depth} 0 0\n".encode())
        for lo in range(1, n, _TEXT_BLOCK_ROWS):
            hi = min(lo + _TEXT_BLOCK_ROWS, n)
            rows = np.concatenate([
                _int_text(parent[lo:hi], p_width),
                np.where(leaf[lo:hi, None], ord("1"), ord("0")
                         ).astype(np.uint8),
                byte_tab[vocab.node_desc[lo:hi]].reshape(hi - lo, -1),
                w_tab[inv.reshape(-1)[lo:hi]]], axis=1)
            f.write(rows[rows != 0].tobytes())


def _text_table(texts) -> np.ndarray:
    """[len(texts), width] uint8: each ASCII text right-aligned, 0 before
    it."""
    width = max(len(t) for t in texts)
    tab = np.zeros((len(texts), width), np.uint8)
    for i, t in enumerate(texts):
        tab[i, width - len(t):] = np.frombuffer(t.encode(), np.uint8)
    return tab


def _int_text(x: np.ndarray, width: int) -> np.ndarray:
    """[len(x), width + 1] uint8: the decimal digits of each x >= 0 and a
    space, right-aligned, 0 before them."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    x = x.astype(np.int64)[:, None]
    digits = np.where((x >= p) | (p == 1), x // p % 10 + ord("0"), 0)
    return np.concatenate([digits.astype(np.uint8),
                           np.full((len(x), 1), ord(" "), np.uint8)], axis=1)


# ---------------------------------------------------------------------------
# training (host-side numpy; done once per deployment)
# ---------------------------------------------------------------------------

def _kmedians_binary(bits: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-medians with bitwise-majority centroids (the FORB::meanValue
    recipe, Thirdparty/DBoW2/FORB.cpp:40-76).  bits: [N, 256] uint8 0/1."""
    n = bits.shape[0]
    k = min(k, n)
    centers = bits[rng.choice(n, k, replace=False)].astype(np.uint8)
    assign = None
    for _ in range(iters):
        d = (bits[:, None, :] != centers[None, :, :]).sum(-1)   # [N, k]
        assign = d.argmin(1)
        new_centers = centers.copy()
        for c in range(k):
            sel = bits[assign == c]
            if len(sel):
                new_centers[c] = (sel.mean(0) >= 0.5).astype(np.uint8)
        if (new_centers == centers).all():
            break
        centers = new_centers
    return centers, assign


def train_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = 4,
                     seed: int = 0, levels_up: int = 2) -> Vocabulary:
    """Build a k^depth tree from packed descriptors [N, 32] u8 (the same
    draws from `seed` as the JAX package's)."""
    rng = np.random.RandomState(seed)
    bits = np.unpackbits(descriptors.astype(np.uint8), axis=-1)

    max_nodes = sum(k ** i for i in range(depth + 1))
    node_children = np.full((max_nodes, k), -1, np.int32)
    node_desc = np.zeros((max_nodes, 32), np.uint8)
    word_id = np.full((max_nodes,), -1, np.int32)
    next_node, next_word = [1], [0]
    word_counts = []

    def build(node: int, subset: np.ndarray, level: int):
        if level == depth or len(subset) <= 1:
            word_id[node] = next_word[0]
            next_word[0] += 1
            word_counts.append(len(subset))
            return
        centers, assign = _kmedians_binary(bits[subset], k, rng)
        for c in range(len(centers)):
            child = next_node[0]
            next_node[0] += 1
            node_children[node, c] = child
            node_desc[child] = np.packbits(centers[c], axis=-1)
            build(child, subset[assign == c], level + 1)

    build(0, np.arange(len(bits)), 0)
    n_nodes, n_words = next_node[0], next_word[0]
    # IDF weights (TemplatedVocabulary::setNodeWeights, TF_IDF):
    # wi = log(N / Ni) over the training corpus as one document set
    counts = np.asarray(word_counts, np.float64)
    weight = np.log(max(len(bits), 1) / np.maximum(counts, 1.0)
                    ).astype(np.float32)
    return Vocabulary(k=k, depth=depth,
                      node_children=node_children[:n_nodes],
                      node_desc=node_desc[:n_nodes],
                      word_id=word_id[:n_nodes], word_weight=weight,
                      n_words=n_words, levels_up=levels_up)


# ---------------------------------------------------------------------------
# transform + scoring
# ---------------------------------------------------------------------------

def build_transform(vocab: Vocabulary, pad_to: Optional[int] = None,
                    device=None):
    """Returns fn: (desc [N, 32] u8, valid [N]) ->
    (bow [W] f32 L1-normalized TF-IDF, word [N] i32, node_lu [N] i32),
    node_lu being the tree node `levels_up` above the leaf.

    The descent takes, per level, the child whose centroid has the largest
    +-1 dot product with the descriptor: integers, exact in f32, with the
    first child winning a tie as in JAX's argmax.  The tree stays as the
    npz holds it on the device (the centroids packed, 32 bytes a node, and
    the child table int32: 79 MB for the reference's 1.1M nodes); each
    level unpacks only the k children it gathers.  Each word's BoW entry is
    its count times its weight: an integer count is order-free, so two runs
    on the card agree bit for bit (a float scatter-add there would not).

    `pad_to` zero-pads the bow vector to the map's k**depth capacity.  The
    tree's tensors live on `device`: CUDA unless the caller names one."""
    if pad_to is not None and vocab.n_words > pad_to:
        raise ValueError(
            f"vocabulary has {vocab.n_words} words > pad_to={pad_to}")
    device = resolve_device(device)
    children = torch.as_tensor(vocab.node_children, device=device)
    node_desc = torch.as_tensor(vocab.node_desc, device=device)
    wid = torch.as_tensor(vocab.word_id, device=device)
    weight = torch.as_tensor(vocab.word_weight, device=device)
    W = vocab.n_words
    depth = vocab.depth
    lu_level = max(depth - vocab.levels_up, 0)

    def transform(desc: torch.Tensor, valid: torch.Tensor):
        N = desc.shape[0]
        pm1 = pm1_from_packed(desc)                              # [N, 256]
        node = torch.zeros(N, dtype=torch.int64, device=desc.device)
        node_lu = node
        for level in range(depth):
            ch = children[node].long()                           # [N, k]
            ch_ok = ch >= 0
            ch_safe = ch.clamp(min=0)
            dots = torch.einsum('nb,nkb->nk', pm1,
                                pm1_from_packed(node_desc[ch_safe]))
            dots = torch.where(ch_ok, dots, -1e9)
            best = torch.argmax(dots, dim=1)
            nxt = torch.gather(ch_safe, 1, best[:, None])[:, 0]
            # leaf-less branches keep the current node
            node = torch.where(torch.any(ch_ok, 1), nxt, node)
            if level + 1 == lu_level:
                node_lu = node
        word = wid[node]
        word_ok = valid & (word >= 0)
        # an integer scatter-add into a count of fixed length (exact in any
        # order; `bincount` would read its length from the device)
        tgt = torch.where(word_ok, word, W).long()
        count = torch.zeros(W + 1, dtype=torch.int64, device=desc.device
                            ).scatter_add_(0, tgt, torch.ones_like(tgt))[:W]
        bow = count.to(torch.float32) * weight
        bow = bow / torch.clamp(torch.sum(torch.abs(bow)), min=1e-12)
        if pad_to is not None and pad_to > W:
            bow = torch.nn.functional.pad(bow, (0, pad_to - W))
        return (bow, torch.where(word_ok, word, -1).to(torch.int32),
                node_lu.to(torch.int32))

    return transform


# the [rows, W] temporaries of the plain version of a score over a keyframe
# table are bounded by gathering at most this many bytes of rows at once
SCORE_CHUNK_BYTES = 1 << 28


def l1_score(bow_a: torch.Tensor, bow_b: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score s = 1 - 0.5 |va - vb|_1, equal to sum min(va, vb) for
    L1-normalized vectors.  Broadcasts over leading dims; a query against
    rows of a keyframe table goes through `table_scores`."""
    return 1.0 - 0.5 * torch.sum(torch.abs(bow_a - bow_b), dim=-1)


def shared_words(bow_a: torch.Tensor, bow_b: torch.Tensor) -> torch.Tensor:
    """Count of common words (the reference's inverted-file counting);
    broadcasts as `l1_score`."""
    return torch.sum((bow_a > 0) & (bow_b > 0), dim=-1).to(torch.int32)


def table_scores_plain(query: torch.Tensor, table: torch.Tensor,
                       rows: torch.Tensor):
    """`table_scores` in tensor ops, for CPU tensors: `l1_score` and
    `shared_words` of the query against the listed rows, gathered
    SCORE_CHUNK_BYTES of rows at a time.  Skipped rows are never read
    (finding the listed ones reads the ids on the host)."""
    if table.dim() != 2 or query.shape != table.shape[1:] or rows.dim() != 1:
        raise ValueError(f"expected query [W], table [K, W] and rows [R], "
                         f"got {tuple(query.shape)}, {tuple(table.shape)} "
                         f"and {tuple(rows.shape)}")
    K, W = table.shape
    rows = rows.long()
    listed = torch.nonzero((rows >= 0) & (rows < K))[:, 0]
    score = torch.zeros(rows.shape, dtype=torch.float32, device=table.device)
    shared = torch.zeros(rows.shape, dtype=torch.int32, device=table.device)
    n = max(1, SCORE_CHUNK_BYTES // (table.element_size() * max(W, 1)))
    for i in range(0, listed.shape[0], n):
        at = listed[i:i + n]
        b = table[rows[at]]
        score[at] = l1_score(query[None, :], b)
        shared[at] = shared_words(query[None, :], b)
    return score, shared


def table_scores(query: torch.Tensor, table: torch.Tensor,
                 rows: torch.Tensor):
    """Scores of a query [W] against the rows `rows` of a keyframe table
    [K, W]: (score f32, shared int32), each of the shape of `rows` ([R]),
    score[i] the L1 score (`l1_score`) and shared[i] the shared-word count
    (`shared_words`) of table row rows[i]; a row id outside [0, K) (-1:
    skip) gives 0 and 0 and is not read.  CUDA tensors go through the
    kernel (one call, the bytes of the listed rows read once); CPU tensors
    through `table_scores_plain`."""
    fn = bow_cuda.table_scores_cuda if (
        query.is_cuda or table.is_cuda or rows.is_cuda) else \
        table_scores_plain
    if rows.dim() == 1:
        return fn(query, table, rows)
    score, shared = fn(query, table, rows.reshape(-1))
    return score.reshape(rows.shape), shared.reshape(rows.shape)
