"""Binary bag-of-words vocabulary (port of orb_slam2_tpu/place/vocab.py:
the stored vocabulary, the descriptor transform and the scores).

A k^L hierarchical k-medians tree over 256-bit ORB descriptors with TF-IDF
weights and L1 scoring (the reference's DBoW2 `TemplatedVocabulary`),
stored as flat arrays:

    node_children [n_nodes, k] i32 (-1 none)
    node_desc     [n_nodes, 32] u8 centroid descriptors
    word_id       [n_nodes] i32 (leaf index, -1 for internal)
    word_weight   [W] f32 IDF

The system's default vocabulary is `data/vocab_default.npz`.  Reading the
reference's ORBvoc text format and training a vocabulary are not part of
this package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from orb_slam2_tpu_torch import resolve_device
from orb_slam2_tpu_torch.matching.hamming import pm1_from_packed


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


def build_transform(vocab: Vocabulary, pad_to: Optional[int] = None,
                    device=None):
    """Returns fn: (desc [N, 32] u8, valid [N]) ->
    (bow [W] f32 L1-normalized TF-IDF, word [N] i32, node_lu [N] i32),
    node_lu being the tree node `levels_up` above the leaf.

    The descent takes, per level, the child whose centroid has the largest
    +-1 dot product with the descriptor: integers, exact in f32, with the
    first child winning a tie as in JAX's argmax.  Each word's BoW entry is
    its count times its weight: an integer count is order-free, so two runs
    on the card agree bit for bit (a float scatter-add there would not).

    `pad_to` zero-pads the bow vector to the map's k**depth capacity.  The
    tree's tensors live on `device`: CUDA unless the caller names one."""
    if pad_to is not None and vocab.n_words > pad_to:
        raise ValueError(
            f"vocabulary has {vocab.n_words} words > pad_to={pad_to}")
    device = resolve_device(device)
    children = torch.as_tensor(vocab.node_children, device=device).long()
    cpm1 = pm1_from_packed(torch.as_tensor(vocab.node_desc, device=device))
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
            ch = children[node]                                  # [N, k]
            ch_ok = ch >= 0
            ch_safe = ch.clamp(min=0)
            dots = torch.einsum('nb,nkb->nk', pm1, cpm1[ch_safe])
            dots = torch.where(ch_ok, dots, -1e9)
            best = torch.argmax(dots, dim=1)
            nxt = torch.gather(ch_safe, 1, best[:, None])[:, 0]
            # leaf-less branches keep the current node
            node = torch.where(torch.any(ch_ok, 1), nxt, node)
            if level + 1 == lu_level:
                node_lu = node
        word = wid[node]
        word_ok = valid & (word >= 0)
        count = torch.bincount(torch.where(word_ok, word, W).long(),
                               minlength=W + 1)[:W]
        bow = count.to(torch.float32) * weight
        bow = bow / torch.clamp(torch.sum(torch.abs(bow)), min=1e-12)
        if pad_to is not None and pad_to > W:
            bow = torch.nn.functional.pad(bow, (0, pad_to - W))
        return (bow, torch.where(word_ok, word, -1).to(torch.int32),
                node_lu.to(torch.int32))

    return transform


def l1_score(bow_a: torch.Tensor, bow_b: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score s = 1 - 0.5 |va - vb|_1, equal to sum min(va, vb) for
    L1-normalized vectors.  Broadcasts over leading dims."""
    return 1.0 - 0.5 * torch.sum(torch.abs(bow_a - bow_b), dim=-1)


def shared_words(bow_a: torch.Tensor, bow_b: torch.Tensor) -> torch.Tensor:
    """Count of common words (the reference's inverted-file counting)."""
    return torch.sum((bow_a > 0) & (bow_b > 0), dim=-1).to(torch.int32)
