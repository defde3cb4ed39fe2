"""The vocabularies the benchmark hands to both sides.

`default`: the frozen copy of the port's shipped tree
(`data/vocab_default.npz`, copied from
orb_slam2_tpu_torch/data/vocab_default.npz): k = 10, depth 4, 9,876
words.  `wide`: the reference vocabulary's shape (k = 10, L = 6,
987,600 words; ORB-SLAM2 loads ORBvoc.txt at start-up, System.cc:62),
two seeded levels grafted under each word of the default tree by
`wide_vocabulary` (copied from chip_smoke.py `wide_vocabulary`, numpy
only).  The real ORBvoc.txt is not in the repository; this tree stands
in for it.

A vocabulary is a dict of the npz's arrays.  The program reads it from a
file: `path_for` writes the wide tree once into the checkout's
`portbench/_cache/` (a fixed path, so later runs find it) and returns the
path; the plain reference reads the same file.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_cache")
DEFAULT = os.path.join(HERE, "data", "vocab_default.npz")
KEYS = ("k", "depth", "node_children", "node_desc", "word_id",
        "word_weight", "n_words", "levels_up")


def load(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in KEYS}


def wide_vocabulary(base: Dict[str, np.ndarray], seed: int = 0,
                    levels: int = 2, flips: int = 8) -> Dict[str, np.ndarray]:
    """`base` with `levels` levels of `k` children grafted under each word
    (numpy, from `seed`): each child's centroid its parent's with `flips`
    seeded bit positions flipped (a position drawn twice stays), each
    leaf's weight its base word's plus ln k a level.  Node ids: the
    base's, then the grafted nodes level by level, a parent's children
    together, so a parent precedes its children as in DBoW2's files;
    words in node order."""
    rng = np.random.RandomState(seed)
    k = int(base["k"])
    words = np.nonzero(base["word_id"] >= 0)[0]
    parents_of = [words]
    children = [base["node_children"].copy()]
    descs = [base["node_desc"]]
    n = base["node_children"].shape[0]
    for _ in range(levels):
        par = parents_of[-1]
        ids = n + np.arange(len(par) * k, dtype=np.int64)
        grid = np.concatenate(children)
        grid[par] = ids.reshape(-1, k)
        children = [grid, np.full((len(ids), k), -1, np.int32)]
        d = np.concatenate(descs)[np.repeat(par, k)]
        pos = rng.randint(0, 256, (len(ids), flips))
        np.bitwise_xor.at(d, (np.repeat(np.arange(len(ids)), flips),
                              (pos // 8).ravel()),
                          (128 >> (pos % 8)).astype(np.uint8).ravel())
        descs.append(d)
        parents_of.append(ids)
        n += len(ids)
    node_children = np.concatenate(children).astype(np.int32)
    word_id = np.full((n,), -1, np.int32)
    leaves = parents_of[-1]
    word_id[leaves] = np.arange(len(leaves), dtype=np.int32)
    weight = (np.repeat(base["word_weight"][base["word_id"][words]],
                        k ** levels).astype(np.float64)
              + levels * np.log(k)).astype(np.float32)
    return {"k": np.int64(k), "depth": np.int64(int(base["depth"]) + levels),
            "node_children": node_children,
            "node_desc": np.concatenate(descs), "word_id": word_id,
            "word_weight": weight, "n_words": np.int64(len(leaves)),
            "levels_up": np.int64(int(base["levels_up"]))}


def path_for(spec: dict) -> str:
    """The file of the configuration's vocabulary (`spec`: {"tree":
    "default"} or {"tree": "wide", "seed", "levels", "flips"}); "none"
    gives a path that does not exist, which turns the program's
    vocabulary off."""
    tree = spec["tree"]
    if tree == "default":
        return DEFAULT
    if tree == "none":
        return os.path.join(CACHE, "no-vocabulary.npz")
    if tree != "wide":
        raise ValueError(f"unknown vocabulary tree {tree!r}")
    seed, levels, flips = spec["seed"], spec["levels"], spec["flips"]
    path = os.path.join(CACHE, f"vocab_wide_s{seed}_l{levels}_f{flips}.npz")
    if not os.path.exists(path):
        os.makedirs(CACHE, exist_ok=True)
        tree = wide_vocabulary(load(DEFAULT), seed, levels, flips)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **tree)
        os.replace(tmp, path)
    return path
