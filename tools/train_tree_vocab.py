#!/usr/bin/env python3
"""Train and ship the 32k-leaf hierarchical (2-level) ORB vocabulary.

DBoW2's tree exists because a CPU cannot afford a flat argmin over 1M
words per descriptor; the matmul analog (SURVEY 2.3) is a STAGED Hamming
argmin: one matmul against the B=64 level-1 nodes, then one small matmul
against the chosen node's C=512 children. Training is hierarchical
k-majority: coarse k-majority for the nodes, then an independent
k-majority per node over its assigned descriptors (64 small problems
instead of one 32k-cluster problem).

Run:  JAX_PLATFORMS=cpu python tools/train_tree_vocab.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from fasttrack_tpu.bow.vocabulary import (
    TreeVocabulary,
    train_tree_vocabulary,
)
from fasttrack_tpu.datasets.synthetic import make_texture, _render
from fasttrack_tpu.ops import OrbConfig
from fasttrack_tpu.ops.host_kernels import host_extract_orb


def gather_descriptors(n_scenes=32, views_per_scene=8):
    H, W = 480, 752
    cfg = OrbConfig(height=H, width=W, n_features=1024, n_levels=8)
    K = np.array([[458.0, 0, W / 2], [0, 458.0, H / 2], [0, 0, 1.0]])
    descs = []
    for s in range(n_scenes):
        rng = np.random.default_rng(200 + s)
        tex = make_texture(rng, size=1024)
        for v in range(views_per_scene):
            ang = 0.12 * (v - views_per_scene / 2)
            ca, sa = np.cos(ang), np.sin(ang)
            R_wc = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
            t_wc = np.array([0.25 * v - 1.0, 0.12 * (v % 3), -0.15 * v])
            img = _render(tex, 150.0 + 20.0 * (s % 4), K, R_wc, t_wc, H, W,
                          plane_z=5.0 + 0.5 * (s % 3))
            kps = host_extract_orb(img.astype(np.uint8), cfg)
            descs.append(kps.desc_signed[kps.valid])
        print(f"scene {s}: {sum(len(d) for d in descs)} total", flush=True)
    return np.concatenate(descs)


def main(branches=64, children=512):
    alld = gather_descriptors()
    print(f"training {branches}x{children} tree on {len(alld)} descriptors",
          flush=True)
    voc = train_tree_vocabulary(
        alld, branches=branches, children=children, iters=8, seed=0
    )
    out = os.path.join(os.path.dirname(__file__), "..",
                       "fasttrack_tpu", "bow", "orb_vocab_32k.npz")
    voc.save(out)
    print(f"saved {out} ({os.path.getsize(out)} bytes, "
          f"{voc.n_words} leaves)")


if __name__ == "__main__":
    main()
