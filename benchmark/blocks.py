"""A graph's robot blocks as the work counts read them: its poses and
edges, and each robot's (poses, edges, separators) (``work.block_work``),
shared by the runners' ``work``."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from benchmark import work


class Blocks(NamedTuple):
    n: int  # poses
    d: int
    edges: int
    blocks: List[Tuple[int, int, int]]  # per robot: poses, edges, separators


def graph_blocks(g: Dict) -> Blocks:
    off = np.concatenate([[0], np.cumsum(g["num_poses"])])
    src = off[g["src_robot"]] + g["src_frame"]
    dst = off[g["dst_robot"]] + g["dst_frame"]
    n, d = int(off[-1]), g["R"].shape[-1]
    blocks = []
    for k in range(len(g["num_poses"])):
        m = np.zeros(n, bool)
        m[off[k]:off[k + 1]] = True
        blocks.append(work.block_work(src, dst, m))
    return Blocks(n, d, len(src), blocks)
