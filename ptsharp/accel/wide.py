"""Wide-node (BVH-K) collapse of the binary flattened BVH.

Why: mesh traversal is a chain of serially-dependent row gathers. The
binary skip-link walk gathers one row per VISITED node — including every
node whose AABB then misses. A K-wide node row carries the node's own box
PLUS its K children's boxes and preorder indices, so each gathered row
decides the next K-way step without touching children that miss:

  * arrivals drop from "children of every hit node" to "hit children
    only" (~2x fewer gathers), and
  * tree depth drops from log2 to ~logK (another ~2-3x fewer levels),

while the extra per-step box tests are dense arithmetic on data already
fetched. Replaces the same reference hot loop as the binary
walk (Tree.cs:67-128, Triangle.cs:95-124).

Preorder + skip-link invariants (same as accel/bvh.py): a node's children
subtrees follow it contiguously; `skip` jumps past the subtree. The walk
descends to the FIRST (lowest preorder index) hit child; later hit
children are reached through the finished subtree's skip chain and
re-tested from their own row — which is gathered anyway — so no per-ray
stack exists and all hit children are provably visited.

Collapse: top-down. A wide node's children start as the binary node's two
children; the internal child with the largest surface area is repeatedly
replaced by its own two children until K subtree roots exist (the standard
BVH8-collapse rule). Binary leaves stay leaves (their triangle slots
already form one packed leaf row).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class WideBVH(NamedTuple):
    """Flattened K-wide BVH (preorder). Leaf payloads (first/count/kind)
    are copied verbatim from the binary source nodes; child_idx entries of
    absent children are 0 with inverted boxes (never hit)."""

    bmin: np.ndarray        # (Nw, 3)
    bmax: np.ndarray        # (Nw, 3)
    first: np.ndarray       # (Nw,)  leaf payload (slot start / prim index)
    count: np.ndarray       # (Nw,)  0 = internal
    kind: np.ndarray        # (Nw,)  leaf type code (PT_*), PT_NONE internal
    skip: np.ndarray        # (Nw,)  next preorder node after this subtree
    child_bmin: np.ndarray  # (Nw, K, 3)
    child_bmax: np.ndarray  # (Nw, K, 3)
    child_idx: np.ndarray   # (Nw, K) preorder index of child k
    src: np.ndarray         # (Nw,)  originating binary node index
    k: int


def _area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]


def collapse(bmin, bmax, first, count, skip, kind=None, k: int = 4) -> WideBVH:
    """Collapse a binary flattened BVH (accel/bvh.py layout: preorder,
    left child = i+1, right child = skip[i+1]) into a K-wide one.

    kind: optional per-binary-node leaf type codes (TLAS typed leaves);
    defaults to 0 for internals and is only read at leaves.
    """
    n = bmin.shape[0]
    if kind is None:
        kind = np.zeros(n, np.int32)
    is_leaf = count > 0

    out_bmin: list = []
    out_bmax: list = []
    out_first: list = []
    out_count: list = []
    out_kind: list = []
    out_cb_min: list = []
    out_cb_max: list = []
    out_cidx_children: list = []  # list of per-node child binary ids
    out_src: list = []

    def wide_children(b: int) -> list[int]:
        kids = [b + 1, skip[b + 1]]
        while len(kids) < k:
            # split the internal child with the largest surface area
            best, best_a = -1, -1.0
            for j, c in enumerate(kids):
                if not is_leaf[c]:
                    a = _area(bmin[c], bmax[c])
                    if a > best_a:
                        best, best_a = j, a
            if best < 0:
                break
            c = kids.pop(best)
            kids[best:best] = [c + 1, skip[c + 1]]
        return kids

    # preorder emission with an explicit stack (no recursion limit issues
    # at dragon scale); wide_slot_of[binary_node] resolves child pointers
    # in a second pass.
    wide_slot_of = np.full(n, -1, np.int64)
    stack = [0]
    order: list[int] = []  # binary node id per wide slot, preorder
    children_of: dict[int, list[int]] = {}
    while stack:
        b = stack.pop()
        wide_slot_of[b] = len(order)
        order.append(b)
        if not is_leaf[b]:
            kids = wide_children(b)
            children_of[b] = kids
            for c in reversed(kids):
                stack.append(c)

    nw = len(order)
    w_bmin = bmin[order].astype(np.float32)
    w_bmax = bmax[order].astype(np.float32)
    w_first = first[order].astype(np.int32)
    w_count = count[order].astype(np.int32)
    w_kind = kind[order].astype(np.int32)
    w_src = np.asarray(order, np.int32)
    w_cb_min = np.full((nw, k, 3), np.float32(np.inf))
    w_cb_max = np.full((nw, k, 3), np.float32(-np.inf))
    w_cidx = np.zeros((nw, k), np.int32)

    # subtree sizes -> skip links (preorder: skip = slot + subtree size)
    sizes = np.ones(nw, np.int64)
    # children appear after the parent in preorder; accumulate sizes from
    # the back (every node's children have higher slots)
    for slot in range(nw - 1, -1, -1):
        b = order[slot]
        kids = children_of.get(b)
        if kids:
            for j, c in enumerate(kids):
                cs = wide_slot_of[c]
                sizes[slot] += sizes[cs]
                w_cb_min[slot, j] = bmin[c]
                w_cb_max[slot, j] = bmax[c]
                w_cidx[slot, j] = cs
    w_skip = (np.arange(nw, dtype=np.int64) + sizes).astype(np.int32)

    return WideBVH(w_bmin, w_bmax, w_first, w_count, w_kind, w_skip,
                   w_cb_min, w_cb_max, w_cidx, w_src, k)


def row_width(k: int) -> int:
    """Packed row float32 slots: 6 own box + 3 meta + 6K child boxes +
    K child indices, padded up to a multiple of 8."""
    w = 9 + 7 * k
    return -(-w // 8) * 8


def pack_rows(w: WideBVH, node_offset: int = 0) -> np.ndarray:
    """Pack a WideBVH into (Nw, row_width) float32 rows. node_offset is
    added to skip and child indices (concatenated multi-tree tables).

    Row layout (float32 slots; ints bit-cast):
      [0:3]  own bmin        [3:6] own bmax
      [6]    first (bits)    [7]   kind<<8 | min(count,255) (bits)
      [8]    skip  (bits)    -- full int32: no node-count cap
      [9 : 9+6K]    child boxes, (bmin3, bmax3) per child
      [9+6K: 9+7K]  child preorder indices (bits)
    """
    k = w.k
    nw = w.bmin.shape[0]
    rows = np.zeros((nw, row_width(k)), np.float32)
    rows[:, 0:3] = w.bmin
    rows[:, 3:6] = w.bmax
    rows[:, 6] = w.first.astype(np.int32).view(np.float32)
    meta = ((w.kind.astype(np.int64) << 8)
            | np.minimum(w.count, 255).astype(np.int64)).astype(np.int32)
    rows[:, 7] = meta.view(np.float32)
    rows[:, 8] = (w.skip + node_offset).astype(np.int32).view(np.float32)
    cb = np.concatenate([w.child_bmin, w.child_bmax], axis=2)  # (Nw, K, 6)
    rows[:, 9:9 + 6 * k] = cb.reshape(nw, 6 * k)
    # absent children keep inverted boxes (never hit); their index 0 is
    # never followed. Present children get the global offset.
    present = np.isfinite(w.child_bmin[:, :, 0])
    cidx = np.where(present, w.child_idx + node_offset, 0).astype(np.int32)
    rows[:, 9 + 6 * k:9 + 7 * k] = cidx.view(np.float32)
    return rows
