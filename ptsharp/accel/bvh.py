"""Host-side BVH construction -> flattened skip-link arrays for the device.

The reference builds a pointer-based k-d tree with median splits and
objects duplicated into both children (Tree.cs:22-265). SURVEY.md §7 calls
for replacing it with a *flattened* BVH: contiguous node arrays, preorder
layout with skip ("miss") links so on-device traversal is a stackless loop
(a `lax.while_loop` of gathers, or one per-lane GPU kernel).

Build algorithm: Morton-ordered linear BVH — centroids quantized to a 30-bit
Morton code, triangles sorted, leaves of `leaf_size` consecutive triangles,
and a perfect binary tree over the (power-of-two padded) leaves with bounds
computed bottom-up. Fully numpy-vectorized, so a ~1M-triangle dragon builds
in seconds. Empty pad leaves get inverted bounds so every ray's slab test
rejects them. (A binned-SAH refinement can slot in behind the same flattened
layout later; Morton LBVH trades ~20-30% traversal quality for build speed.)

Flattened node arrays (all length N, preorder):
  bmin, bmax : (N, 3) float32 node AABB
  first      : (N,)  int32  leaf -> first triangle in the *sorted* order
  count      : (N,)  int32  leaf -> triangle count (0 for internal nodes)
  skip       : (N,)  int32  preorder index to jump to when the subtree is
                            skipped or finished (N = done)
Traversal invariant: advancing on hit = idx + 1; on miss = skip[idx]; after
a leaf = skip[idx] (which equals idx + 1 for leaves).
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np

logger = logging.getLogger(__name__)

# Which builder produced the LAST build() result ("sah" | "morton") and a
# running per-builder count, so a benchmark can record which builder fed
# its tables. Benches/tests read these; build() also logs at INFO.
last_builder: str | None = None
build_counts = {"sah": 0, "morton": 0}


class FlatBVH(NamedTuple):
    bmin: np.ndarray
    bmax: np.ndarray
    first: np.ndarray
    count: np.ndarray
    skip: np.ndarray
    order: np.ndarray  # permutation: sorted-tri -> original-tri index
    max_leaf: int


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so consecutive bits are 3 apart."""
    v = v.astype(np.uint64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3(points01: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for (T, 3) points in [0, 1]."""
    q = np.clip(points01 * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return (
        (_expand_bits(q[:, 0]) << 2)
        | (_expand_bits(q[:, 1]) << 1)
        | _expand_bits(q[:, 2])
    )


def build(tri_bmin: np.ndarray, tri_bmax: np.ndarray, leaf_size: int = 8,
          method: str = "auto") -> FlatBVH:
    """Build from per-triangle AABBs (T, 3). Returns flattened arrays plus
    the triangle permutation (callers must reorder their vertex/attribute
    arrays by `order` so leaf blocks are contiguous).

    method: "auto" prefers the native binned-SAH builder
    (native/bvh_builder.cpp, ~25% fewer node visits than Morton) and falls
    back to the pure-Python Morton LBVH; "morton"/"sah" force a builder.
    """
    t = tri_bmin.shape[0]
    assert t > 0, "empty BVH"

    global last_builder
    if method in ("auto", "sah"):
        from ptsharp.accel import native

        out = native.build_bvh_sah(tri_bmin, tri_bmax, leaf_size)
        if out is not None:
            bmin, bmax, first, count, skip, order = out
            last_builder = "sah"
            build_counts["sah"] += 1
            logger.info("bvh.build: sah (native binned-SAH), %d tris, "
                        "%d nodes, leaf_size=%d", t, bmin.shape[0], leaf_size)
            return FlatBVH(bmin, bmax, first, count, skip, order, leaf_size)
        if method == "sah":
            raise RuntimeError("native SAH builder unavailable")
    last_builder = "morton"
    build_counts["morton"] += 1
    logger.info("bvh.build: morton (LBVH fallback), %d tris, leaf_size=%d",
                t, leaf_size)
    centroids = 0.5 * (tri_bmin + tri_bmax)
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    codes = morton3((centroids - lo) / extent)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    sb_min = tri_bmin[order]
    sb_max = tri_bmax[order]

    n_leaves = -(-t // leaf_size)
    lp = 1 << max(0, (n_leaves - 1).bit_length())  # pad to power of two
    depth = lp.bit_length() - 1  # perfect tree depth (leaves at `depth`)

    # bottom-up bounds per level; level d has 2^d nodes
    leaf_min = np.full((lp, 3), np.float32(np.inf))
    leaf_max = np.full((lp, 3), np.float32(-np.inf))
    # scatter-min/max triangle bounds into their leaf slots
    pad = (-t) % leaf_size
    if pad:
        sb_min_p = np.concatenate([sb_min, np.full((pad, 3), np.inf, np.float32)])
        sb_max_p = np.concatenate([sb_max, np.full((pad, 3), -np.inf, np.float32)])
    else:
        sb_min_p, sb_max_p = sb_min, sb_max
    grouped_min = sb_min_p.reshape(n_leaves, leaf_size, 3).min(axis=1)
    grouped_max = sb_max_p.reshape(n_leaves, leaf_size, 3).max(axis=1)
    leaf_min[:n_leaves] = grouped_min
    leaf_max[:n_leaves] = grouped_max

    level_min = [leaf_min]
    level_max = [leaf_max]
    while level_min[-1].shape[0] > 1:
        cur_min, cur_max = level_min[-1], level_max[-1]
        level_min.append(np.minimum(cur_min[0::2], cur_min[1::2]))
        level_max.append(np.maximum(cur_max[0::2], cur_max[1::2]))
    level_min.reverse()  # level_min[d] = bounds of the 2^d nodes at depth d
    level_max.reverse()

    # preorder flatten with skip links over the implicit perfect tree,
    # pruning pad subtrees (those with inverted bounds)
    n_nodes_cap = 2 * lp - 1
    bmin = np.empty((n_nodes_cap, 3), np.float32)
    bmax = np.empty((n_nodes_cap, 3), np.float32)
    first = np.zeros(n_nodes_cap, np.int32)
    count = np.zeros(n_nodes_cap, np.int32)
    skip = np.zeros(n_nodes_cap, np.int32)

    out = 0
    # stack of (depth, index-within-level)
    stack = [(0, 0)]
    # record (out_idx) -> needs skip patched after subtree emitted
    while stack:
        d, i = stack.pop()
        lo_d = level_min[d][i]
        if not np.isfinite(lo_d[0]):
            continue  # pad subtree: nothing real inside
        idx = out
        out += 1
        bmin[idx] = level_min[d][i]
        bmax[idx] = level_max[d][i]
        if d == depth:  # leaf
            start = i * leaf_size
            cnt = min(leaf_size, t - start)
            first[idx] = start
            count[idx] = max(cnt, 0)
            skip[idx] = -1  # patched below
        else:
            count[idx] = 0
            skip[idx] = -1
            stack.append((d + 1, 2 * i + 1))
            stack.append((d + 1, 2 * i))
    n = out

    # skip link = next preorder node whose depth <= this node's depth.
    # Recompute via a second pass using subtree extents: emit order is
    # preorder, so a node's subtree is the contiguous block that follows it.
    # Walk backwards with a monotonic stack on node "levels".
    # Simpler: redo the walk tracking subtree sizes.
    sizes = np.zeros(n, np.int32)
    out2 = 0
    def emit(d, i):
        nonlocal out2
        lo_d = level_min[d][i]
        if not np.isfinite(lo_d[0]):
            return 0
        my = out2
        out2 += 1
        total = 1
        if d != depth:
            total += emit(d + 1, 2 * i)
            total += emit(d + 1, 2 * i + 1)
        sizes[my] = total
        return total

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, depth * 4 + 1000))
    emit(0, 0)
    sys.setrecursionlimit(old_limit)
    skip[:n] = np.arange(n, dtype=np.int32) + sizes[:n]

    return FlatBVH(
        bmin=bmin[:n].copy(),
        bmax=bmax[:n].copy(),
        first=first[:n].copy(),
        count=count[:n].copy(),
        skip=skip[:n].copy(),
        order=order,
        max_leaf=leaf_size,
    )
