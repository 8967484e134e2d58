"""BVH build + traversal correctness: flattened traversal must agree with
brute-force Möller–Trumbore over every triangle."""

import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.accel import bvh as bvh_mod
from ptsharp.accel import traverse
from ptsharp.core import vec
from ptsharp.geometry import primitives as prim
from ptsharp.geometry.mesh import TriMesh, cube_mesh, sphere_mesh


def _mesh_arrays(mesh: TriMesh, leaf_size=4):
    v = mesh.v
    lo = np.minimum(np.minimum(v[:, 0], v[:, 1]), v[:, 2])
    hi = np.maximum(np.maximum(v[:, 0], v[:, 1]), v[:, 2])
    flat = bvh_mod.build(lo, hi, leaf_size=leaf_size)
    sv = v[flat.order]
    pad = np.zeros((leaf_size, 3, 3), np.float32)
    sv = np.concatenate([sv, pad])
    return (
        traverse.MeshArrays(
            node_bmin=jnp.asarray(flat.bmin),
            node_bmax=jnp.asarray(flat.bmax),
            node_first=jnp.asarray(flat.first),
            node_count=jnp.asarray(flat.count),
            node_skip=jnp.asarray(flat.skip),
            v0=jnp.asarray(sv[:, 0]),
            e1=jnp.asarray(sv[:, 1] - sv[:, 0]),
            e2=jnp.asarray(sv[:, 2] - sv[:, 0]),
            max_leaf=leaf_size,
        ),
        flat,
    )


def _brute(mesh: TriMesh, org, dirn):
    v = jnp.asarray(mesh.v)
    t, _, _ = prim.intersect_triangles(org, dirn, v[:, 0], v[:, 1], v[:, 2])
    return jnp.min(t, axis=1)


def test_bvh_skip_links_wellformed():
    rng = np.random.default_rng(0)
    lo = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 0.5, (1000, 3)).astype(np.float32)
    flat = bvh_mod.build(lo, hi, leaf_size=8)
    n = flat.bmin.shape[0]
    assert flat.skip.max() <= n
    assert (flat.skip > np.arange(n)).all()  # strictly forward
    # leaf triangle ranges cover exactly [0, T)
    leaves = flat.count > 0
    covered = np.zeros(1000, bool)
    for f, c in zip(flat.first[leaves], flat.count[leaves]):
        assert not covered[f : f + c].any()  # no duplication (unlike k-d)
        covered[f : f + c] = True
    assert covered.all()


def test_bvh_matches_brute_force_cube():
    mesh = cube_mesh([-1, -1, -1], [1, 1, 1])
    arrays, _ = _mesh_arrays(mesh)
    rng = np.random.default_rng(1)
    n = 256
    org = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    org = org + np.sign(org) * 2.0  # push outside the cube
    target = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    dirn = target - org
    dirn = (dirn / np.linalg.norm(dirn, axis=1, keepdims=True)).astype(np.float32)
    t_bvh, tri, _, _ = traverse.traverse(
        arrays, jnp.asarray(org), jnp.asarray(dirn), vec.INF, 0,
        arrays.node_bmin.shape[0],
    )
    t_ref = _brute(mesh, jnp.asarray(org), jnp.asarray(dirn))
    np.testing.assert_allclose(np.asarray(t_bvh), np.asarray(t_ref), rtol=1e-4)
    assert (np.asarray(tri) >= 0).all()


def test_bvh_matches_brute_force_sphere_mesh():
    mesh = sphere_mesh([0.0, 0.0, 0.0], 1.0, subdivisions=3)  # 1280 tris
    arrays, _ = _mesh_arrays(mesh, leaf_size=8)
    rng = np.random.default_rng(2)
    n = 512
    # random rays toward the sphere, some missing
    org = rng.normal(0, 1, (n, 3))
    org = (org / np.linalg.norm(org, axis=1, keepdims=True) * 3).astype(np.float32)
    target = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    dirn = target - org
    dirn = (dirn / np.linalg.norm(dirn, axis=1, keepdims=True)).astype(np.float32)
    t_bvh, _, _, _ = traverse.traverse(
        arrays, jnp.asarray(org), jnp.asarray(dirn), vec.INF, 0,
        arrays.node_bmin.shape[0],
    )
    t_ref = _brute(mesh, jnp.asarray(org), jnp.asarray(dirn))
    hit_ref = np.asarray(t_ref) < vec.INF
    hit_bvh = np.asarray(t_bvh) < vec.INF
    np.testing.assert_array_equal(hit_bvh, hit_ref)
    np.testing.assert_allclose(
        np.asarray(t_bvh)[hit_bvh], np.asarray(t_ref)[hit_ref], rtol=1e-4
    )


def test_scene_mesh_instancing():
    """Two instances of the same cube mesh via SceneBuilder: transformed
    instance must hit at the transformed location."""
    from ptsharp.camera import Camera
    from ptsharp.intersect import closest_hit
    from ptsharp.materials import diffuse_material
    from ptsharp.scene import PT_TRIANGLE, SceneBuilder

    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [5.0, 0.0, 0.0]  # second cube at x=+5

    b = SceneBuilder()
    mesh_id = b.add_mesh(cube_mesh([-1, -1, -1], [1, 1, 1]),
                         diffuse_material([1, 0, 0]))
    b.add_mesh_instance(mesh_id, transform=t)
    scene = b.build(leaf_size=4)

    org = jnp.asarray([[0, 0, -5], [5, 0, -5]], jnp.float32)
    dirn = jnp.asarray([[0, 0, 1], [0, 0, 1]], jnp.float32)
    hit = closest_hit(scene, org, dirn)
    np.testing.assert_allclose(np.asarray(hit.t), [4.0, 4.0], rtol=1e-4)
    assert (np.asarray(hit.ptype) == PT_TRIANGLE).all()
    assert np.asarray(hit.inst).tolist() == [0, 1]


def test_scene_mesh_normals_interpolated():
    """Smooth sphere mesh normals should be close to analytic sphere
    normals after barycentric interpolation."""
    from ptsharp.intersect import closest_hit, hit_info
    from ptsharp.materials import diffuse_material
    from ptsharp.scene import SceneBuilder

    mesh = sphere_mesh([0.0, 0.0, 0.0], 1.0, subdivisions=3)
    b = SceneBuilder()
    b.add_mesh(mesh, diffuse_material([1, 1, 1]))
    scene = b.build(leaf_size=8)

    rng = np.random.default_rng(3)
    n = 128
    d = rng.normal(0, 1, (n, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    org = jnp.asarray(d * 3.0, jnp.float32)
    dirn = jnp.asarray(-d, jnp.float32)
    hit = closest_hit(scene, org, dirn)
    info = hit_info(scene, org, dirn, hit)
    # hit normal should be ~ the outward radial direction
    cos = np.sum(np.asarray(info.normal) * d, axis=1)
    assert cos.min() > 0.99


def test_native_sah_builder():
    """Native C++ binned-SAH build: correct skip links, full coverage,
    traversal agrees with brute force."""
    from ptsharp.accel import native

    if not native.available():
        import pytest

        pytest.skip("native toolchain unavailable")
    mesh = sphere_mesh([0.0, 0.0, 0.0], 1.0, subdivisions=3)
    v = mesh.v
    lo = np.minimum(np.minimum(v[:, 0], v[:, 1]), v[:, 2])
    hi = np.maximum(np.maximum(v[:, 0], v[:, 1]), v[:, 2])
    flat = bvh_mod.build(lo, hi, leaf_size=8, method="sah")
    n = flat.bmin.shape[0]
    assert (flat.skip > np.arange(n)).all()
    leaves = flat.count > 0
    covered = np.zeros(v.shape[0], bool)
    for f, c in zip(flat.first[leaves], flat.count[leaves]):
        assert not covered[f : f + c].any()
        covered[f : f + c] = True
    assert covered.all()

    sv = v[flat.order]
    sv = np.concatenate([sv, np.zeros((8, 3, 3), np.float32)])
    arrays = traverse.MeshArrays(
        node_bmin=jnp.asarray(flat.bmin), node_bmax=jnp.asarray(flat.bmax),
        node_first=jnp.asarray(flat.first), node_count=jnp.asarray(flat.count),
        node_skip=jnp.asarray(flat.skip),
        v0=jnp.asarray(sv[:, 0]), e1=jnp.asarray(sv[:, 1] - sv[:, 0]),
        e2=jnp.asarray(sv[:, 2] - sv[:, 0]), max_leaf=8,
    )
    rng = np.random.default_rng(4)
    n_rays = 256
    org = rng.normal(0, 1, (n_rays, 3))
    org = (org / np.linalg.norm(org, axis=1, keepdims=True) * 3).astype(np.float32)
    tgt = rng.uniform(-1.2, 1.2, (n_rays, 3)).astype(np.float32)
    dirn = tgt - org
    dirn = (dirn / np.linalg.norm(dirn, axis=1, keepdims=True)).astype(np.float32)
    t_bvh, _, _, _ = traverse.traverse(
        arrays, jnp.asarray(org), jnp.asarray(dirn), vec.INF, 0, n
    )
    t_ref = _brute(mesh, jnp.asarray(org), jnp.asarray(dirn))
    np.testing.assert_allclose(np.asarray(t_bvh), np.asarray(t_ref), rtol=1e-4)


def test_multi_mesh_slot_layout_matches_brute():
    """Regression: with 2+ distinct meshes where an earlier mesh's leaf
    count is NOT a multiple of CLUSTER_GROUP, the later mesh's node_first
    slot indices must account for the earlier mesh's leaf padding
    (scene.py slot_offset advance). A sphere mesh at subdiv 2 has 40
    leaves (40 % 16 != 0), so the offset cube mesh after it exposes any
    off-by-padding bug as wrong t values."""
    from ptsharp.intersect import closest_hit
    from ptsharp.materials import diffuse_material
    from ptsharp.scene import PT_TRIANGLE, SceneBuilder

    sph = sphere_mesh([0.0, 0.0, 0.0], 1.0, subdivisions=2)  # 320 tris
    cube = cube_mesh([-1, -1, -1], [1, 1, 1]).transform(
        np.array([[1, 0, 0, 8], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32)
    )
    b = SceneBuilder()
    b.add_mesh(sph, diffuse_material([1, 0, 0]))
    b.add_mesh(cube, diffuse_material([0, 1, 0]))
    scene = b.build(leaf_size=8)

    # aimed rays: half at the sphere, half at the cube, plus randoms
    rng = np.random.default_rng(6)
    n = 256
    org = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    org[:, 2] -= 6.0
    tgt = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    tgt[n // 2:, 0] += 8.0  # second half aims at the offset cube
    dirn = tgt - org
    dirn = (dirn / np.linalg.norm(dirn, axis=1, keepdims=True)).astype(np.float32)
    org_j, dirn_j = jnp.asarray(org), jnp.asarray(dirn)

    hit = closest_hit(scene, org_j, dirn_j)
    t_ref = jnp.minimum(_brute(sph, org_j, dirn_j), _brute(cube, org_j, dirn_j))
    np.testing.assert_allclose(np.asarray(hit.t), np.asarray(t_ref),
                               rtol=1e-4, atol=1e-4)
    # the ray aimed dead-center at the cube must report the cube's instance
    center_ray_t = _ray_t(scene, [8.0, 0.0, -6.0], [0.0, 0.0, 1.0])
    np.testing.assert_allclose(center_ray_t, 5.0, rtol=1e-4)


def test_wide_collapse_wellformed():
    """K-wide collapse invariants: preorder skip links strictly forward,
    every binary leaf present exactly once, child indices point at the
    children's own preorder slots."""
    from ptsharp.accel import wide as wide_mod

    rng = np.random.default_rng(9)
    lo = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 0.5, (3000, 3)).astype(np.float32)
    flat = bvh_mod.build(lo, hi, leaf_size=8)
    for k in (2, 4, 8):
        w = wide_mod.collapse(flat.bmin, flat.bmax, flat.first, flat.count,
                              flat.skip, k=k)
        nw = w.bmin.shape[0]
        assert (w.skip > np.arange(nw)).all()
        assert w.skip.max() == nw
        # leaf multiset preserved
        src_leaves = sorted(flat.first[flat.count > 0].tolist())
        wide_leaves = sorted(w.first[w.count > 0].tolist())
        assert src_leaves == wide_leaves
        # child indices: in range, strictly increasing per node, and the
        # boxes stored for child j equal the child's own box
        internal = np.where(w.count == 0)[0]
        for slot in internal[:: max(1, internal.shape[0] // 50)]:
            present = np.isfinite(w.child_bmin[slot, :, 0])
            cidx = w.child_idx[slot][present]
            assert (np.diff(cidx) > 0).all()
            np.testing.assert_array_equal(w.child_bmin[slot][present],
                                          w.bmin[cidx])
            np.testing.assert_array_equal(w.child_bmax[slot][present],
                                          w.bmax[cidx])


def test_wide_traversal_matches_brute():
    """traverse_wide over a scene build, and the per-lane kernel over the
    same tables, must agree with brute force for every K."""
    from ptsharp.accel.traverse import traverse_wide
    from ptsharp.materials import diffuse_material
    from ptsharp.pallas import traverse_gpu
    from ptsharp.scene import SceneBuilder

    mesh = sphere_mesh([0, 0.5, 0], 1.0, subdivisions=3)
    rng = np.random.default_rng(10)
    org = jnp.asarray(rng.uniform(-3, 3, (512, 3)).astype(np.float32))
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    t_ref = _brute(mesh, org, d)
    for k in (2, 4, 8):
        b = SceneBuilder()
        b.add_mesh(mesh, diffuse_material([0.5, 0.5, 0.5]))
        scene = b.build(leaf_size=8, wide_k=k)
        wb, we = int(scene.w_inst_base[0]), int(scene.w_inst_end[0])
        for walk in (traverse_wide, traverse_gpu.closest_hit):
            t, slot, u, v = jax.jit(
                lambda o, dd, s=scene, wb=wb, we=we, walk=walk: walk(
                    s.w_rows, s.leaf_rows, o, dd, vec.INF, wb, we, 8, k)
            )(org, d)
            np.testing.assert_allclose(np.asarray(t), np.asarray(t_ref),
                                       rtol=1e-4, atol=1e-4)


def test_cluster_intersector_small_scene():
    """Regression: a scene with fewer clusters than the candidate count
    (single small mesh -> 1 cluster < k_cand=12) must degrade gracefully,
    not crash lax.top_k."""
    from ptsharp.intersect import closest_hit
    from ptsharp.materials import diffuse_material
    from ptsharp.scene import SceneBuilder

    b = SceneBuilder()
    b.add_mesh(cube_mesh([-1, -1, -1], [1, 1, 1]), diffuse_material([1, 0, 0]))
    scene = b.build(leaf_size=4, intersector="cluster")
    hit = closest_hit(scene, jnp.asarray([[0, 0, -5.0]], jnp.float32),
                      jnp.asarray([[0, 0, 1.0]], jnp.float32))
    np.testing.assert_allclose(float(hit.t[0]), 4.0, rtol=1e-4)


def _ray_t(scene, o, d):
    from ptsharp.intersect import closest_hit

    hit = closest_hit(scene, jnp.asarray([o], jnp.float32),
                      jnp.asarray([d], jnp.float32))
    return float(hit.t[0])


def test_packed_traversal_matches_brute():
    """The packed-row traversal (one node row + one leaf row per step) must
    agree with brute-force over a full scene build (slot re-layout,
    u_rows/leaf_rows packing)."""
    import jax

    from ptsharp.accel.traverse import traverse_packed, traverse_packed_chunked
    from ptsharp.materials import diffuse_material
    from ptsharp.scene import SceneBuilder

    mesh = sphere_mesh([0, 0.5, 0], 1.0, subdivisions=3)
    b = SceneBuilder()
    b.add_mesh(mesh, diffuse_material([0.5, 0.5, 0.5]))
    scene = b.build(leaf_size=8)

    rng = np.random.default_rng(5)
    org = jnp.asarray(rng.uniform(-3, 3, (512, 3)).astype(np.float32))
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)

    t_ref = _brute(mesh, org, d)
    base = int(scene.u_inst_base[0])
    end = int(scene.u_inst_end[0])
    t, slot, u, v = jax.jit(
        lambda o, dd: traverse_packed(
            scene.u_rows, scene.leaf_rows, o, dd, vec.INF, base, end, 8
        )
    )(org, d)
    np.testing.assert_allclose(np.asarray(t), np.asarray(t_ref), rtol=1e-4,
                               atol=1e-4)
    # chunked wrapper with padding agrees too
    t2, *_ = jax.jit(
        lambda o, dd: traverse_packed_chunked(
            scene.u_rows, scene.leaf_rows, o, dd, vec.INF, base, end, 8,
            chunk=128,
        )
    )(org, d)
    np.testing.assert_allclose(np.asarray(t2), np.asarray(t), rtol=1e-6)
