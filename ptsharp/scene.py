"""Host scene builder -> frozen device SceneData.

The reference's Scene (Scene.cs) is a registry of IShape objects compiled
into a pointer k-d tree; intersection is virtual dispatch per shape. Here
`SceneBuilder` collects typed primitive descriptions on the host and
`build()` flattens them into `SceneData`: one SoA device table per primitive
type, a flattened wide-leaf BVH over all mesh triangles, an instance table
(the TransformedShape mechanism, TransformedShape.cs:19-72), a material
table, a texture atlas, and a light table for NEE (Scene.cs:29-38 auto
light classification).

SceneData is a registered dataclass pytree: array fields are jit-traced
(so materials/emitters stay differentiable and updatable without
recompiling), while structural metadata (SDF trees, volume grids, static
flags) ride as static aux data — changing scene *structure* retraces,
changing scene *parameters* does not.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace

import jax
import jax.numpy as jnp
import numpy as np

from ptsharp.accel import bvh as bvh_mod
from ptsharp.accel import wide as wide_mod
from ptsharp.geometry.mesh import TriMesh
from ptsharp.materials import Material, MaterialTable
from ptsharp.textures import TextureAtlas

# primitive type codes in hit records
PT_NONE = 0
PT_SPHERE = 1
PT_PLANE = 2
PT_CUBE = 3
PT_CYLINDER = 4
PT_TRIANGLE = 5
PT_SDF = 6
PT_VOLUME = 7
PT_FUNCTION = 8
# TLAS-only leaf kind: a mesh-instance entry (never appears in hit records;
# the traversal re-enters the instance's BLAS and records PT_TRIANGLE hits)
PT_INSTANCE = 9

_DATA_FIELDS = [
    "sphere_center", "sphere_radius", "sphere_inv", "sphere_world", "sphere_mat",
    "plane_point", "plane_normal", "plane_mat",
    "cube_min", "cube_max", "cube_inv", "cube_world", "cube_mat",
    "cyl_radius", "cyl_z0", "cyl_z1", "cyl_inv", "cyl_world", "cyl_mat",
    "node_bmin", "node_bmax", "node_first", "node_count", "node_skip",
    "tri_v0", "tri_e1", "tri_e2",
    "tri_n0", "tri_n1", "tri_n2",
    "tri_uv0", "tri_uv1", "tri_uv2", "tri_mat",
    "inst_inv", "inst_world", "inst_node_base", "inst_node_end", "inst_mat",
    "u_bmin", "u_bmax", "u_first", "u_count", "u_kind", "u_skip",
    "u_rows", "leaf_rows",
    "w_rows", "w_inst_base", "w_inst_end",
    "cluster_bmin", "cluster_bmax", "cluster_rows",
    "inst_cluster_base", "inst_cluster_end",
    "u_inst_base", "u_inst_end",
    "light_ptype", "light_pindex", "light_center", "light_radius", "light_mat",
    "light_tri_start", "light_tri_end", "light_area",
    "light_cdf", "light_pmf",
    "em_v0", "em_e1", "em_e2", "em_nrm", "em_cdf", "em_mat",
    "materials", "textures",
    "env_color", "texture_angle",
    "volume_data",
]
_META_FIELDS = [
    "sdf_objects", "volumes", "functions", "sphere_xform", "cube_xform",
    "cyl_xform", "max_leaf", "env_texture", "has_surface_maps",
    "tlas_end", "use_tlas", "intersector", "wide_k", "w_tlas_end",
    "light_types",
]


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=_DATA_FIELDS,
    meta_fields=_META_FIELDS,
)
@dataclass(frozen=True)
class SceneData:
    # spheres (object space center/radius + optional affine)
    sphere_center: jnp.ndarray
    sphere_radius: jnp.ndarray
    sphere_inv: jnp.ndarray    # (S, 3, 4) world->object
    sphere_world: jnp.ndarray  # (S, 3, 4) object->world
    sphere_mat: jnp.ndarray
    # infinite planes
    plane_point: jnp.ndarray
    plane_normal: jnp.ndarray
    plane_mat: jnp.ndarray
    # axis boxes
    cube_min: jnp.ndarray
    cube_max: jnp.ndarray
    cube_inv: jnp.ndarray
    cube_world: jnp.ndarray
    cube_mat: jnp.ndarray
    # capped z-cylinders
    cyl_radius: jnp.ndarray
    cyl_z0: jnp.ndarray
    cyl_z1: jnp.ndarray
    cyl_inv: jnp.ndarray
    cyl_world: jnp.ndarray
    cyl_mat: jnp.ndarray
    # flattened BVH over all mesh triangles (concatenated per-mesh blocks)
    node_bmin: jnp.ndarray
    node_bmax: jnp.ndarray
    node_first: jnp.ndarray
    node_count: jnp.ndarray
    node_skip: jnp.ndarray
    # BVH-sorted triangle soup + attributes
    tri_v0: jnp.ndarray
    tri_e1: jnp.ndarray
    tri_e2: jnp.ndarray
    tri_n0: jnp.ndarray
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_uv0: jnp.ndarray
    tri_uv1: jnp.ndarray
    tri_uv2: jnp.ndarray
    tri_mat: jnp.ndarray
    # mesh instances (identity transform for plain meshes)
    inst_inv: jnp.ndarray      # (I, 3, 4)
    inst_world: jnp.ndarray    # (I, 3, 4)
    inst_node_base: jnp.ndarray
    inst_node_end: jnp.ndarray
    inst_mat: jnp.ndarray      # material override, -1 = per-triangle
    # unified TLAS + BLAS node arrays (the Tree.cs:22-42 top-level accel,
    # flattened): nodes [0, tlas_end) form a BVH over *objects* (analytic
    # primitives + mesh instances); each mesh BLAS follows, skip-linked
    # within its own [base, end) range. u_kind: PT_NONE = internal,
    # PT_TRIANGLE = triangle leaf, PT_SPHERE/CUBE/CYLINDER = analytic
    # singleton leaf (u_first = primitive index), PT_INSTANCE = enter BLAS
    # (u_first = instance id).
    u_bmin: jnp.ndarray
    u_bmax: jnp.ndarray
    u_first: jnp.ndarray
    u_count: jnp.ndarray
    u_kind: jnp.ndarray
    u_skip: jnp.ndarray
    # packed hot-path tables: u_rows (N, 8) = one gather per node step
    # [bmin, bmax, bits(first), bits(skip<<12|kind<<8|count)]; leaf_rows
    # (n_leaves, leaf*9) = one gather per leaf visit [v0, e1, e2] per slot
    u_rows: jnp.ndarray
    leaf_rows: jnp.ndarray
    # K-wide node rows (accel/wide.py): the production traversal table.
    # One row = own box + K child boxes + K child preorder indices, so a
    # gathered row decides a K-way step without touching missed children.
    # Same unified layout as u_rows: [wide TLAS][wide BLAS per mesh].
    w_rows: jnp.ndarray        # (Nw, wide.row_width(K))
    w_inst_base: jnp.ndarray   # per-instance wide BLAS range
    w_inst_end: jnp.ndarray
    # cluster tables for the fixed-depth cull intersector: GROUP consecutive
    # leaf rows form one cluster; cluster_rows is a reshape of leaf_rows so
    # cluster c's triangles occupy slots [c*G*leaf, (c+1)*G*leaf)
    cluster_bmin: jnp.ndarray  # (C, 3)
    cluster_bmax: jnp.ndarray
    cluster_rows: jnp.ndarray  # (C, GROUP*leaf*9)
    inst_cluster_base: jnp.ndarray  # per-instance cluster range
    inst_cluster_end: jnp.ndarray
    u_inst_base: jnp.ndarray  # per-instance BLAS start in unified space
    u_inst_end: jnp.ndarray
    # light table for NEE
    light_ptype: jnp.ndarray
    light_pindex: jnp.ndarray
    light_center: jnp.ndarray
    light_radius: jnp.ndarray
    light_mat: jnp.ndarray
    # per-triangle emissive light geometry (PT_TRIANGLE lights sample a
    # world-space triangle proportional to area instead of the reference's
    # bounding-disc proxy; Scene.cs:29-38 registers shapes, Sampler.cs:212-296
    # samples them). light_tri_start/end index [start, end) into em_*.
    light_tri_start: jnp.ndarray
    light_tri_end: jnp.ndarray
    light_area: jnp.ndarray   # total emissive area per light (0 = non-tri)
    # power-proportional light selection (LIGHT_MODE_POWER): pmf ~
    # emittance * luminance * surface-area proxy. Keeps many-light NEE
    # (reference runway, Example.cs:1028-1082) one traversal per bounce
    # with variance concentrated on the bright lights.
    light_cdf: jnp.ndarray    # (L,) cumulative pmf, last entry 1
    light_pmf: jnp.ndarray    # (L,) selection probability per light
    em_v0: jnp.ndarray        # (E, 3) world space
    em_e1: jnp.ndarray
    em_e2: jnp.ndarray
    em_nrm: jnp.ndarray       # (E, 3) unit face normal, world space
    em_cdf: jnp.ndarray       # (E,) cumulative area within its light, (0, 1]
    em_mat: jnp.ndarray       # (E,) material id of the emissive triangle
    # materials / textures / environment
    materials: MaterialTable
    textures: TextureAtlas
    env_color: jnp.ndarray
    texture_angle: jnp.ndarray
    volume_data: tuple  # per-volume (W, H, D) device grids (traced args)
    # --- static metadata ---
    sdf_objects: tuple  # tuple of (Sdf, mat_id, bmin_tuple, bmax_tuple)
    volumes: tuple      # tuple of VolumeGrid (identity-hashed)
    functions: tuple    # tuple of (Heightfield, mat_id)
    sphere_xform: bool
    cube_xform: bool
    cyl_xform: bool
    max_leaf: int
    env_texture: int
    has_surface_maps: bool
    tlas_end: int    # number of TLAS nodes at the head of the u_* arrays
    use_tlas: bool   # static dispatch: unified traversal vs per-type passes
    intersector: str  # mesh path: "wide"/"walk"/"cluster"/"pallas"
    wide_k: int       # branching factor of the wide node rows
    w_tlas_end: int   # wide TLAS node count at the head of w_rows
    light_types: tuple  # sorted set of PT_* codes among registered lights
    # (static: lets the integrator pick the analytic any-hit shadow path
    # when every light's own hit distance is cheap to compute)
    @property
    def num_lights(self) -> int:
        return self.light_mat.shape[0]


def _affine(m: np.ndarray) -> np.ndarray:
    return np.asarray(m, np.float32)[:3, :4]


_IDENTITY34 = np.eye(4, dtype=np.float32)[:3, :4]

# consecutive leaf rows per cluster for the fixed-depth cull intersector
# (leaf preorder = BVH locality, so consecutive leaves cluster well)
CLUSTER_GROUP = 16


def _xform_aabb(world34: np.ndarray, lo, hi):
    """Conservative world AABB of an object-space AABB under an affine
    transform (Matrix.MulBox semantics, Matrix.cs:157-173): transform the 8
    corners, re-box."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    corners = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
         for z in (lo[2], hi[2])],
        np.float32,
    )
    w = corners @ np.asarray(world34, np.float32)[:, :3].T + world34[:, 3]
    return w.min(axis=0), w.max(axis=0)


class SceneBuilder:
    """Collects shapes + materials on the host; `build()` freezes them into
    device arrays. Emissive shapes are auto-registered as NEE lights
    (Scene.cs:29-38)."""

    def __init__(self):
        self._materials: list[Material] = []
        self._mat_ids: dict[Material, int] = {}
        self._spheres = []   # (center, radius, inv, world, mat)
        self._planes = []
        self._cubes = []
        self._cyls = []
        self._meshes: list[tuple[TriMesh, int]] = []  # (mesh, default mat)
        self._instances = []  # (mesh_idx, inv, world, mat_override)
        self._sdfs = []
        self._volumes = []
        self._functions = []
        self._lights = []     # (ptype, pindex, center, radius, mat)
        self._textures: list[np.ndarray] = []
        self.env_color = np.zeros(3, np.float32)
        self.env_texture = -1
        self.texture_angle = 0.0

    # -- materials / textures ---------------------------------------------

    def material_id(self, m: Material) -> int:
        if m not in self._mat_ids:
            self._mat_ids[m] = len(self._materials)
            self._materials.append(m)
        return self._mat_ids[m]

    def add_texture(self, image: np.ndarray) -> int:
        """Register an (H, W, 3) linear-RGB image; returns its atlas id."""
        self._textures.append(np.asarray(image, np.float32))
        return len(self._textures) - 1

    def set_environment(self, color=None, texture_id: int = -1, angle: float = 0.0):
        if color is not None:
            self.env_color = np.asarray(color, np.float32)
        self.env_texture = texture_id
        self.texture_angle = float(angle)

    # -- shapes ------------------------------------------------------------

    def _register_light(self, ptype, pindex, center, radius, mat_id, m: Material):
        if m.emittance > 0:
            self._lights.append((ptype, pindex, np.asarray(center, np.float32),
                                 float(radius), mat_id))

    def add_sphere(self, center, radius, material: Material, transform=None) -> int:
        mid = self.material_id(material)
        center = np.asarray(center, np.float32)
        inv, world = _IDENTITY34, _IDENTITY34
        wcenter, wradius = center, radius
        if transform is not None:
            t = np.asarray(transform, np.float32)
            inv, world = _affine(np.linalg.inv(t)), _affine(t)
            wcenter = t[:3, :3] @ center + t[:3, 3]
            wradius = radius * float(np.linalg.norm(t[:3, :3], 2))
        idx = len(self._spheres)
        self._spheres.append((center, float(radius), inv, world, mid))
        self._register_light(PT_SPHERE, idx, wcenter, wradius, mid, material)
        return idx

    def add_plane(self, point, normal, material: Material) -> int:
        # An infinite plane has no finite light geometry: the reference
        # silently samples its infinite bounding box (Sampler.cs:231-233 via
        # Plane.cs:31-34), which degenerates to full-coverage light from any
        # point. Reject instead; use an emissive quad mesh (quad_mesh) or a
        # thin cube for an area light.
        if material.emittance > 0:
            raise ValueError(
                "emissive infinite planes are not supported as NEE lights; "
                "use an emissive quad mesh or thin cube instead"
            )
        mid = self.material_id(material)
        idx = len(self._planes)
        n = np.asarray(normal, np.float32)
        n = n / max(np.linalg.norm(n), 1e-20)
        self._planes.append((np.asarray(point, np.float32), n, mid))
        return idx

    def add_cube(self, bmin, bmax, material: Material, transform=None) -> int:
        mid = self.material_id(material)
        bmin = np.asarray(bmin, np.float32)
        bmax = np.asarray(bmax, np.float32)
        inv, world = _IDENTITY34, _IDENTITY34
        center = 0.5 * (bmin + bmax)
        radius = 0.5 * float(np.linalg.norm(bmax - bmin))
        if transform is not None:
            t = np.asarray(transform, np.float32)
            inv, world = _affine(np.linalg.inv(t)), _affine(t)
            center = t[:3, :3] @ center + t[:3, 3]
            radius *= float(np.linalg.norm(t[:3, :3], 2))
        idx = len(self._cubes)
        self._cubes.append((bmin, bmax, inv, world, mid))
        self._register_light(PT_CUBE, idx, center, radius, mid, material)
        return idx

    def add_cylinder(self, radius, z0, z1, material: Material, transform=None) -> int:
        """Z-axis capped cylinder; pass `transform` for arbitrary placement
        (NewTransformedCylinder, Cylinder.cs:21-35)."""
        mid = self.material_id(material)
        inv, world = _IDENTITY34, _IDENTITY34
        center = np.array([0.0, 0.0, (z0 + z1) / 2.0], np.float32)
        rad = float(np.hypot(radius, (z1 - z0) / 2.0))
        if transform is not None:
            t = np.asarray(transform, np.float32)
            inv, world = _affine(np.linalg.inv(t)), _affine(t)
            center = t[:3, :3] @ center + t[:3, 3]
            rad *= float(np.linalg.norm(t[:3, :3], 2))
        idx = len(self._cyls)
        self._cyls.append((float(radius), float(z0), float(z1), inv, world, mid))
        self._register_light(PT_CYLINDER, idx, center, rad, mid, material)
        return idx

    def add_mesh(self, mesh: TriMesh, material: Material | None = None,
                 transform=None) -> int:
        """Add a mesh; returns mesh id usable with add_mesh_instance.
        material=None keeps per-triangle materials (OBJ with MTL); else all
        triangles use `material`."""
        mid = -1 if material is None else self.material_id(material)
        mesh_idx = len(self._meshes)
        self._meshes.append((mesh, mid))
        self.add_mesh_instance(mesh_idx, transform=transform, material=material)
        return mesh_idx

    def add_mesh_instance(self, mesh_idx: int, transform=None,
                          material: Material | None = None) -> int:
        over = -1 if material is None else self.material_id(material)
        inv, world = _IDENTITY34, _IDENTITY34
        if transform is not None:
            t = np.asarray(transform, np.float32)
            inv, world = _affine(np.linalg.inv(t)), _affine(t)
        idx = len(self._instances)
        self._instances.append((mesh_idx, inv, world, over))
        mesh, def_mid = self._meshes[mesh_idx]
        mat = material if material is not None else (
            self._materials[def_mid] if def_mid >= 0 else None
        )
        emissive = mat is not None and mat.emittance > 0
        if not emissive and mat is None and mesh.mat is not None:
            # per-triangle materials (OBJ Ke): any emissive triangle makes
            # the instance a light (Scene.cs:29-38 auto-classification)
            ids = np.unique(mesh.mat)
            emissive = any(self._materials[int(m)].emittance > 0 for m in ids)
            if emissive:
                mat = next(self._materials[int(m)] for m in ids
                           if self._materials[int(m)].emittance > 0)
        if emissive:
            lo, hi = mesh.bounds()
            center = 0.5 * (lo + hi)
            radius = 0.5 * float(np.linalg.norm(hi - lo))
            if transform is not None:
                t = np.asarray(transform, np.float32)
                center = t[:3, :3] @ center + t[:3, 3]
                radius *= float(np.linalg.norm(t[:3, :3], 2))
            # mesh lights are identified by instance id in the hit record
            self._lights.append((PT_TRIANGLE, idx, center, radius,
                                 self.material_id(mat)))
        return idx

    def add_sdf(self, sdf, material: Material) -> int:
        mid = self.material_id(material)
        idx = len(self._sdfs)
        lo, hi = sdf.bounds()
        self._sdfs.append((sdf, mid, tuple(map(float, lo)), tuple(map(float, hi))))
        if material.emittance > 0:
            center = 0.5 * (np.asarray(lo) + np.asarray(hi))
            radius = 0.5 * float(np.linalg.norm(np.asarray(hi) - np.asarray(lo)))
            self._lights.append((PT_SDF, idx, center.astype(np.float32), radius, mid))
        return idx

    def add_function(self, heightfield, material: Material) -> int:
        """Register a z < f(x, y) heightfield shape (Function.cs parity)."""
        mid = self.material_id(material)
        self._functions.append((heightfield, mid))
        return len(self._functions) - 1

    def add_volume(self, volume) -> int:
        """volume: geometry.volume.VolumeGrid whose windows carry material
        *ids* already registered via material_id()."""
        self._volumes.append(volume)
        return len(self._volumes) - 1

    # -- freeze ------------------------------------------------------------

    def build(self, leaf_size: int = 8, use_tlas: bool | None = None,
              intersector: str | None = None,
              wide_k: int = 4) -> SceneData:
        """intersector: mesh triangle path. None (the default) picks by
        backend: "pallas" on a GPU where the scene does not use the TLAS,
        "wide" otherwise. "wide" (K-wide node rows: one
        gather per arrived node tests K child boxes, the fewest gathers per
        ray), "walk" (binary packed skip-link walk) or "cluster"
        (fixed-depth cull, divergence-insensitive by construction). Cluster
        tables are only materialized when the cluster intersector is
        selected (they duplicate all leaf geometry in device memory).

        "pallas" runs the same K-wide walk as one per-lane GPU kernel
        (pallas/traverse_gpu.py) over the same tables. The kernel walks
        each instance's BLAS, so it forces per-instance dispatch (no
        unified TLAS re-entry)."""
        if intersector not in (None, "wide", "walk", "cluster", "pallas"):
            raise ValueError(f"unknown intersector {intersector!r}")
        if intersector == "pallas":
            if use_tlas:
                raise ValueError("the pallas intersector is per-instance; "
                                 "use_tlas must not be set")
            use_tlas = False
        f32 = jnp.float32
        i32 = jnp.int32

        def soa(rows, idx, shape, dtype=np.float32):
            if rows:
                return jnp.asarray(np.stack([np.asarray(r[idx], dtype) for r in rows]))
            return jnp.zeros((0,) + shape, dtype)

        # --- meshes: one BVH per mesh; triangles re-laid into padded leaf
        # SLOTS so a leaf's whole block is ONE contiguous row (n_leaves,
        # leaf*9), so traversal fetches a node row + a leaf row instead of
        # ~29 scattered rows per step.
        node_bmin = []
        node_bmax = []
        node_first = []  # leaf -> SLOT start (leaf_ord * leaf_size + offset)
        node_count = []
        node_skip = []
        tri_v = []      # slot-ordered, padded with degenerate zeros
        tri_n = []
        tri_uv = []
        tri_mat = []
        leaf_rows_l = []  # (n_leaves, leaf*9) packed [v0, e1, e2] per slot
        cl_bmin_l = []    # (n_clusters, 3) cluster AABBs
        cl_bmax_l = []
        mesh_node_range = []  # per mesh: (base, end)
        mesh_slot_range = []  # per mesh: scene slot range [lo, hi)
        mesh_cluster_range = []  # per mesh: (cbase, cend)
        mesh_root_bounds = []  # per mesh: (lo, hi) of the BVH root
        mesh_wide = []  # per mesh: WideBVH (K-wide collapse of the BLAS)
        build_cluster = intersector == "cluster"
        slot_offset = 0
        node_offset = 0
        cluster_offset = 0
        for mesh, def_mid in self._meshes:
            mesh = mesh.fix_normals()
            v = mesh.v
            lo = np.minimum(np.minimum(v[:, 0], v[:, 1]), v[:, 2])
            hi = np.maximum(np.maximum(v[:, 0], v[:, 1]), v[:, 2])
            flat = bvh_mod.build(lo, hi, leaf_size=leaf_size)
            order = flat.order
            sv = v[order]
            sn = mesh.n[order]
            suv = mesh.uv[order]
            if mesh.mat is not None and def_mid < 0:
                tm = mesh.mat[order]  # per-triangle materials (OBJ/MTL)
            else:
                tm = np.full(v.shape[0], max(def_mid, 0), np.int32)

            # slot re-layout: every leaf owns exactly leaf_size slots
            leaf_ids = np.where(flat.count > 0)[0]
            nl = leaf_ids.shape[0]
            firsts = flat.first[leaf_ids]
            counts = flat.count[leaf_ids]
            lanes = np.arange(leaf_size, dtype=np.int32)
            src = firsts[:, None] + lanes[None, :]
            valid = lanes[None, :] < counts[:, None]
            src = np.where(valid, src, 0).reshape(-1)
            vmask = valid.reshape(-1)
            slot_v = np.where(vmask[:, None, None], sv[src], 0.0).astype(np.float32)
            slot_n = np.where(vmask[:, None, None], sn[src], 0.0).astype(np.float32)
            slot_uv = np.where(vmask[:, None, None], suv[src], 0.0).astype(np.float32)
            slot_m = np.where(vmask, tm[src], 0).astype(np.int32)

            new_first = flat.first.copy()
            new_first[leaf_ids] = (
                np.arange(nl, dtype=np.int32) * leaf_size + slot_offset
            )

            # pad leaf count to a CLUSTER_GROUP multiple (zero slots never
            # hit: degenerate triangles have det == 0)
            lpad = (-nl) % CLUSTER_GROUP
            if lpad:
                zpad = lpad * leaf_size
                slot_v = np.concatenate(
                    [slot_v, np.zeros((zpad, 3, 3), np.float32)])
                slot_n = np.concatenate(
                    [slot_n, np.zeros((zpad, 3, 3), np.float32)])
                slot_uv = np.concatenate(
                    [slot_uv, np.zeros((zpad, 3, 2), np.float32)])
                slot_m = np.concatenate([slot_m, np.zeros(zpad, np.int32)])
            nlp = nl + lpad

            e1s = slot_v[:, 1] - slot_v[:, 0]
            e2s = slot_v[:, 2] - slot_v[:, 0]
            rows = np.concatenate([slot_v[:, 0], e1s, e2s], axis=1)  # (S, 9)
            leaf_rows_l.append(rows.reshape(nlp, leaf_size * 9))

            # cluster AABBs from leaf bounds (padded with inverted boxes);
            # only materialized for the cluster intersector — they
            # duplicate every leaf's geometry in device memory otherwise
            nc = nlp // CLUSTER_GROUP
            if build_cluster:
                lb_min = np.full((nlp, 3), np.float32(np.inf))
                lb_max = np.full((nlp, 3), np.float32(-np.inf))
                lb_min[:nl] = flat.bmin[leaf_ids]
                lb_max[:nl] = flat.bmax[leaf_ids]
                cl_bmin_l.append(lb_min.reshape(nc, CLUSTER_GROUP, 3).min(axis=1))
                cl_bmax_l.append(lb_max.reshape(nc, CLUSTER_GROUP, 3).max(axis=1))
            mesh_cluster_range.append((cluster_offset, cluster_offset + nc))
            cluster_offset += nc

            # K-wide collapse of this mesh's BLAS (local skip links; the
            # packer re-bases indices when the unified table is assembled)
            mesh_wide.append(wide_mod.collapse(
                flat.bmin, flat.bmax, new_first, flat.count, flat.skip,
                kind=np.where(flat.count > 0, PT_TRIANGLE, PT_NONE).astype(np.int32),
                k=wide_k,
            ))

            tri_v.append(slot_v)
            tri_n.append(slot_n)
            tri_uv.append(slot_uv)
            tri_mat.append(slot_m)
            node_bmin.append(flat.bmin)
            node_bmax.append(flat.bmax)
            node_first.append(new_first)
            node_count.append(flat.count)
            node_skip.append(flat.skip + node_offset)
            mesh_node_range.append((node_offset, node_offset + flat.bmin.shape[0]))
            mesh_root_bounds.append((flat.bmin[0].copy(), flat.bmax[0].copy()))
            # advance by the PADDED leaf count: leaf_rows/tri arrays carry
            # nlp = nl + lpad leaves for this mesh, so the next mesh's slot
            # indices must start after the padding too
            mesh_slot_range.append((slot_offset,
                                    slot_offset + nlp * leaf_size))
            slot_offset += nlp * leaf_size
            node_offset += flat.bmin.shape[0]

        if self._meshes:
            tv = np.concatenate(tri_v)
            tn = np.concatenate(tri_n)
            tuv = np.concatenate(tri_uv)
            tmat = np.concatenate(tri_mat)
            leaf_rows = np.concatenate(leaf_rows_l)
            if build_cluster:
                cl_bmin = np.concatenate(cl_bmin_l)
                cl_bmax = np.concatenate(cl_bmax_l)
                cluster_rows = leaf_rows.reshape(
                    cl_bmin.shape[0], CLUSTER_GROUP * leaf_size * 9
                )
            else:
                cl_bmin = np.zeros((0, 3), np.float32)
                cl_bmax = np.zeros((0, 3), np.float32)
                cluster_rows = np.zeros((0, CLUSTER_GROUP * leaf_size * 9),
                                        np.float32)
            v0, v1, v2 = tv[:, 0], tv[:, 1], tv[:, 2]
            nodes = (
                np.concatenate(node_bmin),
                np.concatenate(node_bmax),
                np.concatenate(node_first),
                np.concatenate(node_count),
                np.concatenate(node_skip),
            )
        else:
            v0 = v1 = v2 = np.zeros((0, 3), np.float32)
            tn = np.zeros((0, 3, 3), np.float32)
            tuv = np.zeros((0, 3, 2), np.float32)
            tmat = np.zeros(0, np.int32)
            leaf_rows = np.zeros((0, leaf_size * 9), np.float32)
            cl_bmin = np.zeros((0, 3), np.float32)
            cl_bmax = np.zeros((0, 3), np.float32)
            cluster_rows = np.zeros((0, CLUSTER_GROUP * leaf_size * 9),
                                    np.float32)
            nodes = (
                np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32),
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
            )

        inst_rows = []
        inst_cluster = []
        for mesh_idx, inv, world, over in self._instances:
            base, end = mesh_node_range[mesh_idx]
            inst_rows.append((inv, world, base, end, over))
            inst_cluster.append(mesh_cluster_range[mesh_idx])

        # --- TLAS over all objects (Tree.cs:22-42, Scene.cs:56-66) ---------
        # One flattened BVH whose singleton leaves are typed object entries;
        # mesh-instance leaves re-enter the instance's BLAS during traversal.
        obj_kind = []
        obj_index = []
        obj_lo = []
        obj_hi = []

        def add_obj(kind, index, lo, hi, world):
            lo2, hi2 = _xform_aabb(world, lo, hi)
            obj_kind.append(kind)
            obj_index.append(index)
            obj_lo.append(lo2)
            obj_hi.append(hi2)

        for i, (center, radius, _inv, world, _mid) in enumerate(self._spheres):
            add_obj(PT_SPHERE, i, center - radius, center + radius, world)
        for i, (bmn, bmx, _inv, world, _mid) in enumerate(self._cubes):
            add_obj(PT_CUBE, i, bmn, bmx, world)
        for i, (rad, z0, z1, _inv, world, _mid) in enumerate(self._cyls):
            add_obj(PT_CYLINDER, i, [-rad, -rad, z0], [rad, rad, z1], world)
        for i, (mesh_idx, _inv, world, _over) in enumerate(self._instances):
            lo, hi = mesh_root_bounds[mesh_idx]
            add_obj(PT_INSTANCE, i, lo, hi, world)

        n_obj = len(obj_kind)
        if n_obj > 0:
            tl = bvh_mod.build(
                np.stack(obj_lo), np.stack(obj_hi), leaf_size=1
            )
            tlas_n = tl.bmin.shape[0]
            t_kind = np.zeros(tlas_n, np.int32)
            t_first = np.zeros(tlas_n, np.int32)
            leaf_mask = tl.count > 0
            ids = tl.order[tl.first[leaf_mask]]
            t_kind[leaf_mask] = np.asarray(obj_kind, np.int32)[ids]
            t_first[leaf_mask] = np.asarray(obj_index, np.int32)[ids]
            u_bmin = np.concatenate([tl.bmin, nodes[0]])
            u_bmax = np.concatenate([tl.bmax, nodes[1]])
            u_first = np.concatenate([t_first, nodes[2]])
            u_count = np.concatenate([tl.count, nodes[3]])
            u_kind = np.concatenate(
                [t_kind, np.where(nodes[3] > 0, PT_TRIANGLE, PT_NONE).astype(np.int32)]
            )
            u_skip = np.concatenate([tl.skip, nodes[4] + tlas_n])
            wide_tlas = wide_mod.collapse(
                tl.bmin, tl.bmax, t_first, tl.count, tl.skip, kind=t_kind,
                k=wide_k,
            )
        else:
            tlas_n = 0
            u_bmin = np.zeros((0, 3), np.float32)
            u_bmax = np.zeros((0, 3), np.float32)
            u_first = np.zeros(0, np.int32)
            u_count = np.zeros(0, np.int32)
            u_kind = np.zeros(0, np.int32)
            u_skip = np.zeros(0, np.int32)
            wide_tlas = None

        # packed binary node rows: ONE row gather fetches a whole node
        # [bmin(3), bmax(3), bits(first), bits(kind<<8 | count), bits(skip)]
        # — skip owns a full int32 slot, so node counts are uncapped
        # (871k-tri dragon scale, Example.cs:977)
        n_u = u_bmin.shape[0]
        assert leaf_size <= 255
        u_rows = np.zeros((n_u, 10), np.float32)
        u_rows[:, 0:3] = u_bmin
        u_rows[:, 3:6] = u_bmax
        u_rows[:, 6] = u_first.astype(np.int32).view(np.float32)
        meta_bits = (
            (u_kind.astype(np.int64) << 8)
            | np.minimum(u_count, 255).astype(np.int64)
        ).astype(np.int32)
        u_rows[:, 7] = meta_bits.view(np.float32)
        u_rows[:, 8] = u_skip.astype(np.int32).view(np.float32)

        # unified K-wide table: [wide TLAS][wide BLAS per mesh]
        w_parts = []
        w_off = 0
        if wide_tlas is not None:
            w_parts.append(wide_mod.pack_rows(wide_tlas, 0))
            w_off = wide_tlas.bmin.shape[0]
        w_tlas_n = w_off
        w_mesh_range = []
        for wmesh in mesh_wide:
            w_parts.append(wide_mod.pack_rows(wmesh, w_off))
            nwm = wmesh.bmin.shape[0]
            w_mesh_range.append((w_off, w_off + nwm))
            w_off += nwm
        w_rows = (np.concatenate(w_parts) if w_parts
                  else np.zeros((0, wide_mod.row_width(wide_k)), np.float32))
        w_inst_b = np.asarray(
            [w_mesh_range[mi][0] for mi, *_ in self._instances], np.int32
        ) if self._instances else np.zeros(0, np.int32)
        w_inst_e = np.asarray(
            [w_mesh_range[mi][1] for mi, *_ in self._instances], np.int32
        ) if self._instances else np.zeros(0, np.int32)

        # --- per-triangle emissive light geometry ---------------------------
        # For each PT_TRIANGLE light, collect its instance's emissive
        # triangles in world space with an area CDF for proportional NEE
        # sampling (replaces the bounding-sphere disc proxy).
        em_v0l, em_e1l, em_e2l, em_nl, em_cdfl, em_matl = [], [], [], [], [], []
        lt_start = np.zeros(len(self._lights), np.int32)
        lt_end = np.zeros(len(self._lights), np.int32)
        lt_area = np.zeros(len(self._lights), np.float32)
        cursor = 0
        for li, (ptype, pindex, _c, _r, _lm) in enumerate(self._lights):
            if ptype != PT_TRIANGLE:
                continue
            mesh_idx, _inv, world, over = self._instances[pindex]
            mesh, def_mid = self._meshes[mesh_idx]
            t_count = mesh.v.shape[0]
            if over >= 0:
                mids = np.full(t_count, over, np.int32)
            elif mesh.mat is not None:
                mids = np.asarray(mesh.mat, np.int32)
            else:
                mids = np.full(t_count, max(def_mid, 0), np.int32)
            emit_lut = np.asarray(
                [m.emittance for m in self._materials], np.float32
            )
            sel = emit_lut[mids] > 0
            if not sel.any():
                continue
            wv = mesh.v[sel] @ world[:3, :3].T + world[:3, 3]
            e1 = wv[:, 1] - wv[:, 0]
            e2 = wv[:, 2] - wv[:, 0]
            cr = np.cross(e1, e2)
            area2 = np.linalg.norm(cr, axis=1)
            area = 0.5 * area2
            nrm = cr / np.maximum(area2, 1e-20)[:, None]
            total = float(area.sum())
            cdf = np.cumsum(area) / max(total, 1e-20)
            em_v0l.append(wv[:, 0].astype(np.float32))
            em_e1l.append(e1.astype(np.float32))
            em_e2l.append(e2.astype(np.float32))
            em_nl.append(nrm.astype(np.float32))
            em_cdfl.append(cdf.astype(np.float32))
            em_matl.append(mids[sel])
            lt_start[li] = cursor
            cursor += int(sel.sum())
            lt_end[li] = cursor
            lt_area[li] = total

        def cat(parts, shape, dtype=np.float32):
            if parts:
                return jnp.asarray(np.concatenate(parts).astype(dtype))
            return jnp.zeros((0,) + shape, dtype)

        # power-proportional light pmf/cdf: emittance x luminance x area
        # proxy (emissive triangle area for mesh lights, bounding r^2
        # otherwise)
        n_l = len(self._lights)
        if n_l:
            lum = np.array([0.2126, 0.7152, 0.0722], np.float32)
            power = np.zeros(n_l, np.float32)
            for li, (ptype, _pi, _c, rad, lm) in enumerate(self._lights):
                m = self._materials[lm]
                area = (lt_area[li] if ptype == PT_TRIANGLE
                        else max(rad * rad, 1e-8))
                power[li] = m.emittance * float(
                    np.dot(np.asarray(m.color, np.float32), lum)) * area
            total = float(power.sum())
            pmf = (power / total if total > 0
                   else np.full(n_l, 1.0 / n_l, np.float32))
            cdf = np.cumsum(pmf).astype(np.float32)
            cdf[-1] = 1.0
        else:
            pmf = np.zeros(0, np.float32)
            cdf = np.zeros(0, np.float32)

        if use_tlas is None:
            # heuristic: brute-force per-type passes win for small object
            # counts (vectorized slab tests, zero gathers); the TLAS wins
            # for instancing (no Python-unrolled traversals) and big object
            # soups. Threshold measured on cube_field-style scenes.
            n_analytic = len(self._spheres) + len(self._cubes) + len(self._cyls)
            use_tlas = len(self._instances) > 1 or n_analytic >= 64
        use_tlas = bool(use_tlas and n_obj > 0)
        if intersector is None:
            # the per-lane kernel walks each instance's BLAS, so TLAS
            # scenes keep the XLA walk; the CPU runs the XLA walk
            gpu = jax.default_backend() == "gpu"
            intersector = "pallas" if gpu and not use_tlas else "wide"

        sphere_x = any(
            not np.array_equal(s[2], _IDENTITY34) for s in self._spheres
        )
        cube_x = any(not np.array_equal(c[2], _IDENTITY34) for c in self._cubes)
        cyl_x = any(not np.array_equal(c[3], _IDENTITY34) for c in self._cyls)

        return SceneData(
            sphere_center=soa(self._spheres, 0, (3,)),
            sphere_radius=soa(self._spheres, 1, ()),
            sphere_inv=soa(self._spheres, 2, (3, 4)),
            sphere_world=soa(self._spheres, 3, (3, 4)),
            sphere_mat=soa(self._spheres, 4, (), np.int32),
            plane_point=soa(self._planes, 0, (3,)),
            plane_normal=soa(self._planes, 1, (3,)),
            plane_mat=soa(self._planes, 2, (), np.int32),
            cube_min=soa(self._cubes, 0, (3,)),
            cube_max=soa(self._cubes, 1, (3,)),
            cube_inv=soa(self._cubes, 2, (3, 4)),
            cube_world=soa(self._cubes, 3, (3, 4)),
            cube_mat=soa(self._cubes, 4, (), np.int32),
            cyl_radius=soa(self._cyls, 0, ()),
            cyl_z0=soa(self._cyls, 1, ()),
            cyl_z1=soa(self._cyls, 2, ()),
            cyl_inv=soa(self._cyls, 3, (3, 4)),
            cyl_world=soa(self._cyls, 4, (3, 4)),
            cyl_mat=soa(self._cyls, 5, (), np.int32),
            node_bmin=jnp.asarray(nodes[0]),
            node_bmax=jnp.asarray(nodes[1]),
            node_first=jnp.asarray(nodes[2]),
            node_count=jnp.asarray(nodes[3]),
            node_skip=jnp.asarray(nodes[4]),
            tri_v0=jnp.asarray(v0),
            tri_e1=jnp.asarray(v1 - v0),
            tri_e2=jnp.asarray(v2 - v0),
            tri_n0=jnp.asarray(tn[:, 0] if tn.size else tn.reshape(0, 3)),
            tri_n1=jnp.asarray(tn[:, 1] if tn.size else tn.reshape(0, 3)),
            tri_n2=jnp.asarray(tn[:, 2] if tn.size else tn.reshape(0, 3)),
            tri_uv0=jnp.asarray(tuv[:, 0] if tuv.size else tuv.reshape(0, 2)),
            tri_uv1=jnp.asarray(tuv[:, 1] if tuv.size else tuv.reshape(0, 2)),
            tri_uv2=jnp.asarray(tuv[:, 2] if tuv.size else tuv.reshape(0, 2)),
            tri_mat=jnp.asarray(tmat),
            inst_inv=soa(inst_rows, 0, (3, 4)),
            inst_world=soa(inst_rows, 1, (3, 4)),
            inst_node_base=soa(inst_rows, 2, (), np.int32),
            inst_node_end=soa(inst_rows, 3, (), np.int32),
            inst_mat=soa(inst_rows, 4, (), np.int32),
            u_bmin=jnp.asarray(u_bmin),
            u_bmax=jnp.asarray(u_bmax),
            u_first=jnp.asarray(u_first),
            u_count=jnp.asarray(u_count),
            u_kind=jnp.asarray(u_kind),
            u_skip=jnp.asarray(u_skip),
            u_rows=jnp.asarray(u_rows),
            leaf_rows=jnp.asarray(leaf_rows),
            w_rows=jnp.asarray(w_rows),
            w_inst_base=jnp.asarray(w_inst_b),
            w_inst_end=jnp.asarray(w_inst_e),
            cluster_bmin=jnp.asarray(cl_bmin),
            cluster_bmax=jnp.asarray(cl_bmax),
            cluster_rows=jnp.asarray(cluster_rows),
            inst_cluster_base=jnp.asarray(
                np.asarray([c[0] for c in inst_cluster], np.int32)),
            inst_cluster_end=jnp.asarray(
                np.asarray([c[1] for c in inst_cluster], np.int32)),
            u_inst_base=soa(inst_rows, 2, (), np.int32) + tlas_n,
            u_inst_end=soa(inst_rows, 3, (), np.int32) + tlas_n,
            light_ptype=soa(self._lights, 0, (), np.int32),
            light_pindex=soa(self._lights, 1, (), np.int32),
            light_center=soa(self._lights, 2, (3,)),
            light_radius=soa(self._lights, 3, ()),
            light_mat=soa(self._lights, 4, (), np.int32),
            light_tri_start=jnp.asarray(lt_start),
            light_tri_end=jnp.asarray(lt_end),
            light_area=jnp.asarray(lt_area),
            light_cdf=jnp.asarray(cdf),
            light_pmf=jnp.asarray(pmf),
            em_v0=cat(em_v0l, (3,)),
            em_e1=cat(em_e1l, (3,)),
            em_e2=cat(em_e2l, (3,)),
            em_nrm=cat(em_nl, (3,)),
            em_cdf=cat(em_cdfl, ()),
            em_mat=cat(em_matl, (), np.int32),
            materials=MaterialTable.build(self._materials),
            textures=TextureAtlas.build(self._textures),
            env_color=jnp.asarray(self.env_color),
            texture_angle=jnp.float32(self.texture_angle),
            volume_data=tuple(jnp.asarray(v.data) for v in self._volumes),
            sdf_objects=tuple(self._sdfs),
            volumes=tuple(self._volumes),
            functions=tuple(self._functions),
            sphere_xform=sphere_x,
            cube_xform=cube_x,
            cyl_xform=cyl_x,
            max_leaf=leaf_size,
            env_texture=self.env_texture,
            tlas_end=int(tlas_n),
            use_tlas=use_tlas,
            intersector=intersector,
            wide_k=int(wide_k),
            w_tlas_end=int(w_tlas_n),
            light_types=tuple(sorted({lt[0] for lt in self._lights})),
            has_surface_maps=any(
                m.normal_texture >= 0 or m.bump_texture >= 0
                for m in self._materials
            ),
        )
