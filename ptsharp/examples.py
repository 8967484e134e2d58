"""Scene catalog — the acceptance suite mirroring reference Example.cs.

Each builder returns (scene, camera, render_config, integrator_config).
Scenes cite their reference counterpart; BASELINE.json's five configs map to
simple_sphere (#1), cornell (#2), mesh/bunny (#3), sdf_scene + ellipsoid
(#4), volume_scene (#5).
"""

from __future__ import annotations

import math

import numpy as np

from ptsharp.camera import Camera
from ptsharp.core import color as colorlib
from ptsharp.core import transform
from ptsharp.geometry import sdf as sdf_mod
from ptsharp.geometry import volume as vol_mod
from ptsharp.geometry.mesh import TriMesh, cube_mesh, sphere_mesh
from ptsharp.integrator import (
    LIGHT_MODE_ALL,
    LIGHT_MODE_RANDOM,
    IntegratorConfig,
    SPECULAR_MODE_FIRST,
)
from ptsharp.materials import (
    clear_material,
    diffuse_material,
    glossy_material,
    light_material,
    metallic_material,
    specular_material,
    transparent_material,
)
from ptsharp.renderer import RenderConfig
from ptsharp.scene import SceneBuilder

CATALOG = {}


def example(name):
    def deco(fn):
        CATALOG[name] = fn
        return fn

    return deco


@example("simple_sphere")
def simple_sphere(width=256, height=256):
    """BASELINE config #1: diffuse sphere + ground plane + sphere light
    (reference simplesphere, Example.cs:1670)."""
    b = SceneBuilder()
    b.add_sphere([0, 1, 0], 1.0, diffuse_material([0.65, 0.22, 0.18]))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.8, 0.8, 0.8]))
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.08, 0.09, 0.12])
    scene = b.build()
    cam = Camera.look_at([0, 2, -6], [0, 1, 0], [0, 1, 0], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("cornell")
def cornell(width=512, height=512):
    """BASELINE config #2: Cornell-style box, area-light NEE, specular +
    refractive spheres, Russian roulette."""
    red = diffuse_material([0.63, 0.065, 0.05])
    green = diffuse_material([0.14, 0.45, 0.091])
    white = diffuse_material([0.725, 0.71, 0.68])
    b = SceneBuilder()
    s = 2.0  # half-size of the box
    b.add_plane([-s, 0, 0], [1, 0, 0], red)     # left wall
    b.add_plane([s, 0, 0], [-1, 0, 0], green)   # right wall
    b.add_plane([0, 0, 0], [0, 1, 0], white)    # floor
    b.add_plane([0, 2 * s, 0], [0, -1, 0], white)  # ceiling
    b.add_plane([0, 0, s], [0, 0, -1], white)   # back wall
    # area light: emissive sphere poking through the ceiling
    b.add_sphere([0, 2 * s + 0.85, 0], 1.0, light_material([1, 1, 1], 14.0))
    # mirror and glass spheres
    b.add_sphere([-0.9, 0.75, 0.6], 0.75, metallic_material([0.95, 0.95, 0.95], 0.0, 0.9))
    b.add_sphere([0.9, 0.65, -0.4], 0.65, clear_material(1.5, 0.0))
    scene = b.build()
    cam = Camera.look_at([0, 2.0, -6.5], [0, 2.0, 0], [0, 1, 0], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=5, russian_roulette=True, rr_start_depth=2)


@example("material_spheres")
def material_spheres(width=512, height=384):
    """All 7 material archetypes on one stage (reference materialspheres,
    Example.cs:1204-1227)."""
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.75, 0.75, 0.75]))
    mats = [
        diffuse_material(colorlib.hex_color(0x334D5C)),
        specular_material(colorlib.hex_color(0x334D5C), 2.0),
        glossy_material(colorlib.hex_color(0x334D5C), 2.0, math.radians(50)),
        transparent_material(colorlib.hex_color(0x334D5C), 2.0, math.radians(20), 1.0),
        clear_material(2.0, 0.0),
        metallic_material(colorlib.hex_color(0xD1B897), math.radians(10), 0.8),
        light_material([1.0, 1.0, 1.0], 2.0),
    ]
    for i, m in enumerate(mats):
        x = (i - 3) * 2.2
        b.add_sphere([x, 1.0, 0.0], 1.0, m)
    b.add_sphere([0, 12, -6], 3.0, light_material([1, 1, 1], 10.0))
    b.set_environment(color=[0.06, 0.07, 0.09])
    scene = b.build()
    cam = Camera.look_at([0, 3.5, -12], [0, 1, 0], [0, 1, 0], 45.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=4)


@example("refraction")
def refraction(width=512, height=384):
    """Glass sphere caustic-ish demo (reference refraction,
    Example.cs:1127-1147)."""
    b = SceneBuilder()
    glass = clear_material(1.5, 0.0)
    b.add_sphere([-1.5, 1.0, 0], 1.0, glass)
    b.add_sphere([1.5, 1.0, 0], 1.0, specular_material([0.3, 0.3, 0.9], 1.5))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.8, 0.8, 0.8]))
    b.add_sphere([0, 6, -4], 1.5, light_material([1, 1, 1], 12.0))
    b.set_environment(color=[0.1, 0.1, 0.12])
    scene = b.build()
    cam = Camera.look_at([0, 2.5, -7], [0, 1, 0], [0, 1, 0], 38.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=6)


@example("mesh")
def mesh_scene(width=512, height=512, subdivisions=4):
    """BASELINE config #3 stand-in: high-poly triangle mesh with flattened
    BVH traversal (reference bunny, Example.cs:1084; the actual .obj asset
    is not shipped — an icosphere of ~20k triangles exercises the same
    path; `load_obj` handles real assets)."""
    b = SceneBuilder()
    m = sphere_mesh([0, 0, 0], 1.0, subdivisions=subdivisions)
    m = m.fit_inside([-1, 0, -1], [1, 2, 1], [0.5, 0.0, 0.5])
    b.add_mesh(m, glossy_material([0.7, 0.6, 0.3], 1.4, math.radians(20)))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.75, 0.75, 0.75]))
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.08, 0.09, 0.12])
    scene = b.build(leaf_size=8)
    cam = Camera.look_at([0, 2.2, -5], [0, 1, 0], [0, 1, 0], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


def _bunny_mesh(subdivisions: int = 6, seed: int = 11) -> TriMesh:
    """Procedural bunny-class mesh: an icosphere displaced by a band of
    sines (irregular triangle sizes + concavities — the BVH stress the
    reference gets from the 70k-tri bunny OBJ, Example.cs:1084; no OBJ
    assets ship with this image so the stand-in is generated). subdiv 6 =
    81,920 triangles."""
    m = sphere_mesh([0, 0, 0], 1.0, subdivisions=subdivisions)
    v = m.v.reshape(-1, 3).astype(np.float64)
    d = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    # seed-derived phase offsets give distinct base geometry per caller
    # (dragon() passes a different seed than bunny())
    p1, p2, p3 = (np.random.default_rng(seed).uniform(0, 2 * np.pi, 3)
                  if seed != 11 else (0.0, 0.0, 0.0))
    disp = (
        0.16 * np.sin(5.1 * x + 1.3 + p1) * np.sin(4.3 * y + p2)
        + 0.11 * np.sin(7.7 * z + 0.5 + p2) * np.cos(6.1 * x + p3)
        + 0.07 * np.sin(11.0 * y + 2.1 + p3) * np.sin(9.0 * z + p1)
        + 0.23 * np.exp(-18.0 * ((x - 0.25) ** 2 + (y - 0.85) ** 2 + z**2))
        + 0.23 * np.exp(-18.0 * ((x + 0.25) ** 2 + (y - 0.85) ** 2 + z**2))
    )
    r = 1.0 + disp
    # squash into a seated-blob silhouette
    v2 = d * r[:, None]
    v2[:, 1] *= 0.92
    new_v = v2.reshape(-1, 3, 3).astype(np.float32)
    # spherical UVs for texturing
    uv = np.stack(
        [
            0.5 + np.arctan2(z, x) / (2 * np.pi),
            0.5 + np.arcsin(np.clip(y, -1, 1)) / np.pi,
        ],
        axis=-1,
    ).astype(np.float32).reshape(-1, 3, 2)
    return TriMesh(v=new_v, n=m.n, uv=uv).smooth_normals()


@example("bunny")
def bunny(width=1920, height=1080, subdivisions: int = 6,
          intersector: str | None = None, wide_k: int = 4):
    """BASELINE config #3: a bunny-class triangle mesh (81,920 tris) with a
    procedural marble texture, flattened-BVH traversal, 1080p (reference
    bunny, Example.cs:1084-1102)."""
    b = SceneBuilder()
    # procedural marble texture (map_Kd path: bilinear atlas sampling)
    ty, tx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    vein = np.sin(tx * 0.35 + 3.0 * np.sin(ty * 0.12)) * 0.5 + 0.5
    tex = (0.45 + 0.5 * vein[..., None] * np.array([0.9, 0.85, 0.75]))
    tid = b.add_texture(np.clip(tex, 0, 1).astype(np.float32))
    from ptsharp.materials import Material

    mat = Material(color=(0.7, 0.65, 0.55), texture=tid)
    m = _bunny_mesh(subdivisions)
    m = m.fit_inside([-1, 0, -1], [1, 2, 1], [0.5, 0.0, 0.5])
    b.add_mesh(m, mat)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.75, 0.72, 0.68]))
    b.add_sphere([3.5, 6, -3], 1.6, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.10, 0.11, 0.14])
    scene = b.build(leaf_size=8, intersector=intersector, wide_k=wide_k)
    cam = Camera.look_at([0, 1.8, -4.2], [0, 0.9, 0], [0, 1, 0], 38.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=4)


@example("dragon")
def dragon(width=512, height=288):
    """High-poly glossy showcase (reference dragon, Example.cs:977-995; the
    OBJ asset is not shipped — a serpentine displaced icosphere stands in
    at ~80k triangles, same BVH/shading load)."""
    m = _bunny_mesh(6, seed=23)
    v = m.v.reshape(-1, 3).copy()
    # serpentine stretch + twist
    t = v[:, 0] * 1.5
    c, s = np.cos(t * 0.8), np.sin(t * 0.8)
    y = v[:, 1] * c - v[:, 2] * s
    z = v[:, 1] * s + v[:, 2] * c
    v[:, 1], v[:, 2] = y * 0.6, z * 0.8
    v[:, 0] *= 1.9
    m = TriMesh(v=v.reshape(-1, 3, 3), uv=m.uv).smooth_normals()
    b = SceneBuilder()
    gold = glossy_material([0.85, 0.64, 0.23], 1.8, math.radians(12))
    b.add_mesh(m.fit_inside([-1.6, 0, -0.8], [1.6, 1.2, 0.8], [0.5, 0, 0.5]),
               gold)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.4, 0.42, 0.45]))
    b.add_sphere([-2.5, 5, -3], 1.4, light_material([1, 1, 1], 10.0))
    b.set_environment(color=[0.16, 0.18, 0.22])
    scene = b.build(leaf_size=8)
    cam = Camera.look_at([0, 1.6, -3.6], [0, 0.5, 0], [0, 1, 0], 42.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=4)


@example("dragon_hd")
def dragon_hd(width=960, height=540, subdivisions: int = 8,
              intersector: str | None = None, wide_k: int = 4):
    """Dragon-SCALE mesh: 1,310,720 triangles (subdiv-8 displaced
    icosphere with the serpentine warp) — past the reference's 871k-tri
    dragon (Example.cs:977) and far past the old 524k packed-node cap
    (now removed: skip owns a full int32 slot). Exercises million-node
    BVH builds + traversal at production scale."""
    m = _bunny_mesh(subdivisions, seed=23)
    v = m.v.reshape(-1, 3).copy()
    t = v[:, 0] * 1.5
    c, s = np.cos(t * 0.8), np.sin(t * 0.8)
    y = v[:, 1] * c - v[:, 2] * s
    z = v[:, 1] * s + v[:, 2] * c
    v[:, 1], v[:, 2] = y * 0.6, z * 0.8
    v[:, 0] *= 1.9
    m = TriMesh(v=v.reshape(-1, 3, 3), uv=m.uv).smooth_normals()
    b = SceneBuilder()
    jade = glossy_material([0.35, 0.72, 0.45], 1.6, math.radians(16))
    b.add_mesh(m.fit_inside([-1.6, 0, -0.8], [1.6, 1.2, 0.8], [0.5, 0, 0.5]),
               jade)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.42, 0.42, 0.45]))
    b.add_sphere([-2.5, 5, -3], 1.4, light_material([1, 1, 1], 10.0))
    b.set_environment(color=[0.15, 0.17, 0.21])
    scene = b.build(leaf_size=8, intersector=intersector, wide_k=wide_k)
    cam = Camera.look_at([0, 1.6, -3.6], [0, 0.5, 0], [0, 1, 0], 42.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=8), \
        IntegratorConfig(max_bounces=4)


@example("teapot")
def teapot(width=512, height=384):
    """CSG-meshed teapot stand-in (reference teapot, Example.cs:1349-1382):
    supersphere body + torus handle + capsule spout, iso-surfaced by
    marching tetrahedra into a real triangle mesh."""
    from ptsharp.geometry import mc
    from ptsharp.geometry.sdf import (
        SdfCapsule, SdfSphere, SdfTorus, SdfTransform, SdfUnion,
    )

    body = SdfSphere(radius=1.0, exponent=3.0)  # squarish supersphere body
    handle = SdfTransform(
        SdfTorus(major=0.45, minor=0.1), transform.translate([-1.05, 0.1, 0.0])
    )
    spout = SdfTransform(
        SdfCapsule(a=[0, 0, 0], b=[0.9, 0.55, 0.0], radius=0.14),
        transform.translate([0.8, 0.0, 0.0]),
    )
    pot = SdfUnion(body, handle, spout)
    m = mc.sdf_mesh(pot.evaluate, [-2.2, -1.4, -1.4], [2.2, 1.4, 1.4], 0.06)
    m = m.smooth_normals_threshold(math.radians(40))
    b = SceneBuilder()
    b.add_mesh(m.fit_inside([-1, 0, -1], [1, 1.4, 1], [0.5, 0, 0.5]),
               glossy_material([0.75, 0.78, 0.82], 1.6, math.radians(18)))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.68, 0.62]))
    b.add_sphere([2.5, 5, -2.5], 1.2, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.12, 0.13, 0.16])
    scene = b.build(leaf_size=8)
    cam = Camera.look_at([0, 1.6, -3.4], [0, 0.6, 0], [0, 1, 0], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("suzanne")
def suzanne(width=512, height=384):
    """Head-ish displaced mesh (reference suzanne, Example.cs:1318-1347)."""
    m = sphere_mesh([0, 0, 0], 1.0, subdivisions=5)
    v = m.v.reshape(-1, 3).astype(np.float64)
    d = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    # brow ridge, muzzle and two ears
    disp = (
        0.30 * np.exp(-14.0 * ((np.abs(x) - 0.75) ** 2 + (y - 0.72) ** 2 + z**2))
        + 0.25 * np.exp(-10.0 * (x**2 + (y + 0.35) ** 2 + (z + 0.9) ** 2))
        + 0.08 * np.sin(3.0 * y) * np.cos(2.0 * x)
    )
    v2 = (d * (1.0 + disp)[:, None]) * np.array([1.0, 0.85, 0.8])
    m = TriMesh(v=v2.reshape(-1, 3, 3).astype(np.float32),
                uv=m.uv).smooth_normals()
    b = SceneBuilder()
    b.add_mesh(m.fit_inside([-1, 0.2, -1], [1, 2.2, 1], [0.5, 0, 0.5]),
               diffuse_material([0.62, 0.45, 0.3]))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.72, 0.7, 0.66]))
    b.add_sphere([2, 5, -3], 1.3, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.1, 0.11, 0.14])
    scene = b.build(leaf_size=8)
    cam = Camera.look_at([0, 1.7, -3.8], [0, 1.1, 0], [0, 1, 0], 38.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("gopher")
def gopher(width=448, height=448):
    """Mascot from analytic parts (reference gopher, Example.cs:1542-1564):
    body/head spheres, transformed-cylinder limbs, sphere eyes."""
    b = SceneBuilder()
    blue = diffuse_material([0.35, 0.65, 0.85])
    cream = diffuse_material([0.9, 0.85, 0.75])
    dark = diffuse_material([0.05, 0.05, 0.06])
    b.add_sphere([0, 0.9, 0], 0.9, blue,
                 transform=transform.scale([0.85, 1.0, 0.7]))
    b.add_sphere([0, 2.1, 0], 0.62, blue)
    for sx in (-1, 1):
        b.add_sphere([0.42 * sx, 2.55, -0.25], 0.22, cream)  # ears
        b.add_sphere([0.26 * sx, 2.2, -0.5], 0.17, cream)    # eye whites
        b.add_sphere([0.26 * sx, 2.2, -0.64], 0.07, dark)    # pupils
        t = transform.translate([0.75 * sx, 0.6, 0]) @ \
            transform.rotate([0, 0, 1], math.radians(25.0 * sx))
        b.add_cylinder(0.14, -0.45, 0.45, blue, transform=t)  # arms
    b.add_sphere([0, 2.05, -0.62], 0.1, cream)  # snout
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.75, 0.73, 0.7]))
    b.add_sphere([3, 6, -4], 1.6, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.2, 0.23, 0.28])
    scene = b.build()
    cam = Camera.look_at([0, 1.9, -4.6], [0, 1.4, 0], [0, 1, 0], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


def _brick_mesh() -> TriMesh:
    """2x4 toy brick with studs (Util.CreateBrick stand-in: the STL asset
    is not shipped; studs are small boxes)."""
    parts = [cube_mesh([0, 0, 0], [4, 1.0, 2])]
    for i in range(4):
        for j in range(2):
            cx, cz = 0.5 + i, 0.5 + j
            parts.append(cube_mesh([cx - 0.28, 1.0, cz - 0.28],
                                   [cx + 0.28, 1.28, cz + 0.28]))
    v = np.concatenate([p.v for p in parts])
    return TriMesh(v=v)


@example("toybrick")
def toybrick(width=512, height=384, rows=6, cols=6):
    """Instanced toy-brick wall (reference toybrick, Example.cs:1229-1272)
    — one brick mesh, dozens of TransformedShape instances through the
    TLAS, per-instance material overrides."""
    rng = np.random.default_rng(4)
    palette = [
        diffuse_material(c) for c in
        ([0.78, 0.12, 0.1], [0.98, 0.75, 0.1], [0.1, 0.4, 0.75],
         [0.1, 0.6, 0.25], [0.95, 0.95, 0.95], [0.95, 0.45, 0.1])
    ]
    b = SceneBuilder()
    mid = None
    brick = _brick_mesh()
    for r_ in range(rows):
        off = 2.0 if r_ % 2 else 0.0
        for c_ in range(cols):
            t = transform.translate([c_ * 4.0 + off - cols * 2, r_ * 1.0, 0])
            mat = palette[int(rng.integers(len(palette)))]
            if mid is None:
                mid = b.add_mesh(brick, mat, transform=t)
            else:
                b.add_mesh_instance(mid, transform=t, material=mat)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.7, 0.7, 0.7]))
    b.add_sphere([6, 14, -12], 3.0, light_material([1, 1, 1], 7.0))
    b.set_environment(color=[0.25, 0.28, 0.33])
    scene = b.build(leaf_size=4)
    cam = Camera.look_at([2, 5.5, -16], [0, 3, 0], [0, 1, 0], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=12), \
        IntegratorConfig(max_bounces=3)


@example("cylinder_field")
def cylinder_field(width=512, height=288, n=24):
    """Row of overlapping transformed cylinders (reference cylinder,
    Example.cs:997-1026)."""
    b = SceneBuilder()
    for i in range(n):
        hue = i / n
        col = np.array([0.5 + 0.5 * math.cos(6.28 * hue),
                        0.5 + 0.5 * math.cos(6.28 * hue + 2.1),
                        0.5 + 0.5 * math.cos(6.28 * hue + 4.2)])
        t = transform.translate([i * 0.6 - n * 0.3, 0.0, 0.0]) @ \
            transform.rotate([1, 0, 0], math.radians(90)) @ \
            transform.rotate([0, 0, 1], math.radians(8.0 * i))
        b.add_cylinder(0.5, -0.6, 0.6, glossy_material(col * 0.8, 1.4,
                                                       math.radians(15)),
                       transform=t)
    b.add_plane([0, -0.8, 0], [0, 1, 0], diffuse_material([0.6, 0.6, 0.6]))
    b.add_sphere([0, 7, -5], 2.0, light_material([1, 1, 1], 7.0))
    b.set_environment(color=[0.18, 0.2, 0.24])
    scene = b.build()
    cam = Camera.look_at([0, 2.4, -7], [0, 0, 0], [0, 1, 0], 42.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("hits")
def hits(width=512, height=384, n=60):
    """Scatter field of squashed-sphere instances (reference hits,
    Example.cs catalog) — random ellipsoids on a plane, TLAS stress."""
    rng = np.random.default_rng(9)
    b = SceneBuilder()
    for i in range(n):
        p = rng.uniform(-6, 6, 2)
        s = rng.uniform(0.2, 0.7)
        sq = rng.uniform(0.3, 1.0, 3)
        col = rng.uniform(0.2, 0.9, 3)
        t = transform.translate([p[0], s * sq[1], p[1]]) @ \
            transform.scale(s * sq)
        b.add_sphere([0, 0, 0], 1.0, diffuse_material(col), transform=t)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.75, 0.75, 0.75]))
    b.add_sphere([5, 9, -6], 2.2, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.15, 0.17, 0.2])
    scene = b.build()
    cam = Camera.look_at([0, 4.5, -11], [0, 0, 0], [0, 1, 0], 45.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("ellipsoid")
def ellipsoid(width=512, height=384):
    """Non-uniformly scaled sphere instancing (reference ellipsoid,
    Example.cs:1104-1125) — exercises the per-primitive affine path."""
    b = SceneBuilder()
    wall = diffuse_material([0.8, 0.8, 0.8])
    b.add_plane([0, 0, 0], [0, 1, 0], wall)
    for i in range(4):
        t = np.eye(4, dtype=np.float32)
        ang = i * math.pi / 4
        c, s = math.cos(ang), math.sin(ang)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        scl = np.diag([2.0, 0.6, 0.6]).astype(np.float32)
        t[:3, :3] = rot @ scl
        t[:3, 3] = [0, 0.8, 0]
        b.add_sphere([0, 0, 0], 1.0, glossy_material([0.7, 0.2, 0.2], 1.5,
                                                     math.radians(30)), transform=t)
    b.add_sphere([3, 7, -3], 1.5, light_material([1, 1, 1], 10.0))
    b.set_environment(color=[0.07, 0.08, 0.1])
    scene = b.build()
    cam = Camera.look_at([0, 3, -7], [0, 0.8, 0], [0, 1, 0], 35.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("sdf")
def sdf_scene(width=512, height=384):
    """BASELINE config #4: SDF CSG demo + depth-of-field camera
    (reference sdf, Example.cs:1399-1425)."""
    b = SceneBuilder()
    shape = sdf_mod.SdfIntersection(
        sdf_mod.SdfCube((1.6, 1.6, 1.6)),
        sdf_mod.SdfSphere(1.05),
    ) - sdf_mod.SdfUnion(
        sdf_mod.SdfCylinder(0.55, 4.0),
        sdf_mod.SdfTransform(
            sdf_mod.SdfCylinder(0.55, 4.0),
            np.asarray(transform.rotate(np.array([1.0, 0, 0]), math.pi / 2)),
        ),
        sdf_mod.SdfTransform(
            sdf_mod.SdfCylinder(0.55, 4.0),
            np.asarray(transform.rotate(np.array([0.0, 0, 1]), math.pi / 2)),
        ),
    )
    shape = sdf_mod.SdfTransform(
        shape,
        np.asarray(transform.translate(np.array([0.0, 1.0, 0.0]))),
    )
    b.add_sdf(shape, glossy_material([0.85, 0.55, 0.15], 1.4, math.radians(25)))
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.78, 0.78, 0.78]))
    b.add_sphere([3, 6, -4], 1.5, light_material([1, 1, 1], 10.0))
    b.set_environment(color=[0.08, 0.09, 0.11])
    scene = b.build()
    cam = Camera.look_at([2.8, 2.8, -4.5], [0, 1, 0], [0, 1, 0], 35.0)
    cam = cam.set_focus([0.0, 1.0, 0.0], 0.06)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("volume")
def volume_scene(width=384, height=384):
    """BASELINE config #5: windowed iso-surface volume rendering over a
    procedural density grid (reference volume, Example.cs:1427-1474, minus
    the CT-slice asset)."""
    n = 64
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / (n - 1) * 2.0 - 1.0
    x, y, z = g[0], g[1], g[2]
    # nested-shell density: radial falloff + angular ripple
    r = np.sqrt(x**2 + y**2 + z**2)
    density = np.clip(1.0 - r, 0, 1) + 0.12 * np.sin(6 * x) * np.sin(6 * y) * np.sin(6 * z)
    density = np.clip(density, 0.0, 1.0)

    b = SceneBuilder()
    m_out = diffuse_material([0.9, 0.5, 0.3])
    m_in = diffuse_material([0.3, 0.5, 0.9])
    id_out = b.material_id(m_out)
    id_in = b.material_id(m_in)
    vol = vol_mod.VolumeGrid(
        data=density,
        windows=[
            vol_mod.VolumeWindow(0.25, 0.6, id_out),
            vol_mod.VolumeWindow(0.6, 1.1, id_in),
        ],
        bmin=np.array([-1, 0, -1], np.float32),
        bmax=np.array([1, 2, 1], np.float32),
    )
    b.add_volume(vol)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.8, 0.8, 0.8]))
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 10.0))
    b.set_environment(color=[0.09, 0.1, 0.12])
    scene = b.build()
    cam = Camera.look_at([0, 2.2, -4.5], [0, 1, 0], [0, 1, 0], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=8), \
        IntegratorConfig(max_bounces=2)


@example("veach")
def veach(width=512, height=384):
    """Veach MIS stress scene: four lights of varying size/emittance over
    metallic bars of varying gloss (reference veachscene,
    Example.cs:1566-1611) — the integrator-correctness benchmark."""
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.6, 0.6, 0.6]))
    b.add_plane([0, 0, 6], [0, 0, -1], diffuse_material([0.55, 0.55, 0.55]))
    # four spherical lights: radius shrinks as emittance grows
    lights = [
        (2.0, 2.0, [1.0, 0.8, 0.6]),
        (0.9, 8.0, [0.9, 1.0, 0.7]),
        (0.35, 40.0, [0.7, 0.9, 1.0]),
        (0.12, 300.0, [1.0, 0.7, 0.9]),
    ]
    for i, (rad, e, c) in enumerate(lights):
        x = -4.5 + i * 3.0
        b.add_sphere([x, 5.0, 3.0], rad, light_material(c, e))
    # metallic bars with increasing roughness
    for i in range(4):
        gloss = math.radians([2.0, 8.0, 18.0, 32.0][i])
        y = 0.6 + i * 0.9
        zz = 1.0 + i * 0.8
        b.add_cube([-1, -0.03, -0.15], [1, 0.03, 0.15],
                   metallic_material([0.9, 0.9, 0.9], gloss, 0.9),
                   transform=_bar_transform(y, zz))
    b.set_environment(color=[0.03, 0.03, 0.04])
    scene = b.build()
    cam = Camera.look_at([0, 3.0, -8.0], [0, 2.0, 2.0], [0, 1, 0], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=4, specular_mode=SPECULAR_MODE_FIRST,
                         light_mode=LIGHT_MODE_ALL)


def _bar_transform(y, z):
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = np.diag([3.0, 1.0, 1.0]).astype(np.float32)
    # tilt the bar toward the camera
    ang = math.radians(-25.0)
    c, s = math.cos(ang), math.sin(ang)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    t[:3, :3] = rot @ t[:3, :3]
    t[:3, 3] = [0, y, z]
    return t


@example("cube_field")
def cube_field(width=512, height=384, n=12):
    """Grid of random-height cubes (reference example3, Example.cs:387-418 —
    the default viewport scene; exercises many-cube brute-force tables)."""
    rng = np.random.default_rng(4)
    b = SceneBuilder()
    white = diffuse_material([0.75, 0.75, 0.75])
    for i in range(-n // 2, n // 2):
        for j in range(-n // 2, n // 2):
            h = float(rng.uniform(0.1, 1.8))
            b.add_cube([i, 0, j], [i + 0.92, h, j + 0.92],
                       diffuse_material(colorlib.hex_color(
                           [0x334D5C, 0x45B29D, 0xEFC94C, 0xE27A3F, 0xDF5A49][int(rng.integers(5))])))
    b.add_sphere([0, 14, -6], 3.0, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.1, 0.12, 0.15])
    scene = b.build()
    cam = Camera.look_at([-7, 8, -10], [0, 0, 0], [0, 1, 0], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=8), \
        IntegratorConfig(max_bounces=3)


@example("craft")
def craft(width=512, height=384, n=10):
    """Textured voxel blocks (reference craft, Example.cs:72-117) with a
    procedural grass/dirt texture atlas (no external assets)."""
    rng = np.random.default_rng(7)
    b = SceneBuilder()
    # procedural "grass top / dirt side" texture
    tex = np.zeros((32, 32, 3), np.float32)
    noise = rng.uniform(0.75, 1.0, (32, 32, 1)).astype(np.float32)
    tex[:10] = np.array([0.13, 0.45, 0.10], np.float32) * noise[:10]
    tex[10:] = np.array([0.35, 0.22, 0.12], np.float32) * noise[10:]
    tid = b.add_texture(tex)
    from ptsharp.materials import Material

    block = Material(color=(0.6, 0.5, 0.3), texture=tid)
    heights = (
        2.0 + 1.6 * np.sin(np.arange(n)[:, None] * 0.7)
        * np.cos(np.arange(n)[None, :] * 0.9)
        + rng.uniform(0, 0.8, (n, n))
    )
    for i in range(n):
        for j in range(n):
            h = float(np.ceil(heights[i, j]))
            for k in range(int(h)):
                if k < h - 1 and 0 < i < n - 1 and 0 < j < n - 1:
                    continue  # hollow interior like the reference mesh opt
                x, z = i - n / 2, j - n / 2
                b.add_cube([x, k, z], [x + 1, k + 1, z + 1], block)
    b.add_sphere([0, 16, -8], 4.0, light_material([1, 1, 1], 6.0))
    b.set_environment(color=[0.35, 0.48, 0.65])
    scene = b.build()
    cam = Camera.look_at([-8, 9, -10], [0, 1, 0], [0, 1, 0], 45.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=8), \
        IntegratorConfig(max_bounces=3)


@example("runway")
def runway(width=512, height=288):
    """Runway of Kelvin-temperature lights at reference scale — 126
    lights (reference runway carries hundreds, Example.cs:1028-1082).
    Exercises Colour.Kelvin + many-light NEE via LIGHT_MODE_POWER: one
    power-CDF light pick per bounce, so trace cost and compile time are
    flat in light count (the ALL mode would unroll 126 traversals)."""
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.05, 0.05, 0.06]))
    for i in range(60):
        z = i * 4.0
        k = 2000.0 + (i % 20) * 700.0
        c = np.asarray(colorlib.kelvin(k))
        for x in (-3.0, 3.0):
            b.add_sphere([x, 0.3, z], 0.3, light_material(c, 6.0))
    # approach strobes
    for i in range(6):
        b.add_sphere([0, 0.25, -8.0 - i * 5.0], 0.25,
                     light_material(np.asarray(colorlib.kelvin(6500.0)), 10.0))
    b.set_environment(color=[0.01, 0.012, 0.02])
    scene = b.build()
    cam = Camera.look_at([0, 6, -20], [0, 0, 30], [0, 1, 0], 50.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=2, light_mode="power")


@example("mol")
def mol(width=512, height=384):
    """Ball-and-stick molecule (reference mol, Example.cs:538-816) from the
    embedded benzene structure; the molfile parser handles real .sdf files."""
    from ptsharp.io.mol import add_molecule, benzene

    b = SceneBuilder()
    add_molecule(b, benzene())
    b.add_plane([0, 0, -1.2], [0, 0, 1], diffuse_material([0.85, 0.85, 0.85]))
    b.add_sphere([4, 6, 6], 2.0, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.12, 0.13, 0.16])
    scene = b.build()
    cam = Camera.look_at([0, -7, 4], [0, 0, 0], [0, 0, 1], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("go")
def go(width=512, height=384):
    """Go board with stones as squashed-sphere instances (reference go,
    Example.cs:248-338)."""
    rng = np.random.default_rng(19)
    b = SceneBuilder()
    board = diffuse_material([0.72, 0.55, 0.3])
    b.add_cube([-9.5, -0.5, -9.5], [9.5, 0.0, 9.5], board)
    white = glossy_material([0.95, 0.95, 0.92], 1.4, math.radians(10))
    black = glossy_material([0.06, 0.06, 0.07], 1.5, math.radians(10))
    squash = np.diag([0.45, 0.22, 0.45, 1.0]).astype(np.float32)
    for i in range(-4, 5):
        for j in range(-4, 5):
            if rng.random() < 0.5:
                continue
            t = squash.copy()
            t[:3, 3] = [i * 2.0, 0.22, j * 2.0]
            b.add_sphere([0, 0, 0], 1.0, white if rng.random() < 0.5 else black,
                         transform=t)
    b.add_sphere([0, 14, -6], 3.0, light_material([1, 1, 1], 7.0))
    b.set_environment(color=[0.1, 0.1, 0.12])
    scene = b.build()
    cam = Camera.look_at([0, 10, -13], [0, 0, 0], [0, 1, 0], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("qbert")
def qbert(width=448, height=448):
    """Isometric cube pyramid (reference qbert)."""
    rng = np.random.default_rng(23)
    b = SceneBuilder()
    palette = [0x334D5C, 0x45B29D, 0xEFC94C, 0xE27A3F, 0xDF5A49]
    n = 7
    for y in range(n):
        for x in range(n - y):
            for z in range(n - y):
                if x + z >= n - y:
                    continue
                c = colorlib.hex_color(palette[int(rng.integers(len(palette)))])
                b.add_cube([x + y * 0.5, y * 0.9, z + y * 0.5],
                           [x + y * 0.5 + 0.95, y * 0.9 + 0.95, z + y * 0.5 + 0.95],
                           diffuse_material(np.asarray(c)))
    b.add_sphere([n, 3 * n, -n], 4.0, light_material([1, 1, 1], 5.0))
    b.set_environment(color=[0.25, 0.3, 0.4])
    scene = b.build()
    cam = Camera.look_at([n * 2.2, n * 1.6, -n * 1.6], [n / 2, n / 3, n / 2],
                         [0, 1, 0], 38.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=8), \
        IntegratorConfig(max_bounces=3)


@example("maze")
def maze(width=512, height=384, n=21):
    """Random wall maze of cubes (reference maze)."""
    rng = np.random.default_rng(5)
    b = SceneBuilder()
    wall = diffuse_material([0.85, 0.83, 0.78])
    floor = diffuse_material([0.2, 0.25, 0.3])
    b.add_plane([0, 0, 0], [0, 1, 0], floor)
    for i in range(n):
        for j in range(n):
            edge = i in (0, n - 1) or j in (0, n - 1)
            if edge or ((i % 2 == 0 or j % 2 == 0) and rng.random() < 0.55):
                x, z = i - n / 2, j - n / 2
                b.add_cube([x, 0, z], [x + 1, 1.4, z + 1], wall)
    b.add_sphere([0, 18, 0], 4.0, light_material([1, 1, 1], 6.0))
    b.set_environment(color=[0.1, 0.12, 0.16])
    scene = b.build()
    cam = Camera.look_at([0, 22, -14], [0, 0, 0], [0, 1, 0], 45.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=8), \
        IntegratorConfig(max_bounces=2)


@example("sh")
def sh(width=448, height=448):
    """Spherical-harmonics lobe shape, two-material positive/negative lobes
    (reference sh/shrender, SH.cs + Example.cs:942-975)."""
    from ptsharp.geometry.sh_shape import add_sh_shape

    b = SceneBuilder()
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] *= 2.2
    t[:3, 3] = [0, 1.4, 0]
    add_sh_shape(
        b, 3, 2,
        glossy_material([0.8, 0.25, 0.2], 1.4, math.radians(15)),
        glossy_material([0.2, 0.3, 0.8], 1.4, math.radians(15)),
        transform=t, step=0.035,
    )
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.8, 0.8, 0.8]))
    b.add_sphere([3, 6, -3], 1.5, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.09, 0.1, 0.12])
    scene = b.build(leaf_size=8)
    cam = Camera.look_at([0, 2.6, -4.5], [0, 1.2, 0], [0, 1, 0], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


@example("heightfield")
def heightfield(width=512, height=384):
    """z < f(x, y) terrain shape (reference Function.cs capability)."""
    import jax.numpy as jnp

    from ptsharp.geometry.function import Heightfield

    def f(x, y):
        return 0.6 * jnp.sin(x) * jnp.cos(y) + 0.2 * jnp.sin(3 * x) * jnp.sin(2 * y)

    b = SceneBuilder()
    hf = Heightfield(f=f, bmin=np.array([-4, -4, -2], np.float32),
                     bmax=np.array([4, 4, 2], np.float32))
    b.add_function(hf, glossy_material([0.4, 0.55, 0.35], 1.3, math.radians(25)))
    b.add_sphere([5, 6, 8], 2.0, light_material([1, 1, 1], 8.0))
    b.set_environment(color=[0.2, 0.25, 0.33])
    scene = b.build()
    cam = Camera.look_at([0, -8, 5], [0, 0, 0], [0, 0, 1], 42.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=8), \
        IntegratorConfig(max_bounces=2)


@example("love")
def love(width=512, height=384):
    """Heart-ish CSG of spheres + cube (reference love)."""
    b = SceneBuilder()
    red = glossy_material([0.8, 0.1, 0.15], 1.5, math.radians(20))
    heart = sdf_mod.SdfUnion(
        sdf_mod.SdfTransform(sdf_mod.SdfSphere(0.72),
                             np.asarray(transform.translate(np.array([-0.45, 1.6, 0.0])))),
        sdf_mod.SdfTransform(sdf_mod.SdfSphere(0.72),
                             np.asarray(transform.translate(np.array([0.45, 1.6, 0.0])))),
        sdf_mod.SdfTransform(
            sdf_mod.SdfCube((1.35, 1.35, 1.0)),
            np.asarray(
                transform.mul(
                    transform.translate(np.array([0.0, 0.9, 0.0])),
                    transform.rotate(np.array([0.0, 0.0, 1.0]), math.pi / 4),
                )
            ),
        ),
    )
    b.add_sdf(heart, red)
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.9, 0.88, 0.86]))
    b.add_sphere([3, 6, -4], 1.5, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.12, 0.1, 0.12])
    scene = b.build()
    cam = Camera.look_at([0, 2.2, -5], [0, 1.1, 0], [0, 1, 0], 38.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=16), \
        IntegratorConfig(max_bounces=3)


def beads_frame(frame: int, n_frames: int = 30, width=320, height=240):
    """One frame of the beads animation (reference beads/Frame,
    Example.cs:163-223): spiral of glossy beads rotating over time."""
    rng = np.random.default_rng(11)
    phase = 2.0 * math.pi * frame / n_frames
    b = SceneBuilder()
    b.add_plane([0, 0, 0], [0, 1, 0], diffuse_material([0.8, 0.8, 0.8]))
    for i in range(40):
        a = i * 0.31 + phase
        r = 0.6 + i * 0.08
        y = 0.35 + 0.15 * math.sin(a * 3)
        c = colorlib.hex_color([0x45B29D, 0xEFC94C, 0xE27A3F][i % 3])
        b.add_sphere([r * math.cos(a), y, r * math.sin(a)], 0.3,
                     glossy_material(np.asarray(c), 1.4, math.radians(15)))
    b.add_sphere([3, 7, -3], 1.5, light_material([1, 1, 1], 9.0))
    b.set_environment(color=[0.1, 0.11, 0.14])
    scene = b.build()
    cam = Camera.look_at([0, 4, -7], [0, 0.5, 0], [0, 1, 0], 40.0)
    return scene, cam, RenderConfig(width=width, height=height, spp=8), \
        IntegratorConfig(max_bounces=3)


def render_animation(frames: int, out_template: str = "beads_%03d.png",
                     **kw):
    """Frame-loop rendering (reference Frame/IterativeRender animation use)."""
    import jax

    from ptsharp.renderer import Renderer

    for f in range(frames):
        scene, cam, rcfg, icfg = beads_frame(f, frames, **kw)
        r = Renderer(scene, cam, rcfg, icfg)
        film = r.render(key=jax.random.PRNGKey(f))
        from ptsharp.film import save_png

        save_png(film.color_srgb(), out_template % f)


def build(name: str, **kw):
    return CATALOG[name](**kw)


def main(argv=None):
    """CLI: python -m ptsharp.examples <name> [iterations] [out.png]"""
    import sys

    import jax

    args = argv if argv is not None else sys.argv[1:]
    if not args or args[0] not in CATALOG:
        print("usage: python -m ptsharp.examples <name> [iters] [out.png]")
        print("scenes:", ", ".join(sorted(CATALOG)))
        return 1
    name = args[0]
    iters = int(args[1]) if len(args) > 1 else 1
    out = args[2] if len(args) > 2 else f"{name}.png"
    scene, cam, rcfg, icfg = build(name)
    from ptsharp.renderer import Renderer

    r = Renderer(scene, cam, rcfg, icfg)
    r.iterative_render(iters, key=jax.random.PRNGKey(0), path_template=out,
                       verbose=True)
    print(f"wrote {out}; rays traced: {r.rays_traced}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())