"""Batched analytic primitive intersection over SoA tables.

The reference dispatches one virtual `IShape.Intersect(Ray)` per primitive per
ray (IShape.cs:3-11). Here each primitive *type* is a flat SoA table and its
intersector evaluates a whole (R rays × P primitives) block in one vectorized
op — brute-force over the table with a min-reduction, which is the
accelerator-friendly shape for the small analytic-primitive counts PTSharp scenes use
(the k-d tree only ever mattered for triangle meshes; those get a BVH in
`ptsharp.accel`).

All intersectors:
  * accept unnormalized ray directions (so instance-transformed rays keep a
    world-parametric t; see TransformedShape.cs:43-72 for the reference's
    equivalent t-recompute),
  * return t = INF on miss,
  * use EPS_T as the minimum hit distance.

Semantics cite the reference: Sphere.cs:40-81, Cube.cs:35-68, Plane.cs:36-50,
Cylinder.cs:44-163, Triangle.cs:95-223, Box.cs:72-94.
"""

from __future__ import annotations

import jax.numpy as jnp

from ptsharp.core import vec

INF = vec.INF
# Minimum hit distance. The reference uses 1e-9 (Util.EPS) for most shapes and
# 1e-6 for cubes; fp32 wavefronts need a slightly larger epsilon to avoid
# self-intersection after origin offsetting.
EPS_T = 1e-4


def _safe_div(a, b):
    """IEEE-div that avoids 0/0 NaNs (slab tests rely on +/-inf, keep those)."""
    return a / jnp.where(jnp.abs(b) < 1e-30, jnp.where(b < 0, -1e-30, 1e-30), b)


# ---------------------------------------------------------------------------
# Spheres: centers (S, 3), radii (S,)
# ---------------------------------------------------------------------------


def intersect_spheres(org, dirn, centers, radii):
    """org/dirn (R, 1, 3) or (R, S, 3) (pre-transformed per sphere); returns
    t (R, S). Quadratic near/far root selection (Sphere.cs:40-60), tolerant
    of unnormalized directions."""
    oc = org - centers[None, :, :]  # (R, S, 3)
    d = dirn
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(oc * d, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - (radii**2)[None, :]
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv2a = 0.5 / jnp.maximum(a, 1e-30)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t = jnp.where(t0 > EPS_T, t0, jnp.where(t1 > EPS_T, t1, INF))
    return jnp.where(disc > 0.0, t, INF)


def sphere_normal(p, center):
    return vec.normalize(p - center)


def sphere_uv(p, center, radius):
    """Spherical lat-long UV (Sphere.cs:62-69 semantics, without the
    reference's swapped-component typo noted in SURVEY.md)."""
    d = vec.normalize(p - center)
    u = jnp.arctan2(d[..., 2], d[..., 0])
    v = jnp.arctan2(d[..., 1], vec.length(vec.vec3(d[..., 0], jnp.zeros_like(d[..., 1]), d[..., 2])))
    u = 1.0 - (u + jnp.pi) / (2.0 * jnp.pi)
    v = (v + jnp.pi / 2.0) / jnp.pi
    return u, v


# ---------------------------------------------------------------------------
# Planes: points (P, 3), normals (P, 3) — infinite planes (Plane.cs)
# ---------------------------------------------------------------------------


def intersect_planes(org, dirn, points, normals):
    """org/dirn (R, 1, 3) or (R, P, 3); returns t (R, P)."""
    d_dot_n = jnp.sum(dirn * normals[None, :, :], axis=-1)
    po = points[None, :, :] - org
    t = _safe_div(jnp.sum(po * normals[None, :, :], axis=-1), d_dot_n)
    valid = (jnp.abs(d_dot_n) > vec.EPS) & (t > EPS_T)
    return jnp.where(valid, t, INF)


# ---------------------------------------------------------------------------
# Axis-aligned boxes / cubes: bmin, bmax (C, 3)   (Cube.cs:35-47)
# ---------------------------------------------------------------------------


def intersect_cubes(org, dirn, bmin, bmax):
    """org/dirn (R, 1, 3) or (R, C, 3); returns t (R, C)."""
    invd = _safe_div(jnp.ones_like(dirn), dirn)
    n = (bmin[None, :, :] - org) * invd
    f = (bmax[None, :, :] - org) * invd
    lo = jnp.minimum(n, f)
    hi = jnp.maximum(n, f)
    t0 = jnp.max(lo, axis=-1)
    t1 = jnp.min(hi, axis=-1)
    # Reference accepts only the entry hit (t0 > 0 && t0 < t1, Cube.cs:40).
    hit = (t0 > EPS_T) & (t0 < t1)
    return jnp.where(hit, t0, INF)


def cube_normal(p, bmin, bmax, eps: float = 1e-4):
    """Face-epsilon normal (Cube.cs:57-68); default +Y like the reference."""
    nx = jnp.abs(p[..., 0] - bmin[..., 0]) < eps
    px = jnp.abs(p[..., 0] - bmax[..., 0]) < eps
    ny = jnp.abs(p[..., 1] - bmin[..., 1]) < eps
    py = jnp.abs(p[..., 1] - bmax[..., 1]) < eps
    nz = jnp.abs(p[..., 2] - bmin[..., 2]) < eps
    pz = jnp.abs(p[..., 2] - bmax[..., 2]) < eps
    zeros = jnp.zeros_like(p[..., 0])
    ones = jnp.ones_like(p[..., 0])
    n = vec.vec3(zeros, ones, zeros)
    for cond, nvec in [
        (pz, vec.vec3(zeros, zeros, ones)),
        (nz, vec.vec3(zeros, zeros, -ones)),
        (py, vec.vec3(zeros, ones, zeros)),
        (ny, vec.vec3(zeros, -ones, zeros)),
        (px, vec.vec3(ones, zeros, zeros)),
        (nx, vec.vec3(-ones, zeros, zeros)),
    ]:
        n = jnp.where(cond[..., None], nvec, n)
    return n


def cube_uv(p, bmin, bmax):
    q = (p - bmin) / jnp.maximum(bmax - bmin, 1e-12)
    return q[..., 0], q[..., 2]


# ---------------------------------------------------------------------------
# Capped Z-cylinders: radius (C,), z0, z1 (C,)   (Cylinder.cs:44-107)
# ---------------------------------------------------------------------------


def intersect_cylinders(org, dirn, radius, z0, z1):
    """org/dirn (R, 1, 3) or (R, C, 3); returns t (R, C)."""
    o = org
    d = dirn
    r = radius[None, :]
    tz0 = _safe_div(z0[None, :] - o[..., 2], d[..., 2])
    tz1 = _safe_div(z1[None, :] - o[..., 2], d[..., 2])

    def cap_ok(tc):
        px = o[..., 0] + d[..., 0] * tc
        py = o[..., 1] + d[..., 1] * tc
        return (tc > EPS_T) & (px * px + py * py <= r * r)

    t_top = jnp.where(cap_ok(tz1), tz1, INF)
    t_bot = jnp.where(cap_ok(tz0), tz0, INF)

    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2.0 * (o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1])
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - r * r
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv2a = 0.5 / jnp.maximum(a, 1e-30)
    tl0 = (-b - sq) * inv2a
    tl1 = (-b + sq) * inv2a
    # Reference prefers the + root first (Cylinder.cs:86-99); we take the
    # nearest valid lateral hit inside [z0, z1] which is geometrically
    # equivalent for closed cylinders.
    def lat_ok(tl):
        z = o[..., 2] + d[..., 2] * tl
        return (tl > EPS_T) & (z >= z0[None, :]) & (z <= z1[None, :]) & (disc >= 0.0)

    t_lat = jnp.where(lat_ok(tl0), tl0, jnp.where(lat_ok(tl1), tl1, INF))
    return jnp.minimum(jnp.minimum(t_top, t_bot), t_lat)


def cylinder_normal(p, z0, z1, eps: float = 1e-4):
    """Lateral radial normal, cap normals at the z extremes
    (Cylinder.cs:122-163)."""
    on_bot = jnp.abs(p[..., 2] - z0) < eps
    on_top = jnp.abs(p[..., 2] - z1) < eps
    zeros = jnp.zeros_like(p[..., 0])
    lateral = vec.normalize(vec.vec3(p[..., 0], p[..., 1], zeros))
    n = lateral
    n = jnp.where(on_bot[..., None], vec.vec3(zeros, zeros, -jnp.ones_like(zeros)), n)
    n = jnp.where(on_top[..., None], vec.vec3(zeros, zeros, jnp.ones_like(zeros)), n)
    return n


# ---------------------------------------------------------------------------
# Triangles: v0, v1, v2 (T, 3) — Möller–Trumbore (Triangle.cs:95-124)
# ---------------------------------------------------------------------------


def intersect_triangles(org, dirn, v0, v1, v2, eps: float = 1e-9):
    """Brute-force M-T over a triangle block: org/dirn (R, 3), verts (T, 3).
    Returns (t, u, v) each (R, T); barycentrics follow the M-T convention
    (u along v1-v0, v along v2-v0), w = 1-u-v at v0."""
    e1 = (v1 - v0)[None, :, :]
    e2 = (v2 - v0)[None, :, :]
    d = dirn[:, None, :]
    h = jnp.cross(d, e2)
    det = jnp.sum(e1 * h, axis=-1)
    inv_det = _safe_div(jnp.ones_like(det), det)
    s = org[:, None, :] - v0[None, :, :]
    u = jnp.sum(s * h, axis=-1) * inv_det
    q = jnp.cross(s, e1)
    v = jnp.sum(d * q, axis=-1) * inv_det
    t = jnp.sum(e2 * q, axis=-1) * inv_det
    ok = (
        (jnp.abs(det) > eps)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS_T)
    )
    return jnp.where(ok, t, INF), u, v


def triangle_interpolate(attr0, attr1, attr2, u, v):
    """Barycentric interpolation with (w=1-u-v) at vertex 0 — matches the
    M-T u/v convention used by intersect_triangles."""
    w = 1.0 - u - v
    return (
        attr0 * w[..., None] + attr1 * u[..., None] + attr2 * v[..., None]
    )


# ---------------------------------------------------------------------------
# AABB slab entry/exit (Box.cs:72-94) — used by BVH traversal and volumes
# ---------------------------------------------------------------------------


def box_entry_exit(org, dirn, bmin, bmax):
    """Returns (tmin, tmax) per (ray, box) pair with broadcasting over
    leading axes of bmin/bmax."""
    invd = _safe_div(jnp.ones_like(dirn), dirn)
    n = (bmin - org) * invd
    f = (bmax - org) * invd
    lo = jnp.minimum(n, f)
    hi = jnp.maximum(n, f)
    return jnp.max(lo, axis=-1), jnp.min(hi, axis=-1)
