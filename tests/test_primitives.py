"""Analytic intersection tests for every primitive battery."""

import jax.numpy as jnp
import numpy as np

from ptsharp.core import vec
from ptsharp.geometry import primitives as prim


def rays(org, dirn):
    o = jnp.asarray([org], jnp.float32)[:, None, :]
    d = jnp.asarray([dirn], jnp.float32)[:, None, :]
    return o, d


def test_sphere_hit_miss():
    centers = jnp.array([[0.0, 0.0, 5.0]])
    radii = jnp.array([1.0])
    o, d = rays([0, 0, 0], [0, 0, 1])
    t = prim.intersect_spheres(o, d, centers, radii)
    np.testing.assert_allclose(t[0, 0], 4.0, rtol=1e-5)
    o, d = rays([0, 3, 0], [0, 0, 1])
    t = prim.intersect_spheres(o, d, centers, radii)
    assert float(t[0, 0]) >= vec.INF


def test_sphere_inside():
    """Ray starting inside returns the far root (Sphere.cs:52-59)."""
    centers = jnp.array([[0.0, 0.0, 0.0]])
    radii = jnp.array([2.0])
    o, d = rays([0, 0, 0], [0, 0, 1])
    t = prim.intersect_spheres(o, d, centers, radii)
    np.testing.assert_allclose(t[0, 0], 2.0, rtol=1e-5)


def test_plane():
    pts = jnp.array([[0.0, 0.0, 0.0]])
    nrm = jnp.array([[0.0, 1.0, 0.0]])
    o, d = rays([0, 2, 0], [0, -1, 0])
    t = prim.intersect_planes(o, d, pts, nrm)
    np.testing.assert_allclose(t[0, 0], 2.0, rtol=1e-5)
    # parallel ray misses
    o, d = rays([0, 2, 0], [1, 0, 0])
    t = prim.intersect_planes(o, d, pts, nrm)
    assert float(t[0, 0]) >= vec.INF


def test_cube_entry_and_normal():
    bmin = jnp.array([[-1.0, -1.0, -1.0]])
    bmax = jnp.array([[1.0, 1.0, 1.0]])
    o, d = rays([0, 0, -5], [0, 0, 1])
    t = prim.intersect_cubes(o, d, bmin, bmax)
    np.testing.assert_allclose(t[0, 0], 4.0, rtol=1e-5)
    p = jnp.array([[0.0, 0.0, -1.0]])
    n = prim.cube_normal(p, bmin[0], bmax[0])
    np.testing.assert_allclose(n[0], [0, 0, -1], atol=1e-6)


def test_cylinder_lateral_and_caps():
    radius = jnp.array([1.0])
    z0 = jnp.array([-1.0])
    z1 = jnp.array([1.0])
    # lateral hit
    o, d = rays([-5, 0, 0], [1, 0, 0])
    t = prim.intersect_cylinders(o, d, radius, z0, z1)
    np.testing.assert_allclose(t[0, 0], 4.0, rtol=1e-5)
    # cap hit from above
    o, d = rays([0, 0, 5], [0, 0, -1])
    t = prim.intersect_cylinders(o, d, radius, z0, z1)
    np.testing.assert_allclose(t[0, 0], 4.0, rtol=1e-5)
    # miss outside radius
    o, d = rays([0, 3, 5], [0, 0, -1])
    t = prim.intersect_cylinders(o, d, radius, z0, z1)
    assert float(t[0, 0]) >= vec.INF


def test_triangle_moller_trumbore():
    v0 = jnp.array([[-1.0, -1.0, 3.0]])
    v1 = jnp.array([[1.0, -1.0, 3.0]])
    v2 = jnp.array([[0.0, 1.0, 3.0]])
    o = jnp.array([[0.0, -0.2, 0.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    t, u, v = prim.intersect_triangles(o, d, v0, v1, v2)
    np.testing.assert_allclose(t[0, 0], 3.0, rtol=1e-5)
    w = 1.0 - u[0, 0] - v[0, 0]
    p = w * v0[0] + u[0, 0] * v1[0] + v[0, 0] * v2[0]
    np.testing.assert_allclose(p, [0.0, -0.2, 3.0], atol=1e-5)
    # backface culling is off: reverse direction from behind still hits
    o2 = jnp.array([[0.0, -0.2, 5.0]])
    d2 = jnp.array([[0.0, 0.0, -1.0]])
    t2, _, _ = prim.intersect_triangles(o2, d2, v0, v1, v2)
    np.testing.assert_allclose(t2[0, 0], 2.0, rtol=1e-5)
    # miss outside
    o3 = jnp.array([[5.0, 0.0, 0.0]])
    t3, _, _ = prim.intersect_triangles(o3, d, v0, v1, v2)
    assert float(t3[0, 0]) >= vec.INF


def test_box_entry_exit():
    lo = jnp.array([-1.0, -1.0, -1.0])
    hi = jnp.array([1.0, 1.0, 1.0])
    o = jnp.array([[0.0, 0.0, -4.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    tmin, tmax = prim.box_entry_exit(o, d, lo, hi)
    np.testing.assert_allclose(tmin[0], 3.0, rtol=1e-5)
    np.testing.assert_allclose(tmax[0], 5.0, rtol=1e-5)
