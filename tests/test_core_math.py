"""Unit tests for the math core against analytic results (the per-kernel
test strategy SURVEY.md §4 prescribes — the reference ships zero tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptsharp.core import color, sampling, transform, vec


def test_vec_basics():
    a = vec.vec3(1.0, 2.0, 3.0)
    b = vec.vec3(4.0, -5.0, 6.0)
    assert np.isclose(vec.dot(a, b), 1 * 4 - 2 * 5 + 3 * 6)
    np.testing.assert_allclose(vec.cross(a, b), np.cross([1, 2, 3], [4, -5, 6]))
    assert np.isclose(vec.length(a), np.sqrt(14), rtol=1e-6)
    n = vec.normalize(a)
    assert np.isclose(vec.length(n), 1.0, rtol=1e-6)


def test_reflect():
    n = vec.vec3(0.0, 1.0, 0.0)
    i = vec.normalize(vec.vec3(1.0, -1.0, 0.0))
    r = vec.reflect(n, i)
    np.testing.assert_allclose(r, vec.normalize(vec.vec3(1.0, 1.0, 0.0)), atol=1e-6)


def test_refract_snell():
    """Straight-on entry does not bend; oblique follows Snell's law."""
    n = vec.vec3(0.0, 1.0, 0.0)
    i = vec.vec3(0.0, -1.0, 0.0)
    t = vec.refract(n, i, 1.0, 1.5)
    np.testing.assert_allclose(t, i, atol=1e-6)

    theta_i = np.deg2rad(30.0)
    i = vec.vec3(np.sin(theta_i), -np.cos(theta_i), 0.0)
    t = vec.refract(n, i, 1.0, 1.5)
    sin_t = float(t[0]) / float(vec.length(t))
    np.testing.assert_allclose(sin_t, np.sin(theta_i) / 1.5, atol=1e-5)


def test_refract_tir_returns_zero():
    """Total internal reflection yields the zero vector
    (Vector.Refract semantics, Vector.cs:500-514)."""
    n = vec.vec3(0.0, 1.0, 0.0)
    theta = np.deg2rad(80.0)  # above critical angle for 1.5 -> 1.0
    i = vec.vec3(np.sin(theta), -np.cos(theta), 0.0)
    t = vec.refract(n, i, 1.5, 1.0)
    np.testing.assert_allclose(t, np.zeros(3), atol=1e-6)


def test_fresnel_reflectance():
    n = vec.vec3(0.0, 1.0, 0.0)
    # normal incidence: R = ((n1-n2)/(n1+n2))^2
    i = vec.vec3(0.0, -1.0, 0.0)
    r0 = vec.reflectance(n, i, 1.0, 1.5)
    np.testing.assert_allclose(r0, ((1.0 - 1.5) / (1.0 + 1.5)) ** 2, atol=1e-5)
    # grazing: -> 1
    theta = np.deg2rad(89.9)
    i = vec.vec3(np.sin(theta), -np.cos(theta), 0.0)
    rg = vec.reflectance(n, i, 1.0, 1.5)
    assert rg > 0.95
    # TIR: exactly 1
    theta = np.deg2rad(80.0)
    i = vec.vec3(np.sin(theta), -np.cos(theta), 0.0)
    rt = vec.reflectance(n, i, 1.5, 1.0)
    np.testing.assert_allclose(rt, 1.0, atol=1e-6)


def test_orthonormal_basis():
    key = jax.random.PRNGKey(0)
    w = vec.normalize(jax.random.normal(key, (128, 3)))
    t, b = vec.orthonormal_basis(w)
    np.testing.assert_allclose(vec.dot(t, w), 0.0, atol=1e-5)
    np.testing.assert_allclose(vec.dot(b, w), 0.0, atol=1e-5)
    np.testing.assert_allclose(vec.dot(t, b), 0.0, atol=1e-5)
    np.testing.assert_allclose(vec.length(t), 1.0, atol=1e-5)


def test_cosine_hemisphere_distribution():
    """Mean of cos-weighted directions about n should be ~2/3 n; all
    directions must lie in the upper hemisphere."""
    key = jax.random.PRNGKey(1)
    n = vec.normalize(vec.vec3(0.3, 0.8, -0.5))
    u1, u2 = jax.random.uniform(key, (2, 20000))
    d = sampling.cosine_hemisphere(jnp.broadcast_to(n, (20000, 3)), u1, u2)
    cos = vec.dot(d, n)
    assert float(jnp.min(cos)) > -1e-4
    np.testing.assert_allclose(float(jnp.mean(cos)), 2.0 / 3.0, atol=0.01)


def test_cone_within_angle():
    key = jax.random.PRNGKey(2)
    d = vec.normalize(vec.vec3(1.0, 2.0, 3.0))
    theta = 0.3
    u1, u2 = jax.random.uniform(key, (2, 4096))
    out = sampling.cone(jnp.broadcast_to(d, (4096, 3)), theta, u1, u2)
    ang = jnp.arccos(jnp.clip(vec.dot(out, d), -1.0, 1.0))
    assert float(jnp.max(ang)) <= theta + 1e-4


def test_cone_zero_angle_identity():
    d = vec.normalize(vec.vec3(1.0, 0.0, 1.0))
    u = jnp.array([0.3])
    out = sampling.cone(jnp.broadcast_to(d, (1, 3)), 0.0, u, u)
    np.testing.assert_allclose(out[0], d, atol=1e-6)


def test_stratified_pair_covers_grid():
    base = jnp.zeros(16)
    idx = jnp.arange(16)
    u, v = sampling.stratified_pair(base, base, 4, idx)
    pts = set(zip(np.round(np.asarray(u) * 4).astype(int),
                  np.round(np.asarray(v) * 4).astype(int)))
    assert len(pts) == 16


def test_hex_color_and_kelvin():
    c = color.hex_color(0xFFFFFF)
    np.testing.assert_allclose(c, np.ones(3), atol=1e-6)
    k = color.kelvin(6600.0)
    assert k.shape == (3,)
    assert float(k[0]) >= 0.9  # warm white
    cold = color.kelvin(20000.0)
    assert float(cold[2]) == 1.0  # blue saturates


def test_matrix_roundtrip():
    m = transform.mul(
        transform.translate(jnp.array([1.0, 2.0, 3.0])),
        transform.mul(
            transform.rotate(jnp.array([0.0, 1.0, 0.0]), 0.7),
            transform.scale(jnp.array([2.0, 2.0, 2.0])),
        ),
    )
    p = jnp.array([0.5, -1.0, 2.0])
    q = transform.mul_position(m, p)
    back = transform.mul_position(transform.inverse(m), q)
    np.testing.assert_allclose(back, p, atol=1e-5)


def test_mul_box_contains_transformed_corners():
    m = transform.rotate(jnp.array([1.0, 1.0, 0.0]), 0.5)
    bmin = jnp.array([-1.0, -2.0, -0.5])
    bmax = jnp.array([1.0, 0.5, 2.0])
    lo, hi = transform.mul_box(m, bmin, bmax)
    corners = np.array(
        [
            [x, y, z]
            for x in (bmin[0], bmax[0])
            for y in (bmin[1], bmax[1])
            for z in (bmin[2], bmax[2])
        ]
    )
    tc = np.array([transform.mul_position(m, jnp.asarray(c, jnp.float32)) for c in corners])
    assert np.all(tc >= np.asarray(lo) - 1e-5)
    assert np.all(tc <= np.asarray(hi) + 1e-5)
