"""Catalog-wide smoke renders + tests for filters, poisson, heightfield,
molfile, viewer."""

import math
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptsharp.core import filters, poisson
from ptsharp.examples import CATALOG, build
from ptsharp.renderer import Renderer, RenderConfig

# scenes cheap enough for per-commit CI on 2 CPUs; the full catalog smoke
# runs in scripts/render_catalog.py
SMOKE = ["simple_sphere", "cornell", "mesh", "ellipsoid", "heightfield",
         "mol", "veach",
         "teapot", "suzanne", "gopher", "toybrick", "cylinder_field", "hits"]


@pytest.mark.parametrize("name", SMOKE)
def test_catalog_scene(name):
    scene, cam, rcfg, icfg = build(name)
    r = Renderer(scene, cam, RenderConfig(width=10, height=8, spp=2), icfg)
    film = r.render(key=jax.random.PRNGKey(0))
    img = np.asarray(film.mean)
    assert np.isfinite(img).all()
    assert img.mean() > 0.0


def test_dragon_scale_mesh():
    """Uncapped BVH node path (the old 1<<19 packed-node cap is gone):
    subdiv-6 = 81,920 tris with leaf_size 1 -> ~164k binary nodes, well
    past the old 12-bit-skip packing; build + closest-hit smoke on a small
    ray batch. (The true million-node scale renders via examples.dragon_hd,
    1.3M tris / ~439k nodes, exercised by scripts/render_catalog.py and the
    large-mesh bench config.)"""
    from ptsharp.examples import _bunny_mesh
    from ptsharp.intersect import closest_hit
    from ptsharp.materials import diffuse_material
    from ptsharp.scene import SceneBuilder

    m = _bunny_mesh(6, seed=3)
    b = SceneBuilder()
    b.add_mesh(m, diffuse_material([0.6, 0.6, 0.6]))
    scene = b.build(leaf_size=1)  # 81,920 leaves -> ~164k nodes; with the
    # old bit-packed skip this layout was capped — now any count packs
    assert scene.u_rows.shape[0] > (1 << 17)
    org = jnp.asarray(np.full((64, 3), [0.0, 0.0, -3.0], np.float32))
    d = np.zeros((64, 3), np.float32)
    ang = np.linspace(-0.3, 0.3, 64)
    d[:, 0], d[:, 2] = np.sin(ang), np.cos(ang)
    h = closest_hit(scene, org, jnp.asarray(d))
    assert np.isfinite(np.asarray(h.t)).all()
    assert (np.asarray(h.t) < 1e8).sum() > 30


def test_dragon_hd_in_catalog():
    assert "dragon_hd" in CATALOG  # rendered by scripts/render_catalog.py;
    # the 1.3M-tri build is too heavy for per-commit CI


def test_filters():
    dx = jnp.asarray([0.0, 0.25, 0.49])
    dy = jnp.zeros(3)
    box = filters.evaluate(filters.BOX, dx, dy)
    np.testing.assert_allclose(box, 1.0)
    tri = np.asarray(filters.evaluate(filters.TRIANGLE, dx, dy))
    assert tri[0] > tri[1] > tri[2] > 0.0
    gau = np.asarray(filters.evaluate(filters.GAUSSIAN, dx, dy))
    assert gau[0] > gau[1] > gau[2] >= 0.0


def test_triangle_filter_render_unbiased():
    """Filtered render of a constant environment stays constant (weights
    normalize out in the Welford mean)."""
    from ptsharp.integrator import IntegratorConfig
    from ptsharp.scene import SceneBuilder
    from ptsharp.camera import Camera

    b = SceneBuilder()
    b.set_environment(color=[0.3, 0.5, 0.7])
    scene = b.build()
    cam = Camera.look_at([0, 0, -3], [0, 0, 0], [0, 1, 0], 45.0)
    r = Renderer(scene, cam,
                 RenderConfig(width=6, height=6, spp=8, filter="triangle"),
                 IntegratorConfig(max_bounces=0))
    film = r.render(key=jax.random.PRNGKey(0))
    np.testing.assert_allclose(
        np.asarray(film.mean), np.broadcast_to([0.3, 0.5, 0.7], (6, 6, 3)),
        atol=1e-5,
    )


def test_poisson_disc_spacing():
    pts = poisson.poisson_disc(10.0, 10.0, 1.0, seed=1)
    assert len(pts) > 20
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    d += np.eye(len(pts)) * 1e9
    assert d.min() >= 1.0 - 1e-5


def test_molfile_roundtrip():
    from ptsharp.io.mol import benzene, parse_molfile

    mol = benzene()
    # write a V2000 molfile and parse it back
    lines = ["benzene", "  ptsharp", "", f"{len(mol.elements):3d}{len(mol.bonds):3d}  0  0  0  0  0  0  0  0999 V2000"]
    for p, el in zip(mol.positions, mol.elements):
        lines.append(f"{p[0]:10.4f}{p[1]:10.4f}{p[2]:10.4f} {el:<3s} 0  0  0  0  0  0  0  0  0  0  0  0")
    for a, b in mol.bonds:
        lines.append(f"{a + 1:3d}{b + 1:3d}  1  0  0  0  0")
    parsed = parse_molfile("\n".join(lines))
    assert parsed.elements == mol.elements
    np.testing.assert_allclose(parsed.positions, mol.positions, atol=1e-3)
    np.testing.assert_array_equal(parsed.bonds, mol.bonds)


def test_heightfield_intersect():
    from ptsharp.geometry.function import Heightfield, intersect, normal_at

    hf = Heightfield(
        f=lambda x, y: jnp.zeros_like(x),  # flat plane z = 0
        bmin=np.array([-2, -2, -1], np.float32),
        bmax=np.array([2, 2, 1], np.float32),
    )
    org = jnp.asarray([[0.0, 0.0, 0.9]])
    dirn = jnp.asarray([[0.0, 0.0, -1.0]])
    t = intersect(hf, org, dirn, jnp.asarray([0.0]), jnp.asarray([3.0]))
    np.testing.assert_allclose(float(t[0]), 0.9, atol=0.05)
    n = normal_at(hf, jnp.asarray([[0.0, 0.0, 0.0]]))
    np.testing.assert_allclose(n[0], [0, 0, 1], atol=1e-4)


def test_viewer_serves_frames():
    from ptsharp.viewer import ViewerServer

    v = ViewerServer(port=18765).start()
    try:
        v.update(np.full((4, 4, 3), 0.5, np.float32))
        page = urllib.request.urlopen(
            "http://127.0.0.1:18765/", timeout=5
        ).read()
        assert b"frame.png" in page
        png = urllib.request.urlopen(
            "http://127.0.0.1:18765/frame.png", timeout=5
        ).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        v.stop()
