"""OBJ/STL round-trips, marching-tetrahedra meshing, SH shapes."""

import os

import numpy as np
import pytest

from ptsharp.geometry.mc import sdf_mesh
from ptsharp.geometry.mesh import TriMesh, cube_mesh, sphere_mesh
from ptsharp.geometry import sh_shape
from ptsharp.io.obj import load_mtl, load_obj, save_obj
from ptsharp.io.stl import load_stl, save_stl
from ptsharp.materials import diffuse_material
from ptsharp.scene import SceneBuilder


def test_obj_roundtrip(tmp_path):
    mesh = cube_mesh([-1, -1, -1], [1, 1, 1])
    p = str(tmp_path / "cube.obj")
    save_obj(mesh, p)
    loaded = load_obj(p)
    assert loaded.num_triangles == 12
    np.testing.assert_allclose(
        np.sort(loaded.v.reshape(-1, 3), axis=0),
        np.sort(mesh.v.reshape(-1, 3), axis=0),
        atol=1e-5,
    )


def test_obj_fan_triangulation_and_negative_indices(tmp_path):
    p = str(tmp_path / "quad.obj")
    with open(p, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n")
        f.write("f 1 2 3 4\n")  # quad -> 2 triangles
        f.write("f -4 -3 -2\n")  # negative indices
    m = load_obj(p)
    assert m.num_triangles == 3


def test_mtl_parsing(tmp_path):
    mtl = tmp_path / "m.mtl"
    mtl.write_text(
        "newmtl red\nKd 0.8 0.1 0.1\n"
        "newmtl lamp\nKe 4.0 2.0 2.0\n"
    )
    obj = tmp_path / "t.obj"
    obj.write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "usemtl red\nf 1 2 3\nusemtl lamp\nf 1 2 3\n"
    )
    b = SceneBuilder()
    m = load_obj(str(obj), builder=b)
    assert m.mat is not None and len(set(m.mat.tolist())) == 2
    mats = load_mtl(str(mtl))
    assert mats["red"].color == (0.8, 0.1, 0.1)
    assert mats["lamp"].emittance == 4.0
    np.testing.assert_allclose(mats["lamp"].color, (1.0, 0.5, 0.5))


def test_stl_binary_roundtrip(tmp_path):
    mesh = sphere_mesh([0, 0, 0], 1.0, subdivisions=1)
    p = str(tmp_path / "s.stl")
    save_stl(mesh, p, binary=True)
    loaded = load_stl(p)
    assert loaded.num_triangles == mesh.num_triangles
    np.testing.assert_allclose(
        np.sort(loaded.v.reshape(-1), axis=0),
        np.sort(mesh.v.reshape(-1), axis=0),
        atol=1e-5,
    )


def test_stl_ascii_roundtrip(tmp_path):
    mesh = cube_mesh([0, 0, 0], [1, 1, 1])
    p = str(tmp_path / "c.stl")
    save_stl(mesh, p, binary=False)
    loaded = load_stl(p)
    assert loaded.num_triangles == 12


def test_marching_tetrahedra_sphere():
    """Meshing the unit-sphere SDF: vertices land on r=1, area ~ 4*pi."""

    def f(p):
        return np.linalg.norm(p, axis=-1) - 1.0

    mesh = sdf_mesh(f, [-1.3] * 3, [1.3] * 3, 0.1)
    assert mesh.num_triangles > 500
    r = np.linalg.norm(mesh.v.reshape(-1, 3), axis=1)
    np.testing.assert_allclose(r.mean(), 1.0, atol=0.02)
    e1 = mesh.v[:, 1] - mesh.v[:, 0]
    e2 = mesh.v[:, 2] - mesh.v[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum()
    np.testing.assert_allclose(area, 4 * np.pi, rtol=0.05)
    # outward orientation
    fn = mesh.face_normals()
    cen = mesh.v.mean(axis=1)
    assert (np.sum(fn * cen, axis=1) > 0).mean() > 0.99


def test_sh_shape_meshes():
    pos, neg = sh_shape.sh_meshes(3, 2, step=0.05)
    assert pos.num_triangles > 50
    assert neg.num_triangles > 50
    # lobe magnitudes: all vertices satisfy r ~ |Y|
    v = pos.v.reshape(-1, 3)
    r = np.linalg.norm(v, axis=1)
    d = v / np.maximum(r, 1e-9)[:, None]
    y = np.abs(sh_shape.real_sh(3, 2, d))
    # vertices sit on r = |Y| except near the origin pinch where lobes
    # meet (direction ill-defined); check the bulk
    frac_on_surface = (np.abs(r - y) < 0.05).mean()
    assert frac_on_surface > 0.9


def test_sh_orthonormality():
    """Monte-Carlo check that the real SH basis is orthonormal on S^2."""
    rng = np.random.default_rng(0)
    p = rng.normal(size=(200000, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    basis = [(0, 0), (1, -1), (1, 1), (2, 0), (3, 2), (4, -3)]
    vals = np.stack([sh_shape.real_sh(l, m, p) for l, m in basis])
    gram = vals @ vals.T * (4 * np.pi / p.shape[0])
    np.testing.assert_allclose(gram, np.eye(len(basis)), atol=0.05)
