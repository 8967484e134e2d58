"""Wavefront OBJ/MTL loader -> TriMesh (+ per-triangle materials).

Parity with reference OBJ.cs: v/vt/vn/f parsing with fan triangulation and
negative/omitted index handling (OBJ.cs:66-156), mtllib/usemtl resolution
(OBJ.cs:48-65), and the MTL subset the reference reads (newmtl, Ke with
max-normalized emittance, Kd, map_Kd, map_bump; OBJ.cs:167-213).

Host-side numpy; textures register into the SceneBuilder atlas so the
returned TriMesh carries ready-to-use material ids.
"""

from __future__ import annotations

import os

import numpy as np

from ptsharp.geometry.mesh import TriMesh
from ptsharp.materials import Material
from ptsharp.textures import load_texture


def load_obj(path: str, builder=None, parent_material: Material | None = None):
    """Load an OBJ file. With `builder` (a SceneBuilder), MTL materials and
    textures are registered and the mesh carries per-triangle material ids;
    without, geometry only. Returns TriMesh."""
    vs: list[list[float]] = []
    vts: list[list[float]] = []
    vns: list[list[float]] = []
    faces = []  # (corner-triples, material-name)
    materials: dict[str, Material] = {}
    current_mat = None

    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            kw = parts[0]
            if kw == "v":
                vs.append([float(x) for x in parts[1:4]])
            elif kw == "vt":
                vts.append([float(parts[1]), float(parts[2])])
            elif kw == "vn":
                vns.append([float(x) for x in parts[1:4]])
            elif kw == "mtllib" and len(parts) > 1:
                mtl_path = os.path.join(base, " ".join(parts[1:]))
                if os.path.exists(mtl_path):
                    materials.update(load_mtl(mtl_path, builder))
            elif kw == "usemtl" and len(parts) > 1:
                current_mat = " ".join(parts[1:])
            elif kw == "f":
                corners = []
                for tok in parts[1:]:
                    idx = tok.split("/")
                    vi = int(idx[0])
                    ti = int(idx[1]) if len(idx) > 1 and idx[1] else 0
                    ni = int(idx[2]) if len(idx) > 2 and idx[2] else 0
                    corners.append((vi, ti, ni))
                # fan triangulation (OBJ.cs:145-155)
                for k in range(1, len(corners) - 1):
                    faces.append(((corners[0], corners[k], corners[k + 1]),
                                  current_mat))

    def resolve(i, n):
        # negative = relative-from-end; 1-based otherwise (OBJ.cs:120-133)
        return i + n if i < 0 else i - 1

    t = len(faces)
    v = np.zeros((t, 3, 3), np.float32)
    n = np.zeros((t, 3, 3), np.float32)
    uv = np.zeros((t, 3, 2), np.float32)
    mat_names = []
    for fi, (corners, mname) in enumerate(faces):
        for ci, (vi, ti, ni) in enumerate(corners):
            v[fi, ci] = vs[resolve(vi, len(vs))]
            if ti:
                uv[fi, ci] = vts[resolve(ti, len(vts))]
            if ni:
                n[fi, ci] = vns[resolve(ni, len(vns))]
        mat_names.append(mname)

    mat_ids = None
    if builder is not None:
        default = parent_material or Material(color=(0.8, 0.8, 0.8))
        default_id = builder.material_id(default)
        ids = []
        for mname in mat_names:
            if mname is not None and mname in materials:
                ids.append(builder.material_id(materials[mname]))
            else:
                ids.append(default_id)
        mat_ids = np.asarray(ids, np.int32)

    return TriMesh(v, n, uv, mat_ids)


def load_mtl(path: str, builder=None) -> dict[str, Material]:
    """Parse the MTL subset the reference supports (OBJ.cs:167-213)."""
    out: dict[str, Material] = {}
    name = None
    fields: dict = {}
    base = os.path.dirname(path)

    def commit():
        if name is None:
            return
        out[name] = Material(**fields)

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            kw = parts[0].lower()
            if kw == "newmtl":
                commit()
                name = " ".join(parts[1:])
                fields = {}
            elif kw == "ke":
                # emissive: normalized color, max component = emittance
                # (OBJ.cs:193-200)
                c = np.array([float(x) for x in parts[1:4]], np.float32)
                mx = float(c.max())
                if mx > 0:
                    fields["color"] = tuple((c / mx).tolist())
                    fields["emittance"] = mx
            elif kw == "kd":
                if "emittance" not in fields:
                    fields["color"] = tuple(float(x) for x in parts[1:4])
            elif kw == "map_kd" and builder is not None:
                tex_path = os.path.join(base, " ".join(parts[1:]))
                if os.path.exists(tex_path):
                    fields["texture"] = builder.add_texture(load_texture(tex_path))
            elif kw == "map_bump" and builder is not None:
                tex_path = os.path.join(base, " ".join(parts[1:]))
                if os.path.exists(tex_path):
                    fields["bump_texture"] = builder.add_texture(
                        load_texture(tex_path)
                    )
    commit()
    return out


def save_obj(mesh: TriMesh, path: str) -> None:
    """Minimal OBJ writer (round-trip testing / asset generation)."""
    with open(path, "w") as f:
        f.write("# ptsharp OBJ export\n")
        for tri in mesh.v:
            for vert in tri:
                f.write(f"v {vert[0]} {vert[1]} {vert[2]}\n")
        has_n = mesh.n is not None and np.abs(mesh.n).sum() > 0
        if has_n:
            for tri in mesh.n:
                for nrm in tri:
                    f.write(f"vn {nrm[0]} {nrm[1]} {nrm[2]}\n")
        for i in range(mesh.v.shape[0]):
            a, b, c = 3 * i + 1, 3 * i + 2, 3 * i + 3
            if has_n:
                f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
            else:
                f.write(f"f {a} {b} {c}\n")
