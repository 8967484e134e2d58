"""STL loader: binary/ASCII autodetect -> TriMesh.

Parity with reference STL.cs: the 84-byte-header + 50-byte-facet binary
format (STL.cs:160-224) and the `solid`/`facet` ASCII grammar
(STL.cs:80-141), with the same autodetection approach (size check against
the declared triangle count, STL.cs:56-78).
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

from ptsharp.geometry.mesh import TriMesh

_ASCII_VERTEX = re.compile(rb"vertex\s+([^\s]+)\s+([^\s]+)\s+([^\s]+)")
_ASCII_NORMAL = re.compile(rb"facet\s+normal\s+([^\s]+)\s+([^\s]+)\s+([^\s]+)")


def load_stl(path: str) -> TriMesh:
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        header = f.read(84)
        if len(header) >= 84:
            (count,) = struct.unpack_from("<I", header, 80)
            if 84 + count * 50 == size:
                return _load_binary(f, count)
    return _load_ascii(path)


def _load_binary(f, count: int) -> TriMesh:
    raw = np.frombuffer(f.read(count * 50), dtype=np.uint8)
    raw = raw.reshape(count, 50)
    floats = raw[:, :48].copy().view(np.float32).reshape(count, 4, 3)
    normals = floats[:, 0]  # per-facet normal
    v = floats[:, 1:4]
    n = np.repeat(normals[:, None, :], 3, axis=1)
    # zero normals are regenerated later by fix_normals
    return TriMesh(v.astype(np.float32), n.astype(np.float32))


def _load_ascii(path: str) -> TriMesh:
    with open(path, "rb") as f:
        data = f.read()
    verts = np.array(
        [[float(a), float(b), float(c)] for a, b, c in _ASCII_VERTEX.findall(data)],
        np.float32,
    )
    t = verts.shape[0] // 3
    v = verts[: t * 3].reshape(t, 3, 3)
    normals = _ASCII_NORMAL.findall(data)
    n = None
    if len(normals) >= t:
        nn = np.array(
            [[float(a), float(b), float(c)] for a, b, c in normals[:t]], np.float32
        )
        n = np.repeat(nn[:, None, :], 3, axis=1)
    return TriMesh(v, n)


def save_stl(mesh: TriMesh, path: str, binary: bool = True) -> None:
    """Binary STL writer (asset generation / round-trip tests)."""
    t = mesh.v.shape[0]
    fn = mesh.face_normals()
    if binary:
        with open(path, "wb") as f:
            f.write(b"ptsharp binary stl".ljust(80, b"\0"))
            f.write(struct.pack("<I", t))
            for i in range(t):
                f.write(struct.pack("<3f", *fn[i]))
                for k in range(3):
                    f.write(struct.pack("<3f", *mesh.v[i, k]))
                f.write(struct.pack("<H", 0))
    else:
        with open(path, "w") as f:
            f.write("solid ptsharp\n")
            for i in range(t):
                f.write(f"facet normal {fn[i][0]} {fn[i][1]} {fn[i][2]}\n")
                f.write("outer loop\n")
                for k in range(3):
                    vv = mesh.v[i, k]
                    f.write(f"vertex {vv[0]} {vv[1]} {vv[2]}\n")
                f.write("endloop\nendfacet\n")
            f.write("endsolid ptsharp\n")
