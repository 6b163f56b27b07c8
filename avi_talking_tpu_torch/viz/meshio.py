"""Dependency-free OBJ / PLY mesh IO on the host, numpy only (port of
``avi_talking_tpu/viz/meshio.py``): ``read_obj`` gives ``--uv-obj``'s UVs,
``write_obj`` / ``write_ply`` dump meshes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (F, 3) int32 (0-based)
    uvs: Optional[np.ndarray] = None  # (Tv, 2)
    face_uvs: Optional[np.ndarray] = None  # (F, 3) indices into uvs
    colors: Optional[np.ndarray] = None  # (V, 3) vertex colors

    def save(self, path: str) -> None:
        if path.endswith(".ply"):
            write_ply(path, self.vertices, self.faces)
        else:
            write_obj(path, self.vertices, self.faces, self.uvs, self.face_uvs,
                      self.colors)


def read_obj(path: str) -> Mesh:
    verts, faces, uvs, face_uvs, colors = [], [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:  # vertex colors
                    colors.append([float(x) for x in parts[4:7]])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("f "):
                idx, tidx = [], []
                for tok in line.split()[1:4]:
                    comps = tok.split("/")
                    idx.append(int(comps[0]) - 1)
                    if len(comps) > 1 and comps[1]:
                        tidx.append(int(comps[1]) - 1)
                faces.append(idx)
                if len(tidx) == 3:
                    face_uvs.append(tidx)
    return Mesh(
        vertices=np.asarray(verts, np.float32),
        faces=np.asarray(faces, np.int32),
        uvs=np.asarray(uvs, np.float32) if uvs else None,
        face_uvs=np.asarray(face_uvs, np.int32) if face_uvs else None,
        colors=np.asarray(colors, np.float32) if colors else None,
    )


def write_obj(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    uvs: Optional[np.ndarray] = None,
    face_uvs: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
) -> None:
    with open(path, "w") as f:
        for i, v in enumerate(np.asarray(vertices)):
            if colors is not None:
                c = colors[i]
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
            else:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if uvs is not None:
            for t in np.asarray(uvs):
                f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        for fi, face in enumerate(np.asarray(faces)):
            if face_uvs is not None:
                tu = face_uvs[fi]
                f.write(
                    f"f {face[0]+1}/{tu[0]+1} {face[1]+1}/{tu[1]+1} {face[2]+1}/{tu[2]+1}\n"
                )
            else:
                f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    v = np.asarray(vertices, np.float32)
    fc = np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(v)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(fc)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode())
        f.write(v.astype("<f4").tobytes())
        buf = bytearray()
        for row in fc:
            buf += b"\x03" + row.astype("<i4").tobytes()
        f.write(bytes(buf))
