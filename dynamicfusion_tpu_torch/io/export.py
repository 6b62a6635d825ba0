"""Mesh and point-cloud export (a copy of ``dynamicfusion_tpu.io.export``):
marching-tetrahedra surface extraction from the canonical TSDF, vertex
welding into an indexed mesh, gradient normals, and binary/ascii PLY and
OBJ writers.

Host-side numpy, as in the JAX package: only ``extract_mesh`` differs, in
reading the port's ``TsdfVolume`` (decoded on its device, then copied to
the host). The tables and the numpy functions are the original's, held
equal to it by ``tests/test_torch_port_basics.py``.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# marching tetrahedra
# ---------------------------------------------------------------------------

# cube corner offsets, and the 6-tetrahedra decomposition of a cube sharing
# the main diagonal (0,6)
_CUBE = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
     (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], dtype=np.int64)
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
     [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], dtype=np.int64)

# tet edges: e0..e5 connect corner pairs
_TET_EDGES = np.array(
    [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], dtype=np.int64)

# triangle table: for each of 16 sign cases (bit i set = corner i inside,
# i.e. tsdf < iso), up to two triangles given as edge-id triples (-1 pad).
# Quads are split along a fixed diagonal; winding is fixed afterwards
# against the TSDF gradient, so only the cyclic order must be valid.
_EMPTY = [[-1, -1, -1], [-1, -1, -1]]
_TRI_TABLE = np.array([
    _EMPTY,                              # 0000
    [[0, 1, 2], [-1, -1, -1]],           # 0001: corner 0
    [[0, 3, 4], [-1, -1, -1]],           # 0010: corner 1
    [[1, 3, 4], [1, 4, 2]],              # 0011: corners 0,1 (cycle e1 e3 e4 e2)
    [[1, 3, 5], [-1, -1, -1]],           # 0100: corner 2
    [[0, 3, 5], [0, 5, 2]],              # 0101: corners 0,2 (cycle e0 e3 e5 e2)
    [[0, 1, 5], [0, 5, 4]],              # 0110: corners 1,2 (cycle e0 e1 e5 e4)
    [[2, 4, 5], [-1, -1, -1]],           # 0111: corner 3 outside
    [[2, 4, 5], [-1, -1, -1]],           # 1000: corner 3
    [[0, 4, 5], [0, 5, 1]],              # 1001: corners 0,3 (cycle e0 e4 e5 e1)
    [[0, 2, 5], [0, 5, 3]],              # 1010: corners 1,3 (cycle e0 e2 e5 e3)
    [[1, 3, 5], [-1, -1, -1]],           # 1011: corner 2 outside
    [[1, 2, 4], [1, 4, 3]],              # 1100: corners 2,3 (cycle e1 e2 e4 e3)
    [[0, 3, 4], [-1, -1, -1]],           # 1101: corner 1 outside
    [[0, 1, 2], [-1, -1, -1]],           # 1110: corner 0 outside
    _EMPTY,                              # 1111
], dtype=np.int64)


class Mesh(NamedTuple):
    vertices: np.ndarray  # (V, 3) float32, world coordinates
    faces: np.ndarray     # (F, 3) int32, outward-wound (toward +tsdf)
    normals: np.ndarray   # (V, 3) float32, unit, outward


def _trilinear_gradient(tsdf: np.ndarray, pts_vox: np.ndarray) -> np.ndarray:
    """Central-difference TSDF gradient trilinearly sampled at voxel-space
    points (the raycaster's normal convention)."""
    d = np.asarray(tsdf.shape)
    g = np.stack(np.gradient(tsdf), axis=-1)  # (D,D,D,3)
    p = np.clip(pts_vox, 0.0, d - 1.001)
    i0 = np.floor(p).astype(np.int64)
    f = (p - i0).astype(np.float32)
    out = np.zeros((len(p), 3), np.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                out += w[:, None] * g[
                    np.minimum(i0[:, 0] + dx, d[0] - 1),
                    np.minimum(i0[:, 1] + dy, d[1] - 1),
                    np.minimum(i0[:, 2] + dz, d[2] - 1),
                ]
    return out


def marching_tetrahedra(
    tsdf: np.ndarray,
    weight: np.ndarray,
    voxel_size: float,
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    iso: float = 0.0,
    weld_decimals: int = 5,
    min_weight: float = 1e-6,
) -> Mesh:
    """Extract the iso-surface triangle mesh from a (D,D,D) TSDF.

    Only cubes whose 8 corners are all observed (weight >= min_weight) and
    straddle the iso value are processed (pipeline callers pass
    cfg.extract_min_weight, so that single-observation voxels do not claim
    surface). Returns an indexed mesh
    with welded vertices and gradient normals; faces are wound so geometric
    normals point toward positive TSDF (outside)."""
    tsdf = np.asarray(tsdf, np.float32)
    weight = np.asarray(weight, np.float32)
    d = tsdf.shape[0]

    # ---- active cubes: all-observed + sign change among corners ----
    def corner(a, off):
        return a[off[0]:off[0] + d - 1, off[1]:off[1] + d - 1, off[2]:off[2] + d - 1]

    vals8 = np.stack([corner(tsdf, o) for o in _CUBE], axis=-1)    # (d-1)^3 x 8
    obs8 = np.stack([corner(weight, o) >= min_weight for o in _CUBE], axis=-1)
    active = obs8.all(-1) & (vals8.min(-1) < iso) & (vals8.max(-1) > iso)
    ci, cj, ck = np.nonzero(active)
    if len(ci) == 0:
        z3 = np.zeros((0, 3))
        return Mesh(z3.astype(np.float32), z3.astype(np.int32), z3.astype(np.float32))

    base = np.stack([ci, cj, ck], axis=-1)                  # (C, 3)
    cvals = vals8[ci, cj, ck]                               # (C, 8)
    cpos = base[:, None, :] + _CUBE[None, :, :]             # (C, 8, 3) voxel coords

    # ---- tets ----
    tv = cvals[:, _TETS].reshape(-1, 4)                      # (T, 4)
    tp = cpos[:, _TETS].reshape(-1, 4, 3).astype(np.float32)  # (T, 4, 3)

    inside = tv < iso
    case = (inside * (1 << np.arange(4))).sum(-1)            # (T,)
    keep = (case != 0) & (case != 15)
    tv, tp, case = tv[keep], tp[keep], case[keep]

    # ---- edge intersection points for all 6 edges of every tet ----
    va = tv[:, _TET_EDGES[:, 0]]                             # (T, 6)
    vb = tv[:, _TET_EDGES[:, 1]]
    denom = vb - va
    t = np.where(np.abs(denom) > 1e-12, (iso - va) / np.where(denom == 0, 1, denom), 0.5)
    t = np.clip(t, 0.0, 1.0)
    pa = tp[:, _TET_EDGES[:, 0]]                             # (T, 6, 3)
    pb = tp[:, _TET_EDGES[:, 1]]
    epts = pa + t[..., None] * (pb - pa)                     # (T, 6, 3) voxel coords

    # ---- gather triangles ----
    tris = _TRI_TABLE[case]                                  # (T, 2, 3) edge ids
    slot_valid = tris[:, :, 0] >= 0                          # (T, 2)
    ti, si = np.nonzero(slot_valid)
    edge_ids = tris[ti, si]                                  # (F, 3)
    tri_pts = epts[ti[:, None], edge_ids]                    # (F, 3, 3) voxel coords

    # ---- weld vertices ----
    flat = tri_pts.reshape(-1, 3)
    key = np.round(flat * (10 ** weld_decimals)).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    verts_vox = flat[first]                                  # (V, 3)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate triangles (two welded corners coincide)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]

    # ---- orient against the TSDF gradient (normals point to +tsdf) ----
    grad_v = _trilinear_gradient(tsdf, verts_vox)            # (V, 3)
    fv = verts_vox[faces]                                    # (F, 3, 3)
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    gsum = grad_v[faces].sum(axis=1)
    flip = (fn * gsum).sum(-1) < 0
    faces[flip] = faces[flip][:, ::-1]

    nrm = grad_v / np.maximum(np.linalg.norm(grad_v, axis=-1, keepdims=True), 1e-12)
    verts = (verts_vox * voxel_size + np.asarray(origin, np.float32)).astype(np.float32)
    return Mesh(verts, faces, nrm.astype(np.float32))


def extract_mesh(cfg, vol, iso: float = 0.0) -> Mesh:
    """Canonical-surface mesh from the port's pipeline ``TsdfVolume``
    (decoded on its device, extracted on the host)."""
    from dynamicfusion_tpu_torch.models import volume as volume_model

    return marching_tetrahedra(
        volume_model.decode_tsdf(vol.tsdf).cpu().numpy(),
        volume_model.decode_weight(vol.weight).cpu().numpy(),
        cfg.voxel_size,
        cfg.volume_origin,
        iso=iso,
        min_weight=cfg.extract_min_weight,
    )


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------


def save_ply(
    path: str,
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write a point cloud or triangle mesh as PLY (binary little-endian by
    default). NaN points are dropped (and faces referencing them, if any)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    finite = np.isfinite(pts).all(-1)
    if faces is not None and not finite.all():
        remap = np.cumsum(finite) - 1
        faces = np.asarray(faces, np.int64)
        faces = remap[faces][finite[np.asarray(faces)].all(-1)]
    pts = pts[finite]
    if normals is not None:
        normals = np.asarray(normals, np.float32).reshape(-1, 3)[finite]
    if colors is not None:
        colors = np.asarray(colors).reshape(-1, 3)[finite]
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)

    props = ["property float x", "property float y", "property float z"]
    cols = [pts]
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
        cols.append(normals)
    header = [
        "ply",
        "format binary_little_endian 1.0" if binary else "format ascii 1.0",
        "comment dynamicfusion_tpu export",
        f"element vertex {len(pts)}",
        *props,
    ]
    if colors is not None:
        header += [
            "property uchar red", "property uchar green", "property uchar blue"
        ]
    if faces is not None:
        header += [
            f"element face {len(faces)}",
            "property list uchar int vertex_indices",
        ]
    header.append("end_header")

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        fl = np.concatenate(cols, axis=-1).astype("<f4")
        if binary:
            if colors is None:
                f.write(fl.tobytes())
            else:
                n = len(pts)
                rec = np.zeros(n, dtype=[("f", "<f4", fl.shape[1]), ("c", "u1", 3)])
                rec["f"] = fl
                rec["c"] = colors
                f.write(rec.tobytes())
            if faces is not None:
                fa = np.asarray(faces, "<i4")
                rec = np.zeros(len(fa), dtype=[("n", "u1"), ("v", "<i4", 3)])
                rec["n"] = 3
                rec["v"] = fa
                f.write(rec.tobytes())
        else:
            for i in range(len(pts)):
                row = " ".join(f"{v:.6f}" for v in fl[i])
                if colors is not None:
                    row += " " + " ".join(str(int(c)) for c in colors[i])
                f.write((row + "\n").encode())
            if faces is not None:
                for tri in np.asarray(faces):
                    f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode())


def save_obj(
    path: str,
    vertices: np.ndarray,
    faces: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
) -> None:
    """Write a Wavefront OBJ mesh (or point set when faces is None)."""
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# dynamicfusion_tpu export\n")
        np.savetxt(f, v, fmt="v %.6f %.6f %.6f")
        if normals is not None:
            np.savetxt(
                f, np.asarray(normals, np.float32).reshape(-1, 3),
                fmt="vn %.6f %.6f %.6f",
            )
        if faces is not None:
            fa = np.asarray(faces, np.int64) + 1  # OBJ is 1-based
            if normals is not None:
                rows = np.stack([fa[:, 0], fa[:, 0], fa[:, 1], fa[:, 1],
                                 fa[:, 2], fa[:, 2]], axis=-1)
                np.savetxt(f, rows, fmt="f %d//%d %d//%d %d//%d")
            else:
                np.savetxt(f, fa, fmt="f %d %d %d")


def save_mesh(path: str, mesh: Mesh) -> None:
    """Write a Mesh by extension (.ply binary or .obj)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        save_obj(path, mesh.vertices, mesh.faces, mesh.normals)
    else:
        save_ply(path, mesh.vertices, normals=mesh.normals, faces=mesh.faces)
