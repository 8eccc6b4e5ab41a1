"""Offline mesher: occupancy-field extraction -> triangle mesh (.ply).

A copy of the JAX package's ``eval/mesher.py``: query the decoder
hierarchy's occupancy on a dense grid in fixed-size chunks (the last one
padded), then extract the level-0 isosurface by *marching tetrahedra* (each
cube split into 6 tets: table-free, watertight, exactly linear-interpolated
on edges). Color is assigned by a direct point query of the color decoder
at the vertex positions. The queries run on the device that holds the grids
(the card, by default) under ``torch.no_grad()``, through whichever sampler
route is active (``ops.trilinear.sampler_route``), a chunk at a time as a
program (``slam/programs.py``: on a card a replayed CUDA graph, the
counterpart of the JAX package's jitted ``eval_chunk`` and
``color_chunk``); the isosurface, the cleanup and the PLY writer are
numpy.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..models.decoders import nice_forward

# 6-tetrahedra decomposition of the unit cube around the 0-6 main diagonal.
# Corners: bit 0 -> x, bit 1 -> y, bit 2 -> z  (c = x + 2y + 4z); every tet
# shares edge 0-6 so neighbouring cubes agree on shared faces.
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 3, 6],
        [0, 3, 2, 6],
        [0, 2, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int32,
)
_CORNER_OFFSETS = np.array(
    [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], np.int32
)  # corner c = x + 2y + 4z


# The outputs a chunk can query: the occupancy logit, the raw colour.
_COLUMNS = {"occupancy": 3, "rgb": slice(0, 3)}


def query_chunks(params, grids, bounds, flat: np.ndarray, chunk: int, stage: str,
                  output: str, programs=None) -> np.ndarray:
    """``nice_forward(..., stage)[:, _COLUMNS[output]]`` over ``flat [P,
    3]`` in chunks of ``chunk`` points on the grids' device, each chunk one
    call of a program keyed on (stage, output, chunk, the grids' shapes, the
    sampler route); the last chunk is padded with zeros and the padding
    dropped. The points go to the device in one copy, the map into the
    program once, and the result comes back in one copy, the query's one
    wait. The program lives in ``programs`` (a ``slam.programs.Programs``),
    by default the process-wide ones, graphs on a card;
    ``Programs(capture=False)`` runs the same buffers eagerly (on a card,
    only to compare the two)."""
    from ..slam.programs import shared_programs  # slam imports the renderer

    device = next(iter(grids.values())).device
    pad = (-len(flat)) % chunk
    flat_p = torch.from_numpy(
        np.concatenate([flat, np.zeros((pad, 3), np.float32)])
    ).to(device)
    col = _COLUMNS[output]

    def query(params, grids, bounds, p):
        return nice_forward(params, grids, p, bounds, stage)[:, col]

    fixed = (params, grids, bounds)
    if programs is None:
        programs = shared_programs(device)
    prog = programs.static_program(
        f"mesher_chunk {stage} {output} n={chunk}", (), device, query, fixed, (flat_p[:chunk],))
    prog.load(*fixed)
    out = torch.cat([prog.run(flat_p[i : i + chunk]).clone()
                     for i in range(0, len(flat_p), chunk)])
    return out.cpu().numpy()[: len(flat)]


def lattice_points(scene_bound, resolution: int) -> np.ndarray:
    """The query lattice ``[R, R, R, 3]`` (xyz points, axes in (z, y, x)
    order) over ``scene_bound [3, 2]``."""
    sb = (
        scene_bound.detach().cpu().numpy()
        if isinstance(scene_bound, torch.Tensor) else np.asarray(scene_bound)
    )
    xs = np.linspace(sb[0, 0], sb[0, 1], resolution)
    ys = np.linspace(sb[1, 0], sb[1, 1], resolution)
    zs = np.linspace(sb[2, 0], sb[2, 1], resolution)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    return np.stack([X, Y, Z], axis=-1).astype(np.float32)


def query_occupancy_grid(
    params,
    grids: Dict[str, torch.Tensor],
    bounds: Dict[str, torch.Tensor],
    scene_bound,
    resolution: int = 128,
    chunk: int = 65536,
    stage: str = "fine",
    programs=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense occupancy field over the scene bound.

    Returns ``(occ [R, R, R], pts [R, R, R, 3])`` with axis order (z, y, x).
    """
    pts = lattice_points(scene_bound, resolution)
    occ = query_chunks(params, grids, bounds, pts.reshape(-1, 3), chunk, stage, "occupancy",
                        programs)
    return occ.reshape(resolution, resolution, resolution), pts


def marching_tetrahedra(
    field: np.ndarray, pts: np.ndarray, level: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``field == level`` isosurface. Returns (verts, faces).

    ``field`` is [Z, Y, X]; ``pts`` gives world positions per grid node.
    Vectorized over all cubes; memory ~ O(cubes x 24).
    """
    f = field - level
    nz, ny, nx = f.shape
    # Cube base indices.
    bz, by, bx = np.meshgrid(
        np.arange(nz - 1), np.arange(ny - 1), np.arange(nx - 1), indexing="ij"
    )
    base = np.stack([bx.ravel(), by.ravel(), bz.ravel()], axis=-1)  # [C, 3] xyz

    # Corner values/positions [C, 8].
    cz = base[:, 2][:, None] + _CORNER_OFFSETS[None, :, 2]
    cy = base[:, 1][:, None] + _CORNER_OFFSETS[None, :, 1]
    cx = base[:, 0][:, None] + _CORNER_OFFSETS[None, :, 0]
    vals = f[cz, cy, cx]  # [C, 8]
    pos = pts[cz, cy, cx]  # [C, 8, 3]

    # Early reject cubes with uniform sign.
    active = ~(np.all(vals > 0, axis=1) | np.all(vals < 0, axis=1))
    vals, pos = vals[active], pos[active]
    if len(vals) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    tet_vals = vals[:, _TETS]  # [C, 6, 4]
    tet_pos = pos[:, _TETS]  # [C, 6, 4, 3]
    tv = tet_vals.reshape(-1, 4)
    tp = tet_pos.reshape(-1, 4, 3)
    inside = tv > 0  # occupancy positive = inside
    code = (
        inside[:, 0] * 1 + inside[:, 1] * 2 + inside[:, 2] * 4 + inside[:, 3] * 8
    )

    def interp(p1, v1, p2, v2):
        t = v1 / (v1 - v2 + 1e-30)
        return p1 + t[:, None] * (p2 - p1)

    tris = []
    # Enumerate the 14 non-trivial sign patterns of a tetrahedron.
    for c in range(1, 15):
        m = code == c
        if not m.any():
            continue
        ins = [i for i in range(4) if c & (1 << i)]
        outs = [i for i in range(4) if not c & (1 << i)]
        P, V = tp[m], tv[m]
        if len(ins) == 1:
            a = ins[0]
            e = [interp(P[:, a], V[:, a], P[:, o], V[:, o]) for o in outs]
            tris.append(np.stack([e[0], e[1], e[2]], axis=1))
        elif len(ins) == 3:
            a = outs[0]
            e = [interp(P[:, i], V[:, i], P[:, a], V[:, a]) for i in ins]
            tris.append(np.stack([e[0], e[2], e[1]], axis=1))
        else:  # 2 in, 2 out -> quad -> 2 triangles
            i0, i1 = ins
            o0, o1 = outs
            e00 = interp(P[:, i0], V[:, i0], P[:, o0], V[:, o0])
            e01 = interp(P[:, i0], V[:, i0], P[:, o1], V[:, o1])
            e10 = interp(P[:, i1], V[:, i1], P[:, o0], V[:, o0])
            e11 = interp(P[:, i1], V[:, i1], P[:, o1], V[:, o1])
            tris.append(np.stack([e00, e10, e01], axis=1))
            tris.append(np.stack([e01, e10, e11], axis=1))
    tri = np.concatenate(tris, axis=0)  # [T, 3, 3]

    # Weld vertices.
    flat = tri.reshape(-1, 3)
    quant = np.round(flat / 1e-6).astype(np.int64)
    uniq, inv = np.unique(quant, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    verts = np.zeros((len(uniq), 3))
    verts[inv] = flat
    faces = inv.reshape(-1, 3)
    # Drop degenerate faces.
    keep = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[keep]


def extract_mesh(
    params,
    grids,
    bounds,
    scene_bound,
    resolution: int = 128,
    level: float = 0.0,
    with_color: bool = True,
    chunk: int = 65536,
    programs=None,
):
    """Full pipeline: query field -> marching tets -> per-vertex color."""
    occ, pts = query_occupancy_grid(
        params, grids, bounds, scene_bound, resolution, chunk, programs=programs
    )
    verts, faces = marching_tetrahedra(occ, pts, level)
    colors = None
    if with_color and len(verts):
        cs = query_chunks(params, grids, bounds, verts.astype(np.float32), chunk, "color",
                           "rgb", programs)
        colors = np.clip(cs, 0, 1)
    return verts, faces, colors


def largest_components(
    verts: np.ndarray, faces: np.ndarray, colors=None, keep: int = 1
):
    """Keep the ``keep`` largest face-connected components: floating blobs
    in never-observed space disconnect from the main surface and are
    dropped. Union-find over the vertex graph induced by faces."""
    n = len(verts)
    parent = np.arange(n)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for f in faces:
        r0, r1, r2 = find(f[0]), find(f[1]), find(f[2])
        parent[r1] = r0
        parent[r2] = r0
    roots = np.array([find(i) for i in range(n)])
    face_root = roots[faces[:, 0]]
    counts = np.bincount(face_root, minlength=n)
    keep_roots = set(np.argsort(counts)[::-1][:keep].tolist())
    fmask = np.array([r in keep_roots for r in face_root])
    return _compact(verts, faces[fmask], colors)


def cull_unseen(
    verts: np.ndarray,
    faces: np.ndarray,
    colors,
    poses_c2w: np.ndarray,
    intr,
    depths: np.ndarray = None,
    bound_scale: float = 1.02,
    depth_test: bool = False,
):
    """Drop mesh geometry the trajectory never observed.

    A vertex survives if ANY camera sees it: inside the (slightly enlarged)
    image frustum, in front of the camera, and (with ``depth_test`` and
    per-frame depth maps) not farther than the observed surface by more than
    ``bound_scale``. Faces keep only if all three vertices survive.
    """
    poses = np.asarray(poses_c2w, np.float32)
    v = np.asarray(verts, np.float32)
    seen = np.zeros(len(v), bool)
    mw = (bound_scale - 1.0) * intr.W / 2
    mh = (bound_scale - 1.0) * intr.H / 2
    for ci in range(len(poses)):
        if seen.all():
            break
        w2c = np.linalg.inv(poses[ci])
        pc = v @ w2c[:3, :3].T + w2c[:3, 3]
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = intr.fx * pc[:, 0] / z + intr.cx
            w_ = intr.fy * pc[:, 1] / z + intr.cy
        ok = (
            (z > 0)
            & (u >= -mw) & (u < intr.W + mw)
            & (w_ >= -mh) & (w_ < intr.H + mh)
        )
        if depth_test and depths is not None:
            ui = np.clip(np.round(u).astype(np.int64), 0, intr.W - 1)
            wi = np.clip(np.round(w_).astype(np.int64), 0, intr.H - 1)
            d = np.asarray(depths[ci])[wi, ui]
            ok &= (d <= 0) | (z <= d * bound_scale)
        seen |= ok
    fmask = seen[faces].all(axis=1)
    return _compact(verts, faces[fmask], colors)


def _compact(verts, faces, colors):
    """Drop vertices unused by ``faces``; remap indices."""
    used = np.zeros(len(verts), bool)
    if len(faces):
        used[faces.ravel()] = True
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(used.sum())
    verts2 = np.asarray(verts)[used]
    faces2 = remap[faces] if len(faces) else faces
    colors2 = None if colors is None else np.asarray(colors)[used]
    return verts2, faces2, colors2


def postprocess_mesh(
    verts, faces, colors, mcfg, poses_c2w=None, intr=None, depths=None
):
    """Apply the ``meshing.*`` cleanup options (``MeshingConfig``)."""
    if len(faces) == 0:
        return verts, faces, colors
    if mcfg.clean_mesh and poses_c2w is not None and intr is not None:
        verts, faces, colors = cull_unseen(
            verts, faces, colors, poses_c2w, intr, depths,
            bound_scale=mcfg.clean_mesh_bound_scale,
            depth_test=mcfg.depth_test,
        )
    if mcfg.get_largest_components and len(faces):
        verts, faces, colors = largest_components(verts, faces, colors)
    return verts, faces, colors


def write_ply(path: str, verts, faces, colors=None):
    """Minimal ASCII PLY writer (no mesh library needed)."""
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(verts)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            fh.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        fh.write(f"element face {len(faces)}\n")
        fh.write("property list uchar int vertex_indices\nend_header\n")
        if colors is not None:
            c8 = (np.asarray(colors) * 255).astype(np.uint8)
            for v, c in zip(verts, c8):
                fh.write(
                    f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]} {c[1]} {c[2]}\n"
                )
        else:
            for v in verts:
                fh.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces:
            fh.write(f"3 {f[0]} {f[1]} {f[2]}\n")
