"""Procedural benchmark scenes in NumPy: the same arrays as
`benchmarks/scenes.py`, without the JAX package, so a machine without
JAX can build them.

`build_shell_tree` refines an octree around a spherical shell (a
stand-in for a NeRF-synthetic object surface; sparse, O(surface)
leaves) and returns the tree's arrays as a state dict for
`utils.convert.tree_from_numpy`, the feature pool, and the world-space
centres of the occupied leaves (row i's leaf centre at index i).
"""

from __future__ import annotations

import numpy as np

from .spec import DATA_SENTINEL


def build_shell_tree(
    depth: int = 7,
    data_format: str = "SH9",
    data_dim: int = 28,
    radius: float = 0.30,
    thickness_vox: float = 1.5,
    seed: int = 0,
    N: int = 2,
):
    """Octree refined around the shell |r - radius| < eps.

    :return: (state dict, features (M, data_dim) float32, centers
        (M, 3) float32 world-space centre of the leaf pointing at row i).
    """
    rng = np.random.RandomState(seed)
    fine = 0.5 ** depth

    def shell_hit(centers: np.ndarray, cell_size: float) -> np.ndarray:
        d = np.linalg.norm(centers - 0.5, axis=-1)
        tol = cell_size * np.sqrt(3) * 0.5 + thickness_vox * fine
        return np.abs(d - radius) < tol

    N3 = N ** 3
    u, v, w = np.meshgrid(np.arange(N), np.arange(N), np.arange(N), indexing="ij")
    uvw = np.stack([u.ravel(), v.ravel(), w.ravel()], -1)  # (N^3, 3)

    # Breadth-first construction. Node 0 = root at depth 0.
    child_rows = [np.zeros((1, N3), np.int32)]
    parent_rows = [np.zeros((1, 2), np.int32)]
    frontier_ids = np.array([0], np.int64)
    frontier_corners = np.zeros((1, 3), np.float64)
    n_nodes = 1
    leaf_cells = []  # (node_id, cell_idx, center) of occupied leaves

    for level in range(depth):
        cell = 0.5 ** (level + 1)
        n = len(frontier_ids)
        centers = (frontier_corners[:, None, :] + (uvw[None] + 0.5) * cell).reshape(-1, 3)
        hit = shell_hit(centers, cell)
        subdivide = hit if level < depth - 1 else np.zeros_like(hit)
        occupied = hit & ~subdivide
        node_of = np.repeat(frontier_ids, N3)
        cell_of = np.tile(np.arange(N3), n)
        if occupied.any():
            leaf_cells.append((node_of[occupied], cell_of[occupied], centers[occupied]))
        k = int(subdivide.sum())
        if k == 0:
            break
        new_ids = n_nodes + np.arange(k)
        ch = np.zeros((n, N3), np.int32)
        ch.reshape(-1)[subdivide] = (new_ids - node_of[subdivide]).astype(np.int32)
        child_rows.append(ch)  # rows align with this level's frontier_ids
        pr = np.zeros((k, 2), np.int32)
        pr[:, 0] = (
            (node_of[subdivide] * N + uvw[cell_of[subdivide], 0]) * N
            + uvw[cell_of[subdivide], 1]
        ) * N + uvw[cell_of[subdivide], 2]
        pr[:, 1] = level + 1
        parent_rows.append(pr)
        frontier_ids = new_ids
        frontier_corners = (
            np.repeat(frontier_corners, N3, axis=0) + uvw[np.tile(np.arange(N3), n)] * cell
        )[subdivide]
        n_nodes += k

    child = np.zeros((n_nodes, N3), np.int32)
    pdepth = np.zeros((n_nodes, 2), np.int32)
    offs = 0
    for pr in parent_rows:
        pdepth[offs : offs + len(pr)] = pr
        offs += len(pr)
    # child block i (i >= 1) holds the rows of the frontier at level i-1.
    starts = np.cumsum([0] + [len(p) for p in parent_rows[:-1]])
    for i, ch in enumerate(child_rows[1:]):
        s = starts[i]
        child[s : s + len(ch)] = ch

    data = np.full((n_nodes, N3), DATA_SENTINEL, np.int32)
    if leaf_cells:
        nodes = np.concatenate([c[0] for c in leaf_cells])
        cells = np.concatenate([c[1] for c in leaf_cells])
        centers = np.concatenate([c[2] for c in leaf_cells])
        data[nodes, cells] = np.arange(len(nodes), dtype=np.int32)
        M = len(nodes)
    else:
        centers = np.zeros((0, 3))
        M = 0

    # Default N3Tree geometry (radius 0.5, centre 0.5): world == tree space.
    state = {
        "child": child.reshape(n_nodes, N, N, N),
        "data": data.reshape(n_nodes, N, N, N, 1),
        "parent_depth": pdepth,
        "offset": np.zeros(3, np.float32),
        "invradius": np.ones(3, np.float32),
        "n_internal": n_nodes,
        "filled": n_nodes,
        "depth_limit": depth,
        "data_dim": data_dim,
        "data_format": data_format,
        "extra_data": None,
    }
    feats = (rng.randn(M, data_dim) * 0.3).astype(np.float32)
    feats[:, -1] = np.abs(rng.randn(M)).astype(np.float32) * 30.0 + 10.0
    return state, feats, centers.astype(np.float32)


def build_opaque_tree(depth: int = 7, data_format: str = "SH9",
                      data_dim: int = 28, radius: float = 0.30,
                      seed: int = 0, N: int = 2, sigma: float = 400.0):
    """Shell scene with near-opaque surface densities, where fast mode's
    early ray termination pays."""
    state, feats, centers = build_shell_tree(
        depth=depth, data_format=data_format, data_dim=data_dim,
        radius=radius, seed=seed, N=N,
    )
    feats[:, -1] = sigma
    return state, feats, centers


def dense_density_grid(centers: np.ndarray, sigma: np.ndarray, reso: int) -> np.ndarray:
    """The dense (reso, reso, reso) float32 sigma grid of a shell tree whose
    occupied leaves are all at resolution ``reso`` (`build_shell_tree`'s
    are, at 2**depth): each leaf's sigma at its cell floor(centre * reso),
    0 elsewhere (`grid_weight_render`'s input, in world space = tree space)."""
    cell = np.floor(np.asarray(centers, np.float64) * reso).astype(np.int64)
    if cell.size and (cell.min() < 0 or cell.max() >= reso):
        raise ValueError(f"leaf centres outside the {reso}^3 grid")
    grid = np.zeros((reso, reso, reso), np.float32)
    grid[cell[:, 0], cell[:, 1], cell[:, 2]] = sigma
    return grid


def random_lobes(data_format: str, basis_dim: int, seed: int = 0) -> np.ndarray:
    """Seeded ``extra_data`` for an SG or ASG pool: (basis_dim, 4) rows
    [lambda, mu_xyz] with unit mu, or (basis_dim, 11) rows
    [a, b, x(3), y(3), z(3)] with an orthonormal frame."""
    rng = np.random.RandomState(seed)
    if data_format == "SG":
        mu = rng.randn(basis_dim, 3)
        mu /= np.linalg.norm(mu, axis=1, keepdims=True)
        lam = rng.uniform(1.0, 8.0, (basis_dim, 1))
        return np.concatenate([lam, mu], axis=1).astype(np.float32)
    if data_format == "ASG":
        frames = np.linalg.qr(rng.randn(basis_dim, 3, 3))[0]  # columns x, y, z
        ab = rng.uniform(1.0, 8.0, (basis_dim, 2))
        axes = frames.transpose(0, 2, 1).reshape(basis_dim, 9)
        return np.concatenate([ab, axes], axis=1).astype(np.float32)
    raise ValueError(f"no lobes for {data_format!r}")


def orbit_camera(theta: float = 0.5, phi: float = 0.4, dist: float = 2.2):
    """c2w matrix orbiting the unit-cube center, looking at it."""
    eye = 0.5 + dist * np.array(
        [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)]
    )
    fwd = 0.5 - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w


# Degrees a joint turns at most in `joint_pose_sequence`.
POSE_AMPLITUDE_DEG = 3.0


def skin_to_nearest_joints(points: np.ndarray, joints: np.ndarray, n_bones: int):
    """Skinning of a spatially coherent rig: each point's ``n_bones``
    nearest joints, weights proportional to 1 / distance and normalised.

    :return: (skinning weights (Q, n_bones) float32, joint ids (Q,
        n_bones) int32), nearest joint first
    """
    Q = points.shape[0]
    sw = np.empty((Q, n_bones), np.float32)
    ji = np.empty((Q, n_bones), np.int32)
    chunk = 1 << 18  # points per distance table, to bound host memory
    for s in range(0, Q, chunk):
        p = points[s:s + chunk].astype(np.float64)
        dist = np.linalg.norm(p[:, None, :] - joints[None].astype(np.float64), axis=-1)
        near = np.argsort(dist, axis=1)[:, :n_bones]
        inv = 1.0 / np.maximum(np.take_along_axis(dist, near, axis=1), 1e-6)
        sw[s:s + chunk] = inv / inv.sum(axis=1, keepdims=True)
        ji[s:s + chunk] = near
    return sw, ji


def joint_pose_sequence(joints: np.ndarray, n_frames: int, seed: int) -> np.ndarray:
    """(n_frames, J, 4, 4) float32 poses: in frame k joint j rotates about
    its own position by ``POSE_AMPLITUDE_DEG * sin(2 pi k / n_frames +
    phi_j)`` degrees around a seeded axis, with a seeded phase phi_j. The
    canonical pose is the identity."""
    rng = np.random.RandomState(seed)
    J = joints.shape[0]
    axes = rng.randn(J, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    phase = rng.uniform(0.0, 2.0 * np.pi, J)
    K = np.zeros((J, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axes[:, 2], axes[:, 1], -axes[:, 0]
    K -= K.transpose(0, 2, 1)
    out = np.tile(np.eye(4), (n_frames, J, 1, 1))
    for k in range(n_frames):
        a = np.deg2rad(POSE_AMPLITUDE_DEG) * np.sin(2.0 * np.pi * k / n_frames + phase)
        R = (np.eye(3) + np.sin(a)[:, None, None] * K
             + (1.0 - np.cos(a))[:, None, None] * (K @ K))  # Rodrigues
        out[k, :, :3, :3] = R
        out[k, :, :3, 3] = joints - np.einsum("jab,jb->ja", R, joints)
    return out.astype(np.float32)


def bench_dynamic_cloud() -> dict:
    """The dynamic configuration of `bench.py` (its ``dynamic_fused`` and
    ``dynamic_fast`` keys), in NumPy: 20,000 Gaussian points (seed 1)
    clipped to [0.2, 0.8], an RGBA pool with densities 8-9, two joints
    (the second rotating about z by 0.5 sin(2 pi i / 4) in frame i of 4)
    with weights from the z coordinate. The tree it runs on is
    ``N3Tree(N=2, data_dim=4, depth_limit=6)`` refined 5 times.

    :return: dict of points, features, skinning_weights, joint_index,
        poses (4, 2, 4, 4) and src_pose (2, 4, 4)
    """
    n_points, n_frames = 20000, 4
    rng = np.random.RandomState(1)
    pts = np.clip(0.5 + 0.15 * rng.randn(n_points, 3), 0.2, 0.8).astype(np.float32)
    feats = np.concatenate([rng.rand(n_points, 3), 8.0 + rng.rand(n_points, 1)],
                           axis=1).astype(np.float32)
    sw = np.stack([1.0 - pts[:, 2], pts[:, 2]], axis=1).astype(np.float32)
    ji = np.tile(np.array([0, 1], np.int32), (n_points, 1))
    poses = []
    for i in range(n_frames):
        a = 0.5 * np.sin(2 * np.pi * i / n_frames)
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        poses.append(np.stack([np.eye(4, dtype=np.float32), rot]))
    return dict(points=pts, features=feats, skinning_weights=sw, joint_index=ji,
                poses=np.stack(poses), src_pose=np.stack([np.eye(4, dtype=np.float32)] * 2))


def bench_deep_dynamic_cloud() -> dict:
    """The deep dynamic configuration of `bench.py` (its ``deep9_dyn_*``
    keys), in NumPy: 40,000 points (seed 2) on the sphere of radius 0.30
    about the cube's centre, a pool of 4 columns (colors 0-1, densities
    8-9), two joints (the second rotating about z by 0.4 sin(2 pi i / 4) in
    frame i of 4) with weights from the z coordinate. It runs on the
    depth-9 SH9 shell (`build_shell_tree(depth=9)`) with its index table
    reset to `DATA_SENTINEL` and re-pointed at the canonical points, through
    ``VolumeRenderer(tree, step_size=1e-3)`` at 800x800, fx 880: with SH9 and
    a 4-column pool a frame renders alpha alone (``(3 // 9) + 1`` output
    channels), as in bench.py.

    :return: dict of points, features, skinning_weights, joint_index,
        poses (4, 2, 4, 4) and src_pose (2, 4, 4)
    """
    n_points, n_frames = 40000, 4
    rng = np.random.RandomState(2)
    u = rng.randn(n_points, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (0.5 + 0.30 * u).astype(np.float32)
    feats = np.concatenate([rng.rand(n_points, 3), 8.0 + rng.rand(n_points, 1)],
                           axis=1).astype(np.float32)
    sw = np.stack([1.0 - pts[:, 2], pts[:, 2]], axis=1).astype(np.float32)
    ji = np.tile(np.array([0, 1], np.int32), (n_points, 1))
    poses = []
    for i in range(n_frames):
        a = 0.4 * np.sin(2 * np.pi * i / n_frames)
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        poses.append(np.stack([np.eye(4, dtype=np.float32), rot]))
    return dict(points=pts, features=feats, skinning_weights=sw, joint_index=ji,
                poses=np.stack(poses), src_pose=np.stack([np.eye(4, dtype=np.float32)] * 2))
