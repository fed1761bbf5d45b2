"""N^3-branching sparse voxel octree with an indirected feature pool: the
counterpart of `svox_t_tpu/models/tree.py`, as far as the serving and
training paths need it.

The tree is three separate arrays, as in the JAX package: structure
(`child`, `parent_depth`), an int32 index table (`data`) and a dense
feature pool that the caller passes to every render. Structure edits
(`refine`, `shrink_to_fit`) are host NumPy; `construct_tree` re-points
the index table on ``device`` and leaves it there until a structure edit
needs it on the host. `.npz` files are interchangeable with the JAX
package's `save`/`load`, including legacy files whose `data` holds float
leaf features. `forward` is the differentiable point query, and
`accumulate_weights` collects per-leaf render weights while it locks the
structure.

`_baked_spec` bakes the tree for the baked render backend
(`ops/bake.py`) on the host, once, and keeps the bake until the structure,
the index table or ``extra_data`` is replaced. `construct_tree` keeps a
cached bake current on ``device``: the points' leaf box joins the
occupied box, `refresh` re-packs the rows and `grow_boxes_device` regrows
the skip boxes, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bake as bake_ops
from ..ops import query as query_ops
from ..ops import traversal
from ..utils.dataformat import DataFormat
from ..utils.spec import DATA_SENTINEL, TreeSpec, make_tree_spec


class N3Tree:
    """N^3 tree: 3D tree with branching factor N per interior node
    (N=2 is the familiar octree). Its tables live on the host; its specs
    and re-pointed index table on ``device``, the CUDA card unless the
    caller names another device (without a card it raises)."""

    def __init__(
        self,
        N=2,
        data_dim=4,
        depth_limit=10,
        init_reserve=1,
        init_refine=0,
        geom_resize_fact=1.5,
        radius=0.5,
        center=[0.5, 0.5, 0.5],
        data_format="RGBA",
        extra_data=None,
        device="cuda",
        dtype=torch.float32,
    ):
        if N < 2 or depth_limit < 0:
            raise ValueError("N must be >= 2 and depth_limit >= 0")
        self.N: int = int(N)
        self.data_dim: int = int(data_dim)
        self.dtype = dtype
        self.device = torch.device(device)

        if init_refine > 0:
            for i in range(1, init_refine + 1):
                init_reserve += (N ** i) ** 3

        self.features = torch.zeros((init_reserve, data_dim), dtype=dtype, device=self.device)
        self._data = np.full((init_reserve, N, N, N, 1), DATA_SENTINEL, dtype=np.int32)
        self._child = np.zeros((init_reserve, N, N, N), dtype=np.int32)
        self._parent_depth = np.zeros((init_reserve, 2), dtype=np.int32)
        self._n_internal = 1
        self._n_free = 0

        if isinstance(radius, (float, int)):
            radius = [radius] * 3
        radius = np.asarray(radius, np.float32)
        center = np.asarray(center, np.float32)
        self.invradius = 0.5 / radius
        self.offset = 0.5 * (1.0 - center / radius)

        self.depth_limit = int(depth_limit)
        self.geom_resize_fact = float(geom_resize_fact)
        self.data_format = DataFormat(data_format) if data_format is not None else None
        self.extra_data = extra_data
        self._weight_accum = None
        self._lock_tree_structure = False
        self._invalidate()
        self.filled = self._n_internal
        self.refine(repeats=init_refine)

    # ------------------------------------------------------------------
    # Buffer views

    def _ensure_host_data(self):
        """`_data` lives on the device after construct_tree(); pull it
        back before host-side mutation."""
        if isinstance(self._data, torch.Tensor):
            self._data = self._data.cpu().numpy().reshape(-1, self.N, self.N, self.N, 1)

    @property
    def data(self) -> np.ndarray:
        """(capacity, N, N, N, 1) int32 index table into the feature pool."""
        self._ensure_host_data()
        return self._data

    @data.setter
    def data(self, value):
        self._data = np.asarray(value, np.int32).reshape(-1, self.N, self.N, self.N, 1)
        self._cached_spec = None
        self._cached_baked = None

    @property
    def child(self) -> np.ndarray:
        return self._child

    @property
    def parent_depth(self) -> np.ndarray:
        return self._parent_depth

    @property
    def extra_data(self):
        """Auxiliary per-tree array (SG/ASG parameters)."""
        return self._extra_data

    @extra_data.setter
    def extra_data(self, value):
        self._extra_data = None if value is None else np.asarray(value, np.float32)
        self._cached_spec = None
        self._cached_baked = None

    # ------------------------------------------------------------------
    # Spec marshaling

    def _spec(self, transformation_matrices=None, joint_features=None,
              skinning_weights=None, joint_index=None) -> TreeSpec:
        """The device TreeSpec (cached until the tree changes).

        ``transformation_matrices`` (M, 4, 4), ``joint_features`` (J, Kd),
        ``skinning_weights`` and ``joint_index`` (M, n_bones) are attached
        per call, not cached."""
        if self._cached_spec is None:
            rows = self._parent_depth[: max(self.filled, 1), 1]
            self._cached_spec = make_tree_spec(
                self._child,
                self._data,
                self._parent_depth,
                self.offset,
                self.invradius,
                n_internal=self.filled,
                # bound descent by the actual tree depth
                n_levels=int(rows.max()) + 2,
                extra_data=self.extra_data,
                device=self.device,
            )
        return self._attach(self._cached_spec, transformation_matrices=transformation_matrices,
                            joint_features=joint_features, skinning_weights=skinning_weights,
                            joint_index=joint_index)

    def _attach(self, spec, **per_call):
        """``spec`` with the given per-call tensors attached on ``device``."""
        dtypes = dict(joint_index=torch.int32)
        attach = {k: torch.as_tensor(v, dtype=dtypes.get(k, torch.float32),
                                     device=self.device).contiguous()
                  for k, v in per_call.items() if v is not None}
        return spec.with_(**attach) if attach else spec

    def _baked_spec(self, transformation_matrices=None, skinning_weights=None,
                    joint_index=None) -> bake_ops.BakedTree:
        """The baked render structure (`ops/bake.py`), baked on the host
        once and kept current by `construct_tree`; the per-call tensors
        are attached as in `_spec`."""
        if self._cached_baked is None:
            self._ensure_host_data()
            self._cached_baked = bake_ops.bake_arrays(
                self._child, self._data, self._parent_depth, self.offset, self.invradius,
                self.filled, extra_data=self.extra_data, device=self.device,
            )
        return self._attach(self._cached_baked, transformation_matrices=transformation_matrices,
                            skinning_weights=skinning_weights, joint_index=joint_index)

    # ------------------------------------------------------------------
    # Real-time octree (re)pointing

    def construct_tree(self, indices):
        """Attach a (Q, 3) world-space point cloud: point i's leaf index
        slot is set to i. Runs on ``device``; the index table stays there
        until a host-side structure op needs it."""
        spec = self._spec()
        points = torch.as_tensor(indices, dtype=torch.float32, device=self.device)
        new_data_flat = query_ops.construct_tree(spec, points)
        lo = hi = None
        baked = self._cached_baked
        if baked is not None:
            # Old cells keep their rows: the box grows by the points' leaves.
            lo, hi = query_ops.points_leaf_aabb(spec, points,
                                                union=(baked.aabb_lo, baked.aabb_hi))
        self._adopt_data_flat(spec, new_data_flat, lo, hi)

    def _adopt_data_flat(self, spec: TreeSpec, new_data_flat: torch.Tensor, lo=None, hi=None):
        """Adopt a re-pointed flat index table (from `construct_tree` or a
        frame loop) produced from ``spec``: it becomes the tree's table, on
        ``device``, and the cached spec points at it. A cached bake is
        refreshed from it with the occupied box (lo, hi), which must cover
        the bake's old box (without it, the whole cube), and its skip boxes
        regrow."""
        self._data = new_data_flat
        self._cached_spec = spec.with_(data_flat=new_data_flat)
        if self._cached_baked is not None:
            baked = bake_ops.refresh(self._cached_baked, new_data_flat, lo, hi)
            self._cached_baked = bake_ops.grow_boxes_device(baked)

    # ------------------------------------------------------------------
    # Differentiable point query

    def forward(self, features, indices, cuda=True, want_node_ids=False,
                world=True, want_data_ids=False, want_leaf_node=False):
        """Differentiable point query of ``features`` (M, D) at (Q, 3)
        points, on ``device``.

        :return: values (Q, D); plus packed node ids and/or data ids when
            requested. Empty leaves give zero values.
        """
        del cuda
        if want_leaf_node:
            raise NotImplementedError(
                "want_leaf_node needs unique_leaf_nodes, which waits for the "
                "rest of K8b (ROADMAP.md §2)"
            )
        indices = torch.as_tensor(indices, dtype=torch.float32, device=self.device)
        if indices.ndim != 2:
            raise ValueError(f"indices must be (Q, 3), got {tuple(indices.shape)}")
        values, node_ids, data_ids = query_ops.query(self._spec(), features, indices, world)
        if not (want_node_ids or want_data_ids):
            return values
        ret = [values]
        if want_node_ids:
            ret.append(node_ids)
        if want_data_ids:
            ret.append(data_ids)
        return ret

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def accumulate_weights(self):
        """Context manager collecting per-leaf render contribution
        weights; see `WeightAccumulator`."""
        return WeightAccumulator(self)

    def _check_unlocked(self):
        if self._lock_tree_structure:
            raise RuntimeError("Tree locked")

    # ------------------------------------------------------------------
    # Refinement & memory management

    def _node_cells(self, nodes: np.ndarray) -> np.ndarray:
        """(len(nodes) * N^3, 4) [node, x, y, z] rows covering every cell
        of the given nodes, cells in row-major order within each node."""
        N = self.N
        grid = np.stack(
            np.meshgrid(np.arange(N), np.arange(N), np.arange(N), indexing="ij"),
            axis=-1,
        ).reshape(-1, 3)
        out = np.empty((len(nodes), N ** 3, 4), np.int64)
        out[:, :, 0] = np.asarray(nodes)[:, None]
        out[:, :, 1:] = grid[None]
        return out.reshape(-1, 4)

    def refine(self, repeats=1, sel=None, leaf_node=None, node_id=None):
        """Refine selected leaves (default: all below depth_limit).

        Each selected leaf cell becomes an internal node whose N^3 child
        cells inherit the parent cell's index-table entry; new nodes are
        appended at the tail, and `child` keeps parent-relative offsets.

        :param sel: tuple of 4 index arrays (node, x, y, z), or None.
        :param leaf_node: optional (L, 4) array equivalent of `sel`.
        :return: True iff buffers were resized.
        """
        self._check_unlocked()
        self._ensure_host_data()
        resized = False
        mutated = False
        if sel is not None or leaf_node is not None:
            targets = (
                np.asarray(leaf_node)
                if leaf_node is not None
                else np.stack([np.asarray(t) for t in sel], axis=-1)
            )
        else:
            targets = None
        for pass_no in range(repeats):
            if targets is None:
                leaves = self._all_leaves()
                targets = leaves[self._parent_depth[leaves[:, 0], 1] < self.depth_limit]
            n_new = len(targets)
            if n_new == 0:
                break
            base = self.filled
            shortfall = base + n_new - self.capacity
            if shortfall > 0:
                self._grow_buffers(shortfall)
                resized = True
            parents = targets[:, 0].astype(np.int32)
            cells = (parents,) + tuple(targets[:, 1 + a] for a in range(3))
            ids = base + np.arange(n_new, dtype=np.int32)
            # Each split cell points (relatively) at its new node ...
            self._child[cells] = ids - parents
            # ... whose cells all inherit the split cell's data pointer.
            self._data[ids] = self._data[cells][:, None, None, None]
            self._parent_depth[ids, 0] = (
                self._pack_index_np(targets) if node_id is None else node_id
            )
            child_depth = self._parent_depth[parents, 1] + 1
            self._parent_depth[ids, 1] = child_depth
            self._n_internal += n_new
            self.filled += n_new
            mutated = True
            node_id = None  # caller-supplied ids apply to the first pass only
            if pass_no + 1 < repeats:
                targets = self._node_cells(ids[child_depth < self.depth_limit])
        if mutated:
            self._invalidate()
        return resized

    def shrink_to_fit(self):
        """Defragment and trim the node buffers to the live node count.
        Returns True if the buffers changed."""
        self._check_unlocked()
        self._ensure_host_data()
        n_nodes = self.n_internal
        live = n_nodes - self._n_free
        if live >= self.capacity:
            return False
        if self._n_free:
            N3 = self.N ** 3
            keep = self._parent_depth[:n_nodes, 0] != -1
            new_id = np.cumsum(keep, dtype=np.int64) - 1
            old_ids = np.flatnonzero(keep)
            offs = self._child[old_ids]
            shift = new_id[old_ids]
            offs = np.where(
                offs != 0,
                new_id[old_ids[:, None, None, None] + offs] - shift[:, None, None, None],
                0,
            ).astype(np.int32)
            links = self._parent_depth[old_ids].copy()
            links[:, 0] = (new_id[links[:, 0] // N3] * N3 + links[:, 0] % N3).astype(np.int32)
            self._child = offs
            self._data = self._data[old_ids]
            self._parent_depth = links
            self._n_internal = live
            self._n_free = 0
        else:
            self._data = self._data[:live]
            self._child = self._child[:live]
            self._parent_depth = self._parent_depth[:live]
        self.filled = min(self.filled, live)
        self._invalidate()
        return True

    def _grow_buffers(self, min_extra: int):
        """Grow node-array capacity by at least `min_extra` rows and at
        least geom_resize_fact; new index rows start at the sentinel."""
        old_cap = self.capacity
        new_cap = max(old_cap + int(min_extra), int(old_cap * self.geom_resize_fact))

        def grown(arr, fill):
            out = np.full((new_cap,) + arr.shape[1:], fill, arr.dtype)
            out[:old_cap] = arr
            return out

        self._data = grown(self._data, DATA_SENTINEL)
        self._child = grown(self._child, 0)
        self._parent_depth = grown(self._parent_depth, 0)

    def _all_leaves(self) -> np.ndarray:
        if self._last_all_leaves is None:
            self._last_all_leaves = np.stack(
                np.nonzero(self._child[: self.n_internal] == 0), axis=-1
            )
        return self._last_all_leaves

    def _pack_index_np(self, txyz: np.ndarray) -> np.ndarray:
        N = self.N
        return ((txyz[:, 0] * N + txyz[:, 1]) * N + txyz[:, 2]) * N + txyz[:, 3]

    def _invalidate(self):
        self._last_all_leaves = None
        self._cached_spec = None
        self._cached_baked = None

    # ------------------------------------------------------------------
    # Counts

    @property
    def n_leaves(self):
        return self._all_leaves().shape[0]

    @property
    def n_internal(self):
        return self._n_internal

    @property
    def capacity(self):
        return self._parent_depth.shape[0]

    @property
    def depths(self) -> np.ndarray:
        """Leaf depths (root children = 0), (n_leaves,) int32."""
        return self._parent_depth[self._all_leaves()[:, 0], 1]

    @property
    def max_depth(self):
        return int(self.depths.max())

    def world2tree(self, indices):
        return traversal.world2tree(
            torch.as_tensor(indices, dtype=torch.float32, device=self.device),
            torch.as_tensor(self.offset, device=self.device),
            torch.as_tensor(self.invradius, device=self.device),
        )

    def tree2world(self, indices):
        return traversal.tree2world(
            torch.as_tensor(indices, dtype=torch.float32, device=self.device),
            torch.as_tensor(self.offset, device=self.device),
            torch.as_tensor(self.invradius, device=self.device),
        )

    # ------------------------------------------------------------------
    # Persistence (the JAX package's .npz schema)

    def save(self, path, shrink=True, compress=True):
        """Save structure and feature pool to .npz."""
        self._ensure_host_data()
        if shrink:
            self.shrink_to_fit()
        data = {
            "data_dim": self.data_dim,
            "child": self._child,
            "parent_depth": self._parent_depth,
            "n_internal": self._n_internal,
            "n_free": self._n_free,
            "invradius3": self.invradius,
            "offset": self.offset,
            "depth_limit": self.depth_limit,
            "geom_resize_fact": self.geom_resize_fact,
            "data": self._data,
        }
        if self.data_format is not None:
            data["data_format"] = repr(self.data_format)
        if self.extra_data is not None:
            data["extra_data"] = self.extra_data
        data["features"] = self.features.detach().cpu().numpy()
        (np.savez_compressed if compress else np.savez)(path, **data)

    @classmethod
    def load(cls, path, device="cuda"):
        """Load from .npz: int32-index files (with or without a
        `features` key) and legacy files with float leaf features in
        `data`, which become a feature pool plus an identity index
        table."""
        with np.load(path) as z:
            tree = cls(
                extra_data=z["extra_data"] if "extra_data" in z.files else None,
                device=device,
            )
            tree.data_dim = int(z["data_dim"])
            tree._child = np.asarray(z["child"], np.int32)
            tree.N = int(tree._child.shape[-1])
            tree._parent_depth = np.asarray(z["parent_depth"], np.int32)
            tree._n_internal = int(z["n_internal"])
            tree.filled = tree._n_internal
            if "invradius3" in z.files:
                tree.invradius = np.asarray(z["invradius3"], np.float32)
            else:
                tree.invradius = np.full((3,), float(z["invradius"]), np.float32)
            tree.offset = np.asarray(z["offset"], np.float32)
            tree.depth_limit = int(z["depth_limit"])
            tree.geom_resize_fact = float(z["geom_resize_fact"])
            raw = np.asarray(z["data"])
            cap = tree._child.shape[0]
            N = tree.N
            if np.issubdtype(raw.dtype, np.floating):
                feats = raw.reshape(-1, tree.data_dim).astype(np.float32)
                tree.features = torch.as_tensor(feats, device=tree.device)
                tree._data = np.arange(cap * N ** 3, dtype=np.int32).reshape(cap, N, N, N, 1)
            else:
                tree._data = raw.astype(np.int32).reshape(cap, N, N, N, 1)
                if "features" in z.files:
                    tree.features = torch.as_tensor(
                        np.asarray(z["features"], np.float32), device=tree.device
                    )
                else:
                    tree.features = torch.zeros((1, tree.data_dim), dtype=tree.dtype,
                                                device=tree.device)
            tree._n_free = int(z["n_free"]) if "n_free" in z.files else 0
            tree.data_format = (
                DataFormat(str(z["data_format"])) if "data_format" in z.files else None
            )
        tree._invalidate()
        return tree

    def __repr__(self):
        return (
            f"svox_t_tpu_torch.N3Tree(N={self.N}, data_dim={self.data_dim}, "
            f"depth_limit={self.depth_limit}, "
            f"capacity:{self.n_internal - self._n_free}/{self.capacity}, "
            f"data_format:{self.data_format or 'RGBA'}, device={self.device})"
        )


class WeightAccumulator:
    """Context manager for per-leaf render weight accumulation. While it
    is active the tree's structure is locked (`refine` and
    `shrink_to_fit` raise), and every `VolumeRenderer.forward` and
    `render_persp` adds each compositing sample's weight to its leaf
    cell."""

    def __init__(self, tree: N3Tree):
        self.tree = tree
        self.weight_accum = None

    def __enter__(self):
        self.tree._lock_tree_structure = True
        self.tree._weight_accum = torch.zeros(
            self.tree._child.shape, dtype=torch.float32, device=self.tree.device
        )
        return self

    def __exit__(self, type, value, traceback):
        self.weight_accum = self.tree._weight_accum
        self.tree._weight_accum = None
        self.tree._lock_tree_structure = False

    @property
    def value(self) -> torch.Tensor:
        """(capacity, N, N, N) summed weights per cell."""
        wa = self.tree._weight_accum
        return wa if wa is not None else self.weight_accum

    def __call__(self) -> torch.Tensor:
        """(n_leaves,) summed weights, one per leaf in `_all_leaves()`
        order (the order of the JAX package's ``t[:].aux``)."""
        leaves = torch.as_tensor(self.tree._all_leaves(), dtype=torch.long,
                                 device=self.value.device)
        return self.value[leaves[:, 0], leaves[:, 1], leaves[:, 2], leaves[:, 3]]
