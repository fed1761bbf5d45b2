"""N^3-branching sparse voxel octree with an indirected feature pool: the
counterpart of `svox_t_tpu/models/tree.py`.

The tree is three separate arrays, as in the JAX package: structure
(`child`, `parent_depth`), an int32 index table (`data`) and a dense
feature pool that the caller passes to every render. Structure edits
(`refine`, `_refine_at`, `merge`, `shrink_to_fit`) are host NumPy;
`construct_tree` re-points the index table on ``device`` and leaves it
there until a structure edit needs it on the host. `.npz` files are
interchangeable with the JAX package's `save`/`load`, including legacy
files whose `data` holds float leaf features. `forward` is the
differentiable point query (with ``want_leaf_node``, also the distinct
hit leaves), `set` writes pool rows at points, and `accumulate_weights`
collects per-leaf render weights while it locks the structure.
``tree[key]`` is an `N3TreeView` of leaves (`models/view.py`): their
values, geometry and in-place edits; ``tree.corners`` and the other
leaf properties are those of ``tree[:]``. `merge` reduces each selected
frontier node's children into one leaf on the pool's device and frees
the node; `shrink_to_fit` then compacts the freed nodes away. The
frontier reductions come as tensors (``grad=True``, differentiable with
respect to the pool) or as NumPy.

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
from .view import N3TreeView


def _resolve_device(device, map_location) -> torch.device:
    """``device``, or its alias ``map_location`` (the JAX package's and
    svox's name); the CUDA card when neither is given."""
    if device is not None and map_location is not None:
        if torch.device(device) != torch.device(map_location):
            raise ValueError(f"device={device!r} and map_location={map_location!r} disagree")
    chosen = device if device is not None else map_location
    return torch.device("cuda" if chosen is None else chosen)


def _first(x):
    """A reduction's value: the first item of a (values, indices) result."""
    return x[0] if isinstance(x, tuple) else x


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
        map_location=None,
        dtype=torch.float32,
        device=None,
    ):
        if N < 2 or depth_limit < 0:
            raise ValueError("N must be >= 2 and depth_limit >= 0")
        self.N: int = int(N)
        self.data_dim: int = int(data_dim)
        self.dtype = dtype
        self.device = _resolve_device(device, map_location)

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
        # _ver counts layout changes (views check it); _occ_ver also counts
        # re-pointings of the index table.
        self._ver = 0
        self._occ_ver = 0
        self.extra_data = extra_data
        self._weight_accum = None
        self._lock_tree_structure = False
        self._rng = np.random.RandomState(0)
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
        self._invalidate_spec()

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
        self._invalidate_spec()

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
        lo = hi = None
        baked = self._cached_baked
        if baked is not None:
            # Old cells keep their rows: the box grows by the points' leaves.
            new_data_flat, lo, hi = query_ops.construct_tree_aabb(
                spec, points, union=(baked.aabb_lo, baked.aabb_hi))
        else:
            new_data_flat = query_ops.construct_tree(spec, points)
        self._adopt_data_flat(spec, new_data_flat, lo, hi)

    def _adopt_data_flat(self, spec: TreeSpec, new_data_flat: torch.Tensor, lo=None, hi=None):
        """Adopt a re-pointed flat index table (from `construct_tree` or a
        frame loop) produced from ``spec``: it becomes the tree's table, on
        ``device``, and the cached spec points at it. A cached bake is
        refreshed from it with the occupied box (lo, hi), which must cover
        the bake's old box (without it, the whole cube), and its skip boxes
        regrow."""
        self._occ_ver += 1
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

        :return: values (Q, D); plus packed node ids, data ids and/or the
            distinct hit leaves (n_hit, 4) [node, x, y, z] in ascending
            packed-id order when requested. Empty leaves give zero values.
        """
        del cuda
        indices = torch.as_tensor(indices, dtype=torch.float32, device=self.device)
        if indices.ndim != 2:
            raise ValueError(f"indices must be (Q, 3), got {tuple(indices.shape)}")
        spec = self._spec()
        values, node_ids, data_ids = query_ops.query(spec, features, indices, world)
        if not (want_node_ids or want_data_ids or want_leaf_node):
            return values
        ret = [values]
        if want_node_ids:
            ret.append(node_ids)
        if want_data_ids:
            ret.append(data_ids)
        if want_leaf_node:
            # Compacted on the device; only the count comes to the host.
            leaf_node, count = query_ops.unique_leaf_nodes(
                node_ids, self.N, n_cells=spec.data_flat.numel())
            ret.append(leaf_node[: int(count)])
        return ret

    def set(self, indices, values, cuda=True):
        """Write ``values`` (Q, data_dim) into the feature rows that world
        points ``indices`` (Q, 3) address (`ops/query.py` `assign`);
        ``features`` becomes the new pool."""
        del cuda
        self.features = query_ops.assign(
            self._spec(), self.features,
            torch.as_tensor(indices, dtype=torch.float32, device=self.device),
            torch.as_tensor(values, dtype=self.dtype, device=self.device),
        )

    def construct_tree_device(self, spec: TreeSpec, indices) -> TreeSpec:
        """``spec`` re-pointed at the (Q, 3) points, as a new spec; the
        tree itself is left as it was."""
        return spec.with_(data_flat=query_ops.construct_tree(spec, indices))

    def snap(self, indices):
        """Lower corners (world space) of the distinct leaves that the
        points fall in, in ascending packed-id order."""
        return self[torch.as_tensor(indices, dtype=torch.float32)].corners

    def partial(self, data_sel=None, device=None):
        """Copy of the tree with the channels ``data_sel`` of the feature
        pool, on ``device`` (default: this tree's)."""
        if data_sel is None:
            sel = None
            new_data_dim = self.data_dim
        else:
            sel = np.atleast_1d(np.arange(self.data_dim)[data_sel])
            new_data_dim = sel.size
        t2 = N3Tree(N=self.N, data_dim=int(new_data_dim), depth_limit=self.depth_limit,
                    geom_resize_fact=self.geom_resize_fact,
                    device=self.device if device is None else device)
        self._ensure_host_data()
        t2.invradius = self.invradius.copy()
        t2.offset = self.offset.copy()
        t2._child = self._child.copy()
        t2._parent_depth = self._parent_depth.copy()
        t2._data = self._data.copy()
        t2._n_internal = self._n_internal
        t2._n_free = self._n_free
        t2.filled = self.filled
        t2.extra_data = None if self.extra_data is None else self.extra_data.copy()
        t2.data_format = self.data_format
        feats = self.features.detach()
        if sel is not None:
            feats = feats[:, torch.as_tensor(sel, device=feats.device)]
        t2.features = feats.to(t2.device, copy=True)
        t2._invalidate()
        return t2

    def clone(self, device=None):
        return self.partial(device=device)

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
    # Frontier ops

    def _pool(self, features=None) -> torch.Tensor:
        """``features`` (default: the tree's pool) as a tensor on ``device``."""
        return torch.as_tensor(self.features if features is None else features, device=self.device)

    def _child_rows(self, nid: np.ndarray) -> np.ndarray:
        """(len(nid), N^3) index-table entries of each node's cells."""
        self._ensure_host_data()
        return self._data[nid, ..., 0].reshape(len(nid), -1)

    def _leaf_feature_values(self, features, nid: np.ndarray) -> np.ndarray:
        """(len(nid), N^3, data_dim) feature values of each node's cells
        (empty cells: zeros), as NumPy."""
        return self._leaf_feature_values_torch(self._pool(features), nid).detach().cpu().numpy()

    def _leaf_feature_values_torch(self, features: torch.Tensor, nid: np.ndarray) -> torch.Tensor:
        """The same as a tensor on the pool's device, differentiable with
        respect to ``features``."""
        idx = torch.as_tensor(self._child_rows(nid).astype(np.int64), device=features.device)
        valid = (idx >= 0) & (idx < features.shape[0])
        if not features.shape[0]:
            return features.new_zeros(idx.shape + (features.shape[1],))
        return torch.where(valid[..., None], features[torch.where(valid, idx, 0)], 0.0)

    def merge(self, frontier_sel=None, op=torch.mean, features=None):
        """Merge the children of selected frontier nodes (nodes whose cells
        are all leaves) into their parent cell, which becomes a leaf
        pointing at the node's first non-empty cell's row. With ``op``
        (default the mean) that row becomes op over the node's occupied
        cells' rows (empty cells take no part), on the pool's device, and
        ``features`` (default the tree's pool) is stored back as the tree's
        pool; ``op=None`` keeps the row as it is. ``op`` is a torch
        reduction called as ``op(rows, axis=0)`` (a tuple result gives its
        first item); the mean (``torch.mean`` or ``np.mean``) runs for all
        nodes at once. The nodes are freed; `shrink_to_fit` compacts them
        away. Returns False when nothing is selected."""
        self._check_unlocked()
        self._ensure_host_data()
        if self.n_internal - self._n_free <= 1:
            raise RuntimeError("Cannot merge root node")
        nid = self._frontier if frontier_sel is None else self._frontier[frontier_sel]
        nid = np.atleast_1d(np.asarray(nid))
        if nid.size == 0:
            return False
        feats = self._pool(features)
        M = feats.shape[0]
        child_idx = self._child_rows(nid)
        valid = child_idx < M
        occupied = valid.any(axis=1)
        first = np.where(occupied, np.argmax(valid, axis=1), 0)
        parent_row = np.where(occupied, child_idx[np.arange(len(nid)), first], DATA_SENTINEL)
        if op is not None:
            with torch.no_grad():
                # empty cells read as zeros: the sum leaves them out
                vals = self._leaf_feature_values_torch(feats, nid)
                ok = np.flatnonzero(occupied)
                mask = torch.as_tensor(valid, device=vals.device)
                if op is torch.mean or op is np.mean:
                    okt = torch.as_tensor(ok, device=vals.device)
                    reduced = vals[okt].sum(dim=1) / mask[okt].sum(dim=1, keepdim=True)
                else:
                    reduced = torch.stack([_first(op(vals[i][mask[i]], axis=0)) for i in ok]) \
                        if ok.size else vals.new_zeros((0, vals.shape[2]))
                rows = torch.as_tensor(parent_row[ok].astype(np.int64), device=vals.device)
                self.features = query_ops.write_rows(feats, rows, reduced)
        parent_sel = tuple(self._unpack_index_np(self._parent_depth[nid, 0]).T)
        self._data[parent_sel + (0,)] = parent_row
        self._child[parent_sel] = 0
        self._parent_depth[nid] = -1
        self._n_free += nid.shape[0]
        self._invalidate()
        return True

    def reduce_frontier(self, op=None, dim=None, grad=False, features=None):
        """Reduce each frontier node's cell values (empty cells: zeros) with
        ``op(vals, axis=1)``, vals (n_frontier, N^3, data_dim) (or the
        channel ``dim``); default the mean. ``grad=True`` reduces a tensor
        on the pool's device, differentiable with respect to the pool
        (``op`` a torch function); ``grad=False`` reduces NumPy."""
        feats = self._pool(features)
        if grad:
            vals = self._leaf_feature_values_torch(feats, self._frontier)
            op = torch.mean if op is None else op
        else:
            vals = self._leaf_feature_values(feats, self._frontier)
            op = np.mean if op is None else op
        if dim is not None:
            vals = vals[..., dim]
        return op(vals, axis=1)

    def max_frontier(self, dim=None, grad=False, features=None):
        return self.reduce_frontier(op=torch.amax if grad else np.max, dim=dim, grad=grad,
                                    features=features)

    def diam_frontier(self, dim=None, grad=False, scale=1.0, features=None):
        """The largest distance between two cell values of each frontier
        node (tensor with ``grad=True``, else NumPy)."""
        feats = self._pool(features)
        if grad:
            vals = self._leaf_feature_values_torch(feats, self._frontier)
        else:
            vals = self._leaf_feature_values(feats, self._frontier)
        if dim is not None:
            vals = vals[..., dim]
        if vals.ndim == 2:
            vals = vals[:, :, None]
        delta = (vals[:, :, None, :] - vals[:, None, :, :]) * scale
        if grad:
            return torch.amax(torch.linalg.norm(delta, dim=-1), dim=(1, 2))
        return np.max(np.linalg.norm(delta, axis=-1), axis=(1, 2))

    @property
    def _frontier(self) -> np.ndarray:
        """Nodes in use whose cells are all leaves."""
        if self._last_frontier is None:
            ni = self.n_internal
            sel = (self._child[:ni] == 0).reshape(ni, -1).all(axis=1)
            sel &= self._parent_depth[:ni, 0] != -1
            self._last_frontier = np.nonzero(sel)[0]
        return self._last_frontier

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

    def _refine_at(self, intnode_idx, xyzi):
        """Refine the one leaf cell (intnode_idx, *xyzi): its new node's
        cells take the cell's index entry, and the cell's own entry becomes
        0, as in the JAX package. A no-op at depth_limit or on an internal
        cell; returns True iff the buffers grew."""
        self._check_unlocked()
        self._ensure_host_data()
        if min(xyzi) < 0 or max(xyzi) >= self.N:
            raise ValueError(f"cell {tuple(xyzi)} outside 0..{self.N - 1}")
        if self._parent_depth[intnode_idx, 1] >= self.depth_limit:
            return
        xi, yi, zi = xyzi
        if self._child[intnode_idx, xi, yi, zi] != 0:
            return
        resized = False
        filled = self.n_internal
        if filled >= self.capacity:
            self._grow_buffers(1)
            resized = True
        self._child[filled] = 0
        self._child[intnode_idx, xi, yi, zi] = filled - intnode_idx
        self._parent_depth[filled, 0] = self._pack_index_np(
            np.array([[intnode_idx, xi, yi, zi]], dtype=np.int32))[0]
        self._parent_depth[filled, 1] = self._parent_depth[intnode_idx, 1] + 1
        self._data[filled, :, :, :] = self._data[intnode_idx, xi, yi, zi]
        self._data[intnode_idx, xi, yi, zi] = 0
        self._n_internal += 1
        self.filled += 1
        self._invalidate()
        return resized

    def shrink_to_fit(self):
        """Defragment and trim the node buffers to the live node count:
        the nodes that `merge` freed are compacted away, each kept node's
        child offsets and packed parent link re-expressed in the new ids.
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

    def _unpack_index_np(self, flat: np.ndarray) -> np.ndarray:
        """(Q,) packed ids -> (Q, 4) int64 [node, x, y, z]."""
        N = self.N
        flat = np.asarray(flat).astype(np.int64)
        z = flat % N
        flat = flat // N
        y = flat % N
        flat = flat // N
        x = flat % N
        return np.stack([flat // N, x, y, z], axis=-1)

    def _pack_index(self, txyz: torch.Tensor) -> torch.Tensor:
        return traversal.pack_index(torch.as_tensor(txyz), self.N)

    def _unpack_index(self, flat) -> np.ndarray:
        """(Q,) packed ids (a tensor or an array) -> (Q, 4) NumPy."""
        if isinstance(flat, torch.Tensor):
            flat = flat.cpu().numpy()
        return self._unpack_index_np(flat)

    def _calc_corners(self, nodes) -> torch.Tensor:
        """Tree-space lower corners of (Q, 4) [node, x, y, z] cells (the
        `calc_corners` kernel on ``device``)."""
        idx = torch.as_tensor(np.asarray(nodes, np.int32).reshape(-1, 4), device=self.device)
        return query_ops.calc_corners(self._spec(), idx)

    def _make_val_tensor(self, val) -> torch.Tensor:
        """A scalar or (..., 1)-channel value broadcast to (Q, data_dim)."""
        val = torch.as_tensor(val, dtype=self.dtype, device=self.device)
        while val.ndim < 2:
            val = val[None]
        if val.shape[-1] == 1:
            return val.expand(*val.shape[:-1], self.data_dim)
        if val.shape[-1] != self.data_dim:
            raise ValueError(f"value has {val.shape[-1]} channels, the tree {self.data_dim}")
        return val

    def _invalidate(self):
        """The layout changed: views, leaf lists, specs and the bake go."""
        self._ver += 1
        self._occ_ver += 1
        self._last_all_leaves = None
        self._last_frontier = None
        self._cached_spec = None
        self._cached_baked = None

    def _invalidate_spec(self):
        """The index table or extra data changed: leaf views stay valid,
        the specs and the bake go."""
        self._occ_ver += 1
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
    def max_depth(self):
        return int(self._parent_depth[self._all_leaves()[:, 0], 1].max())

    @property
    def ndim(self):
        return 2

    @property
    def shape(self):
        return (self.n_leaves, self.data_dim)

    def size(self, dim):
        return self.data_dim if dim == 1 else self.n_leaves

    def numel(self):
        return self.data_dim * self.n_leaves

    def __len__(self):
        return self.n_leaves

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
    def load(cls, path, map_location=None, device=None):
        """Load from .npz: int32-index files (with or without a
        `features` key) and legacy files with float leaf features in
        `data`, which become a feature pool plus an identity index
        table. ``map_location`` is an alias of ``device`` (default: the
        CUDA card)."""
        with np.load(path) as z:
            tree = cls(
                extra_data=z["extra_data"] if "extra_data" in z.files else None,
                device=_resolve_device(device, map_location),
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

    def __getitem__(self, key) -> N3TreeView:
        return N3TreeView(self, key)

    def __setitem__(self, key, val):
        N3TreeView(self, key).set(val)

    def __iadd__(self, val):
        self[:] += val
        return self

    def __isub__(self, val):
        self[:] -= val
        return self

    def __imul__(self, val):
        self[:] *= val
        return self

    def __itruediv__(self, val):
        self[:] /= val
        return self

    __idiv__ = __itruediv__

    # The leaves' view, as properties and methods of the tree.
    @property
    def depths(self):
        return self[:].depths

    @property
    def lengths(self):
        return self[:].lengths

    @property
    def lengths_local(self):
        return self[:].lengths_local

    @property
    def corners(self):
        return self[:].corners

    @property
    def corners_local(self):
        return self[:].corners_local

    @property
    def values(self):
        return self[:].values

    @property
    def values_local(self):
        return self[:].values_local

    def sample(self, n_samples, device=None):
        return self[:].sample(n_samples, device=device)

    def sample_local(self, n_samples):
        return self[:].sample_local(n_samples)

    def aux(self, arr):
        return self[:].aux(arr)

    def normal_(self, mean=0.0, std=1.0):
        return self[:].normal_(mean, std)

    def clamp_(self, min=None, max=None):
        return self[:].clamp_(min, max)

    def uniform_(self, min=0.0, max=1.0):
        return self[:].uniform_(min, max)

    def relu_(self):
        return self[:].relu_()

    def sigmoid_(self):
        return self[:].sigmoid_()

    def nan_to_num_(self, inf_val=2e4):
        return self[:].nan_to_num_(inf_val)


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
        order (``tree.aux`` of the weights)."""
        return self.tree.aux(self.value)
