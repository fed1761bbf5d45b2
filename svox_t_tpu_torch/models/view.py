"""Leaf-set view over an N3Tree, the counterpart of
`svox_t_tpu/models/view.py`.

A view resolves an indexing key (int, slice or bool mask over
`N3Tree._all_leaves()`, a (B, 3) point matrix of any dtype, an x, y, z
tuple, or `LocalIndex(points)` for tree-space points; a second key picks
channels) into leaf cells ``(node, x, y, z)`` and exposes their geometry
and the feature values they point at. Point keys run the point query with
``want_leaf_node=True``: the distinct hit leaves in ascending packed-id
order (`ops/query.py` `unique_leaf_nodes`).

`values` is a differentiable gather from ``tree.features`` (zeros for
empty leaves); `set` and the in-place helpers write the selected leaves'
pool rows on the pool's device and replace ``tree.features`` with the
new pool, as the JAX package replaces its array. Where several selected
leaves share a row, the last of them writes it. Geometry comes back as
tensors on the tree's device (`corners` through the `calc_corners`
kernel); the random helpers draw from the tree's own
``np.random.RandomState`` (``tree._rng``), so their draws equal the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.query import write_rows
from ..utils.dataformat import LocalIndex


class N3TreeView:
    def __init__(self, tree, key):
        self.tree = tree
        local = False
        self.single_key = False
        if isinstance(key, LocalIndex):
            key = key.val
            local = True
        if isinstance(key, tuple) and len(key) >= 3 and not any(
            isinstance(k, slice) for k in key[:3]
        ):
            main_key = torch.tensor([[float(k) for k in key[:3]]], dtype=torch.float32)
            key = (main_key, *key[3:]) if len(key) > 3 else main_key

        leaf_key = key[0] if isinstance(key, tuple) else key
        # Any 2-D (B, 3) key is a batch of query points, whatever its dtype.
        is_points = getattr(leaf_key, "ndim", 0) == 2 and leaf_key.shape[1] == 3
        if is_points:
            pts = torch.as_tensor(leaf_key).to(device=tree.device, dtype=torch.float32)
            _, node_ids, unique_leaf_node = tree.forward(
                tree.features, pts, want_node_ids=True, world=not local, want_leaf_node=True
            )
            self._packed_ids = node_ids.cpu().numpy()
            self.unique_leaf_node = unique_leaf_node.cpu().numpy()
            self.leaf_node_id = self._packed_ids
            leaf_node = self.unique_leaf_node
        else:
            self._packed_ids = None
            self.unique_leaf_node = None
            if isinstance(leaf_key, int):
                leaf_key = np.asarray([leaf_key])
                self.single_key = True
            elif isinstance(leaf_key, torch.Tensor):
                leaf_key = leaf_key.cpu().numpy()
            leaf_node = self.tree._all_leaves()[leaf_key]

        self._leaf_node = np.asarray(leaf_node)  # (n, 4)
        self._chan_key = key[1] if isinstance(key, tuple) and len(key) > 1 else None
        self._tree_ver = tree._ver

    # -- helpers --------------------------------------------------------

    def _check_ver(self):
        if self.tree._ver > self._tree_ver:
            raise RuntimeError(
                "N3TreeView has been invalidated because tree data layout has changed"
            )

    def _data_ids(self) -> np.ndarray:
        """Feature-pool row per selected leaf (>= M: empty)."""
        self._check_ver()
        self.tree._ensure_host_data()
        ln = self._leaf_node
        return self.tree._data[ln[:, 0], ln[:, 1], ln[:, 2], ln[:, 3], 0]

    def _rows(self, M: int):
        """(row per selected leaf, its validity) as tensors on the pool's
        device."""
        ids = torch.as_tensor(self._data_ids().astype(np.int64), device=self.tree.features.device)
        return ids, (ids >= 0) & (ids < M)

    def _indexer(self) -> np.ndarray:
        return self._leaf_node

    def __repr__(self):
        self._check_ver()
        return "N3TreeView(" + repr(self.values) + ")"

    # -- values ---------------------------------------------------------

    @property
    def values(self) -> torch.Tensor:
        """(n_leaves, data_dim) feature values (a differentiable gather)."""
        self._check_ver()
        feats = self.tree.features
        ids, valid = self._rows(feats.shape[0])
        if feats.shape[0]:
            vals = torch.where(valid[:, None], feats[torch.where(valid, ids, 0)], 0.0)
        else:
            vals = feats.new_zeros((ids.shape[0], feats.shape[1]))
        if self._chan_key is not None:
            vals = vals[:, self._chan_key]
        return vals[0] if self.single_key else vals

    @property
    def values_nograd(self) -> torch.Tensor:
        self._check_ver()
        return self.values.detach()

    @property
    def values_local(self) -> torch.Tensor:
        """Alias of `values`: feature rows have no world or tree frame."""
        return self.values

    @property
    def data_values(self) -> np.ndarray:
        """Raw int32 index-table entries of the selected leaves."""
        return self._data_ids()

    def set(self, value):
        """Write (n_leaves, data_dim) values (or, with a channel key, the
        selected channels; scalars and per-leaf vectors broadcast) into the
        selected leaves' feature rows; empty leaves are skipped."""
        self._check_ver()
        if isinstance(value, N3TreeView):
            value = value.values_nograd
        feats = self.tree.features
        M, D = feats.shape
        ids, valid = self._rows(M)
        n = ids.shape[0]
        v = torch.as_tensor(value, dtype=feats.dtype, device=feats.device)
        if self._chan_key is None:
            v = torch.broadcast_to(v, (n, D))
        else:
            cols = torch.as_tensor(np.atleast_1d(np.arange(D)[self._chan_key]), device=feats.device)
            if v.ndim == 1 and v.shape[0] == n and len(cols) == 1:
                v = v[:, None]
            block = feats.detach()[torch.where(valid, ids, 0)] if M else feats.new_zeros((n, D))
            block[:, cols] = torch.broadcast_to(v, (n, len(cols)))
            v = block
        self.tree.features = write_rows(feats, ids[valid], v[valid])

    def __setitem__(self, key, value):
        val = self.values_nograd.clone()
        val[key] = torch.as_tensor(value, dtype=val.dtype, device=val.device)
        self.set(val)

    # -- geometry -------------------------------------------------------

    @property
    def shape(self):
        self._check_ver()
        return (self._leaf_node.shape[0], self.tree.data_dim)

    @property
    def ndim(self):
        return 2

    def _depths_np(self) -> np.ndarray:
        self._check_ver()
        return self.tree._parent_depth[self._leaf_node[:, 0], 1]

    def _on_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.tree.device)

    @property
    def depths(self) -> torch.Tensor:
        """Leaf depths (root children = 0), (n_leaves,) int32."""
        return self._on_device(self._depths_np())

    def _lengths_local_np(self) -> np.ndarray:
        return float(self.tree.N) ** (-self._depths_np().astype(np.float32) - 1.0)

    @property
    def lengths(self) -> torch.Tensor:
        """World-space side lengths N^-(depth+1) / invradius, (n_leaves, 3)."""
        return self._on_device(self._lengths_local_np()[:, None] / self.tree.invradius)

    @property
    def lengths_local(self) -> torch.Tensor:
        """Tree-space side lengths N^-(depth+1), (n_leaves,)."""
        return self._on_device(self._lengths_local_np())

    @property
    def corners(self) -> torch.Tensor:
        """World-space lower corners, (n_leaves, 3)."""
        local = self.corners_local
        return (local - self._on_device(self.tree.offset)) / self._on_device(self.tree.invradius)

    @property
    def corners_local(self) -> torch.Tensor:
        """Tree-space lower corners, (n_leaves, 3)."""
        self._check_ver()
        return self.tree._calc_corners(self._indexer())

    def _uniform(self, n: int, n_samples: int) -> torch.Tensor:
        return self._on_device(self.tree._rng.rand(n, n_samples, 3).astype(np.float32))

    def sample(self, n_samples, device=None):
        """(n_leaves, n_samples, 3) uniform world-space samples per leaf,
        on ``device`` (default: the tree's)."""
        self._check_ver()
        corn, length = self.corners, self.lengths
        out = corn[:, None] + self._uniform(corn.shape[0], n_samples) * length[:, None]
        return out if device is None else out.to(device)

    def sample_local(self, n_samples):
        self._check_ver()
        corn, length = self.corners_local, self.lengths_local
        return corn[:, None] + self._uniform(corn.shape[0], n_samples) * length[:, None, None]

    def aux(self, arr):
        """Index an auxiliary (capacity, N, N, N[, ...]) array (a tensor, or
        an array as NumPy) by this view's leaf cells."""
        ln = self._leaf_node
        if isinstance(arr, torch.Tensor):
            ln = torch.as_tensor(ln, dtype=torch.long, device=arr.device)
        else:
            arr = np.asarray(arr)
        return arr[ln[:, 0], ln[:, 1], ln[:, 2], ln[:, 3]]

    # -- in-place feature modification helpers --------------------------

    def _map_rows(self, fn):
        """Replace the selected leaves' rows r by fn(rows), one row per
        selected non-empty leaf, in view order, on the pool's device."""
        feats = self.tree.features
        ids, valid = self._rows(feats.shape[0])
        rows = ids[valid]
        self.tree.features = write_rows(feats, rows, fn(feats.detach()[rows]))

    def _draw(self, draw, scale, shift):
        """Rows replaced by a NumPy draw of the tree's generator, scaled and
        shifted in float32 as the JAX package does, copied to the device."""
        def fn(v):
            x = draw(*v.shape).astype(np.float32) * scale + shift
            return torch.as_tensor(x, device=v.device)
        self._map_rows(fn)

    def normal_(self, mean=0.0, std=1.0):
        self._check_ver()
        self._draw(self.tree._rng.randn, std, mean)

    def uniform_(self, min=0.0, max=1.0):
        self._check_ver()
        self._draw(self.tree._rng.rand, max - min, min)

    def clamp_(self, min=None, max=None):
        self._check_ver()
        self._map_rows(lambda v: torch.clamp(v, min, max))

    def relu_(self):
        self._check_ver()
        self._map_rows(lambda v: torch.clamp(v, min=0.0))

    def sigmoid_(self):
        self._check_ver()
        self._map_rows(lambda v: 1.0 / (1.0 + torch.exp(-v)))

    def nan_to_num_(self, inf_val=2e4):
        self._check_ver()
        self._map_rows(lambda v: torch.nan_to_num(v, nan=0.0, posinf=inf_val, neginf=-inf_val))

    def refine(self, repeats=1):
        """Refine the selected leaves (`N3Tree.refine`)."""
        self._check_ver()
        return self.tree.refine(repeats, sel=tuple(self._leaf_node.T), leaf_node=self._leaf_node)

    def __len__(self):
        return self._leaf_node.shape[0]

    # -- tensor conveniences (non-mutating counterparts of the helpers) --

    def size(self, dim=None):
        self._check_ver()
        return self.shape if dim is None else self.shape[dim]

    def dim(self):
        return self.ndim

    def numel(self):
        sh = self.shape
        return int(sh[0]) * int(sh[1])

    def item(self):
        return self.values.item()

    def clamp(self, min=None, max=None):
        return torch.clamp(self.values, min, max)

    def clamp_min(self, min):
        return torch.clamp_min(self.values, min)

    def clamp_max(self, max):
        return torch.clamp_max(self.values, max)

    def relu(self):
        return torch.relu(self.values)

    def sigmoid(self):
        return torch.sigmoid(self.values)


def _redirect_funcs():
    """Arithmetic, comparisons and reductions act on `values`."""
    names = [
        "__add__", "__mul__", "__sub__", "__mod__", "__truediv__",
        "__radd__", "__rsub__", "__rmul__", "__abs__", "__pos__",
        "__neg__", "__eq__", "__ne__", "__ge__", "__gt__", "__le__",
        "__lt__", "clip", "max", "min", "mean", "sum", "__getitem__",
        "__floordiv__",
    ]

    def redirect(name):
        def impl(self, *args, **kwargs):
            return getattr(self.values, name)(*args, **kwargs)

        setattr(N3TreeView, name, impl)

    for name in names:
        redirect(name)


_redirect_funcs()
