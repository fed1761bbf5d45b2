"""Carry an octree across between the JAX package and this one.

Both packages keep the same three arrays: structure (`child`,
`parent_depth`), the int32 index table (`data`) and a separate (M, D)
feature pool. `tree_state` reads a tree of either package into a dict of
NumPy arrays; `tree_from_numpy` builds this package's `N3Tree` from such
a dict. The feature pool is not part of the state: it stays a separate
tensor that the caller passes to every render; an int8 pool of the JAX
package (its `QuantizedFeatures`) moves with `quantized_from_numpy`, a
recorded sample tape (its `RayTape`) with `tape_from_jax`.
"""

from __future__ import annotations

import numpy as np

import torch

from ..models.tree import N3Tree
from ..ops.render import QuantizedFeatures
from ..ops.tape import RayTape
from .dataformat import DataFormat


def tree_state(tree) -> dict:
    """The arrays of an N3Tree (of either package) as NumPy copies."""
    extra = tree.extra_data
    fmt = tree.data_format
    return {
        "child": np.array(tree.child, np.int32),
        "data": np.array(tree.data, np.int32),
        "parent_depth": np.array(tree.parent_depth, np.int32),
        "offset": np.array(tree.offset, np.float32),
        "invradius": np.array(tree.invradius, np.float32),
        "n_internal": int(tree.n_internal),
        "n_free": int(getattr(tree, "_n_free", 0)),
        "filled": int(tree.filled),
        "depth_limit": int(tree.depth_limit),
        "data_dim": int(tree.data_dim),
        "data_format": None if fmt is None else repr(fmt),
        "extra_data": None if extra is None else np.array(extra, np.float32),
    }


def _default_data_dim(fmt: DataFormat | None) -> int:
    if fmt is None or fmt.format == DataFormat.RGBA:
        return 4
    return 3 * fmt.basis_dim + 1


def tree_from_numpy(state: dict, device="cuda") -> N3Tree:
    """Build this package's N3Tree on ``device`` from NumPy arrays.

    :param state: ``child`` (n, N, N, N) or (n, N^3) int32, ``data``
        (n, N, N, N[, 1]) int32, ``parent_depth`` (n, 2) int32,
        ``offset`` and ``invradius`` (3,) float32, ``n_internal`` (and
        optionally ``filled`` and ``n_free``, the nodes freed by a merge
        and not yet compacted), ``depth_limit``, ``data_format`` (string
        or None), ``extra_data`` (or None) and optionally ``data_dim``
        (default: 4 for RGBA, 3 * basis_dim + 1 otherwise).
    """
    fmt_txt = state.get("data_format")
    fmt = DataFormat(fmt_txt) if fmt_txt is not None else None
    child = np.asarray(state["child"], np.int32)
    n = child.shape[0]
    N = int(round(np.prod(child.shape[1:]) ** (1.0 / 3.0)))
    if N ** 3 != int(np.prod(child.shape[1:])):
        raise ValueError(f"child table shape {child.shape} is not (n, N, N, N)")
    tree = N3Tree(
        N=N,
        data_dim=int(state.get("data_dim") or _default_data_dim(fmt)),
        depth_limit=int(state["depth_limit"]),
        data_format=fmt_txt,
        extra_data=state.get("extra_data"),
        device=device,
    )
    tree._child = child.reshape(n, N, N, N).copy()
    tree._data = np.asarray(state["data"], np.int32).reshape(n, N, N, N, 1).copy()
    tree._parent_depth = np.asarray(state["parent_depth"], np.int32).copy()
    tree._n_internal = int(state["n_internal"])
    tree._n_free = int(state.get("n_free", 0))
    tree.filled = int(state.get("filled", tree._n_internal))
    tree.offset = np.asarray(state["offset"], np.float32).copy()
    tree.invradius = np.asarray(state["invradius"], np.float32).copy()
    tree._invalidate()
    return tree


def quantized_from_numpy(q, scale, zero, device="cuda") -> QuantizedFeatures:
    """This package's int8 pool from the arrays of another's (the JAX
    package's `QuantizedFeatures` fields): q (M, D) int8, scale and zero
    (D,) float32, copied to ``device`` as they are."""
    return QuantizedFeatures(torch.as_tensor(np.array(q, np.int8), device=device),
                             torch.as_tensor(np.array(scale, np.float32), device=device),
                             torch.as_tensor(np.array(zero, np.float32), device=device))


def _output_slots(arrays, n_slots: int) -> np.ndarray:
    """The slot of the JAX tape's padded layout that its replay returns as
    output row i (JAX `unsort_output`): ``inv_pos[i]``, or on a grouped
    tape (``group`` > 1) the block gather ``ginv`` that JAX's unsort uses
    in its place, followed by the transpose of ``out_blocks`` from
    block-major back to raster order (per view on a rig tape)."""
    group = int(arrays.get("group") or 1)
    if group <= 1:
        return np.asarray(arrays["inv_pos"], np.int64)
    slots = np.arange(n_slots).reshape(-1, group)[np.asarray(arrays["ginv"], np.int64)].reshape(-1)
    if arrays.get("out_blocks"):
        nbh, nbw, bh, bw = arrays["out_blocks"]
        slots = slots.reshape(-1, nbh, nbw, bh, bw).swapaxes(2, 3).reshape(-1)
    return slots


def tape_from_jax(arrays, device="cuda") -> RayTape:
    """This package's `RayTape` from the arrays and meta of a JAX package
    `RayTape` (a mapping of its field names): the chunk layout ``idx``,
    ``dt`` and the optional ``cell`` and ``tval`` (n_chunks, S, C),
    ``counts`` and ``dscale`` (n_chunks, C), ``origins``, ``dirs`` and
    ``vdirs`` (n_chunks, C, 3), ``inv_pos`` (n_rays,), on a grouped tape
    ``group``, ``ginv`` and ``out_blocks``, and ``n_features``,
    ``n_cells``, ``compact``, ``geom``, ``indirect``. Ray i is the output
    row i of JAX's replay: its run is the first ``counts`` samples of the
    chunk column at the slot JAX's unsort reads for row i (`_output_slots`:
    ``inv_pos[i]``, or the group gather on a grouped tape, such as a rig
    tape in (view, pixel) order). The rays come out in that order, on
    ``device``, a data-indirect tape with its cells and ``tval``."""
    idx = np.asarray(arrays["idx"])
    n_chunks, S, C = idx.shape
    inv = _output_slots(arrays, n_chunks * C)
    chunk, lane = inv // C, inv % C
    counts = np.asarray(arrays["counts"], np.int64).reshape(-1)[inv]
    offsets = np.zeros(inv.shape[0] + 1, np.int64)
    offsets[1:] = np.cumsum(counts)
    ray = np.repeat(np.arange(inv.shape[0]), counts)
    slot = np.arange(offsets[-1]) - offsets[ray]

    def stream(name, dtype):
        a = arrays.get(name)
        if a is None or np.asarray(a).size == 0:
            return None
        a = np.asarray(a, dtype)[chunk[ray], slot, lane[ray]]
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def per_ray(name):
        a = np.asarray(arrays[name], np.float32)
        return torch.as_tensor(np.ascontiguousarray(a.reshape(n_chunks * C, *a.shape[2:])[inv]),
                               device=device)

    return RayTape(
        idx=stream("idx", np.int32), dt=stream("dt", np.float32), cell=stream("cell", np.int32),
        offsets=torch.as_tensor(offsets.astype(np.int32), device=device),
        counts=torch.as_tensor(counts.astype(np.int32), device=device),
        origins=per_ray("origins"), dirs=per_ray("dirs"), vdirs=per_ray("vdirs"),
        dscale=per_ray("dscale"), n_rays=int(inv.shape[0]),
        S=int(counts.max()) if counts.size else 0, compact=bool(arrays["compact"]),
        n_features=int(arrays["n_features"]), n_cells=int(arrays["n_cells"]),
        geom=tuple(arrays.get("geom", ())), tval=stream("tval", np.float32),
        indirect=bool(arrays.get("indirect", False)),
    )
