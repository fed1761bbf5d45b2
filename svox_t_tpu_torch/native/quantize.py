"""ctypes binding of the median-cut quantizer (`quantizer.cpp`), the
counterpart of `svox_t_tpu/native/quantize.py`.

The PlenOctrees color compression utility (svox_t's
`csrc/quantizer.cpp:130-157`): host C++, built with g++ at first use into
``build/svox_t_tpu_torch/`` beside the package (named by a hash of the
source, so an edited source rebuilds) and loaded with ctypes. A failed
build raises: the port does not fall back quietly. `quantize_median_cut_plain`
is the same algorithm in NumPy, for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .._build import BUILD_DIR

__all__ = ["quantize_median_cut", "quantize_median_cut_plain"]

_SRC = Path(__file__).resolve().parent / "quantizer.cpp"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIB = None


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libsvox_quantizer_{h.hexdigest()[:16]}.so"


def _lib() -> ctypes.CDLL:
    """The quantizer library, built first if this source has none."""
    global _LIB
    if _LIB is None:
        path = _library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # A process-unique name, then an atomic rename: processes that
            # build at once never load a half-written library.
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build the quantizer ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        fp = ctypes.POINTER(ctypes.c_float)
        lib.svoxt_quantize_median_cut.restype = ctypes.c_int32
        lib.svoxt_quantize_median_cut.argtypes = [fp, fp, ctypes.c_int64, ctypes.c_int64,
                                                  ctypes.c_int32, fp,
                                                  ctypes.POINTER(ctypes.c_int32)]
        _LIB = lib
    return _LIB


def _inputs(data, weights, order: int):
    data = np.ascontiguousarray(np.asarray(data, np.float32))
    if data.ndim != 2:
        raise ValueError(f"data must be (n, k), got {data.shape}")
    n = data.shape[0]
    if not (0 <= order < 31 and (1 << order) <= n):
        raise ValueError(f"order {order} needs 2^order <= n = {n}")
    w = None
    if weights is not None:
        w = np.ascontiguousarray(np.asarray(weights, np.float32))
        if w.shape != (n,):
            raise ValueError(f"weights must be ({n},), got {w.shape}")
    return data, w


def quantize_median_cut(data, weights=None, order: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Median-cut quantization of (n, k) rows into 2^order colors.

    :param data: (n, k) float array (a tensor is read on the host)
    :param weights: optional (n,) row weights
    :param order: the number of splits: 2^order colors
    :return: (colors (2^order, k) float32, color_id_map (n,) int32)
    """
    data, w = _inputs(data, weights, order)
    colors = np.zeros((1 << order, data.shape[1]), np.float32)
    id_map = np.zeros((data.shape[0],), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    _lib().svoxt_quantize_median_cut(
        data.ctypes.data_as(fp), None if w is None else w.ctypes.data_as(fp), data.shape[0],
        data.shape[1], order, colors.ctypes.data_as(fp),
        id_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return colors, id_map


def quantize_median_cut_plain(data, weights=None, order: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """`quantize_median_cut` in NumPy: the same splits (a stable sort
    where the C++ partitions), so the same id map on distinct values; the
    colors are the same weighted means, summed in another order."""
    data, w = _inputs(data, weights, order)
    n, k = data.shape
    colors = np.zeros((1 << order, k), np.float32)
    id_map = np.zeros((n,), np.int32)
    next_color = 0

    def rec(idx: np.ndarray, depth: int) -> None:
        nonlocal next_color
        if depth <= 0 or idx.size <= 1:
            wi = w[idx] if w is not None else np.ones(idx.size, np.float32)
            tw = wi.sum()
            if tw > 0:
                colors[next_color] = (wi[:, None] * data[idx]).sum(0) / tw
            id_map[idx] = next_color
            next_color += 1
            return
        rows = data[idx]
        dim = int(np.argmax(rows.max(0) - rows.min(0)))
        srt = idx[np.argsort(rows[:, dim], kind="stable")]
        if w is None:
            m = idx.size // 2
        else:
            # The first index whose inclusive prefix weight exceeds half the
            # total starts the right cluster (the C++ loop's break).
            pfx = np.cumsum(w[srt])
            m = min(int(np.searchsorted(pfx, 0.5 * pfx[-1], side="right")), idx.size - 1)
        rec(srt[:m], depth - 1)
        rec(srt[m:], depth - 1)

    rec(np.arange(n, dtype=np.int64), order)
    return colors, id_map
