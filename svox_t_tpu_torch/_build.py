"""Build and bind the package's CUDA kernels.

The kernels (`csrc/*.cu`, sharing `csrc/common.cuh`) are compiled by
``nvcc``, one process per source file, all started together, and linked
into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at the first launch, never at import, so the
package imports on machines without CUDA. The library lands in
``build/svox_t_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one
loads the library already built.

The march headers (`render_fwd.cuh`, `render_bwd.cuh`, `render_aux.cuh`)
are instantiated once per compile: the float32 instances by the
`render_*.cu` sources, the bf16 and int8 pool instances (K5) from the
`POOL_INSTANCES` table, whose macros go to nvcc as ``-D`` flags. The tape
replay header (`tape_replay.cuh`, K13c-e) has no structure or interp axis:
its passes compile once per pool type (`FLAT_HEADERS`).

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions round them: the march's sample positions then
agree bit for bit with the plain version, and a descent can never pick a
neighbouring cell because of a contracted multiply-add.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "svox_t_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# The trilinear compiles (`*_interp*`, float32, bf16 and int8 pools) hold
# the most kernel instances and set the build's wall time; they also run
# their optimizer passes in parallel threads. The others compile as
# before. The log gives each compile's seconds.
SPLIT_FLAGS = ("-split-compile=0",)


# The pool types of each march header that the JAX package reaches (K5):
# an int8 pool takes no gradient, so the backward header has no int8
# instance. Each is built on both structures, nearest and trilinear.
POOL_INSTANCES = {"render_fwd": ("bf16", "i8"), "render_bwd": ("bf16",),
                  "render_aux": ("bf16", "i8"), "tape_replay_fwd": ("bf16", "i8"),
                  "tape_replay_bwd": ("bf16",)}
# The entries of POOL_INSTANCES with no structure or interp axis: each is
# a pass of a header (its -D flag), compiled once per pool type; the
# float32 pool's compile is the `.cu` source of the entry's name.
FLAT_HEADERS = {"tape_replay_fwd": ("tape_replay", "-DSVOX_TAPE_PASS=0"),
                "tape_replay_bwd": ("tape_replay", "-DSVOX_TAPE_PASS=1")}
_STRUCTURES = {"": "svox::TreeWalk", "_baked": "svox::Baked"}
_POOL_TYPES = {"bf16": "svox::PoolBF16", "i8": "svox::PoolI8"}


class Unit(NamedTuple):
    """One nvcc compile: its name (of the object and in the log), its
    source, and the macros (``-D`` flags) it is compiled with."""

    name: str
    source: Path
    defines: tuple


def units(csrc: Path = CSRC) -> list:
    """Every compile of the library: each `.cu` source of ``csrc``, then
    each pool instance of `POOL_INSTANCES`, named as the float32 source
    with the pool type's suffix (``render_fwd_baked_interp_bf16``,
    ``tape_replay_fwd_bf16``)."""
    out = [Unit(p.stem, p, ()) for p in sorted(csrc.glob("*.cu"))]
    for header, kinds in POOL_INSTANCES.items():
        if header in FLAT_HEADERS:
            source, pass_flag = FLAT_HEADERS[header]
            for kind in kinds:
                defines = (pass_flag, f"-DSVOX_SUFFIX=_{kind}", f"-DSVOX_POOL={_POOL_TYPES[kind]}")
                out.append(Unit(f"{header}_{kind}", csrc / f"{source}.cuh", defines))
            continue
        for ssfx, structure in _STRUCTURES.items():
            for isfx in ("", "_interp"):
                for kind in kinds:
                    sfx = f"{ssfx}{isfx}_{kind}"
                    defines = (f"-DSVOX_STRUCTURE={structure}", f"-DSVOX_SUFFIX={sfx}",
                               f"-DSVOX_POOL={_POOL_TYPES[kind]}")
                    if isfx:
                        defines += ("-DSVOX_INTERP=1",)
                    out.append(Unit(header + sfx, csrc / f"{header}.cuh", defines))
    return out


def source_args(unit: Unit, stub: Path) -> list:
    """nvcc's input arguments for ``unit``: a `.cu` source as it is; for a
    pool instance its ``-D`` flags, the header's directory and ``stub``, a
    one-line `.cu` written here that includes the header."""
    if not unit.defines:
        return [str(unit.source)]
    stub.write_text(f'#include "{unit.source.name}"\n')
    return [*unit.defines, f"-I{unit.source.parent}", str(stub)]


def _flags(unit: Unit):
    return NVCC_FLAGS + (SPLIT_FLAGS if "_interp" in unit.name else ())


def _label(unit: Unit) -> str:
    if not unit.defines:
        return unit.source.name
    return f"{unit.name} ({unit.source.name} {' '.join(unit.defines)})"


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + SPLIT_FLAGS).encode())
    h.update(repr([(u.name, u.defines) for u in units()]).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsvox_t_tpu_torch_{h.hexdigest()[:16]}.so"


class Build(NamedTuple):
    """Result of `build()`: the library path, the seconds the compile
    took (0.0 when the library was already built) and nvcc's log, one
    section per compile headed ``== <source> (<seconds> s)`` (a pool
    instance: ``== <name> (<header> <-D flags>) (<seconds> s)``)."""

    path: Path
    seconds: float
    log: str


def build() -> Build:
    """Compile the kernels unless a library for these sources exists:
    one nvcc per compile unit, run in parallel, then one link."""
    path = library_path()
    if path.exists():
        return Build(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{path.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs, stubs = [], []
    for unit in units():
        obj = BUILD_DIR / f"{stem}.{unit.name}.o"
        stubs.append(BUILD_DIR / f"{stem}.{unit.name}.cu")
        cmd = [nvcc, *_flags(unit), "-c", "-o", str(obj), *source_args(unit, stubs[-1])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((unit, obj, proc))
    def finish(proc):
        out, _ = proc.communicate()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        results = list(pool.map(finish, [proc for _, _, proc in jobs]))
    logs, failed = [], []
    for (unit, obj, proc), (out, secs) in zip(jobs, results):
        logs.append(f"== {_label(unit)} ({secs:.1f} s)\n{out}")
        if proc.returncode != 0:
            failed.append(f"{_label(unit)} ({proc.returncode}):\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        for f in objs + stubs:
            f.unlink(missing_ok=True)
    return Build(path, time.perf_counter() - t0, "".join(logs))


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        lib.svox_error_string.argtypes = [ctypes.c_int]
        lib.svox_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


class Kernel:
    """One C entry point of the library, with its launch count.

    ``launches`` rises by one each time the entry point returns success;
    it is a plain integer that callers may reset.
    """

    def __init__(self, symbol: str, argtypes):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_lib(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = _lib().svox_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1
