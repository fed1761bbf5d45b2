"""Designs of the octree re-pointing kernel (K8a, construct_tree) side by
side, and where its call's time goes, on one CUDA GPU.

    python3 tools/construct_tree_ab.py [--parent DIR] [--designs A,B,...]

`csrc/construct_tree.cu` runs a scatter (each point's descent and an
atomicMax into a winner scratch) and a merge (the new index table from the
winners and the old table). Its levers are compile-time constants and one
line of the source; this script compiles each design with nvcc, every
design a text patch of the source, in a copy of the sources (that unit
alone):

  * ``shipped``: the source as it is (`kPoints` points a scatter thread,
    their levels interleaved; the merge in 16-byte vectors; the winner kept
    all -1 between calls, reset by the merge at the cells it took);
  * ``p1``, ``p4``: one or four points a scatter thread;
  * ``memset``: the winner cleared by a cudaMemsetAsync before each scatter
    (no reset in the merge);
  * ``scalar_merge``: the merge one cell a thread;
  * ``parent`` (with ``--parent DIR``, a checkout of an earlier commit, for
    example ``git archive`` of the parent unpacked in DIR): that commit's
    source.

On the depth-9 SH9 shell (1,404,480 occupied leaves), for both orders the
main paths give the kernel: the serving frames' leaf centres in a random
permutation (`chip_smoke.py` phase 4), and the dynamic frames' warped
canonical cloud in its own order (the leaf centres turned 3 degrees about
the cube's centre, in leaf order), it prints for each library:

  * the device time of each pass alone (the memset, the scatter, the merge;
    `torch.profiler`, L2 flushed before each call, and warm);
  * the CUDA-event time of one call of the C entry, back to back, in turns
    with the others (ROUNDS rounds, the order reversed every other round,
    the medians), every result equal to the plain version (`torch.equal`);
  * the host time of one call: the whole wrapper (this tree's
    `ops/query.py` for ``shipped``; the parent's wrapper, as it was, for
    ``parent``), its Python alone (the C call stubbed), and the ctypes call
    of the C entry alone (the launches' enqueue included), each the mean of
    HOST_CALLS calls with no synchronize inside.

Needs one CUDA GPU and nvcc; builds no other kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
import render_fwd_ab as fab  # noqa: E402
import svox_t_tpu_torch as stt  # noqa: E402
from svox_t_tpu_torch import _build  # noqa: E402
from svox_t_tpu_torch.ops import query as query_ops  # noqa: E402
from svox_t_tpu_torch.utils.scenes import build_shell_tree  # noqa: E402

ROUNDS = 10
REPS = 10
HOST_CALLS = 200
PROFILE_REPS = 10

POINTS = "constexpr int kPoints = 2;\n"
VEC = "    const bool vec = aligned16(data) && aligned16(winner) && aligned16(out);\n"
# `memset`: the earlier kernel's scratch, cleared by a cudaMemsetAsync before
# each scatter, so the merge resets nothing.
MEMSET = (
    ("""    if ((w.x & w.y & w.z & w.w) != -1) {
      reinterpret_cast<int4*>(winner)[j] = make_int4(-1, -1, -1, -1);
    }
""", ""),
    ("    if (w >= 0) winner[e] = -1;\n", ""),
    ("""  if (err != cudaSuccess) return err;
  if (Q > 0) {""", """  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(winner, 0xFF, sizeof(int32_t) * static_cast<size_t>(n_cells), stream);
  if (err != cudaSuccess) return err;
  if (Q > 0) {"""),
)
# {design: text patches of construct_tree.cu}.
DESIGNS = {
    "shipped": (),
    "p1": ((POINTS, "constexpr int kPoints = 1;\n"),),
    "p4": ((POINTS, "constexpr int kPoints = 4;\n"),),
    "memset": MEMSET,
    "scalar_merge": ((VEC, "    const bool vec = false;\n"),),
}
UNIT = ("construct_tree",)
PASSES = {"memset": ("Memset", "memset"), "scatter": ("scatter_kernel",), "merge": ("merge_kernel",)}


def design_sources(workdir: Path, parent: Path | None, designs: dict) -> dict:
    """{library: (its csrc copy, its units)}: each design's source patched."""
    src = (_build.CSRC / "construct_tree.cu").read_text()
    out = {}
    trees = {name: (_build.CSRC, patches) for name, patches in designs.items()}
    if parent is not None:
        trees["parent"] = (parent / "svox_t_tpu_torch" / "csrc", ())
    for name, (csrc, patches) in trees.items():
        text = src if name != "parent" else (csrc / "construct_tree.cu").read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"construct_tree.cu changed: design {name}'s patch no longer applies")
            text = text.replace(old, new)
        d = workdir / name
        d.mkdir()
        for f in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
            shutil.copy(f, d / f.name)
        (d / "construct_tree.cu").write_text(text)
        out[name] = (d, UNIT)
    return out


def report(name: str, rows: list) -> None:
    """Registers and spills of a library's K8a kernels."""
    print(f"ptxas {name}: " + "; ".join(f"{e[:60]} {r} regs {s} B spilled" for _, e, r, s in rows))


def parent_wrapper(spec, points, fn, dev):
    """The parent commit's `construct_tree_cuda`, as it was (its checks, two
    allocations and the C call), on ``fn``."""
    query_ops._check_points(spec, points)
    tables = (spec.child_flat, spec.data_flat, spec.offset, spec.scaling)
    if not points.is_cuda or any(t.device != points.device for t in tables):
        raise ValueError("construct_tree_cuda needs points and tree on one CUDA device")
    for t, dtype in zip(tables, (torch.int32, torch.int32, torch.float32, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError("child/data must be contiguous int32, offset/scaling float32")
    if points.shape[0] >= 2 ** 31 or spec.child_flat.numel() >= 2 ** 31:
        raise ValueError("construct_tree_cuda takes fewer than 2^31 points and cells")
    points = points.contiguous()
    n_cells = spec.data_flat.numel()
    winner = torch.empty(n_cells, dtype=torch.int32, device=points.device)
    out = torch.empty_like(spec.data_flat)
    err = fn(points.data_ptr(), points.shape[0], spec.child_flat.data_ptr(), spec.data_flat.data_ptr(), n_cells,
             spec.N, spec.n_levels, spec.offset.data_ptr(), spec.scaling.data_ptr(), winner.data_ptr(),
             out.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"parent svox_construct_tree: CUDA error {err}")
    return out


def orders(dev):
    """(spec, {order: points}) on the depth-9 shell."""
    state, _, centers_np = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    tree = stt.tree_from_numpy(state, device=dev)
    centers = torch.from_numpy(centers_np).to(dev)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(centers.shape[0])).to(dev)
    a = math.radians(3.0)
    rot = torch.tensor([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]],
                       device=dev)
    mid = centers.mean(0)
    warped = ((centers - mid) @ rot.T + mid).contiguous()
    return tree._spec(), {"serving (permuted leaf centres)": centers[perm].contiguous(),
                          "dynamic (warped cloud, leaf order)": warped}


def host_us(fn) -> float:
    """Host microseconds a call of ``fn``, HOST_CALLS calls with no
    synchronize inside (after a warm-up and a synchronize)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / HOST_CALLS * 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose K8a is timed beside this one's")
    ap.add_argument("--designs", default=None, help="a comma-separated subset of the designs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("construct_tree_ab.py needs a CUDA GPU")
    chosen = args.designs.split(",") if args.designs else list(DESIGNS)
    unknown = set(chosen) - set(DESIGNS)
    if unknown:
        raise SystemExit(f"unknown designs {sorted(unknown)}; known: {sorted(DESIGNS)}")
    designs = {k: v for k, v in DESIGNS.items() if k in chosen or k == "shipped"}
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = fab.compile_libraries(Path(tmp), design_sources(Path(tmp), args.parent, designs), report)
        print(f"builds: {time.perf_counter() - t0:.1f} s")
        fns = {}
        for name, path in libs.items():
            fn = getattr(ctypes.CDLL(str(path)), "svox_construct_tree")
            fn.argtypes = query_ops.CONSTRUCT_TREE.argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        # The package's wrapper launches this tree's kernel from the shipped
        # library built here (not the package's whole library).
        query_ops.CONSTRUCT_TREE._fn = fns["shipped"]
        spec, pts = orders(dev)
        n_cells = spec.data_flat.numel()
        stream = torch.cuda.current_stream(dev).cuda_stream
        # Every library's scratch starts all -1 (the kept-winner contract; a
        # memset design clears it itself).
        winners = {name: torch.full((n_cells,), -1, dtype=torch.int32, device=dev) for name in fns}
        outs = {name: torch.empty_like(spec.data_flat) for name in fns}

        def entry(name, p):
            """A call of library ``name``'s C entry on points ``p``."""
            a = (p.data_ptr(), p.shape[0], spec.child_flat.data_ptr(), spec.data_flat.data_ptr(), n_cells,
                 spec.N, spec.n_levels, spec.offset.data_ptr(), spec.scaling.data_ptr(),
                 winners[name].data_ptr(), outs[name].data_ptr(), dev.index, stream)

            def launch():
                err = fns[name](*a)
                if err:
                    raise RuntimeError(f"{name} svox_construct_tree: CUDA error {err}")
            return launch

        print(f"K8a on the depth-9 shell, {spec.data_flat.numel()} cells [{card}]")
        with torch.no_grad():
            for order, p in pts.items():
                want = query_ops.construct_tree_plain(spec, p)
                print(f"{order}: {p.shape[0]} points; {int((want != spec.data_flat).sum())} slots re-pointed")
                runs = [n for n in (("parent",) if "parent" in fns else ()) + tuple(designs)]
                for name in runs:
                    entry(name, p)()
                    torch.cuda.synchronize()
                    cs.check(torch.equal(outs[name], want), f"{order}: {name} differs from the plain version")
                    if name != "parent" and "memset" not in name:
                        cs.check(bool((winners[name] == -1).all()), f"{order}: {name} left its scratch dirty")
                for name in runs:
                    for cold in (True, False):
                        split = {}
                        for pass_, names in PASSES.items():
                            try:
                                split[pass_] = cs.device_ms(entry(name, p), PROFILE_REPS, names, cold=cold)
                            except AssertionError:
                                split[pass_] = 0.0  # a design without that pass
                        tag = "cold" if cold else "warm"
                        res[f"{order} {name} device {tag}"] = split
                        print(f"  {name:12s} device ms a pass, L2 {tag}: " + ", ".join(
                            f"{k} {v:.4f}" for k, v in split.items()) + f"; sum {sum(split.values()):.4f}")
                times = {name: [] for name in runs}
                launches = [(name, entry(name, p)) for name in runs]
                for i in range(ROUNDS):
                    for name, launch in (launches if i % 2 == 0 else launches[::-1]):
                        times[name].append(cs.time_ms(launch, REPS))
                base = statistics.median(times[runs[0]])
                for name in runs:
                    med = statistics.median(times[name])
                    res[f"{order} {name} event_ms"] = med
                    print(f"  {name:12s} CUDA events a call (C entry, back to back): median {med:.4f} ms "
                          f"({base / med:.3f}x {runs[0]}), rounds {[round(x, 4) for x in times[name]]}")
                # The whole call through the wrappers, and its host time.
                wrap = {"shipped": lambda: query_ops.construct_tree_cuda(spec, p)}
                if "parent" in fns:
                    wrap["parent"] = lambda: parent_wrapper(spec, p, fns["parent"], dev)
                for name, fn in wrap.items():
                    ev = statistics.median(cs.time_ms(fn, REPS) for _ in range(ROUNDS))
                    whole = host_us(fn)
                    c_only = host_us(entry(name, p))
                    kernel_cls = type(query_ops.CONSTRUCT_TREE)
                    saved = kernel_cls.__call__
                    kernel_cls.__call__ = lambda self, *a: None
                    try:
                        py = host_us(fn if name == "shipped" else
                                     (lambda: parent_wrapper(spec, p, lambda *a: 0, dev)))
                    finally:
                        kernel_cls.__call__ = saved
                    res[f"{order} {name} wrapper"] = dict(event_ms=ev, host_us=whole, python_us=py, c_call_us=c_only)
                    print(f"  {name:12s} through its wrapper: CUDA events {ev:.4f} ms a call; host {whole:.1f} us a "
                          f"call: Python {py:.1f} us, the C call (its launches' enqueue) {c_only:.1f} us")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
