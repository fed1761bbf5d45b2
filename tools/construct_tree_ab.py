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

Then the fused re-point (``box``: `construct_tree_aabb`, the table and the
points' leaf box from one descent, `svox_construct_tree_aabb`) against the
two calls it replaces (``two``: `construct_tree` and then
`points_leaf_aabb`, this tree's wrappers and kernels; ``parent``: the same
wrappers on the parent's two C entries), at both orders, without a union
and with one (a fixed box inside the cube, as the bake's box would be): each
call's CUDA-event time back to back and the device time of its K8a and K8b
kernels from `torch.profiler` (L2 cold and warm), in turns (ROUNDS rounds,
reversed every other round, the medians), the kernels a call launches (the
wrappers' fills and copies included), and its host time; every result equal
to `construct_tree_aabb_plain` (`torch.equal`, table and box). Beside them
the box form's designs, each a text patch of the source: ``box_early`` (the
scratch read before the block's reduction) and the censuses
``box_noatomic`` (no read, no atomic) and ``box_nodiv`` (one division a
point), which are timed and not checked; and ``box_census``, which counts
the box scratch's float atomics of one call.

Needs one CUDA GPU and nvcc; builds no other kernel (and the query unit,
for `points_leaf_aabb`).
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
# `box_census` (in the box section only): the shipped source with a count
# of the box scratch's float atomics, read back by an entry of its own.
BOX_CENSUS = (
    ("      if (v < now) svox::atomic_min_float(box + a, v);\n",
     "      if (v < now) {\n        svox::atomic_min_float(box + a, v);\n        atomicAdd(&g_box_atomics, 1u);\n"
     "      }\n"),
    ("      svox::atomic_max_float(box + a, v);\n",
     "      svox::atomic_max_float(box + a, v);\n      atomicAdd(&g_box_atomics, 1u);\n"),
    ("namespace {\n", "__device__ unsigned int g_box_atomics = 0;\n\nnamespace {\n"),
    ('extern "C" const char* svox_error_string(int err) {',
     'extern "C" unsigned int svox_box_atomics() {\n  unsigned int n = 0;\n'
     '  cudaMemcpyFromSymbol(&n, g_box_atomics, sizeof(n));\n  const unsigned int zero = 0;\n'
     '  cudaMemcpyToSymbol(g_box_atomics, &zero, sizeof(zero));\n  return n;\n}\n\n'
     'extern "C" const char* svox_error_string(int err) {'),
)
FOLD_READ = "    const float now = __ldcg(box + a);\n"
FOLD_ATOMICS = FOLD_READ + """    if (a < 3) {
      if (v < now) svox::atomic_min_float(box + a, v);
    } else if (v > now) {
      svox::atomic_max_float(box + a, v);
    }
"""
BOX_DIVS = """          lo[a] = fminf(lo[a], static_cast<float>(c[a]) / cube[k] - 1e-6f);
          up[a] = fmaxf(up[a], static_cast<float>(c[a] + 1) / cube[k] + 1e-6f);
"""
# Designs of the box form (the box section): ``box_early`` reads the box
# scratch before the block's reduction, not after it; the censuses
# ``box_noatomic`` (no read and no atomic: the box is not folded) and
# ``box_nodiv`` (one division a point, the box from its reciprocal: not
# exact) are timed and not checked.
BOX_DESIGNS = {
    "box_census": BOX_CENSUS,
    "box_early": (("  __shared__ float part[kThreads / 32][6];\n",
                   "  __shared__ float part[kThreads / 32][6];\n"
                   "  const float now = threadIdx.x < 6 ? __ldcg(box + threadIdx.x) : 0.f;\n"),
                  (FOLD_READ, "")),
    "box_noatomic": ((FOLD_ATOMICS, "    if (v == -12345.f) box[a] = v;\n"),),
    "box_nodiv": (("        const int32_t c[3] = {cx[k], cy[k], cz[k]};\n",
                   "        const int32_t c[3] = {cx[k], cy[k], cz[k]};\n        const float inv = 1.f / cube[k];\n"),
                  (BOX_DIVS, BOX_DIVS.replace(" / cube[k]", " * inv"))),
}
BOX_UNCHECKED = ("box_noatomic", "box_nodiv")
# {design: text patches of construct_tree.cu}.
DESIGNS = {
    "shipped": (),
    "p1": ((POINTS, "constexpr int kPoints = 1;\n"),),
    "p4": ((POINTS, "constexpr int kPoints = 4;\n"),),
    "memset": MEMSET,
    "scalar_merge": ((VEC, "    const bool vec = false;\n"),),
}
UNIT = ("construct_tree",)
# The libraries the fused re-point is timed in: with the query unit, whose
# svox_points_aabb is the second of the two calls it replaces.
BOX_UNITS = ("construct_tree", "query")
BOX_KERNELS = ("scatter", "merge", "points_aabb")
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
        out[name] = (d, BOX_UNITS if name in ("shipped", "parent") else UNIT)
    return out


def report(name: str, rows: list) -> None:
    """Registers and spills of a library's K8a kernels."""
    print(f"ptxas {name}: " + "; ".join(f"{e[:60]} {r} regs {s} B spilled" for _, e, r, s in rows
                                        if any(k in e for k in BOX_KERNELS)))


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


def kernels_a_call(fn) -> list:
    """The device kernels one call of ``fn`` launches (fills included)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name[:40] for e in sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                                         and not e.is_user_annotation), key=lambda e: e.time_range.start)]


def box_section(libs: dict, spec, pts: dict, dev, card: str, res: dict) -> None:
    """The fused re-point against the two calls it replaces (the module
    docstring), at each order, without and with a union."""
    entries = {}
    for name in ("shipped", "parent"):
        if name not in libs:
            continue
        lib = ctypes.CDLL(str(libs[name]))
        for sym, kernel in (("svox_construct_tree", query_ops.CONSTRUCT_TREE),
                            ("svox_points_aabb", query_ops.POINTS_AABB),
                            ("svox_construct_tree_aabb", query_ops.CONSTRUCT_TREE_AABB)):
            if name == "parent" and sym == "svox_construct_tree_aabb":
                continue
            fn = getattr(lib, sym)
            fn.argtypes = kernel.argtypes
            fn.restype = ctypes.c_int
            entries[name, sym] = fn
    box_union = (torch.full((3,), 0.25, device=dev), torch.full((3,), 0.75, device=dev))
    for order, p in pts.items():
        for union in (None, box_union):
            tag = f"{order}, {'no union' if union is None else 'a union'}"
            want = query_ops.construct_tree_aabb_plain(spec, p, union)

            def box():
                query_ops.CONSTRUCT_TREE_AABB._fn = entries["shipped", "svox_construct_tree_aabb"]
                return query_ops.construct_tree_aabb_cuda(spec, p, union)

            def two(lib):
                def run():
                    query_ops.CONSTRUCT_TREE._fn = entries[lib, "svox_construct_tree"]
                    query_ops.POINTS_AABB._fn = entries[lib, "svox_points_aabb"]
                    table = query_ops.construct_tree_cuda(spec, p)
                    return (table, *query_ops.points_leaf_aabb_cuda(spec, p, union=union))
                return run

            def box_design(name):
                lib = ctypes.CDLL(str(libs[name]))
                fused = lib.svox_construct_tree_aabb
                fused.argtypes = query_ops.CONSTRUCT_TREE_AABB.argtypes
                fused.restype = ctypes.c_int

                def run():
                    query_ops.CONSTRUCT_TREE_AABB._fn = fused
                    return query_ops.construct_tree_aabb_cuda(spec, p, union)
                return run

            runs = {"box": box}
            runs.update({n: box_design(n) for n in libs if n.startswith("box_") and n != "box_census"})
            runs["two"] = two("shipped")
            if ("parent", "svox_construct_tree") in entries:
                runs["parent"] = two("parent")

            def held(name, got):
                if name in BOX_UNCHECKED:
                    return
                cs.check(all(torch.equal(a, b) for a, b in zip(got, want)), f"{tag}: {name} differs from plain")

            for name, fn in runs.items():
                got = fn()
                torch.cuda.synchronize()
                held(name, got)
            times = {(n, k): [] for n in runs for k in ("event", "cold", "warm")}
            order_ = list(runs)
            for rnd in range(ROUNDS):
                for name in (order_ if rnd % 2 == 0 else order_[::-1]):
                    fn = runs[name]
                    times[name, "event"].append(cs.time_ms(fn, REPS))
                    times[name, "cold"].append(cs.device_ms(fn, REPS, BOX_KERNELS, cold=True))
                    times[name, "warm"].append(cs.device_ms(fn, REPS, BOX_KERNELS, cold=False))
                    got = fn()
                    torch.cuda.synchronize()
                    held(name, got)
            census = ctypes.CDLL(str(libs["box_census"]))
            fused = census.svox_construct_tree_aabb
            fused.argtypes = query_ops.CONSTRUCT_TREE_AABB.argtypes
            fused.restype = ctypes.c_int
            census.svox_box_atomics.restype = ctypes.c_uint
            census.svox_box_atomics()
            query_ops.CONSTRUCT_TREE_AABB._fn = fused
            got = query_ops.construct_tree_aabb_cuda(spec, p, union)
            torch.cuda.synchronize()
            n_atomics = census.svox_box_atomics()
            cs.check(all(torch.equal(a, b) for a, b in zip(got, want)), f"{tag}: box_census differs from plain")
            n_blocks = -(-p.shape[0] // 512)
            res[f"box {tag} atomics"] = n_atomics
            print(f"fused re-point, {tag}: box {want[1].tolist()} - {want[2].tolist()}, equal to plain in every round; "
                  f"{n_atomics} float atomics on the box scratch from {n_blocks} scatter blocks (6 coordinates "
                  f"each) [{card}]")
            for name, fn in runs.items():
                ev, cold, warm = (statistics.median(times[name, k]) for k in ("event", "cold", "warm"))
                ref = statistics.median(times[order_[-1], "event"])
                ks = kernels_a_call(fn)
                host = host_us(fn)
                res[f"box {tag} {name}"] = dict(event_ms=ev, device_cold_ms=cold, device_warm_ms=warm, host_us=host,
                                                kernels=len(ks))
                print(f"  {name:8s} CUDA events a call {ev:.4f} ms ({ref / ev:.3f}x {order_[-1]}); device (K8a, K8b "
                      f"kernels) L2 cold {cold:.4f}, warm {warm:.4f} ms; host {host:.1f} us; {len(ks)} kernels a call: "
                      f"{ks}; event rounds {[round(x, 4) for x in times[name, 'event']]}")


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
    designs.update(BOX_DESIGNS)
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
                runs = [n for n in (("parent",) if "parent" in fns else ()) + tuple(designs)
                        if not n.startswith("box_")]
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
        box_section(libs, spec, pts, dev, card, res)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
