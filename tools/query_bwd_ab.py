"""Designs of K8b's query backward (`csrc/query_bwd.cuh`, compiled by
`query.cu` for float32 value gradients and by `query_bf16.cu` for bf16
ones) side by side on one CUDA GPU.

    python3 tools/query_bwd_ab.py [--parent DIR] [--rounds N]

This script compiles each design with nvcc, every design a text patch of
the header in a copy of the sources (the two query units alone):

  * ``shipped``: the header as it is, at the unit `query_bwd_unit` picks:
    the warp walks its 32 points' rows, one contiguous span, in units of 4
    values (one vector load, one float4 atomicAdd, a bf16 unit widened
    first) into the zeroed gradient;
  * ``w2``, ``w1``: the shipped kernel at the units of 2 and 1 values (the
    instances that rows and pointers the wider units do not divide take);
  * ``t128``: the shipped kernel in 128-thread blocks;
  * ``dense``: the row-owner design: each point claims its row in a
    row-owner table, every row of the gradient is written once in order
    (its owner's value gradients, or zeros: no zero fill) and the other
    points' rows are added with vector atomics;
  * ``stcs``, ``zfast``: the dense design with the rows kernel's stores
    streaming (`__stcs`), or with a warp whose 32 rows have no owner
    storing zeros alone;
  * ``rows4``: the dense design with four groups of 32 rows a warp in the
    rows kernel, their owners loaded before any store;
  * ``lane``: a lane adds its own point's whole row into a zeroed
    gradient;
  * ``points``: the dense design's claims and adds, with the owners storing
    their own rows into a zeroed gradient in place of the pass over every
    row; ``flat``: the dense design with its rows kernel a grid-stride loop
    over the gradient's units, as a fill writes (the designs but ``w2``,
    ``w1`` and ``t128`` are in `tools/query_bwd_designs.cuh`, launched in
    place of the shipped kernel, and a patch applies to whichever of the
    two files holds its text);
  * ``zeros``, a census not held to plain: the dense design with every row
    written as zeros (the rows kernel's stores alone);
  * ``parent`` (with ``--parent DIR``, a checkout of an earlier commit, for
    example ``git archive`` of the parent unpacked in DIR): that commit's
    kernel (a thread a (point, column) element, a scalar atomicAdd) into
    a zeroed gradient;
  * ``index_add_``: one `index_add_` of the gradient rows into the zeroed
    (M, D) buffer (float32; bf16 rows widened), the library call of the
    same function.

It prints each library's registers and spills, then times the designs in
turns (ROUNDS rounds, the order reversed every other round, the medians) on
the depth-9 SH9 shell (D 28, M 1,404,480 rows), float32 and bf16 seeded
unit gradients, at the shapes the main paths give the kernel (as
`tools/query_ab.py` draws them):

  * ``frame``: `chip_smoke.py` phase 6's 1,404,480 points (the occupied
    leaf centres in a seeded permutation, every row once);
  * ``prior``: the training step's density prior, 65,536 occupied leaf
    centres chosen at random.

A call is what the wrapper launches: the gradient's zero fill where the
design adds into zeros, and the kernels (a dense design's row-owner table
kept all -1 between calls);
each time is the median over the rounds of the call's device time from
`torch.profiler` (REPS calls, every kernel and fill of the call counted),
L2 cold (a 128 MB write before each call, not counted) and warm. In every round each design's gradient is held to the
plain version (`query_backward_plain`) within the atomic-sum tolerance,
1e-5 * max(1, max|plain|). Each shape's line gives the bound
(`chip_smoke.kernel_bounds`: the ids and the gradient rows read, the
(M, D) float32 gradient written; one operation a value).

Needs one CUDA GPU and nvcc; builds no other kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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

ROUNDS = 6
REPS = 10
HEADER = "query_bwd.cuh"
UNITS = ("query", "query_bf16")
DESIGN_FILE = "query_bwd_designs.cuh"
ENTRY = "template <class T, int kW, int kD>\ncudaError_t launch_query_bwd_walk("
_SHIPPED = (_build.CSRC / HEADER).read_text()
# The shipped launcher's body: its launch.
LAUNCH_BODY = _SHIPPED[_SHIPPED.index("{\n", _SHIPPED.index(ENTRY)) + 2:_SHIPPED.index("\n}\n", _SHIPPED.index(ENTRY)) + 1]


def spliced(launch: str) -> tuple:
    """The patches that launch ``launch`` of `tools/query_bwd_designs.cuh`
    in place of the shipped kernel."""
    return ((ENTRY, f'#include "{DESIGN_FILE}"\n\n' + ENTRY),
            (LAUNCH_BODY, f"  return {launch}<T, kW, kD>(a, stream);\n"))


# {library: text patches of the header or of the designs file}.
DESIGNS = {
    "shipped": (),
    "t128": (("constexpr int kQueryBwdThreads = 256;", "constexpr int kQueryBwdThreads = 128;"),),
    "dense": spliced("launch_dense"),
    "stcs": spliced("launch_dense") + (("      }\n      out[u] = v;\n", "      }\n      __stcs(out + u, v);\n"),),
    "zfast": spliced("launch_dense") + (
        ("  V* out = reinterpret_cast<V*>(a.grad + static_cast<size_t>(base) * d);\n",
         "  V* out = reinterpret_cast<V*>(a.grad + static_cast<size_t>(base) * d);\n"
         "  if (__ballot_sync(0xffffffffu, own >= 0) == 0) {\n"
         "    for (int u = lane; u < n; u += 32) out[u] = V{};\n"
         "    return;\n"
         "  }\n"),),
    "rows4": spliced("launch_rows4"),
    "lane": spliced("launch_lane"),
    "points": spliced("launch_points"),
    "flat": spliced("launch_flat"),
    "zeros": spliced("launch_dense") + (("  const int32_t own = lane < nr ? owner[base + lane] : -1;\n",
                                         "  const int32_t own = -1;\n"),),
}
# Census runs, not held to plain: ``zeros`` writes every row as zeros (the
# rows kernel's stores alone).
UNCHECKED = {"zeros"}
# The libraries that add into a zeroed gradient (the parent's too); the
# others write every row.
ZEROED = {"shipped", "t128", "lane", "points", "parent"}
# {run: (library, values a unit or None for the rule's)}.
RUNS = {
    "shipped": ("shipped", None), "w2": ("shipped", 2), "w1": ("shipped", 1), "t128": ("t128", None),
    "dense": ("dense", None), "stcs": ("stcs", None), "zfast": ("zfast", None), "rows4": ("rows4", None),
    "lane": ("lane", None), "points": ("points", None), "flat": ("flat", None), "zeros": ("zeros", None),
}
SHAPES = ("frame", "prior")
# The parent's svox_query_bwd and svox_query_bwd_bf16: no unit.
PARENT_ARGTYPES = query_ops.QUERY_BWD.argtypes[:6] + query_ops.QUERY_BWD.argtypes[7:]


def call_ms(fn, reps: int, cold: bool) -> float:
    """Device ms a call of ``fn`` (every kernel and fill it launches), from
    one `torch.profiler` session of ``reps`` calls, each after a 128 MB
    write when ``cold`` (the write not counted): the session's device
    events fall into ``reps`` groups of equal size, the write first in each."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(cs.PROFILER_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                if cold:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation), key=lambda e: e.time_range.start)
        if ev and len(ev) % reps == 0:
            break
    per = len(ev) // reps
    cs.check(per >= 1 + cold and len(ev) == per * reps, f"query_bwd_ab: {len(ev)} device events for {reps} calls")
    kept = [e for k, e in enumerate(ev) if k % per >= (1 if cold else 0)]
    return sum(e.time_range.elapsed_us() for e in kept) / 1e3 / reps


def split_ms(fn, reps: int) -> dict:
    """{kernel name: device ms a call} of ``fn``, L2 cold, from one
    `torch.profiler` session (the fills under their own name)."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation), key=lambda e: e.time_range.start)
    per = len(ev) // reps
    out = {}
    for k, e in enumerate(ev):
        if k % per:
            m = re.search(r"(\w+_kernel|\w*Functor\w*)", e.name)
            name = m.group(1) if m else e.name[:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def design_sources(workdir: Path, parent: Path | None, designs: dict) -> dict:
    """{library: (its csrc copy, its units)}: each design's header and
    `tools/query_bwd_designs.cuh` patched (a patch applies to the one of
    the two that holds its text once), the designs file beside the header;
    the parent's as it is."""
    src = (_build.CSRC / HEADER).read_text()
    extra = (Path(__file__).resolve().parent / DESIGN_FILE).read_text()
    out = {}
    for name, patches in designs.items():
        texts = [src, extra]
        for old, new in patches:
            hits = [k for k, t in enumerate(texts) if t.count(old) == 1]
            if len(hits) != 1 or any(t.count(old) > 1 for t in texts):
                raise RuntimeError(f"{HEADER} or {DESIGN_FILE} changed: design {name}'s patch no longer applies")
            texts[hits[0]] = texts[hits[0]].replace(old, new)
        d = workdir / name
        d.mkdir()
        for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
            shutil.copy(f, d / f.name)
        (d / HEADER).write_text(texts[0])
        (d / DESIGN_FILE).write_text(texts[1])
        out[name] = (d, UNITS)
    if parent is not None:
        out["parent"] = (parent / "svox_t_tpu_torch" / "csrc", UNITS)
    return out


def report(name: str, rows: list) -> None:
    """Registers and spills of a library's query backward kernels."""
    def short(entry):
        m = re.search(r"(query_bwd\w*kernel)(I\w+?EEv)?", entry)
        return m.group(0)[:60] if m else entry[:48]
    print(f"ptxas {name}: " + "; ".join(f"{short(e)} {r} regs {s} B spilled" for _, e, r, s in rows
                                        if "query_bwd" in e))


def shapes(dev) -> tuple:
    """(spec, M, D, {shape: the points' row ids}), the ids from the plain
    forward (no kernel of the package is built)."""
    state, feats_np, centers_np = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    spec = stt.tree_from_numpy(state, device=dev)._spec()
    feats = torch.from_numpy(feats_np).to(dev)
    centers = torch.from_numpy(centers_np).to(dev)
    M, D = feats.shape
    rng = np.random.RandomState(0)
    pts = {"frame": centers[torch.from_numpy(rng.permutation(M)).to(dev)].contiguous(),
           "prior": centers[torch.from_numpy(rng.choice(M, cs.N_PRIOR_POINTS, replace=False)).to(dev)].contiguous()}
    return M, D, {k: query_ops.query_forward_plain(spec, feats, v)[2] for k, v in pts.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose query backward is timed beside this one's")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("query_bwd_ab.py needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = fab.compile_libraries(Path(tmp), design_sources(Path(tmp), args.parent, DESIGNS), report)
        print(f"builds: {time.perf_counter() - t0:.1f} s")
        fns = {}
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            for kind, sym in (("f32", "svox_query_bwd"), ("bf16", "svox_query_bwd_bf16")):
                fn = getattr(lib, sym)
                fn.argtypes = PARENT_ARGTYPES if name == "parent" else query_ops.QUERY_BWD.argtypes
                fn.restype = ctypes.c_int
                fns[name, kind] = fn
        M, D, ids = shapes(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        runs = (["parent"] if args.parent is not None else []) + list(RUNS)
        for shape in SHAPES:
            didx = ids[shape]
            Q = didx.shape[0]
            rng = np.random.RandomState(12)
            g32 = torch.from_numpy(rng.randn(Q, D).astype(np.float32)).to(dev)
            for kind, gv in (("f32", g32), ("bf16", g32.to(torch.bfloat16))):
                want = query_ops.query_backward_plain(didx, gv, M)
                grad = torch.empty(M, D, dtype=torch.float32, device=dev)
                rule = query_ops.query_bwd_unit(D, gv.dtype, (gv.data_ptr(), grad.data_ptr()))
                valid = (didx >= 0) & (didx < M)
                idx_l, rows = didx[valid].long(), gv[valid].float()

                def launcher(name):
                    lib, w = RUNS.get(name, ("parent", None))
                    fn = fns[lib, kind]
                    unit = rule if w is None else w * gv.element_size()
                    zeroed = lib in ZEROED
                    a = (didx.data_ptr(), gv.data_ptr(), Q, M, D, grad.data_ptr())
                    a = a + ((dev.index, stream) if name == "parent" else (unit, dev.index, stream))

                    def launch():
                        if zeroed:
                            grad.zero_()
                        err = fn(*a)
                        if err:
                            raise RuntimeError(f"{name} {shape} {kind}: CUDA error {err}")
                    return launch

                def library():
                    grad.zero_()
                    grad.index_add_(0, idx_l, rows)

                launches = {name: launcher(name) for name in runs}
                launches["index_add_"] = library
                names = runs + ["index_add_"]
                times = {(n, c): [] for n in names for c in ("cold", "warm")}
                errs = {}
                for rnd in range(args.rounds):
                    for name in (names if rnd % 2 == 0 else names[::-1]):
                        times[name, "cold"].append(call_ms(launches[name], REPS, cold=True))
                        times[name, "warm"].append(call_ms(launches[name], REPS, cold=False))
                        torch.cuda.synchronize()
                        if name in UNCHECKED:
                            continue
                        errs[name] = max(errs.get(name, 0.0), cs.atomic_err(grad, want, f"{name} {shape} {kind}"))
                b = cs.kernel_bounds(M, D, 1, Q, 0, dict(rows=0, nodes=0, steps=0, points=0, levels=0, ids=0))
                b = b["query_bwd" if kind == "f32" else "query_bwd_bf16"]
                res[f"bound_{shape}_{kind}_ms"] = b["bound_ms"]
                print(f"query_bwd {shape} {kind}: {Q} points into ({M}, {D}), unit {rule} bytes; {args.rounds} "
                      f"rounds in turns, every gradient within the atomic tolerance of plain (max err "
                      f"{max(errs.values()):.3g}); bound {b['bound_ms']:.5f} ms ({b['bound_by']}) [{card}]")
                for name in ("shipped", "dense", "zeros", "flat", "parent"):
                    if name in launches:
                        print(f"  {name} by kernel, L2 cold: " + ", ".join(
                            f"{k} {v:.4f}" for k, v in split_ms(launches[name], REPS).items()))
                base = statistics.median(times[names[0], "cold"])
                for name in names:
                    c, w = (statistics.median(times[name, k]) for k in ("cold", "warm"))
                    res[f"{name}_{shape}_{kind}_cold_ms"] = c
                    res[f"{name}_{shape}_{kind}_warm_ms"] = w
                    print(f"  {name:10s} L2 cold {c:.4f} ms ({base / c:.3f}x {names[0]}; {b['bound_ms'] / c:.3f} of "
                          f"the bound), warm {w:.4f} ms; rounds cold {[round(x, 4) for x in times[name, 'cold']]}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
