"""Designs of the point query's forward (K8b, `query_fwd`, `query_fwd_bf16`)
side by side, and where its time goes, on one CUDA GPU.

    python3 tools/query_ab.py [--parent DIR] [--designs A,B,...]

`csrc/query_fwd.cuh` (compiled by `query.cu` for a float32 pool and by
`query_bf16.cu` for a bf16 one): each lane descends its point and writes its
ids, then the warp copies its 32 rows into its span of the output in units
of 16, 8, 4 (or 2) bytes. This script compiles each design with nvcc, every
design a text patch of the header as it is, in a copy of the sources (the two
query units alone):

  * ``shipped``: the header as it is, at the unit `ops/query.py`
    `query_unit` picks (16 bytes for a float32 SH9 row, 8 for a bf16 one);
    ``u8``, ``u4`` and ``u2``: the shipped kernel at a narrower unit (the
    instances a misaligned pool takes);
  * ``p2``: two points a lane, their descents interleaved level by level
    (`tools/query_designs.cuh`, launched in place of the shipped kernel);
  * ``bulk``: Hopper's bulk asynchronous copies (the same file): each row into shared memory by one `cp.async.bulk` on an `mbarrier`, the
    block's span stored by one bulk store (float32 rows; others take the
    warp copy);
  * ``no_copy``: a census, the descents and the ids alone (the values are
    not written, and not checked);
  * ``parent`` (with ``--parent DIR``, a checkout of an earlier commit, for
    example ``git archive`` of the parent unpacked in DIR): that commit's
    kernel (a thread a point, its row copied value by value).

It prints each library's registers and spills, then times the designs in
turns (ROUNDS rounds, the order reversed every other round, the medians) on
the depth-9 SH9 shell, float32 and bf16 pools, at the shapes the main paths
give the kernel:

  * ``frame``: `chip_smoke.py` phase 6's 1,404,480 points (the occupied leaf
    centres in a seeded permutation, every point in a row);
  * ``prior``: the training step's density prior, 65,536 occupied leaf
    centres chosen at random (`chip_smoke.py` `N_PRIOR_POINTS`);
  * ``edit``: the editing path's query, the centres of all 2,087,352 leaves
    plus a duplicated fifth, 2,504,822 points in a seeded permutation (some
    in empty leaves: zero rows).

Each time is the median over the rounds of the mean of REPS calls of the C
entry into preallocated outputs, L2 cold (a 128 MB write before each call,
CUDA events around the call alone) and warm (back to back). In every round
each design's values, node ids and row ids are held to the plain version
(`query_forward_plain`) bit for bit. Each shape's line gives the bound:
`chip_smoke.py` `query_fwd_work`'s bytes (phase 6's count) over the card's
memory rate, or its descent's operations where they take longer. Beside
them, the census of the shipped kernel: ``no_copy`` (the descent and the ids) and one
`index_select` of the pool at the kernel's own row ids (the copy alone,
through a library call; empty rows read row 0), neither the same function.

Needs one CUDA GPU and nvcc; builds no other kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
from svox_t_tpu_torch.ops import traversal  # noqa: E402
from svox_t_tpu_torch.utils.scenes import build_shell_tree  # noqa: E402

ROUNDS = 6
REPS = 10
HEADER = "query_fwd.cuh"
UNITS = ("query", "query_bf16")
COPY = "  copy_rows<T, U, kD>(a, idx, base, min(32, a.Q - base));\n"
LAUNCH = "template <class T, class U, int kD>\ncudaError_t launch_query_fwd("
LAUNCH_BODY = """  const int64_t blocks = (static_cast<int64_t>(a.Q) + kQueryThreads - 1) / kQueryThreads;
  query_fwd_kernel<T, U, kD><<<static_cast<unsigned>(blocks), kQueryThreads, 0, stream>>>(a);
  return cudaGetLastError();
"""


def spliced(design: str) -> tuple:
    """The patches that launch a design of `tools/query_designs.cuh` in
    place of the shipped kernel."""
    return ((LAUNCH, '#include "query_designs.cuh"\n\n' + LAUNCH),
            (LAUNCH_BODY, f"  return launch_{design}<T, U, kD>(a, stream);\n"))


# {design: text patches of query_fwd.cuh}; the unit designs share the
# shipped library.
DESIGNS = {
    "shipped": (),
    "p2": spliced("p2"),
    "bulk": spliced("bulk"),
    "no_copy": ((COPY, ""),),
}
UNIT_RUNS = {"u8": 8, "u4": 4, "u2": 2}
UNCHECKED = {"no_copy"}
SHAPES = ("frame", "prior", "edit")


def design_sources(workdir: Path, parent: Path | None, designs: dict) -> dict:
    """{library: its csrc copy}: each design's header patched, with
    `tools/query_designs.cuh` beside it; the parent's as it is."""
    src = (_build.CSRC / HEADER).read_text()
    out = {}
    for name, patches in designs.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{HEADER} changed: design {name}'s patch no longer applies")
            text = text.replace(old, new)
        d = workdir / name
        d.mkdir()
        for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
            shutil.copy(f, d / f.name)
        shutil.copy(Path(__file__).resolve().parent / "query_designs.cuh", d / "query_designs.cuh")
        (d / HEADER).write_text(text)
        out[name] = d
    if parent is not None:
        out["parent"] = parent / "svox_t_tpu_torch" / "csrc"
    return out


def compile_libraries(workdir: Path, sources: dict) -> dict:
    """{library: path} of the libraries that built (the two query units
    each, one nvcc a unit, all at once); a library whose compile fails is
    reported and left out."""
    nvcc = _build._nvcc()
    jobs = [(name, unit) for name, csrc in sources.items() for unit in _build.units(csrc)
            if unit.name in UNITS]

    def compile_unit(job):
        name, unit = job
        obj = workdir / f"{name}.{unit.name}.o"
        cmd = [nvcc, *_build._flags(unit), "-c", "-o", str(obj),
               *_build.source_args(unit, workdir / f"{name}.{unit.name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return obj, proc.returncode, proc.stdout + proc.stderr

    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        done = list(pool.map(compile_unit, jobs))
    print(f"nvcc: {len(jobs)} compiles in {time.perf_counter() - t0:.1f} s")
    libs = {}
    for name in sources:
        mine = [(unit, d) for (n, unit), d in zip(jobs, done) if n == name]
        failed = [f"{unit.name}:\n{log}" for unit, (_, rc, log) in mine if rc]
        if failed:
            print(f"nvcc {name} failed; left out:\n" + "\n".join(failed))
            continue
        lib = workdir / f"lib{name}.so"
        proc = subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(lib),
                               *[str(o) for _, (o, _, _) in mine]], capture_output=True, text=True)
        if proc.returncode:
            print(f"nvcc link {name} failed; left out:\n{proc.stdout}\n{proc.stderr}")
            continue
        libs[name] = lib
        rows = [(unit.name, *r) for unit, (_, _, log) in mine for r in fab.ptxas_rows(log)]
        fwd = [f"{instance_name(e)} {r} regs {s} B spilled" for u, e, r, s in rows if "query_fwd" in e]
        print(f"ptxas {name}: " + "; ".join(fwd))
    return libs


# A query forward instance's design and template arguments: the value type
# (f float, t 2-byte), the unit type and kD.
INSTANCE = re.compile(r"query_fwd_(bulk_|p2_)?kernelI(f|t)(t|j|5uint2|5uint4)Li(\d+)E")
UNIT_BYTES = {"t": 2, "j": 4, "5uint2": 8, "5uint4": 16}


def instance_name(entry: str) -> str:
    """``[<design> ]<pool> unit <bytes> D <kD or run time>``, or the pool
    type alone (the parent's kernels)."""
    m = INSTANCE.search(entry)
    if not m:
        return "f32" if "bf16" not in entry else "bf16"
    design, pool, unit, kd = m.groups()
    return (f"{design[:-1] + ' ' if design else ''}{'f32' if pool == 'f' else 'bf16'} unit {UNIT_BYTES[unit]} "
            f"D {kd if kd != '0' else 'any'}")


def load_entries(libs: dict, parent_has_unit: bool) -> dict:
    """{(library, pool kind): (C entry, takes a unit)}."""
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        has_unit = name != "parent" or parent_has_unit
        args = query_ops._QUERY_FWD_ARGS if has_unit else query_ops._QUERY_FWD_ARGS[:-3] + query_ops._QUERY_FWD_ARGS[-2:]
        for kind, sfx in (("f32", ""), ("bf16", "_bf16")):
            fn = getattr(lib, f"svox_query_fwd{sfx}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
            fns[name, kind] = (fn, has_unit)
    return fns


def shapes(dev) -> tuple:
    """(spec, {pool kind: pool}, {shape: points})."""
    state, feats_np, centers_np = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    tree = stt.tree_from_numpy(state, device=dev)
    feats = torch.from_numpy(feats_np).to(dev)
    centers = torch.from_numpy(centers_np).to(dev)
    M = centers.shape[0]
    rng = np.random.RandomState(0)
    every = tree.tree2world(tree.corners_local + 0.5 * tree.lengths_local[:, None]).contiguous()
    L = every.shape[0]
    dup = every[torch.from_numpy(rng.choice(L, L // 5, replace=False)).to(dev)]
    pts = {
        "frame": centers[torch.from_numpy(rng.permutation(M)).to(dev)].contiguous(),
        "prior": centers[torch.from_numpy(rng.choice(M, cs.N_PRIOR_POINTS, replace=False)).to(dev)].contiguous(),
        "edit": torch.cat([every, dup])[torch.from_numpy(rng.permutation(L + L // 5)).to(dev)].contiguous(),
    }
    return tree._spec(), {"f32": feats, "bf16": feats.to(torch.bfloat16)}, pts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose query forward is timed beside this one's")
    ap.add_argument("--designs", default=None, help="a comma-separated subset of the designs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("query_ab.py needs a CUDA GPU")
    chosen = args.designs.split(",") if args.designs else list(DESIGNS) + list(UNIT_RUNS)
    unknown = set(chosen) - set(DESIGNS) - set(UNIT_RUNS)
    if unknown:
        raise SystemExit(f"unknown designs {sorted(unknown)}; known: {sorted(DESIGNS) + sorted(UNIT_RUNS)}")
    designs = {k: v for k, v in DESIGNS.items() if k in chosen or k == "shipped"}
    parent_has_unit = args.parent is not None and "int32_t* data_idx, int unit, int device" in (
        args.parent / "svox_t_tpu_torch" / "csrc" / "query.cu").read_text()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_libraries(Path(tmp), design_sources(Path(tmp), args.parent, designs))
        if "shipped" not in libs:
            raise SystemExit("the shipped query forward did not build")
        fns = load_entries(libs, parent_has_unit)
        stream = torch.cuda.current_stream(dev).cuda_stream
        spec, pools, pts = shapes(dev)
        flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)

        for shape in SHAPES:
            p = pts[shape]
            Q = p.shape[0]
            for kind, pool in pools.items():
                M, D = pool.shape
                want = query_ops.query_forward_plain(spec, pool, p)
                rule = query_ops.query_unit(D, pool.dtype, (pool.data_ptr(),))
                runs = [(name, name, None) for name in (["parent"] if "parent" in libs else [])]
                runs += [(name, name, rule) for name in designs if name in libs and not (
                    name == "bulk" and kind != "f32")]
                runs += [(name, "shipped", u) for name, u in UNIT_RUNS.items()
                         if name in chosen and u < rule and u in query_ops.QUERY_UNITS[pool.dtype]]
                outs = {name: (torch.empty(Q, D, dtype=pool.dtype, device=dev),
                               torch.empty(Q, dtype=torch.int32, device=dev),
                               torch.empty(Q, dtype=torch.int32, device=dev)) for name, _, _ in runs}

                def launcher(name, lib, unit):
                    fn, has_unit = fns[lib, kind]
                    v, n, di = outs[name]
                    head = (p.data_ptr(), Q, 1, spec.child_flat.data_ptr(), spec.data_flat.data_ptr(), spec.N,
                            spec.n_levels, spec.offset.data_ptr(), spec.scaling.data_ptr(), pool.data_ptr(), M, D,
                            v.data_ptr(), n.data_ptr(), di.data_ptr())
                    tail = ((unit,) if has_unit else ()) + (dev.index, stream)

                    def launch():
                        err = fn(*head, *tail)
                        if err:
                            raise RuntimeError(f"{name} {shape} {kind}: CUDA error {err}")
                    return launch

                launches = {name: launcher(name, lib, unit) for name, lib, unit in runs}
                idx_l = torch.empty(Q, dtype=torch.int64, device=dev)
                sel = torch.empty(Q, D, dtype=pool.dtype, device=dev)

                def census_copy():
                    torch.index_select(pool, 0, idx_l, out=sel)

                def cold(fn):
                    total = 0.0
                    fn()
                    for _ in range(REPS):
                        flush.zero_()
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        fn()
                        end.record()
                        end.synchronize()
                        total += start.elapsed_time(end)
                    return total / REPS

                names = [name for name, _, _ in runs] + ["index_select"]
                times = {(n, c): [] for n in names for c in ("cold", "warm")}
                for rnd in range(ROUNDS):
                    for name in (names if rnd % 2 == 0 else names[::-1]):
                        fn = census_copy if name == "index_select" else launches[name]
                        times[name, "cold"].append(cold(fn))
                        times[name, "warm"].append(cs.time_ms(fn, REPS))
                        if name == "index_select":
                            continue
                        torch.cuda.synchronize()
                        v, n, di = outs[name]
                        cs.check(torch.equal(n, want[1]) and torch.equal(di, want[2]),
                                 f"{name} {shape} {kind}: ids differ from the plain version")
                        cs.check(name in UNCHECKED or torch.equal(v, want[0]),
                                 f"{name} {shape} {kind}: values differ from the plain version")
                        if name == "shipped" and rnd == 0:
                            valid = (di >= 0) & (di < M)
                            idx_l.copy_(torch.where(valid, di, 0).long())
                empty = int(((want[2] < 0) | (want[2] >= M)).sum())
                leaf = traversal.descend(spec, traversal.world2tree(p, spec.offset, spec.scaling))
                q_levels = int(torch.round(torch.log2(leaf.cube_sz) / float(np.log2(spec.N))).sum())
                n_bytes, n_ops = cs.query_fwd_work(Q, M, D, pool.element_size(), q_levels)
                bound_ms, bound_by = cs.bound(n_bytes, n_ops)
                res[f"bound_{shape}_{kind}_ms"] = bound_ms
                print(f"query forward {shape} ({Q} points, {empty} in empty space), {kind} pool (D {D}, rule unit "
                      f"{rule} B), {ROUNDS} rounds in turns, values and ids equal to plain; bound {bound_ms:.5f} ms "
                      f"(by {bound_by}: {n_bytes} bytes, {q_levels} levels) [{card}]")
                base = statistics.median(times[runs[0][0], "cold"])
                for name in names:
                    c, w = (statistics.median(times[name, k]) for k in ("cold", "warm"))
                    unit = dict((n, u) for n, _, u in runs).get(name)
                    res[f"{name}_{shape}_{kind}_cold_ms"] = c
                    res[f"{name}_{shape}_{kind}_warm_ms"] = w
                    print(f"  {name:12s} unit {unit or '-'}: L2 cold {c:.4f} ms ({base / c:.3f}x {runs[0][0]}), "
                          f"warm {w:.4f} ms; rounds cold {[round(x, 4) for x in times[name, 'cold']]}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
