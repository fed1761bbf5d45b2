"""Designs of the tape recorder's walks (K13a, K13b; `csrc/tape_record.cuh`)
side by side on one CUDA GPU.

    python3 tools/tape_record_ab.py [--parent DIR] [--designs A,B,...] [--shapes a,b,...]
                                    [--rounds N] [--no-census]

This script compiles each design with nvcc, every design a text patch of
`tape_record.cuh` in a copy of the sources (`tape_record.cu` and
`tape_record_baked.cu` alone), `tools/tape_record_designs.cuh` beside it:

  * ``shipped``: the header as it is: one walk of each ray (`stage_kernel`)
    that counts it and stages its samples in an arena of per-ray chunks of
    32 entries (layout (ii)), 8 entries of each stream held in registers
    and stored at once, the cumsum, one host copy, then the copy into the
    tape's runs
    (`copy_kernel`), `compact` and the streams template parameters;
  * ``scalar``: the shipped walk storing each sample's entries into its
    chunk as it walks (designs file);
  * ``flush4``, ``flush16``: the shipped walk storing 4 or 16 entries of
    a stream at a time;
  * ``runtime``: the shipped design with `compact` and the streams as
    run-time tests a sample (designs file);
  * ``loop1``: the shipped walk on a rotated loop, the next sample's lookup
    at the end of a step (designs file);
  * ``no_stores``: the shipped walk without its arena stores (a census of
    the stores' share; its tape is not held to plain, and its arena is
    zeroed so that the copy reads cells that exist);
  * ``chunk8``, ``chunk16``: chunks of 8 or 16 entries (the same arena's
    entries);
  * ``warp``: arena layout (i), chunks of 32 steps x 32 lanes a warp,
    lane-minor, a store a sample (designs file);
  * ``pair``: the earlier design in this tree's header: the count walk
    (`count_kernel`), the cumsum, the record walk (`record_kernel`), each
    run written at its offset;
  * ``stop``: the pair with the compact record walk ending at each ray's
    last occupied sample; ``resume``: also starting at its first one, from
    the (t, step) the count walk saved (designs file);
  * ``parent`` (with ``--parent DIR``, a checkout of an earlier commit, for
    example ``git archive`` of the parent unpacked in DIR): that commit's
    pair.

It prints each library's registers and spills (ptxas), then for each shape
the census (`ops/tape_census.py`: the steps each design walks, the empty
steps' split, the arena's chunks, padding and bytes under layouts (i) and
(ii)), unless ``--no-census``. Then it times the designs in turns (ROUNDS
rounds, the order reversed every other round, the medians), each as its
`record_tape` launches it (allocations, the walks, the cumsum, the host
reads, the copy): ``kernels``, the device time of every kernel of a call
(`torch.profiler`, fills aside), L2 cold (a 128 MB write before each call);
and ``call``, CUDA events over REPS calls of the whole host sequence (the
pair reads the card three times a call, as the parent's `record_tape` did;
the fused designs once). In every round each design's tape (counts,
offsets, idx, dt, cell, tval, dscale) must equal the plain versions'
(`count_samples_plain`, `record_samples_plain`) bit for bit. A fused launch
whose arena is short reruns with the capacity it reported; the reruns are
counted.

The shapes are the callers' (`chip_smoke.py`): (a) the depth-9 SH9 shell's
deep camera (800x800, exact, compacted, with cells) on both structures;
(b) the same rays uncompacted with cells and t and no row stream, as the
dynamic tape records them; (c) the deep dynamic scene's indirect tape
against the union occupancy of three seeded poses on the tree walk (cells
and t; the skeleton drawn from its own seed); (d) bench.py's 4-view rig
(the depth-7 shell, compacted, 2,560,000 rays); (e) the deep camera in
fast mode on the bake. Needs one CUDA GPU and nvcc; builds no other
kernel.
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
from svox_t_tpu_torch.ops import tape as tape_ops  # noqa: E402
from svox_t_tpu_torch.ops.bake import BakedTree  # noqa: E402
from svox_t_tpu_torch.ops.tape_census import walk_census  # noqa: E402
from svox_t_tpu_torch.utils.scenes import (build_shell_tree, joint_pose_sequence,  # noqa: E402
                                           skin_to_nearest_joints)

ROUNDS = 6
REPS = 5
UNITS = ("tape_record", "tape_record_baked")
HEADER = "tape_record.cuh"
DESIGN_FILE = "tape_record_designs.cuh"
STAGE_AT = "// K13a+K13b: walk ray i once; its counts, delta_scale and staged samples."
COUNT_LAUNCH = "  count_kernel<S><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);"
RECORD_LAUNCH = "  record_kernel<S><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);"
STAGE_WALK = "  walk(p, i, r, [&](const svox::Leaf& leaf, float t, float dt) {\n    ++tot;\n    const bool is_occ"
STAGE_STORES = "    if (chunk >= a.capacity) return;\n    const int32_t q = chunk * kChunk + e0;"
CHUNK = "constexpr int kChunk = 32;"
FLUSH = "constexpr int kFlush = 8;"
INCLUDE = ((STAGE_AT, f'#include "{DESIGN_FILE}"\n\n' + STAGE_AT),)


def _launches(kernel: str, what: str) -> tuple:
    return ((f"  return launch_{kernel}<S>(a, flags, stream);\n}}",
             f"  return launch_{kernel}_{what}<S>(a, flags, stream);\n}}"),)


# {design: (kind, text patches of tape_record.cuh)}: kind "fused" (the stage
# and copy entries), "warp" (the same entries, layout (i)) or "pair" (the
# count and record entries).
DESIGNS = {
    "shipped": ("fused", ()),
    "scalar": ("fused", INCLUDE + _launches("stage", "scalar")),
    "flush4": ("fused", ((FLUSH, "constexpr int kFlush = 4;"),)),
    "flush16": ("fused", ((FLUSH, "constexpr int kFlush = 16;"),)),
    "runtime": ("fused", INCLUDE + _launches("stage", "runtime") + _launches("copy", "runtime")),
    "loop1": ("fused", INCLUDE + ((STAGE_WALK, STAGE_WALK.replace("  walk(", "  walk_rotated(")),)),
    "no_stores": ("fused", ((STAGE_STORES, STAGE_STORES.replace("chunk >= a.capacity", "true")),)),
    "chunk8": ("fused", ((CHUNK, "constexpr int kChunk = 8;"),)),
    "chunk16": ("fused", ((CHUNK, "constexpr int kChunk = 16;"),)),
    "warp": ("warp", INCLUDE + _launches("stage", "warp") + _launches("copy", "warp")),
    "pair": ("pair", ()),
    "stop": ("pair", INCLUDE + ((RECORD_LAUNCH, RECORD_LAUNCH.replace("record_kernel", "record_stop_kernel")),)),
    "resume": ("pair", INCLUDE + (
        (COUNT_LAUNCH, COUNT_LAUNCH.replace("count_kernel<S>", "count_resume_kernel<S>").replace(
            "(p);", "(p, resume_buffer(B));")),
        (RECORD_LAUNCH, RECORD_LAUNCH.replace("record_kernel<S>", "record_resume_kernel<S>").replace(
            "(p);", "(p, resume_buffer(B));")))),
}
CHUNKS = {"chunk8": 8, "chunk16": 16}
SHAPES = ("a", "b", "c", "d", "e")
# A recorder kernel's mangled name: its name, then its template flags
# (stage: compact, idx, cell, t; copy: idx, cell, t), printed as bits.
KERNEL = re.compile(r"\d+((?:stage|copy|count|record)\w*?_kernel)I\w*?(\w*)")


def design_sources(workdir: Path, parent: Path | None, designs: dict) -> dict:
    """{library: (its csrc copy, its units)}: each design's header patched,
    with `tools/tape_record_designs.cuh` beside it; the parent's as it is."""
    src = (_build.CSRC / HEADER).read_text()
    out = {}
    for name, (_, patches) in designs.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{HEADER} changed: design {name}'s patch no longer applies")
            text = text.replace(old, new)
        d = workdir / name
        d.mkdir()
        for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
            shutil.copy(f, d / f.name)
        shutil.copy(Path(__file__).resolve().parent / DESIGN_FILE, d / DESIGN_FILE)
        (d / HEADER).write_text(text)
        out[name] = (d, UNITS)
    if parent is not None:
        out["parent"] = (parent / "svox_t_tpu_torch" / "csrc", UNITS)
    return out


def report(name: str, rows: list) -> None:
    """Registers and spills of a library's recorder kernels (K15 aside)."""
    out = []
    for unit, e, r, s in rows:
        m = KERNEL.search(e)
        if m:
            bits = "".join(re.findall(r"Lb([01])E", m.group(2)))
            out.append(f"{unit} {m.group(1)}{f'<{bits}>' if bits else ''} {r} regs {s} B spilled")
    print(f"ptxas {name}: " + "; ".join(out))


def _bind(lib, symbol: str, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


class Entries:
    """A library's entry points on one structure (``sfx``)."""

    def __init__(self, path: Path, kind: str, sfx: str):
        lib = ctypes.CDLL(str(path))
        self.kind = kind
        if kind == "pair":
            self.count = _bind(lib, f"svox_tape_count{sfx}", tape_ops._COUNT_ARGS)
            self.record = _bind(lib, f"svox_tape_record{sfx}", tape_ops._RECORD_ARGS)
        else:
            self.stage = _bind(lib, f"svox_tape_stage{sfx}", tape_ops._STAGE_ARGS)
            self.copy = _bind(lib, f"svox_tape_copy{sfx}", tape_ops._COPY_ARGS)


def _call(fn, *args):
    err = fn(*args)
    if err:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def pair_tape(e: Entries, case: dict):
    """The parent's `record_tape`: count, cumsum, a host read of the total,
    the record walk (which read the total again), a host read of S."""
    spec, M, o, d, opt = case["spec"], case["M"], case["origins"], case["dirs"], case["opt"]
    dev, B = o.device, o.shape[0]
    args = tape_ops._walk_args(spec, o, d, opt, M, "pair")
    stream = tape_ops._stream(dev)
    n_occ = torch.empty(B, dtype=torch.int32, device=dev)
    n_tot = torch.empty_like(n_occ)
    _call(e.count, *args, n_occ.data_ptr(), n_tot.data_ptr(), *stream)
    counts = n_occ if case["compact"] else n_tot
    offsets = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts.long(), 0)
    total = int(offsets[-1])
    offsets = offsets.to(torch.int32)
    total = int(offsets[-1])
    ints = lambda want: torch.empty(total, dtype=torch.int32, device=dev) if want else None  # noqa: E731
    idx, cell = ints(case["idx"]), ints(case["cell"])
    dt = torch.empty(total, dtype=torch.float32, device=dev)
    tval = torch.empty(total, dtype=torch.float32, device=dev) if case["t"] else None
    dscale = torch.empty(B, dtype=torch.float32, device=dev)
    _call(e.record, *args, offsets.data_ptr(), int(case["compact"]), _ptr(idx), dt.data_ptr(), _ptr(cell),
          _ptr(tval), dscale.data_ptr(), *stream)
    S = int(counts.max())
    return counts.to(torch.int32), offsets, S, idx, dt, cell, tval, dscale, 0


def fused_tape(e: Entries, case: dict, chunk: int, warp: bool, zeroed: bool = False):
    """This tree's `record_tape` (`ops/tape.py` `record_streams`) with a
    design's stage and copy entries (``zeroed``: the arena zeroed first);
    returns the tape and the reruns."""
    spec, M, o, d, opt = case["spec"], case["M"], case["origins"], case["dirs"], case["opt"]
    dev, B = o.device, o.shape[0]
    args = tape_ops._walk_args(spec, o, d, opt, M, "fused")
    stream = tape_ops._stream(dev)
    per = chunk * 32 if warp else chunk
    # The same entries as the shipped arena.
    capacity = -(-tape_ops.arena_capacity(B, case["compact"]) * tape_ops.ARENA_CHUNK // per)
    alloc = torch.zeros if zeroed else torch.empty

    def stage(cap):
        def entries(want, dtype):
            return alloc(cap * per, dtype=dtype, device=dev) if want else None

        st = tape_ops.Staged(torch.empty(B, dtype=torch.int32, device=dev),
                             torch.empty(B, dtype=torch.int32, device=dev),
                             torch.empty(B, dtype=torch.float32, device=dev),
                             torch.zeros(1, dtype=torch.int32, device=dev), cap,
                             torch.empty(cap, 2, dtype=torch.int32, device=dev), entries(case["idx"], torch.int32),
                             entries(True, torch.float32), entries(case["cell"], torch.int32),
                             entries(case["t"], torch.float32))
        _call(e.stage, *args, int(case["compact"]), st.n_occ.data_ptr(), st.n_tot.data_ptr(),
              st.dscale.data_ptr(), st.n_chunks.data_ptr(), cap, st.owner.data_ptr(), _ptr(st.idx),
              st.dt.data_ptr(), _ptr(st.flat), _ptr(st.tval), *stream)
        return st

    st = stage(capacity)
    counts = st.n_occ if case["compact"] else st.n_tot
    offsets = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    torch.cumsum(counts, 0, dtype=torch.int32, out=offsets[1:])
    total, S, n_chunks = torch.stack((counts.sum(dtype=torch.int64), counts.max().long(),
                                      st.n_chunks[0].long())).tolist()
    reruns = 0
    if n_chunks > capacity:
        reruns = 1
        st = stage(n_chunks)
    if warp:
        # Layout (i) reads a warp's 32 offsets: pad to a multiple of 32 rays.
        pad = (-B) % 32
        padded = torch.cat([offsets, offsets[-1:].expand(pad)]) if pad else offsets
    else:
        padded = offsets
    ints = lambda src: None if src is None else torch.empty(total, dtype=torch.int32, device=dev)  # noqa: E731
    floats = lambda src: None if src is None else torch.empty(total, dtype=torch.float32, device=dev)  # noqa: E731
    idx, dt, cell, tval = ints(st.idx), floats(st.dt), ints(st.flat), floats(st.tval)
    if n_chunks:
        _call(e.copy, tape_ops._structure_arg(spec, opt), n_chunks, st.owner.data_ptr(), _ptr(st.idx),
              st.dt.data_ptr(), _ptr(st.flat), _ptr(st.tval), padded.data_ptr(), _ptr(idx), dt.data_ptr(),
              _ptr(cell), _ptr(tval), *stream)
    return counts.to(torch.int32), offsets, S, idx, dt, cell, tval, st.dscale, reruns


def _captured(run) -> dict:
    """The arguments of the first `record_tape` call that ``run()`` makes."""
    seen = {}
    real = tape_ops.record_tape

    def spy(spec, n_features, origins, dirs, vdirs, opt, **kw):
        seen.setdefault("call", (spec, n_features, origins, dirs, opt, kw))
        return real(spec, n_features, origins, dirs, vdirs, opt, **kw)

    tape_ops.record_tape = spy
    try:
        run()
    finally:
        tape_ops.record_tape = real
    spec, M, o, d, opt, kw = seen["call"]
    o, d = (torch.as_tensor(x, dtype=torch.float32, device=spec.device).contiguous() for x in (o, d))
    indirect = kw.get("indirect", False)
    return dict(spec=spec, M=int(M), origins=o, dirs=d, opt=opt, compact=kw.get("compact", True),
                idx=not indirect, cell=indirect or kw.get("record_cells", True), t=kw.get("record_t", False))


def shapes(dev, chosen) -> dict:
    """{shape label: case}: each case the spec, rays, options and the
    streams `record_tape` records there."""
    out = {}
    state, feats_np, centers_np = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    M = feats_np.shape[0]
    tree = stt.tree_from_numpy(state, device=dev)
    specs = {"tree": tree._spec(), "baked": tree._baked_spec()}
    r = stt.VolumeRenderer(tree)
    opts = {fast: r._get_options(fast) for fast in (False, True)}
    o, d = cs.camera_rays(dev)
    deep = dict(M=M, origins=o, dirs=d)
    for sname, spec in specs.items():
        if "a" in chosen:
            out[f"a {sname}"] = dict(deep, spec=spec, opt=opts[False], compact=True, idx=True, cell=True, t=False)
        if "b" in chosen:
            out[f"b {sname}"] = dict(deep, spec=spec, opt=opts[False], compact=False, idx=False, cell=True,
                                     t=True)
    if "e" in chosen:
        out["e baked"] = dict(deep, spec=specs["baked"], opt=opts[True], compact=True, idx=True, cell=True,
                              t=False)
    if "c" in chosen:
        rng = np.random.RandomState(0)
        joints, _, _, _ = cs.skeleton(rng, M, dev)
        sw, ji = skin_to_nearest_joints(centers_np, joints, cs.N_BONES)
        poses = torch.from_numpy(joint_pose_sequence(joints, cs.N_FRAMES, seed=4)).to(dev)
        src = torch.eye(4, device=dev).repeat(cs.N_JOINTS, 1, 1)
        rig = (poses, src, torch.from_numpy(centers_np).to(dev), torch.from_numpy(sw).to(dev),
               torch.from_numpy(ji).to(dev))
        dyn = stt.VolumeRenderer(stt.tree_from_numpy(state, device=dev), backend="tree")
        c2w = cs.orbit_camera()
        with torch.no_grad():
            out["c tree"] = _captured(lambda: dyn.record_dynamic_persp(c2w, *rig, cs.WIDTH, cs.HEIGHT, cs.FX,
                                                                       record_t=True))
    if "d" in chosen:
        mb = {}
        out["d baked"] = _captured(lambda: mb.update(cs.minibatch_scene(dev)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose pair is timed beside this one's designs")
    ap.add_argument("--designs", default=None, help="a comma-separated subset of the designs")
    ap.add_argument("--shapes", default=",".join(SHAPES), help="a comma-separated subset of a-e")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--no-census", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tape_record_ab.py needs a CUDA GPU")
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
        kinds = {name: designs[name][0] if name in designs else "pair" for name in libs}
        runs = (["parent"] if "parent" in libs else []) + list(designs)
        t0 = time.perf_counter()
        cases = shapes(dev, set(args.shapes.split(",")))
        print(f"scenes: {time.perf_counter() - t0:.1f} s")
        for label, case in cases.items():
            sfx = "_baked" if isinstance(case["spec"], BakedTree) else ""
            entries = {name: Entries(libs[name], kinds[name], sfx) for name in runs}
            with torch.no_grad():
                n_occ, n_tot = tape_ops.count_samples_plain(case["spec"], case["M"], case["origins"], case["dirs"],
                                                            case["opt"])
                counts = n_occ if case["compact"] else n_tot
                offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int32, device=dev)
                offsets[1:] = torch.cumsum(counts, 0)
                want = (counts, offsets, int(counts.max()), *tape_ops.record_samples_plain(
                    case["spec"], case["M"], case["origins"], case["dirs"], case["opt"], offsets, case["compact"],
                    case["idx"], case["cell"], case["t"]))
                if not args.no_census:
                    n_streams = 2 + case["cell"] + case["t"] - (not case["idx"])
                    c = walk_census(case["spec"], case["M"], case["origins"], case["dirs"], case["opt"],
                                    case["compact"], entry_bytes=4 * n_streams)
                    print(f"census {label}: {json.dumps(c)}")
                    res[f"census_{label}"] = c

            def tape_of(name):
                e = entries[name]
                if e.kind == "pair":
                    return pair_tape(e, case)
                return fused_tape(e, case, CHUNKS.get(name, tape_ops.ARENA_CHUNK), e.kind == "warp",
                                  name == "no_stores")

            names = ("idx", "dt", "cell", "tval", "dscale")
            reruns = {name: 0 for name in runs}
            times = {(n, k): [] for n in runs for k in ("kernels", "call")}
            for rnd in range(args.rounds):
                for name in (runs if rnd % 2 == 0 else runs[::-1]):
                    with torch.no_grad():
                        got = tape_of(name)
                        torch.cuda.synchronize()
                        reruns[name] += got[-1]
                        if name != "no_stores":
                            cs.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                                     and got[2] == want[2], f"{name} {label}: counts or offsets differ from plain")
                            for field, g, w in zip(names, got[3:8], want[3:]):
                                cs.check((g is None) == (w is None) and (g is None or torch.equal(g, w)),
                                         f"{name} {label}: {field} differs from plain")
                        times[name, "kernels"].append(cs.device_ms(lambda: tape_of(name), REPS, None, cold=True))
                        times[name, "call"].append(cs.time_ms(lambda: tape_of(name), REPS))
            B, n = case["origins"].shape[0], int(want[1][-1])
            print(f"K13a+K13b {label}: {B} rays, {n} samples ({'compact' if case['compact'] else 'full'}; idx "
                  f"{case['idx']}, cell {case['cell']}, t {case['t']}); {args.rounds} rounds in turns, every tape "
                  f"equal to plain but no_stores's [{card}]")
            base = statistics.median(times[runs[0], "kernels"])
            for name in runs:
                k_ms, c_ms = (statistics.median(times[name, w]) for w in ("kernels", "call"))
                res[f"{name} {label} kernels_ms"] = k_ms
                res[f"{name} {label} call_ms"] = c_ms
                res[f"{name} {label} reruns"] = reruns[name]
                print(f"  {name:10s} kernels L2 cold {k_ms:.4f} ms ({base / k_ms:.3f}x {runs[0]}), call {c_ms:.4f} "
                      f"ms, reruns {reruns[name]}; rounds {[round(x, 4) for x in times[name, 'kernels']]}")
            for name in [n for n in ("parent", "shipped") if n in runs]:
                with torch.no_grad():
                    tape_of(name)
                    events = cs.profiled_kernels(lambda: tape_of(name), lambda ev: len(ev) > 0, f"{name} breakdown")
                parts = {}
                for ev in events:
                    m = re.search(r"(stage|copy|count|record)\w*_kernel", ev.name)
                    key = m.group(0) if m else ev.name.split("<")[0].split("(")[0][-40:]
                    parts[key] = parts.get(key, 0.0) + ev.time_range.elapsed_us() / 1e3
                print(f"  {name} one call, L2 warm, by kernel: "
                      + "; ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
