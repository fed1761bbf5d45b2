"""Designs of K10's backward, the LBS warp's VJP (`csrc/warp.cu`
`warp_bwd_kernel`), side by side on one CUDA GPU.

    python3 tools/warp_bwd_ab.py [--parent DIR] [--designs A,B,...] [--rounds N]

This script compiles each design with nvcc, every design a text patch of
`warp.cu` in a copy of the sources (that unit alone):

  * ``shipped``: the source as it is: a warp takes `kRun` steps of 32
    consecutive points, and a thread sums its points' dT terms in a
    register cache of `kSlots` joints (a miss flushes the least recently
    used slot into the block's shared table; both the evictions and the
    run's end go joint by joint, the warp summing each joint's slots by
    shuffles, `warp_flush`), w and j in one
    vector load a point at nb 4 and 2, the rows of T and g_M in float4s;
  * ``r4``, ``r16``: runs of 4 or 16 steps;
  * ``stride256``: a thread's points `kThreads` apart (the block's points
    a step consecutive);
  * ``slot_flush``, ``lane_flush``: the run's end flushed slot by slot (a
    warp sum where all lanes hold one joint in a slot) or lane by lane
    (`tools/warp_designs.cuh`);
  * ``evict_lane``: a miss's evicted slot added by its lane alone (the
    shipped kernel's warp adds the lanes' evictions joint by joint);
  * ``lb2``, ``lb3``: the shipped kernel bounded to 2 or 3 blocks an SM
    (128 or 80 registers);
  * ``scalar``: the shipped runs with the earlier kernel's scalar loads (w
    and j a bone at a time, T and g_M a float at a time);
  * ``tile``: dT = S^T G as a split-K product over tiles of points
    (`tools/warp_designs.cuh`, launched in place of the shipped dispatch);
  * ``no_adds`` (a census, not a design): the shipped kernel without its
    dT adds: the time they take is the difference;
  * ``parent`` (with ``--parent DIR``, a checkout of an earlier commit, for
    example ``git archive`` of the parent unpacked in DIR): that commit's
    kernel (a thread a point, 12 shared float adds a kept bone).

It prints each library's registers and spills, then times the designs in
turns (ROUNDS rounds, the order reversed every other round, the medians of
the kernel's device time from `torch.profiler`, REPS calls of the C entry
into preallocated outputs, L2 flushed before each call) at the shapes its
callers give the kernel, on the depth-9 SH9 shell's 1,404,480 leaf centres
skinned to a seeded 32-joint skeleton's 4 nearest joints (`chip_smoke.py`
phase 3c's rig, its skeleton from this script's seed), posed by pose 1:

  * ``a``: phase 6's call: J 32, nb 4, g_x and g_M, dT, dx and dw;
  * ``b``: the pose fit's call: g_x only, dT only;
  * ``c``: bench.py's rig: J 2, nb 2 (weights 1 - z and z), g_x and g_M,
    dT only.

In every round each design's dx and dw are held to the plain version
(`warp_backward_plain`) bit for bit and its dT within ATOMIC_RTOL (the
census is not checked). Then ``shipped`` and ``parent`` at J =
`svox_warp_max_joints()` (random ids, 50,000 points), checked the same way.

Needs one CUDA GPU and nvcc; builds no other kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
from svox_t_tpu_torch.ops import warp as warp_ops  # noqa: E402
from svox_t_tpu_torch.utils.scenes import (build_shell_tree, joint_pose_sequence,  # noqa: E402
                                           skin_to_nearest_joints)

ROUNDS = 6
REPS = 10
UNIT = ("warp",)
SOURCE = "warp.cu"
DESIGN_FILE = "warp_designs.cuh"
DISPATCH = """  if (nb == 4 && vec_bones) {
    warp_bwd_kernel<4><<<blocks, kThreads, smem, stream>>>(p, g);
  } else if (nb == 2 && vec_bones) {
    warp_bwd_kernel<2><<<blocks, kThreads, smem, stream>>>(p, g);
  } else {
    warp_bwd_kernel<0><<<blocks, kThreads, smem, stream>>>(p, g);
  }
"""
ENTRY = "template <int kNB>\n__global__ void __launch_bounds__(kThreads)\nwarp_bwd_kernel("
INCLUDE = (ENTRY, f'#include "{DESIGN_FILE}"\n\n' + ENTRY)
RUN = "constexpr int kRun = 8;"
FLUSH = "    warp_flush<kSlots>(c.id, c.s, table);\n"
STRIDE = """  const int q0 = blockIdx.x * (kThreads * kRun) + (threadIdx.x & ~31) * kRun + (threadIdx.x & 31);
  for (int r = 0; r < kRun; ++r) {
    const int q = q0 + r * 32;"""
# {design: text patches of warp.cu}.
DESIGNS = {
    "shipped": (),
    "r4": ((RUN, "constexpr int kRun = 4;"),),
    "r16": ((RUN, "constexpr int kRun = 16;"),),
    "stride256": ((STRIDE, """  const int q0 = blockIdx.x * (kThreads * kRun) + threadIdx.x;
  for (int r = 0; r < kRun; ++r) {
    const int q = q0 + r * kThreads;"""),),
    "slot_flush": (INCLUDE, (FLUSH, "    cache_flush_slots(c, table);\n")),
    "lane_flush": (INCLUDE, (FLUSH, "    cache_flush_lanes(c, table);\n")),
    "evict_lane": (("    warp_flush<1>(out, vs, table);\n",
                    "    if (out[0] >= 0) flush_slot(table, out[0], vs[0]);\n"),),
    "lb2": ((ENTRY, ENTRY.replace("(kThreads)", "(kThreads, 2)")),),
    "lb3": ((ENTRY, ENTRY.replace("(kThreads)", "(kThreads, 3)")),),
    "scalar": (("  const bool vec_bones = aligned16(w) && aligned16(ji);",
                "  const bool vec_bones = false;"),
               ("  const WarpGrads g{g_x, g_M, dT, dx, dw, aligned16(T), g_M != nullptr && aligned16(g_M)};",
                "  const WarpGrads g{g_x, g_M, dT, dx, dw, false, false};")),
    "tile": (INCLUDE, (DISPATCH, "  return launch_tile(p, g, smem, vec_bones, stream);\n")),
    "no_adds": (("      cache_add(c, table, live && wb > 0.f && jw >= 0 && jw < p.J, jw, ++now, t);",
                 "      if (t[0] == -12345.f && t[11] == jw) table[0] = t[5];"),),
}
CENSUS = ("no_adds",)
SHAPES = ("a", "b", "c")


def design_sources(workdir: Path, parent: Path | None, designs: dict, source: str = SOURCE,
                   design_file: str = DESIGN_FILE, unit: tuple = UNIT) -> dict:
    """{library: (its csrc copy, its units)}: each design's ``source``
    patched, with ``tools/<design_file>`` beside it; the parent's as it is."""
    src = (_build.CSRC / source).read_text()
    out = {}
    for name, patches in designs.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{source} changed: design {name}'s patch no longer applies")
            text = text.replace(old, new)
        d = workdir / name
        d.mkdir()
        for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
            shutil.copy(f, d / f.name)
        shutil.copy(Path(__file__).resolve().parent / design_file, d / design_file)
        (d / source).write_text(text)
        out[name] = (d, unit)
    if parent is not None:
        out["parent"] = (parent / "svox_t_tpu_torch" / "csrc", unit)
    return out


def report(name: str, rows: list) -> None:
    """Registers and spills of a library's warp backward kernels."""
    print(f"ptxas {name}: " + "; ".join(f"{e[:60]} {r} regs {s} B spilled" for _, e, r, s in rows
                                        if "warp_bwd" in e))


def deep_rig(dev) -> dict:
    """`chip_smoke.py` phase 3c's rig (its skeleton from seed 0, as
    `tools/profile_dynamic_frame.py` makes it): the depth-9 shell's leaf
    centres and features, skinned to the 4 nearest of 32 joints, the poses
    (seed 4), pose 1's transforms and the warped cloud."""
    state, feats_np, centers_np = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    M = centers_np.shape[0]
    joints = cs.skeleton(np.random.RandomState(0), M, dev)[0]
    sw, ji = (torch.from_numpy(a).to(dev) for a in skin_to_nearest_joints(centers_np, joints, cs.N_BONES))
    poses = torch.from_numpy(joint_pose_sequence(joints, cs.N_FRAMES, seed=4)).to(dev)
    src = torch.eye(4, device=dev).repeat(cs.N_JOINTS, 1, 1)
    centers = torch.from_numpy(centers_np).to(dev)
    T1 = stt.get_transformation_matrix(src, poses[1])
    warped = warp_ops.warp_forward_plain(T1, centers, sw, ji)[0]  # the kernel's bit for bit
    return dict(state=state, feats=torch.from_numpy(feats_np).to(dev), centers=centers, sw=sw, ji=ji,
                poses=poses, src=src, T1=T1, warped=warped)


def shapes(rig: dict, dev) -> dict:
    """{shape: (T, x, w, ji, g_x, g_M, want (T, x, w))}."""
    M = rig["centers"].shape[0]
    rng = np.random.RandomState(4)
    g_x = torch.from_numpy(rng.randn(M, 3).astype(np.float32)).to(dev)
    g_M = torch.from_numpy(rng.randn(M, 4, 4).astype(np.float32)).to(dev)
    x = rig["centers"]
    z = x[:, 2]
    sw2 = torch.stack([1.0 - z, z], dim=1).contiguous()
    ji2 = torch.tensor([0, 1], dtype=torch.int32, device=dev).repeat(M, 1)
    T2 = rig["T1"][:2].contiguous()
    return {
        "a": (rig["T1"], x, rig["sw"], rig["ji"], g_x, g_M, (True, True, True)),
        "b": (rig["T1"], x, rig["sw"], rig["ji"], g_x, None, (True, False, False)),
        "c": (T2, x, sw2, ji2, g_x, g_M, (True, False, False)),
    }


def max_joint_shape(dev):
    """J = svox_warp_max_joints() (`kernel_max_joints`), 50,000 points,
    random ids (some -1 and J + 3) and weights (some <= 0)."""
    J = warp_ops.kernel_max_joints()
    rng = np.random.RandomState(42)
    T = np.tile(np.eye(4, dtype=np.float32), (J, 1, 1)) + rng.randn(J, 4, 4).astype(np.float32) * 0.1
    Q = 50000
    x = rng.rand(Q, 3).astype(np.float32)
    w = rng.uniform(-0.3, 1.0, (Q, 4)).astype(np.float32)
    ji = rng.randint(0, J, (Q, 4)).astype(np.int32)
    ji[1::11, -1] = -1
    ji[2::13, 0] = J + 3
    g_x = rng.randn(Q, 3).astype(np.float32)
    g_M = rng.randn(Q, 4, 4).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (T, x, w, ji, g_x, g_M)]
    return (*t, (True, True, True))


def bind(libs: dict) -> dict:
    """{library: its svox_warp_bwd}."""
    fns = {}
    for name, path in libs.items():
        fn = getattr(ctypes.CDLL(str(path)), "svox_warp_bwd")
        fn.argtypes = warp_ops.WARP_BWD.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run_shape(fns: dict, runs: list, shape: str, case, rounds: int, dev, card: str, res: dict) -> None:
    """Times ``runs`` in turns on one shape and checks each against plain."""
    T, x, w, ji, g_x, g_M, want = case
    J, (Q, nb) = T.shape[0], w.shape
    plain = warp_ops.warp_backward_plain(T, x, w, ji, g_x, g_M, *want)
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = {name: (torch.zeros(J, 4, 4, device=dev), torch.empty(Q, 3, device=dev) if want[1] else None,
                   torch.empty(Q, nb, device=dev) if want[2] else None) for name in runs}

    def launcher(name):
        dT, dx, dw = outs[name]
        p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        a = (T.data_ptr(), J, x.data_ptr(), w.data_ptr(), ji.data_ptr(), Q, nb, p(g_x), p(g_M),
             dT.data_ptr(), p(dx), p(dw), dev.index, stream)

        def launch():
            dT.zero_()
            err = fns[name](*a)
            if err:
                raise RuntimeError(f"{name} {shape}: CUDA error {err}")
        return launch

    def held(name):
        torch.cuda.synchronize()
        got = outs[name]
        for field, g, p_ in zip(("dx", "dw"), got[1:], plain[1:]):
            cs.check((g is None) == (p_ is None) and (g is None or torch.equal(g, p_)),
                     f"{name} {shape}: {field} differs from the plain version")
        if name not in CENSUS:
            cs.atomic_err(got[0], plain[0], f"{name} {shape} dT")

    launches = {name: launcher(name) for name in runs}
    for name in runs:
        launches[name]()
        held(name)
    times = {name: [] for name in runs}
    for rnd in range(rounds):
        for name in (runs if rnd % 2 == 0 else runs[::-1]):
            times[name].append(cs.device_ms(launches[name], REPS, ("warp_bwd",), cold=True))
            launches[name]()
            held(name)
    runs_dT, census = warp_ops.warp_dT_runs_plain(T, x, w, ji, g_x, g_M)
    cs.atomic_err(runs_dT, plain[0], f"the runs mirror, {shape}")
    print(f"K10 backward {shape}: {Q} points, J {J}, nb {nb}, g_x {g_x is not None}, g_M {g_M is not None}, "
          f"wanted (dT, dx, dw) {want}; the shipped runs' census (`warp_dT_runs_plain`) {census} against "
          f"{12 * census['terms']} shared adds a point at a time; {rounds} rounds in turns, dx and dw equal to "
          f"plain, dT within ATOMIC_RTOL (census unchecked) [{card}]")
    base = statistics.median(times[runs[0]])
    for name in runs:
        m = statistics.median(times[name])
        res[f"{name}_{shape}_ms"] = m
        print(f"  {name:12s} {m:.4f} ms ({base / m:.3f}x {runs[0]}); rounds {[round(t, 4) for t in times[name]]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose K10 backward is timed beside this one's")
    ap.add_argument("--designs", default=None, help="a comma-separated subset of the designs")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("warp_bwd_ab.py needs a CUDA GPU")
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
        fns = bind(libs)
        # The wrappers' joint limit from the shipped library, not the package's build.
        lib = ctypes.CDLL(str(libs["shipped"]))
        warp_ops.kernel_max_joints = lib.svox_warp_max_joints
        runs = (["parent"] if "parent" in fns else []) + list(designs)
        t0 = time.perf_counter()
        rig = deep_rig(dev)
        print(f"rig: {rig['centers'].shape[0]} points, {time.perf_counter() - t0:.1f} s to build")
        for shape, case in shapes(rig, dev).items():
            run_shape(fns, runs, shape, case, args.rounds, dev, card, res)
        run_shape(fns, [n for n in runs if n in ("parent", "shipped")], "max_joints", max_joint_shape(dev), 1,
                  dev, card, res)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
