"""Designs of the first-hit march (K9b) side by side, on one CUDA GPU.

    python3 tools/first_hit_ab.py [--parent DIR] [--designs A,B,...] [--no-census]

`csrc/render_aux.cuh`'s `first_hit_kernel` reads one value a sample, its
row's sigma, so its time is its lookups' chains of dependent loads and the
loop around them. The shipped header has two levers, compile-time constants
(`kFhLoop` 0 or 1, `kFhReuse`); `tools/first_hit_designs.cuh` holds the
kernel with every lever this script times, the ones that did not ship
included (`kFhLoop` 2, `kFhPath`, `kFhTop`). This script compiles each
design with nvcc, every design a text patch of those constants (the
designs file first put in place of the header's K9b section where a design
needs it), in a copy of the sources, K9b alone (each library's K9c and K9d
are cut from its copy of the header, the parent's too: their code is not
timed here, `tools/mf_ab.py` times it), on every instance (structure,
nearest or interp, pool type) whose lever it changes:

  * ``shipped``: the header as it is;
  * ``no_levers``: the earlier loop, the interp corners from 9 lookups: the
    earlier kernel's work in this kernel's code;
  * ``loop0``, ``loop1``: the earlier loop (a sample's lookup at the top of
    each step) or the rotated one (the next sample's lookup at the end of a
    step) where the shipped instance has the other, nearest;
    ``loop1_interp`` (designs file): the rotated loop on the interp ones;
  * ``reuse1``: the tree walk's interp corners with the own corner's row
    reused and the other 7 looked up from the root;
  * ``corners9``: the interp corners from 9 lookups (`sample_corners`);
  * ``ahead`` (designs file): the rotated loop with the next sample's lookup
    issued before this sample's sigma is compared, every instance;
  * ``path`` (designs file): the tree walk's descents started on the
    previous sample's path, every level's node in shared memory
    (`lookup_next`, mirrored by `ops/first_hit_path.py`);
  * ``path_reg`` (designs file): the same with the last two levels' nodes
    in registers (`lookup_next_reg`; nearest only), and ``path_reg_ahead``
    with the lookup ahead;
  * ``top`` (designs file): on the bake, the previous sample's top and mid
    entries taken again while the point stays in their cells
    (`lookup_trail`), and ``top_ahead`` with the lookup ahead;
  * ``parent`` (with ``--parent DIR``, a checkout of an earlier commit, for
    example ``git archive`` of the parent unpacked in DIR): that commit's
    header.

It prints the registers and spills of every K9b instance of every library
(ptxas). Then, unless ``--no-census``, the census of the lookups
(`ops/first_hit_path.py`) on the aux scene's deep camera (the depth-9 SH9
shell, 800x800, the main path's rays), both structures, nearest and interp.
Then it times in turns (ROUNDS rounds, INTERP_TREE_ROUNDS on the tree
walk's interp instances, the order reversed every other round, the medians;
CUDA events over REPS calls) every instance (both structures, nearest and
interp, float32, bf16 and int8 pools): ``parent``, ``shipped`` and each
design that changes the instance. Every run's found,
t_hit and row must equal the first run's bit for bit and its fraction lie
within RENDER_ATOL of it. Needs one CUDA GPU and nvcc; builds no other
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
from svox_t_tpu_torch.ops import first_hit_path  # noqa: E402
from svox_t_tpu_torch.ops import render as render_ops  # noqa: E402
from svox_t_tpu_torch.ops import render_aux as aux_ops  # noqa: E402
from svox_t_tpu_torch.utils.scenes import build_shell_tree  # noqa: E402

ROUNDS = 6
INTERP_TREE_ROUNDS = 12
REPS = 10

AUX_UNITS = ("render_aux", "render_aux_baked", "render_aux_interp", "render_aux_baked_interp",
             "render_aux_bf16", "render_aux_baked_bf16", "render_aux_interp_bf16",
             "render_aux_baked_interp_bf16", "render_aux_i8", "render_aux_baked_i8",
             "render_aux_interp_i8", "render_aux_baked_interp_i8")
TREE_NEAREST = ("render_aux", "render_aux_bf16", "render_aux_i8")
BAKED_NEAREST = ("render_aux_baked", "render_aux_baked_bf16", "render_aux_baked_i8")
TREE_INTERP = ("render_aux_interp", "render_aux_interp_bf16", "render_aux_interp_i8")
BAKED_INTERP = ("render_aux_baked_interp", "render_aux_baked_interp_bf16", "render_aux_baked_interp_i8")
# The shipped header's constants, and the designs file's (tools/first_hit_designs.cuh,
# which holds the levers that did not ship).
LOOP = "constexpr int kFhLoop = !S::kBaked && !svox::kInterp ? 1 : 0;\n"
REUSE = "constexpr int kFhReuse = svox::kInterp ? (S::kBaked ? 1 : 2) : 0;\n"
D_LOOP = LOOP
D_PATH = "constexpr int kFhPath = 0;\n"
D_TOP = "constexpr bool kFhTop = false;\n"
DESIGNS_FILE = Path(__file__).resolve().parent / "first_hit_designs.cuh"
K9B_SECTION = re.compile(r"// -{69}\n// K9b: first hit\n.*?(?=// -{69}\n// K9c/K9d: motion features)", re.S)


def loop(n, old=LOOP):
    return (old, f"constexpr int kFhLoop = {n};\n")


def spliced(*patches):
    """Patches of the designs file, put in place of the header's K9b
    section first."""
    return (("designs file",), *patches)


# {design: (text patches of render_aux.cuh, the units it changes)}.
DESIGNS = {
    "shipped": ((), AUX_UNITS),
    "no_levers": ((loop(0), (REUSE, "constexpr int kFhReuse = 0;\n")), AUX_UNITS),
    "loop0": ((loop(0),), TREE_NEAREST),
    "loop1": (((LOOP, "constexpr int kFhLoop = svox::kInterp ? 0 : 1;\n"),), BAKED_NEAREST),
    "loop1_interp": (spliced(loop(1, D_LOOP)), TREE_INTERP + BAKED_INTERP),
    "reuse1": (((REUSE, "constexpr int kFhReuse = svox::kInterp ? 1 : 0;\n"),), TREE_INTERP),
    "corners9": (((REUSE, "constexpr int kFhReuse = 0;\n"),), TREE_INTERP + BAKED_INTERP),
    "ahead": (spliced(loop(2, D_LOOP)), AUX_UNITS),
    "path": (spliced((D_PATH, "constexpr int kFhPath = 1;\n")), TREE_NEAREST + TREE_INTERP),
    "path_reg": (spliced((D_PATH, "constexpr int kFhPath = svox::kInterp ? 0 : 2;\n")), TREE_NEAREST),
    "path_reg_ahead": (spliced((D_PATH, "constexpr int kFhPath = svox::kInterp ? 0 : 2;\n"), loop(2, D_LOOP)),
                       TREE_NEAREST),
    "top": (spliced((D_TOP, "constexpr bool kFhTop = true;\n")), BAKED_NEAREST),
    "top_ahead": (spliced((D_TOP, "constexpr bool kFhTop = true;\n"), loop(2, D_LOOP)), BAKED_NEAREST),
}
POOLS = ("f32", "bf16", "i8")
STRUCTS = ("tree", "baked")
# K9b alone: each library's copy of the header loses the motion-feature
# kernels (from their section to the end of the anonymous namespace) and
# their C entries.
MF_SECTION = re.compile(r"// -{69}\n// K9c/K9d: motion features.*?(?=\}  // namespace)", re.S)
MF_ENTRIES = re.compile(r"// K9c\. jf \(J, Kd\).*\Z", re.S)
KERNEL = re.compile(r"first_hit_kernel")


def k9b_only(text: str) -> str:
    """A render_aux.cuh with K9b alone."""
    for pat in (MF_SECTION, MF_ENTRIES):
        if len(pat.findall(text)) != 1:
            raise RuntimeError("render_aux.cuh changed: the motion-feature kernels no longer cut")
        text = pat.sub("", text)
    return text


def design_sources(workdir: Path, parent: Path | None, designs: dict) -> tuple:
    """({library: (its csrc copy, its units)}, {design: the library it
    shares}), each header patched and cut to K9b (`k9b_only`)."""
    src = (_build.CSRC / "render_aux.cuh").read_text()
    out, alias = {}, {}
    trees = {name: (_build.CSRC, patches, units) for name, (patches, units) in designs.items()}
    if parent is not None:
        trees["parent"] = (parent / "svox_t_tpu_torch" / "csrc", (), AUX_UNITS)
    for name, (csrc, patches, units) in trees.items():
        text = src if name != "parent" else (csrc / "render_aux.cuh").read_text()
        if patches and patches[0] == ("designs file",):
            if len(K9B_SECTION.findall(text)) != 1:
                raise RuntimeError("render_aux.cuh changed: its K9b section no longer splices")
            section = "// " + "-" * 69 + "\n// K9b: first hit\n" + DESIGNS_FILE.read_text() + "\n"
            text = K9B_SECTION.sub(lambda _: section, text)
            patches = patches[1:]
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"render_aux.cuh changed: design {name}'s patch no longer applies")
            text = text.replace(old, new)
        if name not in ("shipped", "parent") and text == src:
            alias[name] = "shipped"
            continue
        d = workdir / name
        d.mkdir()
        for f in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
            shutil.copy(f, d / f.name)
        (d / "render_aux.cuh").write_text(k9b_only(text))
        out[name] = (d, units)
    return out, alias


def report(name: str, rows: list) -> None:
    """Registers and spills of a library's K9b instances."""
    k9b = [(unit, regs, spill) for unit, entry, regs, spill in rows if KERNEL.search(entry)]
    print(f"ptxas {name}: {len(k9b)} K9b kernels, {sum(s for *_, s in k9b)} bytes spilled in all")
    for unit, regs, spill in k9b:
        print(f"  {unit} first_hit_kernel {regs} regs ({cs.blocks_per_sm(regs)} blocks/SM) {spill} B spilled")


def load(libs: dict) -> dict:
    """{(library, suffix): C entry} of K9b."""
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for st_ in ("", "_baked"):
            for interp in ("", "_interp"):
                for pool in POOLS:
                    sfx = st_ + interp + render_ops.POOL_SUFFIX[pool]
                    fn = getattr(lib, f"svox_first_hit{sfx}", None)
                    if fn is None:
                        continue
                    fn.argtypes = aux_ops._FIRST_HIT_ARGS
                    fn.restype = ctypes.c_int
                    fns[name, sfx] = fn
    return fns


def scene(dev):
    """The aux scene's tree and pool (the depth-9 SH9 shell) and the deep
    camera's rays."""
    state, feats_np, _ = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    tree = stt.tree_from_numpy(state, device=dev)
    o, d = cs.camera_rays(dev)
    return tree, torch.from_numpy(feats_np).to(dev), o, d


def census(specs: dict, opts: dict, feats, o, d) -> dict:
    """The census of K9b's lookups on both structures, nearest and interp."""
    res = {}
    for structure, spec in specs.items():
        for interp, opt in opts.items():
            t0 = time.perf_counter()
            c = first_hit_path.first_hit_census(spec, feats, o, d, opt)
            label = f"{structure}{' interp' if interp else ''}"
            s = max(c["samples"], 1)
            line = (f"census {label} ({time.perf_counter() - t0:.1f} s): {c['hits']} rays hit, {c['found']} "
                    f"found, {c['samples']} samples; own lookups' loads from the root {c['root_loads']} "
                    f"({c['root_loads'] / s:.3f} a sample)")
            if structure == "tree":
                line += (f", started on the previous path {c['path_loads']} ({c['path_loads'] / s:.3f}; "
                         f"{c['root_loads'] / max(c['path_loads'], 1):.3f}x fewer), in the previous leaf "
                         f"{c['same_leaf']}")
            else:
                line += (f"; in the previous top cell {c['same_top']} ({c['same_top'] / s:.3f}), mid cell "
                         f"{c['same_mid']} ({c['same_mid'] / s:.3f}); loads with those reused "
                         f"{c['trail_loads']} ({c['trail_loads'] / s:.3f})")
            if interp:
                line += (f"; lookups sample_corners {c['lookups_9']} ({c['lookups_9'] / s:.3f}), corners_keep "
                         f"{c['lookups_keep']} ({c['lookups_keep'] / s:.3f}); their loads {c['loads_9']} "
                         f"({c['loads_9'] / s:.3f}) against {c['loads_keep']} ({c['loads_keep'] / s:.3f})")
            print(line)
            res[label] = c
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose K9b is timed beside this one's")
    ap.add_argument("--designs", default=None, help="a comma-separated subset of the designs")
    ap.add_argument("--no-census", action="store_true", help="skip the census")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("first_hit_ab.py needs a CUDA GPU")
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
        sources, alias = design_sources(Path(tmp), args.parent, designs)
        libs = fab.compile_libraries(Path(tmp), sources, report)
        print(f"builds: {time.perf_counter() - t0:.1f} s")
        libs.update({a: libs[t] for a, t in alias.items()})
        fns = load(libs)
        tree, feats, o, d = scene(dev)
        specs = {"tree": tree._spec(), "baked": tree._baked_spec()}
        opts = {i: stt.VolumeRenderer(tree, interp="trilinear" if i else "nearest")._get_options(False)
                for i in (False, True)}
        if not args.no_census:
            with torch.no_grad():
                res["census"] = census(specs, opts, feats, o, d)
        pools = {k: fab.as_pool(k, feats) for k in POOLS}
        stream = torch.cuda.current_stream(dev).cuda_stream
        B = o.shape[0]

        def call(structure, interp, pool, lib, buf):
            """A launch of ``lib``'s K9b instance into ``buf``."""
            opt = opts[interp]
            sfx = cs.SUFFIX[structure] + ("_interp" if interp else "") + render_ops.POOL_SUFFIX[pool]
            fn = fns[lib, sfx]
            a = aux_ops._aux_args(specs[structure], pools[pool], o, d, opt, "first_hit_ab")
            tail = (opt.sigma_thresh, *(b.data_ptr() for b in buf), dev.index, stream)

            def launch():
                err = fn(*a, *tail)
                if err:
                    raise RuntimeError(f"{lib} first_hit{sfx}: CUDA error {err}")
            launch.keep = a  # the structure descriptor the arguments point at
            return launch

        def in_turns(key, runs, rounds):
            """Times of ``runs`` [(run, library)] of the instance ``key``
            (structure, interp, pool) in turns, after holding each run's
            result to the first run's."""
            structure, interp, pool = key
            ref, launches = None, []
            for run, lib in runs:
                buf = (torch.empty(B, dtype=torch.bool, device=dev), torch.empty(B, device=dev),
                       torch.empty(B, dtype=torch.int32, device=dev), torch.empty(B, 3, device=dev))
                launch = call(structure, interp, pool, lib, buf)
                what = f"first_hit {structure} interp={interp} {pool}: {run} against {runs[0][0]}"
                launch()
                torch.cuda.synchronize()
                if ref is None:
                    ref = [b.clone() for b in buf]
                    cs.check(int(ref[0].sum()) > 0 and bool(torch.isfinite(ref[3]).all()), f"{what}: no hit")
                else:
                    cs.check(all(torch.equal(b, r) for b, r in zip(buf[:3], ref[:3])),
                             f"{what}: found, t_hit or row differ")
                    err = float((buf[3] - ref[3]).abs().max())
                    cs.check(err <= cs.RENDER_ATOL, f"{what}: frac {err}")
                launches.append((run, launch))
            times = {run: [] for run, _ in launches}
            for i in range(rounds):
                for run, launch in (launches if i % 2 == 0 else launches[::-1]):
                    times[run].append(cs.time_ms(launch, REPS))
            base = statistics.median(times[runs[0][0]])
            for run, v in times.items():
                med = statistics.median(v)
                res[f"first_hit_{structure}{'_interp' if interp else ''}_{pool}_{run}_ms"] = med
                print(f"  first_hit {structure:5s} {'interp' if interp else 'nearest':7s} {pool:4s} {run:12s}: "
                      f"median {med:.4f} ms ({base / med:.3f}x {runs[0][0]}), rounds {[round(x, 4) for x in v]}")

        first = (("parent", "parent"),) if args.parent is not None else ()
        print(f"K9b, {ROUNDS} rounds in turns ({INTERP_TREE_ROUNDS} on the tree walk's interp instances); "
              f"CUDA events over {REPS} calls; found, t_hit and row bit for bit, frac within RENDER_ATOL of "
              f"the first run [{card}]")
        with torch.no_grad():
            for interp in (False, True):
                for structure in STRUCTS:
                    for pool in POOLS:
                        runs = first + (("shipped", "shipped"),)
                        unit = ("render_aux" + ("_baked" if structure == "baked" else "")
                                + ("_interp" if interp else "") + render_ops.POOL_SUFFIX[pool])
                        runs += tuple((n, n) for n in designs if n != "shipped" and unit in DESIGNS[n][1])
                        rounds = INTERP_TREE_ROUNDS if interp and structure == "tree" else ROUNDS
                        in_turns((structure, interp, pool), runs, rounds)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
