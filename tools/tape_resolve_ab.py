"""Cost of a per-sample indirect-resolve test in the tape replay (K13c).

    python3 tools/tape_resolve_ab.py

`csrc/tape_replay.cuh` resolves a data-indirect tape's cells once per
ray: each branch (index table or none) inlines its own sample loop, so a
direct tape's samples pay no test. This script compiles the float32
forward twice with nvcc into two small libraries: the header as it is
(per ray), and a copy whose sample loop tests the table per sample
(per sample, the one-loop alternative), each launched at width 4 (the
SH9 row in 16-byte loads). It records the depth-9 SH9 shell's
compacted exact tape of the 800x800 orbit camera with the plain recorder
(no library build needed), then times the two replays in ten alternating
pairs (CUDA events over REPS launches each), on the direct tape and on a
data-indirect tape with the tree's index table, checks that the two
variants' outputs are equal bit for bit, and prints the medians with the
card's name and power limit. Needs one CUDA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import json
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
import svox_t_tpu_torch as stt  # noqa: E402
from svox_t_tpu_torch import _build  # noqa: E402
from svox_t_tpu_torch.ops import render as render_ops  # noqa: E402
from svox_t_tpu_torch.ops import tape as tape_ops  # noqa: E402
from svox_t_tpu_torch.utils.scenes import build_shell_tree, orbit_camera  # noqa: E402

PAIRS = 10
REPS = 20
# The per-ray dispatch of the header and its per-sample replacement.
PER_RAY = ("  if (p.table != nullptr) {\n    replay_fwd<FMT, BD, kRot, true, W>(p, i, blockIdx.y);\n"
           "  } else {\n    replay_fwd<FMT, BD, kRot, false, W>(p, i, blockIdx.y);\n  }\n")
PER_SAMPLE_CALL = "  replay_fwd<FMT, BD, kRot, false, W>(p, i, blockIdx.y);\n"
# The SH9 row's vector width, as `replay_fwd_width` picks it for the pool.
WIDTH = 4
RESOLVE = "  if constexpr (kIndirect) {\n    return static_cast<uint32_t>(v)"
RESOLVE_PER_SAMPLE = "  if (kIndirect || p.table != nullptr) {\n    return static_cast<uint32_t>(v)"


def compile_variants(workdir: Path) -> dict:
    """{variant: library path}: the forward pass of tape_replay.cuh as it
    is, and with the per-sample test."""
    src = (_build.CSRC / "tape_replay.cuh").read_text()
    for old in (PER_RAY, RESOLVE):
        if src.count(old) != 1:
            raise RuntimeError("tape_replay.cuh changed: the variant patch no longer applies")
    variants = {"per_ray": src,
                "per_sample": src.replace(PER_RAY, PER_SAMPLE_CALL).replace(RESOLVE, RESOLVE_PER_SAMPLE)}
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]

    def build(name):
        header = workdir / f"tape_replay_{name}.cuh"
        header.write_text(variants[name])
        stub = workdir / f"{name}.cu"
        stub.write_text(f'#define SVOX_TAPE_PASS 0\n#define SVOX_SUFFIX \n#include "{header.name}"\n')
        lib = workdir / f"lib{name}.so"
        t0 = time.perf_counter()
        subprocess.run([nvcc, *flags, "-shared", f"-I{_build.CSRC}", f"-I{workdir}", "-o", str(lib),
                        str(stub)], check=True, capture_output=True, text=True)
        print(f"nvcc {name}: {time.perf_counter() - t0:.1f} s")
        return lib

    with ThreadPoolExecutor(2) as pool:
        return dict(zip(variants, pool.map(build, variants)))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tape_resolve_ab.py needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_variants(Path(tmp))
        fns = {}
        for name, path in libs.items():
            fn = ctypes.CDLL(str(path)).svox_tape_replay_fwd
            fn.argtypes = tape_ops._REPLAY_FWD_ARGS
            fn.restype = ctypes.c_int
            fns[name] = fn
        state, feats_np, _ = build_shell_tree(depth=9, data_format="SH9", data_dim=28)
        tree = stt.tree_from_numpy(state, device=dev)
        feats = torch.from_numpy(feats_np).to(dev)
        r = stt.VolumeRenderer(tree, backend="tree")
        opt = r._get_options(False)
        o, d = render_ops.cam2world_rays(torch.as_tensor(orbit_camera(), device=dev), 800, 800,
                                         1111.111, 1111.111)
        o, d = o.contiguous(), d.contiguous()
        spec = tree._spec()
        M = feats.shape[0]
        tapes = {}
        for kind, indirect in (("direct", False), ("indirect", True)):
            n_occ, _ = tape_ops.count_samples_plain(spec, M, o, d, opt)
            offsets = torch.zeros(n_occ.shape[0] + 1, dtype=torch.int32, device=dev)
            offsets[1:] = torch.cumsum(n_occ, 0)
            idx, dt, cell, _, dscale = tape_ops.record_samples_plain(
                spec, M, o, d, opt, offsets, True, want_idx=not indirect, want_cell=True)
            tapes[kind] = (offsets, cell if indirect else idx, dt, dscale)
        table = spec.data_flat
        n_color = render_ops.check_format(tape_ops._NOSPEC, feats, opt)
        rad = render_ops.radiometry_args(tape_ops._NOSPEC, feats, opt, n_color)
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = {}

        def launch(name, kind, out):
            offsets, idx, dt, dscale = tapes[kind]
            tab = (table.data_ptr(), table.numel()) if kind == "indirect" else (None, 0)
            err = fns[name](offsets.data_ptr(), idx.data_ptr(), dt.data_ptr(), None, dscale.data_ptr(),
                            d.data_ptr(), o.shape[0], *tab, *rad,
                            opt.background_brightness, opt.sigma_thresh, opt.stop_thresh, out.data_ptr(),
                            None, WIDTH, dev.index, stream)
            if err:
                raise RuntimeError(f"{name} {kind}: CUDA error {err}")

        def timed(name, kind):
            out = torch.empty(o.shape[0], n_color + 1, device=dev)
            launch(name, kind, out)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                launch(name, kind, out)
            end.record()
            torch.cuda.synchronize()
            outs[name, kind] = out
            return start.elapsed_time(end) / REPS

        times = {(n, k): [] for n in fns for k in tapes}
        for pair in range(PAIRS):
            order = list(fns) if pair % 2 == 0 else list(fns)[::-1]
            for kind in tapes:
                for name in order:
                    times[name, kind].append(timed(name, kind))
        for kind in tapes:
            if not torch.equal(outs["per_ray", kind], outs["per_sample", kind]):
                raise AssertionError(f"{kind}: the variants' outputs differ")
        res = {f"{n}_{k}_ms": statistics.median(v) for (n, k), v in times.items()}
        for kind in tapes:
            base = res[f"per_ray_{kind}_ms"]
            res[f"per_sample_cost_{kind}"] = res[f"per_sample_{kind}_ms"] / base - 1.0
            q = np.percentile(times["per_ray", kind], [25, 75])
            res[f"per_ray_{kind}_iqr_ms"] = float(q[1] - q[0])
        n = int(tapes["direct"][0][-1])
        print(f"K13c float32, depth-9 SH9 shell, 800x800, compacted exact tape ({n} samples), {PAIRS} "
              f"alternating pairs of {REPS} launches [{card}]")
        for (name, kind), v in times.items():
            print(f"  {name} {kind}: median {statistics.median(v):.4f} ms, runs {[round(x, 4) for x in v]}")
        print(json.dumps(res))


if __name__ == "__main__":
    main()
