"""Designs of the tape replay forward (K13c) side by side, on one CUDA GPU.

    python3 tools/tape_fwd_ab.py

`csrc/tape_replay.cuh`'s forward loads sample k + 1's row index, step and
cell and, at width 4 (the three-colour RGBA, SH1 and SH9 rows), its whole
row in 16-byte loads (a second register row) before sample k composites,
sample k + 2's recorded row or cell before that. This script compiles the
float32 forward pass with nvcc into one small library per design, each a
text patch of the header as it is:

  * ``shipped``: the header as it is (timed at widths 4 and 1);
  * ``streams_ahead``: only the streams one sample ahead; width 4 loads
    each sample's whole row in its own iteration, before the sigma test;
  * ``sigma_first``: as ``streams_ahead``, but width 4 loads the row's last
    vector (sigma and three coefficients) first and the other six only
    where sigma passes;
  * ``earlier``: the scalar design before the redesign (width 1, each
    sample's streams loaded in its own iteration, dt after the sigma test).

It prints each library's ptxas registers and spills, then times the
designs in turns (ROUNDS rounds, the order reversed every other round,
the medians) at two shapes: the depth-9 SH9 shell's compacted exact tape
of the 800x800 orbit camera on the bake (CUDA events over REPS launches),
and a 65,536-ray subset of `chip_smoke.py`'s minibatch rig tape (device
time from `torch.profiler`, L2 flushed before each launch, and warm). The
outputs of every design are checked equal bit for bit. It builds the
package's library first (the tapes are recorded with its kernels), then
the variants (one nvcc each, in parallel). Needs one CUDA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
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
import chip_smoke as cs  # noqa: E402
import svox_t_tpu_torch as stt  # noqa: E402
from svox_t_tpu_torch import _build  # noqa: E402
from svox_t_tpu_torch.ops import render as render_ops  # noqa: E402
from svox_t_tpu_torch.ops import tape as tape_ops  # noqa: E402
from svox_t_tpu_torch.ops import tape_subset as subset_ops  # noqa: E402
from svox_t_tpu_torch.utils.scenes import build_shell_tree  # noqa: E402

ROUNDS = 6
REPS = 20

# The shipped loop head: the next sample's streams loaded one sample ahead;
# at width 4 its row resolved and its values too, its recorded value two
# ahead.
HEAD = """  // Loaded one sample ahead of their use: sample k's step and cell, and its
  // row, as recorded at W = 1, resolved at W = 4 with its values in nbuf;
  // at W = 4 also sample k + 1's recorded row or cell (the scalar row
  // measured slower with its row resolved ahead).
  int32_t next = 0;
  float dt_next = 0.f;
  int32_t cell_next = 0;
  int32_t v_after = 0;
  float nbuf[kD];
  if (k < end) {
    next = __ldg(p.idx + k);
    dt_next = __ldg(p.dt + k);
    if (p.waccum != nullptr) cell_next = __ldg(p.cell + k);
    if constexpr (kVec) {
      next = resolve_row<kIndirect>(p, next);
      load_row<kD>(features, next, p.M, nbuf);
      if (k + 1 < end) v_after = __ldg(p.idx + k + 1);
    }
  }
  for (; k < end; ++k) {
    const int32_t cur = next;
    const float dt = dt_next;
    const int32_t cell = cell_next;
    if constexpr (kVec) {
#pragma unroll
      for (int e = 0; e < kD; ++e) buf[e] = nbuf[e];
    }
    if (k + 1 < end) {
      dt_next = __ldg(p.dt + k + 1);
      if (p.waccum != nullptr) cell_next = __ldg(p.cell + k + 1);
      if constexpr (kVec) {
        next = resolve_row<kIndirect>(p, v_after);
        load_row<kD>(features, next, p.M, nbuf);
        if (k + 2 < end) v_after = __ldg(p.idx + k + 2);
      } else {
        next = __ldg(p.idx + k + 1);
      }
    }
    const int32_t idx = kVec ? cur : resolve_row<kIndirect>(p, cur);
    if (static_cast<uint32_t>(idx) >= static_cast<uint32_t>(p.M)) continue;
    const auto row = features + static_cast<size_t>(idx) * D;
    const float sigma = row_col<W>(row, buf, D - 1);
    if (!(sigma > p.sigma_thresh)) continue;
"""
# The first design: the streams one sample ahead, the row loaded in its
# own sample's iteration, before the sigma test.
STREAMS_AHEAD = """  // Sample k's streams, loaded one sample ahead.
  int32_t v_next = 0;
  float dt_next = 0.f;
  int32_t cell_next = 0;
  if (k < end) {
    v_next = __ldg(p.idx + k);
    dt_next = __ldg(p.dt + k);
    if (p.waccum != nullptr) cell_next = __ldg(p.cell + k);
  }
  for (; k < end; ++k) {
    const int32_t v = v_next;
    const float dt = dt_next;
    const int32_t cell = cell_next;
    if (k + 1 < end) {
      v_next = __ldg(p.idx + k + 1);
      dt_next = __ldg(p.dt + k + 1);
      if (p.waccum != nullptr) cell_next = __ldg(p.cell + k + 1);
    }
    const int32_t idx = resolve_row<kIndirect>(p, v);
    if (static_cast<uint32_t>(idx) >= static_cast<uint32_t>(p.M)) continue;
    const auto row = features + static_cast<size_t>(idx) * D;
    if constexpr (kVec) {
#pragma unroll
      for (int e = 0; e < kD; e += 4) load_row4(row, buf, e);
    }
    const float sigma = row_col<W>(row, buf, D - 1);
    if (!(sigma > p.sigma_thresh)) continue;
"""
SIGMA_FIRST = STREAMS_AHEAD.replace("""    if constexpr (kVec) {
#pragma unroll
      for (int e = 0; e < kD; e += 4) load_row4(row, buf, e);
    }
    const float sigma = row_col<W>(row, buf, D - 1);
    if (!(sigma > p.sigma_thresh)) continue;
""", """    if constexpr (kVec) load_row4(row, buf, kD - 4);
    const float sigma = row_col<W>(row, buf, D - 1);
    if (!(sigma > p.sigma_thresh)) continue;
    if constexpr (kVec) {
#pragma unroll
      for (int e = 0; e < kD - 4; e += 4) load_row4(row, buf, e);
    }
""")
EARLIER = """  for (; k < end; ++k) {
    const int32_t idx = sample_row<kIndirect>(p, k);
    if (static_cast<uint32_t>(idx) >= static_cast<uint32_t>(p.M)) continue;
    const auto row = features + static_cast<size_t>(idx) * D;
    if constexpr (kVec) {
#pragma unroll
      for (int e = 0; e < kD; e += 4) load_row4(row, buf, e);
    }
    const float sigma = row_col<W>(row, buf, D - 1);
    if (!(sigma > p.sigma_thresh)) continue;
    const float dt = __ldg(p.dt + k);
"""
ATOMIC = "    if (p.waccum != nullptr) atomicAdd(p.waccum + cell, weight);\n"
ATOMIC_EARLIER = "    if (p.waccum != nullptr) atomicAdd(p.waccum + __ldg(p.cell + k), weight);\n"
# (design, width) pairs timed.
RUNS = (("shipped", 4), ("shipped", 1), ("streams_ahead", 4), ("sigma_first", 4), ("earlier", 1))
PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
PTXAS_USED = re.compile(r"Used (\d+) registers")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
FWD_SH9 = re.compile(r"replay_fwd_kernelILi1ELi9ELb([01])ELi(\d+)E")


def variants() -> dict:
    """{design: header text}."""
    src = (_build.CSRC / "tape_replay.cuh").read_text()
    for old in (HEAD, ATOMIC):
        if src.count(old) != 1:
            raise RuntimeError("tape_replay.cuh changed: the design patches no longer apply")
    return {"shipped": src, "streams_ahead": src.replace(HEAD, STREAMS_AHEAD),
            "sigma_first": src.replace(HEAD, SIGMA_FIRST),
            "earlier": src.replace(HEAD, EARLIER).replace(ATOMIC, ATOMIC_EARLIER)}


def compile_variants(workdir: Path) -> dict:
    """{design: library path}, and print each one's SH9 registers and spills."""
    texts = variants()
    nvcc = _build._nvcc()

    def build(name):
        header = workdir / f"tape_replay_{name}.cuh"
        header.write_text(texts[name])
        stub = workdir / f"{name}.cu"
        stub.write_text(f'#define SVOX_TAPE_PASS 0\n#define SVOX_SUFFIX \n#include "{header.name}"\n')
        lib = workdir / f"lib{name}.so"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", f"-I{_build.CSRC}", f"-I{workdir}",
                               "-o", str(lib), str(stub)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{proc.stdout}\n{proc.stderr}")
        return lib, time.perf_counter() - t0, proc.stdout + proc.stderr

    with ThreadPoolExecutor(len(texts)) as pool:
        built = dict(zip(texts, pool.map(build, texts)))
    for name, (_, secs, log) in built.items():
        entry, spill, rows = None, 0, []
        for line in log.splitlines():
            if (m := PTXAS_ENTRY.search(line)):
                entry = m.group(1)
            elif (m := PTXAS_SPILL.search(line)):
                spill = int(m.group(1)) + int(m.group(2))
            elif (m := PTXAS_USED.search(line)) and entry is not None:
                rows.append((entry, int(m.group(1)), spill))
                entry, spill = None, 0
        sh9 = [f"width {m.group(2)}{' rot' if m.group(1) == '1' else ''} {r} regs, {s} B spilled"
               for e, r, s in rows for m in [FWD_SH9.search(e)] if m]
        print(f"nvcc {name}: {secs:.1f} s; {len(rows)} kernels, {sum(r[2] for r in rows)} bytes spilled in all; "
              f"SH9: {'; '.join(sh9)}")
    return {name: b[0] for name, b in built.items()}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tape_fwd_ab.py needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    t0 = time.perf_counter()
    b = _build.build()
    print(f"package library: {b.seconds:.1f} s to build")
    with tempfile.TemporaryDirectory() as tmp:
        fns = {}
        for name, path in compile_variants(Path(tmp)).items():
            fn = ctypes.CDLL(str(path)).svox_tape_replay_fwd
            fn.argtypes = tape_ops._REPLAY_FWD_ARGS
            fn.restype = ctypes.c_int
            fns[name] = fn
        print(f"builds: {time.perf_counter() - t0:.1f} s")

        # The deep shell's compacted exact tape on the bake.
        state, feats_np, _ = build_shell_tree(depth=9, data_format="SH9", data_dim=28)
        tree = stt.tree_from_numpy(state, device=dev)
        feats = torch.from_numpy(feats_np).to(dev)
        r = stt.VolumeRenderer(tree)
        spec, opt = r._render_spec(), r._get_options(False)
        o, d = cs.camera_rays(dev)
        deep = tape_ops.record_tape(spec, feats.shape[0], o, d, d, opt)
        # The minibatch step's subset: 65,536 ids of the rig tape (seed 8, as
        # chip_smoke.py's phase 3h), the pool at 0.9 of the true one.
        mb = cs.minibatch_scene(dev)
        ids = np.random.RandomState(8).randint(0, mb["rig"].n_rays, cs.B_MB)
        sub = subset_ops.subset_tape(subset_ops.TapeRowSource(mb["rig"]), ids, with_rays=False)
        shapes = {"deep": (deep, feats, opt), "minibatch": (sub, (mb["f0"] * 0.9).contiguous(), mb["opt"])}
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = {}

        def call(name, width, shape):
            tp, pool, op = shapes[shape]
            n_color = render_ops.check_format(tape_ops._NOSPEC, pool, op)
            rad = render_ops.radiometry_args(tape_ops._NOSPEC, pool, op, n_color)
            out = torch.empty(tp.n_rays, n_color + 1, device=dev)
            fn = fns[name]

            def launch():
                err = fn(tp.offsets.data_ptr(), tp.idx.data_ptr(), tp.dt.data_ptr(), None, tp.dscale.data_ptr(),
                         tp.vdirs.data_ptr(), tp.n_rays, None, 0, *rad, op.background_brightness,
                         op.sigma_thresh, op.stop_thresh, out.data_ptr(), None, width, dev.index, stream)
                if err:
                    raise RuntimeError(f"{name} width {width} {shape}: CUDA error {err}")
            outs[name, width, shape] = out
            return launch

        timers = {"deep": lambda fn: cs.time_ms(fn, REPS),
                  "minibatch": lambda fn: cs.device_ms(fn, REPS, ("replay_fwd_kernel",)),
                  "minibatch_warm": lambda fn: cs.device_ms(fn, REPS, ("replay_fwd_kernel",), cold=False)}
        times = {(run, t): [] for run in RUNS for t in timers}
        for i in range(ROUNDS):
            order = RUNS if i % 2 == 0 else RUNS[::-1]
            for t, timer in timers.items():
                shape = t.split("_")[0]
                for run in order:
                    times[run, t].append(timer(call(*run, shape)))
        for shape in shapes:
            ref = outs["shipped", 4, shape]
            for run in RUNS:
                if not torch.equal(outs[(*run, shape)], ref):
                    raise AssertionError(f"{shape}: {run} differs from the shipped width 4")
        print(f"K13c float32 designs in turns, {ROUNDS} rounds, outputs equal bit for bit: deep tape "
              f"{deep.n_samples} samples of {deep.n_rays} rays (CUDA events over {REPS} launches); minibatch "
              f"subset {sub.n_samples} samples of {sub.n_rays} rays (profiler, L2 flushed; warm) [{card}]")
        res = {}
        for t in timers:
            base = statistics.median(times[("earlier", 1), t])
            for run in RUNS:
                v = times[run, t]
                med = statistics.median(v)
                res[f"{run[0]}_w{run[1]}_{t}_ms"] = med
                print(f"  {t:15s} {run[0]:12s} width {run[1]}: median {med:.4f} ms ({base / med:.3f}x the "
                      f"earlier design), rounds {[round(x, 4) for x in v]}")
        print(json.dumps(res))


if __name__ == "__main__":
    main()
