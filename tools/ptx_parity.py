"""Compare the PTX of the kernel sources with another copy of them, on a
machine with nvcc.

    python3 tools/ptx_parity.py [--by-entry] OTHER_CSRC_DIR [SOURCE ...]

OTHER_CSRC_DIR holds another version of `svox_t_tpu_torch/csrc` (for
example the parent commit's, unpacked with `git archive`). Every compile
unit that both trees hold (a unit only one of them has is listed and
skipped) is compiled to PTX from both with the build's code-generation
flags, all at once. A tree's units are those its `_build.units` lists:
this tree's, and the other's when its `_build.py` lies beside
OTHER_CSRC_DIR and has `units` (else the other's `.cu` sources): the
`.cu` sources and the pool instances of the march headers.
Anonymous-namespace and internal names (they hash the file's path), the
function ordinals in block labels and local depots, and comment lines are
normalized away; the script prints each unit's PTX lines and how many
lines differ, with the first lines of each difference, and exits nonzero
if any unit differs. Naming units (e.g. `render_bwd`,
`render_fwd_baked_bf16`) compares only those. With ``--by-entry`` each unit
that differs is also compared function by function (each `.entry` and
`.func` of its PTX, by name): it prints how many of them are identical and
the diff lines of each that is not, so that a change to one kernel of a
unit shows the unit's other kernels unchanged.
"""

from __future__ import annotations

import difflib
import importlib.util
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from svox_t_tpu_torch import _build  # noqa: E402

DIFF_LINES_SHOWN = 40
# With the length prefix of a mangled name, which counts the path's characters.
ANON = re.compile(r"\d*_GLOBAL__N__[0-9a-f]+_[0-9]+_\w+?_cu_[0-9a-f]+"
                  r"|\d*_INTERNAL_[0-9a-f]{8}_[0-9]+_\w+?_cu_[0-9a-f]{8}")


def ptx_flags() -> list:
    """The build's flags, with one PTX target instead of the SASS one and
    without the ptxas report."""
    flags = list(_build.NVCC_FLAGS)
    for flag in ("-gencode", "-Xptxas"):
        i = flags.index(flag)
        del flags[i:i + 2]
    return ["-arch=sm_90a", *flags]


def units_of(csrc: Path) -> dict:
    """The compile units of the tree that holds ``csrc``, by name."""
    build_py = csrc.parent / "_build.py"
    if csrc != _build.CSRC and build_py.exists():
        spec = importlib.util.spec_from_file_location("other_build", build_py)
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
        if hasattr(other, "units"):
            return {u.name: u for u in other.units(csrc)}
    if csrc != _build.CSRC:
        return {p.stem: _build.Unit(p.stem, p, ()) for p in csrc.glob("*.cu")}
    return {u.name: u for u in _build.units()}


# A function's basic-block labels and local depot carry its ordinal in the
# unit (`$L__BB12_3`, `__local_depot12`), which moves when a kernel is added
# before it.
ORDINAL = re.compile(r"(\$L__BB|__local_depot)\d+")


def normalized(path: Path) -> Path:
    out = path.with_suffix(".norm")
    lines = [ORDINAL.sub(r"\1", ANON.sub("ANON", ln)) for ln in path.read_text().splitlines()
             if not ln.startswith("//")]
    out.write_text("\n".join(lines) + "\n")
    return out


FUNCTION = re.compile(r"^(?:\.visible\s+|\.weak\s+)?\.(?:entry|func)\s+(?:\([^)]*\)\s*)?(\w+)")


def functions(path: Path) -> dict:
    """{name: its lines} of a normalized PTX file's functions, and the lines
    before the first under ``""``. A function's trailing blank lines are
    dropped: they depend on what follows it in the unit."""
    out, name = {"": []}, ""
    for line in path.read_text().splitlines():
        m = FUNCTION.match(line)
        if m:
            name = m.group(1)
            out[name] = []
        out[name].append(line)
    for lines in out.values():
        while lines and not lines[-1].strip():
            lines.pop()
    return out


def by_entry(a: Path, b: Path) -> None:
    fa, fb = functions(a), functions(b)
    same = [n for n in fb if n in fa and fa[n] == fb[n]]
    print(f"  by function: {len(same)} of {len(fb)} identical (the header counted as one)")
    for n in fb:
        if n in fa and fa[n] == fb[n]:
            continue
        if n not in fa:
            print(f"  {n or 'header'}: only in this tree, {len(fb[n])} lines")
            continue
        diff = [d for d in difflib.unified_diff(fa[n], fb[n], lineterm="", n=0)
                if d[:1] in "+-" and d[:3] not in ("+++", "---")]
        print(f"  {n or 'header'}: {len(diff)} diff lines, the first: {diff[:4]}")
    for n in fa:
        if n not in fb:
            print(f"  {n or 'header'}: only in {a.parent}, {len(fa[n])} lines")


def main() -> None:
    entries = "--by-entry" in sys.argv[1:]
    if entries:
        sys.argv.remove("--by-entry")
    other = Path(sys.argv[1]).resolve()
    nvcc = _build._nvcc()
    trees = {"other": units_of(other), "this": units_of(_build.CSRC)}
    here, there = set(trees["this"]), set(trees["other"])
    sources = sorted((here & there) & set(sys.argv[2:]) if sys.argv[2:] else here & there)
    for name in sorted(here ^ there):
        print(f"{name}: only in {'this tree' if name in here else other}; not compared")
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name in sources:
            for tag, units in trees.items():
                ptx = Path(tmp) / f"{name}.{tag}.ptx"
                args = _build.source_args(units[name], Path(tmp) / f"{name}.{tag}.cu")
                jobs[name, tag] = (ptx, subprocess.Popen(
                    [nvcc, *ptx_flags(), "-ptx", "-o", str(ptx), *args],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for (name, tag), (_, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on {tag} {name}:\n{out}")
        differ = False
        for name in sources:
            a, b = (normalized(jobs[name, tag][0]) for tag in ("other", "this"))
            diff = subprocess.run(["diff", str(a), str(b)], capture_output=True, text=True).stdout
            n = len(diff.splitlines())
            differ |= n > 0
            print(f"{name}: {len(b.read_text().splitlines())} PTX lines, {n} diff lines against "
                  f"{other}")
            if n and entries:
                by_entry(a, b)
            elif n:
                print("\n".join(diff.splitlines()[:DIFF_LINES_SHOWN]))
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
