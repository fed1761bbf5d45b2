"""Compare the PTX of the nearest-mode march sources with another copy of
the kernel sources, on a machine with nvcc.

    python3 tools/ptx_parity.py OTHER_CSRC_DIR

OTHER_CSRC_DIR holds another version of `svox_t_tpu_torch/csrc` (for
example the parent commit's, unpacked with `git archive`). The six
nearest-mode sources, `render_{fwd,bwd,aux}{,_baked}.cu`, are compiled to
PTX from both directories with the build's code-generation flags, all at
once. Anonymous-namespace names (they hash the file's path) and comment
lines are normalized away; the script prints each source's PTX lines and
how many lines differ, and exits nonzero if any source differs.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from svox_t_tpu_torch import _build  # noqa: E402

SOURCES = ("render_fwd", "render_fwd_baked", "render_bwd", "render_bwd_baked", "render_aux",
           "render_aux_baked")
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_[0-9]+_\w+?_cu_[0-9a-f]+")


def ptx_flags() -> list:
    """The build's flags, with one PTX target instead of the SASS one and
    without the ptxas report."""
    flags = list(_build.NVCC_FLAGS)
    for flag in ("-gencode", "-Xptxas"):
        i = flags.index(flag)
        del flags[i:i + 2]
    return ["-arch=sm_90a", *flags]


def normalized(path: Path) -> Path:
    out = path.with_suffix(".norm")
    lines = [ANON.sub("ANON", ln) for ln in path.read_text().splitlines() if not ln.startswith("//")]
    out.write_text("\n".join(lines) + "\n")
    return out


def main() -> None:
    other = Path(sys.argv[1]).resolve()
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name in SOURCES:
            for tag, csrc in (("other", other), ("this", _build.CSRC)):
                ptx = Path(tmp) / f"{name}.{tag}.ptx"
                jobs[name, tag] = (ptx, subprocess.Popen(
                    [nvcc, *ptx_flags(), "-ptx", "-o", str(ptx), str(csrc / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for (name, tag), (_, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on {tag} {name}.cu:\n{out}")
        differ = False
        for name in SOURCES:
            a, b = (normalized(jobs[name, tag][0]) for tag in ("other", "this"))
            diff = subprocess.run(["diff", str(a), str(b)], capture_output=True, text=True).stdout
            n = len(diff.splitlines())
            differ |= n > 0
            print(f"{name}: {len(b.read_text().splitlines())} PTX lines, {n} diff lines against "
                  f"{other}")
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
