"""The A/B tools' designs of K8b's query forward (`tools/query_ab.py`), of
K9a, the opacity VJP (`tools/render_bwd_ab.py --opacity`), of K14a, the
subset gather (`tools/subset_gather_ab.py`), of K8a with its box form
(`tools/construct_tree_ab.py`), of K10's backward (`tools/warp_bwd_ab.py`),
of K11's forward (`tools/voxelize_ab.py`), of K13a+K13b, the tape
recorder's walks (`tools/tape_record_ab.py`), of K12, the dense-grid
weight pass (`tools/grid_ab.py`), and of K8b's query backward
(`tools/query_bwd_ab.py`), on the CPU: the kernels
build only on a card, but each design is a text patch of the shipped
source, and the designs that lost live in `tools/*_designs.cuh`.

  * every design's patches apply to the header as it is (each exactly
    once), and a design that launches a lost kernel finds it in the
    designs file;
  * the opacity designs file's levers default to the shipped kernel's, and
    each design sets the levers it names; the K10 and K11 designs files
    define no lever of their own sources, whose levers the plain mirrors
    (`ops/warp.py`, `ops/p2v.py`) repeat;
  * `chip_smoke.query_fwd_work`, the query forward's bytes and operations
    that the smoke's phase 6 and `tools/query_ab.py` count, on a small case,
    and `chip_smoke.subset_gather_bytes`, K14a's, likewise; `chip_smoke.grid_bounds`,
    K12's, on a census.
"""

import re
import sys
from pathlib import Path

import pytest

TOOLS = Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))

import construct_tree_ab  # noqa: E402
import grid_ab  # noqa: E402
import query_ab  # noqa: E402
import query_bwd_ab  # noqa: E402
import render_bwd_ab  # noqa: E402
import render_fwd_ab  # noqa: E402
import subset_gather_ab  # noqa: E402
import tape_record_ab  # noqa: E402
import voxelize_ab  # noqa: E402
import warp_bwd_ab  # noqa: E402

import chip_smoke  # noqa: E402
from svox_t_tpu_torch import _build  # noqa: E402
from svox_t_tpu_torch.ops import p2v as p2v_ops  # noqa: E402
from svox_t_tpu_torch.ops import warp as warp_ops  # noqa: E402


@pytest.mark.parametrize("design", sorted(query_ab.DESIGNS))
def test_query_design_patches_apply(tmp_path, design):
    sources = query_ab.design_sources(tmp_path, None, {design: query_ab.DESIGNS[design]})
    text = (sources[design] / query_ab.HEADER).read_text()
    assert (sources[design] / "query_designs.cuh").exists()
    if design in ("p2", "bulk"):
        assert f"return launch_{design}<T, U, kD>(a, stream);" in text
        assert "query_fwd_kernel<T, U, kD><<<" not in text
        assert f"cudaError_t launch_{design}(" in (TOOLS / "query_designs.cuh").read_text()
    if design == "no_copy":
        assert "copy_rows<T, U, kD>(a, idx" not in text


def _spliced(tmp_path, design):
    sources, alias = render_fwd_ab.design_sources(
        tmp_path, None, {design: render_bwd_ab.OPACITY_DESIGNS[design]}, render_bwd_ab.BWD_UNITS, "render_bwd.cuh")
    return (sources[design][0] / "render_bwd.cuh").read_text()


# {design: (kOpReuse, kOpLoop, kOpSkip) as the spliced text sets them}.
OPACITY_LEVERS = {
    "none": ("0", "0", "false"),
    "reuse": (render_bwd_ab.REUSE_LEVERS, "0", "false"),
    "reuse1": ("svox::kInterp ? 1 : 0", "0", "false"),
    "loop1": ("0", "1", "false"),
    "loop2": ("0", "2", "false"),
    "skip": (render_bwd_ab.REUSE_LEVERS, render_bwd_ab.LOOP_LEVERS, "true"),
}


@pytest.mark.parametrize("design", sorted(OPACITY_LEVERS))
def test_opacity_design_sets_its_levers(tmp_path, design):
    text = _spliced(tmp_path, design)
    reuse, loop, skip = OPACITY_LEVERS[design]
    assert f"constexpr int kOpReuse = {reuse};" in text
    assert f"constexpr int kOpLoop = {loop};" in text
    assert f"constexpr bool kOpSkip = {skip};" in text
    assert text.count("opacity_bwd_kernel(const Params<S> p)") == 1
    assert "return cudaErrorInvalidValue;" in text and render_bwd_ab.K3_SWITCH not in text


def test_opacity_designs_file_defaults_are_the_shipped_levers(tmp_path):
    designs = (TOOLS / "opacity_designs.cuh").read_text()
    assert f"constexpr int kOpReuse = {render_bwd_ab.REUSE_LEVERS};" in designs
    assert f"constexpr int kOpLoop = {render_bwd_ab.LOOP_LEVERS};" in designs
    assert "constexpr bool kOpSkip = false;" in designs
    shipped = _spliced(tmp_path, "shipped")
    k9a = shipped.split("// K9a: the opacity VJP (see")[1]
    assert "kOpSkip" not in shipped and "svox::sample_corners(" not in k9a


def test_query_fwd_work_counts_bytes_and_levels():
    # 10 points, 6 rows of 4 float32 values, 25 levels: points and entries
    # 20 bytes a point, 6 rows read, 10 rows and 8 bytes of ids written.
    n_bytes, n_ops = chip_smoke.query_fwd_work(10, 6, 4, 4, 25)
    assert n_bytes == 10 * 20 + 6 * 16 + 10 * 16 + 10 * 8
    assert n_ops == chip_smoke.OPS_LEVEL * 25
    assert chip_smoke.query_fwd_work(10, 6, 4, 2, 25)[0] == 10 * 20 + 6 * 8 + 10 * 8 + 10 * 8


@pytest.mark.parametrize("design", sorted(subset_gather_ab.DESIGNS))
def test_subset_gather_design_patches_apply(tmp_path, design):
    sources = subset_gather_ab.design_sources(tmp_path, None, {design: subset_gather_ab.DESIGNS[design]})
    csrc, units = sources[design]
    text = (csrc / subset_gather_ab.SOURCE).read_text()
    assert units == ("tape_subset",) and (csrc / subset_gather_ab.DESIGN_FILE).exists()
    if design in ("thread", "runtime"):
        assert f"return launch_{design}(a, stream);" in text
        assert f'#include "{subset_gather_ab.DESIGN_FILE}"' in text
        assert f"cudaError_t launch_{design}(" in (TOOLS / subset_gather_ab.DESIGN_FILE).read_text()
    if design == "b256":
        assert "constexpr int kGatherThreads = 256;" in text


@pytest.mark.parametrize("design", sorted(construct_tree_ab.DESIGNS) + sorted(construct_tree_ab.BOX_DESIGNS))
def test_construct_tree_design_patches_apply(tmp_path, design):
    patches = {**construct_tree_ab.DESIGNS, **construct_tree_ab.BOX_DESIGNS}[design]
    sources = construct_tree_ab.design_sources(tmp_path, None, {design: patches})
    csrc, units = sources[design]
    text = (csrc / "construct_tree.cu").read_text()
    assert units == (construct_tree_ab.BOX_UNITS if design == "shipped" else construct_tree_ab.UNIT)
    if design == "box_census":
        assert text.count("atomicAdd(&g_box_atomics, 1u);") == 2
        assert 'extern "C" unsigned int svox_box_atomics()' in text
    if design == "box_early":
        assert text.count("__ldcg(box + ") == 1 and "const float now = threadIdx.x < 6" in text
    if design in ("box_noatomic", "box_nodiv"):
        assert ("atomic_min_float(box" in text) == (design == "box_nodiv")
        assert ("static_cast<float>(c[a]) / cube[k]" in text) == (design == "box_noatomic")


def test_subset_gather_bytes_counts_streams():
    B, n = 7, 100
    base = B * 4 + (B + 1) * 4 + B * 8 + n * 16 + B * 16 + B * 20
    assert chip_smoke.subset_gather_bytes(B, n) == base
    assert chip_smoke.subset_gather_bytes(B, n, t=True, cell=True) == base + n * 16
    assert chip_smoke.subset_gather_bytes(B, n, rays=True) == base + B * 48


def _design_text(tool, tmp_path, design):
    sources = warp_bwd_ab.design_sources(tmp_path, None, {design: tool.DESIGNS[design]}, tool.SOURCE,
                                         tool.DESIGN_FILE, tool.UNIT)
    csrc, units = sources[design]
    assert units == tool.UNIT and (csrc / tool.DESIGN_FILE).exists()
    return (csrc / tool.SOURCE).read_text()


@pytest.mark.parametrize("design", sorted(warp_bwd_ab.DESIGNS))
def test_warp_bwd_design_patches_apply(tmp_path, design):
    text = _design_text(warp_bwd_ab, tmp_path, design)
    spliced = f'#include "{warp_bwd_ab.DESIGN_FILE}"' in text
    assert spliced == (design in ("tile", "slot_flush", "lane_flush"))
    designs = (TOOLS / warp_bwd_ab.DESIGN_FILE).read_text()
    if design == "tile":
        assert "  return launch_tile(p, g, smem, vec_bones, stream);" in text
        assert "cudaError_t launch_tile(" in designs
    if design in ("slot_flush", "lane_flush"):
        name = {"slot_flush": "cache_flush_slots", "lane_flush": "cache_flush_lanes"}[design]
        assert f"    {name}(c, table);" in text and f"void {name}(" in designs
    if design in ("r4", "r16"):
        assert f"constexpr int kRun = {design[1:]};" in text
    if design == "no_adds":
        assert "cache_add(c, table," not in text
    if design == "scalar":
        assert "const bool vec_bones = false;" in text and "dx, dw, false, false};" in text
    if design == "stride256":
        assert "const int q = q0 + r * kThreads;" in text
    if design == "evict_lane":
        assert "warp_flush<1>(out, vs, table);" not in text
    if design == "lb3":
        assert "__launch_bounds__(kThreads, 3)\nwarp_bwd_kernel(" in text


@pytest.mark.parametrize("design", sorted(voxelize_ab.DESIGNS))
def test_voxelize_design_patches_apply(tmp_path, design):
    text = _design_text(voxelize_ab, tmp_path, design)
    if design in ("gather", "pairs", "no_atomics"):
        assert f"  return launch_{design}(a, vol, tiled, stream);" in text
        assert f'#include "{voxelize_ab.DESIGN_FILE}"' in text
        assert f"cudaError_t launch_{design}(" in (TOOLS / voxelize_ab.DESIGN_FILE).read_text()
        assert text.count("namespace {") == text.count("}  // namespace") == 2
    if design.startswith("cap"):
        assert ("constexpr int kTileFloats = 8192;" in text) == (design == "cap8k")
    if design == "full_walk":
        assert "if (s > a.cr2) continue;" not in text and "      if (true) {" in text


def test_warp_p2v_designs_files_defaults_are_the_shipped_levers():
    warp = (_build.CSRC / "warp.cu").read_text()
    p2v = (_build.CSRC / "p2v.cu").read_text()
    assert f"constexpr int kThreads = {warp_ops.RUN_BLOCK};" in warp
    assert f"constexpr int kRun = {warp_ops.RUN_POINTS};" in warp
    assert f"constexpr int kSlots = {warp_ops.RUN_SLOTS};" in warp
    assert f"constexpr int kThreads = {p2v_ops.TILE_BLOCK};" in p2v
    assert f"constexpr int kTileFloats = {p2v_ops.TILE_FLOATS};" in p2v
    for name, levers in (("warp_designs.cuh", ("kThreads", "kRun", "kSlots", "kRowStride")),
                         ("p2v_designs.cuh", ("kThreads", "kTileFloats"))):
        designs = (TOOLS / name).read_text()
        assert not any(f"constexpr int {lever} =" in designs for lever in levers)
    # The shipped sources carry only what ships.
    assert "tile_kernel" not in warp and "gather" not in p2v and "no_atomics" not in p2v


# {design: the kernels of tools/tape_record_designs.cuh it launches or walks with}.
TAPE_RECORD_LOST = {"runtime": ("launch_stage_runtime", "launch_copy_runtime"), "loop1": ("walk_rotated",),
                    "scalar": ("launch_stage_scalar",),
                    "warp": ("launch_stage_warp", "launch_copy_warp"), "stop": ("record_stop_kernel",),
                    "resume": ("count_resume_kernel", "record_resume_kernel")}


@pytest.mark.parametrize("design", sorted(tape_record_ab.DESIGNS))
def test_tape_record_design_patches_apply(tmp_path, design):
    sources = tape_record_ab.design_sources(tmp_path, None, {design: tape_record_ab.DESIGNS[design]})
    csrc, units = sources[design]
    assert units == tape_record_ab.UNITS and (csrc / tape_record_ab.DESIGN_FILE).exists()
    text = (csrc / tape_record_ab.HEADER).read_text()
    designs = (TOOLS / tape_record_ab.DESIGN_FILE).read_text()
    lost = TAPE_RECORD_LOST.get(design, ())
    assert (f'#include "{tape_record_ab.DESIGN_FILE}"' in text) == bool(lost)
    for name in lost:
        assert f"{name}<S>" in text or f"{name}(p, i, r," in text
        assert re.search(rf"\b{name}\(", designs)
    shipped = (_build.CSRC / tape_record_ab.HEADER).read_text()
    assert not any(name in shipped for names in TAPE_RECORD_LOST.values() for name in names)
    if design == "no_stores":
        assert "    if (true) return;\n    const int32_t q = chunk * kChunk + e0;" in text
    if design.startswith("flush"):
        assert f"constexpr int kFlush = {design[5:]};" in text
    if design in tape_record_ab.CHUNKS:
        assert f"constexpr int kChunk = {tape_record_ab.CHUNKS[design]};" in text
    if design in ("shipped", "pair"):
        assert text == shipped


@pytest.mark.parametrize("design", sorted(grid_ab.DESIGNS))
def test_grid_design_patches_apply(tmp_path, design):
    """Each K12 design's patches apply once to grid.cu; a spliced design
    includes `tools/grid_designs.cuh` inside the anonymous namespace and
    launches a kernel or launcher that file defines, in place of the
    shipped march's 32-bit launch; a brick design sets the brick its mask
    is sized for; only ``rows`` launches with no row width."""
    sources = grid_ab.design_sources(tmp_path, None, {design: grid_ab.DESIGNS[design]})
    csrc, units = sources[design]
    text = (csrc / grid_ab.SOURCE).read_text()
    assert units == ("grid",) and (csrc / grid_ab.DESIGN_FILE).exists()
    brick = grid_ab.DESIGNS[design][1]
    assert f"constexpr int kBrick = {brick};" in text
    designs_text = (TOOLS / grid_ab.DESIGN_FILE).read_text()
    if design in ("ahead", "smem"):
        include = text.index(f'#include "{grid_ab.DESIGN_FILE}"')
        assert include < text.index("}  // namespace")
        assert grid_ab.LAUNCH not in text
        name = {"ahead": "grid_kernel_ahead", "smem": "launch_smem"}[design]
        assert f"{name}<kBrick, int>" in text and re.search(rf"\b{name}\(", designs_text)
    else:
        assert f'#include "{grid_ab.DESIGN_FILE}"' not in text
    assert (design in grid_ab.ROWS) == (design == "rows")


def test_grid_bounds_count_bytes_and_operations():
    """The whole call writes both grids; the march reads the rays, the mask
    and the marked voxels and writes only the contributing voxels' two
    words (read and written by its atomics), the fill being the wrapper's."""
    census = dict(rays=10, samples=100, voxels=50, voxels_marked=7, contrib=20, voxels_contrib=5, reso=16,
                  brick=8)
    b = chip_smoke.grid_bounds(census)
    mask = 4 * 1
    assert b["grid_pass"]["bound_bytes"] == 10 * 24 + 50 * 4 + 2 * 16 ** 3 * 4
    assert b["grid_occupancy"]["bound_bytes"] == 16 ** 3 * 4 + mask
    assert b["grid_weight"]["bound_bytes"] == 10 * 24 + mask + 7 * 4 + 5 * 16
    ops = chip_smoke.OPS_GRID_SAMPLE * 100 + chip_smoke.OPS_GRID_CONTRIB * 20
    assert b["grid_pass"]["bound_ops"] == b["grid_weight"]["bound_ops"] == ops


@pytest.mark.parametrize("design", sorted(query_bwd_ab.DESIGNS))
def test_query_bwd_design_patches_apply(tmp_path, design):
    """Each K8b backward design's patches apply once to query_bwd.cuh or to
    `tools/query_bwd_designs.cuh`: the header's designs keep the shipped
    launch; a spliced design includes the designs file before the shipped
    launcher and returns its own launch in place of the shipped kernel's,
    and its patches of the rows kernel land in the designs file; every run
    names a library, and the libraries that add into zeros are the walks'."""
    sources = query_bwd_ab.design_sources(tmp_path, None, {design: query_bwd_ab.DESIGNS[design]})
    csrc, units = sources[design]
    text = (csrc / query_bwd_ab.HEADER).read_text()
    extra = (csrc / query_bwd_ab.DESIGN_FILE).read_text()
    assert units == ("query", "query_bf16")
    shipped = "query_bwd_kernel<T, kW, kD><<<" in text
    assert "owner[" not in (query_bwd_ab._build.CSRC / query_bwd_ab.HEADER).read_text()
    if design in ("shipped", "t128"):
        assert shipped and f'#include "{query_bwd_ab.DESIGN_FILE}"' not in text
        assert ("kQueryBwdThreads = 128;" in text) == (design == "t128")
    else:
        assert not shipped and f"  return launch_{design if design in ('rows4', 'lane', 'points', 'flat') else 'dense'}" \
            f"<T, kW, kD>(a, stream);" in text
        assert text.index(f'#include "{query_bwd_ab.DESIGN_FILE}"') < text.index("cudaError_t launch_query_bwd_walk(")
    assert ("__stcs(out + u, v);" in extra) == (design == "stcs")
    assert ("if (__ballot_sync(0xffffffffu, own >= 0) == 0) {" in extra) == (design == "zfast")
    assert ("  const int32_t own = -1;\n" in extra) == (design == "zeros")
    assert {lib for lib, _ in query_bwd_ab.RUNS.values()} == set(query_bwd_ab.DESIGNS)
    assert query_bwd_ab.ZEROED - {"parent"} == {"shipped", "t128", "lane", "points"}
