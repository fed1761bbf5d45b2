"""The motion-feature marches' vector widths (K9c and K9d,
`csrc/render_aux.cuh`) on the CPU, where no kernel runs:

  * `mf_width`, the width a launch takes: 4 (a sample's LBS rows in one
    float4 and one int4 load, the joint table from a shared copy in
    float4s, the output or grad_out row in float4s) where there are 4
    bones, Kd is a multiple of 4, the skinning weights, joint indices and
    K9c's output (K9d's grad_out) lie on 16 bytes and the shared tables
    (K9d: the gradient table too) fit in `KERNEL_MF_VECTOR_SMEM`; else 1;
  * the override (``width=`` of the wrappers): 1 always, 4 only where the
    rule gives 4, anything else raises;
  * the budget is the header's (`kSmemBudget`).
"""

import re

import pytest

from svox_t_tpu_torch import _build
from svox_t_tpu_torch.ops import render_aux as taux

# (J, Kd, nb, backward, offsets in bytes of (sw, ji, out or grad_out), want).
WIDTH_CASES = [
    (32, 16, 4, False, (0, 0, 0), 4), (32, 16, 4, True, (0, 0, 0), 4),
    (32, 8, 4, True, (16, 32, 48), 4), (7, 4, 4, False, (0, 0, 0), 4),
    (32, 16, 5, False, (0, 0, 0), 1), (32, 16, 1, True, (0, 0, 0), 1),
    (32, 3, 4, False, (0, 0, 0), 1), (32, 18, 4, True, (0, 0, 0), 1),
    (32, 16, 4, False, (4, 0, 0), 1), (32, 16, 4, True, (0, 8, 0), 1),
    (32, 16, 4, True, (0, 0, 4), 1), (32, 16, 4, False, (0, 0, 12), 1),
    # The shared tables at the budget: K9c's joint table of rows 20 (Kd 16)
    # or 36 (Kd 32) floats; K9d's with its gradient table of rows Kd | 1.
    (512, 16, 4, False, (0, 0, 0), 4), (513, 16, 4, False, (0, 0, 0), 1),
    (284, 32, 4, False, (0, 0, 0), 4), (285, 32, 4, False, (0, 0, 0), 1),
    (200, 16, 4, True, (0, 0, 0), 4), (300, 16, 4, True, (0, 0, 0), 1),
    (372, 32, 4, True, (0, 0, 0), 1),
]


@pytest.mark.parametrize("J,kd,nb,backward,offs,want", WIDTH_CASES)
def test_mf_width_rule(J, kd, nb, backward, offs, want):
    ptrs = tuple(1 << 20 | o for o in offs)
    assert taux.mf_width(J, kd, nb, backward, ptrs) == want


def _args(J, kd, nb, sw_off=0):
    """The tail of `_mf_kernel_args`' arguments: (joint table, J, Kd,
    skinning weights, joint indices, nb)."""
    return (0, J, kd, (1 << 20) + sw_off, 1 << 21, nb)


@pytest.mark.parametrize("backward", [False, True])
def test_mf_width_override(backward):
    """No override takes the rule's width; 1 is always taken; 4 only
    where the rule gives 4; any other value raises."""
    row = 1 << 22
    for args, rule in ((_args(32, 16, 4), 4), (_args(32, 16, 4, sw_off=4), 1), (_args(32, 16, 5), 1)):
        assert taux._mf_launch_width(args, backward, row, None) == rule
        assert taux._mf_launch_width(args, backward, row, 1) == 1
        if rule == 4:
            assert taux._mf_launch_width(args, backward, row, 4) == 4
        else:
            with pytest.raises(ValueError, match="width 4 takes"):
                taux._mf_launch_width(args, backward, row, 4)
    for bad in (0, 2, 3, 8, "4", 4.0, True):
        with pytest.raises(ValueError, match="must be 1 or 4"):
            taux._mf_launch_width(_args(32, 16, 4), backward, row, bad)


def test_mf_vector_budget_is_the_headers():
    text = (_build.CSRC / "render_aux.cuh").read_text()
    m = re.search(r"constexpr size_t kSmemBudget = (\d+) \* 1024;", text)
    assert m and int(m.group(1)) * 1024 == taux.KERNEL_MF_VECTOR_SMEM
    assert "constexpr int row_stride(int kd) { return 4 * (((kd + 3) / 4) | 1); }" in text
    assert "constexpr int table_floats(int J, int kd) { return (J * table_stride(kd) + 3) / 4 * 4; }" in text
