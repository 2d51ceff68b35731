"""Kernel #1's frozen work counts against hand counts and the program's
own layout at a small shape."""

import pytest

from harness import counts


def test_hand_counts_p2_222_b2():
    # nd = 3 p (p + 1)^2 = 54, C = 3 p^3 = 24; sx = 9, sy = 3,
    # L0 = 9 + 3 + 1 + 1 = 14 -> Lp 128; Lu = round128(128 + 12) + 128.
    assert counts.kernel1_layout(2, (2, 2, 2)) == (128, 384)
    assert counts.kernel1_ops(2, (2, 2, 2), 2) == 2 * 54 * 54 * 8 * 2
    assert counts.kernel1_bytes(2, (2, 2, 2), 2) == \
        (2 * 2 * 24 * 384 + 54 * 54 + 128) * 8


def test_main_path_bound():
    # The driven shape of the kernel table: p = 3, 10^3, B = 16, bound by
    # its bytes at 0.0104 ms.
    t = counts.kernel1_bound_s(3, (10, 10, 10), 16)
    assert t == pytest.approx(34_680_832 / 3.35e12)
    assert round(t * 1e3, 4) == 0.0104


@pytest.mark.parametrize("p,shape", [(2, (2, 2, 2)), (3, (10, 10, 10)),
                                     (3, (4, 5, 6)), (4, (3, 3, 3))])
def test_layout_matches_program(p, shape):
    from palace_torch.ops.structured_kernel import _flat_tables

    _, _, _, _, Lp, Lu, _ = _flat_tables(p, shape)
    assert counts.kernel1_layout(p, shape) == (Lp, Lu)
