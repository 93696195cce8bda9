"""The low-precision control at each cell's own size, on the card: the
program served at M8 (one limb: the next precision below the cells' M16)
has to come out not correct."""
import pytest

import readings


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["phi3mini-decode-m16", "phi35moe-decode-m16"])
def test_m8_control_is_not_correct(cuda, workload):
    (got,) = readings.readings(workload, [2**31 + 101], 20.0, "M8")
    assert not got["correct"], got
