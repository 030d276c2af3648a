"""The shift kernels' staging plan on the CPU: the masked exchange's
emulation (the cases and what they check:
``tests/torch_shift_plan_cases.py``)."""

import pytest

import torch_shift_plan_cases as C


@pytest.mark.parametrize("max_tile", C.LIVE_TILES)
@pytest.mark.parametrize("n", C.NS)
@pytest.mark.parametrize("mode", C.MODES)
def test_masked_emulation_matches_plain_and_reference(mode, n, max_tile):
    C.masked_emulation_matches_plain_and_reference(mode, n, max_tile)
