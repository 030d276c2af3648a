"""The shift kernels' staging plan on the CPU: the ring plan's emulation,
circulant directions, and past a group of rows (the cases and what they
check: ``tests/torch_shift_plan_cases.py``)."""

import pytest

import torch_shift_plan_cases as C


@pytest.mark.parametrize("max_tile", C.TILES)
@pytest.mark.parametrize("n", C.NS)
@pytest.mark.parametrize("mode", ("circulant",))
def test_ring_emulation_matches_plain_and_reference(mode, n, max_tile):
    C.ring_emulation_matches_plain_and_reference(mode, n, max_tile)


@pytest.mark.parametrize("n", (65539, 1 << 20))
def test_ring_emulation_past_a_group(n):
    C.ring_emulation_past_a_group(n)
