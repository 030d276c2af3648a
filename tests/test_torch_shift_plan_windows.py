"""The shift kernels' staging plan on the CPU: the plan's windows, its
masked slices, the delay phases' ring plans and the staged emulation
(the cases and what they check: ``tests/torch_shift_plan_cases.py``)."""

import pytest

import torch_shift_plan_cases as C


@pytest.mark.parametrize("max_tile", C.TILES)
@pytest.mark.parametrize("n", C.NS)
@pytest.mark.parametrize("mode", C.MODES)
def test_windows_cover_every_direction(mode, n, max_tile):
    C.windows_cover_every_direction(mode, n, max_tile)


@pytest.mark.parametrize("max_tile", C.TILES)
@pytest.mark.parametrize("n", C.NS)
@pytest.mark.parametrize("mode", C.MODES)
def test_staged_emulation_matches_plain_and_reference(mode, n, max_tile):
    C.staged_emulation_matches_plain_and_reference(mode, n, max_tile)


@pytest.mark.parametrize("max_tile", C.LIVE_TILES)
@pytest.mark.parametrize("n", C.NS)
@pytest.mark.parametrize("mode", C.MODES)
def test_masked_plan_places_the_liveness_slices(mode, n, max_tile):
    C.masked_plan_places_the_liveness_slices(mode, n, max_tile)


def test_ring_plans_of_the_delay_phases_keep_the_tile():
    C.ring_plans_of_the_delay_phases_keep_the_tile()
