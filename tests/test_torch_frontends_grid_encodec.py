"""The port's engine measures musicgen-medium-bench (encodec: 4 codebooks, the (4, V, D) tables sharded on
the vocab) at train_s, prefill_s and decode_s
under dp, fsdp, tp and ep on both bench meshes with no failed trace, to the
reference's kinds or a listed difference and its useful-FLOP ratio
(``tests/frontends_grid.py``)."""
import pytest

import frontends_grid as grid

ARCH = "musicgen-medium"
POINTS = grid.points(ARCH)[1]


@pytest.fixture(scope="module")
def measured():
    return grid.measure(ARCH)


def test_grid_is_the_reference_table():
    grid.check_table(ARCH)


@pytest.mark.parametrize("i", range(len(POINTS)), ids=grid.ids(POINTS))
def test_point_traces_to_the_reference_kinds(measured, i):
    grid.check_point(ARCH, measured, i)
