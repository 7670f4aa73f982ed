"""On the card: the program comes out correct and the control does not, on
each configuration, at a reduced batch of the cells' own frame sizes
(benchmark/control.py reads both at the cells' full size).

    python -m pytest -q -p no:cacheprovider -m card benchmark/tests/test_bench_control_card.py
"""

import pytest

from benchmark import check, control, harness

CONTROL = "reference_tf32_values"
CELLS = {"homography_charbonnier.bulk_b1024_584x388": 128,
         "euclidean_quadratic.clip_b64_1080p": 16}


def reduced(name):
    cell = harness.load_cell(name)
    cell.mix = dict(cell.mix, batch=CELLS[name], pool=2)
    return cell


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CELLS))
def test_program_is_correct_and_control_is_not(name, card):
    port = __import__(harness.PORT)
    cell = reduced(name)
    lims = check.limits(name)
    for seed in (11, 12):
        prog = control.readings(cell, port, seed, None, card)
        ok, checks = check.judge(prog, lims)
        assert ok, checks
        ctl = control.readings(cell, port, seed, CONTROL, card)
        ok, checks = check.judge(ctl, lims)
        assert not ok, checks
