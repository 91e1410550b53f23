"""On the card, at each cell's own size: the control (the reference in the
program's place with TF32 on) and the faults planted in the reference are
judged not correct against the cell's limits."""
import pytest

from benchmark import judge, spec
from benchmark.tests.tiny import ROOT
from benchmark.tools import control


@pytest.mark.cuda
@pytest.mark.parametrize("cell", spec.cells(ROOT))
def test_control_and_faults_fail(card, cell):
    limits = spec.cell(ROOT, cell).limits
    got = control.readings(ROOT, cell, 20261018, device=card)
    for variant, _ in control.VARIANTS:
        check = judge.checks(got[variant], limits)
        assert not judge.correct(check), (variant, check)
