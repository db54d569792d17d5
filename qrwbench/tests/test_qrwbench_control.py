"""The comparison that decides `correct` fails what it has to: the
control (the plain references at TF32 precision in the port's place)
and each fault that a cell can have, planted under the timed path of a
whole run with the look for a card skipped. CPU, tiny sizes."""

import pytest
from _pytest.monkeypatch import MonkeyPatch

from qrwbench import control
from qrwbench.tests import faults
from qrwbench.tests.helpers import TINY, bench, run_tiny, torch_threads, \
    workload


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_is_not_correct(name):
    torch_threads()
    got = control.readings(bench(), workload(name), 11, 1, "cpu",
                           TINY[name])
    lim = got["limits"]
    assert all(got["program"][k] <= v for k, v in lim.items()), got
    assert any(got["control"][k] > v for k, v in lim.items()), got


@pytest.mark.parametrize("name,fault", [
    (name, f) for name, fs in sorted(faults.BY_CELL.items()) for f in fs],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_planted_fault_is_not_correct(name, fault):
    mp = MonkeyPatch()
    try:
        fault(mp)
        res, checks = run_tiny(name, seconds=0.3)
    finally:
        mp.undo()
    assert not res["correct"], checks


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(TINY))
def test_control_on_the_card(card, name):
    """The same on the card, at the tiny size (the card's kernels and
    the references on CUDA tensors)."""
    w = workload(name)
    over = dict(TINY[name])
    if name == "trot-mpc-rolled":
        over.update(per_phase=512)
    if name == "hetero-fleet":
        over.update(batch=384, tile=128)
    got = control.readings(bench(), w, 11, 1, card, over)
    lim = got["limits"]
    assert all(got["program"][k] <= v for k, v in lim.items()), got
    assert any(got["control"][k] > v for k, v in lim.items()), got


def test_the_harness_refuses_the_cpu():
    from qrwbench import run
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "trot-fullsize-ns", "--seed", "1",
                     "--seconds", "1"]) == 2
