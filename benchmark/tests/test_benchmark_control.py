"""The check's control and its planted faults come out not correct.

At tiny sizes on the CPU: the reference one precision below the
configuration's, put in the program's place, and each fault planted under
the program's timed path, each fail at least one compared number, while the
sound program passes them all. ``python3 -m benchmark.control`` reads the
same at a cell's own size on the card."""

from __future__ import annotations

import pytest

from benchmark import control
from benchmark.tests.conftest import tiny

CELLS = ["fastppo-mlp512-ray21.train64k", "pixelppo-conv32-ray21.train16k",
         "fastppo-mlp512-ray21.rollout16k"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("what", ("control",) + control.FAULTS)
def test_the_control_and_each_fault_fail_the_check(bench, workload, what):
    r = control.reading(tiny(bench, workload), what, 2**31 + 99, "cpu")
    assert r["fails"], r


@pytest.mark.parametrize("workload", CELLS)
def test_the_sound_program_passes_the_check(bench, workload):
    r = control.reading(tiny(bench, workload), "sound", 2**31 + 99, "cpu")
    assert not r["fails"], r
