"""On the card: the program passes each one-card cell's comparison and the
lower-precision control (the reference one precision step lower, in the
program's place) does not, nor does a planted training fault.  A short window of
the cell's own loop at its own sizes.  Run on a machine with the card:
``python -m pytest benchmark/tests/test_bench_controls.py -q``."""

import pytest
import torch

from benchmark.harness import judge, spec

ONE_CARD = [w["name"] for w in spec.load_json(spec.SPEC_FILE)["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CARD)
def test_the_control_and_the_faults_come_out_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the program runs at the cell's sizes on CUDA")
    cell = spec.find_cell(workload)
    loop = spec.loop_module(cell.traffic["loop"])
    kinds = set()
    for kind, numbers in loop.readings(cell, 2**31 + 11, 1.0, control=True):
        kinds.add(kind)
        # A control or fault reports the numbers it can fail (no exact ones).
        limits = {k: v for k, v in cell.limits.items() if k in numbers}
        assert judge.verdict(numbers, limits)[0] is (kind == "program"), (kind, numbers)
    assert "program" in kinds and "control" in kinds
