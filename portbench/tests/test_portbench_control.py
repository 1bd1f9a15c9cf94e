"""The reference with float8 weights put in the program's place, which sets
the limits' upper readings, reads far above the program.  On the CPU at the
tiny size (the mechanism); on the card at the cell's own size, against the
cell's limits (marked `cuda`)."""
import math

import pytest

from portbench import harness
from portbench.tests.conftest import run_tiny


def test_portbench_control_reads_far_above_the_program_tiny():
    out, _ = run_tiny(seed=31, hooks={"fp8_reference": True})
    assert set(out.fp8_reference) == set(out.compared)
    for k, v in out.compared.items():
        assert out.fp8_reference[k] > 100 * max(v, 1e-9), (k, v, out.fp8_reference[k])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vv1.5b-podcast-b8"])
def test_portbench_control_fails_the_cell_on_the_card(cuda_device, workload):
    cell = harness.resolve(workload)
    out = harness.execute(harness.Run(cell, 2 ** 31 + 5, 2.0, False, cuda_device,
                                      {"fp8_reference": True}))
    assert all(ok for *_, ok in harness.judge(out.compared, cell.limits))
    assert not all(ok for *_, ok in harness.judge(out.fp8_reference, cell.limits))
    assert all(math.isfinite(v) for v in out.fp8_reference.values())
