"""The comparison fails on the control and on each planted fault, on the CPU at small sizes."""
import importlib

import pytest

from benchmark import faults
from benchmark.tests import tiny


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", sorted(tiny.TINY))
def test_a_planted_fault_is_not_correct(workload, fault):
    from flexs_tpu_torch.runtime import jit_runner

    family = importlib.import_module(
        f"benchmark.families.{tiny.spec(workload).config['family']}")
    result = tiny.rehearse(workload, faults=faults.swaps(fault, family, jit_runner))
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["compared"].values())
    if fault == "far_dists":  # caught by the sampled distances, whatever else moves
        assert result["compared"]["dist_errors"]["value"] > 0


def test_the_tf_binding_control_is_not_correct():
    """The reference's tables in bfloat16 in the program's place: true_scores off the float32 ones."""
    result = tiny.rehearse("tfbind8-adalead-nam.chunk40", control=True)
    assert result["correct"] is False
    assert result["compared"]["oracle_gap"]["value"] > 0
