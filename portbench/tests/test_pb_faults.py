"""Each fault a cell can have, planted under the timed path of a tiny run
(the harness's look for a card skipped), makes ``correct`` false under
the cell's committed limits."""

from __future__ import annotations

import pytest

from portbench import faults, harness
from portbench.tests import tiny

CASES = [(cell, name) for cell in tiny.CELLS
         for name in (faults.SERVING if tiny.cell(cell)["traffic"]["kind"] == "serve"
                      else faults.TRAINING)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_incorrect(cell, fault):
    spec = tiny.cell(cell)
    planted = faults.SERVING if spec["traffic"]["kind"] == "serve" else faults.TRAINING
    r = harness.run_cell(spec, 2**32 + 77, 1.0, False, "cpu", fault=planted[fault])
    assert not r["correct"], r["checks"]
    # refused by what the check compared, not for want of anything to compare
    assert r["numbers"].get("clips_checked", 1) > 0
    assert all(c["value"] is not None for c in r["checks"].values())
