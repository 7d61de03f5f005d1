"""On the card: the control (the reference in the precision below the
cell's, put in the program's place) comes out not correct under each
cell's committed limits, while the program at the same size comes out
correct.  The serving cells run a sixteenth of the tile here; the
training cells their whole shape with a one-second window.

    pytest portbench -m card
"""

from __future__ import annotations

import pytest

from portbench import check, harness, registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    spec = registry.cell(cell)
    if spec["traffic"]["kind"] == "serve":
        spec["traffic"].update(clients=132, keep_share=0.25)
    r = harness.run_cell(spec, 2**31 + 99, 2.0, False, card, readings=True)
    assert r["correct"], r["checks"]
    n = r["numbers"]
    control = ({"max_logit_gap": n["control_gap"]} if "control_gap" in n else n["control"])
    ok, checks = check.verdict({**n, **control}, spec["limits"])
    assert not ok, checks
