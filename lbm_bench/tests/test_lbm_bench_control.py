"""The control comes out not correct, at a size a test run holds: on the
tiny float32 4-level case and the tiny float32 level the program with its
bf16 storage switched on, in the program's place and held to its
configuration's limits, while the program's own readings hold them
(`control.readings`, as on the card)."""

import json
import os

import pytest

from lbm_bench import compare, control, harness


def _limits(config):
    with open(os.path.join(harness.HERE, "configs", config, "limits.json")) as fh:
        return json.load(fh)["limits"]


@pytest.mark.parametrize("case, traffic, config", [
    ("tiny_case", "tiny_traffic", "sphere_re10m"),
    ("tiny_row", "row_traffic", "sphere_64m_row"),
])
def test_the_control_fails_and_the_program_holds(case, traffic, config, request):
    case_dir = request.getfixturevalue(case)
    traffic = request.getfixturevalue(traffic)
    limits = _limits(config)
    rows = list(control.readings(case_dir, traffic, [2 ** 31 + 11], 1, 0.0, "cpu",
                                 say=lambda m: None))
    prog = compare.judge(rows[0]["program"], {k: limits[k] for k in rows[0]["program"]})
    ctrl = compare.judge(rows[0]["control"], {k: limits[k] for k in rows[0]["control"]})
    assert all(c["ok"] for c in prog.values()), prog
    assert not all(c["ok"] for c in ctrl.values()), ctrl
