"""Fixtures of the benchmark's CPU tests: tiny sphere cases built with the
port's case generator, one a float32 4-level case like sphere_re10m, one a
float32 single level like sphere_64m_row."""

import os
import sys

import pytest
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the mixes at test size: calls of 2 coarse steps, an event every call, one
# step followed by the reference
TINY_TRAFFIC = {"call_steps": 2, "forces_every": 2, "stats_every": 2, "trace_calls": 1,
                "check_steps": 1, "perturb_rho": 0.001, "perturb_u": 0.05}
ROW_TRAFFIC = {"call_steps": 2, "trace_calls": 1, "check_steps": 1,
               "perturb_rho": 0.001, "perturb_u": 0.05}


def _case(path, **over):
    from open_ludwig_torch.cases import make_case_sphere
    make_case_sphere(str(path), "10M", steps=1000000, output_freq=0, **over)
    cfg = os.path.join(str(path), "config.yaml")
    with open(cfg) as fh:
        doc = yaml.safe_load(fh)
    doc["advanced"]["high_re"]["min_coarse_blocks"] = 1
    with open(cfg, "w") as fh:
        yaml.safe_dump(doc, fh, sort_keys=False)
    return str(path)


@pytest.fixture
def tiny_traffic():
    return dict(TINY_TRAFFIC)


@pytest.fixture
def row_traffic():
    return dict(ROW_TRAFFIC)


@pytest.fixture(scope="session")
def tiny_case(tmp_path_factory):
    """4 levels (16^3, 22x24x24, 24x40x40, 26x40x72), float32, Bouzidi on
    the finest, wall model, WALE, sponge, forces."""
    return _case(tmp_path_factory.mktemp("tiny4"), surface_resolution=8, num_levels=4)


@pytest.fixture(scope="session")
def tiny_row(tmp_path_factory):
    """One float32 level of 56^3 cells with Bouzidi."""
    return _case(tmp_path_factory.mktemp("row1"), surface_resolution=6, num_levels=1)


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
