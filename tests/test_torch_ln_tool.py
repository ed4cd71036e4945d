"""The LN producer's timing tool (``nunchaku_tpu_torch/tools/time_ln.py``)
on the CPU: its rows are PERF.md's rows 6 and 15 at the shapes it names,
and each row's bound counts the bytes ``chip_smoke.py`` counts for the same
kernel and shape (each input read once, each output written once), so the
two scripts report one bound for one call."""

import importlib.util
from pathlib import Path

import pytest

from nunchaku_tpu_torch.tools import time_ln

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rows_are_the_documented_ones():
    assert [r for r, _ in time_ln.rows()] == ["6", "6:m4096", "6:m512", "6:r128", "6:r256", "15", "15:r128"]


@pytest.mark.parametrize("m,r", [(4608, 32), (4096, 32), (512, 32), (4608, 128), (4608, 256)])
def test_single_bytes_match_chip_smoke(m, r):
    assert time_ln.single_bytes(m, time_ln.DIM, r) == _chip_smoke().ln_bytes(m, time_ln.DIM, r)


@pytest.mark.parametrize("r", [32, 128])
def test_dual_bytes_match_chip_smoke(r):
    assert time_ln.dual_bytes(4608, time_ln.DIM, r, r) == _chip_smoke().dual_bytes(4608, time_ln.DIM, r, r)
