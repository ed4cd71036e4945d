"""The dequant's timing tool (``nunchaku_tpu_torch/tools/time_dequant.py``) and
the pipelined producer's rows of ``tools/time_chain.py`` on the CPU: the
rows are PERF.md's at the shapes they name, and each row's bound counts the
bytes and operations ``chip_smoke.py`` counts for the same call (each input
read once, each output written once), so the scripts report one bound for
one call."""

import importlib.util
from pathlib import Path

import pytest

from nunchaku_tpu_torch.tools import time_chain, time_dequant

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rows_are_the_documented_ones():
    assert [r for r, _ in time_dequant.rows()] == ["1", "1:fc2", "1s", "1e", "1e:fc2", "1e:s"]
    assert dict(time_dequant.rows())["1s"] == (3840, 11520, "int4", True)


def test_shapes_are_the_model_paths():
    smoke = _chip_smoke()
    assert (time_dequant.DIM, time_dequant.HID) == (smoke.DIM, smoke.HID)
    assert (time_dequant.ZI_DIM, time_dequant.ZI_QKV) == (smoke.ZI_DIM, 3 * smoke.ZI_DIM)


@pytest.mark.parametrize("row", [r for r, _ in time_dequant.rows()])
def test_bound_matches_chip_smoke(row):
    smoke = _chip_smoke()
    k, n, codes, _ = dict(time_dequant.rows())[row]
    g = 16 if codes == "e2m1" else 64
    assert time_dequant.deq_bytes(k, n, g) == smoke.deq_bytes(k, n, g)
    assert time_dequant.row_bound(k, n, codes) == smoke.bound(smoke.deq_bytes(k, n, g))


def test_pipelined_rows_beside_row_2():
    """Row 14 at R 32 / 128 / 256 beside row 2 at the same shapes, each pair on one bound."""
    names = [r for r, _ in time_chain.rows()]
    for r14, r2 in (("14", "2"), ("14:r128", "2:r128"), ("14:r256", "2:r256")):
        assert r14 in names and r2 in names
    assert time_chain.PIPE_RANKS == {"14": 32, "14:r128": 128, "14:r256": 256}


@pytest.mark.parametrize("r", sorted(time_chain.PIPE_RANKS.values()))
def test_pipelined_bound_matches_chip_smoke(r):
    smoke = _chip_smoke()
    m, k, n = smoke.S_IMG + smoke.S_TXT, smoke.DIM, smoke.HID
    want = smoke.bound(smoke.gemm_bytes(m, k, n, r, m * n + 4 * (n // 1536) * m + 4 * m * r) + 4 * n + 2 * n * r,
                       2 * m * n * k, 4 * m * n * r)
    assert time_chain.producer_bound(m, k, n, r, time_chain.GROUPS) == want
