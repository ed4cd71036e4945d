"""The qkv / RoPE producer's timing tool (``nunchaku_tpu_torch/tools/time_qkv.py``)
on the CPU: its rows are PERF.md's rows 7 and 18 at the shapes it names, and
each row's bound counts the bytes and operations ``chip_smoke.py`` counts for
the same call (each input read once, each output written once), so the two
scripts report one bound for one call."""

import importlib.util
from pathlib import Path

import pytest

from nunchaku_tpu_torch.tools import time_qkv

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rows_are_the_documented_ones():
    assert [r for r, _ in time_qkv.rows()] == ["7", "7:img", "7:txt", "7:r128", "7:r256", "7:r0", "18"]


def test_shapes_are_the_model_paths():
    smoke = _chip_smoke()
    assert (time_qkv.HD, time_qkv.HEADS, time_qkv.S_IMG, time_qkv.S_TXT, time_qkv.RANK) == (
        smoke.HD, smoke.HEADS, smoke.S_IMG, smoke.S_TXT, smoke.RANK)
    assert time_qkv.ZI_HEADS * time_qkv.HD == smoke.ZIMAGE["dim"]


# (S, R, heads): row 7, the dual block's image and text calls, R 128 / 256, Z-Image without low rank, row 18
CALLS = [(4608, 32, 24), (4096, 32, 24), (512, 32, 24), (4608, 128, 24), (4608, 256, 24), (4096, 0, 30),
         (4608, 0, 24)]


@pytest.mark.parametrize("s,r,heads", CALLS)
def test_bound_matches_chip_smoke(monkeypatch, s, r, heads):
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "HEADS", heads)
    assert time_qkv.rope_bytes(s, r, heads) == smoke.rope_bytes(s, r)
    want = smoke.bound(smoke.rope_bytes(s, r), bf16_ops=2 * s * 3 * heads * smoke.HD * r)
    assert time_qkv.rope_bound(s, r, heads) == want
