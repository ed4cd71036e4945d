"""The port's checkpoint codecs and safetensors files against the JAX package (CPU).

Every codec of ``nunchaku_tpu_torch.utils.nunchaku_format`` gives the same
arrays as ``nunchaku_tpu.utils.nunchaku_format`` on the same seeded input,
exactly; safetensors files written by either package read back bit for
bit in the other.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from nunchaku_tpu.utils import nunchaku_format as JNF
from nunchaku_tpu.utils import safetensors as jst
from nunchaku_tpu_torch.utils import nunchaku_format as TNF
from nunchaku_tpu_torch.utils import safetensors as tst


def _eq(t: torch.Tensor, a: np.ndarray):
    assert tuple(t.shape) == a.shape
    np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("n,k", [(128, 64), (256, 512)])
def test_weight_int4_codec_matches_jax(n, k):
    rng = np.random.default_rng(0)
    vals = rng.integers(-8, 8, (n, k)).astype(np.int8)
    packed = JNF.pack_weight_int4(vals)
    _eq(TNF.pack_weight_int4(torch.from_numpy(vals)), packed)
    _eq(TNF.unpack_weight_int4(torch.from_numpy(packed), n, k), JNF.unpack_weight_int4(packed, n, k))
    _eq(TNF.unpack_weight_int4(torch.from_numpy(packed), n, k), vals)


@pytest.mark.parametrize("g,n", [(1, 128), (4, 256), (48, 384)])
def test_scale_codecs_match_jax(g, n):
    rng = np.random.default_rng(1)
    s = rng.standard_normal((g, n)).astype(np.float32)
    packed = JNF.pack_scale_ref(s)
    _eq(TNF.pack_scale_ref(torch.from_numpy(s)), packed)
    _eq(TNF.unpack_scale(torch.from_numpy(packed), n), JNF.unpack_scale(packed, n))
    if g % 4 == 0:  # micro scales come in k-quads: e4m3 bytes through both packages
        b = rng.integers(0, 256, (g, n)).astype(np.uint8)
        mp = JNF.pack_micro_scale_ref(b)
        _eq(TNF.pack_micro_scale_ref(torch.from_numpy(b)), mp)
        _eq(TNF.unpack_micro_scale(torch.from_numpy(mp), n), JNF.unpack_micro_scale(mp, n))


@pytest.mark.parametrize("down", [True, False])
@pytest.mark.parametrize("r", [16, 32, 128])
def test_lowrank_codec_matches_jax(down, r):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((r, 256) if down else (384, r)).astype(np.float32)
    packed = JNF.pack_lowrank_weight_ref(w, down)
    _eq(TNF.pack_lowrank_weight_ref(torch.from_numpy(w), down), packed)
    _eq(TNF.unpack_lowrank_weight(torch.from_numpy(packed), down), JNF.unpack_lowrank_weight(packed, down))


def test_awq_gemv_codec_matches_jax():
    rng = np.random.default_rng(3)
    oc, ic = 24, 256
    vals = rng.integers(0, 16, (oc, ic)).astype(np.int8)
    np.testing.assert_array_equal(TNF._awq_gemv_perm(oc, ic).numpy(), JNF._awq_gemv_perm(oc, ic))
    packed = JNF.pack_awq_gemv(vals)
    _eq(TNF.pack_awq_gemv(torch.from_numpy(vals)), packed)
    _eq(TNF.unpack_awq_gemv(torch.from_numpy(packed), oc, ic), JNF.unpack_awq_gemv(packed, oc, ic))
    _eq(TNF.unpack_awq_gemv(torch.from_numpy(packed), oc, ic), vals)


def test_tinychat_codec_matches_jax():
    rng = np.random.default_rng(4)
    oc, ic = 16, 256
    vals = rng.integers(0, 16, (oc, ic)).astype(np.int8)
    packed = JNF.pack_tinychat_w4(vals)
    _eq(TNF.pack_tinychat_w4(torch.from_numpy(vals)), packed)
    _eq(TNF.unpack_tinychat_w4(torch.from_numpy(packed), oc, ic), JNF.unpack_tinychat_w4(packed, oc, ic))
    _eq(TNF.unpack_tinychat_w4(torch.from_numpy(packed), oc, ic), vals)


def _arrays(rng):
    """One tensor of each dtype a nunchaku checkpoint holds, as numpy (JAX
    package) and torch (port) twins over the same bytes."""
    f32 = rng.standard_normal((5, 7)).astype(np.float32)
    bf16 = rng.standard_normal((3, 9)).astype(ml_dtypes.bfloat16)
    e4m3 = rng.uniform(0.01, 400.0, (33,)).astype(ml_dtypes.float8_e4m3fn)  # odd length: misaligns what follows
    i8 = rng.integers(-128, 128, (4, 6)).astype(np.int8)
    i32 = rng.integers(-2**31, 2**31, (2, 3)).astype(np.int32)
    arrays = {"f32": f32, "e4m3": e4m3, "bf16": bf16, "i8": i8, "i32": i32}
    torch_of = {
        "f32": torch.from_numpy(f32.copy()),
        "bf16": torch.from_numpy(bf16.view(np.uint16).astype(np.int16)).view(torch.bfloat16),
        "e4m3": torch.from_numpy(e4m3.view(np.uint8).copy()).view(torch.float8_e4m3fn),
        "i8": torch.from_numpy(i8.copy()),
        "i32": torch.from_numpy(i32.copy()),
    }
    return arrays, torch_of


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def test_safetensors_cross_read_bit_identical(tmp_path):
    arrays, tensors = _arrays(np.random.default_rng(5))
    meta = {"config": '{"num_layers": 2}', "quantization_config": '{"rank": 128}'}
    jst.save_safetensors(tmp_path / "jax.safetensors", arrays, meta)
    tst.save_safetensors(tmp_path / "torch.safetensors", {k: tensors[k] for k in arrays}, meta)
    assert (tmp_path / "jax.safetensors").read_bytes() == (tmp_path / "torch.safetensors").read_bytes()
    got, got_meta = tst.load_safetensors(tmp_path / "jax.safetensors")
    assert got_meta == meta and list(got) == list(arrays)
    for k, a in arrays.items():
        assert got[k].dtype == tensors[k].dtype and tuple(got[k].shape) == a.shape
        np.testing.assert_array_equal(_bits(got[k]), np.ascontiguousarray(a).reshape(-1).view(np.uint8))
    back, back_meta = jst.load_safetensors(tmp_path / "torch.safetensors")
    assert back_meta == meta
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype
        np.testing.assert_array_equal(back[k].view(np.uint8), a.view(np.uint8))
