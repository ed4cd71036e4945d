"""The kernel twins this slice extends, against the JAX package (CPU): the
e2m1 form of the w4a8 dequant (bit for bit against the Pallas kernel in
interpret mode and the XLA route), and the chain producer, grouped consumer
and W4A4 GEMM at rank 128 (nunchaku's rank-128 checkpoints).

Inputs come from a seeded numpy generator; each test states its tolerance.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.ops import gemm as jgemm
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.ops import gemm as tgemm


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("k,n", [(512, 256), (768, 384), (256, 128)])
def test_dequant_e2m1_codes_exact(k, n):
    """Every nibble (the stray code -8 too) with group-16 rescales in
    [1, 127 / 6]: the twin's int8 codes equal the Pallas kernel's and the
    XLA route's exactly."""
    rng = np.random.default_rng(k + n)
    qw = rng.integers(-128, 128, (k // 2, n), dtype=np.int8)
    rs = _bf(rng.uniform(1.0, 127.0 / 6.0, (k // 16, n)))
    ref = np.asarray(jgemm.dequant_w4a8_pallas(jnp.asarray(qw), jnp.asarray(rs), interpret=True, codes="e2m1"))
    np.testing.assert_array_equal(np.asarray(jgemm.dequant_w4a8_to_int8(jnp.asarray(qw), jnp.asarray(rs),
                                                                        codes="e2m1")), ref)
    out = tgemm.dequant_w4a8(_t(qw), _t(rs), "e2m1").numpy()
    assert out.dtype == np.int8 and out.shape == (k, n)
    np.testing.assert_array_equal(out, ref)
    assert tgemm.COUNTS["dequant_w4a8_e2m1"].launches == 0  # the CPU takes the twin


def test_dequant_rejects_unknown_codes():
    with pytest.raises(ValueError):
        tgemm.dequant_w4a8(torch.zeros((128, 128), dtype=torch.int8), torch.ones((16, 128)), "fp8")


def _chain_inputs(rng, m, k, n, r):
    qa = rng.integers(-127, 128, (m, k), dtype=np.int8)
    asc = ((rng.random((1, m)) + 0.5) / 127.0).astype(np.float32)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    ws = ((rng.random((1, n)) + 0.5) / (73.0 * np.sqrt(k))).astype(np.float32)
    la = rng.standard_normal((m, r)).astype(np.float32)
    return qa, asc, w, ws, la, _bf(rng.standard_normal((r, n)) * 0.02), _bf(rng.standard_normal((n,)) * 0.02)


@pytest.mark.parametrize("unsigned", [False, True])
def test_gelu_quant_rank128_matches_pallas(unsigned):
    """Codes at most one apart on <= 0.1% (tanh and reduction rounding at .5
    boundaries), scales within 1e-5, the rank-128 lora_next within 1e-2 of
    its max (f32 sums in another order): the rank-32 tolerances."""
    rng = np.random.default_rng(3)
    m, k, n, r = 256, 256, 3072, 128
    inputs = _chain_inputs(rng, m, k, n, r) + ((rng.random((n,)) + 0.5).astype(np.float32),
                                               _bf(rng.standard_normal((n, r)) * 0.02))
    q_ref, s_ref, l_ref = map(np.asarray, jgemm.svdq_gemm_w8a8_gelu_quant(
        *map(jnp.asarray, inputs), act_unsigned_next=unsigned, gelu_shift=0.171875))
    q, s, l = tgemm.svdq_gemm_w8a8_gelu_quant(*map(_t, inputs), act_unsigned_next=unsigned)
    assert l.shape == l_ref.shape == (m, r)
    diff = np.abs(q.numpy().astype(np.int32) - q_ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-5)
    assert _rel(l.numpy(), l_ref) <= 1e-2


def test_grouped_consumer_rank128_matches_pallas():
    """bf16 output within 1e-2 of the reference's max (f32 low-rank sums
    reordered), as at rank 32."""
    rng = np.random.default_rng(4)
    m, k, n, g = 256, 3072, 256, 2
    qa, _, w, ws, la, pu, bias = _chain_inputs(rng, m, k, n, 128)
    asc = ((rng.random((g, m)) + 0.5) / 127.0).astype(np.float32)
    ref = np.asarray(jgemm.svdq_gemm_w4a4(*map(jnp.asarray, (qa, asc, w, ws, la, pu, bias)), precision="int8"),
                     np.float32)
    out = tgemm.svdq_gemm_w4a4(*map(_t, (qa, asc, w, ws, la, pu, bias)), precision="int8")
    assert out.dtype == torch.bfloat16 and _rel(out.float().numpy(), ref) <= 1e-2


def test_gemm_w4a4_rank128_matches_pallas():
    """int4 at rank 128: bf16 output within 1e-2 of the Pallas kernel's max
    (the same bf16 products, f32 sums in another order)."""
    rng = np.random.default_rng(5)
    m, k, n, r = 256, 512, 384, 128
    qa = rng.integers(-128, 128, (m, k // 2), dtype=np.int8)
    qw = rng.integers(-128, 128, (k // 2, n), dtype=np.int8)
    asc = _bf((rng.random((k // 64, m)) + 0.5) / 4.6)
    wsc = _bf((rng.random((k // 64, n)) + 0.5) / (4.6 * np.sqrt(k)))
    la = rng.standard_normal((m, r)).astype(np.float32)
    pu, bias = _bf(rng.standard_normal((r, n)) * 0.02), _bf(rng.standard_normal((n,)) * 0.02)
    ref = np.asarray(jgemm.svdq_gemm_w4a4(*map(jnp.asarray, (qa, asc, qw, wsc, la, pu, bias)), precision="int4",
                                          interpret=True), np.float32)
    out = tgemm.svdq_gemm_w4a4(*map(_t, (qa, asc, qw, wsc, la, pu, bias)), precision="int4")
    assert _rel(out.float().numpy(), ref) <= 1e-2
