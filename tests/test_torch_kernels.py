"""Parity of the port's four kernel modules with the JAX package's Pallas
kernels (interpret mode on the CPU), through the port's plain twins.

Inputs come from a seeded numpy generator and go through both packages;
each test states its tolerance. The JAX references are computed once per
module.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.ops import attention as jattn
from nunchaku_tpu.ops import gemm as jgemm
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.ops import attention as tattn
from nunchaku_tpu_torch.ops import gemm as tgemm


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


# ---------------------------------------------------------------------------
# kernel 1: w4a8 dequant (exact codes)
# ---------------------------------------------------------------------------

DEQUANT_SHAPES = [(512, 256), (1024, 384), (256, 128)]


@pytest.fixture(scope="module")
def dequant_cases():
    rng = np.random.default_rng(0)
    cases = {}
    for k, n in DEQUANT_SHAPES:
        qw = rng.integers(-128, 128, (k // 2, n), dtype=np.int8)
        rs = rng.uniform(1.0, 127.0 / 7.0, (k // 64, n)).astype(np.float32)
        rs = np.asarray(jnp.asarray(rs, jnp.bfloat16))
        ref = np.asarray(jgemm.dequant_w4a8_pallas(jnp.asarray(qw), jnp.asarray(rs), interpret=True))
        cases[(k, n)] = (qw, rs, ref)
    return cases


@pytest.mark.parametrize("k,n", DEQUANT_SHAPES)
def test_dequant_codes_exact(dequant_cases, k, n):
    qw, rs, ref = dequant_cases[(k, n)]
    out = tgemm.dequant_w4a8(_t(qw), _t(rs)).numpy()
    assert out.dtype == np.int8 and out.shape == (k, n)
    np.testing.assert_array_equal(out, ref)


def test_dequant_matches_xla_route(dequant_cases):
    qw, rs, ref = dequant_cases[(512, 256)]
    np.testing.assert_array_equal(np.asarray(jgemm.dequant_w4a8_to_int8(jnp.asarray(qw), jnp.asarray(rs))), ref)


# ---------------------------------------------------------------------------
# kernel 2: GELU -> requantize producer; kernel 3: grouped consumer
# ---------------------------------------------------------------------------


def _chain_inputs(rng, m, k, n, r):
    qa = rng.integers(-127, 128, (m, k), dtype=np.int8)
    asc = ((rng.random((1, m)) + 0.5) / 127.0).astype(np.float32)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    ws = ((rng.random((1, n)) + 0.5) / (73.0 * np.sqrt(k))).astype(np.float32)
    la = rng.standard_normal((m, r)).astype(np.float32)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    pu = bf(rng.standard_normal((r, n)) * 0.02)
    bias = bf(rng.standard_normal((n,)) * 0.02)
    return qa, asc, w, ws, la, pu, bias


@pytest.fixture(scope="module")
def chain_cases():
    rng = np.random.default_rng(1)
    m, k, n, r = 256, 256, 3072, 32  # N = 3072 -> bn = 1536: two scale groups
    qa, asc, w, ws, la, pu, bias = _chain_inputs(rng, m, k, n, r)
    rsm = (rng.random((n,)) + 0.5).astype(np.float32)
    pd = np.asarray(jnp.asarray(rng.standard_normal((n, r)) * 0.02, jnp.bfloat16))
    cases = {}
    for unsigned in (False, True):
        ref = jgemm.svdq_gemm_w8a8_gelu_quant(
            *map(jnp.asarray, (qa, asc, w, ws, la, pu, bias, rsm, pd)),
            act_unsigned_next=unsigned, gelu_shift=0.171875)
        cases[unsigned] = ((qa, asc, w, ws, la, pu, bias, rsm, pd), tuple(map(np.asarray, ref)))
    return cases


@pytest.mark.parametrize("unsigned", [False, True])
def test_gelu_quant_matches_pallas(chain_cases, unsigned):
    inputs, (q_ref, s_ref, l_ref) = chain_cases[unsigned]
    q, s, l = tgemm.svdq_gemm_w8a8_gelu_quant(*map(_t, inputs), act_unsigned_next=unsigned)
    assert s.shape == s_ref.shape == (2, 256)  # one scale per (token, 1536-column group)
    diff = np.abs(q.numpy().astype(np.int32) - q_ref.astype(np.int32))
    # codes: at most one apart (tanh/reduction rounding at .5 boundaries), on <= 0.1%
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-5)
    assert _rel(l.numpy(), l_ref) <= 1e-2  # lora_next: f32 sums in another order


# K = 64 (mod 128): the card's s8 main loop ends such a K on a half tile; the twin the card is held to must
# stay held to JAX there (JAX's K tile is then K itself)
CHAIN_TAIL_SHAPES = [(128, 320, 1536), (256, 192, 3072)]


@pytest.fixture(scope="module")
def chain_tail_cases():
    rng = np.random.default_rng(3)
    cases = {}
    for m, k, n in CHAIN_TAIL_SHAPES:
        qa, asc, w, ws, la, pu, bias = _chain_inputs(rng, m, k, n, 32)
        rsm = (rng.random((n,)) + 0.5).astype(np.float32)
        pd = np.asarray(jnp.asarray(rng.standard_normal((n, 32)) * 0.02, jnp.bfloat16))
        ref = jgemm.svdq_gemm_w8a8_gelu_quant(*map(jnp.asarray, (qa, asc, w, ws, la, pu, bias, rsm, pd)),
                                              gelu_shift=0.171875)
        cases[(m, k, n)] = ((qa, asc, w, ws, la, pu, bias, rsm, pd), tuple(map(np.asarray, ref)))
    return cases


@pytest.mark.parametrize("m,k,n", CHAIN_TAIL_SHAPES)
def test_gelu_quant_k_tail_matches_pallas(chain_tail_cases, m, k, n):
    inputs, (q_ref, s_ref, l_ref) = chain_tail_cases[(m, k, n)]
    q, s, l = tgemm.svdq_gemm_w8a8_gelu_quant(*map(_t, inputs))
    assert s.shape == s_ref.shape == (n // 1536, m)
    diff = np.abs(q.numpy().astype(np.int32) - q_ref.astype(np.int32))
    # codes: at most one apart (tanh/reduction rounding at .5 boundaries), on <= 0.1%
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-5)
    assert _rel(l.numpy(), l_ref) <= 1e-2  # lora_next: f32 sums in another order


def test_chain_tile_rule_matches_jax():
    for n in (12288, 3072, 1024, 640, 384, 200):
        assert tgemm.chain_tile_n(n) == jgemm._pick_dim(n, (1536, 1024, 512, 256, 128))


# K / G = 64 (mod 128) in the last two: the card's s8 main loop ends each such group on a half tile
GROUPED_SHAPES = [(256, 3072, 256, 2), (128, 1024, 384, 4), (128, 768, 256, 4), (256, 192, 128, 1)]


@pytest.fixture(scope="module")
def grouped_cases():
    rng = np.random.default_rng(2)
    cases = {}
    for m, k, n, g in GROUPED_SHAPES:
        qa, _, w, ws, la, pu, bias = _chain_inputs(rng, m, k, n, 32)
        asc = ((rng.random((g, m)) + 0.5) / 127.0).astype(np.float32)
        ref = np.asarray(jgemm.svdq_gemm_w4a4(*map(jnp.asarray, (qa, asc, w, ws, la, pu, bias)),
                                              precision="int8"), np.float32)
        cases[(m, k, n, g)] = ((qa, asc, w, ws, la, pu, bias), ref)
    return cases


@pytest.mark.parametrize("m,k,n,g", GROUPED_SHAPES)
def test_grouped_consumer_matches_pallas(grouped_cases, m, k, n, g):
    inputs, ref = grouped_cases[(m, k, n, g)]
    out = tgemm.svdq_gemm_w4a4(*map(_t, inputs), precision="int8")
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert _rel(out.float().numpy(), ref) <= 1e-2  # bf16 output, f32 low-rank sums reordered


# ---------------------------------------------------------------------------
# kernel 4: fixed-shift flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [(1, 2, 200, 200), (2, 2, 130, 260), (1, 1, 77, 300), (1, 3, 384, 384)]


@pytest.fixture(scope="module")
def flash_cases():
    rng = np.random.default_rng(3)
    cases = {}
    for b, h, sq, skv in FLASH_CASES:
        bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
        q = bf(rng.standard_normal((b, h, sq, 128)) * 0.25)
        k = bf(rng.standard_normal((b, h, skv, 128)) * 2.0)
        v = bf(rng.standard_normal((b, h, skv, 128)))
        ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=1.0,
                                    out_bshd=True, fixed_softmax=True)
        cases[(b, h, sq, skv)] = ((q, k, v), np.asarray(ref, np.float32))
    return cases


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_fixed_matches_pallas(flash_cases, case):
    (q, k, v), ref = flash_cases[case]
    out = tattn.flash_attention(_t(q), _t(k), _t(v))
    b, h, sq, _ = case
    assert out.shape == (b, sq, h * 128) and out.dtype == torch.bfloat16
    assert _rel(out.float().numpy(), ref) <= 1e-2  # bf16 output; exp2 and sums reordered


def test_cpu_tensors_take_the_plain_twin():
    """On the CPU no wrapper launches (or counts) a kernel."""
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    tgemm.dequant_w4a8(torch.zeros((128, 128), dtype=torch.int8),
                       torch.ones((4, 128), dtype=torch.bfloat16))
    q = torch.zeros((1, 1, 8, 128), dtype=torch.bfloat16)
    tattn.flash_attention(q, q, q)
    assert all(v == 0 for v in launch_counts().values())
