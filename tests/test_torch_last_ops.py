"""Parity of the port's last four op-level entry points with the JAX
package at small sizes (CPU): the dual LayerNorm producer
(``ln_mod_quant_int8_dual``), the producer without the low-rank term
(``qkv_prepare``), token-major flash attention (``flash_attention_bshd``)
and the software-pipelined chain producer
(``svdq_gemm_w8a8_gelu_quant(pipelined=True)``), each alone and chained as a
FLUX.1-dev single block's pieces would meet.

The JAX kernels run as the JAX package's own tests run them on the CPU
(Pallas interpret mode); the port's wrappers run their plain twins (CPU
tensors). Each test makes its inputs from its own seeded numpy generator
and states its tolerance.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models import linear as jlin
from nunchaku_tpu.ops import attention as jatt
from nunchaku_tpu.ops import gemm as jgemm
from nunchaku_tpu.ops import quantize as jquant
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.ops import attention as tatt
from nunchaku_tpu_torch.ops import gemm as tgemm
from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
from nunchaku_tpu_torch.ops import quantize as tquant


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(out, ref):
    out, ref = _np(out), _np(ref)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)


def _codes_close(q, q_ref):
    """int8 codes at most one apart on at most 0.1% of elements."""
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(q_ref, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def _scales_close(s, s_ref):
    s_ref = np.asarray(s_ref)
    assert s.shape == s_ref.shape
    assert np.max(np.abs(s.numpy() - s_ref) / np.abs(s_ref)) <= 1e-5


# ---------------------------------------------------------------------------
# the dual LayerNorm producer
# ---------------------------------------------------------------------------


def _dual_inputs(rng, b, s, k, smooths):
    x = _bf16(rng, (b, s, k), 3.0) + _bf16(rng, (b, s, 1))
    sc = jnp.asarray(rng.standard_normal((b, k)) * 0.3, jnp.float32)
    sh = jnp.asarray(rng.standard_normal((b, k)) * 0.3, jnp.float32)
    sm = [jnp.asarray(rng.uniform(0.5, 2.0, (k,)), jnp.bfloat16) if on else None for on in smooths]
    pds = [_bf16(rng, (k, r), 0.05) for r in (32, 16)]
    return x, sc, sh, sm[0], pds[0], sm[1], pds[1]


def _opt(a):
    return None if a is None else _t(a)


@pytest.mark.parametrize("smooths", [(True, True), (False, True), (True, False)], ids=["both", "a_none", "b_none"])
@pytest.mark.parametrize("b", [1, 2])
def test_ln_mod_quant_dual_matches_jax(b, smooths):
    """Each head: codes at most one apart on at most 0.1%, scales rel <=
    1e-5, lora_act rel <= 1e-2 (row 6's bounds: XLA sums the LayerNorm in
    another order). R 32 and 16."""
    rng = np.random.default_rng(140 + b)
    s, k = 256, 512
    args = _dual_inputs(rng, b, s, k, smooths)
    ref = jquant.ln_mod_quant_int8_dual(*args)
    out = tquant.ln_mod_quant_int8_dual(*(_opt(a) for a in args))
    for (q, sc, la), (q_r, s_r, l_r), r in zip(out, ref, (32, 16)):
        assert q.shape == (b * s, k) and q.dtype == torch.int8 and la.shape == (b * s, r)
        _codes_close(q, q_r)
        _scales_close(sc, s_r)
        assert _rel(la, l_r) <= 1e-2


@pytest.mark.parametrize("b", [1, 2])
def test_ln_mod_quant_dual_twin_is_two_single_twins(b):
    """The twin's two outputs equal two ln_mod_quant_int8_plain calls
    exactly (the same LayerNorm, each head its own epilogue)."""
    rng = np.random.default_rng(150 + b)
    x, sc, sh, sma, pda, smb, pdb = (_opt(a) for a in _dual_inputs(rng, b, 128, 256, (True, False)))
    dual = tquant.ln_mod_quant_int8_dual_plain(x, sc, sh, sma, pda, smb, pdb)
    for got, (sm, pd) in zip(dual, ((sma, pda), (smb, pdb))):
        for g, w in zip(got, tquant.ln_mod_quant_int8_plain(x, sc, sh, sm, pd)):
            assert torch.equal(g, w)


def test_ln_mod_quant_dual_needs_modulation():
    rng = np.random.default_rng(152)
    x, _, _, sma, pda, smb, pdb = (_opt(a) for a in _dual_inputs(rng, 1, 64, 256, (True, True)))
    with pytest.raises(ValueError):
        tquant.ln_mod_quant_int8_dual(x, None, None, sma, pda, smb, pdb)


# ---------------------------------------------------------------------------
# qkv_prepare
# ---------------------------------------------------------------------------


def _prepare_inputs(rng, b, s, heads, d):
    qkv = _bf16(rng, (b, s, 3 * heads * d), 2.0)
    nq, nk = (jnp.asarray(rng.uniform(0.5, 1.5, (d,)), jnp.bfloat16) for _ in range(2))
    ang = rng.uniform(0.0, 6.0, (s, d // 2))
    cos = jnp.asarray(np.concatenate([np.cos(ang)] * 2, -1), jnp.float32)
    sin = jnp.asarray(np.concatenate([-np.sin(ang), np.sin(ang)], -1), jnp.float32)
    return qkv, cos, sin, nq, nk


@pytest.mark.parametrize("scaled", [False, True], ids=["q_scale1", "q_scale_log2e"])
@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("s", [200, 256])
def test_qkv_prepare_matches_jax(s, d, scaled):
    """q, k, v (B, H, S, D) within 1e-2 relative of JAX's (S 200: JAX pads
    to 256 and cuts back; the port takes S as it comes)."""
    rng = np.random.default_rng(160 + s + d)
    heads = 2
    args = _prepare_inputs(rng, 1, s, heads, d)
    q_scale = jatt.LOG2E / math.sqrt(d) if scaled else 1.0
    ref = jatt.qkv_prepare(*args, heads=heads, head_dim=d, q_scale=q_scale)
    out = tatt.qkv_prepare(*map(_t, args), heads=heads, head_dim=d, q_scale=q_scale)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape) == (1, heads, s, d) and o.dtype == torch.bfloat16
        assert _rel(o, r) <= 1e-2


@pytest.mark.parametrize("eps", [1e-6, 1e-2])
def test_qkv_prepare_twin_is_producer_without_lora(eps):
    """The twin equals qkv_rope_producer_plain without low-rank operands
    exactly, eps passed through."""
    rng = np.random.default_rng(170)
    qkv, cos, sin, nq, nk = map(_t, _prepare_inputs(rng, 2, 96, 2, 128))
    scale = tatt.LOG2E / math.sqrt(128)
    got = tatt.qkv_prepare(qkv, cos, sin, nq, nk, heads=2, head_dim=128, q_scale=scale, eps=eps)
    want = tatt.qkv_rope_producer_plain(qkv, cos, sin, nq, nk, q_scale=scale, eps=eps)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_qkv_prepare_refuses_wrong_heads():
    rng = np.random.default_rng(171)
    qkv, cos, sin, nq, nk = map(_t, _prepare_inputs(rng, 1, 32, 2, 128))
    with pytest.raises(ValueError):
        tatt.qkv_prepare(qkv, cos, sin, nq, nk, heads=3, head_dim=128)


# ---------------------------------------------------------------------------
# token-major flash
# ---------------------------------------------------------------------------


def _bshd_inputs(rng, sq, skv, heads=2, d=128):
    q = _bf16(rng, (1, sq, heads, d), 2.0)
    k = _bf16(rng, (1, skv, heads, d), 2.0)
    v = _bf16(rng, (1, skv, heads, d))
    return q, k, v


@pytest.mark.parametrize("sq,skv", [(256, 256), (300, 300), (200, 333), (1700, 1700)])
def test_flash_bshd_matches_jax(sq, skv):
    """(B, S, H, D) out within 1e-2 of the max of JAX's (the online kernel's
    bound: XLA's CPU exp2 of bf16). The twin rescales at JAX's kv tile,
    min(1536, round_up(Skv, 128)): S 1700 crosses it."""
    rng = np.random.default_rng(180 + sq)
    q, k, v = _bshd_inputs(rng, sq, skv)
    ref = jatt.flash_attention_bshd(q, k, v)
    out = tatt.flash_attention_bshd(_t(q), _t(k), _t(v))
    assert tuple(out.shape) == tuple(ref.shape) == (1, sq, 2, 128) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 1e-2


def test_flash_bshd_tiles():
    assert [tatt.bshd_tile(s) for s in (256, 300, 333, 1536, 1700, 4608)] == [256, 384, 384, 1536, 1536, 1536]


@pytest.mark.parametrize("scale", [None, 0.05])
def test_flash_bshd_twin_at_kernel_tile_is_online_twin(scale):
    """At the kernel's 128-column tile the twin is the online kernel's twin
    on the transposed tensors, bit for bit (scale None: 1/sqrt(D) in both)."""
    rng = np.random.default_rng(190)
    q, k, v = map(_t, _bshd_inputs(rng, 160, 200))
    got = tatt.flash_attention_bshd_plain(q, k, v, scale=scale, bkv=tatt.ONLINE_BKV)
    want = tatt.flash_attention_online_plain(*(t.transpose(1, 2) for t in (q, k, v)), scale=scale)
    assert torch.equal(got, want.transpose(1, 2))


# ---------------------------------------------------------------------------
# the software-pipelined chain producer
# ---------------------------------------------------------------------------


def _chain_inputs(rng, m, k, n, r):
    """JAX's own case (tests/test_ops.py:922): int8 codes, small positive
    scales, O(0.1) low-rank terms and bias."""
    qa = rng.integers(-127, 128, (m, k)).astype(np.int8)
    asc = (rng.random((1, m)) * 0.01 + 0.001).astype(np.float32)
    qw = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.random((1, n)) * 0.01 + 0.001).astype(np.float32)
    la = (rng.standard_normal((m, r)) * 0.1).astype(np.float32)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    pu = bf(rng.standard_normal((r, n)) * 0.1)
    b = bf(rng.standard_normal((n,)) * 0.1)
    rsm = (rng.random((n,)) + 0.5).astype(np.float32)
    pd = bf(rng.standard_normal((n, r)) * 0.1)
    return qa, asc, qw, ws, la, pu, b, rsm, pd


@pytest.mark.parametrize("unsigned", [False, True])
@pytest.mark.parametrize("n", [1024, 3072])
def test_pipelined_producer_matches_jax(n, unsigned):
    """M 256, K 512, R 32 (N 3072: two 1536-column scale groups): codes at
    most one apart on at most 0.1%, scales within 1e-5, lora_next within
    1e-2 (row 2's bounds, test_torch_kernels.py:98-106). JAX's pipelined
    kernel is its plain one bit for bit, and so is the port's twin."""
    rng = np.random.default_rng(200 + n + unsigned)
    inputs = _chain_inputs(rng, 256, 512, n, 32)
    ref = jgemm.svdq_gemm_w8a8_gelu_quant(*map(jnp.asarray, inputs), act_unsigned_next=unsigned, pipelined=True)
    q_r, s_r, l_r = map(np.asarray, ref)
    q, s, l = tgemm.svdq_gemm_w8a8_gelu_quant(*map(_t, inputs), act_unsigned_next=unsigned, pipelined=True)
    assert s.shape == s_r.shape == (n // tgemm.chain_tile_n(n), 256) and l.shape == (256, 32)
    _codes_close(q, q_r)
    np.testing.assert_allclose(s.numpy(), s_r, rtol=1e-5)
    assert _rel(l, l_r) <= 1e-2


@pytest.mark.parametrize("k", [128, 256, 512, 768, 1024, 2048, 3072, 6144, 12288, 200])
def test_int8_tile_k_matches_jax(k):
    assert tgemm.int8_tile_k(k) == min(jgemm._pick_dim(k, (3072, 1536, 768, 512, 1024, 256)), k)


@pytest.mark.parametrize("case,route", [
    (dict(k=3072, pipelined=True), "pipe"),
    (dict(k=512, pipelined=True), "pipe"),
    (dict(k=3072), "grouped"),  # pipelined None means False
    (dict(k=3072, pipelined=False), "grouped"),
    (dict(k=1024, pipelined=True), "grouped"),  # K != its K tile (512)
    (dict(k=12288, pipelined=True), "grouped"),  # FLUX fc2's K: tile 3072
    (dict(k=3072, pipelined=True, layer_idx=0), "grouped"),  # stacked
    (dict(k=3072, pipelined=True, ptoken=True), "ptoken"),
    (dict(k=3072, pipelined=True, ptoken=True, precision="w4a8"), "w4a8"),
])
def test_chain_route_follows_jax(case, route):
    """JAX gemm.py:1344-1378: w4a8 returns first, ptoken second, then the
    pipe kernel only for K == bk on an unstacked weight."""
    case = dict(case)
    assert tgemm.chain_route(case.pop("k"), **case) == route


def test_pipelined_branch_on_cpu_runs_the_twin():
    """On CPU tensors every route of the int8 producer is its twin; no
    kernel count moves, a stacked weight falls through as in JAX."""
    rng = np.random.default_rng(210)
    inputs = list(map(_t, _chain_inputs(rng, 128, 256, 256, 16)))
    reset_launch_counts()
    plain = tgemm.svdq_gemm_w8a8_gelu_quant(*inputs)
    piped = tgemm.svdq_gemm_w8a8_gelu_quant(*inputs, pipelined=True)
    stack = torch.stack([inputs[2], inputs[2]])
    stacked = tgemm.svdq_gemm_w8a8_gelu_quant(*inputs[:2], stack, *inputs[3:], pipelined=True,
                                              layer_idx=torch.tensor(1, dtype=torch.int32))
    for a, b, c in zip(plain, piped, stacked):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not any(launch_counts().values())


# ---------------------------------------------------------------------------
# the four together: a FLUX.1-dev single block's pieces at reduced width
# ---------------------------------------------------------------------------


def _rsmooth(smooth):
    sm = np.asarray(smooth, np.float32)
    return np.where(sm == 0, 1.0, 1.0 / np.where(sm == 0, 1.0, sm)).astype(np.float32)


def test_single_block_pieces_chain_matches_jax():
    """dim 256, 2 heads of 128, S 256, R 32, int8 linears from the JAX
    random_init: the dual producer gives the qkv and fc1 activations; fc1
    runs through the pipelined chain producer into the grouped int8
    consumer (fc2); the qkv product through qkv_prepare, token-major, into
    flash_attention_bshd. Both ends within 2e-2 relative of JAX (the
    small-model bound)."""
    rng = np.random.default_rng(220)
    b, s, dim, heads, d, r = 1, 256, 256, 2, 128, 32
    keys = jax.random.split(jax.random.PRNGKey(14), 3)
    to_qkv = jlin.SVDQW4A4Linear.random_init(keys[0], dim, 3 * dim, rank=r, precision="int8")
    fc1 = jlin.SVDQW4A4Linear.random_init(keys[1], dim, 4 * dim, rank=r, precision="int8")
    fc2 = jlin.SVDQW4A4Linear.random_init(keys[2], 4 * dim, dim, rank=r, precision="int8")
    x = _bf16(rng, (b, s, dim), 2.0)
    sc = jnp.asarray(rng.standard_normal((b, dim)) * 0.2, jnp.float32)
    sh = jnp.asarray(rng.standard_normal((b, dim)) * 0.2, jnp.float32)
    _, cos, sin, nq, nk = _prepare_inputs(rng, b, s, heads, d)
    rsm = jnp.asarray(_rsmooth(fc2.smooth))

    def run(f, lin, op_q, op_att, op_gemm):
        (qa, sa, laa), (qb, sb, lab) = op_q.ln_mod_quant_int8_dual(
            f(x), f(sc), f(sh), f(to_qkv.smooth), f(to_qkv.proj_down), f(fc1.smooth), f(fc1.proj_down))
        qout, qs, la2 = op_gemm.svdq_gemm_w8a8_gelu_quant(
            qb, sb, f(fc1.qweight), f(fc1.wscales), lab, f(fc1.proj_up), f(fc1.bias), f(rsm), f(fc2.proj_down),
            pipelined=True)
        mlp = op_gemm.svdq_gemm_w4a4(qout, qs, f(fc2.qweight), f(fc2.wscales), la2, f(fc2.proj_up), f(fc2.bias),
                                     precision="int8")
        qkv = op_gemm.svdq_gemm_w4a4(qa, sa, f(to_qkv.qweight), f(to_qkv.wscales), laa, f(to_qkv.proj_up),
                                     f(to_qkv.bias), precision="int8")
        q, k, v = op_att.qkv_prepare(qkv.reshape(b, s, 3 * dim), f(cos), f(sin), f(nq), f(nk), heads=heads,
                                     head_dim=d)
        tok = [lin(t) for t in (q, k, v)]  # (B, H, S, D) -> (B, S, H, D)
        return mlp, op_att.flash_attention_bshd(*tok)

    mlp_r, att_r = run(lambda a: a, lambda t: jnp.swapaxes(t, 1, 2), jquant, jatt, jgemm)
    mlp, att = run(_t, lambda t: t.transpose(1, 2).contiguous(), tquant, tatt, tgemm)
    assert tuple(mlp.shape) == tuple(mlp_r.shape) == (b * s, dim)
    assert tuple(att.shape) == tuple(att_r.shape) == (b, s, heads, d)
    for out, ref in ((mlp, mlp_r), (att, att_r)):
        assert np.isfinite(_np(out)).all()
        assert _rel(out, ref) <= 2e-2
