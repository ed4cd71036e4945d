"""Every kernel twin whose Hopper kernel takes ranks above 128 (in chunks of
128) against the JAX package at rank 256 (CPU): the int8 chain producer
(grouped and pipelined) and grouped consumer (with the residual's extra
rank), the packed w4a8 GEMM (rank-1 and grouped) and W4 producer, the LN +
modulate + quantize producer (single and dual) and the qkv/RoPE producer,
plus a stacked packed GEMM on the layer of a Z-Image file synthesized in
upstream's ``svdq-int4_r256-z-image-turbo`` layout (the configuration whose
packed w4a8 route the kernels refused at 128).

The JAX kernels run as the JAX package's own tests run them on the CPU
(Pallas interpret mode). Inputs come from seeded numpy generators; each
test states its tolerance, the rank-32 / rank-128 tests' own: rank only
lengthens the f32 sums whose order differs.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.core.packing import pack_int4
from nunchaku_tpu.models.transformers.loader_zimage import load_zimage_transformer as jax_load_zimage
from nunchaku_tpu.ops import attention as jops_att
from nunchaku_tpu.ops import gemm as jgemm
from nunchaku_tpu.ops import quantize as jquant
from nunchaku_tpu_torch import load_zimage_transformer
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.ops import attention as tops_att
from nunchaku_tpu_torch.ops import gemm as tgemm
from nunchaku_tpu_torch.ops import quantize as tquant
from nunchaku_tpu_torch.tools import synth_checkpoint

R = 256


def _t(a):
    return None if a is None else to_torch(np.asarray(a), "cpu")


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(out, ref):
    out, ref = _np(out), _np(ref)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _bf16_steps(out, ref):
    """Elements further apart than one bf16 step (2^-7 |ref| + 1e-4 max
    |ref|), and the share of elements that differ at all."""
    out, ref = _np(out), _np(ref)
    beyond = int((np.abs(out - ref) > 2.0 ** -7 * np.abs(ref) + 1e-4 * np.abs(ref).max()).sum())
    return beyond, float((out != ref).mean())


def _codes_close(q, q_ref):
    """int8 codes at most one apart on at most 0.1% of them (a code at a .5
    boundary flips with the epilogue's rounding order)."""
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(q_ref, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def _int8_chain(rng, m, k, n, r):
    qa = rng.integers(-127, 128, (m, k), dtype=np.int8)
    asc = ((rng.random((1, m)) + 0.5) / 127.0).astype(np.float32)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    ws = ((rng.random((1, n)) + 0.5) / (73.0 * np.sqrt(k))).astype(np.float32)
    la = rng.standard_normal((m, r)).astype(np.float32)
    return qa, asc, w, ws, la, _bf(rng.standard_normal((r, n)) * 0.02), _bf(rng.standard_normal((n,)) * 0.02)


def _packed_chain(rng, m, k, n, r):
    qa = rng.integers(-127, 128, (m, k), dtype=np.int8)
    qw = np.asarray(pack_int4(rng.integers(-8, 8, (k, n)), axis=0))
    rs = _bf(rng.random((k // 64, n)) * (127.0 / 7.0 - 1.0) + 1.0)
    asc = ((rng.random((1, m)) + 0.5) / 127.0).astype(np.float32)
    ws = ((rng.random((1, n)) + 0.5) / (73.0 * np.sqrt(k) * 8.0)).astype(np.float32)
    la = rng.standard_normal((m, r)).astype(np.float32)
    return qa, asc, qw, rs, ws, la, _bf(rng.standard_normal((r, n)) * 0.02), _bf(rng.standard_normal((n,)) * 0.02)


# ---------------------------------------------------------------------------
# the int8 chain pair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pipelined", [False, True], ids=["grouped", "pipelined"])
@pytest.mark.parametrize("unsigned", [False, True])
def test_gelu_quant_rank256_matches_jax(unsigned, pipelined):
    """The producer (its pipelined form when K is one K tile, as JAX routes
    it): codes at most one apart on at most 0.1%, scales within 1e-5, the
    rank-256 lora_next within 1e-2 of its max."""
    rng = np.random.default_rng(60 + unsigned + 2 * pipelined)
    m, k, n = 256, 512, 3072
    inputs = _int8_chain(rng, m, k, n, R) + ((rng.random((n,)) + 0.5).astype(np.float32),
                                             _bf(rng.standard_normal((n, R)) * 0.02))
    kw = dict(act_unsigned_next=unsigned, pipelined=pipelined)
    q_r, s_r, l_r = map(np.asarray, jgemm.svdq_gemm_w8a8_gelu_quant(*map(jnp.asarray, inputs), gelu_shift=0.171875,
                                                                    **kw))
    assert tgemm.chain_route(k, pipelined=pipelined) == ("pipe" if pipelined else "grouped")
    q, s, l = tgemm.svdq_gemm_w8a8_gelu_quant(*map(_t, inputs), **kw)
    assert l.shape == l_r.shape == (m, R)
    _codes_close(q, q_r)
    np.testing.assert_allclose(s.numpy(), s_r, rtol=1e-5)
    assert _rel(l, l_r) <= 1e-2


@pytest.mark.parametrize("residual", [False, True])
def test_grouped_consumer_rank256_matches_jax(residual):
    """The grouped consumer at R 256, alone and with the gated residual
    whose extra operand carries its own rank-256 term (the kernel's extra
    R2): bf16 output within 1e-2 of the reference's max."""
    rng = np.random.default_rng(70 + residual)
    m, k, n, g = 256, 3072, 256, 2
    qa, _, w, ws, la, pu, bias = _int8_chain(rng, m, k, n, R)
    asc = ((rng.random((g, m)) + 0.5) / 127.0).astype(np.float32)
    res = None
    if residual:
        res = (_bf(rng.standard_normal((m, n)) * 2.0), (rng.standard_normal((1, n)) * 0.5).astype(np.float32),
               _bf(rng.standard_normal((m, n)) * 0.5), rng.standard_normal((m, R)).astype(np.float32),
               _bf(rng.standard_normal((R, n)) * 0.02))
    ref = jgemm.svdq_gemm_w4a4(*map(jnp.asarray, (qa, asc, w, ws, la, pu, bias)), precision="int8",
                               residual=None if res is None else tuple(map(jnp.asarray, res)))
    out = tgemm.svdq_gemm_w4a4(*map(_t, (qa, asc, w, ws, la, pu, bias)), precision="int8",
                               residual=None if res is None else tuple(map(_t, res)))
    assert out.dtype == torch.bfloat16 and _rel(out, ref) <= 1e-2


# ---------------------------------------------------------------------------
# the packed w4a8 route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 2], ids=["rank1", "grouped"])
def test_packed_gemm_rank256_matches_jax(monkeypatch, groups):
    """The packed GEMM's twin against ``_gemm_w4a8h_kernel`` (rank-1 under
    ``NUNCHAKU_TPU_W4A8_XLA=0``; grouped scales take it whatever the
    switch): every element within one bf16 step, at most 0.1% of them
    different (the R-term's f32 sum in another order); and bit for bit the
    int8 grouped twin on the dequantized weight."""
    monkeypatch.setenv("NUNCHAKU_TPU_W4A8_XLA", "0")
    rng = np.random.default_rng(80 + groups)
    m, k, n = 128, 3072 if groups > 1 else 512, 256
    qa, asc, qw, rs, ws, la, pu, bias = _packed_chain(rng, m, k, n, R)
    if groups > 1:
        asc = ((rng.random((groups, m)) + 0.5) / 127.0).astype(np.float32)
    ref = jgemm.svdq_gemm_w4a4(*map(jnp.asarray, (qa, asc, qw, ws, la, pu, bias)), rescales=jnp.asarray(rs),
                               precision="w4a8")
    args = tuple(map(_t, (qa, asc, qw, rs, ws, la, pu, bias)))
    out = (tgemm.gemm_w4a8 if groups == 1 else tgemm.gemm_w4a8_grouped)(*args)
    beyond, differ = _bf16_steps(out, ref)
    assert out.dtype == torch.bfloat16 and beyond == 0 and differ <= 1e-3, (beyond, differ)
    assert torch.equal(out, tgemm.gemm_w8a8_grouped(args[0], args[1], tgemm.dequant_w4a8(args[2], args[3]),
                                                    *args[4:]))


@pytest.mark.parametrize("unsigned", [False, True])
def test_packed_producer_rank256_matches_jax(unsigned):
    """The W4 producer's twin against ``_gemm_w4a8_gelu_quant_kernel``:
    codes at most one apart on at most 0.1%, scales within 1e-5, lora_next
    within 1e-2 of its max; bit for bit the int8 producer's twin on the
    dequantized weight."""
    rng = np.random.default_rng(90 + unsigned)
    m, k, n = 256, 512, 3072
    qa, asc, qw, rs, ws, la, pu, bias = _packed_chain(rng, m, k, n, R)
    rsm = (rng.random((n,)) + 0.5).astype(np.float32)
    pd = _bf(rng.standard_normal((n, R)) * 0.02)
    q_r, s_r, l_r = map(np.asarray, jgemm.svdq_gemm_w8a8_gelu_quant(
        *map(jnp.asarray, (qa, asc, qw, ws, la, pu, bias, rsm, pd)), act_unsigned_next=unsigned,
        gelu_shift=0.171875, rescales=jnp.asarray(rs), precision="w4a8"))
    args = tuple(map(_t, (qa, asc, qw, ws, la, pu, bias, rsm, pd)))
    q, s, l = tgemm.svdq_gemm_w8a8_gelu_quant(*args, act_unsigned_next=unsigned, rescales=_t(rs), precision="w4a8")
    assert l.shape == l_r.shape == (m, R)
    _codes_close(q, q_r)
    np.testing.assert_allclose(s.numpy(), s_r, rtol=1e-5)
    assert _rel(l, l_r) <= 1e-2
    int8 = tgemm.svdq_gemm_w8a8_gelu_quant(args[0], args[1], tgemm.dequant_w4a8(args[2], _t(rs)), *args[3:],
                                           act_unsigned_next=unsigned)
    assert all(torch.equal(a, b) for a, b in zip((q, s, l), int8))


ZI_R256 = dict(dim=256, layers=2, refiners=1, heads=2, cap=256, ffn_inner=512, t_dim=1024, rank=R)


def test_zimage_r256_stacked_packed_matches_jax(tmp_path, monkeypatch):
    """A Z-Image file in the ``svdq-int4_r256-z-image-turbo`` layout
    (``synth_checkpoint.zimage_state`` at rank 256, small dims) loaded at
    w4a8 by both loaders: the qkv projection's stacked buffers equal bit for
    bit, and the packed GEMM's stacked rank-1 twin on layer 1 of the stack
    (``NUNCHAKU_TPU_W4A8_XLA=0``) within one bf16 step of JAX's stacked
    ``_gemm_w4a8h_kernel`` on at most 0.1% of elements, and equal to the
    twin on the layer itself."""
    path = tmp_path / "zimage_r256.safetensors"
    synth_checkpoint.write(path, synth_checkpoint.zimage_state(**ZI_R256, device="cpu"))
    jm = jax_load_zimage(path, precision="w4a8")
    tm = load_zimage_transformer(path, precision="w4a8", device="cpu")
    jl, tl = jm.layers.attention.to_qkv, tm.layers.attention.to_qkv
    for name in ("qweight", "rescales", "wscales", "proj_down", "proj_up", "smooth"):
        np.testing.assert_array_equal(_np(getattr(tl, name)), _np(getattr(jl, name)))
    assert tl.qweight.shape == (2, 128, 768) and tl.proj_down.shape == (2, 256, R)
    monkeypatch.setenv("NUNCHAKU_TPU_W4A8_XLA", "0")
    rng = np.random.default_rng(97)
    x = jnp.asarray(rng.standard_normal((128, 256)), jnp.bfloat16)
    qa, asc, la = jquant.quantize_w4a4_act_fuse_lora(x, jl.proj_down[1], jl.smooth[1], precision="w4a8")
    layer = dict(rescales=jl.rescales[1], precision="w4a8")
    ref = jgemm.svdq_gemm_w4a4(qa, asc, jl.qweight, jl.wscales[1], la, jl.proj_up[1], None, **layer,
                               layer_idx=jnp.int32(1))
    idx = torch.tensor(1, dtype=torch.int32)
    args = (_t(qa), _t(asc), tl.qweight, _t(jl.rescales[1]), _t(jl.wscales[1]), _t(la), _t(jl.proj_up[1]))
    out = tgemm.gemm_w4a8(*args, layer_idx=idx)
    beyond, differ = _bf16_steps(out, ref)
    assert out.shape == (128, 768) and beyond == 0 and differ <= 1e-3, (beyond, differ)
    assert torch.equal(out, tgemm.gemm_w4a8(args[0], args[1], tl.qweight[1], *args[3:]))


# ---------------------------------------------------------------------------
# the LN + modulate + quantize producer and the qkv/RoPE producer
# ---------------------------------------------------------------------------


def _stream(rng, b, s, k):
    x = jnp.asarray(rng.standard_normal((b, s, k)) * 3.0 + rng.standard_normal((b, s, 1)), jnp.bfloat16)
    sc = jnp.asarray(rng.standard_normal((b, k)) * 0.3, jnp.float32)
    sh = jnp.asarray(rng.standard_normal((b, k)) * 0.3, jnp.float32)
    return x, sc, sh


def test_ln_mod_quant_rank256_matches_jax():
    """Codes at most one apart on at most 0.1%, scales within 1e-5, the
    rank-256 lora_act within 1e-2 of its max (row 6's bounds)."""
    rng = np.random.default_rng(110)
    b, s, k = 2, 96, 512
    x, sc, sh = _stream(rng, b, s, k)
    smooth = jnp.asarray(rng.uniform(0.5, 2.0, (k,)), jnp.bfloat16)
    pd = jnp.asarray(rng.standard_normal((k, R)) * 0.05, jnp.bfloat16)
    q_r, s_r, l_r = jquant.ln_mod_quant_int8(x, sc, sh, smooth, pd, bm=32)
    q, s_t, la = tquant.ln_mod_quant_int8(_t(x), _t(sc), _t(sh), _t(smooth), _t(pd))
    assert la.shape == (b * s, R)
    _codes_close(q, q_r)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_r), rtol=1e-5)
    assert _rel(la, l_r) <= 1e-2


def test_ln_mod_quant_dual_rank256_matches_jax():
    """The dual producer with heads of rank 256 and 144: each head within
    row 6's bounds of JAX's dual kernel."""
    rng = np.random.default_rng(111)
    b, s, k = 1, 256, 512
    x, sc, sh = _stream(rng, b, s, k)
    heads = [(jnp.asarray(rng.uniform(0.5, 2.0, (k,)), jnp.bfloat16),
              jnp.asarray(rng.standard_normal((k, r)) * 0.05, jnp.bfloat16)) for r in (R, 144)]
    args = (x, sc, sh) + heads[0] + heads[1]
    ref = jquant.ln_mod_quant_int8_dual(*args)
    out = tquant.ln_mod_quant_int8_dual(*map(_t, args))
    for (q, s_t, la), (q_r, s_r, l_r), r in zip(out, ref, (R, 144)):
        assert la.shape == (b * s, r)
        _codes_close(q, q_r)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_r), rtol=1e-5)
        assert _rel(la, l_r) <= 1e-2


def test_qkv_rope_producer_rank256_matches_jax():
    """One stream at rank 256: q, k, v within 1e-2 of their max (row 7's
    bound)."""
    rng = np.random.default_rng(112)
    b, s, heads, d = 1, 128, 2, 128
    qkv = jnp.asarray(rng.standard_normal((b, s, 3 * heads * d)) * 2.0, jnp.bfloat16)
    nq, nk = (jnp.asarray(rng.uniform(0.5, 1.5, (d,)), jnp.bfloat16) for _ in range(2))
    ang = rng.random((s, d // 2)) * 6.0
    cos = jnp.asarray(np.concatenate([np.cos(ang)] * 2, -1), jnp.float32)
    sin = jnp.asarray(np.concatenate([-np.sin(ang), np.sin(ang)], -1), jnp.float32)
    la = jnp.asarray(rng.standard_normal((b, s, R)), jnp.float32)
    pu = jnp.asarray(rng.standard_normal((R, 3 * heads * d)) * 0.05, jnp.bfloat16)
    scale = jops_att.LOG2E / math.sqrt(d)
    ref = jops_att.qkv_rope_producer(qkv, cos, sin, nq, nk, heads=heads, head_dim=d, q_scale=scale, lora_act=la,
                                     proj_up=pu)
    out = tops_att.qkv_rope_producer(*map(_t, (qkv, cos, sin, nq, nk)), q_scale=scale, lora_act=_t(la),
                                     proj_up=_t(pu))
    for o, rf in zip(out, ref):
        assert tuple(o.shape) == tuple(rf.shape) == (b, heads, s, d)
        assert _rel(o, rf) <= 1e-2
