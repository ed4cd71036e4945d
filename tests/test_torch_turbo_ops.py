"""Parity of the port's bf16-stream (turbo) pieces with the JAX package at
small sizes (CPU): the LN + modulate + quantize producer, the qkv/RoPE
producer, the grouped consumer's gated-residual mode, the half-split weight
permutation, and the modules built on them.

The JAX kernels run as the JAX package's own tests run them on the CPU
(Pallas interpret mode); the port's wrappers run their plain twins (CPU
tensors). Inputs come from seeded numpy generators; each test states its
tolerance.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models import attention as jatt
from nunchaku_tpu.models import embeddings as jemb
from nunchaku_tpu.models import linear as jlin
from nunchaku_tpu.models import normalization as jnorm
from nunchaku_tpu.ops import attention as jops_att
from nunchaku_tpu.ops import gemm as jgemm
from nunchaku_tpu.ops import quantize as jquant
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.models import attention as tatt
from nunchaku_tpu_torch.models import embeddings as temb
from nunchaku_tpu_torch.models import linear as tlin
from nunchaku_tpu_torch.models import transformer_flux as tflux
from nunchaku_tpu_torch.ops import attention as tops_att
from nunchaku_tpu_torch.ops import gemm as tgemm
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


def port_svdq(jl):
    return tlin.SVDQW4A4Linear(
        _t(jl.qweight), _t(jl.wscales), _t(jl.smooth), _t(jl.proj_down), _t(jl.proj_up),
        None if jl.bias is None else _t(jl.bias), None if jl.rescales is None else _t(jl.rescales),
        precision=jl.precision)


def port_attention(ja):
    opt = lambda x, f: None if x is None else f(x)
    return tatt.FluxAttention(
        port_svdq(ja.to_qkv), _t(ja.norm_q), _t(ja.norm_k), opt(ja.to_out, port_svdq),
        opt(ja.add_qkv_proj, port_svdq), opt(ja.norm_added_q, _t), opt(ja.norm_added_k, _t),
        opt(ja.to_add_out, port_svdq), head_dim=ja.head_dim)


# ---------------------------------------------------------------------------
# kernel 5: LN + modulate + quantize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,mod", [(1, True), (2, True), (1, False), (2, False)])
def test_ln_mod_quant_matches_jax(b, mod):
    """Codes at most one apart on at most 0.1% of elements, scales rel <=
    1e-5, lora_act rel <= 1e-2 (XLA sums the LayerNorm in another order)."""
    rng = np.random.default_rng(40 + b)
    s, k, r = 96, 512, 32
    x = _bf16(rng, (b, s, k), 3.0) + _bf16(rng, (b, s, 1))
    sc = jnp.asarray(rng.standard_normal((b, k)) * 0.3, jnp.float32) if mod else None
    sh = jnp.asarray(rng.standard_normal((b, k)) * 0.3, jnp.float32) if mod else None
    smooth = jnp.asarray(rng.uniform(0.5, 2.0, (k,)), jnp.bfloat16)
    pd = _bf16(rng, (k, r), 0.05)
    q_r, s_r, l_r = jquant.ln_mod_quant_int8(x, sc, sh, smooth, pd, bm=32)
    q, sc_t, la = tquant.ln_mod_quant_int8(_t(x), None if sc is None else _t(sc),
                                           None if sh is None else _t(sh), _t(smooth), _t(pd))
    assert q.shape == (b * s, k) and sc_t.shape == (1, b * s) and la.shape == (b * s, r)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(q_r, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    s_r = np.asarray(s_r)
    assert np.max(np.abs(sc_t.numpy() - s_r) / s_r) <= 1e-5
    assert _rel(la, l_r) <= 1e-2


# ---------------------------------------------------------------------------
# kernel 6: qkv / RoPE producer
# ---------------------------------------------------------------------------


def _rope_inputs(rng, s_all, d):
    ids = np.zeros((s_all, 3), np.int32)
    ids[:, 1] = np.arange(s_all) // 16
    ids[:, 2] = np.arange(s_all) % 16
    rot = jemb.rope_table(jnp.asarray(ids), (16, 56, 56))
    cos, sin = jops_att.rope_table_halfsplit(rot)
    t_cos, t_sin = tops_att.rope_table_halfsplit(_t(rot))
    np.testing.assert_array_equal(t_cos.numpy(), np.asarray(cos))
    np.testing.assert_array_equal(t_sin.numpy(), np.asarray(sin))
    return cos, sin


@pytest.mark.parametrize("lora", [True, False])
def test_qkv_rope_producer_matches_jax(lora):
    """One stream (the single block's call); q, k, v rel <= 1e-2."""
    rng = np.random.default_rng(50)
    b, s, heads, d, r = 1, 256, 2, 128, 32
    qkv = _bf16(rng, (b, s, 3 * heads * d), 2.0)
    nq, nk = (jnp.asarray(rng.uniform(0.5, 1.5, (d,)), jnp.bfloat16) for _ in range(2))
    cos, sin = _rope_inputs(rng, s, d)
    la = jnp.asarray(rng.standard_normal((b, s, r)), jnp.float32) if lora else None
    pu = _bf16(rng, (r, 3 * heads * d), 0.05) if lora else None
    scale = jops_att.LOG2E / math.sqrt(d)
    ref = jops_att.qkv_rope_producer(qkv, cos, sin, nq, nk, heads=heads, head_dim=d, q_scale=scale,
                                     lora_act=la, proj_up=pu)
    out = tops_att.qkv_rope_producer(_t(qkv), _t(cos), _t(sin), _t(nq), _t(nk), q_scale=scale,
                                     lora_act=None if la is None else _t(la),
                                     proj_up=None if pu is None else _t(pu))
    for o, rf in zip(out, ref):
        assert tuple(o.shape) == tuple(rf.shape) == (b, heads, s, d)
        assert _rel(o, rf) <= 1e-2


@pytest.mark.parametrize("lora", [True, False])
def test_qkv_rope_producer_shared_buffer_matches_jax(lora):
    """The dual block's two calls into one joint buffer: img rows at
    S_txt, then txt rows at 0 (JAX out_s / s_offset / alias_outs)."""
    rng = np.random.default_rng(51)
    b, s_txt, s_img, heads, d, r = 1, 128, 256, 2, 128, 32
    qkv_i, qkv_t = _bf16(rng, (b, s_img, 3 * heads * d), 2.0), _bf16(rng, (b, s_txt, 3 * heads * d), 2.0)
    nq, nk, nq2, nk2 = (jnp.asarray(rng.uniform(0.5, 1.5, (d,)), jnp.bfloat16) for _ in range(4))
    cos, sin = _rope_inputs(rng, s_txt + s_img, d)
    la_i = jnp.asarray(rng.standard_normal((b, s_img, r)), jnp.float32) if lora else None
    la_t = jnp.asarray(rng.standard_normal((b, s_txt, r)), jnp.float32) if lora else None
    pu_i, pu_t = (_bf16(rng, (r, 3 * heads * d), 0.05) if lora else None for _ in range(2))
    kw = dict(heads=heads, head_dim=d, q_scale=0.25, bm=128)
    q, k, v = jops_att.qkv_rope_producer(qkv_i, cos[s_txt:], sin[s_txt:], nq, nk, out_s=s_txt + s_img,
                                         s_offset=s_txt, lora_act=la_i, proj_up=pu_i, **kw)
    ref = jops_att.qkv_rope_producer(qkv_t, cos[:s_txt], sin[:s_txt], nq2, nk2, alias_outs=(q, k, v),
                                     lora_act=la_t, proj_up=pu_t, **kw)
    opt = lambda a: None if a is None else _t(a)
    joint = tuple(torch.empty((b, heads, s_txt + s_img, d), dtype=torch.bfloat16) for _ in range(3))
    tc, ts = _t(cos), _t(sin)
    tops_att.qkv_rope_producer(_t(qkv_i), tc[s_txt:], ts[s_txt:], _t(nq), _t(nk), q_scale=0.25,
                               lora_act=opt(la_i), proj_up=opt(pu_i), out=joint, s_offset=s_txt)
    out = tops_att.qkv_rope_producer(_t(qkv_t), tc[:s_txt], ts[:s_txt], _t(nq2), _t(nk2), q_scale=0.25,
                                     lora_act=opt(la_t), proj_up=opt(pu_t), out=joint, s_offset=0)
    assert all(o is j for o, j in zip(out, joint))
    for o, rf in zip(out, ref):
        assert tuple(o.shape) == tuple(rf.shape)
        assert _rel(o, rf) <= 1e-2


def test_qkv_rope_producer_rejects_rows_outside_the_buffer():
    qkv = torch.zeros((1, 100, 3 * 2 * 128), dtype=torch.bfloat16)
    cos = torch.zeros((100, 128))
    buf = tuple(torch.empty((1, 2, 150, 128), dtype=torch.bfloat16) for _ in range(3))
    with pytest.raises(ValueError, match="do not fit"):
        tops_att.qkv_rope_producer(qkv, cos, cos, torch.ones(128), torch.ones(128), out=buf, s_offset=60)


# ---------------------------------------------------------------------------
# mode 3': the grouped consumer's gated-residual epilogue
# ---------------------------------------------------------------------------


def _gemm_operands(rng, m, k, n, groups, r=32):
    qa = jnp.asarray(rng.integers(-127, 128, (m, k)), jnp.int8)
    asc = jnp.asarray((rng.random((groups, m)) + 0.5) / 127.0, jnp.float32)
    qw = jnp.asarray(rng.integers(-127, 128, (k, n)), jnp.int8)
    ws = jnp.asarray((rng.random((1, n)) + 0.5) / (73.0 * math.sqrt(k)), jnp.float32)
    la = jnp.asarray(rng.standard_normal((m, r)), jnp.float32)
    pu = _bf16(rng, (r, n), 0.02)
    bias = _bf16(rng, (n,), 0.02)
    return qa, asc, qw, ws, la, pu, bias


@pytest.mark.parametrize("groups,full", [(2, False), (2, True), (1, False), (1, True)])
def test_residual_epilogue_matches_jax(groups, full):
    """``svdq_gemm_w4a4(..., precision="int8", residual=...)``: grouped
    scales (G 2) take the fused consumer epilogue in both packages,
    per-token scales (G 1) the standalone GEMM plus ``res_apply``; with
    ``(x, gate)`` and with the full operand set. rel <= 1e-2."""
    rng = np.random.default_rng(60 + groups + 2 * full)
    m, k, n, r = 256, 1024, 256, 32
    ops = _gemm_operands(rng, m, k, n, groups, r)
    res = (_bf16(rng, (m, n), 2.0), jnp.asarray(rng.standard_normal((1, n)) * 0.5, jnp.float32))
    if full:
        res = res + (_bf16(rng, (m, n), 0.5), jnp.asarray(rng.standard_normal((m, r)), jnp.float32),
                     _bf16(rng, (r, n), 0.02))
    ref = jgemm.svdq_gemm_w4a4(*ops, precision="int8", residual=res)
    out = tgemm.svdq_gemm_w4a4(*map(_t, ops), precision="int8", residual=tuple(map(_t, res)))
    assert tuple(out.shape) == tuple(ref.shape) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 1e-2


def test_res_apply_batches_rows_by_gate():
    """Row m of an (M, N) output takes gate[m // S]; the (B, S, N) form
    gives the same result."""
    rng = np.random.default_rng(64)
    b, s, n = 2, 6, 8
    out = torch.from_numpy(rng.standard_normal((b * s, n)).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((b * s, n)).astype(np.float32)).to(torch.bfloat16)
    gate = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    flat = tgemm.res_apply(out, x, gate)
    want = (x.float().reshape(b, s, n) + gate[:, None] * out.float().reshape(b, s, n)).to(torch.bfloat16)
    assert torch.equal(flat.reshape(b, s, n), want)
    assert torch.equal(tgemm.res_apply(out.reshape(b, s, n), x.reshape(b, s, n), gate), want)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["w4a8", "int8"])
def test_permute_qk_halfsplit_bit_exact(precision):
    """Every permuted buffer equals the JAX permutation's; an int8 weight
    stays K-contiguous."""
    ja = jatt.FluxAttention.random_init(jax.random.PRNGKey(8), 256, 2, 128, joint=True, precision=precision)
    ta = port_attention(ja)
    jatt.permute_qk_halfsplit(ja)
    tatt.permute_qk_halfsplit(ta)
    assert ta.prep_fused
    for lin in ("to_qkv", "add_qkv_proj"):
        for name in ("qweight", "wscales", "proj_up", "bias", "rescales"):
            jt = getattr(getattr(ja, lin), name)
            tt = getattr(getattr(ta, lin), name)
            assert (jt is None) == (tt is None)
            if jt is not None:
                np.testing.assert_array_equal(_np(tt) if tt.dtype != torch.int8 else tt.numpy(),
                                              np.asarray(jt, np.float32 if tt.dtype != torch.int8 else np.int8))
        if precision == "int8":
            assert getattr(ta, lin).qweight.t().is_contiguous()
    for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
        np.testing.assert_array_equal(_np(getattr(ta, name)), np.asarray(getattr(ja, name), np.float32))
    with pytest.raises(ValueError):
        tatt.permute_qk_halfsplit(ta)


@pytest.mark.parametrize("precision,s", [("w4a8", 64), ("int8", 64), ("w4a8", 77), ("int8", 77)],
                         ids=["w4a8", "int8", "w4a8-ragged", "int8-ragged"])
def test_forward_modulated_matches_jax(precision, s):
    """The producer feeds the GEMM at every S. At a ragged S (77: no tile
    divisor) the JAX method takes its multi-pass chain and keeps the
    low-rank term in the GEMM, so the port's ``skip_lora`` parts are held
    to JAX's ``forward_parts`` of the modulated stream. rel <= 1e-2."""
    jl = jlin.SVDQW4A4Linear.random_init(jax.random.PRNGKey(9), 512, 384, precision=precision)
    rng = np.random.default_rng(70)
    x = _bf16(rng, (2, s, 512), 2.0)
    sc, sh = (jnp.asarray(rng.standard_normal((2, 512)) * 0.3, jnp.float32) for _ in range(2))
    tl = port_svdq(jl)
    ref = jl.forward_modulated(x, sc, sh)
    assert _rel(tl.forward_modulated(_t(x), _t(sc), _t(sh)), ref) <= 1e-2
    ref_main, ref_la = jl.forward_modulated(x, sc, sh, skip_lora=True)
    if ref_la is None:
        y = jnorm.layer_norm(x) * (1.0 + sc)[:, None] + sh[:, None]
        ref_main, ref_la = jl.forward_parts(y.astype(jnp.bfloat16))
    main, la = tl.forward_modulated(_t(x), _t(sc), _t(sh), skip_lora=True)
    assert tuple(main.shape) == (2, s, 384) and tuple(la.shape) == (2, s, 32)
    assert _rel(main, ref_main) <= 1e-2 and _rel(la, ref_la) <= 1e-2
    main_p, la_p = tl.forward_parts(_t(x))
    ref_main_p, ref_la_p = jl.forward_parts(x)
    assert _rel(main_p, ref_main_p) <= 1e-2 and _rel(la_p, ref_la_p) <= 1e-2


@pytest.mark.parametrize("joint", [True, False])
def test_fused_flux_attention_matches_jax(joint):
    """The fused prologue with mods (raw streams, LN + modulate in the
    projections, low-rank terms in the producer) against JAX's; rel <= 2e-2."""
    ja = jatt.FluxAttention.random_init(jax.random.PRNGKey(10), 256, 2, 128, joint=joint, precision="w4a8")
    ta = port_attention(ja)
    jatt.permute_qk_halfsplit(ja)
    ja.prep_producer = True
    tatt.permute_qk_halfsplit(ta)
    rng = np.random.default_rng(71)
    s_txt, s_img = 128, 256
    img = _bf16(rng, (1, s_img, 256), 2.0)
    txt = _bf16(rng, (1, s_txt, 256), 2.0) if joint else None
    mods = [(jnp.asarray(rng.standard_normal((1, 256)) * 0.3 + 0.5, jnp.float32),
             jnp.asarray(rng.standard_normal((1, 256)) * 0.3 + 1.0, jnp.float32)) for _ in range(2)]
    ids = np.zeros(((s_txt if joint else 0) + s_img, 3), np.int32)
    ids[:, 2] = np.arange(ids.shape[0])
    rot = jops_att.rope_table_halfsplit(jemb.rope_table(jnp.asarray(ids), (16, 56, 56)))
    jmods = (mods[0], mods[1] if joint else None)
    ref = ja(img, txt, rot, mods=jmods)
    tmods = tuple(None if m is None else tuple(map(_t, m)) for m in jmods)
    out = ta(_t(img), None if txt is None else _t(txt), tuple(map(_t, rot)), mods=tmods)
    ref, out = (ref, out) if joint else ((ref,), (out,))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        assert _rel(o, r) <= 2e-2


def test_rope_layout_mismatch_raises():
    """Weights and rope table in different layouts raise in both
    directions, and the model's rope layout is read from its attention
    modules: a block left unpermuted then refuses the half-split table."""
    ja = jatt.FluxAttention.random_init(jax.random.PRNGKey(12), 256, 2, 128, joint=False, precision="w4a8")
    ta = port_attention(ja)
    s = 64
    ids = torch.zeros((s, 3), dtype=torch.int32)
    ids[:, 2] = torch.arange(s)
    rot = temb.rope_table(ids, (16, 56, 56))
    pair = tops_att.rope_table_halfsplit(rot)
    x = torch.from_numpy(np.random.default_rng(73).standard_normal((1, s, 256)).astype(np.float32))
    x = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="fused prologue"):
        ta(x, None, pair)
    tatt.permute_qk_halfsplit(ta)
    with pytest.raises(ValueError, match="half-split order"):
        ta(x, None, rot)
    assert tuple(ta(x, None, pair).shape) == (1, s, 256)

    tm = tflux.FluxTransformer2DModel.random_init(
        tflux.FluxConfig(num_layers=1, num_single_layers=1, num_attention_heads=2,
                         joint_attention_dim=256, pooled_projection_dim=256, precision="w4a8"), seed=0,
        device="cpu")
    assert not tm.rope_halfsplit
    tatt.permute_qk_halfsplit(tm.transformer_blocks.attn)  # the dual stack only
    assert tm.rope_halfsplit
    with pytest.raises(ValueError, match="fused prologue"):
        tm.layer_views()["single_transformer_blocks"][0].attn(x, None, pair)


@pytest.mark.parametrize("precision,dim,s,full", [("w4a8", 768, 256, False), ("w4a8", 768, 256, True),
                                                  ("int8", 256, 256, True), ("w4a8", 768, 200, True)])
def test_gelu_mlp_mod_residual_matches_jax(precision, dim, s, full):
    """gelu_mlp(mod=, residual=): the producer on the raw stream and the
    gated residual in the consumer (dim 768: two scale groups, the fused
    epilogue; dim 256: one group, res_apply; S 200: rows padded for the
    chain, the residual applied after the slice); rel <= 2e-2."""
    jf = jatt.FeedForward.random_init(jax.random.PRNGKey(11), dim, precision=precision)
    rng = np.random.default_rng(72)
    x = _bf16(rng, (1, s, dim), 2.0)
    mod = tuple(jnp.asarray(rng.standard_normal((1, dim)) * 0.3, jnp.float32) for _ in range(2))
    res = (x, jnp.asarray(rng.standard_normal((1, dim)) * 0.5, jnp.float32))
    if full:
        res = res + (_bf16(rng, (1, s, dim), 0.5), jnp.asarray(rng.standard_normal((1, s, 32)), jnp.float32),
                     _bf16(rng, (32, dim), 0.02))
    ref = jf(x, mod=mod, residual=res)
    out = tatt.FeedForward(port_svdq(jf.fc1), port_svdq(jf.fc2))(_t(x), mod=tuple(map(_t, mod)),
                                                                 residual=tuple(map(_t, res)))
    assert tuple(out.shape) == tuple(ref.shape) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 2e-2
