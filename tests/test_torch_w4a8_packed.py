"""The packed-int4 w4a8 route of the port (``NUNCHAKU_TPU_W4A8_XLA=0``,
``NUNCHAKU_TPU_W4A8_FUSED=1``) against the JAX package (CPU): the plain
twins of the packed GEMM (rank-1 and grouped modes) and of the W4 chain
producer against the Pallas kernels in interpret mode, ``gelu_mlp`` and a
small FLUX model under the route switches against the JAX ones under the
same switches, and the nvfp4-a8 (e2m1) linears that keep the dequant route.

Inputs come from seeded numpy generators; each test states its tolerance.
The JAX package reads the switches while it traces, so each test sets the
environment (monkeypatch) before its first JAX call and traces anew.

XLA on the CPU contracts ``acc + d * as`` into one fused multiply-add; the
port keeps the two roundings the JAX source writes (and its Hopper kernels
make). So the rank-1 product, scales and bias match bit for bit, and where
an f32 sum of products follows (the grouped scale sum, the low-rank term,
the producer's epilogue) the outputs may differ by one bf16 step on a few
elements.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.core.packing import pack_int4
from nunchaku_tpu.models import attention as jatt
from nunchaku_tpu.models import linear as jlin
from nunchaku_tpu.models.transformers.transformer_flux import FluxConfig as JaxFluxConfig
from nunchaku_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from nunchaku_tpu.ops import gemm as jgemm
from nunchaku_tpu.ops.quantize import quantize_w4a4_act_fuse_lora
from nunchaku_tpu_torch.convert import flux_from_jax_params, to_torch
from nunchaku_tpu_torch.models import attention as tatt
from nunchaku_tpu_torch.models import linear as tlin
from nunchaku_tpu_torch.models.transformer_flux import FluxConfig
from nunchaku_tpu_torch.ops import gemm as tgemm

from test_torch_flux import S_IMG, _inputs

SWITCHES = [("1", "0"), ("1", "1"), ("0", "1"), ("0", "0")]  # (NUNCHAKU_TPU_W4A8_XLA, NUNCHAKU_TPU_W4A8_FUSED)
SMALL = dict(num_layers=2, num_single_layers=2, num_attention_heads=6, joint_attention_dim=512,
             pooled_projection_dim=256)  # dim 768: the MLP's 3072 hidden columns make two requantize groups


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
    """Elements further apart than one bf16 rounding step (2^-7 |ref|, plus
    1e-4 of max |ref| for sums that cancel), and the share that differs."""
    out, ref = _np(out), _np(ref)
    beyond = int((np.abs(out - ref) > 2.0 ** -7 * np.abs(ref) + 1e-4 * np.abs(ref).max()).sum())
    return beyond, float((out != ref).mean())


def _switch(monkeypatch, xla, fused):
    monkeypatch.setenv("NUNCHAKU_TPU_W4A8_XLA", xla)
    monkeypatch.setenv("NUNCHAKU_TPU_W4A8_FUSED", fused)


@pytest.fixture
def routes(monkeypatch):
    """Calls per route of the port's w4a8 GEMMs: the packed GEMM's two
    modes, the W4 producer, the dequant, and the LN + modulate + quantize
    producer (by their callers' names)."""
    calls = {"gemm_w4a8": 0, "gemm_w4a8_grouped": 0, "gemm_w4a8_gelu_quant": 0, "dequant_w4a8": 0,
             "ln_mod_quant_int8": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name, attr in (("gemm_w4a8", "gemm_w4a8"), ("gemm_w4a8_grouped", "gemm_w4a8_grouped"),
                       ("gemm_w4a8_gelu_quant", "svdq_gemm_w4a8_gelu_quant"), ("dequant_w4a8", "dequant_w4a8")):
        monkeypatch.setattr(tgemm, attr, spy(name, getattr(tgemm, attr)))
    monkeypatch.setattr(tatt, "dequant_w4a8", spy("dequant_w4a8", tatt.dequant_w4a8))
    for module in (tatt, tlin):
        monkeypatch.setattr(module, "ln_mod_quant_int8", spy("ln_mod_quant_int8", module.ln_mod_quant_int8))
    return calls


def test_switches_read_at_call_time(monkeypatch):
    monkeypatch.delenv("NUNCHAKU_TPU_W4A8_XLA", raising=False)
    monkeypatch.delenv("NUNCHAKU_TPU_W4A8_FUSED", raising=False)
    assert tgemm.w4a8_use_xla() and not tgemm.w4a8_fused()  # the JAX defaults
    assert tgemm.w4a8_use_xla() == jgemm._w4a8_use_xla(0, 0, 0) and tgemm.w4a8_fused() == jgemm._w4a8_fused()
    _switch(monkeypatch, "0", "1")
    assert not tgemm.w4a8_use_xla() and tgemm.w4a8_fused()
    assert tgemm.w4a8_use_xla() == jgemm._w4a8_use_xla(0, 0, 0) and tgemm.w4a8_fused() == jgemm._w4a8_fused()


def _rank1_inputs(r, seed=29):
    """tests/test_ops.py:430-459's case (m 128, k 512, n 256, g 64) with
    every int4 code (-8 too) and rescales up to 127 / 7."""
    rng = np.random.default_rng(seed + r)
    m, k, n, g = 128, 512, 256, 64
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    pd = jnp.asarray(rng.standard_normal((k, r)) * 0.05, jnp.bfloat16)
    pu = jnp.asarray(rng.standard_normal((r, n)) * 0.05, jnp.bfloat16)
    sm = jnp.asarray(np.abs(rng.standard_normal(k)) + 0.5, jnp.bfloat16)
    bias = jnp.asarray(rng.standard_normal(n) * 0.1, jnp.bfloat16)
    qw = jnp.asarray(pack_int4(rng.integers(-8, 8, (k, n)), axis=0))
    rs = jnp.asarray(rng.random((k // g, n)) * (127.0 / 7.0 - 1.0) + 1.0, jnp.bfloat16)
    ws = jnp.asarray(rng.random((1, n)) * 0.01 + 0.001, jnp.float32)
    qa, asc, la = quantize_w4a4_act_fuse_lora(x, pd, sm, precision="w4a8")
    return qa, asc, qw, rs, ws, la, pu, bias


@pytest.mark.parametrize("route", ["hoisted", "tiles"])
@pytest.mark.parametrize("lora,bias", [(True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("r", [32, 128])
def test_packed_gemm_rank1_matches_jax(monkeypatch, route, lora, bias, r):
    """The rank-1 twin against ``_gemm_w4a8h_kernel`` (``W4A8_XLA=0``,
    default tiles) and ``_gemm_w4a8_kernel`` (explicit tiles bm 64, bn 128,
    bk 512). Bit for bit without the low-rank term; with it, every element
    within one bf16 step and at most 0.1% of them different (the R-term's f32
    sum in another order than XLA's dot)."""
    qa, asc, qw, rs, ws, la, pu, b = _rank1_inputs(r)
    la, pu = (la, pu) if lora else (None, None)
    b = b if bias else None
    if route == "hoisted":
        _switch(monkeypatch, "0", "0")
        ref = jgemm.svdq_gemm_w4a4(qa, asc, qw, ws, la, pu, b, rescales=rs, precision="w4a8")
    else:
        ref = jgemm.svdq_gemm_w4a4(qa, asc, qw, ws, la, pu, b, rescales=rs, precision="w4a8", bm=64, bn=128, bk=512)
    out = tgemm.gemm_w4a8(*map(_t, (qa, asc, qw, rs, ws, la, pu, b)))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == tuple(ref.shape)
    if not lora:
        np.testing.assert_array_equal(_np(out), _np(ref))
    beyond, differ = _bf16_steps(out, ref)
    assert beyond == 0 and differ <= 1e-3, (beyond, differ)
    assert tgemm.COUNTS["gemm_w4a8"].launches == 0  # the CPU takes the twin


def _chain_inputs(rng, m, k, n, r):
    qa = rng.integers(-127, 128, (m, k), dtype=np.int8)
    qw = np.asarray(pack_int4(rng.integers(-8, 8, (k, n)), axis=0))
    rs = _bf(rng.random((k // 64, n)) * (127.0 / 7.0 - 1.0) + 1.0)
    asc = ((rng.random((1, m)) + 0.5) / 127.0).astype(np.float32)
    ws = ((rng.random((1, n)) + 0.5) / (73.0 * np.sqrt(k) * 8.0)).astype(np.float32)
    la = rng.standard_normal((m, r)).astype(np.float32)
    return qa, asc, qw, rs, ws, la, _bf(rng.standard_normal((r, n)) * 0.02), _bf(rng.standard_normal((n,)) * 0.02)


@pytest.mark.parametrize("lora", [True, False])
@pytest.mark.parametrize("r", [32, 128])
def test_packed_grouped_matches_jax(lora, r):
    """The grouped twin (2 groups of 1536) against ``_gemm_w4a8h_kernel``'s
    grouped mode, which JAX runs for grouped scales whatever the switches:
    one bf16 step at most (XLA's fused multiply-add in the group sum), on at
    most 0.1% of elements; and bit for bit the int8 grouped twin on the
    dequantized weight (the port's two routes, as tests/test_ops.py:461-480
    pins JAX's)."""
    rng = np.random.default_rng(4 + r)
    qa, _, qw, rs, ws, la, pu, bias = _chain_inputs(rng, 256, 3072, 256, r)
    asc = ((rng.random((2, 256)) + 0.5) / 127.0).astype(np.float32)
    la, pu = (la, pu) if lora else (None, None)
    ref = jgemm.svdq_gemm_w4a4(*(None if v is None else jnp.asarray(v) for v in (qa, asc, qw, ws, la, pu, bias)),
                               rescales=jnp.asarray(rs), precision="w4a8")
    args = tuple(map(_t, (qa, asc, qw, rs, ws, la, pu, bias)))
    out = tgemm.gemm_w4a8_grouped(*args)
    beyond, differ = _bf16_steps(out, ref)
    assert out.dtype == torch.bfloat16 and beyond == 0 and differ <= 1e-3, (beyond, differ)
    w8 = tgemm.dequant_w4a8(args[2], args[3])
    assert torch.equal(out, tgemm.gemm_w8a8_grouped(args[0], args[1], w8, *args[4:]))
    assert torch.equal(tgemm.svdq_gemm_w4a4(*args[:3], args[4], *args[5:], args[3], precision="w4a8"), out)


@pytest.mark.parametrize("unsigned", [False, True])
@pytest.mark.parametrize("r", [32, 128])
def test_packed_producer_matches_jax(unsigned, r):
    """The W4 producer's twin against ``_gemm_w4a8_gelu_quant_kernel`` (K 512
    in one k step): codes at most one apart on at most 0.1% of them, scales
    within 1e-5 (XLA's tanh and fused multiply-adds in the epilogue: a code
    at a .5 boundary may flip, as for the int8 producer), lora_next within
    1e-2 of its max (f32 sums over other column tiles); and bit for bit the
    int8 producer's twin on the dequantized weight."""
    rng = np.random.default_rng(3 + r)
    m, k, n = 256, 512, 3072
    qa, asc, qw, rs, ws, la, pu, bias = _chain_inputs(rng, m, k, n, r)
    rsm = (rng.random((n,)) + 0.5).astype(np.float32)
    pd = _bf(rng.standard_normal((n, r)) * 0.02)
    q_ref, s_ref, l_ref = map(np.asarray, jgemm.svdq_gemm_w8a8_gelu_quant(
        *map(jnp.asarray, (qa, asc, qw, ws, la, pu, bias, rsm, pd)), act_unsigned_next=unsigned,
        gelu_shift=0.171875, rescales=jnp.asarray(rs), precision="w4a8"))
    args = tuple(map(_t, (qa, asc, qw, ws, la, pu, bias, rsm, pd)))
    q, s, l = tgemm.svdq_gemm_w8a8_gelu_quant(*args, act_unsigned_next=unsigned, rescales=_t(rs), precision="w4a8")
    assert q.shape == q_ref.shape and s.shape == s_ref.shape == (2, m) and l.shape == l_ref.shape == (m, r)
    diff = np.abs(q.numpy().astype(np.int32) - q_ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-5)
    assert _rel(l, l_ref) <= 1e-2
    int8 = tgemm.svdq_gemm_w8a8_gelu_quant(args[0], args[1], tgemm.dequant_w4a8(args[2], _t(rs)), *args[3:],
                                           act_unsigned_next=unsigned)
    assert all(torch.equal(a, b) for a, b in zip((q, s, l), int8))


def _port_svdq(jl):
    return tlin.SVDQW4A4Linear(
        _t(jl.qweight), _t(jl.wscales), _t(jl.smooth), _t(jl.proj_down), _t(jl.proj_up), _t(jl.bias),
        _t(jl.rescales), precision=jl.precision, wcodes=getattr(jl, "wcodes", "int4"))


# calls per route of one gelu_mlp, by (XLA, FUSED) and requantize groups (dim 768: 2, dim 256: 1)
MLP_ROUTES = {
    ("1", "0"): {2: dict(dequant_w4a8=2), 1: dict(dequant_w4a8=2)},
    ("1", "1"): {2: dict(gemm_w4a8_gelu_quant=1, gemm_w4a8_grouped=1),
                 1: dict(gemm_w4a8_gelu_quant=1, dequant_w4a8=1)},  # one group: a rank-1 consumer
    ("0", "1"): {2: dict(gemm_w4a8_gelu_quant=1, gemm_w4a8_grouped=1),
                 1: dict(gemm_w4a8_gelu_quant=1, gemm_w4a8=1)},
    ("0", "0"): {2: dict(gemm_w4a8=2), 1: dict(gemm_w4a8=2)},  # unchained: fc1, GELU, fc2
}


@pytest.mark.parametrize("dim", [768, 256])
@pytest.mark.parametrize("switches", SWITCHES, ids=lambda s: f"xla{s[0]}-fused{s[1]}")
def test_gelu_mlp_route_switches_match_jax(monkeypatch, routes, switches, dim):
    """``gelu_mlp`` under each combination of the two switches against JAX's
    under the same: max error <= 2e-2 of the reference's max |value| (codes
    flip at .5 boundaries, as in tests/test_torch_modules.py), through the
    routes JAX takes; the packed chain bit for bit the dequant route's."""
    _switch(monkeypatch, *switches)
    jf = jatt.FeedForward.random_init(jax.random.PRNGKey(7), dim, precision="w4a8")
    x = jnp.asarray(np.random.default_rng(22).standard_normal((1, 200, dim)), jnp.bfloat16)
    ref = jf(x)
    fc1, fc2 = _port_svdq(jf.fc1), _port_svdq(jf.fc2)
    out = tatt.gelu_mlp(fc1, fc2, _t(x))
    assert tuple(out.shape) == tuple(ref.shape) and _rel(out, ref) <= 2e-2
    groups = 2 if dim == 768 else 1
    assert {k: v for k, v in routes.items() if v} == MLP_ROUTES[switches][groups]
    if switches[1] == "1" and (switches[0] == "1" or groups == 2):  # the same consumer mode on both routes
        _switch(monkeypatch, "1", "0")  # the dequant route's int8 chain
        assert torch.equal(tatt.gelu_mlp(fc1, fc2, _t(x)), out)


@pytest.fixture(scope="module")
def small_flux():
    jm = JaxFlux.random_init(jax.random.PRNGKey(5), JaxFluxConfig(precision="w4a8", **SMALL))
    params = {k: np.asarray(v) for k, v in jm.named_parameters()}
    return jm, params


@pytest.mark.parametrize("switches", [("0", "1"), ("0", "0")], ids=["xla0-fused1", "xla0-fused0"])
@pytest.mark.parametrize("turbo", [False, True], ids=["default", "turbo"])
def test_small_flux_packed_route_matches_jax(monkeypatch, routes, small_flux, turbo, switches):
    """A 2 + 2-block FLUX model (dim 768) on the packed route, default and
    turbo configurations, against the JAX forward under the same switches:
    max error <= 2e-2 of the reference's max |value| (the level of
    tests/test_torch_flux.py and test_torch_turbo_flux.py). Every w4a8 GEMM
    takes a packed kernel, none the dequant or the LN producer (off for
    w4a8 under XLA=0, as in JAX): 4 standalone linears per dual block and 2
    per single block, one chain (producer + grouped consumer) per MLP under
    FUSED=1, the MLPs' fc1 and fc2 apart under FUSED=0."""
    _switch(monkeypatch, *switches)
    jm, params = small_flux
    tm = flux_from_jax_params(params, FluxConfig(precision="w4a8", **SMALL), device="cpu")
    if turbo:
        jm = JaxFlux.random_init(jax.random.PRNGKey(5), JaxFluxConfig(precision="w4a8", **SMALL))
        jm.set_stream_dtype(jnp.bfloat16)
        jm.enable_fused_qkv_prep()
        tm.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    args = _inputs()
    ref = np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, args)), np.float32)
    with torch.no_grad():
        out = tm(*[_t(a) for a in args])
    assert out.shape == (1, S_IMG, 64) and _rel(out, ref) <= 2e-2
    mlps = 2 * SMALL["num_layers"] + SMALL["num_single_layers"]
    standalone = 4 * SMALL["num_layers"] + 2 * SMALL["num_single_layers"]
    expect = (dict(gemm_w4a8=standalone, gemm_w4a8_gelu_quant=mlps, gemm_w4a8_grouped=mlps) if switches[1] == "1"
              else dict(gemm_w4a8=standalone + 2 * mlps))
    assert {k: v for k, v in routes.items() if v} == expect


@pytest.mark.parametrize("switches", SWITCHES, ids=lambda s: f"xla{s[0]}-fused{s[1]}")
def test_nvfp4_a8_keeps_the_dequant_route(monkeypatch, routes, switches):
    """e2m1-coded w4a8 (nvfp4-a8) has no packed kernel, in JAX or here: its
    linear and its MLP (chained or not, as the switches say) take the
    dequant route under every switch, within 2e-2 of JAX's; grouped scales
    and the packed wrappers refuse e2m1 rescales (JAX gemm.py:2081-2085)."""
    _switch(monkeypatch, *switches)
    key = jax.random.PRNGKey(9)
    jf = jatt.FeedForward(jlin.SVDQW4A4Linear.random_init(key, 768, 3072, precision="nvfp4-a8"),
                          jlin.SVDQW4A4Linear.random_init(jax.random.fold_in(key, 1), 3072, 768,
                                                          precision="nvfp4-a8"))
    x = jnp.asarray(np.random.default_rng(23).standard_normal((1, 200, 768)), jnp.bfloat16)
    fc1, fc2 = _port_svdq(jf.fc1), _port_svdq(jf.fc2)
    assert fc1.wcodes == "e2m1"
    assert _rel(fc1(_t(x)), jf.fc1(x)) <= 2e-2
    assert _rel(tatt.gelu_mlp(fc1, fc2, _t(x)), jf(x)) <= 2e-2
    assert {k: v for k, v in routes.items() if v} == dict(dequant_w4a8=3)
    qa, asc, la = fc2.quantize(torch.zeros((256, 3072), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tgemm.svdq_gemm_w4a4(qa, asc.expand(2, -1), fc2.qweight, fc2.wscales, rescales=fc2.rescales,
                             precision="w4a8", wcodes="e2m1")
    with pytest.raises(ValueError):
        tgemm.gemm_w4a8(qa, asc, fc2.qweight, fc2.rescales, fc2.wscales)
