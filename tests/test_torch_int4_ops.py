"""The int4 / nvfp4 SVDQuant ops and modules of the port against the JAX
package at small sizes (CPU): the 4-bit activation quantize, the W4A4 GEMM's
plain twin, the AWQ W4A16 linear (the GEMV kernel's twin and the large-M
route), ``SVDQW4A4Linear`` at int4 / nvfp4 and ``AWQW4A16Linear``.

Inputs come from seeded numpy generators; JAX runs its Pallas kernels in
interpret mode. Each test states its tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.core import dtypes as jdtypes
from nunchaku_tpu.models import attention as jatt
from nunchaku_tpu.models import linear as jlin
from nunchaku_tpu.models import normalization as jnorm
from nunchaku_tpu.ops import gemm as jgemm
from nunchaku_tpu.ops import gemv as jgemv
from nunchaku_tpu.ops import quantize as jquant
from nunchaku_tpu.ops import reference as jref
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.models import attention as tatt
from nunchaku_tpu_torch.models import linear as tlin
from nunchaku_tpu_torch.models import normalization as tnorm
from nunchaku_tpu_torch.ops import gemm as tgemm
from nunchaku_tpu_torch.ops import gemv as tgemv
from nunchaku_tpu_torch.ops import quantize as tquant
from nunchaku_tpu_torch.ops import reference as tref


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops: one intra-op thread keeps their time steady when a
    parallel test run keeps every core busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(out, ref):
    out, ref = _np(out), _np(ref)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _within_bf16_step(out, ref):
    """Every element at most one bf16 rounding step from the reference:
    f32 sums in another order can round to the neighbouring bf16 value
    (one step is <= 2^-7 |ref|); near-zero sums get 1e-4 of max |ref|."""
    out, ref = _np(out), _np(ref)
    return bool(np.all(np.abs(out - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-4 * np.abs(ref).max()))


def port_svdq(jl):
    return tlin.SVDQW4A4Linear(
        _t(jl.qweight), _t(jl.wscales), _t(jl.smooth), _t(jl.proj_down), _t(jl.proj_up),
        None if jl.bias is None else _t(jl.bias), None, precision=jl.precision, act_unsigned=jl.act_unsigned)


def port_awq(jl):
    assert jl.group_size == tref.GROUP_INT4  # the port's AWQ layers take 64-row groups only
    return tlin.AWQW4A16Linear(_t(jl.qweight), _t(jl.wscales), _t(jl.wzeros),
                               None if jl.bias is None else _t(jl.bias))


# ---------------------------------------------------------------------------
# constants, e2m1, quantize
# ---------------------------------------------------------------------------


def test_constants_and_e2m1_match_jax():
    assert (tref.GROUP_FP4, tref.E2M1_MAX) == (jref.GROUP_FP4, jdtypes.E2M1_MAX)
    for p in ("int4", "nvfp4", "int8"):
        assert tref.group_size(p) == jref.group_size(p)
    codes = np.arange(-8, 8, dtype=np.int32)
    np.testing.assert_array_equal(tref.decode_e2m1(torch.from_numpy(codes)).numpy(),
                                  np.asarray(jgemm._decode_e2m1(jnp.asarray(codes))))
    vals = np.array([0, .5, 1, 1.5, 2, 3, 4, 6, -.5, -1, -1.5, -2, -3, -4, -6, -0.0], np.float32)
    np.testing.assert_array_equal(tref.e2m1_value_to_code(torch.from_numpy(vals)).numpy(),
                                  np.asarray(jquant._e2m1_value_to_code(jnp.asarray(vals))))


def test_gelu_jax_matches_jax():
    """``jax.nn.gelu(approximate=True)``'s operation order; XLA's CPU tanh
    approximation and torch's differ by up to ~1e-6 on about a third of
    f32 inputs (ROADMAP Queue 3), hence a tolerance and not equality."""
    x = np.random.default_rng(40).standard_normal(4096).astype(np.float32) * 3
    np.testing.assert_allclose(tref.gelu_jax(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)), rtol=1e-5, atol=1e-6)


def _edge_acts(precision, k=512):
    """Random rows plus groups built to hit the rounding edges: an all-zero
    group; a group whose scale is exactly 1 holding the e2m1 binade edges
    1, 2, 4, values just below them, and the ties between grid points
    (nvfp4), or the half-integer ties of int4; a group of tiny values whose
    e4m3 scale is subnormal or zero; a group of huge values."""
    rng = np.random.default_rng(41)
    x = rng.standard_normal((16, k)) * 2.0
    g = 16 if precision == "nvfp4" else 64
    x[0, :g] = 0.0
    if precision == "nvfp4":
        x[1, :g] = [6.0, 1.0, 2.0, 4.0, 0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, -0.25, -2.5, -5.0,
                    1.9921875, 3.984375]
        x[1, g:2 * g] = -x[1, :g]
    else:
        edge = [7.0, 0.5, 1.5, 2.5, -2.5, 3.5, -0.5, 6.5, -6.5, 4.5, 1.0, 2.0, 4.0, -7.0, 0.328125, 5.5]
        x[1, :g] = np.resize(edge, g)
    x[2, :g] *= 1e-4
    x[3, g:3 * g] *= 1e-3
    x[4, :g] *= 1e4
    return _bf16(x)


@pytest.mark.parametrize("precision,unsigned,smooth", [
    ("int4", False, False), ("int4", False, True), ("int4", True, False), ("int4", True, True),
    ("nvfp4", False, False), ("nvfp4", False, True)])
def test_quantize_4bit_matches_jax_exactly(precision, unsigned, smooth):
    """Packed codes and scales identical to JAX ``quantize_w4a4_act_fuse_lora``
    (the port multiplies by the f32 reciprocals of 7, 15 and 6 as XLA
    compiles the JAX divisions); lora_act: f32 sums in another order."""
    x = _edge_acts(precision)
    rng = np.random.default_rng(42)
    pd = _bf16(rng.standard_normal((x.shape[1], 16)) * 0.05)
    sm = _bf16(rng.random(x.shape[1]) * 1.5 + 0.5) if smooth else None
    q_r, s_r, l_r = jquant.quantize_w4a4_act_fuse_lora(
        jnp.asarray(x), jnp.asarray(pd), None if sm is None else jnp.asarray(sm), precision=precision,
        act_unsigned=unsigned)
    q, s, la = tquant.quantize_w4a4_act_fuse_lora(_t(x), _t(pd), None if sm is None else _t(sm),
                                                  precision=precision, act_unsigned=unsigned)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    assert s.dtype == torch.bfloat16 and tuple(s.shape) == tuple(s_r.shape)
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(s_r, np.float32))
    assert _rel(la, l_r) <= 1e-5


# ---------------------------------------------------------------------------
# the W4A4 GEMM's plain twin
# ---------------------------------------------------------------------------


def _gemm_case(precision, unsigned, m=256, k=512, n=256, r=32, seed=43):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((m, k)) * 2.0)
    if unsigned:  # post-GELU-like activations
        x = _bf16(np.maximum(np.asarray(x, np.float32), -0.17))
    pd = _bf16(rng.standard_normal((k, r)) * 0.05)
    qa, asc, la = jquant.quantize_w4a4_act_fuse_lora(jnp.asarray(x), jnp.asarray(pd), precision=precision,
                                                     act_unsigned=unsigned)
    g = jref.group_size(precision)
    qw = rng.integers(-128, 128, (k // 2, n), dtype=np.int8)
    ws = _bf16(np.abs(rng.standard_normal((k // g, n))) / (7 * np.sqrt(k)))
    pu = _bf16(rng.standard_normal((r, n)) * 0.02)
    bias = _bf16(rng.standard_normal(n) * 0.02)
    return [np.asarray(a) for a in (qa, asc, la)] + [qw, ws, pu, bias]


@pytest.mark.parametrize("lora_bias", [True, False])
@pytest.mark.parametrize("precision,unsigned", [("int4", False), ("int4", True), ("nvfp4", False)])
def test_gemm_w4a4_plain_matches_jax(precision, unsigned, lora_bias):
    """The twin against the JAX Pallas kernel (interpret mode): the same
    bf16 operands and products, f32 sums in another order."""
    qa, asc, la, qw, ws, pu, bias = _gemm_case(precision, unsigned)
    extra = (la, pu, bias) if lora_bias else (None, None, None)
    ref = jgemm.svdq_gemm_w4a4(jnp.asarray(qa), jnp.asarray(asc), jnp.asarray(qw), jnp.asarray(ws),
                               *[None if a is None else jnp.asarray(a) for a in extra],
                               precision=precision, act_unsigned=unsigned)
    out = tgemm.gemm_w4a4_plain(_t(qa), _t(asc), _t(qw), _t(ws), *[None if a is None else _t(a) for a in extra],
                                precision=precision, act_unsigned=unsigned)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == tuple(ref.shape)
    assert _within_bf16_step(out, ref)


def test_gemm_w4a4_dispatch_and_refusals():
    qa, asc, la, qw, ws, pu, bias = _gemm_case("int4", True, m=128, k=256, n=128)
    args = [_t(a) for a in (qa, asc, qw, ws, la, pu, bias)]
    out = tgemm.svdq_gemm_w4a4(*args, precision="int4", act_unsigned=True)
    ref = tgemm.gemm_w4a4_plain(*args, precision="int4", act_unsigned=True)
    assert torch.equal(out, ref)
    x = torch.randn((128, 128)).to(torch.bfloat16)
    gate = torch.randn((1, 128))
    res = tgemm.svdq_gemm_w4a4(*args, precision="int4", act_unsigned=True, residual=(x, gate))
    assert torch.equal(res, tgemm.res_apply(ref, x, gate))
    with pytest.raises(ValueError):  # unsigned activations are an int4 mode
        tgemm.gemm_w4a4(*args, precision="nvfp4", act_unsigned=True)


# ---------------------------------------------------------------------------
# AWQ W4A16
# ---------------------------------------------------------------------------


def _awq_case(m, k=512, n=768, seed=44):
    jl = jlin.AWQW4A16Linear.random_init(jax.random.PRNGKey(seed), k, n)
    x = _bf16(np.random.default_rng(seed).standard_normal((m, k)))
    return jl, x


@pytest.mark.parametrize("m", [1, 2, 5, 8, 12])
def test_awq_gemv_plain_matches_jax_kernel(m):
    """The GEMV twin against JAX ``awq_w4a16_linear`` (interpret mode):
    w = bf16(q s - z) may round one step apart where XLA fuses the multiply
    and subtract; f32 sums in another order. Max error <= 1e-3 of max |ref|."""
    jl, x = _awq_case(m)
    args = (jl.qweight, jl.wscales, jl.wzeros, jl.bias)
    ref = jgemv.awq_w4a16_linear(jnp.asarray(x), *args)
    out = tgemv.awq_w4a16_linear(_t(x), *[_t(a) for a in args])
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, 768)
    assert _rel(out, ref) <= 1e-3


def test_awq_large_m_route_matches_jax():
    """M 32 takes the dequantize-then-multiply route (JAX
    ``awq_w4a16_linear_xla``); tolerance as for the GEMV."""
    jl, x = _awq_case(32)
    args = (jl.qweight, jl.wscales, jl.wzeros, jl.bias)
    ref = jgemv.awq_w4a16_linear_xla(jnp.asarray(x), *args)
    out = tgemv.awq_w4a16_linear_plain(_t(x), *[_t(a) for a in args])
    assert _rel(out, ref) <= 1e-3
    assert tgemv.AWQ_XLA_MIN_M == jgemv.AWQ_XLA_MIN_M


@pytest.mark.parametrize("lead", [(1,), (2,), (32,)])
def test_awq_linear_module_matches_jax(lead):
    """The module routes M < 16 to the GEMV and larger M to the dequantize
    route, like JAX; bf16 outputs within 1e-2 of max |ref|."""
    jl, x = _awq_case(int(np.prod(lead)), seed=45)
    ref = jl(jnp.asarray(x))
    out = port_awq(jl)(_t(x))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == tuple(ref.shape)
    assert _rel(out, ref) <= 1e-2


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision,unsigned", [("int4", False), ("int4", True), ("nvfp4", False)])
def test_svdq_linear_4bit_matches_jax(precision, unsigned):
    """300 tokens (padded to 512 inside): identical codes, bf16 outputs with
    f32 sums in another order -> max error <= 1e-2 of max |ref|."""
    jl = jlin.SVDQW4A4Linear.random_init(jax.random.PRNGKey(46), 512, 384, precision=precision,
                                         act_unsigned=unsigned)
    x = np.random.default_rng(47).standard_normal((2, 150, 512))
    if unsigned:
        x = np.maximum(x, -0.17)
    x = _bf16(x)
    ref = jl(jnp.asarray(x))
    lin = port_svdq(jl)
    out = lin(_t(x))
    assert out.shape == (2, 150, 384) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 1e-2
    assert lin.qweight.t().is_contiguous()  # stored K-contiguous, the kernel's layout
    np.testing.assert_array_equal(lin.qweight.numpy(), np.asarray(jl.qweight))


@pytest.mark.parametrize("precision", ["int4", "nvfp4"])
def test_feedforward_4bit_matches_jax(precision):
    """fc1 -> GELU (jax.nn.gelu's order) -> fc2 (unsigned at int4): codes
    may differ by one where the GELU's tanh rounds apart, so max error
    <= 2e-2 of max |ref|."""
    jf = jatt.FeedForward.random_init(jax.random.PRNGKey(48), 256, precision=precision)
    x = _bf16(np.random.default_rng(49).standard_normal((1, 200, 256)))
    ref = jf(jnp.asarray(x))
    ff = tatt.FeedForward(port_svdq(jf.fc1), port_svdq(jf.fc2))
    assert ff.fc2.act_unsigned == (precision == "int4")
    out = ff(_t(x))
    assert tuple(out.shape) == tuple(ref.shape)
    assert _rel(out, ref) <= 2e-2


@pytest.mark.parametrize("kind", ["dual", "single"])
def test_adaln_awq_matches_jax(kind):
    """AdaLN-Zero with the AWQ modulation linear of the int4 / nvfp4
    models; bf16 outputs within 1e-2 of max |ref|."""
    jcls, tcls = ((jnorm.AdaLayerNormZero, tnorm.AdaLayerNormZero) if kind == "dual"
                  else (jnorm.AdaLayerNormZeroSingle, tnorm.AdaLayerNormZeroSingle))
    jm = jcls.random_init(jax.random.PRNGKey(50), 256, precision="int4")
    rng = np.random.default_rng(51)
    x = rng.standard_normal((1, 64, 256)).astype(np.float32)
    temb = _bf16(rng.standard_normal((1, 256)))
    refs = jm(jnp.asarray(x), jnp.asarray(temb))
    tm = tcls(port_awq(jm.linear))
    outs = tm(torch.from_numpy(x), _t(temb))
    for o, r in zip(outs, refs):
        assert tuple(o.shape) == tuple(r.shape)
        assert _rel(o, r) <= 1e-2


def test_random_init_4bit_layouts():
    gen = torch.Generator().manual_seed(0)
    lin = tlin.SVDQW4A4Linear.random_init(gen, 512, 256, precision="nvfp4", device="cpu")
    assert tuple(lin.wscales.shape) == (32, 256) and lin.wscales.dtype == torch.bfloat16
    assert tuple(lin.qweight.shape) == (256, 256) and lin.in_features == 512
    lin = tlin.SVDQW4A4Linear.random_init(gen, 512, 256, precision="int4", act_unsigned=True, device="cpu")
    assert tuple(lin.wscales.shape) == (8, 256) and lin.act_unsigned
    awq = tnorm.mod_linear(gen, 256, 768, "nvfp4", device="cpu")
    assert isinstance(awq, tlin.AWQW4A16Linear) and tuple(awq.wzeros.shape) == (4, 768)
    with pytest.raises(NotImplementedError):
        tlin.SVDQW4A4Linear.random_init(gen, 512, 256, precision="nvfp4", act_unsigned=True, device="cpu")
