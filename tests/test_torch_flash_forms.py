"""The fixed-shift flash kernel's denominator, two-tile and int8 forms of the
port against the JAX package on the CPU, and FLUX's two attention switches
(``attn_kv_unroll = 2``, ``attn_int8``) set through ``set_on_stacks``.

The JAX ``flash_attention(return_denom=True)``, ``flash_attention(kv_unroll=2)``
and ``flash_attention_i8`` run ``_flash_kernel_fixed_denom``,
``_flash_kernel_fixed2`` and ``_flash_kernel_fixed_i8`` in Pallas interpret
mode; the port's wrappers run their plain twins on CPU tensors. Inputs come
from seeded numpy generators.

Tolerances: bf16 attention outputs within 1e-2 of the reference's max |value|
(p and the output rounded to bf16; exp2 and the sums in another order); the
denominator l, an f32 sum, within 1e-5 relative; ``quantize_qk`` codes and
scales bit for bit; the small FLUX forwards within 2e-2 of the JAX model's
max |value| (int8 codes downstream of bf16 attention, as
tests/test_torch_stacked_flux.py holds its models).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models.transformers.transformer_flux import FluxConfig as JaxFluxConfig
from nunchaku_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from nunchaku_tpu.ops import attention as jatt
from nunchaku_tpu_torch.convert import flux_from_jax_params, to_torch
from nunchaku_tpu_torch.models.transformer_flux import FluxConfig
from nunchaku_tpu_torch.ops import attention as tatt

from test_torch_turbo_ops import _bf16, _rel, _t

D = 128
# the small int8 FLUX of tests/test_parallel.py (1 + 1 blocks, 2 heads): dim 256
SMALL = dict(num_layers=1, num_single_layers=1, num_attention_heads=2, joint_attention_dim=512,
             pooled_projection_dim=256, precision="int8")
S_IMG, S_TXT = 256, 64


def _qkv(seed, b, h, s, scale=1.0, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (_bf16(rng, (b, h, s, D), scale), _bf16(rng, (b, h, skv, D), scale), _bf16(rng, (b, h, skv, D)))


@pytest.mark.parametrize("scale", [None, 1.0], ids=["scaled", "prescaled"])
@pytest.mark.parametrize("s,skv", [(300, 300), (128, 200)])
def test_denom_matches_jax(scale, s, skv):
    """o (B, H, S, D) and l (B, H, S) against ``return_denom=True`` at a
    ragged kv length (bq = bkv = 128: several kv blocks); ``scale=1.0``
    takes a q that carries scale * log2(e)."""
    q, k, v = _qkv(1, 1, 2, s, 0.5, skv)
    if scale == 1.0:
        q = (q.astype(jnp.float32) * (math.log2(math.e) / math.sqrt(D))).astype(jnp.bfloat16)
    o_ref, l_ref = jatt.flash_attention(q, k, v, scale=scale, bq=128, bkv=128, fixed_softmax=True,
                                        return_denom=True)
    o, l = tatt.flash_attention_denom(_t(q), _t(k), _t(v), scale=scale)
    assert o.shape == (1, 2, s, D) and o.dtype == torch.bfloat16 and l.shape == (1, 2, s) and l.dtype == torch.float32
    assert _rel(o, o_ref) <= 1e-2
    l_ref = np.asarray(l_ref, np.float32)
    assert np.abs(l.numpy() - l_ref).max() / np.abs(l_ref).max() <= 1e-5


def test_denom_refusals():
    q, k, v = (_t(a) for a in _qkv(2, 1, 1, 64))
    with pytest.raises(ValueError):
        tatt.flash_attention_denom(q, k, v, kv_mask=torch.ones((1, 64), dtype=torch.bool))
    with pytest.raises(ValueError):
        tatt.flash_attention_denom(q, k, v, out_bshd=True)


@pytest.mark.parametrize("out_bshd", [False, True], ids=["bhsd", "bshd"])
def test_unroll2_matches_jax(out_bshd):
    """At tests/test_ops.py's shape (1, 2, 640, 128), bq = bkv = 128: 640
    is no multiple of two 128-column blocks (JAX pads and masks the last
    step's second block; the port's 64-column tiles cut it)."""
    q, k, v = _qkv(3, 1, 2, 640)
    ref = jatt.flash_attention(q, k, v, bq=128, bkv=128, fixed_softmax=True, kv_unroll=2, out_bshd=out_bshd)
    out = tatt.flash_attention_unroll2(_t(q), _t(k), _t(v), out_bshd=out_bshd)
    assert out.shape == tuple(ref.shape)
    assert _rel(out, ref) <= 1e-2


def test_unroll_gate_rules():
    """``flash_attention(kv_unroll=2)`` takes the two-tile form only without
    a kv mask (JAX :713-722): with a mask, and at any other unroll, it is the
    one-tile kernel's output."""
    q, k, v = (_t(a) for a in _qkv(4, 1, 2, 200))
    mask = torch.ones((1, 200), dtype=torch.bool)
    mask[0, :30] = False
    assert torch.equal(tatt.flash_attention(q, k, v, mask, kv_unroll=2), tatt.flash_attention_plain(q, k, v, mask))
    assert torch.equal(tatt.flash_attention(q, k, v, kv_unroll=3), tatt.flash_attention_plain(q, k, v))
    assert torch.equal(tatt.flash_attention(q, k, v, kv_unroll=2),
                       tatt.flash_attention_unroll2_plain(q, k, v, 1.0, out_bshd=True))


def test_quantize_qk_bit_exact():
    """Codes and scales of JAX's jitted ``quantize_qk`` bit for bit, an
    all-zero token row included (scale 0, codes 0). Jitted, as the model
    runs it: XLA compiles its ``/ 127.0`` into a multiply by f32(1/127)
    (op-by-op dispatch divides, and 20 of these 576 scales then differ in
    the last bit)."""
    q, k, _ = _qkv(5, 2, 3, 96, 2.0)
    q = q.at[1, 2, 7].set(0.0)
    ref = jax.jit(jatt.quantize_qk)(q, k)
    out = tatt.quantize_qk(_t(q), _t(k))
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.dtype == to_torch(r, "cpu").dtype and np.array_equal(o.numpy(), r)


@pytest.mark.parametrize("out_bshd", [False, True], ids=["bhsd", "bshd"])
def test_flash_i8_matches_jax(out_bshd):
    """At tests/test_ops.py's shape (1, 2, 384, 128): q prescaled before its
    quantization; the same codes and scales into both."""
    q, k, v = _qkv(6, 1, 2, 384)
    qp = (q.astype(jnp.float32) * (math.log2(math.e) / math.sqrt(D))).astype(jnp.bfloat16)
    q8, qs, k8, ks = jatt.quantize_qk(qp, k)
    ref = jatt.flash_attention_i8(q8, qs, k8, ks, v, bq=128, bkv=128, out_bshd=out_bshd)
    out = tatt.flash_attention_i8(*(_t(a) for a in (q8, qs, k8, ks, v)), out_bshd=out_bshd)
    assert out.shape == tuple(ref.shape) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 1e-2


def _small_inputs():
    rng = np.random.default_rng(31)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    ids = np.zeros((S_IMG, 3), np.int32)
    ids[:, 1] = np.arange(S_IMG) // 16
    ids[:, 2] = np.arange(S_IMG) % 16
    return (bf(rng.standard_normal((1, S_IMG, 64))), bf(rng.standard_normal((1, S_TXT, 512))),
            bf(rng.standard_normal((1, 256))), np.array([0.5], np.float32), ids, np.zeros((S_TXT, 3), np.int32),
            np.array([3.5], np.float32))


@pytest.fixture(scope="module")
def small_flux():
    jm = JaxFlux.random_init(jax.random.PRNGKey(21), JaxFluxConfig(**SMALL))
    tm = flux_from_jax_params({k: np.asarray(v) for k, v in jm.named_parameters()}, FluxConfig(**SMALL),
                              device="cpu")
    return jm.set_stream_dtype(jnp.bfloat16), tm.set_stream_dtype(torch.bfloat16)


@pytest.mark.parametrize("setting", [dict(attn_kv_unroll=2), dict(attn_int8=True)], ids=["kv_unroll2", "int8"])
def test_flux_attention_switches_match_jax(small_flux, monkeypatch, setting):
    """FLUX int8 on a bf16 stream with the unfused prologue (the setup of
    tools/ablate_kv_unroll.py): the switch set on both stacks of the JAX
    model and through ``set_on_stacks`` on the port's, which routes every
    block's attention to the form's twin; the forward within 2e-2 of JAX's."""
    jm, tm = small_flux
    for stack in (jm.transformer_blocks, jm.single_transformer_blocks):
        for key, value in setting.items():
            setattr(stack.attn, key, value)
    tm.set_on_stacks("attn", **setting)
    called = []
    name = "flash_attention_unroll2" if "attn_kv_unroll" in setting else "flash_attention_i8"
    fn = getattr(tatt, name)
    monkeypatch.setattr(tatt, name, lambda *a, **kw: called.append(1) or fn(*a, **kw))
    from nunchaku_tpu_torch.models import attention as tmod
    monkeypatch.setattr(tmod, name, getattr(tatt, name), raising=False)
    try:
        args = _small_inputs()
        ref = np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, args)), np.float32)
        with torch.no_grad():
            out = tm(*[to_torch(a, "cpu") for a in args])
    finally:
        for stack in (jm.transformer_blocks, jm.single_transformer_blocks):
            for key in setting:
                setattr(stack.attn, key, {"attn_kv_unroll": 1, "attn_int8": False}[key])
        tm.set_on_stacks("attn", attn_kv_unroll=1, attn_int8=False)
    assert len(called) == SMALL["num_layers"] + SMALL["num_single_layers"]
    assert out.shape == (1, S_IMG, 64)
    assert _rel(out, ref) <= 2e-2
