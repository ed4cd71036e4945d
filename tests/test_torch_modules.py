"""Parity of the port's modules with the JAX package at small sizes (CPU).

Weights come from the JAX modules' ``random_init`` and move to the port
through numpy; inputs come from a seeded numpy generator. Each test states
its tolerance. The last test holds the port to its import rule.
"""

import ast
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.core import packing as jpack
from nunchaku_tpu.models import attention as jatt
from nunchaku_tpu.models import embeddings as jemb
from nunchaku_tpu.models import linear as jlin
from nunchaku_tpu.models import normalization as jnorm
from nunchaku_tpu.ops import gemm as jgemm
from nunchaku_tpu.ops import quantize as jquant
from nunchaku_tpu.ops import reference as jref
from nunchaku_tpu.pipeline import pipeline_flux as jpipe
from nunchaku_tpu.pipeline import scheduler as jsched
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.core import packing as tpack
from nunchaku_tpu_torch.models import attention as tatt
from nunchaku_tpu_torch.models import embeddings as temb
from nunchaku_tpu_torch.models import linear as tlin
from nunchaku_tpu_torch.models import normalization as tnorm
from nunchaku_tpu_torch.ops import quantize as tquant
from nunchaku_tpu_torch.ops import reference as tref
from nunchaku_tpu_torch.pipeline import pipeline_flux as tpipe
from nunchaku_tpu_torch.pipeline import scheduler as tsched

ROOT = pathlib.Path(__file__).resolve().parents[1]


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


def port_linear(jl):
    return tlin.Linear(_t(jl.weight), None if jl.bias is None else _t(jl.bias))


# ---------------------------------------------------------------------------
# packing, quantize, reference ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unsigned,axis", [(False, 0), (False, -1), (True, 0)])
def test_pack_unpack_bit_exact(unsigned, axis):
    rng = np.random.default_rng(10)
    lo, hi = (0, 16) if unsigned else (-8, 8)
    shape = (512, 96) if axis == 0 else (24, 768)
    vals = rng.integers(lo, hi, shape, dtype=np.int8)
    packed = tpack.pack_int4(torch.from_numpy(vals), axis)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpack.pack_int4(jnp.asarray(vals), axis)))
    np.testing.assert_array_equal(tpack.unpack_int4(packed, axis, unsigned=unsigned).numpy(), vals)


def test_constants_match_jax():
    from nunchaku_tpu.ops import attention as ja
    from nunchaku_tpu_torch.ops import attention as ta

    assert tref.GROUP_INT4 == jref.GROUP_INT4 and tref.GELU_SHIFT == jref.GELU_SHIFT
    assert tpack.PACK_BLOCK == jpack.PACK_BLOCK
    assert (ta.FIXED_SHIFT, ta.FIXED_CAP, ta.LOG2E) == (ja.FIXED_SHIFT, ja.FIXED_CAP, ja.LOG2E)


TANH_DEVIATION = 1e-6  # |torch.tanh - XLA's CPU tanh| on f32 inputs (ROADMAP.md Queue 3: ~1e-6 absolute)


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("flags")), "unknown")
    except OSError:
        return "unknown"


# (port function, JAX counterpart, the port's tanh argument): the chain
# epilogue's order against the JAX epilogue's _tanh_gelu, the unfused MLP's
# order against jax.nn.gelu(approximate=True)
GELU_PAIRS = {
    "gelu_chain_order": (tref.gelu, lambda x: jgemm._tanh_gelu(x),
                         lambda x: 0.7978845608028654 * (x + ((0.044715 * x) * x) * x)),
    "gelu_jax_order": (tref.gelu_jax, jref.gelu, lambda x: 0.7978845608028654 * (x + 0.044715 * (x * x * x))),
}


@pytest.mark.parametrize("case", ["gelu_chain_order", "gelu_jax_order", "rmsnorm"])
def test_gelu_and_rmsnorm_match_jax(case):
    """GELU: the port's operation order held at rtol 1e-5 / atol 1e-6 plus
    0.5 |x| dt, the part the host's tanh alone explains, where dt is the
    measured elementwise |torch.tanh(z) - jnp.tanh(z)| on the port's own z;
    dt itself must stay within TANH_DEVIATION. RMSNorm: rtol 1e-5 / atol 1e-6."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 256)).astype(np.float32) * 3
    w = rng.standard_normal((256,)).astype(np.float32)
    xt = torch.from_numpy(x)
    if case == "rmsnorm":
        np.testing.assert_allclose(tref.rmsnorm(xt, torch.from_numpy(w)).numpy(),
                                   np.asarray(jref.rmsnorm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5, atol=1e-6)
        return
    port_fn, jax_fn, tanh_arg = GELU_PAIRS[case]
    z = tanh_arg(xt)
    tz, jz = torch.tanh(z).numpy(), np.asarray(jnp.tanh(jnp.asarray(z.numpy())))
    dt = np.abs(tz - jz)
    i = np.unravel_index(np.argmax(dt), dt.shape)
    assert dt.max() <= TANH_DEVIATION, (
        f"tanh deviation {dt.max():.3e} > {TANH_DEVIATION:.0e} at {i}: z {z.numpy()[i]!r}, torch {tz[i]!r}, "
        f"XLA {jz[i]!r}; host CPU flags: {_cpu_flags()}")
    out, ref = port_fn(xt).numpy(), np.asarray(jax_fn(jnp.asarray(x)))
    excess = np.abs(out - ref) - (1e-6 + 1e-5 * np.abs(ref) + 0.5 * np.abs(x) * dt)
    j = np.unravel_index(np.argmax(excess), excess.shape)
    assert excess.max() <= 0, (f"{case}: |port - JAX| beyond tolerance at {j}: x {x[j]!r}, port {out[j]!r}, "
                               f"JAX {ref[j]!r}, dt {dt[j]:.3e}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_int8_matches_jax(dtype):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((300, 512)).astype(np.float32) * 2
    x[7] = 0.0  # an all-zero token: scale 0, codes 0
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    pd = _bf16(rng, (512, 32), 0.02)
    smooth = jnp.asarray(rng.uniform(0.5, 2.0, (512,)), jnp.bfloat16)
    q_r, s_r, l_r = jquant.quantize_w4a4_act_fuse_lora(xj, pd, smooth, precision="int8")
    q, s, l = tquant.quantize_w4a4_act_fuse_lora(_t(xj), _t(pd), _t(smooth), precision="int8")
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))  # exact codes
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    assert _rel(l, l_r) <= 1e-5  # f32 sums in another order


# ---------------------------------------------------------------------------
# linear layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["w4a8", "int8"])
def test_svdq_linear_matches_jax(precision):
    jl = jlin.SVDQW4A4Linear.random_init(jax.random.PRNGKey(1), 512, 384, precision=precision)
    rng = np.random.default_rng(13)
    x = _bf16(rng, (2, 150, 512))  # 300 tokens: padded to 512 inside
    ref = jl(x)
    out = port_svdq(jl)(_t(x))
    assert out.shape == (2, 150, 384) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 1e-2  # bf16 outputs; low-rank sums in another order


def test_svdq_linear_tiny_m_matches_jax():
    """M = 1 (the AdaLN modulation shape) pads to 8 rows, like JAX."""
    jl = jlin.SVDQW4A4Linear.random_init(jax.random.PRNGKey(2), 256, 768, rank=16, precision="int8")
    x = _bf16(np.random.default_rng(14), (1, 256))
    assert _rel(port_svdq(jl)(_t(x)), jl(x)) <= 1e-2


def test_bf16_linear_matches_jax():
    jl = jlin.Linear.random_init(jax.random.PRNGKey(3), 64, 256)
    x = _bf16(np.random.default_rng(15), (1, 40, 64))
    assert _rel(port_linear(jl)(_t(x)), jl(x)) <= 1e-2
    xf = jnp.asarray(np.random.default_rng(16).standard_normal((3, 64)), jnp.float32)
    assert _rel(port_linear(jl)(_t(xf)), jl(xf)) <= 1e-5  # f32 in, f32 out


# ---------------------------------------------------------------------------
# norms and embeddings
# ---------------------------------------------------------------------------


def test_layer_norm_matches_jax():
    x = np.random.default_rng(17).standard_normal((2, 50, 256)).astype(np.float32) * 4 + 1
    np.testing.assert_allclose(tnorm.layer_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jnorm.layer_norm(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["zero", "single", "continuous"])
def test_adaln_matches_jax(kind):
    rng = np.random.default_rng(18)
    x = jnp.asarray(rng.standard_normal((1, 40, 256)), jnp.float32)
    t = _bf16(rng, (1, 256))
    key = jax.random.PRNGKey(4)
    if kind == "zero":
        jm = jnorm.AdaLayerNormZero.random_init(key, 256, precision="w4a8")
        tm = tnorm.AdaLayerNormZero(port_svdq(jm.linear))
    elif kind == "single":
        jm = jnorm.AdaLayerNormZeroSingle.random_init(key, 256, precision="w4a8")
        tm = tnorm.AdaLayerNormZeroSingle(port_svdq(jm.linear))
    else:
        jm = jnorm.AdaLayerNormContinuous.random_init(key, 256)
        tm = tnorm.AdaLayerNormContinuous(port_linear(jm.linear))
    ref = jm(x, t)
    out = tm(_t(x), _t(t))
    ref, out = (ref, out) if isinstance(ref, tuple) else ((ref,), (out,))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        assert _rel(o, r) <= 1e-2  # int8 modulation linear, bf16 outputs


def test_rope_matches_jax():
    ids = np.zeros((300, 3), np.int32)
    ids[:, 1] = np.arange(300) // 20
    ids[:, 2] = np.arange(300) % 20
    rot_r = jemb.rope_table(jnp.asarray(ids), (16, 56, 56))
    rot = temb.rope_table(torch.from_numpy(ids), (16, 56, 56))
    np.testing.assert_allclose(rot.numpy(), np.asarray(rot_r), rtol=1e-5, atol=1e-5)
    x = _bf16(np.random.default_rng(19), (1, 2, 300, 128))
    out = temb.apply_rope(_t(x), rot, scale=0.3)
    assert _rel(out, jemb.apply_rope(x, rot_r, scale=0.3)) <= 1e-2


def test_timestep_embeddings_match_jax():
    t = jnp.asarray([0.25, 0.9], jnp.float32)
    np.testing.assert_allclose(temb.timestep_embedding(_t(t) * 1000.0, 256).numpy(),
                               np.asarray(jemb.timestep_embedding(t * 1000.0, 256)), rtol=1e-4, atol=1e-4)
    jm = jemb.CombinedTimestepEmbeddings.random_init(jax.random.PRNGKey(5), 256, 128, True)

    def mlp(j):
        return temb.MLPEmbedder(port_linear(j.fc1), port_linear(j.fc2))

    tm = temb.CombinedTimestepEmbeddings(mlp(jm.timestep_embedder), mlp(jm.text_embedder),
                                         mlp(jm.guidance_embedder))
    pooled = _bf16(np.random.default_rng(20), (2, 128))
    g = jnp.asarray([3.5, 3.5], jnp.float32)
    assert _rel(tm(_t(t), _t(pooled), _t(g)), jm(t, pooled, g)) <= 1e-2


# ---------------------------------------------------------------------------
# attention and MLP
# ---------------------------------------------------------------------------


def port_attention(ja):
    opt = lambda x, f: None if x is None else f(x)
    return tatt.FluxAttention(
        port_svdq(ja.to_qkv), _t(ja.norm_q), _t(ja.norm_k), opt(ja.to_out, port_svdq),
        opt(ja.add_qkv_proj, port_svdq), opt(ja.norm_added_q, _t), opt(ja.norm_added_k, _t),
        opt(ja.to_add_out, port_svdq), head_dim=ja.head_dim)


@pytest.mark.parametrize("joint", [True, False])
def test_flux_attention_matches_jax(joint):
    ja = jatt.FluxAttention.random_init(jax.random.PRNGKey(6), 256, 2, 128, joint=joint, precision="w4a8")
    rng = np.random.default_rng(21)
    s_txt, s_img = 64, 192
    img = jnp.asarray(rng.standard_normal((1, s_img, 256)), jnp.float32)
    txt = jnp.asarray(rng.standard_normal((1, s_txt, 256)), jnp.float32) if joint else None
    ids = np.zeros((s_txt + s_img if joint else s_img, 3), np.int32)
    ids[:, 2] = np.arange(ids.shape[0])
    rot = jemb.rope_table(jnp.asarray(ids), (16, 56, 56))
    ref = ja(img, txt, rot)
    out = port_attention(ja)(_t(img), None if txt is None else _t(txt), _t(rot))
    ref, out = (ref, out) if joint else ((ref,), (out,))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        assert _rel(o, r) <= 2e-2  # int8 codes, bf16 q/k/v and flash output


@pytest.mark.parametrize("precision,dim", [("w4a8", 768), ("w4a8", 256), ("int8", 256)])
def test_gelu_mlp_matches_jax(precision, dim):
    """dim 768: hidden 3072 -> two requantize scale groups (grouped consumer);
    dim 256: hidden 1024 -> one group (standalone int8 consumer)."""
    jf = jatt.FeedForward.random_init(jax.random.PRNGKey(7), dim, precision=precision)
    x = _bf16(np.random.default_rng(22), (1, 200, dim))
    ref = jf(x)
    out = tatt.FeedForward(port_svdq(jf.fc1), port_svdq(jf.fc2))(_t(x))
    assert tuple(out.shape) == tuple(ref.shape)
    assert _rel(out, ref) <= 2e-2  # requantized codes may differ by one at .5 boundaries


# ---------------------------------------------------------------------------
# scheduler and pipeline helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps,seq", [(2, 256), (28, 4096), (50, 4096)])
def test_flux_sigmas_match_jax(steps, seq):
    np.testing.assert_array_equal(tsched.flux_sigmas(steps, image_seq_len=seq),
                                  jsched.flux_sigmas(steps, image_seq_len=seq))


def test_euler_step_matches_jax():
    rng = np.random.default_rng(23)
    lat = rng.standard_normal((1, 16, 64)).astype(np.float32)
    vel = _bf16(rng, (1, 16, 64))
    sig = jsched.flux_sigmas(4, image_seq_len=16)
    ref = jsched.euler_step(jnp.asarray(lat), vel, jnp.float32(sig[1]), jnp.float32(sig[2]))
    out = tsched.euler_step(torch.from_numpy(lat), _t(vel), sig[1], sig[2])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_latent_packing_and_ids_match_jax():
    lat = np.random.default_rng(24).standard_normal((2, 16, 8, 12)).astype(np.float32)
    packed = tpipe.pack_latents(torch.from_numpy(lat))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpipe.pack_latents(jnp.asarray(lat))))
    np.testing.assert_array_equal(tpipe.unpack_latents(packed, 8, 12).numpy(), lat)
    np.testing.assert_array_equal(tpipe.make_img_ids(4, 6).numpy(), np.asarray(jpipe.make_img_ids(4, 6)))


# ---------------------------------------------------------------------------
# import rule
# ---------------------------------------------------------------------------


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "nunchaku_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = {str(p.relative_to(ROOT)): r for p in files for r in _imported_roots(p)
           if r in ("jax", "jaxlib", "nunchaku_tpu")}
    assert not bad, bad
