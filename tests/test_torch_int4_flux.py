"""The port's FLUX transformer at the int4 and nvfp4 SVDQuant precisions
against the JAX package at a tiny config (CPU): the forward, a 2-step
text-to-latents pipeline request, the bf16-stream fallback of the 4-bit
blocks, the converter and the parameter tree. Weights come from the JAX
``random_init`` through ``flux_from_jax_params``.

Tolerance for model outputs and latents: max error <= 2e-2 of the
reference's max |value|, as for the w4a8 model (tests/test_torch_flux.py).
A 4-bit activation code is a seventh of its group's range (int4), so an
input that rounds one bf16 step apart (an f32 sum in another order, the
flash twin, XLA's tanh) can move a layer's output by percents where the
w4a8 model's int8 codes move it by a fraction of one. The random AdaLN
modulation of ``random_init`` (gates and scales up to ~4) multiplies that:
even the JAX package's own two int4 GEMM routes, which differ in summation
order only, end more than 2e-2 apart at this size
(``test_jax_int4_routes_agree_only_when_damped``). So these tests damp the
modulation linears on both sides (scales and zeros x ``checks.MOD_DAMP`` =
0.125, gates up to ~0.5, as a trained model's are), as the card's
small-model checks do. Damping scales both sides alike, so the modulation
linears are also checked alone, undamped in effect
(``checks.check_modulation``, which fails every wrong modulation of
``checks.MOD_MUTATIONS``).
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models.transformers.transformer_flux import FluxConfig as JaxFluxConfig
from nunchaku_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from nunchaku_tpu.pipeline.pipeline_flux import FluxPipeline as JaxPipeline
from nunchaku_tpu_torch.convert import flux_from_jax_params, to_torch
from nunchaku_tpu_torch.models.linear import AWQW4A16Linear
from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
from nunchaku_tpu_torch.ops import checks
from nunchaku_tpu_torch.ops.checks import MOD_DAMP
from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

TINY = dict(num_layers=1, num_single_layers=1, num_attention_heads=2, joint_attention_dim=512,
            pooled_projection_dim=256)
S_IMG, S_TXT = 256, 128
PRECISIONS = ["int4", "nvfp4"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops: one intra-op thread keeps their time steady when a
    parallel test run keeps every core busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(out, ref):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _inputs():
    rng = np.random.default_rng(60)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    lat = bf(rng.standard_normal((1, S_IMG, 64)))
    txt = bf(rng.standard_normal((1, S_TXT, 512)))
    pooled = bf(rng.standard_normal((1, 256)))
    ids = np.zeros((S_IMG, 3), np.int32)
    ids[:, 1] = np.arange(S_IMG) // 16
    ids[:, 2] = np.arange(S_IMG) % 16
    return lat, txt, pooled, np.array([0.5], np.float32), ids, np.zeros((S_TXT, 3), np.int32), \
        np.array([3.5], np.float32)


def damped_jax_model(precision, damp=True):
    """The JAX ``random_init`` model with its AdaLN modulation damped (the
    AWQ linears' scales and zeros x MOD_DAMP) -> (model, its parameters)."""
    jm = JaxFlux.random_init(jax.random.PRNGKey(1), JaxFluxConfig(precision=precision, **TINY))
    for blocks, names in ((jm.transformer_blocks, ("norm1", "norm1_context")),
                          (jm.single_transformer_blocks, ("norm",))):
        for name in names if damp else ():
            lin = getattr(blocks, name).linear
            lin.wscales = (lin.wscales.astype(jnp.float32) * MOD_DAMP).astype(jnp.bfloat16)
            lin.wzeros = (lin.wzeros.astype(jnp.float32) * MOD_DAMP).astype(jnp.bfloat16)
    return jm, {k: np.asarray(v) for k, v in jm.named_parameters()}


def _jax_forward(jm):
    return np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, _inputs())), np.float32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for precision in PRECISIONS:
        jm, params = damped_jax_model(precision)
        tm = flux_from_jax_params(params, FluxConfig(precision=precision, **TINY), device="cpu")
        out[precision] = (jm, params, tm)
    return out


@pytest.mark.parametrize("precision", PRECISIONS)
def test_forward_matches_jax(models, precision):
    jm, _, tm = models[precision]
    ref = _jax_forward(jm)
    with torch.no_grad():
        out = tm(*[to_torch(a, "cpu") for a in _inputs()])
    assert out.shape == (1, S_IMG, 64) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 2e-2


@pytest.mark.parametrize("precision", PRECISIONS)
def test_pipeline_two_steps_matches_jax(models, precision):
    jm, _, tm = models[precision]
    lat, txt, pooled = _inputs()[:3]
    kw = dict(height=256, width=256, num_inference_steps=2)
    ref = JaxPipeline(jm, vae=None)(prompt_embeds=jnp.asarray(txt), pooled_prompt_embeds=jnp.asarray(pooled),
                                    latents=jnp.asarray(lat), **kw).latents
    out = FluxPipeline(tm, vae=None)(prompt_embeds=to_torch(txt, "cpu"), pooled_prompt_embeds=to_torch(pooled, "cpu"),
                                     latents=to_torch(lat, "cpu"), **kw).latents
    assert out.shape == (1, S_IMG, 64) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 2e-2


def test_bf16_stream_fallback_matches_jax(models):
    """On a bf16 stream the 4-bit blocks take the unfused branches (JAX
    ``_ln_producer_ok`` is false), with the fused qkv prologue on."""
    jm, params = damped_jax_model("int4")
    jm.set_stream_dtype(jnp.bfloat16).enable_fused_qkv_prep()
    args = _inputs()
    ref = np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, args)), np.float32)
    tm = flux_from_jax_params(params, FluxConfig(precision="int4", **TINY), device="cpu")
    tm.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    with torch.no_grad():
        out = tm(*[to_torch(a, "cpu") for a in args])
    assert _rel(out, ref) <= 2e-2


def test_converter_takes_every_parameter(models):
    jm, params, tm = models["int4"]
    blk = tm.layer_views()["transformer_blocks"][0]
    np.testing.assert_array_equal(blk.ff.fc1.qweight.numpy(), params["transformer_blocks.ff.fc1.qweight"][0])
    assert blk.ff.fc1.precision == "int4" and not blk.ff.fc1.act_unsigned and blk.ff.fc2.act_unsigned
    assert isinstance(blk.norm1.linear, AWQW4A16Linear)
    single = tm.layer_views()["single_transformer_blocks"][0]
    assert single.mlp_fc2.act_unsigned and not single.attn_out.act_unsigned
    assert not models["nvfp4"][2].layer_views()["single_transformer_blocks"][0].mlp_fc2.act_unsigned
    with pytest.raises(KeyError):
        flux_from_jax_params({**params, "extra.weight": np.zeros(1)}, FluxConfig(precision="int4", **TINY),
                             device="cpu")


@pytest.mark.parametrize("precision", PRECISIONS)
def test_random_init_mirrors_the_jax_parameter_tree(models, precision):
    """Same parameter names, shapes and dtypes as the JAX model: the blocks
    are stacked, their buffers (L, ...) as the JAX leaves."""
    _, params, _ = models[precision]
    tm = FluxTransformer2DModel.random_init(FluxConfig(precision=precision, **TINY), seed=0, device="cpu")
    ours = {name: (tuple(buf.shape), str(buf.dtype).replace("torch.", "")) for name, buf in tm.named_buffers()}
    theirs = {name: (tuple(a.shape), str(a.dtype)) for name, a in params.items()}
    assert ours == theirs


@pytest.mark.parametrize("damp", [False, True])
def test_jax_int4_routes_agree_only_when_damped(monkeypatch, damp):
    """The reason for damping: the JAX package's Pallas int4 GEMM and its
    XLA route (``NUNCHAKU_TPU_INT4_XLA=1`` with the f32 epilogue, so the
    same bf16 operands and products, f32 sums in another order) end more
    than 2e-2 apart on the undamped 1 + 1-block model, and within 2e-2 once
    the modulation is damped."""
    jm, _ = damped_jax_model("int4", damp=damp)
    pallas = _jax_forward(jm)
    monkeypatch.setenv("NUNCHAKU_TPU_INT4_XLA", "1")
    monkeypatch.setenv("NUNCHAKU_TPU_XLA_LORA_BF16", "0")
    xla = _jax_forward(jm)
    rel = _rel(xla, pallas)
    assert (rel <= 2e-2) if damp else (rel > 2e-2), rel


@pytest.mark.parametrize("mutation", [None, *checks.MOD_MUTATIONS])
def test_check_modulation_catches_wrong_modulations(models, mutation):
    """The modulation linears checked alone on the damped model: an exact
    copy passes; each wrong modulation fails."""
    tm = models["int4"][2]
    other = copy.deepcopy(tm)
    if mutation is not None:
        checks.mutate_modulation(other, mutation)
    _, ok, detail = checks.check_modulation(tm, other)
    assert ok == (mutation is None), detail
