"""The port's FLUX transformer and 2-step pipeline in the turbo configuration
(bf16 residual stream + fused qkv prologue, as ``bench.py`` serves it)
against the JAX package's at the tiny config of tests/test_torch_flux.py
(CPU). Weights come un-permuted through ``flux_from_jax_params``; both
models then switch on their own (``set_stream_dtype`` +
``enable_fused_qkv_prep``).

Tolerance for model outputs and latents: max error <= 2e-2 of the
reference's max |value| (int8 codes flip at rounding boundaries, bf16
stream and outputs).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models.transformers.transformer_flux import FluxConfig as JaxFluxConfig
from nunchaku_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from nunchaku_tpu.pipeline.pipeline_flux import FluxPipeline as JaxPipeline
from nunchaku_tpu_torch.convert import flux_from_jax_params, to_torch
from nunchaku_tpu_torch.models.transformer_flux import FluxConfig
from nunchaku_tpu_torch.ops.attention import rope_table_halfsplit
from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

from test_torch_flux import S_IMG, TINY, _inputs, _rel


def _turbo_pair(precision, seed):
    jm = JaxFlux.random_init(jax.random.PRNGKey(seed), JaxFluxConfig(precision=precision, **TINY))
    params = {k: np.asarray(v) for k, v in jm.named_parameters()}
    tm = flux_from_jax_params(params, FluxConfig(precision=precision, **TINY), device="cpu")
    jm.set_stream_dtype(jnp.bfloat16)
    jm.enable_fused_qkv_prep()
    tm.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    return jm, tm


@pytest.fixture(scope="module")
def models():
    out = {}
    for precision in ("w4a8", "int8"):
        jm, tm = _turbo_pair(precision, 1)
        ref = np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, _inputs())), np.float32)
        out[precision] = (jm, tm, ref)
    return out


@pytest.mark.parametrize("precision", ["w4a8", "int8"])
def test_turbo_forward_matches_jax(models, precision):
    _, tm, ref = models[precision]
    with torch.no_grad():
        out = tm(*[to_torch(a, "cpu") for a in _inputs()])
    assert out.shape == (1, S_IMG, 64) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 2e-2


def test_turbo_pipeline_two_steps_matches_jax(models):
    jm, tm, _ = models["w4a8"]
    lat, txt, pooled = _inputs()[:3]
    kw = dict(height=256, width=256, num_inference_steps=2)
    ref = JaxPipeline(jm, vae=None)(prompt_embeds=jnp.asarray(txt), pooled_prompt_embeds=jnp.asarray(pooled),
                                    latents=jnp.asarray(lat), **kw).latents
    out = FluxPipeline(tm, vae=None)(prompt_embeds=to_torch(txt, "cpu"), pooled_prompt_embeds=to_torch(pooled, "cpu"),
                                     latents=to_torch(lat, "cpu"), **kw).latents
    assert out.shape == (1, S_IMG, 64) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 2e-2


def test_turbo_embed_matches_jax(models):
    """bf16 streams and the half-split (cos, sin) rope pair."""
    jm, tm, _ = models["w4a8"]
    args = _inputs()
    img_r, txt_r, _, (cos_r, sin_r) = jm.embed(*map(jnp.asarray, args))
    img, txt, _, (cos, sin) = tm.embed(*[to_torch(a, "cpu") for a in args])
    assert img.dtype == txt.dtype == torch.bfloat16
    assert _rel(img, img_r) <= 1e-2 and _rel(txt, txt_r) <= 1e-2
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_r), rtol=1e-5, atol=1e-5)


def test_turbo_is_the_default_model_up_to_rounding():
    """Switching a model to turbo keeps its function (the JAX package's
    own equivalence bound for fused vs unfused, 2e-2 relative L2), and
    enable_fused_qkv_prep refuses to permute twice."""
    jm = JaxFlux.random_init(jax.random.PRNGKey(2), JaxFluxConfig(precision="int8", **TINY))
    params = {k: np.asarray(v) for k, v in jm.named_parameters()}
    tm = flux_from_jax_params(params, FluxConfig(precision="int8", **TINY), device="cpu")
    args = [to_torch(a, "cpu") for a in _inputs()]
    with torch.no_grad():
        ref = tm(*args).float()
        qw = tm.layer_views()["transformer_blocks"][0].attn.to_qkv.qweight.clone()
        tm.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
        out = tm(*args).float()
    with pytest.raises(ValueError):
        tm.enable_fused_qkv_prep()
    assert not torch.equal(qw, tm.layer_views()["transformer_blocks"][0].attn.to_qkv.qweight)
    assert (torch.linalg.norm(out - ref) / torch.linalg.norm(ref)).item() < 2e-2


def test_bf16_stream_without_fused_prologue_matches_jax():
    """set_stream_dtype(bf16) alone: the LN + modulate + quantize producers
    and the residual epilogue with the unfused attention prologue (the
    interleaved rope table), as in the JAX package."""
    jm = JaxFlux.random_init(jax.random.PRNGKey(4), JaxFluxConfig(precision="int8", **TINY))
    params = {k: np.asarray(v) for k, v in jm.named_parameters()}
    tm = flux_from_jax_params(params, FluxConfig(precision="int8", **TINY), device="cpu")
    jm.set_stream_dtype(jnp.bfloat16)
    tm.set_stream_dtype(torch.bfloat16)
    ref = np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, _inputs())), np.float32)
    with torch.no_grad():
        out = tm(*[to_torch(a, "cpu") for a in _inputs()])
    assert _rel(out, ref) <= 2e-2


def test_turbo_batch2_matches_jax(models):
    """B = 2 with distinct timesteps: each batch row takes its own AdaLN
    vectors in the producers and its own gate row in the residual epilogue."""
    jm, tm, _ = models["int8"]
    rng = np.random.default_rng(31)
    lat, txt, pooled, _, img_ids, txt_ids, _ = _inputs()
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    args = (bf(np.concatenate([lat, rng.standard_normal(lat.shape)])),
            bf(np.concatenate([txt, rng.standard_normal(txt.shape)])),
            bf(np.concatenate([pooled, rng.standard_normal(pooled.shape)])),
            np.array([0.5, 0.9], np.float32), img_ids, txt_ids, np.array([3.5, 2.0], np.float32))
    ref = np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, args)), np.float32)
    with torch.no_grad():
        out = tm(*[to_torch(a, "cpu") for a in args])
    assert out.shape == (2, S_IMG, 64)
    for i in range(2):
        assert _rel(out[i], ref[i]) <= 2e-2


def test_rope_table_halfsplit_layout():
    rot = torch.from_numpy(np.random.default_rng(3).standard_normal((5, 4, 2)).astype(np.float32))
    cos, sin = rope_table_halfsplit(rot)
    assert cos.shape == sin.shape == (5, 8)
    assert torch.equal(cos[:, :4], rot[..., 0]) and torch.equal(cos[:, 4:], rot[..., 0])
    assert torch.equal(sin[:, :4], -rot[..., 1]) and torch.equal(sin[:, 4:], rot[..., 1])
