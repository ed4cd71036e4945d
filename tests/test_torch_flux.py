"""The port's FLUX transformer and 2-step text-to-latents pipeline against
the JAX package at a tiny config (CPU), with weights carried across by
``flux_from_jax_params``.

Tolerance for model outputs and latents: max error <= 2e-2 of the
reference's max |value| -- the level of tests/test_flux_model.py's
equivalence checks (int8 codes flip at rounding boundaries, bf16 outputs).
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
from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

TINY = dict(num_layers=1, num_single_layers=1, num_attention_heads=2, joint_attention_dim=512,
            pooled_projection_dim=256)
S_IMG, S_TXT = 256, 128


def _rel(out, ref):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _inputs():
    rng = np.random.default_rng(30)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    lat = bf(rng.standard_normal((1, S_IMG, 64)))
    txt = bf(rng.standard_normal((1, S_TXT, 512)))
    pooled = bf(rng.standard_normal((1, 256)))
    ids = np.zeros((S_IMG, 3), np.int32)
    ids[:, 1] = np.arange(S_IMG) // 16
    ids[:, 2] = np.arange(S_IMG) % 16
    return lat, txt, pooled, np.array([0.5], np.float32), ids, np.zeros((S_TXT, 3), np.int32), \
        np.array([3.5], np.float32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for precision in ("w4a8", "int8"):
        jm = JaxFlux.random_init(jax.random.PRNGKey(0), JaxFluxConfig(precision=precision, **TINY))
        params = {k: np.asarray(v) for k, v in jm.named_parameters()}
        tm = flux_from_jax_params(params, FluxConfig(precision=precision, **TINY), device="cpu")
        ref = np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, _inputs())), np.float32)
        out[precision] = (jm, params, tm, ref)
    return out


@pytest.mark.parametrize("precision", ["w4a8", "int8"])
def test_forward_matches_jax(models, precision):
    _, _, tm, ref = models[precision]
    with torch.no_grad():
        out = tm(*[to_torch(a, "cpu") for a in _inputs()])
    assert out.shape == (1, S_IMG, 64) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 2e-2


def test_embed_matches_jax(models):
    jm, _, tm, _ = models["w4a8"]
    args = _inputs()
    img_r, txt_r, temb_r, rot_r = jm.embed(*map(jnp.asarray, args))
    img, txt, temb, rot = tm.embed(*[to_torch(a, "cpu") for a in args])
    # the embedders return bf16 (f32 sums in another order may round one ulp apart)
    assert _rel(img, img_r) <= 1e-2 and _rel(txt, txt_r) <= 1e-2
    assert _rel(temb, temb_r) <= 1e-2
    np.testing.assert_allclose(rot.numpy(), np.asarray(rot_r), rtol=1e-5, atol=1e-5)


def test_pipeline_two_steps_matches_jax(models):
    jm, _, tm, _ = models["w4a8"]
    lat, txt, pooled = _inputs()[:3]
    kw = dict(height=256, width=256, num_inference_steps=2)
    ref = JaxPipeline(jm, vae=None)(prompt_embeds=jnp.asarray(txt), pooled_prompt_embeds=jnp.asarray(pooled),
                                    latents=jnp.asarray(lat), **kw).latents
    out = FluxPipeline(tm, vae=None)(prompt_embeds=to_torch(txt, "cpu"), pooled_prompt_embeds=to_torch(pooled, "cpu"),
                                     latents=to_torch(lat, "cpu"), **kw).latents
    assert out.shape == (1, S_IMG, 64) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 2e-2


def test_pipeline_noise_comes_from_the_seed(models):
    _, _, tm, _ = models["w4a8"]
    txt, pooled = (to_torch(a, "cpu") for a in _inputs()[1:3])
    pipe = FluxPipeline(tm)
    run = lambda seed: pipe(prompt_embeds=txt, pooled_prompt_embeds=pooled, height=128, width=128,
                            num_inference_steps=1, seed=seed).latents
    a, b, c = run(0), run(0), run(1)
    assert a.shape == (1, 64, 64) and torch.isfinite(a.float()).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_converter_takes_every_parameter(models):
    jm, params, tm, _ = models["w4a8"]
    views = tm.layer_views()
    blk = views["transformer_blocks"][0]
    np.testing.assert_array_equal(blk.ff.fc1.qweight.numpy(), params["transformer_blocks.ff.fc1.qweight"][0])
    assert blk.ff.fc1.precision == "w4a8" and blk.norm1.linear.precision == "int8"
    assert views["single_transformer_blocks"][0].mlp_fc2.in_features == 4 * jm.cfg.dim
    with pytest.raises(KeyError):
        flux_from_jax_params({**params, "extra.weight": np.zeros(1)}, FluxConfig(precision="w4a8", **TINY),
                             device="cpu")


def test_random_init_mirrors_the_jax_parameter_tree(models):
    """Same parameter names, shapes and dtypes as the JAX model: the blocks
    are stacked, their buffers (L, ...) as the JAX leaves."""
    _, params, _, _ = models["w4a8"]
    tm = FluxTransformer2DModel.random_init(FluxConfig(precision="w4a8", **TINY), seed=0, device="cpu")
    ours = {name: (tuple(buf.shape), str(buf.dtype).replace("torch.", "")) for name, buf in tm.named_buffers()}
    theirs = {name: (tuple(a.shape), str(a.dtype)) for name, a in params.items()}
    assert ours == theirs


def test_flux_config_defaults_match_jax():
    """``FluxConfig()`` builds the same model in both packages: every field
    the port has defaults to the JAX value (precision "int4" included)."""
    import dataclasses

    theirs = JaxFluxConfig()
    for f in dataclasses.fields(FluxConfig):
        assert getattr(FluxConfig(), f.name) == getattr(theirs, f.name), f.name
    assert FluxConfig().precision == "int4"
