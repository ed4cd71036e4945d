"""The port's image-conditioned FLUX requests against the JAX package (CPU):
FLUX.1-Kontext reference tokens on the sequence axis (rope frame 1), FLUX.1
Canny / Depth control latents and FLUX.1-Fill masked-image + mask channels on
the channel axis, and the preparation of each from images through the VAE
encoder. Models: the tiny FLUX of tests/test_torch_flux.py at w4a8 (1 dual +
1 single block, 2 heads), in the default configuration (f32 stream) and the
turbo one (bf16 stream, fused qkv prologue), at ``in_channels`` 64, 128 and
384; the tiny VAE of tests/test_torch_vae.py. Each pipeline run gets the
same ``latents`` in both packages.

Tolerances:
- ``prepare_kontext`` / ``prepare_edit`` ids and ``prepare_fill``'s 256 mask
  channels: exact.
- Encoded tokens (Kontext, control, Fill's 64 image channels): the encoder's
  bound of tests/test_torch_vae_encoder.py, max error <= 2e-2 and mean
  error <= 5e-3 of the reference's max |value|.
- Pipeline latents: max error <= 2e-2 of the reference's max |value| (the
  pipeline tests' bound, tests/test_torch_fbcache.py); cache hits equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunchaku_tpu.models.transformers.transformer_flux import FluxConfig as JaxFluxConfig
from nunchaku_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from nunchaku_tpu.models.transformers.loader import load_flux_transformer as jax_load_flux
from nunchaku_tpu.pipeline.pipeline_flux import FluxPipeline as JaxPipeline
from nunchaku_tpu_torch import apply_cache_on_pipe, load_flux_transformer
from nunchaku_tpu_torch.convert import flux_from_jax_params, to_torch
from nunchaku_tpu_torch.models.transformer_flux import FluxConfig
from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline, make_img_ids
from nunchaku_tpu_torch.tools import synth_checkpoint as synth

import torch_checkpoints as ckpt
from test_torch_flux import TINY, _inputs, _rel
from test_torch_vae import TINY as TINY_VAE
from test_torch_vae import _bf, _vae_pair
from test_torch_vae_encoder import _close

KW = dict(height=256, width=256)  # 16 x 16 image tokens, as the tiny model's tests
S_IMG = 256


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed, in_channels=64, turbo=False):
    jm = JaxFlux.random_init(jax.random.PRNGKey(seed), JaxFluxConfig(precision="w4a8", in_channels=in_channels,
                                                                     **TINY))
    params = {k: np.asarray(v) for k, v in jm.named_parameters()}
    tm = flux_from_jax_params(params, FluxConfig(precision="w4a8", in_channels=in_channels, **TINY), device="cpu")
    if turbo:
        jm.set_stream_dtype(jnp.bfloat16)
        jm.enable_fused_qkv_prep()
        tm.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    return jm, tm


@pytest.fixture(scope="module")
def pairs():
    return {"default": _pair(20), "turbo": _pair(21, turbo=True)}


@pytest.fixture(scope="module")
def vae():
    jv, _, tv = _vae_pair(TINY_VAE, 3)
    return jv, tv


def _images(b, h, w, seed):
    return _bf(np.random.default_rng(seed).uniform(0.0, 1.0, (b, h, w, 3)))


def _jax_prep(jv, method, *args):
    """The JAX pipeline's preparation under one jit (its eager VAE encode
    would compile op by op)."""
    return jax.jit(lambda v, *a: getattr(JaxPipeline(None, vae=v), method)(*a))(jv, *map(jnp.asarray, args))


def _port(tm, vae=None, **kw):
    lat, txt, pooled = _inputs()[:3]
    return FluxPipeline(tm, vae=vae)(prompt_embeds=to_torch(txt, "cpu"), pooled_prompt_embeds=to_torch(pooled, "cpu"),
                                     latents=to_torch(lat, "cpu"), **KW, **kw)


def _jax(jm, vae=None, **kw):
    lat, txt, pooled = _inputs()[:3]
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return JaxPipeline(jm, vae=vae)(prompt_embeds=jnp.asarray(txt), pooled_prompt_embeds=jnp.asarray(pooled),
                                    latents=jnp.asarray(lat), **KW, **kw)


# ---------------------------------------------------------------------------
# preparation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(128, 128), (96, 160)])
def test_prepare_kontext_matches_jax(vae, hw):
    """Reference tokens within the encoder's bound; ids exactly JAX's: the
    (H/16, W/16) grid with axis 0 (the rope frame) set to 1."""
    jv, tv = vae
    img = _images(1, *hw, 50)
    ref_tok, ref_ids = _jax_prep(jv, "prepare_kontext", img)
    tok, ids = FluxPipeline(None, vae=tv).prepare_kontext(to_torch(img, "cpu"))
    s = (hw[0] // 16) * (hw[1] // 16)
    assert tok.dtype == torch.bfloat16 and tuple(tok.shape) == ref_tok.shape == (1, s, 64)
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (s, 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    assert (ids[:, 0] == 1).all() and torch.equal(ids[:, 1:], make_img_ids(hw[0] // 16, hw[1] // 16)[:, 1:])
    mx, mean = _close(tok, ref_tok)
    assert mx <= 2e-2 and mean <= 5e-3


def test_prepare_control_matches_jax(vae):
    jv, tv = vae
    img = _images(1, 256, 256, 51)
    ref = _jax_prep(jv, "prepare_control", img)
    out = FluxPipeline(None, vae=tv).prepare_control(to_torch(img, "cpu"))
    assert tuple(out.shape) == ref.shape == (1, S_IMG, 64)
    mx, mean = _close(out, ref)
    assert mx <= 2e-2 and mean <= 5e-3


@pytest.fixture(scope="module")
def fill(vae):
    jv, tv = vae
    rng = np.random.default_rng(52)
    img = rng.uniform(0.0, 1.0, (2, 256, 256, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 256, 256)) < 0.3).astype(np.float32)
    ref = np.asarray(_jax_prep(jv, "prepare_fill", img, mask).astype(jnp.float32))
    out = FluxPipeline(None, vae=tv).prepare_fill(torch.from_numpy(img), torch.from_numpy(mask))
    return ref, out


def test_prepare_fill_matches_jax(fill):
    """(B, S, 320) bf16: the masked image's tokens within the encoder's
    bound, the 256 mask channels (8x8 then 2x2 patchified) exactly JAX's."""
    ref, out = fill
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape == (2, S_IMG, 320)
    np.testing.assert_array_equal(out[..., 64:].float().numpy(), ref[..., 64:])
    assert set(np.unique(ref[..., 64:])) <= {0.0, 1.0} and ref[..., 64:].mean() > 0.2
    mx, mean = _close(out[..., :64], ref[..., :64])
    assert mx <= 2e-2 and mean <= 5e-3


def test_image_conditioning_needs_an_encoder(pairs):
    _, tm = pairs["default"]
    with pytest.raises(ValueError, match="encoder"):
        FluxPipeline(tm).prepare_kontext(torch.zeros((1, 64, 64, 3)))
    with pytest.raises(ValueError, match="cond_ids"):
        _port(tm, num_inference_steps=1, cond_tokens=torch.zeros((1, 16, 64), dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# Kontext: reference tokens on the sequence axis
# ---------------------------------------------------------------------------


def _cond():
    """Pre-packed Kontext tokens of a 128 x 160 reference (8 x 10 = 80 tokens,
    not a multiple of the image's) and their frame-1 ids."""
    tok = _bf(np.random.default_rng(53).standard_normal((1, 80, 64)))
    ids = np.asarray(make_img_ids(8, 10))
    ids[:, 0] = 1
    return tok, ids


@pytest.mark.parametrize("config,cache", [("default", None), ("default", "fb"), ("default", "double_fb"),
                                          ("turbo", "fb"), ("turbo", "double_fb")])
def test_kontext_cond_tokens_match_jax(pairs, config, cache):
    """The model runs over S_img + S_cond image tokens, the velocity is cut
    back to S_img, the cache state is sized by both (a forced hit at step 1
    of 2) and the schedule by S_img alone. (The turbo configuration runs
    uncached in the next test.)"""
    jm, tm = pairs[config]
    tok, ids = _cond()
    kw = dict(num_inference_steps=2, cond_tokens=tok, cond_ids=ids)
    if cache is not None:
        kw |= dict(cache=cache, cache_hit_ratio=0.5)
    ref = _jax(jm, **kw)
    out = _port(tm, **{**kw, "cond_tokens": to_torch(tok, "cpu"), "cond_ids": torch.from_numpy(ids)})
    assert out.latents.shape == (1, S_IMG, 64) and out.latents.dtype == torch.bfloat16
    assert out.cache_hits == (None if cache is None else int(ref.cache_hits)) == (None if cache is None else 1)
    assert _rel(out.latents, ref.latents) <= 2e-2


def test_kontext_image_to_image_matches_jax(pairs, vae):
    """``image=``: the reference encoded inside the request, then the turbo
    model (uncached) and the VAE decode. The JAX side gets its own jitted
    ``prepare_kontext`` of the same image as ``cond_tokens`` and returns
    latents (its decode is held against the port's in
    tests/test_torch_fbcache.py)."""
    jm, tm = pairs["turbo"]
    jv, tv = vae
    img = _images(1, 128, 128, 54)
    tok, ids = _jax_prep(jv, "prepare_kontext", img)
    ref = _jax(jm, cond_tokens=tok, cond_ids=ids, num_inference_steps=2)
    out = _port(tm, vae=tv, image=to_torch(img, "cpu"), num_inference_steps=2)
    assert out.cache_hits is None
    assert _rel(out.latents, ref.latents) <= 2e-2
    assert out.images.dtype == torch.float32 and tuple(out.images.shape) == (1, 256, 256, 3)
    assert bool(torch.isfinite(out.images).all()) and 0.0 <= float(out.images.min()) <= float(out.images.max()) <= 1.0


# ---------------------------------------------------------------------------
# Canny / Depth and Fill: conditioning on the channel axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_channels", [128, 384])
def test_control_latents_match_jax(in_channels):
    """``in_channels`` 128 (Canny / Depth: 64 control channels) and 384 (Fill:
    320); the noise stays 16 channels (``out_channels // 4``), the output 64."""
    jm, tm = _pair(22 + in_channels, in_channels)
    cond = _bf(np.random.default_rng(in_channels).standard_normal((1, S_IMG, in_channels - 64)))
    kw = dict(num_inference_steps=2, control_latents=cond)
    ref = _jax(jm, **kw)
    out = _port(tm, **{**kw, "control_latents": to_torch(cond, "cpu")})
    assert tm.x_embedder.weight.shape[0] == in_channels and tm.cfg.out_channels == 64
    assert out.latents.shape == (1, S_IMG, 64)
    assert _rel(out.latents, ref.latents) <= 2e-2
    # seeded noise: out_channels // 4 = 16 latent channels, packed to 64
    noise = _port(tm, num_inference_steps=1, control_latents=to_torch(cond, "cpu")).latents
    assert noise.shape == (1, S_IMG, 64)


def test_fill_file_loads_as_jax_does(tmp_path):
    """A synthesized Fill-layout file (``flux_state(in_channels=384)``, int4):
    the port's loader reads every buffer as the JAX loader does, the config's
    ``in_channels`` 384 and ``x_embedder`` (384 x 3072 at full size, here
    384 x 256, (in, out) as the JAX leaf)."""
    path = tmp_path / "fill.safetensors"
    synth.write(path, synth.flux_state(layers=1, single=1, heads=2, joint=256, pooled=128, precision="int4",
                                       in_channels=384, seed=9, device="cpu"))
    jm = jax_load_flux(path)
    tm = load_flux_transformer(path, device="cpu")
    ckpt.assert_same_as_jax(tm, jm)
    assert tm.cfg.in_channels == jm.cfg.in_channels == 384 and tuple(tm.x_embedder.weight.shape) == (384, 256)


def test_apply_cache_on_pipe_sets_the_defaults(pairs):
    """As in JAX: ``default_cache`` and ``default_thresholds`` are set (and
    read by nothing)."""
    _, tm = pairs["default"]
    pipe = apply_cache_on_pipe(FluxPipeline(tm), use_double_fb_cache=True, residual_diff_threshold=0.2)
    ref = JaxPipeline(None)
    from nunchaku_tpu.pipeline.pipeline_flux import apply_cache_on_pipe as jax_apply

    jax_apply(ref, use_double_fb_cache=True, residual_diff_threshold=0.2)
    assert (pipe.default_cache, pipe.default_thresholds) == (ref.default_cache, ref.default_thresholds)
    assert apply_cache_on_pipe(FluxPipeline(tm)).default_cache == "fb"
