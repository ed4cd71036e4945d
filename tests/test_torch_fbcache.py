"""The port's first-block caches (``"fb"``, ``"double_fb"``) and the image
pipeline against the JAX package (CPU), at the tiny turbo configuration of
tests/test_torch_turbo_flux.py and the tiny VAE of tests/test_torch_vae.py.

Tolerances: cache hit counts equal; latents within 2e-2 of the reference's
max |value| (as the uncached pipeline tests); images (values in [0, 1])
within 2e-2 absolute; a threshold of 0 bit-exact against the uncached port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunchaku_tpu.caching import fbcache as jfb
from nunchaku_tpu.pipeline.pipeline_flux import FluxPipeline as JaxPipeline
from nunchaku_tpu_torch.caching import fbcache as tfb
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

from test_torch_flux import _inputs, _rel
from test_torch_turbo_flux import _turbo_pair
from test_torch_vae import TINY as TINY_VAE
from test_torch_vae import _vae_pair

KW = dict(height=256, width=256)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path is thousands of tiny torch ops; in a parallel
    test run with every core busy, an intra-op thread pool waits on its
    threads at each of them. One thread keeps these tests' time steady."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return _turbo_pair("w4a8", 7)


def _args():
    lat, txt, pooled = _inputs()[:3]
    return lat, txt, pooled


def _port(tm, vae=None, **kw):
    lat, txt, pooled = _args()
    return FluxPipeline(tm, vae=vae)(prompt_embeds=to_torch(txt, "cpu"), pooled_prompt_embeds=to_torch(pooled, "cpu"),
                                     latents=to_torch(lat, "cpu"), **KW, **kw)


def _jax(jm, vae=None, **kw):
    lat, txt, pooled = _args()
    return JaxPipeline(jm, vae=vae)(prompt_embeds=jnp.asarray(txt), pooled_prompt_embeds=jnp.asarray(pooled),
                                    latents=jnp.asarray(lat), **KW, **kw)


@pytest.mark.parametrize("n,ratio", [(50, 0.5), (4, 0.5), (10, 0.3), (7, 1.0), (5, 0.0), (1, 0.5)])
def test_hit_schedule_matches_jax(n, ratio):
    np.testing.assert_array_equal(tfb.make_hit_schedule(n, ratio), jfb.make_hit_schedule(n, ratio))


@pytest.mark.parametrize("cache", ["fb", "double_fb"])
def test_forced_schedule_matches_jax(pair, cache):
    jm, tm = pair
    kw = dict(num_inference_steps=4, cache=cache, cache_hit_ratio=0.5)
    ref = _jax(jm, **kw)
    out = _port(tm, **kw)
    assert out.cache_hits == int(ref.cache_hits) == 2 and out.images is None
    assert out.latents.shape == (1, 256, 64) and _rel(out.latents, ref.latents) <= 2e-2


@pytest.mark.parametrize("cache", ["fb", "double_fb"])
def test_threshold_zero_is_the_uncached_port(pair, cache):
    _, tm = pair
    ref = _port(tm, num_inference_steps=3)
    out = _port(tm, num_inference_steps=3, cache=cache, residual_diff_threshold=0.0,
                single_residual_diff_threshold=0.0)
    assert out.cache_hits == 0 and ref.cache_hits is None
    assert torch.equal(out.latents, ref.latents)


@pytest.mark.parametrize("cache", ["fb", "double_fb"])
def test_huge_threshold_hits_every_step_but_the_first(pair, cache):
    _, tm = pair
    out = _port(tm, num_inference_steps=4, cache=cache, residual_diff_threshold=1e9,
                single_residual_diff_threshold=1e9)
    assert out.cache_hits == 3 and torch.isfinite(out.latents.float()).all()


def test_threshold_decisions_match_jax(pair):
    """Decisions from the residuals themselves (one host read each). The
    relative L1 distances of this run lie 0.68-0.82, each at least 0.028
    from 0.77: hits at steps 1-3 on both levels, misses at 0 and 4."""
    jm, tm = pair
    kw = dict(num_inference_steps=5, cache="double_fb", residual_diff_threshold=0.77,
              single_residual_diff_threshold=0.77)
    ref, out = _jax(jm, **kw), _port(tm, **kw)
    assert out.cache_hits == int(ref.cache_hits) == 3
    assert _rel(out.latents, ref.latents) <= 2e-2


def test_forced_decisions_never_read_the_residuals():
    def natural():
        raise AssertionError("a forced decision took the threshold route")

    assert tfb._apply_force(natural, 1) is True and tfb._apply_force(natural, 0) is False
    assert tfb._apply_force(lambda: True, -1) is True and tfb._apply_force(lambda: False, None) is False


def test_pipeline_refuses_bad_cache_arguments(pair):
    _, tm = pair
    with pytest.raises(ValueError):
        _port(tm, num_inference_steps=1, cache_hit_ratio=0.5)
    with pytest.raises(ValueError):  # a forced hit ratio is the FB caches' alone, as in JAX
        _port(tm, num_inference_steps=1, cache="teacache", cache_hit_ratio=0.5)
    with pytest.raises(ValueError):
        _port(tm, num_inference_steps=1, cache="unknown")


@pytest.mark.parametrize("tiled", [False, True])
def test_image_pipeline_matches_jax(pair, tiled):
    """Cached denoise then the VAE decode (whole, or tiles of 16 latents)."""
    jm, tm = pair
    jv, _, tv = _vae_pair(TINY_VAE, 3)
    if tiled:
        jv.enable_tiling(tile_latent_size=16)
        tv.enable_tiling(tile_latent_size=16)
    kw = dict(num_inference_steps=2, cache="double_fb", cache_hit_ratio=0.5)
    ref = _jax(jm, vae=jv, **kw)
    out = _port(tm, vae=tv, **kw)
    assert out.cache_hits == int(ref.cache_hits) == 1
    assert out.images.dtype == torch.float32 and tuple(out.images.shape) == (1, 256, 256, 3)
    assert float(out.images.min()) >= 0.0 and float(out.images.max()) <= 1.0
    assert np.abs(out.images.numpy() - np.asarray(ref.images)).max() <= 2e-2
