"""The port's Qwen-Image pipeline and first-N-blocks cache against the JAX
package on the CPU, at the tiny configuration of tests/test_torch_qwenimage.py
(weights from the JAX ``random_init``, the same numpy latents and prompts).

Tolerances: latents and velocities within 2e-2 of the reference's max
|value| (as the model test); cache hit counts equal; a threshold of 0 (no
hit) bit for bit the uncached port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.caching import fbcache as jfb
from nunchaku_tpu.pipeline.pipeline_qwenimage import QwenImagePipeline as JaxPipeline
from nunchaku_tpu_torch.caching import fbcache as tfb
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.pipeline.pipeline_qwenimage import LIGHTNING_PRESETS, QwenImagePipeline

from test_torch_qwenimage import S_IMG, _bf, _rel, inputs, qwen_pair

KW = dict(height=128, width=128)  # 8 x 8 latent tokens: S_IMG


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jm, tm, _ = qwen_pair("w4a8", seed=4)
    return jm, tm


def _prompts():
    """Positive prompts padded to 24 tokens (24 and 9 valid), negative ones
    of 6 tokens with all-True masks, and the latents; numpy."""
    lat, txt, _, _, mask = inputs(seed=92)
    rng = np.random.default_rng(93)
    neg = _bf(rng.standard_normal((2, 6, 320)))
    return lat, txt, mask, neg, np.ones((2, 6), bool)


def _run_port(tm, batch=2, **kw):
    lat, txt, mask, neg, neg_mask = (a[:batch] for a in _prompts())
    return QwenImagePipeline(tm)(to_torch(txt, "cpu"), to_torch(neg, "cpu"), torch.from_numpy(mask),
                                 torch.from_numpy(neg_mask), latents=to_torch(lat, "cpu"), **KW, **kw)


def _run_both(jm, tm, batch=2, **kw):
    lat, txt, mask, neg, neg_mask = (a[:batch] for a in _prompts())
    ref = JaxPipeline(jm)(jnp.asarray(txt), jnp.asarray(neg), jnp.asarray(mask), jnp.asarray(neg_mask),
                          latents=jnp.asarray(lat), **KW, **kw)
    return _run_port(tm, batch, **kw), ref


def test_true_cfg_with_masks_matches_jax(pair):
    out, ref = _run_both(*pair, num_inference_steps=2, true_cfg_scale=4.0)
    assert out.latents.shape == (2, S_IMG, 64) and out.latents.dtype == torch.bfloat16 and out.images is None
    assert _rel(out.latents, ref.latents) <= 2e-2


def test_lightning_preset_matches_jax(pair):
    """lightning-4step: 4 steps at guidance 1.0, so the negative branch is
    not run (its embeddings are ignored)."""
    assert LIGHTNING_PRESETS["lightning-4step"] == dict(num_inference_steps=4, true_cfg_scale=1.0)
    out, ref = _run_both(*pair, lightning="lightning-4step", batch=1)
    assert _rel(out.latents, ref.latents) <= 2e-2


def test_refusals(pair):
    _, tm = pair
    lat, txt, mask, neg, _ = _prompts()
    pipe = QwenImagePipeline(tm)
    args = (to_torch(txt, "cpu"), to_torch(neg, "cpu"))
    with pytest.raises(ValueError, match="both prompt branches"):
        pipe(*args, torch.from_numpy(mask), num_inference_steps=1, **KW)
    with pytest.raises(NotImplementedError):  # ControlNet is not ported
        pipe(*args, num_inference_steps=1, **KW, control_image=np.zeros((1, 128, 128, 3)))
    # edit conditioning needs a VAE with an encoder, and cond_tokens their ids
    with pytest.raises(ValueError, match="encoder"):
        pipe(*args, num_inference_steps=1, **KW, image=np.zeros((1, 128, 128, 3)))
    with pytest.raises(ValueError, match="cond_ids"):
        pipe(*args, num_inference_steps=1, **KW, cond_tokens=torch.zeros((1, 64, 64), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        pipe(*args, num_inference_steps=1, cache="double_fb", **KW)


# ---------------------------------------------------------------------------
# the first-N-blocks cache
# ---------------------------------------------------------------------------


def test_forced_schedule_matches_jax(pair):
    """qwenimage_fb_cached_forward over four steps forced miss, hit, miss,
    hit (``fn_blocks=1``: block 0 is the indicator of the 2-block model),
    masked prompts at B 2: each velocity and the hit count as JAX's."""
    jm, tm = pair
    lat, txt, mask, _, _ = _prompts()
    ids = inputs()[3]
    jfwd = jax.jit(lambda m, st, x, t, f: jfb.qwenimage_fb_cached_forward(
        m, st, x, jnp.asarray(txt), t, jnp.asarray(ids), fn_blocks=1, encoder_hidden_states_mask=jnp.asarray(mask),
        force=f))
    jst = jfb.init_qwen_fb_state(2, S_IMG, 256)
    tst = tfb.init_qwen_fb_state(2, S_IMG, 256, device="cpu")
    rng = np.random.default_rng(94)
    for step, force in enumerate((0, 1, 0, 1)):
        x = _bf(lat.astype(np.float32) * (1.0 - 0.2 * step) + 0.1 * rng.standard_normal(lat.shape))
        t = np.full((2,), 0.9 - 0.2 * step, np.float32)
        ref, jst = jfwd(jm, jst, jnp.asarray(x), jnp.asarray(t), jnp.int32(force))
        with torch.no_grad():
            out, tst = tfb.qwenimage_fb_cached_forward(
                tm, tst, to_torch(x, "cpu"), to_torch(txt, "cpu"), torch.from_numpy(t), torch.from_numpy(ids),
                fn_blocks=1, encoder_hidden_states_mask=torch.from_numpy(mask), force=force)
        assert tst.hits == int(jst.hits) == (step + 1) // 2
        assert _rel(out, np.asarray(ref, np.float32)) <= 2e-2


@pytest.mark.parametrize("threshold,hits", [(0.0, 0), (1e9, 2 * 2)])
def test_cached_pipeline_matches_jax(pair, threshold, hits):
    """cache="fb" with true CFG: one state per branch, hits summed over
    both. Threshold 0 never hits (and is the uncached port bit for bit);
    1e9 hits at every step after the first in both branches."""
    jm, tm = pair
    kw = dict(num_inference_steps=3, true_cfg_scale=4.0, cache="fb", residual_diff_threshold=threshold,
              fn_blocks=8)
    out, ref = _run_both(jm, tm, **kw)
    assert out.cache_hits == int(ref.cache_hits) == hits
    assert _rel(out.latents, ref.latents) <= 2e-2
    if threshold == 0.0:
        plain = _run_port(tm, num_inference_steps=3, true_cfg_scale=4.0)
        assert torch.equal(out.latents, plain.latents)
