"""The port's Qwen-Image-Edit conditioning (``QwenImagePipeline.prepare_edit``
and ``__call__(image=, cond_tokens=, cond_ids=)``) against the JAX package
(CPU), at the tiny configuration of tests/test_torch_qwenimage_pipeline.py
(2 blocks, 2 heads, w4a8, 128x128: 64 image tokens) with true CFG over padded
prompts (24 and 9 valid tokens of 24), and the tiny VAE of
tests/test_torch_vae.py as the encoder.

Tolerances:
- ids of one reference (frame 1) and of two (Edit-2509: frames 1, 2): exact.
- Encoded tokens: the encoder's bound of tests/test_torch_vae_encoder.py, max
  error <= 2e-2 and mean error <= 5e-3 of the reference's max |value|.
- Latents: max error <= 2e-2 of the reference's max |value| (the Qwen
  pipeline tests' bound); cache hit counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunchaku_tpu.pipeline.pipeline_qwenimage import QwenImagePipeline as JaxPipeline
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.pipeline.pipeline_flux import make_img_ids
from nunchaku_tpu_torch.pipeline.pipeline_qwenimage import QwenImagePipeline

from test_torch_qwenimage import S_IMG, _rel
from test_torch_qwenimage_pipeline import KW, _prompts, pair  # noqa: F401  (pair: the model fixture)
from test_torch_vae import TINY as TINY_VAE
from test_torch_vae import _bf, _vae_pair
from test_torch_vae_encoder import _close


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vae():
    jv, _, tv = _vae_pair(TINY_VAE, 4)
    return jv, tv


def _images(*shape, seed):
    return _bf(np.random.default_rng(seed).uniform(0.0, 1.0, (*shape, 3)))


def _jax_edit(jv, images):
    """The JAX ``prepare_edit`` under one jit (its eager encode would
    compile op by op)."""
    return jax.jit(lambda v, ims: JaxPipeline(None, vae=v).prepare_edit(ims))(jv, [jnp.asarray(a) for a in images])


@pytest.mark.parametrize("sizes", [[(128, 128)], [(64, 64), (64, 96)]], ids=["edit", "edit-2509"])
def test_prepare_edit_matches_jax(vae, sizes):
    """Image i's tokens follow image i-1's with rope frame index i + 1 on
    the (H/16, W/16) grid; one image may be passed bare."""
    jv, tv = vae
    images = [_images(1, h, w, seed=60 + i) for i, (h, w) in enumerate(sizes)]
    ref_tok, ref_ids = _jax_edit(jv, images)
    pipe = QwenImagePipeline(None, vae=tv)
    arg = [to_torch(a, "cpu") for a in images]
    tok, ids = pipe.prepare_edit(arg if len(arg) > 1 else arg[0])
    grids = [(h // 16, w // 16) for h, w in sizes]
    s = sum(h * w for h, w in grids)
    assert tok.dtype == torch.bfloat16 and tuple(tok.shape) == ref_tok.shape == (1, s, 64)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    start = 0
    for i, (h, w) in enumerate(grids):
        part = ids[start:start + h * w]
        assert (part[:, 0] == i + 1).all() and torch.equal(part[:, 1:], make_img_ids(h, w)[:, 1:])
        start += h * w
    mx, mean = _close(tok, ref_tok)
    assert mx <= 2e-2 and mean <= 5e-3


def _run(jm, tm, cond, **kw):
    """Both pipelines at B 2 with true CFG 4.0 over the padded prompts, the
    reference tokens (1, S_cond, 64) broadcast to the batch."""
    lat, txt, mask, neg, neg_mask = _prompts()
    tok, ids = cond
    kw = dict(true_cfg_scale=4.0, **KW, **kw)
    ref = JaxPipeline(jm)(jnp.asarray(txt), jnp.asarray(neg), jnp.asarray(mask), jnp.asarray(neg_mask),
                          latents=jnp.asarray(lat), cond_tokens=jnp.asarray(tok), cond_ids=jnp.asarray(ids), **kw)
    out = QwenImagePipeline(tm)(to_torch(txt, "cpu"), to_torch(neg, "cpu"), torch.from_numpy(mask),
                                torch.from_numpy(neg_mask), latents=to_torch(lat, "cpu"),
                                cond_tokens=to_torch(np.array(tok), "cpu"), cond_ids=torch.from_numpy(np.array(ids)),
                                **kw)
    return out, ref


@pytest.fixture(scope="module")
def edit_2509(vae):
    """Two references (64 x 64 and 64 x 96: 16 + 24 tokens, frames 1 and 2)
    as the JAX package prepares them."""
    jv, _ = vae
    return _jax_edit(jv, [_images(1, 64, 64, seed=70), _images(1, 64, 96, seed=71)])


def test_edit_cfg_matches_jax(pair, edit_2509):  # noqa: F811
    """Uncached: the velocity of both CFG branches cut back to S_img."""
    out, ref = _run(*pair, edit_2509, num_inference_steps=2)
    assert out.latents.shape == (2, S_IMG, 64) and out.latents.dtype == torch.bfloat16
    assert _rel(out.latents, ref.latents) <= 2e-2


@pytest.mark.parametrize("threshold,hits", [(0.0, 0), (1e9, 2 * 2)])
def test_edit_fb_cache_matches_jax(pair, edit_2509, threshold, hits):  # noqa: F811
    """``cache="fb"``: each branch's state sized S_img + S_cond (104 rows),
    as JAX sizes it; hits summed over both branches."""
    out, ref = _run(*pair, edit_2509, num_inference_steps=3, cache="fb", residual_diff_threshold=threshold,
                    fn_blocks=1)
    assert out.cache_hits == int(ref.cache_hits) == hits
    assert _rel(out.latents, ref.latents) <= 2e-2


def test_edit_image_request(pair, vae):  # noqa: F811
    """``image=``: one reference encoded inside the request at B 2 (its
    tokens broadcast to both rows) equals the request given the same
    tokens and ids, and ControlNet stays refused."""
    _, tm = pair
    _, tv = vae
    lat, txt, mask, neg, neg_mask = _prompts()
    img = to_torch(_images(1, 128, 128, seed=72), "cpu")
    pipe = QwenImagePipeline(tm, vae=tv)
    args = (to_torch(txt, "cpu"), to_torch(neg, "cpu"), torch.from_numpy(mask), torch.from_numpy(neg_mask))
    kw = dict(latents=to_torch(lat, "cpu"), num_inference_steps=2, true_cfg_scale=4.0, **KW)
    out = pipe(*args, image=img, **kw)
    tok, ids = pipe.prepare_edit(img)
    again = QwenImagePipeline(tm)(*args, cond_tokens=tok, cond_ids=ids, **kw)
    assert torch.equal(out.latents, again.latents) and tuple(out.images.shape) == (2, 128, 128, 3)
    with pytest.raises(NotImplementedError):
        pipe(*args, image=img, control_image=img, **kw)
