"""The port's Z-Image loader and pipeline against the JAX package on the CPU.

Loader: small synthesized v2 files (tests/torch_checkpoints.py ``ZIMAGE``:
dim 256, 2 heads of 128, 2 layers, 1 + 1 refiners, rank 16, the timestep and
adaLN linears 1024 wide) through both loaders: every buffer of the port's
stacks equal to the JAX loader's leaf of the same name bit for bit, the
config equal, at None / int8 / w4a8 from an int4 file, at None and w4a8
(which loads int8) from an nvfp4 file, and with ``skip_refiners`` (16-bit
refiner linears); each loaded model's forward within twice the spread of
the JAX package's own two GEMM routes on that model (measured on the CPU
by running the JAX forward with and without ``NUNCHAKU_TPU_INT4_XLA=1`` at
int4 / nvfp4, ``NUNCHAKU_TPU_XLA_LORA_BF16=0`` at int8 / w4a8: int4 2.41e-2,
int8 6.9e-3, w4a8 3.4e-3, nvfp4 1.80e-2, nvfp4 at w4a8 7.2e-3, int4 with
16-bit refiners 2.03e-2; the port ends 1.0e-2, 6.9e-3, 3.4e-3, 1.3e-2,
7.2e-3 and 1.7e-2 from JAX).

Pipeline: ``zimage_sigmas`` bit for bit; ``ZImagePipeline`` 2 steps at 256 x
256 from given latents on the int8 tiny model of tests/test_torch_zimage.py,
the Turbo preset (guidance 0) and CFG 4.0 with negative embeddings (two
B-size forwards a step), final latents within twice the JAX routes' spread
on the same runs (5.1e-3 and 1.55e-2; the port 5.1e-3 and 1.6e-2).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models.transformers.loader_zimage import load_zimage_transformer as jax_load_zimage
from nunchaku_tpu.pipeline.pipeline_zimage import ZImagePipeline as JaxPipeline
from nunchaku_tpu.pipeline.pipeline_zimage import zimage_sigmas as jax_sigmas
from nunchaku_tpu_torch import ZImagePipeline, load_zimage_transformer, zimage_sigmas
from nunchaku_tpu_torch.models.linear import Linear, SVDQW4A4Linear

import torch_checkpoints as TC
from test_torch_zimage import S_IMG, S_TXT, _bf16, _img_ids, _one_torch_thread, _rel, _t, tiny_models  # noqa: F401

# (file precision, skip_refiners, load precision) -> twice the JAX routes' spread (module docstring)
LOADS = {("int4", False, None): 4.8e-2, ("int4", False, "int8"): 1.4e-2, ("int4", False, "w4a8"): 6.9e-3,
         ("nvfp4", False, None): 3.6e-2, ("nvfp4", False, "w4a8"): 1.44e-2, ("int4", True, None): 4.1e-2}
PIPE = {"turbo": (dict(guidance_scale=0.0), 1.1e-2), "cfg": (dict(guidance_scale=4.0), 3.2e-2)}


@pytest.mark.parametrize("case", list(LOADS), ids=lambda c: f"{c[0]}{'-skip_refiners' if c[1] else ''}-{c[2]}")
def test_loader_matches_jax(tmp_path, case):
    """Buffers bit for bit, config and static attributes equal, the forward
    within the bound; an nvfp4 file at w4a8 loads int8 linears (stacked
    but read by their own weights, as in JAX), and ``skip_refiners`` keeps
    the refiners' linears 16-bit."""
    file_precision, skip, precision = case
    path = TC.zimage_checkpoint(tmp_path / "zimage.safetensors", file_precision, skip)
    jm = jax_load_zimage(path, precision=precision)
    tm = load_zimage_transformer(path, precision=precision, device="cpu")
    TC.assert_same_as_jax(tm, jm)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    want = "int8" if (file_precision, precision) == ("nvfp4", "w4a8") else precision or file_precision
    assert tm.cfg.precision == want and tm.layers.attention.to_qkv.precision == want
    refiner = tm.noise_refiner.feed_forward.w13
    assert isinstance(refiner, Linear) if skip else isinstance(refiner, SVDQW4A4Linear)
    rng = np.random.default_rng(102)
    x, c = _bf16(rng.standard_normal((1, S_IMG, 64))), _bf16(rng.standard_normal((1, S_TXT, 256)))
    t, ii, ti = np.array([0.5], np.float32), _img_ids(), np.zeros((S_TXT, 3), np.int32)
    ref = jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, (x, c, t, ii, ti)))
    with torch.no_grad():
        out = tm(_t(x), _t(c), torch.from_numpy(t), torch.from_numpy(ii), torch.from_numpy(ti))
    assert out.shape == (1, S_IMG, 64) and bool(torch.isfinite(out.float()).all())
    assert _rel(out, ref) <= LOADS[case]


def test_loader_refusals(tmp_path):
    """A file loads at its own 4-bit precision, int8 or w4a8, and refuses an
    unknown precision; the fused prep refuses 16-bit refiners (JAX's would
    fail on their missing qweight)."""
    path = TC.zimage_checkpoint(tmp_path / "zimage.safetensors", "int4", skip_refiners=True)
    for bad in ("nvfp4", "fp8"):
        with pytest.raises(ValueError):
            load_zimage_transformer(path, precision=bad, device="cpu")
    with pytest.raises(NotImplementedError):
        load_zimage_transformer(path, device="cpu").enable_fused_qkv_prep()


@pytest.mark.parametrize("shift", [3.0, 1.0])
@pytest.mark.parametrize("steps", [1, 2, 8, 50])
def test_sigmas_equal_jax(steps, shift):
    out, ref = zimage_sigmas(steps, shift), jax_sigmas(steps, shift)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("case", list(PIPE))
def test_pipeline_two_steps_matches_jax(case):
    """``ZImagePipeline``, 2 steps from given latents on the int8 tiny model:
    ``t = 1 - sigma``, the negative velocity, CFG only with negatives and
    guidance > 0 (as two B-size forwards); final latents within the bound,
    bf16 packed tokens."""
    jm, _, tm = tiny_models("int8")
    rng = np.random.default_rng(101)
    pe = _bf16(rng.standard_normal((1, S_TXT, 512)))
    ne = _bf16(rng.standard_normal((1, S_TXT, 512)) * 0.5)
    lat = rng.standard_normal((1, S_IMG, 64)).astype(np.float32)
    kw, tol = PIPE[case]
    kw = dict(kw, height=256, width=256, num_inference_steps=2)
    neg = ne if case == "cfg" else None
    ref = JaxPipeline(jm)(jnp.asarray(pe), latents=jnp.asarray(lat), negative_prompt_embeds=None if neg is None
                          else jnp.asarray(neg), **kw).latents
    out = ZImagePipeline(tm)(_t(pe), latents=torch.from_numpy(lat), negative_prompt_embeds=_t(neg), **kw)
    assert out.images is None and out.latents.shape == (1, S_IMG, 64) and out.latents.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.latents.float()).all())
    assert _rel(out.latents, ref) <= tol
    if case == "cfg":  # guidance 0 ignores the negatives: the unguided result
        plain = ZImagePipeline(tm)(_t(pe), latents=torch.from_numpy(lat), negative_prompt_embeds=_t(neg),
                                   **{**kw, "guidance_scale": 0.0}).latents
        assert torch.equal(plain, ZImagePipeline(tm)(_t(pe), latents=torch.from_numpy(lat),
                                                     **{**kw, "guidance_scale": 0.0}).latents)
        assert _rel(out.latents, plain) > 1e-3
