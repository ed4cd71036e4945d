"""The port's Qwen-Image transformer against the JAX package on the CPU, at
the tiny configuration of tests/test_qwenimage.py (2 joint blocks, 2 heads
of 128, joint dim 320), weights from the JAX ``random_init`` carried by
``convert.qwenimage_from_jax_params``; inputs from seeded numpy generators.

Padded prompts at B 2: row 0 has all its 24 text tokens, row 1 only 9, and
``encoder_hidden_states_mask`` marks the rest.

Tolerance: model outputs within 2e-2 of the reference's max |value|, as for
FLUX (tests/test_torch_flux.py). At int4 the AdaLN modulation is damped on
both sides (``checks.MOD_DAMP``), for the reason tests/test_torch_int4_flux.py
shows: undamped, the JAX package's own two int4 GEMM routes end more than
2e-2 apart. The padded-versus-unpadded check keeps the JAX test's absolute
2e-2; an all-True mask gives the unmasked output bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models.transformers.transformer_qwenimage import QwenImageConfig as JaxQwenConfig
from nunchaku_tpu.models.transformers.transformer_qwenimage import QwenImageTransformer2DModel as JaxQwen
from nunchaku_tpu_torch.convert import qwenimage_from_jax_params, to_torch
from nunchaku_tpu_torch.models.transformer_qwenimage import QwenImageConfig, QwenImageTransformer2DModel
from nunchaku_tpu_torch.ops import checks
from nunchaku_tpu_torch.ops.checks import MOD_DAMP

TINY = dict(num_layers=2, num_attention_heads=2, joint_attention_dim=320)
S_IMG, S_TXT, VALID = 64, 24, (24, 9)
VARIANTS = ["plain", "txt_norm", "fused"]


@pytest.fixture(scope="module", autouse=True)
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


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def inputs(b=2, s_txt=S_TXT, valid=VALID, seed=90):
    """(latents, text states, timesteps, img_ids, mask) as numpy."""
    rng = np.random.default_rng(seed)
    lat = _bf(rng.standard_normal((b, S_IMG, 64)))
    txt = _bf(rng.standard_normal((b, s_txt, 320)))
    t = np.linspace(0.3, 0.8, b).astype(np.float32)
    ids = np.zeros((S_IMG, 3), np.int32)
    ids[:, 1] = np.arange(S_IMG) // 8
    ids[:, 2] = np.arange(S_IMG) % 8
    mask = np.arange(s_txt)[None, :] < np.asarray(valid)[:, None]
    return lat, txt, t, ids, mask


def qwen_pair(precision, txt_norm=False, seed=1):
    """The JAX ``random_init`` model (int4: AWQ modulation damped x MOD_DAMP;
    ``txt_norm``: with a random text RMSNorm weight) and the port's model
    carrying its weights."""
    jm = JaxQwen.random_init(jax.random.PRNGKey(seed), JaxQwenConfig(precision=precision, **TINY))
    if precision == "int4":
        for name in ("norm1", "norm1_context"):
            lin = getattr(jm.blocks, name).linear
            lin.wscales = (lin.wscales.astype(jnp.float32) * MOD_DAMP).astype(jnp.bfloat16)
            lin.wzeros = (lin.wzeros.astype(jnp.float32) * MOD_DAMP).astype(jnp.bfloat16)
    if txt_norm:
        jm.txt_norm = jnp.asarray(1.0 + 0.2 * np.random.default_rng(seed).standard_normal(320), jnp.bfloat16)
    params = {k: np.asarray(v) for k, v in jm.named_parameters()}
    tm = qwenimage_from_jax_params(params, QwenImageConfig(precision=precision, **TINY), device="cpu")
    return jm, tm, params


_jax_fwd = jax.jit(lambda m, *a, **k: m(*a, **k))


def _forward_pair(jm, tm, args, mask):
    ref = np.asarray(_jax_fwd(jm, *map(jnp.asarray, args),
                              encoder_hidden_states_mask=None if mask is None else jnp.asarray(mask)), np.float32)
    with torch.no_grad():
        out = tm(*[to_torch(a, "cpu") for a in args],
                 encoder_hidden_states_mask=None if mask is None else torch.from_numpy(mask))
    return out, ref


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("precision", ["w4a8", "int4"])
def test_masked_forward_matches_jax(precision, variant):
    jm, tm, _ = qwen_pair(precision, txt_norm=variant == "txt_norm")
    if variant == "fused":
        jm.enable_fused_qkv_prep()
        tm.enable_fused_qkv_prep()
    *args, mask = inputs()
    out, ref = _forward_pair(jm, tm, args, mask)
    assert out.shape == (2, S_IMG, 64) and out.dtype == torch.bfloat16
    for i in range(2):
        assert _rel(out[i], ref[i]) <= 2e-2


@pytest.mark.parametrize("precision", ["w4a8", "int4"])
def test_unmasked_forward_matches_jax(precision):
    jm, tm, _ = qwen_pair(precision, seed=2)
    *args, _ = inputs(b=1, valid=(S_TXT,))
    out, ref = _forward_pair(jm, tm, args, None)
    assert _rel(out, ref) <= 2e-2


@pytest.mark.parametrize("precision", ["w4a8", "int4"])
def test_encoder_hidden_states_mask_matches_unpadded(precision):
    """Padded text plus the mask gives the unpadded image-stream output (the
    text rope follows the token index, and masked keys add nothing), row by
    row at B 2; an all-True mask equals no mask bit for bit."""
    _, tm, _ = qwen_pair(precision, seed=3)
    lat, txt, t, ids, mask = (to_torch(a, "cpu") if a.dtype != bool else torch.from_numpy(a)
                              for a in inputs(seed=91))
    with torch.no_grad():
        out = tm(lat, txt, t, ids, encoder_hidden_states_mask=mask)
        for i, n in enumerate(VALID):
            ref = tm(lat[i:i + 1], txt[i:i + 1, :n], t[i:i + 1], ids)
            assert (out[i:i + 1].float() - ref.float()).abs().max().item() <= 2e-2
        ones = torch.ones_like(mask)
        assert torch.equal(tm(lat, txt, t, ids, encoder_hidden_states_mask=ones), tm(lat, txt, t, ids))


def test_converter_takes_every_parameter():
    _, tm, params = qwen_pair("int4", txt_norm=True)
    cfg = QwenImageConfig(precision="int4", **TINY)
    blocks = tm.layer_views()["blocks"]
    assert tm.txt_norm is not None and len(blocks) == 2 and tm.proj_out.weight.shape == (256, 64)
    np.testing.assert_array_equal(blocks[1].ff.fc1.qweight.numpy(), params["blocks.ff.fc1.qweight"][1])
    assert blocks[0].ff.fc2.act_unsigned and not blocks[0].ff.fc1.act_unsigned
    with pytest.raises(KeyError):
        qwenimage_from_jax_params({**params, "extra.weight": np.zeros(1)}, cfg, device="cpu")
    bad = dict(params, **{"proj_out.weight": params["proj_out.weight"][:, :32]})
    with pytest.raises(ValueError):
        qwenimage_from_jax_params(bad, cfg, device="cpu")


@pytest.mark.parametrize("precision", ["w4a8", "int4"])
def test_random_init_mirrors_the_jax_parameter_tree(precision):
    """Same parameter names, shapes and dtypes as the JAX model: the blocks
    are one stack, its buffers (L, ...) as the JAX leaves."""
    _, _, params = qwen_pair(precision)
    tm = QwenImageTransformer2DModel.random_init(QwenImageConfig(precision=precision, **TINY), seed=0,
                                                 device="cpu")
    ours = {name: (tuple(buf.shape), str(buf.dtype).replace("torch.", "")) for name, buf in tm.named_buffers()}
    theirs = {name: (tuple(a.shape), str(a.dtype)) for name, a in params.items()}
    assert ours == theirs


def test_config_matches_jax():
    ours, theirs = QwenImageConfig(), JaxQwenConfig()
    assert (ours.dim, ours.proj_out_channels, ours.num_layers, ours.joint_attention_dim, ours.precision) == (
        theirs.dim, theirs.proj_out_channels, theirs.num_layers, theirs.joint_attention_dim, theirs.precision)
    flux = ours.as_flux()
    assert (flux.num_single_layers, flux.pooled_projection_dim, flux.guidance_embeds) == (0, 0, False)
    assert vars(flux) == vars(theirs.as_flux())


def test_int4_modulation_linears_hold_alone():
    """Damping scales both sides alike, so the AWQ modulation linears are
    also held alone against their counterparts (here: a deep copy, and each
    wrong modulation of ``checks.MOD_MUTATIONS`` must fail)."""
    import copy

    _, tm, _ = qwen_pair("int4")
    assert checks.check_modulation(tm, copy.deepcopy(tm))[1]
    wrong = copy.deepcopy(tm)
    checks.mutate_modulation(wrong, "zeros left out")
    assert not checks.check_modulation(tm, wrong)[1]
