"""The port's VAE encoder against the JAX package (CPU): ``Downsample``,
``Encoder`` and ``AutoencoderKL.encode``, with the same weights (carried by
``vae_from_jax_params``) and the same seeded numpy inputs, and the encoder
weights the converter and ``load_autoencoder`` produce.

Structure: ``MIXED`` of tests/test_torch_vae.py (blocks 32, 32, 64, 128, one
resnet each), with random norms and biases and damped resnet branches
(``_vae_pair``): its 128-wide mid block takes the online flash kernel's
twin on a 256px image (32x32 = 1024 tokens) and the f32 einsum on a 64px
one.

Tolerances (the decoder's of tests/test_torch_vae.py):
- ``Downsample`` (one convolution): max error <= 2e-2 of the reference's
  max |value|.
- ``Encoder`` moments and ``encode`` latents (the mode): max error <= 2e-2
  and mean error <= 5e-3 of the reference's max |value| (bf16 rounding flips
  compound through the encoder's layers, the bias of a convolution is added
  after a bf16 rounding on some backends).
- The sample's formula, the converter's and the loaders' weights: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunchaku_tpu.models import autoencoder as jvae
from nunchaku_tpu_torch import load_autoencoder
from nunchaku_tpu_torch.convert import to_torch, vae_from_jax_params
from nunchaku_tpu_torch.models import autoencoder as tvae
from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
from nunchaku_tpu_torch.tools import synth_checkpoint as synth

from test_torch_vae import MIXED, _bf, _rel, _vae_pair, _x

VAE_SMALL = dict(block_out_channels=(32, 32, 64, 64), layers_per_block=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mixed():
    return _vae_pair(MIXED, 1)


def _images(size, seed):
    return _bf(np.random.default_rng(seed).uniform(0.0, 1.0, (1, size, size, 3)))


def _close(out, ref):
    """max and mean error over the reference's max |value|."""
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(out - ref)
    return err.max() / scale, err.mean() / scale


@pytest.mark.parametrize("hw", [(16, 16), (15, 17)])
def test_downsample_matches_jax(mixed, hw):
    """Pad by one at the bottom and right, stride 2, no padding: even and odd
    sides give JAX's output shape."""
    jv, _, tv = mixed
    x = _x((1, 32, *hw), 40)
    ref = np.asarray(jv.encoder.downsamplers[1](jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        out = tv.encoder.downsamplers[1](to_torch(x, "cpu"))
    assert isinstance(tv.encoder.downsamplers[1], tvae.Downsample)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape == (1, 32, hw[0] // 2, hw[1] // 2)
    assert _rel(out, ref) <= 2e-2


def test_encoder_moments_match_jax(mixed):
    jv, _, tv = mixed
    x = _bf(np.random.default_rng(41).uniform(-1.0, 1.0, (1, 3, 64, 64)))
    ref = np.asarray(jax.jit(lambda m, a: m(a))(jv.encoder, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        out = tv.encoder(to_torch(x, "cpu"))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape == (1, 32, 8, 8)
    mx, mean = _close(out, ref)
    assert mx <= 2e-2 and mean <= 5e-3


@pytest.mark.parametrize("size,branch", [(256, "flash"), (64, "einsum")])
def test_encode_mode_matches_jax(mixed, size, branch):
    """(B, H, W, 3) in [0, 1] -> scaled latents (B, 16, H/8, W/8): the mean of
    the moments, shifted and scaled by the bf16-rounded factors. At 256px
    the mid block (128 wide, 32x32) runs the flash kernel's twin (no
    launch on the CPU)."""
    jv, _, tv = mixed
    img = _images(size, 42)
    ref = np.asarray(jax.jit(lambda m, a: m.encode(a))(jv, jnp.asarray(img)).astype(jnp.float32))
    reset_launch_counts()
    out = tv.encode(to_torch(img, "cpu"))
    assert launch_counts()["flash_online"] == 0
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape == (1, 16, size // 8, size // 8)
    mx, mean = _close(out, ref)
    assert mx <= 2e-2 and mean <= 5e-3


def test_encode_sample_formula(mixed):
    """With a generator: ``mean + exp(clip(logvar, -30, 20) / 2) * noise``
    before the shift and scale, the noise a bf16 rounding of the
    generator's normal draw; the same seed gives the same sample."""
    _, _, tv = mixed
    img = to_torch(_images(64, 43), "cpu")
    with torch.no_grad():
        mean, logvar = tv.encoder((img * 2.0 - 1.0).permute(0, 3, 1, 2).to(torch.bfloat16)).chunk(2, dim=1)
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(7)).to(torch.bfloat16)
    sf, sh = torch.tensor(0.3611, dtype=torch.bfloat16), torch.tensor(0.1159, dtype=torch.bfloat16)
    want = (mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * noise - sh) * sf
    got = tv.encode(img, generator=torch.Generator().manual_seed(7))
    assert torch.equal(got, want)
    assert torch.equal(got, tv.encode(img, generator=torch.Generator().manual_seed(7)))
    mode = tv.encode(img)
    assert torch.equal(mode, (mean - sh) * sf) and not torch.equal(got, mode)


def test_converter_carries_and_checks_the_encoder(mixed):
    _, params, tv = mixed
    for name, buf in tv.encoder.named_buffers():
        np.testing.assert_array_equal(buf.float().numpy(), params["encoder." + name].astype(np.float32), name)
    assert len(tv.encoder.downsamplers) == 3 and tv.encoder.conv_out.weight.shape[0] == 32
    with pytest.raises(KeyError):
        vae_from_jax_params({**params, "encoder.extra.weight": np.zeros(1)}, **MIXED, device="cpu")
    wrong = {**params, "encoder.conv_out.weight": np.zeros((16, 128, 3, 3), params["encoder.conv_out.weight"].dtype)}
    with pytest.raises(ValueError):
        vae_from_jax_params(wrong, **MIXED, device="cpu")
    decoder_only = vae_from_jax_params({k: v for k, v in params.items() if k.startswith("decoder.")}, **MIXED,
                                       device="cpu")
    assert decoder_only.encoder is None
    with pytest.raises(ValueError, match="no encoder"):
        decoder_only.encode(torch.zeros((1, 64, 64, 3)))


def test_random_init_mirrors_the_jax_encoder(mixed):
    """At latent 16, where the JAX ``random_init``'s 2 x 16 conv_out and the
    port's 2 x latent_channels agree."""
    _, params, _ = mixed
    tv = tvae.AutoencoderKL.random_init(seed=0, **MIXED, device="cpu")
    ours = {n: (tuple(b.shape), str(b.dtype).replace("torch.", "")) for n, b in tv.named_buffers()
            if n.startswith("encoder.")}
    theirs = {n: (tuple(a.shape), str(a.dtype)) for n, a in params.items() if n.startswith("encoder.")}
    assert ours == theirs
    # the decoder is drawn first: its weights do not depend on the encoder's
    gen = torch.Generator().manual_seed(0)
    dec = tvae.Decoder.random_init(gen, 16, MIXED["block_out_channels"], MIXED["layers_per_block"], "cpu")
    for (name, a), (_, b) in zip(dec.named_buffers(), tv.decoder.named_buffers(), strict=True):
        assert torch.equal(a, b), name


@pytest.fixture(scope="module")
def synth_vae():
    state, _ = synth.vae_state(**VAE_SMALL, encoder=True, seed=5, device="cpu")
    jm = jvae.load_autoencoder({k: v.float().numpy() for k, v in state.items()}, **VAE_SMALL)
    return state, jm


def test_loader_reads_the_encoder_as_jax_does(synth_vae):
    """A synthesized diffusers file with ``encoder.*`` keys: every buffer of
    the port's VAE, encoder included, equals the JAX loader's bit for bit,
    and so does the encode of one image."""
    state, jm = synth_vae
    tm = load_autoencoder(state, **VAE_SMALL, device="cpu")
    ref_model = vae_from_jax_params({k: np.asarray(v) for k, v in jm.named_parameters()}, **VAE_SMALL, device="cpu")
    assert tm.encoder is not None
    names = [n for n, _ in tm.named_buffers()]
    assert sum(n.startswith("encoder.") for n in names) == len([k for k in state if k.startswith("encoder.")])
    for (name, t), (ref_name, u) in zip(tm.named_buffers(), ref_model.named_buffers(), strict=True):
        assert name == ref_name
        assert torch.equal(t.contiguous().view(torch.uint8), u.contiguous().view(torch.uint8)), name
    assert [d.conv.stride for d in tm.encoder.downsamplers] == [2, 2, 2]
    assert [d.conv.padding for d in tm.encoder.downsamplers] == [0, 0, 0]
    img = _images(64, 44)
    assert torch.equal(tm.encode(to_torch(img, "cpu")), ref_model.encode(to_torch(img, "cpu")))


def test_loader_encoder_refusals(synth_vae):
    """Decoder-only files still load (``encoder=None``; ``encode`` raises
    ValueError); a partial encoder is a missing key; a wrong shape raises."""
    state, _ = synth_vae
    decoder_only = {k: v for k, v in state.items() if not k.startswith("encoder.")}
    tm = load_autoencoder(decoder_only, **VAE_SMALL, device="cpu")
    assert tm.encoder is None
    with pytest.raises(ValueError):
        tm.encode(torch.zeros((1, 64, 64, 3)))
    with pytest.raises(KeyError):
        load_autoencoder({**decoder_only, "encoder.conv_in.weight": state["encoder.conv_in.weight"],
                          "encoder.conv_in.bias": state["encoder.conv_in.bias"]}, **VAE_SMALL, device="cpu")
    bad = dict(state)
    bad["encoder.down_blocks.0.downsamplers.0.conv.weight"] = torch.zeros((32, 32, 1, 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        load_autoencoder(bad, **VAE_SMALL, device="cpu")


def test_synth_vae_state_keys():
    """``vae_state(encoder=True)`` adds the diffusers encoder keys, and only
    them, to the decoder's."""
    dec, _ = synth.vae_state(**VAE_SMALL, seed=1, device="cpu")
    both, _ = synth.vae_state(**VAE_SMALL, encoder=True, seed=1, device="cpu")
    assert set(both) - set(dec) == {k for k in both if k.startswith("encoder.")}
    assert set(dec) <= set(both) and not any(k.startswith("encoder.") for k in dec)
    assert tuple(both["encoder.conv_out.weight"].shape) == (32, 64, 3, 3)
    assert tuple(both["encoder.mid_block.attentions.0.to_q.weight"].shape) == (64, 64)
