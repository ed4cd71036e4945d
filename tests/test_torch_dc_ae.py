"""The port's DC-AE against the JAX package's on the CPU: both load one numpy
state dict (``synthesize_dcae_state_dict``, the same function in both
packages) and encode / decode the same seeded inputs. A small config with
every block kind (ResBlocks, an EfficientViT stage with a multiscale
branch, down- and upsamplers). Each test states its tolerance.

Both sides round as XLA does (bf16 convolution operands with f32 sums and
one rounding, the bias added in bf16; f32 norms and linear attention), but
sum in another order: an element may sit one bf16 step from JAX's after
each convolution, and the steps compound over the blocks, so outputs are
held to max error <= 2e-2 of max |ref| (decoded images: 1e-2 absolute in
[0, 1]).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models import dc_ae as J
from nunchaku_tpu_torch.models import dc_ae as T

TINY = dict(latent_channels=4, attention_head_dim=8, block_out_channels=(8, 16, 32),
            encoder_block_types=("res", "res", "vit"), decoder_block_types=("res", "res", "vit"),
            encoder_layers_per_block=(1, 1, 1), decoder_layers_per_block=(2, 1, 2), qkv_multiscales=((), (), (5,)))


@pytest.fixture(scope="module")
def models():
    sd = T.synthesize_dcae_state_dict(T.DCAEConfig(**TINY), seed=3)
    jsd = J.synthesize_dcae_state_dict(J.DCAEConfig(**TINY), seed=3)
    assert sd.keys() == jsd.keys() and all(np.array_equal(sd[k], jsd[k]) for k in sd)
    return J.load_dc_ae(jsd, J.DCAEConfig(**TINY)), T.load_dc_ae(sd, T.DCAEConfig(**TINY), device="cpu")


def _rel(out, ref):
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / np.abs(ref).max()


def test_decode_matches_jax(models):
    jm, tm = models
    z = np.random.default_rng(5).standard_normal((2, 4, 4, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda m, a: m.decode(a))(jm, jnp.asarray(z)), np.float32)
    out = tm.decode(torch.from_numpy(z))
    assert out.shape == ref.shape == (2, 16, 16, 3) and out.dtype == torch.float32
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    assert np.abs(out.numpy() - ref).max() <= 1e-2


def test_encode_matches_jax(models):
    jm, tm = models
    img = np.random.default_rng(6).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    ref = jax.jit(lambda m, a: m.encode(a))(jm, jnp.asarray(img))
    out = tm.encode(torch.from_numpy(img))
    assert tuple(out.shape) == ref.shape == (2, 4, 4, 4) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 2e-2


@pytest.mark.parametrize("block", ["res", "vit"])
def test_blocks_match_jax(models, block):
    """One decoder ResBlock (stage 0) and one EfficientViTBlock (the
    deepest stage, with its 5x5 multiscale branch) on identical bf16 inputs:
    within 2e-2 of max |ref| (the linear attention's f32 sums and the
    convolutions' in another order)."""
    jm, tm = models
    c = 8 if block == "res" else 32
    x = np.asarray(jnp.asarray(np.random.default_rng(7).standard_normal((1, c, 8, 8)), jnp.bfloat16))
    jb = jm.dec_stages[-1][0] if block == "res" else jm.dec_stages[0][0]
    tb = tm.dec_stages[-1][0] if block == "res" else tm.dec_stages[0][0]
    ref = jax.jit(lambda b, a: b(a))(jb, jnp.asarray(x))
    out = tb(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16))
    assert tuple(out.shape) == ref.shape and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 2e-2


def test_random_init_and_config():
    """``random_init`` is ``load_dc_ae`` of the synthesized dict; the full
    config compresses 32x into 32 channels (dc-ae-f32c32-sana)."""
    cfg = T.DCAEConfig()
    assert 2 ** (len(cfg.block_out_channels) - 1) == 32 and cfg.latent_channels == 32
    m = T.DCAE.random_init(T.DCAEConfig(**TINY), seed=3, device="cpu")
    z = torch.randn((1, 4, 2, 2), generator=torch.Generator().manual_seed(0))
    assert tuple(m.decode(z).shape) == (1, 8, 8, 3)
    assert len(m.dec_stages[0]) == 2 and isinstance(m.dec_ups[0], torch.nn.Identity)
