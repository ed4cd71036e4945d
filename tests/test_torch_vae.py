"""The port's VAE decoder and online flash attention against the JAX package
(CPU), with the same weights (carried by ``vae_from_jax_params``) and the
same seeded numpy inputs.

Tolerances:
- ``flash_attention_online_plain`` against the JAX ``flash_attention``
  (``_flash_kernel`` in interpret mode, ``bq = bkv = 128``): max error
  <= 1e-2 of the reference's max |value| (bf16 p and output; the rescales
  fall at other kv columns when the twin steps by 32 or 64, and a split
  twin's p is rounded against its range's own running max).
- The split twin against the unsplit one at the same tile: max error <=
  1e-2 of the unsplit output's max |value| (the same bound: only where the
  rescales and the bf16 roundings of p fall differs).
- Modules (``group_norm``, ``Conv2d``, ``ResnetBlock``, ``Upsample``,
  ``AttnBlock`` in both branches): max error <= 2e-2 of the reference's max
  |value| (bf16 activations; the convolution's bias is added after a bf16
  rounding on some backends, one ulp).
- Decoded images, whole and tiled (values in [0, 1]): max absolute error
  <= 2e-2 and mean absolute error <= 5e-3 (bf16 rounding flips compound
  through the decoder's 20 layers; see ``_vae_pair``).
- ``_tile_blend_mask``: exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunchaku_tpu.models import autoencoder as jvae
from nunchaku_tpu.ops.attention import flash_attention as jax_flash
from nunchaku_tpu_torch.convert import to_torch, vae_from_jax_params
from nunchaku_tpu_torch.models import autoencoder as tvae
from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
from nunchaku_tpu_torch.ops.attention import (ONLINE_BKV, WIDE_BKV, flash_attention_online, flash_attention_online_plain,
                                              online_splits, online_tile)

TINY = dict(block_out_channels=(32, 32, 32, 32), layers_per_block=1)
# mid block 128 wide (the flash branch at 32x32), an up block with a shortcut
MIXED = dict(block_out_channels=(32, 32, 64, 128), layers_per_block=1)


def _rel(out, ref):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _vae_pair(structure, seed):
    """A JAX VAE with random norms and biases (random_init makes them 1 and
    0) and resnet branches damped like a trained network's (conv2 x 0.25),
    and the port's decoder carrying the same weights. Undamped, the random
    decoder grows its residual stream and amplifies rare single bf16
    rounding flips (in either package) to a max image error near the 2e-2
    tolerance; damped, it stays clear of it."""
    jv = jvae.AutoencoderKL.random_init(jax.random.PRNGKey(seed), **structure)
    rng = np.random.default_rng(seed)
    params = {}
    for name, a in jv.named_parameters():
        a = np.asarray(a)
        if name.endswith(("bias", "_b")):
            a = _bf(rng.standard_normal(a.shape) * 0.1)
        elif name.endswith("_w"):
            a = _bf(1.0 + rng.standard_normal(a.shape) * 0.1)
        elif name.endswith("conv2.weight"):
            a = _bf(a.astype(np.float32) * 0.25)
        params[name] = a
    jv.load_state_dict({k: jnp.asarray(v) for k, v in params.items()})
    return jv, params, vae_from_jax_params(params, **structure, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread keeps these tests' time
    steady when a parallel test run keeps every core busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    return _vae_pair(TINY, 0)


@pytest.fixture(scope="module")
def mixed():
    return _vae_pair(MIXED, 1)


# ---------------------------------------------------------------------------
# the online flash kernel's plain twin against _flash_kernel
# ---------------------------------------------------------------------------

FLASH_CASES = [(1, 1, 300, 512), (1, 2, 300, 128)]


@pytest.fixture(scope="module")
def flash_cases():
    rng = np.random.default_rng(3)
    cases = {}
    for b, h, s, d in FLASH_CASES:
        q, k, v = (_bf(rng.standard_normal((b, h, s, d)) * sc) for sc in (2.0, 2.0, 1.0))
        ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=1.0 / math.sqrt(d), bq=128, bkv=128)
        cases[(b, h, s, d)] = ((q, k, v), np.asarray(ref, np.float32))
    return cases


@pytest.mark.parametrize("bkv", [32, WIDE_BKV, ONLINE_BKV])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_online_plain_matches_pallas(flash_cases, case, bkv):
    (q, k, v), ref = flash_cases[case]
    out = flash_attention_online_plain(*(to_torch(a, "cpu") for a in (q, k, v)), bkv=bkv)
    assert out.shape == case and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 1e-2


# (B, H, Sq, Skv, D) at the wide kernel's head dims: ragged S, Sq != Skv, and the kv splits it takes there
WIDE_CASES = [((1, 1, 100, 100, 512), 2), ((1, 1, 300, 300, 256), 4), ((1, 2, 100, 300, 512), 4),
              ((1, 1, 300, 100, 256), 2), ((2, 1, 65, 130, 512), 2), ((1, 1, 64, 64, 256), 1)]


@pytest.fixture(scope="module")
def wide_cases():
    rng = np.random.default_rng(5)
    cases = {}
    for (b, h, sq, skv, d), _ in WIDE_CASES:
        q = _bf(rng.standard_normal((b, h, sq, d)) * 2.0)
        k = _bf(rng.standard_normal((b, h, skv, d)) * 2.0)
        v = _bf(rng.standard_normal((b, h, skv, d)))
        ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=1.0 / math.sqrt(d), bq=128, bkv=128)
        cases[(b, h, sq, skv, d)] = ((q, k, v), np.asarray(ref, np.float32))
    return cases


@pytest.mark.parametrize("case,splits", WIDE_CASES)
def test_wide_twin_matches_pallas(wide_cases, case, splits):
    """The D 256 / 512 twin as the card check runs it (64-column rescales,
    the kernel's kv splits merged in range order) against _flash_kernel."""
    (q, k, v), ref = wide_cases[case]
    b, h, sq, skv, d = case
    assert online_tile(d) == WIDE_BKV and online_splits(b, h, sq, skv, d) == splits
    out = flash_attention_online(*(to_torch(a, "cpu") for a in (q, k, v)))
    assert tuple(out.shape) == (b, h, sq, d) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 1e-2


@pytest.mark.parametrize("splits", [2, 3, 4])
def test_wide_merged_twin_matches_unsplit(wide_cases, splits):
    """Merging kv ranges is the same function: the split twin against the
    unsplit one at the same 64-column tile (Sq != Skv, ragged)."""
    (q, k, v), _ = wide_cases[(1, 2, 100, 300, 512)]
    args = [to_torch(a, "cpu") for a in (q, k, v)]
    whole = flash_attention_online_plain(*args, bkv=WIDE_BKV)
    split = flash_attention_online_plain(*args, bkv=WIDE_BKV, splits=splits)
    assert _rel(split, whole.float().numpy()) <= 1e-2


def test_online_splits_rule():
    """The kv splits of the wide kernel's rule (mirrored in
    csrc/flash_online.cu wide_splits) at the VAE's shapes and the edges:
    the core's head dims never split; a 4096-token tile (64 query blocks)
    splits in two, a whole 1024px image (256) not at all."""
    assert online_splits(1, 1, 4096, 4096, 512) == 2 and online_splits(1, 1, 4096, 4096, 256) == 2
    assert online_splits(1, 1, 16384, 16384, 512) == 1
    assert online_splits(1, 1, 1000, 1000, 512) == 4
    assert online_splits(1, 1, 4224, 4096, 512) == 2 and online_splits(1, 1, 4288, 4096, 512) == 1
    assert online_splits(1, 1, 64, 64, 512) == 1 and online_splits(1, 1, 64, 65, 512) == 2
    assert online_splits(1, 1, 4096, 4096, 128) == 1 and online_splits(1, 1, 100, 100, 64) == 1


def test_flash_online_on_cpu_runs_the_twin(flash_cases):
    (q, k, v), _ = flash_cases[(1, 2, 300, 128)]
    args = [to_torch(a, "cpu") for a in (q, k, v)]
    reset_launch_counts()
    assert torch.equal(flash_attention_online(*args), flash_attention_online_plain(*args))
    assert launch_counts()["flash_online"] == 0


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _x(shape, seed, scale=1.0):
    return _bf(np.random.default_rng(seed).standard_normal(shape) * scale)


def _run(jmod, tmod, x):
    ref = np.asarray(jmod(jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        out = tmod(to_torch(x, "cpu"))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    return _rel(out, ref)


def test_group_norm_matches_jax(mixed):
    jv, _, tv = mixed
    x = _x((2, 64, 8, 12), 10, 3.0)
    jb, tb = jv.decoder.up_blocks[1][1], tv.decoder.up_blocks[1][1]
    ref = np.asarray(jvae.group_norm(jnp.asarray(x), jb.norm1_w, jb.norm1_b).astype(jnp.float32))
    out = tvae.group_norm(to_torch(x, "cpu"), tb.norm1_w, tb.norm1_b)
    assert out.dtype == torch.bfloat16 and _rel(out, ref) <= 2e-2


@pytest.mark.parametrize("which", ["conv_in", "conv_out", "shortcut_1x1"])
def test_conv2d_matches_jax(mixed, which):
    jv, _, tv = mixed
    pick = {"conv_in": lambda d: d.conv_in, "conv_out": lambda d: d.conv_out,
            "shortcut_1x1": lambda d: d.up_blocks[1][0].shortcut}[which]
    cin = pick(jv.decoder).weight.shape[1]
    assert _run(pick(jv.decoder), pick(tv.decoder), _x((1, cin, 10, 14), 11)) <= 2e-2


@pytest.mark.parametrize("which", ["same_width", "with_shortcut"])
def test_resnet_block_matches_jax(mixed, which):
    jv, _, tv = mixed
    i, j = (0, 1) if which == "same_width" else (1, 0)
    jb, tb = jv.decoder.up_blocks[i][j], tv.decoder.up_blocks[i][j]
    assert (tb.shortcut is not None) == (which == "with_shortcut")
    assert _run(jb, tb, _x((1, jb.conv1.weight.shape[1], 16, 16), 12)) <= 2e-2


def test_upsample_matches_jax(mixed):
    jv, _, tv = mixed
    x = _x((1, 128, 8, 8), 13)
    assert _run(jv.decoder.upsamplers[0], tv.decoder.upsamplers[0], x) <= 2e-2


@pytest.mark.parametrize("branch", ["einsum", "flash"])
def test_attn_block_matches_jax(tiny, mixed, branch):
    """c = 32 at 8x8 takes the f32 einsum; c = 128 at 32x32 the flash kernel."""
    jv, _, tv = tiny if branch == "einsum" else mixed
    c = jv.decoder.mid_attn.q.weight.shape[0]
    side = 8 if branch == "einsum" else 32
    assert _run(jv.decoder.mid_attn, tv.decoder.mid_attn, _x((1, c, side, side), 14)) <= 2e-2


# ---------------------------------------------------------------------------
# the decoder: whole and tiled
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoded(tiny):
    jv, _, tv = tiny
    z = _x((1, 16, 32, 32), 20)
    out = {}
    for tiled in (False, True):
        if tiled:
            jv.enable_tiling(tile_latent_size=16, overlap=0.25)
            tv.enable_tiling(tile_latent_size=16, overlap=0.25)
        try:
            ref = np.asarray(jv.decode(jnp.asarray(z)))
            img = tv.decode(to_torch(z, "cpu"))
        finally:
            jv.disable_tiling()
            tv.disable_tiling()
        out[tiled] = (img, ref)
    return out


@pytest.mark.parametrize("tiled", [False, True])
def test_decode_matches_jax(decoded, tiled):
    img, ref = decoded[tiled]
    assert img.dtype == torch.float32 and tuple(img.shape) == ref.shape == (1, 256, 256, 3)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    err = np.abs(img.numpy() - ref)
    assert err.max() <= 2e-2 and err.mean() <= 5e-3


def test_tiled_decode_blends_nine_tiles(decoded):
    """Tile 16 with stride 12 over 32 latents: offsets [0, 12, 16], the last
    flush against the edge; the tiled image differs from the whole one
    (each tile's attention and padding see less), as in the JAX package."""
    (whole, _), (tiled, _) = decoded[False], decoded[True]
    assert 0.0 < (tiled - whole).abs().mean().item() < 0.04


@pytest.mark.parametrize("flags", [(False, False, False, False), (True, True, True, True),
                                   (False, True, True, False), (True, False, False, True)])
def test_tile_blend_mask_exact(flags):
    top, bottom, left, right = flags
    ref = np.asarray(jvae._tile_blend_mask(128, 32, top=top, bottom=bottom, left=left, right=right))
    out = tvae._tile_blend_mask(128, 32, top=top, bottom=bottom, left=left, right=right)
    assert out.shape == (1, 128, 128, 1)
    np.testing.assert_array_equal(out.numpy(), ref)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def test_converter_carries_and_checks_the_weights(mixed):
    _, params, tv = mixed
    np.testing.assert_array_equal(tv.decoder.mid_attn.q.weight.float().numpy(),
                                  params["decoder.mid_attn.q.weight"].astype(np.float32))
    np.testing.assert_array_equal(tv.decoder.up_blocks[1][0].shortcut.bias.float().numpy(),
                                  params["decoder.up_blocks.1.0.shortcut.bias"].astype(np.float32))
    with pytest.raises(KeyError):
        vae_from_jax_params({**params, "decoder.extra.weight": np.zeros(1)}, **MIXED, device="cpu")
    with pytest.raises(ValueError):  # the structure says a 64-wide mid block
        vae_from_jax_params(params, block_out_channels=(32, 32, 64, 64), layers_per_block=1, device="cpu")


def test_random_init_mirrors_the_jax_decoder(tiny):
    """Decoder and encoder (both packages' ``random_init`` make both)."""
    _, params, _ = tiny
    tv = tvae.AutoencoderKL.random_init(seed=0, **TINY, device="cpu")
    ours = {n: (tuple(b.shape), str(b.dtype).replace("torch.", "")) for n, b in tv.named_buffers()}
    theirs = {n: (tuple(a.shape), str(a.dtype)) for n, a in params.items()}
    assert ours == theirs
    assert any(n.startswith("decoder.") for n in ours) and any(n.startswith("encoder.") for n in ours)
    assert tv.scaling_factor == 0.3611 and tv.shift_factor == 0.1159 and tv.tile_latent_size is None
