"""The port's checkpoint loaders against the JAX package's (CPU).

Small nunchaku-format checkpoints (``tests/torch_checkpoints.py``: numpy
values packed with the JAX package's packers) load through both packages:
FLUX.1 from an int4 and from an nvfp4 file at its own precision, int8 and
w4a8 (from nvfp4: nvfp4-a8, e2m1 codes); Qwen-Image at ranks 32 and 128,
int4 and w4a8; T5 (TinyChat W4 and bf16), CLIP and the VAE decoder.

Every integer code, packed code, scale and rescale of the port's model
equals the JAX model's exactly, and so do the static attributes (precision,
``act_unsigned``, ``wcodes``, the norms' ``scale_shift``). Forward outputs:
max error <= 2e-2 of the reference's max |value|, the tolerance of the
port's other 4-bit model tests (tests/test_torch_int4_flux.py), with the
AdaLN modulation drawn small as those tests damp it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_checkpoints as ckpt
from nunchaku_tpu.models.autoencoder import load_autoencoder as jax_load_vae
from nunchaku_tpu.models.text_encoders.clip import load_clip_text as jax_load_clip
from nunchaku_tpu.models.text_encoders.t5 import load_t5_encoder as jax_load_t5
from nunchaku_tpu.models.transformers.loader import load_flux_transformer as jax_load_flux
from nunchaku_tpu.models.transformers.loader_qwenimage import load_qwenimage_transformer as jax_load_qwen
from nunchaku_tpu_torch import load_autoencoder, load_clip_text, load_flux_transformer, load_qwenimage_transformer
from nunchaku_tpu_torch import load_t5_encoder
from nunchaku_tpu_torch.convert import clip_from_jax_params, t5_from_jax_params, to_torch, vae_from_jax_params

@pytest.fixture(autouse=True)
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


def _forward_pair(jm, tm, inputs):
    ref = np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, inputs)), np.float32)
    with torch.no_grad():
        out = tm(*[to_torch(a, "cpu") for a in inputs])
    assert out.shape == ref.shape and bool(torch.isfinite(out.float()).all())
    return _rel(out, ref)


@pytest.fixture(scope="module")
def flux_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("flux")
    return {p: ckpt.flux_checkpoint(d / f"flux-{p}.safetensors", p) for p in ("int4", "nvfp4")}


@pytest.mark.parametrize("precision", [None, "int8", "w4a8"])
@pytest.mark.parametrize("source", ["int4", "nvfp4"])
def test_flux_loader_matches_jax(flux_files, source, precision):
    path = flux_files[source]
    jm = jax_load_flux(path, precision=precision)
    tm = load_flux_transformer(path, precision, device="cpu")
    ckpt.assert_same_as_jax(tm, jm)
    views = tm.layer_views()
    fc1 = views["transformer_blocks"][0].ff.fc1
    want = {None: (source, "int4"), "int8": ("int8", "int4"),
            "w4a8": ("w4a8", "e2m1" if source == "nvfp4" else "int4")}[precision]
    assert (fc1.precision, fc1.wcodes) == want
    assert views["single_transformer_blocks"][0].mlp_fc2.act_unsigned == (source == "int4")
    assert views["transformer_blocks"][0].norm1.scale_shift == 0.0
    assert _forward_pair(jm, tm, ckpt.flux_inputs()) <= 2e-2


def test_flux_loader_refusals(flux_files):
    with pytest.raises(ValueError):
        load_flux_transformer(flux_files["nvfp4"], "int4", device="cpu")
    with pytest.raises(ValueError):
        load_flux_transformer(flux_files["int4"], "fp8", device="cpu")


@pytest.fixture(scope="module")
def qwen_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen")
    return {r: ckpt.qwen_checkpoint(d / f"qwen-r{r}.safetensors", rank=r) for r in (32, 128)}


def _qwen_inputs():
    rng = np.random.default_rng(71)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    s_img = 64
    ids = np.zeros((s_img, 3), np.int32)
    ids[:, 1] = np.arange(s_img) // 8
    ids[:, 2] = np.arange(s_img) % 8
    return (bf(rng.standard_normal((1, s_img, 64))), bf(rng.standard_normal((1, 24, ckpt.QWEN["joint"]))),
            np.array([0.6], np.float32), ids)


@pytest.mark.parametrize("precision", [None, "w4a8"])
@pytest.mark.parametrize("rank", [32, 128])
def test_qwen_loader_matches_jax(qwen_files, rank, precision):
    path = qwen_files[rank]
    jm = jax_load_qwen(path, precision=precision)
    tm = load_qwenimage_transformer(path, precision, device="cpu")
    blocks = tm.layer_views()["blocks"]
    assert tm.cfg.rank == rank == blocks[0].ff.fc1.proj_down.shape[1]
    assert blocks[0].norm1.scale_shift == 1.0 and blocks[1].ff.fc2.act_unsigned
    ckpt.assert_same_as_jax(tm, jm)
    assert _forward_pair(jm, tm, _qwen_inputs()) <= 2e-2


def test_qwen_w4a8_from_nvfp4_loads_int8(tmp_path):
    """An nvfp4 Qwen-Image file asked for at w4a8 loads int8, as in JAX."""
    path = ckpt.qwen_checkpoint(tmp_path / "qwen-fp4.safetensors", precision="nvfp4", rank=32)
    tm = load_qwenimage_transformer(path, "w4a8", device="cpu")
    assert tm.cfg.precision == "int8" and tm.layer_views()["blocks"][0].attn.to_qkv.precision == "int8"
    ckpt.assert_same_as_jax(tm, jax_load_qwen(path, precision="w4a8"))


@pytest.mark.parametrize("quantized", [True, False])
def test_t5_loader_matches_jax(tmp_path, quantized):
    state, config = ckpt.t5_state(quantized)
    jm = jax_load_t5(state, config)
    tm = load_t5_encoder({k: to_torch(v, "cpu") for k, v in state.items()}, config, device="cpu")
    ref_model = t5_from_jax_params({k: np.asarray(v) for k, v in jm.named_parameters()},
                                   heads=config["num_heads"], d_kv=config["d_kv"], device="cpu")
    ba, bb = dict(tm.named_buffers()), dict(ref_model.named_buffers())
    assert ba.keys() == bb.keys()
    for name, t in ba.items():
        assert t.dtype == bb[name].dtype and torch.equal(t.contiguous().view(torch.uint8),
                                                         bb[name].contiguous().view(torch.uint8)), name
    if quantized:
        assert tm.blocks[0].ff.wo.wscales.shape[0] == ckpt.T5["d_ff"] // 128  # the group comes from the scales
    ids = np.random.default_rng(72).integers(0, ckpt.T5["vocab"], (1, 32)).astype(np.int32)
    ref = np.asarray(jm(jnp.asarray(ids)), np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long())
    assert _rel(out, ref) <= 2e-2


def test_clip_loader_matches_jax():
    state = ckpt.clip_state()
    c = ckpt.CLIP
    jm = jax_load_clip(state, heads=c["heads"], layers=c["layers"])
    tm = load_clip_text({k: to_torch(v, "cpu") for k, v in state.items()}, heads=c["heads"], layers=c["layers"],
                        device="cpu")
    ref_model = clip_from_jax_params({k: np.asarray(v) for k, v in jm.named_parameters()}, heads=c["heads"],
                                     device="cpu")
    for (name, t), (_, u) in zip(tm.named_buffers(), ref_model.named_buffers(), strict=True):
        assert torch.equal(t.contiguous().view(torch.uint8), u.contiguous().view(torch.uint8)), name
    ids = np.zeros((1, 77), np.int32)
    ids[0, :6] = [5, 17, 42, 9, 2, 0]
    ref_pooled, ref_hidden = jm(jnp.asarray(ids))
    with torch.no_grad():
        pooled, hidden = tm(torch.from_numpy(ids).long())
    assert _rel(pooled, ref_pooled) <= 2e-2 and _rel(hidden, ref_hidden) <= 2e-2


def test_vae_loader_matches_jax(tmp_path):
    state = ckpt.vae_state()
    kw = dict(block_out_channels=ckpt.VAE["block_out_channels"], layers_per_block=ckpt.VAE["layers_per_block"])
    jm = jax_load_vae(state, **kw)
    tstate = {k: to_torch(v, "cpu") for k, v in state.items()}
    tm = load_autoencoder(tstate, **kw, device="cpu")
    ref_model = vae_from_jax_params({k: np.asarray(v) for k, v in jm.named_parameters()}, **kw, device="cpu")
    for (name, t), (_, u) in zip(tm.named_buffers(), ref_model.named_buffers(), strict=True):
        assert torch.equal(t.contiguous().view(torch.uint8), u.contiguous().view(torch.uint8)), name
    z = np.asarray(jnp.asarray(np.random.default_rng(73).standard_normal((1, 16, 8, 8)), jnp.bfloat16))
    ref = np.asarray(jm.decode(jnp.asarray(z)), np.float32)
    with torch.no_grad():
        out = tm.decode(to_torch(z, "cpu"))
    assert out.shape == ref.shape and np.abs(out.numpy() - ref).max() <= 2e-2
    # a decoder-only file loads without an encoder, and encode raises; a partial encoder is a missing key;
    # a state dict without a decoder is refused
    assert tm.encoder is None
    with pytest.raises(ValueError):
        tm.encode(torch.zeros((1, 64, 64, 3)))
    tstate["encoder.conv_in.weight"] = torch.zeros((32, 3, 3, 3), dtype=torch.bfloat16)
    with pytest.raises(KeyError):
        load_autoencoder(tstate, **kw, device="cpu")
    with pytest.raises(KeyError):
        load_autoencoder({k: v for k, v in tstate.items() if not k.startswith("decoder.")}, **kw, device="cpu")
