"""The port's precision conversion of built models against the JAX package (CPU).

``requantize_model`` to int8 and w4a8 from int4 and nvfp4 FLUX.1 models (and
a rank-128 Qwen-Image model) loaded from small nunchaku-format files gives
codes, scales and rescales bit-identical to the JAX function's (its jitted
int8 rounding multiplies by f32(1/127), the loader divides: each port
function follows its own JAX counterpart). ``w4a8_cache_dequant``'s int8
codes are the step's dequant codes (and the JAX dial's); a model dialed in
full runs the same int8 codes through the same int8 route, so its forward
output equals the undialed one's bit for bit.
"""

import pytest
import torch

import torch_checkpoints as ckpt
from nunchaku_tpu.models import requantize as jreq
from nunchaku_tpu.models.transformers.loader import load_flux_transformer as jax_load_flux
from nunchaku_tpu.models.transformers.loader_qwenimage import load_qwenimage_transformer as jax_load_qwen
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.models import requantize as treq
from nunchaku_tpu_torch.models.linear import SVDQW4A4Linear
from nunchaku_tpu_torch.models.loader import load_flux_transformer
from nunchaku_tpu_torch.models.loader_qwenimage import load_qwenimage_transformer
from nunchaku_tpu_torch.ops.gemm import dequant_w4a8_plain


@pytest.fixture(scope="module")
def flux_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("flux")
    return {p: ckpt.flux_checkpoint(d / f"flux-{p}.safetensors", p, seed=1) for p in ("int4", "nvfp4")}


@pytest.mark.parametrize("out", ["int8", "w4a8"])
@pytest.mark.parametrize("source", ["int4", "nvfp4"])
def test_requantize_model_matches_jax(flux_files, source, out):
    jm = jreq.requantize_model(jax_load_flux(flux_files[source]), out)
    tm = treq.requantize_model(load_flux_transformer(flux_files[source], device="cpu"), out)
    ckpt.assert_same_as_jax(tm, jm)
    fc1 = tm.transformer_blocks[0].ff.fc1
    assert fc1.precision == out and fc1.wcodes == ("e2m1" if (source, out) == ("nvfp4", "w4a8") else "int4")
    assert tm.cfg.precision == out


def test_requantize_qwen_rank128_matches_jax(tmp_path):
    path = ckpt.qwen_checkpoint(tmp_path / "qwen.safetensors", rank=128, seed=2)
    for out in ("int8", "w4a8"):
        jm = jreq.requantize_model(jax_load_qwen(path), out)
        tm = treq.requantize_model(load_qwenimage_transformer(path, device="cpu"), out)
        ckpt.assert_same_as_jax(tm, jm)


def test_requantize_follows_each_jax_form(flux_files):
    """The loader's int8 (a true division by 127) and requantize_model's
    (XLA's multiply by f32(1/127)) may differ by one code; each port function
    matches its own JAX counterpart (the tests above and test_torch_loader),
    so this only records that both conversions run and agree to one code."""
    a = load_flux_transformer(flux_files["int4"], "int8", device="cpu").transformer_blocks[0].ff.fc1
    b = treq.requantize_model(load_flux_transformer(flux_files["int4"], device="cpu"), "int8")
    b = b.transformer_blocks[0].ff.fc1
    assert (a.qweight.int() - b.qweight.int()).abs().max() <= 1


@pytest.mark.parametrize("source", ["int4", "nvfp4"])
def test_w4a8_cache_dequant_codes(flux_files, source):
    base = load_flux_transformer(flux_files[source], "w4a8", device="cpu")
    step = {name: dequant_w4a8_plain(m.qweight, m.rescales, m.wcodes) for name, m in base.named_modules()
            if isinstance(m, SVDQW4A4Linear) and m.precision == "w4a8"}
    dialed = treq.w4a8_cache_dequant(base, 1.0)
    got = {name: m for name, m in dialed.named_modules() if name in step}
    assert all(m.precision == "int8" and torch.equal(m.qweight, step[name]) for name, m in got.items())
    assert base.transformer_blocks[0].ff.fc1.precision == "w4a8"  # a copy unless inplace
    # the JAX dial's codes, module for module
    ckpt.assert_same_as_jax(dialed, jreq.w4a8_cache_dequant(jax_load_flux(flux_files[source], precision="w4a8"), 1.0))
    # the same int8 codes through the same int8 route: the step output is unchanged, bit for bit
    inputs = [to_torch(a, "cpu") for a in ckpt.flux_inputs()]
    with torch.no_grad():
        assert torch.equal(dialed(*inputs), base(*inputs))


def test_w4a8_cache_dequant_budget_takes_the_largest_first(flux_files):
    base = load_flux_transformer(flux_files["nvfp4"], "w4a8", device="cpu")
    fc = base.transformer_blocks[0].ff.fc1.qweight.numel()  # the MLP linears are the largest (K * N / 2 bytes)
    budget = (4 * fc + 2 * fc) / 2**30 + 1e-9  # net growth of K * N / 2 bytes each: the six MLP linears
    dialed = treq.w4a8_cache_dequant(base, budget, inplace=True)
    assert dialed is base
    mlps = [dialed.transformer_blocks[0].ff, dialed.transformer_blocks[0].ff_context]
    singles = dialed.single_transformer_blocks[0]
    assert all(m.fc1.precision == m.fc2.precision == "int8" for m in mlps)
    assert singles.mlp_fc1.precision == singles.mlp_fc2.precision == "int8"
    assert dialed.transformer_blocks[0].attn.to_qkv.precision == "w4a8"
