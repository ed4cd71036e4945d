"""The port's precision conversion of built models against the JAX package (CPU).

``requantize_model`` to int8 and w4a8 from int4 and nvfp4 FLUX.1 models (and
a rank-128 Qwen-Image model) loaded from small nunchaku-format files gives
codes, scales and rescales bit-identical to the JAX function's (its jitted
int8 rounding multiplies by f32(1/127), the loader divides: each port
function follows its own JAX counterpart). ``w4a8_cache_dequant``'s int8
codes are the step's dequant codes (and the JAX dial's); every dialed linear
gives the undialed one's output bit for bit on every layer, and a model
dialed in full stays within JAX's own bound for its dial (3e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_checkpoints as ckpt
from nunchaku_tpu.models import linear as jlin
from nunchaku_tpu.models import requantize as jreq
from nunchaku_tpu.models.transformers.loader import load_flux_transformer as jax_load_flux
from nunchaku_tpu.models.transformers.loader_qwenimage import load_qwenimage_transformer as jax_load_qwen
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.models import requantize as treq
from nunchaku_tpu_torch.models.linear import SVDQW4A4Linear, slice_module
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
    fc1 = tm.layer_views()["transformer_blocks"][0].ff.fc1
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
    a = load_flux_transformer(flux_files["int4"], "int8", device="cpu").layer_views()["transformer_blocks"][0].ff.fc1
    b = treq.requantize_model(load_flux_transformer(flux_files["int4"], device="cpu"), "int8")
    b = b.layer_views()["transformer_blocks"][0].ff.fc1
    assert (a.qweight.int() - b.qweight.int()).abs().max() <= 1


@pytest.mark.parametrize("source", ["int4", "nvfp4"])
def test_w4a8_cache_dequant_codes(flux_files, source):
    base = load_flux_transformer(flux_files[source], "w4a8", device="cpu")
    # the step's dequant codes of every w4a8 linear, a stacked one layer by layer
    step = {name: torch.stack([dequant_w4a8_plain(m.qweight[i], m.rescales[i], m.wcodes)
                               for i in range(m.qweight.shape[0])])
            for name, m in base.named_modules() if isinstance(m, SVDQW4A4Linear) and m.precision == "w4a8"}
    dialed = treq.w4a8_cache_dequant(base, 1.0)
    got = {name: m for name, m in dialed.named_modules() if name in step}
    assert all(m.precision == "int8" and torch.equal(m.qweight, step[name]) for name, m in got.items())
    assert base.transformer_blocks.ff.fc1.precision == "w4a8"  # a copy unless inplace
    # the JAX dial's codes, module for module
    ckpt.assert_same_as_jax(dialed, jreq.w4a8_cache_dequant(jax_load_flux(flux_files[source], precision="w4a8"), 1.0))
    # the same int8 codes through the same int8 route: every dialed linear gives the w4a8 linear's output,
    # layer by layer, bit for bit
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((64, 4 * 256))).to(torch.bfloat16)
    with torch.no_grad():
        for name, m in got.items():
            w = dict(base.named_modules())[name]
            for i in range(m.qweight.shape[0]):
                xi = x[:, :w.in_features]
                assert torch.equal(slice_module(m, i)(xi), slice_module(w, i)(xi)), (name, i)
    # the step: the dialed MLP pairs run the int8 chain on their stacks, whose consumer reads this width's one
    # scale group through the stacked rank-1 kernel mode (its f32 epilogue; JAX's dialed model likewise: a
    # stacked int8 product never takes XLA's dot), where the w4a8 chain's non-stacked consumer takes the
    # torch._int_mm route, which rounds its main term to bf16 first. JAX holds its dialed model to 3e-3
    # (tests/test_flux_model.py); the port's spread here is 2.4e-3 (int4) and 2.3e-3 (nvfp4)
    inputs = [to_torch(a, "cpu") for a in ckpt.flux_inputs()]
    with torch.no_grad():
        a, b = dialed(*inputs).float(), base(*inputs).float()
    assert (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item() < 3e-3


def test_w4a8_cache_dequant_budget_takes_the_largest_first(flux_files):
    base = load_flux_transformer(flux_files["nvfp4"], "w4a8", device="cpu")
    # the MLP stacks are the largest (L * K * N / 2 bytes; one layer each here)
    fc = base.transformer_blocks.ff.fc1.qweight.numel()
    budget = (4 * fc + 2 * fc) / 2**30 + 1e-9  # net growth of L * K * N / 2 bytes each: the six MLP stacks
    dialed = treq.w4a8_cache_dequant(base, budget, inplace=True)
    assert dialed is base
    mlps = [dialed.transformer_blocks.ff, dialed.transformer_blocks.ff_context]
    singles = dialed.single_transformer_blocks
    assert all(m.fc1.precision == m.fc2.precision == "int8" for m in mlps)
    assert singles.mlp_fc1.precision == singles.mlp_fc2.precision == "int8"
    assert dialed.transformer_blocks.attn.to_qkv.precision == "w4a8"


@pytest.mark.parametrize("out", ["int8", "w4a8"])
def test_requantize_odd_width_linear_keeps_logical_dims(out):
    """An odd-width int4 linear (K 640 padded to 768, N 200 to 256, as
    SDXL's and SANA's widths pad): ``requantize_svdq`` keeps ``logical_in``
    / ``logical_out`` as the JAX function does, its buffers equal JAX's bit
    for bit, and the forward on (1, 300, 640) returns the logical 200
    columns within one bf16 step of JAX's (2^-7 relative, near-zero sums
    1e-4 of max |ref|: the same codes, f32 sums in another order).
    ``w4a8_cache_dequant`` keeps the logical dims too, and its int8 copy
    gives the w4a8 linear's output bit for bit."""
    k, n = 640, 200
    jl = jlin.SVDQW4A4Linear.random_init(jax.random.PRNGKey(81), k, n, rank=32, precision="int4")
    t = lambda a: to_torch(np.asarray(a), "cpu")
    tl = SVDQW4A4Linear(t(jl.qweight), t(jl.wscales), t(jl.smooth), t(jl.proj_down), t(jl.proj_up), t(jl.bias),
                        precision="int4", logical_in=k, logical_out=n)
    jq, tq = jreq.requantize_svdq(jl, out), treq.requantize_svdq(tl, out)
    assert (tq.logical_in, tq.logical_out, tq.in_features, tq.out_features) == (
        jq.logical_in, jq.logical_out, jq.in_features, jq.out_features) == (k, n, 768, 256)
    for name in ("qweight", "wscales", "rescales"):
        a, b = getattr(tq, name), getattr(jq, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32), err_msg=name)
    x = np.asarray(jnp.asarray(np.random.default_rng(82).standard_normal((1, 300, k)), jnp.bfloat16))
    ref = np.asarray(jq(jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = tq(t(x))
    assert got.shape == (1, 300, n) and ref.shape == (1, 300, n)
    got = got.float().numpy()
    assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-4 * np.abs(ref).max())
    if out == "w4a8":
        dialed = treq.w4a8_cache_dequant(torch.nn.Sequential(tq), 1.0)[0]
        assert dialed.precision == "int8" and (dialed.logical_in, dialed.logical_out) == (k, n)
        with torch.no_grad():
            assert torch.equal(dialed(t(x)), tq(t(x)))
