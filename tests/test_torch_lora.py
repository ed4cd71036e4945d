"""LoRA on the port's quantized FLUX model against the JAX package (CPU):
the converter (diffusers, peft and kohya flavors, a q / v subset of a fused
projection, ``compose_lora``), ``update_lora_params`` and
``set_lora_strength`` on a 2 + 2-block model at int4 and w4a8, the AWQ side
branch, and the converter CLI. LoRA files come from
``tools.synth_checkpoint.lora_state`` (seeded), models from the JAX
``random_init`` through ``flux_from_jax_params``.

Buffers are held to JAX's bit for bit (``torch_checkpoints.assert_same_as_jax``).
JAX's ``update_lora_params`` cannot restack a LoRA that touches only some
layers of a stack (the layers' static ``rank`` then differs), so its
reference for such a LoRA is the same LoRA with zeros on the other layers:
its padding is those zeros. Forwards: within 2e-2 of the reference's max
|value|, the FLUX model tests' bound (tests/test_torch_flux.py); the int4
models' AdaLN modulation damped as tests/test_torch_int4_flux.py damps it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_checkpoints as ckpt
from nunchaku_tpu.lora.flux import __main__ as jax_cli
from nunchaku_tpu.lora.flux import apply as japply
from nunchaku_tpu.lora.flux import convert as jconvert
from nunchaku_tpu.models.linear import AWQW4A16Linear as JaxAWQ
from nunchaku_tpu.models.transformers.transformer_flux import FluxConfig as JaxFluxConfig
from nunchaku_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from nunchaku_tpu.utils.safetensors import load_safetensors as jax_load
from nunchaku_tpu_torch import compose_lora, set_lora_strength, update_lora_params
from nunchaku_tpu_torch.convert import flux_from_jax_params, to_torch
from nunchaku_tpu_torch.lora.flux import __main__ as cli
from nunchaku_tpu_torch.lora.flux.convert import is_nunchaku_format, to_canonical
from nunchaku_tpu_torch.models.linear import AWQW4A16Linear, stack_modules
from nunchaku_tpu_torch.models.transformer_flux import FluxConfig
from nunchaku_tpu_torch.ops.checks import MOD_DAMP
from nunchaku_tpu_torch.tools.synth_checkpoint import lora_state, write
from nunchaku_tpu_torch.utils.safetensors import load_safetensors

from test_torch_flux import _inputs, _rel

SMALL = dict(num_layers=2, num_single_layers=2, num_attention_heads=2, joint_attention_dim=512,
             pooled_projection_dim=256)
CFG = FluxConfig(**SMALL)
FLAVORS = ["diffusers", "peft", "kohya"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_lora(flavor, rank, seed, **kw):
    """A synthesized LoRA as numpy f32 (the JAX converter's input)."""
    return {k: v.float().numpy() for k, v in lora_state(CFG, rank, flavor, seed=seed, device="cpu", **kw)[0].items()}


def _partial(sd, keep):
    """(the LoRA on the blocks whose keys hold one of ``keep``, the full LoRA
    with zeros elsewhere: JAX's reference for it)."""
    kept = {k: v for k, v in sd.items() if any(m in k for m in keep)}
    zeroed = {k: v if k in kept or k.endswith(".alpha") else np.zeros_like(v) for k, v in sd.items()}
    return kept, zeroed


def _same_canonical(out, ref):
    assert sorted(out) == sorted(ref)
    for k in ref:
        for o, r in zip(out[k], ref[k]):
            assert o.dtype == np.float32 and o.shape == r.shape
            np.testing.assert_array_equal(o, r, err_msg=k)


# ---------------------------------------------------------------------------
# convert / compose
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flavor", FLAVORS)
def test_to_canonical_matches_jax(flavor):
    """Every canonical (A, B) equals JAX's; kohya with alpha 3 of rank 4
    (A scaled by 0.75), at strength 0.6. The port takes torch tensors (bf16
    as the file stores them) as well as numpy arrays."""
    sd_t = lora_state(CFG, 4, flavor, alpha=3.0, seed=5, device="cpu")[0]
    sd = {k: v.float().numpy() for k, v in sd_t.items()}
    ref = jconvert.to_canonical(sd, 0.6)
    _same_canonical(to_canonical(sd, 0.6), ref)
    _same_canonical(to_canonical(sd_t, 0.6), ref)
    assert "transformer_blocks.1.attn.to_qkv" in ref and "single_transformer_blocks.1.proj_out" in ref
    assert is_nunchaku_format(sd) == jconvert.is_nunchaku_format(sd) is (flavor == "kohya")


def test_qkv_subset_matches_jax():
    """A LoRA on q and v only (legal in the diffusers flavor): the fused B
    is full width with k's rows zero, as JAX assembles it."""
    sd = {k: v for k, v in _np_lora("diffusers", 4, 6).items()
          if ".attn.to_q." in k or ".attn.to_v." in k}
    ref = jconvert.to_canonical(sd)
    _same_canonical(to_canonical(sd), ref)
    a, b = ref["transformer_blocks.0.attn.to_qkv"]
    dim = CFG.dim
    assert a.shape == (8, dim) and b.shape == (3 * dim, 8) and not b[dim:2 * dim].any()


def test_compose_matches_jax():
    """Two LoRAs of different flavors and strengths, ranks concatenated."""
    pair = [(_np_lora("diffusers", 4, 7), 1.0), (_np_lora("kohya", 8, 8, alpha=4.0), 0.5)]
    ref = jconvert.compose_lora(pair)
    _same_canonical(compose_lora(pair), ref)
    assert ref["transformer_blocks.0.attn.to_qkv"][0].shape[0] == 12 + 8


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _jax_model(precision, seed=3):
    jm = JaxFlux.random_init(jax.random.PRNGKey(seed), JaxFluxConfig(precision=precision, **SMALL))
    if precision == "int4":
        for blocks, names in ((jm.transformer_blocks, ("norm1", "norm1_context")),
                              (jm.single_transformer_blocks, ("norm",))):
            for name in names:
                lin = getattr(blocks, name).linear
                lin.wscales = (lin.wscales.astype(jnp.float32) * MOD_DAMP).astype(jnp.bfloat16)
                lin.wzeros = (lin.wzeros.astype(jnp.float32) * MOD_DAMP).astype(jnp.bfloat16)
    return jm


def _port(jm, precision):
    return flux_from_jax_params({k: np.asarray(v) for k, v in jm.named_parameters()},
                                FluxConfig(precision=precision, **SMALL), device="cpu")


@pytest.fixture(scope="module", params=["int4", "w4a8"])
def lora_pair(request):
    """The base models, a first LoRA (diffusers, rank 4, dual block 1 and
    single block 0 only, strength 0.7) and a second on top (kohya, rank 8,
    alpha 4, every block, strength 1.3), JAX's and the port's each; and the
    JAX LoRA'd model carried into the port."""
    precision = request.param
    jm = _jax_model(precision)
    tm = _port(jm, precision)
    sd1, z1 = _partial(_np_lora("diffusers", 4, 1), ["transformer.transformer_blocks.1.",
                                                        "transformer.single_transformer_blocks.0."])
    sd2 = _np_lora("kohya", 8, 2, alpha=4.0)
    j1 = japply.update_lora_params(jm, z1, strength=0.7)
    j2 = japply.update_lora_params(j1, sd2, strength=1.3)
    t1 = update_lora_params(tm, sd1, strength=0.7)
    t2 = update_lora_params(t1, sd2, strength=1.3)
    return dict(precision=precision, jm=jm, tm=tm, j1=j1, j2=j2, t1=t1, t2=t2, sd1=sd1, sd2=sd2)


def test_buffers_match_jax(lora_pair):
    """Every buffer of the port's LoRA'd model equals JAX's bit for bit after
    the partial first LoRA (padded across each stack) and after the second
    (the low-rank stacks: 32 base ranks, then 16 of the first, then 16
    more; the AWQ side branch at int4); the JAX model carried by
    ``flux_from_jax_params`` equals it too, ``lora_base_rank`` included."""
    p = lora_pair
    ckpt.assert_same_as_jax(p["t1"], p["j1"])
    ckpt.assert_same_as_jax(p["t2"], p["j2"])
    carried = _port(p["j2"], p["precision"])
    ckpt.assert_same_as_jax(carried, p["j2"])
    qkv = p["t2"].transformer_blocks.attn.to_qkv
    assert tuple(qkv.proj_down.shape[::2]) == (2, 32 + 16 + 16) and qkv.lora_base_rank == 32
    for name, mod in p["t2"].named_modules():
        if getattr(mod, "lora_up_unit", None) is not None and hasattr(mod, "lora_base_rank"):
            assert carried.get_submodule(name).lora_base_rank == mod.lora_base_rank, name
    if p["precision"] == "int4":
        assert p["t2"].transformer_blocks.norm1.linear.lora_down.shape == (2, CFG.dim, 8)
    # the LoRA fields reach each layer's view (slice_module) and survive a restack (stack_modules)
    views = p["t2"].layer_views()["single_transformer_blocks"]
    restacked = stack_modules(views)
    for i, view in enumerate(views):
        lin = view.attn_out
        assert lin.lora_base_rank == 32 and lin.lora_up_unit.shape[0] == lin.proj_up.shape[0] - 32
        assert torch.equal(lin.lora_up_unit, p["t2"].single_transformer_blocks.attn_out.lora_up_unit[i])
    assert restacked.attn_out.lora_base_rank == 32
    assert torch.equal(restacked.attn_out.lora_up_unit, p["t2"].single_transformer_blocks.attn_out.lora_up_unit)


def test_set_strength_matches_jax_and_is_absolute(lora_pair):
    """``set_lora_strength`` equals JAX's (strength 0.3, rounded in bf16 as
    JAX rounds it) and is absolute: 0.5 then 1.3 equals 1.3 once; applying
    at 0.7 equals applying at 1.0 and then setting 0.7."""
    p = lora_pair
    ckpt.assert_same_as_jax(set_lora_strength(p["t2"], 0.3), japply.set_lora_strength(p["j2"], 0.3))
    once = dict(set_lora_strength(p["t2"], 1.3).named_buffers())
    twice = dict(set_lora_strength(set_lora_strength(p["t2"], 0.5), 1.3).named_buffers())
    assert once.keys() == twice.keys()
    for k in once:
        assert torch.equal(once[k], twice[k]), k
    direct = dict(update_lora_params(p["tm"], p["sd2"], strength=0.7).named_buffers())
    via = dict(set_lora_strength(update_lora_params(p["tm"], p["sd2"]), 0.7).named_buffers())
    for k in direct:
        assert torch.equal(direct[k], via[k]), k


def test_base_untouched_and_weights_shared(lora_pair):
    """The input model keeps every buffer; the LoRA'd model shares each
    4-bit weight stack with it (the same storage), and new low-rank stacks
    replace the base's only where a LoRA touched a leaf."""
    p = lora_pair
    fresh = dict(_port(p["jm"], p["precision"]).named_buffers())
    for k, t in p["tm"].named_buffers():
        assert torch.equal(t, fresh[k]), k
    base, lora = dict(p["tm"].named_buffers()), dict(p["t2"].named_buffers())
    for k in base:
        if k.endswith((".qweight", ".wscales", ".smooth", ".bias")):
            assert lora[k].data_ptr() == base[k].data_ptr(), k
        if k.endswith(".proj_down"):
            assert lora[k].data_ptr() != base[k].data_ptr(), k
    views = p["t2"].layer_views()["transformer_blocks"]
    assert views[1].attn.to_qkv.proj_up.data_ptr() != p["tm"].layer_views()["transformer_blocks"][1].attn.to_qkv.proj_up.data_ptr()


def _jax_forward(jm):
    return np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, _inputs())), np.float32)


def _forward(tm):
    with torch.no_grad():
        return tm(*[to_torch(a, "cpu") for a in _inputs()])


def test_forward_matches_jax(lora_pair, monkeypatch):
    """The twice LoRA'd model's forward within 2e-2 of JAX's LoRA'd model's,
    and away from the base model's (the LoRA moves the output). At int4 the
    bound is twice the JAX package's own two int4 routes' spread on the same
    model where that is larger (the repo's rule for 4-bit models, as SDXL's,
    SANA's and Z-Image's tests: at 2 + 2 blocks the routes, sums in another
    order only, end ~1.9e-2 apart)."""
    p = lora_pair
    out, ref = _forward(p["t2"]), _jax_forward(p["j2"])
    bound = 2e-2
    if p["precision"] == "int4":
        monkeypatch.setenv("NUNCHAKU_TPU_INT4_XLA", "1")
        monkeypatch.setenv("NUNCHAKU_TPU_XLA_LORA_BF16", "0")
        bound = max(bound, 2 * _rel(_jax_forward(p["j2"]), ref))
    assert _rel(out, ref) <= bound
    assert _rel(out, _forward(p["tm"]).float().numpy()) > 1e-3


def test_strength_zero_near_base(lora_pair):
    """At strength 0 the LoRA rows are zero: the forward is the base's up to
    the order of the low-rank sums (within 2e-2), not bit for bit."""
    p = lora_pair
    base = _forward(p["tm"]).float().numpy()
    assert _rel(_forward(set_lora_strength(p["t2"], 0.0)), base) <= 2e-2


def test_turbo_after_lora_matches_jax_and_keeps_base():
    """w4a8 in the turbo configuration (bf16 stream, the fused qkv prologue
    enabled after the LoRA, as JAX's order is): the forward within 2e-2 of
    JAX's; the half-split permutation of the LoRA'd model leaves the base's
    buffers as they were; a LoRA on a model already in half-split order
    raises."""
    jm = _jax_model("w4a8", seed=4)
    tm = _port(jm, "w4a8")
    sd = _np_lora("diffusers", 16, 9)
    jl = japply.update_lora_params(jm, sd, strength=0.8)
    tl = update_lora_params(tm, sd, strength=0.8)
    before = {k: t.clone() for k, t in tm.named_buffers()}
    jl.set_stream_dtype(jnp.bfloat16).enable_fused_qkv_prep()
    tl.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    assert tl.transformer_blocks.attn.to_qkv.proj_up.shape[-2] == 32 + 48
    assert _rel(_forward(tl), _jax_forward(jl)) <= 2e-2
    for k, t in tm.named_buffers():
        assert torch.equal(t, before[k]), k
    with pytest.raises(ValueError, match="before enable_fused_qkv_prep"):
        update_lora_params(tl, sd)


@pytest.mark.parametrize("m", [1, 32], ids=["gemv", "dequant"])
def test_awq_side_branch_matches_jax(m):
    """The AWQ linear with a LoRA side branch on both routes (M < 16 the
    GEMV's twin, else dequantize-then-multiply), within 1e-2 of JAX's."""
    jl = JaxAWQ.random_init(jax.random.PRNGKey(2), 256, 512)
    rng = np.random.default_rng(4)
    jl.lora_down = jnp.asarray(rng.standard_normal((256, 16)) * 0.05, jnp.bfloat16)
    jl.lora_up = jnp.asarray(rng.standard_normal((16, 512)) * 0.05, jnp.bfloat16)
    jl.refresh_pytree()
    x = jnp.asarray(rng.standard_normal((m, 256)), jnp.bfloat16)
    ref = np.asarray(jl(x), np.float32)
    tl = AWQW4A16Linear(*(to_torch(np.asarray(getattr(jl, n)), "cpu") for n in ("qweight", "wscales", "wzeros", "bias")),
                        lora_down=to_torch(np.asarray(jl.lora_down), "cpu"), lora_up=to_torch(np.asarray(jl.lora_up), "cpu"))
    out = tl(to_torch(np.asarray(x), "cpu"))
    assert out.dtype == torch.bfloat16 and _rel(out, ref) <= 1e-2
    base = AWQW4A16Linear(tl.qweight, tl.wscales, tl.wzeros, tl.bias)(to_torch(np.asarray(x), "cpu"))
    assert _rel(out, base.float().numpy()) > 1e-3


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_round_trip(tmp_path, monkeypatch, capsys):
    """``python -m nunchaku_tpu_torch.lora.flux`` on a kohya file writes the
    JAX CLI's keys, bf16 values and metadata; the converted file reads back
    to the input's canonical form rounded to bf16, every path but the single
    blocks' ``qkv_mlp_fused``, which the diffusers key table of both
    packages does not read."""
    src = tmp_path / "kohya.safetensors"
    write(src, lora_state(CFG, 4, "kohya", alpha=2.0, seed=11, device="cpu"))
    cli.main(["-i", str(src), "-o", str(tmp_path / "port.safetensors"), "--strength", "0.9"])
    monkeypatch.setattr("sys.argv", ["x", "-i", str(src), "-o", str(tmp_path / "jax.safetensors"), "--strength", "0.9"])
    jax_cli.main()
    assert "converted" in capsys.readouterr().out
    out, meta = load_safetensors(tmp_path / "port.safetensors")
    ref, jmeta = jax_load(str(tmp_path / "jax.safetensors"))
    assert meta == jmeta and sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(out[k].view(torch.uint16).numpy(), np.asarray(ref[k]).view(np.uint16), err_msg=k)
    back = to_canonical(out)
    want = to_canonical(load_safetensors(src)[0], 0.9)
    assert sorted(back) == sorted(k for k in want if not k.endswith("qkv_mlp_fused"))
    for k in back:
        for b, w in zip(back[k], want[k]):
            np.testing.assert_array_equal(b, torch.from_numpy(w).to(torch.bfloat16).float().numpy(), err_msg=k)
