"""The port's SDXL slice against the JAX package on the CPU: the online
flash at head dim 64 (self-attention at a ragged S, cross-attention against
77 text keys), the GEGLU-fused activation quantize, the odd-width SVDQ
linear, ``ResnetBlock2D`` and a one-block ``SpatialTransformer``, the TINY
UNet of ``tests/test_sdxl.py`` at int4 and int8, the pipeline with and
without CFG, ``sdxl_sigmas``, the converter and the parameter tree.

Weights: the JAX model's structure from ``jax.eval_shape`` of its
``random_init``, filled from a seeded numpy generator with the same
distributions (the eager JAX ``random_init`` of the TINY UNet takes ~30 s
on a CPU), then carried into the port by ``sdxl_from_jax_params``. Inputs come
from seeded numpy generators; JAX runs its Pallas kernels in interpret mode.
Each JAX output is computed once per module (fixtures). Each test states its
tolerance.

Why the whole-model tolerances are what they are: a 4-bit activation code
is a seventh of its group's range, so an input one bf16 step apart (an f32
sum in another order in a GroupNorm or a convolution, the flash twin's
128-column rescales against JAX's one block) flips codes, and each flip
moves a layer's output by a code step. The JAX package's own two int4 GEMM
routes (``NUNCHAKU_TPU_INT4_XLA=1``, which changes only the summation
order) end 5.2e-2 apart (max error over max |value|) on the TINY UNet, the
port 5.2e-2 from either; at int8 the JAX routes
(``NUNCHAKU_TPU_XLA_LORA_BF16=0``) end 1.5e-2 apart, the port 1.7e-2
(measured on the CPU by running the JAX forward with and without those
switches set). The model and pipeline
bounds are twice the JAX routes' spread: 1e-1 (int4), 3e-2 (int8). Guidance
multiplies a forward's differences (``eps_n + 5 (eps - eps_n)``): on the
2-step CFG 5.0 pipeline JAX's int8 routes end 3.4e-2 apart (int4: 1.2e-1),
so that case's bound is 7e-2 at int8. The modules and ops, fed identical
inputs, are held far tighter.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models import linear as jlin
from nunchaku_tpu.models.unets.unet_sdxl import SDXLConfig as JaxSDXLConfig
from nunchaku_tpu.models.unets.unet_sdxl import SDXLUNet2DConditionModel as JaxUNet
from nunchaku_tpu.ops import quantize as jquant
from nunchaku_tpu.ops.attention import flash_attention as jax_flash
from nunchaku_tpu.pipeline.pipeline_sdxl import SDXLPipeline as JaxPipeline
from nunchaku_tpu.pipeline.pipeline_sdxl import sdxl_sigmas as jax_sigmas
from nunchaku_tpu_torch import SDXLConfig, SDXLPipeline, SDXLUNet2DConditionModel
from nunchaku_tpu_torch.convert import sdxl_from_jax_params, to_torch
from nunchaku_tpu_torch.core.packing import unpack_int4
from nunchaku_tpu_torch.models import linear as tlin
from nunchaku_tpu_torch.ops import quantize as tquant
from nunchaku_tpu_torch.ops import reference as tref
from nunchaku_tpu_torch.ops.attention import flash_attention_online
from nunchaku_tpu_torch.pipeline.pipeline_sdxl import sdxl_sigmas

# tests/test_sdxl.py's TINY: quantized widths 256 / 512, head dim 64
TINY = dict(block_out_channels=(128, 256, 512), layers_per_block=1, transformer_layers=(0, 1, 2),
            cross_attention_dim=256, projection_class_embeddings_input_dim=256 + 6 * 32, addition_time_embed_dim=32,
            head_dim=64)
PRECISIONS = ["int4", "int8"]
MODEL_TOL = {"int4": 1e-1, "int8": 3e-2}
CFG_TOL = 7e-2  # the int8 pipeline under CFG 5.0
SIZE = 32  # latent side: 256 x 256 images
TANH_DEVIATION = 1e-6  # |torch.tanh - XLA's CPU tanh| on f32 (ROADMAP Queue 3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread keeps the torch side's time steady when a
    parallel test run keeps every core busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(out, ref):
    out, ref = _np(out), _np(ref)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _within_bf16_step(out, ref):
    """Every element at most one bf16 step (2^-7 relative) from the
    reference, near-zero sums 1e-4 of max |ref|: f32 sums in another order."""
    out, ref = _np(out), _np(ref)
    return bool(np.all(np.abs(out - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-4 * np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the TINY UNet, weights from numpy
# ---------------------------------------------------------------------------


def _dotted(path) -> str:
    return ".".join(str(getattr(k, "name", getattr(k, "idx", None))) for k in path)


def numpy_params(shapes: dict, precision: str, seed: int) -> dict:
    """Leaves of the JAX ``random_init`` with its distributions (linear.py,
    unet_sdxl.py), by name: SVDQ codes uniform bytes, group / channel scales
    |N(0,1)| / sqrt(K) / 7 (int4) or / 127 (int8), smooth 1, low-rank N(0,
    0.02); plain and convolution weights N(0, 1/fan_in), biases N(0, 0.02);
    norm gains 1 + N(0, 0.1) and shifts N(0, 0.1) (JAX draws 1 and 0; the
    affine is then exercised)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "qweight":
            out[name] = rng.integers(-128, 128, s.shape, dtype=np.int8)
            continue
        if leaf == "wscales":
            k = shapes[name[:-len("wscales")] + "qweight"].shape[0] * (1 if precision == "int8" else 2)
            v = np.abs(rng.standard_normal(s.shape)) / math.sqrt(k) / (127 if precision == "int8" else 7)
        elif leaf == "smooth":
            v = np.ones(s.shape)
        elif leaf in ("proj_down", "proj_up", "bias"):
            v = rng.standard_normal(s.shape) * 0.02
        elif leaf == "gamma":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif leaf == "beta":
            v = 0.1 * rng.standard_normal(s.shape)
        elif leaf == "weight":
            v = rng.standard_normal(s.shape) / math.sqrt(math.prod(s.shape[:-1]))
        else:
            raise KeyError(name)
        out[name] = np.asarray(jnp.asarray(v, s.dtype))
    return out


def tiny_models(precision: str, seed: int = 0):
    """(JAX model, its parameters by name, the port's model)."""
    cfg = JaxSDXLConfig(**TINY, precision=precision)
    struct = jax.eval_shape(lambda k: JaxUNet.random_init(k, cfg), jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(struct)
    params = numpy_params({_dotted(p): s for p, s in leaves}, precision, seed)
    jm = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(params[_dotted(p)]) for p, _ in leaves])
    return jm, params, sdxl_from_jax_params(params, SDXLConfig(**TINY, precision=precision), device="cpu")


def _unet_inputs():
    rng = np.random.default_rng(71)
    return (_bf16(rng.standard_normal((1, 4, SIZE, SIZE))), np.full((1,), 500.0, np.float32),
            _bf16(rng.standard_normal((1, 77, 256))), _bf16(rng.standard_normal((1, 256))),
            np.full((1, 6), 512.0, np.float32))


@pytest.fixture(scope="module")
def models():
    return {p: tiny_models(p) for p in PRECISIONS}


@pytest.fixture(scope="module")
def jax_forward(models):
    run = jax.jit(lambda m, *a: m(*a))
    return {p: np.asarray(run(models[p][0], *map(jnp.asarray, _unet_inputs())), np.float32) for p in PRECISIONS}


# ---------------------------------------------------------------------------
# ops: flash at D 64, the GEGLU quantize, the odd-width linear
# ---------------------------------------------------------------------------

FLASH_CASES = {"self": (2, 300, 300), "cross": (3, 256, 77)}  # heads, Sq, Skv


def _flash_inputs(case):
    h, sq, skv = FLASH_CASES[case]
    rng = np.random.default_rng(72)
    return tuple(_bf16(rng.standard_normal((1, h, s, 64)) * 2.0) for s in (sq, skv, skv))


@pytest.fixture(scope="module")
def jax_flash_out():
    return {c: np.asarray(jax_flash(*map(jnp.asarray, _flash_inputs(c))), np.float32) for c in FLASH_CASES}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_online_d64_matches_jax(jax_flash_out, case):
    """The D-64 online flash (scale 1/sqrt(64); the wrapper's CPU path, the
    kernel's 128-column kv tiles, the ragged tail of Skv 77 cut off) against
    JAX ``flash_attention`` (interpret mode, one kv block): max error <=
    1e-2 of max |ref|. XLA's CPU exp2 of a bf16 argument rounds to another
    neighbour than exp2f on most p, so the outputs differ by about one bf16
    step nearly everywhere, whatever the tiles. The (B, S, H*D) form equals
    the (B, H, S, D) one transposed."""
    q, k, v = map(_t, _flash_inputs(case))
    out = flash_attention_online(q, k, v)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert _rel(out, jax_flash_out[case]) <= 1e-2
    bshd = flash_attention_online(q, k, v, out_bshd=True)
    assert torch.equal(bshd, out.transpose(1, 2).reshape(1, q.shape[2], -1))


def _geglu_case(precision):
    """GEGLU input (M 300, 2 x 320), a proj_down padded to the layer's K 512
    (zero rows past 320, as an odd-width linear holds it), random smooth."""
    rng = np.random.default_rng(73)
    x = _bf16(rng.standard_normal((300, 640)) * 2.0)
    pd = np.zeros((512, 32), np.float32)
    pd[:320] = rng.standard_normal((320, 32)) * 0.05
    sm = rng.random(512) * 1.5 + 0.5
    return x, _bf16(pd), _bf16(sm)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_geglu_quantize_matches_jax(precision):
    """``fuse_glu=True, glu_act="gelu"`` with the K padding, against JAX.

    The bf16 GLU products equal JAX's except where the host's tanh moves
    the f32 product across a bf16 rounding edge (about 1.4% of them here,
    mostly at negative gates, where gelu is small and tanh's absolute
    deviation is large against it): each such difference is held to the
    part ``0.5 |value * gate| dt`` explains (dt = |torch.tanh(z) -
    jnp.tanh(z)| on the port's own z, itself <= 1e-6), and flips stay under
    5%. The fused quantize then equals JAX's quantize of the port's own
    product bit for bit (codes, scales; the padded columns' codes are 0),
    lora_act within 1e-4 of its max |value| (f32 sums in another order)."""
    x, pd, sm = _geglu_case(precision)
    value, gate = x[:, :320].astype(np.float32), x[:, 320:].astype(np.float32)
    vp = tquant.glu_product(_t(x), "gelu")
    jgelu = np.asarray(jax.nn.gelu(jnp.asarray(gate), approximate=True))
    vj = np.asarray(jnp.asarray(value * jgelu, jnp.bfloat16).astype(jnp.float32))
    z = 0.7978845608028654 * (gate + 0.044715 * (gate * gate * gate))
    dt = np.abs(torch.tanh(torch.from_numpy(z)).numpy() - np.asarray(jnp.tanh(jnp.asarray(z))))
    assert dt.max() <= TANH_DEVIATION, dt.max()
    v32 = vp.float().numpy()
    flip = v32 != vj
    pf = value * tref.gelu_jax(torch.from_numpy(gate)).numpy()
    explained = np.abs(pf - value * jgelu) <= 1e-6 * np.abs(pf) + 0.5 * np.abs(value * gate) * dt
    assert np.all(explained[flip]) and flip.mean() <= 5e-2, (flip.sum(), flip.size)

    kw = dict(precision=precision)
    out = tquant.quantize_w4a4_act_fuse_lora(_t(x), _t(pd), _t(sm), fuse_glu=True, glu_act="gelu", **kw)
    ref = [np.asarray(a) for a in jquant.quantize_w4a4_act_fuse_lora(
        jnp.asarray(np.asarray(_np(vp), np.float32), jnp.bfloat16), jnp.asarray(pd), jnp.asarray(sm), **kw)]
    np.testing.assert_array_equal(out[0].numpy(), ref[0])
    np.testing.assert_array_equal(_np(out[1]), np.asarray(ref[1], np.float32))
    codes = out[0] if precision == "int8" else unpack_int4(out[0], -1)
    assert not codes[:, 320:].any() and codes[:, :320].any()
    assert _rel(out[2], ref[2]) <= 1e-4


def test_silu_glu_quantize_matches_jax():
    """``glu_act="silu"`` (SANA's and Z-Image's GLU) at int4 with the K
    padding: the bf16 products, then codes and scales, equal JAX's fused
    quantize bit for bit (torch's and XLA's f32 silu differ by a few ulp,
    too little to move a bf16 product here); lora_act within 1e-4."""
    x, pd, sm = _geglu_case("int4")
    kw = dict(precision="int4", fuse_glu=True, glu_act="silu")
    out = tquant.quantize_w4a4_act_fuse_lora(_t(x), _t(pd), _t(sm), **kw)
    ref = [np.asarray(a) for a in jquant.quantize_w4a4_act_fuse_lora(jnp.asarray(x), jnp.asarray(pd),
                                                                       jnp.asarray(sm), **kw)]
    value, gate = x[:, :320].astype(np.float32), x[:, 320:].astype(np.float32)
    vj = np.asarray(jnp.asarray(value * jax.nn.silu(jnp.asarray(gate)), jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(_np(tquant.glu_product(_t(x), "silu")), vj)
    np.testing.assert_array_equal(out[0].numpy(), ref[0])
    np.testing.assert_array_equal(_np(out[1]), np.asarray(ref[1], np.float32))
    assert _rel(out[2], ref[2]) <= 1e-4


ODD_SHAPES = [(640, 768), (320, 960)]  # SDXL level 1's K 640; N 960 pads to 1024


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("k,n", ODD_SHAPES)
def test_odd_width_linear_matches_jax(precision, k, n):
    """An odd-width ``SVDQW4A4Linear`` (K padded to 256, N to 128): the JAX
    ``random_init``'s padded buffers carried over with logical dims, the
    forward on (1, 300, K) within one bf16 step of JAX (same codes, f32 sums
    in another order); the port's ``random_init`` has JAX's buffer shapes,
    zero codes and zero proj_down rows past K."""
    jl = jlin.SVDQW4A4Linear.random_init(jax.random.PRNGKey(74), k, n, rank=32, precision=precision)
    x = _bf16(np.random.default_rng(75).standard_normal((1, 300, k)))
    ref = np.asarray(jl(jnp.asarray(x)), np.float32)
    tl = tlin.SVDQW4A4Linear(_t(jl.qweight), _t(jl.wscales), _t(jl.smooth), _t(jl.proj_down), _t(jl.proj_up),
                             _t(jl.bias), precision=precision, logical_in=k, logical_out=n)
    out = tl(_t(x))
    assert out.shape == (1, 300, n) and ref.shape == (1, 300, n) and out.dtype == torch.bfloat16
    assert _within_bf16_step(out, ref)
    mine = tlin.SVDQW4A4Linear.random_init(torch.Generator().manual_seed(0), k, n, precision=precision,
                                           device="cpu")
    shapes = {name: tuple(np.shape(getattr(jl, name))) for name in ("qweight", "wscales", "proj_down", "proj_up")}
    assert {name: tuple(getattr(mine, name).shape) for name in shapes} == shapes
    assert (mine.logical_in, mine.logical_out, mine.in_features) == (k, n, jl.in_features)
    codes = mine.qweight if precision == "int8" else unpack_int4(mine.qweight, 0)
    assert not codes[k:].any() and not mine.proj_down[k:].any() and codes[:k].any()
    with pytest.raises(ValueError):
        tlin.SVDQW4A4Linear(_t(jl.qweight), _t(jl.wscales), _t(jl.smooth), _t(jl.proj_down), _t(jl.proj_up),
                            _t(jl.bias), precision=precision, logical_in=k - 300, logical_out=n)


# ---------------------------------------------------------------------------
# modules, the whole UNet, the pipeline
# ---------------------------------------------------------------------------


def _module_inputs():
    rng = np.random.default_rng(76)
    return (_bf16(rng.standard_normal((1, 128, 16, 16))), _bf16(rng.standard_normal((1, 256, 16, 16))),
            _bf16(rng.standard_normal((1, 512))), _bf16(rng.standard_normal((1, 77, 256))))


def test_shifted_conv_matches_jax():
    """``ShiftedConv2d`` (the input shifted, the padding ring holding the
    shift) against JAX's on the same bf16 weights, NCHW against NHWC: within
    one bf16 step (f32 sums in another order)."""
    from nunchaku_tpu.models.unets.unet_sdxl import Conv2d as JaxConv2d
    from nunchaku_tpu.models.unets.unet_sdxl import ShiftedConv2d as JaxShifted
    from nunchaku_tpu_torch.models.autoencoder import Conv2d
    from nunchaku_tpu_torch.models.unet_sdxl import ShiftedConv2d

    rng = np.random.default_rng(78)
    w, b = _bf16(rng.standard_normal((3, 3, 8, 16)) / math.sqrt(72)), _bf16(rng.standard_normal(16) * 0.02)
    x = _bf16(rng.standard_normal((1, 8, 12, 12)))
    ref = JaxShifted(JaxConv2d(jnp.asarray(w), jnp.asarray(b)), jnp.asarray(0.7))(jnp.asarray(x).transpose(0, 2, 3, 1))
    out = ShiftedConv2d(Conv2d(_t(w).permute(3, 2, 0, 1).contiguous(), _t(b)), torch.tensor(0.7))(_t(x))
    assert out.shape == (1, 16, 12, 12) and out.dtype == torch.bfloat16
    assert _within_bf16_step(out, np.asarray(ref, np.float32).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("module", ["resnet", "spatial_int4", "spatial_int8"])
def test_modules_match_jax(models, module):
    """Level 1's first ``ResnetBlock2D`` (128 -> 256 channels, 1x1
    shortcut) and ``SpatialTransformer`` (one block, 4 heads of 64), NCHW in
    the port and NHWC in JAX. The resnet (bf16 convolutions, f32
    GroupNorm): max error <= 1e-2 of max |ref|. The spatial transformer
    adds the quantized linears, whose codes flip where an input sits one
    bf16 step apart (the flash twin's rescale columns): <= 5e-2 (int4; JAX's
    own int4 routes differ by as much), 2e-2 (int8)."""
    x128, x256, temb, ctx = _module_inputs()
    nhwc = lambda f: lambda x, *a: f(jnp.asarray(x).transpose(0, 2, 3, 1), *map(jnp.asarray, a)).transpose(0, 3, 1, 2)
    if module == "resnet":
        jm, _, tm = models["int4"]
        ref = jax.jit(nhwc(lambda x, t: jm.down_resnets[1][0](x, t)))(x128, temb)
        out = tm.down_resnets[1][0](_t(x128), _t(temb))
        tol = 1e-2
    else:
        precision = module.split("_")[1]
        jm, _, tm = models[precision]
        ref = jax.jit(nhwc(lambda x, c: jm.down_attns[1][0](x, c)))(x256, ctx)
        with torch.no_grad():
            out = tm.down_attns[1][0](_t(x256), _t(ctx))
        tol = 5e-2 if precision == "int4" else 2e-2
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("precision", PRECISIONS)
def test_unet_forward_matches_jax(models, jax_forward, precision):
    with torch.no_grad():
        out = models[precision][2](*map(_t, _unet_inputs()))
    ref = jax_forward[precision]
    assert out.shape == ref.shape == (1, 4, SIZE, SIZE) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    assert _rel(out, ref) <= MODEL_TOL[precision]


def _pipe_inputs():
    rng = np.random.default_rng(77)
    sigma0 = float(np.sqrt(sdxl_sigmas(2)[0][0] ** 2 + 1.0))
    return (_bf16(rng.standard_normal((1, 77, 256))), _bf16(rng.standard_normal((1, 256))),
            _bf16(rng.standard_normal((1, 77, 256))), _bf16(rng.standard_normal((1, 256))),
            (rng.standard_normal((1, 4, SIZE, SIZE)) * sigma0).astype(np.float32))


@pytest.mark.parametrize("cfg", [False, True], ids=["no_cfg", "cfg"])
def test_pipeline_two_steps_matches_jax(models, cfg):
    """``SDXLPipeline``, 2 steps at 256 x 256 from given latents, without
    and with CFG 5.0 (two batch-1 UNet calls a step), at int8: final
    latents within the int8 model bound (CFG: ``CFG_TOL``) of JAX's
    ``SDXLPipeline``. (At int4 the code flips of the forward, times the
    guidance, leave the pipeline's own arithmetic unobservable; the int4
    forward is held above.)"""
    jm, _, tm = models["int8"]
    pe, pool, ne, npool, lat = _pipe_inputs()
    kw = dict(height=SIZE * 8, width=SIZE * 8, num_inference_steps=2, guidance_scale=5.0)
    neg = lambda f: dict(negative_prompt_embeds=f(ne), negative_pooled_prompt_embeds=f(npool)) if cfg else {}
    ref = JaxPipeline(jm)(jnp.asarray(pe), jnp.asarray(pool), latents=jnp.asarray(lat), **neg(jnp.asarray),
                          **kw).latents
    out = SDXLPipeline(tm)(_t(pe), _t(pool), latents=_t(lat), **neg(_t), **kw)
    assert out.images is None and out.latents.shape == (1, 4, SIZE, SIZE) and out.latents.dtype == torch.float32
    assert bool(torch.isfinite(out.latents).all())
    assert _rel(out.latents, ref) <= (CFG_TOL if cfg else MODEL_TOL["int8"])


@pytest.mark.parametrize("steps", [1, 4, 30, 50])
def test_sdxl_sigmas_equal_jax(steps):
    sig, ts = sdxl_sigmas(steps)
    jsig, jts = jax_sigmas(steps)
    assert sig.dtype == jsig.dtype == np.float32 and ts.dtype == jts.dtype
    np.testing.assert_array_equal(sig, jsig)
    np.testing.assert_array_equal(ts, jts)


def test_converter_and_parameter_tree(models):
    """The converter takes every JAX parameter (and refuses an extra one);
    the port's ``random_init`` has the JAX tree's names, dtypes and shapes
    (convolutions (kh, kw, in, out) there, (out, in, kh, kw) here)."""
    _, params, tm = models["int4"]
    blk = tm.down_attns[1][0].blocks[0]
    np.testing.assert_array_equal(blk.ff.proj.qweight.numpy(), params["down_attns.1.0.blocks.0.ff.proj.qweight"])
    assert blk.attn1.head_dim == 64 and blk.attn2.to_k.weight.shape == (256, 256)
    with pytest.raises(KeyError):
        sdxl_from_jax_params({**params, "extra.weight": np.zeros(1)}, SDXLConfig(**TINY), device="cpu")
    mine = SDXLUNet2DConditionModel.random_init(SDXLConfig(**TINY), seed=0, device="cpu")
    ours = {n: (tuple(b.shape), str(b.dtype).replace("torch.", "")) for n, b in mine.named_buffers()}
    theirs = {}
    for n, a in params.items():
        shape = (a.shape[3], a.shape[2], a.shape[0], a.shape[1]) if a.ndim == 4 else a.shape
        theirs[n] = (tuple(shape), str(a.dtype))
    assert ours == theirs
