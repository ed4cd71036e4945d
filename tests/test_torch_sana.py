"""The port's SANA slice against the JAX package on the CPU: the online flash
at head dim 112, ``lite_la``, the cross-attention (unmasked on the flash
twin, masked on the f32 softmax), ``SanaGLUMBConv`` at odd widths, one
block, the tiny model at int4 and int8 (with and without PAG), the pipeline
at 2 steps with CFG, with PAG and with ``cache="fb"``, the shifted sigmas,
the loader (codes and scales equal to the JAX loader's), the converter and
the parameter tree.

The tiny config has dim 224 (7 linear-attention heads of 32), 2
cross-attention heads of 112, FF hidden 560: every quantized width is odd
(K 224 -> 256, 560 -> 768; N 672 -> 768, 1120 -> 1152, 224 -> 256), so the
padded buffers, the logical dims and the GLU split at the logical width
are all exercised. Weights: the JAX model's structure from
``jax.eval_shape`` of its ``random_init``, filled from a seeded numpy
generator, carried into the port by ``sana_from_jax_params``. JAX runs its
Pallas kernels in interpret mode.

Tolerances. A 4-bit activation code is a seventh of its group's range, so
an input one bf16 step apart (the flash twin's exp2 against XLA's, f32 sums
in another order) flips codes. The JAX package's own two GEMM routes
(``NUNCHAKU_TPU_INT4_XLA=1``; at int8 ``NUNCHAKU_TPU_XLA_LORA_BF16=0``)
end 1.8e-2 (int4) and 7.2e-3 (int8) apart on the tiny model's forward
(measured on the CPU by running the JAX forward with and without the
switch), the port 1.7e-2 and 3.6e-3 from JAX: model bounds are twice the
routes' spread, 4e-2 (int4) and 1.5e-2 (int8). Modules fed identical
inputs are held tighter, each as its test states.
"""

import ast
import dataclasses
import math
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models.transformers import transformer_sana as JS
from nunchaku_tpu.models.transformers.loader_sana import load_sana_transformer as jax_load_sana
from nunchaku_tpu.ops.attention import flash_attention as jax_flash
from nunchaku_tpu.pipeline.pipeline_sana import SanaPipeline as JaxPipeline
from nunchaku_tpu.pipeline.scheduler import flux_sigmas as jax_sigmas
from nunchaku_tpu_torch import SanaConfig, SanaPipeline, SanaTransformer2DModel, load_sana_transformer
from nunchaku_tpu_torch.convert import sana_from_jax_params, to_torch
from nunchaku_tpu_torch.models import transformer_sana as TS
from nunchaku_tpu_torch.ops.attention import flash_attention_online
from nunchaku_tpu_torch.pipeline.scheduler import flux_sigmas

import torch_checkpoints as TC

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(num_layers=2, num_attention_heads=7, num_cross_attention_heads=2, caption_channels=96)
PAG_LAYERS = (1,)
PRECISIONS = ["int4", "int8"]
MODEL_TOL = {"int4": 4e-2, "int8": 1.5e-2}
S_IMG, S_TXT = 256, 40  # a 16 x 16 latent grid (512 x 512 images), 40 text tokens


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


def _dotted(path) -> str:
    return ".".join(str(getattr(k, "name", getattr(k, "idx", None))) for k in path)


def numpy_params(shapes: dict, precision: str, seed: int) -> dict:
    """Leaves of the JAX ``random_init`` with its distributions by name: SVDQ
    codes uniform bytes, group / channel scales |N(0,1)| / sqrt(K) / 7 (int4)
    or / 127 (int8), smooth 1, low-rank and biases N(0, 0.02); plain weights
    N(0, 1/fan_in), the depthwise weights N(0, 1/9); the scale-shift tables
    N(0, 0.1) (JAX draws 0.02: larger modulation exercises it more)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "qweight":
            out[name] = rng.integers(-128, 128, s.shape, dtype=np.int8)
            continue
        if leaf == "wscales":
            k = shapes[name[:-len("wscales")] + "qweight"].shape[-2] * (1 if precision == "int8" else 2)
            v = np.abs(rng.standard_normal(s.shape)) / math.sqrt(k) / (127 if precision == "int8" else 7)
        elif leaf == "smooth":
            v = np.ones(s.shape)
        elif leaf in ("proj_down", "proj_up", "bias", "depth_b"):
            v = rng.standard_normal(s.shape) * 0.02
        elif leaf in ("scale_shift_table", "scale_shift_table_out"):
            v = rng.standard_normal(s.shape) * 0.1
        elif leaf == "depth_w":
            v = rng.standard_normal(s.shape) / 3.0
        elif leaf == "weight":
            v = rng.standard_normal(s.shape) / math.sqrt(s.shape[-2])
        else:
            raise KeyError(name)
        out[name] = np.asarray(jnp.asarray(v, s.dtype))
    return out


def tiny_models(precision: str, seed: int = 0):
    """(JAX model, its parameters by name, the port's model), PAG on block 1."""
    cfg = JS.SanaConfig(**TINY, precision=precision, pag_layers=PAG_LAYERS)
    struct = jax.eval_shape(lambda k: JS.SanaTransformer2DModel.random_init(k, cfg), jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(struct)
    params = numpy_params({_dotted(p): s for p, s in leaves}, precision, seed)
    jm = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(params[_dotted(p)]) for p, _ in leaves])
    tm = sana_from_jax_params(params, SanaConfig(**TINY, precision=precision, pag_layers=PAG_LAYERS), device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    return {p: tiny_models(p) for p in PRECISIONS}


def _jax_block(jm, i):
    return jax.tree.map(lambda a: a[i], jm.blocks)


def _model_inputs():
    rng = np.random.default_rng(81)
    return (_bf16(rng.standard_normal((2, S_IMG, 32))), _bf16(rng.standard_normal((2, S_TXT, 96))),
            np.array([0.7, 0.3], np.float32))


# ---------------------------------------------------------------------------
# ops: flash at D 112, lite_la
# ---------------------------------------------------------------------------

FLASH_CASES = {"cross": (2, 2, 256, 300), "ragged": (1, 3, 100, 77)}  # B, H, Sq, Skv


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_online_d112_matches_jax(case):
    """The D-112 online flash (scale 1/sqrt(112); the wrapper's CPU path,
    the kernel's 128-column kv tiles, the ragged tail of Skv 300 and 77 cut
    off) against JAX ``flash_attention`` (interpret mode): max error <=
    1e-2 of max |ref| (XLA's CPU exp2 of a bf16 argument rounds to another
    neighbour than exp2f on most p: about one bf16 step nearly everywhere).
    The (B, S, H*D) form equals the (B, H, S, D) one transposed."""
    b, h, sq, skv = FLASH_CASES[case]
    rng = np.random.default_rng(82)
    q, k, v = (_bf16(rng.standard_normal((b, h, s, 112)) * 2.0) for s in (sq, skv, skv))
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)), np.float32)
    out = flash_attention_online(_t(q), _t(k), _t(v))
    assert out.shape == (b, h, sq, 112) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 1e-2
    bshd = flash_attention_online(_t(q), _t(k), _t(v), out_bshd=True)
    assert torch.equal(bshd, out.transpose(1, 2).reshape(b, sq, h * 112))


def test_lite_la_matches_jax():
    """ReLU linear attention in f32 (eps 1e-15) on a (2, 300, 3 * 224) qkv:
    every element within one bf16 step of JAX's (f32 sums in another
    order)."""
    qkv = _bf16(np.random.default_rng(83).standard_normal((2, 300, 3 * 224)))
    ref = np.asarray(JS.lite_la(jnp.asarray(qkv), 224), np.float32)
    out = TS.lite_la(_t(qkv), 224)
    assert out.shape == (2, 300, 224) and out.dtype == torch.bfloat16
    o = _np(out)
    assert np.all(np.abs(o - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6)


# ---------------------------------------------------------------------------
# modules, the model, the pipeline
# ---------------------------------------------------------------------------


def _module_inputs():
    rng = np.random.default_rng(84)
    return _bf16(rng.standard_normal((2, S_IMG, 224))), _bf16(rng.standard_normal((2, S_TXT, 224)))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_cross_attention_matches_jax(models, masked):
    """Block 0's cross-attention at int8 (q_linear, the D-112 attention,
    out_proj) on identical inputs: unmasked on the flash twin, masked (the
    second prompt padded after 25 of 40 tokens) on the f32 softmax: max
    error <= 2e-2 of max |ref| (the flash twin's bf16 steps move out_proj's
    int8 codes by one)."""
    jm, _, tm = models["int8"]
    x, cond = _module_inputs()
    mask = None
    if masked:
        mask = np.ones((2, S_TXT), bool)
        mask[1, 25:] = False
    jb = _jax_block(jm, 0)
    ref = jax.jit(lambda m, *a: m.cross_attn(*a))(jb, jnp.asarray(x), jnp.asarray(cond),
                                                   None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        out = tm.blocks[0].cross_attn(_t(x), _t(cond), None if mask is None else torch.from_numpy(mask))
    assert out.shape == ref.shape == (2, S_IMG, 224) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 2e-2


@pytest.mark.parametrize("precision", PRECISIONS)
def test_glumbconv_matches_jax(models, precision):
    """Block 0's GLUMBConv at odd widths (inverted 224 -> 1120 padded to
    1152, SiLU, the depthwise conv over 1120 channels with f32 output, the
    GLU split at 560, point 560 padded to 768 -> 224): max error <= 1e-2
    of max |ref| (the f32 convolution's sums in another order move some GLU
    products a bf16 step, and the point linear's codes with them)."""
    jm, _, tm = models[precision]
    x, _ = _module_inputs()
    ref = jax.jit(lambda m, a: m.ff(a, (16, 16)))(_jax_block(jm, 0), jnp.asarray(x))
    with torch.no_grad():
        out = tm.blocks[0].ff(_t(x), (16, 16))
    assert out.shape == ref.shape == (2, S_IMG, 224) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 1e-2


@pytest.mark.parametrize("pag", [False, True], ids=["plain", "pag_row1"])
def test_block_matches_jax(models, pag):
    """Block 1 (the PAG block) at int8 on an f32 stream, timestep
    modulation from the model's embed: plain, and with PAG on batch row 1
    (both branches over the whole batch, rows selected): within the int8
    model bound."""
    jm, _, tm = models["int8"]
    x, cond = _module_inputs()
    rng = np.random.default_rng(85)
    xs = (rng.standard_normal((2, S_IMG, 224)) * 2).astype(np.float32)
    temb6 = (rng.standard_normal((2, 6, 224)) * 0.2).astype(np.float32)
    rows = np.array([False, True])
    kw = dict(pag=pag, pag_rows=jnp.asarray(rows) if pag else None)
    ref = jax.jit(lambda m, *a: m(*a, (16, 16), None, **kw))(_jax_block(jm, 1), jnp.asarray(xs), jnp.asarray(cond),
                                                             jnp.asarray(temb6))
    with torch.no_grad():
        out = tm.blocks[1](torch.from_numpy(xs), _t(cond), torch.from_numpy(temb6), (16, 16), None, pag,
                           torch.from_numpy(rows) if pag else None)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert _rel(out, ref) <= MODEL_TOL["int8"]


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("pag", [False, True], ids=["plain", "pag"])
def test_model_forward_matches_jax(models, precision, pag):
    """The tiny model's forward (B 2), plain and with PAG on block 1 for
    batch row 1, within the model bound of its precision."""
    jm, _, tm = models[precision]
    x, c, t = _model_inputs()
    rows = np.array([False, True])
    kw = dict(pag=True, pag_layers=list(PAG_LAYERS)) if pag else {}
    ref = np.asarray(jax.jit(lambda m, *a: m(*a, **kw, pag_rows=jnp.asarray(rows) if pag else None))(
        jm, jnp.asarray(x), jnp.asarray(c), jnp.asarray(t)), np.float32)
    with torch.no_grad():
        out = tm(_t(x), _t(c), torch.from_numpy(t), **kw, pag_rows=torch.from_numpy(rows) if pag else None)
    assert out.shape == ref.shape == (2, S_IMG, 32) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    assert _rel(out, ref) <= MODEL_TOL[precision]


PIPE_CASES = {
    "cfg": dict(guidance_scale=4.5),
    "pag": dict(guidance_scale=4.5, pag_scale=2.0),
    "fb": dict(guidance_scale=1.0, cache="fb", residual_diff_threshold=10.0),  # step 1 replays the cache
}


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_two_steps_matches_jax(models, case):
    """``SanaPipeline``, 2 steps at 512 x 512 from given latents (B 1) at
    int8: CFG 4.5 (B 2 against zero embeddings), CFG with PAG 2.0 on block 1
    (B 3), and the first-block cache at guidance 1 with a threshold that
    makes step 1 a hit. Final latents within 4.5e-2 of JAX's, twice the
    largest spread of JAX's own int8 routes on these cases (measured on the
    CPU as above: CFG 1.7e-2, PAG 2.2e-2, cache 2.7e-3; guidance multiplies
    a forward's differences, ``v_unc + 4.5 (v_txt - v_unc)``); the cached
    run also differs from the uncached one."""
    jm, _, tm = models["int8"]
    rng = np.random.default_rng(86)
    pe = _bf16(rng.standard_normal((1, S_TXT, 96)))
    lat = rng.standard_normal((1, S_IMG, 32)).astype(np.float32)
    kw = dict(height=512, width=512, num_inference_steps=2, **PIPE_CASES[case])
    ref = JaxPipeline(jm)(prompt_embeds=jnp.asarray(pe), latents=jnp.asarray(lat), **kw).latents
    out = SanaPipeline(tm)(prompt_embeds=_t(pe), latents=torch.from_numpy(lat), **kw)
    assert out.images is None and out.latents.shape == (1, 32, 16, 16) and out.latents.dtype == torch.float32
    assert bool(torch.isfinite(out.latents).all())
    assert _rel(out.latents, ref) <= 4.5e-2
    if case == "fb":
        plain = SanaPipeline(tm)(prompt_embeds=_t(pe), latents=torch.from_numpy(lat),
                                 **{**kw, "cache": None}).latents
        assert _rel(out.latents, plain) > 1e-3


def test_pipeline_refusals(models):
    """The JAX pipeline's refusals: a cache other than "fb", the cache with
    PAG or with guidance, PAG without PAG layers; no embeddings and no
    encoder."""
    _, _, tm = models["int8"]
    pe = torch.zeros((1, S_TXT, 96), dtype=torch.bfloat16)
    pipe = SanaPipeline(tm)
    kw = dict(height=64, width=64, num_inference_steps=1)
    for bad in (dict(cache="teacache"), dict(cache="fb", guidance_scale=1.0, pag_scale=1.0),
                dict(cache="fb", guidance_scale=2.0)):
        with pytest.raises(ValueError):
            pipe(prompt_embeds=pe, **kw, **bad)
    no_pag = SanaTransformer2DModel.random_init(SanaConfig(num_layers=1, num_attention_heads=4,
                                                           num_cross_attention_heads=1, caption_channels=96),
                                                device="cpu")
    with pytest.raises(ValueError):
        SanaPipeline(no_pag)(prompt_embeds=pe, pag_scale=1.0, **kw)
    with pytest.raises(ValueError):
        pipe(prompt="a cat", **kw)


@pytest.mark.parametrize("steps", [1, 2, 20, 50])
def test_sigmas_equal_jax(steps):
    """SANA's constant shift 3.0 and FLUX's dynamic shift at 4096 tokens,
    equal to JAX's bit for bit."""
    for kw in (dict(use_dynamic_shifting=False, shift=3.0), dict(image_seq_len=4096)):
        out, ref = flux_sigmas(steps, **kw), jax_sigmas(steps, **kw)
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# loader, converter, parameter tree, import rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", [None, "int8"])
def test_loader_matches_jax(tmp_path, precision):
    """One synthesized SANA file (the layout of tests/test_sana.py: dim 512,
    2 blocks, PAG on block 1) through both loaders: every buffer equal to
    the JAX loader's leaf bit for bit (codes, scales, the zero pag_to_v of
    block 0), ``pag_layers`` (1,); the forward within the model bound."""
    path = TC.sana_checkpoint(tmp_path / "sana.safetensors")
    jm = jax_load_sana(path, precision=precision)
    tm = load_sana_transformer(path, precision=precision, device="cpu")
    TC.assert_same_as_jax(tm, jm)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg) and tm.cfg.pag_layers == (1,)
    assert not tm.blocks[0].attn.pag_to_v.qweight.any()
    rng = np.random.default_rng(87)
    x, c = _bf16(rng.standard_normal((1, S_IMG, 32))), _bf16(rng.standard_normal((1, 64, 1152)))
    t = np.array([0.5], np.float32)
    ref = jax.jit(lambda m, *a: m(*a))(jm, jnp.asarray(x), jnp.asarray(c), jnp.asarray(t))
    with torch.no_grad():
        out = tm(_t(x), _t(c), torch.from_numpy(t))
    assert _rel(out, ref) <= MODEL_TOL["int4" if precision is None else "int8"]


def test_loader_odd_widths(tmp_path):
    """A file of the tiny odd-width config (224 / 560, head dim 112), its
    widths stored zero-padded as nunchaku stores them: the port's buffers
    equal the JAX loader's leaves bit for bit and take the config's logical
    dims (the JAX loader keeps the padded ones as logical, so its model
    cannot run this file); the forward equals that of the port's converter
    fed the JAX loader's leaves, and is finite."""
    path = TC.sana_checkpoint(tmp_path / "sana_odd.safetensors", dims=TC.SANA_ODD)
    jm = jax_load_sana(path)
    tm = load_sana_transformer(path, device="cpu")
    TC.assert_same_as_jax(tm, jm)
    qkv, point = tm.blocks[0].attn.qkv_proj, tm.blocks[0].ff.point
    assert (qkv.logical_in, qkv.logical_out, qkv.in_features, qkv.out_features) == (224, 672, 256, 768)
    assert (point.logical_in, point.logical_out, point.in_features) == (560, 224, 768)
    assert jm.blocks.attn.qkv_proj.logical_out == 768
    params = {k: np.asarray(v) for k, v in jm.named_parameters()}
    conv = sana_from_jax_params(params, tm.cfg, device="cpu")
    rng = np.random.default_rng(88)
    x, c = _bf16(rng.standard_normal((1, S_IMG, 32))), _bf16(rng.standard_normal((1, S_TXT, 96)))
    with torch.no_grad():
        out = tm(_t(x), _t(c), torch.tensor([0.5]))
        assert torch.equal(out, conv(_t(x), _t(c), torch.tensor([0.5])))
    assert out.shape == (1, S_IMG, 32) and bool(torch.isfinite(out.float()).all())


def test_converter_and_parameter_tree(models):
    """The converter takes every JAX parameter (and refuses an extra one);
    the port's ``random_init`` has the JAX tree's names, dtypes and shapes
    (the stacked blocks' layer axis taken apart)."""
    _, params, tm = models["int4"]
    np.testing.assert_array_equal(tm.blocks[1].ff.point.qweight.numpy(), params["blocks.ff.point.qweight"][1])
    assert tm.blocks[0].cross_attn.head_dim == 112 and tm.blocks[0].ff.point.logical_in == 560
    with pytest.raises(KeyError):
        sana_from_jax_params({**params, "extra.weight": np.zeros(1)},
                             SanaConfig(**TINY, pag_layers=PAG_LAYERS), device="cpu")
    mine = SanaTransformer2DModel.random_init(SanaConfig(**TINY, pag_layers=PAG_LAYERS), seed=0, device="cpu")
    ours = {n: (tuple(b.shape), str(b.dtype).replace("torch.", "")) for n, b in mine.named_buffers()}
    theirs = {}
    for n, a in params.items():
        if n.startswith("blocks."):
            for i in range(a.shape[0]):
                theirs[n.replace("blocks.", f"blocks.{i}.", 1)] = (tuple(a.shape[1:]), str(a.dtype))
        else:
            theirs[n] = (tuple(a.shape), str(a.dtype))
    assert ours == theirs


@pytest.mark.parametrize("module", ["models/transformer_sana.py", "models/loader_sana.py", "models/dc_ae.py",
                                    "models/text_encoders/gemma2.py", "pipeline/pipeline_sana.py"])
def test_sana_modules_import_no_jax(module):
    """The SANA slice's modules are among those the import rule covers, and
    import neither JAX nor the JAX package."""
    tree = ast.parse((ROOT / "nunchaku_tpu_torch" / module).read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module}
    assert not roots & {"jax", "jaxlib", "nunchaku_tpu"}
