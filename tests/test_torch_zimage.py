"""The port's Z-Image slice against the JAX package on the CPU: the stacked
(layer-index) modes of the W4A4 GEMM (int4, nvfp4), the w4a8 dequant and
the packed w4a8 GEMM against the Pallas kernels in interpret mode; the tiny
model (the config of tests/test_zimage.py: dim 512, 4 heads of 128, 2
layers, 1 + 1 refiners, FFN 1024, caption 512) at int4, int8, w4a8 and
nvfp4 and after ``enable_fused_qkv_prep``; the stacks' layout, views and
parameter tree. Its modules are held apart in
tests/test_torch_zimage_modules.py, the loader and the pipeline in
tests/test_torch_zimage_pipeline.py, on this file's tiny models.

Weights: the JAX model's structure from ``jax.eval_shape`` of its
``random_init``, filled from a seeded numpy generator with the
``random_init`` distributions, except the adaLN modulation weights, drawn at
a quarter of ``random_init``'s scale (a trained model's modulation is small;
at full scale the random gates multiply a 4-bit code flip into the next
block and the JAX package's own two int4 routes end 0.127 apart), carried
into the port by ``zimage_from_jax_params``. Every module sees the same
inputs on both sides (the rope tables are the JAX ones).

Tolerances. Ops: the stacked twins equal the non-stacked twins on the
layer bit for bit; the W4A4 twin within one bf16 step of JAX's kernel, the
dequant's codes exact, the packed GEMM bit for bit without the low-rank
term. Modules and the model: twice the spread of the JAX package's own two
GEMM routes on the same module and inputs (``NUNCHAKU_TPU_INT4_XLA=1`` at
int4 / nvfp4, ``NUNCHAKU_TPU_XLA_LORA_BF16=0`` at int8 / w4a8: the same
math, f32 sums in another order, so a 4-bit code flips where an input is a
bf16 step from a rounding edge), measured on the CPU in this test's
configuration by running the JAX call with and without the switch (the
smaller of the two prologues' spreads for the attention and the model).
Spreads (int4 / int8 / w4a8 / nvfp4): attention 3.98e-2 / 1.58e-2 /
9.4e-3 / 4.79e-2; feed-forward 7.31e-2 / 1.32e-2 / 1.83e-2 / 3.85e-2;
modulated block 3.34e-2 / 6.5e-3 / 1.05e-2 / 2.03e-2; context-refiner
block 1.19e-1 / 2.72e-2 / 2.10e-2 / 8.95e-2 (its unmodulated RMSNorm of
the feed-forward output scales a small output's flips to O(1)); model
1.83e-2 / 3.2e-3 / 3.9e-3 / 1.27e-2. The port ends, in the same order, at
1.1e-2 / 2.2e-3 / 2.8e-3 / 3.7e-2 (attention), 1.3e-2 / 1.8e-4 / 8e-6 /
9e-4 (feed-forward), 1.6e-2 / 3.1e-3 / 6.2e-3 / 9.7e-3 (block), 7.4e-2 /
9.2e-3 / 1.4e-2 / 5.5e-2 (context refiner) and 2.2e-2 / 3.2e-3 / 3.9e-3 /
9.9e-3 (model) from JAX.
"""

import copy
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.core.packing import pack_int4
from nunchaku_tpu.models.transformers import transformer_zimage as JZ
from nunchaku_tpu.ops import attention as jattn
from nunchaku_tpu.ops import gemm as jgemm
from nunchaku_tpu.ops import quantize as jquant
from nunchaku_tpu_torch import ZImageConfig, ZImageTransformer2DModel
from nunchaku_tpu_torch.convert import to_torch, zimage_from_jax_params
from nunchaku_tpu_torch.models import linear as tlin
from nunchaku_tpu_torch.models.transformer_zimage import STACKS
from nunchaku_tpu_torch.ops import gemm as tgemm

TINY = dict(dim=512, num_layers=2, num_refiner_layers=1, num_attention_heads=4, in_channels=16, patch_size=2,
            cap_feat_dim=512, axes_dims_rope=(32, 48, 48), ffn_inner=1024)
PRECISIONS = ["int4", "int8", "w4a8", "nvfp4"]
# twice the JAX routes' spread (module docstring), by module and precision
TOL = {
    "attention": {"int4": 8e-2, "int8": 3.2e-2, "w4a8": 1.9e-2, "nvfp4": 9.6e-2},
    "feed_forward": {"int4": 1.47e-1, "int8": 2.7e-2, "w4a8": 3.7e-2, "nvfp4": 7.7e-2},
    "modulated": {"int4": 6.7e-2, "int8": 1.3e-2, "w4a8": 2.1e-2, "nvfp4": 4.1e-2},
    "context": {"int4": 2.38e-1, "int8": 5.5e-2, "w4a8": 4.2e-2, "nvfp4": 1.79e-1},
    "model": {"int4": 3.7e-2, "int8": 6.4e-3, "w4a8": 7.8e-3, "nvfp4": 2.6e-2},
}
MODEL_TOL = TOL["model"]
ADALN_SCALE = 0.25
S_IMG, S_TXT = 256, 64  # a 16 x 16 token grid (256 x 256 images), 64 caption tokens


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread keeps the torch side's time steady when a
    parallel test run keeps every core busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return None if a is None else to_torch(np.asarray(a), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(out, ref):
    out, ref = _np(out), _np(ref)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _bf16_steps(out, ref):
    """Elements further than one bf16 rounding step apart (2^-7 |ref| plus
    1e-4 of max |ref| for sums that cancel)."""
    out, ref = _np(out), _np(ref)
    return int((np.abs(out - ref) > 2.0 ** -7 * np.abs(ref) + 1e-4 * np.abs(ref).max()).sum())


def _dotted(path) -> str:
    return ".".join(str(getattr(k, "name", getattr(k, "idx", None))) for k in path)


def numpy_params(shapes: dict, precision: str, seed: int) -> dict:
    """Leaves with the JAX ``random_init`` distributions by name: SVDQ codes
    uniform bytes; group scales |N(0,1)| / sqrt(K) / 7 (int4, nvfp4), channel
    scales / 127 (int8) or that times 127 / 70 (w4a8, against rescales
    uniform in [1, 127 / 7]); smooth 1; low-rank factors and biases N(0,
    0.02); plain weights N(0, 1/fan_in), the adaLN ones a quarter of that;
    the RMSNorm weights uniform in [0.5, 1.5] (JAX draws ones)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "qweight":
            out[name] = rng.integers(-128, 128, s.shape, dtype=np.int8)
            continue
        if leaf == "wscales":
            k = shapes[name[:-len("wscales")] + "qweight"].shape[-2] * (1 if precision == "int8" else 2)
            v = np.abs(rng.standard_normal(s.shape)) / math.sqrt(k)
            v = v / {"int4": 7, "nvfp4": 7, "int8": 127, "w4a8": 70}[precision]
        elif leaf == "rescales":
            v = rng.random(s.shape) * (127.0 / 7.0 - 1.0) + 1.0
        elif leaf == "smooth":
            v = np.ones(s.shape)
        elif leaf in ("proj_down", "proj_up", "bias"):
            v = rng.standard_normal(s.shape) * 0.02
        elif leaf == "weight":
            v = rng.standard_normal(s.shape) / math.sqrt(s.shape[-2]) * (ADALN_SCALE if ".adaln." in name else 1.0)
        else:  # RMSNorm weights
            v = rng.uniform(0.5, 1.5, s.shape)
        out[name] = np.asarray(jnp.asarray(v, s.dtype))
    return out


_CACHE = {}


def tiny_models(precision: str, fused: bool = False, seed: int = 0):
    """(JAX model, its parameters by name, the port's model), both after
    ``enable_fused_qkv_prep`` when ``fused``; built once per process."""
    key = (precision, fused, seed)
    if key not in _CACHE:
        cfg = JZ.ZImageConfig(**TINY, precision=precision)
        struct = jax.eval_shape(lambda k: JZ.ZImageTransformer2DModel.random_init(k, cfg), jax.random.PRNGKey(0))
        leaves, treedef = jax.tree_util.tree_flatten_with_path(struct)
        params = numpy_params({_dotted(p): s for p, s in leaves}, precision, seed)
        jm = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(params[_dotted(p)]) for p, _ in leaves])
        tm = zimage_from_jax_params(params, ZImageConfig(**TINY, precision=precision), device="cpu")
        if fused:
            jm.enable_fused_qkv_prep()
            tm.enable_fused_qkv_prep()
        _CACHE[key] = (jm, params, tm)
    return _CACHE[key]


def _img_ids(s=S_IMG):
    side = int(round(math.sqrt(s)))
    ids = np.zeros((s, 3), np.int32)
    ids[:, 1] = np.arange(s) // side
    ids[:, 2] = np.arange(s) % side
    return ids


def model_inputs(seed=91, b=1):
    rng = np.random.default_rng(seed)
    return (_bf16(rng.standard_normal((b, S_IMG, 64))), _bf16(rng.standard_normal((b, S_TXT, 512))),
            np.full((b,), 0.5, np.float32), _img_ids(), np.zeros((S_TXT, 3), np.int32))


def _jax_rot(fused, s_txt=S_TXT):
    """The joint [caption; image] rope table of the JAX model (interleaved,
    or half-split after the fused prep)."""
    rot = jnp.concatenate([JZ.rope_table(jnp.zeros((s_txt, 3), jnp.int32), TINY["axes_dims_rope"]),
                           JZ.rope_table(jnp.asarray(_img_ids()), TINY["axes_dims_rope"])], axis=0)
    return jattn.rope_table_halfsplit(rot) if fused else rot


def _port_rot(rot):
    return tuple(_t(r) for r in rot) if isinstance(rot, tuple) else _t(rot)


def _jax_layer(jm, i):
    return jax.tree.map(lambda a: a[i], jm.layers)


# ---------------------------------------------------------------------------
# ops: the stacked modes against the Pallas kernels
# ---------------------------------------------------------------------------

LAYERS = 3


def _w4a4_stack_case(precision, m=256, k=512, n=256, r=32, seed=93):
    """Activations quantized by JAX, a 3-layer stack of random codes and one
    layer's group scales, low-rank terms and bias."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((m, k)) * 2.0)
    pd = _bf16(rng.standard_normal((k, r)) * 0.05)
    qa, asc, la = (np.asarray(a) for a in jquant.quantize_w4a4_act_fuse_lora(jnp.asarray(x), jnp.asarray(pd),
                                                                             precision=precision))
    g = 16 if precision == "nvfp4" else 64
    stack = rng.integers(-128, 128, (LAYERS, k // 2, n), dtype=np.int8)
    ws = _bf16(np.abs(rng.standard_normal((k // g, n))) / (7 * np.sqrt(k)))
    return qa, asc, stack, ws, la, _bf16(rng.standard_normal((r, n)) * 0.02), _bf16(rng.standard_normal(n) * 0.02)


@pytest.mark.parametrize("layer", range(LAYERS))
@pytest.mark.parametrize("precision", ["int4", "nvfp4"])
def test_stacked_w4a4_matches_jax(precision, layer):
    """``svdq_gemm_w4a4(..., layer_idx=)`` on a 3-layer stack against JAX's
    stacked ``_gemm_w4a4_kernel`` (scalar-prefetch mode, interpret): every
    element within one bf16 step (the same bf16 operands, f32 sums in another
    order); and the stacked twin equals the non-stacked twin on the layer bit
    for bit. The stack keeps each layer K-contiguous, as the port stores it."""
    qa, asc, stack, ws, la, pu, bias = _w4a4_stack_case(precision)
    ref = jgemm.svdq_gemm_w4a4(*map(jnp.asarray, (qa, asc, stack, ws, la, pu, bias)), precision=precision,
                               layer_idx=jnp.int32(layer))
    tstack = _t(stack).transpose(1, 2).contiguous().transpose(1, 2)
    idx = torch.tensor(layer, dtype=torch.int32)
    out = tgemm.svdq_gemm_w4a4(_t(qa), _t(asc), tstack, _t(ws), _t(la), _t(pu), _t(bias), precision=precision,
                               layer_idx=idx)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == tuple(ref.shape)
    assert _bf16_steps(out, ref) == 0
    flat = tgemm.gemm_w4a4(_t(qa), _t(asc), tstack[layer], _t(ws), _t(la), _t(pu), _t(bias), precision=precision)
    assert torch.equal(out, flat)


@pytest.mark.parametrize("layer", range(LAYERS))
def test_stacked_dequant_codes_equal_jax(layer):
    """The stacked dequant against JAX ``dequant_w4a8_pallas(qw, rs,
    layer_idx)`` (interpret): every int8 code equal; the stacked twin equals
    the non-stacked one on the layer."""
    rng = np.random.default_rng(94)
    k, n = 512, 256
    stack = rng.integers(-128, 128, (LAYERS, k // 2, n), dtype=np.int8)
    rs = _bf16(rng.random((k // 64, n)) * (127.0 / 7.0 - 1.0) + 1.0)
    ref = np.asarray(jgemm.dequant_w4a8_pallas(jnp.asarray(stack), jnp.asarray(rs), jnp.int32(layer)))
    out = tgemm.dequant_w4a8(_t(stack), _t(rs), layer_idx=torch.tensor(layer, dtype=torch.int32))
    assert out.dtype == torch.int8 and tuple(out.shape) == (k, n)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(out, tgemm.dequant_w4a8(_t(stack)[layer], _t(rs)))


@pytest.mark.parametrize("route", ["dequant", "packed"])
@pytest.mark.parametrize("lora", [True, False])
def test_stacked_w4a8_matches_jax(monkeypatch, route, lora):
    """w4a8 with ``layer_idx`` (layer 2 of 3): on the dequant route (the
    default) the stacked dequant then the int8 product, against JAX's
    stacked Pallas dequant and XLA's int8 dot; on the packed route
    (``NUNCHAKU_TPU_W4A8_XLA=0``) the packed GEMM's stacked rank-1 twin
    against JAX's stacked ``_gemm_w4a8h_kernel`` (interpret). Bit for bit
    without the low-rank term; with it every element within one bf16 step
    (its f32 sum in another order than XLA's dot). Both equal the port's
    non-stacked call on the layer."""
    monkeypatch.setenv("NUNCHAKU_TPU_W4A8_XLA", "0" if route == "packed" else "1")
    rng = np.random.default_rng(95)
    m, k, n, r = 128, 512, 256, 32
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    pd = jnp.asarray(rng.standard_normal((k, r)) * 0.05, jnp.bfloat16)
    qa, asc, la = jquant.quantize_w4a4_act_fuse_lora(x, pd, None, precision="w4a8")
    stack = jnp.stack([pack_int4(rng.integers(-8, 8, (k, n)), axis=0) for _ in range(LAYERS)])
    rs = jnp.asarray(rng.random((k // 64, n)) * (127.0 / 7.0 - 1.0) + 1.0, jnp.bfloat16)
    ws = jnp.asarray(rng.random((1, n)) * 0.01 + 0.001, jnp.float32)
    pu = jnp.asarray(rng.standard_normal((r, n)) * 0.05, jnp.bfloat16) if lora else None
    la = la if lora else None
    bias = jnp.asarray(rng.standard_normal(n) * 0.1, jnp.bfloat16)
    ref = jgemm.svdq_gemm_w4a4(qa, asc, stack, ws, la, pu, bias, rescales=rs, precision="w4a8",
                               layer_idx=jnp.int32(2))
    args = [_t(a) for a in (qa, asc, stack, ws, la, pu, bias)]
    out = tgemm.svdq_gemm_w4a4(*args, rescales=_t(rs), precision="w4a8", layer_idx=torch.tensor(2, dtype=torch.int32))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == tuple(ref.shape)
    if lora:
        assert _bf16_steps(out, ref) == 0
    else:
        np.testing.assert_array_equal(_np(out), _np(ref))
    flat = tgemm.svdq_gemm_w4a4(*args[:2], args[2][2], *args[3:], rescales=_t(rs), precision="w4a8")
    assert torch.equal(out, flat)


def test_stacked_refusals():
    """An index outside [0, L) raises in every stacked twin; the stacked
    forms the FLUX and Qwen-Image stacks reach (int8 per-token scales, the
    W4A4 GEMM's unsigned activations, e2m1 codes) take the layer as the
    non-stacked twin does; the counts of the stacked modes move only on the
    card."""
    qa, asc, stack, ws, la, pu, bias = (_t(a) for a in _w4a4_stack_case("int4", m=64, k=256, n=128))
    for bad in (LAYERS, -1):
        idx = torch.tensor(bad, dtype=torch.int32)
        with pytest.raises(IndexError):
            tgemm.gemm_w4a4(qa, asc, stack, ws, la, pu, bias, precision="int4", layer_idx=idx)
        with pytest.raises(IndexError):
            tgemm.dequant_w4a8(stack, torch.ones((4, 128), dtype=torch.bfloat16), layer_idx=idx)
    one = torch.tensor(1, dtype=torch.int32)
    qa8, w8 = torch.ones((64, 128), dtype=torch.int8), stack.to(torch.int8)  # an (L, 128, 128) int8 stack
    assert torch.equal(tgemm.svdq_gemm_w4a4(qa8, torch.ones((1, 64)), w8, torch.ones((1, 128)), precision="int8",
                                            layer_idx=one),
                       tgemm.gemm_w8a8_rank1(qa8, torch.ones((1, 64)), w8[1], torch.ones((1, 128)), None, None, None))
    assert torch.equal(tgemm.gemm_w4a4(qa, asc, stack, ws, la, pu, bias, precision="int4", act_unsigned=True,
                                       layer_idx=one),
                       tgemm.gemm_w4a4(qa, asc, stack[1], ws, la, pu, bias, precision="int4", act_unsigned=True))
    rs16 = torch.ones((16, 128), dtype=torch.bfloat16)
    assert torch.equal(tgemm.dequant_w4a8(stack, rs16, "e2m1", layer_idx=one), tgemm.dequant_w4a8(stack[1], rs16, "e2m1"))
    before = {k: c.launches for k, c in tgemm.COUNTS.items()}
    tgemm.gemm_w4a4(qa, asc, stack, ws, la, pu, bias, precision="int4", layer_idx=one)
    assert {k: c.launches for k, c in tgemm.COUNTS.items()} == before


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


_JAX_OUT = {}


def _forward_pair(precision, fused=False):
    """(the port's forward, the JAX model's, the latter computed once)."""
    jm, _, tm = tiny_models(precision, fused)
    x, c, t, ii, ti = model_inputs()
    if (precision, fused) not in _JAX_OUT:
        _JAX_OUT[precision, fused] = np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, (x, c, t, ii, ti))),
                                                np.float32)
    with torch.no_grad():
        out = tm(_t(x), _t(c), torch.from_numpy(t), torch.from_numpy(ii), torch.from_numpy(ti))
    return out, _JAX_OUT[precision, fused]


@pytest.mark.parametrize("precision", PRECISIONS)
def test_model_forward_matches_jax(precision, monkeypatch):
    """The tiny model's forward (JAX: its three stacks through ``_scan`` with
    stacked weights at w4a8 / int4 / nvfp4; the port: the layer views, the
    4-bit linears reading their stacks by layer index) within twice the JAX
    routes' spread; at w4a8 / int4 / nvfp4 every quantized linear of every
    layer passes its stack and its layer index to the GEMM (16 calls), at
    int8 none does."""
    calls = []
    real = tlin.svdq_gemm_w4a4

    def spy(*a, **kw):
        calls.append(kw.get("layer_idx"))
        return real(*a, **kw)

    monkeypatch.setattr(tlin, "svdq_gemm_w4a4", spy)
    out, ref = _forward_pair(precision)
    assert out.shape == ref.shape == (1, S_IMG, 64) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    assert _rel(out, ref) <= MODEL_TOL[precision]
    stacked = [int(i) for i in calls if i is not None]
    want = [] if precision == "int8" else [0, 0, 0, 0] + [0, 0, 0, 0] + [0, 0, 0, 0, 1, 1, 1, 1]
    assert stacked == want and len(calls) == 16


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_fused_qkv_prep_matches_jax(precision):
    """After ``enable_fused_qkv_prep`` (all three to_qkv / norm_q / norm_k
    stacks permuted in place, then the layer views rebuilt): the port
    against the fused JAX model within the model bound, and against its own
    unfused forward within 2e-2 at int8 (tests/test_zimage.py's bound for
    JAX's two prologues; at int4 the model bound)."""
    out, ref = _forward_pair(precision, fused=True)
    assert _rel(out, ref) <= MODEL_TOL[precision]
    plain, _ = _forward_pair(precision)
    assert _rel(out, plain) <= (2e-2 if precision == "int8" else MODEL_TOL[precision])
    _, _, tm = tiny_models(precision, True)
    with pytest.raises(ValueError):
        tm.enable_fused_qkv_prep()


def test_stacks_views_and_parameter_tree():
    """The port keeps the JAX layout: every buffer equals the JAX model's leaf
    of the same dotted name bit for bit, with its shape and dtype (the stacks
    carry the leading layer axis); each int4 qweight layer K-contiguous, the
    layers back to back; the layer views are views (no copy), the 4-bit ones
    attached to their stack with a layer index on the stack's device; a copy
    of the model builds its views on its own stacks; ``random_init`` has the JAX
    tree's names, shapes and dtypes; the converter refuses an extra
    parameter."""
    jm, params, tm = tiny_models("int4")
    jp = {k: np.asarray(v) for k, v in jm.named_parameters()}
    mine = dict(tm.named_buffers())
    assert set(mine) == set(jp)
    for name, t in mine.items():
        a = jp[name]
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name and tuple(t.shape) == a.shape, name
        np.testing.assert_array_equal(t.contiguous().reshape(-1).view(torch.uint8).numpy(),
                                      np.ascontiguousarray(a).reshape(-1).view(np.uint8), err_msg=name)
    qw = tm.layers.attention.to_qkv.qweight
    assert qw.shape == (2, 256, 1536) and qw[1].t().is_contiguous() and qw.stride(0) == qw[0].numel()
    views = tm.layer_views()
    assert [len(views[n]) for n in STACKS] == [1, 1, 2]
    lin = views["layers"][1].attention.to_qkv
    assert lin.qweight.data_ptr() == qw[1].data_ptr() and lin._stacked_qweight is qw and int(lin._layer_idx) == 1
    assert views["layers"][1].feed_forward.w2._layer_idx.dtype == torch.int32
    twin = copy.deepcopy(tm)
    view = twin.layer_views()["layers"][1].attention.to_qkv
    assert view.qweight.data_ptr() == twin.layers.attention.to_qkv.qweight[1].data_ptr() != qw[1].data_ptr()
    assert view._stacked_qweight is twin.layers.attention.to_qkv.qweight
    _, _, t8 = tiny_models("int8")
    assert not hasattr(t8.layer_views()["layers"][0].attention.to_qkv, "_layer_idx")
    fresh = ZImageTransformer2DModel.random_init(ZImageConfig(**TINY), seed=0, device="cpu")
    ours = {n: (tuple(b.shape), str(b.dtype).removeprefix("torch.")) for n, b in fresh.named_buffers()}
    assert ours == {n: (a.shape, a.dtype.name) for n, a in jp.items()}
    assert fresh.layers.feed_forward.w13.qweight[0].t().is_contiguous()
    with pytest.raises(KeyError):
        zimage_from_jax_params({**params, "extra.weight": np.zeros(1)}, ZImageConfig(**TINY), device="cpu")
