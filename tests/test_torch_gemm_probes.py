"""Parity of the port's two GEMM probe kernels (``ops/gemm_probe.py``) and
its four ported probe tools with the TPU probe scripts under ``tools/``, at
small sizes on the CPU.

The scripts run their full-size benchmark when imported, so they are not
imported: each is parsed, and only its function definitions (and, for
``bench_gemm_variants.py``, its ``S_*`` BlockSpecs) are executed in a
namespace whose sizes are small and whose ``pl.pallas_call`` runs in
interpret mode, as the JAX package's own tests run Pallas on the CPU. The
scripts stay as they are. The port's wrappers run their plain versions
(CPU tensors). Inputs come from seeded numpy generators. Tolerances: the
int8 forms bit for bit (every partial sum here stays below 2^24, where f32
sums of int32 partials are exact in any order); the bf16-operand forms
within one bf16 step elementwise, up to the order of their f32 sums, which
differs (``checks.bf16_order_factor``: a sum that cancels to near 0 is held
to ``BF16_ORDER_C`` sqrt(K) 2^-24 sum_k |a_k w_k|, not to a step of its tiny
value; the same product summed in bf16 must exceed that limit); the decoded
operands bit for bit.
"""

import ast
import functools
import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as jpl
from jax.experimental.pallas import tpu as pltpu

from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
from nunchaku_tpu_torch.ops.checks import BF16_ORDER_C, bf16_accumulated, bf16_order_factor
from nunchaku_tpu_torch.ops.gemm_probe import (BF16_FORMS, I8_BUILT, I8_TILES, decode_operand, gemm_probe_bf16,
                                               gemm_probe_i8)
from nunchaku_tpu_torch.tools import bench_gemm_variants, probe_int8_mxu, probe_m512, tune_gemm_impl

TOOLS = Path(__file__).resolve().parent.parent / "tools"
M, K, N = 256, 512, 256
BM, BN, BK = 128, 128, 256
BENCH_SPECS = {"S_A", "S_A8", "S_AS", "S_W", "S_W8", "S_WS", "S_ABF", "S_WBF", "S_AT", "S_WT"}


def _interpret_pl():
    """``jax.experimental.pallas`` with ``pallas_call`` in interpret mode."""
    pl = types.SimpleNamespace(**{k: getattr(jpl, k) for k in dir(jpl) if not k.startswith("__")})
    pl.pallas_call = functools.partial(jpl.pallas_call, interpret=True)
    return pl


@functools.lru_cache(maxsize=None)
def _script(name):
    """The ``def``s (and BlockSpecs) of ``tools/<name>.py``, executed at M, K,
    N / BM, BN, BK with an interpret-mode ``pl``."""
    path = TOOLS / f"{name}.py"
    tree = ast.parse(path.read_text())
    keep = [node for node in tree.body if isinstance(node, ast.FunctionDef)
            or (isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id in BENCH_SPECS
                                                     for t in node.targets))]
    ns = dict(jax=jax, jnp=jnp, np=np, pl=_interpret_pl(), pltpu=pltpu, functools=functools,
              M=M, K=K, N=N, BM=BM, BN=BN, BK=BK)
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    return ns


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _kt(a):
    """A (K, N) int8 weight as the port holds it: K-contiguous."""
    return _t(a).t().contiguous().t()


def _bits_equal(out, ref):
    ref = _t(ref)
    assert out.dtype == ref.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16)), (out.float() - ref.float()).abs().max()


def _within_one_step(out, ref, a, w, a_form, w_form, a_scale=None, w_scale=None):
    """One bf16 step elementwise up to the f32 sums' order
    (checks.bf16_order_factor within checks.BF16_ORDER_C), a limit that the
    same product summed in bf16 exceeds."""
    a_dec, w_dec = decode_operand(a, a_form, a_scale, dim=1), decode_operand(w, w_form, w_scale, dim=0)
    c = bf16_order_factor(out, _t(ref), a_dec, w_dec)
    assert c <= BF16_ORDER_C, c
    control = bf16_order_factor(bf16_accumulated(a_dec, w_dec), _t(ref), a_dec, w_dec)
    assert control > BF16_ORDER_C, control


@functools.lru_cache(maxsize=None)
def _bench_inputs():
    """bench_gemm_variants.py's draws at the small sizes, as JAX arrays."""
    rng = np.random.default_rng(0)
    return dict(qa=jnp.asarray(rng.integers(-127, 128, (M, K // 2)), jnp.int8),
                qa8=jnp.asarray(rng.integers(-7, 8, (M, K)), jnp.int8),
                asc=jnp.asarray(rng.random((K // 64, M)), jnp.bfloat16),
                qw=jnp.asarray(rng.integers(-127, 128, (K // 2, N)), jnp.int8),
                qw8=jnp.asarray(rng.integers(-7, 8, (K, N)), jnp.int8),
                ws=jnp.asarray(rng.random((K // 64, N)), jnp.bfloat16),
                wbf=jnp.asarray(rng.random((K, N)), jnp.bfloat16),
                abf=jnp.asarray(rng.random((M, K)), jnp.bfloat16),
                at=jnp.asarray(rng.random((1, M)), jnp.float32),
                wt=jnp.asarray(rng.random((1, N)), jnp.float32))


@functools.lru_cache(maxsize=None)
def _full_range_inputs(seed):
    """int8 operands over the probes' full code range (probe_int8_mxu, probe_m512,
    tune_gemm_impl draw from [-127, 127)); |sums| <= 512 * 127^2 < 2^24."""
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.integers(-127, 127, (M, K)), jnp.int8),
            jnp.asarray(rng.integers(-127, 127, (K, N)), jnp.int8),
            jnp.asarray(rng.normal(size=(M, K)), jnp.bfloat16),
            jnp.asarray(rng.normal(size=(K, N)), jnp.bfloat16))


@functools.lru_cache(maxsize=None)
def _bench(kernel, specs, *names):
    """One bench_gemm_variants.py kernel body through its grid_call."""
    s = _script("bench_gemm_variants")
    x = _bench_inputs()
    return np.asarray(s["grid_call"](s[kernel], tuple(x[n] for n in names), [s[p] for p in specs]))


# ---------------------------------------------------------------------------
# the int8 forms: bit for bit
# ---------------------------------------------------------------------------


def test_k_i8dot_bit_for_bit():
    """V5: int8 x int8, each K tile's int32 partial added in f32, cast."""
    x = _bench_inputs()
    ref = _bench("k_i8dot", ("S_A8", "S_W8"), "qa8", "qw8")
    _bits_equal(gemm_probe_i8(_t(x["qa8"]), _kt(x["qw8"]), acc="f32"), ref)


@pytest.mark.parametrize("tile", I8_BUILT[("f32", True)])
def test_k_v7_bit_for_bit(tile):
    """V7: the f32 sum times a_scale[m] times w_scale[n], at every card tile."""
    x = _bench_inputs()
    ref = _bench("k_v7", ("S_A8", "S_AT", "S_W8", "S_WT"), "qa8", "at", "qw8", "wt")
    _bits_equal(gemm_probe_i8(_t(x["qa8"]), _kt(x["qw8"]), _t(x["at"]), _t(x["wt"]), acc="f32", tile=tile), ref)


@pytest.mark.parametrize("jax_tile,tile", [((128, 128, 256), "chain"), ((256, 256, 128), "128x128x128s6")])
def test_v7_with_bit_for_bit(jax_tile, tile):
    """Two of v7_with's tiles: each the port's rank-1 f32 mode bit for bit."""
    s, x = _script("bench_gemm_variants"), _bench_inputs()
    ref = np.asarray(s["v7_with"](*jax_tile)(x["qa8"], x["at"], x["qw8"], x["wt"]))
    _bits_equal(gemm_probe_i8(_t(x["qa8"]), _kt(x["qw8"]), _t(x["at"]), _t(x["wt"]), acc="f32", tile=tile), ref)


@pytest.mark.parametrize("acc", ["i32", "f32"])
def test_probe_int8_mxu_int8_bit_for_bit(acc):
    """probe_int8_mxu's pallas_mm on int8 operands, int32 or f32 accumulator."""
    a8, w8, _, _ = _full_range_inputs(1)
    ref = np.asarray(_script("probe_int8_mxu")["pallas_mm"](a8, w8, 128, 128, 256,
                                                            jnp.int32 if acc == "i32" else jnp.float32, jnp.bfloat16))
    _bits_equal(gemm_probe_i8(_t(a8), _kt(w8), acc=acc), ref)


@pytest.mark.parametrize("tile", I8_BUILT[("i32", False)])
def test_probe_m512_kern_i8_bit_for_bit(tile):
    """probe_m512's kern_i8 (int32 accumulator) at every card tile."""
    s = _script("probe_m512")
    a8, w8, _, _ = _full_range_inputs(2)
    ref = np.asarray(s["pallas_mm"](a8, w8, 128, 256, 256, s["kern_i8"], jnp.int32))
    _bits_equal(gemm_probe_i8(_t(a8), _kt(w8), tile=tile), ref)


@pytest.mark.parametrize("tile", I8_BUILT[("i32", False)])
def test_tune_gemm_impl_kern_bit_for_bit(tile):
    """tune_gemm_impl's kern (int32 scratch accumulator) at every card tile."""
    a8, w8, _, _ = _full_range_inputs(3)
    ref = np.asarray(_script("tune_gemm_impl")["pallas_mm"](a8, w8, 256, 128, 512))
    _bits_equal(gemm_probe_i8(_t(a8), _kt(w8), tile=tile), ref)


def test_int32_to_bf16_rounds_through_f32():
    """int32 -> bf16 rounds twice (to f32, then bf16), as XLA's astype does:
    2^24 + 2^16 + 1 -> 2^24 (one rounding would give 2^24 + 2^17)."""
    target = 2 ** 24 + 2 ** 16 + 1
    assert float(jnp.int32(target).astype(jnp.bfloat16)) == 2.0 ** 24
    kk = 1152  # row 0 . column 0 = target: 1044 products of 127 * 127, then codes times 1
    a = torch.zeros((128, kk), dtype=torch.int8)
    w = torch.zeros((kk, 128), dtype=torch.int8)
    full, left = divmod(target, 127 * 127)
    a[0, :full], w[:full, 0] = 127, 127
    j = full
    while left:
        v = min(127, left)
        a[0, j], w[j, 0] = v, 1
        left, j = left - v, j + 1
    out = gemm_probe_i8(a, w, tile="chain")
    assert float(out[0, 0]) == 2.0 ** 24


def test_i32_takes_half_k_tiles():
    """The int32 mode takes K % 128 == 64 (its last K tile half zeros on the
    card): the exact product, cast through f32, at K 320."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(-127, 127, (128, 320)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 127, (320, 256)).astype(np.int8))
    exact = (a.long() @ w.long()).float().to(torch.bfloat16)
    for tile in I8_BUILT[("i32", False)]:
        assert torch.equal(gemm_probe_i8(a, w, tile=tile), exact), tile


# ---------------------------------------------------------------------------
# the bf16-operand forms: within one bf16 step
# ---------------------------------------------------------------------------

BF16_CASES = {  # bench_gemm_variants kernel -> (specs, inputs, port forms, scaled)
    "k_bf": (("S_ABF", "S_WBF"), ("abf", "wbf"), ("bf16", "bf16"), False),
    "k_v1": (("S_A", "S_W"), ("qa", "qw"), ("p4", "p4"), False),
    "k_v2": (("S_A8", "S_AS", "S_W8", "S_WS"), ("qa8", "asc", "qw8", "ws"), ("i8", "i8"), True),
    "k_v4": (("S_A", "S_AS", "S_W8", "S_WS"), ("qa", "asc", "qw8", "ws"), ("p4", "i8"), True),
    "k_v6": (("S_A", "S_AS", "S_W", "S_WS"), ("qa", "asc", "qw", "ws"), ("p4", "p4"), True),
}


@pytest.mark.parametrize("kernel", list(BF16_CASES))
def test_bench_bf16_forms_within_one_step(kernel):
    specs, names, (af, wf), scaled = BF16_CASES[kernel]
    x = _bench_inputs()
    ref = _bench(kernel, specs, *names)
    a, w = _t(x[names[0]]), _t(x[names[2 if scaled else 1]])
    sc = (_t(x[names[1]]), _t(x[names[3]])) if scaled else (None, None)
    out = gemm_probe_bf16(a, w, *sc, a_form=af, w_form=wf)
    _within_one_step(out, ref, a, w, af, wf, *sc)


def test_probe_int8_mxu_bf16_within_one_step():
    """probe_int8_mxu's pallas_mm on bf16 operands (f32 accumulator)."""
    _, _, abf, wbf = _full_range_inputs(4)
    ref = _script("probe_int8_mxu")["pallas_mm"](abf, wbf, 128, 128, 256, jnp.float32, jnp.bfloat16)
    _within_one_step(gemm_probe_bf16(_t(abf), _t(wbf)), ref, _t(abf), _t(wbf), "bf16", "bf16")


def test_probe_m512_kern_cvt_within_one_step():
    """probe_m512's kern_cvt: int8 codes cast to bf16 inside, f32 sums."""
    s = _script("probe_m512")
    a8, w8, _, _ = _full_range_inputs(5)
    ref = s["pallas_mm"](a8, w8, 128, 128, 256, s["kern_cvt"], jnp.float32)
    _within_one_step(gemm_probe_bf16(_t(a8), _t(w8), a_form="i8", w_form="i8"), ref, _t(a8), _t(w8), "i8", "i8")


# ---------------------------------------------------------------------------
# the decoded operands: bit for bit the scripts' own decode products
# ---------------------------------------------------------------------------


def _a_scales(s, asc):
    """k_v2's activation scales: the expansion product, (M, K) f32 -> bf16."""
    e = s["expand_mat"](K // 64, K).astype(jnp.bfloat16)
    return jax.lax.dot_general(asc, e, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32)


def _w_scales(ws):
    """k_v2's weight scales: each group row broadcast over its 64 rows."""
    return jnp.broadcast_to(ws[:, None, :], (K // 64, 64, N)).reshape(K, N)


@pytest.mark.parametrize("form", ["i8", "p4"])
@pytest.mark.parametrize("scaled", [False, True])
def test_decoded_activation_bit_for_bit(form, scaled):
    s, x = _script("bench_gemm_variants"), _bench_inputs()
    codes = s["unpack_l"](x["qa"]) if form == "p4" else x["qa8"]
    ref = codes.astype(jnp.bfloat16)
    if scaled:
        ref = ref * _a_scales(s, x["asc"]).astype(jnp.bfloat16)
    out = decode_operand(_t(x["qa" if form == "p4" else "qa8"]), form, _t(x["asc"]) if scaled else None, dim=1)
    _bits_equal(out, ref)


@pytest.mark.parametrize("form", ["i8", "p4"])
@pytest.mark.parametrize("scaled", [False, True])
def test_decoded_weight_bit_for_bit(form, scaled):
    s, x = _script("bench_gemm_variants"), _bench_inputs()
    codes = s["unpack_s"](x["qw"]) if form == "p4" else x["qw8"]
    ref = codes.astype(jnp.bfloat16)
    if scaled:
        ref = ref * _w_scales(x["ws"])
    out = decode_operand(_t(x["qw" if form == "p4" else "qw8"]), form, _t(x["ws"]) if scaled else None, dim=0)
    _bits_equal(out, ref)


# ---------------------------------------------------------------------------
# the wrappers: layouts and refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("acc,rank1", sorted(I8_BUILT))
def test_i8_weight_layouts_agree(acc, rank1):
    """W contiguous (K, N) and W a transposed view of an (N, K)-contiguous
    tensor give the same product."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    sc = (torch.from_numpy(rng.random(M).astype(np.float32)), torch.from_numpy(rng.random(N).astype(np.float32)))
    kw = dict(acc=acc, tile=I8_BUILT[(acc, rank1)][0])
    args = sc if rank1 else ()
    assert torch.equal(gemm_probe_i8(a, w, *args, **kw), gemm_probe_i8(a, w.t().contiguous().t(), *args, **kw))


def _i8(m=M, k=K, n=N):
    return torch.zeros((m, k), dtype=torch.int8), torch.zeros((k, n), dtype=torch.int8)


@pytest.mark.parametrize("case", ["ragged_m", "ragged_n", "ragged_k", "ragged_k_f32", "unbuilt_mode", "unknown_tile",
                                  "one_scale", "dtype", "bad_scale"])
def test_i8_refusals(case):
    a, w = _i8()
    sc = torch.ones(M), torch.ones(N)
    calls = {
        "ragged_m": lambda: gemm_probe_i8(*_i8(m=192), tile="128x128x128s4p"),
        "ragged_n": lambda: gemm_probe_i8(*_i8(n=128), tile="128x256x128s4"),
        "ragged_k": lambda: gemm_probe_i8(*_i8(k=160), tile="chain"),  # the int32 mode takes K % 64
        "ragged_k_f32": lambda: gemm_probe_i8(*_i8(k=192), acc="f32"),  # the f32 mode sums whole 128-deep K tiles
        "unbuilt_mode": lambda: gemm_probe_i8(a, w, *sc, acc="i32"),  # i32 with the rank-1 epilogue
        "unknown_tile": lambda: gemm_probe_i8(a, w, tile="512x1024x512"),
        "one_scale": lambda: gemm_probe_i8(a, w, sc[0], None, acc="f32"),
        "dtype": lambda: gemm_probe_i8(a.float(), w),
        "bad_scale": lambda: gemm_probe_i8(a, w, torch.ones(M + 1), sc[1], acc="f32"),
    }
    with pytest.raises(ValueError):
        calls[case]()


@pytest.mark.parametrize("case", ["unbuilt_form", "packed_k", "ragged_m", "w_layout", "scale_shape", "dtype"])
def test_bf16_refusals(case):
    bf = torch.zeros((M, K), dtype=torch.bfloat16), torch.zeros((K, N), dtype=torch.bfloat16)
    calls = {
        "unbuilt_form": lambda: gemm_probe_bf16(bf[0], torch.zeros((K, N), dtype=torch.int8), w_form="i8"),
        "packed_k": lambda: gemm_probe_bf16(torch.zeros((M, 64), dtype=torch.int8),
                                            torch.zeros((64, N), dtype=torch.int8), a_form="p4", w_form="p4"),
        "ragged_m": lambda: gemm_probe_bf16(torch.zeros((M - 64, K), dtype=torch.bfloat16), bf[1]),
        "w_layout": lambda: gemm_probe_bf16(bf[0], bf[1].t().contiguous().t()),  # K-contiguous: the kernel reads W N-contiguous
        "scale_shape": lambda: gemm_probe_bf16(torch.zeros((M, K), dtype=torch.int8),
                                               torch.zeros((K, N), dtype=torch.int8),
                                               torch.ones((K // 64, M), dtype=torch.bfloat16),
                                               torch.ones((K // 32, N), dtype=torch.bfloat16), a_form="i8",
                                               w_form="i8"),
        "dtype": lambda: gemm_probe_bf16(bf[0].float(), bf[1]),
    }
    with pytest.raises(ValueError):
        calls[case]()


def test_every_built_form_has_a_count():
    c = launch_counts()
    for (acc, rank1), tiles in I8_BUILT.items():
        for tile in tiles:
            assert f"gemm_probe_i8_{acc}_{'rank1' if rank1 else 'cast'}@{tile}" in c
    for a_form, w_form, scaled in BF16_FORMS:
        assert f"gemm_probe_bf16_{a_form}_{w_form}{'_scaled' if scaled else ''}" in c
    assert set(I8_TILES) == set(I8_BUILT[("i32", False)])


# ---------------------------------------------------------------------------
# the ported tools at tiny sizes on the CPU: a row per JAX variant, no launch
# ---------------------------------------------------------------------------


def _jax_timed_names(name):
    """The names bench_gemm_variants.py passes to timed(...), in order."""
    tree = ast.parse((TOOLS / f"{name}.py").read_text())
    return [n.value.args[0].value for n in tree.body
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call) and getattr(n.value.func, "id", "") == "timed"]


def test_tool_bench_gemm_variants_cpu():
    reset_launch_counts()
    lines = []
    rows = bench_gemm_variants.run("cpu", 256, 512, 256, iters=1, log=lines.append)
    names = [r["name"] for r in rows]
    assert names[:8] == _jax_timed_names("bench_gemm_variants")
    assert names[8:] == [f"V7 {t}" for t in I8_BUILT[("f32", True)]]  # v7_with's sweep over the card tiles
    assert len(lines) == len(rows) and all(r["ms"] > 0 and r["of_bound"] is None for r in rows)
    assert not any(launch_counts().values())


def test_tool_probe_int8_mxu_cpu():
    reset_launch_counts()
    lines = []
    rows = probe_int8_mxu.run("cpu", 256, 256, 256, iters=1, log=lines.append)
    letters = [r["name"].split(" ")[0] for r in rows]
    assert letters == ["A.", "B.", "C.", "D.", "E.", "E2."] + ["F."] * len(I8_BUILT[("i32", False)])
    d = rows[3]
    assert d["ms"] is None and "not expressible on this card" in d["note"] and "not expressible" in lines[3]
    assert not any(launch_counts().values())


def test_tool_probe_m512_cpu():
    reset_launch_counts()
    rows = probe_m512.run("cpu", 256, 256, 256, layers=2, iters=1, log=lambda _: None)
    names = [r["name"] for r in rows]
    assert names[:2] == ["xla-i8", "xla-bf16"] and names[-2:] == ["pl-cvt-128.128.64", "pl-i8-f32acc-128.128.64"]
    assert len(names) == 4 + len(I8_BUILT[("i32", False)])
    some = probe_m512.run("cpu", 256, 256, 256, layers=2, iters=1, names=["pl-i8-chain"], log=lambda _: None)
    assert [r["name"] for r in some] == ["pl-i8-chain"]
    assert not any(launch_counts().values())


def test_tool_tune_gemm_impl_cpu():
    reset_launch_counts()
    lines = []
    rows = tune_gemm_impl.run("cpu", shapes=[(256, 256, 256), (512, 256, 512)], iters=1, ch=2, log=lines.append)
    per = 1 + len(I8_BUILT[("i32", False)])
    assert len(rows) == 2 * per and len(lines) == 2
    assert lines[0].startswith("(256,256,256): best=") and "xla=" in lines[0] and "pl chain=" in lines[0]
    assert len(tune_gemm_impl.SHAPES) == 13 and tune_gemm_impl.CH == 4
    assert not any(launch_counts().values())
