"""Card tests: each Hopper kernel of nunchaku_tpu_torch against its plain
PyTorch twin on the GPU, at FLUX.1-dev and Qwen-Image main-path shapes (f32
and bf16-stream configurations) and at ragged ones, and small models on the
card against the CPU.

They need an NVIDIA GPU and nvcc, and skip elsewhere (decided inside a
fixture, so every worker collects the same tests). This file imports no
JAX; on the card, run it without the JAX-side conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import copy

import pytest
import torch

from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
from nunchaku_tpu_torch.models.transformer_qwenimage import QwenImageConfig, QwenImageTransformer2DModel
from nunchaku_tpu_torch.ops import checks, gemm_probe, launch_counts, reset_launch_counts
from nunchaku_tpu_torch.pipeline.pipeline_flux import make_img_ids
from nunchaku_tpu_torch.ops.attention import (block_sparse_attention, flash_attention, flash_attention_denom,
                                              flash_attention_denom_plain, flash_attention_online, quantize_qk)
from nunchaku_tpu_torch.ops.gemm import (dequant_w4a8, gemm_w4a4, gemm_w4a8, gemm_w4a8_grouped, gemm_w8a8_grouped,
                                         gemm_w8a8_rank1, svdq_gemm_w4a4, svdq_gemm_w4a8_gelu_quant,
                                         svdq_gemm_w8a8_gelu_quant)
from nunchaku_tpu_torch.ops.gemv import awq_w4a16_linear

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.parametrize("k,n", [(3072, 12288), (12288, 3072), (256, 128)])
def test_dequant_w4a8_exact(dev, k, n):
    _, ok, detail = checks.check_dequant(*checks.dequant_case(k, n, device=dev))
    assert ok, detail


@pytest.mark.parametrize("k,n", [(3072, 12288), (12288, 3072), (256, 64), (768, 320), (1280, 192)])
def test_dequant_w4a8_e2m1_exact(dev, k, n):
    """The e2m1 form at FLUX's shapes and at odd tile counts (K / 256 and
    N / 64 of 1, 3, 5)."""
    reset_launch_counts()
    _, ok, detail = checks.check_dequant(*checks.dequant_case(k, n, codes="e2m1", device=dev), codes="e2m1")
    assert ok, detail
    c = launch_counts()
    assert c["dequant_w4a8_e2m1"] == 1 and c["dequant_w4a8"] == 0


# the dequant's edges: one unit (K 256) of half a column tile (N 64), N that its 128-column units do not divide
# (N % 128 == 64), SANA's padded fc widths (K 2304, N 6784); both code forms (FLUX's shapes: the tests above)
DEQUANT_EDGES = [(256, 64), (768, 192), (2304, 6784), (512, 4160)]


@pytest.mark.parametrize("codes", ["int4", "e2m1"])
@pytest.mark.parametrize("k,n", DEQUANT_EDGES)
def test_dequant_w4a8_edges(dev, k, n, codes):
    qw, rs = checks.dequant_case(k, n, codes=codes, device=dev)
    _, ok, detail = checks.check_dequant(qw, rs, codes)
    assert ok, detail
    out = dequant_w4a8(qw, rs, codes)
    assert out.shape == (k, n) and out.stride() == (1, k) and out.dtype == torch.int8


@pytest.mark.parametrize("codes", ["int4", "e2m1"])
def test_dequant_w4a8_rescale_range(dev, codes):
    """Exact over rescales of either sign from 2^-20 to 2^12 and zeros: products far past +-127 clip, ties
    round to even, and codes c and -c take the same magnitude."""
    k, n = 1024, 384
    g = torch.Generator(device=dev).manual_seed(5)
    qw = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device=dev, generator=g)
    shape = (k // (64 if codes == "int4" else 16), n)
    mag = torch.exp2(torch.rand(shape, device=dev, generator=g) * 32.0 - 20.0)
    sign = torch.where(torch.rand(shape, device=dev, generator=g) < 0.5, -1.0, 1.0)
    rs = (mag * sign).to(torch.bfloat16)
    rs[:, ::17] = 0.0
    rs[0, :64] = torch.tensor([0.5, 1.5, 2.5, 0.25, 0.75, 1.25] * 10 + [15.875, 16.0, 127.0 / 8, 254.0],
                              device=dev).to(torch.bfloat16)
    _, ok, detail = checks.check_dequant(qw, rs, codes)
    assert ok, detail


@pytest.mark.parametrize("codes", ["int4", "e2m1"])
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("k,n", [(3840, 11520), (256, 64), (768, 192)])
def test_dequant_w4a8_stacked_edges(dev, k, n, codes, layers):
    """Stacks of one and three layers, the index read on the card: every layer the non-stacked kernel's
    codes, the last one the plain version's."""
    reset_launch_counts()
    _, ok, detail = checks.check_dequant_stacked(*checks.dequant_case(k, n, codes=codes, device=dev), codes, layers)
    assert ok, detail
    c = launch_counts()
    name = "dequant_w4a8_e2m1" if codes == "e2m1" else "dequant_w4a8"
    assert c[name + "_stacked"] == layers + 1 and c[name] == layers, c


def _ptxas_alone(src, tmp_path):
    """nvcc's -Xptxas -v output for one source of csrc built alone; fails on a build error."""
    import subprocess

    from nunchaku_tpu_torch.ops import _build

    out = subprocess.run([_build._nvcc(), *_build.FLAGS, "-c", str(_build.CSRC / src), "-o", str(tmp_path / "k.o")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout + out.stderr


def _spills_and_losses(text):
    import re

    spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", text)]
    return spills, re.findall(r"\((C75\d\d)\) Potential Performance Loss", text)


def test_dequant_sass(dev, tmp_path):
    """The dequant's two kernels (int4 and e2m1 codes): no spill, no type conversion anywhere in them (I2F,
    F2I: the tables round by an f32 addition, units are split without an integer division), and TMA both
    ways (UTMALDG, UTMASTG)."""
    from nunchaku_tpu_torch.ops import _build

    spills, losses = _spills_and_losses(_ptxas_alone("dequant_w4a8.cu", tmp_path))
    assert spills and not any(spills) and not losses, (spills, losses)
    path = _build.build()
    sass = _build.sass_counts(path, opcodes=("I2F", "F2I", "UTMALDG", "UTMASTG"))
    res = _build.resource_usage(path)
    deq = [n for n in sass if "dequant_w4a8_kernel<" in n]
    assert len(deq) == 2, deq
    for name in deq:
        c = sass[name]
        assert c["I2F"] == 0 and c["F2I"] == 0 and c["UTMALDG"] > 0 and c["UTMASTG"] > 0, (name, c)
        assert res[name]["STACK"] == 0 and res[name]["LOCAL"] == 0, (name, res[name])


def test_dequant_w4a8_e2m1_refusals(dev):
    qw, rs = checks.dequant_case(512, 128, codes="e2m1", device=dev)
    with pytest.raises(ValueError):
        dequant_w4a8(qw, rs)  # group-16 rescales under int4 codes
    with pytest.raises(ValueError):
        dequant_w4a8(qw, rs, "fp8")


@pytest.mark.parametrize("r", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("m,k,n,unsigned", [(4608, 3072, 12288, False), (256, 256, 3072, True)])
def test_gelu_quant_ranks(dev, r, m, k, n, unsigned):
    _, ok, detail = checks.check_gelu_quant(*checks.gelu_quant_case(m, k, n, r, device=dev),
                                            act_unsigned_next=unsigned)
    assert ok, detail


@pytest.mark.parametrize("r", [16, 32, 64, 128])
@pytest.mark.parametrize("m,k,n,groups", [(4608, 12288, 3072, 8), (256, 3072, 256, 2)])
def test_grouped_ranks(dev, r, m, k, n, groups):
    _, ok, detail = checks.check_grouped(*checks.grouped_case(m, k, n, groups, r, device=dev))
    assert ok, detail
    _, ok, detail = checks.check_grouped_res(*checks.grouped_res_case(m, k, n, groups, r, device=dev))
    assert ok, detail


@pytest.mark.parametrize("r", [160, 256])
def test_chain_rank_refusal(dev, r):
    """Ranks above 128, which the chain kernels refused before they ran the
    rank term in chunks of 128: the producer (grouped and per-token scales)
    and the consumer (grouped, rank-1, with the residual's extra rank at R
    too) within their bounds of the twins."""
    args = checks.gelu_quant_case(512, 3072, 3072, r, device=dev)
    _, ok, detail = checks.check_gelu_quant(*args)
    assert ok, detail
    _, ok, detail = checks.check_ptoken(*args)
    assert ok, detail
    _, ok, detail = checks.check_grouped(*checks.grouped_case(512, 3072, 3072, 2, r, device=dev))
    assert ok, detail
    _, ok, detail = checks.check_grouped_res(*checks.grouped_res_case(512, 3072, 3072, 2, r, device=dev))
    assert ok, detail
    _, ok, detail = checks.check_rank1(*checks.grouped_res_case(512, 3072, 3072, 1, r, device=dev))
    assert ok, detail


@pytest.mark.parametrize("kind", checks.CHUNK_KINDS)
def test_rank_chunk_boundary(dev, kind):
    """Every kernel that runs its rank term in chunks of 128: rank 128 (one
    chunk) bit for bit the same launch with the low-rank operands
    zero-padded to 256 (a second chunk of zeros)."""
    m, k, n = (4608, 3072, 3072) if kind.startswith("ln") else (512, 3072, 3072)
    _, ok, detail = checks.check_chunk_boundary(checks.chunk_case(kind, m, k, n, device=dev))
    assert ok, detail


@pytest.mark.parametrize("m,k,n,unsigned", [(4096, 3072, 9216, False), (4096, 12288, 3072, True), (256, 3072, 12288, False)])
def test_gemm_w4a4_rank128(dev, m, k, n, unsigned):
    """Qwen-Image's shapes from a rank-128 checkpoint (int4)."""
    args, kw = checks.w4a4_case(m, k, n, "int4", unsigned, r=128, device=dev)
    _, ok, detail = checks.check_w4a4(args, kw)
    assert ok, detail


@pytest.mark.parametrize("m,k,n,unsigned", [
    (512, 3072, 12288, False),
    (4608, 3072, 12288, False),
    (256, 256, 3072, True),
])
def test_gelu_quant(dev, m, k, n, unsigned):
    _, ok, detail = checks.check_gelu_quant(*checks.gelu_quant_case(m, k, n, device=dev),
                                            act_unsigned_next=unsigned)
    assert ok, detail


@pytest.mark.parametrize("m,k,n,groups", [(512, 12288, 3072, 8), (4608, 12288, 3072, 8), (256, 3072, 256, 2)])
def test_grouped(dev, m, k, n, groups):
    _, ok, detail = checks.check_grouped(*checks.grouped_case(m, k, n, groups, device=dev))
    assert ok, detail


@pytest.mark.parametrize("b,h,sq,skv", [(1, 24, 4608, 4608), (2, 2, 200, 333), (1, 3, 77, 65)])
def test_flash(dev, b, h, sq, skv):
    _, ok, detail = checks.check_flash(*checks.flash_case(b, h, sq, skv, device=dev))
    assert ok, detail


FIXED_FORM_SHAPES = [(1, 24, 4608, 4608), (2, 2, 200, 333), (1, 3, 77, 65), (1, 2, 100, 129)]
# the Hopper attention core's ragged shapes: Skv 77, 300 and 4307 (one, three and 34 kv tiles, each with a ragged
# last one), Sq off the 128-row tile, B 2
CORE_RAGGED = [(2, 3, 200, 77), (2, 2, 300, 300), (1, 2, 4307, 4307), (2, 2, 130, 4307)]


@pytest.mark.parametrize("b,h,sq,skv", FIXED_FORM_SHAPES + [(1, 24, 16896, 16896)])
def test_flash_denom(dev, b, h, sq, skv):
    """The denominator form at FLUX's 1024px and 2048px joint sequences and
    ragged ones: o within 1e-2, l within 1e-5 relative of the plain twin, o
    bit for bit the one-tile kernel's; one flash_fixed_denom launch."""
    q, k, v = checks.flash_case(b, h, sq, skv, device=dev)
    reset_launch_counts()
    o, _ = flash_attention_denom(q, k, v, scale=1.0)
    assert launch_counts()["flash_fixed_denom"] == 1 and launch_counts()["flash_fixed"] == 0
    _, ok, detail = checks.check_flash_denom(q, k, v)
    assert ok, detail


def test_flash_denom_scaled(dev):
    """``scale`` None (1/sqrt(D) on an unscaled q) against the twin; the
    kv mask and the (B, S, H*D) output refused."""
    q, k, v = checks.flash_online_case(2, 2, 200, 333, 128, device=dev)
    o, l = flash_attention_denom(q, k, v)
    ro, rl = flash_attention_denom_plain(q, k, v)
    assert (o.float() - ro.float()).abs().max() <= 1e-2 * ro.float().abs().max()
    assert ((l - rl).abs().max() / rl.abs().max()).item() <= 1e-5
    with pytest.raises(ValueError):
        flash_attention_denom(q, k, v, kv_mask=torch.ones((2, 333), dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):
        flash_attention_denom(q, k, v, out_bshd=True)


@pytest.mark.parametrize("b,h,sq,skv", FIXED_FORM_SHAPES)
def test_flash_unroll2(dev, b, h, sq, skv):
    """The two-tile form (Skv 65, 129, 333: the last step's second tile cut
    or empty); ``flash_attention(kv_unroll=2)`` takes it without a mask and
    the masked one-tile kernel with one."""
    q, k, v = checks.flash_case(b, h, sq, skv, device=dev)
    _, ok, detail = checks.check_flash_unroll2(q, k, v)
    assert ok, detail
    reset_launch_counts()
    flash_attention(q, k, v, kv_unroll=2)
    flash_attention(q, k, v, torch.ones((b, skv), dtype=torch.bool, device=dev), kv_unroll=2)
    c = launch_counts()
    assert c["flash_fixed_unroll2"] == 1 and c["flash_fixed_masked"] == 1 and c["flash_fixed"] == 0


@pytest.mark.parametrize("out_bshd", [True, False], ids=["bshd", "bhsd"])
@pytest.mark.parametrize("b,h,sq,skv", FIXED_FORM_SHAPES + CORE_RAGGED)
def test_flash_i8(dev, b, h, sq, skv, out_bshd):
    """The int8 form of the attention core against its twin, FLUX's shape
    and the core's ragged ones, in both output layouts; one launch."""
    case = checks.flash_i8_case(b, h, sq, skv, device=dev)
    reset_launch_counts()
    _, ok, detail = checks.check_flash_i8(*case, out_bshd=out_bshd)
    assert ok, detail
    assert launch_counts()["flash_fixed_i8"] == 1


def test_sm90_sass_and_spills(dev):
    """In the built library: the int8 attention form holds IGMMA (q . k),
    HGMMA (p . v) and UTMALDG; each of the bf16 GEMM probe's instantiations
    of the GEMM main loop (gemm_sm90.cuh: its sources TmaBf16 and Decoded)
    holds HGMMA and UTMALDG; its s8 instantiations, the int8 chain
    producer's and the grouped consumer's (with and without the residual
    epilogue), the int8 GEMM probe's (ProbeEpi, one per built mode and tile;
    its persistent form probe_i8_persistent_kernel too), and the two of its
    warpgroup-0 decoding form (gemm_w4_kernel: the packed GEMM and the W4
    producer), hold IGMMA and UTMALDG; each
    instantiation of the W4A4 GEMM
    (gemm_w4a4.cu: three modes, each without a rank-r term, at R <= 32 and
    at R <= 128) holds HGMMA (its register-A products) and UTMALDG; each
    instantiation of the qkv / RoPE producer (qkv_rope_producer.cu: 0 low-rank
    k steps, also the prepare form; 2; 8) holds UTMALDG, the two with a
    low-rank term HGMMA; none of them spills (cuobjdump -res-usage: STACK and
    LOCAL 0)."""
    from nunchaku_tpu_torch.ops import _build

    path = _build.build()
    sass, res = _build.sass_counts(path), _build.resource_usage(path)
    i8 = [n for n in sass if "flash_sm90_kernel<0, 128, 6>" in n.replace("(int)", "")]
    gemm = [n for n in sass if "gemm_sm90_kernel<" in n and "gemm90::Bf16" in n
            and ("::TmaBf16<" in n or "::Decoded<" in n)]
    s8 = [n for n in sass if "gemm_sm90_kernel<" in n and "gemm90::S8" in n]
    chain = [n for n in s8 if "ProbeEpi<" not in n]
    probe = [n for n in s8 if "ProbeEpi<" in n] + [n for n in sass if "probe_i8_persistent_kernel<" in n]
    w4a4 = [n for n in sass if "gemm_w4a4_kernel<" in n]
    packed = [n for n in sass if "gemm_w4_kernel<" in n]
    assert len(i8) == 1 and len(gemm) == len(gemm_probe.BF16_FORMS), (i8, gemm)
    assert len(chain) == 3 and sum("GeluEpi" in n for n in chain) == 1, chain
    assert sum("GroupedEpi<" in n for n in chain) == 2, chain
    assert len(packed) == 2 and sum("GeluEpi" in n for n in packed) == 1, packed
    assert len(probe) == sum(len(tiles) for tiles in gemm_probe.I8_BUILT.values()), probe
    assert len(w4a4) == 9, w4a4
    qkv = {s: [n for n in sass if f"qkv_rope_kernel<{s}>" in n.replace("(int)", "")] for s in (0, 2, 8)}
    assert all(len(found) == 1 for found in qkv.values()), qkv
    qkv = {s: found[0] for s, found in qkv.items()}
    assert all(sass[i8[0]][op] > 0 for op in ("IGMMA", "HGMMA", "UTMALDG")), sass[i8[0]]
    for name in gemm + w4a4:
        assert sass[name]["HGMMA"] > 0 and sass[name]["UTMALDG"] > 0, (name, sass[name])
    for name in chain + packed + probe:
        assert sass[name]["IGMMA"] > 0 and sass[name]["UTMALDG"] > 0, (name, sass[name])
    for steps, name in qkv.items():  # the qkv / RoPE producer: TMA-fed x tiles, the low-rank product on wgmma
        assert sass[name]["UTMALDG"] > 0 and (steps == 0 or sass[name]["HGMMA"] > 0), (name, sass[name])
    for name in i8 + gemm + chain + probe + w4a4 + packed + list(qkv.values()):
        assert res[name]["STACK"] == 0 and res[name]["LOCAL"] == 0, (name, res[name])


# K = 64 (mod 128): the s8 main loop's K tiles are 128 bytes, so the last one (of K, or of each K / G group)
# reads zeros past its end
K_TAIL_PRODUCER = [(256, 192, 1536, 32), (128, 3136, 3072, 128), (128, 64, 256, 16)]
K_TAIL_CONSUMER = [(256, 192, 256, 1), (128, 3136, 384, 1), (256, 384, 256, 2), (128, 1344, 256, 7),
                   (256, 1536, 384, 8), (128, 128, 128, 2)]


@pytest.mark.parametrize("m,k,n,r", K_TAIL_PRODUCER)
def test_gelu_quant_k_tail(dev, m, k, n, r):
    """The producer (grouped and per-token scales) at a K the s8 loop ends
    on a half tile."""
    args = checks.gelu_quant_case(m, k, n, r, device=dev)
    _, ok, detail = checks.check_gelu_quant(*args)
    assert ok, detail
    _, ok, detail = checks.check_ptoken(*args)
    assert ok, detail


@pytest.mark.parametrize("m,k,n,groups", K_TAIL_CONSUMER)
def test_grouped_k_tail(dev, m, k, n, groups):
    """The consumer, grouped (K / G = 64 mod 128: every group ends on a
    half tile) or rank-1 (G = 1), with and without the residual epilogue."""
    if groups == 1:
        _, ok, detail = checks.check_rank1(*checks.grouped_case(m, k, n, 1, device=dev))
        assert ok, detail
        _, ok, detail = checks.check_rank1(*checks.grouped_res_case(m, k, n, 1, device=dev))
        assert ok, detail
        return
    _, ok, detail = checks.check_grouped(*checks.grouped_case(m, k, n, groups, device=dev))
    assert ok, detail
    _, ok, detail = checks.check_grouped_res(*checks.grouped_res_case(m, k, n, groups, device=dev))
    assert ok, detail


@pytest.mark.parametrize("mode", checks.STACKED_CHAIN_MODES[:6])
def test_chain_stacked_k_tail(dev, mode):
    """The int8 chain's stacked modes at K = 64 (mod 128) (the consumers' K
    groups too): every layer bit for bit its non-stacked kernel."""
    producer = "gelu_quant" in mode
    m, k, n = (128, 320, 1536) if producer else (128, 1344, 384)
    run, w, check, _ = checks.chain_stacked_case(mode, m, k, n, device=dev)
    _, ok, detail = checks.check_stacked(run, w, check)
    assert ok, detail


def test_quantize_qk_card_equals_cpu(dev):
    """quantize_qk's codes and scales on the card bit for bit the CPU's."""
    q, k, _ = checks.flash_case(1, 4, 300, 300, device=dev)
    for a, b in zip(quantize_qk(q, k), quantize_qk(q.cpu(), k.cpu())):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("b,h,s,n", [(1, 24, 16896, 4), (1, 2, 1000, 4), (2, 2, 384, 3)])
def test_ring_shards(dev, b, h, s, n):
    """The ring's arithmetic in one process (the denominator kernel on n kv
    shards, parallel.sp's combine) against the dense kernel."""
    _, ok, detail = checks.check_ring_shards(*checks.ring_case(b, h, s, device=dev), n)
    assert ok, detail


@pytest.mark.parametrize("b,h,sq,skv,d", [(1, 1, 4096, 4096, 512), (1, 1, 16384, 16384, 512),
                                          (1, 1, 300, 300, 512), (2, 2, 77, 333, 512),
                                          (1, 2, 200, 130, 128), (1, 1, 65, 97, 256),
                                          # SDXL at 1024px: level 1 self / cross, level 2 self / cross
                                          (1, 10, 4096, 4096, 64), (1, 10, 4096, 77, 64),
                                          (1, 20, 1024, 1024, 64), (1, 20, 1024, 77, 64),
                                          (2, 3, 300, 77, 64), (1, 2, 65, 33, 64),
                                          # SANA at 1024px: cross-attention under CFG (B 2) and PAG (B 3)
                                          (2, 20, 1024, 300, 112), (3, 20, 1024, 300, 112),
                                          (1, 2, 100, 33, 112), (1, 1, 64, 32, 112)])
def test_flash_online(dev, b, h, sq, skv, d):
    _, ok, detail = checks.check_flash_online(*checks.flash_online_case(b, h, sq, skv, d, device=dev))
    assert ok, detail


@pytest.mark.parametrize("out_bshd", [False, True], ids=["bhsd", "bshd"])
@pytest.mark.parametrize("s", [64, 100, 1000, 4096, 16384])
@pytest.mark.parametrize("d", [256, 512])
def test_flash_online_wide(dev, d, s, out_bshd):
    """The wide kernel (D 256 / 512) at one head, square S, both layouts."""
    _, ok, detail = checks.check_flash_online(*checks.flash_online_case(1, 1, s, s, d, device=dev), out_bshd=out_bshd)
    assert ok, detail


# (B, H, Sq, Skv, D, kv splits): one kv tile; an odd tile count cut 1 + 2; four ranges over 5 tiles; the query
# blocks too many to split; 65 / 66 / 67 query blocks at a tile's S (2, 2, 1 splits); B and H > 1 split
WIDE_SPLITS = [(1, 1, 64, 64, 512, 1), (1, 1, 64, 130, 512, 2), (1, 1, 200, 300, 256, 4), (2, 3, 1000, 77, 512, 1),
               (1, 1, 4160, 4096, 512, 2), (1, 1, 4224, 4096, 256, 2), (1, 1, 4288, 4096, 512, 1),
               (2, 2, 300, 1000, 512, 4)]


@pytest.mark.parametrize("b,h,sq,skv,d,splits", WIDE_SPLITS)
def test_flash_online_wide_splits(dev, b, h, sq, skv, d, splits):
    """The kv-split edges of the wide kernel: the twin merges the same
    ranges, so each shape checks the cluster merge at that split count."""
    from nunchaku_tpu_torch.ops.attention import online_splits

    assert online_splits(b, h, sq, skv, d) == splits
    for out_bshd in (False, True):
        _, ok, detail = checks.check_flash_online(*checks.flash_online_case(b, h, sq, skv, d, device=dev),
                                                  out_bshd=out_bshd)
        assert ok, detail


def test_flash_online_wide_sass(dev):
    """The wide kernel's instantiations hold HGMMA and UTMALDG and do not
    spill."""
    from nunchaku_tpu_torch.ops import _build

    path = _build.build()
    sass, res = _build.sass_counts(path), _build.resource_usage(path)
    wide = [n for n in sass if "flash_wide_kernel<" in n]
    assert len(wide) == 2, wide
    for name in wide:
        assert sass[name]["HGMMA"] > 0 and sass[name]["UTMALDG"] > 0, (name, sass[name])
        assert res[name]["STACK"] == 0 and res[name]["LOCAL"] == 0, (name, res[name])


def test_wide_flash_and_gemv_one_kernel_a_call(dev):
    """One device kernel a call of each (the wide kernel's kv merge and the
    GEMV's K reduction inside it: no second kernel), as the profiler lists
    them in one session, and one count each."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = checks.flash_online_case(1, 1, 4096, 4096, 512, device=dev)
    args = checks.awq_case(2, 3072, 18432, device=dev)
    flash_attention_online(q, k, v)
    awq_w4a16_linear(*args)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        flash_attention_online(q, k, v)
        awq_w4a16_linear(*args)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2 and "flash_wide_kernel" in kernels[0] and "gemv_awq_kernel" in kernels[1], kernels
    assert launch_counts()["flash_online"] == 1 and launch_counts()["gemv_awq"] == 1


def test_flash_online_counts_and_refusals(dev):
    reset_launch_counts()
    q, k, v = checks.flash_online_case(1, 1, 100, 100, 512, device=dev)
    flash_attention_online(q, k, v)
    assert launch_counts()["flash_online"] == 1
    for bad in (q.float(), q[..., :384].contiguous()):  # not bf16; a head dim not built
        with pytest.raises(ValueError):
            flash_attention_online(bad, bad.to(torch.bfloat16), bad.to(torch.bfloat16))
    assert launch_counts()["flash_online"] == 1


def test_flash_online_d64_counts_and_refusals(dev):
    """Head dim 64 counts as ``flash_online_d64``; its (B, S, H*D) form
    equals the (B, H, S, D) one; the mask form is not built at 64."""
    reset_launch_counts()
    q, k, v = checks.flash_online_case(1, 4, 256, 77, 64, device=dev)
    out = flash_attention_online(q, k, v)
    bshd = flash_attention_online(q, k, v, out_bshd=True)
    assert torch.equal(bshd, out.transpose(1, 2).reshape(1, 256, 4 * 64))
    assert launch_counts()["flash_online_d64"] == 2 and launch_counts()["flash_online"] == 0
    with pytest.raises(ValueError):
        flash_attention_online(q, k, v, kv_mask=torch.ones((1, 77), dtype=torch.bool, device=dev))
    assert launch_counts()["flash_online_d64"] == 2 and launch_counts()["flash_online_masked"] == 0


def test_flash_online_d112_counts_and_refusals(dev):
    """Head dim 112 (its warp halves 64 + 48) counts as ``flash_online_d112``;
    its (B, S, H*D) form equals the (B, H, S, D) one; the mask form is not
    built at 112."""
    reset_launch_counts()
    q, k, v = checks.flash_online_case(2, 3, 130, 300, 112, device=dev)
    out = flash_attention_online(q, k, v)
    bshd = flash_attention_online(q, k, v, out_bshd=True)
    assert torch.equal(bshd, out.transpose(1, 2).reshape(2, 130, 3 * 112))
    c = launch_counts()
    assert c["flash_online_d112"] == 2 and c["flash_online"] == c["flash_online_d64"] == 0
    with pytest.raises(ValueError):
        flash_attention_online(q, k, v, kv_mask=torch.ones((2, 300), dtype=torch.bool, device=dev))
    assert launch_counts()["flash_online_d112"] == 2 and launch_counts()["flash_online_masked"] == 0


@pytest.mark.parametrize("precision,tol", [("int4", 1e-1), ("int8", 3e-2)])
def test_sdxl_small_unet_matches_cpu(dev, precision, tol):
    """The TINY SDXL UNet of the CPU tests (11 transformer blocks at widths
    256 / 512, head dim 64) on the card against the plain twins on the CPU,
    within the bounds the CPU tests hold it to against JAX (twice the
    spread of the JAX package's own two GEMM routes: a 4-bit code flips
    where an input sits a bf16 step apart); every attention took the D-64
    kernel and, at int4, every SVDQ linear the W4A4 kernel."""
    from nunchaku_tpu_torch import SDXLConfig, SDXLUNet2DConditionModel

    cfg = SDXLConfig(block_out_channels=(128, 256, 512), layers_per_block=1, transformer_layers=(0, 1, 2),
                     cross_attention_dim=256, projection_class_embeddings_input_dim=256 + 6 * 32,
                     addition_time_embed_dim=32, precision=precision)
    cpu_model = SDXLUNet2DConditionModel.random_init(cfg, seed=9, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(10)
    args = (torch.randn((1, 4, 32, 32), generator=gen).to(torch.bfloat16), torch.tensor([500.0]),
            torch.randn((1, 77, 256), generator=gen).to(torch.bfloat16),
            torch.randn((1, 256), generator=gen).to(torch.bfloat16), torch.full((1, 6), 512.0))
    reset_launch_counts()
    with torch.no_grad():
        ref = cpu_model(*args).float()
        out = gpu_model(*[a.to(dev) for a in args]).float().cpu()
    counts = launch_counts()
    assert counts["flash_online_d64"] == 22 and counts["gemm_w4a4_int4"] == (66 if precision == "int4" else 0)
    assert bool(torch.isfinite(out).all()) and ((out - ref).abs().max() / ref.abs().max()).item() <= tol


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("b,h,s,sparsity,bq,bkv,out_bshd", [
    (1, 24, 16896, 0.5, 768, 1536, True),  # FLUX.1-dev 2048px: 5 of 11 kv blocks
    (1, 4, 9728, 0.5, 768, 1536, False),  # 1536px: a ragged tail block (512 of 1536)
    (2, 3, 1000, 0.7, 256, 384, True),  # ragged q and kv, 1 of 3 kv blocks (kk 1)
    (1, 2, 700, 0.0, 128, 256, False),  # every block selected
])
def test_block_sparse(dev, fixed, b, h, s, sparsity, bq, bkv, out_bshd):
    q, k, v, idx, bq, bkv = checks.block_sparse_case(b, h, s, sparsity, bq=bq, bkv=bkv, device=dev)
    _, ok, detail = checks.check_block_sparse(q, k, v, idx, bq, bkv, fixed, out_bshd)
    assert ok, detail


def test_block_sparse_tail_block_selected_and_refusals(dev):
    """Every query block takes the ragged tail block (ids given): within
    the twin's tolerance; counts per form; a head dim other than 128, a
    non-int32 or misshapen block_idx and a bq off the 128 grid raise."""
    q, k, v, idx, bq, bkv = checks.block_sparse_case(1, 2, 1664, 0.5, device=dev)  # kk 1 of 2 blocks
    tail = torch.full_like(idx, 1)  # block 1: columns 1536-1663 of 3072
    reset_launch_counts()
    for fixed in (True, False):
        _, ok, detail = checks.check_block_sparse(q, k, v, tail, bq, bkv, fixed)
        assert ok, detail
    counts = launch_counts()
    assert counts["bs_fixed"] == 2 and counts["bs_online"] == 2 and counts["flash_fixed"] == 1
    d64 = [t[..., :64].contiguous() for t in (q, k, v)]
    for over in (dict(qkv=d64), dict(block_idx=idx.long()), dict(block_idx=idx[:, :, :1]), dict(bq=700)):
        kw = dict(qkv=(q, k, v), block_idx=idx, bq=bq, bkv=bkv) | over
        with pytest.raises(ValueError):
            block_sparse_attention(*kw.pop("qkv"), sparsity_ratio=0.5, scale=1.0, fixed_softmax=True, **kw)
    assert launch_counts()["bs_fixed"] == 2


def test_small_flux_blocksparse_matches_cpu(dev):
    """A 1 + 1-block w4a8 model under set_attention_impl("blocksparse",
    0.5) at S_img 1600 + S_txt 64 (2 kv blocks of 1536, a ragged tail of
    128; 3 query blocks of 768): card against CPU within 2e-2 of the
    reference's max |value|, 2 block-sparse launches a forward."""
    cfg = FluxConfig(num_layers=1, num_single_layers=1, num_attention_heads=2, joint_attention_dim=512,
                     pooled_projection_dim=256, precision="w4a8")
    cpu_model = FluxTransformer2DModel.random_init(cfg, seed=9, device="cpu").set_attention_impl(
        "blocksparse", sparsity_ratio=0.5)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(10)
    args = (torch.randn((1, 1600, 64), generator=gen).to(torch.bfloat16),
            torch.randn((1, 64, 512), generator=gen).to(torch.bfloat16),
            torch.randn((1, 256), generator=gen).to(torch.bfloat16), torch.tensor([0.6]), make_img_ids(40, 40),
            torch.zeros((64, 3), dtype=torch.int32), torch.tensor([3.5]))
    reset_launch_counts()
    with torch.no_grad():
        ref = cpu_model(*args).float()
        out = gpu_model(*[a.to(dev) for a in args]).float().cpu()
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 2e-2, rel
    assert launch_counts()["bs_fixed"] == 2 and launch_counts()["flash_fixed"] == 0


@pytest.mark.parametrize("b,s,k,mod", [(1, 4608, 3072, True), (1, 512, 3072, True), (2, 300, 768, True),
                                       (1, 40, 256, False)])
def test_ln_mod_quant(dev, b, s, k, mod):
    _, ok, detail = checks.check_ln_mod_quant(*checks.ln_mod_quant_case(b, s, k, mod=mod, device=dev))
    assert ok, detail


@pytest.mark.parametrize("b,seqs,heads,r", [(1, (512, 4096), 24, 32), (1, (4608,), 24, 32),
                                            (2, (77, 130), 3, 16), (1, (200,), 2, 0)])
def test_qkv_rope_producer(dev, b, seqs, heads, r):
    _, ok, detail = checks.check_qkv_rope(*checks.qkv_rope_case(b, seqs, heads, r=r, device=dev))
    assert ok, detail


# the producers above rank 32 (nunchaku's rank-128 checkpoints)


@pytest.mark.parametrize("r", [48, 128])
@pytest.mark.parametrize("b,s,k", [(1, 4608, 3072), (2, 300, 768)])
def test_ln_mod_quant_ranks(dev, b, s, k, r):
    """Row 6 at R 48 / 128: within its bounds of the twin, and the codes,
    scales and first 32 lora_act columns bit for bit a rank-32 launch."""
    _, ok, detail = checks.check_ln_rank(*checks.ln_mod_quant_case(b, s, k, r, device=dev))
    assert ok, detail


@pytest.mark.parametrize("b,s,k,r,mod,smooth", [
    (2, 77, 3072, 32, True, True), (2, 300, 3072, 32, True, True),  # several batch rows: a tile each row's own
    (1, 512, 3072, 32, True, True), (1, 4096, 3072, 32, True, True),  # FLUX's text and image streams
    (1, 700, 256, 32, True, True), (1, 700, 1280, 32, True, True),  # K / 256 of 1 and 5
    (1, 4608, 3072, 32, False, True), (1, 4608, 3072, 32, True, False),  # LayerNorm only; no smooth
    (1, 4608, 3072, 16, True, True), (1, 4608, 3072, 144, True, True)])  # the rank step; two rounds
def test_ln_mod_quant_edges(dev, b, s, k, r, mod, smooth):
    """The redesigned row 6 at its edges: tile rows by M (8 to 64 rows of
    one batch row), the row vectors a lane (K 256: one 128-k chunk a K
    half), the two modes of the modulation and the smooth factor, and the
    product's widths (W 32 at R 16, three rounds of 64 at R 144): within
    row 6's bounds of the twin, and from R 32 up bit for bit the rank-32
    launch on its columns."""
    x, sc, sh, sm, pd = checks.ln_mod_quant_case(b, s, k, r, mod=mod, device=dev)
    sm = sm if smooth else None
    check = checks.check_ln_mod_quant if r < 32 else checks.check_ln_rank
    _, ok, detail = check(x, sc, sh, sm, pd)
    assert ok, detail


@pytest.mark.parametrize("b,s,k", [(1, 4608, 3072), (2, 300, 1280)])
def test_ln_mod_quant_dual_edges(dev, b, s, k):
    """The dual mode at heads of R 48 + 128 (one width for both heads'
    rounds): each head within row 6's bounds and bit for bit its single
    launch."""
    _, ok, detail = checks.check_ln_dual(*checks.ln_dual_case(b, s, k, 48, 128, device=dev))
    assert ok, detail


def test_ln_mod_quant_sass(dev):
    """Each instantiation of the LN producer (K 3072 and any K, single and
    dual, widths 32 and 64) holds register-A wgmma (HGMMA) and TMA loads
    (UTMALDG) and does not spill."""
    from nunchaku_tpu_torch.ops import _build

    path = _build.build()
    sass, res = _build.sass_counts(path), _build.resource_usage(path)
    ln = [n for n in sass if "ln_mod_quant_kernel<" in n]
    assert len(ln) == 8, ln
    for name in ln:
        assert sass[name]["HGMMA"] > 0 and sass[name]["UTMALDG"] > 0, (name, sass[name])
        assert res[name]["STACK"] == 0 and res[name]["LOCAL"] == 0, (name, res[name])


@pytest.mark.parametrize("b,s,k,r1,r2", [(1, 4608, 3072, 128, 128), (2, 300, 512, 48, 128), (1, 77, 256, 128, 16)])
def test_ln_mod_quant_dual_ranks(dev, b, s, k, r1, r2):
    """Row 15 at R 48 / 128: each head within row 6's bounds of the twin and
    bit for bit a single-mode launch with its operands."""
    _, ok, detail = checks.check_ln_dual(*checks.ln_dual_case(b, s, k, r1, r2, device=dev))
    assert ok, detail


@pytest.mark.parametrize("r", [48, 128])
@pytest.mark.parametrize("b,seqs,heads", [(1, (512, 4096), 24), (2, (77, 130), 3)])
def test_qkv_rope_producer_ranks(dev, b, seqs, heads, r):
    """Row 7 at R 48 / 128 (shared-buffer calls, ragged token tiles): within
    its bound of the twin, and rank 32 zero-padded to R bit for bit rank 32."""
    _, ok, detail = checks.check_qkv_rank(*checks.qkv_rope_case(b, seqs, heads, r=r, device=dev))
    assert ok, detail


# the redesigned row 7 at its edges: (B, streams into one buffer, H, R)
QKV_EDGES = [(1, (4096,), 30, 0), (1, (4096,), 30, 32),  # Z-Image's heads, without and with the low-rank term
             (2, (77, 130), 3, 0), (2, (77, 130), 3, 16),  # two batch rows, ragged tiles, one shared buffer
             (1, (1,), 2, 32), (1, (65,), 2, 32), (1, (1,), 2, 0), (1, (65,), 2, 0),  # one token; a tile and one
             (1, (512, 4096), 24, 16), (2, (77, 130), 3, 144), (1, (300,), 4, 256),  # the rank step; two chunks
             (2, (77, 130), 3, 384)]  # three chunks, above the ranks a tile keeps: each warpgroup stages its own


@pytest.mark.parametrize("b,seqs,heads,r", QKV_EDGES)
def test_qkv_rope_producer_edges(dev, b, seqs, heads, r):
    """Row 7 at the edges of its token tiles, units and ranks: within its
    bound of the twin, and from R 32 up rank 32 (above 128 also rank 128)
    zero-padded to R bit for bit the unpadded launch."""
    case = checks.qkv_rope_case(b, seqs, heads, r=r, device=dev)
    check = checks.check_qkv_rope if r < 32 else checks.check_qkv_rank
    _, ok, detail = check(*case)
    assert ok, detail
    if r > 128:
        _, ok, detail = checks.check_qkv_rank(*case, r_small=128)
        assert ok, detail


def test_qkv_rope_producer_txt_without_lora(dev):
    """The dual block when the text stream has no low-rank term
    (models/attention.py, mods_txt None): the image stream's rows at R 32,
    then the text stream's at R 0, into one buffer set."""
    streams, cos, sin = checks.qkv_rope_case(1, (512, 4096), 24, r=32, device=dev)
    qkv, nq, nk, _, _, off = streams[1]
    streams[1] = (qkv, nq, nk, None, None, off)
    _, ok, detail = checks.check_qkv_rope(streams, cos, sin)
    assert ok, detail


@pytest.mark.parametrize("r", [144, 160, 256])
def test_producer_rank_refusals(dev, r):
    """Ranks above 128, which both producers refused before they ran the
    rank term in chunks of 128: the LN producer (single, and dual with heads
    of R and 48) and the qkv/RoPE producer within their bounds of the twins,
    bit for bit the rank-32 launch on its columns, and the qkv producer's
    rank 128 zero-padded to R bit for bit rank 128."""
    _, ok, detail = checks.check_ln_rank(*checks.ln_mod_quant_case(1, 4608, 3072, r, device=dev))
    assert ok, detail
    _, ok, detail = checks.check_ln_dual(*checks.ln_dual_case(2, 300, 768, r, 48, device=dev))
    assert ok, detail
    case = checks.qkv_rope_case(1, (512, 4096), 24, r=r, device=dev)
    _, ok, detail = checks.check_qkv_rank(*case)
    assert ok, detail
    _, ok, detail = checks.check_qkv_rank(*case, r_small=128)
    assert ok, detail


# the Hopper attention core (flash_sm90.cuh): every form at CORE_RAGGED's shapes against its twin (the int8
# form in test_flash_i8)
CORE_FORMS = ["fixed", "denom", "unroll2", "fixed_masked", "online_masked", "online_d64", "online_d112",
              "online_d128", "bshd"]


@pytest.mark.parametrize("b,h,sq,skv", CORE_RAGGED)
@pytest.mark.parametrize("form", CORE_FORMS)
def test_core_forms_ragged(dev, form, b, h, sq, skv):
    if form.endswith("masked"):  # a joint [txt; img] sequence, Sq = Skv = S
        s_txt = min(77, skv // 2)
        case = checks.flash_masked_case(b, h, s_txt, skv - s_txt, (s_txt // 2, s_txt)[:b], device=dev)
        _, ok, detail = checks.check_flash_masked(*case, online=form == "online_masked")
    elif form.startswith("online_d"):
        _, ok, detail = checks.check_flash_online(*checks.flash_online_case(b, h, sq, skv, int(form[8:]), device=dev))
    elif form == "bshd":
        _, ok, detail = checks.check_flash_bshd(*checks.flash_bshd_case(b, h, sq, skv, device=dev))
    else:
        check = {"fixed": checks.check_flash, "denom": checks.check_flash_denom,
                 "unroll2": checks.check_flash_unroll2}[form]
        _, ok, detail = check(*checks.flash_case(b, h, sq, skv, device=dev))
    assert ok, detail


@pytest.mark.parametrize("m,k,n,groups,batch,extra", [(4608, 12288, 3072, 8, 1, True),
                                                      (4096, 12288, 3072, 8, 1, False),
                                                      (512, 3072, 256, 2, 2, True)])
def test_grouped_res(dev, m, k, n, groups, batch, extra):
    _, ok, detail = checks.check_grouped_res(
        *checks.grouped_res_case(m, k, n, groups, batch=batch, extra=extra, device=dev))
    assert ok, detail


def test_launch_counts_and_shape_errors(dev):
    reset_launch_counts()
    dequant_w4a8(*checks.dequant_case(256, 128, device=dev))
    assert launch_counts()["dequant_w4a8"] == 1
    qa, a, w, ws, la, pu, b, rsm, pd = checks.gelu_quant_case(100, 256, 256, device=dev)
    with pytest.raises(ValueError):  # M not a multiple of the 128-row tile
        svdq_gemm_w8a8_gelu_quant(qa, a, w, ws, la, pu, b, rsm, pd)
    with pytest.raises(ValueError):  # K group of 100 is not a multiple of 64
        gemm_w8a8_grouped(*checks.grouped_case(128, 200, 128, 2, device=dev))
    assert launch_counts()["gemm_w8a8_gelu_quant"] == 0
    args = checks.grouped_res_case(256, 1024, 256, 2, device=dev)
    gemm_w8a8_grouped(*args)  # the residual operands select the residual mode's count
    assert launch_counts()["gemm_w8a8_grouped_res"] == 1 and launch_counts()["gemm_w8a8_grouped"] == 0


def test_turbo_small_model_batch2_matches_cpu(dev):
    """A 1 + 1-block turbo model (6 heads: two requantize groups, so the MLP
    ends in the grouped residual kernel) at B = 2 on the card against the
    plain twins on the CPU; each batch row within 2e-2 of the reference's
    max |value|."""
    cfg = FluxConfig(num_layers=1, num_single_layers=1, num_attention_heads=6,
                     joint_attention_dim=512, pooled_projection_dim=256, precision="w4a8")
    cpu_model = FluxTransformer2DModel.random_init(cfg, seed=5, device="cpu")
    cpu_model.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(6)
    args = (torch.randn((2, 256, 64), generator=gen).to(torch.bfloat16),
            torch.randn((2, 128, 512), generator=gen).to(torch.bfloat16),
            torch.randn((2, 256), generator=gen).to(torch.bfloat16),
            torch.tensor([0.3, 0.8]), make_img_ids(16, 16), torch.zeros((128, 3), dtype=torch.int32),
            torch.tensor([3.5, 2.0]))
    reset_launch_counts()
    with torch.no_grad():
        ref = cpu_model(*args).float()
        out = gpu_model(*[a.to(dev) for a in args]).float().cpu()
    counts = launch_counts()
    assert counts["gemm_w8a8_grouped_res"] == 3 and counts["ln_mod_quant_int8"] == 6
    for i in range(2):
        assert ((out[i] - ref[i]).abs().max() / ref[i].abs().max()).item() <= 2e-2


@pytest.mark.parametrize("m,k,n,precision,unsigned", [
    (4608, 3072, 12288, "int4", False),
    (4608, 12288, 3072, "int4", True),
    (4608, 3072, 12288, "nvfp4", False),
    (512, 3072, 9216, "nvfp4", False),
    (200, 256, 128, "int4", True),
    (136, 512, 384, "nvfp4", False),
])
def test_gemm_w4a4(dev, m, k, n, precision, unsigned):
    _, ok, detail = checks.check_w4a4(*checks.w4a4_case(m, k, n, precision, unsigned, device=dev))
    assert ok, detail


# the register-A wgmma kernel's edges: one pack block (K 256: two K tiles, no loop), partial last row tiles (TMA
# reads zeros past M, the store masks them), both rank classes (R <= 32: two k steps; above: eight for each
# chunk of 128 ranks, R 200 and 256 two chunks, as upstream's rank-256 Z-Image checkpoint needs)
@pytest.mark.parametrize("m,k,n,precision,unsigned,r", [
    (128, 256, 128, "int4", False, 32),
    (256, 256, 384, "int4", True, 16),
    (8, 256, 256, "nvfp4", False, 32),
    (4104, 3072, 3072, "int4", False, 32),   # a partial last row tile of 8 rows
    (328, 768, 256, "int4", True, 128),
    (72, 512, 128, "nvfp4", False, 64),
    (4096, 3072, 9216, "nvfp4", False, 128),
    (520, 256, 1280, "nvfp4", False, 128),
    (4096, 3840, 3840, "int4", False, 256),
    (4104, 3072, 3072, "int4", True, 256),
    (520, 256, 1280, "nvfp4", False, 256),
    (328, 768, 256, "int4", False, 200),
])
def test_gemm_w4a4_edges(dev, m, k, n, precision, unsigned, r):
    _, ok, detail = checks.check_w4a4(*checks.w4a4_case(m, k, n, precision, unsigned, r, device=dev))
    assert ok, detail


@pytest.mark.parametrize("precision,unsigned", [("int4", False), ("int4", True), ("nvfp4", False)])
def test_gemm_w4a4_every_code(dev, precision, unsigned):
    """Every byte value (so every pair of nibbles, nvfp4's stray code 0x8
    among them) at every position of a pack block on both operands, at unit
    scales (so each product is exact and the output is the sum itself)."""
    args, kw = checks.w4a4_case(256, 512, 256, precision, unsigned, device=dev)
    codes = torch.arange(256, dtype=torch.int32, device=dev).to(torch.uint8).view(torch.int8)
    qa = torch.stack([torch.roll(codes, 7 * i) for i in range(256)])  # (M 256, K/2 256): each row every byte
    qw = torch.stack([torch.roll(codes.flip(0), 3 * i) for i in range(256)]).t()  # (K/2, N), K-contiguous
    ones_a, ones_w = torch.ones_like(args[1]), torch.ones_like(args[3])
    _, ok, detail = checks.check_w4a4((qa, ones_a, qw, ones_w, None, None, None), kw)
    assert ok, detail
    _, ok, detail = checks.check_w4a4((qa, args[1], qw, args[3]) + args[4:], kw)
    assert ok, detail


@pytest.mark.parametrize("m,k,n,precision,unsigned,r,extra", [
    (4608, 3072, 12288, "int4", False, 32, True),
    (200, 256, 384, "int4", True, 256, True),
    (136, 512, 256, "nvfp4", False, 128, True),
    (128, 256, 128, "nvfp4", False, 16, False),
])
def test_w4a4_decode_yardstick(dev, m, k, n, precision, unsigned, r, extra):
    """The W4A4 GEMM's decode yardstick (``nt_w4a4_decode``, timed by
    ``tools/time_w4a4.py``) writes bit for bit its twin's bf16 operands, and
    their product on the bf16 GEMM probe passes the W4A4 check's bound."""
    from nunchaku_tpu_torch.ops.gemm import gemm_w4a4_plain
    from nunchaku_tpu_torch.tools.time_w4a4 import w4a4_decode_bf16

    args, kw = checks.w4a4_case(m, k, n, precision, unsigned, r, device=dev)
    if not extra:
        args = args[:4] + (None, None, None)
    a16, w16 = w4a4_decode_bf16(*args, **kw)
    cpu = tuple(None if a is None else a.cpu() for a in args)
    a_ref, w_ref = w4a4_decode_bf16(*cpu, **kw)
    assert torch.equal(a16.cpu(), a_ref) and torch.equal(w16.cpu(), w_ref)
    if n % 256 == 0 and m % 128 == 0:
        out = gemm_probe.gemm_probe_bf16(a16, w16)[:m].float()
        ref = gemm_w4a4_plain(*args, **kw).float()
        assert ((out - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-4 * ref.abs().max()).all()


@pytest.mark.parametrize("precision", ["int4", "nvfp4"])
def test_gemm_w4a4_without_lora_or_bias(dev, precision):
    args, kw = checks.w4a4_case(256, 512, 256, precision, r=16, device=dev)
    qa, asc, qw, wsc, la, pu, bias = args
    for extra in ((None, None, bias), (la, pu, None), (None, None, None)):
        _, ok, detail = checks.check_w4a4((qa, asc, qw, wsc) + extra, kw)
        assert ok, detail


@pytest.mark.parametrize("m,k,n", [(1, 3072, 18432), (1, 3072, 9216), (5, 512, 768), (12, 1024, 512)])
def test_awq_gemv(dev, m, k, n):
    _, ok, detail = checks.check_awq(*checks.awq_case(m, k, n, device=dev))
    assert ok, detail


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 12])
@pytest.mark.parametrize("k,n", [(3072, 18432), (3072, 9216), (256, 256)])
def test_awq_gemv_rows(dev, m, k, n):
    """Every row count of one launch (and 12: 8 + 4) at FLUX's modulation
    shapes and at the wrapper's smallest K and N."""
    _, ok, detail = checks.check_awq(*checks.awq_case(m, k, n, seed=m, device=dev))
    assert ok, detail


def test_awq_gemv_deterministic(dev):
    """Calls repeat bit for bit (the K splits summed in a fixed order, no
    atomics), one count a call of up to 8 rows; x must be bf16."""
    args = checks.awq_case(2, 3072, 18432, device=dev)
    first = awq_w4a16_linear(*args)
    reset_launch_counts()
    for _ in range(4):
        assert torch.equal(awq_w4a16_linear(*args), first)
    assert launch_counts()["gemv_awq"] == 4
    with pytest.raises(ValueError):  # x not bf16
        awq_w4a16_linear(args[0].float(), *args[1:])


def test_4bit_counts_and_refusals(dev):
    reset_launch_counts()
    for precision, unsigned in (("int4", False), ("int4", True), ("nvfp4", False)):
        args, kw = checks.w4a4_case(128, 256, 128, precision, unsigned, device=dev)
        gemm_w4a4(*args, **kw)
    awq_w4a16_linear(*checks.awq_case(12, 256, 256, device=dev))  # 8 + 4 rows: two launches
    counts = launch_counts()
    assert (counts["gemm_w4a4_int4"], counts["gemm_w4a4_int4_unsigned"], counts["gemm_w4a4_nvfp4"],
            counts["gemv_awq"]) == (1, 1, 1, 2)
    args, kw = checks.w4a4_case(100, 256, 128, device=dev)
    with pytest.raises(ValueError):  # M not a multiple of 8
        gemm_w4a4(*args, **kw)
    args, kw = checks.w4a4_case(128, 256, 128, "nvfp4", device=dev)
    with pytest.raises(ValueError):  # unsigned activations are an int4 mode
        gemm_w4a4(*args, precision="nvfp4", act_unsigned=True)
    qa, asc, qw, wsc, la, pu, bias = args
    with pytest.raises(ValueError):  # the weight stored N-contiguous, not K-contiguous
        gemm_w4a4(qa, asc, qw.contiguous(), wsc, la, pu, bias, **kw)
    with pytest.raises(ValueError):  # N not a multiple of the 256-column block
        awq_w4a16_linear(*checks.awq_case(1, 256, 384, device=dev))
    assert launch_counts()["gemm_w4a4_nvfp4"] == 1 and launch_counts()["gemv_awq"] == 2


@pytest.mark.parametrize("turbo", [False, True])
@pytest.mark.parametrize("precision", ["int4", "nvfp4"])
def test_4bit_small_model_matches_cpu(dev, precision, turbo):
    """A 1 + 1-block model at 6 heads with its AdaLN modulation damped
    (``checks.damp_modulation``) on the card against the plain twins on the
    CPU: within 2e-2 of the reference's max |value|; every GEMM and
    modulation took its kernel, and each modulation linear alone is within
    one bf16 step of the CPU's. ``turbo``: on a bf16 stream with the fused
    qkv prologue, the 4-bit blocks' unfused branches feed the qkv/RoPE
    producer, and no int8 producer runs."""
    cfg = FluxConfig(num_layers=1, num_single_layers=1, num_attention_heads=6,
                     joint_attention_dim=512, pooled_projection_dim=256, precision=precision)
    cpu_model = FluxTransformer2DModel.random_init(cfg, seed=7, device="cpu")
    checks.damp_modulation(cpu_model)
    if turbo:
        cpu_model.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(8)
    args = (torch.randn((1, 256, 64), generator=gen).to(torch.bfloat16),
            torch.randn((1, 128, 512), generator=gen).to(torch.bfloat16),
            torch.randn((1, 256), generator=gen).to(torch.bfloat16),
            torch.tensor([0.6]), make_img_ids(16, 16), torch.zeros((128, 3), dtype=torch.int32),
            torch.tensor([3.5]))
    reset_launch_counts()
    with torch.no_grad():
        ref = cpu_model(*args).float()
        out = gpu_model(*[a.to(dev) for a in args]).float().cpu()
    counts = launch_counts()
    gemms = sum(counts[k + "_stacked"] for k in ("gemm_w4a4_int4", "gemm_w4a4_int4_unsigned", "gemm_w4a4_nvfp4"))
    assert gemms == 12 and counts["gemv_awq"] == 3 and counts["flash_fixed"] == 2
    assert counts["qkv_rope_producer"] == (3 if turbo else 0) and counts["ln_mod_quant_int8"] == 0
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 2e-2
    _, ok, detail = checks.check_modulation(cpu_model, gpu_model)
    assert ok, detail


@pytest.mark.parametrize("online", [False, True], ids=["fixed", "online"])
@pytest.mark.parametrize("b,h,s_txt,s_img,valid", [
    (2, 24, 211, 4096, (211, 97)),  # Qwen-Image 1024px, two prompts padded to 211 tokens
    (2, 2, 77, 130, (77, 0)),  # row 1's whole text block masked; S_txt not a multiple of 64
    (1, 3, 50, 65, (13,)),
])
def test_flash_masked(dev, b, h, s_txt, s_img, valid, online):
    _, ok, detail = checks.check_flash_masked(*checks.flash_masked_case(b, h, s_txt, s_img, valid, device=dev),
                                              online=online)
    assert ok, detail


def test_flash_masked_counts_and_refusals(dev):
    q, k, v, mask = checks.flash_masked_case(1, 2, 20, 60, (7,), device=dev)
    reset_launch_counts()
    flash_attention(q, k, v, mask)
    flash_attention(q, k, v)
    flash_attention_online(q, k, v, scale=1.0, kv_mask=mask.float(), out_bshd=True)
    counts = launch_counts()
    assert (counts["flash_fixed_masked"], counts["flash_fixed"], counts["flash_online_masked"],
            counts["flash_online"]) == (1, 1, 1, 0)
    with pytest.raises(ValueError):  # not (B, S_kv)
        flash_attention(q, k, v, mask[:, 1:])
    q5, k5, v5 = checks.flash_online_case(1, 1, 64, 64, 512, device=dev)
    with pytest.raises(ValueError):  # the online mask form is built for head dim 128
        flash_attention_online(q5, k5, v5, kv_mask=torch.ones((1, 64), dtype=torch.bool, device=dev))
    assert launch_counts()["flash_online_masked"] == 1


@pytest.mark.parametrize("precision,variant", [("w4a8", "fixed"), ("int4", "fixed"), ("int4", "online"),
                                               ("int4", "fused")])
def test_qwen_small_model_matches_cpu(dev, precision, variant):
    """The 2-block Qwen-Image model of the CPU tests (2 heads, joint 320;
    int4: AdaLN modulation damped) at B 2 with padded prompts (24 and 9
    valid tokens) on the card against the plain twins on the CPU: each batch
    row within 2e-2 of the reference's max |value|; every attention took a
    mask form (``online``: fixed_softmax False; ``fused``: the qkv/RoPE
    producer)."""
    cfg = QwenImageConfig(num_layers=2, num_attention_heads=2, joint_attention_dim=320, precision=precision)
    cpu_model = QwenImageTransformer2DModel.random_init(cfg, seed=9, device="cpu")
    if precision == "int4":
        checks.damp_modulation(cpu_model)
    if variant == "fused":
        cpu_model.enable_fused_qkv_prep()
    cpu_model.set_on_stacks("attn", fixed_softmax=variant != "online")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(10)
    mask = torch.arange(24)[None, :] < torch.tensor([[24], [9]])
    args = (torch.randn((2, 64, 64), generator=gen).to(torch.bfloat16),
            torch.randn((2, 24, 320), generator=gen).to(torch.bfloat16), torch.tensor([0.4, 0.9]),
            make_img_ids(8, 8))
    reset_launch_counts()
    with torch.no_grad():
        ref = cpu_model(*args, encoder_hidden_states_mask=mask).float()
        out = gpu_model(*[a.to(dev) for a in args], encoder_hidden_states_mask=mask.to(dev)).float().cpu()
    counts = launch_counts()
    masked = "flash_online_masked" if variant == "online" else "flash_fixed_masked"
    assert counts[masked] == 2 and counts["flash_fixed"] == counts["flash_online"] == 0
    assert counts["qkv_rope_producer"] == (4 if variant == "fused" else 0)
    for i in range(2):
        assert ((out[i] - ref[i]).abs().max() / ref[i].abs().max()).item() <= 2e-2


def _buffers_equal(a, b):
    """Every buffer of two models equal, bit for bit (float ones compared
    as their bytes), and on their devices."""
    ba, bb = dict(a.named_buffers()), dict(b.named_buffers())
    assert ba.keys() == bb.keys()
    for name, t in ba.items():
        u = bb[name].cpu()
        assert t.dtype == u.dtype and t.shape == u.shape, name
        assert torch.equal(t.cpu().contiguous().view(torch.uint8), u.contiguous().view(torch.uint8)), name


@pytest.mark.parametrize("model,precision", [("flux-nvfp4", None), ("flux-nvfp4", "int8"), ("flux-nvfp4", "w4a8"),
                                             ("flux-int4", "w4a8"), ("qwen-r128", None), ("qwen-r128", "w4a8")])
def test_loader_decodes_on_card_as_on_cpu(dev, tmp_path, model, precision):
    """The loaders decode on the device they build on: the card's integer
    codes, scales and rescales equal the CPU's bit for bit (true f32
    divisions on both, round half to even)."""
    from nunchaku_tpu_torch.models.loader import load_flux_transformer
    from nunchaku_tpu_torch.models.loader_qwenimage import load_qwenimage_transformer
    from nunchaku_tpu_torch.tools import synth_checkpoint as synth

    path = tmp_path / "ckpt.safetensors"
    if model.startswith("flux"):
        synth.write(path, synth.flux_state(layers=1, single=1, heads=2, joint=256, pooled=128,
                                           precision=model.split("-")[1], device="cpu"))
        load = load_flux_transformer
    else:
        synth.write(path, synth.qwen_state(layers=1, heads=2, joint=320, rank=128, device="cpu"))
        load = load_qwenimage_transformer
    _buffers_equal(load(path, precision, device=dev), load(path, precision, device="cpu"))


def test_w4a8_cache_dequant_on_card(dev):
    """The dial's int8 codes are the dequant kernel's, in both code forms."""
    from nunchaku_tpu_torch.models.requantize import w4a8_cache_dequant

    for precision in ("w4a8", "nvfp4-a8"):
        cfg = FluxConfig(num_layers=1, num_single_layers=1, num_attention_heads=2, joint_attention_dim=256,
                         pooled_projection_dim=128, precision=precision)
        model = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev)
        fc1 = model.layer_views()["transformer_blocks"][0].ff.fc1
        want = dequant_w4a8(fc1.qweight, fc1.rescales, fc1.wcodes)
        reset_launch_counts()
        dialed = w4a8_cache_dequant(model, 1.0)  # the stacks of one layer each, layer by layer
        assert launch_counts()["dequant_w4a8_e2m1" if precision == "nvfp4-a8" else "dequant_w4a8"] == 12
        got = dialed.layer_views()["transformer_blocks"][0].ff.fc1
        assert got.precision == "int8" and torch.equal(got.qweight, want)


# the packed-int4 w4a8 route (NUNCHAKU_TPU_W4A8_XLA=0, NUNCHAKU_TPU_W4A8_FUSED=1)


@pytest.mark.parametrize("m,k,n,r,groups", [
    (4608, 3072, 9216, 32, 1),   # FLUX single-block qkv
    (4608, 3072, 3072, 32, 1),   # out projection
    (512, 3072, 9216, 32, 1),    # the dual block's text stream
    (4096, 3072, 9216, 128, 1),  # Qwen-Image rank 128
    (200, 512, 256, 16, 1),      # M padded to the 128-row tile
    (4608, 12288, 3072, 32, 8),  # the chain's fc2 consumer
    (4608, 12288, 3072, 128, 8),
    (256, 3072, 256, 32, 2),
])
def test_gemm_w4a8(dev, m, k, n, r, groups):
    case = checks.w4a8_case(m, k, n, r, device=dev) if groups == 1 else checks.w4a8_grouped_case(
        m, k, n, groups, r, device=dev)
    _, ok, detail = checks.check_w4a8(*case)
    assert ok, detail


@pytest.mark.parametrize("r", [32, 128])
@pytest.mark.parametrize("m,k,n,unsigned", [(4608, 3072, 12288, False), (256, 512, 3072, True)])
def test_w4a8_gelu_quant(dev, r, m, k, n, unsigned):
    _, ok, detail = checks.check_w4a8_gelu_quant(*checks.w4a8_gelu_quant_case(m, k, n, r, device=dev),
                                                 act_unsigned_next=unsigned)
    assert ok, detail


# the packed kernels on the s8 loop (W decoded on warpgroup 0): ranks above 128, M past a 128-row tile, K groups
# of 64 (mod 128) (a group's last K tile one half: 192 = 128 + 64, and 64 alone)
@pytest.mark.parametrize("m,k,n,r,groups", [
    (4608, 3072, 9216, 256, 1),   # FLUX qkv at rank 256
    (4608, 3840, 11520, 256, 1),  # Z-Image-Turbo r256's qkv
    (200, 512, 256, 160, 1),      # M off the tile, R 160
    (4608, 12288, 3072, 256, 8),  # the chain's fc2 consumer
    (256, 1536, 384, 160, 8),     # K / G = 192
    (320, 1536, 256, 32, 24),     # K / G = 64, M off the tile
    (136, 768, 128, 16, 4),       # K / G = 192, M eight rows past a tile
])
def test_gemm_w4a8_ranks(dev, m, k, n, r, groups):
    """The packed GEMM in both modes against its twin and bit for bit the
    int8 grouped kernel on the dequantized weight (check_w4a8)."""
    case = checks.w4a8_case(m, k, n, r, device=dev) if groups == 1 else checks.w4a8_grouped_case(
        m, k, n, groups, r, device=dev)
    _, ok, detail = checks.check_w4a8(*case)
    assert ok, detail


@pytest.mark.parametrize("r", [160, 256])
@pytest.mark.parametrize("m,k,n,unsigned", [(4608, 3072, 12288, False), (256, 512, 3072, True)])
def test_w4a8_gelu_quant_ranks(dev, r, m, k, n, unsigned):
    """The W4 producer above rank 128, bit for bit the int8 producer on the
    dequantized weight (check_w4a8_gelu_quant)."""
    _, ok, detail = checks.check_w4a8_gelu_quant(*checks.w4a8_gelu_quant_case(m, k, n, r, device=dev),
                                                 act_unsigned_next=unsigned)
    assert ok, detail


@pytest.mark.parametrize("mode", ["gemm_w4a8_gelu_quant_stacked", "gemm_w4a8_grouped_stacked"])
@pytest.mark.parametrize("r", [32, 256])
def test_w4a8_chain_stacked(dev, mode, r):
    """The packed chain's stacked modes: every layer bit for bit the
    non-stacked kernel on that layer, and the kernel against its twin."""
    m, k, n = (512, 3072, 12288) if "gelu" in mode else (512, 12288, 3072)
    run, w, check, _ = checks.chain_stacked_case(mode, m, k, n, r, device=dev)
    _, ok, detail = checks.check_stacked(run, w, check)
    assert ok, detail


def test_w4a8_packed_counts_and_refusals(dev, monkeypatch):
    """One launch count per mode; e2m1 (nvfp4-a8) rescales refused by every
    packed wrapper, grouped e2m1 scales by the dispatch (as in JAX), and a
    rank-1 e2m1 call under W4A8_XLA=0 kept on the dequant route."""
    reset_launch_counts()
    args = checks.w4a8_case(256, 512, 256, device=dev)
    gemm_w4a8(*args)
    gemm_w4a8_grouped(*checks.w4a8_grouped_case(256, 1024, 256, 2, device=dev))
    svdq_gemm_w4a8_gelu_quant(*checks.w4a8_gelu_quant_case(256, 512, 1536, device=dev))
    c = launch_counts()
    assert (c["gemm_w4a8"], c["gemm_w4a8_grouped"], c["gemm_w4a8_gelu_quant"]) == (1, 1, 1)
    assert c["dequant_w4a8"] == c["gemm_w8a8_grouped"] == c["gemm_w8a8_gelu_quant"] == 0
    qa, asc, _, _, ws, la, pu, bias = args
    qw, rs16 = checks.dequant_case(512, 256, codes="e2m1", device=dev)
    with pytest.raises(ValueError):
        gemm_w4a8(qa, asc, qw, rs16, ws, la, pu, bias)
    with pytest.raises(ValueError):
        svdq_gemm_w4a4(qa, asc.expand(2, -1), qw, ws, la, pu, bias, rs16, precision="w4a8", wcodes="e2m1")
    monkeypatch.setenv("NUNCHAKU_TPU_W4A8_XLA", "0")
    reset_launch_counts()
    svdq_gemm_w4a4(qa, asc, qw, ws, la, pu, bias, rs16, precision="w4a8", wcodes="e2m1")
    c = launch_counts()
    assert c["dequant_w4a8_e2m1"] == 1 and c["gemm_w4a8"] == 0


@pytest.mark.parametrize("turbo", [False, True])
def test_packed_small_model_matches_cpu(dev, monkeypatch, turbo):
    """A 1 + 1-block w4a8 model (6 heads: two requantize groups) on the
    packed route on the card against the plain twins on the CPU: within
    2e-2 of the reference's max |value|, every w4a8 GEMM a packed kernel
    in its stacked mode (6 standalone linears, 3 chains), none the dequant
    or the LN producer."""
    monkeypatch.setenv("NUNCHAKU_TPU_W4A8_XLA", "0")
    monkeypatch.setenv("NUNCHAKU_TPU_W4A8_FUSED", "1")
    cfg = FluxConfig(num_layers=1, num_single_layers=1, num_attention_heads=6,
                     joint_attention_dim=512, pooled_projection_dim=256, precision="w4a8")
    cpu_model = FluxTransformer2DModel.random_init(cfg, seed=7, device="cpu")
    if turbo:
        cpu_model.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(8)
    args = (torch.randn((1, 256, 64), generator=gen).to(torch.bfloat16),
            torch.randn((1, 128, 512), generator=gen).to(torch.bfloat16),
            torch.randn((1, 256), generator=gen).to(torch.bfloat16),
            torch.tensor([0.6]), make_img_ids(16, 16), torch.zeros((128, 3), dtype=torch.int32),
            torch.tensor([3.5]))
    reset_launch_counts()
    with torch.no_grad():
        ref = cpu_model(*args).float()
        out = gpu_model(*[a.to(dev) for a in args]).float().cpu()
    c = {k: v for k, v in launch_counts().items() if v}
    expect = {"gemm_w4a8_stacked": 6, "gemm_w4a8_gelu_quant_stacked": 3, "gemm_w4a8_grouped_stacked": 3,
              "flash_fixed": 2}
    assert c == (expect | {"qkv_rope_producer": 3} if turbo else expect), c
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 2e-2


# the stacked (layer-index) modes and Z-Image


@pytest.mark.parametrize("m,k,n,precision", [
    (4608, 3840, 11520, "int4"),   # Z-Image's qkv over the joint stream
    (4608, 10240, 3840, "int4"),   # w2
    (4096, 3840, 20480, "nvfp4"),  # the noise refiner's w13
    (512, 3840, 3840, "nvfp4"),    # the context refiner's out projection
    (136, 512, 384, "int4"),
])
def test_gemm_w4a4_stacked(dev, m, k, n, precision):
    _, ok, detail = checks.check_w4a4_stacked(*checks.w4a4_case(m, k, n, precision, device=dev))
    assert ok, detail


@pytest.mark.parametrize("m,k,n,precision", [
    (4104, 3072, 3072, "int4"),  # a partial last row tile of 8 rows
    (200, 256, 256, "nvfp4"),    # one pack block, a partial tile
    (8, 512, 128, "int4"),
])
def test_gemm_w4a4_stacked_edges(dev, m, k, n, precision):
    _, ok, detail = checks.check_w4a4_stacked(*checks.w4a4_case(m, k, n, precision, device=dev))
    assert ok, detail


@pytest.mark.parametrize("k,n", [(3840, 11520), (10240, 3840), (256, 128)])
def test_dequant_w4a8_stacked(dev, k, n):
    _, ok, detail = checks.check_dequant_stacked(*checks.dequant_case(k, n, device=dev))
    assert ok, detail


@pytest.mark.parametrize("m,k,n,r", [(4608, 3840, 11520, 32), (512, 10240, 3840, 128), (200, 512, 256, 16),
                                     (4608, 3840, 11520, 256), (200, 512, 256, 160)])
def test_gemm_w4a8_stacked(dev, m, k, n, r):
    _, ok, detail = checks.check_w4a8_stacked(*checks.w4a8_case(m, k, n, r, device=dev))
    assert ok, detail


def test_stacked_counts_clamp_and_refusals(dev):
    """Each stacked mode counts apart from its non-stacked form; an index
    past either end reads the nearest layer (the kernels clamp, reading
    nothing outside the stack); an index on the host, of another type or a
    stack whose layers are not back to back is refused."""
    reset_launch_counts()
    args, kw = checks.w4a4_case(128, 256, 128, "int4", device=dev)
    qa, asc, qw, wsc = args[:4]
    stack, ids = checks.stack_case(qw)
    out = gemm_w4a4(qa, asc, stack, wsc, *args[4:], **kw, layer_idx=ids[1])
    args4, kw4 = checks.w4a4_case(128, 256, 128, "nvfp4", device=dev)
    stack4, ids4 = checks.stack_case(args4[2])
    gemm_w4a4(*args4[:2], stack4, *args4[3:], **kw4, layer_idx=ids4[0])
    qw8, rs = checks.dequant_case(256, 128, device=dev)
    stack8, ids8 = checks.stack_case(qw8)
    dequant_w4a8(stack8, rs, layer_idx=ids8[2])
    a8 = checks.w4a8_case(128, 256, 128, device=dev)
    gemm_w4a8(*a8[:2], stack8, *a8[3:], layer_idx=ids8[0])
    c = launch_counts()
    assert (c["gemm_w4a4_int4_stacked"], c["gemm_w4a4_nvfp4_stacked"], c["dequant_w4a8_stacked"],
            c["gemm_w4a8_stacked"]) == (1, 1, 1, 1)
    assert c["gemm_w4a4_int4"] == c["gemm_w4a4_nvfp4"] == c["dequant_w4a8"] == c["gemm_w4a8"] == 0
    assert torch.equal(out, gemm_w4a4(qa, asc, stack[1], wsc, *args[4:], **kw))
    for bad, layer in ((3, 2), (-5, 0), (1 << 30, 2)):
        idx = torch.tensor(bad, dtype=torch.int32, device=dev)
        assert torch.equal(gemm_w4a4(qa, asc, stack, wsc, *args[4:], **kw, layer_idx=idx),
                           gemm_w4a4(qa, asc, stack[layer], wsc, *args[4:], **kw))
        assert torch.equal(dequant_w4a8(stack8, rs, layer_idx=idx), dequant_w4a8(stack8[layer], rs))
    with pytest.raises(ValueError):  # the index on the host
        gemm_w4a4(qa, asc, stack, wsc, *args[4:], **kw, layer_idx=torch.tensor(1, dtype=torch.int32))
    with pytest.raises(ValueError):  # int64
        dequant_w4a8(stack8, rs, layer_idx=torch.tensor(1, device=dev))
    with pytest.raises(ValueError):  # every other layer: not back to back
        dequant_w4a8(torch.cat([stack8, stack8])[::2], rs, layer_idx=ids8[0])
    with pytest.raises(ValueError):  # an int8 stack keeps each layer K-contiguous, as stack_modules stores it
        svdq_gemm_w4a4(a8[0], a8[1], torch.cat([stack8, stack8], dim=1), a8[4], precision="int8",
                       layer_idx=ids8[0])
    torch.cuda.synchronize()


ZIMAGE_SMALL = dict(dim=512, num_layers=2, num_refiner_layers=1, num_attention_heads=4, cap_feat_dim=512,
                    ffn_inner=1024)  # tests/test_torch_zimage.py's tiny config
ZIMAGE_TOL = {"int4": 3.7e-2, "int8": 6.4e-3, "w4a8": 7.8e-3, "nvfp4": 2.6e-2}  # its model bounds


@pytest.mark.parametrize("precision,variant", [("int4", "plain"), ("int4", "fused"), ("nvfp4", "plain"),
                                               ("w4a8", "plain"), ("w4a8", "packed"), ("int8", "fused")])
def test_zimage_small_model_matches_cpu(dev, monkeypatch, precision, variant):
    """The small Z-Image (its adaLN damped, checks.damp_zimage_modulation) on
    the card against the plain twins on the CPU within the CPU tests' model
    bound of its precision; launches exact per forward: four stacked GEMMs
    (or dequants) a block of the active mode, one flash_fixed a block, one
    producer a block after the fused prep, no non-stacked 4-bit launch."""
    from nunchaku_tpu_torch import ZImageConfig, ZImageTransformer2DModel

    if variant == "packed":
        monkeypatch.setenv("NUNCHAKU_TPU_W4A8_XLA", "0")
    cfg = ZImageConfig(**ZIMAGE_SMALL, precision=precision)
    cpu_model = ZImageTransformer2DModel.random_init(cfg, seed=21, device="cpu")
    checks.damp_zimage_modulation(cpu_model)
    if variant == "fused":
        cpu_model.enable_fused_qkv_prep()
    model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(22)
    x = torch.randn((1, 256, 64), generator=gen).to(torch.bfloat16)
    c = torch.randn((1, 64, 512), generator=gen).to(torch.bfloat16)
    t = torch.tensor([0.5])
    ii, ti = make_img_ids(16, 16), torch.zeros((64, 3), dtype=torch.int32)
    with torch.no_grad():
        ref = cpu_model(x, c, t, ii, ti).float()
        reset_launch_counts()
        out = model(x.to(dev), c.to(dev), t.to(dev), ii, ti).float().cpu()
    counts = launch_counts()
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    assert bool(torch.isfinite(out).all()) and rel <= ZIMAGE_TOL[precision], rel
    blocks = 4
    mode = {"int4": "gemm_w4a4_int4_stacked", "nvfp4": "gemm_w4a4_nvfp4_stacked",
            "w4a8": "gemm_w4a8_stacked" if variant == "packed" else "dequant_w4a8_stacked", "int8": None}[precision]
    want = {"flash_fixed": blocks}
    if variant == "fused":
        want["qkv_rope_producer"] = blocks
    if mode:
        want[mode] = 4 * blocks
    assert {k: v for k, v in counts.items() if v} == want, counts



# the int8 chain on stacks and the per-token chain (FLUX.1-dev int8, bench.py --dense)


@pytest.mark.parametrize("m,k,n,unsigned", [(4608, 3072, 12288, False), (256, 256, 3072, True), (128, 512, 1536, False)])
def test_ptoken_producer(dev, m, k, n, unsigned):
    _, ok, detail = checks.check_ptoken(*checks.gelu_quant_case(m, k, n, device=dev), act_unsigned_next=unsigned)
    assert ok, detail


@pytest.mark.parametrize("m,k,n,res", [(4608, 12288, 3072, False), (4608, 12288, 3072, True), (256, 3072, 256, True),
                                       (128, 512, 384, False)])
def test_rank1_consumer(dev, m, k, n, res):
    """The consumer's rank-1 mode, launchable non-stacked for this test (the
    model takes it stacked only)."""
    reset_launch_counts()
    args = checks.grouped_res_case(m, k, n, 1, device=dev) if res else checks.grouped_case(m, k, n, 1, device=dev)
    _, ok, detail = checks.check_rank1(*args)
    assert ok, detail
    assert launch_counts()["gemm_w8a8_rank1_res" if res else "gemm_w8a8_rank1"] == 1


@pytest.mark.parametrize("mode", checks.STACKED_CHAIN_MODES)
@pytest.mark.parametrize("shape", ["flux", "small"])
def test_chain_stacked_modes(dev, mode, shape):
    """Each stacked chain mode bit for bit its non-stacked kernel on every
    layer of a 3-layer stack, and that kernel within its tolerance of the
    twin: at FLUX.1-dev's fc1 (producers: M 4608, K 3072, N 12288) and fc2
    (consumers: K 12288, N 3072) and at a small shape."""
    producer = "gelu_quant" in mode
    m, k, n = ((4608, 3072, 12288) if producer else (4608, 12288, 3072)) if shape == "flux" else (
        (256, 512, 3072) if producer else (256, 3072, 512))
    run, w, check, _ = checks.chain_stacked_case(mode, m, k, n, device=dev)
    _, ok, detail = checks.check_stacked(run, w, check)
    assert ok, detail


def test_chain_stacked_counts_and_clamp(dev):
    """The int8 chain's stacked modes count apart from their non-stacked
    forms; an index past either end reads the nearest layer."""
    reset_launch_counts()
    qa, asc, w, ws, la, pu, b, rsm, pd = checks.gelu_quant_case(128, 256, 1536, device=dev)
    stack, ids = checks.stack_case(w)
    svdq_gemm_w8a8_gelu_quant(qa, asc, stack, ws, la, pu, b, rsm, pd, layer_idx=ids[0])
    svdq_gemm_w8a8_gelu_quant(qa, asc, stack, ws, la, pu, b, rsm, pd, layer_idx=ids[1], ptoken=True)
    g = checks.grouped_case(128, 3072, 256, 2, device=dev)
    gstack, gids = checks.stack_case(g[2])
    gemm_w8a8_grouped(g[0], g[1], gstack, *g[3:], layer_idx=gids[2])
    gemm_w8a8_rank1(g[0], g[1][:1], gstack, *g[3:], layer_idx=gids[2])
    c = launch_counts()
    assert (c["gemm_w8a8_gelu_quant_stacked"], c["gemm_w8a8_gelu_quant_ptoken_stacked"],
            c["gemm_w8a8_grouped_stacked"], c["gemm_w8a8_rank1_stacked"]) == (1, 1, 1, 1)
    assert c["gemm_w8a8_gelu_quant"] == c["gemm_w8a8_grouped"] == c["gemm_w8a8_rank1"] == 0
    for bad, layer in ((3, 2), (-5, 0), (1 << 30, 2)):
        idx = torch.tensor(bad, dtype=torch.int32, device=dev)
        out = svdq_gemm_w8a8_gelu_quant(qa, asc, stack, ws, la, pu, b, rsm, pd, layer_idx=idx, ptoken=True)
        ref = svdq_gemm_w8a8_gelu_quant(qa, asc, stack[layer], ws, la, pu, b, rsm, pd, ptoken=True)
        assert all(torch.equal(x, y) for x, y in zip(out, ref))
        assert torch.equal(gemm_w8a8_rank1(g[0], g[1][:1], gstack, *g[3:], layer_idx=idx),
                           gemm_w8a8_rank1(g[0], g[1][:1], gstack[layer], *g[3:]))
        assert torch.equal(gemm_w8a8_grouped(g[0], g[1], gstack, *g[3:], layer_idx=idx),
                           gemm_w8a8_grouped(g[0], g[1], gstack[layer], *g[3:]))
    torch.cuda.synchronize()


@pytest.mark.parametrize("turbo", [False, True])
@pytest.mark.parametrize("ptoken", ["0", "1"], ids=["grouped", "ptoken"])
def test_int8_stacked_model_matches_cpu(dev, monkeypatch, ptoken, turbo):
    """A 2 + 3-block int8 model (6 heads: two requantize groups) on its
    stacks, card against the plain twins on the CPU within 2e-2 of the
    reference's max |value|; launches exact: 7 MLP chains a forward, each a
    stacked producer and a stacked consumer of the chain's mode (turbo: the
    residual epilogue), the standalone int8 linears on torch._int_mm."""
    monkeypatch.setenv("NUNCHAKU_TPU_CHAIN_PTOKEN", ptoken)
    cfg = FluxConfig(num_layers=2, num_single_layers=3, num_attention_heads=6,
                     joint_attention_dim=512, pooled_projection_dim=256, precision="int8")
    cpu_model = FluxTransformer2DModel.random_init(cfg, seed=13, device="cpu")
    if turbo:
        cpu_model.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(14)
    args = (torch.randn((1, 256, 64), generator=gen).to(torch.bfloat16),
            torch.randn((1, 128, 512), generator=gen).to(torch.bfloat16),
            torch.randn((1, 256), generator=gen).to(torch.bfloat16),
            torch.tensor([0.6]), make_img_ids(16, 16), torch.zeros((128, 3), dtype=torch.int32),
            torch.tensor([3.5]))
    reset_launch_counts()
    with torch.no_grad():
        ref = cpu_model(*args).float()
        out = gpu_model(*[a.to(dev) for a in args]).float().cpu()
    c = {k: v for k, v in launch_counts().items() if v}
    producer = "gemm_w8a8_gelu_quant_ptoken_stacked" if ptoken == "1" else "gemm_w8a8_gelu_quant_stacked"
    consumer = "gemm_w8a8_rank1" if ptoken == "1" else "gemm_w8a8_grouped"
    expect = {producer: 7, consumer + ("_res" if turbo else "") + "_stacked": 7, "flash_fixed": 5}
    if turbo:
        expect |= {"ln_mod_quant_int8": 2 * 4 + 3 * 2, "qkv_rope_producer": 2 * 2 + 3}
    assert c == expect, c
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 2e-2


# the four op-level entry points no model path calls: the dual LN producer, qkv_prepare, token-major flash,
# the pipelined chain producer


@pytest.mark.parametrize("b,s,k,r1,r2", [(1, 4608, 3072, 32, 32), (2, 300, 512, 16, 32), (1, 77, 256, 32, 16)])
def test_ln_mod_quant_dual(dev, b, s, k, r1, r2):
    """Each head within row 6's bounds of the twin and bit for bit a
    single-mode launch with its operands (ragged M: the last 16-row tile)."""
    _, ok, detail = checks.check_ln_dual(*checks.ln_dual_case(b, s, k, r1, r2, device=dev))
    assert ok, detail


@pytest.mark.parametrize("s,heads", [(4608, 24), (200, 2), (64, 3)])
def test_qkv_prepare(dev, s, heads):
    streams, cos, sin = checks.qkv_rope_case(1, (s,), heads, 128, 0, device=dev)
    qkv, nq, nk = streams[0][:3]
    _, ok, detail = checks.check_qkv_prepare(qkv, cos, sin, nq, nk, heads)
    assert ok, detail


@pytest.mark.parametrize("b,s", [(1, 77), (2, 130), (1, 1)])
def test_qkv_prepare_edges(dev, b, s):
    """The prepare form at H 3, ragged S and two batch rows: within its bound
    of the twin and bit for bit the producer without low-rank operands."""
    streams, cos, sin = checks.qkv_rope_case(b, (s,), 3, 128, 0, device=dev)
    qkv, nq, nk = streams[0][:3]
    _, ok, detail = checks.check_qkv_prepare(qkv, cos, sin, nq, nk, 3)
    assert ok, detail


@pytest.mark.parametrize("b,h,sq,skv", [(1, 24, 4608, 4608), (1, 2, 300, 333), (2, 3, 1700, 1700), (1, 2, 77, 40)])
def test_flash_bshd(dev, b, h, sq, skv):
    _, ok, detail = checks.check_flash_bshd(*checks.flash_bshd_case(b, h, sq, skv, device=dev))
    assert ok, detail


@pytest.mark.parametrize("m,k,n,r,unsigned", [(4608, 3072, 12288, 32, False), (4608, 3072, 12288, 128, False),
                                              (256, 512, 1024, 32, True), (256, 512, 3072, 48, False),
                                              (128, 256, 256, 16, True)])
def test_gelu_quant_pipe(dev, m, k, n, r, unsigned):
    """The pipelined producer bit for bit the ordinary producer kernel, and
    within row 2's bounds of the twin (one group of 1536 / 1024 / 256
    columns, or several)."""
    _, ok, detail = checks.check_gelu_quant_pipe(*checks.gelu_quant_case(m, k, n, r, device=dev),
                                                 act_unsigned_next=unsigned)
    assert ok, detail


# the pipelined producer's edges (M, K, N, R = R2, unsigned next): bn 128 without low rank, bn 256 at R 48, bn
# 1024 at R 160, bn 1536 at R 256, bn 512 on a K of 64 (mod 128); K is one K tile each time
PIPE_EDGES = [(256, 256, 128, 0, False), (256, 512, 256, 48, True), (128, 768, 1024, 160, False),
              (256, 1536, 3072, 256, True), (128, 192, 512, 32, False)]


@pytest.mark.parametrize("m,k,n,r,unsigned", PIPE_EDGES)
def test_gelu_quant_pipe_edges(dev, m, k, n, r, unsigned):
    """Bit for bit the ordinary producer kernel (qout, qscales, lora_next) and launched as the pipelined
    kernel (its count, not the ordinary producer's)."""
    from nunchaku_tpu_torch.ops.gemm import chain_route

    assert chain_route(k, pipelined=True) == "pipe"
    case = checks.gelu_quant_case(m, k, n, max(r, 1), device=dev)
    if r == 0:
        case = case[:4] + (None, None) + case[6:]
    reset_launch_counts()
    _, ok, detail = checks.check_gelu_quant_pipe(*case, act_unsigned_next=unsigned)
    assert ok, detail
    c = launch_counts()
    assert c["gemm_w8a8_gelu_quant_pipe"] == 1 and c["gemm_w8a8_gelu_quant"] == 1, c


def test_gelu_quant_pipe_sass(dev, tmp_path):
    """gemm_w8a8_gelu_quant_pipe.cu built alone: no spill and no serialized wgmma (C7512 / C7515); its kernel
    runs IGMMA on TMA-fed stages and keeps no local memory."""
    from nunchaku_tpu_torch.ops import _build

    spills, losses = _spills_and_losses(_ptxas_alone("gemm_w8a8_gelu_quant_pipe.cu", tmp_path))
    assert spills and not any(spills) and not losses, (spills, losses)
    path = _build.build()
    sass, res = _build.sass_counts(path), _build.resource_usage(path)
    pipe = [n for n in sass if "gemm_gelu_pipe_kernel" in n]
    assert len(pipe) == 1, pipe
    assert sass[pipe[0]]["IGMMA"] > 0 and sass[pipe[0]]["UTMALDG"] > 0, sass[pipe[0]]
    assert res[pipe[0]]["STACK"] == 0 and res[pipe[0]]["LOCAL"] == 0, res[pipe[0]]


def test_last_ops_counts_and_refusals(dev):
    """Each entry point counts its own launches; the pipelined branch follows
    JAX's rule (K not one K tile, or a stacked weight: the ordinary
    producer); shapes a kernel does not take raise."""
    from nunchaku_tpu_torch.ops.attention import flash_attention_bshd, qkv_prepare
    from nunchaku_tpu_torch.ops.quantize import ln_mod_quant_int8_dual

    reset_launch_counts()
    ln_mod_quant_int8_dual(*checks.ln_dual_case(1, 64, 256, device=dev))
    streams, cos, sin = checks.qkv_rope_case(1, (64,), 2, 128, 0, device=dev)
    qkv, nq, nk = streams[0][:3]
    qkv_prepare(qkv, cos, sin, nq, nk, heads=2, head_dim=128)
    flash_attention_bshd(*checks.flash_bshd_case(1, 2, 64, 64, device=dev))
    args = checks.gelu_quant_case(128, 256, 256, device=dev)
    svdq_gemm_w8a8_gelu_quant(*args, pipelined=True)
    c = launch_counts()
    assert (c["ln_mod_quant_dual"], c["qkv_prepare"], c["flash_online_bshd"], c["gemm_w8a8_gelu_quant_pipe"]) == (
        1, 1, 1, 1), c
    assert c["ln_mod_quant_int8"] == c["qkv_rope_producer"] == c["flash_online"] == c["gemm_w8a8_gelu_quant"] == 0
    svdq_gemm_w8a8_gelu_quant(*checks.gelu_quant_case(128, 1024, 256, device=dev), pipelined=True)  # K tile 512
    qa, asc, w, *rest = args
    stack, ids = checks.stack_case(w)
    svdq_gemm_w8a8_gelu_quant(qa, asc, stack, *rest, pipelined=True, layer_idx=ids[-1])
    c = launch_counts()
    assert c["gemm_w8a8_gelu_quant_pipe"] == 1 and c["gemm_w8a8_gelu_quant"] == 1
    assert c["gemm_w8a8_gelu_quant_stacked"] == 1
    x, sc, sh, sma, pda, smb, pdb = checks.ln_dual_case(1, 64, 256, device=dev)
    with pytest.raises(ValueError):  # no modulation: JAX has no such form
        ln_mod_quant_int8_dual(x, None, None, sma, pda, smb, pdb)
    # rank 144 (refused before the kernel ran ranks above 128 in chunks): each head bit for bit its single launch
    pdb144 = torch.cat([pdb] * 4 + [pdb[:, :16]], dim=1)
    dual = ln_mod_quant_int8_dual(x, sc, sh, sma, pda, smb, pdb144)
    single = ln_mod_quant_int8_dual(x, sc, sh, smb, pdb144, sma, pda)  # the heads in the other order
    assert all(torch.equal(a, b) for a, b in zip(dual[0] + dual[1], single[1] + single[0]))
    streams, cos, sin = checks.qkv_rope_case(1, (64,), 2, 64, 0, device=dev)
    with pytest.raises(ValueError):  # head dim 64
        qkv_prepare(streams[0][0], cos, sin, streams[0][1], streams[0][2], heads=2, head_dim=64)
    with pytest.raises(ValueError):  # head dim 64
        flash_attention_bshd(*checks.flash_bshd_case(1, 2, 64, 64, d=64, device=dev))
    with pytest.raises(ValueError):  # M not a multiple of the 128-row tile
        svdq_gemm_w8a8_gelu_quant(*checks.gelu_quant_case(100, 256, 256, device=dev), pipelined=True)
    c = launch_counts()
    assert (c["ln_mod_quant_dual"], c["qkv_prepare"], c["flash_online_bshd"], c["gemm_w8a8_gelu_quant_pipe"]) == (
        3, 1, 1, 1), c


# ---------------------------------------------------------------------------
# the GEMM probe kernels (the ported tools; no model path)
# ---------------------------------------------------------------------------

# bench_gemm_variants' shape, probe_m512's, a tune_gemm_impl shape
PROBE_SHAPES = [(4608, 3072, 12288), (512, 3072, 9216), (5120, 12288, 3072)]
PROBE_I8 = [(acc, rank1, tile) for (acc, rank1), tiles in gemm_probe.I8_BUILT.items() for tile in tiles]


@pytest.mark.parametrize("m,k,n", PROBE_SHAPES)
@pytest.mark.parametrize("acc,rank1,tile", PROBE_I8)
def test_probe_i8_bit_for_bit(dev, m, k, n, acc, rank1, tile):
    """Every built instantiation of the int8 probe, bit for bit its plain
    version, one launch on its own count."""
    a, w, sa, sw = checks.probe_i8_case(m, k, n, device=dev)
    reset_launch_counts()
    _, ok, detail = checks.check_probe_i8(a, w, *((sa, sw) if rank1 else ()), acc=acc, tile=tile)
    assert ok, detail
    c = launch_counts()
    assert c[f"{gemm_probe.i8_mode(acc, rank1)}@{tile}"] == 1 and sum(c.values()) == 1, c


# bench_gemm_variants' and probe_m512's shapes, and N 384: the bf16 form's 256-column block tiles past N
@pytest.mark.parametrize("m,k,n", PROBE_SHAPES[:2] + [(256, 512, 384)])
@pytest.mark.parametrize("a_form,w_form,scaled", gemm_probe.BF16_FORMS)
def test_probe_bf16_forms(dev, m, k, n, a_form, w_form, scaled):
    """Every built operand form of the bf16-operand probe within one bf16
    step of its plain version up to the f32 sums' order."""
    args = checks.probe_bf16_case(m, k, n, a_form, w_form, scaled, device=dev)
    reset_launch_counts()
    _, ok, detail = checks.check_probe_bf16(*args, a_form=a_form, w_form=w_form)
    assert ok, detail
    assert launch_counts()[gemm_probe.bf16_mode(a_form, w_form, scaled)] == 1


def test_probe_layouts_and_refusals(dev):
    """W as (K, N) contiguous or as the transposed view of an (N, K) tensor:
    the same int8 product; refused shapes and forms raise before launching."""
    a, w, sa, sw = checks.probe_i8_case(256, 512, 256, device=dev)
    assert torch.equal(gemm_probe.gemm_probe_i8(a, w), gemm_probe.gemm_probe_i8(a, w.contiguous()))
    assert torch.equal(gemm_probe.gemm_probe_i8(a, w, sa, sw, acc="f32"),
                       gemm_probe.gemm_probe_i8(a, w.contiguous(), sa, sw, acc="f32"))
    reset_launch_counts()
    with pytest.raises(ValueError):
        gemm_probe.gemm_probe_i8(a[:192], w, tile="128x128x128s4p")
    with pytest.raises(ValueError):
        gemm_probe.gemm_probe_i8(a[:, :448].contiguous(), w[:448], acc="f32")  # the f32 mode sums whole 128-deep K tiles
    with pytest.raises(ValueError):
        gemm_probe.gemm_probe_i8(a, w, sa, sw, acc="i32")
    with pytest.raises(ValueError):
        gemm_probe.gemm_probe_bf16(a, w, a_form="i8", w_form="i8")  # w K-contiguous
    assert not any(launch_counts().values())
