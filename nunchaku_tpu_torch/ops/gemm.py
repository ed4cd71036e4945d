"""Quantized GEMMs: the w4a8 / int8 path's three Hopper kernels and
standalone int8 product, and the int4 / nvfp4 W4A4 kernel.

Counterparts of ``nunchaku_tpu/ops/gemm.py`` on the route the JAX package
takes by default for w4a8 (packed int4 weights dequantized to per-channel
int8 once per layer, then int8 x int8 products):

* :func:`dequant_w4a8` -- kernel ``csrc/dequant_w4a8.cu`` (JAX
  ``_dequant_w4a8_kernel`` :1074), for int4 codes and for the e2m1 codes of
  nvfp4-a8 (an nvfp4 checkpoint served through the int8 products; its
  launches count apart, as ``dequant_w4a8_e2m1``);
* :func:`svdq_gemm_w8a8_gelu_quant` -- kernel ``csrc/gemm_w8a8_gelu_quant.cu``
  (JAX ``_gemm_w8a8_gelu_quant_kernel`` :460), the fc1 GEMM whose epilogue
  emits fc2's int8 activations (any low-rank width, here and in the
  consumer: the kernels run ranks above 128 in chunks of 128); with
  ``pipelined=True`` (JAX's rule, :func:`chain_route`) the
  kernel ``csrc/gemm_w8a8_gelu_quant_pipe.cu`` (JAX
  ``_gemm_w8a8_gelu_quant_pipe_kernel`` :790), the same outputs bit for bit,
  one tile's product overlapping the previous tile's epilogue (count
  ``gemm_w8a8_gelu_quant_pipe``; no model path takes it, as in JAX);
* :func:`gemm_w8a8_grouped` -- kernel ``csrc/gemm_w8a8_grouped.cu`` (JAX
  ``_gemm_w8a8_kernel`` :344 in grouped-scale mode), the fc2 consumer; with
  ``residual=`` it takes the block's gated residual add into its epilogue
  (the kernel's ``n_res`` mode, counted as ``gemm_w8a8_grouped_res``),
  and :func:`res_apply` is the same add for routes that do not fuse it;
* :func:`gemm_w8a8_rank1` -- the same kernel in rank-1 mode (JAX
  ``_gemm_w8a8_kernel`` with per-token scales, :386), the stacked consumer
  of the per-token chain (``NUNCHAKU_TPU_CHAIN_PTOKEN=1``,
  :func:`chain_ptoken`, whose producer is the per-token mode of
  :func:`svdq_gemm_w8a8_gelu_quant`, JAX
  ``_gemm_w8a8_gelu_quant_ptoken_kernel`` :534);
* :func:`gemm_w8a8` -- the standalone int8 GEMM with rank-1 scales, which
  JAX leaves to XLA (``_gemm_w8a8_xla`` :1221, ``_int8_use_xla`` :858-870,
  for every non-stacked one): ``torch._int_mm`` plus PyTorch epilogue ops;
* :func:`gemm_w4a4` -- kernel ``csrc/gemm_w4a4.cu`` (JAX ``_gemm_w4a4_kernel``
  :125), the W4A4 product of the int4 / nvfp4 modes: 4-bit codes on both
  sides, decoded and scaled to bf16 per group, f32 accumulation.

The JAX package's two w4a8 route switches, read at each call
(:func:`w4a8_use_xla`, :func:`w4a8_fused`), move w4a8 off the dequant route
onto the packed-int4 route, whose kernels decode the int4 codes inside the
int8 GEMM and never write an int8 weight to HBM:

* :func:`gemm_w4a8` / :func:`gemm_w4a8_grouped` -- kernel ``csrc/gemm_w4a8.cu``
  (JAX ``_gemm_w4a8h_kernel`` :281 in its rank-1 and grouped-scale modes,
  and ``_gemm_w4a8_kernel`` :167, its explicit-tile twin): the standalone
  linears under ``NUNCHAKU_TPU_W4A8_XLA=0``, the chain's fc2 consumer;
* :func:`svdq_gemm_w4a8_gelu_quant` -- the W4 form of
  ``csrc/gemm_w8a8_gelu_quant.cu`` (JAX ``_gemm_w4a8_gelu_quant_kernel``
  :721), the chain's fc1 producer under ``NUNCHAKU_TPU_W4A8_FUSED=1``.

Stacked weights (JAX ``layer_idx=``, the scans): every kernel wrapper here
but the standalone :func:`gemm_w8a8` takes ``layer_idx``, a 0-d int32 tensor
on the weights' device, with ``qweight`` the whole stack: (L, K/2, N) packed
4-bit, or (L, K, N) int8 with each layer stored K-contiguous. The kernels
read the index on the card (the counterpart of the Pallas scalar prefetch)
and move their weight pointer to its layer: the same code as the
non-stacked launch on ``qweight[layer_idx]``, bit for bit; the index never
passes through the host. An index outside ``[0, L)`` raises in the plain
twins and is clamped to the nearest layer in the kernels, which read nothing
outside the stack. Each stacked mode counts its launches apart
(:data:`COUNTS`, under the mode's name + ``_stacked``). The 4-bit linears get their stacks from
``attach_stacked_weights`` (JAX ``linear.py:650``); the int8 and w4a8 MLP
chain pair's stacks come through ``gelu_mlp(stacked=...)`` (JAX
``attention.py:602-606``), so the int8 chain kernels read the layer of an
int8 stack. Only the standalone int8 linears take their layer's own (K, N)
view: JAX leaves them to XLA's dot, which slices the layer itself.

Each kernel has a plain PyTorch twin (``*_plain``) with the same numerics.
A wrapper takes the twin only for tensors on the CPU; for CUDA tensors it
launches the kernel (or raises) and adds one to its mode's count in
:data:`COUNTS`.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import torch

from ..core.packing import PACK_BLOCK, unpack_int4
from . import _build
from .quantize import rcp
from .reference import (
    GELU_SHIFT,
    GROUP_FP4,
    GROUP_INT4,
    RCP127,
    bf16_matmul,
    decode_e2m1,
    gelu,
    group_size,
    int8_matmul,
    is_4bit,
)

KERNEL_TILE_M = 128  # the chain GEMM kernels' block tile (csrc/gemm_sm90.cuh s8, the packed forms' too)
KERNEL_TILE_N = 128
KERNEL_TILE_K = 64  # K (and K / G) granularity: the s8 loop ends a K of 64 (mod 128) on a zero-filled half tile


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


# the kernel modes of this module; each counts its launches apart, and its stacked (layer-index) launches
# under its name + "_stacked"
MODES = ("dequant_w4a8", "gemm_w8a8_gelu_quant", "gemm_w8a8_grouped", "gemm_w8a8_grouped_res", "gemm_w4a4_int4",
         "gemm_w4a4_int4_unsigned", "gemm_w4a4_nvfp4", "dequant_w4a8_e2m1", "gemm_w4a8", "gemm_w4a8_grouped",
         "gemm_w4a8_gelu_quant", "gemm_w8a8_gelu_quant_ptoken", "gemm_w8a8_rank1", "gemm_w8a8_rank1_res")
COUNTS = {name: SimpleNamespace(launches=0) for mode in MODES for name in (mode, mode + "_stacked")}
COUNTS["gemm_w8a8_gelu_quant_pipe"] = SimpleNamespace(launches=0)  # no stacked form: JAX pipelines unstacked only


def _count(mode: str, layer_idx) -> None:
    """One launch of ``mode``, or of its stacked form when ``layer_idx`` is given."""
    COUNTS[mode if layer_idx is None else mode + "_stacked"].launches += 1


def layer_of(stack: torch.Tensor, layer_idx: torch.Tensor) -> torch.Tensor:
    """Layer ``layer_idx`` of an (L, ...) stack, for the plain twins (the
    index is read on the host there); an index outside [0, L) raises."""
    i = int(layer_idx)
    if not 0 <= i < stack.shape[0]:
        raise IndexError(f"layer index {i} is outside the stack of {stack.shape[0]} layers")
    return stack[i]


def _stacked(qweight: torch.Tensor, layer_idx: torch.Tensor | None):
    """-> (one layer of the weight, for the shape checks; the index's
    pointer or None; L) for a kernel launch. A stack must hold its layers
    back to back, each in the layout of a non-stacked weight."""
    if layer_idx is None:
        return qweight, None, 0
    _build.require(qweight.dim() == 3, f"a stacked weight is (L, ..., N), got {tuple(qweight.shape)}")
    _build.require(layer_idx.dim() == 0 and layer_idx.dtype == torch.int32 and layer_idx.device == qweight.device,
                   "layer_idx: a 0-d int32 tensor on the weights' device")
    layer = qweight[0]
    _build.require(qweight.stride(0) == layer.numel(), "the stack's layers must lie back to back")
    return layer, layer_idx.data_ptr(), qweight.shape[0]


def _int8_weight(qweight: torch.Tensor, layer_idx: torch.Tensor | None):
    """-> (the (K, N) int8 weight's K-contiguous storage, or the stack's, for
    the kernel; one layer, for the shape checks; the index's pointer; L). A
    non-stacked weight in another layout is copied once; a stack must keep
    each layer K-contiguous, as ``stack_modules`` stores it."""
    layer, idx_ptr, n_layers = _stacked(qweight, layer_idx)
    _build.require(qweight.dtype == torch.int8, "int8 operands expected")
    if layer_idx is None:
        return qweight.t().contiguous(), layer, None, 0  # (N, K): free for a K-contiguous weight
    _build.require(layer.t().is_contiguous(), "a stacked int8 weight keeps each layer K-contiguous")
    return qweight, layer, idx_ptr, n_layers


def chain_ptoken() -> bool:
    """``NUNCHAKU_TPU_CHAIN_PTOKEN`` (JAX ``_chain_ptoken``, gemm.py:903), read
    at each call. Off (the default: unset or "0"), the int8 chain producer
    emits one scale per (token, bn-column group); on, one scale per token
    (the per-token mode of :func:`svdq_gemm_w8a8_gelu_quant`), and the
    consumer is a rank-1 int8 product: the kernel's rank-1 mode on a stack
    (:func:`gemm_w8a8_rank1`), ``torch._int_mm`` otherwise."""
    return os.environ.get("NUNCHAKU_TPU_CHAIN_PTOKEN", "0") != "0"


def int8_tile_k(k: int) -> int:
    """The JAX int8 producer's K tile: ``bk = _pick_dim(K, (3072, 1536, 768,
    512, 1024, 256))`` (``gemm.py:1345-1352``), K itself when none divides."""
    return next((p for p in (3072, 1536, 768, 512, 1024, 256) if k % p == 0), k)


def chain_route(k: int, *, precision: str = "int8", ptoken: bool = False, pipelined: bool | None = None,
                layer_idx=None) -> str:
    """Which producer :func:`svdq_gemm_w8a8_gelu_quant` runs, JAX's order
    (``gemm.py:1344-1378``): "w4a8" for ``precision="w4a8"`` first, then
    "ptoken" for ``ptoken``, then "pipe" when ``pipelined`` (None means
    False) and K is one whole K tile (:func:`int8_tile_k`) on an unstacked
    weight, else "grouped" (the ordinary producer)."""
    if precision == "w4a8":
        return "w4a8"
    if ptoken:
        return "ptoken"
    if pipelined and k == int8_tile_k(k) and layer_idx is None:
        return "pipe"
    return "grouped"


def chain_tile_n(n: int) -> int:
    """Columns per requantize scale of the chain producer: the JAX producer's
    ``bn = _pick_dim(N, (1536, 1024, 512, 256, 128))`` (``gemm.py:1334``). The
    consumer reads one scale per token and ``bn``-wide K group, so this rule
    is part of the numerics."""
    return next((p for p in (1536, 1024, 512, 256, 128) if n % p == 0), n)


# ---------------------------------------------------------------------------
# kernel 1: w4a8 dequant
# ---------------------------------------------------------------------------


WCODES = ("int4", "e2m1")  # the w4a8 weight's 4-bit code forms: int4, or e2m1 (nvfp4-a8)


def w4a8_group(codes: str) -> int:
    """Rows per w4a8 rescale: 64 for int4 codes, 16 for e2m1 (the nvfp4
    group, JAX ``bf16_ref.py:52``)."""
    if codes not in WCODES:
        raise ValueError(f"w4a8 codes must be one of {WCODES}, got {codes!r}")
    return GROUP_INT4 if codes == "int4" else GROUP_FP4


def dequant_w4a8_plain(qweight: torch.Tensor, rescales: torch.Tensor, codes: str = "int4") -> torch.Tensor:
    """(K/2, N) packed 4-bit codes + (K/G, N) bf16 rescales -> (K, N) int8
    ``clip(round(value * rescale), -127, 127)`` in logical row order; the
    value is the signed nibble (int4) or its e2m1 decode (e2m1)."""
    half, n = qweight.shape
    k = half * 2
    g = k // rescales.shape[0]
    p = qweight.reshape(k // PACK_BLOCK, PACK_BLOCK // 2, n).to(torch.int16) & 0xFF
    lo = ((p & 0xF) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    w4 = torch.stack([lo, hi], dim=1).reshape(k // g, g, n)
    vals = decode_e2m1(w4) if codes == "e2m1" else w4.float()
    w = vals * rescales.float()[:, None, :]
    return torch.round(w).clamp(-127, 127).to(torch.int8).reshape(k, n)


def dequant_w4a8(qweight: torch.Tensor, rescales: torch.Tensor, codes: str = "int4",
                 layer_idx: torch.Tensor | None = None) -> torch.Tensor:
    """The (K, N) int8 codes of :func:`dequant_w4a8_plain`. On the card the
    kernel writes them K-contiguous: the result is a (K, N) view with
    strides (1, K), the layout int8 tensor-core products read directly. The
    e2m1 form counts its launches as ``dequant_w4a8_e2m1``. ``layer_idx``:
    qweight is an (L, K/2, N) stack and its layer ``layer_idx`` is
    dequantized (counts ``dequant_w4a8_stacked``, ``dequant_w4a8_e2m1_stacked``)."""
    g = w4a8_group(codes)
    if not qweight.is_cuda:
        return dequant_w4a8_plain(qweight if layer_idx is None else layer_of(qweight, layer_idx), rescales, codes)
    layer, idx_ptr, n_layers = _stacked(qweight, layer_idx)
    half, n = layer.shape
    k = half * 2
    _build.require(qweight.dtype == torch.int8 and layer.is_contiguous(), "qweight: contiguous int8")
    _build.require(rescales.dtype == torch.bfloat16 and rescales.is_contiguous(), "rescales: contiguous bf16")
    _build.require(k % PACK_BLOCK == 0 and n % 64 == 0,
                   f"dequant kernel needs K % 256 == 0, N % 64 == 0 (K={k}, N={n})")
    _build.require(tuple(rescales.shape) == (k // g, n),
                   f"{codes} rescales must be (K/{g}, N) = {(k // g, n)}, got {tuple(rescales.shape)}")
    out_t = torch.empty((n, k), dtype=torch.int8, device=qweight.device)
    lib = _build.library()
    _build.check(lib.nt_dequant_w4a8(qweight.data_ptr(), rescales.data_ptr(), out_t.data_ptr(), k, n,
                                     int(codes == "e2m1"), idx_ptr, n_layers, _stream(qweight)), "dequant_w4a8")
    _count("dequant_w4a8_e2m1" if codes == "e2m1" else "dequant_w4a8", layer_idx)
    return out_t.t()




def w4a8_use_xla() -> bool:
    """``NUNCHAKU_TPU_W4A8_XLA`` (JAX ``_w4a8_use_xla``, gemm.py:873), read at
    each call. On (the default: unset or anything but "0"), a standalone
    w4a8 linear dequantizes its weight to int8 and runs the int8 product,
    and the LN + modulate + quantize producer may feed it; "0" sends it to
    the packed GEMM (:func:`gemm_w4a8`) and turns the producer off for it."""
    return os.environ.get("NUNCHAKU_TPU_W4A8_XLA", "1") != "0"


def w4a8_fused() -> bool:
    """``NUNCHAKU_TPU_W4A8_FUSED`` (JAX ``_w4a8_fused``, gemm.py:889), read at
    each call. Off (the default: unset or "0"), the MLP chain dequantizes its
    w4a8 weights for the int8 chain kernels; on, the chain runs on the packed
    weights (:func:`svdq_gemm_w4a8_gelu_quant`, :func:`gemm_w4a8_grouped`)."""
    return os.environ.get("NUNCHAKU_TPU_W4A8_FUSED", "0") != "0"


# ---------------------------------------------------------------------------
# standalone int8 GEMM (XLA in the JAX package; torch._int_mm here)
# ---------------------------------------------------------------------------


def gemm_w8a8(qact, ascales, qweight, wscales, lora_act, proj_up, bias):
    """``(i32(qact @ qweight) * ascale[m] * wscale[n])`` rounded to bf16, then
    ``+ bf16(lora_act) @ proj_up + bias`` (JAX ``_gemm_w8a8_xla`` with its
    default bf16 rounding of the main term before the low-rank add)."""
    m = qact.shape[0]
    if m <= 16:  # torch._int_mm on the card needs M > 16; extra rows are sliced off
        qact = torch.nn.functional.pad(qact, (0, 0, 0, 32 - m))
    d = int8_matmul(qact, qweight)[:m]
    out = d.float() * ascales.reshape(m, 1).float() * wscales.reshape(1, -1).float()
    if lora_act is not None:
        out = out.to(torch.bfloat16).float() + bf16_matmul(lora_act, proj_up)
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    return out.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# kernel 2: GELU -> requantize chain producer
# ---------------------------------------------------------------------------


def chain_h_plain(qact, ascales, qweight, wscales, lora_act, proj_up, bias, rsmooth_next, proj_down_next,
                  act_unsigned_next=False):
    """The producer's epilogue up to the requantize: (h (M, N) f32, the values
    it quantizes, lora_next (M, R) f32)."""
    m, n = qact.shape[0], qweight.shape[1]
    d = int8_matmul(qact, qweight)
    out = d.float() * ascales.reshape(m, 1).float() * wscales.reshape(1, n).float()
    if lora_act is not None:
        out = out + bf16_matmul(lora_act, proj_up)
    if bias is not None:
        out = out + bias.reshape(1, n).float()
    g = gelu(out)
    lora_next = bf16_matmul(g, proj_down_next)  # raw (unshifted, unsmoothed) g
    if act_unsigned_next:
        g = g + GELU_SHIFT
    return g * rsmooth_next.reshape(1, n).float(), lora_next


def svdq_gemm_w8a8_gelu_quant_plain(qact, ascales, qweight, wscales, lora_act, proj_up, bias,
                                    rsmooth_next, proj_down_next, *, act_unsigned_next=False, ptoken=False):
    """The producer's numerics; ``ptoken``: one scale group of all N columns
    (qscales (1, M), JAX ``_gemm_w8a8_gelu_quant_ptoken_kernel``)."""
    m = qact.shape[0]
    n = qweight.shape[1]
    bn = n if ptoken else chain_tile_n(n)
    h, lora_next = chain_h_plain(qact, ascales, qweight, wscales, lora_act, proj_up, bias, rsmooth_next,
                                 proj_down_next, act_unsigned_next)
    h = h.reshape(m, n // bn, bn)
    scale = h.abs().amax(dim=-1) * RCP127  # (M, N/bn)
    q = torch.round(h * rcp(scale)[..., None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(m, n), scale.t().contiguous(), lora_next


def svdq_gemm_w8a8_gelu_quant(qact, ascales, qweight, wscales, lora_act, proj_up, bias,
                              rsmooth_next, proj_down_next, *, act_unsigned_next=False, rescales=None,
                              precision="int8", layer_idx=None, ptoken=False, pipelined=None):
    """int8 GEMM + fused GELU -> requantize: returns the NEXT layer's
    (qout (M, N) int8, qscales (N/bn, M) f32, lora_next (M, R) f32).

    ``qweight`` is int8 (K, N); ``rsmooth_next`` (N,) is 1/next.smooth and
    ``proj_down_next`` (N, R) the next layer's low-rank down-projection;
    ``act_unsigned_next`` adds the post-GELU shift of an unsigned next layer.
    The route follows JAX's order (:func:`chain_route`):
    ``precision="w4a8"``: ``qweight`` is packed int4 (K/2, N) with
    ``rescales`` (K/64, N), run by :func:`svdq_gemm_w4a8_gelu_quant` (JAX
    :1303-1330). ``ptoken`` (int8 only, as in JAX, where w4a8 returns
    before the switch is read): one scale per token, qscales (1, M) (JAX
    ``_gelu_quant_ptoken`` :607; counts ``gemm_w8a8_gelu_quant_ptoken`` and
    ``..._ptoken_stacked``). ``pipelined`` (None means False, JAX's default):
    when K is one whole K tile of JAX's pick and ``layer_idx`` is None, the
    software-pipelined kernel (JAX ``_gelu_quant_pipelined`` :1602; count
    ``gemm_w8a8_gelu_quant_pipe``), the same outputs bit for bit; otherwise
    the ordinary producer, as JAX falls through. ``layer_idx``: qweight is
    the (L, K, N) int8 (or (L, K/2, N) packed) stack and the kernel reads
    layer ``layer_idx`` (count ``gemm_w8a8_gelu_quant_stacked``)."""
    route = chain_route(qact.shape[-1], precision=precision, ptoken=ptoken, pipelined=pipelined,
                        layer_idx=layer_idx)
    if route == "w4a8":
        return svdq_gemm_w4a8_gelu_quant(qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias,
                                         rsmooth_next, proj_down_next, act_unsigned_next=act_unsigned_next,
                                         layer_idx=layer_idx)
    if precision != "int8":
        raise ValueError(f"the chain producer takes int8 or w4a8 weights, got precision {precision!r}")
    if not qact.is_cuda:
        return svdq_gemm_w8a8_gelu_quant_plain(
            qact, ascales, qweight if layer_idx is None else layer_of(qweight, layer_idx), wscales, lora_act,
            proj_up, bias, rsmooth_next, proj_down_next, act_unsigned_next=act_unsigned_next, ptoken=ptoken)
    if route == "pipe":
        out = _gelu_quant_pipe_launch(qact, ascales, qweight, wscales, lora_act, proj_up, bias, rsmooth_next,
                                      proj_down_next, act_unsigned_next)
        _count("gemm_w8a8_gelu_quant_pipe", None)
        return out
    out = _gelu_quant_launch(qact, ascales, qweight, None, wscales, lora_act, proj_up, bias, rsmooth_next,
                             proj_down_next, act_unsigned_next, layer_idx, ptoken)
    _count("gemm_w8a8_gelu_quant_ptoken" if ptoken else "gemm_w8a8_gelu_quant", layer_idx)
    return out


def _gelu_quant_pipe_launch(qact, ascales, qweight, wscales, lora_act, proj_up, bias, rsmooth_next,
                            proj_down_next, act_unsigned_next):
    """Launch the pipelined producer on an unstacked (K, N) int8 weight."""
    m, k = qact.shape
    wt, _, _, _ = _int8_weight(qweight, None)
    n = qweight.shape[1]
    bn = chain_tile_n(n)
    r = 0 if lora_act is None else lora_act.shape[1]
    r2 = proj_down_next.shape[1]
    _build.require(m % KERNEL_TILE_M == 0 and bn % KERNEL_TILE_N == 0 and bn <= 1536 and k % KERNEL_TILE_K == 0,
                   f"pipelined gelu-quant kernel needs M % 128, bn % 128, K % 64 == 0, bn <= 1536 "
                   f"(M={m}, bn={bn}, K={k})")
    _build.require(r2 >= 1, "proj_down_next needs at least one column")
    _build.require(qact.dtype == torch.int8, "int8 activations expected")
    dev = qact.device
    qa = qact.contiguous()
    a_s = ascales.reshape(m).float().contiguous()
    w_s = wscales.reshape(n).float().contiguous()
    la = None if lora_act is None else lora_act.float().contiguous()
    pu = None if proj_up is None else proj_up.to(torch.bfloat16).contiguous()
    b = None if bias is None else bias.to(torch.bfloat16).contiguous()
    rsm = rsmooth_next.reshape(n).float().contiguous()
    pd = proj_down_next.to(torch.bfloat16).contiguous()
    gbuf = torch.empty((m, n), dtype=torch.float32, device=dev)  # scratch: g between the two kernels
    amax_part = torch.empty((n // KERNEL_TILE_N, m), dtype=torch.float32, device=dev)
    lora_part = torch.empty((n // KERNEL_TILE_N, m, -(-r2 // 16) * 16), dtype=torch.float32, device=dev)
    qout = torch.empty((m, n), dtype=torch.int8, device=dev)
    qscales = torch.empty((n // bn, m), dtype=torch.float32, device=dev)
    lora_next = torch.empty((m, r2), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.check(lib.nt_gemm_w8a8_gelu_quant_pipe(
        qa.data_ptr(), a_s.data_ptr(), wt.data_ptr(), w_s.data_ptr(), _ptr(la), _ptr(pu), _ptr(b), rsm.data_ptr(),
        pd.data_ptr(), gbuf.data_ptr(), amax_part.data_ptr(), lora_part.data_ptr(), qout.data_ptr(), qscales.data_ptr(),
        lora_next.data_ptr(), m, n, k, r, r2, bn, GELU_SHIFT if act_unsigned_next else 0.0, _stream(qact)),
        "gemm_w8a8_gelu_quant_pipe")
    return qout, qscales, lora_next


def _gelu_quant_launch(qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias, rsmooth_next,
                       proj_down_next, act_unsigned_next, layer_idx=None, ptoken=False):
    """Launch the producer's int8 form (``rescales`` None: qweight (K, N)
    int8) or its W4 form (qweight packed int4 (K/2, N), rescales (K/64, N)),
    on layer ``layer_idx`` of a stack when it is given; ``ptoken``: one scale
    group of all N columns."""
    m, k = qact.shape
    if rescales is None:
        wt, layer, idx_ptr, n_layers = _int8_weight(qweight, layer_idx)
        weight = (wt,)
    else:
        layer, idx_ptr, n_layers = _stacked(qweight, layer_idx)
        weight = (qweight, rescales)
    n = layer.shape[1]
    bn = n if ptoken else chain_tile_n(n)
    r = 0 if lora_act is None else lora_act.shape[1]
    r2 = proj_down_next.shape[1]
    _build.require(m % KERNEL_TILE_M == 0 and n % KERNEL_TILE_N == 0 and k % KERNEL_TILE_K == 0,
             f"gelu-quant kernel needs M % 128, N % 128, K % 64 == 0 (M={m}, N={n}, K={k})")
    _build.require(r2 >= 1, "proj_down_next needs at least one column")
    dev = qact.device
    qa = qact.contiguous()
    a_s = ascales.reshape(m).float().contiguous()
    w_s = wscales.reshape(n).float().contiguous()
    la = None if lora_act is None else lora_act.float().contiguous()
    pu = None if proj_up is None else proj_up.to(torch.bfloat16).contiguous()
    b = None if bias is None else bias.to(torch.bfloat16).contiguous()
    rsm = rsmooth_next.reshape(n).float().contiguous()
    pd = proj_down_next.to(torch.bfloat16).contiguous()
    _build.require(qa.dtype == torch.int8, "int8 activations expected")
    tiles = n // KERNEL_TILE_N
    _build.require(n // bn <= 256, f"at most 256 scale groups per row, got {n // bn}")
    gbuf = torch.empty((m, n), dtype=torch.float32, device=dev)  # scratch: g between the two kernels
    amax_part = torch.empty((tiles, m), dtype=torch.float32, device=dev)
    lora_part = torch.empty((tiles, m, -(-r2 // 16) * 16), dtype=torch.float32, device=dev)
    qout = torch.empty((m, n), dtype=torch.int8, device=dev)
    qscales = torch.empty((n // bn, m), dtype=torch.float32, device=dev)
    lora_next = torch.empty((m, r2), dtype=torch.float32, device=dev)
    lib = _build.library()
    entry = lib.nt_gemm_w8a8_gelu_quant if rescales is None else lib.nt_gemm_w4a8_gelu_quant
    _build.check(entry(
        qa.data_ptr(), a_s.data_ptr(), *(t.data_ptr() for t in weight), w_s.data_ptr(), _ptr(la), _ptr(pu),
        _ptr(b), rsm.data_ptr(), pd.data_ptr(), gbuf.data_ptr(), amax_part.data_ptr(), lora_part.data_ptr(),
        qout.data_ptr(), qscales.data_ptr(), lora_next.data_ptr(), m, n, k, r, r2, bn,
        GELU_SHIFT if act_unsigned_next else 0.0, idx_ptr, n_layers, _stream(qact)), entry.__name__)
    return qout, qscales, lora_next




# ---------------------------------------------------------------------------
# kernel 3: grouped-scale consumer, with the gated-residual epilogue
# ---------------------------------------------------------------------------


def res_apply(out, x, gate, extra=None, extra_la=None, extra_pu=None):
    """The block's gated residual add on a finished GEMM output (JAX
    ``_res_apply_xla``, gemm.py:1869): ``x + gate * (out + bf16(extra +
    bf16(extra_la) @ extra_pu))`` in f32, rounded to ``out``'s dtype. ``out``,
    ``x``, ``extra`` are (M, N) or (B, S, N) with M = B*S; ``gate`` is the
    (B, N) AdaLN gate of each batch row."""
    b, n = gate.shape
    t = out.float()
    if extra is not None:
        e = extra.float()
        if extra_la is not None:
            e = e + bf16_matmul(extra_la, extra_pu)
        t = t + e.to(torch.bfloat16).float()
    r = x.float().reshape(b, -1, n) + gate.float().reshape(b, 1, n) * t.reshape(b, -1, n)
    return r.reshape(out.shape).to(out.dtype)


def gemm_w8a8_grouped_plain(qact, ascales, qweight, wscales, lora_act, proj_up, bias, residual=None):
    m, k = qact.shape
    ga = ascales.shape[0]
    bk = k // ga
    acc = None
    for g in range(ga):
        d = int8_matmul(qact[:, g * bk:(g + 1) * bk], qweight[g * bk:(g + 1) * bk])
        part = d.float() * ascales[g].reshape(m, 1).float()
        acc = part if acc is None else acc + part
    out = acc * wscales.reshape(1, -1).float()
    if lora_act is not None:
        out = out + bf16_matmul(lora_act, proj_up)
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    out = out.to(torch.bfloat16)
    return out if residual is None else res_apply(out, *residual)


def _grouped_launch(qact, ascales, qweight, wscales, lora_act, proj_up, bias, residual, layer_idx=None):
    """Launch the consumer kernel: grouped (G > 1) or rank-1 (G = 1) scales,
    with or without the residual epilogue, on layer ``layer_idx`` of an
    (L, K, N) stack when it is given."""
    m, k = qact.shape
    wt, layer, idx_ptr, n_layers = _int8_weight(qweight, layer_idx)
    n = layer.shape[1]
    ga = ascales.shape[0]
    r = 0 if lora_act is None else lora_act.shape[1]
    _build.require(m % KERNEL_TILE_M == 0 and n % KERNEL_TILE_N == 0 and k % ga == 0
                   and (k // ga) % KERNEL_TILE_K == 0,
                   f"grouped kernel needs M % 128, N % 128, (K/G) % 64 == 0 (M={m}, N={n}, K={k}, G={ga})")
    qa = qact.contiguous()
    a_s = ascales.float().contiguous()
    w_s = wscales.reshape(n).float().contiguous()
    la = None if lora_act is None else lora_act.float().contiguous()
    pu = None if proj_up is None else proj_up.to(torch.bfloat16).contiguous()
    b = None if bias is None else bias.to(torch.bfloat16).contiguous()
    _build.require(qa.dtype == torch.int8, "int8 operands expected")
    x = gate = extra = ela = epu = None
    rows, r2 = m, 0
    if residual is not None:
        x, gate, extra, ela, epu = tuple(residual) + (None,) * (5 - len(residual))
        _build.require(m % gate.shape[0] == 0 and gate.shape[1] == n, "gate must be (B, N) with B | M")
        rows = m // gate.shape[0]
        x = x.reshape(m, n).to(torch.bfloat16).contiguous()
        gate = gate.float().contiguous()
        if extra is not None:
            extra = extra.reshape(m, n).to(torch.bfloat16).contiguous()
        if ela is not None:
            _build.require(extra is not None, "extra_la needs extra")
            r2 = ela.shape[-1]
            ela = ela.reshape(m, r2).float().contiguous()
            epu = epu.to(torch.bfloat16).contiguous()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=qact.device)
    lib = _build.library()
    _build.check(lib.nt_gemm_w8a8_grouped(
        qa.data_ptr(), a_s.data_ptr(), wt.data_ptr(), w_s.data_ptr(), _ptr(la), _ptr(pu), _ptr(b),
        _ptr(x), _ptr(gate), _ptr(extra), _ptr(ela), _ptr(epu), out.data_ptr(), m, n, k, ga, r, rows, r2,
        idx_ptr, n_layers, _stream(qact)), "gemm_w8a8_grouped")
    return out


def gemm_w8a8_grouped(qact, ascales, qweight, wscales, lora_act, proj_up, bias, residual=None, layer_idx=None):
    """int8 GEMM over grouped activation scales ``ascales (G, M)``: each
    K/G-wide group's int32 partial is scaled by its scale before the f32
    sum; then ``* wscale + bf16(lora_act) @ proj_up + bias`` -> bf16.

    ``residual = (x, gate[, extra[, extra_la, extra_pu]])`` returns
    :func:`res_apply` of that output instead, computed in the kernel's
    epilogue (:func:`gemm_w8a8_grouped_res` on the card). ``layer_idx``:
    qweight is an (L, K, N) stack, each layer K-contiguous, and the kernel
    reads layer ``layer_idx`` (counts ``gemm_w8a8_grouped_stacked``,
    ``gemm_w8a8_grouped_res_stacked``)."""
    if residual is not None:
        return gemm_w8a8_grouped_res(qact, ascales, qweight, wscales, lora_act, proj_up, bias, residual,
                                     layer_idx)
    if not qact.is_cuda:
        return gemm_w8a8_grouped_plain(qact, ascales, qweight if layer_idx is None else layer_of(qweight, layer_idx),
                                       wscales, lora_act, proj_up, bias)
    out = _grouped_launch(qact, ascales, qweight, wscales, lora_act, proj_up, bias, None, layer_idx)
    _count("gemm_w8a8_grouped", layer_idx)
    return out


def gemm_w8a8_grouped_res(qact, ascales, qweight, wscales, lora_act, proj_up, bias, residual, layer_idx=None):
    """The grouped consumer in its gated-residual mode (its own launch
    count, so a run shows which mode it went through)."""
    if not qact.is_cuda:
        return gemm_w8a8_grouped_plain(qact, ascales, qweight if layer_idx is None else layer_of(qweight, layer_idx),
                                       wscales, lora_act, proj_up, bias, residual)
    out = _grouped_launch(qact, ascales, qweight, wscales, lora_act, proj_up, bias, residual, layer_idx)
    _count("gemm_w8a8_grouped_res", layer_idx)
    return out


def gemm_w8a8_rank1(qact, ascales, qweight, wscales, lora_act, proj_up, bias, residual=None, layer_idx=None):
    """The consumer kernel in rank-1 mode (JAX ``_gemm_w8a8_kernel`` with
    per-token scales, :386): ``bf16(f32(i32(qact @ w)) * ascale[m] * wscale[n]
    + bf16(lora_act) @ proj_up + bias)``, ascales (1, M), the epilogue all
    f32 (not :func:`gemm_w8a8`'s, which rounds its main term to bf16 before
    the low-rank add, as JAX's XLA route does); with ``residual``, the
    gated-residual epilogue of :func:`gemm_w8a8_grouped`. The stacked int8
    product of the per-token chain (``layer_idx``: qweight an (L, K, N)
    stack; counts ``gemm_w8a8_rank1_stacked``, ``..._res_stacked``); JAX
    sends every non-stacked per-token int8 product to XLA, so the model
    takes this mode stacked only (non-stacked counts ``gemm_w8a8_rank1``,
    ``gemm_w8a8_rank1_res``). The kernel sums the exact int32 product over
    all of K before the one f32 conversion; the JAX kernel converts each
    bk-step partial, so the two can differ by f32 rounding of the sum."""
    _build.require(ascales.ndim == 2 and ascales.shape[0] == 1, "rank-1 ascales must be (1, M)")
    if not qact.is_cuda:
        return gemm_w8a8_grouped_plain(qact, ascales, qweight if layer_idx is None else layer_of(qweight, layer_idx),
                                       wscales, lora_act, proj_up, bias, residual)
    out = _grouped_launch(qact, ascales, qweight, wscales, lora_act, proj_up, bias, residual, layer_idx)
    _count("gemm_w8a8_rank1" if residual is None else "gemm_w8a8_rank1_res", layer_idx)
    return out




# ---------------------------------------------------------------------------
# kernels 10-12: the packed-int4 w4a8 route (int4 decoded inside the int8 GEMM)
# ---------------------------------------------------------------------------


def _require_packed(qweight, rescales, k):
    """What the packed kernels take: int4 codes (K/2, N) with bf16
    rescales (K/64, N), K % 256 == 0. e2m1 codes (nvfp4-a8, (K/16, N)
    rescales) have no packed kernel, as in JAX (gemm.py:2081-2085,
    :2183-2187): they take the dequant route."""
    n = qweight.shape[1]
    _build.require(qweight.dtype == torch.int8 and qweight.is_contiguous() and 2 * qweight.shape[0] == k,
                   f"qweight: contiguous int8 (K/2, N) packed int4 with K = {k}")
    _build.require(k % PACK_BLOCK == 0, f"packed kernels need K % 256 == 0 (K={k})")
    _build.require(rescales.dtype == torch.bfloat16 and rescales.is_contiguous()
                   and tuple(rescales.shape) == (k // GROUP_INT4, n),
                   f"rescales must be contiguous bf16 (K/64, N) = {(k // GROUP_INT4, n)} (int4 codes; e2m1 "
                   f"codes take the dequant route), got {rescales.dtype} {tuple(rescales.shape)}")


def gemm_w4a8_plain(qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias):
    """The packed GEMM's numerics in both modes: :func:`dequant_w4a8_plain`'s
    int8 weight, then the JAX kernel's f32 epilogue (gemm.py:224-234, :323)
    rounded to bf16 once. ascales (1, M): ``i32 acc * as * ws``; (G, M): each
    K/G group's partial scaled by its scale before the f32 sum, in group
    order, then ``* ws``; both ``+ bf16(lora_act) @ proj_up + bias``. Not the
    dequant route's :func:`gemm_w8a8`, which rounds its main term to bf16
    before the low-rank add."""
    return gemm_w8a8_grouped_plain(qact, ascales, dequant_w4a8_plain(qweight, rescales), wscales, lora_act,
                                   proj_up, bias)


def _w4a8_launch(qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias, layer_idx=None):
    m, k = qact.shape
    _, idx_ptr, n_layers = _stacked(qweight, layer_idx)
    n = qweight.shape[-1]
    ga = ascales.shape[0]
    r = 0 if lora_act is None else lora_act.shape[1]
    _build.require(qact.dtype == torch.int8 and n % KERNEL_TILE_N == 0 and k % ga == 0
                   and (k // ga) % KERNEL_TILE_K == 0,
                   f"packed GEMM needs int8 qact, N % 128, (K/G) % 64 == 0 (N={n}, K={k}, G={ga})")
    # any M: the kernel's TMA copies read zeros past the last row, and it writes no row at or past M
    qa = _aligned16(qact.contiguous())
    a_s = ascales.float().contiguous()
    la = None if lora_act is None else lora_act.float().contiguous()
    pu = None if proj_up is None else proj_up.to(torch.bfloat16).contiguous()
    b = None if bias is None else bias.to(torch.bfloat16).contiguous()
    w_s = wscales.reshape(n).float().contiguous()
    _build.require(qweight.data_ptr() % 16 == 0 and rescales.data_ptr() % 16 == 0,
                   "the packed GEMM's TMA copies need 16-byte aligned qweight and rescales")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=qact.device)
    lib = _build.library()
    _build.check(lib.nt_gemm_w4a8(qa.data_ptr(), a_s.data_ptr(), qweight.data_ptr(), rescales.data_ptr(),
                                  w_s.data_ptr(), _ptr(la), _ptr(pu), _ptr(b), out.data_ptr(), m, n, k, ga,
                                  r, idx_ptr, n_layers, _stream(qact)), "gemm_w4a8")
    return out


def gemm_w4a8(qact, ascales, qweight, rescales, wscales, lora_act=None, proj_up=None, bias=None, layer_idx=None):
    """The packed GEMM in rank-1 mode (JAX ``_gemm_w4a8h_kernel``, and
    ``_gemm_w4a8_kernel`` of explicit tiles): qact (M, K) int8, ascales
    (1, M) f32, qweight (K/2, N) packed int4 codes, rescales (K/64, N) bf16,
    wscales (1, N) f32; lora_act (M, R), proj_up (R, N), bias (N,) or None
    -> (M, N) bf16 (:func:`gemm_w4a8_plain`). ``layer_idx``: qweight is an
    (L, K/2, N) stack, the product takes its layer ``layer_idx`` (count
    ``gemm_w4a8_stacked``; the other operands are that layer's)."""
    _build.require(ascales.ndim == 2 and ascales.shape[0] == 1, "rank-1 ascales must be (1, M)")
    if not qact.is_cuda:
        layer = qweight if layer_idx is None else layer_of(qweight, layer_idx)
        _require_packed(layer, rescales, qact.shape[1])
        return gemm_w4a8_plain(qact, ascales, layer, rescales, wscales, lora_act, proj_up, bias)
    _require_packed(_stacked(qweight, layer_idx)[0], rescales, qact.shape[1])
    out = _w4a8_launch(qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias, layer_idx)
    _count("gemm_w4a8", layer_idx)
    return out


def gemm_w4a8_grouped(qact, ascales, qweight, rescales, wscales, lora_act=None, proj_up=None, bias=None,
                      layer_idx=None):
    """The packed GEMM in grouped-scale mode, the packed chain's consumer:
    ascales (G, M), G > 1, from :func:`svdq_gemm_w4a8_gelu_quant`; other
    operands as :func:`gemm_w4a8`. No residual epilogue: the caller applies
    :func:`res_apply` (JAX ``res_fused = is_int8 and have_res``, :2249).
    ``layer_idx``: qweight is an (L, K/2, N) stack (count
    ``gemm_w4a8_grouped_stacked``)."""
    _build.require(ascales.ndim == 2 and ascales.shape[0] > 1, "grouped ascales must be (G, M) with G > 1")
    if not qact.is_cuda:
        layer = qweight if layer_idx is None else layer_of(qweight, layer_idx)
        _require_packed(layer, rescales, qact.shape[1])
        return gemm_w4a8_plain(qact, ascales, layer, rescales, wscales, lora_act, proj_up, bias)
    _require_packed(_stacked(qweight, layer_idx)[0], rescales, qact.shape[1])
    out = _w4a8_launch(qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias, layer_idx)
    _count("gemm_w4a8_grouped", layer_idx)
    return out




def svdq_gemm_w4a8_gelu_quant_plain(qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias,
                                    rsmooth_next, proj_down_next, *, act_unsigned_next=False):
    """The W4 producer's numerics: :func:`dequant_w4a8_plain`'s weight
    through :func:`svdq_gemm_w8a8_gelu_quant_plain` (JAX
    ``_gemm_w4a8_gelu_quant_kernel``'s epilogue is the int8 producer's)."""
    return svdq_gemm_w8a8_gelu_quant_plain(qact, ascales, dequant_w4a8_plain(qweight, rescales), wscales,
                                           lora_act, proj_up, bias, rsmooth_next, proj_down_next,
                                           act_unsigned_next=act_unsigned_next)


def svdq_gemm_w4a8_gelu_quant(qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias,
                              rsmooth_next, proj_down_next, *, act_unsigned_next=False, layer_idx=None):
    """The chain producer on packed int4 weights (the W4 form of
    ``csrc/gemm_w8a8_gelu_quant.cu``): :func:`svdq_gemm_w8a8_gelu_quant`'s
    outputs with qweight (K/2, N) packed int4 codes and rescales (K/64, N).
    ``layer_idx``: qweight is an (L, K/2, N) stack, the rescales the layer's
    (count ``gemm_w4a8_gelu_quant_stacked``)."""
    if not qact.is_cuda:
        layer = qweight if layer_idx is None else layer_of(qweight, layer_idx)
        _require_packed(layer, rescales, qact.shape[1])
        return svdq_gemm_w4a8_gelu_quant_plain(qact, ascales, layer, rescales, wscales, lora_act, proj_up,
                                               bias, rsmooth_next, proj_down_next,
                                               act_unsigned_next=act_unsigned_next)
    _require_packed(_stacked(qweight, layer_idx)[0], rescales, qact.shape[1])
    out = _gelu_quant_launch(qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias, rsmooth_next,
                             proj_down_next, act_unsigned_next, layer_idx)
    _count("gemm_w4a8_gelu_quant", layer_idx)
    return out




# ---------------------------------------------------------------------------
# kernel 8: the int4 / nvfp4 W4A4 GEMM
# ---------------------------------------------------------------------------

W4A4_TILE_N = 128  # csrc/gemm_w4a4.cu block tile
# (precision, act_unsigned) -> the kernel's mode and the name of its launch count
W4A4_MODES = {("int4", False): (0, "gemm_w4a4_int4"), ("int4", True): (1, "gemm_w4a4_int4_unsigned"),
              ("nvfp4", False): (2, "gemm_w4a4_nvfp4")}


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its storage offset leaves it off a 16-byte
    boundary (a TMA copy's source must start on one)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def w4a4_values(packed: torch.Tensor, dim: int, *, precision: str, unsigned: bool = False) -> torch.Tensor:
    """Packed 4-bit codes -> their f32 values in logical order along ``dim``:
    int4 nibbles (sign-extended unless ``unsigned``) or e2m1 codes."""
    raw = unpack_int4(packed, dim, unsigned=unsigned)
    return decode_e2m1(raw) if precision == "nvfp4" else raw.float()


def gemm_w4a4_plain(qact, ascales, qweight, wscales, lora_act, proj_up, bias, *, precision, act_unsigned=False):
    """``bf16(sum_k bf16(a_k sa) bf16(w_k sw) + bf16(lora_act) @ proj_up +
    bias)`` with f32 sums (JAX ``_gemm_w4a4_kernel``: each value x group
    scale product rounded to bf16 on both operands)."""
    g = group_size(precision)
    a = w4a4_values(qact, -1, precision=precision, unsigned=act_unsigned)  # (M, K)
    w = w4a4_values(qweight, 0, precision=precision)  # (K, N)
    a = (a * ascales.float().repeat_interleave(g, dim=0).t()).to(torch.bfloat16)
    w = (w * wscales.float().repeat_interleave(g, dim=0)).to(torch.bfloat16)
    out = a.float() @ w.float()  # bf16 x bf16 products are exact in f32
    if lora_act is not None:
        out = out + bf16_matmul(lora_act, proj_up)
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    return out.to(torch.bfloat16)


def gemm_w4a4(qact, ascales, qweight, wscales, lora_act, proj_up, bias, *, precision, act_unsigned=False,
              layer_idx=None):
    """The W4A4 product of :func:`gemm_w4a4_plain` -> (M, N) bf16.

    qact (M, K/2) int8 packed along K; ascales (K/G, M) bf16; qweight the
    (K/2, N) packed weight (the kernel reads it K-contiguous: stored so, as
    ``SVDQW4A4Linear`` keeps it; another layout raises); wscales (K/G, N) bf16;
    lora_act (M, R) f32, proj_up (R, N), bias (N,) or None. G = 64 (int4)
    or 16 (nvfp4); ``act_unsigned`` only with int4. Each mode keeps its own
    launch count (:data:`W4A4_MODES`). ``layer_idx``: qweight is an (L, K/2,
    N) stack whose layers are each stored K-contiguous, and the product
    takes its layer ``layer_idx`` (counts ``gemm_w4a4_int4_stacked`` /
    ``gemm_w4a4_nvfp4_stacked``, ``gemm_w4a4_int4_unsigned_stacked``)."""
    if (precision, bool(act_unsigned)) not in W4A4_MODES:
        raise ValueError(f"no W4A4 mode for precision {precision!r} with act_unsigned={act_unsigned}")
    if not qact.is_cuda:
        return gemm_w4a4_plain(qact, ascales, qweight if layer_idx is None else layer_of(qweight, layer_idx),
                               wscales, lora_act, proj_up, bias, precision=precision, act_unsigned=act_unsigned)
    mode, count = W4A4_MODES[(precision, bool(act_unsigned))]
    layer, idx_ptr, n_layers = _stacked(qweight, layer_idx)
    m, half = qact.shape
    k, n = 2 * half, layer.shape[1]
    g = group_size(precision)
    _build.require(qact.dtype == torch.int8 and qact.is_contiguous(), "qact: contiguous int8")
    _build.require(qweight.dtype == torch.int8 and layer.shape[0] == half and layer.t().is_contiguous(),
                   "qweight: (K/2, N) int8 stored K-contiguous")
    _build.require(k % PACK_BLOCK == 0 and n % W4A4_TILE_N == 0 and m % 8 == 0,
                   f"W4A4 kernel needs K % 256, N % 128, M % 8 == 0 (M={m}, K={k}, N={n})")
    for name, s, cols in (("ascales", ascales, m), ("wscales", wscales, n)):
        _build.require(s.dtype == torch.bfloat16 and s.is_contiguous() and tuple(s.shape) == (k // g, cols),
                       f"{name}: contiguous bf16 (K/{g}, {cols}), got {s.dtype} {tuple(s.shape)}")
    r = 0 if lora_act is None else lora_act.shape[1]
    la = None if lora_act is None else lora_act.float().contiguous()
    pu = None if proj_up is None else _aligned16(proj_up.to(torch.bfloat16).contiguous())
    b = None if bias is None else bias.to(torch.bfloat16).contiguous()
    ascales, wscales = _aligned16(ascales), _aligned16(wscales)
    _build.require(qact.data_ptr() % 16 == 0 and qweight.data_ptr() % 16 == 0,
                   "the W4A4 kernel's TMA copies need 16-byte aligned qact and qweight")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=qact.device)
    lib = _build.library()
    _build.check(lib.nt_gemm_w4a4(qact.data_ptr(), ascales.data_ptr(), qweight.data_ptr(), wscales.data_ptr(),
                                  _ptr(la), _ptr(pu), _ptr(b), out.data_ptr(), m, n, k, r, mode, idx_ptr,
                                  n_layers, _stream(qact)), "gemm_w4a4")
    _count(count, layer_idx)
    return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def svdq_gemm_w4a4(qact, ascales, qweight, wscales, lora_act=None, proj_up=None, bias=None,
                   rescales=None, *, precision="int8", act_unsigned=False, residual=None, wcodes="int4",
                   layer_idx=None):
    """The branches of the JAX ``svdq_gemm_w4a4``, in its order
    (gemm.py:1975-2117).

    int8: qact (M, K) int8, ascales (1, M) per token or (G, M) grouped,
    qweight (K, N) int8, wscales (1, N); grouped scales (G > 1, from the
    chain producer) go to the grouped kernel, per-token scales to the
    standalone int8 GEMM. w4a8: qweight is packed int4 (K/2, N) with
    ``rescales`` (K/64, N), or e2m1 codes (``wcodes="e2m1"``, nvfp4-a8) with
    ``rescales`` (K/16, N). Grouped scales take the packed consumer
    (:func:`gemm_w4a8_grouped`; e2m1 raises, as in JAX); per-token scales
    the packed GEMM (:func:`gemm_w4a8`) when :func:`w4a8_use_xla` is off and
    the codes are int4, else the dequant route (:func:`dequant_w4a8`, then
    the int8 product). int4 / nvfp4 (``act_unsigned``: unsigned int4
    activations): :func:`gemm_w4a4`. ``residual = (x, gate[, extra[,
    extra_la, extra_pu]])`` adds the block's gated residual
    (:func:`res_apply`): in the int8 grouped kernel's epilogue, else after
    the GEMM.

    ``layer_idx`` (a 0-d int32 tensor on the card, or on the CPU for the
    twins): ``qweight`` is the whole stack of a scan and the layer
    ``layer_idx`` is read by the kernel (JAX :1975-2060): int4 / nvfp4 take
    the W4A4 kernel's stacked mode; w4a8 the stacked dequant or, on the
    packed route, the packed GEMM's stacked rank-1 or grouped mode; int8
    (an (L, K, N) stack, the MLP chain's fc2) the consumer kernel's stacked
    grouped mode or, with per-token scales, its stacked rank-1 mode
    (:func:`gemm_w8a8_rank1`): a stacked int8 product never takes
    ``torch._int_mm``, as a stacked one never takes XLA's dot in JAX
    (:1989-1996, :2050-2056)."""
    if is_4bit(precision):
        out = gemm_w4a4(qact, ascales, qweight, wscales, lora_act, proj_up, bias, precision=precision,
                        act_unsigned=act_unsigned, layer_idx=layer_idx)
        return out if residual is None else res_apply(out, *residual)
    if precision == "w4a8":
        grouped = ascales.ndim == 2 and ascales.shape[0] > 1
        if grouped or not (w4a8_use_xla() or wcodes == "e2m1"):
            if wcodes == "e2m1":
                raise ValueError("e2m1-coded w4a8 (nvfp4-a8) has no packed chain kernel; the MLP chain "
                                 "dequantizes its weights first (gelu_mlp)")
            if grouped:
                out = gemm_w4a8_grouped(qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias,
                                        layer_idx)
            else:
                out = gemm_w4a8(qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias, layer_idx)
            return out if residual is None else res_apply(out, *residual)
        qweight = dequant_w4a8(qweight, rescales, wcodes, layer_idx)
        layer_idx = None  # the dequantized layer is one (K, N) weight
    elif precision != "int8":
        raise NotImplementedError(f"precision {precision!r} is not ported")
    if ascales.ndim == 2 and ascales.shape[0] > 1:
        return gemm_w8a8_grouped(qact, ascales, qweight, wscales, lora_act, proj_up, bias, residual, layer_idx)
    if layer_idx is not None:
        return gemm_w8a8_rank1(qact, ascales, qweight, wscales, lora_act, proj_up, bias, residual, layer_idx)
    out = gemm_w8a8(qact, ascales, qweight, wscales, lora_act, proj_up, bias)
    return out if residual is None else res_apply(out, *residual)
