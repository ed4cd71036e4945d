"""The GEMM probes: two Hopper kernels that measure the port's matrix
products apart from any model, and their plain PyTorch versions.

Counterparts of the Pallas kernels of the TPU GEMM probe scripts under
``tools/`` (ported as ``nunchaku_tpu_torch/tools/``; no model path calls
them, in JAX or here):

* :func:`gemm_probe_i8` -- kernel ``csrc/gemm_probe_i8.cu``, the int8
  product int8 A (M, K) x int8 W (K, N), int32 accumulators, bf16 out. Its
  ``acc`` keeps int32 throughout (``"i32"``) or adds each K tile's int32
  partial in f32 (``"f32"``); with ``a_scale`` / ``w_scale`` its epilogue is
  ``(acc * a_scale[m]) * w_scale[n]`` in f32 (rank 1), else a cast. It serves
  ``tools/bench_gemm_variants.py`` ``k_i8dot`` (:107, f32), ``k_v7`` (:159,
  f32, rank 1) and ``v7_with`` (:178); ``tools/probe_int8_mxu.py``
  ``mk_kernel`` (:48) on int8 operands (either ``acc``);
  ``tools/probe_m512.py`` ``kern_i8`` (:30, i32) and
  ``tools/tune_gemm_impl.py`` ``kern`` (:70, i32).
* :func:`gemm_probe_bf16` -- kernel ``csrc/gemm_probe_bf16.cu`` (on the
  wgmma + TMA GEMM main loop of ``csrc/gemm_sm90.cuh``), bf16
  operands, f32 accumulation, bf16 out, each operand given as bf16, as int8
  codes cast to bf16, or as packed int4 codes (``"p4"``, the block-split-half
  layout of ``core/packing.py``); with group-64 scales, each decoded operand
  is ``bf16(code * scale)``. It serves ``tools/bench_gemm_variants.py``
  ``k_bf`` (:55), ``k_v1`` (:70), ``k_v2`` (:81), ``k_v4`` (:96) and ``k_v6``
  (:118, whose two nibble-plane products are one product here);
  ``tools/probe_int8_mxu.py`` ``mk_kernel`` on bf16 operands and
  ``tools/probe_m512.py`` ``kern_cvt`` (:47).

A wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches its kernel or raises, and adds one to the count of the
instantiation it launched (:data:`COUNTS`: ``gemm_probe_i8_<acc>_<epilogue>@<tile>``,
``gemm_probe_bf16_<a form>_<w form>[_scaled]``).

Tiles. The TPU scripts' tile tuples (512 x 1024 x 512 and the like, sized
for the TPU's 16 MB VMEM) mean nothing on this card. The int8 kernel is
instantiated at the card tiles of :data:`I8_TILES`, all with 8 warps:
128 x 128 x 64 is the packed chain GEMMs' tile and warp layout (``csrc/int8_gemm.cuh``:
2 x 4 warps of 64 x 32, two stages); ``"chain"`` is that file's own main loop
(WMMA, the packed forms' loop; the int8 chain kernels run on ``csrc/gemm_sm90.cuh``'s
s8 loop) with the cast epilogue, int32 only. Each tile is built for the modes
the ported tools launch (:data:`I8_BUILT`). The bf16-operand kernel has one
tile, 128 x 128 x 64 (two consumer warpgroups of 64 rows, wgmma m64n128k16).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..core.packing import PACK_BLOCK, unpack_int4
from . import _build
from .gemm import _ptr, _stream
from .reference import GROUP_INT4, int8_matmul

# name -> (id in nt_gemm_probe_i8, BM, BN, BK)
I8_TILES = {"128x128x64": (0, 128, 128, 64), "128x128x128": (1, 128, 128, 128), "128x256x64": (2, 128, 256, 64),
            "256x128x64": (3, 256, 128, 64), "chain": (4, 128, 128, 64)}
I8_ACCS = ("i32", "f32")
# (acc, rank-1 epilogue) -> the tiles it is built at: the modes the ported tools launch
I8_BUILT = {("i32", False): tuple(I8_TILES), ("f32", False): ("128x128x64",),
            ("f32", True): ("128x128x64", "128x128x128", "128x256x64", "256x128x64")}
BF16_TILE = (128, 128, 64)
FORM_IDS = {"bf16": 0, "i8": 1, "p4": 2}
# (a form, w form, scaled): the operand forms the bf16-operand kernel is built for
BF16_FORMS = (("bf16", "bf16", False), ("i8", "i8", False), ("p4", "p4", False), ("i8", "i8", True),
              ("p4", "i8", True), ("p4", "p4", True))


def i8_mode(acc: str, rank1: bool) -> str:
    return f"gemm_probe_i8_{acc}_{'rank1' if rank1 else 'cast'}"


def bf16_mode(a_form: str, w_form: str, scaled: bool) -> str:
    return f"gemm_probe_bf16_{a_form}_{w_form}{'_scaled' if scaled else ''}"


COUNTS = {f"{i8_mode(acc, r1)}@{tile}": SimpleNamespace(launches=0) for (acc, r1), tiles in I8_BUILT.items()
          for tile in tiles}
COUNTS.update({bf16_mode(*f): SimpleNamespace(launches=0) for f in BF16_FORMS})


# ---------------------------------------------------------------------------
# the int8 product
# ---------------------------------------------------------------------------


def gemm_probe_i8_plain(a, w, a_scale=None, w_scale=None, *, acc="i32", bk=64):
    """The int8 kernel's numerics step by step: the exact int32 product
    (``int8_matmul``), or with ``acc="f32"`` each ``bk``-deep K tile's int32
    partial converted to f32 and added in order; then f32 (rounded from
    int32), times ``a_scale[m]``, times ``w_scale[n]`` when both are given,
    and bf16 (the int32 -> bf16 cast goes through f32, as XLA's does)."""
    if acc == "i32":
        s = int8_matmul(a, w).float()
    else:
        s = None
        for k0 in range(0, a.shape[1], bk):
            p = int8_matmul(a[:, k0:k0 + bk], w[k0:k0 + bk]).float()
            s = p if s is None else s + p
    if a_scale is not None:
        s = (s * a_scale.reshape(-1, 1).float()) * w_scale.reshape(1, -1).float()
    return s.to(torch.bfloat16)


def _require_i8(a, w, a_scale, w_scale, acc, tile):
    _build.require(acc in I8_ACCS, f"acc must be one of {I8_ACCS}, got {acc!r}")
    _build.require(tile in I8_TILES, f"tile must be one of {tuple(I8_TILES)}, got {tile!r}")
    _build.require((a_scale is None) == (w_scale is None), "the rank-1 epilogue takes both a_scale and w_scale")
    _build.require(tile in I8_BUILT.get((acc, a_scale is not None), ()),
                   f"no int8 probe built for acc {acc!r}, rank-1 {a_scale is not None} at tile {tile}; built: "
                   f"{I8_BUILT}")
    _build.require(a.dtype == torch.int8 and w.dtype == torch.int8 and a.ndim == 2 and w.ndim == 2
                   and a.shape[1] == w.shape[0], f"a (M, K) and w (K, N) int8, got {tuple(a.shape)} "
                   f"{a.dtype} and {tuple(w.shape)} {w.dtype}")
    _build.require(a.is_contiguous(), "a must be contiguous (M, K)")
    _build.require(w.device == a.device, "a and w on one device")
    (m, k), n = a.shape, w.shape[1]
    _, bm, bn, bk = I8_TILES[tile]
    _build.require(m % bm == 0 and n % bn == 0 and k % bk == 0,
                   f"tile {tile} needs M % {bm}, N % {bn}, K % {bk} == 0 (M={m}, K={k}, N={n})")
    if a_scale is not None:
        for name, s, size in (("a_scale", a_scale, m), ("w_scale", w_scale, n)):
            _build.require(s.dtype == torch.float32 and s.numel() == size and s.device == a.device
                           and s.reshape(-1).is_contiguous(), f"{name}: f32 with {size} values, (1, {size}) or "
                           f"({size},), got {s.dtype} {tuple(s.shape)}")
    return m, k, n, bk


def gemm_probe_i8(a, w, a_scale=None, w_scale=None, *, acc="i32", tile="128x128x64"):
    """int8 a (M, K) x int8 w (K, N) -> (M, N) bf16 (:func:`gemm_probe_i8_plain`).

    ``w`` is in the JAX orientation; the kernel reads it K-contiguous (the
    tensor cores' int8 layout), so a transposed view of an (N, K)-contiguous
    tensor passes as it is and anything else is copied to that layout.
    ``a_scale`` (M,) / ``w_scale`` (N,) f32: the rank-1 epilogue. ``acc``:
    ``"i32"`` or ``"f32"`` (each K tile's int32 partial added in f32).
    ``tile``: one of :data:`I8_TILES`; M, N and K must be multiples of it.
    The (acc, epilogue, tile) combinations built are :data:`I8_BUILT`."""
    m, k, n, bk = _require_i8(a, w, a_scale, w_scale, acc, tile)
    if not a.is_cuda:
        return gemm_probe_i8_plain(a, w, a_scale, w_scale, acc=acc, bk=bk)
    wt = w.t() if w.t().is_contiguous() else w.t().contiguous()  # (N, K), K-contiguous
    rank1 = a_scale is not None
    a_s = None if a_scale is None else a_scale.reshape(-1)
    w_s = None if w_scale is None else w_scale.reshape(-1)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    _build.check(_build.library().nt_gemm_probe_i8(a.data_ptr(), wt.data_ptr(), _ptr(a_s), _ptr(w_s),
                                                    out.data_ptr(), m, n, k, I8_TILES[tile][0], int(acc == "f32"),
                                                    int(rank1), _stream(a)), "gemm_probe_i8")
    COUNTS[f"{i8_mode(acc, rank1)}@{tile}"].launches += 1
    return out


# ---------------------------------------------------------------------------
# the bf16-operand product
# ---------------------------------------------------------------------------


def decode_operand(x, form, scale=None, *, dim):
    """An operand in its stored form -> its bf16 values in logical order.
    ``dim``: the K axis (1 for A (M, K), 0 for W (K, N)); ``"p4"`` holds two
    codes a byte along it. ``scale`` (K/64, M) or (K/64, N) bf16: each value
    becomes ``bf16(code * scale)``, one rounding of an exact f32 product
    (the TPU bodies' ``code.astype(bf16) * scale``)."""
    if form == "bf16":
        return x
    v = (unpack_int4(x, dim) if form == "p4" else x).float()
    if scale is not None:
        s = scale.float().repeat_interleave(GROUP_INT4, dim=0)  # (K, M) or (K, N)
        v = v * (s.t() if dim == 1 else s)
    return v.to(torch.bfloat16)


def gemm_probe_bf16_plain(a, w, a_scale=None, w_scale=None, *, a_form="bf16", w_form="bf16"):
    """The bf16-operand kernel's function: the decoded bf16 operands'
    product with f32 sums (an f32 matmul of bf16 values, exact products),
    rounded to bf16. The kernel sums in another order: within one bf16
    step of this."""
    av = decode_operand(a, a_form, a_scale, dim=1)
    wv = decode_operand(w, w_form, w_scale, dim=0)
    return (av.float() @ wv.float()).to(torch.bfloat16)


def _require_bf16(a, w, a_scale, w_scale, a_form, w_form):
    scaled = a_scale is not None
    _build.require((a_scale is None) == (w_scale is None), "the scaled forms take both a_scale and w_scale")
    _build.require((a_form, w_form, scaled) in BF16_FORMS,
                   f"no bf16-operand kernel for a {a_form!r}, w {w_form!r}, scaled={scaled}; built: {BF16_FORMS}")
    for name, x, form in (("a", a, a_form), ("w", w, w_form)):
        want = torch.bfloat16 if form == "bf16" else torch.int8
        _build.require(x.dtype == want and x.ndim == 2 and x.is_contiguous() and x.device == a.device,
                       f"{name}: contiguous 2-D {want} ({form}), got {x.dtype} {tuple(x.shape)}")
    m, n = a.shape[0], w.shape[1]
    k = a.shape[1] * (2 if a_form == "p4" else 1)
    _build.require(w.shape[0] * (2 if w_form == "p4" else 1) == k, f"K of a ({k}) and w disagree")
    bm, bn, bk = BF16_TILE
    _build.require(m % bm == 0 and n % bn == 0 and k % bk == 0,
                   f"the bf16-operand kernel needs M % {bm}, N % {bn}, K % {bk} == 0 (M={m}, K={k}, N={n})")
    if "p4" in (a_form, w_form):
        _build.require(k % PACK_BLOCK == 0, f"packed int4 operands need K % {PACK_BLOCK} == 0 (K={k})")
    if scaled:
        for name, s, cols in (("a_scale", a_scale, m), ("w_scale", w_scale, n)):
            _build.require(s.dtype == torch.bfloat16 and s.is_contiguous() and s.device == a.device
                           and tuple(s.shape) == (k // GROUP_INT4, cols),
                           f"{name}: contiguous bf16 (K/64, {cols}), got {s.dtype} {tuple(s.shape)}")
    return m, k, n, scaled


def gemm_probe_bf16(a, w, a_scale=None, w_scale=None, *, a_form="bf16", w_form="bf16"):
    """a (M, K) x w (K, N) on bf16 operands -> (M, N) bf16
    (:func:`gemm_probe_bf16_plain`). Forms: ``"bf16"``, ``"i8"`` (int8 codes
    cast to bf16), ``"p4"`` (packed int4 along K: a (M, K/2), w (K/2, N)).
    ``a_scale`` (K/64, M) / ``w_scale`` (K/64, N) bf16 scale each decoded
    operand. w stays N-contiguous (the kernel reads it MN-major). The
    combinations built are :data:`BF16_FORMS`."""
    m, k, n, scaled = _require_bf16(a, w, a_scale, w_scale, a_form, w_form)
    if not a.is_cuda:
        return gemm_probe_bf16_plain(a, w, a_scale, w_scale, a_form=a_form, w_form=w_form)
    _build.require(all(t.data_ptr() % 16 == 0 for t in (a, w, a_scale, w_scale) if t is not None),
                   "the bf16-operand kernel's TMA and bulk copies need 16-byte aligned operands and scales")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    _build.check(_build.library().nt_gemm_probe_bf16(a.data_ptr(), w.data_ptr(), _ptr(a_scale), _ptr(w_scale),
                                                      out.data_ptr(), m, n, k, FORM_IDS[a_form], FORM_IDS[w_form],
                                                      int(scaled), _stream(a)), "gemm_probe_bf16")
    COUNTS[bf16_mode(a_form, w_form, scaled)].launches += 1
    return out
