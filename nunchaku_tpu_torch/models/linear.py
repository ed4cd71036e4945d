"""Linear layers: plain bf16 ``Linear``, the SVDQuant ``SVDQW4A4Linear``
(``int8``, ``w4a8`` with int4 or e2m1 codes, ``int4``, ``nvfp4``) and the
weight-only 4-bit ``AWQW4A16Linear``.

Counterparts of ``nunchaku_tpu/models/linear.py`` ``Linear`` (:61),
``SVDQW4A4Linear`` (:87) and ``AWQW4A16Linear`` (:564, with its LoRA side
branch :583-585, :636-646). Weights keep the JAX package's layouts: (K, N)
K-major, packed 4-bit as (K/2, N) in the block-split-half layout.

Stacked layers (the JAX scans): :func:`stack_modules` and
:func:`slice_module` (JAX ``transformer_flux.py:96-103``) turn identical
modules into one whose buffers carry a leading layer axis, and take a
layer's views back out of it (:func:`build_stacked` stacks layers as they
are made; :func:`fork_module` copies a module tree, not its tensors);
:func:`attach_stacked_weights` (JAX ``linear.py:650``) points each 4-bit
linear of a layer's view at the whole ``(L, ...)`` qweight stack
and a device-resident layer index, which its GEMM kernel reads
(``ops/gemm.py`` stacked modes); :class:`StackedLayers` keeps a model's
per-layer views and indices.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from ..core.packing import PACK_BLOCK, pack_int4
from ..ops.gemm import WCODES, svdq_gemm_w4a4, w4a8_group, w4a8_use_xla
from ..ops.gemv import AWQ_XLA_MIN_M, awq_w4a16_linear, awq_w4a16_linear_plain
from ..ops.quantize import ln_mod_quant_int8, quantize_w4a4_act_fuse_lora
from ..ops.reference import GROUP_INT4, bf16_matmul, group_size, is_4bit

PAD_TOKENS = 256  # token padding quantum of the quantized linears (JAX linear.py:26)


def pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    return x if pad == 0 else nn.functional.pad(x, (0, 0, 0, pad))


def padded_dims(k: int, n: int) -> tuple[int, int]:
    """An SVDQ linear's buffer dims for logical (K, N): K up to a multiple
    of 256, N of 128 (the kernels' pack block and tile)."""
    return k + (-k) % PACK_BLOCK, n + (-n) % 128


def _randn(shape, gen, device, scale=1.0):
    return torch.randn(shape, generator=gen, device=device) * scale


class Linear(nn.Module):
    """Plain linear, weight (K, N): bf16 operands, f32 accumulation, result
    in the input's dtype."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)

    @classmethod
    def random_init(cls, gen, in_features, out_features, bias=True, device="cuda"):
        std = 1.0 / math.sqrt(in_features)
        w = _randn((in_features, out_features), gen, device, std).to(torch.bfloat16)
        return cls(w, _randn((out_features,), gen, device, 0.02).to(torch.bfloat16) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = bf16_matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(x.dtype)


class SVDQW4A4Linear(nn.Module):
    """SVDQuant linear with a low-rank branch of any rank R.

    Buffers (JAX layouts): ``qweight`` (K, N) int8 (int8), or packed 4-bit
    (K/2, N) (w4a8: int4 or e2m1 codes, ``wcodes``; int4 / nvfp4: int4 or
    e2m1 codes); ``wscales`` (1, N) f32 per channel (int8, w4a8) or (K/G, N)
    bf16 per group (int4: G = 64, nvfp4: G = 16); ``rescales`` (K/G, N) bf16
    (w4a8 only; G = 64 for int4 codes, 16 for e2m1); ``smooth`` (K,);
    ``proj_down`` (K, R); ``proj_up`` (R, N); ``bias`` (N,) or None. The
    int8, int4 and nvfp4 weights are stored K-contiguous (the same (K, N) or
    (K/2, N) values), the layout their kernels read. ``act_unsigned``: the
    layer's activations are shifted GELU outputs (the fc2 layers of a model
    from an int4 checkpoint), quantized unsigned at int4 and shifted before
    the signed int8 quantization at int8 / w4a8. ``wcodes="e2m1"`` (w4a8
    only) is the nvfp4-a8 serving mode: an nvfp4 checkpoint's e2m1 codes
    through the int8 products. Always returns bf16.

    Odd widths (JAX linear.py:148-196, 336-350): the kernels take K % 256 ==
    0 and N % 128 == 0, so a layer of ``logical_in`` x ``logical_out`` (SDXL's
    640, SANA's 2240) keeps its buffers zero-padded to those multiples, the
    padded K rows holding zero codes and zero ``proj_down`` rows; ``forward``
    pads the input columns and cuts the output back to ``logical_out``.
    ``in_features`` / ``out_features`` are the buffers' (padded) dims.

    LoRA (``lora.flux.apply.update_lora_params``): a LoRA's ranks are
    appended to the low-rank branch, so ``proj_up`` rows ``lora_base_rank:``
    are the LoRA's, at their strength; ``lora_up_unit`` keeps them at unit
    strength, for ``set_lora_strength``. Both are None without a LoRA.
    """

    def __init__(self, qweight, wscales, smooth, proj_down, proj_up, bias=None, rescales=None, *,
                 precision: str = "w4a8", act_unsigned: bool = False, wcodes: str = "int4",
                 logical_in: int | None = None, logical_out: int | None = None,
                 lora_up_unit: torch.Tensor | None = None, lora_base_rank: int | None = None):
        super().__init__()
        if precision not in ("int8", "w4a8", "int4", "nvfp4"):
            raise NotImplementedError(f"SVDQW4A4Linear precision {precision!r} is not ported")
        if act_unsigned and precision == "nvfp4":
            raise NotImplementedError("unsigned activations are no nvfp4 mode")
        if wcodes not in WCODES or (wcodes == "e2m1" and precision != "w4a8"):
            raise ValueError(f"wcodes {wcodes!r} with precision {precision!r}: e2m1 codes are a w4a8 form")
        if precision == "w4a8" and tuple(rescales.shape) != (2 * qweight.shape[0] // w4a8_group(wcodes),
                                                              qweight.shape[1]):
            raise ValueError(f"{wcodes} rescales must be (K/{w4a8_group(wcodes)}, N), got {tuple(rescales.shape)}")
        if precision != "w4a8":
            qweight = qweight.t().contiguous().t()
        for name, t in (("qweight", qweight), ("wscales", wscales), ("smooth", smooth),
                        ("proj_down", proj_down), ("proj_up", proj_up), ("bias", bias),
                        ("rescales", rescales), ("lora_up_unit", lora_up_unit)):
            self.register_buffer(name, t)
        self.lora_base_rank = lora_base_rank
        self.precision = precision
        self.act_unsigned = act_unsigned
        self.wcodes = wcodes
        self.in_features = qweight.shape[0] * (1 if precision == "int8" else 2)
        self.out_features = qweight.shape[1]
        self.logical_in = self.in_features if logical_in is None else logical_in
        self.logical_out = self.out_features if logical_out is None else logical_out
        if (padded_dims(self.logical_in, self.logical_out) != (self.in_features, self.out_features)
                and (self.logical_in, self.logical_out) != (self.in_features, self.out_features)):
            raise ValueError(f"logical ({self.logical_in}, {self.logical_out}) do not pad to the buffers' "
                             f"({self.in_features}, {self.out_features})")

    @property
    def ln_producer(self) -> bool:
        """Whether the LN + modulate + quantize producer feeds this linear
        (JAX ``_ln_producer_ok``, transformer_flux.py:65-73, and its gate in
        ``forward_modulated``, linear.py:371-378): int8 always; w4a8 on the
        dequant route only (:func:`~nunchaku_tpu_torch.ops.gemm.w4a8_use_xla`,
        read at each call); int4 / nvfp4 quantize their own activations."""
        return self.precision == "int8" or (self.precision == "w4a8" and w4a8_use_xla())

    @classmethod
    def random_init(cls, gen, in_features, out_features, rank=32, precision="w4a8", act_unsigned=False,
                    device="cuda"):
        """The distributions of the JAX ``random_init`` (linear.py:134-197).
        ``precision="nvfp4-a8"``: a w4a8 linear with e2m1 codes and group-16
        rescales (JAX :171-182). Odd dims pad K to 256 and N to 128, the
        padded K rows with zero codes (random codes in [-8, 8) on the
        logical rows, as JAX draws them then) and zero ``proj_down`` rows."""
        std = 1.0 / math.sqrt(in_features)
        k_log, n_log = in_features, out_features
        in_features, out_features = padded_dims(k_log, n_log)
        pad_k = in_features - k_log
        if is_4bit(precision):
            g = group_size(precision)
            ws = (_randn((in_features // g, out_features), gen, device).abs() * std / 7).to(torch.bfloat16)
        else:
            ws = (_randn((1, out_features), gen, device).abs() * std / 127).float()
        rescales, wcodes = None, "int4"
        if precision == "nvfp4-a8":
            precision, wcodes = "w4a8", "e2m1"
        if precision == "int8":
            qw = torch.randint(-128, 128, (k_log, out_features), dtype=torch.int8, generator=gen, device=device)
            qw = nn.functional.pad(qw, (0, 0, 0, pad_k))
        elif precision in ("w4a8", "int4", "nvfp4") and pad_k:
            codes = torch.randint(-8, 8, (k_log, out_features), dtype=torch.int8, generator=gen, device=device)
            qw = pack_int4(nn.functional.pad(codes, (0, 0, 0, pad_k)), 0)
        elif precision in ("w4a8", "int4", "nvfp4"):
            qw = torch.randint(-128, 128, (in_features // 2, out_features), dtype=torch.int8,
                               generator=gen, device=device)
        else:
            raise NotImplementedError(f"precision {precision!r} is not ported")
        if precision == "w4a8":
            cmax = 6.0 if wcodes == "e2m1" else 7.0
            rescales = (torch.rand((in_features // w4a8_group(wcodes), out_features), generator=gen,
                                   device=device) * (127.0 / cmax - 1.0) + 1.0).to(torch.bfloat16)
        smooth = torch.ones((in_features,), dtype=torch.bfloat16, device=device)
        pd = nn.functional.pad(_randn((k_log, rank), gen, device, 0.02).to(torch.bfloat16), (0, 0, 0, pad_k))
        pu = _randn((rank, out_features), gen, device, 0.02).to(torch.bfloat16)
        b = _randn((out_features,), gen, device, 0.02).to(torch.bfloat16)
        return cls(qw, ws, smooth, pd, pu, b, rescales, precision=precision, act_unsigned=act_unsigned,
                   wcodes=wcodes, logical_in=k_log, logical_out=n_log)

    def quantize(self, x2d: torch.Tensor):
        """(M, K) -> (qact, ascales, lora_act), M padded to 256 (to 8 when
        M <= 8), K (``logical_in``) to ``in_features`` by the quantize:
        ascales (1, M') per token (int8, w4a8) or (K/G, M') per group."""
        x2d = pad_rows(x2d, 8 if x2d.shape[0] <= 8 else PAD_TOKENS)
        return quantize_w4a4_act_fuse_lora(x2d, self.proj_down, self.smooth, precision=self.precision,
                                           act_unsigned=self.act_unsigned)

    def forward_quant(self, qact, ascales, lora_act, *, qweight=None, layer_idx=None, skip_lora=False,
                      residual=None):
        """The GEMM on quantized activations. ``qweight`` / ``layer_idx``:
        an (L, K/2, N) stack and the 0-d int32 index of this layer in it,
        read by the kernel (defaults: those :func:`attach_stacked_weights`
        set, else this layer's own ``qweight``). ``skip_lora`` leaves out the
        low-rank epilogue (the caller adds ``lora_act @ proj_up`` itself);
        ``residual`` is :func:`~nunchaku_tpu_torch.ops.gemm.res_apply`'s
        operands."""
        if qweight is None and layer_idx is None:
            qweight = getattr(self, "_stacked_qweight", None)
            if qweight is not None:
                layer_idx = self._layer_idx
        return svdq_gemm_w4a4(qact, ascales, self.qweight if qweight is None else qweight, self.wscales,
                              None if skip_lora else lora_act, None if skip_lora else self.proj_up, self.bias,
                              self.rescales, precision=self.precision, act_unsigned=self.act_unsigned,
                              residual=residual, wcodes=self.wcodes, layer_idx=layer_idx)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        m = math.prod(lead)
        out = self.forward_quant(*self.quantize(x.reshape(m, x.shape[-1])))
        return out[:m, :self.logical_out].reshape(*lead, self.logical_out)

    def forward_parts(self, x: torch.Tensor):
        """Like :meth:`forward` without the low-rank epilogue: returns
        ``(out_without_lora, lora_act)`` so the caller can add the low-rank
        term downstream (the chain consumer's residual epilogue)."""
        lead = x.shape[:-1]
        m = math.prod(lead)
        q, a, la = self.quantize(x.reshape(m, x.shape[-1]))
        out = self.forward_quant(q, a, la, skip_lora=True)
        return (out[:m, :self.logical_out].reshape(*lead, self.logical_out),
                la[:m].reshape(*lead, la.shape[-1]))

    def forward_modulated(self, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                          skip_lora=False):
        """``LN(x) * (1 + scale) + shift`` -> this linear, x (B, S, K) the raw
        bf16 stream, scale / shift (B, K): one LN + modulate + quantize
        producer (:func:`~nunchaku_tpu_torch.ops.quantize.ln_mod_quant_int8`)
        feeds the GEMM at any S (the kernel masks the rows past B*S, so the
        JAX method's multi-pass fallback for an S without a tile divisor has
        no counterpart here). ``skip_lora`` returns ``(out_without_lora,
        lora_act (B, S, R))``."""
        if self.logical_in != self.in_features:
            raise NotImplementedError("an odd-width linear takes LN + modulate + forward (JAX's multi-pass "
                                      "fallback), not the producer")
        if not self.ln_producer:
            raise NotImplementedError("the LN + modulate + quantize producer feeds int8 linears and w4a8 ones on "
                                      f"the dequant route; {self.precision!r} here takes LN + modulate + forward")
        b, s, _ = x.shape
        q, asc, la = ln_mod_quant_int8(x.to(torch.bfloat16), scale, shift, self.smooth, self.proj_down)
        out = self.forward_quant(q, asc, la, skip_lora=skip_lora).reshape(b, s, -1)
        return (out, la.reshape(b, s, -1)) if skip_lora else out


# The linears attach_stacked_weights points at their qweight stack: the 4-bit
# ones, whose every GEMM is a kernel (JAX linear.py:650-669). int8 linears are
# left out: JAX runs their standalone GEMMs as XLA dots, which slice the layer
# themselves, and the port's torch._int_mm takes the layer's view; the int8
# MLP chain pair's stacks reach the chain kernels through gelu_mlp(stacked=).
STACKED_PRECISIONS = ("w4a8", "int4", "nvfp4")


def stack_modules(mods: list[nn.Module]) -> nn.Module:
    """Identical modules -> one of their structure whose buffers are the
    layers' buffers stacked along a new leading axis (JAX ``stack_modules``).
    A layer's weight stored K-contiguous (the int4 / nvfp4 qweight) stays so
    in the stack: each layer of it is K-contiguous, layers back to back."""
    first = mods[0]
    out = copy.copy(first)
    out._parameters = {}
    out._buffers = {}
    for name, t in first._buffers.items():
        if t is None:
            out._buffers[name] = None
        elif t.dim() == 2 and not t.is_contiguous() and t.t().is_contiguous():
            out._buffers[name] = torch.stack([m._buffers[name].t() for m in mods]).transpose(1, 2)
        else:
            out._buffers[name] = torch.stack([m._buffers[name] for m in mods])
    out._modules = {name: None if m is None else stack_modules([x._modules[name] for x in mods])
                    for name, m in first._modules.items()}
    return out


def _empty_stack(t: torch.Tensor, n: int) -> torch.Tensor:
    """An (n, ...) buffer for n layers like ``t``, in :func:`stack_modules`'
    layout (a K-contiguous 2-D layer stays K-contiguous)."""
    if t.dim() == 2 and not t.is_contiguous() and t.t().is_contiguous():
        return torch.empty((n, t.shape[1], t.shape[0]), dtype=t.dtype, device=t.device).transpose(1, 2)
    return torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)


def _stack_like(first: nn.Module, n: int) -> nn.Module:
    out = copy.copy(first)
    out._parameters = {}
    out._buffers = {name: None if t is None else _empty_stack(t, n) for name, t in first._buffers.items()}
    out._modules = {name: None if m is None else _stack_like(m, n) for name, m in first._modules.items()}
    return out


def _copy_layer(stacked: nn.Module, layer: nn.Module, i: int) -> None:
    for name, t in layer._buffers.items():
        dst = stacked._buffers[name]
        if (t is None) != (dst is None):
            raise ValueError(f"layer {i}: buffer {name!r} is {'missing' if t is None else 'unexpected'}")
        if t is not None:
            dst[i].copy_(t)
    for name, m in layer._modules.items():
        if m is not None:
            _copy_layer(stacked._modules[name], m, i)


@torch.no_grad()
def build_stacked(make, n: int) -> nn.Module:
    """``stack_modules([make(0), ..., make(n - 1)])`` without holding the n
    layers at once: layer 0 lays out the stack, and each layer is copied in
    as it is made and then freed, so a full-size model never holds its
    weights twice. ``make(i)`` builds layer i (in order: a random generator
    draws the layers as a list would)."""
    if n < 1:
        raise ValueError("a stack holds at least one layer")
    first = make(0)
    out = _stack_like(first, n)
    _copy_layer(out, first, 0)
    del first
    for i in range(1, n):
        _copy_layer(out, make(i), i)
    return out


def slice_module(stacked: nn.Module, i: int) -> nn.Module:
    """Layer ``i`` of a stacked module, its buffers views into the stack's
    (JAX ``slice_module``): no copy, so the views see any in-place change of
    the stack."""
    out = copy.copy(stacked)
    out._parameters = {}
    out._buffers = {name: None if t is None else t[i] for name, t in stacked._buffers.items()}
    out._modules = {name: None if m is None else slice_module(m, i) for name, m in stacked._modules.items()}
    return out


def fork_module(m: nn.Module) -> nn.Module:
    """A new module tree of ``m``'s structure and settings whose buffers are
    ``m``'s tensors: a buffer or setting changed on the fork leaves ``m`` as
    it was (a LoRA'd model shares its unchanged weights with its base)."""
    new = copy.copy(m)
    new._parameters = dict(m._parameters)
    new._buffers = dict(m._buffers)
    new._non_persistent_buffers_set = set(m._non_persistent_buffers_set)
    new._modules = {name: None if sub is None else fork_module(sub) for name, sub in m._modules.items()}
    return new


def attach_stacked_weights(block: nn.Module, stacked: nn.Module, layer_idx: torch.Tensor) -> nn.Module:
    """Point every 4-bit linear of the layer view ``block`` at the whole
    (L, ...) qweight stack of ``stacked`` and the 0-d int32 ``layer_idx``
    (on the stack's device), so its GEMM reads the layer by index on the
    card (JAX ``attach_stacked_weights``, linear.py:650-669; its scalar
    prefetch). int8 linears are left alone: their products take the layer's
    own weight, as JAX's XLA dots take the sliced one."""
    stk = dict(stacked.named_modules())
    for name, mod in block.named_modules():
        if isinstance(mod, SVDQW4A4Linear) and mod.precision in STACKED_PRECISIONS:
            mod._stacked_qweight = stk[name].qweight
            mod._layer_idx = layer_idx
    return block


class StackedLayers:
    """A model whose blocks are stacked modules: the attributes named in
    ``STACKS`` (the JAX scans' layout). :meth:`layer_views` gives each
    stack's per-layer view modules (:func:`slice_module`), every 4-bit
    linear attached to its stack (:func:`attach_stacked_weights`), and
    :meth:`layer_ids` their 0-d int32 indices on the stack's device, one
    tensor per layer, so a forward makes no host sync per layer. Both are
    built on first use and again once a stack's storage moved (``.to()``, a
    copy, a replaced linear: the key is every buffer's data pointer) or a
    setting of the stacks' modules changed through :meth:`set_on_stacks` or
    a model setter built on it (the attention settings, the fused qkv prep),
    which drops them. The views are no submodules: ``.to()`` and
    ``buffers()`` see the stacks alone."""

    STACKS: tuple[str, ...] = ()
    _views = None

    def _stack_key(self):
        return tuple(tuple(t.data_ptr() for t in getattr(self, name).buffers()) for name in self.STACKS)

    def _layers(self):
        key = self._stack_key()
        if self._views is None or self._views[0] != key:
            views, ids = {}, {}
            for name in self.STACKS:
                stacked = getattr(self, name)
                first = next(stacked.buffers())
                idx = torch.arange(first.shape[0], dtype=torch.int32, device=first.device)
                ids[name] = [idx[i] for i in range(first.shape[0])]
                views[name] = [attach_stacked_weights(slice_module(stacked, i), stacked, ids[name][i])
                               for i in range(first.shape[0])]
            self._views = (key, views, ids)
        return self._views[1], self._views[2]

    def set_on_stacks(self, module: str, **settings) -> None:
        """Set plain attributes of submodule ``module`` of every stack (say
        ``set_on_stacks("attn", fixed_softmax=False)``); the layer views,
        which hold copies of them, are rebuilt at their next use."""
        for name in self.STACKS:
            target = getattr(self, name).get_submodule(module)
            for key, value in settings.items():
                setattr(target, key, value)
        self._views = None

    def layer_views(self) -> dict[str, list[nn.Module]]:
        return self._layers()[0]

    def layer_ids(self) -> dict[str, list[torch.Tensor]]:
        return self._layers()[1]


class AWQW4A16Linear(nn.Module):
    """Weight-only 4-bit linear for the small-M modulation layers of the
    int4 / nvfp4 models and T5's linears: ``w = q * wscales - wzeros`` with
    q unsigned, in groups of G rows (64 for the modulation, the group of a
    TinyChat file for T5; G comes from the scales' shape). Buffers (JAX
    layouts): ``qweight`` (K/2, N) int8, ``wscales`` and ``wzeros`` (K/G, N)
    bf16, ``bias`` (N,) or None. Returns the input's dtype. M < 16 takes the
    GEMV kernel (G = 64), larger M the dequantize-then-multiply route (JAX
    linear.py:616-647). The optional LoRA side branch (JAX :583-585,
    :636-646): ``lora_down`` (K, r), ``lora_up`` (r, N) at the LoRA's
    strength and ``lora_up_unit`` at unit strength, all bf16, adds
    ``(x @ lora_down) @ lora_up`` after the GEMV or the dequantize route: two
    products of bf16 operands with f32 sums, as torch ops (JAX's ``jnp.dot``
    outside any kernel)."""

    def __init__(self, qweight, wscales, wzeros, bias=None, lora_down=None, lora_up=None, lora_up_unit=None):
        super().__init__()
        for name, t in (("qweight", qweight), ("wscales", wscales), ("wzeros", wzeros), ("bias", bias),
                        ("lora_down", lora_down), ("lora_up", lora_up), ("lora_up_unit", lora_up_unit)):
            self.register_buffer(name, t)
        self.in_features = qweight.shape[0] * 2
        self.out_features = qweight.shape[1]

    @classmethod
    def random_init(cls, gen, in_features, out_features, bias=True, device="cuda"):
        """The distributions of the JAX ``random_init`` (linear.py:607);
        ``bias=False`` for T5's linears."""
        std = 1.0 / math.sqrt(in_features)
        groups = in_features // GROUP_INT4
        qw = torch.randint(-128, 128, (in_features // 2, out_features), dtype=torch.int8, generator=gen,
                           device=device)
        ws = (_randn((groups, out_features), gen, device).abs() * std / 8).to(torch.bfloat16)
        wz = _randn((groups, out_features), gen, device, std).to(torch.bfloat16)
        b = _randn((out_features,), gen, device, 0.02).to(torch.bfloat16) if bias else None
        return cls(qw, ws, wz, b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        m = math.prod(lead)
        fwd = awq_w4a16_linear if m < AWQ_XLA_MIN_M else awq_w4a16_linear_plain
        x2d = x.reshape(m, x.shape[-1])
        out = fwd(x2d, self.qweight, self.wscales, self.wzeros, self.bias)
        if self.lora_down is not None:
            out = out + bf16_matmul(bf16_matmul(x2d, self.lora_down), self.lora_up)
        return out.reshape(*lead, out.shape[-1]).to(x.dtype)
