"""The M 512 text-stream product on the card: a stack of four int8 weights.

Port of ``tools/probe_m512.py`` (the TPU probe of FLUX's text-stream GEMM,
M 512, K 3072, N 9216): the same inputs (``numpy.random.default_rng(0)``, an
(L 4, K, N) weight stack), the same case names and 8 timed runs each after
one untimed. A run is the JAX script's ``scan`` as a loop over the stack's
layers (``wstack[l]`` views), each product's whole output consumed into the
carry (``c + sum(f32(o)) * 1e-9``), as the JAX body does so that no product
narrows; each line prints TF/s over the run and ms per product.

    python -m nunchaku_tpu_torch.tools.probe_m512 [CASE ...]

Case -> the port:

* ``xla-i8``: XLA's int8 ``dot_general`` -> ``torch._int_mm``, cast to bf16;
* ``xla-bf16``: XLA's bf16 dot of the cast operands -> ``torch.matmul``;
* ``pl-i8-<tile>`` (``kern_i8`` :30, int32 accumulator, bf16 out):
  ``gemm_probe_i8`` at each card tile the kernel is built for (``chain``:
  the int8 chain kernels' own instantiation of the s8 wgmma loop); the JAX
  script's TPU tiles (sized for 16 MB of VMEM) do not carry over, so the
  names carry the card's;
* ``pl-cvt-128.128.64`` (``kern_cvt`` :47, int8 cast to bf16 inside, f32
  sums): ``gemm_probe_bf16`` on int8 codes;
* ``pl-i8-f32acc-128.128.64``: the JAX line of this name runs ``kern_i8``
  with an int32 accumulator (``probe_m512.py:130``), and so does the port
  (at the ``chain`` tile).

The int8 stack is held K-contiguous for the int8 products (the kernel's and
``torch._int_mm``'s layout) and N-contiguous, as drawn, for the
bf16-operand kernel; both built before timing.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.gemm_probe import gemm_probe_bf16, gemm_probe_i8
from ..ops.reference import int8_matmul
from .probe_common import I32_TILES, bound, k_contiguous, nvidia_smi, row, tensor, tile_fits, tile_label, time_ms

M, K, N, L = 512, 3072, 9216, 4


def cases(m, k, n) -> dict:
    """name -> (product of a and one layer (int8 (K, N) K-contiguous, int8
    (K, N) N-contiguous) -> (M, N) bf16, the layout it reads, int8 or bf16)."""
    cs = {"xla-i8": (lambda a, wk, wn: int8_matmul(a, wk).to(torch.bfloat16), "i8"),
          "xla-bf16": (lambda a, wk, wn: torch.matmul(a.to(torch.bfloat16), wn.to(torch.bfloat16)), "bf16")}
    for tile in I32_TILES:
        if tile_fits(tile, m, k, n):
            cs[f"pl-i8-{tile_label(tile, '.')}"] = (lambda a, wk, wn, tile=tile: gemm_probe_i8(a, wk, tile=tile), "i8")
    cs["pl-cvt-128.128.64"] = (lambda a, wk, wn: gemm_probe_bf16(a, wn, a_form="i8", w_form="i8"), "bf16")
    cs["pl-i8-f32acc-128.128.64"] = (lambda a, wk, wn: gemm_probe_i8(a, wk), "i8")
    return cs


def run(device="cuda", m=M, k=K, n=N, layers=L, iters=8, names=None, log=print) -> list[dict]:
    """Each case (all, or ``names``) on ``device`` -> one row each (name, ms
    per product, tflops, bound_ms per product, of_bound)."""
    rng = np.random.default_rng(0)
    qa = tensor(rng.integers(-127, 127, (m, k)), torch.int8, device)
    wstack = tensor(rng.integers(-127, 127, (layers, k, n)), torch.int8, device)
    wstack_k = k_contiguous(wstack)
    fl = 2 * m * k * n * layers
    every = cases(m, k, n)
    rows = []
    with torch.no_grad():
        for name in names or list(every):
            fn, kind = every[name]

            def scan(fn=fn):
                c = torch.zeros((1, 1), dtype=torch.float32, device=device)
                for li in range(layers):
                    o = fn(qa, wstack_k[li], wstack[li])
                    c = c + o.float().sum() * 1e-9
                return c

            ms = time_ms(scan, iters, device, warmup=1)
            nbytes = m * k + k * n + 2 * m * n
            ops = {"int8_ops" if kind == "i8" else "bf16_ops": 2 * m * k * n}
            bnd = bound(nbytes, **ops)[0]
            r = row(name, ms / layers, fl / layers, bnd, device)
            log(f"{name:28s} {fl / (ms * 1e-3) / 1e12:7.1f} TF/s  ({ms / layers:.3f} ms/gemm)")
            rows.append(r)
    return rows


def main(argv=None) -> int:
    """The cases named in ``argv`` (all if none), as the JAX script reads
    its command line, at its sizes on the card."""
    names = sys.argv[1:] if argv is None else argv
    print(nvidia_smi(), flush=True)
    run(names=names or None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
