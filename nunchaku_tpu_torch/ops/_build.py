"""Build the Hopper kernels of ``nunchaku_tpu_torch/csrc`` and load them.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into an object
file, all of them in parallel, and the objects link into one shared library
with a plain C interface, loaded through ``ctypes``. A build takes seconds
(no PyTorch headers are involved). It runs at first use, into
``nunchaku_tpu_torch/_build/`` (ignored by git), keyed by a hash of the
sources and flags, so an unchanged tree reuses the library.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` turns a nonzero code into
an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream are void*, sizes int.
SIGNATURES = {
    "nt_dequant_w4a8": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
    "nt_gemm_w8a8_gelu_quant": [_P] * 15 + [_I] * 6 + [_F, _P, _I, _P],
    "nt_gemm_w4a8_gelu_quant": [_P] * 16 + [_I] * 6 + [_F, _P, _I, _P],
    "nt_gemm_w8a8_gelu_quant_pipe": [_P] * 15 + [_I] * 6 + [_F, _P],
    "nt_gemm_w4a8": [_P] * 9 + [_I] * 5 + [_P, _I, _P],
    "nt_gemm_w8a8_grouped": [_P] * 13 + [_I] * 7 + [_P, _I, _P],
    "nt_flash_fixed": [_P] * 5 + [_I] * 4 + [_P],
    "nt_flash_online": [_P] * 5 + [_I] * 6 + [_F, _P],
    "nt_flash_online_bshd": [_P] * 4 + [_I] * 4 + [_F, _P],
    "nt_ln_mod_quant": [_P] * 3 + [_I] + [_P] * 5 + [_I] * 4 + [_P],
    "nt_ln_mod_quant_dual": [_P] * 3 + [_I] + [_P] * 10 + [_I] * 5 + [_P],
    "nt_qkv_rope_producer": [_P] * 10 + [_I] * 6 + [_F, _P],
    "nt_qkv_prepare": [_P] * 8 + [_I] * 3 + [_F, _F, _P],
    "nt_gemm_w4a4": [_P] * 8 + [_I] * 5 + [_P, _I, _P],
    "nt_w4a4_decode": [_P] * 9 + [_I] * 7 + [_P],
    "nt_gemv_awq": [_P] * 6 + [_I] * 3 + [_P],
    "nt_bs_fixed": [_P] * 5 + [_I] * 9 + [_F, _P],
    "nt_bs_online": [_P] * 5 + [_I] * 9 + [_F, _P],
    "nt_flash_fixed_denom": [_P] * 5 + [_I] * 4 + [_F, _P],
    "nt_flash_fixed_unroll2": [_P] * 4 + [_I] * 5 + [_F, _P],
    "nt_flash_fixed_i8": [_P] * 6 + [_I] * 5 + [_P],
    "nt_gemm_probe_i8": [_P] * 5 + [_I] * 6 + [_P],
    "nt_gemm_probe_bf16": [_P] * 5 + [_I] * 6 + [_P],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build this process ran


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD / f"libnunchaku_kernels_{_key()}.so"


def build(log=None) -> Path:
    """Compile and link the kernels unless the library for these sources
    exists. ``log`` (a callable taking one string) receives nvcc's output,
    including ``-Xptxas -v``'s registers, shared memory and spills."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    work = BUILD / f"obj_{out.stem}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        if log is not None and text:
            log(f"[nvcc {src.name}]\n{text.rstrip()}")
        if proc.returncode != 0:
            failed.append((src.name, text))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n}:\n{t}" for n, t in failed))
    tmp = work / out.name
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def _per_kernel(path: Path, flag: str, start: str, count) -> dict[str, dict[str, int]]:
    """``cuobjdump <flag>`` of the built library, one dict per kernel
    (demangled name): ``start`` matches the line that opens a kernel's
    section, ``count(line, counts)`` adds each later line to its dict."""
    tools = Path(_nvcc()).parent
    text = subprocess.run([str(tools / "cuobjdump"), flag, str(path)], capture_output=True, text=True,
                          check=True).stdout
    per, fn = {}, None
    for line in text.splitlines():
        m = re.search(start, line)
        if m:
            fn = m.group(1)
            per[fn] = {}
        elif fn is not None:
            count(line, per[fn])
    names = subprocess.run([str(tools / "cu++filt")], input="\n".join(per), capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return dict(zip(names, per.values()))


def sass_counts(path: Path, opcodes=("HGMMA", "IGMMA", "UTMALDG")) -> dict[str, dict[str, int]]:
    """Per kernel of the built library (demangled name), how many of its
    SASS instructions (``cuobjdump -sass``) carry each opcode: HGMMA is a
    bf16 wgmma, IGMMA an int8 one, UTMALDG a TMA tensor load."""
    def count(line, c):
        for op in opcodes:
            c[op] = c.get(op, 0) + (op in line)
    return {k: {op: c.get(op, 0) for op in opcodes} for k, c in
            _per_kernel(path, "-sass", r"Function : (\S+)", count).items()}


def resource_usage(path: Path) -> dict[str, dict[str, int]]:
    """Per kernel of the built library (demangled name), ``cuobjdump
    -res-usage``'s REG (registers a thread), STACK and LOCAL (bytes a
    thread: nonzero when ptxas spilled)."""
    def count(line, c):
        for key in ("REG", "STACK", "LOCAL"):
            m = re.search(rf"\b{key}:(\d+)", line)
            if m:
                c[key] = int(m.group(1))
    return _per_kernel(path, "-res-usage", r"Function (\S+):", count)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def require(cond: bool, what: str) -> None:
    """A wrapper's check of what its kernel takes (device, dtype, shape)."""
    if not cond:
        raise ValueError(what)
