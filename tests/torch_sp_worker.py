"""Process-group workers of tests/test_torch_sp.py (torch only: no JAX).

:func:`run_ranks` spawns one process per rank; each joins a gloo process
group through a file in the test's temporary directory (``file://``: the
parallel test workers never share an address), runs one task of
:data:`TASKS` on the tensors and models the parent saved there, and saves
what it returns as ``out{rank}.pt``. Each child runs one intra-op thread and
gives its group a timeout; the parent kills every child still alive at its
deadline and raises, so a hung ring cannot outlast the test.
"""

from __future__ import annotations

import datetime
import os
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 60


def _load(tmp, name):
    return torch.load(os.path.join(tmp, name), weights_only=False)


def ring_task(rank, n, tmp):
    """This rank's block of the ring attention over the saved global q, k, v
    (scale None: 1/sqrt(D))."""
    from nunchaku_tpu_torch.parallel import ring_attention

    q, k, v = (t.chunk(n, dim=2)[rank] for t in _load(tmp, "qkv.pt"))
    return ring_attention(q, k, v, scale=None)


def models_task(rank, n, tmp):
    """The sequence-parallel forwards of the saved FLUX, Qwen-Image and
    Z-Image models on their saved global inputs, and the two refusals: a
    FLUX model after ``enable_fused_qkv_prep()`` and a sequence that does
    not split into ``n`` shards."""
    from nunchaku_tpu_torch.parallel import (parallelize_sequence, parallelize_sequence_qwenimage,
                                             parallelize_sequence_zimage)

    out = {}
    with torch.no_grad():
        for name, parallelize in (("flux", parallelize_sequence), ("qwen", parallelize_sequence_qwenimage),
                                  ("zimage", parallelize_sequence_zimage)):
            model, args = _load(tmp, f"{name}.pt")
            model, forward = parallelize(model)
            out[name] = forward(model, *args)
        model, args = _load(tmp, "flux.pt")
        model, forward = parallelize_sequence(model)
        out["indivisible"] = _refusal(lambda: forward(model, args[0][:, :-1], *args[1:]))
        model.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
        out["fused"] = _refusal(lambda: forward(model, *args))
    return out


def _refusal(call):
    """The message of the ValueError ``call()`` raises, or None."""
    try:
        call()
    except ValueError as e:
        return str(e)
    return None


TASKS = {"ring": ring_task, "models": models_task}


def _entry(rank, task, n, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'pg')}", world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        torch.save(TASKS[task](rank, n, tmp), os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(task: str, n: int, tmp, deadline_s: float = 150.0) -> list:
    """Run ``TASKS[task]`` on ``n`` gloo ranks -> each rank's result, in
    rank order. Raises if a rank fails or the deadline passes (the children
    still alive are killed first)."""
    tmp = str(tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(rank, task, n, tmp)) for rank in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive:
        raise TimeoutError(f"{task} on {n} ranks: {len(alive)} rank(s) still running after {deadline_s} s")
    errors = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp)) if f.startswith("err")]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"{task} on {n} ranks failed (exit codes {[p.exitcode for p in procs]}):\n"
                           + "\n".join(errors))
    return [torch.load(os.path.join(tmp, f"out{rank}.pt"), weights_only=False) for rank in range(n)]
