"""Spawn N ranks on this machine and run one stage of the port on each.

``run("package.module:function", n, device="cuda", **kwargs)`` starts ``n``
processes with the ``spawn`` context of ``torch.multiprocessing``, joins
them in one process group (:func:`.mesh.init_distributed`, rendezvous
through a ``file://`` in a fresh temporary directory, so launches never
collide), calls ``function(**kwargs)`` on every rank and returns rank 0's
result (numpy arrays and plain Python values) to the caller.  The stage is
named by module and function so that the children import only the port
(a test module that imports JAX stays out of them).

CUDA ranks take ``cuda:LOCAL_RANK``; where there are more ranks than cards
(or with ``share_cards``) they share the cards over gloo.  The kernels'
libraries are built once in the parent before the ranks start.  A rank
that fails ends the launch: the others are stopped and its traceback is
raised here.
"""

from __future__ import annotations

import importlib
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.multiprocessing as mp


# the host thread pools a rank reads at start: torch's (OpenMP) and the
# BLAS numpy loads; each rank gets ``threads`` of them
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _stage(spec: str):
    mod, _, fn = spec.partition(":")
    return getattr(importlib.import_module(mod), fn)


def _child(rank: int, world: int, rdv: str, spec: str, kwargs: dict,
           device: str, share: bool, threads: int, out) -> None:
    from .mesh import init_distributed, shutdown

    try:
        torch.set_num_threads(threads)
        init_distributed(rank, world, rank, device=device, share_cards=share,
                         init_method=rdv)
        res = _stage(spec)(**kwargs)
        if rank == 0:
            out.put(("ok", rank, res))
        shutdown()
    except BaseException:
        out.put(("error", rank, traceback.format_exc()))  # to the parent
        raise


def build_kernels() -> None:
    """Build (or find current) the CUDA libraries before ranks start."""
    from ..ops import block_kernels, haydock_kernels

    haydock_kernels._library()
    block_kernels._library()


def run(spec: str, n: int, *, device: str,
        share_cards: Optional[bool] = None, threads: int = 1,
        timeout: float = 600.0, **kwargs):
    """Run the stage ``spec`` (``"module:function"``) on ``n`` ranks and
    return rank 0's result.  ``device`` (no default) is ``"cuda"`` (NCCL,
    or gloo where the ranks share cards: ``share_cards``, by default when
    there are more ranks than cards) or ``"cpu"`` (gloo); each rank runs
    torch and the BLAS on ``threads`` host threads."""
    if torch.device(device).type == "cuda":
        from ..utils.device import resolve_device

        resolve_device("cuda")
        if share_cards is None:
            share_cards = n > torch.cuda.device_count()
        build_kernels()
    share_cards = bool(share_cards)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="rslmto_rdv_")
    rdv = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_child,
                         args=(r, n, rdv, spec, kwargs, device, share_cards,
                               threads, out))
             for r in range(n)]
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    try:
        os.environ.update({k: str(threads) for k in THREAD_VARS})
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        result, errors = None, []
        deadline = time.monotonic() + timeout
        while not errors:
            try:
                kind, rank, val = out.get(timeout=0.5)
                if kind == "error":
                    errors.append((rank, val))
                else:
                    result = val
                continue
            except queue_mod.Empty:
                pass
            codes = [p.exitcode for p in procs]
            if all(c is not None for c in codes):
                errors += [(r, f"exit code {c}") for r, c in enumerate(codes)
                           if c != 0]
                if result is None and not errors:
                    errors.append((0, "no result"))
                break
            if any(c not in (None, 0) for c in codes):
                try:  # the failing rank's traceback, if it sent one
                    kind, rank, val = out.get(timeout=5.0)
                    errors.append((rank, val))
                except queue_mod.Empty:
                    errors += [(r, f"exit code {c}")
                               for r, c in enumerate(codes)
                               if c not in (None, 0)]
            if time.monotonic() > deadline:
                raise TimeoutError(f"{spec} on {n} ranks: not done within "
                                   f"{timeout} s")
        if errors:
            rank, msg = errors[0]
            raise RuntimeError(f"rank {rank} of {n} failed in {spec}:\n{msg}")
        return result
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
