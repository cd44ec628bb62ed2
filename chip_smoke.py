"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line of output each (any failed check raises, and the exit
code is then non-zero):

0. card: name, torch and CUDA versions, nvidia-smi's name and power limit;
1. build: ``libhaydock.so`` from ``rslmtoasa_tpu_torch/csrc`` with nvcc
   (time and the ``-Xptxas -v`` lines), and the native atomic-sphere
   solver with g++;
2. kernels vs plain: both Haydock kernels against their plain PyTorch
   versions on the card, at the bench shape (bcc box 30, kk = 27000,
   15 slots) for C = 9 chains (one SCF spin channel) and C = 144 (16 start
   atoms), totals and row-block partials within 1e-12 of the output's
   scale; then CUDA-event times, plain and kernel in turns;
3. recursion: ``lanczos_coefficients`` through the kernels vs the plain
   versions on the card, C = 144, lld = 20: a and b2 within 1e-11;
4. main path: a 2-iteration bulk SCF on the box-30 preset with
   ``device='cuda'`` against the same with ``device='cpu'`` (plain
   versions): etot within 1e-9, fermi, ql and mom within 1e-10, and each
   kernel launched nstep * 2 spins * (lld - 1) times; with the wall per
   iteration and its split over the SCF's timer sections.

The last two lines are the kernels' JSON record and the result line.
Without a CUDA card, or without the repository beside it, it exits
non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PRESET = dict(rc=120.0, ndim=1_000_000, lld=20, box=30)
NSTEP = 2
SOURCE = "rslmtoasa_tpu_torch/csrc/haydock.cu"
REPLACES = {"spmv_dot": "rslmtoasa_tpu/ops/pallas_conv.py:185",
            "update_norm": "rslmtoasa_tpu/ops/pallas_conv.py:551"}
ITERS = 20


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters=ITERS):
    """Mean CUDA-event time of ``fn`` over ``iters`` launches, after one
    warm-up launch."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def in_turns(plain, kernel):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), \
        cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def random_chains(kk, c, seed, dev):
    rng = np.random.default_rng(seed)
    x = np.zeros((kk + 1, 9, c), np.complex128)
    x[:kk] = rng.standard_normal((kk, 9, c)) + 1j * rng.standard_normal(
        (kk, 9, c))
    x /= np.linalg.norm(x, axis=(0, 1))
    return torch.from_numpy(x).to(dev)


def section_totals(timer):
    """{section path: seconds so far} of the SCF's timer tree."""
    out = {}

    def walk(node, prefix):
        for name, ch in node.children.items():
            out[prefix + name] = ch.total
            walk(ch, prefix + name + "/")

    walk(timer.root, "")
    return out


def rel_err(got, want):
    scale = float(want.abs().max())
    return float((got - want).abs().max()), scale


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rslmtoasa_tpu_torch import native
    from rslmtoasa_tpu_torch.models.presets import build_synthetic_bcc
    from rslmtoasa_tpu_torch.models.scf import SelfConsistency
    from rslmtoasa_tpu_torch.ops import haydock_kernels as hk
    from rslmtoasa_tpu_torch.ops.lanczos import (
        HaydockOperator,
        lanczos_coefficients,
        scalar_start_vectors,
    )
    from rslmtoasa_tpu_torch.utils.timer import g_timer

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # 0. card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi reports the card")
    say(0, f"card {kind} x{count}; torch {torch.__version__} "
           f"cuda {torch.version.cuda}")
    print(smi[0], flush=True)

    # 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    log = hk.build_library()
    say(1, f"built {os.path.relpath(hk.LIBRARY)} in "
           f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line and ("registers" in line or "spill" in line
                                or "Compiling" in line):
            print("   ", line.strip(), flush=True)
    t0 = time.perf_counter()
    native.get_lib()
    say(1, f"built {os.path.relpath(native.LIBRARY)} in "
           f"{time.perf_counter() - t0:.1f} s")

    # 2. kernels vs plain --------------------------------------------
    t0 = time.perf_counter()
    bench = build_synthetic_bcc(device=dev, **PRESET)
    hb = bench.ham
    kk = bench.cluster.kk
    op = HaydockOperator(hb.ee[:, :, :9, :9], hb.iz, hb.cols).to(dev)
    say(2, f"preset box {PRESET['box']}: kk={kk}, nslots={hb.cols.shape[1]}"
           f", built in {time.perf_counter() - t0:.1f} s")
    check(kk == 27000 and hb.cols.shape[1] == 15, "bench shape")
    records = {n: {"max_abs_err": 0.0} for n in REPLACES}
    for c in (9, 144):
        psi = random_chains(kk, c, 1, dev)
        v = random_chains(kk, c, 2, dev)[:kk].contiguous()
        pmn = random_chains(kk, c, 3, dev)[:kk].contiguous()
        a = torch.linspace(-1.0, 1.0, c, dtype=torch.float64, device=dev)
        y, ap = hk.spmv_dot(op.hs, op.iz, op.cols, psi)
        y0, ap0 = hk.spmv_dot_ref(op.hs, op.iz, op.cols, psi)
        pmn_in = pmn.clone()
        out, nrm = hk.update_norm(a, psi, v, pmn_in)
        out0, nrm0 = hk.update_norm_ref(a, psi, v, pmn)
        torch.cuda.synchronize()
        errs = {}
        for name, pairs in (("spmv_dot", ((y, y0), (ap, ap0),
                                          (ap.sum(0), ap0.sum(0)))),
                            ("update_norm", ((out, out0), (nrm, nrm0),
                                             (nrm.sum(0), nrm0.sum(0))))):
            for got, want in pairs:
                err, scale = rel_err(got, want)
                check(err <= 1e-12 * scale, f"{name} C={c}: {err} > "
                      f"1e-12 * {scale}")
                errs[name] = max(errs.get(name, 0.0), err)
                records[name]["max_abs_err"] = max(
                    records[name]["max_abs_err"], err)
        y_buf = pmn.clone()
        ms_k1, ms_p1 = in_turns(
            lambda: hk.spmv_dot_ref(op.hs, op.iz, op.cols, psi),
            lambda: hk.spmv_dot(op.hs, op.iz, op.cols, psi))
        ms_k3, ms_p3 = in_turns(
            lambda: hk.update_norm_ref(a, psi, v, y_buf),
            lambda: hk.update_norm(a, psi, v, y_buf))
        if c == 9:  # the main path's shape
            records["spmv_dot"].update(ms=ms_k1, plain_ms=ms_p1)
            records["update_norm"].update(ms=ms_k3, plain_ms=ms_p3)
        say(2, f"C={c}: spmv_dot err {errs['spmv_dot']:.3e} kernel "
               f"{ms_k1:.4f} ms plain {ms_p1:.4f} ms; update_norm err "
               f"{errs['update_norm']:.3e} kernel {ms_k3:.4f} ms plain "
               f"{ms_p3:.4f} ms")
        del psi, v, pmn, pmn_in, y, y0, out, out0, y_buf
        torch.cuda.empty_cache()

    # 3. recursion ---------------------------------------------------
    starts = [i * (kk // 16) for i in range(16)]
    psi0 = scalar_start_vectors(kk, starts, dev)
    lld = PRESET["lld"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, b2 = lanczos_coefficients(op.hs, op.iz, op.cols, psi0, lld)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    a0, b20 = lanczos_coefficients(op.hs, op.iz, op.cols, psi0, lld,
                                   plain=True)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    ea = float((a - a0).abs().max())
    eb = float((b2 - b20).abs().max())
    check(a.shape == (lld, 144) and bool(torch.isfinite(b2).all()),
          "recursion shape and finiteness")
    check(ea <= 1e-11 and eb <= 1e-11, f"recursion a {ea}, b2 {eb}")
    nnz = kk * hb.cols.shape[1] * 81
    say(3, f"C=144 lld={lld}: |da|={ea:.3e} |db2|={eb:.3e}; kernels "
           f"{t_k:.3f} s ({nnz * 144 * (lld - 1) / t_k / 1e9:.2f} Gnnz/s), "
           f"plain {t_p:.3f} s")
    del bench, op, psi0
    torch.cuda.empty_cache()

    # 4. main path ---------------------------------------------------
    results = {}
    for device in ("cuda", "cpu"):
        sys_ = build_synthetic_bcc(device=device, **PRESET)
        before = section_totals(g_timer)
        with tempfile.TemporaryDirectory() as work:
            scf = SelfConsistency(sys_, workdir=work)
            if device == "cuda":
                hk.spmv_dot.launches = 0
                hk.update_norm.launches = 0
            t0 = time.perf_counter()
            state = scf.run(nstep=NSTEP)
            wall = time.perf_counter() - t0
            if device == "cuda":
                launches = {"spmv_dot": hk.spmv_dot.launches,
                            "update_norm": hk.update_norm.launches}
        pot = sys_.atoms[0].potential
        results[device] = dict(etot=pot.etot, fermi=scf.fermi,
                               ql=pot.ql.copy(), mom=np.array(pot.mom))
        check(state.niter == NSTEP and np.isfinite(pot.etot)
              and np.isfinite(pot.ql).all(), f"{device} SCF finished")
        spent = {k: v - before.get(k, 0.0)
                 for k, v in section_totals(g_timer).items()}
        rec = spent["recursion-phase/recursion"]
        say(4, f"SCF device={device} sections (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in spent.items() if v > 0.0005))
        say(4, f"SCF device={device}: {wall / NSTEP:.3f} s per iteration, "
               f"recursion {100 * rec / wall:.1f}%; "
               f"etot {float(pot.etot)!r} fermi {float(scf.fermi)!r} "
               f"delta {state.delta:.3e}")
    gpu, cpu = results["cuda"], results["cpu"]
    check(abs(gpu["etot"] - cpu["etot"]) <= 1e-9, "etot within 1e-9")
    check(abs(gpu["fermi"] - cpu["fermi"]) <= 1e-10, "fermi within 1e-10")
    check(np.abs(gpu["ql"] - cpu["ql"]).max() <= 1e-10, "ql within 1e-10")
    check(np.abs(gpu["mom"] - cpu["mom"]).max() <= 1e-10,
          "mom within 1e-10")
    want = NSTEP * 2 * (PRESET["lld"] - 1)
    for name, n in launches.items():
        check(n == want, f"{name} launched {n} times, want {want}")
        records[name]["launches"] = n
    say(4, f"cuda vs cpu: |detot|={abs(gpu['etot'] - cpu['etot']):.3e} "
           f"|dfermi|={abs(gpu['fermi'] - cpu['fermi']):.3e}; launches "
           f"{launches}")
    check("jax" not in sys.modules, "no JAX imported")

    kernels = [dict(name=n, route="cuda", source=SOURCE, replaces=REPLACES[n],
                    launches=r["launches"], max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"])
               for n, r in records.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
