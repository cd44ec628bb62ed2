"""Time the port's K3' (``update_norm`` in ``rslmtoasa_tpu_torch/csrc/
haydock.cu``) at every launch shape, on one CUDA card.

    python tools/k3_plans.py

For each size the port launches it at (C = 9: the wavefront's prefixes of
512 to 65 536 rows, the bench box's 27 000 rows, a box-60 row slab's
108 000; C = 144: the bench's 27 000 rows), on random inputs made on the
card: the recursion's deferred step at every (kr, rows) the kernel takes
(kr threads per chain, ``rows`` rows a block), CUDA-event means of 40
launches made straight through the C interface (no Python wrapper around
them, so that the small sizes show the kernel and not the host), the
best of two runs; the shape ``update_plan`` picks; and ``torch.addcmul``
on the same bytes (three reads, one write), the rate this access pattern
gets on the card.  Every shape's out is checked bit-equal to the picked
shape's, and its row-block partials and b2 to those of the same kr at
any rows (kr sets the order in which a piece's elements are added, the
rows do not).  Last, the wavefront's 19 launches of the box-60 scalar
plan (``chip_smoke.py`` phase 12) at the picked shapes, summed.  Prints
the card's name and power limit first.  Run it from the repository's
root.
"""

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
from rslmtoasa_tpu_torch.ops import haydock_kernels as hk  # noqa: E402

HBM_BYTES_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
SIZES = [(n, 9) for n in (512, 1024, 2048, 4096, 8192, 16384, 27000, 32768,
                          65536, 108000)] + [(27000, 144)]
# the box-60 scalar wavefront plan's stages (prefix rows, steps)
STAGES = ((512, 3), (1024, 1), (2048, 2), (4096, 2), (8192, 3), (16384, 3),
          (32768, 4), (65536, 1))
ROWS = (2, 4, 8, 16, 32)


def cuda_ms(fn, iters=40):
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


def launcher(kk, c, s, v, u, w, b2, a, plan, dev):
    """One launch of K3' at ``plan`` through the C interface, and the
    scratch it writes (the row-block partials first)."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    ct, kr, rows, ln, npart, nruns, npieces, counter = hk._update_setup(
        kk, c, dev, stream, plan)
    scratch = torch.empty(npart + nruns + npieces, dtype=torch.float64,
                          device=dev)
    base = scratch.data_ptr()
    args = (1, *(t.data_ptr() for t in s), v.data_ptr(), u.data_ptr(),
            w.data_ptr(), base,
            base + 8 * (npart + nruns) if npieces else base,
            base + 8 * npart, a.data_ptr(), b2.data_ptr(),
            counter.data_ptr(), kk, c, ct, kr, rows, ln,
            ctypes.c_void_p(stream))
    fn = hk._library().haydock_update_norm

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"haydock_update_norm: CUDA error {err}")
    return launch, scratch[:npart].view(-1, c)


def main():
    if not torch.cuda.is_available():
        sys.exit("k3_plans: torch sees no CUDA device")
    hk.build_library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    nsm = hk._sm_count(dev.index)
    gen = torch.Generator(device=dev)
    picked = {}
    for kk, c in SIZES:
        gen.manual_seed(kk + c)

        def vec(rows):
            return torch.view_as_complex(torch.randn(
                (rows, 9, c, 2), dtype=torch.float64, device=dev,
                generator=gen))

        v, u, w0 = vec(kk), vec(kk + 1), vec(kk + 1)
        s = (torch.randn(c, dtype=torch.float64, device=dev, generator=gen),
             torch.rand(c, dtype=torch.float64, device=dev, generator=gen)
             * 0.5 + 0.5,
             torch.rand(c, dtype=torch.float64, device=dev, generator=gen)
             * 0.5 + 1.0)
        pick = hk.update_plan(kk, c, nsm)
        ct = pick[0]
        plans = [(ct, kr, rows) for kr in hk.UPD_KR
                 if kr * ct <= hk.UPD_THREADS for rows in ROWS]
        bound = 4 * kk * 9 * c * 16 / HBM_BYTES_S * 1e3
        ref, by_kr, times = None, {}, {}
        for plan in [pick] + [p for p in plans if p != pick]:
            w = w0.clone()
            b2 = torch.empty(c, dtype=torch.float64, device=dev)
            a = torch.empty_like(b2)
            launch, part = launcher(kk, c, s, v, u, w, b2, a, plan, dev)
            launch()  # once on w0: the bits every shape must give
            torch.cuda.synchronize()
            got = (w.clone(), part.clone(), b2.clone(), a.clone())
            ref = ref or got
            same = by_kr.setdefault(plan[1], got)
            if not (torch.equal(got[0], ref[0])
                    and torch.equal(got[3], ref[3])
                    and all(torch.equal(x, y) for x, y in zip(got, same))):
                raise RuntimeError(f"kk={kk} C={c}: {plan} gives other "
                                   f"bits than {pick}")
            times[plan] = min(cuda_ms(launch), cuda_ms(launch))
        wk = w0[:kk]
        yard = cuda_ms(lambda: torch.addcmul(wk, v, u[:kk], out=wk))
        best = min(times, key=times.get)
        print(f"kk={kk} C={c} bound {bound:.4f} ms: update_plan "
              f"{pick[1:]} {times[pick]:.4f} ms "
              f"({100 * bound / times[pick]:.1f}%), fastest {best[1:]} "
              f"{times[best]:.4f} ms; torch.addcmul {yard:.4f} ms "
              f"({100 * bound / yard:.1f}%); by (kr, rows): " + ", ".join(
                  f"{p[1]}/{p[2]} {t:.4f}" for p, t in sorted(times.items())),
              flush=True)
        picked[(kk, c)] = (times[pick], bound)
        del v, u, w0
        torch.cuda.empty_cache()
    t = sum(n * picked[(k, 9)][0] for k, n in STAGES)
    b = sum(n * picked[(k, 9)][1] for k, n in STAGES)
    print(f"the box-60 scalar wavefront's 19 launches at update_plan's "
          f"shapes: {t:.4f} ms against {b:.4f} ms of bound "
          f"({100 * b / t:.1f}%)")


if __name__ == "__main__":
    main()
