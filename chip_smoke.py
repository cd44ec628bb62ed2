"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line of output each (any failed check raises, and the exit
code is then non-zero):

0. card: name, torch and CUDA versions, nvidia-smi's name and power limit;
1. build: ``libhaydock.so`` and ``libblockstep.so`` from
   ``rslmtoasa_tpu_torch/csrc`` with nvcc
   (time and the ``-Xptxas -v`` lines of every kernel), and the native
   atomic-sphere solver with g++; ``cuobjdump -sass`` of the libraries must
   show DMMA (FP64 tensor-core) instructions in both SpMV kernels and in K4
   at both widths;
2. kernels vs plain: the three Haydock kernels against their plain
   PyTorch versions on the card, at the bench shape (bcc box 30,
   kk = 27000, 15 slots) for C = 9 chains (one SCF spin channel) and
   C = 144 (16 start atoms), totals and row-block partials within 1e-12
   of the output's scale; K2' ``spmv_dot_pipelined`` also against K1'
   ``spmv_dot`` (y bit-equal, a within 1e-13 of the folded partials), and
   a rerun of each SpMV bit-identical; K3' ``update_norm`` in its deferred
   step and at (1, -a, 1), the Pallas K3 contract (b2 within 1e-13
   relative, a within 1e-15, reruns bit-identical, its ticket counters
   left zero); then CUDA-event times, plain and
   kernel in turns, each kernel's share of its bound, the step's update
   phase before this K3' (K3' at (1, -a, 1) and the torch passes that
   normalised the chain) and now (one launch), alone and after K1', K3'
   at each block size beside ``torch.addcmul`` on the same bytes, the
   SpMVs' TFLOP/s
   and gathered bytes, K1' taken apart (gathers only, MMAs only, every
   column the row itself), and the time of one library call computing
   the SpMV (``torch.sparse.mm`` of H as a complex128 CSR matrix, which
   leaves out the dot); last both SpMVs on the B2 preset (two types mixed
   within a row tile) at C = 9;
3. recursion: ``lanczos_coefficients`` through the kernels vs the plain
   versions on the card, C = 144, lld = 20, for both engines (K1' and
   ``roll=True``, K2'): a and b2 within 1e-11; the 19 steps' time;
4. main path: a 2-iteration bulk SCF on the box-30 preset with
   ``device='cuda'``, once on the default engine and once with
   ``RSLMTO_ROLL=1`` (K2'), against the same with ``device='cpu'``
   (plain versions): after one iteration etot within 1e-9, fermi, ql and
   mom within 1e-10; the second iteration from the CPU run's state on the
   card's engine at the same bars, an etot miss within the atomic-sphere
   solver's last three iterations (where it stops unconverged) listed as
   unmet, as phase 7 holds its pairs; each kernel of the engine launched
   nstep * 2 spins * (lld - 1) times and the other SpMV kernel never;
   with the wall per iteration and its split over the SCF's timer
   sections;
5. bench: ``rslmtoasa_tpu_torch.bench.main(n_start=1)`` (C = 9) in this
   process; its JSON line parses and its host guard passed; its ms a
   step;
6. block step: K4 ``block_step`` against its plain version on the card at
   the box-30 shape with spin-orbit coupling (d = 18, R = 1; both HoH
   launches; a d = 9 spin sector) and on the B2 preset (two types, R = 2):
   y, the Gram partials and their sum within 1e-12 of scale, reruns
   bit-identical; CUDA-event times of K4 and its plain version in turns,
   the share of the bound, and one library call computing the same SpMV
   (``torch.sparse.mm`` of H as a complex128 CSR matrix with the onsite
   term folded in, which leaves out the Gram); one block step taken apart;
   ``block_lanczos`` and ``chebyshev_moments`` at lld 20 through K4
   against their plain versions (non-HoH and HoH): within 1e-11; on B2 at
   d = 18 the kernel walks its table in chunks;
7. block and Chebyshev SCFs: 2 iterations at kk = 27000, ``nsp=2``, for
   ``recur='block'`` (``hoh`` False and True) and ``recur='chebyshev'``
   (window (-1.5, 1.0)), the Green functions on the card, through K4
   against the same with ``plain=True`` on the card, and at box 10
   (kk = 1000) against ``device='cpu'``; at box 10 also the plain versions
   on the card against the CPU, which no kernel touches.  Every pair is
   held after one iteration at the strict bars (etot 1e-9, fermi, ql and
   mom 1e-10), and on the second at ``NSTEP_BARS``: the second
   iteration from the reference run's state after the first, on the other
   run's engine, against the reference's own; there etot, the
   atomic-sphere solver's output, may also lie within the spread of the
   solver's last three iterations where the solver alone, on the
   reference's inputs, stops at its iteration limit unconverged.  The runs'
   scalars after two iterations print beside it, and where they miss those
   bars the part that the first iteration's roundoff brings through the
   solver (the same engine from both states) prints with them; K4 launched
   nstep * (lld - 1) times per H application (twice that with HoH),
   nstep * (lld + 1) for Chebyshev, and K1'-K3' never; with the wall per
   iteration and its split over the timer sections.
8. surface and impurity: a bcc(001) slab (``rc=340``, kk = 27798, four
   types) and the bcc host with three impurities (``rc=220``, kk = 27316,
   a local zone of 60 atoms: 64 row types in the combined table), three
   start blocks each: K4 against its plain version (d = 18 with both HoH
   launches, d = 9), timed beside its bound, ``torch.sparse.mm`` of the
   same H and the box-30 K4 of phase 6; then 2-iteration block (``hoh``
   False and True) and Chebyshev SCFs of each, ``nsp=2``, lld 12, K4
   against ``plain=True`` on the card and at ``rc=12`` (300 energy
   points) the card against the CPU,
   held as phase 7 holds them, except that an etot miss passes, listed as
   unmet, where the atomic-sphere solver explains it (its inputs of the
   two runs within the ql bar, and the solver on got's inputs repeating
   got's etot), also after one iteration; the seconds per iteration of
   every timer section, ``madelung-surface`` among them.
9. exchange: the box-30 bcc preset as an exchange run
   (``presets.synthetic_exchange``: the onsite pair of atom 1 and one pair
   in each of its first five shells, R = 21 live start blocks, ``nsp=2``
   with spin-orbit coupling, lld 20, 2 510 energy points): K4 against its
   plain version at C = 378 (d = 18), timed beside its bound and
   ``torch.sparse.mm``; the block, HoH and Chebyshev exchange runs through
   K4 against ``plain=True`` on the card (chains within 1e-11, Jij/Dij/Aij
   within 1e-8 mRy, every written file within 1e-6; the whole run's Green
   function difference printed), with K4's launch counts, the timer
   sections and the peak device memory; at box 10 (lld 12, 310 energy
   points, the onsite pair, nn and 2nn: R = 9) the same runs with the
   two-index split, the auxiliary-GF Jij,
   Gauss-Legendre (block), damping, inertia and the Jijk trio, the card
   against the CPU at the same bars, and the Green functions of the card's
   chains on the CPU within ``green_bar``: 1e-12 of scale plus lld - 1
   times the CPU's own movement when the energies move by one unit in the
   last place of the Hamiltonian's scale.
10. conductivity: K4 in its two Kubo forms at box 30, d = 18, R = 1 (a
   velocity table alone, one launch; with HoH ``v psi - vo (hs psi)``, two)
   against their plain versions (1e-12 of scale, reruns bit-identical),
   timed beside their bounds and ``torch.sparse.mm`` of the velocity
   table as CSR (with HoH of ``[v | -vo]`` on ``psi`` stacked on
   ``hs psi``); one contraction of the moments (the whole left chain of
   200 against 16 right vectors) timed beside its bound; then conductivity
   runs of the box-30 preset (``nsp=2`` with spin-orbit coupling,
   ``per_type``, ``cond_ll`` 200, the window (-1.5, 1.0), 2 510 energy
   points; ``hoh`` off and on, the HoH runs' atoms given an overlap)
   through K4 against ``plain=True`` on the card, and at box 10 (``cond_ll``
   40) the card against the CPU: mu within 1e-11 of its scale, every
   written file within 1e-6, K4 launched ``ops/kubo.launches`` times (one
   left block); with the wall, its timer sections (``kubo-moments``, which
   ends in a sync, and ``gamma-and-integrals``) and the peak device memory.
11. last branches, each through ``cli.run_system`` (the CLI's dispatch on
   a built system) at box 30, ``nsp=2`` with spin-orbit coupling unless
   said: K4 in its orbital form (R start blocks at the orbital run's group
   size, the lsham onsite term, no Gram) against its plain version (1e-12
   of scale, reruns bit-identical), timed beside its bound and
   ``torch.sparse.mm``, and the orbital trace of 16 sites through K4
   against plain (1e-11 of scale); ``orbital_modern`` on the CLI's 2 000
   sites (window (-1.5, 1.0)) through K4 alone, launched lld + 1 times per
   group; a bravais block SCF writing ``rs2paoham.dat``, and on it as
   ``paoham.dat`` the ``paoflow2rs`` SCF, ``exchange_p2rs`` (phase 9's six
   pairs) and ``conductivity_p2rs`` (``cond_ll`` 200); ``sd`` at ``nsp=3``
   (start moment tilted, Depondt at 300 K, two steps of one SCF iteration
   each), and the first step's moments (1e-10) and torques (1e-8 of scale,
   the atomic-sphere solver's noise) from one state, K4 against
   ``plain=True``; each run with its K4 launch count, wall, timer
   sections and peak device memory.  At box 10 (300 energy points) each
   branch on the card against the CPU on its written files (1e-6; the
   orbital moment on 16 sites at lld 12, ``sd`` on its trajectory, whose
   SCF files carry the solver's noise).

12. large cluster: the bcc preset at box 60 (kk = 216 000, ``nsp=2`` with
   spin-orbit coupling, lld 20), over the wavefront's threshold: the
   plans' stages and work shares (block, HoH, Chebyshev, from atom 0); the
   scalar (one spin channel: K1' and K3'), block, HoH and Chebyshev
   recursions on the wavefront through the kernels against the same
   wavefront's plain version and the full-width kernel route (1e-11), the
   walls of both routes (CUDA-synchronised), the launches against the
   plan's count and each table packed once, the kernels at every stage's
   prefix against their plain versions (1e-12 of scale), timed beside
   their bounds (the stage's occupied blocks) and ``torch.sparse.mm``,
   and the peak device memory; a 2-iteration block SCF through
   ``SelfConsistency`` on the wavefront with its sections, its first
   iteration against the full width's at the strict bars; at box 10 one
   block SCF iteration at ``txc=8`` with ``hyperfine`` (the Python
   atomic-sphere solver), the card against the CPU.
13. ranks: the multi-rank path (``parallel/mesh.py``, ``ops/rowslab.py``,
   ``parallel/launch.py``) on the one card.  K1', K3' and K4 (d = 18 and
   9, both HoH launches) on the box-60 tables cut into two row slabs (own
   rows, then the halo rows their columns reach) against their plain
   versions (1e-12 of scale), timed per launch beside their bounds and
   ``torch.sparse.mm`` on the same slab; two ranks sharing the card over
   gloo: the box-60 block, HoH, Chebyshev and scalar recursions from atom
   0 on row slabs (halo exchanges, launches, each rank's wall and peak
   memory) against the single rank's full-width kernel route (1e-11; the
   scalar one bit for bit), the
   box-30 exchange run (phase 9's six pairs, R = 21) chain-sharded against
   one rank (1e-10 mRy), and the 2-iteration box-30 block SCF through the
   CLI (``RSLMTO_ROWSHARD_BYTES`` sending its recursion to row slabs)
   against one rank's CLI on the written files (1e-6); one NCCL rank
   running the chain-sharded block recursion (the single rank's bits); the
   dry run (``rslmtoasa_tpu_torch.dryrun``) at two ranks on the card.
   Every time there measures the plumbing of two ranks on one card, not
   scaling.
14. terminator fits: ``bpopt_fit`` (``csrc/terminator.cu``) through
   ``get_terminf`` on the box-30 preset's block chains (lld 20, nsp 2)
   at R = 1 (324 chains) and R = 21 (6 804), bit for bit the NumPy
   route; the kernel's CUDA-event time, the NumPy route's wall, the
   whole call on the card's tensors, and the latency bound: the slowest
   chain's Sturm counts (the kernel's own count) times its n - 1 dependent
   levels a count times one level's latency, timed apart on one thread
   (``sturm_steps``, the chain's own finite operands).

All kernel sources build at once in phase 1, one nvcc each.

The last two lines are the kernels' JSON record and the result line.
Without a CUDA card, or without the repository beside it, it exits
non-zero and prints no result.
"""

import contextlib
import copy
import dataclasses
import inspect
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

PRESET = dict(rc=120.0, ndim=1_000_000, lld=20, box=30)
NSTEP = 2
# K4's forms on the slab (the chunked route) and on the impurity's
# combined table (the local zone's route), phase 8, and on the exchange
# pairs, phase 9; its Kubo velocity forms, phase 10, and its orbital form,
# phase 11, by the XLA op each replaces: kubo._spmv of a velocity table,
# with HoH _apply_v_hoh, and _apply_h
K4_FORMS = ("block_step[surface]", "block_step[impurity]",
            "block_step[exchange]")
KUBO_FORMS = {"block_step[kubo]": "rslmtoasa_tpu/ops/kubo.py:25",
              "block_step[kubo-hoh]": "rslmtoasa_tpu/ops/kubo.py:60",
              # the orbital moment's H~ (phase 11): R start blocks, lsham,
              # no Gram, the XLA op that the JAX package's orbital.py
              # applies
              "block_step[orbital]": "rslmtoasa_tpu/ops/kubo.py:37"}
# phase 12: the kernels on the wavefront's row prefixes, by the XLA op of
# the JAX package's staged recursions (ops/wavefront.py) each replaces
WAVEFRONT_FORMS = {
    "spmv_dot[wavefront]": "rslmtoasa_tpu/ops/wavefront.py:143",
    "update_norm[wavefront]": "rslmtoasa_tpu/ops/wavefront.py:149",
    "block_step[wavefront]": "rslmtoasa_tpu/ops/wavefront.py:230",
    "block_step[wavefront-hoh]": "rslmtoasa_tpu/ops/wavefront.py:223",
    "block_step[wavefront-chebyshev]": "rslmtoasa_tpu/ops/wavefront.py:323"}
SOURCES = {"spmv_dot": "rslmtoasa_tpu_torch/csrc/haydock.cu",
           "spmv_dot_pipelined": "rslmtoasa_tpu_torch/csrc/haydock.cu",
           "update_norm": "rslmtoasa_tpu_torch/csrc/haydock.cu",
           **{n: "rslmtoasa_tpu_torch/csrc/block_step.cu"
              for n in ("block_step",) + K4_FORMS + tuple(KUBO_FORMS)},
           **{n: "rslmtoasa_tpu_torch/csrc/" + (
               "block_step.cu" if n.startswith("block") else "haydock.cu")
              for n in WAVEFRONT_FORMS}}
# phase 13: the kernels on row-slab tables, by the TPU op of the JAX
# package's row-sharded recursions each replaces: the ring SpMV and the
# update of parallel/mesh.py lanczos_rowsharded, and the x-slab conv
# engines of ops/msconv_shard.py (block, and its HoH form)
SLAB_FORMS = {
    "spmv_dot[slab]": "rslmtoasa_tpu/parallel/mesh.py:180",
    "update_norm[slab]": "rslmtoasa_tpu/parallel/mesh.py:258",
    "block_step[slab]": "rslmtoasa_tpu/ops/msconv_shard.py:414",
    "block_step[slab-hoh]": "rslmtoasa_tpu/ops/msconv_shard.py:414"}
SOURCES.update({n: "rslmtoasa_tpu_torch/csrc/" + (
    "block_step.cu" if n.startswith("block") else "haydock.cu")
    for n in SLAB_FORMS})
# phase 14: the terminator fits, which the JAX package runs in NumPy on
# the host (no Pallas kernel)
SOURCES["bpopt_fit"] = "rslmtoasa_tpu_torch/csrc/terminator.cu"
TERMINATOR_R = (1, 21)
STURM_REPS = 20_000  # passes of sturm_steps over a chain's levels
REPLACES = {"bpopt_fit": "rslmtoasa_tpu/ops/terminator.py:158 (NumPy)",
            "spmv_dot": "rslmtoasa_tpu/ops/pallas_conv.py:185",
            "spmv_dot_pipelined": "rslmtoasa_tpu/ops/pallas_conv.py:352",
            "update_norm": "rslmtoasa_tpu/ops/pallas_conv.py:551",
            **{n: "rslmtoasa_tpu/ops/block_lanczos.py:27"
               for n in ("block_step",) + K4_FORMS}, **KUBO_FORMS,
            **WAVEFRONT_FORMS, **SLAB_FORMS}
# phase 8: the slab and the impurity at full width, and at a small size
# for the card against the CPU
EMBEDDED = {"surface": dict(rc=340.0), "impurity": dict(rc=220.0)}
EMBEDDED_SMALL = 12.0
EMBEDDED_SMALL_NE = 300  # energy points of the small runs (the CPU's inverses)
EMB_LLD = 12
# the block and Chebyshev SCFs of phase 7
BLOCK_CASES = {"block": dict(recur="block", hoh=False),
               "block-hoh": dict(recur="block", hoh=True),
               "chebyshev": dict(recur="chebyshev", hoh=False)}
WINDOW = (-1.5, 1.0)  # the Chebyshev window in which the moments converge
CHEB_AB = ((WINDOW[1] - WINDOW[0]) / 1.7, sum(WINDOW) / 2)  # H~ = (H - b)/a
SCF_BARS = dict(etot=1e-9, fermi=1e-10, ql=1e-10, mom=1e-10)
CHEB_BARS = dict(etot=3e-9, fermi=3e-9, ql=1e-9, mom=1e-10)
# The bars on the second SCF iteration.  Two runs of two iterations
# each carry the atomic-sphere solver's noise into the second: its
# eigenvalue searches stop at |de| <= 1e-8 and its own loop at a density
# change below 1e-6, so first iterations that agree to roundoff can land
# the scalars of the second well apart, with no kernel in either run.  So
# phase 7 holds the first iteration at SCF_BARS, and the second at these
# bars where both runs start it from one state.  Even then the solver,
# where it ends its 80 iterations unconverged, defines etot only within
# the change of its last iterations: an etot miss passes within that
# spread, measured by the solver alone on the reference's inputs, and is
# listed as unmet.
NSTEP_BARS = {"block": SCF_BARS, "block-hoh": SCF_BARS,
              "chebyshev": CHEB_BARS}
ITERS = 20
# phase 9: box 10's energy points for the card against the CPU (no mesh
# energy lies on a band centre C there, where Jijk's P / P0 is 0 / 0), its
# depth and its neighbour shells (the onsite pair, nn and 2nn: R = 9; the
# CPU's plain K4 at R = 21 takes ~1 s a launch), and the timed launches of
# K4's plain version and the library call at R = 21
XC_SMALL_NE = 300
XC_SMALL_LLD = 12
XC_SMALL_SHELLS = 2
XC_ITERS = 5
# phase 10: the moments of the full-width runs (the config's default
# cond_ll), box 10's for the card against the CPU, and the overlap the
# HoH runs give the preset's atoms (whose obar is 0, so that eeo and vo
# would be 0), per l and spin
COND_LL = 200
COND_SMALL_LL = 40
COND_OBAR = np.array([[-0.05, -0.055], [-0.04, -0.045], [-0.03, -0.035]])
# phase 11: the orbital moment's sites (the CLI's 2 000 at box 30), the
# start blocks held against the plain version and box 10's sites (the
# CLI's 1 000 would keep the CPU's plain K4 busy for minutes); the spin
# dynamics (Depondt with a thermal field, two steps, an SCF iteration
# each), its start moment, and the bar on its torques, K4 against plain
# from one state: the atomic-sphere solver turns inputs 1e-15 apart into
# potential parameters ~4e-11 apart (the CPU preset, port against JAX),
# ~4e-10 of the torques' scale
ORB_SITES = 2000
ORB_HELD = 16
ORB_SMALL_SITES = 16
SD_NML = ("&sd\n integrator = 'depondt'\n sd_temp = 300.0\n asd_step = 2\n"
          " alpha = 0.1\n dt = 1e-15\n sd_seed = 4321\n/\n")
TILT = np.array([0.3, -0.4, 0.866])
TORQUE_BAR = 1e-8
# phase 12: the large cluster (box 60: kk = 216 000, over the JAX
# package's wavefront threshold of 30 000), and the Python atomic-sphere
# solver's SCF (txc 8 with hyperfine) at box 10, the card against the CPU
# (its solve takes ~27 s a call; the CPU's plain K4 at box 30 ~1 min an
# iteration)
LARGE_BOX = 60
XC_SMALL_BOX = 10
XC_TXC = 8
# phase 13: two ranks on the one card; the CLI's block SCF at box 30 takes
# the row slabs under this budget (one chain's state, 6 kk d^2 16 B at
# d = 18, is 0.84 GB: over it, and its share on two ranks under it)
RANKS = 2
CLI_ROWSHARD_BYTES = 600_000_000
# H100 SXM peaks (NVIDIA data sheet, at 700 W): FP64 on the tensor cores,
# FP64 on the vector units, HBM3 bandwidth
FP64_TENSOR_FLOPS = 67e12
FP64_VECTOR_FLOPS = 34e12
HBM_BYTES_S = 3.35e12


def smi_line():
    """nvidia-smi's name and power limit of the card, as phase 0 prints
    them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


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


def in_turns(plain, kernel, iters=ITERS):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(fn, iters) for fn in (plain, kernel, kernel,
                                                     plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def random_chains(kk, c, seed, dev, d=9):
    """(kk+1, d, c) random unit columns with a zero row kk."""
    rng = np.random.default_rng(seed)
    x = np.zeros((kk + 1, d, c), np.complex128)
    x[:kk] = rng.standard_normal((kk, d, c)) + 1j * rng.standard_normal(
        (kk, d, c))
    x /= np.linalg.norm(x, axis=(0, 1))
    return torch.from_numpy(x).to(dev)


REC = "scf-iteration/recursion-phase/"  # an SCF iteration's recursions


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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def csr_operator(hs, iz, cols, onsite=None, izo=None, width=None):
    """H of the ELL tables as one complex128 CSR matrix (d kk, d width),
    the library call's operand (``width`` rows of x, kk + 1 unless given),
    with the onsite blocks ``onsite[izo]`` folded into each row's own slot;
    columns sorted within each row."""
    cols = cols.long()
    kk, nslots = cols.shape
    d = hs.shape[-1]
    dev = cols.device
    vals = hs[iz.long()]  # (kk, nslots, d, d): [i, m, a, b]
    if onsite is not None:
        check(bool((cols[:, 0] == torch.arange(kk, device=dev)).all()),
              "slot 0 is each row's own block")
        vals[:, 0] += onsite[izo.long()]
    order = cols.argsort(dim=1)
    cs = cols.gather(1, order)
    vals = vals[torch.arange(kk, device=dev)[:, None], order]
    vals = vals.permute(0, 2, 1, 3).reshape(-1)  # row (i, a); (m, b)
    colidx = (d * cs[:, None, :, None]
              + torch.arange(d, device=dev)).expand(kk, d, nslots, d)
    crow = torch.arange(d * kk + 1, device=dev) * (d * nslots)
    return torch.sparse_csr_tensor(crow, colidx.reshape(-1), vals,
                                   size=(d * kk, d * (width or kk + 1)))


def spmv_parity(hk, op, psi, what, records):
    """Both SpMV kernels against their plain versions (y, partials and
    their sum, a: within 1e-12 of scale), K2's y against K1's (bit-equal)
    and a against K1's folded partials (1e-13), and a rerun of each
    (bit-identical).  Returns (errors by kernel, |dy|, |da|)."""
    args = (op.hs, op.iz, op.cols, psi)
    y, ap = hk.spmv_dot(*args)
    y2, a2 = hk.spmv_dot_pipelined(*args)
    y0, ap0 = hk.spmv_dot_ref(*args)
    y20, a20 = hk.spmv_dot_pipelined_ref(*args)
    y1, ap1 = hk.spmv_dot(*args)
    y3, a3 = hk.spmv_dot_pipelined(*args)
    torch.cuda.synchronize()
    errs = {}
    for name, pairs in (("spmv_dot", ((y, y0), (ap, ap0),
                                      (ap.sum(0), ap0.sum(0)))),
                        ("spmv_dot_pipelined", ((y2, y20), (a2, a20)))):
        for got, want in pairs:
            err, scale = rel_err(got, want)
            check(err <= 1e-12 * scale, f"{name} {what}: {err} > "
                  f"1e-12 * {scale}")
            errs[name] = max(errs.get(name, 0.0), err)
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                               err)
    dy = float((y2 - y).abs().max())
    check(torch.equal(y2, y), f"K2' y equals K1' y, {what} (max diff {dy})")
    da, scale = rel_err(a2, ap.sum(0))
    check(da <= 1e-13 * scale, f"K2' a vs K1' folded partials, {what}: "
          f"{da} > 1e-13 * {scale}")
    check(torch.equal(y, y1) and torch.equal(ap, ap1) and torch.equal(y2, y3)
          and torch.equal(a2, a3), f"reruns bit-identical, {what}")
    return errs, dy, da


def k3_parity(hk, s, v, x, w, what, deferred=True):
    """K3' against its plain version on the same inputs (``w`` is left
    as it is): out and the row-block partials within 1e-12 of scale, b2
    within 1e-13 relative, the deferred step's a within 1e-15 of scale; a
    rerun bit-identical and every ticket counter back at zero.  Returns
    (the largest error of out and the partials, the plain partials)."""
    c, n = v.shape[2], v.shape[0]
    dev = v.device

    def vec():
        return torch.empty(c, dtype=torch.float64, device=dev)

    got, want, again = w.clone(), w.clone(), w.clone()
    b, b0, b1 = vec(), vec(), vec()
    a, a0, a1 = (vec(), vec(), vec()) if deferred else (None,) * 3
    part = hk.update_norm(s, v, x, got, b, a)
    part0 = hk.update_norm_ref(s, v, x, want, b0, a0)
    part1 = hk.update_norm(s, v, x, again, b1, a1)
    torch.cuda.synchronize()
    if dev.type == "cuda":
        counter = hk._update_setup(
            n, c, dev, torch.cuda.current_stream(dev).cuda_stream, None)[-1]
        check(int(counter.abs().sum()) == 0,
              f"{what}: K3' counters left zero")
    check(torch.equal(got, again) and torch.equal(part, part1)
          and torch.equal(b, b1) and (a is None or torch.equal(a, a1)),
          f"{what}: K3' reruns bit-identical")
    worst = 0.0
    for g, ref in ((got, want), (part, part0)):
        e, sc = rel_err(g, ref)
        check(e <= 1e-12 * sc, f"{what}: K3' {e} > 1e-12 * {sc}")
        worst = max(worst, e)
    e = float(((b - b0).abs() / b0).max())
    check(e <= 1e-13, f"{what}: K3' b2 {e} > 1e-13 relative")
    if deferred:
        e, sc = rel_err(a, a0)
        check(e <= 1e-15 * sc, f"{what}: K3' a {e} > 1e-15 * {sc}")
    return worst, part0


def k3_scalars(c, dev):
    """The deferred step's scalars (r, b2, b2_prev) the kernel checks and
    timings use: |gamma| < 1, so repeated launches on one buffer stay
    bounded."""
    def line(lo, hi):
        return torch.linspace(lo, hi, c, dtype=torch.float64, device=dev)
    return line(-1.0, 1.0), line(0.5, 1.0), line(1.0, 1.5)


def k3_bytes(v, part):
    """K3''s bytes at least: v, psi's and w's first kk rows read, w's
    written, the three scalars, the row-block partials and b2 and a."""
    return 4 * nbytes(v) + nbytes(part) + 5 * 8 * v.shape[2]


def k4_check(bk, op, psi, what, records, name="block_step"):
    """K4 (through the operator: one launch, two with HoH) against its
    plain version: y, the Gram partials and their sum within 1e-12 of
    scale, with HoH the first launch alone too; a rerun bit-identical.
    Returns the largest error, also kept in ``records[name]``."""
    y, g = op(psi, gram=True)
    y0, g0 = op(psi, gram=True, plain=True)
    y1, g1 = op(psi, gram=True)
    pairs = [(y, y0), (g, g0), (g.sum(0), g0.sum(0))]
    if op.hoh:
        pairs.append((bk.block_step(op.hs, op.iz, op.cols, psi, pad=True,
                                    zone=op.zone())[0],
                      bk.block_step_ref(op.hs, op.iz, op.cols, psi,
                                        pad=True)[0]))
    torch.cuda.synchronize()
    err = 0.0
    for got, want in pairs:
        e, scale = rel_err(got, want)
        check(e <= 1e-12 * scale, f"block_step {what}: {e} > 1e-12 * {scale}")
        err = max(err, e)
    check(torch.equal(y, y1) and torch.equal(g, g1),
          f"block_step reruns bit-identical, {what}")
    rec = records[name]
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return err


def k4_work(op, psi, nblocks, ntiles):
    """(flop, bytes) of one H application with its Gram partials over
    ``ntiles`` row tiles: each input read once, each output written once,
    the SpMV over the occupied blocks."""
    kk, d, c = psi.shape[0] - 1, psi.shape[1], psi.shape[2]
    mac = 8 * d * c  # flop per (row, d x d block) pair
    flops = mac * d * (nblocks + 2 * kk)  # SpMV, onsite, Gram
    ins = [op.hs, op.iz, op.cols, psi, op.onsite, op.izo]
    if op.hoh:
        flops += mac * d * nblocks + 2 * kk * d * c  # eeo SpMV, the add
        ins.append(op.hso_neg)
    out = 16 * (kk * d * c + ntiles * c * d)  # y, Gram partials
    return flops, nbytes(*ins) + out


def scalars(scf, sys_):
    pot = sys_.atoms[0].potential
    return dict(etot=pot.etot, fermi=scf.fermi, ql=pot.ql.copy(),
                mom=np.array(pot.mom))


def rec_scalars(scf, sys_):
    """:func:`scalars` of every rec atom's species, stacked."""
    pots = [sys_.atoms[i].potential for i in scf.iz_rec]
    return dict(etot=np.array([p.etot for p in pots]), fermi=scf.fermi,
                ql=np.array([p.ql for p in pots]),
                mom=np.array([p.mom for p in pots]))


def scf_once(scf_cls, sys_, wrappers, g_timer, nstep=NSTEP, read=scalars):
    """An ``nstep``-iteration SCF of ``sys_`` in a scratch directory: its
    scalars after the last iteration and, under ``first``, after the
    first (one ``run(nstep=1)`` per iteration, which gives the same bits as
    one ``run(nstep)``); under ``snap`` a copy of the SCF taken after the
    first iteration; its wall (without the copy), kernel launches and
    timer-section seconds."""
    before = section_totals(g_timer)
    with tempfile.TemporaryDirectory() as work:
        scf = scf_cls(sys_, workdir=work)
        for fn in wrappers.values():
            fn.launches = 0
        wall, niter, first, snap = 0.0, 0, None, None
        for _ in range(nstep):
            if first is not None and snap is None:
                snap = copy.deepcopy(scf)
            t0 = time.perf_counter()
            state = scf.run(nstep=1)
            wall += time.perf_counter() - t0
            niter += state.niter
            first = first or read(scf, sys_)
        launches = {n: fn.launches for n, fn in wrappers.items()}
    out = read(scf, sys_)
    check(niter == nstep and np.isfinite(out["etot"]).all()
          and np.isfinite(out["ql"]).all(), "SCF finished")
    spent = {k: v - before.get(k, 0.0)
             for k, v in section_totals(g_timer).items()}
    return dict(out, delta=state.delta, wall=wall, launches=launches,
                spent=spent, first=first, snap=snap)


@contextlib.contextmanager
def solver_calls(native):
    """The keyword arguments of every atomic-sphere solver call made inside
    the block, in order."""
    calls, solve = [], native.atomsc_native

    def recording(**kw):
        calls.append(copy.deepcopy(kw))
        return solve(**kw)

    native.atomsc_native = recording
    try:
        yield calls
    finally:
        native.atomsc_native = solve


def solver_tail(native, kw, etot):
    """The atomic-sphere solver alone on the inputs ``kw`` of a call that
    gave ``etot``: (its iteration limit, the spread of etot over its last
    three iterations) if it stopped at that limit unconverged, else
    (limit, 0.0)."""
    limit = inspect.signature(native.atomsc_native).parameters[
        "niter"].default
    check(native.atomsc_native(**kw).etot == etot,
          "the solver call repeats its etot")
    last = [native.atomsc_native(**dict(kw, niter=n)).etot
            for n in (limit - 2, limit - 1)]
    if last[1] == etot:  # it converged before the limit
        return limit, 0.0
    return limit, float(np.ptp([*last, etot]))


def second_iteration(snap, device, plain, wrappers, read=scalars):
    """The second iteration of the SCF copied in ``snap`` after its first,
    run on another engine (``device``, ``plain``): its scalars and kernel
    launches."""
    scf = copy.deepcopy(snap)
    scf.sys.device, scf.sys.plain = torch.device(device), plain
    with tempfile.TemporaryDirectory() as work:
        scf.workdir = work
        for fn in wrappers.values():
            fn.launches = 0
        scf.run(nstep=1)
        launches = {n: fn.launches for n, fn in wrappers.items()}
    return dict(read(scf, scf.sys), launches=launches)


def scf_diffs(got, ref):
    """|got - ref| of the SCF scalars (the largest entry of ql and mom, and
    of etot over rec atoms)."""
    return dict(etot=float(np.abs(got["etot"] - ref["etot"]).max()),
                fermi=abs(got["fermi"] - ref["fermi"]),
                ql=float(np.abs(got["ql"] - ref["ql"]).max()),
                mom=float(np.abs(got["mom"] - ref["mom"]).max()))


def solver_explains(native, got_calls, ref_calls, got_etot):
    """Whether an etot difference between two SCF iterations is the
    atomic-sphere solver's own: each rec atom's solver inputs (ql, pl) of
    the two runs agree within the ql bar, and the solver run again on
    got's inputs repeats got's etot.  Returns (bool, the inputs' largest
    difference)."""
    gap = max(float(np.abs(np.asarray(g[k]) - np.asarray(r[k])).max())
              for g, r in zip(got_calls, ref_calls) for k in ("ql", "pl"))
    again = [native.atomsc_native(**kw).etot for kw in got_calls]
    return (len(got_calls) == len(ref_calls) and gap <= SCF_BARS["ql"]
            and np.array_equal(again, got_etot)), gap


def embedded_phase(dev, records, every, sizes=EMBEDDED,
                   small_rc=EMBEDDED_SMALL, lld=EMB_LLD):
    """Phase 8: K4 on the slab and the impurity at ``sizes`` against its
    plain version, timed, and their block, HoH and Chebyshev SCFs, K4
    against plain on ``dev`` and at ``small_rc`` ``dev`` against the CPU.
    Fills ``records`` for K4's forms."""
    from rslmtoasa_tpu_torch import native
    from rslmtoasa_tpu_torch.models.presets import (
        build_synthetic_impurity,
        build_synthetic_surface,
    )
    from rslmtoasa_tpu_torch.models.scf import SelfConsistency
    from rslmtoasa_tpu_torch.ops import block_kernels as bk
    from rslmtoasa_tpu_torch.ops.block_lanczos import BlockOperator
    from rslmtoasa_tpu_torch.utils.timer import g_timer

    def readings(diffs):
        return ", ".join(f"|d{q}|={v:.3e}" for q, v in diffs.items())

    build = {"surface": build_synthetic_surface,
             "impurity": build_synthetic_impurity}
    t0 = time.perf_counter()
    full = {k: build[k](device="cpu", nsp=2, hoh=True, lld=lld, **kw)
            for k, kw in sizes.items()}
    small = {k: build[k](rc=small_rc, device="cpu", nsp=2, hoh=True,
                         lld=lld) for k in sizes}
    for sys_ in small.values():
        sys_.cfg.energy.channels_ldos = EMBEDDED_SMALL_NE
    for k, sys_ in full.items():
        cl = sys_.cluster
        say(8, f"{k}: kk={cl.kk}, {cl.ntype} types, nrec={cl.nrec}, "
               f"nmax={cl.nmax}, {sys_.ham.cols.shape[1]} slots; small "
               f"kk={small[k].cluster.kk}")
    check(sizes is not EMBEDDED or (
        full["surface"].cluster.kk == 27798
        and full["surface"].cluster.nrec == 3
        and full["impurity"].cluster.kk == 27316
        and full["impurity"].cluster.nmax == 60
        and full["impurity"].cluster.nrec == 3), "phase 8 shapes")
    say(8, f"built in {time.perf_counter() - t0:.1f} s")
    bulk_ms = records["block_step"]["ms"]
    for k, sys_ in full.items():
        name = f"block_step[{k}]"
        blocks, blocks_o, iz_rows, iz_sp, nmax = sys_._spmv_tables()
        hb, kk = sys_.ham, sys_.cluster.kk
        r = sys_.cluster.nrec
        nblocks = int((hb.cols < kk).sum())
        ops = {"d=18": BlockOperator(blocks, iz_rows, hb.cols, hb.lsham,
                                     iz_onsite=iz_sp, nmax=nmax),
               "d=18 HoH": BlockOperator(blocks, iz_rows, hb.cols, hb.lsham,
                                         iz_onsite=iz_sp, hoh=True,
                                         hso=blocks_o, enim=hb.enim,
                                         nmax=nmax),
               "d=9": BlockOperator(blocks[..., :9, :9], iz_rows, hb.cols,
                                    hb.lsham[..., :9, :9], iz_onsite=iz_sp,
                                    nmax=nmax)}
        for what, op in ops.items():
            op = op.to(dev)
            d = op.hs.shape[-1]
            zone = op.zone()
            nslots = op.cols.shape[1]
            route = (f"local zone nl={zone.nl} from global memory, "
                     f"{zone.types.numel()} type(s) past it in "
                     f"{bk.chunks(d, zone.types.numel(), zone.otypes.numel(), nslots, True, True)}"
                     f" chunk(s)" if zone is not None else
                     f"{op.hs.shape[0]} types in "
                     f"{bk.chunks(d, op.hs.shape[0], op.onsite.shape[0], nslots, True, True)}"
                     f" chunk(s)")
            psi = random_chains(kk, r * d, 21, dev, d=d)
            err = k4_check(bk, op, psi, f"{k} {what}", records, name)
            t_k, t_p = in_turns(lambda: op(psi, gram=True, plain=True),
                                lambda: op(psi, gram=True))
            flops, moved = k4_work(op, psi, nblocks, bk.nrowblk(kk, d))
            ops_s, bytes_s = flops / FP64_TENSOR_FLOPS, moved / HBM_BYTES_S
            bound = 1e3 * max(ops_s, bytes_s)
            by = "operations" if ops_s >= bytes_s else "bytes"
            lib = ""
            if what == "d=18":
                csr = csr_operator(op.hs, op.iz, op.cols, op.onsite, op.izo)
                flat = psi.view(d * (kk + 1), r * d)
                y0, _ = op(psi, plain=True)
                e, scale = rel_err(
                    torch.sparse.mm(csr, flat).view(kk, d, r * d), y0)
                check(e <= 1e-12 * scale, f"library SpMV {k} d=18: {e}")
                lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, flat))
                lib = (f"; library torch.sparse.mm {lib_ms:.4f} ms; bulk "
                       f"box 30 (phase 6, R=1) {bulk_ms:.4f} ms, here "
                       f"{t_k / r:.4f} ms per start block")
                records[name].update(ms=t_k, plain_ms=t_p, bound_ms=bound,
                                     bound_by=by, library_ms=lib_ms)
                del csr, flat, y0
                if zone is not None:
                    # the zone's cost: the same rows, all of the host's
                    # type, with no zone (one type, one chunk)
                    host = BlockOperator(
                        hb.ee[:1], np.zeros(kk, np.int32), hb.cols,
                        hb.lsham[:1]).to(dev)
                    t_h = cuda_ms(lambda: host(psi, gram=True))
                    lib += (f"; the same rows all of the host's type, no "
                            f"zone: {t_h:.4f} ms, so the zone's "
                            f"{zone.nl // bk.rows_per_tile(d)} row tiles cost "
                            f"{t_k - t_h:.4f} ms")
                    del host
            say(8, f"{k} {what} R={r} ({route}): err {err:.3e}, reruns "
                   f"bit-identical; kernel {t_k:.4f} ms plain {t_p:.4f} ms "
                   f"bound {bound:.4f} ms ({by}, {100 * bound / t_k:.1f}% "
                   f"of it); {flops:.4e} flop {flops / t_k / 1e9:.2f} "
                   f"TFLOP/s, {moved:.4e} B" + lib)
            del psi, op
        del ops
        torch.cuda.empty_cache()

    def embedded_system(sys_, case, device, plain):
        sys_ = copy.deepcopy(sys_)
        sys_.device, sys_.plain = torch.device(device), plain
        sys_.cfg.control.recur = BLOCK_CASES[case]["recur"]
        sys_.cfg.hamiltonian.hoh = BLOCK_CASES[case]["hoh"]
        if sys_.cfg.control.recur == "chebyshev":
            sys_.cfg.energy.energy_min, sys_.cfg.energy.energy_max = WINDOW
        return sys_

    def hold(pair, when, diffs, bars, explained):
        """A pair's readings against ``bars``: an etot miss that the
        atomic-sphere solver explains (``solver_explains``) is unmet, any
        other miss fails the phase."""
        for q, v in diffs.items():
            if v <= bars[q]:
                continue
            what = f"{pair} {when}: |d{q}| {v:.3e} > {bars[q]:g}"
            if q == "etot" and explained[0]:
                unmet.append(f"{what}; the solver's inputs {explained[1]:.1e}"
                             f" apart, and the solver on them repeats etot")
            else:
                misses.append(what)

    misses, unmet = [], []
    for k in sizes:
        nrec = full[k].cluster.nrec
        for case, spec in BLOCK_CASES.items():
            per_it = (2 if spec["hoh"] else 1) * (
                lld + 1 if spec["recur"] == "chebyshev" else lld - 1)
            bars = NSTEP_BARS[case]
            res, engine = {}, {}
            for run, tmpl, device, plain in (("cuda", full, dev, False),
                                             ("cuda-plain", full, dev, True),
                                             ("cuda-small", small, dev, False),
                                             ("cpu-small", small, "cpu",
                                              False)):
                engine[run] = (device, plain)
                with solver_calls(native) as calls:
                    res[run] = r = scf_once(
                        SelfConsistency,
                        embedded_system(tmpl[k], case, device, plain), every,
                        g_timer, read=rec_scalars)
                r["calls"] = calls
                want = {n: 0 for n in every}
                if torch.device(device).type != "cpu" and not plain:
                    want["block_step"] = NSTEP * per_it
                    want["bpopt_fit"] = NSTEP * (spec["recur"] == "block")
                check(r["launches"] == want, f"{k} {case} {run} launches "
                      f"{r['launches']}, want {want}")
                rec = r["spent"][f"{REC}{spec['recur']}-recursion"]
                say(8, f"SCF {k} {case} {run}: {r['wall'] / NSTEP:.3f} s per "
                       f"iteration, recursion {100 * rec / r['wall']:.1f}%; "
                       "seconds per iteration: " + ", ".join(
                           f"{s_} {v / NSTEP:.3f}"
                           for s_, v in r["spent"].items() if v > 0.0005)
                       + f"; etot {r['etot'].tolist()} fermi "
                         f"{float(r['fermi'])!r}; K4 launches "
                         f"{r['launches']['block_step']}")
            if case == "block":
                records[f"block_step[{k}]"]["launches"] = res["cuda"][
                    "launches"]["block_step"]
            for got, ref in (("cuda", "cuda-plain"),
                             ("cuda-small", "cpu-small")):
                pair = f"{k} {case} {got} vs {ref}"
                gc, rc = res[got]["calls"], res[ref]["calls"]
                diffs = scf_diffs(res[got]["first"], res[ref]["first"])
                say(8, f"{pair} after 1 iteration: {readings(diffs)}")
                hold(pair, "after 1 iteration", diffs, SCF_BARS,
                     solver_explains(native, gc[:nrec], rc[:nrec],
                                     res[got]["first"]["etot"]))
                with solver_calls(native) as tc:
                    twin = second_iteration(res[ref]["snap"], *engine[got],
                                            every, read=rec_scalars)
                want = {n: 0 for n in every}
                if torch.device(engine[got][0]).type != "cpu" \
                        and not engine[got][1]:
                    want["block_step"] = per_it
                    want["bpopt_fit"] = int(spec["recur"] == "block")
                check(twin["launches"] == want,
                      f"{pair} iteration 2 launches {twin['launches']}")
                port = scf_diffs(twin, res[ref])
                say(8, f"{pair}, iteration 2 from {ref}'s state after 1: "
                       f"{readings(port)}")
                hold(pair, f"iteration 2 from {ref}'s state", port, bars,
                     solver_explains(native, tc, rc[nrec:], twin["etot"]))
                diffs = scf_diffs(res[got], res[ref])
                say(8, f"{pair} after {NSTEP}: {readings(diffs)}; {got} from "
                       f"its own state against from {ref}'s, one engine: "
                       f"{readings(scf_diffs(res[got], twin))}")
                unmet += [f"{pair} after {NSTEP}: |d{q}| {v:.3e} > "
                          f"{bars[q]:g}" for q, v in diffs.items()
                          if v > bars[q]]
    say(8, f"bars unmet: {len(unmet)}" + "".join(f"; {u}" for u in unmet)
        + f"; phase 8 took {time.perf_counter() - t0:.1f} s")
    check(not misses, "; ".join(misses))


def _last_place(token):
    """The unit of a printed number's last digit: 1e-5 for '1.70886'."""
    mant, _, exp = token.lower().partition("e")
    return 10.0 ** (int(exp or 0) - len(mant.partition(".")[2]))


def file_close(p1, p2):
    """Two written files: the same words, every number within 1e-6
    (relative above one) or one unit of its last printed digit.  Returns
    the largest difference; a miss fails the phase."""
    f = os.path.basename(p1)
    with open(p1) as f1, open(p2) as f2:
        t1, t2 = f1.read().split(), f2.read().split()
    check(len(t1) == len(t2), f"{f}: the same number of words")
    worst = 0.0
    for a, b in zip(t1, t2):
        if a == b:
            continue
        # a namelist separates the entries of an array with commas
        a, b = a.rstrip(","), b.rstrip(",")
        try:
            x, y = float(a), float(b)
        except ValueError:
            check(False, f"{f}: {a} vs {b}")
        bar = max(1e-6 * max(1.0, abs(x)), 1.000001 * _last_place(a))
        check(abs(x - y) <= bar, f"{f}: {a} vs {b}")
        worst = max(worst, abs(x - y))
    return worst


def files_close(d1, d2):
    """Two runs' output directories: the same files (and subdirectories),
    each as :func:`file_close` holds it.  Returns (files, the largest
    difference); a miss fails the phase."""
    names = sorted(os.listdir(d1))
    check(names == sorted(os.listdir(d2)), f"files {names} in both")
    nfiles, worst = 0, 0.0
    for f in names:
        p1, p2 = os.path.join(d1, f), os.path.join(d2, f)
        if os.path.isdir(p1):
            n, w = files_close(p1, p2)
            nfiles, worst = nfiles + n, max(worst, w)
            continue
        nfiles += 1
        worst = max(worst, file_close(p1, p2))
    return nfiles, worst


def green_bar(xc, em):
    """``xc.gij_full`` from ``xc.intersite_gf(em)`` and its bar: 1e-12 of
    its scale plus lld - 1 times its largest movement when the energies
    move by one unit in the last place of the Hamiltonian's scale (the
    chains' largest |a| + 2 |b|, or the Chebyshev window's bound on the
    spectrum), either way: each of the continued fraction's lld - 1
    inverses rounds like such a move.  A real-axis Green function has
    poles, near which two engines' inverses of the same chains land more
    than 1e-12 of scale apart."""
    if hasattr(xc, "mu"):
        lo, hi = em.energy_min, em.energy_max
        scale = (hi - lo) / 1.7 + abs(hi + lo) / 2
    else:
        scale = np.abs(xc.a_b).max() + 2 * np.abs(xc.b_b).max()
    xc.intersite_gf(em)
    want = xc.gij_full.clone()
    spread = torch.zeros_like(want.real)
    d = 2.0**-52 * (np.abs(em.ene).max() + scale)
    for sgn in (1.0, -1.0):
        xc.intersite_gf(dataclasses.replace(em, ene=em.ene + sgn * d))
        spread = torch.maximum(spread, (xc.gij_full - want).abs())
    lld = xc.cfg.control.lld
    return want, 1e-12 * want.abs().max() + (lld - 1) * spread


def exchange_phase(dev, records, every, templates):
    """Phase 9: K4 on the exchange run's R = 21 start blocks at box 30 (d =
    18) against its plain version, timed beside its bound and
    ``torch.sparse.mm``; the exchange runs (block, HoH, Chebyshev) through
    K4 against ``plain=True`` on ``dev`` at box 30, and at box 10 against
    the CPU with the trio, the two-index split, the auxiliary-GF Jij,
    Gauss-Legendre, damping and inertia.  ``templates`` are phase 7's bcc
    systems by box.  Fills ``records["block_step[exchange]"]``."""
    from rslmtoasa_tpu_torch.models.exchange import (
        ExchangeCalculation,
        pair_chains,
        trio_pairs,
    )
    from rslmtoasa_tpu_torch.models.presets import synthetic_exchange
    from rslmtoasa_tpu_torch.ops import block_kernels as bk
    from rslmtoasa_tpu_torch.ops.block_lanczos import BlockOperator
    from rslmtoasa_tpu_torch.physics.energy_mesh import EnergyMesh
    from rslmtoasa_tpu_torch.utils.timer import g_timer

    t0 = time.perf_counter()
    name = "block_step[exchange]"
    full = synthetic_exchange(copy.deepcopy(templates[30]))
    small = synthetic_exchange(copy.deepcopy(templates[10]), XC_SMALL_SHELLS)
    small.cfg.energy.channels_ldos = XC_SMALL_NE
    small.cfg.control.lld = XC_SMALL_LLD
    pairs = full.cfg.lattice.ijpair
    r = len(pair_chains(pairs - 1))
    kk = full.cluster.kk
    check(pairs.shape == (6, 2) and r == 21
          and small.cfg.lattice.ijpair.shape == (XC_SMALL_SHELLS + 1, 2),
          "phase 9 shapes")
    say(9, f"box 30: pairs {pairs.tolist()}, R={r} live start blocks "
           f"(the JAX package recurs {4 * len(pairs)}); box 10 pairs "
           f"{small.cfg.lattice.ijpair.tolist()}")

    # K4 at the exchange run's shape ----------------------------------
    hb = full.ham
    nblocks = int((hb.cols < kk).sum())
    op = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham).to(dev)
    psi = random_chains(kk, 18 * r, 31, dev, d=18)
    err = k4_check(bk, op, psi, f"exchange R={r}", records, name)
    t_k, t_p = in_turns(lambda: op(psi, gram=True, plain=True),
                        lambda: op(psi, gram=True), XC_ITERS)
    flops, moved = k4_work(op, psi, nblocks, bk.nrowblk(kk, 18))
    ops_s, bytes_s = flops / FP64_TENSOR_FLOPS, moved / HBM_BYTES_S
    bound = 1e3 * max(ops_s, bytes_s)
    by = "operations" if ops_s >= bytes_s else "bytes"
    csr = csr_operator(op.hs, op.iz, op.cols, op.onsite, op.izo)
    flat = psi.view(18 * (kk + 1), 18 * r)
    y0, _ = op(psi, plain=True)
    e, scale = rel_err(torch.sparse.mm(csr, flat).view(kk, 18, 18 * r), y0)
    check(e <= 1e-12 * scale, f"library SpMV exchange R={r}: {e}")
    lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, flat), XC_ITERS)
    records[name].update(ms=t_k, plain_ms=t_p, bound_ms=bound, bound_by=by,
                         library_ms=lib_ms)
    say(9, f"K4 d=18 R={r} (C={18 * r}): err {err:.3e}, reruns "
           f"bit-identical; kernel {t_k:.4f} ms plain {t_p:.4f} ms bound "
           f"{bound:.4f} ms ({by}, {100 * bound / t_k:.1f}% of it); "
           f"{flops:.4e} flop {flops / t_k / 1e9:.2f} TFLOP/s, {moved:.4e} B;"
           f" library torch.sparse.mm {lib_ms:.4f} ms; per start block "
           f"{t_k / r:.4f} ms (box 30 R=1, phase 6: "
           f"{records['block_step']['ms']:.4f})")
    del op, psi, csr, flat, y0
    torch.cuda.empty_cache()

    # the exchange runs -----------------------------------------------
    def configured(tmpl, case, device, plain):
        sys_ = copy.deepcopy(tmpl)
        sys_.device, sys_.plain = torch.device(device), plain
        sys_.cfg.control.recur = BLOCK_CASES[case]["recur"]
        sys_.cfg.hamiltonian.hoh = BLOCK_CASES[case]["hoh"]
        if sys_.cfg.control.recur == "chebyshev":
            sys_.cfg.energy.energy_min, sys_.cfg.energy.energy_max = WINDOW
        return sys_

    def exchange_run(sys_, work, pairs_=None):
        """``ExchangeCalculation.run()`` of ``sys_`` into ``work``, the
        kernels' counts zeroed just before it and read just after; its wall,
        timer-section seconds and the card's peak memory."""
        os.makedirs(work)
        pairs_ = sys_.cfg.lattice.ijpair if pairs_ is None else pairs_
        before = section_totals(g_timer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for fn in every.values():
            fn.launches = 0
        t1 = time.perf_counter()
        xc = ExchangeCalculation(sys_, pairs_, work)
        res = xc.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {n: fn.launches for n, fn in every.items()}
        spent = {k: v - before.get(k, 0.0)
                 for k, v in section_totals(g_timer).items()
                 if v - before.get(k, 0.0) > 0.0005}
        return dict(xc=xc, res=res, wall=wall, launches=launches,
                    spent=spent, peak=torch.cuda.max_memory_allocated(dev),
                    dir=work)

    def held(pair, got, ref, green_ref=None):
        """The chains within 1e-11 (their dead slots equal), Jij/Dij/Aij
        within 1e-8 mRy, every written file within 1e-6; with
        ``green_ref`` (a CPU run) also the Green functions of got's chains
        on the CPU within :func:`green_bar`."""
        gx, rx = got["xc"], ref["xc"]
        names = ("mu",) if hasattr(gx, "mu") else ("a_b", "b_b")
        dead = np.setdiff1d(np.arange(4 * len(gx.pairs)), gx.chains)
        diffs = {}
        for k in names:
            g_, w_ = getattr(gx, k), getattr(rx, k)
            diffs[k] = float(np.abs(g_ - w_).max())
            check(diffs[k] <= 1e-11 * max(1.0, float(np.abs(w_).max())),
                  f"{pair} {k}: {diffs[k]}")
            check(np.array_equal(g_[:, dead], w_[:, dead]),
                  f"{pair} {k} dead slots")
        gs = float(rx.gij_full.abs().max())
        diffs["gij/scale"] = float((gx.gij_full.cpu()
                                    - rx.gij_full.cpu()).abs().max()) / gs
        for q in ("jij", "dmi", "aij"):
            diffs[q] = max(float(np.abs(np.asarray(a[q]) - np.asarray(b[q]))
                                 .max()) for a, b in zip(got["res"],
                                                         ref["res"]))
            check(diffs[q] <= 1e-8, f"{pair} {q}: {diffs[q]}")
        if green_ref is not None:
            cx = copy.copy(green_ref)
            for k in names:
                setattr(cx, k, getattr(gx, k))
            want, bar = green_bar(cx, EnergyMesh.build(cx.cfg.energy))
            dg = (gx.gij_full.cpu() - want).abs()
            diffs["green step/scale"] = float(dg.max() / want.abs().max())
            diffs["green step/bar"] = float((dg / bar).max())
            check(diffs["green step/bar"] <= 1.0, f"{pair}: the Green "
                  f"functions of got's chains on the CPU: {diffs}")
        nf, worst = files_close(ref["dir"], got["dir"])
        diffs["files"] = worst
        say(9, f"{pair}: " + ", ".join(f"|d {k}|={v:.3e}"
                                       for k, v in diffs.items())
            + f" ({nf} files)")

    def reading(run, r_):
        return (f"{r_['wall']:.3f} s, K4 launches "
                f"{r_['launches']['block_step']}, fits "
                f"{r_['launches']['bpopt_fit']}, peak "
                f"{r_['peak'] / 2**30:.2f} GiB; " + ", ".join(
                    f"{k} {v:.3f}" for k, v in r_["spent"].items()))

    with tempfile.TemporaryDirectory() as tmp:
        for case, spec in BLOCK_CASES.items():
            res = {}
            for run, tmpl, device, plain in (
                    ("cuda", full, dev, False),
                    ("cuda-plain", full, dev, True),
                    ("cuda-box10", small, dev, False),
                    ("cpu-box10", small, "cpu", False)):
                res[run] = r_ = exchange_run(
                    configured(tmpl, case, device, plain),
                    os.path.join(tmp, f"{case}-{run}"))
                lld = tmpl.cfg.control.lld
                k4 = (2 if spec["hoh"] else 1) * (
                    lld + 1 if spec["recur"] == "chebyshev" else lld - 1)
                k4 = k4 if run in ("cuda", "cuda-box10") else 0
                # one launch of the fits a block table on the card
                fits = int(k4 > 0 and spec["recur"] == "block")
                check(r_["launches"] == dict({n: 0 for n in every},
                                             block_step=k4, bpopt_fit=fits),
                      f"{case} {run} launches {r_['launches']}")
                say(9, f"exchange {case} {run}: " + reading(run, r_))
            say(9, f"exchange {case} cuda Jij (mRy): " + ", ".join(
                f"({x['i'] + 1},{x['j'] + 1}) {x['jij']:.6f}"
                for x in res["cuda"]["res"]))
            if case == "block":
                records[name]["launches"] = res["cuda"]["launches"][
                    "block_step"]
            held(f"{case} cuda vs cuda-plain", res["cuda"], res["cuda-plain"])
            # every analysis at box 10, the card against the CPU
            out = {}
            for run in ("cuda-box10", "cpu-box10"):
                xc = res[run]["xc"]
                xc.calculate_exchange_twoindex()
                out[run] = dict(aux=xc.calculate_jij_auxgreen(),
                                damping=xc.calculate_gilbert_damping(),
                                inertia=xc.calculate_moment_of_inertia())
                if spec["recur"] == "block":
                    wd, xc.workdir = xc.workdir, os.path.join(xc.workdir, "gl")
                    os.makedirs(xc.workdir)
                    xc.run_gauss_legendre()
                    xc.workdir = wd
            for q in out["cpu-box10"]:
                d_ = float(np.abs(out["cuda-box10"][q]
                                  - out["cpu-box10"][q]).max())
                check(d_ <= 1e-8, f"{case} box 10 {q}: {d_}")
            held(f"{case} cuda-box10 vs cpu-box10 (with the analyses)",
                 res["cuda-box10"], res["cpu-box10"],
                 green_ref=res["cpu-box10"]["xc"])
            del res
            torch.cuda.empty_cache()
        # the trio route at box 10
        trios = small.cfg.lattice.ijktrio
        jijk = {}
        for run, device in (("cuda", dev), ("cpu", "cpu")):
            r_ = exchange_run(configured(small, "block", device, False),
                              os.path.join(tmp, f"trio-{run}"),
                              trio_pairs(trios))
            jijk[run] = r_["xc"].calculate_jijk(trios)
            jijk[run + "-dir"] = r_["dir"]
        d_ = float(np.abs(jijk["cuda"] - jijk["cpu"]).max())
        check(np.isfinite(jijk["cpu"]).all() and d_ <= 1e-8,
              f"Jijk box 10: {d_}")
        nf, worst = files_close(jijk["cpu-dir"], jijk["cuda-dir"])
        say(9, f"Jijk trio {trios[0, :3].astype(int).tolist()} box 10 cuda vs"
               f" cpu: |d|={d_:.3e} ({jijk['cpu'][0, :3].tolist()} meV/a.u. "
               f"xx..xz), files {worst:.3e}")
    say(9, f"phase 9 took {time.perf_counter() - t0:.1f} s")


def conductivity_phase(dev, records, every, templates):
    """Phase 10: K4 in its two Kubo forms (a velocity table; with HoH
    ``v psi - vo (hs psi)``) at box 30, d = 18, R = 1, against their plain
    versions, timed beside their bounds and ``torch.sparse.mm``; one
    contraction of the moments timed beside its bound; the conductivity
    runs (``per_type``, ``cond_ll`` 200, ``hoh`` off and on, the HoH runs'
    atoms given ``COND_OBAR``) through K4 against ``plain=True`` at box 30,
    and at box 10 (``cond_ll`` 40) the card against the CPU: mu within
    1e-11 of its scale, every written file within 1e-6.  ``templates`` are
    phase 7's bcc systems by box.  Fills ``records["block_step[kubo]"]``
    and ``records["block_step[kubo-hoh]"]``."""
    from rslmtoasa_tpu_torch.config import ControlCfg
    from rslmtoasa_tpu_torch.models.conductivity import (
        ConductivityCalculation,
        build_kubo_operator,
    )
    from rslmtoasa_tpu_torch.ops import kubo
    from rslmtoasa_tpu_torch.ops.block_lanczos import BlockOperator
    from rslmtoasa_tpu_torch.utils.timer import g_timer

    t0 = time.perf_counter()
    check(ControlCfg().cond_ll == COND_LL, "cond_ll 200 is the default")

    def configured(box, hoh, device, plain, nmom):
        sys_ = copy.deepcopy(templates[box])
        sys_.device, sys_.plain = torch.device(device), plain
        cfg = sys_.cfg
        cfg.calculation.post_processing = "conductivity"
        cfg.control.cond_ll, cfg.control.cond_calctype = nmom, "per_type"
        cfg.hamiltonian.hoh = hoh
        # the window in which the moments converge (at the mesh's own
        # (-1.0, 0.5) they pass 1e70 by n = 100)
        cfg.energy.energy_min, cfg.energy.energy_max = WINDOW
        if hoh:
            for at in sys_.atoms:
                at.potential.obar[:] = COND_OBAR
        sys_.build_hamiltonian()
        return sys_

    # K4 in the Kubo forms ---------------------------------------------
    hsys = configured(30, True, dev, False, COND_LL)
    hb, kk = hsys.ham, hsys.cluster.kk
    check(np.abs(hb.eeo).max() > 0, "the HoH tables carry the overlap")
    v, vo = build_kubo_operator(hsys, "charge", "z", np.array([0.0, 1.0,
                                                               0.0]))
    op = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham, hoh=True,
                       hso=hb.eeo, enim=hb.enim).to(dev)
    psi = random_chains(kk, 18, 41, dev, d=18)
    hpsi = op.hs_apply(psi)
    live = op.cols.long() < kk
    for name, vop in (("block_step[kubo]",
                       kubo.VelocityOperator(v, hb.iz, hb.cols)),
                      ("block_step[kubo-hoh]",
                       kubo.VelocityOperator(v, hb.iz, hb.cols, vo))):
        vop = vop.to(dev)
        hoh = vop.vo_neg is not None
        hx = hpsi if hoh else None

        def kernel(plain=False):
            return vop(psi, hpsi=hx, pad=True, plain=plain)

        y, y0, y1 = kernel(), kernel(True), kernel()
        torch.cuda.synchronize()
        err, scale = rel_err(y, y0)
        check(err <= 1e-12 * scale, f"{name}: {err} > 1e-12 * {scale}")
        check(torch.equal(y, y1), f"{name} reruns bit-identical")
        records[name]["max_abs_err"] = err
        t_k, t_p = in_turns(lambda: kernel(True), kernel)
        # the SpMVs over the (row, slot) blocks their tables hold, and the
        # add; each input read once, y written once
        tabs = [vop.v] + ([vop.vo_neg] if hoh else [])
        blocks = [int(((t.abs().amax(dim=(-2, -1)) > 0)[op.iz.long()]
                       & live).sum()) for t in tabs]
        flops = 8 * 18 * 18 * 18 * sum(blocks) + (2 * kk * 18 * 18 if hoh
                                                  else 0)
        moved = nbytes(*tabs, vop.iz, vop.cols, psi, y) + (
            nbytes(hpsi) if hoh else 0)
        ops_s, bytes_s = flops / FP64_TENSOR_FLOPS, moved / HBM_BYTES_S
        bound = 1e3 * max(ops_s, bytes_s)
        by = "operations" if ops_s >= bytes_s else "bytes"
        # the library call: v as CSR times psi, with HoH [v | -vo] times
        # psi stacked on hs psi
        if hoh:
            csr = csr_operator(torch.cat([vop.v, vop.vo_neg], 1), vop.iz,
                               torch.cat([vop.cols, vop.cols + kk + 1], 1),
                               width=2 * (kk + 1))
            flat = torch.cat([psi, hpsi]).view(36 * (kk + 1), 18)
        else:
            csr = csr_operator(vop.v, vop.iz, vop.cols)
            flat = psi.view(18 * (kk + 1), 18)
        e, scale = rel_err(torch.sparse.mm(csr, flat).view(kk, 18, 18),
                           y0[:kk])
        check(e <= 1e-12 * scale, f"library SpMV {name}: {e}")
        lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, flat))
        records[name].update(ms=t_k, plain_ms=t_p, bound_ms=bound,
                             bound_by=by, library_ms=lib_ms)
        form = "v psi - vo hs psi, two launches" if hoh else \
            "v psi, one launch"
        say(10, f"{name} d=18 R=1 ({form}; table blocks {blocks}): err "
                f"{err:.3e}, reruns "
                f"bit-identical; kernel {t_k:.4f} ms plain {t_p:.4f} ms "
                f"bound {bound:.4f} ms ({by}, {100 * bound / t_k:.1f}% of "
                f"it); {flops:.4e} flop, {moved:.4e} B; library "
                f"torch.sparse.mm {lib_ms:.4f} ms")
        del csr, flat, y, y0, y1
    h_ms = cuda_ms(lambda: op(psi))
    say(10, f"H with HoH (two K4 launches) {h_ms:.4f} ms; box 30 R=1 "
            f"without HoH, phase 6: {records['block_step']['ms']:.4f} ms")
    del op, psi, hpsi, hsys
    torch.cuda.empty_cache()

    # the contraction: one group of right vectors against the whole left
    # chain, as a run at box 30 makes it ceil(n / GROUP) times
    k = kk * 18
    left = torch.randn((1, COND_LL * 18, k), dtype=torch.complex128,
                       device=dev)
    right = torch.randn((1, k, kubo.GROUP * 18), dtype=torch.complex128,
                        device=dev)
    t_c = cuda_ms(lambda: torch.matmul(left, right), 3)
    flops = 8 * COND_LL * 18 * kubo.GROUP * 18 * k
    moved = nbytes(left, right) + 16 * COND_LL * 18 * kubo.GROUP * 18
    ops_s, bytes_s = flops / FP64_TENSOR_FLOPS, moved / HBM_BYTES_S
    bound = 1e3 * max(ops_s, bytes_s)
    nflush = -(-COND_LL // kubo.GROUP)
    say(10, f"contraction (1, {COND_LL * 18}, {k}) x (1, {k}, "
            f"{kubo.GROUP * 18}) complex128 torch.matmul: {t_c:.4f} ms, "
            f"{flops / t_c / 1e9:.2f} TFLOP/s; bound {bound:.4f} ms "
            f"({'operations' if ops_s >= bytes_s else 'bytes'}, "
            f"{100 * bound / t_c:.1f}% of it; {flops / moved:.1f} flop/B); "
            f"{nflush} per box-30 run, ~{nflush * t_c / 1e3:.3f} s")
    del left, right
    torch.cuda.empty_cache()

    # the conductivity runs ----------------------------------------------
    def cond_run(sys_, work):
        """``ConductivityCalculation.run()`` of ``sys_`` into ``work``, the
        kernels' counts zeroed just before it and read just after; its
        wall, timer-section seconds and the card's peak memory."""
        os.makedirs(work)
        before = section_totals(g_timer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for fn in every.values():
            fn.launches = 0
        t1 = time.perf_counter()
        mu = ConductivityCalculation(sys_, work).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {n: fn.launches for n, fn in every.items()}
        spent = {k_: v_ - before.get(k_, 0.0)
                 for k_, v_ in section_totals(g_timer).items()
                 if v_ - before.get(k_, 0.0) > 0.0005}
        return dict(mu=mu, wall=wall, launches=launches, spent=spent,
                    peak=torch.cuda.max_memory_allocated(dev), dir=work)

    with tempfile.TemporaryDirectory() as tmp:
        for hoh in (False, True):
            case = "hoh" if hoh else "non-hoh"
            res = {}
            for run, box, device, plain, nmom in (
                    ("cuda", 30, dev, False, COND_LL),
                    ("cuda-plain", 30, dev, True, COND_LL),
                    ("cuda-box10", 10, dev, False, COND_SMALL_LL),
                    ("cpu-box10", 10, "cpu", False, COND_SMALL_LL)):
                res[run] = r_ = cond_run(
                    configured(box, hoh, device, plain, nmom),
                    os.path.join(tmp, f"{case}-{run}"))
                k4 = kubo.launches(nmom, nmom, hoh) if run in (
                    "cuda", "cuda-box10") else 0
                check(r_["launches"] == dict({n: 0 for n in every},
                                             block_step=k4),
                      f"conductivity {case} {run} launches "
                      f"{r_['launches']}, want {k4} (one left block)")
                check(r_["mu"].shape == (18, 18, nmom, nmom, 1)
                      and np.isfinite(r_["mu"]).all(),
                      f"conductivity {case} {run} moments")
                say(10, f"conductivity {case} {run}: {r_['wall']:.3f} s, "
                        f"K4 launches {r_['launches']['block_step']}, peak "
                        f"{r_['peak'] / 2**30:.2f} GiB; " + ", ".join(
                            f"{k_} {v_:.3f}"
                            for k_, v_ in r_["spent"].items()))
            records[f"block_step[kubo{'-hoh' if hoh else ''}]"][
                "launches"] = res["cuda"]["launches"]["block_step"]
            for got, ref in (("cuda", "cuda-plain"),
                             ("cuda-box10", "cpu-box10")):
                g_, w_ = res[got]["mu"], res[ref]["mu"]
                scale = float(np.abs(w_).max())
                dmu = float(np.abs(g_ - w_).max())
                check(dmu <= 1e-11 * scale, f"conductivity {case} {got} vs "
                      f"{ref}: mu {dmu} > 1e-11 * {scale}")
                nf, worst = files_close(res[ref]["dir"], res[got]["dir"])
                say(10, f"conductivity {case} {got} vs {ref}: |d mu| "
                        f"{dmu:.3e} ({dmu / scale:.3e} of scale {scale:.4e})"
                        f", files {worst:.3e} ({nf} files)")
            del res
            torch.cuda.empty_cache()
    say(10, f"phase 10 took {time.perf_counter() - t0:.1f} s")


def last_branches_phase(dev, records, every, templates):
    """Phase 11: the last ``&calculation`` branches through
    ``cli.run_system`` at box 30 on ``dev``: a bravais block SCF writing
    ``rs2paoham.dat``, then ``paoflow2rs``, ``exchange_p2rs`` (phase 9's
    pairs) and ``conductivity_p2rs`` (``cond_ll`` 200) on it as
    ``paoham.dat``; ``orbital_modern`` on the CLI's 2 000 sites, with K4 in
    its orbital form against its plain version (one launch at the run's
    group of start blocks, timed beside its bound and ``torch.sparse.mm``,
    and the trace of 16 sites); ``sd`` at ``nsp=3`` (Depondt at 300 K, two
    steps), and the torques of one state, K4 against plain; at box 10
    each branch on the card against the CPU on its written files.
    ``templates`` are phase 7's bcc systems by box.  Fills
    ``records["block_step[orbital]"]``."""
    from rslmtoasa_tpu_torch import cli
    from rslmtoasa_tpu_torch.models import orbital
    from rslmtoasa_tpu_torch.models.presets import synthetic_exchange
    from rslmtoasa_tpu_torch.models.scf import (
        SelfConsistency,
        magnetic_torques,
    )
    from rslmtoasa_tpu_torch.ops import kubo
    from rslmtoasa_tpu_torch.ops.block_lanczos import BlockOperator
    from rslmtoasa_tpu_torch.utils.namelist import parse_namelists
    from rslmtoasa_tpu_torch.utils.timer import g_timer

    t0 = time.perf_counter()
    name = "block_step[orbital]"

    def configured(box, device, plain=False, nsp=2, window=None):
        """A copy of the box's template on ``device``, without HoH, at
        ``nsp`` (3: the start moment tilted, the &sd namelist), its energy
        window ``window`` (the Chebyshev-type runs) and at box 10 on
        XC_SMALL_NE energy points."""
        sys_ = copy.deepcopy(templates[box])
        sys_.device, sys_.plain = torch.device(device), plain
        cfg = sys_.cfg
        cfg.control.nsp, cfg.hamiltonian.hoh = nsp, False
        if window is not None:
            cfg.energy.energy_min, cfg.energy.energy_max = window
        if box == 10:
            cfg.energy.channels_ldos = XC_SMALL_NE
        if nsp == 3:
            cfg.namelists = parse_namelists(SD_NML)
            for at in sys_.atoms:
                at.potential.mom = TILT.copy()
        return sys_

    def branch(sys_, work, pre="bravais", proc="none", post="none",
               src=None, run=None):
        """``cli.run_system`` (or ``run(sys_, work)``) of ``sys_`` with
        these ``&calculation`` branches into ``work``, ``paoham.dat`` read
        from ``src``; the kernels' counts zeroed just before it and read
        just after; its return, wall, timer-section seconds and the card's
        peak memory."""
        os.makedirs(work)
        calc = sys_.cfg.calculation
        calc.pre_processing, calc.processing = pre, proc
        calc.post_processing = post
        sys_.cfg.control.fname = os.path.join(src or work, "input.nml")
        before = section_totals(g_timer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for fn in every.values():
            fn.launches = 0
        t1 = time.perf_counter()
        obj = (run or cli.run_system)(sys_, work)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {n: fn.launches for n, fn in every.items()}
        spent = {k: v - before.get(k, 0.0)
                 for k, v in section_totals(g_timer).items()
                 if v - before.get(k, 0.0) > 0.0005}
        return dict(obj=obj, wall=wall, launches=launches, spent=spent,
                    peak=torch.cuda.max_memory_allocated(dev), dir=work)

    def launched(r_, k4, what, fits=0):
        """K4's ``k4`` launches and the terminator fits' ``fits`` (one a
        block recursion's SCF iteration or Jij table), no other kernel's."""
        check(r_["launches"] == dict({n: 0 for n in every}, block_step=k4,
                                     bpopt_fit=fits),
              f"{what}: launches {r_['launches']}, want K4 {k4}, fits "
              f"{fits}")
        say(11, f"{what}: {r_['wall']:.3f} s, K4 launches {k4}, fits "
                f"{fits}, peak "
                f"{r_['peak'] / 2**30:.2f} GiB; " + ", ".join(
                    f"{k} {v:.3f}" for k, v in r_["spent"].items()))

    def finite_numbers(path):
        with open(path) as fh:
            words = fh.read().split()
        vals = np.array([float(w) for w in words])
        check(vals.size > 0 and np.isfinite(vals).all(),
              f"{os.path.basename(path)}: finite numbers")
        return vals

    # K4 in the orbital form at the run's group of start blocks ---------
    sys30 = configured(30, dev, window=WINDOW)
    sys30.build_hamiltonian()
    hb, cl = sys30.ham, sys30.cluster
    kk, lld = cl.kk, sys30.cfg.control.lld
    op = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham).to(dev)
    nsites = min(kk, ORB_SITES)  # the CLI's
    group = orbital.plan(kk, nsites, dev)
    c = 18 * group
    # random columns made on the card (a host copy would take ~7 GB)
    psi = torch.randn((kk + 1, 18, c), dtype=torch.complex128, device=dev,
                      generator=torch.Generator(dev).manual_seed(51))
    psi[kk] = 0.0
    (y, g), (y0, _), (y1, _) = op(psi), op(psi, plain=True), op(psi)
    torch.cuda.synchronize()
    err, scale = rel_err(y, y0)
    check(g is None and err <= 1e-12 * scale,
          f"{name} R={group}: {err} > 1e-12 * {scale}")
    check(torch.equal(y, y1), f"{name} reruns bit-identical")
    t_k, t_p = in_turns(lambda: op(psi, plain=True), lambda: op(psi),
                        XC_ITERS)
    # the SpMV over the occupied blocks and the onsite term; each input
    # read once (x is p), y written once
    nblocks = int((op.cols < kk).sum())
    flops = 8 * 18 * 18 * c * (nblocks + kk)
    moved = nbytes(op.hs, op.iz, op.cols, psi, op.onsite, op.izo) \
        + 16 * kk * 18 * c
    ops_s, bytes_s = flops / FP64_TENSOR_FLOPS, moved / HBM_BYTES_S
    bound = 1e3 * max(ops_s, bytes_s)
    by = "operations" if ops_s >= bytes_s else "bytes"
    csr = csr_operator(op.hs, op.iz, op.cols, op.onsite, op.izo)
    flat = psi.view(18 * (kk + 1), c)
    e, scale = rel_err(torch.sparse.mm(csr, flat).view(kk, 18, c), y0)
    check(e <= 1e-12 * scale, f"library SpMV orbital R={group}: {e}")
    lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, flat), XC_ITERS)
    records[name].update(max_abs_err=err, ms=t_k, plain_ms=t_p,
                         bound_ms=bound, bound_by=by, library_ms=lib_ms)
    say(11, f"{name} d=18 R={group} (C={c}; lsham, no Gram): err "
            f"{err:.3e}, reruns bit-identical; kernel {t_k:.4f} ms plain "
            f"{t_p:.4f} ms bound {bound:.4f} ms ({by}, "
            f"{100 * bound / t_k:.1f}% of it); {flops:.4e} flop "
            f"{flops / t_k / 1e9:.2f} TFLOP/s, {moved:.4e} B; library "
            f"torch.sparse.mm {lib_ms:.4f} ms; per start block "
            f"{t_k / group:.4f} ms")
    del psi, y, y0, y1, csr, flat
    torch.cuda.empty_cache()
    # the trace of the first ORB_HELD sites, K4 against plain
    sites = np.linspace(0, kk - 1, nsites).astype(int)[:ORB_HELD]
    xs, ys = (torch.as_tensor(np.append(cl.cr[:, k] * cl.alat, 0.0),
                              device=dev) for k in (0, 1))
    mus = [orbital.orbital_moments(op, xs, ys, sites, lld, *CHEB_AB,
                                   ORB_HELD, plain=p)
           for p in (False, False, True)]
    err, scale = rel_err(mus[0], mus[2])
    check(err <= 1e-11 * scale, f"orbital trace of {ORB_HELD} sites: {err}"
          f" > 1e-11 * {scale}")
    check(torch.equal(mus[0], mus[1]), "orbital trace reruns bit-identical")
    say(11, f"orbital trace of {ORB_HELD} sites (lld {lld}), K4 vs plain: "
            f"|d mu| {err:.3e} ({err / scale:.3e} of scale {scale:.4e}), "
            f"reruns bit-identical")
    del op, mus, sys30
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # orbital_modern at box 30 through K4 alone ----------------------
        r_ = branch(configured(30, dev, window=WINDOW),
                    os.path.join(tmp, "orbital"), post="orbital_modern")
        om = r_["obj"]
        launched(r_, orbital.launches(lld, nsites, om.group),
                 f"orbital_modern box 30, {nsites} sites in groups of "
                 f"{om.group}")
        records[name]["launches"] = r_["launches"]["block_step"]
        finite_numbers(os.path.join(r_["dir"], "fort.50"))

        # bravais SCF, then the three p2rs branches on its export ---------
        r_ = branch(configured(30, dev), os.path.join(tmp, "bravais"))
        launched(r_, lld - 1, "bravais block SCF box 30 (rs2paoham.dat)",
                 1)
        src = os.path.join(tmp, "p2rs")
        os.makedirs(src)
        shutil.copy(os.path.join(r_["dir"], "rs2paoham.dat"),
                    os.path.join(src, "paoham.dat"))
        nlines = len(finite_numbers(os.path.join(src, "paoham.dat"))) // 7
        say(11, f"rs2paoham.dat: {nlines} elements")
        xsys = synthetic_exchange(configured(30, dev))
        csys = configured(30, dev, window=WINDOW)
        csys.cfg.control.cond_ll, csys.cfg.control.cond_calctype = \
            COND_LL, "per_type"
        for post, sys_, k4, fits, out in (
                ("paoflow2rs", configured(30, dev), lld - 1, 1, "X_out.nml"),
                ("exchange_p2rs", xsys, lld - 1, 1, "jij.out"),
                ("conductivity_p2rs", csys,
                 kubo.launches(COND_LL, COND_LL, False), 0,
                 "cond_total.out")):
            r_ = branch(sys_, os.path.join(tmp, post), post=post, src=src)
            launched(r_, k4, f"{post} box 30", fits)
            if out.endswith(".out"):
                finite_numbers(os.path.join(r_["dir"], out))
            check(os.path.exists(os.path.join(r_["dir"], out)),
                  f"{post} wrote {out}")
        del xsys, csys

        # sd at nsp=3 and the torques of one state ----------------------
        r_ = branch(configured(30, dev, nsp=3), os.path.join(tmp, "sd"),
                    proc="sd")
        launched(r_, 3 * (lld - 1), "sd box 30 nsp=3, 2 steps (3 SCFs)", 3)
        traj = os.path.join(r_["dir"], "output.lammpstrj")
        with open(traj) as fh:
            check(fh.read().count("ITEM: TIMESTEP") == 2, "two frames")
        scf = SelfConsistency(configured(30, dev, nsp=3),
                              os.path.join(tmp, "sd"))
        scf.run(nstep=1)
        twin = copy.deepcopy(scf)
        twin.sys.plain = True
        for s_ in (scf, twin):
            s_.run(nstep=1)
        pots = [s_.sys.atoms[0].potential for s_ in (scf, twin)]
        dm = max(float(np.abs(getattr(pots[0], k)
                              - getattr(pots[1], k)).max())
                 for k in ("mom0", "mom1", "mom"))
        tq, tq0 = (magnetic_torques(s_.sys.atoms, s_.iz_rec)
                   for s_ in (scf, twin))
        dt_, scale = float(np.abs(tq - tq0).max()), float(np.abs(tq0).max())
        check(dm <= 1e-10, f"sd step 1 moments K4 vs plain: {dm}")
        check(dt_ <= TORQUE_BAR * scale, f"sd step 1 torques K4 vs plain: "
              f"{dt_} > {TORQUE_BAR} * {scale}")
        say(11, f"sd step 1 from one state, K4 vs plain: moments |d| "
                f"{dm:.3e}, torques |d| {dt_:.3e} T ({dt_ / scale:.3e} of "
                f"{scale:.4e} T)")
        del scf, twin

        # box 10: each branch on the card against the CPU -----------------
        small = {}
        for device in (dev, "cpu"):
            tag = "cpu" if device == "cpu" else "cuda"
            base = os.path.join(tmp, f"box10-{tag}")
            out = small[tag] = {}
            out["bravais"] = branch(configured(10, device),
                                    os.path.join(base, "bravais"))
            src10 = os.path.join(base, "p2rs")
            os.makedirs(src10)
            shutil.copy(os.path.join(base, "bravais", "rs2paoham.dat"),
                        os.path.join(src10, "paoham.dat"))
            out["paoflow2rs"] = branch(
                configured(10, device), os.path.join(base, "paoflow2rs"),
                post="paoflow2rs", src=src10)
            xsys = synthetic_exchange(configured(10, device),
                                      XC_SMALL_SHELLS)
            xsys.cfg.control.lld = XC_SMALL_LLD
            out["exchange_p2rs"] = branch(
                xsys, os.path.join(base, "exchange_p2rs"),
                post="exchange_p2rs", src=src10)
            csys = configured(10, device, window=WINDOW)
            csys.cfg.control.cond_ll, csys.cfg.control.cond_calctype = \
                COND_SMALL_LL, "per_type"
            out["conductivity_p2rs"] = branch(
                csys, os.path.join(base, "conductivity_p2rs"),
                post="conductivity_p2rs", src=src10)
            osys = configured(10, device, window=WINDOW)
            osys.cfg.control.lld = XC_SMALL_LLD
            out["orbital"] = branch(
                osys, os.path.join(base, "orbital"), post="orbital_modern",
                run=lambda s_, w: orbital.OrbitalMoment(s_, w).run(
                    n_sites=ORB_SMALL_SITES))
            out["sd"] = branch(configured(10, device, nsp=3),
                               os.path.join(base, "sd"), proc="sd")
            if tag == "cuda":
                for what, k4, fits in (
                        ("bravais", lld - 1, 1), ("paoflow2rs", lld - 1, 1),
                        ("exchange_p2rs", XC_SMALL_LLD - 1, 1),
                        ("conductivity_p2rs",
                         kubo.launches(COND_SMALL_LL, COND_SMALL_LL, False),
                         0),
                        ("orbital", orbital.launches(
                            XC_SMALL_LLD, ORB_SMALL_SITES, ORB_SMALL_SITES),
                         0),
                        ("sd", 3 * (lld - 1), 3)):
                    launched(out[what], k4, f"{what} box 10 cuda", fits)
            else:
                for what, r_ in out.items():
                    launched(r_, 0, f"{what} box 10 cpu")
        for what in small["cpu"]:
            d_cpu = small["cpu"][what]["dir"]
            d_cuda = small["cuda"][what]["dir"]
            if what == "sd":
                # the trajectory: the SCFs' files carry the atomic-sphere
                # solver's noise (ROADMAP queue 3)
                nf, worst = 1, file_close(
                    os.path.join(d_cpu, "output.lammpstrj"),
                    os.path.join(d_cuda, "output.lammpstrj"))
            else:
                nf, worst = files_close(d_cpu, d_cuda)
            say(11, f"{what} box 10 cuda vs cpu: files {worst:.3e} "
                    f"({nf} files)")
    say(11, f"phase 11 took {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def python_solver_calls(scf_mod):
    """The keyword arguments of every call of the Python atomic-sphere
    solver that ``scf_mod``'s SCF makes inside the block, in order."""
    calls, solve = [], scf_mod.atomsc

    def recording(**kw):
        calls.append(copy.deepcopy(kw))
        return solve(**kw)

    scf_mod.atomsc = recording
    try:
        yield calls
    finally:
        scf_mod.atomsc = solve


def with_hyperfine(scf, sys_):
    """:func:`scalars` and the hyperfine fields [core, valence] (T)."""
    return dict(scalars(scf, sys_),
                hyper=sys_.atoms[0].potential.hyper_field.copy())


def large_cluster_phase(dev, records, every, box=LARGE_BOX,
                        small_box=XC_SMALL_BOX, lld=PRESET["lld"]):
    """Phase 12: the box-``box`` bcc preset (``nsp=2`` with spin-orbit
    coupling, kk = 216 000 at box 60) on the active-set wavefront.  The
    plans' stages and work shares; for the scalar recursion (one spin
    channel, K1' and K3'), the block (K4, d = 18), HoH (a two-hop plan) and
    Chebyshev (window (-1.5, 1.0)) ones from atom 0: the wavefront through
    the kernels against its plain version and the full-width kernel route
    (1e-11), the walls of both routes, the launches against the plan's
    count, the tables packed once, the kernels per stage against their
    plain versions (1e-12 of scale), timed beside their bounds over the
    stage's occupied blocks and ``torch.sparse.mm``, and the peak device
    memory; a 2-iteration block SCF through ``SelfConsistency`` on the
    wavefront, its first iteration held against the full width's at the
    strict bars; at box ``small_box`` one block SCF iteration at
    ``txc=8`` with ``hyperfine`` (the Python atomic-sphere solver), the
    card against the CPU.  Fills the ``WAVEFRONT_FORMS`` records."""
    from rslmtoasa_tpu_torch.models import scf as scf_mod
    from rslmtoasa_tpu_torch.models.presets import build_synthetic_bcc
    from rslmtoasa_tpu_torch.ops import block_kernels as bk
    from rslmtoasa_tpu_torch.ops import haydock_kernels as hk
    from rslmtoasa_tpu_torch.ops import wavefront as wf
    from rslmtoasa_tpu_torch.ops.block_lanczos import (
        BlockOperator,
        block_lanczos,
        block_start_vectors,
    )
    from rslmtoasa_tpu_torch.ops.chebyshev import chebyshev_moments
    from rslmtoasa_tpu_torch.ops.lanczos import (
        HaydockOperator,
        lanczos_coefficients,
        scalar_start_vectors,
    )
    from rslmtoasa_tpu_torch.utils.timer import g_timer

    t0 = time.perf_counter()
    big = build_synthetic_bcc(device=dev, nsp=2, hoh=True,
                              **dict(PRESET, box=box, lld=lld))
    hb, kk = big.ham, big.cluster.kk
    say(12, f"box {box}: kk={kk}, {int((hb.cols < kk).sum())} occupied "
            f"blocks, built in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    plans = {"scalar": wf.make_plan(hb.cols, kk, [0], lld),
             "block": wf.make_plan(hb.cols, kk, [0], lld),
             "block-hoh": wf.make_plan(hb.cols, kk, [0], lld,
                                       hops_per_step=2),
             "chebyshev": wf.make_plan_chebyshev(hb.cols, kk, [0], lld)}
    say(12, f"four plans in {time.perf_counter() - t1:.2f} s")
    for name, p in plans.items():
        say(12, f"plan {name}: stages {p.stages}, work / dense_work "
                f"{p.work / p.dense_work:.4f}")
        check(p.work < 0.7 * p.dense_work, f"plan {name} engages")
    hs9 = hb.ee[:, :, :9, :9]
    kw_hoh = dict(hoh=True, hso=hb.eeo, enim=hb.enim)
    tabs = (hb.ee, hb.lsham, hb.iz, hb.cols)
    psi_s = scalar_start_vectors(kk, [0], dev)
    psi_b = block_start_vectors(kk, [0], dev)
    ops = {"block": BlockOperator(hb.ee, hb.iz, hb.cols,
                                  hb.lsham).to(dev),
           "block-hoh": BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham,
                                      **kw_hoh).to(dev)}
    ops["chebyshev"] = ops["block"]
    hop = HaydockOperator(hs9, hb.iz, hb.cols).to(dev)

    def host(out):
        return tuple(t.cpu().numpy() if torch.is_tensor(t) else t
                     for t in out)

    # each case: (its wavefront(plain), its full width through the
    # kernels, the launches of each kernel per step)
    cases = {
        "scalar": (lambda plain: wf.lanczos_coefficients_wavefront(
                       hs9, hb.iz, hb.cols, psi_s, lld, plans["scalar"],
                       plain=plain, roll=False),
                   lambda: host(lanczos_coefficients(
                       hop.hs, hop.iz, hop.cols, psi_s, lld, roll=False)),
                   {"spmv_dot": 1, "update_norm": 1}),
        "block": (lambda plain: wf.block_lanczos_wavefront(
                      *tabs, psi_b, lld, plans["block"], plain=plain),
                  lambda: host(block_lanczos(ops["block"], psi_b, lld)),
                  {"block_step": 1}),
        "block-hoh": (lambda plain: wf.block_lanczos_wavefront(
                          *tabs, psi_b, lld, plans["block-hoh"],
                          plain=plain, **kw_hoh),
                      lambda: host(block_lanczos(ops["block-hoh"], psi_b,
                                                 lld)),
                      {"block_step": 2}),
        "chebyshev": (lambda plain: (wf.chebyshev_moments_wavefront(
                          *tabs, psi_b, lld, *CHEB_AB, plans["chebyshev"],
                          plain=plain),),
                      lambda: (chebyshev_moments(
                          ops["chebyshev"], psi_b, lld,
                          *CHEB_AB).cpu().numpy(),),
                      {"block_step": 1})}
    forms = {"scalar": ("spmv_dot[wavefront]", "update_norm[wavefront]"),
             "block": ("block_step[wavefront]",),
             "block-hoh": ("block_step[wavefront-hoh]",),
             "chebyshev": ("block_step[wavefront-chebyshev]",)}

    def timed(fn):
        """fn()'s result, its CUDA-synchronised wall and the card's peak
        memory."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, torch.cuda.max_memory_allocated(
            dev)

    gen = torch.Generator(device=dev)

    def chains(n, d, c, seed):
        """(n+1, d, c) random complex columns with a zero row n, made on
        the card."""
        gen.manual_seed(seed)
        x = torch.randn((n + 1, d, c, 2), dtype=torch.float64, device=dev,
                        generator=gen)
        x[n] = 0.0
        return torch.view_as_complex(x)

    for case, (run, dense, counts) in cases.items():
        p = plans[case]
        steps = sum(s for _, s in p.stages)
        hk._TABLES.clear()
        packs0 = hk.packed_table.builds
        for fn in every.values():
            fn.launches = 0
        got = run(False)
        launches = {n: fn.launches for n, fn in every.items()}
        packs = hk.packed_table.builds - packs0
        want = {n: counts.get(n, 0) * steps for n in every}
        check(launches == want, f"{case} wavefront launches {launches}, "
              f"want {want}")
        plain = run(True)
        full, t_full, mem_full = timed(dense)
        again, t_wf, mem_wf = timed(lambda: run(False))
        err_p = max(float(np.abs(g - w).max()) for g, w in zip(got, plain))
        err_d = max(float(np.abs(g - w).max()) for g, w in zip(got, full))
        check(all(np.array_equal(g, w) for g, w in zip(got, again)),
              f"{case} wavefront reruns bit-identical")
        check(err_p <= 1e-11 and err_d <= 1e-11,
              f"{case} wavefront vs plain {err_p}, vs full width {err_d}")
        say(12, f"{case}: wavefront vs its plain version |d|={err_p:.3e}, "
                f"vs the full-width kernel route |d|={err_d:.3e}; wall "
                f"wavefront {t_wf:.4f} s, full width {t_full:.4f} s "
                f"({t_full / t_wf:.2f}x); peak {mem_wf / 2**30:.2f} / "
                f"{mem_full / 2**30:.2f} GiB; launches {launches} "
                f"(plan: {steps} steps); tables packed {packs}")
        # hs (and -eeo with HoH) and the onsite table; the CPU's plain
        # versions pack nothing
        check(dev.type != "cuda" or packs == (
            1 + counts.get("block_step", 0) if case != "scalar" else 1),
              f"{case}: each table packed once, {packs}")
        # the kernels at each stage's prefix: against their plain versions,
        # timed beside their bounds and the library call
        totals = {f: dict(ms=0.0, plain=0.0, ops=0.0, bytes=0.0, lib=0.0,
                          err=0.0) for f in forms[case]}
        rows = []
        if case == "scalar":
            iz_w, cols_w, _ = p.permute_tables(hb.iz, hb.cols)
            opw = HaydockOperator(hs9, iz_w, cols_w).to(dev)
        else:
            opw = wf._block_operator(
                hb.ee, hb.lsham, hb.iz, hb.cols, p, case == "block-hoh",
                hb.eeo if case == "block-hoh" else None,
                hb.enim if case == "block-hoh" else None, None, 0, dev)
        for n, s in p.stages:
            if case == "scalar":
                iz_n, cols_n = hk.prefix_tables(opw.iz, opw.cols, n)
                x = chains(n, 9, 9, n)
                v = chains(n, 9, 9, n + 1)[:n].contiguous()
                w3 = chains(n, 9, 9, n + 2)
                y, ap = hk.spmv_dot(opw.hs, iz_n, cols_n, x)
                y0, ap0 = hk.spmv_dot_ref(opw.hs, iz_n, cols_n, x)
                s9 = k3_scalars(9, dev)
                e3, part0 = k3_parity(hk, s9, v, x, w3,
                                      f"wavefront stage {n}")
                extra = {"update_norm[wavefront]": e3}
                pairs = {"spmv_dot[wavefront]": ((y, y0), (ap, ap0)),
                         "update_norm[wavefront]": ()}
                buf, b2o, ao = (w3.clone(), part0[0].clone(),
                                part0[0].clone())
                t = {"spmv_dot[wavefront]": in_turns(
                         lambda: hk.spmv_dot_ref(opw.hs, iz_n, cols_n, x),
                         lambda: hk.spmv_dot(opw.hs, iz_n, cols_n, x), 5),
                     "update_norm[wavefront]": in_turns(
                         lambda: hk.update_norm_ref(s9, v, x, buf, b2o, ao),
                         lambda: hk.update_norm(s9, v, x, buf, b2o, ao), 5)}
                nb = int((cols_n < n).sum())
                work = {"spmv_dot[wavefront]": (
                            8 * 81 * nb * 9,
                            nbytes(opw.hs, iz_n, cols_n, x, y0, ap0)),
                        "update_norm[wavefront]": (
                            14 * n * 9 * 9, k3_bytes(v, part0))}
                csr = csr_operator(opw.hs, iz_n, cols_n, width=n + 1)
                flat = x.view(9 * (n + 1), 9)
                e, sc = rel_err(torch.sparse.mm(csr, flat).view(n, 9, 9), y0)
                check(e <= 1e-12 * sc, f"library SpMV, stage {n}: {e}")
                lib = {"spmv_dot[wavefront]": cuda_ms(
                           lambda: torch.sparse.mm(csr, flat), 5),
                       "update_norm[wavefront]": None}
                del csr, flat
            else:
                f = forms[case][0]
                extra = {}
                op_n = opw.prefix(n)
                x = chains(n, 18, 18, n)
                gram = case != "chebyshev"
                y, g = op_n(x, gram=gram)
                y0, g0 = op_n(x, gram=gram, plain=True)
                pairs = {f: ((y, y0),) + (((g, g0),) if gram else ())}
                t = {f: in_turns(lambda: op_n(x, gram=gram, plain=True),
                                 lambda: op_n(x, gram=gram), 5)}
                nb = int((op_n.cols < n).sum())
                flops, moved = k4_work(op_n, x, nb, bk.nrowblk(n, 18))
                if not gram:  # no Gram term, no partials written
                    flops -= 8 * 18 * 18 * 18 * n
                    moved -= 16 * bk.nrowblk(n, 18) * 18 * 18
                work = {f: (flops, moved)}
                lib = {f: None}
                if case != "block-hoh":
                    csr = csr_operator(op_n.hs, op_n.iz, op_n.cols,
                                       op_n.onsite, op_n.izo, width=n + 1)
                    flat = x.view(18 * (n + 1), 18)
                    e, sc = rel_err(torch.sparse.mm(csr, flat).view(
                        n, 18, 18), y0)
                    check(e <= 1e-12 * sc, f"library SpMV, stage {n}: {e}")
                    lib[f] = cuda_ms(lambda: torch.sparse.mm(csr, flat), 5)
                    del csr, flat
            torch.cuda.synchronize()
            for f, prs in pairs.items():
                for gw, ww in prs:
                    e, sc = rel_err(gw, ww)
                    check(e <= 1e-12 * sc, f"{f} stage {n}: {e} > 1e-12 * "
                          f"{sc}")
                    totals[f]["err"] = max(totals[f]["err"], e)
                totals[f]["err"] = max(totals[f]["err"], extra.get(f, 0.0))
                tk, tp = t[f]
                fl, by = work[f]
                tot = totals[f]
                tot["ms"] += s * tk
                tot["plain"] += s * tp
                tot["ops"] += s * fl / FP64_TENSOR_FLOPS
                tot["bytes"] += s * by / HBM_BYTES_S
                tot["lib"] = (None if lib[f] is None or tot["lib"] is None
                              else tot["lib"] + s * lib[f])
                rows.append(f"{f} n={n} x{s}: {tk:.4f} ms (plain {tp:.4f}"
                            + (f", library {lib[f]:.4f}" if lib[f] else "")
                            + f", bound {1e3 * max(fl / FP64_TENSOR_FLOPS, by / HBM_BYTES_S):.4f})")
            del x, y0
        say(12, f"{case} per stage: " + "; ".join(rows))
        for f, tot in totals.items():
            by = "operations" if tot["ops"] >= tot["bytes"] else "bytes"
            bound = 1e3 * max(tot["ops"], tot["bytes"])
            base = f.split("[")[0]
            records[f].update(
                launches=launches[base], max_abs_err=tot["err"],
                ms=tot["ms"] / steps, plain_ms=tot["plain"] / steps,
                bound_ms=bound / steps, bound_by=by,
                library_ms=None if tot["lib"] is None else tot["lib"] / steps)
            say(12, f"{f}: the recursion's {steps} steps {tot['ms']:.4f} ms "
                    f"of kernel (plain {tot['plain']:.4f}, bound "
                    f"{bound:.4f} ms, {by}, {100 * bound / tot['ms']:.1f}% "
                    f"of it" + ("" if tot["lib"] is None else
                               f"; library {tot['lib']:.4f} ms")
                    + f"); {smi_line()}")
        del got, plain, full, again, opw
        torch.cuda.empty_cache()
    del ops, hop, psi_s, psi_b

    # the block SCF at box 60 on the wavefront, and its first iteration at
    # the full width
    def configured(device, template=big, **control):
        sys_ = copy.deepcopy(template)
        sys_.device = torch.device(device)
        sys_.cfg.control.recur, sys_.cfg.hamiltonian.hoh = "block", False
        for k, v in control.items():
            setattr(sys_.cfg.control, k, v)
        return sys_

    r = scf_once(scf_mod.SelfConsistency, configured(dev), every,
                 g_timer)
    want = dict({n: 0 for n in every}, block_step=NSTEP * (lld - 1),
                bpopt_fit=NSTEP)
    check(r["launches"] == want, f"box {box} SCF launches {r['launches']}")
    for f in ("block_step[wavefront]",):
        records[f]["launches"] = r["launches"]["block_step"]
    rec = r["spent"][REC + "block-recursion"]
    say(12, f"SCF block box {box} on the wavefront: {r['wall'] / NSTEP:.3f}"
            f" s per iteration, recursion {100 * rec / r['wall']:.1f}%; "
            + ", ".join(f"{k} {v:.3f}" for k, v in r["spent"].items()
                        if v > 0.0005)
            + f"; etot {float(r['etot'])!r} fermi {float(r['fermi'])!r}; "
              f"K4 launches {r['launches']['block_step']}")
    saved = os.environ.get("RSLMTO_WAVEFRONT_KK")
    os.environ["RSLMTO_WAVEFRONT_KK"] = str(10 * kk)
    try:
        d = scf_once(scf_mod.SelfConsistency, configured(dev), every,
                     g_timer, nstep=1)
    finally:
        if saved is None:
            os.environ.pop("RSLMTO_WAVEFRONT_KK")
        else:
            os.environ["RSLMTO_WAVEFRONT_KK"] = saved
    diffs = scf_diffs(r["first"], d["first"])
    say(12, f"SCF box {box}, first iteration, wavefront vs full width "
            f"({d['wall']:.3f} s, recursion "
            f"{d['spent'][REC + 'block-recursion']:.3f} s): "
            + ", ".join(f"|d{q}|={v:.3e}" for q, v in diffs.items()))
    check(all(v <= SCF_BARS[q] for q, v in diffs.items()),
          f"box {box} SCF wavefront vs full width: {diffs}")
    del r, d

    # the Python atomic-sphere solver: txc=8 with hyperfine, card vs CPU
    small = build_synthetic_bcc(device="cpu", nsp=2,
                                **dict(PRESET, box=small_box, lld=lld))
    out = {}
    for run, device in (("cuda", dev), ("cpu", "cpu")):
        with python_solver_calls(scf_mod) as calls:
            out[run] = r = scf_once(
                scf_mod.SelfConsistency,
                configured(device, small, txc=XC_TXC, hyperfine=True),
                every, g_timer, nstep=1, read=with_hyperfine)
        r["solver"] = calls
        check(len(calls) == 1 and calls[0]["txc"] == XC_TXC
              and calls[0]["hyperfine"], f"{run}: the Python solver ran")
        say(12, f"SCF box {small_box} txc={XC_TXC} hyperfine on {run}: "
                f"{r['wall']:.3f} s (atomic-scf "
                f"{r['spent'].get('atomic-scf', 0.0):.3f} s); etot "
                f"{float(r['etot'])!r}, hyperfine field {r['hyper']} T")
    got, ref = out["cuda"], out["cpu"]
    diffs = dict(scf_diffs(got, ref),
                 hyper=float(np.abs(got["hyper"] - ref["hyper"]).max()))
    say(12, f"txc={XC_TXC} hyperfine, card vs CPU after 1 iteration: "
            + ", ".join(f"|d{q}|={v:.3e}" for q, v in diffs.items()))
    misses = [q for q, v in diffs.items()
              if q in SCF_BARS and v > SCF_BARS[q]]
    if misses == ["etot"]:
        # the atomic-sphere solver's own (ROADMAP queue 3): its inputs of
        # the two runs within the ql bar, and the solver on got's inputs
        # repeating got's etot
        kw, kw0 = got["solver"][0], ref["solver"][0]
        gap = max(float(np.abs(np.asarray(kw[k]) - np.asarray(kw0[k])).max())
                  for k in ("ql", "pl"))
        again = scf_mod.atomsc(**kw).etot
        check(gap <= SCF_BARS["ql"] and again == got["etot"],
              f"txc={XC_TXC}: etot miss not the solver's ({gap}, {again})")
        say(12, f"txc={XC_TXC}: the etot miss is the solver's own (inputs "
                f"{gap:.3e} apart; unmet)")
    else:
        check(not misses, f"txc={XC_TXC} hyperfine card vs CPU: {diffs}")
    check(diffs["hyper"] <= 1e-6, f"hyperfine fields: {diffs['hyper']}")
    del small
    torch.cuda.empty_cache()
    say(12, f"phase 12 in {time.perf_counter() - t0:.1f} s")
    return big


def box_input(sys_, where, box, nstep=NSTEP):
    """``input.nml`` of a block SCF of the bcc preset ``sys_`` built at
    ``box`` (the full box x box x box cell grid, ``&lattice pbc``) with
    ``nstep`` iterations, and its element file, into ``where``."""
    from rslmtoasa_tpu_torch.models.scf import SelfConsistency
    from rslmtoasa_tpu_torch.utils.namelist import write_namelist

    cfg = sys_.cfg
    lat, en, ctl = cfg.lattice, cfg.energy, cfg.control
    text = "".join([
        write_namelist("calculation", {
            "pre_processing": cfg.calculation.pre_processing}),
        write_namelist("control", {
            "calctype": ctl.calctype, "nsp": ctl.nsp, "lld": ctl.lld,
            "recur": "block"}),
        write_namelist("lattice", {
            "rc": lat.rc, "ndim": lat.ndim, "alat": lat.alat,
            "wav": lat.wav, "crystal_sym": lat.crystal_sym,
            "ntype": lat.ntype, "r2": lat.r2, "ct": [lat.ct[0]],
            "pbc": True, "n1": box, "n2": box, "n3": box}),
        write_namelist("atoms", {"database": "", "label": cfg.atoms.labels}),
        write_namelist("self", {"nstep": nstep}),
        write_namelist("energy", {
            "channels_ldos": en.channels_ldos, "energy_min": en.energy_min,
            "energy_max": en.energy_max, "fermi": en.fermi}),
        write_namelist("mix", {"beta": cfg.mix.beta,
                               "mixtype": cfg.mix.mixtype}),
    ])
    path = os.path.join(where, "input.nml")
    with open(path, "w") as fh:
        fh.write(text)
    SelfConsistency(sys_, workdir=where).save_checkpoints()
    for at in sys_.atoms:
        os.replace(os.path.join(where, f"{at.element.symbol}_out.nml"),
                   os.path.join(where, f"{at.label}.nml"))
    return path


def per_rank_text(ranks, what=("wall", "peak")):
    """'rank 0 1.234 s 2.34 GiB, rank 1 ...' of ``stages.per_rank``."""
    return ", ".join(
        f"rank {r} {v[0]:.3f} s {v[1] / 2**30:.2f} GiB"
        + ("" if len(v) < 4 else f" ({int(v[2])} rows + {int(v[3])} halo)")
        for r, v in enumerate(ranks))


def multi_rank_phase(dev, records, big, ranks_device="cuda",
                     small_box=PRESET["box"], lld=PRESET["lld"]):
    """Phase 13: the port's multi-rank path on the one card (the module
    docstring's item 13).  ``big`` is phase 12's box-60 system; the
    exchange and CLI runs build the preset at ``small_box``."""
    from types import SimpleNamespace

    from rslmtoasa_tpu_torch import cli, dryrun
    from rslmtoasa_tpu_torch.convert import system_to_numpy
    from rslmtoasa_tpu_torch.models.presets import (
        build_synthetic_bcc,
        synthetic_exchange,
    )
    from rslmtoasa_tpu_torch.ops import block_kernels as bk
    from rslmtoasa_tpu_torch.ops import haydock_kernels as hk
    from rslmtoasa_tpu_torch.ops import rowslab
    from rslmtoasa_tpu_torch.ops.block_lanczos import (
        BlockOperator,
        block_lanczos,
        block_start_vectors,
    )
    from rslmtoasa_tpu_torch.ops.chebyshev import chebyshev_moments
    from rslmtoasa_tpu_torch.ops.lanczos import (
        HaydockOperator,
        scalar_start_vectors,
    )
    from rslmtoasa_tpu_torch.parallel import launch, stages

    t0 = time.perf_counter()
    hb, kk = big.ham, big.cluster.kk
    hs9 = np.ascontiguousarray(hb.ee[:, :, :9, :9])
    hs9_t = torch.as_tensor(hs9, device=dev)
    gen = torch.Generator(device=dev)

    def chains(n, d, c, seed):
        gen.manual_seed(seed)
        x = torch.randn((n + 1, d, c, 2), dtype=torch.float64, device=dev,
                        generator=gen)
        x[n] = 0.0
        return torch.view_as_complex(x)

    # the kernels on the two slabs' tables ------------------------------
    forms = {f: dict(err=0.0) for f in SLAB_FORMS}
    for rank in range(RANKS):
        slab = rowslab.Slab(SimpleNamespace(rank=rank, world=RANKS),
                            hb.cols, dev)
        n, nx = slab.n_own, slab.nx
        iz_l = slab.rows(hb.iz)
        nb = int((slab.cols < nx).sum())
        x = chains(nx, 9, 9, 100 + rank)
        v = chains(n, 9, 9, 110 + rank)[:n].contiguous()
        w3 = chains(nx, 9, 9, 120 + rank)
        s9 = k3_scalars(9, dev)
        y, ap = hk.spmv_dot(hs9_t, iz_l, slab.cols, x)
        y0, ap0 = hk.spmv_dot_ref(hs9_t, iz_l, slab.cols, x)
        e3, part0 = k3_parity(hk, s9, v, x, w3, f"slab {rank}")
        ops = {"block_step[slab]": rowslab.slab_operator(
                   slab, hb.ee, hb.lsham, hb.iz),
               "block_step[slab-hoh]": rowslab.slab_operator(
                   slab, hb.ee, hb.lsham, hb.iz, hoh=True, hso=hb.eeo,
                   enim=hb.enim),
               "d=9": rowslab.slab_operator(
                   slab, hb.ee[..., :9, :9], hb.lsham[..., :9, :9], hb.iz)}
        xb = {18: chains(nx, 18, 18, 130 + rank),
              9: chains(nx, 9, 9, 140 + rank)}
        hx = slab.extend(ops["block_step[slab-hoh]"].hs_apply(xb[18])[:n])
        hx[n:nx] = chains(nx - n, 18, 18, 150 + rank)[:nx - n]
        k4 = {}
        for f, op in ops.items():
            xf = xb[op.hs.shape[-1]]
            hp = hx if op.hoh else None
            k4[f] = (op(xf, gram=True, hpsi=hp),
                     op(xf, gram=True, plain=True, hpsi=hp))
        first = (ops["block_step[slab-hoh]"].hs_apply(xb[18]),
                 ops["block_step[slab-hoh]"].hs_apply(xb[18], plain=True))
        torch.cuda.synchronize()
        forms["update_norm[slab]"]["err"] = max(
            forms["update_norm[slab]"]["err"], e3)
        pairs = {"spmv_dot[slab]": ((y, y0), (ap, ap0)),
                 "block_step[slab]": tuple(zip(*k4["block_step[slab]"])),
                 "block_step[slab-hoh]": tuple(zip(
                     *k4["block_step[slab-hoh]"])) + (first,),
                 "d=9": tuple(zip(*k4["d=9"]))}
        for f, prs in pairs.items():
            for g, w in prs:
                e, sc = rel_err(g, w)
                check(e <= 1e-12 * sc, f"{f} rank {rank}: {e} > 1e-12 * "
                      f"{sc}")
                if f in forms:
                    forms[f]["err"] = max(forms[f]["err"], e)
        if rank:
            continue
        # timed on slab 0, one launch (two with HoH) per call
        op18, oph = ops["block_step[slab]"], ops["block_step[slab-hoh]"]
        buf, b2o, ao = w3.clone(), part0[0].clone(), part0[0].clone()
        times = {
            "spmv_dot[slab]": in_turns(
                lambda: hk.spmv_dot_ref(hs9_t, iz_l, slab.cols, x),
                lambda: hk.spmv_dot(hs9_t, iz_l, slab.cols, x), 5),
            "update_norm[slab]": in_turns(
                lambda: hk.update_norm_ref(s9, v, x, buf, b2o, ao),
                lambda: hk.update_norm(s9, v, x, buf, b2o, ao), 5),
            "block_step[slab]": in_turns(
                lambda: op18(xb[18], gram=True, plain=True),
                lambda: op18(xb[18], gram=True), 5),
            "block_step[slab-hoh]": in_turns(
                lambda: (oph.hs_apply(xb[18], plain=True),
                         oph(xb[18], gram=True, plain=True, hpsi=hx)),
                lambda: (oph.hs_apply(xb[18]),
                         oph(xb[18], gram=True, hpsi=hx)), 5)}
        flops, moved = k4_work(op18, xb[18], nb, bk.nrowblk(n, 18))
        # both HoH launches: k4_work counts the eeo SpMV and the add
        fh, mh = k4_work(oph, xb[18], nb, bk.nrowblk(n, 18))
        work = {"spmv_dot[slab]": (8 * 81 * nb * 9,
                                   nbytes(hs9_t, iz_l, slab.cols, x, y0,
                                          ap0)),
                "update_norm[slab]": (14 * n * 9 * 9, k3_bytes(v, part0)),
                "block_step[slab]": (flops, moved),
                "block_step[slab-hoh]": (fh, mh)}
        csr = csr_operator(hs9_t, iz_l, slab.cols, width=nx + 1)
        flat = x.view(9 * (nx + 1), 9)
        e, sc = rel_err(torch.sparse.mm(csr, flat).view(n, 9, 9), y0)
        check(e <= 1e-12 * sc, f"library SpMV on the slab: {e}")
        lib = {"spmv_dot[slab]": cuda_ms(lambda: torch.sparse.mm(csr, flat),
                                         5),
               "update_norm[slab]": None, "block_step[slab-hoh]": None}
        csr = csr_operator(op18.hs, op18.iz, op18.cols, op18.onsite,
                           op18.izo, width=nx + 1)
        flat = xb[18].view(18 * (nx + 1), 18)
        e, sc = rel_err(torch.sparse.mm(csr, flat).view(n, 18, 18),
                        k4["block_step[slab]"][1][0])
        check(e <= 1e-12 * sc, f"library SpMV d=18 on the slab: {e}")
        lib["block_step[slab]"] = cuda_ms(
            lambda: torch.sparse.mm(csr, flat), 5)
        del csr, flat
        for f, (tk, tp) in times.items():
            fl, by = work[f]
            ops_s, bytes_s = fl / FP64_TENSOR_FLOPS, by / HBM_BYTES_S
            forms[f].update(ms=tk, plain_ms=tp, library_ms=lib[f],
                            bound_ms=1e3 * max(ops_s, bytes_s),
                            bound_by="operations" if ops_s >= bytes_s
                            else "bytes")
        say(13, f"slab 0 of {RANKS}: {n} own rows + {nx - n} halo rows, "
                f"{nb} occupied blocks; " + "; ".join(
                    f"{f} {forms[f]['ms']:.4f} ms (plain "
                    f"{forms[f]['plain_ms']:.4f}, bound "
                    f"{forms[f]['bound_ms']:.4f} ms {forms[f]['bound_by']}, "
                    f"{100 * forms[f]['bound_ms'] / forms[f]['ms']:.1f}% of "
                    f"it" + ("" if lib[f] is None else
                             f", library {lib[f]:.4f} ms") + ")"
                    for f in SLAB_FORMS) + f"; {smi_line()}")
        del ops, xb, hx, k4, x, v, w3, buf, part0, y, y0
    say(13, "slab kernels vs plain on both slabs: " + ", ".join(
        f"{f} {forms[f]['err']:.3e}" for f in SLAB_FORMS))
    torch.cuda.empty_cache()

    # two ranks sharing the card: the box-60 recursions on row slabs ----
    t1 = time.perf_counter()
    res = launch.run(
        "rslmtoasa_tpu_torch.parallel.stages:slab_cases", RANKS,
        device=ranks_device, share_cards=True, timeout=900.0, cases={
            "block": dict(kinds=("block", "cheb", "scalar")),
            "hoh": dict(hoh=True, hso=hb.eeo, enim=hb.enim,
                        kinds=("block",))},
        hs=hb.ee, lsham=hb.lsham, iz=hb.iz, cols=hb.cols, starts=[0],
        lld=lld, window=WINDOW, single=False)
    t_launch = time.perf_counter() - t1
    ops = {"block": BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham).to(dev),
           "hoh": BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham, hoh=True,
                                hso=hb.eeo, enim=hb.enim).to(dev)}
    psi_b = block_start_vectors(kk, [0], dev)
    full = {("block", "block"): block_lanczos(ops["block"], psi_b, lld),
            ("block", "cheb"): (chebyshev_moments(ops["block"], psi_b, lld,
                                                  *CHEB_AB),),
            ("block", "scalar"): HaydockOperator(
                hs9, hb.iz, hb.cols).to(dev).coefficients(
                    scalar_start_vectors(kk, [0], dev), lld, roll=False),
            ("hoh", "block"): block_lanczos(ops["hoh"], psi_b, lld)}
    want_launches = {("block", "block"): {"block_step": lld - 1},
                     ("block", "cheb"): {"block_step": lld + 1},
                     ("block", "scalar"): {"spmv_dot": lld - 1,
                                           "update_norm": lld - 1},
                     ("hoh", "block"): {"block_step": 2 * (lld - 1)}}
    for (case, kind), want in full.items():
        got = res[case][kind]
        got = got if isinstance(got, tuple) else (got,)
        err = max(float(np.abs(g - w.cpu().numpy()).max())
                  for g, w in zip(got, want))
        launches = {k: v for k, v in res[case]["launches"][kind].items()
                    if v}
        check(err <= 1e-11, f"{case} {kind} on row slabs vs full width: "
              f"{err}")
        # K1''s partials gathered in the global order and K3''s folded as
        # one rank's K3' folds them: the single rank's bits
        check(kind != "scalar" or err == 0.0,
              f"the scalar recursion on row slabs vs full width: {err}, "
              f"not bit for bit")
        check(launches == want_launches[(case, kind)],
              f"{case} {kind} launches {launches}")
        per = 2 if case == "hoh" else 1
        steps = lld + 1 if kind == "cheb" else lld - 1
        check(res[case]["exchanges"][kind] == per * steps,
              f"{case} {kind}: {res[case]['exchanges'][kind]} exchanges")
        say(13, f"box 60 {case} {kind} on {RANKS} ranks' row slabs vs the "
                f"single rank's full width |d|={err:.3e}; launches per rank "
                f"{launches}, halo exchanges {res[case]['exchanges'][kind]};"
                f" " + per_rank_text(res[case]["ranks"][kind]))
    records["spmv_dot[slab]"]["launches"] = \
        res["block"]["launches"]["scalar"]["spmv_dot"]
    records["update_norm[slab]"]["launches"] = \
        res["block"]["launches"]["scalar"]["update_norm"]
    records["block_step[slab]"]["launches"] = \
        res["block"]["launches"]["block"]["block_step"]
    records["block_step[slab-hoh]"]["launches"] = \
        res["hoh"]["launches"]["block"]["block_step"]
    for f, rec in forms.items():
        records[f].update(max_abs_err=rec["err"],
                          **{k: v for k, v in rec.items() if k != "err"})
    say(13, f"the slab launch in {t_launch:.1f} s (spawn, rendezvous, the "
            f"tables to both ranks, the four recursions)")
    del ops, full, res
    torch.cuda.empty_cache()

    # two ranks: the box-30 exchange run, chain-sharded -----------------
    small = build_synthetic_bcc(device=dev, nsp=2, **dict(
        PRESET, box=small_box, lld=lld))
    xsys = synthetic_exchange(copy.deepcopy(small))
    pairs = xsys.cfg.lattice.ijpair
    arrays, pots = system_to_numpy(xsys)
    one = stages.exchange_run(arrays, pots, xsys.cfg, pairs, device=dev)
    # each rank on as many host threads as this process, as one rank runs
    two = launch.run("rslmtoasa_tpu_torch.parallel.stages:exchange_run",
                     RANKS, device=ranks_device, share_cards=True,
                     threads=torch.get_num_threads(), timeout=900.0,
                     arrays=arrays, potentials=pots, cfg=xsys.cfg,
                     pairs=pairs)
    err = float(np.abs(two["jij"] - one["jij"]).max())
    chains = max(float(np.abs(g - w).max())
                 for g, w in zip(two["chains"], one["chains"]))
    say(13, f"exchange chains on {RANKS} ranks vs one |d|={chains:.3e}")
    check(err <= 1e-10, f"exchange on {RANKS} ranks vs one: {err}")
    say(13, f"box {small_box} exchange, pairs {pairs.tolist()}, chain-"
            f"sharded over {RANKS} ranks vs one rank: |d Jij/Dij/Aij|="
            f"{err:.3e} mRy; one rank {one['wall']:.3f} s "
            f"{one['peak'] / 2**30:.2f} GiB; " + per_rank_text(two["ranks"]))
    del xsys, arrays, pots

    # two ranks: the block SCF through the CLI on row slabs -------------
    with tempfile.TemporaryDirectory() as work:
        src = os.path.join(work, "src")
        os.makedirs(src)
        box_input(small, src, small_box)
        dirs = {k: os.path.join(work, k) for k in ("one", "two")}
        for d in dirs.values():
            shutil.copytree(src, d)
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main([os.path.join(dirs["one"], "input.nml"),
                           f"output={dirs['one']}", f"device={dev}"])
        t_one = time.perf_counter() - t1
        check(rc == 0, "one rank's CLI run")
        out = launch.run(
            "rslmtoasa_tpu_torch.parallel.stages:cli_main", RANKS,
            device=ranks_device, share_cards=True,
            threads=torch.get_num_threads(), timeout=900.0,
            argv=[os.path.join(dirs["two"], "input.nml"),
                  f"output={dirs['two']}", f"device={ranks_device}"],
            env={"RSLMTO_ROWSHARD_BYTES": str(CLI_ROWSHARD_BYTES)})
        check(out["rc"] == 0, f"the CLI on {RANKS} ranks")
        check(all(c.get("slab_block", 0) >= 1 and set(c) == {"slab_block"}
                  for c in out["routes"]),
              f"the CLI on {RANKS} ranks did not run on row slabs: "
              f"{out['routes']}")
        nfiles, worst = files_close(dirs["one"], dirs["two"])
        say(13, f"box {small_box} block SCF, {NSTEP} iterations, through "
                f"the CLI on {RANKS} ranks (row slabs) vs one rank: "
                f"{nfiles} files {sorted(os.listdir(dirs['two']))} within "
                f"{worst:.3e}; "
                f"routes per rank {out['routes']}; "
                f"one rank {t_one:.3f} s; " + per_rank_text(out["ranks"]))
    del small

    # one NCCL rank ------------------------------------------------------
    res = launch.run("rslmtoasa_tpu_torch.parallel.stages:chain_block", 1,
                     device=ranks_device, share_cards=False, timeout=600.0,
                     hs=hb.ee, lsham=hb.lsham, iz=hb.iz, cols=hb.cols,
                     starts=[0, kk // 2], lld=lld)
    same = all(np.array_equal(g, w) for g, w in zip(res["block"],
                                                    res["block_1"]))
    check(res["world"] == 1 and same and (
        res["backend"] == "nccl" or ranks_device == "cpu"),
        f"one {res['backend']} rank: bit-equal {same}")
    say(13, f"one {res['backend']} rank on {res['device']}: the chain-"
            f"sharded block recursion (R = 2, box 60) bit-equal to the "
            f"single rank, {res['wall']:.3f} s")

    # the dry run at two ranks on the card ------------------------------
    t1 = time.perf_counter()
    dry = dryrun.run(RANKS, ranks_device)
    check(all(v <= dry["bars"][k] for k, v in dry["errors"].items()),
          f"dry run: {dry['errors']}")
    say(13, f"dry run on {RANKS} ranks ({dry['device']}): " + ", ".join(
        f"{k} {v:.2e}" for k, v in dry["errors"].items())
        + f"; {time.perf_counter() - t1:.1f} s; not applicable: "
        + "; ".join(dryrun.NOT_APPLICABLE))
    # what the dry run's exchange bar parts: the Jij of chains moved by
    # roundoff and of chains wrong at 1e-12, on the card
    rnd = stages.exchange_roundoff(device=dev, eps=(1e-15, 1e-12))
    sound = max(j for _, j in rnd[1e-15])
    wrong = min(j for _, j in rnd[1e-12])
    check(sound < dryrun.BARS["exchange"] < wrong,
          f"exchange bar {dryrun.BARS['exchange']} outside ({sound}, "
          f"{wrong})")
    say(13, "dry run's exchange on one rank, chains moved by e of "
            "themselves (4 seeds): " + "; ".join(
                f"e={e:.0e}: |d chains| " + ", ".join(
                    f"{c:.2e}" for c, _ in v) + " -> |d Jij/Dij/Aij| "
                + ", ".join(f"{j:.2e}" for _, j in v) + " mRy"
                for e, v in rnd.items())
        + f" (bar {dryrun.BARS['exchange']:.0e})")
    say(13, f"phase 13 in {time.perf_counter() - t0:.1f} s")


def terminator_phase(dev, records):
    """Phase 14: the terminator fits on the card (``bpopt_fit``) against
    the NumPy route, on the box-30 preset's block chains (nsp 2); fills
    ``records["bpopt_fit"]``."""
    from rslmtoasa_tpu_torch.models.presets import build_synthetic_bcc
    from rslmtoasa_tpu_torch.ops import terminator
    from rslmtoasa_tpu_torch.ops.block_lanczos import (
        BlockOperator,
        block_lanczos,
        block_start_vectors,
        zsqr,
    )
    from rslmtoasa_tpu_torch.physics.greens import get_terminf

    t0 = time.perf_counter()
    bench = build_synthetic_bcc(device=dev, nsp=2, **PRESET)
    hb = bench.ham
    lld = bench.cfg.control.lld
    n = lld - 1
    op = BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham).to(dev)
    starts = list(range(0, op.kk, op.kk // max(TERMINATOR_R)))[
        :max(TERMINATOR_R)]
    psi0 = block_start_vectors(op.kk, starts, dev)
    a_b, b2_b = (t.cpu().numpy() for t in block_lanczos(op, psi0, lld))
    b_b = zsqr(b2_b)
    del bench, op, psi0
    say(14, f"box-30 block chains: lld {lld}, R = {len(starts)}, in "
            f"{time.perf_counter() - t0:.1f} s")

    def chains(x):
        return torch.as_tensor(np.ascontiguousarray(
            x.real.transpose(1, 2, 3, 0).reshape(-1, lld)), device=dev)

    # the Sturm counts the kernel runs, held on the NaN chain: 301
    # centring steps of 50 counts (emami's first phase out of steps)
    nan_a = np.full((1, lld), 0.1)
    nan_a[0, 3] = np.nan
    nan_t = torch.as_tensor(nan_a, device=dev)
    _, fail = terminator.bpopt_fit(nan_t, nan_t, n)
    check(int(fail[0]) == 1 and int(terminator.sturm_counts(
        nan_t, nan_t, n)[0]) == 301 * 50,
        "the NaN chain runs out of centring steps")
    rec = records["bpopt_fit"]  # its launches from phase 7
    rec.update(max_abs_err=0.0, bound_by="latency", library_ms=None)
    for r in TERMINATOR_R:
        a, b = a_b[:, :r], b_b[:, :r]
        host = []
        for _ in range(3):
            t1 = time.perf_counter()
            want = get_terminf(a, b)
            host.append(time.perf_counter() - t1)
        ad, bd = (torch.as_tensor(x, device=dev) for x in (a, b))
        launches = terminator.bpopt_fit.launches
        got = get_terminf(ad, bd)
        check(terminator.bpopt_fit.launches == launches + 1,
              "one launch a get_terminf")
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              f"the card's fits at R = {r} equal the NumPy route's")
        call = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            get_terminf(ad, bd)
            call.append(time.perf_counter() - t1)
        ca, cb = chains(a), chains(b)
        ms = cuda_ms(lambda: terminator.bpopt_fit(ca, cb, n, 18), iters=10)
        # the latency bound: the slowest chain's Sturm counts, as the
        # kernel counts them, each n - 1 dependent levels, at one level's
        # latency timed apart: one thread's chain of levels on the slowest
        # chain's own finite operands, at its fitted a_inf
        counts = terminator.sturm_counts(ca, cb, n).cpu().numpy()
        k = int(counts.argmax())
        fit, _ = terminator.bpopt_fit(ca[k:k + 1], cb[k:k + 1], n)
        z, zb = ca[k, :n].contiguous(), cb[k, :n].contiguous()
        check(bool(torch.isfinite(z).all() and torch.isfinite(zb).all()),
              "the slowest chain is finite")
        e = float(fit[0, 0])
        level_ns = 1e6 * cuda_ms(lambda: terminator.sturm_steps(
            z, zb, e, STURM_REPS), iters=5) / (STURM_REPS * (n - 1))
        bound = 1e-6 * level_ns * int(counts.max()) * (n - 1)
        say(14, f"R = {r}, C = {ca.shape[0]}: kernel {ms:.4f} ms, latency "
                f"bound {bound:.4f} ms ({100 * bound / ms:.1f} %: the "
                f"slowest chain's {counts.max()} Sturm counts of {n - 1} "
                f"dependent levels at {level_ns:.2f} ns a level, timed on "
                f"one thread on its operands; mean {counts.mean():.1f} "
                f"counts a chain); get_terminf on the card "
                f"{1e3 * min(call):.3f} ms (min of 5), NumPy route "
                f"{1e3 * min(host):.1f} ms (min of 3; "
                f"{', '.join(f'{1e3 * h:.1f}' for h in host)}), bit-equal")
        rec.update(ms=ms, plain_ms=1e3 * min(host), bound_ms=bound)
    say(14, f"phase 14 took {time.perf_counter() - t0:.1f} s")


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rslmtoasa_tpu_torch import bench as port_bench
    from rslmtoasa_tpu_torch import native
    from rslmtoasa_tpu_torch.models.presets import (
        build_synthetic_b2,
        build_synthetic_bcc,
        build_synthetic_impurity,
        build_synthetic_surface,
    )
    from rslmtoasa_tpu_torch.models.scf import SelfConsistency
    from rslmtoasa_tpu_torch.ops import block_kernels as bk
    from rslmtoasa_tpu_torch.ops import cuda_build
    from rslmtoasa_tpu_torch.ops import haydock_kernels as hk
    from rslmtoasa_tpu_torch.ops import terminator
    from rslmtoasa_tpu_torch.ops.block_lanczos import (
        BlockOperator,
        block_lanczos,
        block_start_vectors,
        block_times,
        eig_sqrt,
        gram_sum,
        pad_row,
    )
    from rslmtoasa_tpu_torch.ops.chebyshev import (
        chebyshev_green,
        chebyshev_moments,
    )
    from rslmtoasa_tpu_torch.ops.lanczos import (
        HaydockOperator,
        lanczos_coefficients,
        scalar_start_vectors,
    )
    from rslmtoasa_tpu_torch.physics.greens import bgreen
    from rslmtoasa_tpu_torch.utils.timer import g_timer

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    wrappers = {"spmv_dot": hk.spmv_dot,
                "spmv_dot_pipelined": hk.spmv_dot_pipelined,
                "update_norm": hk.update_norm}

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
    # every source at once: one nvcc per CUDA source, g++ for the solver
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        jobs = {hk.LIBRARY: pool.submit(hk.build_library),
                bk.LIBRARY: pool.submit(bk.build_library),
                terminator.LIBRARY: pool.submit(terminator.build_library),
                native.LIBRARY: pool.submit(native.get_lib)}
        logs = {lib: job.result() for lib, job in jobs.items()}
    say(1, "built " + ", ".join(os.path.relpath(lib) for lib in logs)
        + f" in {time.perf_counter() - t0:.1f} s")
    for lib in (hk.LIBRARY, bk.LIBRARY, terminator.LIBRARY):
        for line in logs[lib].splitlines():
            if "spill" in line or ("ptxas" in line and (
                    "registers" in line or "Compiling" in line)):
                print("   ", line.strip(), flush=True)
    check("spmv_dot_pipelined_kernel" in logs[hk.LIBRARY],
          "ptxas reports K2'")
    check("block_step_kernel" in logs[bk.LIBRARY], "ptxas reports K4")
    check("bpopt_fit_kernel" in logs[terminator.LIBRARY],
          "ptxas reports the terminator fit")
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    dmma = {}
    for lib, knames in ((hk.LIBRARY, ("spmv_dot_kernel",
                                      "spmv_dot_pipelined_kernel")),
                        (bk.LIBRARY, ("block_step_kernelILi9E",
                                      "block_step_kernelILi18E"))):
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True, timeout=120).stdout
        for body in sass.split("Function : ")[1:]:
            fname = body.split("\n", 1)[0]
            for kname in knames:
                if kname in fname:
                    dmma[kname] = body.count("DMMA")
    say(1, f"cuobjdump -sass: DMMA instructions {dmma}")
    check(len(dmma) == 4 and min(dmma.values()) > 0,
          "both SpMV kernels and K4 at d = 9 and 18 multiply on the FP64 "
          "tensor cores (DMMA)")

    # 2. kernels vs plain --------------------------------------------
    t0 = time.perf_counter()
    bench = build_synthetic_bcc(device=dev, **PRESET)
    hb = bench.ham
    kk = bench.cluster.kk
    op = HaydockOperator(hb.ee[:, :, :9, :9], hb.iz, hb.cols).to(dev)
    nslots = hb.cols.shape[1]
    say(2, f"preset box {PRESET['box']}: kk={kk}, nslots={nslots}"
           f", built in {time.perf_counter() - t0:.1f} s")
    check(kk == 27000 and nslots == 15, "bench shape")
    csr = csr_operator(op.hs, op.iz, op.cols)
    # occupied (row, slot) blocks: what this run's data needs
    nblocks = int((op.cols < kk).sum())
    self_cols = torch.arange(kk, dtype=torch.int32, device=dev)[:, None] \
        .expand(kk, nslots).contiguous()
    records = {n: {"max_abs_err": 0.0} for n in REPLACES}
    for c in (9, 144):
        psi = random_chains(kk, c, 1, dev)
        v = random_chains(kk, c, 2, dev)[:kk].contiguous()
        w_in = random_chains(kk, c, 3, dev)
        errs, dy, da = spmv_parity(hk, op, psi, f"bcc C={c}", records)
        y0, ap0 = hk.spmv_dot_ref(op.hs, op.iz, op.cols, psi)
        # K3': the deferred step (r, b2, b2_prev; |gamma| < 1, so repeated
        # launches on one buffer stay bounded) and the generalised update
        # at (1, -a, 1), the Pallas K3 contract
        s_step = k3_scalars(c, dev)
        ones = torch.ones(c, dtype=torch.float64, device=dev)
        s_old = (ones, -s_step[0], ones)
        err_new, part0 = k3_parity(hk, s_step, v, psi, w_in, f"bcc C={c}")
        err_old, _ = k3_parity(hk, s_old, v, psi, w_in,
                               f"bcc C={c} at (1, -a, 1)", deferred=False)
        errs["update_norm"] = max(err_new, err_old)
        records["update_norm"]["max_abs_err"] = max(
            records["update_norm"]["max_abs_err"], errs["update_norm"])
        buf = w_in.clone()
        b2o, ao = (torch.empty(c, dtype=torch.float64, device=dev)
                   for _ in range(2))
        ms = {}
        ms["spmv_dot"] = in_turns(
            lambda: hk.spmv_dot_ref(op.hs, op.iz, op.cols, psi),
            lambda: hk.spmv_dot(op.hs, op.iz, op.cols, psi))
        ms["spmv_dot_pipelined"] = in_turns(
            lambda: hk.spmv_dot_pipelined_ref(op.hs, op.iz, op.cols, psi),
            lambda: hk.spmv_dot_pipelined(op.hs, op.iz, op.cols, psi))
        ms["update_norm"] = in_turns(
            lambda: hk.update_norm_ref(s_step, v, psi, buf, b2o, ao),
            lambda: hk.update_norm(s_step, v, psi, buf, b2o, ao))
        # the step's update phase before this redesign (K1''s fold, K3' at
        # (1, -a, 1), then the torch passes that normalised the chain and
        # copied a and b2) and now (the fold and one K3' launch), alone and
        # after K1'
        tab = torch.zeros((2, c), dtype=torch.float64, device=dev)
        rows_out = torch.view_as_real(psi.clone())[:kk]

        def old_update(y, apart):
            a_ll = apart.sum(0)
            tab[0] = a_ll
            part = hk.update_norm((ones, -a_ll, ones), y, psi, buf, b2o)
            summ = part.sum(0)
            tab[1] = summ
            sq = torch.sqrt(summ)
            pmn_new = psi[:kk] * (-sq)
            torch.div(torch.view_as_real(buf[:kk]), sq[:, None],
                      out=rows_out)
            return pmn_new

        def new_update(y, apart):
            hk.update_norm((apart.sum(0), s_step[1], s_step[2]), y, psi, buf,
                           b2o, ao)

        phase = {
            "update phase": in_turns(lambda: old_update(v, ap0),
                                     lambda: new_update(v, ap0)),
            "K3' alone": in_turns(
                lambda: hk.update_norm(s_old, v, psi, buf, b2o),
                lambda: hk.update_norm(s_step, v, psi, buf, b2o, ao)),
            "step (K1' + update phase)": in_turns(
                lambda: old_update(*hk.spmv_dot(op.hs, op.iz, op.cols,
                                                psi)),
                lambda: new_update(*hk.spmv_dot(op.hs, op.iz, op.cols,
                                                psi)))}
        # K3' at each block size (the bits do not change; update_plan
        # picks one), and torch.addcmul on the same bytes (three reads and
        # one write, no norm): the rate this pattern gets on the card
        ct3, kr3, rows3 = hk.update_plan(kk, c, hk._sm_count(dev.index))
        by_rows = {rows: cuda_ms(lambda: hk.update_norm(
            s_step, v, psi, buf, b2o, ao, plan=(ct3, kr3, rows)))
            for rows in (32, 16, 8, 4, 2)}
        yard = cuda_ms(lambda: torch.addcmul(buf[:kk], v, psi[:kk],
                                             out=buf[:kk]))
        # K1' taken apart: its gathers alone, its MMAs alone, and all of it
        # with every column the row itself (the same work, perfect locality)
        halves = {
            "gathers only": cuda_ms(lambda: hk.spmv_dot_half(
                op.hs, op.iz, op.cols, psi, "gather")),
            "MMAs only": cuda_ms(lambda: hk.spmv_dot_half(
                op.hs, op.iz, op.cols, psi, "mma")),
            "cols = row": cuda_ms(lambda: hk.spmv_dot(
                op.hs, op.iz, self_cols, psi))}
        flat = psi.view(9 * (kk + 1), c)
        ylib = torch.sparse.mm(csr, flat).view(kk, 9, c)
        err, scale = rel_err(ylib, y0)
        check(err <= 1e-12 * scale, f"library SpMV C={c}: {err}")
        lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, flat))
        del ylib
        # bounds from this run's inputs: each input read once, each
        # output written once; the SpMVs' flops over the occupied blocks
        spmv_flops = 8 * 81 * nblocks * c
        spmv_bytes = nbytes(op.hs, op.iz, op.cols, psi, y0, ap0)
        upd_bytes = k3_bytes(v, part0)
        gathered = nblocks * 9 * c * 16
        # what the kernels issue: every (row, chain) pair times 34 quads
        # times 3 n-tiles of one m16n8k8 (64 MACs per pair)
        dmma_flops = 2 * 64 * hk.NTILE * hk.nquads(nslots) * kk * c
        bounds = {
            "spmv_dot": (spmv_flops / FP64_TENSOR_FLOPS,
                         spmv_bytes / HBM_BYTES_S),
            # 14 flop per complex element: three scaled terms added, then
            # |.|^2, on the vector units
            "update_norm": (14 * kk * 9 * c / FP64_VECTOR_FLOPS,
                            upd_bytes / HBM_BYTES_S)}
        bounds["spmv_dot_pipelined"] = bounds["spmv_dot"]
        if c == 9:  # the main path's shape
            for name, (t_k, t_p) in ms.items():
                ops_s, bytes_s = bounds[name]
                records[name].update(
                    ms=t_k, plain_ms=t_p, bound_ms=1e3 * max(ops_s, bytes_s),
                    bound_by="operations" if ops_s >= bytes_s else "bytes",
                    library_ms=None if name == "update_norm" else lib_ms)
        say(2, f"C={c}: " + "; ".join(
            f"{n} err {errs[n]:.3e} kernel {ms[n][0]:.4f} ms plain "
            f"{ms[n][1]:.4f} ms bound {1e3 * max(bounds[n]):.4f} ms "
            f"({100e3 * max(bounds[n]) / ms[n][0]:.1f}% of it)"
            for n in ms) + f"; K2' vs K1': |dy|={dy:.3e} |da|={da:.3e}")
        for n in ("spmv_dot", "spmv_dot_pipelined"):
            say(2, f"C={c}: {n} {spmv_flops / ms[n][0] / 1e9:.2f} TFLOP/s "
                   f"on the occupied blocks, {dmma_flops / ms[n][0] / 1e9:.2f}"
                   f" TFLOP/s issued to DMMA; gathered "
                   f"{gathered:.4e} B, {gathered / ms[n][0] / 1e9:.3f} TB/s")
        say(2, f"C={c}: padded DMMA work {dmma_flops:.4e} flop -> "
               f"{1e3 * dmma_flops / FP64_TENSOR_FLOPS:.4f} ms at the FP64 "
               f"tensor peak; K1' apart: " + ", ".join(
                   f"{k} {t:.4f} ms" for k, t in halves.items()))
        upd_bound = 1e3 * max(bounds["update_norm"])
        alone, upd = phase["K3' alone"], phase["update phase"]
        say(2, f"C={c}: " + ", ".join(
            f"{k} {t_new:.4f} ms (before: {t_old:.4f} ms)"
            for k, (t_new, t_old) in phase.items())
            + f"; K3' alone {100 * upd_bound / alone[0]:.1f}% of its "
            f"{upd_bound:.4f} ms bound (at (1, -a, 1): "
            f"{100 * upd_bound / alone[1]:.1f}%), the update phase "
            f"{100 * upd_bound / upd[0]:.1f}% (before: "
            f"{100 * upd_bound / upd[1]:.1f}%); K1' "
            f"{ms['spmv_dot'][0]:.4f} ms; {smi_line()}")
        say(2, f"C={c}: K3' by rows a block (update_plan: {rows3}): "
               + ", ".join(f"{r} {t:.4f} ms" for r, t in by_rows.items())
               + f"; torch.addcmul on the same bytes {yard:.4f} ms "
               f"({100 * upd_bound / yard:.1f}% of the bound)")
        say(2, f"C={c}: library torch.sparse.mm (CSR complex128, no dot): "
               f"{lib_ms:.4f} ms; SpMV flops {spmv_flops:.4e} -> "
               f"{1e3 * spmv_flops / FP64_VECTOR_FLOPS:.4f} ms at FP64 "
               f"vector peak, {1e3 * spmv_flops / FP64_TENSOR_FLOPS:.4f} "
               f"ms at FP64 tensor peak; update bytes {upd_bytes:.4e}")
        del psi, v, w_in, buf, y0, part0, rows_out
        torch.cuda.empty_cache()
    del csr
    # two types that mix within row tiles (B2), at one chain count
    b2 = build_synthetic_b2(rc=8.0, nsp=1, device=dev)
    op_b2 = HaydockOperator(b2.ham.ee[:, :, :9, :9], b2.ham.iz,
                            b2.ham.cols).to(dev)
    iz_b2 = op_b2.iz.cpu().numpy()
    check(op_b2.hs.shape[0] == 2 and any(
        len(set(iz_b2[i:i + hk.ROWS_PER_BLOCK])) == 2
        for i in range(0, op_b2.kk, hk.ROWS_PER_BLOCK)),
        "B2 mixes its two types within a row tile")
    errs, dy, da = spmv_parity(hk, op_b2, random_chains(op_b2.kk, 9, 4, dev),
                               "B2 C=9", records)
    say(2, f"B2 kk={op_b2.kk} ntype=2 C=9: spmv_dot err "
           f"{errs['spmv_dot']:.3e}, spmv_dot_pipelined err "
           f"{errs['spmv_dot_pipelined']:.3e}; K2' vs K1' |dy|={dy:.3e} "
           f"|da|={da:.3e}; reruns bit-identical")
    del b2, op_b2
    torch.cuda.empty_cache()

    # 3. recursion ---------------------------------------------------
    starts = [i * (kk // 16) for i in range(16)]
    psi0 = scalar_start_vectors(kk, starts, dev)
    lld = PRESET["lld"]
    nnz = kk * nslots * 81
    for roll in (False, True):
        # one untimed run first, so that neither engine pays the caching
        # allocator's first requests after empty_cache()
        lanczos_coefficients(op.hs, op.iz, op.cols, psi0, lld, roll=roll)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, b2 = lanczos_coefficients(op.hs, op.iz, op.cols, psi0, lld,
                                     roll=roll)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        t0 = time.perf_counter()
        a0, b20 = lanczos_coefficients(op.hs, op.iz, op.cols, psi0, lld,
                                       plain=True, roll=roll)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
        ea = float((a - a0).abs().max())
        eb = float((b2 - b20).abs().max())
        check(a.shape == (lld, 144) and bool(torch.isfinite(b2).all()),
              "recursion shape and finiteness")
        check(ea <= 1e-11 and eb <= 1e-11,
              f"recursion roll={roll}: a {ea}, b2 {eb}")
        say(3, f"C=144 lld={lld} roll={roll}: |da|={ea:.3e} "
               f"|db2|={eb:.3e}; kernels {1e3 * t_k:.3f} ms for the "
               f"{lld - 1} steps, {1e3 * t_k / (lld - 1):.4f} ms a step "
               f"({nnz * 144 * (lld - 1) / t_k / 1e9:.2f} Gnnz/s), "
               f"plain {1e3 * t_p:.3f} ms; {smi_line()}")
    del bench, op, psi0
    torch.cuda.empty_cache()

    # 4. main path ---------------------------------------------------
    # Each engine against the CPU after one iteration at SCF_BARS, and on
    # the second iteration from the CPU run's state after the first (its
    # copy run on the card's engine) against the CPU's own, as phase 7
    # holds its pairs: there an etot miss within the spread of the
    # atomic-sphere solver's last three iterations, where the solver alone
    # stops unconverged on the CPU run's inputs, is listed as unmet.  The
    # whole two-iteration runs' differences print beside it.
    results = {}
    env_roll = os.environ.pop("RSLMTO_ROLL", None)
    roll_of = {"cuda": None, "cuda-roll": "1", "cpu": None}

    def engine_of(run):
        if roll_of[run] is None:
            os.environ.pop("RSLMTO_ROLL", None)
        else:
            os.environ["RSLMTO_ROLL"] = roll_of[run]

    def readings(diffs):
        return ", ".join(f"|d{q}|={v:.3e}" for q, v in diffs.items())

    want = NSTEP * 2 * (PRESET["lld"] - 1)
    expect = {"cuda": {"spmv_dot": want, "spmv_dot_pipelined": 0,
                       "update_norm": want},
              "cuda-roll": {"spmv_dot": 0, "spmv_dot_pipelined": want,
                            "update_norm": want}}
    misses, unmet = [], []
    try:
        for run, device in (("cuda", "cuda"), ("cuda-roll", "cuda"),
                            ("cpu", "cpu")):
            engine_of(run)
            with solver_calls(native) as calls:
                results[run] = r = scf_once(
                    SelfConsistency, build_synthetic_bcc(device=device,
                                                         **PRESET),
                    wrappers, g_timer)
            r["solver"] = calls[-1]  # the second iteration's
            rec = r["spent"][REC + "recursion"]
            say(4, f"SCF {run} sections (s): " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["spent"].items()
                if v > 0.0005))
            say(4, f"SCF {run}: {r['wall'] / NSTEP:.3f} s per iteration, "
                   f"recursion {100 * rec / r['wall']:.1f}%; "
                   f"etot {float(r['etot'])!r} fermi {float(r['fermi'])!r} "
                   f"delta {r['delta']:.3e}")
        cpu = results["cpu"]
        limit, tail = solver_tail(native, cpu["solver"], cpu["etot"])
        for run in ("cuda", "cuda-roll"):
            gpu = results[run]
            check(gpu["launches"] == expect[run],
                  f"{run} launches {gpu['launches']}, want {expect[run]}")
            first = scf_diffs(gpu["first"], cpu["first"])
            misses += [f"{run} vs cpu after 1 iteration: |d{q}| {v} > "
                       f"{SCF_BARS[q]}" for q, v in first.items()
                       if v > SCF_BARS[q]]
            engine_of(run)
            twin = second_iteration(cpu["snap"], "cuda", False, wrappers)
            check(twin["launches"] == {n: k // NSTEP
                                       for n, k in expect[run].items()},
                  f"{run} iteration 2 launches {twin['launches']}")
            port = scf_diffs(twin, cpu)
            for q, v in port.items():
                if v <= SCF_BARS[q]:
                    continue
                what = (f"{run} vs cpu, iteration 2 from cpu's state: "
                        f"|d{q}| {v:.3e} > {SCF_BARS[q]:g}")
                if q == "etot" and v <= tail:
                    unmet.append(f"{what}, within the unconverged solver's "
                                 f"last three iterations ({tail:.3e})")
                else:
                    misses.append(what)
            whole = scf_diffs(gpu, cpu)
            unmet += [f"{run} vs cpu after {NSTEP}: |d{q}| {v:.3e} > "
                      f"{SCF_BARS[q]:g} (one state, two engines: "
                      f"{port[q]:.3e})" for q, v in whole.items()
                      if v > SCF_BARS[q]]
            say(4, f"{run} vs cpu after 1 iteration: {readings(first)}; "
                   f"iteration 2 from cpu's state: {readings(port)}; after "
                   f"{NSTEP}: {readings(whole)}; launches {gpu['launches']}"
                   f"; the solver alone on cpu's inputs "
                   + (f"stops unconverged at its limit of {limit} "
                      f"iterations, etot over the last three spread "
                      f"{tail:.3e}" if tail else "converges"))
    finally:
        if env_roll is None:
            os.environ.pop("RSLMTO_ROLL", None)
        else:
            os.environ["RSLMTO_ROLL"] = env_roll
    say(4, f"bars unmet: {len(unmet)}" + "".join(f"; {u}" for u in unmet))
    check(not misses, "; ".join(misses))
    for name in wrappers:
        path = "cuda-roll" if name == "spmv_dot_pipelined" else "cuda"
        records[name]["launches"] = results[path]["launches"][name]

    # 5. bench -------------------------------------------------------
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = port_bench.main(n_start=1)
    printed = buf.getvalue().strip().splitlines()
    check(len(printed) == 1 and json.loads(printed[0]) == line,
          "bench prints one JSON line")
    check(line["guard_max_abs_err"] <= port_bench.GUARD_ATOL
          and line["value"] > 0, "bench host guard")
    print(f"[5] {printed[0]}", flush=True)
    say(5, f"bench at C=9: {line['ms_per_step']:.4f} ms a step "
           f"({line['value']:.2f} Gnnz/s) on {smi_line()}; in "
           f"{time.perf_counter() - t0:.1f} s")

    # 6. block step ----------------------------------------------------
    t0 = time.perf_counter()
    soc = build_synthetic_bcc(device=dev, nsp=2, hoh=True, **PRESET)
    hb = soc.ham
    kk = soc.cluster.kk
    nblocks = int((hb.cols < kk).sum())
    say(6, f"box {PRESET['box']} with SOC and HoH tables: kk={kk}, "
           f"{nblocks} occupied blocks, built in "
           f"{time.perf_counter() - t0:.1f} s")
    ops = {"d=18": BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham),
           "d=18 HoH": BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham,
                                     hoh=True, hso=hb.eeo, enim=hb.enim),
           "d=9": BlockOperator(hb.ee[..., :9, :9], hb.iz, hb.cols,
                                hb.lsham[..., :9, :9])}
    for what, op in ops.items():
        op = op.to(dev)
        d = op.hs.shape[-1]
        psi = random_chains(kk, d, 11, dev, d=d)
        err = k4_check(bk, op, psi, f"box 30 {what}", records)
        t_k, t_p = in_turns(lambda: op(psi, gram=True, plain=True),
                            lambda: op(psi, gram=True))
        flops, moved = k4_work(op, psi, nblocks, bk.nrowblk(kk, d))
        ops_s, bytes_s = flops / FP64_TENSOR_FLOPS, moved / HBM_BYTES_S
        bound = 1e3 * max(ops_s, bytes_s)
        by = "operations" if ops_s >= bytes_s else "bytes"
        lib = ""
        if what == "d=18":
            csr = csr_operator(op.hs, op.iz, op.cols, op.onsite, op.izo)
            flat = psi.view(d * (kk + 1), d)
            y0, _ = op(psi, plain=True)
            e, scale = rel_err(torch.sparse.mm(csr, flat).view(kk, d, d), y0)
            check(e <= 1e-12 * scale, f"library SpMV d=18: {e}")
            lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, flat))
            lib = (f"; library torch.sparse.mm (CSR complex128, onsite "
                   f"folded in, no Gram) {lib_ms:.4f} ms")
            records["block_step"].update(ms=t_k, plain_ms=t_p, bound_ms=bound,
                                         bound_by=by, library_ms=lib_ms)
            del csr, flat, y0
        say(6, f"{what}: err {err:.3e}, reruns bit-identical; kernel "
               f"{t_k:.4f} ms plain {t_p:.4f} ms bound {bound:.4f} ms ({by}"
               f", {100 * bound / t_k:.1f}% of it); {flops:.4e} flop "
               f"{flops / t_k / 1e9:.2f} TFLOP/s, {moved:.4e} B" + lib)
        del psi
    # one block step taken apart (d = 18, R = 1)
    op = ops["d=18"]
    psi = random_chains(kk, 18, 13, dev, d=18)
    pmn = psi[:kk]
    b2 = gram_sum(pmn.conj(), pmn)
    b, b_i = eig_sqrt(b2)
    parts = {"K4 (H psi and its Gram)": lambda: op(psi, gram=True),
             "gram_sum (B^2)": lambda: gram_sum(pmn.conj(), pmn),
             "eig_sqrt (eigh)": lambda: eig_sqrt(b2),
             "block_times (one of three)": lambda: block_times(pmn, b_i),
             "pad_row": lambda: pad_row(pmn)}
    say(6, "one block step taken apart, d=18 R=1: " + ", ".join(
        f"{k} {cuda_ms(f):.4f} ms" for k, f in parts.items()))
    del psi, pmn, parts
    # the recursions through K4 against their plain versions
    psi0 = block_start_vectors(kk, [0], dev)
    lld = PRESET["lld"]
    for what in ("d=18", "d=18 HoH"):
        op = ops[what]
        runs = {"block_lanczos": lambda plain: block_lanczos(
                    op, psi0, lld, plain=plain),
                "chebyshev_moments": lambda plain: (chebyshev_moments(
                    op, psi0, lld, *CHEB_AB, plain=plain),)}
        for name, run in runs.items():
            run(False)  # warm-up
            secs = {}
            for plain in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run(plain)
                torch.cuda.synchronize()
                secs[plain] = (time.perf_counter() - t0, out)
            err = max(float((g - w).abs().max())
                      for g, w in zip(secs[False][1], secs[True][1]))
            check(err <= 1e-11, f"{name} {what} through K4 vs plain: {err}")
            say(6, f"{name} {what} lld={lld}: |d|={err:.3e}; kernels "
                   f"{secs[False][0]:.3f} s, plain {secs[True][0]:.3f} s")
    del ops, op, psi0, runs, secs
    torch.cuda.empty_cache()
    b2 = build_synthetic_b2(rc=8.0, nsp=2, device=dev)
    op = BlockOperator(b2.ham.ee, b2.ham.iz, b2.ham.cols,
                       b2.ham.lsham).to(dev)
    iz_b2 = op.iz.cpu().numpy()
    rt = bk.rows_per_tile(18)
    check(op.hs.shape[0] == 2 and any(
        len(set(iz_b2[i:i + rt])) == 2 for i in range(0, op.kk, rt)),
        "B2 mixes its two types within a row tile")
    err = k4_check(bk, op, random_chains(op.kk, 36, 12, dev, d=18),
                   "B2 R=2", records)
    nchunk = bk.chunks(18, 2, op.onsite.shape[0], op.cols.shape[1], True,
                       True)
    check(nchunk > 1, "B2 at d=18 walks its table in chunks")
    say(6, f"B2 kk={op.kk} ntype=2 d=18 R=2: err {err:.3e}, reruns "
           f"bit-identical; the table in {nchunk} chunks")
    del b2, op

    # 7. block and Chebyshev SCFs --------------------------------------
    every = dict(wrappers, block_step=bk.block_step,
                 bpopt_fit=terminator.bpopt_fit)
    # the card's batched inverse and complex kernels load or compile on
    # their first call: both Green functions once here, on a tiny input, so
    # that no SCF's timer sections carry it
    eye = np.tile(np.eye(18), (3, 1, 1, 1))
    bgreen(0.1 * eye, eye, 0.1 * eye[0], eye[0], np.linspace(-1, 1, 4), dev)
    chebyshev_green(eye, np.linspace(-1, 0.5, 4), *WINDOW, dev)
    templates = {30: soc, 10: build_synthetic_bcc(
        device="cpu", nsp=2, **dict(PRESET, box=10))}

    def configured(box, case, device, plain):
        sys_ = copy.deepcopy(templates[box])
        sys_.device, sys_.plain = torch.device(device), plain
        sys_.cfg.control.recur = BLOCK_CASES[case]["recur"]
        sys_.cfg.hamiltonian.hoh = BLOCK_CASES[case]["hoh"]
        if sys_.cfg.control.recur == "chebyshev":
            sys_.cfg.energy.energy_min, sys_.cfg.energy.energy_max = WINDOW
        return sys_

    def readings(diffs):
        return ", ".join(f"|d{q}|={v:.3e}" for q, v in diffs.items())

    misses = []  # every reading prints before a miss fails the phase
    unmet = []  # bars missed where the solver, not the port, moves
    for case, spec in BLOCK_CASES.items():
        per_it = (2 if spec["hoh"] else 1) * (
            lld + 1 if spec["recur"] == "chebyshev" else lld - 1)
        bars = NSTEP_BARS[case]

        def want(device, plain, niter):
            out = {n: 0 for n in every}
            if device != "cpu" and not plain:
                out["block_step"] = niter * per_it
                # the terminator fits: one launch a block iteration
                out["bpopt_fit"] = niter * (spec["recur"] == "block")
            return out

        res, engine = {}, {}
        for run, box, device, plain in (("cuda", 30, dev, False),
                                        ("cuda-plain", 30, dev, True),
                                        ("cuda-box10", 10, dev, False),
                                        ("cuda-plain-box10", 10, dev, True),
                                        ("cpu-box10", 10, "cpu", False)):
            engine[run] = (device, plain)
            with solver_calls(native) as calls:
                res[run] = r = scf_once(SelfConsistency,
                                        configured(box, case, device, plain),
                                        every, g_timer)
            r["solver"] = calls[-1]  # the second iteration's
            check(r["launches"] == want(device, plain, NSTEP),
                  f"{case} {run} launches {r['launches']}, want "
                  f"{want(device, plain, NSTEP)}")
            rec = r["spent"][f"{REC}{spec['recur']}-recursion"]
            say(7, f"SCF {case} {run}: {r['wall'] / NSTEP:.3f} s per "
                   f"iteration, recursion {100 * rec / r['wall']:.1f}%; "
                   + ", ".join(f"{k} {v:.3f}" for k, v in r["spent"].items()
                               if v > 0.0005)
                   + f"; etot {float(r['etot'])!r} fermi "
                     f"{float(r['fermi'])!r}; K4 launches "
                     f"{r['launches']['block_step']}, fits "
                     f"{r['launches']['bpopt_fit']}")
        # a copy of the SCF after one iteration repeats the second on its
        # own engine: the copy carries the whole SCF state
        same = second_iteration(res["cuda-plain"]["snap"], dev, True, every)
        diffs = scf_diffs(same, res["cuda-plain"])
        say(7, f"{case} cuda-plain, iteration 2 again from a copy of its "
               f"state after 1: {readings(diffs)}")
        misses += [f"{case} cuda-plain copy: |d{q}| {v} > {bars[q]}"
                   for q, v in diffs.items() if v > bars[q]]
        # "cuda-plain-box10" against "cpu-box10" runs no kernel.  Each pair
        # is held after one iteration at the strict bars, and on the second
        # iteration at NSTEP_BARS: the second from ref's state after the
        # first, on got's engine, against ref's own.  Each run of NSTEP
        # iterations also carries the first iteration's roundoff through
        # the atomic-sphere solver into the second; that part of a pair's
        # difference is got's run against the same engine from ref's state.
        for got, ref in (("cuda", "cuda-plain"), ("cuda-box10", "cpu-box10"),
                         ("cuda-plain-box10", "cpu-box10")):
            pair = f"{case} {got} vs {ref}"
            diffs = scf_diffs(res[got]["first"], res[ref]["first"])
            say(7, f"{pair} after 1 iteration: {readings(diffs)}")
            misses += [f"{pair} after 1 iteration: |d{q}| {v} > "
                       f"{SCF_BARS[q]}" for q, v in diffs.items()
                       if v > SCF_BARS[q]]
            twin = second_iteration(res[ref]["snap"], *engine[got], every)
            check(twin["launches"] == want(*engine[got], 1),
                  f"{pair} iteration 2 launches {twin['launches']}")
            port = scf_diffs(twin, res[ref])
            limit, tail = solver_tail(native, res[ref]["solver"],
                                      res[ref]["etot"])
            say(7, f"{pair}, iteration 2 from {ref}'s state after 1: "
                   f"{readings(port)}; the solver alone on {ref}'s inputs "
                   + (f"stops unconverged at its limit of {limit} "
                      f"iterations, etot over the last three spread "
                      f"{tail:.3e}" if tail else "converges"))
            for q, v in port.items():
                if v <= bars[q]:
                    continue
                what = (f"{pair}, iteration 2 from {ref}'s state: |d{q}| "
                        f"{v:.3e} > {bars[q]:g}")
                if q == "etot" and v <= tail:
                    unmet.append(f"{what}, within the unconverged solver's "
                                 f"last three iterations ({tail:.3e})")
                else:
                    misses.append(what)
            diffs = scf_diffs(res[got], res[ref])
            solver = scf_diffs(res[got], twin)
            say(7, f"{pair} after {NSTEP}: {readings(diffs)}; {got} from its "
                   f"own state against from {ref}'s, one engine: "
                   f"{readings(solver)}")
            unmet += [f"{pair} after {NSTEP}: |d{q}| {v:.3e} > {bars[q]:g} "
                      f"(one state, two engines: {port[q]:.3e}; one engine, "
                      f"two states: {solver[q]:.3e})"
                      for q, v in diffs.items() if v > bars[q]]
        if case == "block":
            records["block_step"]["launches"] = res["cuda"]["launches"][
                "block_step"]
            # phase 14 fills the rest
            records["bpopt_fit"] = dict(
                launches=res["cuda"]["launches"]["bpopt_fit"])
    say(7, f"bars unmet: {len(unmet)}"
        + "".join(f"; {u}" for u in unmet))
    check(not misses, "; ".join(misses))
    torch.cuda.empty_cache()

    # 8. surface and impurity ----------------------------------------------
    embedded_phase(dev, records, every)

    # 9. exchange -------------------------------------------------------
    exchange_phase(dev, records, every, templates)

    # 10. conductivity --------------------------------------------------
    conductivity_phase(dev, records, every, templates)

    # 11. the last branches --------------------------------------------
    last_branches_phase(dev, records, every, templates)
    del templates, soc
    torch.cuda.empty_cache()

    # 12. the large cluster ---------------------------------------------
    big = large_cluster_phase(dev, records, every)

    # 13. ranks on the one card -----------------------------------------
    multi_rank_phase(dev, records, big)
    del big

    # 14. the terminator fits -------------------------------------------
    terminator_phase(dev, records)
    check("jax" not in sys.modules, "no JAX imported")

    kernels = [dict(name=n, route="cuda", source=SOURCES[n],
                    replaces=REPLACES[n], launches=r["launches"],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for n, r in records.items()]
    say(15, f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
