"""Time variants of the port's K4 (``rslmtoasa_tpu_torch/csrc/block_step.cu``)
beside the shipped kernel, on one CUDA card, in turns.

    python tools/k4_variants.py                  # shipped, gc3, gc9
    python tools/k4_variants.py 'name|old|new'   # more: one text replaced

Each variant is the shipped source with one piece of text replaced; all
build at once with nvcc into ``_checkout/`` (gitignored).  On the box-30 bcc
preset with spin-orbit coupling (kk = 27000, 15 slots) each is checked
against the plain version (1e-12) and timed with CUDA events in the order
shipped, variants..., variants reversed, shipped: d = 18 with its Gram,
without it, the SpMV alone (the padded form), and d = 9 with its Gram;
then d = 18 with its Gram, three start blocks, on the impurity preset (its
local zone's route), on the same rows all of the host's type (no zone)
and on the slab (four types in chunks), as ``chip_smoke.py`` phase 8
builds them.  Prints the card's name and power limit, each variant's
registers and spills, and its mean times.  Run it from the repository's
root.
"""

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
from chip_smoke import PRESET, cuda_ms, random_chains  # noqa: E402
from rslmtoasa_tpu_torch.models.presets import (  # noqa: E402
    build_synthetic_bcc,
    build_synthetic_impurity,
    build_synthetic_surface,
)
from rslmtoasa_tpu_torch.ops import block_kernels as bk  # noqa: E402
from rslmtoasa_tpu_torch.ops import cuda_build  # noqa: E402
from rslmtoasa_tpu_torch.ops.block_lanczos import BlockOperator  # noqa

OUT = "_checkout"
DEFAULT = ["gc3|D == 18 ? 6 : 9;|D == 18 ? 3 : 9;",
           "gc9|D == 18 ? 6 : 9;|9;"]


def build(name, source):
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, f"k4_{name}.cu")
    with open(src, "w") as fh:
        fh.write(source)
    lib = os.path.abspath(os.path.join(OUT, f"libk4_{name}.so"))
    res = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                          lib, src], capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
    print(name, "registers", re.findall(r"Used (\d+) registers", log),
          "spill stores", re.findall(r"(\d+) bytes spill stores", log),
          flush=True)
    return lib


def main(specs):
    shipped = open(bk.SOURCE).read()
    sources = {"shipped": shipped}
    for spec in specs:
        name, old, new = spec.split("|")
        if old not in shipped:
            raise ValueError(f"{name}: {old!r} is not in the source")
        sources[name] = shipped.replace(old, new)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build, sources, sources.values())))

    dev = torch.device("cuda", 0)
    soc = build_synthetic_bcc(device=dev, nsp=2, **PRESET)
    hb, kk = soc.ham, soc.cluster.kk
    ops = {18: BlockOperator(hb.ee, hb.iz, hb.cols, hb.lsham).to(dev),
           9: BlockOperator(hb.ee[..., :9, :9], hb.iz, hb.cols,
                            hb.lsham[..., :9, :9]).to(dev)}
    psi = {d: random_chains(kk, d, 11, dev, d=d) for d in ops}
    op18 = ops[18]
    forms = {
        "d18 gram": lambda: op18(psi[18], gram=True),
        "d18 no gram": lambda: op18(psi[18]),
        "d18 spmv only": lambda: bk.block_step(op18.hs, op18.iz, op18.cols,
                                               psi[18], pad=True),
        "d9 gram": lambda: ops[9](psi[9], gram=True)}
    # the impurity's combined table, the same rows without a zone, the slab
    imp = build_synthetic_impurity(device="cpu", nsp=2, lld=16)
    slab = build_synthetic_surface(device="cpu", nsp=2, lld=16)
    hb, kk = imp.ham, imp.cluster.kk
    blocks, _, iz_rows, iz_sp, nmax = imp._spmv_tables()
    more = {"impurity": BlockOperator(blocks, iz_rows, hb.cols, hb.lsham,
                                      iz_onsite=iz_sp, nmax=nmax),
            "impurity rows, no zone": BlockOperator(
                hb.ee[:1], np.zeros(kk, np.int32), hb.cols, hb.lsham[:1]),
            "slab": BlockOperator(slab.ham.ee, slab.ham.iz, slab.ham.cols,
                                  slab.ham.lsham)}
    for what, op in more.items():
        op = ops[what] = op.to(dev)
        psi[what] = random_chains(op.kk, 54, 11, dev, d=18)
        forms[f"{what} R=3"] = (lambda op=op, p=psi[what]: op(p, gram=True))
    ref = {d: ops[d](psi[d], gram=True, plain=True) for d in ops}
    times = {n: {f: [] for f in forms} for n in libs}
    for name in list(libs) + list(libs)[::-1]:
        bk.LIBRARY = libs[name]
        bk._library.cache_clear()
        for d, op in ops.items():
            y, g = op(psi[d], gram=True)
            torch.cuda.synchronize()
            for got, want in ((y, ref[d][0]), (g, ref[d][1])):
                err = float((got - want).abs().max())
                if err > 1e-12 * float(want.abs().max()):
                    raise RuntimeError(f"{name} {d}: error {err}")
        for form, fn in forms.items():
            times[name][form].append(cuda_ms(fn))
    for name, by_form in times.items():
        print(name, "; ".join(f"{f} {sum(v) / len(v):.4f} ms" for f, v in
                              by_form.items()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or DEFAULT)
