"""How far the exchange run's Green functions on one device lie from the
CPU's on the same chains, against how far the CPU's own move when the
chains or the energies move by one unit in the last place.

    python tools/green_spread.py [DEVICE]

For the port's exchange preset (``presets.build_synthetic_exchange``: bcc,
``nsp=2``, the onsite pair of atom 1 and one pair in each of its first
five shells, 21 live chains) at box 10 with 310 energy points, block and
HoH, lld 12 and 20: one exchange run on the CPU gives the chains; their
Green functions (``ExchangeCalculation.intersite_gf``) come once on
``DEVICE`` (``cuda``, the default, or ``cpu``) and once on the CPU, and
again on the CPU from the chains times 1 + 2^-52 and 1 - 2^-52.  Prints
per configuration the largest difference over the scale (the largest
|G|), its ratio to 1e-12 of the scale plus that movement taken per
element and per energy (its largest over the elements at each energy),
and its ratio to ``chip_smoke.green_bar`` (the energies moved instead, by
one unit in the last place of the Hamiltonian's scale, times lld - 1).
A real-axis Green function has poles, so near one both the difference and
the movement grow.  Run it from the repository's root.
"""

import copy
import sys
import tempfile

import torch

sys.path.insert(0, ".")
from chip_smoke import green_bar  # noqa: E402
from rslmtoasa_tpu_torch.models.exchange import (  # noqa: E402
    ExchangeCalculation,
)
from rslmtoasa_tpu_torch.models.presets import (  # noqa: E402
    build_synthetic_exchange,
)
from rslmtoasa_tpu_torch.physics.energy_mesh import EnergyMesh  # noqa: E402

ULP = 2.0**-52


def main(device="cuda"):
    dev = torch.device(device)
    for lld in (12, 20):
        for hoh in (False, True):
            sys_ = build_synthetic_exchange(box=10, rc=120.0, ndim=10**6,
                                            lld=lld, nsp=2, hoh=hoh,
                                            device="cpu")
            sys_.cfg.energy.channels_ldos = 300
            em = EnergyMesh.build(sys_.cfg.energy)
            with tempfile.TemporaryDirectory() as work:
                cpu = ExchangeCalculation(sys_, sys_.cfg.lattice.ijpair,
                                          work)
                cpu.run()
            on_dev = copy.copy(cpu)
            on_dev.sys = copy.copy(sys_)
            on_dev.sys.device = dev
            on_dev.intersite_gf(em)
            got = on_dev.gij_full.cpu()
            want = cpu.gij_full.clone()
            spread = torch.zeros_like(want.real)
            for f in (1.0 + ULP, 1.0 - ULP):
                moved = copy.copy(cpu)
                moved.a_b, moved.b_b = cpu.a_b * f, cpu.b_b * f
                moved.intersite_gf(em)
                spread = torch.maximum(spread,
                                       (moved.gij_full - want).abs())
            diff = (got - want).abs()
            scale = float(want.abs().max())
            per_e = spread.amax(dim=(0, 1, 2), keepdim=True)
            bar = green_bar(copy.copy(cpu), em)[1]
            print(f"box 10 lld {lld} hoh {hoh} on {dev}: |dG|/scale "
                  f"{float(diff.max()) / scale:.3e}; ratio to 1e-12 scale "
                  f"+ one-ulp movement: per element "
                  f"{float((diff / (1e-12 * scale + spread)).max()):.3f}, "
                  f"per energy "
                  f"{float((diff / (1e-12 * scale + per_e)).max()):.3f}; "
                  f"to green_bar {float((diff / bar).max()):.4f}",
                  flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
