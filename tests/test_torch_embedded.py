"""The port's surface and impurity SCF against the JAX package's (CPU).

Presets, both packages built alike from the bcc preset (the JAX side from
its public functions: ``synthetic_bcc_config``, ``synthetic_bcc_atom``,
``bravais_cluster``, ``build_surf_full`` / ``newclu``, ``neighbor_map``,
``sbar_for_cluster``; the port through ``BulkSystem.build``): a bcc(001)
slab at ``rc=12`` with three surface layers (kk = 218, four types, three
rec atoms), and the bcc host at ``rc=12`` with three impurities (kk = 338,
a local zone of ``nmax`` = 60 atoms), lld 8; type k has its band centres
moved by ``k * BAND_SHIFT``.

* geometry equal; the surface Madelung, ``surfpot`` and ``imppot`` within
  1e-12;
* block ``a_b`` / ``b2_b`` within 1e-10 and Chebyshev moments within 1e-10
  of scale, nsp 1 and 2, HoH off and on; the same from the JAX system's
  arrays carried across by ``convert``;
* one SCF iteration: ql and mom within 1e-10, the (fixed) Fermi level
  equal, etot within 1e-9 or else the atomic-sphere solver's own
  difference (it stops unconverged and turns inputs 1e-16 apart into etot
  up to 5e-8 apart: its inputs of both runs agree within 1e-10, and the
  JAX package's solver on the port's inputs gives the port's etot); the
  written files within 1e-6, one unit of the last printed digit allowed
  (``test_torch_block``);
* K4's route for the impurity's local zone: its plan, and its packed tables
  through ``spmv_packed_ref`` against the plain product;
* both command-line drivers on a surface and an impurity input; the user
  ``lattice.nml`` bookkeeping ignored outside the bulk, as in the JAX
  package; the scalar recursion and ``newclusurf`` refused.
"""

import copy
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rslmtoasa_tpu import native as jnative
from rslmtoasa_tpu.cli import _main_inner as jax_cli
from rslmtoasa_tpu.config import JobConfig as JaxConfig
from rslmtoasa_tpu.geometry import bravais_cluster as jbravais
from rslmtoasa_tpu.geometry import neighbor_map as jneighbors
from rslmtoasa_tpu.geometry import primitive_cell as jcell
from rslmtoasa_tpu.geometry import sbar_for_cluster as jsbar
from rslmtoasa_tpu.geometry.cluster import newclu as jnewclu
from rslmtoasa_tpu.geometry.surface import build_surf_full as jsurf
from rslmtoasa_tpu.models import presets as jpresets
from rslmtoasa_tpu.models.bulk import BulkSystem as JaxBulk
from rslmtoasa_tpu.models.scf import SelfConsistency as JaxSCF
from rslmtoasa_tpu.physics.energy_mesh import EnergyMesh as JaxMesh
from rslmtoasa_tpu.physics.madelung import imppot as jimppot
from rslmtoasa_tpu.physics.madelung_surf import surfpot as jsurfpot
from rslmtoasa_tpu.utils.namelist import parse_namelists as jparse
from rslmtoasa_tpu.utils.namelist import read_namelists as jread
from rslmtoasa_tpu_torch import native
from rslmtoasa_tpu_torch.cli import main as torch_cli
from rslmtoasa_tpu_torch.config import JobConfig
from rslmtoasa_tpu_torch.convert import system_from_numpy, system_to_numpy
from rslmtoasa_tpu_torch.models import presets
from rslmtoasa_tpu_torch.models.bulk import BulkSystem
from rslmtoasa_tpu_torch.models.scf import SelfConsistency
from rslmtoasa_tpu_torch.ops import block_kernels as bk
from rslmtoasa_tpu_torch.ops import haydock_kernels as hk
from rslmtoasa_tpu_torch.utils.namelist import read_namelists, write_namelist
from test_torch_block import _assert_printed_close

CPU = torch.device("cpu")
RC, LLD = 12.0, 8
NE = 200  # energy points of the SCF tests (the preset has 2500)
WINDOW = (-1.5, 1.0)  # the Chebyshev window of test_torch_block


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch intra-op thread per xdist worker, as in
    ``test_torch_block`` (the batched CPU inverses oversubscribe)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ----------------------------------------------------------------------
# the presets, built by each package
def _config(kind, nsp, hoh):
    cfg = presets.synthetic_embedded_config(kind, RC, LLD, nsp)
    cfg.hamiltonian.hoh = hoh
    cfg.energy.channels_ldos = NE
    return cfg


def _chebyshev(*systems):
    """Switch the systems' configs to the Chebyshev recursion in WINDOW."""
    for sys_ in systems:
        sys_.cfg.control.recur = "chebyshev"
        sys_.cfg.energy.energy_min, sys_.cfg.energy.energy_max = WINDOW


def _jax_config(cfg):
    """The JAX package's config with the port config's settings."""
    jcfg = jpresets.synthetic_bcc_config(rc=RC, ndim=cfg.lattice.ndim,
                                         lld=LLD, nsp=cfg.control.nsp)
    for group in ("calculation", "control", "lattice", "atoms", "energy",
                  "hamiltonian"):
        src, dst = getattr(cfg, group), getattr(jcfg, group)
        for k, v in vars(src).items():
            setattr(dst, k, copy.deepcopy(v))
    if cfg.control.calctype == "S":
        jcfg.namelists = jparse(presets.SLAB_CHARGE)
    return jcfg


def _jax_system(cfg):
    """The JAX package's system for the port config ``cfg``, from its
    public functions."""
    jcfg = _jax_config(cfg)
    lat = jcfg.lattice
    cell = jcell("bcc")
    cl = jbravais(cell, alat=lat.alat, rc=lat.rc, ndim=lat.ndim, wav=lat.wav,
                  calctype=jcfg.control.calctype)
    cl._ct1 = float(lat.ct[0])
    if jcfg.control.calctype == "S":
        cl = jsurf(cl, lat.surftype, lat.nlay, cell.ntot)
    else:
        cl = jnewclu(cl, lat.inclu, cell.ntot)
    jneighbors(cl, ct1=float(lat.ct[0]))
    sys_ = JaxBulk(cfg=jcfg)
    sys_.cluster = cl
    sys_.sbars, sys_.sbarvecs = jsbar(cl.cr_ang, cl.iu, cl.wav, lat.r2)
    for k, label in enumerate(jcfg.atoms.labels):
        at = jpresets.synthetic_bcc_atom(label)
        for a in (at.potential.center_band, at.potential.enu, at.potential.c):
            a += k * presets.BAND_SHIFT
        sys_.atoms.append(at)
    sys_.emesh = JaxMesh.build(jcfg.energy)
    sys_.build_hamiltonian()
    return sys_


_SYSTEMS = {}


def _pair(kind, nsp, hoh):
    """(JAX system, port system) of one preset, built once per module and
    handed out as copies."""
    key = (kind, nsp, hoh)
    if key not in _SYSTEMS:
        cfg = _config(kind, nsp, hoh)
        _SYSTEMS[key] = (_jax_system(cfg), presets.build_synthetic_embedded(
            cfg, hoh, device="cpu"))
    return copy.deepcopy(_SYSTEMS[key])


# ----------------------------------------------------------------------
# geometry and electrostatics
@pytest.mark.parametrize("kind", ["S", "I"])
def test_geometry_matches_jax(kind):
    jsys, psys = _pair(kind, 2, False)
    jc, pc = jsys.cluster, psys.cluster
    assert pc.kk == (218 if kind == "S" else 338)
    for k in ("cr", "iz", "num", "irec", "ib", "iu", "atlist", "nn"):
        assert np.array_equal(getattr(pc, k), getattr(jc, k)), k
    for k in ("kk", "ntype", "nbulk", "nrec", "nmax", "nbas"):
        assert getattr(pc, k) == getattr(jc, k), k
    if kind == "S":
        assert pc.nrec == 3 and pc.ntype == 4 and pc.nmax == 0
        assert np.array_equal(pc.natoms_layer, jc.natoms_layer)
        assert np.array_equal(pc.miller, jc.miller)
    else:
        assert pc.nmax == 60 and pc.nrec == 3
        assert np.array_equal(pc.chargetrf_type, jc.chargetrf_type)
        for k in ("blocks", "iz_eff", "hall"):
            assert np.array_equal(getattr(psys.ham, k), getattr(jsys.ham, k))


@pytest.mark.parametrize("kind", ["S", "I"])
def test_electrostatics_match_jax(kind):
    """The surface Madelung matrix and ``surfpot``'s shifts, or ``impmad``
    and ``imppot``'s, within 1e-12 on seeded charge transfers."""
    jsys, psys = _pair(kind, 2, False)
    jscf, pscf = JaxSCF(jsys, workdir="."), SelfConsistency(psys, ".")
    if kind == "S":
        assert np.abs(pscf.smad.dss - jscf.smad.dss).max() <= 1e-12
    else:
        assert np.abs(pscf.amad_imp - jscf.amad_imp).max() <= 1e-12
    dq = np.random.default_rng(3).uniform(-0.05, 0.05, len(pscf.iz_rec))
    pscf.electrostatics(dq)
    cl = jsys.cluster
    if kind == "S":
        vmix = float(jsys.cfg.namelists.get("charge").get_scalar("vmix"))
        assert vmix == 0.05
        jsurfpot(jscf.smad, dq, cl.natoms_layer, int(jsys.cfg.lattice.nlay),
                 jsys.atoms, jscf.iz_rec, cl.nbulk, vmix=vmix)
    else:
        bulk = np.array([jsys.atoms[t].potential.ql[0].sum()
                         - jsys.atoms[t].element.valence
                         for t in range(cl.nbulk)])
        jimppot(jscf.amad_imp, dq, bulk, cl.chargetrf_type, jsys.atoms,
                jscf.iz_rec, cl.nbulk)
    for isp in pscf.iz_rec:
        want = jsys.atoms[isp].potential.vmad
        assert want != 0.0
        assert abs(psys.atoms[isp].potential.vmad - want) <= 1e-12


# ----------------------------------------------------------------------
# the recursions
RECURSIONS = [(kind, nsp, hoh, recur) for kind in ("S", "I")
              for nsp in (1, 2) for hoh in (False, True)
              for recur in ("block", "chebyshev")]


def _coefficients(sys_, recur):
    if recur == "block":
        return sys_.run_block()
    window = SimpleNamespace(energy_min=WINDOW[0], energy_max=WINDOW[1])
    return (sys_.run_chebyshev(window),)


@pytest.mark.parametrize("kind,nsp,hoh,recur", RECURSIONS)
def test_recursion_matches_jax(kind, nsp, hoh, recur):
    jsys, psys = _pair(kind, nsp, hoh)
    want = _coefficients(jsys, recur)
    got = _coefficients(psys, recur)
    nrec = len(psys.cluster.irec)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.shape[1:] == (nrec, 18, 18)
        bar = 1e-10 if recur == "block" else 1e-10 * np.abs(w).max()
        assert np.abs(g - w).max() <= bar


@pytest.mark.parametrize("kind", ["S", "I"])
def test_carried_state_gives_jax_coefficients(kind):
    """The JAX system's arrays (its Hamiltonian with HoH, an impurity's
    combined tables among them) carried into the port by ``convert``: the
    port's block recursion gives the JAX package's coefficients."""
    jsys, _ = _pair(kind, 2, True)
    arrays, pots = system_to_numpy(jsys)
    if kind == "I":
        assert {"ham_blocks", "ham_blocks_o", "ham_iz_eff", "nbas",
                "chargetrf_type"} <= set(arrays)
    else:
        assert {"natoms_layer", "miller"} <= set(arrays)
    psys = system_from_numpy(arrays, pots, CPU, cfg=_config(kind, 2, True))
    assert psys.cluster.nmax == jsys.cluster.nmax
    for got, want in zip(psys.run_block(), jsys.run_block()):
        assert np.abs(got - np.asarray(want)).max() <= 1e-10


# ----------------------------------------------------------------------
# one SCF iteration
SCF_CASES = ["S-block", "S-block-hoh", "S-chebyshev", "S-nsp1-block",
             "I-block", "I-block-hoh", "I-chebyshev", "I-nsp1-block-hoh"]


@pytest.fixture(scope="module", params=SCF_CASES)
def scf_pair(request, tmp_path_factory, monkeypatch_module):
    kind, *rest = request.param.split("-")
    jsys, psys = _pair(kind, 1 if "nsp1" in rest else 2, "hoh" in rest)
    if "chebyshev" in rest:
        _chebyshev(jsys, psys)
    calls = {"jax": [], "torch": []}  # each package's solver calls

    def recorder(solve, into):
        def recording(**kw):
            into.append(copy.deepcopy(kw))
            return solve(**kw)
        return recording

    for pkg, mod in (("jax", jnative), ("torch", native)):
        monkeypatch_module.setattr(mod, "atomsc_native",
                                   recorder(mod.atomsc_native, calls[pkg]))
    out = []
    for pkg, sys_, cls in (("jax", jsys, JaxSCF),
                           ("torch", psys, SelfConsistency)):
        work = tmp_path_factory.mktemp(f"{pkg}-{request.param}")
        scf = cls(sys_, workdir=str(work))
        scf.run(nstep=1)
        out.append(dict(
            etot=np.array([sys_.atoms[i].potential.etot
                           for i in scf.iz_rec]),
            ql=np.array([sys_.atoms[i].potential.ql for i in scf.iz_rec]),
            mom=np.array([sys_.atoms[i].potential.mom for i in scf.iz_rec]),
            fermi=scf.fermi, delta=scf.state.delta, dir=work,
            solver=calls[pkg]))
    monkeypatch_module.undo()
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_scf_scalars_match_jax(scf_pair):
    ref, got = scf_pair
    assert got["fermi"] == ref["fermi"]  # fixed for 'S' and 'I'
    assert np.abs(got["ql"] - ref["ql"]).max() <= 1e-10
    assert np.abs(got["mom"] - ref["mom"]).max() <= 1e-10
    assert abs(got["delta"] - ref["delta"]) <= 1e-10
    assert np.isfinite(got["etot"]).all() and (got["etot"] < -2000).all()
    for n, (e, e0) in enumerate(zip(got["etot"], ref["etot"])):
        if abs(e - e0) <= 1e-9:
            continue
        # The atomic-sphere solver's own difference: it stops unconverged
        # and turns inputs 1e-16 apart into etot up to 5e-8 apart.  Its
        # inputs agree (ql and pl within the ql bar, the rest equal), and
        # the JAX package's solver on the port's inputs gives its etot.
        kw, kw0 = got["solver"][n], ref["solver"][n]
        for k in kw:
            d = np.abs(np.asarray(kw[k]) - np.asarray(kw0[k])).max()
            assert d <= (1e-10 if k in ("ql", "pl") else 0.0), k
        assert jnative.atomsc_native(**kw).etot == e


def test_scf_outputs_match_jax(scf_pair):
    ref, got = scf_pair
    files = sorted(os.listdir(got["dir"]))
    assert files == sorted(os.listdir(ref["dir"]))
    assert {"totaldos.out", "X_out.nml"} <= set(files)
    for fname in files:
        _assert_printed_close(ref["dir"] / fname, got["dir"] / fname)


# ----------------------------------------------------------------------
# K4's route for the local zone
@pytest.mark.parametrize("nclu", [1, 3])
@pytest.mark.parametrize("d", [9, 18])
def test_local_zone_plan(d, nclu):
    """The rows of whole tiles up to ``nmax`` are local; the tiles past
    them use only the species present there, renumbered."""
    inclu = presets.IMPURITIES[:nclu]
    cfg = presets.synthetic_embedded_config("I", RC, LLD, 2, inclu=inclu)
    hb = presets.build_synthetic_embedded(cfg, device="cpu").ham
    nmax = 15 if nclu == 1 else 60
    assert hb.blocks.shape[0] == nmax + 1 + nclu
    iz, izo = torch.from_numpy(hb.iz_eff), torch.from_numpy(
        hb.iz.astype(np.int32))
    zone = bk.local_zone(nmax, d, iz, hb.blocks.shape[0], izo, 1 + nclu)
    rt = bk.rows_per_tile(d)
    assert zone.nl % rt == 0 and zone.nl - rt < nmax <= zone.nl
    assert zone.nl == {(18, 1): 16, (9, 1): 32, (18, 3): 64, (9, 3): 64}[
        d, nclu]
    # the host's one species beyond the zone, in both tables
    assert zone.types.tolist() == [nmax] and zone.otypes.tolist() == [0]
    assert torch.equal(zone.types[zone.iz[zone.nl:].long()],
                       iz[zone.nl:].long())
    assert torch.equal(zone.otypes[zone.izo[zone.nl:].long()],
                       izo[zone.nl:].long())
    assert not zone.iz[:zone.nl].any() and not zone.izo[:zone.nl].any()
    assert bk.local_zone(0, d, iz, hb.blocks.shape[0], izo, 1) is None


@pytest.mark.parametrize("d", [9, 18])
def test_local_zone_tables_match_plain(d):
    """The combined table packed for the local tiles and the compacted one
    for the rest, multiplied as the kernel's fragments combine (each on
    its rows), give the plain product of the combined table within 1e-13
    of scale; the onsite tables alike."""
    hb = presets.build_synthetic_embedded(
        presets.synthetic_embedded_config("I", RC, LLD, 2),
        device="cpu").ham
    sl = slice(0, d)
    tab = torch.from_numpy(np.ascontiguousarray(hb.blocks[..., sl, sl]))
    onsite = torch.from_numpy(np.ascontiguousarray(hb.lsham[..., sl, sl]))
    iz = torch.from_numpy(hb.iz_eff)
    izo = torch.from_numpy(hb.iz.astype(np.int32))
    cols = torch.from_numpy(hb.cols)
    kk = cols.shape[0]
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((kk + 1, d, 2 * d))
                         + 1j * rng.standard_normal((kk + 1, d, 2 * d)))
    x[kk] = 0.0
    zone = bk.local_zone(60, d, iz, tab.shape[0], izo, onsite.shape[0])
    nl = zone.nl

    def routed(local, rest, i, i_rest, c):
        """Rows below nl through the whole packed table, the rest through
        the compacted one (a single type here)."""
        assert rest.shape[0] == 1
        return torch.cat([hk.spmv_packed_ref(local, i[:nl], c[:nl], x),
                          hk.spmv_packed_ref(rest, i_rest[nl:], c[nl:], x)])

    want = bk.block_spmv(tab, iz, cols, x)
    got = routed(bk.pack_table(tab), zone.pack(tab), iz, zone.iz, cols)
    assert (got - want).abs().max() <= 1e-13 * want.abs().max()
    want = torch.einsum("iab,ibc->iac", onsite[izo.long()], x[:kk])
    got = routed(bk.pack_onsite(onsite), zone.pack_onsite(onsite), izo,
                 zone.izo, torch.arange(kk, dtype=torch.int32)[:, None])
    assert (got - want).abs().max() <= 1e-13 * want.abs().max()


def test_impurity_scf_counts_its_recursions(monkeypatch, tmp_path):
    """The impurity's HoH block SCF, collinear: one H application is two
    K4 calls (their plain version on the CPU) per spin sector:
    2 * (lld - 1) * 2."""
    calls = []
    ref = bk.block_step_ref

    def spy(*args, **kw):
        calls.append(1)
        return ref(*args, **kw)

    monkeypatch.setattr(bk, "block_step_ref", spy)
    _, psys = _pair("I", 1, True)
    SelfConsistency(psys, workdir=str(tmp_path)).run(nstep=1)
    assert len(calls) == 2 * (LLD - 1) * 2


# ----------------------------------------------------------------------
# the entry points
def _input_text(cfg, nstep=1, crystal_sym=None):
    lat, en = cfg.lattice, cfg.energy
    lattice = {"rc": lat.rc, "ndim": lat.ndim, "alat": lat.alat,
               "wav": lat.wav, "crystal_sym": crystal_sym or lat.crystal_sym,
               "ntype": lat.ntype, "r2": lat.r2, "ct": [lat.ct[0]]}
    if cfg.control.calctype == "S":
        lattice.update(surftype=lat.surftype, nlay=lat.nlay)
    else:
        lattice.update(nclu=lat.nclu, inclu=lat.inclu)
    return "".join([
        write_namelist("calculation", {
            "pre_processing": cfg.calculation.pre_processing}),
        write_namelist("control", {
            "calctype": cfg.control.calctype, "nsp": cfg.control.nsp,
            "lld": cfg.control.lld, "recur": cfg.control.recur}),
        write_namelist("lattice", lattice),
        write_namelist("atoms", {"database": "", "label": cfg.atoms.labels}),
        write_namelist("self", {"nstep": nstep}),
        write_namelist("energy", {
            "channels_ldos": en.channels_ldos, "energy_min": en.energy_min,
            "energy_max": en.energy_max, "fermi": en.fermi}),
        write_namelist("mix", {"beta": cfg.mix.beta,
                               "mixtype": cfg.mix.mixtype}),
        write_namelist("hamiltonian", {"hoh": cfg.hamiltonian.hoh}),
        presets.SLAB_CHARGE if cfg.control.calctype == "S" else "",
    ])


def _element_files(jsys, where):
    """One ``<label>.nml`` per type: the JAX package's checkpoints."""
    JaxSCF(jsys, workdir=str(where)).save_checkpoints()
    for label in jsys.cfg.atoms.labels:
        os.rename(where / f"{label}_out.nml", where / f"{label}.nml")


@pytest.mark.parametrize("case", ["S-block", "I-block-hoh"])
def test_cli_matches_jax_cli(tmp_path, capsys, case):
    kind, *rest = case.split("-")
    cfg = _config(kind, 2, "hoh" in rest)
    src = tmp_path / "src"
    src.mkdir()
    _element_files(_pair(kind, 2, "hoh" in rest)[0], src)
    (src / "input.nml").write_text(_input_text(cfg))
    parsed = JobConfig.from_namelists(read_namelists(str(src / "input.nml")))
    assert parsed.control.calctype == kind
    if kind == "I":
        assert np.array_equal(parsed.lattice.inclu, presets.IMPURITIES)
    dirs = {}
    for name in ("jax", "torch"):
        dirs[name] = tmp_path / name
        shutil.copytree(src, dirs[name])
    inp = lambda name: str(dirs[name] / "input.nml")  # noqa: E731
    assert jax_cli([inp("jax"), f"output={dirs['jax']}"]) == 0
    assert torch_cli([inp("torch"), f"output={dirs['torch']}",
                      "device=cpu"]) == 0
    capsys.readouterr()
    files = set(os.listdir(dirs["torch"]))
    assert files == set(os.listdir(dirs["jax"]))
    assert {"totaldos.out", "report.out", "X_out.nml"} <= files
    for fname in sorted(files):
        _assert_printed_close(dirs["jax"] / fname, dirs["torch"] / fname)


def test_user_lattice_is_bulk_only(tmp_path):
    """A slab input with ``crystal_sym='file'`` and a ``lattice.nml``
    sidecar whose bookkeeping (``irec``, ``nrec``) differs from the slab's:
    both packages' ``BulkSystem.build`` take the slab's own, as the JAX
    package applies the sidecar's only for ``calctype='B'``."""
    cfg = _config("S", 2, False)
    jsys = _pair("S", 2, False)[0]
    _element_files(jsys, tmp_path)
    (tmp_path / "input.nml").write_text(_input_text(cfg, crystal_sym="file"))
    (tmp_path / "lattice.nml").write_text(write_namelist("lattice", {
        "ntot": 1, "nbas": 1, "nrec": 1, "irec": [1], "izp": [1],
        "a": np.array([[-0.5, 0.5, 0.5], [0.5, -0.5, 0.5],
                       [0.5, 0.5, -0.5]]).T,
        "crd": np.zeros((3, 1))}))
    inp = str(tmp_path / "input.nml")
    built = []
    for read, config, bulk, kw in (
            (jread, JaxConfig, JaxBulk, {}),
            (read_namelists, JobConfig, BulkSystem, {"device": "cpu"})):
        c = config.from_namelists(read(inp), fname=inp)
        c.atoms.database = str(tmp_path)
        assert c.lattice.crystal_sym == "file"
        built.append(bulk.build(c, str(tmp_path), **kw).cluster)
    jc, pc = built
    assert np.array_equal(pc.irec, jc.irec) and len(pc.irec) == 3
    assert np.array_equal(pc.iz, jc.iz) and pc.ntype == jc.ntype == 4
    assert np.array_equal(pc.irec, jsys.cluster.irec)


def test_scalar_path_and_newclusurf_raise():
    """The scalar recursion on a slab or an impurity, and an impurity in a
    slab, raise naming their ROADMAP queue-3 entry."""
    for kind in ("S", "I"):
        _, psys = _pair(kind, 1, False)
        psys.cfg.control.recur = "lanczos"
        with pytest.raises(NotImplementedError, match="queue 3"):
            SelfConsistency(psys, workdir=".")
        with pytest.raises(NotImplementedError, match="queue 3"):
            psys.run_lanczos()
    cfg = _config("I", 2, False)
    cfg.calculation.pre_processing = "newclusurf"
    with pytest.raises(NotImplementedError, match="queue 3"):
        BulkSystem.build(cfg, device="cpu")
