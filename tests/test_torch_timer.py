"""The port's span system (``utils/timer.py``) on the CPU.

* the tree's totals and ``ncalls`` under nesting, and the report's format;
* while a ``torch.profiler`` records, each section is a host range of its
  own name, nested in its parent's interval; without a profiler no range
  is opened;
* ``benchmark.device_trace.Trace`` names a host-only gap inside
  ``bench.window`` by the innermost section that covers it;
* the spans the benchmark reads: one block SCF iteration on the bcc preset
  (``scf-iteration``, ``bands``, ``scf-output``, ``atomic-scf``,
  ``terminators``), a recursion with ``RSLMTO_WAVEFRONT_KK`` lowered
  (``wavefront-plan``), a Jij table (``jij-table``, ``terminators``,
  ``jij-twoindex``), and the CLI's ``RSLMTO_PROFILE`` trace.
"""

import json
import re
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.device_trace import WINDOW, Trace
from rslmtoasa_tpu_torch import cli
from rslmtoasa_tpu_torch.models import presets
from rslmtoasa_tpu_torch.models.exchange import ExchangeCalculation
from rslmtoasa_tpu_torch.models.scf import SelfConsistency
from rslmtoasa_tpu_torch.utils import timer as timer_mod
from rslmtoasa_tpu_torch.utils.timer import Timer, g_timer

BCC = dict(rc=8.0, ndim=2000, lld=8, nsp=2)


def _fresh(monkeypatch):
    """``g_timer`` with an empty tree from here on; the old one after the
    test."""
    root = timer_mod._Node("total")
    monkeypatch.setattr(g_timer, "root", root)
    monkeypatch.setattr(g_timer, "current", root)
    return g_timer


def _nodes(node, path=""):
    """{path: node} of the tree below ``node``."""
    out = {}
    for ch in node.children.values():
        p = f"{path}/{ch.name}" if path else ch.name
        out[p] = ch
        out.update(_nodes(ch, p))
    return out


def _calls(timer) -> dict:
    """{section name: ncalls summed over the tree}."""
    out = {}
    for p, n in _nodes(timer.root).items():
        name = p.split("/")[-1]
        out[name] = out.get(name, 0) + n.ncalls
    return out


def _children_within_parents(timer):
    for node in _nodes(timer.root).values():
        kids = sum(ch.total for ch in node.children.values())
        assert kids <= node.total, node.name


# ----------------------------------------------------------------------
# the tree
def test_totals_and_calls_under_nesting():
    t = Timer()
    for _ in range(3):
        with t.section("outer"):
            with t.section("inner"):
                time.sleep(0.002)
            with t.section("inner"):
                pass
    with t.section("inner"):  # a root-level node of the same name
        pass
    outer = t.root.children["outer"]
    inner = outer.children["inner"]
    assert outer.ncalls == 3 and inner.ncalls == 6
    assert t.root.children["inner"].ncalls == 1
    assert inner.total >= 3 * 0.002 and inner.total <= outer.total
    assert inner.tmin <= inner.tmax and outer.tmin >= 0.002
    assert t.current is t.root


def test_section_unwinds_on_an_exception():
    t = Timer()
    with pytest.raises(ValueError):
        with t.section("outer"):
            with t.section("inner"):
                raise ValueError("x")
    assert t.current is t.root
    assert t.root.children["outer"].children["inner"].ncalls == 1
    assert t.root.children["outer"].ncalls == 1


def test_report_format():
    t = Timer()
    with t.section("a"):
        with t.section("b"):
            pass
    t.root.children["c"] = timer_mod._Node("c")  # never run
    lines = t.report().split("\n")
    assert lines[0] == "timing report (s): name  ncalls  total  mean  min  max"
    a = t.root.children["a"]
    b = a.children["b"]
    assert lines[1] == (f"{'a':<30s} {1:6d} {a.total:10.3f} {a.total:10.3f}"
                        f" {a.tmin:10.3f} {a.tmax:10.3f}")
    assert lines[2] == (f"  {'b':<30s} {1:6d} {b.total:10.3f} "
                        f"{b.total:10.3f} {b.tmin:10.3f} {b.tmax:10.3f}")
    assert lines[3] == (f"{'c':<30s} {0:6d} {0.0:10.3f} {0.0:10.3f} "
                        f"{0.0:10.3f} {0.0:10.3f}")
    assert re.fullmatch(r"total {31}1 +\d+\.\d{3}", lines[4]), lines[4]
    assert len(lines) == 5


# ----------------------------------------------------------------------
# the profiler's ranges
def _host_events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_sections_are_host_ranges_nested_as_the_tree():
    t = Timer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.section("outer"):
            torch.ones(4).sum()
            with t.section("inner"):
                torch.ones(4).sum()
    ev = {n: (a, b) for n, a, b in _host_events(prof)
          if n in ("outer", "inner")}
    assert set(ev) == {"outer", "inner"}
    (oa, ob), (ia, ib) = ev["outer"], ev["inner"]
    assert oa <= ia < ib <= ob
    assert t.root.children["outer"].children["inner"].ncalls == 1


def test_no_range_without_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    t = Timer()
    with t.section("outer"):
        with t.section("inner"):
            pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with t.section("outer"):
            with t.section("inner"):
                pass
    assert opened == ["outer", "inner"]


def test_trace_names_a_host_gap_by_the_innermost_span():
    t = Timer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW):
            with t.section("scf-iteration"):
                with t.section("atomic-scf"):
                    time.sleep(0.05)
    gaps = Trace(prof).idle_gaps
    assert gaps and gaps[0][0] == "atomic-scf", gaps
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW):
            time.sleep(0.05)
    assert Trace(prof).idle_gaps[0][0] == "host, no torch operation"


# ----------------------------------------------------------------------
# the program's spans
def test_block_scf_iteration_spans(monkeypatch, tmp_path):
    sys_ = presets.build_synthetic_bcc(device="cpu", **BCC)
    assert sys_.cfg.control.recur == "block"
    scf = SelfConsistency(sys_, workdir=str(tmp_path))
    fresh = _fresh(monkeypatch)
    scf.run(nstep=1)
    calls = _calls(fresh)
    want = {"scf-iteration": 1, "recursion-phase": 1, "build-bulkham": 1,
            "block-recursion": 1, "dos-phase": 1, "terminators": 1,
            "green-function": 1, "bands": 3, "scf-output": 2,
            "atomic-scf": 1}
    assert calls == want
    top = fresh.root.children
    assert list(top) == ["scf-iteration"]
    it = top["scf-iteration"]
    assert set(it.children) == {"recursion-phase", "dos-phase", "bands",
                                "atomic-scf", "scf-output"}
    assert set(it.children["dos-phase"].children) == {
        "terminators", "green-function", "bands", "scf-output"}
    _children_within_parents(fresh)


def test_wavefront_plan_span(monkeypatch):
    sys_ = presets.build_synthetic_bcc(device="cpu", **BCC)
    fresh = _fresh(monkeypatch)
    sys_.run_block()
    assert "wavefront-plan" not in _calls(fresh)
    monkeypatch.setenv("RSLMTO_WAVEFRONT_KK", "1")
    sys_.run_block()
    calls = _calls(fresh)
    assert calls["wavefront-plan"] == 1 and calls["block-recursion"] == 2
    plan = fresh.root.children["block-recursion"].children["wavefront-plan"]
    assert plan.total <= fresh.root.children["block-recursion"].total


def test_jij_table_spans(monkeypatch, tmp_path):
    sys_ = presets.build_synthetic_bcc(device="cpu", **dict(BCC, ndim=500))
    sys_.cfg.energy.channels_ldos = 200
    xc = ExchangeCalculation(sys_, [[1, 1], [1, 2]], str(tmp_path))
    fresh = _fresh(monkeypatch)
    xc.run()
    xc.calculate_exchange_twoindex()
    calls = _calls(fresh)
    assert calls == {"jij-table": 1, "build-bulkham": 1,
                     "pair-recursion": 1, "start-blocks": 1,
                     "terminators": 2, "intersite-gf": 1,
                     "jij-integrals": 1, "jij-twoindex": 1}
    table = fresh.root.children["jij-table"]
    assert "start-blocks" in table.children["pair-recursion"].children
    assert "terminators" in table.children
    assert "terminators" in table.children["intersite-gf"].children
    _children_within_parents(fresh)


def test_cli_profile_trace(tmp_path, monkeypatch, capsys):
    sys_ = presets.build_synthetic_exchange(nshell=2, device="cpu",
                                            **dict(BCC, ndim=500))
    sys_.cfg.energy.channels_ldos = 200
    src = tmp_path / "run"
    src.mkdir()
    presets.write_exchange_input(sys_, str(src))
    _fresh(monkeypatch)
    monkeypatch.setenv("RSLMTO_PROFILE", str(tmp_path / "prof"))
    assert cli.main([str(src / "input.nml"), f"output={src}",
                     "device=cpu"]) == 0
    assert "jij-table" in capsys.readouterr().out  # the report, as before
    with open(tmp_path / "prof" / "trace_rank0.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"jij-table", "pair-recursion", "terminators",
            "jij-twoindex"} <= names
    assert (src / "jij.out").exists()
