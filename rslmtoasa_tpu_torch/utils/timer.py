"""Hierarchical named wall-clock timers with a tree report.

Mirrors the reference's ``g_timer%start/stop`` + end-of-run report tree
(``source/timer.f90:37-59``, ``source/report.f90:34-60``): nested named
phases, per-node ncalls/sum/min/max/mean aggregation.

While a ``torch.profiler`` records, each section also opens a
``record_function`` range of its own name, nested as the sections are, so
the program's spans sit on the profiler's clock beside the device's kernels
and copies.  Without a profiler a section costs one flag check more.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch._C._autograd import _profiler_enabled


@dataclass
class _Node:
    name: str
    children: Dict[str, "_Node"] = field(default_factory=dict)
    ncalls: int = 0
    total: float = 0.0
    tmin: float = float("inf")
    tmax: float = 0.0

    def child(self, name: str) -> "_Node":
        if name not in self.children:
            self.children[name] = _Node(name)
        return self.children[name]


class Timer:
    def __init__(self) -> None:
        self.root = _Node("total")
        self.current = self.root
        self._t0 = time.perf_counter()

    @contextmanager
    def section(self, name: str):
        parent = self.current
        node = parent.child(name)
        self.current = node
        span = None
        if _profiler_enabled():
            span = torch.profiler.record_function(name)
            span.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t
            if span is not None:
                span.__exit__(None, None, None)
            node.ncalls += 1
            node.total += dt
            node.tmin = min(node.tmin, dt)
            node.tmax = max(node.tmax, dt)
            self.current = parent

    def report(self) -> str:
        lines = ["timing report (s): name  ncalls  total  mean  min  max"]

        def walk(node: _Node, depth: int) -> None:
            for ch in node.children.values():
                mean = ch.total / max(ch.ncalls, 1)
                lines.append(
                    f"{'  ' * depth}{ch.name:<30s} {ch.ncalls:6d} "
                    f"{ch.total:10.3f} {mean:10.3f} "
                    f"{(0.0 if ch.tmin == float('inf') else ch.tmin):10.3f} {ch.tmax:10.3f}"
                )
                walk(ch, depth + 1)

        walk(self.root, 0)
        total = time.perf_counter() - self._t0
        lines.append(f"{'total':<30s} {1:6d} {total:10.3f}")
        return "\n".join(lines)


g_timer = Timer()
