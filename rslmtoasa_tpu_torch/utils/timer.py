"""Hierarchical named wall-clock timers with a tree report.

Mirrors the reference's ``g_timer%start/stop`` + end-of-run report tree
(``source/timer.f90:37-59``, ``source/report.f90:34-60``): nested named
phases, per-node ncalls/sum/min/max/mean aggregation.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class _Node:
    name: str
    parent: Optional["_Node"] = None
    children: Dict[str, "_Node"] = field(default_factory=dict)
    ncalls: int = 0
    total: float = 0.0
    tmin: float = float("inf")
    tmax: float = 0.0
    _started: Optional[float] = None

    def child(self, name: str) -> "_Node":
        if name not in self.children:
            self.children[name] = _Node(name, parent=self)
        return self.children[name]


class Timer:
    def __init__(self) -> None:
        self.root = _Node("total")
        self.current = self.root
        self.root._started = time.perf_counter()

    def start(self, name: str) -> None:
        node = self.current.child(name)
        node._started = time.perf_counter()
        self.current = node

    def stop(self, name: str) -> None:
        node = self.current
        if node.name != name:
            # forgiving: unwind to the matching ancestor
            while node is not self.root and node.name != name:
                node = node.parent  # type: ignore
        dt = time.perf_counter() - (node._started or time.perf_counter())
        node.ncalls += 1
        node.total += dt
        node.tmin = min(node.tmin, dt)
        node.tmax = max(node.tmax, dt)
        self.current = node.parent or self.root

    @contextmanager
    def section(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

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
        total = time.perf_counter() - (self.root._started or 0.0)
        lines.append(f"{'total':<30s} {1:6d} {total:10.3f}")
        return "\n".join(lines)


g_timer = Timer()
