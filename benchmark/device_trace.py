"""What the device did in the traced window, from ``torch.profiler``.

The window is the host span ``bench.window`` that the harness opens around
its jobs; the device's activity is the union of the kernel, copy and set
intervals the profiler records inside it.  Gaps in that union are labelled
by the innermost host operation the profiler shows at the gap's middle.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

WINDOW = "bench.window"


class Trace:
    """``busy_s``, ``window_s``, device time by operation name, and the
    idle gaps, of one profiled window."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        host, dev = [], []
        t0 = t1 = None
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            if str(e.device_type()).endswith("CUDA"):
                # the host's annotations are mirrored on the device's
                # timeline; only kernels, copies and sets are device work
                if not (e.is_user_annotation() or e.name() == WINDOW):
                    dev.append((start, start + dur, e.name()))
            else:
                if e.name() == WINDOW:
                    t0, t1 = start, start + dur
                host.append((start, start + dur, e.name()))
        if t0 is None:
            raise RuntimeError(f"the profile holds no {WINDOW} span")
        self.window_s = (t1 - t0) * 1e-9
        by_name = defaultdict(float)
        spans = []
        for a, b, name in dev:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                by_name[name] += (b - a) * 1e-9
                spans.append((a, b))
        self.device_ops = sorted(by_name.items(), key=lambda x: -x[1])
        merged = []
        for a, b in sorted(spans):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-9
        edges = [t0] + [x for ab in merged for x in ab] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [h for h in host if h[2] != WINDOW]
        self._host_a = np.array([h[0] for h in host], dtype=np.int64)
        self._host_b = np.array([h[1] for h in host], dtype=np.int64)
        self._host_n = [h[2] for h in host]
        self.idle_gaps = [(self._label((a + b) // 2), (b - a) * 1e-9)
                          for a, b in gaps[:10]]

    def _label(self, t) -> str:
        """The shortest host operation that covers ``t``."""
        cover = np.nonzero((self._host_a <= t) & (self._host_b >= t))[0]
        if cover.size == 0:
            return "host, no torch operation"
        i = cover[np.argmin(self._host_b[cover] - self._host_a[cover])]
        return self._host_n[i]

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name holds ``pattern``."""
        return sum(s for n, s in self.device_ops if pattern in n)

    def breakdown(self) -> dict:
        return {"device_ops": [[n[:160], s] for n, s in self.device_ops[:10]],
                "idle_gaps": [[n[:160], s] for n, s in self.idle_gaps]}
