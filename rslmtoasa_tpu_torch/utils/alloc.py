"""Labelled allocation accounting (reference ``safe_alloc.f90`` :57-657).

The reference wraps every allocate/deallocate with a label registry and
prints a leak/usage report at exit.  This analogue tracks the big host
arrays (Hamiltonian tables, recursion outputs, Green functions) by label
plus the CUDA caching allocator's live bytes, and prints the same style
of report: per-label current/peak bytes and anything still alive at exit.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict


class AllocTracker:
    def __init__(self):
        self.current: Dict[str, int] = defaultdict(int)
        self.peak: Dict[str, int] = defaultdict(int)
        self.count: Dict[str, int] = defaultdict(int)

    # ------------------------------------------------------------------
    def track(self, label: str, obj) -> None:
        """Register array-like ``obj`` (anything with .nbytes) under
        ``label`` (g_safe_alloc%allocate)."""
        nbytes = int(getattr(obj, "nbytes", 0))
        self.current[label] += nbytes
        self.count[label] += 1
        if self.current[label] > self.peak[label]:
            self.peak[label] = self.current[label]

    def release(self, label: str, obj=None) -> None:
        """Unregister (g_safe_alloc%deallocate).  With obj=None the
        whole label is dropped."""
        if obj is None:
            self.current[label] = 0
            return
        self.current[label] -= int(getattr(obj, "nbytes", 0))
        if self.current[label] < 0:
            self.current[label] = 0

    # ------------------------------------------------------------------
    def device_bytes(self) -> int:
        """Bytes held by live tensors on the current CUDA device, or -1
        when no CUDA context exists (CPU-only runs)."""
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return -1
        return int(torch.cuda.memory_stats().get(
            "allocated_bytes.all.current", 0))

    # ------------------------------------------------------------------
    def report(self) -> str:
        """Usage report; labels still live are the leak candidates
        (safe_alloc report printed from main.f90 :74-75)."""
        lines = ["allocation report (bytes): label  live  peak  count"]
        for label in sorted(self.peak, key=lambda k: -self.peak[k]):
            lines.append(
                f"{label:40s} {self.current[label]:>12d} "
                f"{self.peak[label]:>12d} {self.count[label]:>6d}"
            )
        live = {k: v for k, v in self.current.items() if v > 0}
        if live:
            lines.append("still allocated at report time: "
                         + ", ".join(sorted(live)))
        dev = self.device_bytes()
        if dev >= 0:
            lines.append(f"live device buffers: {dev} bytes")
        return "\n".join(lines)


g_alloc = AllocTracker()
