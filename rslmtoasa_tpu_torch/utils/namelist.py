"""Fortran namelist reader/writer.

The reference code (rslmtoasa) drives everything from Fortran namelist files
(``input.nml`` plus per-element ``<label>.nml`` / ``<label>_out.nml``; see
reference ``source/os.f90:34-158`` and ``source/element.f90:65-100``).  This
module implements a small, dependency-free namelist dialect parser covering
everything those files use:

* ``&group ... /`` blocks (multiple groups per file, repeated groups merge),
* scalar assignments ``name = value``,
* indexed/sliced array assignments ``name(1) = v``, ``name(:, 2) = a, b, c``,
  ``name(1, :, 2) = ...``,
* value lists spanning multiple lines,
* Fortran literals: ``1.0d0`` / ``2.5E-3`` reals, ``T``/``F``/``.true.``,
  quoted strings with ``'``/``"``, repeat counts ``3*1.0``,
* ``!`` comments, trailing commas.

The public surface is :func:`read_namelists`, :func:`parse_namelists`,
:class:`NamelistGroup` (with array materialisation helpers mirroring how the
Fortran ``read(nml=...)`` fills pre-shaped arrays), and :func:`write_namelist`
used for checkpoint output files (reference ``source/namelist_generator.f90``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "Assignment",
    "NamelistGroup",
    "Namelists",
    "parse_namelists",
    "read_namelists",
    "write_namelist",
    "format_value",
]

# one index element in e.g. ``ql(1, :, 2)`` — an int (1-based) or ':' slice
Index = Union[int, str]


@dataclass
class Assignment:
    """One ``name(index) = values`` entry inside a namelist group."""

    name: str
    index: Optional[Tuple[Index, ...]]  # None for plain ``name = ...``
    values: List[Any]


class NamelistGroup:
    """An ordered collection of assignments for one ``&group``.

    Mirrors Fortran namelist-read semantics: assignments apply in file order
    on top of defaults, so later entries override earlier ones.
    """

    def __init__(self, name: str):
        self.name = name
        self.assignments: List[Assignment] = []

    def names(self) -> List[str]:
        return list({a.name for a in self.assignments})

    def has(self, key: str) -> bool:
        key = key.lower()
        return any(a.name == key for a in self.assignments)

    def get_scalar(self, key: str, default: Any = None) -> Any:
        """Last scalar value assigned to ``key`` (first element if a list)."""
        key = key.lower()
        val = default
        for a in self.assignments:
            if a.name == key and a.index is None:
                val = a.values[0] if len(a.values) == 1 else list(a.values)
            elif a.name == key and a.index is not None and all(
                i == 1 for i in a.index if i != ":"
            ) and ":" not in a.index:
                # ``name(1) = v`` on a scalar-ish usage
                val = a.values[0]
        return val

    def fill_array(self, key: str, arr: np.ndarray) -> np.ndarray:
        """Apply all assignments for ``key`` onto a pre-shaped array.

        ``arr`` is modified in place (and returned).  Index semantics follow
        Fortran: 1-based indices, column-major value filling for plain and
        sliced assignments, ``:`` means the whole extent of that dimension.
        """
        key = key.lower()
        for a in self.assignments:
            if a.name != key:
                continue
            _apply_assignment(arr, a)
        return arr

    def __repr__(self) -> str:  # pragma: no cover
        return f"NamelistGroup({self.name!r}, {len(self.assignments)} assignments)"


class Namelists(dict):
    """Mapping of group-name -> :class:`NamelistGroup` (lowercased keys)."""

    def group(self, name: str) -> NamelistGroup:
        return self.setdefault(name.lower(), NamelistGroup(name.lower()))

    def merge(self, other: "Namelists") -> "Namelists":
        for gname, grp in other.items():
            mine = self.group(gname)
            mine.assignments.extend(grp.assignments)
        return self


def _apply_assignment(arr: np.ndarray, a: Assignment) -> None:
    vals = a.values
    if a.index is None:
        # whole-array fill, Fortran column-major order
        flat = np.asarray(arr, order="F").reshape(-1, order="F")
        n = min(len(vals), flat.size)
        flat[:n] = vals[:n]
        arr[...] = flat.reshape(arr.shape, order="F")
        return
    # build numpy index: ints -> 0-based, ':' -> slice(None)
    idx: List[Any] = []
    for i, d in enumerate(a.index):
        if d == ":":
            idx.append(slice(None))
        else:
            idx.append(int(d) - 1)
    if len(idx) != arr.ndim:
        # Fortran allows name(k) on multi-d arrays (rare); treat as flat F-order offset
        if len(idx) == 1 and isinstance(idx[0], int):
            flat = arr.reshape(-1, order="F")
            start = idx[0]
            n = min(len(vals), flat.size - start)
            flat[start : start + n] = vals[:n]
            arr[...] = flat.reshape(arr.shape, order="F")
            return
        raise ValueError(f"index rank mismatch for {a.name}: {a.index} vs shape {arr.shape}")
    sub = arr[tuple(idx)]
    if not isinstance(sub, np.ndarray) or sub.ndim == 0:
        arr[tuple(idx)] = vals[0]
    else:
        flat = sub.reshape(-1, order="F")
        n = min(len(vals), flat.size)
        flat[:n] = vals[:n]
        arr[tuple(idx)] = flat.reshape(sub.shape, order="F")


# ------------------------------- parsing ---------------------------------

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<string>'(?:[^']|'')*'|"(?:[^"]|"")*")
      | (?P<repeat>\d+\*)
      | (?P<number>[+-]?(?:\d+\.?\d*|\.\d+)(?:[eEdD][+-]?\d+)?)
      | (?P<logical>\.true\.|\.false\.|\.t\.|\.f\.|[tTfF](?![\w.]))
      | (?P<comma>,)
      | (?P<word>[A-Za-z_][\w%]*)
    )
    """,
    re.VERBOSE,
)


def _strip_comment(line: str) -> str:
    """Remove a trailing ``!`` comment, respecting quoted strings."""
    out = []
    in_q: Optional[str] = None
    for ch in line:
        if in_q:
            out.append(ch)
            if ch == in_q:
                in_q = None
        elif ch in "'\"":
            in_q = ch
            out.append(ch)
        elif ch == "!":
            break
        else:
            out.append(ch)
    return "".join(out)


def _parse_value_token(tok: str) -> Any:
    t = tok.strip()
    if t.startswith("'") or t.startswith('"'):
        q = t[0]
        return t[1:-1].replace(q + q, q)
    tl = t.lower()
    if tl in (".true.", ".t.", "t"):
        return True
    if tl in (".false.", ".f.", "f"):
        return False
    # number
    t2 = tl.replace("d", "e")
    try:
        if re.fullmatch(r"[+-]?\d+", t2):
            return int(t2)
        return float(t2)
    except ValueError:
        return t  # bare word treated as string


_ASSIGN_RE = re.compile(
    r"^\s*([A-Za-z_]\w*)\s*(\(\s*[^)]*\s*\))?\s*=\s*(.*)$", re.DOTALL
)


def _parse_index(spec: Optional[str]) -> Optional[Tuple[Index, ...]]:
    if spec is None:
        return None
    inner = spec.strip()[1:-1]
    parts = [p.strip() for p in inner.split(",")]
    out: List[Index] = []
    for p in parts:
        if p == ":":
            out.append(":")
        else:
            out.append(int(p))
    return tuple(out)


def _parse_values(text: str) -> List[Any]:
    """Parse a comma/space-separated Fortran value list with repeat counts."""
    vals: List[Any] = []
    pos = 0
    pending_repeat = 1
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if not m:
            break
        pos = m.end()
        if m.lastgroup == "comma":
            continue
        if m.lastgroup == "repeat":
            pending_repeat = int(m.group("repeat")[:-1])
            continue
        tok = m.group(m.lastgroup)
        v = _parse_value_token(tok)
        vals.extend([v] * pending_repeat)
        pending_repeat = 1
    return vals


def parse_namelists(text: str) -> Namelists:
    """Parse all ``&group ... /`` blocks from ``text``."""
    nml = Namelists()
    lines = [_strip_comment(ln) for ln in text.splitlines()]
    i = 0
    cur: Optional[NamelistGroup] = None
    buf: List[str] = []  # accumulate statements of current group

    def flush_statements(body: str, grp: NamelistGroup) -> None:
        # split body into assignments: find ``name(... )? =`` anchors
        anchor = re.compile(r"[A-Za-z_]\w*\s*(?:\(\s*[^)]*\s*\))?\s*=")
        starts = [m.start() for m in anchor.finditer(body)]
        # filter out anchors that are inside a quoted string
        def in_string(idx: int) -> bool:
            q = None
            for j, ch in enumerate(body[:idx]):
                if q:
                    if ch == q:
                        q = None
                elif ch in "'\"":
                    q = ch
            return q is not None

        starts = [s for s in starts if not in_string(s)]
        starts.append(len(body))
        for s, e in zip(starts[:-1], starts[1:]):
            stmt = body[s:e].strip().rstrip(",")
            if not stmt:
                continue
            m = _ASSIGN_RE.match(stmt)
            if not m:
                continue
            name, idxspec, rhs = m.group(1).lower(), m.group(2), m.group(3)
            grp.assignments.append(
                Assignment(name=name, index=_parse_index(idxspec), values=_parse_values(rhs))
            )

    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if cur is None:
            m = re.match(r"^&(\w+)\s*(.*)$", line)
            if m:
                cur = nml.group(m.group(1))
                rest = m.group(2)
                if rest:
                    buf.append(rest)
            continue
        # inside a group: terminator is '/' or '&end' at statement level
        if line == "/" or line.lower() in ("&end", "$end"):
            flush_statements(" ".join(buf), cur)
            buf = []
            cur = None
            continue
        # a '/' may terminate at end of line too
        if line.endswith("/") and not line.endswith("'/") :
            buf.append(line[:-1])
            flush_statements(" ".join(buf), cur)
            buf = []
            cur = None
            continue
        if line:
            buf.append(line)
    if cur is not None:
        flush_statements(" ".join(buf), cur)
    return nml


def read_namelists(path: str) -> Namelists:
    with open(path, "r") as fh:
        return parse_namelists(fh.read())


# ------------------------------- writing ---------------------------------


def format_value(v: Any) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "T" if v else "F"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return f"'{v}'"


def write_namelist(name: str, entries: Dict[str, Any]) -> str:
    """Serialise ``entries`` as one ``&name ... /`` block.

    Values may be scalars, 1-d sequences (written as comma lists) or numpy
    arrays of rank >= 2 (written as one sliced assignment per trailing-index
    combination, matching the reference's output style, e.g.
    ``ql(1, :, 1) = ...``; see ``source/namelist_generator.f90:90-98``).
    """
    out = [f"&{name}"]
    for key, val in entries.items():
        arr = np.asarray(val) if not np.isscalar(val) and not isinstance(val, str) else None
        if arr is not None and arr.ndim >= 2:
            # write one line per combination of all-but-one leading dims:
            # choose to slice the second dimension like the reference does for
            # (l, spin) arrays: name(:, j) = row
            tail_shape = arr.shape[1:]
            for tail in np.ndindex(*tail_shape[::-1]):
                tail = tail[::-1]
                sl = arr[(slice(None),) + tail]
                idx = ", ".join([":"] + [str(t + 1) for t in tail])
                out.append(
                    f" {key}({idx}) = " + ", ".join(format_value(x) for x in sl)
                )
        elif arr is not None and arr.ndim == 1:
            out.append(f" {key} = " + ", ".join(format_value(x) for x in arr))
        else:
            out.append(f" {key} = {format_value(val)}")
    out.append("/")
    return "\n".join(out) + "\n"
