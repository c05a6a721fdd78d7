"""The benchmark's frozen copy of the paper's acyclic query
formulations (§5.1, Table 7).

Each pattern is its Datalog body as the program's ``core/query.py``
states it: binary ``edge`` atoms over a symmetric edge relation and
unary sample atoms ``v1``–``v4`` (a ``<`` filter, which the cyclic
shapes carry, is parsed too).  The plain reference counts from these
bodies alone.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

DATALOG = {
    "3-path": "v1(a), edge(a,b), edge(b,c), edge(c,d), v2(d)",
    "4-path": "v1(a), edge(a,b), edge(b,c), edge(c,d), edge(d,e), v2(e)",
    "1-tree": "edge(a,b), edge(a,c), v1(b), v2(c)",
    "2-comb": "edge(a,b), edge(a,c), edge(b,d), v1(c), v2(d)",
}


@dataclass(frozen=True)
class Pattern:
    name: str
    edges: tuple[tuple[str, str], ...]
    unary: tuple[tuple[str, str], ...]      # (relation, variable)
    less: tuple[tuple[str, str], ...]       # (left, right): left < right

    @property
    def variables(self) -> tuple[str, ...]:
        seen: dict[str, None] = {}
        for a, b in self.edges:
            seen.setdefault(a)
            seen.setdefault(b)
        for _, v in self.unary:
            seen.setdefault(v)
        return tuple(seen)


_ATOM = re.compile(r"(\w+)\(([^)]*)\)")
_LESS = re.compile(r"(\w+)\s*<\s*(\w+)")


def pattern(name: str) -> Pattern:
    """The pattern of ``name`` read from its Datalog body."""
    body = DATALOG[name]
    edges, unary = [], []
    for rel, args in _ATOM.findall(body):
        vs = tuple(v.strip() for v in args.split(","))
        if len(vs) == 2:
            edges.append(vs)
        else:
            unary.append((rel, vs[0]))
    return Pattern(name, tuple(edges), tuple(unary),
                   tuple(_LESS.findall(body)))
