"""Join-query IR: atoms, inequality filters, and the paper's benchmark queries.

A (natural) join query ``Q = ⋈_{R ∈ atoms(Q)} R`` is a set of atoms, each a
relation symbol applied to a tuple of variables, plus (for symmetry breaking,
as in the paper's Datalog formulations) strict ``<`` filters between
variables.  Graph patterns are join queries over a binary ``edge`` relation
and unary sample predicates ``v1``, ``v2``, ...
"""
from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class Atom:
    """One relational atom ``rel(v_0, ..., v_{k-1})``."""

    rel: str
    vars: tuple[str, ...]

    @property
    def arity(self) -> int:
        return len(self.vars)

    def __str__(self) -> str:
        return f"{self.rel}({', '.join(self.vars)})"


@dataclass(frozen=True)
class LessThan:
    """Strict inequality filter ``left < right`` (symmetry breaking)."""

    left: str
    right: str

    def __str__(self) -> str:
        return f"{self.left}<{self.right}"


@dataclass(frozen=True)
class Query:
    """A join query: atoms + inequality filters + a display name."""

    atoms: tuple[Atom, ...]
    filters: tuple[LessThan, ...] = ()
    name: str = "query"

    @property
    def variables(self) -> tuple[str, ...]:
        """All variables, in first-appearance order."""
        seen: dict[str, None] = {}
        for a in self.atoms:
            for v in a.vars:
                seen.setdefault(v)
        return tuple(seen)

    @property
    def num_vars(self) -> int:
        return len(self.variables)

    def atoms_with(self, var: str) -> tuple[Atom, ...]:
        return tuple(a for a in self.atoms if var in a.vars)

    def relation_names(self) -> tuple[str, ...]:
        seen: dict[str, None] = {}
        for a in self.atoms:
            seen.setdefault(a.rel)
        return tuple(seen)

    def __str__(self) -> str:
        parts = [str(a) for a in self.atoms] + [str(f) for f in self.filters]
        return f"{self.name}: " + ", ".join(parts)


_ATOM_RE = re.compile(r"(\w+)\(([^)]*)\)")
_FILTER_RE = re.compile(r"^(\w+)\s*<\s*(\w+)$")


def parse(text: str, name: str = "query") -> Query:
    """Parse ``"edge(a,b), edge(b,c), edge(a,c), a<b, b<c"`` style strings."""
    atoms: list[Atom] = []
    filters: list[LessThan] = []
    # Split on commas not inside parens.
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    for part in parts:
        part = part.strip()
        if not part:
            continue
        m = _ATOM_RE.fullmatch(part)
        if m:
            rel = m.group(1)
            vs = tuple(v.strip() for v in m.group(2).split(",") if v.strip())
            atoms.append(Atom(rel, vs))
            continue
        m = _FILTER_RE.fullmatch(part)
        if m:
            filters.append(LessThan(m.group(1), m.group(2)))
            continue
        raise ValueError(f"cannot parse query fragment: {part!r}")
    return Query(tuple(atoms), tuple(filters), name)


# ---------------------------------------------------------------------------
# The paper's benchmark queries (§5.1), verbatim Datalog formulations.
# ---------------------------------------------------------------------------

def clique(k: int) -> Query:
    """k-clique with ``a1 < a2 < ... < ak`` symmetry breaking (paper)."""
    names = [chr(ord("a") + i) for i in range(k)]
    atoms = [Atom("edge", (names[i], names[j]))
             for i in range(k) for j in range(i + 1, k)]
    filters = [LessThan(names[i], names[i + 1]) for i in range(k - 1)]
    return Query(tuple(atoms), tuple(filters), f"{k}-clique")


def cycle(k: int) -> Query:
    """k-cycle; paper uses ``a<b<c<d`` for the 4-cycle."""
    names = [chr(ord("a") + i) for i in range(k)]
    atoms = [Atom("edge", (names[i], names[(i + 1) % k])) for i in range(k)]
    filters = [LessThan(names[i], names[i + 1]) for i in range(k - 1)]
    return Query(tuple(atoms), tuple(filters), f"{k}-cycle")


def path(k: int) -> Query:
    """k-path: v1(a0), v2(ak), chain of k edges.  3-path has 4 vars."""
    names = [chr(ord("a") + i) for i in range(k + 1)]
    atoms = [Atom("v1", (names[0],))]
    atoms += [Atom("edge", (names[i], names[i + 1])) for i in range(k)]
    atoms += [Atom("v2", (names[k],))]
    return Query(tuple(atoms), (), f"{k}-path")


def tree(n: int) -> Query:
    """n-tree: complete binary tree with 2^n leaves, each from its own sample.

    1-tree (paper): v1(b), v2(c), edge(a,b), edge(a,c).
    """
    if n == 1:
        return parse("edge(a,b), edge(a,c), v1(b), v2(c)", "1-tree")
    if n == 2:
        return parse(
            "edge(a,b), edge(a,c), edge(b,d), edge(b,e), edge(c,f), "
            "edge(c,g), v1(d), v2(e), v3(f), v4(g)",
            "2-tree",
        )
    raise ValueError("only 1-tree and 2-tree are benchmarked")


def comb(n: int) -> Query:
    """2-comb (paper): v1(c), v2(d), edge(a,b), edge(a,c), edge(b,d)."""
    if n != 2:
        raise ValueError("only the 2-comb is benchmarked")
    return parse("edge(a,b), edge(a,c), edge(b,d), v1(c), v2(d)", "2-comb")


def lollipop(n: int) -> Query:
    """n-lollipop: n-path followed by an (n+1)-clique (paper §4.12).

    2-lollipop: v1(a), edge(a,b), edge(b,c) + 3-clique on (c,d,e), d<e.
    3-lollipop: v1(a), 3-path to d + 4-clique on (d,e,f,g), e<f<g.
    """
    if n == 2:
        return parse(
            "v1(a), edge(a,b), edge(b,c), edge(c,d), edge(c,e), edge(d,e), "
            "d<e",
            "2-lollipop",
        )
    if n == 3:
        return parse(
            "v1(a), edge(a,b), edge(b,c), edge(c,d), "
            "edge(d,e), edge(d,f), edge(d,g), edge(e,f), edge(e,g), "
            "edge(f,g), e<f, f<g",
            "3-lollipop",
        )
    raise ValueError("only 2- and 3-lollipop are benchmarked")


#: name -> constructor for every query in the paper's benchmark.
PAPER_QUERIES = {
    "3-clique": lambda: clique(3),
    "4-clique": lambda: clique(4),
    "4-cycle": lambda: cycle(4),
    "3-path": lambda: path(3),
    "4-path": lambda: path(4),
    "1-tree": lambda: tree(1),
    "2-tree": lambda: tree(2),
    "2-comb": lambda: comb(2),
    "2-lollipop": lambda: lollipop(2),
    "3-lollipop": lambda: lollipop(3),
}


def get_query(name: str) -> Query:
    return PAPER_QUERIES[name]()
