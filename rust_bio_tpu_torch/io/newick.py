"""Newick phylogenetic tree parsing and writing.

Reference parity: src/io/newick.rs (feature `phylogeny`) — pest-grammar
parser into a petgraph tree. Here: a recursive-descent parser into a plain
``Tree`` of ``Clade`` nodes (name + branch length + children), the
Python-idiomatic equivalent.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple


@dataclass
class Clade:
    """A tree node: optional name, optional branch length, children."""

    name: Optional[str] = None
    branch_length: Optional[float] = None
    children: List["Clade"] = field(default_factory=list)

    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> Iterator["Clade"]:
        if self.is_leaf():
            yield self
        else:
            for c in self.children:
                yield from c.leaves()

    def __iter__(self) -> Iterator["Clade"]:
        yield self
        for c in self.children:
            yield from c


@dataclass
class Tree:
    root: Clade

    def leaf_names(self) -> List[str]:
        return [c.name for c in self.root.leaves() if c.name is not None]

    def node_count(self) -> int:
        return sum(1 for _ in self.root)


class _Parser:
    def __init__(self, s: str) -> None:
        self.s = s
        self.i = 0

    def _peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def _skip_ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t\r\n":
            self.i += 1

    def parse(self) -> Clade:
        self._skip_ws()
        clade = self._clade()
        self._skip_ws()
        if self._peek() != ";":
            raise ValueError(f"expected ';' at position {self.i}")
        self.i += 1
        return clade

    def _clade(self) -> Clade:
        self._skip_ws()
        node = Clade()
        if self._peek() == "(":
            self.i += 1
            while True:
                node.children.append(self._clade())
                self._skip_ws()
                c = self._peek()
                if c == ",":
                    self.i += 1
                    continue
                if c == ")":
                    self.i += 1
                    break
                raise ValueError(f"expected ',' or ')' at position {self.i}")
        name = self._label()
        if name:
            node.name = name
        self._skip_ws()
        if self._peek() == ":":
            self.i += 1
            node.branch_length = self._number()
        return node

    def _label(self) -> str:
        self._skip_ws()
        if self._peek() in ("'", '"'):
            quote = self._peek()
            self.i += 1
            out = []
            while self.i < len(self.s) and self.s[self.i] != quote:
                out.append(self.s[self.i])
                self.i += 1
            self.i += 1
            return "".join(out)
        out = []
        while self.i < len(self.s) and self.s[self.i] not in "():;, \t\r\n[":
            out.append(self.s[self.i])
            self.i += 1
        return "".join(out)

    def _number(self) -> float:
        self._skip_ws()
        start = self.i
        while self.i < len(self.s) and (
            self.s[self.i].isdigit() or self.s[self.i] in ".-+eE"
        ):
            self.i += 1
        return float(self.s[start : self.i])


def from_string(s: str) -> Tree:
    """Parse a Newick string.

    >>> t = from_string("(A:0.1,B:0.2,(C:0.3,D:0.4)E:0.5)F;")
    >>> t.leaf_names()
    ['A', 'B', 'C', 'D']
    """
    return Tree(root=_Parser(s).parse())


def read(path) -> Tree:
    with open(path) as h:
        return from_string(h.read())


def _write_clade(c: Clade) -> str:
    s = ""
    if c.children:
        s += "(" + ",".join(_write_clade(ch) for ch in c.children) + ")"
    if c.name:
        s += c.name
    if c.branch_length is not None:
        s += f":{c.branch_length:g}"
    return s


def to_string(tree: Tree) -> str:
    return _write_clade(tree.root) + ";"


def write(path, tree: Tree) -> None:
    with open(path, "w") as h:
        h.write(to_string(tree) + "\n")
