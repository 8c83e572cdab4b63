"""Code-region tree (paper §2).

A *code region* is a single-entry/single-exit section of code. Regions are
organized as a tree with the whole program as the root; regions of equal depth
never overlap, and nesting refines granularity (paper Fig. 1).

In the JAX framework the "code" is a step function and regions are named
phases (embed / layer_i.attn / layer_i.ffn / optimizer / ...), but this module
is agnostic: it only models the tree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

ROOT_ID = 0


@dataclasses.dataclass
class Region:
    """One code region. ``rid`` is dense and unique; root has rid 0."""

    rid: int
    name: str
    parent: Optional[int]  # parent rid; None only for the root

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Region({self.rid}, {self.name!r})"


class RegionTree:
    """Tree of code regions. Root (rid 0) represents the whole program.

    Per the paper, *depth* of a region is the path length from the root;
    the root itself has depth 0 and is not a candidate bottleneck.
    """

    def __init__(self, root_name: str = "program"):
        self._regions: Dict[int, Region] = {ROOT_ID: Region(ROOT_ID, root_name, None)}
        self._children: Dict[int, List[int]] = {ROOT_ID: []}

    # -- construction -----------------------------------------------------
    def add(self, name: str, parent: int = ROOT_ID, rid: Optional[int] = None) -> int:
        if parent not in self._regions:
            raise KeyError(f"unknown parent region {parent}")
        if rid is None:
            rid = max(self._regions) + 1
        if rid in self._regions:
            raise ValueError(f"duplicate region id {rid}")
        self._regions[rid] = Region(rid, name, parent)
        self._children[rid] = []
        self._children[parent].append(rid)
        return rid

    # -- queries ----------------------------------------------------------
    def __contains__(self, rid: int) -> bool:
        return rid in self._regions

    def __len__(self) -> int:
        return len(self._regions) - 1  # excluding the root

    def region(self, rid: int) -> Region:
        return self._regions[rid]

    def name(self, rid: int) -> str:
        return self._regions[rid].name

    def parent(self, rid: int) -> Optional[int]:
        return self._regions[rid].parent

    def children(self, rid: int) -> Tuple[int, ...]:
        return tuple(self._children[rid])

    def is_leaf(self, rid: int) -> bool:
        return not self._children[rid]

    def depth(self, rid: int) -> int:
        d = 0
        cur = rid
        while self._regions[cur].parent is not None:
            cur = self._regions[cur].parent
            d += 1
        return d

    def ids(self) -> Tuple[int, ...]:
        """All region ids except the root, in insertion order."""
        return tuple(r for r in self._regions if r != ROOT_ID)

    def at_depth(self, depth: int) -> Tuple[int, ...]:
        return tuple(r for r in self.ids() if self.depth(r) == depth)

    def subtree(self, rid: int) -> Tuple[int, ...]:
        """rid plus all descendants (pre-order)."""
        out: List[int] = []
        stack = [rid]
        while stack:
            cur = stack.pop()
            out.append(cur)
            stack.extend(reversed(self._children[cur]))
        return tuple(out)

    def descendants(self, rid: int) -> Tuple[int, ...]:
        return self.subtree(rid)[1:]

    def walk(self) -> Iterator[int]:
        yield from self.subtree(ROOT_ID)[1:]

    def path(self, rid: int) -> Tuple[int, ...]:
        """Path of rids from the depth-1 ancestor down to ``rid``."""
        rev = [rid]
        cur = rid
        while self._regions[cur].parent not in (None, ROOT_ID):
            cur = self._regions[cur].parent
            rev.append(cur)
        return tuple(reversed(rev))

    # -- identity ----------------------------------------------------------
    def fingerprint(self) -> str:
        """Stable digest of the tree's structure (rids, names, parentage).
        Snapshot transport uses it to check that two shards were recorded
        against the same instrumented region layout."""
        import hashlib
        spec = [self._regions[ROOT_ID].name] + [
            (r.rid, r.name, r.parent)
            for r in (self._regions[i] for i in sorted(self._regions))
            if r.rid != ROOT_ID]
        return hashlib.sha256(repr(spec).encode()).hexdigest()[:16]

    def to_spec(self) -> dict:
        """JSON-serializable structure (for self-describing wire headers).
        Insertion order is preserved so parents precede children on rebuild."""
        regs = [r for i, r in self._regions.items() if i != ROOT_ID]
        return {"root": self._regions[ROOT_ID].name,
                "rids": [r.rid for r in regs],
                "names": [r.name for r in regs],
                "parents": [r.parent for r in regs]}

    @classmethod
    def from_spec(cls, spec: Mapping) -> "RegionTree":
        tree = cls(spec["root"])
        for rid, nm, par in zip(spec["rids"], spec["names"], spec["parents"]):
            tree.add(nm, parent=par, rid=rid)
        return tree

    # -- helpers ----------------------------------------------------------
    @classmethod
    def from_edges(cls, names: Sequence[str],
                   parents: Sequence[Optional[int]],
                   root_name: str = "program") -> "RegionTree":
        """Build from parallel (name, parent) lists; ids are 1..len(names)."""
        tree = cls(root_name)
        for i, (nm, par) in enumerate(zip(names, parents), start=1):
            tree.add(nm, ROOT_ID if par is None else par, rid=i)
        return tree

    def render(self) -> str:  # pragma: no cover - cosmetic
        lines: List[str] = []

        def rec(rid: int, indent: int) -> None:
            if rid != ROOT_ID:
                lines.append("  " * indent + f"[{rid}] {self.name(rid)}")
            for ch in self._children[rid]:
                rec(ch, indent + (rid != ROOT_ID))

        rec(ROOT_ID, 0)
        return "\n".join(lines)
