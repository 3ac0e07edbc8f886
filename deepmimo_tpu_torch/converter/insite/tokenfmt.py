"""Parser for Wireless InSite's begin_<tag>/end_<tag> text format.

The .setup/.txrx/.city/.ter/.veg files share a simple block grammar::

    [name] begin_<kind>
        label value...            # typed scalar lines
        begin_<child> ... end_<child>
        1.0 2.0 3.0               # bare data rows (e.g. vertices)
    end_<kind>

This module parses such files into ``InsiteNode`` trees with typed values
(yes/no -> bool, ints, floats), and serializes them back. A line-based
recursive-descent design, copied from
``deepmimo_tpu/converter/insite/tokenfmt.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

_BEGIN = re.compile(r"begin_<(?P<kind>[^>]*)>")
_END = re.compile(r"end_<(?P<kind>[^>]*)>")
_INT = re.compile(r"^-?\d+$")
_FLOAT = re.compile(r"^-?\d+\.\d*(?:[eE][-+]?\d+)?$|^-?\.\d+$")


def _typed(tok: str) -> Any:
    if tok == "yes":
        return True
    if tok == "no":
        return False
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    return tok


@dataclass
class InsiteNode:
    """One begin_/end_ block: typed values, child nodes, and bare data rows."""

    kind: str = ""
    name: str = ""
    values: Dict[str, Any] = field(default_factory=dict)
    children: List["InsiteNode"] = field(default_factory=list)
    labels: List[str] = field(default_factory=list)
    data: List[Tuple] = field(default_factory=list)

    def __getitem__(self, key: str) -> Any:
        return self.values[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self.values.get(key, default)

    def child(self, kind: str) -> "InsiteNode":
        """First child of the given kind (raises if absent)."""
        for ch in self.children:
            if ch.kind == kind:
                return ch
        raise KeyError(f"no <{kind}> child in <{self.kind}>")

    def find_all(self, kind: str) -> List["InsiteNode"]:
        """All descendants (including self) of the given kind."""
        out = []
        if self.kind == kind:
            out.append(self)
        for ch in self.children:
            out.extend(ch.find_all(kind))
        return out


def parse_insite_text(text: str) -> List[InsiteNode]:
    """Parse file content into the top-level list of nodes."""
    lines = [ln for ln in text.splitlines()]
    # Skip a leading format line if present
    if lines and lines[0].startswith("Format type:keyword"):
        lines = lines[1:]

    pos = 0

    def parse_block(kind: str, name: str) -> InsiteNode:
        nonlocal pos
        node = InsiteNode(kind=kind, name=name)
        while pos < len(lines):
            line = lines[pos].strip()
            pos += 1
            if not line:
                continue
            m_end = _END.search(line)
            if m_end and m_end.group("kind") == kind:
                return node
            m_begin = _BEGIN.search(line)
            if m_begin:
                child_name = line[m_begin.end():].strip()
                child = parse_block(m_begin.group("kind"), child_name)
                node.children.append(child)
                # Also expose the child under its kind (and name) for
                # dict-style access, matching how consumers look things up.
                node.values.setdefault(child.kind, child)
                if child.name:
                    node.values.setdefault(child.name, child)
                continue
            toks = [_typed(t) for t in line.split()]
            if len(toks) == 1 and isinstance(toks[0], str):
                node.labels.append(toks[0])
            elif toks and isinstance(toks[0], str):
                node.values[toks[0]] = toks[1] if len(toks) == 2 else \
                    tuple(toks[1:])
            else:
                node.data.append(tuple(toks))
        if kind:
            raise ValueError(f"Unterminated block <{kind}>")
        return node

    top: List[InsiteNode] = []
    while pos < len(lines):
        line = lines[pos].strip()
        if not line:
            pos += 1
            continue
        m = _BEGIN.search(line)
        if not m:
            raise ValueError(f"Expected begin_<...> at top level, got: {line}")
        name = line[m.end():].strip()
        pos += 1
        top.append(parse_block(m.group("kind"), name))
    return top


def parse_insite_file(path: str) -> List[InsiteNode]:
    with open(path, "r") as f:
        return parse_insite_text(f.read())


# ----------------------------------------------------------------------------
# Serialization (inverse of the parser): InsiteNode trees -> project text
# ----------------------------------------------------------------------------

def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        # Plain positional decimals (no exponent notation): that's how
        # InSite writes its files, and exponent forms don't type as
        # numbers in every consumer's tokenizer.
        import numpy as _np
        return _np.format_float_positional(v, trim="-")
    return str(v)


def serialize_insite_node(node: InsiteNode, indent: int = 0) -> str:
    """Serialize one node back to the begin_/end_ block grammar.

    Emission order: labels, scalar values, bare data rows, children —
    matching how InSite lays out its files. Children stored in ``values``
    (the parser's dict aliases) are emitted once, from ``children``.
    """
    pad = "  " * indent
    head = f"{pad}begin_<{node.kind}> {node.name}".rstrip()
    lines = [head]
    for label in node.labels:
        lines.append(f"{pad}{label}")
    for k, v in node.values.items():
        if isinstance(v, InsiteNode):
            continue
        vs = " ".join(_fmt_value(x) for x in v) if isinstance(v, tuple) \
            else _fmt_value(v)
        lines.append(f"{pad}{k} {vs}")
    for row in node.data:
        lines.append(pad + " ".join(_fmt_value(x) for x in row))
    for child in node.children:
        lines.append(serialize_insite_node(child, indent))
    lines.append(f"{pad}end_<{node.kind}>")
    return "\n".join(lines)


def serialize_insite_text(nodes: List[InsiteNode],
                          format_line: bool = True) -> str:
    """Serialize top-level nodes into a complete InSite project file."""
    parts = ["Format type:keyword version: 1.1.0"] if format_line else []
    parts += [serialize_insite_node(n) for n in nodes]
    return "\n".join(parts) + "\n"
