"""The check that the benchmark runs the port alone: no module whose
top-level name (the part before the first dot) is one of ``FORBIDDEN`` is
imported. ``tumseg_torch`` begins with ``tumseg`` and is allowed: names are
compared whole."""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "tumseg")


def forbidden(names: Iterable[str], banned=FORBIDDEN) -> List[str]:
    """The names among ``names`` whose top-level name is banned."""
    return sorted({n for n in names if n.split(".")[0] in banned})


def loaded() -> List[str]:
    """The banned modules that this process holds."""
    return forbidden(list(sys.modules))


def imports_of(path: Path) -> List[str]:
    """Every module that the file's ``import`` and ``from`` statements
    name (relative imports as written, with their dots)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    return names
