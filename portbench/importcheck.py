"""The check that nothing of JAX runs in a benchmark process.

Names are compared by their top-level part (before the first dot), whole:
the measured package's name, ``topo_descriptors_tpu_torch``, begins with
the JAX package's, so a prefix test would be wrong.
"""

from __future__ import annotations

import ast
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "topo_descriptors_tpu"})
PROGRAM = "topo_descriptors_tpu_torch"


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded in the benchmark process: " + ", ".join(names))
        self.names = names


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules) -> list:
    """The names in ``modules`` (e.g. ``sys.modules``) whose top level is
    forbidden."""
    return sorted(n for n in modules if top_level(n) in FORBIDDEN)


def imports_of(path: Path) -> set:
    """Top-level names of every module ``path`` imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            names |= {top_level(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(top_level(node.module))
    return names
