"""The benchmark measures the port alone: no module of JAX, or of the JAX
package, may be loaded.  Names are compared by their top-level part (before
the first dot) as a whole: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rust_particle_system_tpu"})
PORT = "rust_particle_system_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """Forbidden modules among ``modules`` (default ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if top(m) in FORBIDDEN)


def imports_of(path: Path) -> set:
    """Top-level names of every module a Python file imports (absolute
    imports; a relative import stays inside its package)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add(top(node.module))
    return found
