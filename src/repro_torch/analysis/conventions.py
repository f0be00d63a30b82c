"""Convention lint: the port's discipline rules, enforced on the AST
(counterpart of ``repro.analysis.conventions``). Repo scope, over every
module of ``src/repro_torch/``:

* **kernel-library-outside-kernels**: a kernel library is built, loaded or
  called (``load_library``, ``build_library``, ``ctypes.CDLL``) only under
  ``kernels/``. A call elsewhere bypasses the wrappers' checks, their launch
  counts and the launch records the kernel lint reads.
* **bare-dict-plan-cache**: plan caches are ``bucketing.PlanCache``
  (bounded, keyed on leaf signatures), never a bare dict: an unbounded
  ``{}`` keyed on trees leaks plan metadata across models.
* **forbidden-import**: no module imports ``jax``, ``jaxlib`` or the JAX
  package ``repro``: the machine with the card has none of them.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterator, List, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.framework import AnalysisPass, register_pass

_PLAN_CACHE_NAME = re.compile(r"(plan.*cache|^plans$|_plans$)", re.IGNORECASE)
_LIBRARY_CALLS = frozenset({"load_library", "build_library", "CDLL"})
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "repro")


def package_root() -> str:
    """``src/repro_torch`` resolved from this file's location."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _py_files(root: str) -> Iterator[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _target_names(node: ast.AST) -> Iterator[str]:
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, ast.Attribute):
        yield node.attr
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _target_names(elt)


def _called_name(node: ast.Call) -> str:
    f = node.func
    return f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")


def _imports(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Import):
        return [alias.name for alias in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module]
    return []


def scan_source(source: str, rel: str) -> List[Tuple[str, int, str]]:
    """[(code, lineno, message)] for one module's source; ``rel`` is its
    path under the package (``kernels/ops.py``)."""
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [("syntax-error", e.lineno or 0, f"{rel}: not parseable: {e.msg}")]
    in_kernels = rel.replace(os.sep, "/").startswith("kernels/")
    hits: List[Tuple[str, int, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _called_name(node) in _LIBRARY_CALLS:
            if not in_kernels:
                hits.append(("kernel-library-outside-kernels", node.lineno,
                             f"{rel}:{node.lineno}: {_called_name(node)}() outside "
                             f"src/repro_torch/kernels/: launch through the kernels' "
                             f"wrappers"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if not isinstance(node.value, (ast.Dict, ast.DictComp)):
                continue
            for t in targets:
                for name in _target_names(t):
                    if _PLAN_CACHE_NAME.search(name):
                        hits.append(("bare-dict-plan-cache", node.lineno,
                                     f"{rel}:{node.lineno}: {name!r} assigned a bare "
                                     f"dict: plan caches must be bucketing.PlanCache "
                                     f"(bounded LRU keyed on leaf signatures)"))
        for name in _imports(node):
            if name.split(".")[0] in FORBIDDEN_IMPORTS:
                hits.append(("forbidden-import", node.lineno,
                             f"{rel}:{node.lineno}: imports {name}: the port stands "
                             f"alone, without JAX or the JAX package"))
    return hits


@register_pass
class ConventionsPass(AnalysisPass):
    name = "conventions"
    description = ("AST rules: kernel libraries only under kernels/, plan caches "
                   "are PlanCache, no import of jax or repro")
    scope = "repo"

    def run(self, _artifacts=None) -> List[Finding]:
        root = package_root()
        out: List[Finding] = []
        n_files = 0
        for path in _py_files(root):
            rel = os.path.relpath(path, root)
            n_files += 1
            with open(path, encoding="utf-8") as f:
                source = f.read()
            for code, lineno, message in scan_source(source, rel):
                out.append(Finding(pass_name=self.name, severity=Severity.ERROR,
                                   code=code, message=message,
                                   location=f"{rel}:{lineno}"))
        out.append(Finding(pass_name=self.name, severity=Severity.INFO, code="summary",
                           message=f"scanned {n_files} files under src/repro_torch"))
        return out
