"""The 2.x module spellings as importable modules: this package's copy of
``paddle_tpu/modules_compat.py``.

Paddle scripts spell ``paddle.tensor``, ``paddle.optimizer``,
``paddle.static``, ``paddle.device``, ``paddle.distributed`` and
``paddle.regularizer``, and ``from paddle.tensor import math``. Each
alias names the real module of this package (``tensor`` is ``ops``,
``optimizer`` is ``optim``, ``distributed`` the ``dist`` package, which
also calls as the tensor API's ``dist`` op), and ``import
paddle_tpu_torch.tensor.math`` gives the same module object as
``paddle_tpu_torch.ops.math``: a meta-path finder, which answers only
for names under this package's prefix, maps the alias onto the real
dotted name, so no module runs twice under two names.

``_ALIASES`` is the one table; the package's ``__getattr__`` reads it
(``resolve``), so every alias is imported at first use. The JAX
package's ``io``, ``metric`` and ``imperative`` (ROADMAP Queue 1, item 10)
aliases name modules that are not ported. ``fleet`` names
``dist.fleet``, the collective front end: the JAX package's ``fleet``
is its auto-parallel planner, which re-exports that front end and waits
for item 6c here.
"""
from __future__ import annotations

import importlib
import importlib.util
import sys

__all__ = ["install", "resolve", "ALIASES"]

# alias (under the package) -> its real home (relative import)
_ALIASES = {
    "tensor": ".ops",
    "tensor.creation": ".ops.creation",
    "tensor.math": ".ops.math",
    "tensor.linalg": ".ops.linalg",
    "tensor.manipulation": ".ops.manipulation",
    "tensor.logic": ".ops.compare",
    "tensor.random": ".ops.random_ops",
    "tensor.search": ".ops.manipulation",
    "optimizer": ".optim",
    "regularizer": ".optim.regularizer",
    "distributed": ".dist",
    "fleet": ".dist.fleet",
    "static": ".static_",
    "device": ".core.device",
}

# the top-level aliases (``pkg.tensor``, ``pkg.optimizer``, ...)
ALIASES = tuple(a for a in _ALIASES if "." not in a)


class _AliasLoader:
    """Hands back the real module object (one identity under both
    names)."""

    def __init__(self, real_name):
        self._real = real_name

    def create_module(self, spec):
        mod = importlib.import_module(self._real)
        # module_from_spec overwrites these with the alias spelling
        self._saved = {k: getattr(mod, k, None)
                       for k in ("__spec__", "__loader__", "__package__",
                                 "__name__")}
        return mod

    def exec_module(self, module):  # already run under its real name
        for k, v in self._saved.items():
            if v is not None:
                setattr(module, k, v)


class _AliasFinder:
    """Maps ``<pkg>.<alias>[.rest]`` onto the real dotted name; ahead of
    the path finder, which would load an alias's submodules a second
    time through the aliased package's ``__path__``."""

    def __init__(self, pkg_name):
        self._pkg_prefix = pkg_name + "."
        self._map = {f"{pkg_name}.{a}": f"{pkg_name}{t}"
                     for a, t in _ALIASES.items()}
        self._prefixes = sorted(self._map, key=len, reverse=True)

    def _real_name(self, fullname):
        if not fullname.startswith(self._pkg_prefix):
            return None
        if fullname in self._map:
            return self._map[fullname]
        for alias in self._prefixes:
            if fullname.startswith(alias + "."):
                return self._map[alias] + fullname[len(alias):]
        return None

    def find_spec(self, fullname, path=None, target=None):
        real = self._real_name(fullname)
        if real is None:
            return None
        try:
            real_spec = importlib.util.find_spec(real)
        except (ImportError, ValueError):
            return None
        if real_spec is None:
            return None
        return importlib.util.spec_from_loader(
            fullname, _AliasLoader(real),
            is_package=real_spec.submodule_search_locations is not None)


def resolve(pkg_name, alias):
    """The module ``alias`` names, imported now and registered under the
    alias spelling too."""
    mod = importlib.import_module(_ALIASES[alias], pkg_name)
    sys.modules.setdefault(f"{pkg_name}.{alias}", mod)
    return mod


def install(pkg_name):
    """Mount the finder for ``pkg_name`` once; nothing is imported."""
    for f in sys.meta_path:
        if (type(f).__name__ == "_AliasFinder"
                and getattr(f, "_pkg_prefix", None) == pkg_name + "."):
            return
    sys.meta_path.insert(0, _AliasFinder(pkg_name))
