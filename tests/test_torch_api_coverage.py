"""Every public name of ``thetis_tpu`` is defined in ``thetis_tpu_torch``.

Both packages are read as source with ``ast``; neither is imported. For
each module of the reference these names are required:

* its public top-level classes, functions and assignments, the names in
  its ``__all__``, and the names a package ``__init__.py`` re-exports;
* for each public class, its public methods, properties and class
  attributes, and every dunder it defines but ``__init__`` (``__add__``,
  ``__getitem__``, ``__call__``, ...).

The port's module at the same path (or the one ``RELOCATED`` names) must
bind each module-level name. The port's class of the same name must
define each member: in its body, in a base class the port's module binds,
or, for a reference property or attribute, as an attribute its methods
set on ``self`` (``self.x = ...``, ``setattr(self, "x", ...)``, or
``setattr`` over a module-level tuple of names). A name may be left out
only through ``NOT_PORTED``, whose reason names the ROADMAP entry that
says why, and ROADMAP.md must name it. Run alone:
``pytest tests/test_torch_api_coverage.py -q``.
"""
import ast
import functools
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "thetis_tpu"
PORT = ROOT / "thetis_tpu_torch"

#: reference module -> the port's module that holds its names
RELOCATED = {
    # ROADMAP A10a-c: "the rest of api.py in the facade"
    "api.py": "__init__.py",
}

_DO_NOT_PORT = "ROADMAP A, Do not port: "

#: ``module::Name`` or ``module::Class.member`` -> why the port lacks it
NOT_PORTED = {
    "config.py::float_dtype": _DO_NOT_PORT + (
        "JAX's global precision switch; the port has none, a tensor's "
        "dtype is its mesh's (Mesh2d(dtype=))"),
    "config.py::int_dtype": _DO_NOT_PORT + (
        "JAX's global precision switch; the port's index tables are int64"),
    "kernels/ringmv.py::ring_mv_pallas": _DO_NOT_PORT + (
        "the Pallas call; ring_mv launches csrc/ring_mv.cu"),
    "kernels/ringmv.py::block_diag_mv_pallas": _DO_NOT_PORT + (
        "the Pallas call; block_diag_mv launches csrc/block_diag_mv.cu"),
    "solvers/assembled.py::ShiftStencil": _DO_NOT_PORT + (
        "a v5e layout; the port gathers through the ring table"),
    "solvers/assembled.py::get_stencil": _DO_NOT_PORT + (
        "builds ShiftStencil, a v5e layout"),
    "parallel/sharded.py::harvest_graph": _DO_NOT_PORT + (
        "rebinds the one template shard_map traces; the port keeps one "
        "real instance a partition"),
    "parallel/sharded.py::clone_graph": _DO_NOT_PORT + (
        "rebinds the one template shard_map traces; the port keeps one "
        "real instance a partition"),
    "parallel/assembled_sharded.py::DistributedCoarseCorrection.local_apply":
        _DO_NOT_PORT + (
            "the per-device body of a shard_map trace (a psum over the "
            "device axis); the port's apply takes every partition's "
            "residual at once"),
    "parallel/submesh.py::SubMesh.keep_all_marker_masks": (
        "ROADMAP A11: the residuals match bit for bit without it"),
    "solvers/newton.py::NewtonParameters.__eq__": (
        "ROADMAP C, roundoff-level only: NewtonParameters not hashable "
        "(the reference hashes it as a static argument of jax.jit)"),
    "solvers/newton.py::NewtonParameters.__hash__": (
        "ROADMAP C, roundoff-level only: NewtonParameters not hashable "
        "(the reference hashes it as a static argument of jax.jit)"),
    "utils/constant.py::Constant.__jax_array__": _DO_NOT_PORT + (
        "JAX's array protocol; torch reads a Constant through __array__ "
        "and __float__"),
}


def _top(body):
    """Module-level statements, looking inside ``if`` and ``try``."""
    for n in body:
        if isinstance(n, (ast.If, ast.Try)):
            yield from _top(n.body)
            yield from _top(n.orelse)
            for h in getattr(n, "handlers", ()):
                yield from _top(h.body)
            yield from _top(getattr(n, "finalbody", ()))
        else:
            yield n


def _targets(n):
    if isinstance(n, ast.Assign):
        ts = n.targets
    elif isinstance(n, (ast.AnnAssign, ast.AugAssign)):
        ts = [n.target]
    else:
        return []
    out = []
    for t in ts:
        out.extend(t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t])
    return out


class Package:
    """One package's source, parsed; ``sources`` replaces files by text."""

    def __init__(self, root, sources=None):
        self.root = root
        self.sources = sources or {}

    @functools.lru_cache(maxsize=None)
    def tree(self, rel):
        if rel in self.sources:
            return ast.parse(self.sources[rel])
        path = self.root / rel
        return ast.parse(path.read_text()) if path.exists() else None

    @functools.lru_cache(maxsize=None)
    def bound(self, rel):
        """Module-level name -> the statement that binds it."""
        names = {}
        for n in _top(self.tree(rel).body):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                names[n.name] = n
            elif isinstance(n, ast.ImportFrom):
                for a in n.names:
                    names[a.asname or a.name] = n
            elif isinstance(n, ast.Import):
                for a in n.names:
                    names[(a.asname or a.name).split(".")[0]] = n
            for t in _targets(n):
                if isinstance(t, ast.Name):
                    names[t.id] = n
        return names

    def all_names(self, rel):
        n = self.bound(rel).get("__all__")
        if not isinstance(n, ast.Assign):
            return []   # absent, or imported with the names it lists
        return [e.value for e in n.value.elts]

    def _imported_class(self, rel, node, name):
        """The (module, ClassDef) a ``from ... import name`` brings in."""
        if node.level:
            base = pathlib.PurePosixPath(rel).parent
            for _ in range(node.level - 1):
                base = base.parent
        elif (node.module or "").split(".")[0] == self.root.name:
            base = pathlib.PurePosixPath(".")
        else:
            return None
        parts = [p for p in (node.module or "").split(".")[
            0 if node.level else 1:] if p]
        mod = base.joinpath(*parts) if parts else base
        orig = next(a.name for a in node.names if (a.asname or a.name) == name)
        for cand in (f"{mod}.py", f"{mod}/__init__.py"):
            cand = str(pathlib.PurePosixPath(cand))
            if self.tree(cand) is not None:
                d = self.bound(cand).get(orig)
                if isinstance(d, ast.ClassDef):
                    return cand, d
        return None

    @functools.lru_cache(maxsize=None)
    def members(self, rel, cls):
        """(class-level names, attributes set on ``self``), bases included."""
        body, attrs = set(), set()
        for n in cls.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                body.add(n.name)
            body.update(t.id for t in _targets(n) if isinstance(t, ast.Name))
        # loop variable -> the names of the module-level tuple it runs over
        consts = {k: v.value for k, v in self.bound(rel).items()
                  if isinstance(v, ast.Assign)
                  and isinstance(v.value, (ast.Tuple, ast.List))}
        nodes = list(ast.walk(cls))
        loops = {n.target.id: [e.value for e in consts[n.iter.id].elts
                               if isinstance(e, ast.Constant)]
                 for n in nodes
                 if isinstance(n, ast.For) and isinstance(n.target, ast.Name)
                 and isinstance(n.iter, ast.Name) and n.iter.id in consts}
        for n in nodes:
            for t in _targets(n):
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    attrs.add(t.attr)
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id == "setattr" and len(n.args) == 3
                    and isinstance(n.args[0], ast.Name)
                    and n.args[0].id == "self"):
                key = n.args[1]
                if isinstance(key, ast.Constant):
                    attrs.add(key.value)
                elif isinstance(key, ast.Name):
                    attrs.update(loops.get(key.id, ()))
        for b in cls.bases:
            if not isinstance(b, ast.Name):
                continue
            d = self.bound(rel).get(b.id)
            found = ((rel, d) if isinstance(d, ast.ClassDef)
                     else self._imported_class(rel, d, b.id)
                     if isinstance(d, ast.ImportFrom) else None)
            if found:
                b_body, b_attrs = self.members(*found)
                body |= b_body
                attrs |= b_attrs
        return frozenset(body), frozenset(attrs)


def _is_property(node):
    if isinstance(node, (ast.Assign, ast.AnnAssign)):
        return True
    return any(isinstance(d, ast.Name) and d.id in ("property",
                                                    "cached_property")
               for d in getattr(node, "decorator_list", ()))


def required(ref, rel):
    """(module-level names, {class: {member: is_property}}) that the
    reference module ``rel`` makes public."""
    tree = ref.tree(rel)
    names = set(ref.all_names(rel))
    for name, n in ref.bound(rel).items():
        if name.startswith("_"):
            continue
        if isinstance(n, ast.ImportFrom):
            if rel.endswith("__init__.py") and name != "*":
                names.add(name)
        elif not isinstance(n, ast.Import):
            names.add(name)
    classes = {}
    for n in _top(tree.body):
        if not isinstance(n, ast.ClassDef) or n.name.startswith("_"):
            continue
        want = {}
        for m in n.body:
            for name in ([m.name] if isinstance(
                    m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    else [t.id for t in _targets(m)
                          if isinstance(t, ast.Name)]):
                dunder = name.startswith("__") and name.endswith("__")
                if ((dunder and name not in ("__init__", "__slots__"))
                        or not name.startswith("_")):
                    want[name] = _is_property(m)
        classes[n.name] = want
    return names, classes


def missing(ref, port, rel):
    """The reference module's public names that the port does not define,
    as ``module::Name`` / ``module::Class.member``."""
    prel = RELOCATED.get(rel, rel)
    names, classes = required(ref, rel)
    if port.tree(prel) is None:
        return [f"{rel}::{n}" for n in sorted(names)] or [f"{rel}::"]
    bound = port.bound(prel)
    out = [f"{rel}::{n}" for n in sorted(names) if n not in bound]
    for cname, want in sorted(classes.items()):
        cls = bound.get(cname)
        if isinstance(cls, ast.ImportFrom):
            found = port._imported_class(prel, cls, cname)
            if found is None:
                continue   # bound to something that is not a class here
            body, attrs = port.members(*found)
        elif isinstance(cls, ast.ClassDef):
            body, attrs = port.members(prel, cls)
        else:
            continue       # the name itself is reported (or not a class)
        out += [f"{rel}::{cname}.{m}" for m, prop in sorted(want.items())
                if m not in body and not (prop and m in attrs)]
    return out


REF_PKG = Package(REF)
PORT_PKG = Package(PORT)
MODULES = sorted(str(p.relative_to(REF).as_posix()) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_is_ported(rel):
    gaps = [m for m in missing(REF_PKG, PORT_PKG, rel) if m not in NOT_PORTED]
    assert not gaps, (
        f"public names of thetis_tpu/{rel} missing from the port: {gaps}; "
        "port them, or list each in NOT_PORTED with its ROADMAP reason")


def test_not_ported_entries_are_live_and_on_the_roadmap():
    """Each entry names a reference definition the port still lacks, gives
    a ROADMAP reason, and ROADMAP.md names it."""
    roadmap = (ROOT / "ROADMAP.md").read_text()
    gaps = {m for rel in MODULES for m in missing(REF_PKG, PORT_PKG, rel)}
    for key, reason in NOT_PORTED.items():
        rel, name = key.split("::")
        assert rel in MODULES, key
        assert key in gaps, f"{key} is ported (or gone): drop its entry"
        assert reason.startswith("ROADMAP "), key
        assert name.split(".")[-1] in roadmap, f"ROADMAP.md does not name {key}"


def test_relocated_modules_exist():
    for rel, prel in RELOCATED.items():
        assert (REF / rel).exists() and (PORT / prel).exists(), (rel, prel)
        assert not (PORT / rel).exists(), rel


#: one ported name of each kind the scan reads, and the edit that removes it
REMOVALS = [
    ("fem/functionspace.py", "fem/functionspace.py::Function.copy",
     "    def copy(", "    def kopy("),
    ("fem/functionspace.py", "fem/functionspace.py::Function.__getitem__",
     "    def __getitem__(", "    def getitem("),
    ("fem/functionspace.py", "fem/functionspace.py::Function.__radd__",
     "    __radd__ = __add__", "    radd = __add__"),
    ("fem/functionspace.py", "fem/functionspace.py::Function.dat",
     "    def dat(", "    def dta("),
    ("__init__.py", "api.py::as_vector",
     "def as_vector(", "def _as_vector("),
    ("kernels/__init__.py", "kernels/__init__.py::tridiag_solve",
     "from .tridiag import tridiag_solve", "from .tridiag import shared_form"),
    ("mesh/mesh2d.py", "mesh/mesh2d.py::Mesh2d.facet_cells",
     '"cell_area", "facet_cells",', '"cell_area",'),
    ("fem/bdm.py", "fem/bdm.py::BDMSpace.mass_inverse",
     "class BDMSpace(HdivSpace):", "class BDMSpace:"),
]


@pytest.mark.parametrize("rel,name,old,new", REMOVALS,
                         ids=[r[1] for r in REMOVALS])
def test_a_removed_name_is_reported(rel, name, old, new):
    """The scan fails when one ported name is taken out of the port."""
    text = (PORT / rel).read_text()
    assert text.count(old) == 1, (rel, old)
    cut = Package(PORT, {rel: text.replace(old, new)})
    ref_rel = {v: k for k, v in RELOCATED.items()}.get(rel, rel)
    assert name not in missing(REF_PKG, PORT_PKG, ref_rel)
    assert name in missing(REF_PKG, cut, ref_rel)
