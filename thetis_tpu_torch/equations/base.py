"""Equation/Term infrastructure (port of ``thetis_tpu/equations/base.py``).

Mirrors the reference's ``thetis/equation.py`` (Term/Equation with labels
``source|explicit|implicit|nonlinear`` and sign convention d(u)/dt = term)
but evaluates residuals as fused quadrature-point accumulation passes:

  * every term adds its integrand into shared accumulator *buckets*
    (cell / grad / facet / facet-grad, see ``fem.assembly``),
  * a single projection step turns buckets into dof-space residuals.

Boundary conditions follow the reference's vocabulary
(``shallowwater_eq.py:232-296``): per-marker dicts with keys ``elev``,
``uv``, ``un``, ``flux`` (open sea) and ``drag``; unspecified markers are
impermeable land.  The *structure* (which markers/keys exist) is fixed at
equation construction; the *values* are passed per call.
"""
import numpy as np
import torch

__all__ = ["Bucket", "EquationBase", "SUPPORTED_LABELS", "facet_quad_value",
           "facet_quad_value_2s"]

SUPPORTED_LABELS = frozenset(["source", "explicit", "implicit", "nonlinear"])


class Bucket:
    """Lazily-allocated accumulator; avoids materialising zero tensors for
    disabled terms.  ``add`` rebinds (never updates in place), so buckets
    compose with ``torch.func`` transforms."""

    __slots__ = ("val",)

    def __init__(self):
        self.val = None

    def add(self, x):
        self.val = x if self.val is None else self.val + x

    def __bool__(self):
        return self.val is not None


def facet_quad_value(asm, val, vector=False):
    """Convert a BC value / coefficient into per-facet-quad tensors.

    Supported: python scalars, 0-d tensors, per-vertex CG1 arrays (nv,),
    per-cell-dof DG arrays (nc, nd), or ready (nf, nqf) arrays.  Vector
    variants carry a trailing component axis.
    """
    mesh = asm.mesh
    nqf = len(asm.space._tab_np["qwf"])
    tail = (2,) if vector else ()
    if np.isscalar(val) or (hasattr(val, "ndim") and val.ndim == len(tail)):
        return asm.as_tensor(val).expand((mesh.nf, nqf) + tail)
    val = asm.as_tensor(val)
    if val.shape[:1] == (mesh.nv,):
        # CG1 vertex data: linear interpolation along the facet
        fv = mesh.facet_verts
        a, b = val[fv[:, 0]], val[fv[:, 1]]
        t = asm.space.tab("qt").reshape((1, nqf) + (1,) * len(tail))
        return a[:, None] + (b[:, None] - a[:, None]) * t
    if val.shape[:2] == (mesh.nc, asm.ndofs):
        return asm.facet_traces(val)[:, 0]
    if val.shape[:2] == (mesh.nf, nqf):
        return val
    raise ValueError(
        f"cannot map BC value of shape {tuple(val.shape)} to facets")


def facet_quad_value_2s(asm, val, vector=False):
    """Both-side facet traces (nf, 2, nqf[, k]).  Sides are identical unless
    ``val`` is a DG dof array."""
    mesh = asm.mesh
    if (
        not np.isscalar(val)
        and hasattr(val, "shape")
        and tuple(val.shape[:2]) == (mesh.nc, asm.ndofs)
    ):
        return asm.facet_traces(asm.as_tensor(val))
    tr0 = facet_quad_value(asm, val, vector=vector)
    return torch.stack([tr0, tr0], dim=1)


class EquationBase:
    """Common helpers: term registry + boundary masks."""

    def __init__(self, mesh, asm, bnd_conditions=None):
        self.mesh = mesh
        self.asm = asm
        self.terms = []  # list of (name, label, method)
        bnd_conditions = bnd_conditions or {}
        self.bnd_keys = {
            int(m): frozenset(spec.keys()) for m, spec in bnd_conditions.items()
        }
        self._build_masks()

    def add_term(self, name, label, method):
        if label not in SUPPORTED_LABELS:
            raise ValueError(f"unknown term label {label!r}")
        self.terms.append((name, label, method))

    def select_terms(self, label):
        """Select by label ('implicit', frozenset of labels, 'all') or by
        exact term *names* (any entry matching a registered term name
        switches to name-based selection)."""
        if label == "all":
            labels = SUPPORTED_LABELS
        elif isinstance(label, str):
            labels = frozenset([label])
        else:
            labels = frozenset(label)
        names = {n for (n, _, _) in self.terms}
        if labels & names:
            return [(n, m) for (n, l, m) in self.terms if n in labels]
        return [(n, m) for (n, l, m) in self.terms if l in labels]

    # -- boundary classification (static, host side) --------------------
    def _build_masks(self):
        mesh = self.mesh
        marker = mesh.facet_marker_np
        is_bnd = mesh.facet_is_boundary_np
        open_keys = ("elev", "uv", "un", "flux", "value", "equilibrium",
                     "symm")
        self.open_markers = [
            m
            for m, keys in sorted(self.bnd_keys.items())
            if any(k in keys for k in open_keys)
        ]
        mask_open = np.zeros(mesh.nf, dtype=bool)
        for m in self.open_markers:
            mask_open |= is_bnd & (marker == m)

        def dev(a):
            return torch.as_tensor(a, device=mesh.device)

        self.mask_open = dev(mask_open)
        self.mask_land = dev(is_bnd & ~mask_open)
        self.mask_bnd = dev(is_bnd)
        self.mask_int = dev(~is_bnd)
        self.marker_masks = {
            m: dev(is_bnd & (marker == m))
            for m in sorted(self.bnd_keys)
            if (is_bnd & (marker == m)).any()
        }
        # drop BC specs on markers absent from this mesh
        self.bnd_keys = {m: k for m, k in self.bnd_keys.items()
                         if m in self.marker_masks}

    def _mask_q(self, mask, tail=0):
        """Expand an (nf,) mask to broadcast over (nf, nqf, ...)."""
        return mask.reshape((self.mesh.nf, 1) + (1,) * tail)
