"""Reference-element tabulations for triangles.

Replaces the reference stack's FIAT/finat/TSFC basis machinery
(``thetis/utility.py:163-258`` relies on Firedrake function spaces) with
explicit numpy tabulations of Lagrange bases and quadrature rules on the
unit triangle with vertices (0,0), (1,0), (0,1).

Local facet convention: facet ``i`` is the edge *opposite* local vertex
``i``, traversed from local vertex ``(i+1)%3`` to ``(i+2)%3``.  Facet trace
tabulations come in 6 *variants*: ``variant = local_facet*2 + direction``
where direction 0 follows the owning cell's traversal and direction 1 is
reversed.  A facet's quadrature points are parameterised by the side-0
(owner/"left") cell's traversal; the side-1 cell uses the reversed variant so
both sides evaluate at identical physical points.
"""
import numpy as np

__all__ = [
    "triangle_quadrature",
    "edge_quadrature",
    "ReferenceElement",
    "P0Tri",
    "P1Tri",
    "P2Tri",
    "FACET_VERTICES",
]

# facet i connects local vertices (i+1)%3 -> (i+2)%3
FACET_VERTICES = np.array([[1, 2], [2, 0], [0, 1]], dtype=np.int32)


def triangle_quadrature(degree):
    """Symmetric quadrature on the reference triangle, exact to ``degree``.

    Returns (points (nq,2), weights (nq,)) with weights summing to 1/2
    (the reference-triangle area).
    """
    if degree <= 1:
        pts = np.array([[1.0 / 3.0, 1.0 / 3.0]])
        wts = np.array([1.0])
    elif degree == 2:
        # 3-point midpoint-edge rule, degree 2
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        wts = np.array([1 / 3, 1 / 3, 1 / 3])
    elif degree == 3:
        # 4-point rule (degree 3, one negative weight)
        pts = np.array(
            [[1 / 3, 1 / 3], [0.2, 0.2], [0.6, 0.2], [0.2, 0.6]]
        )
        wts = np.array([-27 / 48, 25 / 48, 25 / 48, 25 / 48])
    elif degree == 4:
        # Dunavant degree-4, 6 points
        a1, b1, w1 = 0.816847572980459, 0.091576213509771, 0.109951743655322
        a2, b2, w2 = 0.108103018168070, 0.445948490915965, 0.223381589678011
        bary = []
        wts = []
        for (a, b, w) in ((a1, b1, w1), (a2, b2, w2)):
            bary += [(a, b, b), (b, a, b), (b, b, a)]
            wts += [w, w, w]
        bary = np.array(bary)
        pts = bary[:, 1:]
        wts = np.array(wts)
    elif degree <= 6:
        # Dunavant degree-6, 12 points
        g = [
            (0.873821971016996, 0.063089014491502, 0.050844906370207),
            (0.501426509658179, 0.249286745170910, 0.116786275726379),
        ]
        bary = []
        wts = []
        for (a, b, w) in g:
            bary += [(a, b, b), (b, a, b), (b, b, a)]
            wts += [w, w, w]
        a, b, c, w = (
            0.636502499121399,
            0.310352451033785,
            0.053145049844816,
            0.082851075618374,
        )
        for p in [(a, b, c), (a, c, b), (b, a, c), (b, c, a), (c, a, b), (c, b, a)]:
            bary.append(p)
            wts.append(w)
        bary = np.array(bary)
        pts = bary[:, 1:]
        wts = np.array(wts)
    else:
        raise NotImplementedError(f"triangle quadrature degree {degree}")
    return pts, wts * 0.5


def edge_quadrature(degree):
    """Gauss-Legendre quadrature on [0, 1]; weights sum to 1."""
    n = max(1, (degree + 2) // 2)
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


class ReferenceElement:
    """Scalar Lagrange element on the reference triangle.

    Attributes
    ----------
    ndofs : number of local dofs
    dof_coords : (ndofs, 2) reference coordinates of the nodal points
    """

    degree = None
    ndofs = None
    dof_coords = None

    @classmethod
    def eval_basis(cls, pts):
        """Tabulate basis values; returns (npts, ndofs)."""
        raise NotImplementedError

    @classmethod
    def eval_grad(cls, pts):
        """Tabulate reference gradients; returns (npts, ndofs, 2)."""
        raise NotImplementedError

    # -- facet machinery (shared) ------------------------------------

    @classmethod
    def facet_points(cls, ts):
        """Reference coordinates of facet quadrature points.

        ``ts``: (nqf,) parameter values in [0,1].
        Returns (6, nqf, 2): for each variant, the reference coords.
        """
        verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        out = np.zeros((6, len(ts), 2))
        for lf in range(3):
            a = verts[FACET_VERTICES[lf, 0]]
            b = verts[FACET_VERTICES[lf, 1]]
            fwd = a[None, :] + ts[:, None] * (b - a)[None, :]
            rev = b[None, :] + ts[:, None] * (a - b)[None, :]
            out[lf * 2 + 0] = fwd
            out[lf * 2 + 1] = rev
        return out

    @classmethod
    def tabulate(cls, quad_degree):
        """Full tabulation bundle used by the assembly kernels.

        Returns a dict of numpy arrays:
          qp (nq,2), qw (nq,), phi (nq,nd), dphi (nq,nd,2),
          qt (nqf,), qwf (nqf,),
          phi_f (6,nqf,nd), dphi_f (6,nqf,nd,2)
        """
        qp, qw = triangle_quadrature(quad_degree)
        qt, qwf = edge_quadrature(quad_degree)
        fpts = cls.facet_points(qt)  # (6, nqf, 2)
        phi_f = np.stack([cls.eval_basis(fpts[v]) for v in range(6)])
        dphi_f = np.stack([cls.eval_grad(fpts[v]) for v in range(6)])
        return dict(
            qp=qp,
            qw=qw,
            phi=cls.eval_basis(qp),
            dphi=cls.eval_grad(qp),
            qt=qt,
            qwf=qwf,
            phi_f=phi_f,
            dphi_f=dphi_f,
            phi_nodes=cls.eval_basis(cls.dof_coords),
        )


class P0Tri(ReferenceElement):
    degree = 0
    ndofs = 1
    dof_coords = np.array([[1 / 3, 1 / 3]])

    @classmethod
    def eval_basis(cls, pts):
        return np.ones((len(pts), 1))

    @classmethod
    def eval_grad(cls, pts):
        return np.zeros((len(pts), 1, 2))


class P1Tri(ReferenceElement):
    degree = 1
    ndofs = 3
    dof_coords = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])

    @classmethod
    def eval_basis(cls, pts):
        x, y = pts[:, 0], pts[:, 1]
        return np.stack([1.0 - x - y, x, y], axis=1)

    @classmethod
    def eval_grad(cls, pts):
        g = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        return np.broadcast_to(g, (len(pts), 3, 2)).copy()


class P2Tri(ReferenceElement):
    """Quadratic Lagrange: vertex dofs 0-2, then edge-midpoint dofs 3-5
    where dof 3+i sits on facet i (opposite vertex i)."""

    degree = 2
    ndofs = 6
    dof_coords = np.array(
        [
            [0.0, 0.0],
            [1.0, 0.0],
            [0.0, 1.0],
            [0.5, 0.5],
            [0.0, 0.5],
            [0.5, 0.0],
        ]
    )

    @classmethod
    def _bary(cls, pts):
        x, y = pts[:, 0], pts[:, 1]
        return np.stack([1.0 - x - y, x, y], axis=1)

    @classmethod
    def eval_basis(cls, pts):
        lam = cls._bary(pts)
        l0, l1, l2 = lam[:, 0], lam[:, 1], lam[:, 2]
        return np.stack(
            [
                l0 * (2 * l0 - 1),
                l1 * (2 * l1 - 1),
                l2 * (2 * l2 - 1),
                4 * l1 * l2,
                4 * l2 * l0,
                4 * l0 * l1,
            ],
            axis=1,
        )

    @classmethod
    def eval_grad(cls, pts):
        lam = cls._bary(pts)
        l0, l1, l2 = lam[:, 0], lam[:, 1], lam[:, 2]
        # d lambda / d(x,y)
        d0 = np.array([-1.0, -1.0])
        d1 = np.array([1.0, 0.0])
        d2 = np.array([0.0, 1.0])
        n = len(pts)
        g = np.zeros((n, 6, 2))
        g[:, 0] = (4 * l0 - 1)[:, None] * d0
        g[:, 1] = (4 * l1 - 1)[:, None] * d1
        g[:, 2] = (4 * l2 - 1)[:, None] * d2
        g[:, 3] = 4 * (l1[:, None] * d2 + l2[:, None] * d1)
        g[:, 4] = 4 * (l2[:, None] * d0 + l0[:, None] * d2)
        g[:, 5] = 4 * (l0[:, None] * d1 + l1[:, None] * d0)
        return g


ELEMENTS = {("DG", 0): P0Tri, ("DG", 1): P1Tri, ("DG", 2): P2Tri,
            ("CG", 1): P1Tri, ("CG", 2): P2Tri}
