r"""3D diagnostic operators.

Port of ``thetis_tpu/equations/utility3d.py`` on the column-local
extruded tensors:

  VerticalVelocitySolver   w from the weak (flux-consistent) continuity
                           solve, or by pointwise column integration
  DensitySolver            pointwise EOS evaluation, on the P1 or the
                           quadratic (P2) vertical space
  DensitySolverWeak        the EOS L2-projected onto the density field
  VelocityMagnitudeSolver  |(u, v, w)| L2-projected, clipped from below
  BaroclinicHeadCalculator r = -1/rho0 int_z^eta rho' dz and
                           int_pg = g grad_h(r) (P1 or P2DG x P2 head)
  SmagorinskyViscosity     nu = (C_s hmin)^2 |S|
  Mesh3DConsistencyCalculator  the hydrostatic consistency metric
  expand_function_to_3d / extract_surface_2d / extract_bottom_2d:
                           2D<->3D copies as broadcasts and slices
"""
import numpy as np
import torch

from ..config import physical_constants
from ..utils.log import print_output

__all__ = [
    "VerticalVelocitySolver",
    "DensitySolver",
    "DensitySolverWeak",
    "VelocityMagnitudeSolver",
    "BaroclinicHeadCalculator",
    "SmagorinskyViscosity",
    "Mesh3DConsistencyCalculator",
    "expand_function_to_3d",
    "extract_surface_2d",
    "extract_bottom_2d",
]


def expand_function_to_3d(u2d, nz):
    """2D nodal field (nc, 3[, k]) -> 3D (nc, 3, nz, 2[, k]) by vertical
    broadcast (a view: do not update it in place)."""
    return u2d[:, :, None, None].expand(
        tuple(u2d.shape[:2]) + (nz, 2) + tuple(u2d.shape[2:]))


def extract_surface_2d(u3d):
    """3D -> 2D: value at the free surface (top node of the top layer)."""
    return u3d[:, :, -1, 1]


def extract_bottom_2d(u3d):
    """3D -> 2D: value at the bed (bottom node of the bottom layer)."""
    return u3d[:, :, 0, 0]


class VerticalVelocitySolver:
    r"""Diagnostic vertical velocity from incompressibility:
    dw/dz = -div_h(uv), w(-h) = -uv . grad(h).

    * :meth:`solve` integrates the projected horizontal divergence up
      each column.
    * :meth:`solve_weak` is the weak continuity solve: find ``w`` such
      that the DG advection operator applied to the uniform tracer
      vanishes,

          \int w d(phi)/dz dV - \oint \hat w [phi n_z] dS
              = -( \int uv . grad_h(phi) dV - \oint avg(uv).n [phi] dS )

      with central interface fluxes, the bottom flux closed and the
      surface flux from the own trace.  The operator factorizes as
      ``M_h (x) T`` over the extruded layout, so the solve is two small
      constant contractions (``T^{-1}`` over the vertical profile,
      ``M_h^{-1}`` per triangle) applied to one weak-divergence assembly.
    """

    def __init__(self, asm3d, bathymetry_cell):
        """:arg bathymetry_cell: (nc, 3) bathymetry at horizontal nodes"""
        self.asm3d = asm3d
        self.bathy_cell = bathymetry_cell
        asm2 = asm3d.asm2d
        mesh = asm3d.mesh
        # nodal horizontal gradient of bathymetry (P1 per cell: constant)
        self.grad_h = asm2.cell_grads(bathymetry_cell)[:, 0]  # (nc, 2)
        is_bnd = np.asarray(mesh.facet_is_boundary_np)

        def dev(a):
            return torch.as_tensor(a, dtype=mesh.dtype, device=mesh.device)

        self._mask_int = dev((~is_bnd).astype(np.float64))
        self._mask_bnd = dev(is_bnd.astype(np.float64))
        # constant factors of the weak operator M_h (x) T (see class doc)
        self._Mh_inv_ref = dev(np.linalg.inv(np.asarray(asm2._Mref_np)))
        nz = asm3d.nz
        N = 2 * nz
        T = np.zeros((N, N))
        # volume: + int psi_a psi'_pp per layer (rows = tests (k, pp))
        D = np.array([[-0.5, 0.5], [-0.5, 0.5]])  # D[a, pp]
        for k in range(nz):
            for a in range(2):
                for pp in range(2):
                    T[2 * k + pp, 2 * k + a] += D[a, pp]
        # interior interfaces: central flux f_i = (w[2i-1] + w[2i]) / 2,
        # below test row gets -f, above test row +f
        for i in range(1, nz):
            T[2 * i - 1, 2 * i - 1] += -0.5
            T[2 * i - 1, 2 * i] += -0.5
            T[2 * i, 2 * i - 1] += 0.5
            T[2 * i, 2 * i] += 0.5
        # surface: own-trace outflux on the top test row (bottom closed)
        T[N - 1, N - 1] += -1.0
        self._T_inv = dev(np.linalg.inv(T))

    def weak_divergence_rhs(self, uv3d, geom):
        """The weak divergence of ``uv3d`` tested against the 3D test set:
        the horizontal-advection operator of ``TracerEquation3D`` at
        tracer == 1 (same cell term, same central inter-column fluxes,
        same own-trace boundary flux), with the opposite sign."""
        a3 = self.asm3d
        uv_q = a3.cell_values(uv3d)               # (nc, nz, nq, nqv, 2)
        acc = torch.cat([uv_q, torch.zeros_like(uv_q[..., :1])], dim=-1)
        r = a3.grad_to_dofs(acc, geom)
        uv_tr = a3.facet_traces(uv3d)             # (nf, 2, nz, nqf, nqv, 2)
        n = a3.mesh.facet_normal[:, None, None, None, :]
        un0 = (uv_tr[:, 0] * n).sum(-1)
        un1 = (uv_tr[:, 1] * n).sum(-1)
        un_av = 0.5 * (un0 + un1)
        mi = self._mask_int.reshape(-1, 1, 1, 1)
        mb = self._mask_bnd.reshape(-1, 1, 1, 1)
        acc_f = torch.stack([-un_av * mi - un0 * mb, un_av * mi], dim=1)
        return -(r + a3.vfacet_to_dofs(acc_f, geom))

    def solve_weak(self, uv3d, geom):
        """:arg uv3d: (nc, 3, nz, 2, 2); returns w (nc, 3, nz, 2) from
        the weak continuity equation (see class doc)."""
        rhs = self.weak_divergence_rhs(uv3d, geom)
        mesh = self.asm3d.mesh
        t = torch.einsum("ij,cjlv->cilv", self._Mh_inv_ref, rhs) \
            / mesh.detJ[:, None, None, None]
        nc = rhs.shape[0]
        w = t.reshape(nc, 3, -1) @ self._T_inv.T
        return w.reshape(rhs.shape)

    def solve(self, uv3d, geom):
        """:arg uv3d: (nc, 3, nz, 2, 2); returns w (nc, 3, nz, 2) by
        integrating the projected divergence up from the bed."""
        a3 = self.asm3d
        g = a3.cell_grads(uv3d, geom)             # (nc,nz,nq,nqv,2,3)
        div_h = g[..., 0, 0] + g[..., 1, 1]
        div_dofs = a3.mass_inverse(a3.cell_to_dofs(div_h, geom), geom)
        w_cum = a3.cumulative_integral(div_dofs, geom, from_top=False)
        uv_bot = uv3d[:, :, 0, 0]                 # (nc, 3, 2)
        w_b = -(uv_bot * self.grad_h[:, None, :]).sum(-1)  # (nc, 3)
        return w_b[:, :, None, None] - w_cum


def _to_p2_nodes(u):
    """P1DG horizontal nodal data (nc, 3, ...) -> P2DG nodes (nc, 6, ...):
    the vertices, then the edge midpoints (m12, m02, m01) of
    ``Assembler3D.p2_htabs``.  Linear interpolation, exact for the P1
    fields (density traces, z interfaces) it is given."""
    mids = torch.stack([0.5 * (u[:, 1] + u[:, 2]), 0.5 * (u[:, 0] + u[:, 2]),
                        0.5 * (u[:, 0] + u[:, 1])], dim=1)
    return torch.cat([u, mids], dim=1)


class DensitySolver:
    """Pointwise EOS evaluation at dof points."""

    def __init__(self, eos, rho0=None):
        self.eos = eos
        self.rho0 = physical_constants["rho0"] if rho0 is None else rho0

    def solve(self, salt, temp, pressure=0.0):
        """density anomaly rho' = rho(S,T,p) - rho0."""
        return self.eos.compute_rho(salt, temp, pressure, self.rho0)

    def solve_p2(self, salt, temp, pressure=0.0, horizontal=False):
        """Density anomaly on the quadratic vertical space: the EOS at the
        layer bottom, middle and top, with T and S interpolated linearly
        to the middle (a nonlinear EOS then differs there from the mean
        of the node densities).

        :kwarg horizontal: also at the 3 horizontal edge midpoints (T and
            S interpolated linearly there): the P2DG x P2 density
        :returns: (nc, 3 or 6, nz, 3), vertical nodes s = 0, 1/2, 1
        """
        layered = isinstance(pressure, torch.Tensor) and pressure.dim() >= 4
        if horizontal:
            salt, temp = _to_p2_nodes(salt), _to_p2_nodes(temp)
            if layered:
                pressure = _to_p2_nodes(pressure)

        def mid(u):
            return 0.5 * (u[..., 0] + u[..., 1])

        p_b = p_t = p_m = pressure
        if layered:
            p_b, p_t, p_m = pressure[..., 0], pressure[..., 1], mid(pressure)
        rho_b = self.eos.compute_rho(salt[..., 0], temp[..., 0], p_b,
                                     self.rho0)
        rho_t = self.eos.compute_rho(salt[..., 1], temp[..., 1], p_t,
                                     self.rho0)
        rho_m = self.eos.compute_rho(mid(salt), mid(temp), p_m, self.rho0)
        return torch.stack([rho_b, rho_m, rho_t], dim=-1)


class DensitySolverWeak:
    """The EOS evaluated at quadrature points and L2-projected onto the
    density field: differs from :class:`DensitySolver` when the EOS is
    nonlinear (Jackett)."""

    def __init__(self, asm3d, eos, rho0=None):
        self.asm3d = asm3d
        self.eos = eos
        self.rho0 = physical_constants["rho0"] if rho0 is None else rho0

    def solve(self, salt, temp, geom, pressure=0.0):
        a3 = self.asm3d
        rho_q = self.eos.compute_rho(a3.cell_values(salt),
                                     a3.cell_values(temp), pressure,
                                     self.rho0)
        return a3.mass_inverse(a3.cell_to_dofs(rho_q, geom), geom)


class VelocityMagnitudeSolver:
    """|(u, v, w)| L2-projected onto a scalar 3D field and clipped to at
    least ``min_val``; ``uv`` or ``w`` may be None."""

    def __init__(self, asm3d, min_val=1e-6):
        self.asm3d = asm3d
        self.min_val = float(min_val)

    def solve(self, geom, uv=None, w=None):
        a3 = self.asm3d
        s = 0.0
        if uv is not None:
            s = s + (a3.cell_values(uv) ** 2).sum(dim=-1)
        if w is not None:
            s = s + a3.cell_values(w) ** 2
        out = a3.mass_inverse(a3.cell_to_dofs(torch.sqrt(s), geom), geom)
        return torch.clamp_min(out, self.min_val)


class BaroclinicHeadCalculator:
    r"""Baroclinic head r = -1/rho0 int_z^eta rho' dz and the internal
    pressure gradient int_pg = g grad_h(r).

    With ``quadratic=True`` the head lives on the P2DG x P2 space: the
    density is interpolated to the 6 horizontal nodes and the head holds
    the exact in-layer antiderivative at the s-nodes 0, 1/2, 1 (the
    integral of a layer-linear density is quadratic in z)."""

    def __init__(self, asm3d):
        self.asm3d = asm3d
        self.rho0 = physical_constants["rho0"]
        self.g = physical_constants["g_grav"]

    _to_p2_nodes = staticmethod(_to_p2_nodes)

    def compute_head(self, rho_prime, geom, quadratic=False):
        """Density anomaly, (nc, 3, nz, 2) P1 or (nc, 3 or 6, nz, 3) P2
        vertical -> the head at dofs: (nc, 3, nz, 2), or (nc, 6, nz, 3)
        with ``quadratic``."""
        if quadratic:
            if rho_prime.shape[1] == 3:
                rho_prime = _to_p2_nodes(rho_prime)
            z_if6 = _to_p2_nodes(geom["z_if"])
            Delta = z_if6[..., 1:] - z_if6[..., :-1]       # (nc, 6, nz)
        else:
            Delta = geom["Delta_nodes"]                    # (nc, 3, nz)
        p2_in = rho_prime.shape[3] == 3
        if p2_in:
            rb, rm, rt = (rho_prime[..., 0], rho_prime[..., 1],
                          rho_prime[..., 2])
            # Simpson: exact for the quadratic in-layer density
            layer_int = Delta * (rb + 4.0 * rm + rt) / 6.0
        else:
            rb, rt = rho_prime[..., 0], rho_prime[..., 1]
            layer_int = Delta * 0.5 * (rb + rt)
        # integral from the free surface down to the top of each layer
        csum = torch.flip(torch.cumsum(torch.flip(layer_int, [2]), 2), [2])
        above = csum - layer_int
        scale = -1.0 / self.rho0
        if not quadratic:
            return torch.stack([scale * csum, scale * above], dim=3)
        # in-layer antiderivative int_s^1 rho on the Lagrange {0, 1/2, 1}
        # density at s = 1/2: basis integrals (-1/24, 1/3, 5/24); for a P1
        # density the trapezoid tail (1/8, 3/8)
        if p2_in:
            tail_mid = Delta * (-rb / 24.0 + rm / 3.0 + 5.0 * rt / 24.0)
        else:
            tail_mid = Delta * (rb / 8.0 + 3.0 * rt / 8.0)
        return torch.stack([scale * csum, scale * (above + tail_mid),
                            scale * above], dim=3)

    def compute_int_pg(self, baroc_head, geom):
        """int_pg = g grad_h(r) projected to dofs: (nc, 3, nz, 2, 2), from
        the P1 or the quadratic head (its gradient at the same quadrature
        points)."""
        a3 = self.asm3d
        vtabs = a3.p2_vtabs if baroc_head.shape[3] == 3 else None
        htabs = a3.p2_htabs if baroc_head.shape[1] == 6 else None
        gr = a3.cell_grads(baroc_head, geom, vtabs=vtabs,
                           htabs=htabs)[..., 0:2]
        return a3.mass_inverse(a3.cell_to_dofs(self.g * gr, geom), geom)


class SmagorinskyViscosity:
    r"""nu = (C_s hmin)^2 |S|, |S|^2 = du/dx^2 + dv/dy^2
    + 0.5 (du/dy + dv/dx)^2, projected to the dofs and clamped to
    [``min_visc``, ``max_visc``]."""

    def __init__(self, asm3d, cs=0.1, max_visc=None, min_visc=1e-10):
        self.asm3d = asm3d
        self.cs = cs
        self.max_visc = max_visc
        self.min_visc = min_visc
        mesh = asm3d.mesh
        self.dx2 = torch.as_tensor((cs * mesh.cell_hmin_np) ** 2,
                                   dtype=mesh.dtype, device=mesh.device)

    def solve(self, uv3d, geom):
        """:arg uv3d: (nc, 3, nz, 2, 2); returns nu (nc, 3, nz, 2)."""
        a3 = self.asm3d
        g = a3.cell_grads(uv3d, geom)             # (nc,nz,nq,nqv,2,3)
        dudx, dudy = g[..., 0, 0], g[..., 0, 1]
        dvdx, dvdy = g[..., 1, 0], g[..., 1, 1]
        s_mag = torch.sqrt(dudx**2 + dvdy**2 + 0.5 * (dudy + dvdx) ** 2)
        nu_q = self.dx2[:, None, None, None] * s_mag
        nu = a3.mass_inverse(a3.cell_to_dofs(nu_q, geom), geom)
        nu = torch.clamp_min(nu, self.min_visc)
        if self.max_visc is not None:
            nu = torch.clamp_max(nu, self.max_visc)
        return nu


class Mesh3DConsistencyCalculator:
    r"""Hydrostatic consistency criterion (HCC) of the extruded mesh: per
    prism, the largest z difference across its top (bottom) facet over the
    local prism height; 0 for straight prisms, above ~1 a sign of internal
    pressure-gradient errors."""

    def __init__(self, solver_obj=None):
        self.solver_obj = solver_obj

    @staticmethod
    def compute(z_interfaces):
        """(nc, 3, nz+1) interface z -> (nc, 3, nz, 2) HCC metric
        ([..., 0] the bottom facet's ratio, [..., 1] the top's)."""
        z_bot, z_top = z_interfaces[:, :, :-1], z_interfaces[:, :, 1:]
        dz_top = (z_top.amax(dim=1, keepdim=True)
                  - z_top.amin(dim=1, keepdim=True))
        dz_bot = (z_bot.amax(dim=1, keepdim=True)
                  - z_bot.amin(dim=1, keepdim=True))
        h = torch.clamp_min(z_top - z_bot, 1e-14)
        return torch.stack([dz_bot / h, dz_top / h], dim=-1)

    def solve(self):
        """The metric on the solver's current mesh (interfaces from the
        current elevation), with its range logged."""
        so = self.solver_obj
        out = self.compute(so.extruded.z_interfaces(so.bathy_cell,
                                                    so.fields.elev_2d.data))
        print_output(f"HCC: {float(out.min()):.4f} .. "
                     f"{float(out.max()):.4f}")
        return out
