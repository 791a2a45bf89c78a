r"""3D diagnostic operators.

Port of the main-path parts of ``thetis_tpu/equations/utility3d.py`` on
the column-local extruded tensors:

  VerticalVelocitySolver   w from the weak (flux-consistent) continuity
                           solve, or by pointwise column integration
  DensitySolver            pointwise EOS evaluation
  BaroclinicHeadCalculator r = -1/rho0 int_z^eta rho' dz and
                           int_pg = g grad_h(r) (P1 head)
  expand_function_to_3d / extract_surface_2d / extract_bottom_2d:
                           2D<->3D copies as broadcasts and slices

Not ported yet (ROADMAP A7): the quadratic (P2) head and density, the
weak density projection, the velocity-magnitude and Smagorinsky solvers
and the HCC metric.
"""
import numpy as np
import torch

from ..config import physical_constants

__all__ = [
    "VerticalVelocitySolver",
    "DensitySolver",
    "BaroclinicHeadCalculator",
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


class DensitySolver:
    """Pointwise EOS evaluation at dof points."""

    def __init__(self, eos, rho0=None):
        self.eos = eos
        self.rho0 = physical_constants["rho0"] if rho0 is None else rho0

    def solve(self, salt, temp, pressure=0.0):
        """density anomaly rho' = rho(S,T,p) - rho0."""
        return self.eos.compute_rho(salt, temp, pressure, self.rho0)


class BaroclinicHeadCalculator:
    r"""Baroclinic head r = -1/rho0 int_z^eta rho' dz and the internal
    pressure gradient int_pg = g grad_h(r), both on the P1 x P1 prism
    space."""

    def __init__(self, asm3d):
        self.asm3d = asm3d
        self.rho0 = physical_constants["rho0"]
        self.g = physical_constants["g_grav"]

    def compute_head(self, rho_prime, geom, quadratic=False):
        """Density anomaly (nc, 3, nz, 2) -> baroclinic head at dofs
        (nc, 3, nz, 2)."""
        if quadratic or rho_prime.shape[3] != 2:
            raise NotImplementedError(
                "the quadratic baroclinic head is not ported to "
                "thetis_tpu_torch yet (ROADMAP A7)")
        Delta = geom["Delta_nodes"]                # (nc, 3, nz)
        rb, rt = rho_prime[..., 0], rho_prime[..., 1]
        layer_int = Delta * 0.5 * (rb + rt)
        # integral from the free surface down to the top of each layer
        csum = torch.flip(torch.cumsum(torch.flip(layer_int, [2]), 2), [2])
        above = csum - layer_int
        scale = -1.0 / self.rho0
        return torch.stack([scale * csum, scale * above], dim=3)

    def compute_int_pg(self, baroc_head, geom):
        """int_pg = g grad_h(r) projected to dofs: (nc, 3, nz, 2, 2)."""
        a3 = self.asm3d
        gr = a3.cell_grads(baroc_head, geom)[..., 0:2]
        return a3.mass_inverse(a3.cell_to_dofs(self.g * gr, geom), geom)
