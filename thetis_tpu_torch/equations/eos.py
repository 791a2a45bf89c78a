r"""Equations of state for seawater density.

Port of ``thetis_tpu/equations/eos.py``:

  JackettEquationOfState  the nonlinear rational EOS of Jackett et al.
      (2006), 25 coefficients, rho = P1(T,S,p)/P2(T,S,p)
  LinearEquationOfState   rho = rho_ref - alpha (T-T_ref) + beta (S-S_ref)

Evaluated pointwise on tensors (pressure may be a Python scalar).
"""
import torch

__all__ = ["JackettEquationOfState", "LinearEquationOfState"]


def as_tensor_like(x, *others):
    """``x`` as a tensor: as it is, else in the dtype and on the device
    of the first tensor among ``others``, else in float64 (the
    reference's pointwise closures take numbers and arrays as well as its
    own arrays)."""
    if isinstance(x, torch.Tensor):
        return x
    ref = next((o for o in others if isinstance(o, torch.Tensor)), None)
    if ref is None:
        return torch.as_tensor(x, dtype=torch.float64)
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


class JackettEquationOfState:
    """Jackett et al. (2006) 25-coefficient rational EOS (coefficients
    from the paper's Table A2)."""

    a = (
        9.9984085444849347e2, 7.3471625860981584e0, -5.3211231792841769e-2,
        3.6492439109814549e-4, 2.5880571023991390e0, -6.7168282786692355e-3,
        1.9203202055760151e-3, 1.1798263740430364e-2, 9.8920219266399117e-8,
        4.6996642771754730e-6, -2.5862187075154352e-8, -3.2921414007960662e-12,
    )
    b = (
        1.0, 7.2815210113327091e-3, -4.4787265461983921e-5,
        3.3851002965802430e-7, 1.3651202389758572e-10, 1.7632126669040377e-3,
        -8.8066583251206474e-6, -1.8832689434804897e-10, 5.7463776745432097e-6,
        1.4716275472242334e-9, 6.7103246285651894e-6, -2.4461698007024582e-17,
        -9.1534417604289062e-18,
    )

    def compute_rho(self, s, th, p, rho0=0.0):
        """Water density minus ``rho0``.

        :arg s: salinity (psu), :arg th: potential temperature (C),
        :arg p: pressure (dbar), :arg rho0: reference value subtracted
        """
        a, b = self.a, self.b
        # arrays as tensors; numbers stay numbers (the density solver
        # passes a scalar pressure), but the clipped salinity
        th, p = (as_tensor_like(v, s, th, p) if hasattr(v, "__array__")
                 else v for v in (th, p))
        s_pos = torch.clamp_min(as_tensor_like(s, th, p), 0.0)  # s < 0 clipped
        pn = (
            a[0] + th * a[1] + th * th * a[2] + th * th * th * a[3]
            + s_pos * a[4] + th * s_pos * a[5] + s_pos * s_pos * a[6]
            + p * a[7] + p * th * th * a[8] + p * s_pos * a[9]
            + p * p * a[10] + p * p * th * th * a[11]
        )
        s32 = torch.sqrt(s_pos ** 3)
        pd = (
            b[0] + th * b[1] + th * th * b[2] + th * th * th * b[3]
            + th * th * th * th * b[4] + s_pos * b[5] + s_pos * th * b[6]
            + s_pos * th * th * th * b[7]
            + s32 * b[8] + s32 * th * th * b[9]
            + p * b[10] + p * p * th * th * th * b[11] + p * p * p * th * b[12]
        )
        return pn / pd - rho0

    def eval(self, s, th, p, rho0=0.0):
        return self.compute_rho(s, th, p, rho0)


class LinearEquationOfState:
    """rho = rho_ref - alpha (T - T_ref) + beta (S - S_ref)."""

    def __init__(self, rho_ref=1000.0, alpha=0.2, beta=0.77, th_ref=15.0,
                 s_ref=35.0):
        self.rho_ref = rho_ref
        self.alpha = alpha
        self.beta = beta
        self.th_ref = th_ref
        self.s_ref = s_ref

    def compute_rho(self, s, th, p, rho0=0.0):
        return (
            self.rho_ref - rho0
            - self.alpha * (th - self.th_ref)
            + self.beta * (s - self.s_ref)
        )

    def eval(self, s, th, p, rho0=0.0):
        return self.compute_rho(s, th, p, rho0)
