"""Carry states, fields and bathymetry between numpy and the port.

Both packages are fed from the same numpy data: the reference through
``jnp.asarray``, the port through these helpers; results come back as
numpy for comparison.
"""
import datetime

import numpy as np
import torch

__all__ = ["state_from_numpy", "state_to_numpy", "fields_from_numpy",
           "fields_to_numpy", "bathymetry_from_numpy", "bathymetry_to_numpy",
           "state3d_from_numpy", "state3d_to_numpy", "state3d_keys",
           "flowsolver3d_from_numpy", "flowsolver2d_from_reference",
           "wd_alpha_from_numpy", "sphere_mesh_from_reference"]

_STATE_KEYS = ("elev", "uv")
#: the 3D step's state dict (``FlowSolver._get_state``) under the default
#: options; ``state3d_keys`` gives it under others
STATE3D_KEYS = ("elev", "psi_3d", "salt_3d", "split_residual", "temp_3d",
                "tke_3d", "uv", "uv_3d")
#: the lagged eddy coefficients of ``use_turbulence``
STATE3D_TURBULENCE_KEYS = ("mu_v_3d", "nu_v_3d")
#: the LeapFrogAM3 history, and that of tke/psi under
#: ``use_turbulence_advection``
STATE3D_LEAPFROG_KEYS = ("salt_lf_old", "temp_lf_old", "uv_lf_old")
STATE3D_LEAPFROG_TURBULENCE_KEYS = ("psi_lf_old", "tke_lf_old")


def state3d_keys(options=None):
    """The sorted keys of the 3D step state under ``options`` (a
    ``ModelOptions3d``, a dict of options, or None for the defaults)."""
    if isinstance(options, dict):
        opt = options.get
    else:
        def opt(k, default):
            return getattr(options, k, default)
    turb = opt("use_turbulence", False)
    leapfrog = str(opt("timestepper_type", "")) == "LeapFrogAM3"
    keys = set(STATE3D_KEYS)
    if not opt("use_modesplit_2d", True):
        keys.discard("split_residual")
    if turb:
        keys.update(STATE3D_TURBULENCE_KEYS)
    if leapfrog:
        keys.update(STATE3D_LEAPFROG_KEYS)
        if turb and opt("use_turbulence_advection", False):
            keys.update(STATE3D_LEAPFROG_TURBULENCE_KEYS)
    return tuple(sorted(keys))


def _to_tensor(v, device, dtype):
    return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                           device=device)


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").numpy()
    return np.asarray(v)


def state_from_numpy(d, device, dtype):
    """The SWE state ``{"uv", "elev"}`` as numpy arrays -> tensors, in the
    element family's layout: ``(nc,3,2)`` / ``(nc,3)`` for dg-dg, a CG2
    elevation ``(nv + nf,)`` for dg-cg, facet dofs ``(nf,)`` (RT1) or
    ``(nf, 2)`` (BDM1) with ``(nc, 1)`` for the p = 0 H(div) pairs, flat
    RT2 / BDM2 dofs with ``(nc, 3)`` for p = 1.  A tracer system's state
    (``{label: (nc, 3) or (nv,)}``) is ``fields_from_numpy``'s."""
    if sorted(d) != list(_STATE_KEYS):
        raise KeyError(f"swe state needs keys {_STATE_KEYS}, got {sorted(d)}")
    return {k: _to_tensor(v, device, dtype) for k, v in d.items()}


def state_to_numpy(s):
    return {k: _to_numpy(v) for k, v in s.items()}


def fields_from_numpy(d, device, dtype):
    """Coefficient fields (scalars or arrays) -> tensors (0-d for
    scalars)."""
    return {k: _to_tensor(v, device, dtype) for k, v in d.items()}


def fields_to_numpy(d):
    return {k: _to_numpy(v) for k, v in d.items()}


def bathymetry_from_numpy(b, device, dtype):
    """Bathymetry: a Python scalar stays a float (constant depth); an
    array (CG1 (nv,) or DG (nc, nd)) becomes a tensor."""
    if np.isscalar(b):
        return float(b)
    return _to_tensor(b, device, dtype)


def bathymetry_to_numpy(b):
    return float(b) if np.isscalar(b) else _to_numpy(b)


def sphere_mesh_from_reference(ref, device, dtype):
    """The port's :class:`~.mesh.sphere.SphereMesh` with the reference
    sphere's vertices, (already outward-oriented) cells, radius and name
    on ``device`` in ``dtype``: the same tables."""
    from .mesh.sphere import SphereMesh

    return SphereMesh(np.asarray(ref.coords_np), np.asarray(ref.cells_np),
                      radius=ref.radius, name=ref.name, device=device,
                      dtype=dtype)


def wd_alpha_from_numpy(alpha, mesh2d):
    """A wetting-and-drying alpha: a scalar stays a float, a P1 array
    ``(nv,)`` becomes a CG1 :class:`~.fem.functionspace.Function` on
    ``mesh2d`` (the form ``set_wetting_and_drying_alpha`` gives)."""
    from .fem.functionspace import Function, FunctionSpace

    if np.isscalar(alpha) or np.ndim(alpha) == 0:
        return float(alpha)
    a = np.asarray(alpha, dtype=np.float64)
    if a.shape != (mesh2d.nv,):
        raise ValueError(f"alpha must be a scalar or P1 (nv,), got "
                         f"{a.shape}")
    return Function(FunctionSpace(mesh2d, "CG", 1), name="wd_alpha",
                    data=_to_tensor(a, mesh2d.device, mesh2d.dtype))


def state3d_from_numpy(d, device, dtype, options=None):
    """The 3D step state (``uv`` (nc,3,2), ``elev`` (nc,3), ``uv_3d``
    (nc,3,nz,2,2), ``salt_3d``/``temp_3d``/``tke_3d``/``psi_3d``
    (nc,3,nz,2), ``split_residual`` (nc,3,2) and, when ``options`` has
    ``use_turbulence``, ``nu_v_3d``/``mu_v_3d`` (nc,3,nz,2)) as numpy
    arrays -> tensors.  Any other key set is refused."""
    want = state3d_keys(options)
    if tuple(sorted(d)) != want:
        raise KeyError(f"3D state needs keys {want}, got "
                       f"{tuple(sorted(d))}")
    return {k: _to_tensor(v, device, dtype) for k, v in d.items()}


def state3d_to_numpy(s):
    return {k: _to_numpy(v) for k, v in s.items()}


_NEWTON_FIELDS = ("snes_rtol", "snes_atol", "snes_max_it", "ksp_rtol",
                  "ksp_max_it", "gmres_restart", "line_search", "dense",
                  "monitor_convergence")
#: option objects of the reference that the port builds itself
_SUB_OPTIONS = ("swe_timestepper_options", "tracer_timestepper_options",
                "sediment_timestepper_options", "exner_timestepper_options",
                "sediment_model_options", "nh_model_options")
#: of those, the ones whose values are carried across
_CARRIED_SUB_OPTIONS = ("swe_timestepper_options",
                        "tracer_timestepper_options",
                        "sediment_model_options", "nh_model_options")
#: the turbine farm options (``{subdomain: farm options or a list}``)
_FARM_OPTIONS = ("tidal_turbine_farms", "discrete_tidal_turbine_farms")


def _option_value(v, device, dtype, mesh=None):
    """A reference option value in the port's terms: arrays (numpy or the
    reference's device arrays, read through ``np.asarray``) become
    tensors, a Function the port's Function of the same family on
    ``mesh`` (its data alone without one), Constants and NewtonParameters
    the port's own classes, a ``GLSModelOptions`` the port's own by its
    attributes (all plain numbers, switches and names); plain Python
    values pass through."""
    from .equations.turbulence import GLSModelOptions
    from .solvers.newton import NewtonParameters
    from .utils.constant import Constant

    if v is None or isinstance(v, (bool, int, float, str, dict, list,
                                   datetime.datetime)):
        return v
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    kind = type(v).__name__
    if kind == "Constant":
        return Constant(np.asarray(v))
    if kind == "NewtonParameters":
        return NewtonParameters(**{k: getattr(v, k) for k in _NEWTON_FIELDS})
    if kind == "GLSModelOptions":
        return GLSModelOptions(**vars(v))
    if kind == "Function":
        data = _to_tensor(np.asarray(v.data), device, dtype)
        if mesh is None:
            return data
        from .fem.functionspace import Function, FunctionSpace
        fs = v.function_space
        return Function(FunctionSpace(mesh, fs.family, fs.degree,
                                      dim=fs.dim), data=data)
    if hasattr(v, "__array__"):
        return _to_tensor(np.asarray(v), device, dtype)
    raise TypeError(f"cannot carry option value of type {kind} to the port")


def _tracer_options(ro, conv):
    """The port's TracerFieldOptions for each of the reference's: the
    numbers and names as they are, a source or diffusivity converted (a
    callable source, which reads the reference's arrays, is left to the
    caller: it becomes None)."""
    from .model.options import TracerFieldOptions

    out = {}
    for label, t in ro.items():
        out[label] = TracerFieldOptions(
            label, name=t.name, filename=t.filename, shortname=t.shortname,
            unit=t.unit,
            source=None if callable(t.source) else conv(t.source),
            diffusivity=conv(t.diffusivity),
            use_conservative_form=t.use_conservative_form)
    return out


def _farm_options(fo, conv):
    """The port's farm options object for a reference one: the same class
    by name, every value converted (the density Function among them), the
    turbine options attribute by attribute; lists and numpy tables pass
    as they are."""
    from .model import turbines

    out = getattr(turbines, type(fo).__name__)()
    for k, v in vars(fo).items():
        if k.startswith("_"):
            continue
        if k == "turbine_options":
            to = out.turbine_options
            for tk, tv in vars(v).items():
                if not tk.startswith("_"):
                    setattr(to, tk, tv if isinstance(tv, (list, np.ndarray))
                            else conv(tv))
        elif isinstance(v, (list, np.ndarray)):
            setattr(out, k, v)
        else:
            setattr(out, k, conv(v))
    return out


def flowsolver2d_from_reference(ref, mesh2d):
    """The port's :class:`~thetis_tpu_torch.model.flowsolver2d.FlowSolver2d`
    on ``mesh2d`` (its device and dtype), set up from a reference
    ``FlowSolver2d`` through numpy: the bathymetry, every option value
    (the SWE and tracer stepper types first, then their stepper options;
    the tracers' options, a callable tracer source excepted; the sediment
    and non-hydrostatic sub-options; each turbine farm's options with its
    density Function, coordinates and turbine options), the shallow-water,
    tracer and sediment boundary data and, when the reference is
    initialized, its state (``uv``, ``elev``, each tracer and, as the
    options say, ``sediment_2d``, ``bathymetry``, ``q`` and ``w``) and
    time counters (the port solver is then initialized too).  One port
    object stands for one reference object: a Constant or Function shared
    by several options or markers stays shared.  The reference is read,
    never changed, and nothing of JAX is imported: array values go
    through ``np.asarray``."""
    from .model.flowsolver2d import FlowSolver2d

    dev, dt = mesh2d.device, mesh2d.dtype
    memo = {}

    def conv(v):
        if id(v) not in memo:
            memo[id(v)] = (v, _option_value(v, dev, dt, mesh=mesh2d))
        return memo[id(v)][1]

    s = FlowSolver2d(mesh2d, _to_tensor(np.asarray(ref.bathymetry_dof),
                                        dev, dt))
    ro, po = ref.options, s.options
    po.swe_timestepper_type = ro.swe_timestepper_type
    po.tracer_timestepper_type = ro.tracer_timestepper_type
    for k, v in vars(ro).items():
        if (k.startswith("_") or k in _SUB_OPTIONS
                or k.endswith("_timestepper_type")):
            continue
        if k == "tracer":
            po.tracer = _tracer_options(v, conv)
        elif k in _FARM_OPTIONS:
            setattr(po, k, {
                sub: ([_farm_options(f, conv) for f in fo]
                      if isinstance(fo, (list, tuple))
                      else _farm_options(fo, conv))
                for sub, fo in v.items()})
        else:
            setattr(po, k, conv(v))
    for sub in _CARRIED_SUB_OPTIONS:
        for k, v in vars(getattr(ro, sub)).items():
            if not k.startswith("_"):
                setattr(getattr(po, sub), k, conv(v))
    for which in ("shallow_water", "tracer", "sediment"):
        for marker, spec in ref.bnd_functions[which].items():
            s.bnd_functions[which][marker] = {
                k: conv(v) for k, v in spec.items()}
    if getattr(ref, "_initialized", False):
        s.initialize()
        state = ref._get_state()
        if sorted(state) != sorted(s._get_state()):
            raise KeyError(f"state keys differ: reference {sorted(state)}, "
                           f"port {sorted(s._get_state())}")
        s._set_state({k: _to_tensor(np.asarray(v), dev, dt)
                      for k, v in state.items()})
        s.simulation_time = float(ref.simulation_time)
        s.iteration = int(ref.iteration)
        s.i_export = int(ref.i_export)
    return s


def flowsolver3d_from_numpy(mesh2d, bathymetry, n_layers, options,
                            extrude_options=None, bnd_functions=None):
    """The port's :class:`~thetis_tpu_torch.model.flowsolver3d.FlowSolver`
    from numpy inputs, on ``mesh2d``'s device and dtype: ``options`` is
    the dict given to ``options.update`` (array values, such as a CG1
    Coriolis field, become tensors; a reference ``Function``, such as a
    CG1 viscosity, the port's Function of its family; a reference
    ``GLSModelOptions`` or ``NewtonParameters`` the port's own),
    ``bathymetry`` a scalar or an array, ``bnd_functions`` the
    ``{'shallow_water' | 'momentum' | 'salt' | 'temp': {marker: {key:
    value}}}`` boundary conditions (values: numbers, arrays, Constants,
    Functions or None, converted as the options are).  The reference's
    solver is built from the same description with its arrays passed
    through ``jnp.asarray``, so both compute the same step."""
    from .model.flowsolver3d import FlowSolver

    dev, dt = mesh2d.device, mesh2d.dtype
    memo = {}

    def conv(v):
        # one port object for one reference object: a Function shared by
        # several markers stays shared, so updating it reaches them all
        if id(v) not in memo:
            memo[id(v)] = (v, _option_value(v, dev, dt, mesh=mesh2d))
        return memo[id(v)][1]

    s = FlowSolver(mesh2d, bathymetry_from_numpy(bathymetry, dev, dt),
                   n_layers, options={k: conv(v) for k, v in options.items()},
                   extrude_options=extrude_options)
    for which, specs in (bnd_functions or {}).items():
        s.bnd_functions[which] = {
            int(m): {k: conv(v) for k, v in spec.items()}
            for m, spec in specs.items()}
    return s
