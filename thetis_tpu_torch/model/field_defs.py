"""Canonical field metadata registry.

Mirrors the reference's ``thetis/field_defs.py:5-258``: every model field has
a canonical key, human-readable name, short name, output filename and unit.
``FieldDict`` validates fields against this registry on insertion
(ref ``thetis/utility.py:102-136``).

Copied unchanged from ``thetis_tpu/model/field_defs.py`` (numpy / plain Python only).
"""

__all__ = ["field_metadata", "FieldDict", "AttrDict"]

field_metadata = {
    "bathymetry_2d": dict(name="Bathymetry", shortname="Bathymetry",
                          unit="m", filename="bathymetry2d"),
    "elev_2d": dict(name="Water elevation", shortname="Elevation",
                    unit="m", filename="Elevation2d"),
    "uv_2d": dict(name="Depth averaged velocity", shortname="Velocity",
                  unit="m s-1", filename="Velocity2d"),
    "solution_2d": dict(name="SWE solution", shortname="SWE",
                        unit="", filename="Solution2d"),
    "tracer_2d": dict(name="Depth averaged tracer", shortname="Tracer",
                      unit="", filename="Tracer2d"),
    "sediment_2d": dict(name="Sediment", shortname="Sediment",
                        unit="kg m-3", filename="Sediment2d"),
    "uv_dav_2d": dict(name="Depth averaged velocity", shortname="Depth averaged velocity",
                      unit="m s-1", filename="DAVelocity2d"),
    "split_residual_2d": dict(name="Momentum eq. residual for mode splitting",
                              shortname="Momentum residual", unit="m s-2",
                              filename="SplitResidual2d"),
    "q_2d": dict(name="Non-hydrostatic pressure at bottom", shortname="NH pressure",
                 unit="Pa", filename="NHPressure2d"),
    "w_2d": dict(name="Vertical velocity", shortname="Vertical velocity",
                 unit="m s-1", filename="VertVelo2d"),
    "coriolis_2d": dict(name="Coriolis parameter", shortname="Coriolis",
                        unit="s-1", filename="coriolis_2d"),
    "wind_stress_2d": dict(name="Wind stress", shortname="Wind stress",
                           unit="Pa", filename="wind_stress_2d"),
    # 3D fields (solver3d)
    "elev_3d": dict(name="Water elevation", shortname="Elevation",
                    unit="m", filename="Elevation3d"),
    "uv_3d": dict(name="Horizontal velocity", shortname="Horizontal velocity",
                  unit="m s-1", filename="Velocity3d"),
    "w_3d": dict(name="Vertical velocity", shortname="Vertical velocity",
                 unit="m s-1", filename="VertVelo3d"),
    "salt_3d": dict(name="Water salinity", shortname="Salinity",
                    unit="psu", filename="Salinity3d"),
    "temp_3d": dict(name="Water temperature", shortname="Temperature",
                    unit="C", filename="Temperature3d"),
    "density_3d": dict(name="Water density", shortname="Density",
                       unit="kg m-3", filename="Density3d"),
    "tke_3d": dict(name="Turbulent kinetic energy", shortname="TKE",
                   unit="m2 s-2", filename="TurbKEnergy3d"),
    "psi_3d": dict(name="Turbulence generic length scale", shortname="GLS",
                   unit="m2 s-3", filename="TurbPsi3d"),
    "eps_3d": dict(name="TKE dissipation rate", shortname="Dissipation",
                   unit="m2 s-3", filename="TurbEps3d"),
    "len_3d": dict(name="Turbulent length scale", shortname="Length scale",
                   unit="m", filename="TurbLen3d"),
    "eddy_visc_3d": dict(name="Eddy viscosity", shortname="Eddy viscosity",
                         unit="m2 s-1", filename="EddyVisc3d"),
    "eddy_diff_3d": dict(name="Eddy diffusivity", shortname="Eddy diffusivity",
                         unit="m2 s-1", filename="EddyDiff3d"),
    "baroc_head_3d": dict(name="Baroclinic head", shortname="Baroclinic head",
                          unit="m", filename="BarocHead3d"),
    "int_pg_3d": dict(name="Internal pressure gradient", shortname="Int. pressure gradient",
                      unit="m s-2", filename="IntPG3d"),
    "smag_visc_3d": dict(name="Smagorinsky viscosity", shortname="Smagorinsky viscosity",
                         unit="m2 s-1", filename="SmagVisc3d"),
    "bottom_drag_3d": dict(name="Bottom drag coefficient", shortname="Bottom drag",
                           unit="", filename="BottomDrag3d"),
    "uv_bottom_2d": dict(name="Bottom velocity", shortname="Bottom velocity",
                         unit="m s-1", filename="BotVelocity2d"),
    "uv_dav_3d": dict(name="Depth averaged velocity", shortname="Depth averaged velocity",
                      unit="m s-1", filename="DAVelocity3d"),
    "w_mesh_3d": dict(name="Mesh velocity", shortname="Mesh velocity",
                      unit="m s-1", filename="MeshVelo3d"),
    "hcc_metric_3d": dict(name="HCC metric", shortname="HCC metric",
                          unit="-", filename="HCCMetric3d"),
    "z_coord_3d": dict(name="Mesh z coordinates", shortname="Z coordinates",
                       unit="m", filename="ZCoord3d"),
    "buoy_freq_3d": dict(name="Buoyancy frequency squared", shortname="Buoyancy frequency squared",
                         unit="s-2", filename="BuoyFreq3d"),
    "shear_freq_3d": dict(name="Vertical shear frequency squared",
                          shortname="Shear frequency squared",
                          unit="s-2", filename="ShearFreq3d"),
}


class AttrDict(dict):
    """Dictionary with attribute access (ref ``utility.py:89-100``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self


class FieldDict(AttrDict):
    """Field container that validates keys against ``field_metadata``
    (ref ``utility.py:102-136``)."""

    def _check_key(self, key):
        base = key
        # tracer labels like 'tracer_2d' subscripted systems pass through
        if base not in field_metadata and not base.endswith("_2d") and not base.endswith("_3d"):
            raise KeyError(
                f"Unknown field '{key}'; add it to field_metadata first"
            )

    def __setitem__(self, key, value):
        self._check_key(key)
        super().__setitem__(key, value)

    def __setattr__(self, key, value):
        if key == "__dict__":
            super().__setattr__(key, value)
            return
        self._check_key(key)
        super().__setitem__(key, value)
