"""Smoke run of the PyTorch/CUDA port (``thetis_tpu_torch``) on one GPU.

Drives the port's ported ``bench.py`` workloads and the 3D model with its
turbulence closure through the hand-written CUDA kernels, after building
them from ``thetis_tpu_torch/csrc`` and holding each against its plain
PyTorch version:

* the 3D baroclinic channel (``bench.py::build_workload_3d``: periodic
  48x48 mesh, 4,608 columns x 12 layers, 1,036,800 DOF, SSPRK22 ALE,
  f32), which runs the tridiagonal kernel (2 launches per step) and, in
  its barotropic CN solve, the ring matvec and block-Jacobi kernels;
* the same 3D workload with the GLS turbulence closure (k-epsilon, Canuto
  A), a wind stress, layers refined toward the surface and the
  conservation monitors, entered as a user's run script enters it:
  ``assign_initial_conditions`` and ``iterate()`` with exports (4
  tridiagonal launches per step: the velocity pair, the tracer, k and
  psi); the same workload with the explicit subcycled 2D mode
  (``dt_mode='split'``, no ring kernel); and the Kato-Phillips
  wind-entrainment column (f64, 4 h through ``iterate()``), whose
  mixed-layer depth must follow the empirical curve;
* the Rhine ROFI example (``examples/rhineROFI/rhineROFI.py``) at its own
  size (870 triangles x 12 layers, dt 7 s, 200 steps), its case built
  through the port from a copy of its mesh generator: LeapFrogAM3, GLS,
  Smagorinsky, the tracer limiter, momentum ``symm`` and salinity
  ``value`` boundaries, the Kelvin-wave elevation set every step through
  ``iterate(update_forcings=...)``; the same options at the bench's width
  (the estuary: 48x48x12, two tracers with their own boundaries and a
  heat source); and the bench's 3D channel under each coupling of the 3D
  model's last slice (fixed mesh, unsplit 2D mode, quadratic head and
  density, LeapFrogAM3 with GLS and advected tke/psi);
* the 2D semi-implicit CrankNicolson step (the CN workload: 320x160
  rectangle, 102,400 cells, 921,600 DOF, f32): ring matvec and
  block-Jacobi;
* the 2D model, ``FlowSolver2d``, entered as a user enters it, on the
  same 320x160 workloads: SSPRK33 (no kernel on its path), the
  semi-implicit CN, the CN under each preconditioner of the CFL policy
  (coarse correction, Schur fieldsplit) and the Newton CN with the
  assembled wave preconditioner (ring matvec and block-Jacobi inside it);
* the 2D slice of tracers, wetting-and-drying and the other steppers:
  DIRK22 semi-implicit SWE (each stage an assembled FGMRES on the ring
  matvec and block-Jacobi kernels) with two P1DG tracers (CN, limiter,
  a source, the monitors) at 320x160 (1,536,000 DOF); the Thacker bowl
  at the same width and the reference test's own case; DIRK33 and
  PressureProjectionPicard at 320x160, PPP on the standing wave,
  SteadyState and SSPIMEX at the CPU tests' sizes;
* morphodynamics, tidal turbines and the non-hydrostatic pressure: the
  sediment-trench, tidal-array and solitary-wave examples at their own
  sizes, each written for the port, and each at the bench's width
  (~10^5 cells), where the SWE's CN runs the ring matvec and block-Jacobi
  kernels every step;
* the other element families and meshes: dg-cg (P1DG velocity x P2 CG
  elevation), rt-dg and bdm-dg (RT1/BDM1 x P0, RT2/BDM2 x P1DG), the
  icosahedral sphere (Williamson 2) and a gmsh file, each at its
  reference test's or example's size and at the bench's width; none of
  these paths runs a hand kernel (the assembled ring solve is dg-dg
  only), and each is checked at 0 launches;
* the adjoint: the gradient of a functional of the bench's CN run
  through ``differentiable_forward``, whose backward runs the ring
  matvec kernel again (the adjoint ring solves on the transposed blocks
  and the block-Jacobi kernel on the transposed diagonal), the channel
  inversion and tidal-farm examples, and gradients through the mass
  PCGs' CUDA graphs;
* I/O and forcing: demos/demo_2d_north_sea.py through the port with its
  exports on (the VTK series, the HDF5 checkpoints where h5py is
  installed), the TPXO-format tidal file read every step and three
  tide-gauge stations every step, at the demo's size and on a 104,423-cell
  coastline mesh (DIRK22 stages on the ring matvec and block-Jacobi
  kernels), the ring kernels at that mesh's ring table, and ERA5 forcing
  set into the card's fields;
* the repo's 42 demos and examples, each from its own source at its
  regression size through ``run_script`` (the scripts rewritten by
  ``REWRITE_TABLE``, nothing else), each against its own checks.

Phases, each printing its lines:

1. device: the card, its power limit, the TF32 switches (both off);
2. build: one nvcc per kernel source, all started together, with seconds;
3. kernels against plain, f64 and f32: ring_mv and block_diag_mv on the
   ragged cases of ``thetis_tpu_torch/kernels/cases.py``, the tridiagonal
   solve on its ragged cases there (column counts around the tile, n = 1
   to 300, one and two right-hand sides a column; two must equal two
   solves of one bit for bit), on operands that start off a 16-byte
   boundary, on broadcast patterns that are copied first and on each side
   of the n at which its general kernel takes over; then every kernel at
   the shapes the port runs it at (nc 4,608 and 102,400; tridiag the
   velocity solve's 13,824 columns of 13 with two right-hand sides sharing
   the coefficients, 13,824 and 27,648 columns of 13, 4096 columns of 300,
   and ROFI's 2,610 columns of 13 with two and one), each with one PyTorch
   call computing the same function as its
   yardstick (cuSPARSE bsrmv, ``torch.bmm``, ``torch.linalg.solve`` on
   dense matrices);
   device time (profiler; at nc 102,400 with the L2 flushed before each
   call, as the solvers call the kernels there, and the kernel's
   back-to-back time beside it), CUDA-event time (median of 50), bytes,
   the bound and the kernel's share of it;
4. 2D slice: 1 warm-up + 10 timed f32 CN steps, launch counts, rates;
5. 2D parity: one f64 step on the GPU (kernels) against the same step on
   the CPU (the port's plain path);
6. 3D slice: 1 warm-up + 20 timed f32 steps (the bench's n), launches per
   step, rates, peak memory, a per-phase breakdown and, from a fresh
   process (``python3 chip_smoke.py profile3d``), the profiler's device
   kernels of one step and of the velocity column solve alone (one
   tridiagonal kernel, no copy of a coefficient);
7. 3D parity, f64, GPU against the CPU plain path (run in phase 21's
   block, after every timed phase): one step of the plain workload, three of the GLS workload with and without advection of tke
   and psi, three of the estuary at 8x8x4, of ROFI at coarse 16 with 2
   layers (from a stratified start) and of each coupling at 16x16x12;
12. 3D model with GLS, f32, full size: 1 warm-up + 20 steps through
    ``iterate()`` with two exports; ms/step beside ``advance_n`` over the
    same steps (whose final state must be the same bits), launches per
    step (4 tridiag: one with two right-hand sides, three with one),
    FGMRES cycles, ranges of tke and the eddy coefficients, the monitors;
    from a fresh process (``python3 chip_smoke.py profile3d_gls``) the
    device kernels of one GLS step and of one ``step_columns`` call;
13. 3D model, ``dt_mode='split'``, f32, full size: 5 steps, the 2D mode
    as ``M_modesplit`` explicit SSPRK33 substeps, no ring kernel;
14. Kato-Phillips, f64: 240 steps of 60 s through ``iterate()``; the
    mixed-layer depth within 10% of 1.05 u* sqrt(t / N0);
15. Rhine ROFI, f32: 200 steps through ``iterate(update_forcings=...)``;
    ms/step, launches (4 tridiag a step), FGMRES cycles, the example's
    checks (salinity within [-0.01, 32.01], freshwater volume changed by
    less than 5%) and the monitors;
16. the estuary, f32, 48x48x12: 1 warm-up + 20 steps through
    ``iterate(update_forcings=...)``; ms/step, DOF*steps/s, launches (5
    tridiag a step), salinity bounds, the monitors; from a fresh process
    (``python3 chip_smoke.py profile3d_estuary``) the device kernels of
    one step;
17. the couplings, f32, 48x48x12: 1 warm-up + 5 steps each; ms/step and
    launches; from a fresh process (``python3 chip_smoke.py
    profile3d_more``) the device kernels of one step of each and of one
    ROFI step;
8. 2D model, SSPRK33, f32, full size: 1 warm-up + 30 timed steps through
   ``iterate()``, rates, launches, a profiler count per step;
9. 2D model, semi-implicit CN, f32, full size: 1 warm-up + 10 timed
   steps, held against phase 4's final state and launch counts;
10. 2D model, the preconditioner policy, f32, full size: CN at 12 and 50
    hmin/c (coarse correction, Schur fieldsplit) and the Newton CN, 1
    warm-up + 3 timed steps each; setup seconds, Newton iterations,
    FGMRES cycles, launches, ms/step, peak memory, final residuals;
11. 2D model parity, f64, 80x40: one step of each configuration of
    phases 8-10 and 18-20 on the GPU against the CPU plain path (run in
    phase 21's block);
18. the 2D slice, f32, 320x160, through ``iterate()``: DIRK22
    semi-implicit SWE with two P1DG tracers (CN tracer stepper, limiter,
    a source on one, the volume, tracer-mass and overshoot monitors), 1
    warm-up + 10 steps: ms/step, DOF*steps/s of 1,536,000 DOF, ring_mv /
    block_diag_mv launches a step (> 0), FGMRES cycles a stage, the
    tracer mass change; from a fresh process (``python3 chip_smoke.py
    profile2d_tracers``) the device kernels and device ms of one step;
19. wetting-and-drying: the Thacker bowl on SquareMesh(226, 226)
    (102,152 cells), f32, CN, 1 + 5 steps: ms/step, Newton iterations,
    FGMRES cycles, the volume change (and f64's over the same steps);
20. DIRK33 and PressureProjectionPicard at 320x160, f32, 1 + 3 steps
    each;
21. the f64 checks that time nothing, after every timed phase: the
    Thacker case of ``tests/test_thacker.py`` (n = 10, dt 600 s, 72
    steps) under CN, DIRK22 and BackwardEuler against its bounds and PPP
    on the standing wave (100x1, 20 steps, relative error <= 5e-3), each
    in a process of its own (``python3 chip_smoke.py thacker <stepper>``,
    ``python3 chip_smoke.py standing_wave``), all four at once; meanwhile
    phases 7 and 11 (one 80x40 step of the slice, DIRK33, PPP and the
    bowl under CN among them; one step of the sediment channel with
    Exner, the tidal array and the solitary wave) and SteadyState (8x4)
    and SSPIMEX (5x4), each GPU against CPU; a fifth process takes the
    profiler's device kernels of one step of 22b, 23b and 24b (``python3
    chip_smoke.py profile_slice9``);
22. morphodynamics: (a) examples/sediment_trench_2d at its size (80x5,
    f32, dt 0.3 s, morfac 100, CN theta 1, suspended sediment + bedload +
    Exner, ``equilibrium`` inflow, from the example's 0.51 m/s), 1 + 20
    steps: ms/step, the largest bed change within the example's bounds;
    (b) tests/test_sediment.py's channel scaled by 20 onto 320x160
    (1,280,481 DOF: SWE, sediment, bed), f32, 1 + 5 steps: ms/step,
    DOF*steps/s, ring_mv / block_diag_mv launches a step (each > 0), the
    solves' counters, the sediment minimum and the bed change;
23. tidal turbines, in a process of its own (``python3 chip_smoke.py
    tidal_array``: the example sets rho0 = 1026): (a) examples/
    discrete_turbines/tidal_array.py at its size (100x30, f64, nine
    turbines, 20 steps of 50 s through ``iterate(update_forcings=...)``
    with the power callback) against its checks (power in 1e5 .. 1e8 W,
    the wake slower than the free stream); (b) the array on 400x120
    (96,000 cells, f32) from 2.5 m/s, 1 + 5 steps at dt 2.5 s (the
    coarse-correction band): ms/step, launches (each > 0), 9 turbines to
    1e-5, finite power;
24. the non-hydrostatic pressure: (a) examples/nonhydrostatic_cases/
    solitary_wave_nh at its size (250x1, f64, 200 steps) against its
    checks (crest within 30 m of x0 + c t, amplitude above 0.7 a); (b)
    the wave on 640x80 (102,400 cells, P2 q), f32, the Newton CN under
    the assembled wave PC, 1 + 5 steps: ms/step, launches (each > 0),
    BiCGStab iterations a step;
25. dg-cg: (a) ``tests/test_dgcg.py``'s standing wave at its size (100x1,
    f64): the Newton CN at 10 and 20 steps and PressureProjectionPicard at
    20, each in a process of its own in phase 21's block (``python3
    chip_smoke.py dgcg_wave <cn10|cn20|ppp20>``), against the test's
    bounds (2e-2, 5e-3, 5e-3), and ``test_dgcg_mass_conservation``'s
    closed basin (20x4, 30 CN steps, f64) in another (``python3
    chip_smoke.py dgcg_volume``), its volume to the test's 1e-10 with the
    scatters' atomic adds in no fixed order; (b) the bench's 320x160
    mesh, P1DG uv x P2 CG elevation (819,841 DOF), f32,
    PressureProjectionPicard under the wave-Schur PC at wave CFL 10, 1 + 3
    steps: ms/step, Newton iterations and FGMRES cycles, finite, the
    volume to 1e-6, the mass PCG replayed as a CUDA graph (as in 26b and
    27b: every mass PCG of the run replays, none solves eagerly);
26. rt-dg and bdm-dg: (a) ``test_rtdg.py::test_rtdg_flowsolver`` and
    ``test_rt2.py::test_rt2_facade`` (both families) at their sizes, f64,
    against their bounds (``python3 chip_smoke.py hdiv_cases``); (b) RT1
    x P0 (255,840 DOF), RT2 x P1DG and BDM2 x P1DG on 320x160, f32, the
    semi-implicit CN at 2 hmin/c, 1 + 3 steps each;
27. the sphere and gmsh: (a) ``examples/williamson2/williamson2.py`` at
    its regression size (refinement 3, 24 steps, f64) against its ``l2 <
    0.05`` (after 26a, in its process); (b) Williamson 2 at
    refinement 6 (81,920 cells) under rt-dg and bdm-dg, f32, 1 + 3 steps,
    the volume to 1e-9; (c) the bench's rectangle written as a gmsh 2.2
    file, read onto the card (the RectangleMesh's tables) and stepped once
    (dg-dg SSPRK33).  Phase 21 gains one f64 GPU-against-CPU step of each
    configuration of 25-27 (20x10; refinement 3) at 1e-10, and a process
    with the profiler's view of one step of each full-width run
    (``python3 chip_smoke.py profile_families``).

28. the adjoint (``FlowSolver2d.differentiable_forward``): (a) the
    bench's 2D CN (320x160, f32) under a gradient of J = the domain
    integral of u_x at the end plus the summed L2 norm of the elevation,
    with respect to the drag field and the initial elevation, over 4
    steps: the forward and the backward each with its device ms, device
    kernels, wall time and ring_mv / block_diag_mv launches (the
    backward's ring_mv > 0: the adjoint ring solves and the x-bar
    matvecs), and the peak memory of an 8-step gradient stored and
    checkpointed (chunk 2); after phase 21's block, the f64 checks: (b)
    the full-width gradient with the kernels against the plain versions
    (1e-9 of max) with its Taylor rate (> 1.9), and the 40x20 gradient on
    the card against the CPU's (1e-9); (c) examples/channel_inversion at
    its regression size in a process of its own (``python3 chip_smoke.py
    channel_inversion``) against its checks (J1 < 0.1 J0, the recovered
    Manning nearer the truth than the first guess); (d) Taylor rates
    through one explicit dg-cg step and one RT1 CN step at the bench's
    width (every mass PCG replaying its graph in the backward, none
    solving eagerly) and through examples/tidalfarm's density at its
    regression size.

29. I/O and forcing (``python3 chip_smoke.py io`` runs it alone): first a
    line saying whether h5py is installed and, if not, which parts are
    left out (the HDF5 checkpoints, ``load_state``, ``DiagnosticHDF5``,
    the NetCDF4 reader); (a) the North Sea demo at its own size (40 km,
    665 cells, f64, DIRK22, 24 hourly steps, the TPXO boundary set every
    step, hourly exports, three stations every step) against
    tests/test_north_sea.py's bounds, one station row a step and the
    expected export files; (b) the same at 3.2 km (104,423 cells, f32, dt
    scaled with the resolution: the demo's wave CFL, printed with the
    preconditioner the CFL policy picks), 1 + 12 steps with the VTK
    series every 4 steps and the stations, then without I/O: ms/step of
    each, ring_mv / block_diag_mv launches a step, FGMRES cycles, seconds
    per export of each exporter and per station evaluation; with h5py a
    restart from export 2 against the uninterrupted run and a second
    uninterrupted run's spread; the profiler's device kernels and device
    ms of one step from a process of its own in phase 21's block
    (``python3 chip_smoke.py profile_io``); the ring kernels against
    their plain versions at the 3.2 km mesh's ring table (phase 3's
    ``shapes``); after phase 21's block, f64: (c) one North Sea step and
    its stations GPU against CPU, tests/test_checkpoint.py's 3D case with
    the VTK series and the profile, transect and station callbacks GPU
    against CPU (the tridiagonal kernel), and with h5py the 2D and 3D
    checkpoint cases restarted on the card and a checkpoint carried
    card -> CPU and back; (d) a synthetic ERA5 file's wind stress and
    pressure set into the card's fields (to 1e-12 of the host's numpy)
    and one North Sea step with them, GPU against CPU.  The phase prints
    its seconds.

30. the demos and examples (``python3 chip_smoke.py examples`` runs it
    alone): ``Function.interpolate`` on the card (a callable of card
    tensors, a numpy one), the rest of ``Function``'s user API on the
    card against the CPU (``function_api_checks``: ``+ - *`` both ways
    with Functions, numbers, tensors and numpy arrays, component
    indexing, ``dat``, ``project``, and a ``copy`` that shares no
    memory), the rewrite table, then every script of
    demos/ and examples/ but the helper modules (``example_scripts``),
    f64, each in a process of its own (``python3 chip_smoke.py example
    <path>``), eight at a time, the longest first; the whole script
    leaves out the seven that an earlier phase runs at the same size
    (``EXAMPLES_RUN_EARLIER``) and starts the others, among phase 21's
    block, once that block's profile processes have ended, beside the
    f64 checks and at a lower priority.  Each prints its seconds, its
    solvers' steps and its ring_mv / block_diag_mv / tridiag launches
    (each process sets its counts to 0 just before its script); each
    script's own checks must hold, but for the two that the reference
    fails at regression size, which must fail the same way
    (``fails_as_the_reference``); a 3D script must launch the ring
    kernels, and the tridiagonal kernel exactly where its options make
    the vertical solves implicit; ``examples/waveEq2d/channel2d_waveEq``
    and ``examples/baroclinic_channel`` run on the card, where each must
    launch the ring kernels, and on the CPU, every field to 1e-10 of its
    largest value (``python3 chip_smoke.py example_parity <path>``).
    The kernels line's ``launches_by_path`` gains ``examples``, the sum
    over the scripts.

31. the partitioned path, ``thetis_tpu_torch.parallel`` (``python3
    chip_smoke.py parallel`` runs it alone; in the whole script it runs
    after phase 6), PAR_PARTS = 4 partitions on the one card: (a) the
    bench's 3D channel on the non-periodic 48x48 rectangle (the stripe
    partition refuses periodic-x), 12 layers, f64: one partitioned step
    (``ShardedFlowSolver3d``; its barotropic solve ``ShardedAssembledCN``)
    against the serial port's step on the card to 1e-11 relative, the
    barotropic Krylov at 1e-13 (the reference's test), and a second step
    from the same state the same bits; then f32, the serial step and the
    partitioned step side by side, 1 warm-up and 3 timed steps each:
    ms/step, device ms/step and device kernels of one step, launches a
    step (partitions on one card are overhead, not scaling); (b) the 2D
    CN bench (nc 102,400) partitioned, without and with the per-field
    coarse correction, f64, one step against the serial assembled CN to
    1e-10 relative, FGMRES cycles; (c) ring_mv and block_diag_mv at one
    partition's extended ring table of (a) and of (b), the tridiagonal
    solve at one partition's columns of (a), each against its plain
    version with its bound and library time (``shapes`` rows).  Every
    kernel must launch on the partitioned runs (``launches_by_path``
    gains ``parallel``, their sum); the phase prints its seconds in a
    ``[phase_parallel]`` line.

Then one JSON line describing each kernel (top-level numbers f32 at the
3D step's shape, ``shapes`` every shape and dtype of phases 3 and 31c),
the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.  Any
failed check raises, so the script exits non-zero and prints no result;
without a CUDA device it exits 1 at once.  Run from the repository root:
``python3 chip_smoke.py``.
"""
import ast
import contextlib
import functools
import gc
import glob
import json
import math
import os
import subprocess
import sys
import time
import types
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from thetis_tpu_torch.config import physical_constants
from thetis_tpu_torch.equations.shallowwater_2d import (
    ShallowWaterEquations, swe_state)
from thetis_tpu_torch.fem.assembly import DGAssembler
from thetis_tpu_torch.fem.functionspace import (Function, FunctionSpace,
                                                SpatialCoordinate)
from thetis_tpu_torch.interop import state3d_keys
from thetis_tpu_torch.kernels import ringmv, tridiag
from thetis_tpu_torch.equations.momentum_3d import vertical_viscosity_implicit
from thetis_tpu_torch.kernels.cases import (RAGGED_NC, RAGGED_TRIDIAG,
                                            ragged_case, ragged_tridiag_case)
from thetis_tpu_torch.mesh.generation import (PeriodicRectangleMesh,
                                              RectangleMesh, SquareMesh)
from thetis_tpu_torch.mesh.mesh2d import Mesh2d
from thetis_tpu_torch.model.flowsolver2d import FlowSolver2d
from thetis_tpu_torch.model.flowsolver3d import FlowSolver
from thetis_tpu_torch.solvers.assembled import get_coloring, ring_tables
from thetis_tpu_torch.solvers.newton import NewtonParameters
from thetis_tpu_torch.solvers.pcg import JacobiPCG
from thetis_tpu_torch.timeintegration.rungekutta import SCHEMES
from thetis_tpu_torch.timeintegration.steppers import get_stepper
from thetis_tpu_torch.utils.constant import Constant
from thetis_tpu_torch.utils.coordsys import beta_plane_coriolis_params

NX, NY, LX, LY = 320, 160, 100e3, 50e3  # bench.py:213-214, :51
RESTART = 8
NX3, NY3, NZ3 = 48, 48, 12              # bench.py:206
L3, DEPTH3 = 1600e3, 1600.0             # bench.py:122-123
STEPS3 = 20                             # bench.py:207
RESTART3 = 6                            # flowsolver3d's barotropic solve
H100_BW = 3.35e12  # bytes/s, H100 SXM data sheet
# flop/s outside the tensor cores (H100 SXM data sheet); no kernel here
# has the reuse that would feed a matrix unit
H100_PEAK = {torch.float32: 67e12, torch.float64: 34e12}
KERNEL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# one f64 step, GPU kernels vs CPU plain path: same Krylov path, sums in
# other orders; the solve amplifies 1e-16 roundoff by its conditioning
PARITY_RTOL = 1e-9
# phase 9 against phase 4: the two runs hold the 50 m depth as a scalar
# (bench.py) and as the model's CG1 field, which differ in f32 roundoff;
# each step's solve stops at ksp_rtol 1e-5, so over 11 steps the states
# differ at that tolerance, not at roundoff (CPU f32: 2.1e-5 of max on uv)
MODEL_CN_RTOL = 1e-4
KERNELS = ("ring_mv", "tridiag", "block_diag_mv")
STEPS_SSP = 30                          # bench.py:211-212
#: the GLS run: a wind stress [N/m^2] and layers refined toward the surface
#: (sigma_j = 1 - (1 - j/nz)^3: 0.93 m on top, 367 m at the bed).  On the
#: bench's uniform 133 m layers no wind gives a shear whose production
#: exceeds the dissipation, and tke never leaves its floor.
GLS_WIND = (0.1, 0.03)
GLS_STRETCH = 3.0
GLS_OPTIONS = dict(use_turbulence=True, check_volume_conservation_3d=True,
                   check_temperature_conservation=True,
                   check_temperature_overshoot=True)
# the volume is a host sum of f32 elevations against a 4e15 m^3 basin
VOLUME_RTOL_F32 = 1e-6
# Kato-Phillips (tests/test_katophillips.py of the reference)
KP_DEPTH, KP_LAYERS, KP_US, KP_N0 = 50.0, 20, 0.01, 0.01
NX_PARITY, NY_PARITY = 80, 40           # phase 11's CPU-affordable mesh
#: FlowSolver2d configurations: (stepper, semi-implicit, dt in hmin/c,
#: NewtonParameters keywords, the PC the CFL policy should pick).  The
#: coarse / Schur cases take the policy's restart (24) at the bench's
#: ksp_rtol (1e-5; f32 cannot reach the policy's default 1e-7) with 8
#: cycles; the Newton case the policy's restart/cap (8/24) at ksp_rtol
#: 1e-5 and snes_rtol 1e-4: in f32 the Newton residual of this step
#: stalls near 1e-5 of its start (the residual's terms are ~100x the
#: step's change, each rounded at 6e-8), so a lower snes_rtol, the
#: default 1e-8 included, runs every step to snes_max_it = 8 iterations.
MODEL2D = {
    "ssprk33": ("SSPRK33", None, 0.08, None, None),
    "cn": ("CrankNicolson", True, 2.0,
           dict(ksp_rtol=1e-5, ksp_max_it=32, gmres_restart=RESTART),
           "NoneType"),
    "cn_coarse": ("CrankNicolson", True, 12.0,
                  dict(ksp_rtol=1e-5, ksp_max_it=192, gmres_restart=24),
                  "CoarseCorrection"),
    "cn_schur": ("CrankNicolson", True, 50.0,
                 dict(ksp_rtol=1e-5, ksp_max_it=192, gmres_restart=24),
                 "SchurFieldsplitPC"),
    "cn_newton": ("CrankNicolson", False, 2.0,
                  dict(snes_rtol=1e-4, ksp_rtol=1e-5, ksp_max_it=24,
                       gmres_restart=8), "AssembledWavePC"),
}
SOURCES = {"ring_mv": ("thetis_tpu_torch/csrc/ring_mv.cu",
                       "thetis_tpu/kernels/ringmv.py:45"),
           "tridiag": ("thetis_tpu_torch/csrc/tridiag.cu",
                       "thetis_tpu/kernels/tridiag.py:61"),
           "block_diag_mv": ("thetis_tpu_torch/csrc/block_diag_mv.cu",
                             "thetis_tpu/kernels/ringmv.py:59")}


def log(*a):
    print(*a, flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def median_ms(fn, reps=50, warm=5):
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    ts = sorted(a.elapsed_time(b) for a, b in ev)
    return ts[reps // 2]


def device_rows(fn, host=True):
    """Run ``fn`` under torch.profiler; returns ``(us, count, name)`` of
    every device kernel, largest device time first.  Now and then a
    capture comes back without one device record (on the card, of 1 launch
    and of 25, in a fresh process too, and twice running), so an empty one
    is taken again a moment later, five times at most; the callers raise
    if the rows are still empty.  ``host=False`` records the device
    activity alone: a step of ~10^6 launches also records millions of host
    ops, whose processing takes minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if host
                  else [ProfilerActivity.CUDA])
    for attempt in range(5):
        time.sleep(0.2 * attempt)
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue  # host ops; their kernels are rows of their own
            us = getattr(e, "self_device_time_total", None)
            rows.append((e.self_cuda_time_total if us is None else us,
                         e.count, e.key))
        if rows:
            break
    return sorted(rows, reverse=True)


def device_ms(fn, reps=20, flush=None):
    """Device time per call: the device kernels' time over ``reps`` calls,
    without the host's gaps between launches (which the CUDA-event time
    of :func:`median_ms` includes).  With ``flush`` (an in-place
    ``bitwise_not_`` of a buffer larger than the L2) run before every
    call, the flush's own kernels are left out of the sum.  The profiler
    can miss a few kernel records of a capture (2 of 20 of one kernel on
    the card), so the sum is divided by the calls it saw of the costliest
    kernel, not by ``reps``."""
    fn()
    torch.cuda.synchronize()  # the warm-up call ends before the capture

    def run():
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()

    rows = [r for r in device_rows(run) if "bitwise_not" not in r[2]]
    if not rows:
        raise RuntimeError(f"the profiler saw no device kernel in {reps} "
                           "calls")
    per_call = max(1, round(rows[0][1] / reps))  # costliest kernel's count
    return sum(r[0] for r in rows) / (rows[0][1] / per_call) / 1e3


def show_step_profile(tag, title, fn, top=6):
    """The device kernels of one call of ``fn``: their count, device time,
    the tridiagonal ones and the ``top`` costliest."""
    rows = device_rows(fn)
    if not rows:
        raise RuntimeError(f"the profiler saw no device kernel in {title}")
    solves = [(cnt, key) for _, cnt, key in rows if "tridiag" in key]
    log(f"{tag} {title}: {sum(r[1] for r in rows)} device kernels, device "
        f"busy {sum(r[0] for r in rows) / 1e3:.3f} ms; tridiag kernels: "
        + "; ".join(f"x{c} {k.split('::')[-1][:60]}" for c, k in solves)
        + "; top by device time:")
    for us, cnt, key in rows[:top]:
        log(f"{tag}   {us / 1e3:8.3f} ms  x{cnt:<5d} {key[:90]}")


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def reset_counts():
    ringmv.reset_launches()
    tridiag.reset_launches()


def counts():
    return {"ring_mv": ringmv.launches("ring_mv"),
            "tridiag": tridiag.launches(),
            "block_diag_mv": ringmv.launches("block_diag_mv")}


# -- workloads ----------------------------------------------------------
def workload(device, dtype, nx=NX, ny=NY):
    """The bench's CN case (bench.py:39-109) on the port."""
    mesh = RectangleMesh(nx, ny, LX, LY, device=device, dtype=dtype)
    V = FunctionSpace(mesh, "DG", 1)
    asm = DGAssembler(mesh, V)
    opts = SimpleNamespace(
        use_nonlinear_equations=True, use_wetting_and_drying=False,
        use_lax_friedrichs_velocity=True, use_grad_div_viscosity_term=False,
        use_grad_depth_viscosity_term=True, sipg_factor=1.0,
        norm_smoother=0.0)
    eq = ShallowWaterEquations(mesh, asm, opts, bathymetry=50.0,
                               bnd_conditions={})
    elev0 = Function(V).interpolate(
        lambda x, y: 1.0 * torch.exp(-(((x - LX / 2) / 15e3) ** 2)
                                     - ((y - LY / 2) / 15e3) ** 2))
    sol = swe_state(torch.zeros((mesh.nc, 3, 2), dtype=dtype, device=device),
                    elev0.data)
    fields = {
        "lax_friedrichs_velocity_scaling_factor": asm.as_tensor(1.0),
        "quadratic_drag_coefficient": asm.as_tensor(2.5e-3),
    }
    dt = 2.0 * float(mesh.cell_hmin_np.min()) / math.sqrt(9.81 * 51.0)
    st = get_stepper(
        "CrankNicolson", eq, dt, semi_implicit=True, assembled_solve=True,
        solver_parameters=NewtonParameters(ksp_rtol=1e-5, ksp_max_it=32,
                                           gmres_restart=RESTART))
    return mesh, eq, st, sol, fields


def bench3d_solver(mesh2d, cor, nz=NZ3, nx=NX3, options=None,
                   stretch=None):
    """A ``FlowSolver`` on ``mesh2d`` with the bench's 3D options
    (bench.py:112-177), the CG1 Coriolis ``cor`` on its vertices and the
    horizontal viscosity of an ``nx``-wide mesh; ``options`` are set over
    the bench's, ``stretch`` refines the layers toward the surface.
    Initialized, no initial conditions."""
    device, dtype = mesh2d.device, mesh2d.dtype
    physical_constants["rho0"] = 1020.0
    nu_scale = 0.5 * (L3 / nx) / 200.0
    s = FlowSolver(mesh2d, torch.tensor(DEPTH3, dtype=dtype, device=device),
                   nz, extrude_options=(None if stretch is None else
                                        dict(z_stretch_fact=stretch)))
    s.options.update(dict(
        timestepper_type="SSPRK22",
        solve_salinity=False,
        solve_temperature=True,
        constant_salinity=35.0,
        use_baroclinic_formulation=True,
        use_implicit_vertical_diffusion=True,
        use_bottom_friction=True,
        coriolis_frequency=torch.as_tensor(cor, dtype=dtype, device=device),
        vertical_viscosity=1e-3,
        vertical_diffusivity=1e-5,
        horizontal_viscosity=nu_scale,
        horizontal_diffusivity=30.0,
        equation_of_state_type="linear",
        timestep=300.0,
        simulation_export_time=24 * 3600.0,
        simulation_end_time=24 * 3600.0,
        no_exports=True,
    ))
    s.options.update(options or {})
    s.initialize()
    return s


def bench3d_coriolis(mesh2d):
    """The bench's beta-plane Coriolis on the vertices (a CG1 field)."""
    f0, beta = beta_plane_coriolis_params(37.5)
    return f0 + beta * (mesh2d.coords_np[:, 1] - L3 / 2)


def workload3d(device, dtype, nx=NX3, ny=NY3, nz=NZ3, options=None,
               stretch=None, mesh2d=None):
    """The bench's 3D baroclinic channel (bench.py:112-177) on the port,
    entered as the bench enters the reference; ``options`` are set over
    the bench's, ``stretch`` refines the layers toward the surface (the
    temperature is then set on the refined grid's own nodes).  The mesh
    is the bench's periodic one unless ``mesh2d`` is given."""
    if mesh2d is None:
        mesh2d = PeriodicRectangleMesh(nx, ny, L3, L3, direction="x",
                                       device=device, dtype=dtype)
    s = bench3d_solver(mesh2d, bench3d_coriolis(mesh2d), nz, nx, options,
                       stretch)
    x = mesh2d.coords_np[mesh2d.cells_np]  # (nc, 3, 2) P1DG nodes
    y_pert = 0.1 * L3 * np.sin(2 * np.pi * x[..., 0] / L3)
    t2d = 25.0 - 5e-6 * (x[..., 1] + y_pert - L3 / 2)
    sigma = np.linspace(-DEPTH3, 0.0, nz + 1)
    if stretch is not None:
        sigma = -DEPTH3 * (1.0 - s.extruded.sigma_np)
    z_nodes = np.stack([sigma[:-1], sigma[1:]], axis=-1)
    temp0 = t2d[:, :, None, None] + 8.2e-3 * (z_nodes[None, None]
                                              + DEPTH3 / 2)
    s.assign_initial_conditions(
        elev=torch.zeros((mesh2d.nc, 3), dtype=dtype, device=device),
        temp=torch.as_tensor(temp0, dtype=dtype, device=device))
    n_dofs = 3 * (mesh2d.nc * 3 * nz * 2) + 3 * (mesh2d.nc * 3)
    return s, s._get_state(), s._gather_swe_fields(), n_dofs


def model2d(config, device, dtype, nx=NX, ny=NY, mesh=None):
    """The bench's 2D case entered through the model API:
    ``FlowSolver2d(mesh, 50.0)``, ``.options``, ``initialize()`` and
    ``assign_initial_conditions`` (the Gaussian of bench.py:67-70).
    Returns ``(solver, setup seconds)``."""
    stepper, semi, mult, params, _ = MODEL2D[config]
    if mesh is None:
        mesh = RectangleMesh(nx, ny, LX, LY, device=device, dtype=dtype)
    s = FlowSolver2d(mesh, 50.0)
    o = s.options
    o.swe_timestepper_type = stepper
    so = o.swe_timestepper_options
    if semi is None:
        so.use_automatic_timestep = False
    else:
        so.use_semi_implicit_linearization = semi
    if params is not None:
        so.solver_parameters = NewtonParameters(**params)
    o.timestep = mult * float(mesh.cell_hmin_np.min()) / math.sqrt(9.81 * 51.0)
    o.quadratic_drag_coefficient = 2.5e-3
    o.lax_friedrichs_velocity_scaling_factor = 1.0
    o.no_exports = True
    _, t_setup = sync_time(s.initialize)
    # the equation options of bench.py:55-63
    eo = s.eq_sw.options
    want = dict(use_nonlinear_equations=True, use_wetting_and_drying=False,
                use_lax_friedrichs_velocity=True,
                use_grad_div_viscosity_term=False,
                use_grad_depth_viscosity_term=True, sipg_factor=1.0,
                norm_smoother=0.0)
    got = {k: getattr(eo, k) for k in want}
    if got != want:
        raise AssertionError(f"equation options {got} != bench {want}")
    x = s.function_spaces.H_2d.dof_coords()
    s.assign_initial_conditions(elev=torch.exp(
        -(((x[..., 0] - LX / 2) / 15e3) ** 2)
        - ((x[..., 1] - LY / 2) / 15e3) ** 2))
    return s, t_setup


def workload3d_gls(device, dtype, nx=NX3, ny=NY3, advect=False):
    """The 3D workload with the GLS closure (k-epsilon, Canuto A: the
    defaults), a wind stress, surface-refined layers and the monitors."""
    opts = dict(GLS_OPTIONS, use_turbulence_advection=advect,
                wind_stress=np.array(GLS_WIND))
    return workload3d(device, dtype, nx, ny, options=opts,
                      stretch=GLS_STRETCH)


def kato_phillips(device, dtype, hours=4):
    """The Kato-Phillips wind-entrainment column: 3x2 periodic cells, 20
    layers over 50 m, dt 60 s, salt stratification N0 = 0.01 1/s, friction
    velocity u* = 0.01 m/s, linear equations, no bottom friction, GLS
    k-epsilon.  Returns the solver, ready for ``iterate()``, and the
    interface heights."""
    g = float(physical_constants["g_grav"])
    rho0 = 1000.0  # the package's own value; the bench sets 1020
    mesh2d = PeriodicRectangleMesh(3, 2, 7500.0, 5000.0, direction="x",
                                   device=device, dtype=dtype)
    s = FlowSolver(mesh2d, KP_DEPTH, KP_LAYERS)
    s.options.update(dict(
        timestep=60.0, simulation_export_time=3600.0,
        simulation_end_time=hours * 3600.0 - 1e-9, no_exports=True,
        use_nonlinear_equations=False, solve_salinity=True,
        solve_temperature=False, constant_temperature=10.0,
        use_implicit_vertical_diffusion=True, use_bottom_friction=False,
        use_turbulence=True, use_baroclinic_formulation=True,
        vertical_viscosity=1.3e-6, vertical_diffusivity=1.4e-7,
        wind_stress=np.array([rho0 * KP_US**2, 0.0])))
    # rho' = beta (S - S_ref): dS/dz = -N0^2 rho0 / (g beta)
    salt_grad = -(KP_N0**2) * rho0 / g / 0.77
    z_if = -KP_DEPTH * (1.0 - np.linspace(0.0, 1.0, KP_LAYERS + 1))
    s_if = 35.0 + salt_grad * z_if
    salt = np.broadcast_to(np.stack([s_if[:-1], s_if[1:]], axis=-1),
                           (mesh2d.nc, 3, KP_LAYERS, 2))
    bench_rho0 = physical_constants["rho0"]
    physical_constants["rho0"] = rho0  # read while the solver is built
    try:
        s.assign_initial_conditions(
            salt=torch.as_tensor(salt.copy(), dtype=dtype, device=device))
    finally:
        physical_constants["rho0"] = bench_rho0
    return s, z_if


# -- the Rhine ROFI example (examples/rhineROFI/rhineROFI.py), its case
# built through the port: a 724 x 764 km ocean box with a 45 km river
# channel discharging 1500 m3/s of fresh water at 52.5 N under an M2
# Kelvin wave.  The tests build the reference's solver from the same
# description (``rofi_description``).
ROFI_ETA, ROFI_H_OCEAN, ROFI_H_RIVER = 1.0, 20.0, 5.0
ROFI_L_RIVER, ROFI_W_RIVER, ROFI_Y_RIVER = 45e3, 2e3, 30e3
ROFI_Q_RIVER, ROFI_SALT_OCEAN, ROFI_SALT_RIVER = 1.5e3, 32.0, 0.0
ROFI_T_TIDE = 44714.0
ROFI_DT = 7.0
ROFI_LAT = 52.5
ROFI_COLS = 870 * 3                     # coarse 1: 870 triangles


def _graded(x0, x1, dx0, ratio, reverse=False):
    """Grid lines from x0 to x1 starting at spacing dx0, growing by
    ``ratio`` per cell; the last line lands exactly on x1
    (rhineROFI.py:54-63)."""
    xs = [0.0]
    d = dx0
    while xs[-1] < (x1 - x0):
        xs.append(xs[-1] + d)
        d *= ratio
    xs = np.asarray(xs) * (x1 - x0) / xs[-1]
    return x0 + ((x1 - x0) - xs[::-1] if reverse else xs)


def rofi_mesh_arrays(coarse=1.0):
    """``make_rofi_mesh`` of rhineROFI.py:66-118: the ocean box [-Lx, 0] x
    [0, Ly] (graded from 2 km x ``coarse`` at the coast and the mouth) and
    the river strip, joined conformally.  Returns ``(coords, cells,
    markers)``, ``markers`` the boundary-marker function of edge
    midpoints (1 south, 2 west, 3 north, 6 the river inlet, 0 land)."""
    lx, ly = 724e3, 764e3
    dx0 = 2e3 * coarse
    half = ROFI_W_RIVER / 2
    xs = _graded(-lx, 0.0, dx0, 1.35, reverse=True)
    ys = np.unique(np.concatenate([
        _graded(0.0, ROFI_Y_RIVER - half, dx0, 1.35, reverse=True),
        [ROFI_Y_RIVER - half, ROFI_Y_RIVER + half],
        _graded(ROFI_Y_RIVER + half, ly, dx0, 1.35)]))
    coords, vid, cells = [], {}, []

    def add(x, y):
        key = (round(x, 3), round(y, 3))
        if key not in vid:
            vid[key] = len(coords)
            coords.append((x, y))
        return vid[key]

    def add_quad(x0, x1, y0, y1):
        v00, v10, v01, v11 = add(x0, y0), add(x1, y0), add(x0, y1), \
            add(x1, y1)
        cells.extend([(v00, v10, v11), (v00, v11, v01)])

    for i in range(len(xs) - 1):
        for j in range(len(ys) - 1):
            add_quad(xs[i], xs[i + 1], ys[j], ys[j + 1])
    xr = _graded(0.0, ROFI_L_RIVER, dx0, 1.2)
    for i in range(len(xr) - 1):
        add_quad(xr[i], xr[i + 1], ROFI_Y_RIVER - half, ROFI_Y_RIVER + half)

    def markers(mid):
        m = np.zeros(len(mid), dtype=np.int32)
        m[np.abs(mid[:, 1]) < 1.0] = 1
        m[np.abs(mid[:, 0] + lx) < 1.0] = 2
        m[np.abs(mid[:, 1] - ly) < 1.0] = 3
        m[np.abs(mid[:, 0] - ROFI_L_RIVER) < 1.0] = 6
        return m

    return (np.asarray(coords), np.asarray(cells, dtype=np.int32), markers)


def rofi_description(coords, cells, layers, steps):
    """The ROFI case's numbers on a mesh (rhineROFI.py:78-211): the CG1
    bathymetry, the options (``steps`` steps of 7 s, one export), the
    Kelvin-wave elevation as a function of time at the vertices, the
    boundary conditions with ``"kelvin"`` where that CG1 field goes, and
    the initial elevation, velocity and salinity at the cell nodes."""
    g = 9.81
    c_wave = math.sqrt(g * ROFI_H_OCEAN)
    omega_tide = 2 * np.pi / ROFI_T_TIDE
    t_day = 0.99726968 * 24 * 3600
    cor = 2 * (2 * np.pi / t_day) * math.sin(math.radians(ROFI_LAT))
    k, m = omega_tide / c_wave, cor / c_wave
    xv, yv = coords[:, 0], coords[:, 1]
    bathy = np.where(xv <= 0.0, ROFI_H_OCEAN,
                     ROFI_H_OCEAN * (1 - xv / ROFI_L_RIVER)
                     + ROFI_H_RIVER * (xv / ROFI_L_RIVER))
    options = dict(
        element_family="dg-dg", timestepper_type="LeapFrogAM3",
        solve_salinity=True, solve_temperature=False,
        constant_temperature=10.0, use_implicit_vertical_diffusion=True,
        use_bottom_friction=True, bottom_roughness=0.005,
        use_turbulence=True, use_baroclinic_formulation=True,
        use_lax_friedrichs_velocity=True, use_lax_friedrichs_tracer=True,
        vertical_viscosity=1.3e-6, vertical_diffusivity=1.4e-7,
        use_limiter_for_tracers=True, use_smagorinsky_viscosity=True,
        smagorinsky_coefficient=1.0 / math.sqrt(5.0),
        coriolis_frequency=cor, simulation_export_time=steps * ROFI_DT,
        simulation_end_time=steps * ROFI_DT, horizontal_velocity_scale=2.0,
        check_salinity_overshoot=True, check_salinity_conservation=True,
        timestep=ROFI_DT, no_exports=True)

    def kelvin(t):
        return (ROFI_ETA * np.exp(xv * m)
                * np.cos(yv * k - omega_tide * t))

    bnd = {"shallow_water": {1: {"elev": "kelvin"}, 2: {"elev": "kelvin"},
                             3: {"elev": "kelvin"},
                             6: {"flux": -ROFI_Q_RIVER}},
           "momentum": {mk: {"symm": None} for mk in (1, 2, 3, 6)},
           "salt": {1: {"value": ROFI_SALT_OCEAN},
                    2: {"value": ROFI_SALT_OCEAN},
                    3: {"value": ROFI_SALT_OCEAN},
                    6: {"value": ROFI_SALT_RIVER}}}
    xc = coords[cells]
    ocean = xc[..., 0] <= 0.0
    decay = np.exp(xc[..., 0] * m) * np.cos(xc[..., 1] * k)
    elev0 = np.where(ocean, ROFI_ETA * decay,
                     ROFI_ETA * np.cos(xc[..., 1] * k))
    v0 = np.where(ocean, (g * k / omega_tide) * ROFI_ETA * decay, 0.0)
    uv0 = np.stack([np.zeros_like(v0), v0], axis=-1)
    salt2d = (ROFI_SALT_OCEAN - (ROFI_SALT_OCEAN - ROFI_SALT_RIVER)
              * (1 + np.tanh((xc[..., 0] - 10.5e3) / 2000.0)) / 2)
    salt0 = np.broadcast_to(salt2d[:, :, None, None],
                            salt2d.shape + (layers, 2)).copy()
    return dict(bathymetry=bathy, options=options, kelvin=kelvin, bnd=bnd,
                elev=elev0, uv=uv0, salt=salt0)


def rofi_freshwater(s, bathy_cell):
    """int (1 - S/S_ocean) dV, the example's freshwater diagnostic
    (rhineROFI.py:214-222), on the host in f64."""
    salt = s.fields.salt_3d.data.double().cpu().numpy()
    elev = s.fields.elev_2d.data.double().cpu().numpy()
    depth = (bathy_cell + elev).mean(axis=1)
    fresh = (1.0 - salt / ROFI_SALT_OCEAN).mean(axis=(1, 2, 3))
    return float((fresh * depth * s.mesh2d.cell_area_np).sum())


def rofi_solver(device, dtype, coarse=1.0, layers=12, steps=200):
    """The ROFI example's solver through the port, as its script builds it:
    options, boundary conditions with the Kelvin-wave elevation as a CG1
    ``Function``, ``initialize``, ``assign_initial_conditions``.  Returns
    the solver, the ``update_forcings`` the script passes to ``iterate``
    and the bathymetry at the cell nodes (numpy)."""
    physical_constants["rho0"] = 1000.0  # rhineROFI.py:23
    coords, cells, markers = rofi_mesh_arrays(coarse)
    mesh2d = Mesh2d(coords, cells, boundary_markers=markers,
                    name="rhine_rofi", device=device, dtype=dtype)
    d = rofi_description(coords, cells, layers, steps)
    P1 = FunctionSpace(mesh2d, "CG", 1)
    bathy = Function(P1, name="Bathymetry", data=d["bathymetry"])
    s = FlowSolver(mesh2d, bathy, layers)
    s.options.update(d["options"])
    bnd_elev = Function(P1, name="bnd elevation", data=d["kelvin"](0.0))
    for which, specs in d["bnd"].items():
        s.bnd_functions[which] = {
            mk: {k: bnd_elev if v == "kelvin" else v for k, v in sp.items()}
            for mk, sp in specs.items()}
    s.initialize()
    s.assign_initial_conditions(
        elev=torch.as_tensor(d["elev"], dtype=dtype, device=device),
        uv_2d=torch.as_tensor(d["uv"], dtype=dtype, device=device),
        salt=torch.as_tensor(d["salt"], dtype=dtype, device=device))

    def update_forcings(t):
        bnd_elev.data = torch.as_tensor(d["kelvin"](t), dtype=dtype,
                                        device=device)

    return s, update_forcings, d["bathymetry"][cells]


# -- the estuary: ROFI's options at the bench's full width ---------------
EST_N, EST_L = 48, 96e3                 # 48 x 48 x 2 triangles of 2 km
EST_H_OCEAN, EST_H_RIVER = 20.0, 5.0    # west (ocean) .. east (river)
EST_SPONGE, EST_VISC = 10e3, (1.0, 50.0)
EST_HEAT = 1e-4                         # K/s in the top layer


def estuary(device, dtype, n=EST_N, nz=NZ3):
    """ROFI's options on a 96 x 96 km rectangle of 2 km cells (ROFI's
    finest spacing) and ``nz`` layers: depth 20 m at the west (the ocean,
    marker 1) ramping to 5 m at the east (the river, marker 2), markers 3
    and 4 land.  West: an M2 tide of 1 m as a CG1 ``Function`` set every
    step, salinity 32, temperature 10, momentum ``symm``; east: an inflow
    of 1,500 m^3/s (``flux``, and ``un`` matching it over the section),
    salinity 0, temperature 15.  LeapFrogAM3, GLS, Smagorinsky 1/sqrt(5)
    on a CG1 background viscosity rising from 1 to 50 m^2/s over the
    western 10 km, Coriolis at 52.5 N, the tracer limiter and a heat
    source in the top layer: both tracers advance alone (different
    boundaries, one source).  The start: at rest, salinity falling from 30
    (west) to 0 (east) and 2 psu fresher at the top than at the bed,
    temperature 10..15 C and 1 C warmer on top (stably stratified
    everywhere, so the closure's buoyancy is not roundoff).  Returns the
    solver, its ``update_forcings`` and the 3D DOF count."""
    physical_constants["rho0"] = 1000.0
    mesh2d = RectangleMesh(n, n, EST_L, EST_L, device=device, dtype=dtype)
    P1 = FunctionSpace(mesh2d, "CG", 1)
    x = mesh2d.coords_np[:, 0]
    depth = EST_H_OCEAN + (EST_H_RIVER - EST_H_OCEAN) * x / EST_L
    visc = EST_VISC[0] + (EST_VISC[1] - EST_VISC[0]) * np.clip(
        1.0 - x / EST_SPONGE, 0.0, 1.0)
    s = FlowSolver(mesh2d, Function(P1, data=depth), nz)
    heat = torch.zeros((mesh2d.nc, 3, nz, 2), dtype=dtype, device=device)
    heat[:, :, -1] = EST_HEAT
    t_day = 0.99726968 * 24 * 3600
    s.options.update(dict(
        timestepper_type="LeapFrogAM3", solve_salinity=True,
        solve_temperature=True, use_implicit_vertical_diffusion=True,
        use_bottom_friction=True, bottom_roughness=0.005,
        use_turbulence=True, use_baroclinic_formulation=True,
        use_lax_friedrichs_velocity=True, use_lax_friedrichs_tracer=True,
        vertical_viscosity=1.3e-6, vertical_diffusivity=1.4e-7,
        use_limiter_for_tracers=True, use_smagorinsky_viscosity=True,
        smagorinsky_coefficient=1.0 / math.sqrt(5.0),
        horizontal_viscosity=Function(P1, data=visc),
        coriolis_frequency=2 * (2 * np.pi / t_day)
        * math.sin(math.radians(ROFI_LAT)),
        temperature_source_3d=heat, timestep=ROFI_DT,
        simulation_export_time=ROFI_DT, simulation_end_time=ROFI_DT,
        horizontal_velocity_scale=2.0, no_exports=True,
        check_volume_conservation_3d=True,
        check_salinity_overshoot=True, check_temperature_overshoot=True))
    tide = Function(P1, data=np.ones_like(x))
    un_river = -ROFI_Q_RIVER / (EST_L * EST_H_RIVER)
    s.bnd_functions.update({
        "shallow_water": {1: {"elev": tide}, 2: {"flux": -ROFI_Q_RIVER}},
        "momentum": {1: {"symm": None}, 2: {"un": un_river}},
        "salt": {1: {"value": 32.0}, 2: {"value": 0.0}},
        "temp": {1: {"value": 10.0}, 2: {"value": 15.0}}})
    s.initialize()
    xc = mesh2d.coords_np[mesh2d.cells_np][..., 0]          # (nc, 3)
    sig = s.extruded.sigma_np
    sig_n = np.stack([sig[:-1], sig[1:]], axis=-1)          # (nz, 2)
    salt = (30.0 * (1.0 - xc / EST_L))[:, :, None, None] + 2.0 * (1 - sig_n)
    temp = (10.0 + 5.0 * xc / EST_L)[:, :, None, None] + sig_n
    s.assign_initial_conditions(
        salt=torch.as_tensor(salt, dtype=dtype, device=device),
        temp=torch.as_tensor(temp, dtype=dtype, device=device))
    omega = 2 * np.pi / ROFI_T_TIDE

    def update_forcings(t):
        tide.data = torch.full((mesh2d.nv,), math.cos(omega * t),
                               dtype=dtype, device=device)

    n_dofs = 6 * mesh2d.nc * 3 * nz * 2
    return s, update_forcings, n_dofs


def iterate_steps(s, n, exports=1):
    """``n`` more steps through ``iterate()``: the end time moves on by
    ``n`` dt and the export interval is set so that they run as
    ``exports`` loops of equal length."""
    o = s.options
    o.simulation_export_time = n // exports * s.dt
    o.simulation_end_time = s.simulation_time + n * s.dt
    s.iterate()


def check_state(tag, s, shapes):
    for k, v in s._get_state().items():
        if tuple(v.shape) != shapes[k]:
            raise AssertionError(f"{tag}: {k} shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{tag}: non-finite {k}")


# -- phases -------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA GPU", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; count {torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn={torch.backends.cudnn.allow_tf32}")
    return name


def phase_build():
    from thetis_tpu_torch.config import BUILD_DIR
    from thetis_tpu_torch.kernels.build import build_libraries

    t0 = time.perf_counter()
    built = build_libraries(KERNELS)
    each = ", ".join(f"{k}.cu {v[0]:.2f} s" for k, v in built.items())
    log(f"[build] {each}; all three in parallel "
        f"{time.perf_counter() - t0:.2f} s -> {BUILD_DIR} (nvcc -gencode "
        "arch=compute_90a,code=sm_90a)")
    for k, (_, out) in built.items():
        for line in out.splitlines():  # registers, shared memory, spills
            if any(w in line for w in ("Compiling", "Used", "spill")):
                log(f"[build] {k}: {line.split(':', 1)[-1].strip()}")


def bound_ms(nbytes, flops, dtype):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / H100_BW * 1e3
    t_ops = flops / H100_PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(tag, dtype, got, ref):
    """``got`` against the plain version's ``ref``: finite, and within the
    dtype's tolerance of ``ref``'s largest magnitude (the sums run in
    another order)."""
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = KERNEL_TOL[dtype]
    if not (bool(torch.isfinite(got).all()) and err <= tol * scale):
        raise AssertionError(f"{tag} {dtype}: max|err| {err:.3e} > {tol:g} x "
                             f"max|ref| {scale:.3e}")
    return err, scale


def measure(tag, dtype, kernel, plain, library, nbytes, flops, cold=False,
            lib_reps=(50, 20)):
    """Hold ``kernel()`` and the library call against ``plain()``, then
    time all three: CUDA events (launch included, median of 50, back to
    back) and device time (profiler).  With ``cold`` (an operand outgrows
    the L2, or the port's path evicts it between two calls) the device
    times are taken with the L2 flushed before every call, since that is
    what a caller sees; the kernel's back-to-back time is kept beside them
    as ``warm_device_ms``.  ``library`` is ``(name, fn, to_ref)``,
    ``to_ref`` turning the call's output into the plain layout outside the
    timed call; ``lib_reps`` the calls of it under CUDA events and under
    the profiler (fewer where one call takes a second)."""
    flush = None
    if cold:
        buf = torch.empty(2**25, dtype=torch.int32, device="cuda")  # 128 MB
        flush = buf.bitwise_not_
    ref = plain()
    err, scale = check(tag, dtype, kernel(), ref)
    out = dict(max_abs_err=err, ms=median_ms(kernel),
               plain_ms=median_ms(plain),
               device_ms=device_ms(kernel, flush=flush),
               plain_device_ms=device_ms(plain, flush=flush), bytes=nbytes,
               flops=flops)
    lib_name, lib_fn, to_ref = library
    check(f"{tag} library {lib_name}", dtype, to_ref(lib_fn()), ref)
    out.update(library=lib_name,
               library_ms=median_ms(lib_fn, lib_reps[0],
                                    warm=min(5, lib_reps[0])),
               library_device_ms=device_ms(lib_fn, lib_reps[1], flush))
    lib_txt = (f", library {lib_name} {out['library_device_ms']:.4f}; "
               f"events (launch included) library {out['library_ms']:.4f}")
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops, dtype)
    out["share"] = out["bound_ms"] / out["device_ms"]
    how = "back to back"
    if cold:
        out["warm_device_ms"] = device_ms(kernel)
        out["warm_share"] = out["bound_ms"] / out["warm_device_ms"]
        how = (f"L2 flushed before each call; kernel back to back "
               f"{out['warm_device_ms']:.4f} ms ({out['warm_share']:.0%})")
    log(f"[kernel] {tag} {str(dtype)[6:]}: max|err|={err:.3e} (tol "
        f"{KERNEL_TOL[dtype]:g} x max|ref|={scale:.3e}) ok; device time "
        f"({how}) kernel {out['device_ms']:.4f} ms, plain "
        f"{out['plain_device_ms']:.4f}{lib_txt}; events (launch included, "
        f"back to back) kernel {out['ms']:.4f}, plain {out['plain_ms']:.4f}; "
        f"{nbytes / 1e6:.3f} MB, {flops / 1e6:.2f} Mflop -> bound "
        f"{out['bound_ms']:.4f} ms by {out['bound_by']}, share "
        f"{out['share']:.0%}")
    return out


def ring_bsr(blocks, ring, valid):
    """The ring operator as a ``(9 nc, 9 nc)`` BSR matrix of 9x9 blocks on
    the cell-major vector: one block per valid slot, the blocks of a
    neighbour repeated in a row summed (the yardstick's layout; the port
    never builds it)."""
    nc = blocks.shape[3]
    dev = blocks.device
    keep = valid.reshape(-1)
    rows = torch.arange(nc, device=dev).repeat_interleave(4)[keep]
    cols = ring.reshape(-1).long()[keep]
    vals = blocks.permute(3, 0, 1, 2).reshape(nc * 4, 9, 9)[keep]
    key, inv = torch.unique(rows * nc + cols, sorted=True,
                            return_inverse=True)
    summed = torch.zeros((len(key), 9, 9), dtype=blocks.dtype,
                         device=dev).index_add_(0, inv, vals)
    crow = torch.zeros(nc + 1, dtype=torch.int32, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(key // nc, minlength=nc), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "BSR support is in beta"
        return torch.sparse_bsr_tensor(crow, (key % nc).int(), summed,
                                       size=(9 * nc, 9 * nc))


def ring_mv_bytes(nc, n_valid, es):
    """Blocks of the valid slots, x read and y written once, the ring
    table (int32) and the valid mask (bytes)."""
    return n_valid * 81 * es + 2 * 9 * nc * es + nc * 4 * 4 + nc * 4


def phase_kernel_ragged():
    """Both ring kernels against their plain versions on the ragged cases
    the CPU tests hold against the JAX package (kernels/cases.py)."""
    dev = torch.device("cuda")
    device_rows(lambda: torch.ones(8, device=dev) + 1)  # profiler warm-up
    for nc in RAGGED_NC:
        blocks, x, diag, ring, valid = ragged_case(nc, seed=nc)
        ring = torch.as_tensor(ring, device=dev)
        valid = torch.as_tensor(valid, device=dev)
        errs = []
        for dtype in (torch.float64, torch.float32):
            b, xx, d = (torch.as_tensor(a, dtype=dtype, device=dev)
                        for a in (blocks, x, diag))
            e1, s1 = check(f"ring_mv ragged nc={nc}", dtype,
                           ringmv.ring_mv(b, xx, ring, valid),
                           ringmv.ring_mv_reference(b, xx, ring, valid))
            e2, s2 = check(f"block_diag_mv ragged nc={nc}", dtype,
                           ringmv.block_diag_mv(d, xx),
                           ringmv.block_diag_mv_reference(d, xx))
            errs.append(f"{str(dtype)[6:]} ring_mv {e1:.2e}/{s1:.2e}, "
                        f"block_diag_mv {e2:.2e}/{s2:.2e}")
        log(f"[kernel] ragged nc={nc} ({int((~valid.any(1)).sum())} rows "
            f"with no valid slot): max|err|/max|ref| {'; '.join(errs)}: ok")


def phase_kernel_ring(nx, ny, periodic, mesh=None, cold=None,
                      bjac_rows=None):
    """Both ring kernels at the ring of a ``nx`` x ``ny`` rectangle (the 3D
    bench's periodic one, or the 2D bench's), or of ``mesh``; ``cold``
    (default: the f32 blocks outgrow the L2) times them with the L2
    flushed before each call; ``bjac_rows`` (default all) is the number
    of leading rows the block-Jacobi apply takes (a partition's owned
    rows)."""
    dev = torch.device("cuda")
    if mesh is None and periodic:
        mesh = PeriodicRectangleMesh(nx, ny, L3, L3, direction="x",
                                     device=dev, dtype=torch.float64)
    elif mesh is None:
        mesh = RectangleMesh(nx, ny, LX, LY, device=dev, dtype=torch.float64)
    ring, valid = ring_tables(mesh)
    nc = mesh.nc
    n_valid = int(valid.sum())
    g = torch.Generator(device=dev).manual_seed(1234)
    b64 = torch.randn((4, 9, 9, nc), generator=g, device=dev,
                      dtype=torch.float64)
    x64 = torch.randn((9, nc), generator=g, device=dev, dtype=torch.float64)
    d64 = torch.randn((9, 9, nc), generator=g, device=dev,
                      dtype=torch.float64)
    # where the f32 blocks outgrow the 50 MB L2, the solvers' other work
    # evicts D too (a ring matvec runs between two block-Jacobi applies)
    if cold is None:
        cold = 4 * 81 * nc * 4 > 50e6
    out = {}
    for dtype in (torch.float64, torch.float32):
        blocks, x, diag = b64.to(dtype), x64.to(dtype), d64.to(dtype)
        es = blocks.element_size()
        A = ring_bsr(blocks, ring, valid)
        xc = x.T.contiguous().reshape(-1)
        out[("ring_mv", dtype)] = measure(
            f"ring_mv nc={nc}", dtype,
            lambda: ringmv.ring_mv(blocks, x, ring, valid),
            lambda: ringmv.ring_mv_reference(blocks, x, ring, valid),
            ("cuSPARSE bsrmv (torch.mv of a BSR tensor)",
             lambda: torch.mv(A, xc), lambda y: y.reshape(nc, 9).T),
            ring_mv_bytes(nc, n_valid, es), 2 * 81 * n_valid, cold)
        nb = nc if bjac_rows is None else bjac_rows
        diag, r = diag[..., :nb].contiguous(), x[:, :nb].contiguous()
        dc = diag.permute(2, 0, 1).contiguous()
        rc = r.T.contiguous()[:, :, None]
        out[("block_diag_mv", dtype)] = measure(
            f"block_diag_mv nc={nb}", dtype,
            lambda: ringmv.block_diag_mv(diag, r),
            lambda: ringmv.block_diag_mv_reference(diag, r),
            ("torch.bmm (nc, 9, 9) x (nc, 9, 1)", lambda: torch.bmm(dc, rc),
             lambda z: z[:, :, 0].T),
            (81 + 18) * nb * es, 2 * 81 * nb, cold)
    return out


def phase_kernel_tridiag_ragged():
    """The tridiagonal kernels against the plain version on the ragged
    cases the CPU tests hold against the JAX package (kernels/cases.py),
    and where the wrapper's decisions change."""
    dev = torch.device("cuda")
    worst = {torch.float64: 0.0, torch.float32: 0.0}

    def held(tag, dtype, ops):
        got = tridiag.tridiag_solve(*ops)
        err, scale = check(tag, dtype, got, tridiag.tridiag_reference(*ops))
        worst[dtype] = max(worst[dtype], err / scale)
        return got

    for bc, n, nrhs in RAGGED_TRIDIAG:
        ops64 = [torch.as_tensor(a, device=dev)
                 for a in ragged_tridiag_case(bc, n, nrhs, seed=bc + n)]
        for dtype in worst:
            ops = [a.to(dtype) for a in ops64]
            tag = f"tridiag ragged {bc}x{n} R={nrhs}"
            got = held(tag, dtype, ops)
            if nrhs > 1:  # each right-hand side alone: the same bits
                alone = torch.stack([tridiag.tridiag_solve(*ops[:3], r)
                                     for r in ops[3]])
                if not torch.equal(alone, got):
                    raise AssertionError(f"{tag} {dtype}: R = {nrhs} differs "
                                         f"from {nrhs} solves of one")
            elif bc > 1:  # contiguous views starting one column in: off
                # the 16-byte boundary for odd n, so no vector copies
                off = [a[1:] for a in ops]
                if not torch.equal(tridiag.tridiag_solve(*off), got[1:]):
                    raise AssertionError(f"{tag} {dtype}: a view one column "
                                         "in gives other bits")
    log(f"[kernel] tridiag ragged: {len(RAGGED_TRIDIAG)} cases (columns x "
        f"rows x right-hand sides) in f64 and f32, R = 2 bit-equal to two "
        f"solves, offset views bit-equal: worst max|err|/max|ref| "
        + ", ".join(f"{str(k)[6:]} {v:.2e} (tol {KERNEL_TOL[k]:g})"
                    for k, v in worst.items()) + ": ok")
    # each side of the n at which no tile fits in shared memory any more
    for dtype in worst:
        es = torch.empty((), dtype=dtype).element_size()
        for nrhs in (1, 2):
            n = 1
            while tridiag.tile_geometry(1, n, es, nrhs) is not None:
                n += 1
            for m in (n - 1, n):
                ops = [torch.as_tensor(a, device=dev).to(dtype)
                       for a in ragged_tridiag_case(70, m, nrhs, seed=m)]
                geom = tridiag.tile_geometry(70, m, es, nrhs)
                held(f"tridiag 70x{m} R={nrhs}", dtype, ops)
                log(f"[kernel] tridiag 70x{m} R={nrhs} {str(dtype)[6:]}: "
                    + ("general kernel" if geom is None else
                       f"tiled, {geom.cols} columns and {geom.smem_bytes} "
                       "shared bytes a block") + ": ok")
    # three and four right-hand sides a column go through the tile's one
    # or two slots in turns
    for nrhs, n in ((3, 13), (4, 14)):
        ops = [torch.as_tensor(a, device=dev)
               for a in ragged_tridiag_case(1000, n, nrhs, seed=nrhs)]
        got = held(f"tridiag 1000x{n} R={nrhs}", torch.float64, ops)
        alone = torch.stack([tridiag.tridiag_solve(*ops[:3], r)
                             for r in ops[3]])
        if not torch.equal(alone, got):
            raise AssertionError(f"tridiag R = {nrhs} differs from {nrhs} "
                                 "solves of one")
    # broadcast patterns the wrapper copies first (tests/test_torch_tridiag)
    rng = np.random.default_rng(7)
    for shapes in ([(4,), (4,), (4,), (2, 4)],
                   [(2, 6, 3), (6, 3), (6, 3), (6, 3)],
                   [(1, 6, 3), (2, 1, 3), (6, 1), (2, 6, 3)]):
        dl, dd, du, rhs = (rng.uniform(-1, 1, size=sh + (13,))
                           for sh in shapes)
        ops = [torch.as_tensor(a, device=dev) for a in (dl, dd + 4.0, du, rhs)]
        full = torch.broadcast_shapes(*(t.shape for t in ops))
        check(f"tridiag broadcast {shapes}", torch.float64,
              tridiag.tridiag_solve(*ops),
              tridiag.tridiag_reference(*(t.expand(full) for t in ops)))
    log("[kernel] tridiag with 3 and 4 right-hand sides a column, and "
        "broadcast patterns that are copied first: ok")


def phase_kernel_tridiag(bc, n, nrhs=1):
    """``bc`` coefficient columns of ``n`` rows; the right-hand side has
    their shape, or ``(nrhs, bc, n)`` with ``nrhs`` > 1 sharing each
    column's coefficients (the velocity solve: the two components)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=dev,
                          dtype=torch.float64) * 2 - 1

    dl, du = rnd(bc, n), rnd(bc, n)
    rhs = rnd(bc, n) if nrhs == 1 else rnd(nrhs, bc, n)
    dd = 2.0 + dl.abs() + du.abs() + rnd(bc, n).abs()  # dominant
    out = {}
    for dtype in (torch.float64, torch.float32):
        a, b, c, r = (t.to(dtype) for t in (dl, dd, du, rhs))
        # the yardstick's dense (bc, n, n) matrices are made outside the
        # timed call (2.9 GB in f64 at 4096 x 300)
        dense = torch.diag_embed(b)
        dense.diagonal(-1, 1, 2).copy_(a[:, 1:])
        dense.diagonal(1, 1, 2).copy_(c[:, :-1])
        cols = r.reshape(nrhs, bc, n).permute(1, 2, 0).contiguous()
        lib = ("torch.linalg.solve, dense batched LU (O(n^3), not O(n))",
               lambda: torch.linalg.solve(dense, cols),
               lambda x: x.permute(2, 0, 1).reshape(r.shape))
        # each operand read once, x written once; Thomas does 3 operations
        # a row to eliminate and 5 a row and right-hand side (2 divisions
        # among the 8)
        tag = f"tridiag {bc}x{n}" + (f" x{nrhs} shared" if nrhs > 1 else "")
        out[("tridiag", dtype)] = measure(
            tag, dtype,
            lambda: tridiag.tridiag_solve(a, b, c, r),
            lambda: tridiag.tridiag_reference(a, b, c, r), lib,
            (3 + 2 * nrhs) * bc * n * a.element_size(),
            (3 + 5 * nrhs) * bc * n,
            lib_reps=(50, 20) if n <= 32 else (5, 3))
    return out


def phase_slice2d(smi):
    mesh, eq, st, sol, fields = workload(torch.device("cuda"), torch.float32)
    n_dofs = mesh.nc * 9
    nsteps = 10

    def step(s):
        return st.advance(0.0, s, fields, fields, {})

    s, t_warm = sync_time(lambda: step(sol))
    log(f"[slice2d] f32 {NX}x{NY}: nc={mesh.nc}, {n_dofs} DOF, dt="
        f"{st.dt:.3f} s; warm-up step {t_warm * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()

    def run():
        out = s
        for _ in range(nsteps):
            out = step(out)
        return out

    reset_counts()
    s, t = sync_time(run)
    n = counts()
    ms = t / nsteps * 1e3
    mv_per_step = n["ring_mv"] / nsteps
    cycles = (mv_per_step - 1) / (RESTART + 1)
    for k in ("uv", "elev"):
        if tuple(s[k].shape) != tuple(sol[k].shape):
            raise AssertionError(f"{k} shape {tuple(s[k].shape)}")
        if not bool(torch.isfinite(s[k]).all()):
            raise AssertionError(f"non-finite {k} after {nsteps} steps")
    if n["ring_mv"] == 0 or n["block_diag_mv"] == 0:
        raise AssertionError(f"the CN steps missed a kernel: {n}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, t_asm = sync_time(lambda: [eq.assemble_operator_blocks(
        s, fields, {}, st.theta * st.dt, return_residual=True)
        for _ in range(5)])
    asm_ms = t_asm / 5 * 1e3
    log(f"[slice2d] {nsteps} steps: {ms:.2f} ms/step, "
        f"{n_dofs * nsteps / t:.4e} DOF*steps/s; launches {n} "
        f"({mv_per_step:.1f} ring_mv/step = {cycles:.2f} FGMRES cycles of "
        f"{RESTART} + the anchor matvec); peak memory {peak:.2f} GiB")
    log(f"[slice2d] assembly alone {asm_ms:.2f} ms/step; the rest (Krylov, "
        f"block inverse, packing) {ms - asm_ms:.2f} ms/step")
    log(f"[slice2d] max|elev| {float(s['elev'].abs().max()):.4f} m, "
        f"max|uv| {float(s['uv'].abs().max()):.4f} m/s; card: {smi}")
    return n, s


def compare(tag, a, b, rtol):
    """Every key of GPU state ``a`` against CPU state ``b``."""
    errs = []
    for k in sorted(b):
        ga, cb = a[k].cpu(), b[k]
        err = float((ga - cb).abs().max())
        scale = float(cb.abs().max())
        errs.append(f"{k} {err:.2e}/{scale:.2e}")
        if not (bool(torch.isfinite(ga).all()) and err <= rtol * scale):
            raise AssertionError(f"{tag}: f64 GPU step disagrees with CPU: "
                                 f"{errs}")
    return "; ".join(errs)


def phase_parity2d():
    cpu = workload(torch.device("cpu"), torch.float64)
    gpu = workload(torch.device("cuda"), torch.float64)
    sol_cpu, f_cpu = cpu[3], cpu[4]
    sol_gpu = {k: v.to("cuda") for k, v in sol_cpu.items()}
    reset_counts()
    a, t_gpu = sync_time(
        lambda: gpu[2].advance(0.0, sol_gpu, gpu[4], gpu[4], {}))
    if counts()["ring_mv"] == 0:
        raise AssertionError("the f64 GPU step did not launch the kernel")
    t0 = time.perf_counter()
    b = cpu[2].advance(0.0, sol_cpu, f_cpu, f_cpu, {})
    t_cpu = time.perf_counter() - t0
    errs = compare("parity2d", a, b, PARITY_RTOL)
    log(f"[parity2d] f64 {NX}x{NY} one CN step, GPU kernels {t_gpu:.2f} s "
        f"vs CPU plain {t_cpu:.2f} s: max|diff|/max {errs} <= "
        f"{PARITY_RTOL:g}: ok")


def breakdown3d(s, state, f, reps=3):
    """Synchronized wall time of the step's three parts, entered as
    ``_step`` enters them."""
    parts = {"pre (EOS, head, int_pg)": 0.0,
             "2D CN solve (assembly + FGMRES)": 0.0,
             "post (w, ALE momentum + tracers, limiter, mixing)": 0.0}
    names = list(parts)
    for _ in range(reps):
        (geom0, int_pg, src), t1 = sync_time(lambda: s._pre_fn(state))
        f2 = dict(f)
        f2["momentum_source"] = src
        sw, t2 = sync_time(lambda: s.swe_stepper.advance(
            0.0, {"uv": state["uv"], "elev": state["elev"]}, f2, f2, {}))
        state, t3 = sync_time(lambda: s._post_fn(state, sw, geom0, int_pg,
                                                 f2))
        for k, t in zip(names, (t1, t2, t3)):
            parts[k] += t / reps * 1e3
    return parts, state


def phase_slice3d(smi):
    dev = torch.device("cuda")
    s, state0, f, n_dofs = workload3d(dev, torch.float32)
    nc = s.mesh2d.nc
    state, t_warm = sync_time(lambda: s._step(state0, f, {}))
    log(f"[slice3d] f32 {NX3}x{NY3}x{NZ3}: nc={nc} columns, {n_dofs} DOF, "
        f"dt={s.dt:g} s; warm-up step {t_warm * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, t = sync_time(lambda: s.advance_n(state, f, {}, STEPS3))
    n = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = t / STEPS3 * 1e3
    per = {k: v / STEPS3 for k, v in n.items()}
    for k, v in out.items():
        if tuple(v.shape) != tuple(state0[k].shape):
            raise AssertionError(f"{k} shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite {k} after {STEPS3} steps")
    if n["tridiag"] != 2 * STEPS3:
        raise AssertionError(f"tridiag launched {n['tridiag']} times in "
                             f"{STEPS3} steps, not 2 per step")
    if n["ring_mv"] == 0 or n["block_diag_mv"] == 0:
        raise AssertionError(f"the barotropic solve missed a kernel: {n}")
    cycles = n["block_diag_mv"] / STEPS3 / RESTART3
    log(f"[slice3d] {STEPS3} steps: {ms:.2f} ms/step, "
        f"{n_dofs * STEPS3 / t:.4e} DOF*steps/s; launches {n} = per step "
        f"{per} ({cycles:.2f} FGMRES cycles of {RESTART3}); peak memory "
        f"{peak:.2f} GiB; every state field finite")
    log(f"[slice3d] max|elev| {float(out['elev'].abs().max()):.4e} m, "
        f"max|uv| {float(out['uv'].abs().max()):.4e} m/s, max|uv_3d| "
        f"{float(out['uv_3d'].abs().max()):.4e} m/s, temp "
        f"{float(out['temp_3d'].min()):.4f}..{float(out['temp_3d'].max()):.4f}"
        f" C; card: {smi}")
    parts, _ = breakdown3d(s, out, f)
    log("[slice3d] per part, ms/step (synchronized, 3 steps): "
        + "; ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    run_profile("profile3d", "[slice3d]")
    return n, ms


def run_profile(mode, tag):
    """The profiler's captures of ``mode`` (``profile3d``,
    ``profile3d_gls``, ``profile3d_estuary``, ``profile3d_more``) in a
    process of their own: late in this long one the profiler loses kernel
    records.  Its lines starting with ``tag`` (a prefix or a tuple of
    them) are passed on; a failure there fails here."""
    sub = subprocess.run(
        [sys.executable, os.path.abspath(__file__), mode],
        capture_output=True, text=True, timeout=300)
    for line in sub.stdout.splitlines():
        if line.startswith(tag):
            log(line)
    if sub.returncode != 0:
        raise RuntimeError(f"the profiler captures of {mode} failed:\n"
                           + sub.stderr[-4000:])


def profile3d():
    """The profiler's view of the 3D slice, from a fresh process
    (``python3 chip_smoke.py profile3d``, kernels built already): the
    device kernels of the step that follows phase 6's 1 + 20 steps, those
    of the velocity column solve alone, and those of its one call of the
    tridiagonal wrapper, which must be one tiled kernel with two
    right-hand sides a column and nothing else (no copy of a broadcast
    coefficient), allocating only its result.  An empty capture fails."""
    phase_device()
    dev = torch.device("cuda")
    s, state0, f, _ = workload3d(dev, torch.float32)
    nc = s.mesh2d.nc
    out = s.advance_n(s._step(state0, f, {}), f, {}, STEPS3)
    device_rows(lambda: torch.ones(8, device=dev) + 1)  # profiler warm-up

    def tridiag_rows(rows):
        return [(cnt, key) for _, cnt, key in rows if "tridiag" in key]

    rows = device_rows(lambda: s._step(out, f, {}))
    if not rows:
        raise RuntimeError("the profiler saw no device kernel in a step")
    log(f"[slice3d] profiler, one step: {sum(r[1] for r in rows)} device "
        f"kernels, device busy {sum(r[0] for r in rows) / 1e3:.2f} ms; top "
        "by device time:")
    for us, cnt, key in rows[:12]:
        log(f"[slice3d]   {us / 1e3:8.3f} ms  x{cnt:<5d} {key[:90]}")
    if sum(cnt for cnt, _ in tridiag_rows(rows)) != 2:
        raise AssertionError("the step should launch two tridiagonal "
                             f"kernels: {tridiag_rows(rows)}")
    # the velocity column solve alone at the step's shapes (no stress, no
    # drag): both components share (nc, 3, nz + 1) coefficients
    Dn = torch.full((nc, 3, NZ3), DEPTH3 / NZ3, dtype=torch.float32,
                    device=dev)
    nu = torch.full_like(out["uv_3d"][..., 0], 1e-3)
    rows = device_rows(lambda: vertical_viscosity_implicit(
        out["uv_3d"], nu, Dn, s.dt))
    log(f"[slice3d] the velocity column solve alone: "
        f"{sum(r[1] for r in rows)} device kernels, "
        f"{sum(r[0] for r in rows):.1f} us:")
    for us, cnt, key in rows:
        log(f"[slice3d]   {us:8.2f} us  x{cnt:<3d} {key[:100]}")
    tiled = "tridiag_tile_kernel<float, 2>"
    solve = tridiag_rows(rows)
    if len(solve) != 1 or solve[0][0] != 1 or tiled not in solve[0][1]:
        raise AssertionError("the velocity solve should launch the tiled "
                             "kernel with two right-hand sides a column, "
                             f"once: {solve}")
    # and its call of the kernel's wrapper, operands made as vdiff_implicit
    # makes them: the kernel reads them as they are, so the call is that
    # one kernel (no copy of a broadcast coefficient) and one allocation,
    # its result (no scratch)
    uv = out["uv_3d"].movedim(-1, 0)
    prof = torch.cat([uv[..., :, 0], uv[..., -1:, 1]], dim=-1)
    a = torch.rand((nc, 3, NZ3 + 1), dtype=torch.float32, device=dev)
    neg_a, b = -a, 1.0 + 2.0 * a
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    launches = tridiag.launches()
    x = tridiag.tridiag_solve(neg_a, b, neg_a, prof)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    launches = tridiag.launches() - launches
    rows = device_rows(lambda: tridiag.tridiag_solve(neg_a, b, neg_a, prof))
    log(f"[slice3d] tridiag_solve of {tuple(a.shape)} coefficients and a "
        f"{tuple(prof.shape)} right-hand side: {launches} launch, {allocs} "
        "device allocation (the result); device kernels: "
        + "; ".join(f"x{cnt} {key[:70]} {us:.2f} us"
                    for us, cnt, key in rows))
    if (launches, allocs) != (1, 1) or tuple(x.shape) != tuple(prof.shape) \
            or len(rows) != 1 or rows[0][1] != 1 or tiled not in rows[0][2]:
        raise AssertionError(
            "the velocity solve's call of tridiag_solve should be one "
            "launch of the tiled kernel with two right-hand sides a "
            "column, no other device kernel, and allocate only its "
            f"result: {launches} launches, {allocs} allocations, {rows}")


def phase_parity3d(nx=NX3, nx_small=16):
    """f64 on the GPU (kernels) against the CPU (plain path), every state
    key: one step of the plain workload and three of the GLS workload
    without and with advection of tke and psi (at full width: the closure
    starts on its floors, so the first step moves the eddy coefficients
    only, and a uniform tke and psi have nothing to advect); three steps
    of the estuary at 8 x 8 x 4, of ROFI at coarse 16 with 2 layers, of
    each coupling on the channel at ``nx_small`` x ``nx_small`` and of
    LeapFrogAM3 with GLS at full width (on the GLS workload at 8 x 8 the
    closure turns a relative change of 1e-15 in the start into 2e-9 of
    mu_v's scale in three steps, under SSPRK22 as under LeapFrogAM3; at 16
    x 16 and 48 x 48 into 5-7e-11, which the card's f64 roundoff made
    5.5e-10 at 16 x 16 and 4.5e-11 at 48 x 48)."""
    cases = parity_cases(nx)
    small = parity_cases(nx_small)
    for name in COUPLINGS:
        if name != "leapfrog_gls_advected":   # at full width, as the GLS
            cases[f" {name}"] = small[f" {name}"]  # cases above
    for tag, (make, nsteps, per_step) in cases.items():
        cpu, gpu = make(torch.device("cpu")), make(torch.device("cuda"))
        bnd_gpu = gpu[3]
        reset_counts()
        a, t_gpu = sync_time(
            lambda: gpu[0].advance_n(gpu[1], gpu[2], bnd_gpu, nsteps))
        n = counts()
        if min(n.values()) == 0 or n["tridiag"] != per_step * nsteps:
            raise AssertionError(f"the f64 GPU 3D{tag} steps' launches: {n}")
        t0 = time.perf_counter()
        b = cpu[0].advance_n(cpu[1], cpu[2], cpu[3], nsteps)
        t_cpu = time.perf_counter() - t0
        if sorted(a) != sorted(b) or \
                tuple(sorted(b)) != state3d_keys(cpu[0].options):
            raise AssertionError(f"parity3d{tag}: state keys {sorted(a)}")
        if "gls" in tag and not float(b["tke_3d"].max()) > 2e-6:
            raise AssertionError(f"parity3d{tag}: tke_3d still on its floor")
        errs = compare(f"parity3d{tag}", a, b, PARITY_RTOL)
        mesh = cpu[0].mesh2d
        log(f"[parity3d{tag}] f64 {mesh.nc} triangles x {cpu[0].n_layers} "
            f"layers, {nsteps} step(s), GPU kernels {t_gpu:.2f} s vs CPU "
            f"plain {t_cpu:.2f} s: max|diff|/max {errs} "
            f"<= {PARITY_RTOL:g} x max: ok")


def field_range(v):
    return f"{float(v.min()):.3e}..{float(v.max()):.3e}"


def solve_shapes(s, state, f):
    """One more step from ``state`` with the column solves' calls of the
    tridiagonal wrapper recorded: the number of right-hand sides that share
    each coefficient column, call by call."""
    from thetis_tpu_torch.equations import turbulence

    seen = []
    wrapped = turbulence.tridiag_solve

    def recorder(dl, dd, du, rhs):
        seen.append(rhs.numel() // dd.numel())
        return wrapped(dl, dd, du, rhs)

    turbulence.tridiag_solve = recorder
    try:
        s._step(state, f, {})
    finally:
        turbulence.tridiag_solve = wrapped
    return seen


def phase_model3d_gls(smi, plain_ms):
    """The 3D model with the GLS closure as a user's run script has it:
    options, ``assign_initial_conditions``, ``iterate()`` with exports and
    the conservation monitors; then the same steps through ``advance_n``
    from the same start, which must end on the same bits."""
    dev = torch.device("cuda")
    s, state0, f, n_dofs = workload3d_gls(dev, torch.float32)
    n_dofs += 2 * s.mesh2d.nc * 3 * NZ3 * 2  # tke, psi
    go = s.gls.options
    start = {k: v.clone() for k, v in state0.items()}
    _, t_warm = sync_time(lambda: iterate_steps(s, 1))
    top = float(s.extruded.sigma_np[-1] - s.extruded.sigma_np[-2]) * DEPTH3
    log(f"[model3d gls] f32 {NX3}x{NY3}x{NZ3}, {go.closure_name} / "
        f"{go.stability_function_name}, wind {GLS_WIND} N/m^2, top layer "
        f"{top:.2f} m: {n_dofs} DOF, dt={s.dt:g} s; warm-up step through "
        f"iterate() {t_warm * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, t = sync_time(lambda: iterate_steps(s, STEPS3, exports=2))
    n = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = s._get_state()
    ms = t / STEPS3 * 1e3
    if (s.iteration, s.i_export) != (STEPS3 + 1, 3):
        raise AssertionError(f"iterate(): {s.iteration} steps, "
                             f"{s.i_export} exports")
    for k, v in out.items():
        if tuple(v.shape) != tuple(start[k].shape):
            raise AssertionError(f"{k} shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite {k} after {STEPS3 + 1} steps")
    if not bool(torch.isfinite(s.fields.w_3d.data).all()):
        raise AssertionError("non-finite w_3d from _set_state")
    if n["tridiag"] != 4 * STEPS3:
        raise AssertionError(f"tridiag launched {n['tridiag']} times in "
                             f"{STEPS3} steps, not 4 per step")
    if n["ring_mv"] == 0 or n["block_diag_mv"] == 0:
        raise AssertionError(f"the barotropic solve missed a kernel: {n}")
    if not float(out["tke_3d"].max()) > go.k_min:
        raise AssertionError("tke_3d never left its floor")
    if not float(out["nu_v_3d"].max()) > go.visc_min:
        raise AssertionError("nu_v_3d never left its floor")
    monitors = {k: cb() for k, cb in s.callbacks["export"].items()}
    if sorted(monitors) != ["temp_3d mass", "temp_3d overshoot", "volume3d"]:
        raise AssertionError(f"monitors {sorted(monitors)}")
    if not abs(monitors["volume3d"][1]) <= VOLUME_RTOL_F32:
        raise AssertionError(f"volume relative error {monitors['volume3d']}")
    per = {k: v / STEPS3 for k, v in n.items()}
    cycles = n["block_diag_mv"] / STEPS3 / RESTART3
    log(f"[model3d gls] {STEPS3} steps through iterate(), 2 exports: "
        f"{ms:.2f} ms/step, {n_dofs * STEPS3 / t:.4e} DOF*steps/s (the plain "
        f"step in this run: {plain_ms:.2f} ms/step, x{ms / plain_ms:.2f}); "
        f"launches {n} = per step {per} ({cycles:.2f} FGMRES cycles of "
        f"{RESTART3}); peak memory {peak:.2f} GiB; every state field and "
        "w_3d finite")
    log(f"[model3d gls] tke_3d {field_range(out['tke_3d'])} (k_min "
        f"{go.k_min:g}), psi_3d {field_range(out['psi_3d'])}, nu_v_3d "
        f"{field_range(out['nu_v_3d'])} (visc_min {go.visc_min:g}), mu_v_3d "
        f"{field_range(out['mu_v_3d'])}, max|uv_3d| "
        f"{float(out['uv_3d'].abs().max()):.4e} m/s, temp "
        f"{field_range(out['temp_3d'])} C")
    log("[model3d gls] monitors after the last export: volume3d rel. error "
        f"{monitors['volume3d'][1]:.3e} (<= {VOLUME_RTOL_F32:g}), temp_3d "
        f"mass rel. error {monitors['temp_3d mass'][1]:.3e}, temp_3d "
        f"undershoot / overshoot {monitors['temp_3d overshoot'][2]:.3e} / "
        f"{monitors['temp_3d overshoot'][3]:.3e} C; card: {smi}")
    # the same steps without the lifecycle, from the same start
    warm = s.advance_n(start, f, {}, 1)
    again, t_adv = sync_time(lambda: s.advance_n(warm, f, {}, STEPS3))
    diff = [k for k in out if not torch.equal(again[k], out[k])]
    if diff or sorted(again) != sorted(out):
        raise AssertionError("iterate() and advance_n over the same "
                             f"{STEPS3 + 1} steps differ in {diff}")
    log(f"[model3d gls] advance_n over the same steps: "
        f"{t_adv / STEPS3 * 1e3:.2f} ms/step (iterate() x"
        f"{t / t_adv:.3f}); final state bit-equal on all {len(out)} keys")
    nrhs = solve_shapes(s, out, f)
    if nrhs != [2, 1, 1, 1]:
        raise AssertionError("a GLS step's column solves should be one with "
                             "two right-hand sides (velocity) and three with "
                             f"one (tracer, k, psi): {nrhs}")
    log(f"[model3d gls] right-hand sides per coefficient column, solve by "
        f"solve: {nrhs} (velocity pair, temperature, k, psi)")
    run_profile("profile3d_gls", "[model3d gls profile]")
    return n


def profile3d_gls():
    """The profiler's view of the GLS step, from a fresh process (kernels
    built already): the device kernels of the step that follows 1 + 20
    steps, and those of one ``step_columns`` call on that state.  Records,
    apart from this: an empty capture fails."""
    phase_device()
    dev = torch.device("cuda")
    s, state0, f, _ = workload3d_gls(dev, torch.float32)
    out = s.advance_n(state0, f, {}, STEPS3 + 1)
    device_rows(lambda: torch.ones(8, device=dev) + 1)  # profiler warm-up
    tag = "[model3d gls profile]"
    show_step_profile(tag, "one GLS step", lambda: s._step(out, f, {}), 12)
    geom = s.asm3d.layer_geometry(
        s.extruded.z_interfaces(s.bathy_cell, out["elev"]))
    uv = out["uv_3d"] + out["uv"][:, :, None, None, :]
    rho = s.density_solver.solve(out["salt_3d"], out["temp_3d"])
    m2, n2 = s.gls.compute_shear_buoy_freq(uv, rho, geom,
                                           rho0=physical_constants["rho0"])
    show_step_profile(tag, "one step_columns call", lambda: s.gls.step_columns(
        out["tke_3d"], out["psi_3d"], m2, n2, out["nu_v_3d"],
        out["mu_v_3d"], geom["Delta_nodes"], s.dt), 6)
    show_step_profile(tag, "one eddy_coefficients call",
                      lambda: s.gls.eddy_coefficients(
                          out["tke_3d"], out["psi_3d"], m2, n2), 4)


def phase_model3d_split(smi):
    """``dt_mode='split'``: the 2D mode as ``M_modesplit`` explicit SSPRK33
    substeps in place of the CN solve, so no ring kernel is launched."""
    dev = torch.device("cuda")
    s, state0, f, n_dofs = workload3d(dev, torch.float32,
                                      options=dict(dt_mode="split"))
    want_m = math.ceil(300.0 / 10.0)  # ceil(dt / timestep_2d), its default
    if (s.M_modesplit, type(s.swe_stepper).__name__) != (want_m, "SSPRK33") \
            or abs(s.dt_2d * want_m - s.dt) > 1e-9:
        raise AssertionError(f"split: M_modesplit {s.M_modesplit}, dt_2d "
                             f"{s.dt_2d}, {type(s.swe_stepper).__name__}")
    nsteps = 5
    state, t_warm = sync_time(lambda: s._step(state0, f, {}))
    reset_counts()
    out, t = sync_time(lambda: s.advance_n(state, f, {}, nsteps))
    n = counts()
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"split: non-finite {k}")
    if (n["ring_mv"], n["block_diag_mv"], n["tridiag"]) != (0, 0,
                                                            2 * nsteps):
        raise AssertionError(f"split: launches {n}")
    log(f"[model3d split] f32 {NX3}x{NY3}x{NZ3}, dt={s.dt:g} s, M_modesplit "
        f"{s.M_modesplit} explicit SSPRK33 substeps of {s.dt_2d:g} s (2D "
        f"wave bound {s.compute_dt_2d(0.1):.2f} s): warm-up "
        f"{t_warm * 1e3:.1f} ms; {nsteps} steps {t / nsteps * 1e3:.2f} "
        f"ms/step; launches {n}; max|elev| "
        f"{float(out['elev'].abs().max()):.4e} m, max|uv| "
        f"{float(out['uv'].abs().max()):.4e} m/s; every state field finite; "
        f"card: {smi}")
    return n


def phase_katophillips(smi):
    """The reference's GLS validation run, f64, through ``iterate()``: the
    mixed-layer depth (the lowest point where tke > 1e-5 m^2/s^2, on a
    grid 8 times finer than the layers) against the empirical
    1.05 u* sqrt(t / N0), to the reference test's 10%."""
    s, z_if = kato_phillips(torch.device("cuda"), torch.float64)
    reset_counts()
    _, t = sync_time(s.iterate)
    n = counts()
    if (s.iteration, s.i_export) != (240, 4) or n["tridiag"] != 4 * 240:
        raise AssertionError(f"katophillips: {s.iteration} steps, "
                             f"{s.i_export} exports, launches {n}")
    tke = s.fields.tke_3d.data.cpu().numpy()
    if not np.isfinite(tke).all():
        raise AssertionError("katophillips: non-finite tke")
    prof = np.concatenate([tke[0, 0, :, 0], tke[0, 0, -1:, 1]])
    zfine = np.linspace(z_if[0], z_if[-1], KP_LAYERS * 8)
    mixed = np.interp(zfine, z_if, prof) > 1e-5
    if not mixed.any():
        raise AssertionError("katophillips: no turbulent layer developed")
    depth = -zfine[mixed].min()
    target = 1.05 * KP_US * math.sqrt(s.simulation_time / KP_N0)
    rel = (depth - target) / target
    if abs(rel) >= 0.10:
        raise AssertionError(f"katophillips: mixed layer {depth:.2f} m "
                             f"against {target:.2f} m")
    log(f"[katophillips] f64 3x2x{KP_LAYERS}, 240 steps of {s.dt:g} s "
        f"through iterate(), 4 exports: {t:.1f} s, {t / 240 * 1e3:.1f} "
        f"ms/step; launches {n}; mixed-layer depth {depth:.2f} m against "
        f"1.05 u* sqrt(t/N0) = {target:.2f} m ({rel:+.1%}, bound 10%); "
        f"surface tke {prof[-1]:.3e} m^2/s^2, max nu_v "
        f"{float(s.fields.nu_v_3d.data.max()):.3e} m^2/s; card: {smi}")
    return n


# -- this slice's paths: ROFI, the estuary, the couplings ----------------
ROFI_STEPS = 200
EST_STEPS = STEPS3                       # 1 warm-up + 20 timed
COUPLING_STEPS = 5
#: the 3D workload (bench.py) under each option of the couplings phase
COUPLINGS = {
    "fixed_mesh": dict(use_ale_moving_mesh=False),
    "unsplit": dict(use_modesplit_2d=False),
    "quadratic": dict(use_quadratic_pressure=True,
                      use_quadratic_density=True),
    "leapfrog_gls_advected": None,       # the GLS workload, see below
}
#: tridiagonal launches a step: velocity pair, each tracer, k and psi
TRIDIAG_PER_STEP = {"rofi": 4, "estuary": 5, "fixed_mesh": 2, "unsplit": 2,
                    "quadratic": 2, "leapfrog_gls_advected": 4}


def coupling_workload(name, device, dtype, nx=NX3, ny=NY3):
    """``(solver, state, fields, DOF)`` of the bench's 3D workload under
    the coupling ``name``; ``leapfrog_gls_advected`` is the GLS workload
    with LeapFrogAM3 and tke/psi advected."""
    if name == "leapfrog_gls_advected":
        opts = dict(GLS_OPTIONS, use_turbulence_advection=True,
                    wind_stress=np.array(GLS_WIND),
                    timestepper_type="LeapFrogAM3")
        return workload3d(device, dtype, nx, ny, options=opts,
                          stretch=GLS_STRETCH)
    return workload3d(device, dtype, nx, ny, options=COUPLINGS[name])


def check_finite(tag, state):
    for k, v in state.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{tag}: non-finite {k}")


def monitor_text(s):
    return callbacks_text(s.callbacks["export"])


def callbacks_text(cbs):
    """The monitors' readings now against their first value."""
    out = []
    for name, cb in cbs.items():
        v = cb()
        out.append(f"{name} rel. error {v[1]:.3e}" if len(v) == 2 else
                   f"{name} {v[0]:.4f}..{v[1]:.4f} (under/overshoot "
                   f"{v[2]:.2e}/{v[3]:.2e})")
    return "; ".join(out)


def launches_text(n, steps):
    cycles = n["block_diag_mv"] / steps / RESTART3
    return (f"launches {n} = per step "
            f"{ {k: v / steps for k, v in n.items()} } ({cycles:.2f} FGMRES "
            f"cycles of {RESTART3})")


def check_launches(tag, n, steps, per_step):
    if n["tridiag"] != per_step * steps:
        raise AssertionError(f"{tag}: tridiag launched {n['tridiag']} times "
                             f"in {steps} steps, not {per_step} a step")
    if n["ring_mv"] == 0 or n["block_diag_mv"] == 0:
        raise AssertionError(f"{tag}: the barotropic solve missed a kernel: "
                             f"{n}")


def phase_model3d_rofi(smi):
    """The Rhine ROFI example at its own size (870 triangles, 12 layers,
    dt 7 s), 200 steps through ``iterate(update_forcings=...)`` as its
    script runs it, in f32 and in f64, with the example's checks:
    salinity within [-0.01, 32.01], and the freshwater volume changed by
    less than 5% (in f64: in f32 the ocean's salinity, 32 to 6e-8, drifts
    up by ~1e-4 psu in 200 steps, which the ocean's 1e13 m^3 turn into a
    ~10% loss of the diagnostic)."""
    dev = torch.device("cuda")
    total = {k: 0 for k in KERNELS}
    ms = {}
    for dtype in (torch.float32, torch.float64):
        s, forcing, bathy_cell = rofi_solver(dev, dtype, steps=ROFI_STEPS)
        fw0 = rofi_freshwater(s, bathy_cell)
        reset_counts()
        _, t = sync_time(lambda: s.iterate(update_forcings=forcing))
        n = counts()
        fw1 = rofi_freshwater(s, bathy_cell)
        state = s._get_state()
        tag = f"model3d rofi {str(dtype)[6:]}"
        check_finite(tag, state)
        check_launches(tag, n, ROFI_STEPS, TRIDIAG_PER_STEP["rofi"])
        for k in KERNELS:
            total[k] += n[k]
        salt = state["salt_3d"]
        lo, hi = float(salt.min()), float(salt.max())
        drift = (fw1 - fw0) / fw0
        if s.iteration != ROFI_STEPS or not (lo > -0.01 and hi < 32.01) \
                or (dtype == torch.float64 and not abs(drift) < 0.05):
            raise AssertionError(f"{tag}: {s.iteration} steps, salinity "
                                 f"{lo}..{hi}, freshwater change {drift}")
        ms[dtype] = t / ROFI_STEPS * 1e3
        log(f"[model3d rofi] {str(dtype)[6:]} {s.mesh2d.nc} triangles x "
            f"{s.n_layers} layers ({s.mesh2d.nc * 3} columns), LeapFrogAM3 "
            f"+ GLS + Smagorinsky, dt {s.dt:g} s: {ROFI_STEPS} steps through "
            f"iterate(update_forcings) {t:.2f} s = {ms[dtype]:.2f} ms/step; "
            f"{launches_text(n, ROFI_STEPS)}")
        log(f"[model3d rofi] {str(dtype)[6:]} salinity {lo:.4f}..{hi:.4f} "
            f"(bound -0.01..32.01), freshwater volume {fw0:.6e} -> "
            f"{fw1:.6e} m^3 (change {drift:+.3e}"
            + (", bound 0.05" if dtype == torch.float64 else "") +
            f"), max|uv_3d| {float(state['uv_3d'].abs().max()):.4e} m/s, "
            f"tke {field_range(state['tke_3d'])}, nu_v "
            f"{field_range(state['nu_v_3d'])}; monitors: {monitor_text(s)}; "
            f"card: {smi}")
    return total, ms[torch.float32]


def phase_model3d_estuary(smi):
    """ROFI's options at the bench's width (48 x 48 x 12, 4,608 columns),
    f32: 1 warm-up and 20 timed steps through ``iterate(update_forcings=
    ...)``, the tide set every step."""
    dev = torch.device("cuda")
    s, forcing, n_dofs = estuary(dev, torch.float32)
    o = s.options
    _, t_warm = sync_time(lambda: s.iterate(update_forcings=forcing))
    o.simulation_export_time = EST_STEPS * s.dt
    o.simulation_end_time = s.simulation_time + EST_STEPS * s.dt
    reset_counts()
    _, t = sync_time(lambda: s.iterate(update_forcings=forcing))
    n = counts()
    state = s._get_state()
    check_finite("model3d estuary", state)
    check_launches("model3d estuary", n, EST_STEPS,
                   TRIDIAG_PER_STEP["estuary"])
    salt = state["salt_3d"]
    lo, hi = float(salt.min()), float(salt.max())
    if s.iteration != EST_STEPS + 1 or not (lo > -0.01 and hi < 32.01):
        raise AssertionError(f"model3d estuary: {s.iteration} steps, "
                             f"salinity {lo}..{hi}")
    ms = t / EST_STEPS * 1e3
    log(f"[model3d estuary] f32 {s.mesh2d.nc} triangles x {s.n_layers} "
        f"layers ({s.mesh2d.nc * 3} columns, 2 km), LeapFrogAM3 + GLS + "
        f"Smagorinsky + CG1 sponge, 2 tracers on "
        f"their own paths, dt {s.dt:g} s: {n_dofs} 3D DOF; warm-up step "
        f"{t_warm * 1e3:.1f} ms; {EST_STEPS} steps through "
        f"iterate(update_forcings) {ms:.2f} ms/step, "
        f"{n_dofs * EST_STEPS / t:.4e} DOF*steps/s; "
        f"{launches_text(n, EST_STEPS)}")
    log(f"[model3d estuary] salinity {lo:.4f}..{hi:.4f} (bound "
        f"-0.01..32.01), temperature {field_range(state['temp_3d'])}, max|"
        f"elev| {float(state['elev'].abs().max()):.4e} m, max|uv_3d| "
        f"{float(state['uv_3d'].abs().max()):.4e} m/s, nu_v "
        f"{field_range(state['nu_v_3d'])}; every state field finite; "
        f"monitors: {monitor_text(s)}; card: {smi}")
    run_profile("profile3d_estuary", "[model3d estuary profile]")
    return n, ms


def phase_model3d_couplings(smi):
    """The bench's 3D workload at full width under each coupling of this
    slice: 1 warm-up and 5 timed steps each."""
    dev = torch.device("cuda")
    total = {k: 0 for k in KERNELS}
    for name in COUPLINGS:
        s, state0, f, n_dofs = coupling_workload(name, dev, torch.float32)
        state, t_warm = sync_time(lambda: s._step(state0, f, {}))
        reset_counts()
        out, t = sync_time(lambda: s.advance_n(state, f, {}, COUPLING_STEPS))
        n = counts()
        check_finite(f"model3d couplings {name}", out)
        check_launches(f"model3d couplings {name}", n, COUPLING_STEPS,
                       TRIDIAG_PER_STEP[name])
        for k in KERNELS:
            total[k] += n[k]
        log(f"[model3d couplings] {name}: f32 {NX3}x{NY3}x{NZ3}, warm-up "
            f"{t_warm * 1e3:.1f} ms; {COUPLING_STEPS} steps "
            f"{t / COUPLING_STEPS * 1e3:.2f} ms/step; "
            f"{launches_text(n, COUPLING_STEPS)}; state keys "
            f"{len(out)}, every field finite; card: {smi}")
    run_profile("profile3d_more", ("[model3d rofi profile]",
                                   "[model3d couplings profile]"))
    return total


def profile3d_estuary():
    """The profiler's view of one estuary step after 1 + 20, from a fresh
    process (kernels built already)."""
    phase_device()
    dev = torch.device("cuda")
    s, forcing, _ = estuary(dev, torch.float32)
    forcing(0.0)
    f, b = s._gather_swe_fields(), s._gather_bnd_sw()
    out = s.advance_n(s._get_state(), f, b, EST_STEPS + 1)
    device_rows(lambda: torch.ones(8, device=dev) + 1)  # profiler warm-up
    show_step_profile("[model3d estuary profile]", "one step",
                      lambda: s._step(out, f, b))


def profile3d_more():
    """The profiler's view of one ROFI step and of one step of each
    coupling, each after 3 steps, from a fresh process."""
    phase_device()
    dev = torch.device("cuda")
    s, forcing, _ = rofi_solver(dev, torch.float32)
    forcing(0.0)
    f, b = s._gather_swe_fields(), s._gather_bnd_sw()
    out = s.advance_n(s._get_state(), f, b, 3)
    device_rows(lambda: torch.ones(8, device=dev) + 1)  # profiler warm-up
    show_step_profile("[model3d rofi profile]", "one step",
                      lambda: s._step(out, f, b))
    for name in COUPLINGS:
        s, state0, f, _ = coupling_workload(name, dev, torch.float32)
        out = s.advance_n(state0, f, {}, 3)
        show_step_profile("[model3d couplings profile]", f"{name}, one step",
                          lambda: s._step(out, f, {}))


def parity_cases(nx):
    """The f64 GPU-against-CPU cases of phase 7: ``tag -> (make(device),
    steps, tridiag launches a step)``, ``make`` returning ``(solver,
    state, fields, bnd)``."""
    def bench(make):
        def build(dev):
            s, state, f, _ = make(dev, torch.float64, nx, nx)
            return s, state, f, {}
        return build

    def est(dev):
        s, forcing, _ = estuary(dev, torch.float64, n=8, nz=4)
        forcing(0.0)
        return (s, s._get_state(), s._gather_swe_fields(),
                s._gather_bnd_sw())

    def rofi(dev):
        # ROFI at coarse 16 with 2 layers, from a stably stratified start
        # (2 psu fresher at the top): the example's start is uniform in
        # the vertical, where N^2 is roundoff and the closure's psi source
        # picks its c3 by its sign (a relative change of 1e-15 there moves
        # nu_v by ~4e-5 of its scale; here by 1e-13 after three steps)
        s, forcing, _ = rofi_solver(dev, torch.float64, coarse=16.0,
                                    layers=2, steps=3)
        sig = torch.as_tensor(s.extruded.sigma_np, dtype=torch.float64,
                              device=dev)
        sig_n = torch.stack([sig[:-1], sig[1:]], dim=-1)
        s.fields.salt_3d.data = s.fields.salt_3d.data + 2.0 * (1 - sig_n)
        forcing(0.0)
        return (s, s._get_state(), s._gather_swe_fields(),
                s._gather_bnd_sw())

    cases = {"": (bench(workload3d), 1, 2),
             " gls": (bench(workload3d_gls), 3, 4),
             " gls advected": (bench(
                 lambda *a: workload3d_gls(*a, advect=True)), 3, 4),
             " estuary": (est, 3, TRIDIAG_PER_STEP["estuary"]),
             " rofi": (rofi, 3, TRIDIAG_PER_STEP["rofi"])}
    for name in COUPLINGS:
        cases[f" {name}"] = (bench(
            lambda d, dt, a, b, name=name: coupling_workload(name, d, dt, a,
                                                             b)),
            3, TRIDIAG_PER_STEP[name])
    return cases


def phase_model_ssprk33(smi):
    s, t_setup = model2d("ssprk33", torch.device("cuda"), torch.float32)
    shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
    n_dofs = s.mesh2d.nc * 9
    _, t_warm = sync_time(lambda: iterate_steps(s, 1))
    log(f"[model2d ssprk33] f32 {NX}x{NY}: nc={s.mesh2d.nc}, {n_dofs} DOF, "
        f"dt={s.dt:.4f} s (0.08 hmin/c); setup {t_setup:.2f} s, warm-up "
        f"step {t_warm * 1e3:.1f} ms")
    reset_counts()
    _, t = sync_time(lambda: iterate_steps(s, STEPS_SSP))
    n = counts()
    check_state("model2d ssprk33", s, shapes)
    if s.iteration != STEPS_SSP + 1:
        raise AssertionError(f"iterate ran {s.iteration} steps")
    ms = t / STEPS_SSP * 1e3
    st = s._get_state()
    f = s._gather_swe_fields()
    rows = device_rows(lambda: s._advance(0.0, st, f, {}, {}, {}))
    if not rows:
        raise RuntimeError("the profiler saw no device kernel in a step")
    log(f"[model2d ssprk33] {STEPS_SSP} steps through iterate(): "
        f"{ms:.2f} ms/step, {n_dofs * STEPS_SSP / t:.4e} DOF*steps/s; "
        f"launches {n} (no kernel on the explicit path); profiler, one "
        f"step: {sum(r[1] for r in rows)} device kernels, device busy "
        f"{sum(r[0] for r in rows) / 1e3:.3f} ms; max|elev| "
        f"{float(st['elev'].abs().max()):.4f} m; card: {smi}")
    return n


def phase_model_cn(smi, n_slice, s_slice):
    s, t_setup = model2d("cn", torch.device("cuda"), torch.float32)
    shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
    _, t_warm = sync_time(lambda: iterate_steps(s, 1))
    nsteps = 10
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, t = sync_time(lambda: iterate_steps(s, nsteps))
    n = counts()
    check_state("model2d cn", s, shapes)
    ms = t / nsteps * 1e3
    errs = []
    for k in ("elev", "uv"):
        a, b = s._get_state()[k], s_slice[k]
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        errs.append(f"{k} {err:.2e}/{scale:.2e}")
        if err > MODEL_CN_RTOL * scale:
            raise AssertionError(f"model2d cn: FlowSolver2d state differs "
                                 f"from the hand-wired run: {errs}")
    if (n["ring_mv"], n["block_diag_mv"]) != (n_slice["ring_mv"],
                                              n_slice["block_diag_mv"]):
        raise AssertionError(f"model2d cn launches {n} != hand-wired "
                             f"{n_slice}")
    log(f"[model2d cn] f32 {NX}x{NY}, dt={s.dt:.3f} s (2 hmin/c), policy "
        f"PC {type(s.timestepper.coarse).__name__}: setup {t_setup:.2f} s, "
        f"warm-up {t_warm * 1e3:.1f} ms; {nsteps} steps through iterate(): "
        f"{ms:.2f} ms/step, {9 * s.mesh2d.nc * nsteps / t:.4e} "
        f"DOF*steps/s; launches {n} (= phase 4's); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; against "
        f"phase 4's final state max|diff|/max {'; '.join(errs)} <= "
        f"{MODEL_CN_RTOL:g}; "
        f"card: {smi}")
    return n


def phase_model_policy(smi):
    dev = torch.device("cuda")
    mesh = RectangleMesh(NX, NY, LX, LY, device=dev, dtype=torch.float32)
    _, t_col = sync_time(lambda: get_coloring(mesh))
    n_colors = int(get_coloring(mesh)[2].max()) + 1
    log(f"[model2d policy] distance-2 colouring of {mesh.nc} cells (host): "
        f"{t_col:.2f} s, {n_colors} colours (cached on the mesh)")
    total = {k: 0 for k in KERNELS}
    nsteps = 3
    for config in ("cn_coarse", "cn_schur", "cn_newton"):
        torch.cuda.reset_peak_memory_stats()
        s, t_setup = model2d(config, dev, torch.float32, mesh=mesh)
        ts = s.timestepper
        pc = (ts.preconditioner if config == "cn_newton" else ts.coarse)
        if type(pc).__name__ != MODEL2D[config][4]:
            raise AssertionError(f"{config}: the policy picked "
                                 f"{type(pc).__name__}")
        shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
        _, t_warm = sync_time(lambda: iterate_steps(s, 1))
        reset_counts()
        stats = []

        def run():
            for _ in range(nsteps):
                iterate_steps(s, 1)
                stats.append(dict(ts.stats))

        _, t = sync_time(run)
        n = counts()
        for k in KERNELS:
            total[k] += n[k]
        check_state(f"model2d {config}", s, shapes)
        params = ts.params
        if config == "cn_newton":
            worst = max(x["snes_rel_residual"] for x in stats)
            limit = params.snes_rtol
            newton = sum(x["newton_iterations"] for x in stats) / nsteps
        else:
            worst = max(x["ksp_rel_residual"] for x in stats)
            limit = params.ksp_rtol
            newton = 1.0
        # the Schur fieldsplit is a full PC: no block-Jacobi in that solve
        bjac = config != "cn_schur"
        if n["ring_mv"] == 0 or (n["block_diag_mv"] == 0) == bjac:
            raise AssertionError(f"{config} launches {n}")
        if not worst <= limit:
            raise AssertionError(f"{config}: final relative residual "
                                 f"{worst:.3e} > requested {limit:g}")
        cycles = sum(x["ksp_cycles"] for x in stats) / nsteps
        cfl = s._wave_cfl(ts.theta * s.dt)
        log(f"[model2d {config}] f32 {NX}x{NY}, dt={s.dt:.3f} s "
            f"({MODEL2D[config][2]:g} hmin/c, policy CFL {cfl:.2f}), PC "
            f"{type(pc).__name__}: setup {t_setup:.2f} s, warm-up "
            f"{t_warm * 1e3:.1f} ms; {nsteps} steps {t / nsteps * 1e3:.2f} "
            f"ms/step; Newton iterations/step {newton:.2f}, FGMRES cycles/"
            f"step {cycles:.2f}; per step ring_mv {n['ring_mv'] / nsteps:.1f}"
            f", block_diag_mv {n['block_diag_mv'] / nsteps:.1f}; worst "
            f"final relative residual {worst:.3e} <= {limit:g}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: "
            f"{smi}")
    return total


def phase_model_parity():
    """One f64 step of each configuration on the GPU (kernels) against
    the same step on the CPU (plain path)."""
    for config in MODEL2D:
        out = {}
        secs = {}
        for dev in ("cuda", "cpu"):
            s, t_setup = model2d(config, torch.device(dev), torch.float64,
                                 NX_PARITY, NY_PARITY)
            reset_counts()
            t0 = time.perf_counter()
            iterate_steps(s, 1)
            if dev == "cuda":
                torch.cuda.synchronize()
                n = counts()
            secs[dev] = (t_setup, time.perf_counter() - t0)
            out[dev] = s._get_state()
        bjac = config not in ("ssprk33", "cn_schur")
        if (n["ring_mv"] == 0) != (config == "ssprk33") or \
                (n["block_diag_mv"] == 0) == bjac:
            raise AssertionError(f"parity {config}: GPU step launches {n}")
        errs = compare(f"parity model2d {config}", out["cuda"], out["cpu"],
                       PARITY_RTOL)
        log(f"[parity model2d {config}] f64 {NX_PARITY}x{NY_PARITY} one "
            f"step, GPU kernels setup {secs['cuda'][0]:.2f} s + step "
            f"{secs['cuda'][1]:.2f} s vs CPU plain {secs['cpu'][0]:.2f} + "
            f"{secs['cpu'][1]:.2f} s: max|diff|/max {errs} <= "
            f"{PARITY_RTOL:g}: ok")

# -- the 2D slice: tracers, wetting-and-drying, the other steppers --------
#: phase 18, the slice at full width: the DIRK22 semi-implicit SWE with the
#: CN workload's Krylov settings (f32 floors near ksp_rtol 1e-5), two P1DG
#: tracers on the default CN tracer stepper (the reference's default
#: NewtonParameters), the limiter, a source on the first
SLICE2D_PARAMS = dict(ksp_rtol=1e-5, ksp_max_it=32, gmres_restart=RESTART)
TRACER_LABELS = ("tracer_2d", "salt_2d")
TRACER_SOURCE = 1e-6                    # 1/s, on tracer_2d
STEPS_SLICE2D = 10
#: the Thacker bowl (tests/test_thacker.py)
THACKER_L, THACKER_D0, THACKER_R, THACKER_ETA0 = 951646.46, 50.0, 430620.0, 2.0
THACKER_N = 226                         # 102,152 cells, the bench's width
THACKER_BOUNDS = {"CrankNicolson": 0.26, "DIRK22": 0.26,
                  "BackwardEuler": 0.33}
#: the f64 parity of a wetting-and-drying step: a Krylov budget that
#: solves the step to roundoff (with the default 48 iterations the mass
#: preconditioner leaves the DIRK22 stages near 8e-5, where two summation
#: orders part at ~6e-6 of the state)
WD_PARITY_PARAMS = dict(ksp_rtol=1e-12, ksp_max_it=400, gmres_restart=50)
PPP_SW_BOUND = 5e-3                     # tests/test_standing_wave.py, n = 20


def slice2d_solver(device, dtype, nx=NX, ny=NY, stepper="DIRK22",
                   tracers=True, params=SLICE2D_PARAMS):
    """The bench's 2D case (the Gaussian of bench.py:67-70, depth 50 m, dt
    2 hmin/c) under ``stepper`` entered through the model API, with two
    tracers (a blob with a source, a salinity ramp) and the three
    monitors when ``tracers``.  Returns ``(solver, setup seconds)``."""
    mesh = RectangleMesh(nx, ny, LX, LY, device=device, dtype=dtype)
    s = FlowSolver2d(mesh, 50.0)
    o = s.options
    o.swe_timestepper_type = stepper
    if params is not None:
        o.swe_timestepper_options.solver_parameters = NewtonParameters(
            **params)
    o.timestep = 2.0 * float(mesh.cell_hmin_np.min()) / math.sqrt(9.81 * 51.0)
    o.quadratic_drag_coefficient = 2.5e-3
    o.no_exports = True
    if tracers:
        o.add_tracer_2d("tracer_2d", source=TRACER_SOURCE, diffusivity=1.0)
        o.add_tracer_2d("salt_2d", diffusivity=1.0)
        o.check_volume_conservation_2d = True
        o.check_tracer_conservation = True
        o.check_tracer_overshoot = True
    _, t_setup = sync_time(s.initialize)
    x = s.function_spaces.H_2d.dof_coords()
    xx, yy = x[..., 0], x[..., 1]
    kw = {}
    if tracers:
        kw = dict(tracer_2d=1.0 + 0.5 * torch.exp(
            -(((xx - LX / 4) / 10e3) ** 2) - ((yy - LY / 2) / 10e3) ** 2),
            salt_2d=30.0 + 2.0 * xx / LX)
    s.assign_initial_conditions(elev=torch.exp(
        -(((xx - LX / 2) / 15e3) ** 2) - ((yy - LY / 2) / 15e3) ** 2), **kw)
    return s, t_setup


def phase_slice2d_tracers(smi):
    """Phase 18, the 2D slice at full width through ``iterate()``:
    DIRK22 semi-implicit SWE (each stage an assembled FGMRES on ring_mv +
    block_diag_mv) with two P1DG tracers, the limiter, a source and the
    monitors; 1 warm-up + 10 steps, then the device kernels of one step
    from a fresh process (``python3 chip_smoke.py profile2d_tracers``)."""
    dev = torch.device("cuda")
    s, t_setup = slice2d_solver(dev, torch.float32)
    nc = s.mesh2d.nc
    n_dofs = 9 * nc + len(TRACER_LABELS) * 3 * nc
    shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
    mass0 = {l: s.compute_tracer_mass(l) for l in TRACER_LABELS}
    _, t_warm = sync_time(lambda: iterate_steps(s, 1))
    # the monitors iterate() attached, read now and after the timed steps
    # (with no_exports they are not evaluated inside iterate())
    monitors = dict(s.callbacks["export"])
    for cb in monitors.values():
        cb()
    if sorted(monitors) != sorted(
            ["volume2d"] + [f"{l} mass" for l in TRACER_LABELS]
            + [f"{l} overshoot" for l in TRACER_LABELS]):
        raise AssertionError(f"monitors {sorted(monitors)}")
    ts = s.timestepper
    log(f"[slice2d tracers] f32 {NX}x{NY}: nc={nc}, {n_dofs} DOF (SWE "
        f"{9 * nc} + 2 P1DG tracers), dt={s.dt:.3f} s (2 hmin/c), SWE "
        f"{type(ts).__name__} DIRK22 semi-implicit assembled (coarse PC "
        f"{type(ts.coarse).__name__}, wave CFL "
        f"{s._wave_cfl(float(ts.a[-1][-1]) * s.dt):.2f}), tracers "
        f"{type(s.tracer_stepper).__name__} + "
        f"{type(s.tracer_limiter).__name__}; setup {t_setup:.2f} s, warm-up "
        f"step {t_warm * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, t = sync_time(lambda: iterate_steps(s, STEPS_SLICE2D))
    n = counts()
    check_state("slice2d tracers", s, shapes)
    if s.iteration != STEPS_SLICE2D + 1:
        raise AssertionError(f"iterate ran {s.iteration} steps")
    if n["ring_mv"] == 0 or n["block_diag_mv"] == 0:
        raise AssertionError(f"the DIRK22 stages missed a kernel: {n}")
    st = ts.stats
    if st["stages"] != 2 or not st["ksp_rel_residual"] <= 1e-5:
        raise AssertionError(f"DIRK22 stage solves: {st}")
    tst = s.tracer_stepper.stats
    per = {k: v / STEPS_SLICE2D for k, v in n.items()}
    ms = t / STEPS_SLICE2D * 1e3
    mass = {l: (s.compute_tracer_mass(l) - mass0[l]) / abs(mass0[l])
            for l in TRACER_LABELS}
    if not abs(mass["salt_2d"]) < 1e-3:
        raise AssertionError(f"salt_2d mass changed by {mass['salt_2d']}")
    log(f"[slice2d tracers] {STEPS_SLICE2D} steps through iterate(): "
        f"{ms:.2f} ms/step, {n_dofs * STEPS_SLICE2D / t:.4e} DOF*steps/s; "
        f"launches {n} = per step {per} (both DIRK22 stages); last step's "
        f"SWE FGMRES cycles {st['ksp_cycles']} over {st['stages']} stages "
        f"({st['ksp_cycles'] / st['stages']:.2f} a stage, final relative "
        f"residual {st['ksp_rel_residual']:.2e}); tracer CN: "
        f"{tst.get('newton_iterations')} Newton iteration, "
        f"{tst.get('ksp_cycles')} FGMRES cycles of 16; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[slice2d tracers] tracer mass change since the start (11 steps): "
        f"tracer_2d {mass['tracer_2d']:.3e} (source {TRACER_SOURCE:g}/s), "
        f"salt_2d {mass['salt_2d']:.3e}; monitors over the 10 timed steps: "
        f"{callbacks_text(monitors)}; card: {smi}")
    run_profile("profile2d_tracers", "[slice2d tracers profile]")
    return n


def profile2d_tracers():
    """The profiler's view of one step of phase 18's slice after 2 steps,
    from a fresh process (kernels built already)."""
    phase_device()
    dev = torch.device("cuda")
    s, _ = slice2d_solver(dev, torch.float32)
    iterate_steps(s, 2)
    st = s._get_state()
    args = (0.0, st, s._gather_swe_fields(), s._gather_tracer_extra(st),
            s._gather_bnd("shallow_water"), s._gather_bnd("tracer"))
    device_rows(lambda: torch.ones(8, device=dev) + 1)  # profiler warm-up
    rows = device_rows(lambda: s._advance(*args))
    if not rows:
        raise RuntimeError("the profiler saw no device kernel in a step")
    hand = {k: sum(c for _, c, key in rows if f"{k}_kernel" in key)
            for k in ("ring_mv", "block_diag_mv")}
    if not all(hand.values()):
        raise AssertionError(f"one step's hand kernels: {hand}")
    tag = "[slice2d tracers profile]"
    log(f"{tag} one step (DIRK22 SWE, two CN tracers, limiter): "
        f"{sum(r[1] for r in rows)} device kernels, device busy "
        f"{sum(r[0] for r in rows) / 1e3:.3f} ms; hand kernels {hand}; top "
        "by device time:")
    for us, cnt, key in rows[:8]:
        log(f"{tag}   {us / 1e3:8.3f} ms  x{cnt:<5d} {key[:90]}")


def thacker_bowl(x, y):
    """The bowl's bathymetry and its elevation at t = 0 (= after one
    period)."""
    a = (((THACKER_D0 + THACKER_ETA0) ** 2 - THACKER_D0 ** 2)
         / ((THACKER_D0 + THACKER_ETA0) ** 2 + THACKER_D0 ** 2))
    r2 = (x - THACKER_L / 2) ** 2 + (y - THACKER_L / 2) ** 2
    b = THACKER_D0 * (1 - r2 / THACKER_R ** 2)
    eta = THACKER_D0 * (np.sqrt(1 - a * a) / (1 - a) - 1
                        - r2 * ((1 + a) / (1 - a) - 1) / THACKER_R ** 2)
    return b, eta


def thacker_solver(device, dtype, stepper, nx, dt, ny=None, params=None):
    """``tests/test_thacker.py``'s case: the bowl, wetting-and-drying with
    the automatic alpha, on an ``nx`` x ``ny`` mesh of the square."""
    if ny is None:
        mesh = SquareMesh(nx, nx, THACKER_L, device=device, dtype=dtype)
    else:
        mesh = RectangleMesh(nx, ny, THACKER_L, THACKER_L, device=device,
                             dtype=dtype)
    b, eta = thacker_bowl(mesh.coords_np[:, 0], mesh.coords_np[:, 1])
    s = FlowSolver2d(mesh, torch.as_tensor(b, dtype=dtype, device=device))
    o = s.options
    o.timestep = dt
    o.simulation_export_time = 3600.0
    o.simulation_end_time = 43200.0
    o.no_exports = True
    o.swe_timestepper_type = stepper
    o.use_wetting_and_drying = True
    o.use_automatic_wetting_and_drying_alpha = True
    if params is not None:
        o.swe_timestepper_options.solver_parameters = NewtonParameters(
            **params)
    _, t_setup = sync_time(s.initialize)
    s.assign_initial_conditions(
        elev=torch.as_tensor(eta, dtype=dtype, device=device))
    return s, t_setup


def thacker_error(s):
    """The reference test's masked L2 elevation error over the mesh
    length."""
    xy = s.function_spaces.H_2d.dof_coords().cpu().numpy()
    _, correct = thacker_bowl(xy[..., 0], xy[..., 1])
    r = np.hypot(xy[..., 0] - THACKER_L / 2, xy[..., 1] - THACKER_L / 2)
    mask = 0.5 * (1 - np.tanh((r - 420000.0) / 1000.0))
    eta = s.fields.elev_2d.data.cpu().numpy()
    diff = torch.as_tensor(mask * (eta - correct), dtype=torch.float64,
                           device=s.mesh2d.device).to(s.mesh2d.dtype)
    return float(s.asm.norm_l2(diff)) / THACKER_L


def phase_wetting_drying(smi):
    """Phase 19, wetting-and-drying: the Thacker bowl on SquareMesh(226,
    226) (102,152 cells; dt scaled from the test's 600 s at n = 10 to the
    same wave CFL), f32, CN (the matrix-free Newton: the displaced mass
    keeps it off the assembled path), 1 + 5 steps, and the volume change
    of the same steps in f64 beside it.  (The reference test's own case
    runs in :func:`phase_cases`.)"""
    dev = torch.device("cuda")
    dt = 600.0 * 10 / THACKER_N
    s, t_setup = thacker_solver(dev, torch.float32, "CrankNicolson",
                                THACKER_N, dt)
    shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
    alpha = s.options.wetting_and_drying_alpha.data
    vol0 = s.compute_volume_2d()
    _, t_warm = sync_time(lambda: iterate_steps(s, 1))
    reset_counts()
    stats = []

    def run():
        for _ in range(5):
            iterate_steps(s, 1)
            stats.append(dict(s.timestepper.stats))

    _, t = sync_time(run)
    n = counts()
    check_state("wetting-drying", s, shapes)
    vol = (s.compute_volume_2d() - vol0) / vol0
    newton = sum(x["newton_iterations"] for x in stats) / 5
    cycles = sum(x["ksp_cycles"] for x in stats) / 5
    worst = max(x["ksp_rel_residual"] for x in stats)
    pc = s.timestepper.preconditioner
    pc = pc if isinstance(pc, str) else type(pc).__name__
    log(f"[wetting-drying] f32 Thacker bowl on SquareMesh({THACKER_N}, "
        f"{THACKER_N}): nc={s.mesh2d.nc}, dt={dt:.3f} s, CN ({pc} "
        f"preconditioner, assembled {s.timestepper.assembled_solve}), "
        f"automatic alpha {float(alpha.min()):.3f}..{float(alpha.max()):.3f}"
        f"; setup {t_setup:.2f} s, warm-up {t_warm * 1e3:.1f} ms; 5 steps "
        f"{t / 5 * 1e3:.2f} ms/step; Newton iterations/step {newton:.2f}, "
        f"FGMRES cycles/step {cycles:.2f} (of 16), worst final relative "
        f"residual {worst:.2e}; launches {n}; volume (the monitor's "
        f"integral) changed by {vol:.3e} in 6 steps; card: {smi}")
    s64, _ = thacker_solver(dev, torch.float64, "CrankNicolson", THACKER_N,
                            dt)
    v0 = s64.compute_volume_2d()
    iterate_steps(s64, 6)
    vol64 = (s64.compute_volume_2d() - v0) / v0
    elev_err = float((s.fields.elev_2d.data.double()
                      - s64.fields.elev_2d.data).abs().max())
    log(f"[wetting-drying] the same 6 steps in f64: volume changed by "
        f"{vol64:.3e} (f32 - f64: {vol - vol64:.3e}); max|elev f32 - f64| "
        f"{elev_err:.3e} m")
    return n


def thacker_case(stepper):
    """``tests/test_thacker.py``'s own case on the card: n = 10, dt 600 s,
    72 steps (one period), f64, against its bound for ``stepper``
    (``python3 chip_smoke.py thacker <stepper>``)."""
    phase_device()
    bound = THACKER_BOUNDS[stepper]
    s, _ = thacker_solver(torch.device("cuda"), torch.float64, stepper, 10,
                          600.0)
    _, t = sync_time(s.iterate)
    err = thacker_error(s)
    if s.iteration != 72 or not err < bound:
        raise AssertionError(f"Thacker {stepper}: {s.iteration} steps, L2 "
                             f"error {err} (bound {bound})")
    log(f"[wetting-drying] tests/test_thacker.py case, f64, {stepper}: 72 "
        f"steps of 600 s in {t:.2f} s, elevation L2 error {err:.4f} < "
        f"{bound}; last step {s.timestepper.stats}")


def standing_wave_case():
    """PPP on the standing wave on the card (``python3 chip_smoke.py
    standing_wave``)."""
    phase_device()
    t0 = time.perf_counter()
    rel, s = standing_wave_ppp(torch.device("cuda"))
    if s.iteration != 20 or not rel <= PPP_SW_BOUND:
        raise AssertionError(f"standing wave: {s.iteration} steps, relative "
                             f"error {rel}")
    log(f"[model2d ppp standing wave] f64 100x1, 20 PressureProjectionPicard "
        f"steps in {time.perf_counter() - t0:.2f} s: relative L2 error "
        f"{rel:.4e} <= {PPP_SW_BOUND:g}; last step {s.timestepper.stats}")


def start_cases(modes, at_once=None, after=None, one_thread=False):
    """Start each ``chip_smoke.py`` mode in a process of its own, its
    output to files (a script prints much): all at once, or ``at_once``
    at a time in the order given; with ``after`` (an earlier start's
    handle), the first once every process of ``after`` has ended.  A
    thread of this process starts each as a slot frees, so the caller's
    own work runs meanwhile.  ``one_thread``: each process on one host
    thread (its work is the card's; the thread pools of many processes
    on shared cores spin).  Returns the handle :func:`finish_cases`
    waits on."""
    import tempfile
    import threading

    env = (dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                OPENBLAS_NUM_THREADS="1") if one_thread else None)
    h = SimpleNamespace(pending=[list(m) for m in modes], started=[],
                        done=threading.Event(), stop=threading.Event(),
                        t0=time.perf_counter())

    def schedule():
        while not h.stop.is_set():
            live = [c for c in h.started if c.p.poll() is None]
            for c in h.started:
                if c.end is None and c.p.returncode is not None:
                    c.end = time.perf_counter() - h.t0
            free = at_once is None or len(live) < at_once
            if h.pending and free and (after is None or after.done.is_set()):
                mode = h.pending.pop(0)
                out = tempfile.TemporaryFile("w+")
                err = tempfile.TemporaryFile("w+")
                h.started.append(SimpleNamespace(
                    mode=mode, out=out, err=err, end=None,
                    start=time.perf_counter() - h.t0, p=subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__)] + mode,
                        stdout=out, stderr=err, text=True, env=env)))
                continue
            if not h.pending and not live:
                break
            time.sleep(0.2)
        h.done.set()

    h.thread = threading.Thread(target=schedule, daemon=True)
    h.thread.start()
    return h


def finish_cases(*handles, timeout=600):
    """Wait, ``timeout`` seconds at most, for the processes of
    :func:`start_cases`' ``handles``; pass on the lines of theirs that
    start with "[" (and each process's span) and return them; fail if
    one failed or ran late.  Every process is ended."""
    t0 = time.perf_counter()
    lines, failed = [], []
    try:
        for h in handles:
            h.thread.join(max(timeout - (time.perf_counter() - t0), 0.0))
            if h.thread.is_alive():
                failed.append(f"past {timeout} s: " + ", ".join(
                    " ".join(c.mode) for c in h.started
                    if c.p.poll() is None) + f"; not started {h.pending}")
                continue
            for c in h.started:
                c.out.seek(0)
                c.err.seek(0)
                for line in c.out.read().splitlines():
                    if line.startswith("["):
                        lines.append(line)
                        log(line)
                log(f"[cases] {' '.join(c.mode)}: {c.start:.1f} s to "
                    f"{c.end:.1f} s")
                if c.p.returncode != 0:
                    failed.append(f"{' '.join(c.mode)}:\n"
                                  f"{c.err.read()[-3000:]}")
    finally:
        for h in handles:
            h.stop.set()
            h.thread.join()
            for c in h.started:
                if c.p.poll() is None:
                    c.p.kill()
                    c.p.wait()
                c.out.close()
                c.err.close()
    if failed:
        raise RuntimeError("case processes failed:\n" + "\n".join(failed))
    return lines


def standing_wave_ppp(device):
    """tests/test_standing_wave.py's channel (100 x 1, depth 100 m): one
    period in 20 PressureProjectionPicard steps, f64; returns the relative
    L2 elevation error and the solver."""
    lx, ly, nsteps, depth = 5e3, 1e3, 20, 100.0
    mesh = RectangleMesh(100, 1, lx, ly, device=device, dtype=torch.float64)
    period = 2 * lx / math.sqrt(float(physical_constants["g_grav"]) * depth)
    dt = period / nsteps
    s = FlowSolver2d(mesh, Function(FunctionSpace(mesh, "CG", 1)).assign(
        depth))
    o = s.options
    o.timestep = dt
    o.simulation_export_time = dt * nsteps
    o.simulation_end_time = period - 0.1 * dt
    o.no_exports = True
    o.swe_timestepper_type = "PressureProjectionPicard"
    s.create_function_spaces()
    e0 = Function(s.function_spaces.H_2d).interpolate(
        lambda x, y: torch.cos(math.pi * x / lx))
    s.assign_initial_conditions(elev=e0)
    s.iterate()
    rel = float(s.asm.norm_l2(s.fields.elev_2d.data - e0.data)) / math.sqrt(
        lx * ly)
    return rel, s


def steady_state_solver(device):
    """SteadyState at 8x4, f64 (tests/test_adjoint_swe.py's set-up: a
    viscosity, a drag bump, an inflow and an open outflow)."""
    mesh = RectangleMesh(8, 4, 100.0, 50.0, device=device,
                         dtype=torch.float64)
    s = FlowSolver2d(mesh, 50.0)
    o = s.options
    o.swe_timestepper_type = "SteadyState"
    o.timestep = 0.5
    o.simulation_export_time = 0.5
    o.simulation_end_time = 0.5
    o.no_exports = True
    o.horizontal_viscosity = 2.0
    x = torch.as_tensor(mesh.coords_np, device=device)
    o.quadratic_drag_coefficient = 12.0 * torch.exp(
        -((x[:, 0] - 50.0) ** 2 + (x[:, 1] - 25.0) ** 2) / 20.0 ** 2) + 0.0025
    s.bnd_functions["shallow_water"] = {1: {"un": -1.0}, 2: {"elev": 0.0}}
    s.assign_initial_conditions(uv=torch.tensor([1.0, 0.0], device=device,
                                                dtype=torch.float64),
                                elev=0.0)
    return s


def imex_step(device):
    """One SSPIMEX (IMEXLPUM2) step of the 5x4 SWE of the CPU tests
    (tests/test_torch_steppers2d.py), f64."""
    mesh = RectangleMesh(5, 4, 1e4, 8e3, device=device, dtype=torch.float64)
    asm = DGAssembler(mesh, FunctionSpace(mesh, "DG", 1))
    opts = SimpleNamespace(
        use_nonlinear_equations=True, use_wetting_and_drying=False,
        use_lax_friedrichs_velocity=True, use_grad_div_viscosity_term=False,
        use_grad_depth_viscosity_term=True, sipg_factor=1.0,
        norm_smoother=0.0)
    bathy = torch.as_tensor(20.0 + 5.0 * mesh.coords_np[:, 1] / 8e3,
                            device=device)
    bnd = {1: {"elev": 0.05}}
    eq = ShallowWaterEquations(mesh, asm, opts, bathymetry=bathy,
                               bnd_conditions=bnd)
    x = torch.as_tensor(mesh.coords_np[mesh.cells_np], device=device)
    rng = np.random.default_rng(9)
    sol = {"elev": 0.5 * torch.exp(-((x[..., 0] - 5e3) / 2e3) ** 2),
           "uv": torch.as_tensor(0.05 * rng.standard_normal(
               (mesh.nc, 3, 2)), device=device)}
    fields = {"lax_friedrichs_velocity_scaling_factor": asm.as_tensor(1.0),
              "quadratic_drag_coefficient": asm.as_tensor(2.5e-3)}
    dt = 1.5 * float(mesh.cell_hmin_np.min()) / math.sqrt(9.81 * 25.0)
    st = get_stepper("SSPIMEX", eq, dt, semi_implicit=True,
                     solver_parameters=NewtonParameters(
                         ksp_rtol=1e-10, ksp_max_it=60, gmres_restart=30))
    return st.advance(0.0, sol, fields, fields, bnd), st


def phase_other_steppers(smi):
    """Phase 20: DIRK33 and PressureProjectionPicard at 320x160 (f32, 1 +
    3 steps each); SteadyState (8x4) and SSPIMEX (5x4) at the CPU tests'
    sizes, each GPU against CPU in f64.  (PPP on the standing wave runs in
    :func:`phase_cases`.)"""
    dev = torch.device("cuda")
    total = {k: 0 for k in KERNELS}
    for stepper, params in (("DIRK33", SLICE2D_PARAMS),
                            ("PressureProjectionPicard", None)):
        s, t_setup = slice2d_solver(dev, torch.float32, stepper=stepper,
                                    tracers=False, params=params)
        shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
        _, t_warm = sync_time(lambda: iterate_steps(s, 1))
        reset_counts()
        stats = []

        def run():
            for _ in range(3):
                iterate_steps(s, 1)
                stats.append(dict(s.timestepper.stats))

        _, t = sync_time(run)
        n = counts()
        for k in KERNELS:
            total[k] += n[k]
        check_state(f"model2d {stepper}", s, shapes)
        assembled = getattr(s.timestepper, "assembled_solve", False)
        if assembled and (n["ring_mv"] == 0 or n["block_diag_mv"] == 0):
            raise AssertionError(f"{stepper} launches {n}")
        cycles = sum(x["ksp_cycles"] for x in stats) / 3
        newton = sum(x["newton_iterations"] for x in stats) / 3
        log(f"[model2d {stepper}] f32 {NX}x{NY}, dt={s.dt:.3f} s: setup "
            f"{t_setup:.2f} s, warm-up {t_warm * 1e3:.1f} ms; 3 steps "
            f"{t / 3 * 1e3:.2f} ms/step; implicit solves/step "
            f"{stats[-1]['stages']}, Newton iterations/step {newton:.2f}, "
            f"FGMRES cycles/step {cycles:.2f}, last final relative residual "
            f"{stats[-1]['ksp_rel_residual']:.2e}; launches {n} (assembled "
            f"{assembled}); card: {smi}")
    return total


def phase_cases(smi, scripts, then=()):
    """The f64 checks that time nothing, after every timed phase: the
    Thacker case (``tests/test_thacker.py``: CN, DIRK22, BackwardEuler)
    and PPP on the standing wave (``tests/test_standing_wave.py``, 20
    steps), each launch-bound and in a process of its own, all at once,
    with the tidal-array and solitary-wave examples, the dg-cg standing
    waves (25a), the H(div) and Williamson cases (26a, 27a), and the
    profiles of phases 22-24 (``profile_slice9``), 25-27
    (``profile_families``) and 29 (``profile_io``); phase 30's
    ``scripts`` (:func:`example_modes`), :data:`EXAMPLES_AT_ONCE` at a
    time, once the profiles have ended (their device times are read
    without the scripts beside them); meanwhile, in this process on 4
    CPU threads, the GPU-against-CPU parity of phase 7 (3D), phase 11
    (2D, with the configurations of phases 18-27), SteadyState and
    SSPIMEX, then the phases ``then`` (each called with ``smi``).
    Returns phase 30's launches and each in-process phase's seconds."""
    t30 = time.perf_counter()
    threads = torch.get_num_threads()
    seconds, handles = {}, []
    try:
        handles.append(start_cases([["profile_slice9"], ["profile_families"],
                                    ["profile_io"]]))
        handles.append(start_cases(
            [["thacker", k] for k in THACKER_BOUNDS]
            + [["standing_wave"], ["tidal_array"], ["solitary_wave"]]
            + [["dgcg_wave", k] for k in DGCG_WAVES]
            + [["dgcg_volume"], ["hdiv_cases"]]))
        handles.append(start_cases(example_modes(scripts), EXAMPLES_AT_ONCE,
                                   after=handles[0], one_thread=True))
        torch.set_num_threads(min(threads, 4))
        for phase in (phase_parity3d, phase_model_parity,
                      phase_model_parity_slice, phase_model_parity_slice9,
                      phase_model_parity_families, phase_small_steppers):
            t0 = time.perf_counter()
            phase()
            seconds[phase.__name__] = time.perf_counter() - t0
            log(f"[{phase.__name__}] {seconds[phase.__name__]:.1f} s")
        torch.set_num_threads(threads)
        for phase in then:
            t0 = time.perf_counter()
            phase(smi)
            seconds[phase.__name__] = time.perf_counter() - t0
            log(f"[{phase.__name__}] {seconds[phase.__name__]:.1f} s")
    finally:
        torch.set_num_threads(threads)
        lines = finish_cases(*handles, timeout=900)
    return examples_launches(lines, scripts, smi,
                             time.perf_counter() - t30), seconds


def phase_small_steppers():
    """SteadyState (8x4) and SSPIMEX (5x4), f64, GPU against CPU."""
    dev = torch.device("cuda")
    out = {}
    for dv in ("cuda", "cpu"):
        ss = steady_state_solver(torch.device(dv))
        ss.iterate()
        out[dv] = (ss._get_state(), dict(ss.timestepper.stats))
    st = out["cuda"][1]
    if not st["snes_rel_residual"] < 1e-8:
        raise AssertionError(f"SteadyState Newton: {st}")
    errs = compare("SteadyState", out["cuda"][0], out["cpu"][0], PARITY_RTOL)
    log(f"[model2d steadystate] f64 8x4, dense-LU line-searched Newton: "
        f"{st['newton_iterations']} iterations to {st['snes_rel_residual']:.2e}"
        f"; GPU against CPU max|diff|/max {errs} <= {PARITY_RTOL:g}: ok")
    a, st = imex_step(dev)
    b, _ = imex_step(torch.device("cpu"))
    errs = compare("SSPIMEX", a, b, PARITY_RTOL)
    log(f"[model2d sspimex] f64 5x4, one step ({st.stats['stages']} implicit "
        f"stages): GPU against CPU max|diff|/max {errs} <= {PARITY_RTOL:g}: "
        "ok")


def phase_model_parity_slice():
    """Phase 11's f64 GPU-against-CPU parity for this slice's
    configurations, one step each at 80x40: the slice (DIRK22 + tracers),
    DIRK33, PressureProjectionPicard and the bowl under CN (with a Krylov
    budget that solves the step to roundoff)."""
    cases = {
        "dirk22 tracers": lambda d: slice2d_solver(
            d, torch.float64, NX_PARITY, NY_PARITY)[0],
        "dirk33": lambda d: slice2d_solver(
            d, torch.float64, NX_PARITY, NY_PARITY, stepper="DIRK33",
            tracers=False)[0],
        "ppp": lambda d: slice2d_solver(
            d, torch.float64, NX_PARITY, NY_PARITY,
            stepper="PressureProjectionPicard", tracers=False,
            params=None)[0],
        "wetting-drying cn": lambda d: thacker_solver(
            d, torch.float64, "CrankNicolson", NX_PARITY, 600.0 * 10 / 80,
            ny=NY_PARITY, params=WD_PARITY_PARAMS)[0],
    }
    for name, make in cases.items():
        out, secs = {}, {}
        for dv in ("cuda", "cpu"):
            s = make(torch.device(dv))
            reset_counts()
            t0 = time.perf_counter()
            iterate_steps(s, 1)
            if dv == "cuda":
                torch.cuda.synchronize()
                n = counts()
            secs[dv] = time.perf_counter() - t0
            out[dv] = s._get_state()
        ring = name.startswith("dirk")
        if (n["ring_mv"] > 0) != ring:
            raise AssertionError(f"parity {name}: GPU step launches {n}")
        errs = compare(f"parity model2d {name}", out["cuda"], out["cpu"],
                       PARITY_RTOL)
        log(f"[parity model2d {name}] f64 {NX_PARITY}x{NY_PARITY} one step, "
            f"GPU {secs['cuda']:.2f} s vs CPU {secs['cpu']:.2f} s: "
            f"max|diff|/max {errs} <= {PARITY_RTOL:g}: ok")


# -- the morphodynamics, turbine and NH slice (phases 22-24) ---------------
#: f32 Krylov budget of the SWE solves (the policy's restart and cap at an
#: rtol f32 reaches)
F32_PARAMS = dict(ksp_rtol=1e-5, ksp_max_it=96, gmres_restart=24)
#: the Newton CN in f32 (phase 10's cn_newton): snes_rtol 1e-4, the
#: residual's f32 floor
F32_NEWTON = dict(snes_rtol=1e-4, ksp_rtol=1e-5, ksp_max_it=24,
                  gmres_restart=8)
#: the f64 parity steps of the slice: a Krylov budget that solves the SWE
#: step to roundoff
PARITY9_PARAMS = dict(ksp_rtol=1e-12, ksp_max_it=400, gmres_restart=50)
TRENCH_STEPS = 20
SLICE9_STEPS = 5
SOLITARY_STEPS = 200
#: the AR2000 curves of examples/discrete_turbines/tidal_array.py
AR2000_SPEEDS = [0., 0.75, 0.85, 0.95, 1., 3.05, 3.3, 3.55, 3.8, 4.05, 4.3,
                 4.55, 4.8, 5., 5.001, 5.05, 5.25, 5.5, 5.75, 6.0, 6.25,
                 6.5, 6.75, 7.0]
AR2000_POWERS = [0.0105, 0.032, 0.0385, 0.116, 0.437, 0.437, 0.345, 0.277,
                 0.226, 0.187, 0.156, 0.132, 0.112, 0.0993, 0.0595, 0.0051,
                 0.00151, 0.000889, 0.000652, 0.000523, 0.000441, 0.000384,
                 0.000341, 0.000308]
AR2000_THRUSTS = [0.010531, 0.032281, 0.038951, 0.119951, 0.516484,
                  0.516484, 0.387856, 0.302601, 0.242037, 0.197252,
                  0.16319, 0.136716, 0.115775, 0.102048, 0.060513, 0.005112,
                  0.00151, 0.00089, 0.000653, 0.000524, 0.000442, 0.000384,
                  0.000341, 0.000308]


def trench_profile(x):
    """The trench of examples/sediment_trench_2d/trench_example.py: river
    bed at 0, trench 0.15 m deep between x = 6.5 and 9.5 m, 1.5 m
    slopes (numpy, positive up)."""
    riv, trench = 0.0, -0.15
    diff = trench - riv
    return np.where(
        x <= 5, riv, np.where(
            x <= 6.5, (1 / 1.5) * diff * (x - 6.5) + trench, np.where(
                x <= 9.5, trench, np.where(
                    x <= 11, -(1 / 1.5) * diff * (x - 11) + riv, riv))))


def trench_solver(device, dtype):
    """The morphodynamic phase of examples/sediment_trench_2d/
    trench_example.py written for the port (imports changed, no exports):
    suspended sediment, bedload and Exner (morfac 100) under CN theta 1,
    dt 0.3 s, an ``equilibrium`` sediment inflow, from the example's
    uniform 0.51 m/s; f32 runs take an f32 Krylov budget."""
    mesh2d = RectangleMesh(80, 5, 16.0, 1.1, device=device, dtype=dtype)
    bathymetry_2d = Function(FunctionSpace(mesh2d, "CG", 1),
                             name="bathymetry_2d")
    bathymetry_2d.data = bathymetry_2d.data + torch.as_tensor(
        -trench_profile(mesh2d.coords_np[:, 0]), dtype=dtype, device=device)
    average_size = 160e-6
    s = FlowSolver2d(mesh2d, bathymetry_2d)
    options = s.options
    so = options.sediment_model_options
    so.solve_suspended_sediment = True
    so.use_bedload = True
    so.use_exner = True
    so.use_sediment_conservative_form = False
    so.average_sediment_size = average_size
    so.bed_reference_height = 0.025
    so.morphological_acceleration_factor = 100
    so.horizontal_diffusivity = Constant(0.15)
    options.no_exports = True
    options.nikuradse_bed_roughness = Constant(3 * average_size)
    options.horizontal_viscosity = Constant(1e-6)
    options.swe_timestepper_type = "CrankNicolson"
    options.swe_timestepper_options.implicitness_theta = 1.0
    options.norm_smoother = Constant(0.1)
    options.timestep = 0.3
    if dtype == torch.float32:
        options.swe_timestepper_options.solver_parameters = \
            NewtonParameters(**F32_PARAMS)
    s.bnd_functions["shallow_water"] = {1: {"flux": Constant(-0.22)},
                                        2: {"elev": Constant(0.397)}}
    s.bnd_functions["sediment"] = {
        1: {"flux": Constant(-0.22), "equilibrium": None},
        2: {"elev": Constant(0.397)}}
    s.assign_initial_conditions(
        uv=torch.tensor([0.51, 0.0], dtype=dtype, device=device),
        elev=Constant(0.397))
    return s


def channel_solver(device, dtype, nx=320, ny=160, scale=20.0, inflow=0.25,
                   params=None):
    """tests/test_sediment.py::sediment_channel with every length scaled
    by ``scale`` (20: 3200 x 800 m on 320x160, a 0.8 m bump over 4 m of
    depth with a 400 m half-width), its inflow flux kept at ``inflow``
    m/s over the 4 m depth, suspended sediment with an ``equilibrium``
    inflow, bedload and Exner (morfac 10), dt 2 s."""
    lx, ly = 160.0 * scale, 40.0 * scale
    mesh2d = RectangleMesh(nx, ny, lx, ly, device=device, dtype=dtype)
    P1 = FunctionSpace(mesh2d, "CG", 1)
    x, _ = SpatialCoordinate(mesh2d)
    bath = Function(P1).interpolate(
        4.0 - 0.8 * torch.exp(-(((x - lx / 2) / (20.0 * scale)) ** 2)))
    s = FlowSolver2d(mesh2d, bath)
    o = s.options
    o.timestep = 2.0
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.horizontal_viscosity = Constant(0.1)
    o.horizontal_diffusivity = Constant(0.15)
    o.norm_smoother = 0.1
    if params is not None:
        o.swe_timestepper_options.solver_parameters = NewtonParameters(
            **params)
    sed = o.sediment_model_options
    sed.solve_suspended_sediment = True
    sed.use_bedload = True
    sed.use_exner = True
    sed.use_angle_correction = False
    sed.use_secondary_current = False
    sed.average_sediment_size = 1.6e-4
    sed.morphological_viscosity = 1e-6
    sed.bed_reference_height = 0.025
    sed.morphological_acceleration_factor = 10.0
    flux = -inflow * 4.0 * ly
    s.bnd_functions["shallow_water"] = {1: {"flux": Constant(flux)},
                                        2: {"elev": Constant(0.0)}}
    s.bnd_functions["sediment"] = {
        1: {"flux": Constant(flux), "equilibrium": None},
        2: {"elev": Constant(0.0)}}
    s.assign_initial_conditions(
        uv=torch.tensor([inflow, 0.0], dtype=dtype, device=device), elev=0.0)
    return s


def tidal_array_solver(device, dtype, nx=100, ny=30, params=None, dt=50.0,
                       spun_up=False):
    """examples/discrete_turbines/tidal_array.py written for the port:
    the 2000 x 600 m channel, 50 m deep, an inflow viscosity sponge, nine
    discrete turbines in two farms (AR2000: table thrust, support drag,
    shear profile, upwind correction; AR1500: constant thrust, shear
    profile), CN dt 50 s, the inflow ramped to 2.5 m/s over 500 s by
    ``update_forcings`` and the power callback each step.  ``spun_up``
    starts at the ramp's end from a uniform 2.5 m/s.  Returns ``(solver,
    callback, update_forcings)``; the caller sets rho0."""
    from thetis_tpu_torch.model.turbines import (
        DiscreteTidalTurbineFarmOptions, TurbineFunctionalCallback)

    mesh2d = RectangleMesh(nx, ny, 2000.0, 600.0, device=device, dtype=dtype)
    P1_2d = FunctionSpace(mesh2d, "CG", 1)
    bathymetry_2d = Function(P1_2d, name="Bathymetry").assign(50.0)
    h_viscosity = Function(P1_2d).interpolate(
        lambda x, y: torch.where(x <= 50.0, 51.0 - x, 1.0))
    farm_AR2000 = DiscreteTidalTurbineFarmOptions()
    farm_AR2000.turbine_type = "table"
    to = farm_AR2000.turbine_options
    to.thrust_speeds = AR2000_SPEEDS
    to.thrust_coefficients = AR2000_THRUSTS
    to.power_coefficients = AR2000_POWERS
    to.C_support = 0.7
    to.A_support = 2.6 * 14.0
    to.diameter = 20
    to.apply_shear_profile = True
    to.structure_type = "bottom-fixed"
    to.rel_hub_height = 14.0
    farm_AR2000.upwind_correction = True
    farm_AR2000.turbine_coordinates = [
        [x, y] for x in np.arange(1000, 1061, 60)
        for y in np.arange(260, 341, 40)]
    farm_AR1500 = DiscreteTidalTurbineFarmOptions()
    farm_AR1500.turbine_type = "constant"
    to = farm_AR1500.turbine_options
    to.diameter = 18
    to.thrust_coefficient = 0.6
    to.power_coefficient = 0.55
    to.apply_shear_profile = True
    to.rel_hub_height = 13.5
    farm_AR1500.turbine_coordinates = [
        [940.0, y] for y in np.arange(260, 341, 40)]
    s = FlowSolver2d(mesh2d, bathymetry_2d)
    options = s.options
    options.simulation_export_time = 200.0
    options.simulation_end_time = 5 * 200.0
    options.no_exports = True
    options.check_volume_conservation_2d = True
    options.quadratic_drag_coefficient = Constant(0.0025)
    options.swe_timestepper_type = "CrankNicolson"
    options.swe_timestepper_options.implicitness_theta = 0.5
    if params is not None:
        options.swe_timestepper_options.solver_parameters = \
            NewtonParameters(**params)
    options.horizontal_viscosity = h_viscosity
    options.timestep = dt
    options.discrete_tidal_turbine_farms["everywhere"] = [farm_AR1500,
                                                          farm_AR2000]
    t0 = 500.0 if spun_up else 0.0
    inflow_vel = Constant(-2.5 * t0 / 500.0)
    s.bnd_functions["shallow_water"] = {1: {"un": inflow_vel},
                                        2: {"elev": Constant(0.0)}}

    def update_forcings(t_new):
        inflow_vel.assign(-2.5 * min((t_new + t0) / 500.0, 1.0))

    s.assign_initial_conditions(uv=torch.tensor(
        [2.5 if spun_up else 0.0, 0.0], dtype=dtype, device=device))
    cb = TurbineFunctionalCallback(s)
    s.add_callback(cb, "timestep")
    return s, cb, update_forcings


def solitary_solver(device, dtype, nx=250, ny=1, ly=2.0, q_rtol=None,
                    newton=False):
    """examples/nonhydrostatic_cases/solitary_wave_nh/solitary_wave_2d.py
    written for the port: a Boussinesq solitary wave (a/H 0.2 over 10 m)
    from x0 = 250 m in a 1000 m channel, CN dt 0.1 s with the NH
    pressure (``newton``: the Newton CN of tests/test_nh.py's standing
    wave, under the assembled wave preconditioner).  Returns ``(solver,
    c_sol, a, x0)``."""
    depth = 10.0
    mesh2d = RectangleMesh(nx, ny, 1000.0, ly, device=device, dtype=dtype)
    s = FlowSolver2d(mesh2d, Function(FunctionSpace(mesh2d, "CG", 1),
                                      name="Bathymetry").assign(depth))
    options = s.options
    options.swe_timestepper_type = "CrankNicolson"
    options.timestep = 0.1
    options.simulation_export_time = 5.0
    options.simulation_end_time = 20.0
    options.no_exports = True
    options.nh_model_options.solve_nonhydrostatic_pressure = True
    if q_rtol is not None:
        options.nh_model_options.q_solver_rtol = q_rtol
    if newton:
        options.swe_timestepper_options.use_semi_implicit_linearization = \
            False
    if dtype == torch.float32:
        options.swe_timestepper_options.solver_parameters = \
            NewtonParameters(**(F32_NEWTON if newton else F32_PARAMS))
    s.create_equations()
    g = float(physical_constants["g_grav"])
    a = 0.2 * depth
    c_sol = math.sqrt(g * (depth + a))
    x0 = 250.0
    x_dof = s.function_spaces.H_2d.dof_coords()[..., 0]
    kx = math.sqrt(3 * a / (4 * depth**3))
    eta0 = a / torch.cosh(kx * (x_dof - x0)) ** 2
    u0 = c_sol * eta0 / (depth + eta0)
    s.assign_initial_conditions(
        elev=eta0, uv=torch.stack([u0, torch.zeros_like(u0)], dim=-1))
    return s, c_sol, a, x0


def solver_stats(s):
    """The last step's solver counters of each stepper of ``s``."""
    out = {"swe": dict(s.timestepper.stats)}
    for k in ("sediment_stepper", "exner_stepper", "fs_stepper"):
        st = getattr(s, k, None)
        if st is not None:
            out[k.split("_")[0]] = dict(st.stats)
    if s.solve_nh:
        out["bicgstab"] = s.poisson_solver.iterations
    return out


def timed_steps(s, n, update_forcings=None):
    """``n`` steps through ``iterate()`` one at a time (the per-step
    counters kept); returns (seconds, [solver_stats after each step])."""
    per = []

    def run():
        for _ in range(n):
            o = s.options
            o.simulation_export_time = s.dt
            o.simulation_end_time = s.simulation_time + s.dt
            s.iterate(update_forcings=update_forcings)
            per.append(solver_stats(s))

    _, t = sync_time(run)
    return t, per


def require_hand_kernels(tag, n, steps):
    if n["ring_mv"] < steps or n["block_diag_mv"] < steps:
        raise AssertionError(f"{tag}: ring_mv / block_diag_mv must launch "
                             f"at least once a step: {n} in {steps} steps")


def phase_morphodynamics(smi):
    """Phase 22: (a) the trench example at its own size, f32, 1 + 20
    steps; (b) the sediment channel at the bench's width (320x160,
    1,280,481 DOF), f32, 1 + 5 steps."""
    dev = torch.device("cuda")
    s, t_setup = sync_time(lambda: trench_solver(dev, torch.float32))
    zb0 = s.fields.bathymetry_2d.data.clone()
    _, t_warm = sync_time(lambda: iterate_steps(s, 1))
    t, per = timed_steps(s, TRENCH_STEPS)
    check_finite("trench", s._get_state())
    dz = float((s.fields.bathymetry_2d.data - zb0).abs().max())
    if not 1e-5 < dz < 0.15:
        raise AssertionError(f"trench: the bed changed by {dz} (the "
                             "example's bounds: 1e-5 .. 0.15 m)")
    log(f"[morpho trench] examples/sediment_trench_2d at its size, f32 "
        f"80x5, dt 0.3 s, morfac 100, CN theta 1 (coarse PC "
        f"{type(s.timestepper.coarse).__name__}): setup {t_setup:.2f} s, "
        f"warm-up {t_warm * 1e3:.1f} ms; "
        f"{TRENCH_STEPS} steps {t / TRENCH_STEPS * 1e3:.2f} ms/step; largest "
        f"bed change {dz:.4e} m (bounds 1e-5 .. 0.15); sediment "
        f"{float(s.fields.sediment_2d.data.min()):.3e} .. "
        f"{float(s.fields.sediment_2d.data.max()):.3e}; last step {per[-1]}; "
        f"card: {smi}")

    s, t_setup = sync_time(lambda: channel_solver(dev, torch.float32,
                                                  params=F32_PARAMS))
    mesh = s.mesh2d
    n_dofs = 9 * mesh.nc + 3 * mesh.nc + mesh.nv
    zb0 = s.fields.bathymetry_2d.data.clone()
    shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
    _, t_warm = sync_time(lambda: iterate_steps(s, 1))
    reset_counts()
    t, per = timed_steps(s, SLICE9_STEPS)
    n = counts()
    check_state("morpho channel", s, shapes)
    require_hand_kernels("morpho channel", n, SLICE9_STEPS)
    dz = float((s.fields.bathymetry_2d.data - zb0).abs().max())
    swe = [p["swe"] for p in per]
    log(f"[morpho channel] test_sediment.py's channel x20 on 320x160, f32, "
        f"{mesh.nc} cells, {n_dofs} DOF (SWE {9 * mesh.nc} + sediment "
        f"{3 * mesh.nc} + bed {mesh.nv}), dt 2 s, morfac 10, SWE CN "
        f"semi-implicit assembled (coarse PC "
        f"{type(s.timestepper.coarse).__name__}, wave CFL "
        f"{s._wave_cfl(0.5 * s.dt):.2f}): setup {t_setup:.2f} s, warm-up "
        f"{t_warm * 1e3:.1f} ms; {SLICE9_STEPS} steps "
        f"{t / SLICE9_STEPS * 1e3:.2f} ms/step, "
        f"{n_dofs * SLICE9_STEPS / t:.4e} DOF*steps/s; launches {n} = per "
        f"step { {k: v / SLICE9_STEPS for k, v in n.items()} }; SWE FGMRES "
        f"cycles a step {[p['ksp_cycles'] for p in swe]}; sediment "
        f"{per[-1]['sediment']}, Exner {per[-1]['exner']} (Newton "
        f"iterations, FGMRES cycles of 16); sediment min "
        f"{float(s.fields.sediment_2d.data.min()):.3e}, bed change "
        f"{dz:.3e} m; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: {smi}")
    return n


def tidal_array_case():
    """Phase 23a in a process of its own (``python3 chip_smoke.py
    tidal_array``, started in phase 21's block; the example sets rho0 =
    1026): the example at its size (100x30, f64, 20 steps of 50 s
    through ``iterate(update_forcings=...)`` with the power callback)
    against its checks."""
    phase_device()
    smi = card()
    dev = torch.device("cuda")
    physical_constants["rho0"] = 1026.0
    (s, cb, update_forcings), t_setup = sync_time(
        lambda: tidal_array_solver(dev, torch.float64))
    _, t = sync_time(lambda: s.iterate(update_forcings=update_forcings))
    uv = s.fields.uv_2d.data
    check_finite("tidal array", s._get_state())
    power = sum(cb.average_power)
    x_dof = torch.as_tensor(s.mesh2d.coords_np[s.mesh2d.cells_np][..., 0],
                            device=dev)
    speed = torch.sqrt((uv**2).sum(-1))
    wake = float(speed[(x_dof > 1100) & (x_dof < 1300)].mean())
    free = float(speed[(x_dof > 400) & (x_dof < 800)].mean())
    if s.iteration != 20 or not 1e5 < power < 1e8 or not wake < free:
        raise AssertionError(f"tidal array: {s.iteration} steps, average "
                             f"power {power} W, wake {wake} vs free {free}")
    log(f"[turbines tidal array] examples/discrete_turbines/tidal_array.py "
        f"at its size, f64 100x30, 9 turbines, CN dt 50 s ("
        f"{type(s.timestepper.coarse).__name__} PC), 20 steps through "
        f"iterate(update_forcings=...): setup {t_setup:.2f} s, "
        f"{t / 20 * 1e3:.2f} ms/step; average power {power:.4e} W (bounds "
        f"1e5 .. 1e8), turbines {sum(cb.cost):.6f}; wake {wake:.4f} m/s < "
        f"free stream {free:.4f} m/s; card: {smi}")


def phase_turbines(smi):
    """Phase 23b: the tidal array at the bench's width (400x120, 96,000
    cells, f32, rho0 1026 for the phase) from the ramp's end, 1 + 5 steps
    at dt 2.5 s: the example's 50 s puts the wave CFL at 110 there, where
    the semi-implicit CN takes the Schur fieldsplit (no block-Jacobi) and
    stops short of ksp_rtol; at 2.5 s (CFL 5.5) it takes the coarse
    correction.  (23a runs in phase 21's block.)"""
    dev = torch.device("cuda")
    rho0 = physical_constants["rho0"]
    physical_constants["rho0"] = 1026.0
    try:
        (s, cb, update_forcings), t_setup = sync_time(
            lambda: tidal_array_solver(dev, torch.float32, nx=400, ny=120,
                                       params=F32_PARAMS, dt=2.5,
                                       spun_up=True))
        nc = s.mesh2d.nc
        shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
        _, t_warm = sync_time(lambda: timed_steps(s, 1, update_forcings))
        reset_counts()
        t, per = timed_steps(s, SLICE9_STEPS, update_forcings)
        n = counts()
        check_state("tidal array 400x120", s, shapes)
        require_hand_kernels("tidal array 400x120", n, SLICE9_STEPS)
        turbines = sum(cb.cost)
        power = cb.instantaneous_power
        if abs(turbines - 9.0) > 1e-5 or not all(math.isfinite(p)
                                                  for p in power):
            raise AssertionError(f"tidal array 400x120: {turbines} "
                                 f"turbines, power {power}")
        swe = [p["swe"] for p in per]
        log(f"[turbines bench width] the array on 400x120 (2000 x 600 m), "
            f"f32, {nc} cells, {9 * nc} DOF, from 2.5 m/s, dt 2.5 s, "
            f"semi-implicit CN ({type(s.timestepper.coarse).__name__} at "
            f"wave CFL {s._wave_cfl(0.5 * s.dt):.1f}): setup {t_setup:.2f} "
            f"s, warm-up {t_warm * 1e3:.1f} ms; {SLICE9_STEPS} steps "
            f"{t / SLICE9_STEPS * 1e3:.2f} ms/step, "
            f"{9 * nc * SLICE9_STEPS / t:.4e} DOF*steps/s; launches {n} = "
            f"per step { {k: v / SLICE9_STEPS for k, v in n.items()} }; "
            f"FGMRES cycles of 24 {[p.get('ksp_cycles') for p in swe]} a "
            f"step, final residuals "
            f"{[p.get('ksp_rel_residual') for p in swe]}; turbines "
            f"{turbines:.6f}; power {power} W; card: {smi}")
    finally:
        physical_constants["rho0"] = rho0
    return n


def solitary_wave_case():
    """Phase 24a in a process of its own (``python3 chip_smoke.py
    solitary_wave``, started in phase 21's block): the solitary wave at
    its size (250x1, f64, 200 steps) against its checks."""
    phase_device()
    smi = card()
    dev = torch.device("cuda")
    (s, c_sol, a, x0), t_setup = sync_time(
        lambda: solitary_solver(dev, torch.float64))
    _, t = sync_time(s.iterate)
    eta = s.fields.elev_2d.data
    check_finite("solitary wave", s._get_state())
    x_dof = s.function_spaces.H_2d.dof_coords()[..., 0]
    x_peak = float(x_dof.reshape(-1)[int(eta.argmax())])
    x_expect = x0 + c_sol * s.simulation_time
    if (s.iteration != SOLITARY_STEPS or not abs(x_peak - x_expect) < 30.0
            or not float(eta.max()) > 0.7 * a):
        raise AssertionError(f"solitary wave: {s.iteration} steps, crest at "
                             f"{x_peak} (expected {x_expect}), amplitude "
                             f"{float(eta.max())}")
    log(f"[nh solitary wave] examples/nonhydrostatic_cases/solitary_wave_nh "
        f"at its size, f64 250x1, dt 0.1 s, {SOLITARY_STEPS} steps: setup "
        f"{t_setup:.2f} s, {t / SOLITARY_STEPS * 1e3:.2f} ms/step; crest at "
        f"{x_peak:.2f} m vs x0 + c t = {x_expect:.2f} m (within 30), "
        f"amplitude {float(eta.max()):.4f} m > 0.7 a = {0.7 * a:.2f}; last "
        f"step {solver_stats(s)}; card: {smi}")


def phase_nonhydrostatic(smi):
    """Phase 24b: the solitary wave on 640x80 (102,400 cells), f32, the
    Newton CN, 1 + 5 steps.  (24a runs in phase 21's block.)"""
    dev = torch.device("cuda")
    (s, _, _, _), t_setup = sync_time(
        lambda: solitary_solver(dev, torch.float32, nx=640, ny=80, ly=125.0,
                                q_rtol=1e-5, newton=True))
    mesh = s.mesh2d
    nq = s.poisson_solver.nq_nodes
    n_dofs = 9 * mesh.nc + 3 * mesh.nc + nq
    shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
    _, t_warm = sync_time(lambda: iterate_steps(s, 1))
    reset_counts()
    t, per = timed_steps(s, SLICE9_STEPS)
    n = counts()
    check_state("nh 640x80", s, shapes)
    require_hand_kernels("nh 640x80", n, SLICE9_STEPS)
    log(f"[nh bench width] the wave on 640x80 (1000 x 125 m), f32, "
        f"{mesh.nc} cells, {n_dofs} DOF (SWE {9 * mesh.nc} + w "
        f"{3 * mesh.nc} + P2 q {nq}), dt 0.1 s, Newton CN under "
        f"{type(s.timestepper.preconditioner).__name__}, q_solver_rtol "
        f"1e-5: setup "
        f"{t_setup:.2f} s, warm-up {t_warm * 1e3:.1f} ms; {SLICE9_STEPS} "
        f"steps {t / SLICE9_STEPS * 1e3:.2f} ms/step, "
        f"{n_dofs * SLICE9_STEPS / t:.4e} DOF*steps/s; launches {n} = per "
        f"step { {k: v / SLICE9_STEPS for k, v in n.items()} }; BiCGStab "
        f"iterations a step {[p['bicgstab'] for p in per]}; SWE Newton "
        f"iterations {[p['swe'].get('newton_iterations') for p in per]}, "
        f"FGMRES cycles of 8 {[p['swe']['ksp_cycles'] for p in per]}; card: "
        f"{smi}")
    return n


def profile_slice9():
    """The profiler's view of one step (the coupled advance) of each
    full-width case of phases 22-24 after a warm-up step, from a fresh
    process (``python3 chip_smoke.py profile_slice9``, kernels built
    already; started in phase 21's block): device kernels, device ms and
    the hand kernels' share."""
    phase_device()
    dev = torch.device("cuda")
    physical_constants["rho0"] = 1026.0  # the tidal array's, this process
    cases = {
        "22b sediment channel": lambda: (channel_solver(
            dev, torch.float32, params=F32_PARAMS), None),
        "23b tidal array": lambda: (lambda r: (r[0], r[2]))(
            tidal_array_solver(dev, torch.float32, nx=400, ny=120,
                               params=F32_PARAMS, dt=2.5, spun_up=True)),
        "24b solitary wave": lambda: (solitary_solver(
            dev, torch.float32, nx=640, ny=80, ly=125.0, q_rtol=1e-5,
            newton=True)[0], None),
    }
    device_rows(lambda: torch.ones(8, device=dev) + 1)  # profiler warm-up
    for name, make in cases.items():
        s, update_forcings = make()
        timed_steps(s, 1, update_forcings)
        if update_forcings is not None:
            update_forcings(s.simulation_time + s.dt)
        st = s._get_state()
        args = (s.simulation_time, st, s._gather_swe_fields(),
                s._add_sediment_diffusivity(s._gather_tracer_extra(st)),
                s._gather_bnd("shallow_water"), s._gather_bnd("tracer"))
        torch.cuda.synchronize()
        rows = device_rows(lambda: s._advance(*args))
        if not rows:
            raise RuntimeError(f"the profiler saw no device kernel in {name}")
        hand = {k: (sum(c for _, c, key in rows if f"{k}_kernel" in key),
                    sum(us for us, _, key in rows if f"{k}_kernel" in key)
                    / 1e3)
                for k in ("ring_mv", "block_diag_mv")}
        tag = "[slice9 profile]"
        log(f"{tag} {name}, one step's coupled advance: "
            f"{sum(r[1] for r in rows)} device kernels, device busy "
            f"{sum(r[0] for r in rows) / 1e3:.3f} ms; hand kernels "
            f"(launches, device ms) {hand}; top by device time:")
        for us, cnt, key in rows[:5]:
            log(f"{tag}   {us / 1e3:8.3f} ms  x{cnt:<5d} {key[:90]}")


def phase_model_parity_slice9():
    """Phase 21's f64 GPU-against-CPU step of each configuration of phases
    22-24 at a size the CPU affords: the sediment channel with Exner at
    1 m/s (x1, 16x4), the tidal array's farms from 2.5 m/s (100x30, dt
    10 s: the coarse correction) and the solitary wave (250x1,
    q_solver_rtol 1e-12)."""
    cases = {
        "sediment exner": lambda d: channel_solver(
            d, torch.float64, nx=16, ny=4, scale=1.0, inflow=1.0,
            params=PARITY9_PARAMS),
        "tidal array": lambda d: tidal_array_solver(
            d, torch.float64, params=PARITY9_PARAMS, dt=10.0,
            spun_up=True)[0],
        "nh wave": lambda d: solitary_solver(d, torch.float64,
                                             q_rtol=1e-12)[0],
    }
    for name, make in cases.items():
        out, secs = {}, {}
        for dv in ("cuda", "cpu"):
            s = make(torch.device(dv))
            start = {k: v.clone() for k, v in s._get_state().items()}
            reset_counts()
            t0 = time.perf_counter()
            iterate_steps(s, 1)
            if dv == "cuda":
                torch.cuda.synchronize()
                n = counts()
            secs[dv] = time.perf_counter() - t0
            out[dv] = s._get_state()
        if n["ring_mv"] == 0:
            raise AssertionError(f"parity {name}: GPU step launches {n}")
        moved = {k: float((out["cpu"][k] - start[k]).abs().max())
                 for k in out["cpu"]}
        errs = compare(f"parity model2d {name}", out["cuda"], out["cpu"],
                       PARITY_RTOL)
        log(f"[parity model2d {name}] f64 one step, GPU {secs['cuda']:.2f} s "
            f"vs CPU {secs['cpu']:.2f} s: max|diff|/max {errs} <= "
            f"{PARITY_RTOL:g}: ok (the step moved {moved})")


# -- the element families, the sphere and gmsh (phases 25-27) -------------
#: tests/test_dgcg.py::test_dgcg_standing_wave's cases: (stepper, steps,
#: the test's bound on the relative L2 elevation error)
DGCG_WAVES = {"cn10": ("CrankNicolson", 10, 2e-2),
              "cn20": ("CrankNicolson", 20, 5e-3),
              "ppp20": ("PressureProjectionPicard", 20, 5e-3)}
#: test_dgcg_mass_conservation's bound on the closed basin's volume, f64
DGCG_VOLUME_RTOL = 1e-10
FAMILY_STEPS = 3
#: the dg-cg corrector's f32 budget (the stepper's default ksp_rtol 1e-10
#: is an f64 setting) with its restart of 30
F32_PPP = dict(ksp_rtol=1e-5, ksp_max_it=60, gmres_restart=30)
#: the f64 parity steps of phases 25-27: solved to roundoff
FAMILY_PARITY_PARAMS = dict(ksp_rtol=1e-12, ksp_max_it=240, gmres_restart=40)
FAMILY_PARITY_RTOL = 1e-10
NX_FAMILY, NY_FAMILY = 20, 10                # the parity steps' mesh
R_EARTH, OMEGA_EARTH = 6371220.0, 7.292e-5
W2_BOUND = 0.05                          # examples/williamson2: l2 < 0.05
W2_REFINEMENT = 6                        # 81,920 cells
HDIV_VOLUME_RTOL = 1e-9                  # the sphere's volume, f32
#: the full-width H(div) runs: (family, polynomial degree)
HDIV_CASES = {"RT1xP0": ("rt-dg", 0), "RT2xP1DG": ("rt-dg", 1),
              "BDM2xP1DG": ("bdm-dg", 1)}


def require_no_kernel(tag, n):
    if any(n.values()):
        raise AssertionError(f"{tag}: this path runs no hand kernel, but "
                             f"launched {n}")


def dgcg_standing_wave(device, timesteps, stepper, params=None):
    """``tests/test_dgcg.py::run_standing_wave`` (100 x 1 over 5 x 1 km,
    depth 100 m, one period; the Newton CN or PressureProjectionPicard),
    f64; returns the solver and the relative L2 elevation error."""
    lx, ly, depth = 5e3, 1e3, 100.0
    period = 2 * lx / math.sqrt(float(physical_constants["g_grav"])
                                * depth)
    dt = period / timesteps
    mesh = RectangleMesh(100, 1, lx, ly, device=device, dtype=torch.float64)
    s = FlowSolver2d(mesh, Function(FunctionSpace(mesh, "CG", 1)).assign(
        depth))
    o = s.options
    o.element_family = "dg-cg"
    o.timestep = dt
    o.simulation_export_time = dt * timesteps
    o.simulation_end_time = period - 0.1 * dt
    o.no_exports = True
    o.swe_timestepper_type = stepper
    if stepper == "CrankNicolson":
        o.swe_timestepper_options.use_semi_implicit_linearization = False
    if params is not None:
        o.swe_timestepper_options.solver_parameters = NewtonParameters(
            **params)
    s.create_function_spaces()
    e0 = Function(s.function_spaces.H_2d).interpolate(
        lambda x, y: torch.cos(math.pi * x / lx))
    s.assign_initial_conditions(elev=e0)
    s.iterate()
    rel = float(s.eq_sw.norm_elev(s.fields.elev_2d.data - e0.data)) \
        / math.sqrt(lx * ly)
    return s, rel


def dgcg_wave_case(key):
    """Phase 25a, one case in a process of its own (``python3
    chip_smoke.py dgcg_wave <cn10|cn20|ppp20>``, started in phase 21's
    block): the test's standing wave at its size, f64, on the card,
    against the test's bound."""
    phase_device()
    stepper, steps, bound = DGCG_WAVES[key]
    reset_counts()
    (s, rel), t = sync_time(lambda: dgcg_standing_wave(
        torch.device("cuda"), steps, stepper))
    require_no_kernel(f"dg-cg wave {key}", counts())
    if s.iteration != steps or not rel < bound:
        raise AssertionError(f"dg-cg standing wave {key}: {s.iteration} "
                             f"steps, relative error {rel} (bound {bound})")
    pc = ("the wave-Schur PC" if stepper == "PressureProjectionPicard"
          else f"the {s.timestepper.preconditioner} PC")
    log(f"[dg-cg standing wave] tests/test_dgcg.py case, f64 100x1, "
        f"{stepper} under {pc}, "
        f"{steps} steps in {t:.2f} s ({t / steps * 1e3:.1f} ms/step): "
        f"relative L2 error {rel:.4e} < {bound:g}; last step "
        f"{s.timestepper.stats}")


def dgcg_volume_case():
    """Phase 25a, in a process of its own (``python3 chip_smoke.py
    dgcg_volume``, started in phase 21's block):
    ``tests/test_dgcg.py::test_dgcg_mass_conservation`` on the card, f64:
    the closed 20x4 basin's volume over 30 CN steps to the test's 1e-10,
    with the scatters' atomic adds in no fixed order."""
    phase_device()
    lx = 2e3

    def run():
        mesh = RectangleMesh(20, 4, lx, lx / 5, device=torch.device("cuda"),
                             dtype=torch.float64)
        s = FlowSolver2d(mesh, Function(FunctionSpace(mesh, "CG", 1)).assign(
            20.0))
        o = s.options
        o.element_family = "dg-cg"
        o.timestep = 10.0
        o.simulation_export_time = 100.0
        o.simulation_end_time = 300.0
        o.no_exports = True
        o.swe_timestepper_type = "CrankNicolson"
        s.create_function_spaces()
        e0 = Function(s.function_spaces.H_2d).interpolate(
            lambda x, y: 0.5 * torch.exp(-(((x - lx / 2) / 300.0) ** 2)))
        s.assign_initial_conditions(elev=e0)
        s.initialize()
        v0 = s.compute_volume_2d()
        s.iterate()
        return s, v0

    reset_counts()
    (s, v0), t = sync_time(run)
    require_no_kernel("dg-cg volume", counts())
    dv = abs(s.compute_volume_2d() - v0) / abs(v0)
    if (s.iteration != 30 or not dv < DGCG_VOLUME_RTOL
            or not bool(torch.isfinite(s.fields.elev_2d.data).all())):
        raise AssertionError(f"dg-cg volume: {s.iteration} steps, the volume "
                             f"changed by {dv} of itself (bound "
                             f"{DGCG_VOLUME_RTOL:g})")
    log(f"[dg-cg volume] tests/test_dgcg.py::test_dgcg_mass_conservation, "
        f"f64 20x4 closed basin, 30 CN steps in {t:.2f} s: the volume "
        f"changed by {dv:.3e} of itself < {DGCG_VOLUME_RTOL:g}")


def family_solver(device, dtype, family, degree=1, stepper="CrankNicolson",
                  params=F32_PARAMS, cfl=2.0, nx=NX, ny=NY):
    """The bench's 2D case (bench.py:39-75: 100 x 50 km, depth 50 m, the
    Gaussian hump, quadratic drag 2.5e-3, LF 1) through ``FlowSolver2d``
    in another element family, dt = ``cfl`` hmin / sqrt(g 51) (the
    semi-implicit CN's ``use_semi_implicit_linearization``); returns the
    solver and its setup seconds."""
    def build():
        mesh = RectangleMesh(nx, ny, LX, LY, device=device, dtype=dtype)
        s = FlowSolver2d(mesh, 50.0)
        o = s.options
        o.element_family = family
        o.polynomial_degree = degree
        o.swe_timestepper_type = stepper
        if stepper == "CrankNicolson":
            o.swe_timestepper_options.use_semi_implicit_linearization = True
        o.swe_timestepper_options.solver_parameters = NewtonParameters(
            **params)
        o.timestep = cfl * float(mesh.cell_hmin_np.min()) / math.sqrt(
            9.81 * 51.0)
        o.quadratic_drag_coefficient = 2.5e-3
        o.lax_friedrichs_velocity_scaling_factor = 1.0
        o.no_exports = True
        s.create_function_spaces()
        x = s.function_spaces.H_2d.dof_coords()
        s.assign_initial_conditions(elev=torch.exp(
            -(((x[..., 0] - LX / 2) / 15e3) ** 2)
            - ((x[..., 1] - LY / 2) / 15e3) ** 2))
        return s

    return sync_time(build)


def solver_pcgs(s):
    """The mass PCGs (``solvers/pcg.py::JacobiPCG``) held by the solver's
    equation and function spaces."""
    objs = [s.eq_sw, *vars(s.function_spaces).values()]
    found = {id(v): v for o in objs
             for v in getattr(o, "__dict__", {}).values()
             if isinstance(v, JacobiPCG)}
    return list(found.values())


def family_run(tag, s, t_setup, smi, volume_rtol):
    """1 warm-up + ``FAMILY_STEPS`` steps through ``iterate()`` with the
    launch counts set to 0 before the warm-up; finite state of unchanged
    shapes, the volume to ``volume_rtol``, every mass PCG of the solver
    replayed as a CUDA graph (none solved eagerly); returns the
    counts."""
    shapes = {k: tuple(v.shape) for k, v in s._get_state().items()}
    v0 = s.compute_volume_2d()
    pcgs = solver_pcgs(s)
    replays0 = [p.replays for p in pcgs]
    reset_counts()
    _, t_warm = sync_time(lambda: iterate_steps(s, 1))
    t, per = timed_steps(s, FAMILY_STEPS)
    n = counts()
    check_state(tag, s, shapes)
    require_no_kernel(tag, n)
    replays = [p.replays - r for p, r in zip(pcgs, replays0)]
    eager = [p.eager_cuda for p in pcgs]
    if not pcgs or min(replays) < 1 or any(eager):
        raise AssertionError(f"{tag}: mass PCGs {len(pcgs)}, graph replays "
                             f"{replays}, eager CUDA solves {eager}")
    dv = abs(s.compute_volume_2d() - v0) / abs(v0)
    if not dv <= volume_rtol:
        raise AssertionError(f"{tag}: the volume changed by {dv} of itself "
                             f"(bound {volume_rtol})")
    swe = [p["swe"] for p in per]
    dofs = sum(v.numel() for v in s._get_state().values())
    log(f"[{tag}] {s.mesh2d.nc} cells, {dofs} DOF, dt {s.dt:.3f} s, "
        f"{s.options.swe_timestepper_type}: setup {t_setup:.2f} s, warm-up "
        f"{t_warm * 1e3:.1f} ms; {FAMILY_STEPS} steps "
        f"{t / FAMILY_STEPS * 1e3:.2f} ms/step, "
        f"{dofs * FAMILY_STEPS / t:.4e} DOF*steps/s; launches {n}; Newton "
        f"iterations {[p.get('newton_iterations') for p in swe]}, FGMRES "
        f"cycles {[p.get('ksp_cycles') for p in swe]}, final residuals "
        f"{[p.get('ksp_rel_residual') for p in swe]}; mass PCG graph "
        f"replays {replays}; volume change {dv:.3e}"
        f" (bound {volume_rtol:g}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: {smi}")
    return n


def phase_dgcg(smi):
    """Phase 25b: dg-cg (P1DG velocity x P2 CG elevation) on the bench's
    320x160 mesh, f32, PressureProjectionPicard under the wave-Schur PC
    at wave CFL 10, 1 + 3 steps.  (25a runs in phase 21's block.)"""
    s, t_setup = family_solver(torch.device("cuda"), torch.float32,
                               "dg-cg", stepper="PressureProjectionPicard",
                               params=F32_PPP, cfl=10.0)
    if not s.timestepper.use_schur_pc:
        raise AssertionError("dg-cg PPP without the wave-Schur PC")
    return family_run(f"dg-cg PPP {NX}x{NY}", s, t_setup, smi,
                      VOLUME_RTOL_F32)


def phase_hdiv(smi):
    """Phase 26b: RT1 x P0, RT2 x P1DG and BDM2 x P1DG on the bench's
    320x160 mesh, f32, the semi-implicit CN at 2 hmin/c, 1 + 3 steps
    each.  (26a runs in phase 21's block.)"""
    total = {k: 0 for k in KERNELS}
    for name, (family, degree) in HDIV_CASES.items():
        s, t_setup = family_solver(torch.device("cuda"), torch.float32,
                                   family, degree)
        n = family_run(f"hdiv {name} {NX}x{NY}", s, t_setup, smi,
                       VOLUME_RTOL_F32)
        for k in KERNELS:
            total[k] += n[k]
    return total


def williamson2_solver(device, dtype, refinement, family="rt-dg",
                       params=None, days=0.25):
    """``examples/williamson2/williamson2.py`` written for the port: the
    icosahedral sphere, rt-dg (RT1 x P0) or bdm-dg, the semi-implicit CN
    at dt 900 s, the Coriolis frequency and the zonal velocity at the
    vertices; returns the solver, the analytic elevation (nc, 1) and its
    amplitude."""
    from thetis_tpu_torch.mesh.sphere import IcosahedralSphereMesh

    mesh = IcosahedralSphereMesh(R_EARTH, refinement, device=device,
                                 dtype=dtype)
    g = 9.81
    u0 = 2 * np.pi * R_EARTH / (12.0 * 86400.0)
    s = FlowSolver2d(mesh, torch.as_tensor(2.94e4 / g))
    o = s.options
    o.element_family = family
    o.polynomial_degree = 0
    o.swe_timestepper_type = "CrankNicolson"
    o.swe_timestepper_options.use_semi_implicit_linearization = True
    o.swe_timestepper_options.solver_parameters = NewtonParameters(
        **(params or dict(ksp_rtol=1e-8, ksp_max_it=96, gmres_restart=24)))
    o.timestep = 900.0
    o.simulation_export_time = 86400.0
    o.simulation_end_time = days * 86400.0
    o.no_exports = True
    xyz = mesh.coords_np
    cent = mesh.cell_midpoints()
    sin_lat = cent[:, 2] / np.linalg.norm(cent, axis=1)
    amp = (R_EARTH * OMEGA_EARTH * u0 + 0.5 * u0 ** 2) / g
    eta0 = (-amp * sin_lat ** 2)[:, None]
    uvec = (u0 / R_EARTH) * np.stack([-xyz[:, 1], xyz[:, 0],
                                      np.zeros(mesh.nv)], axis=-1)
    o.coriolis_frequency = torch.as_tensor(2.0 * OMEGA_EARTH * xyz[:, 2]
                                           / R_EARTH)
    s.assign_initial_conditions(elev=torch.as_tensor(eta0),
                                uv=torch.as_tensor(uvec))
    return s, eta0, amp


def williamson2_l2(s, eta0, amp):
    area = s.mesh2d.cell_area_np
    err = s.fields.elev_2d.data[:, 0].double().cpu().numpy() - eta0[:, 0]
    return math.sqrt(float((area * err ** 2).sum()) / area.sum()) / amp


def williamson2_case():
    """Phase 27a (in :func:`hdiv_cases`' process): the example at its
    regression size (refinement 3, 0.25 day in 24 steps of 900 s, f64)
    against its own bound."""
    reset_counts()
    (s, eta0, amp), t_setup = sync_time(lambda: williamson2_solver(
        torch.device("cuda"), torch.float64, 3))
    s.initialize()
    v0 = s.compute_volume_2d()
    _, t = sync_time(s.iterate)
    require_no_kernel("williamson2", counts())
    l2 = williamson2_l2(s, eta0, amp)
    dv = abs(s.compute_volume_2d() - v0) / abs(v0)
    if s.iteration != 24 or not l2 < W2_BOUND or not dv < 1e-12:
        raise AssertionError(f"williamson2: {s.iteration} steps, l2 {l2}, "
                             f"volume change {dv}")
    log(f"[williamson2] examples/williamson2/williamson2.py at its "
        f"regression size, f64, refinement 3 ({s.mesh2d.nc} cells), 24 "
        f"steps of 900 s: setup {t_setup:.2f} s, {t / 24 * 1e3:.1f} "
        f"ms/step; elevation rel. L2 error {l2:.4f} < {W2_BOUND}; volume "
        f"change {dv:.2e}; last step {s.timestepper.stats}")


def hdiv_standing_wave(device, family, degree, nx, n_per_period, periods,
                       amp=0.01):
    """The standing wave of ``tests/test_rtdg.py::test_rtdg_flowsolver``
    (degree 0) and ``tests/test_rt2.py::test_rt2_facade`` (degree 1)
    through the port's FlowSolver2d, f64; returns the solver and the
    initial elevation."""
    lx, ly, depth = 5e3, 1e3, 100.0
    period = 2 * lx / math.sqrt(float(physical_constants["g_grav"])
                                * depth)
    mesh = RectangleMesh(nx, 2, lx, ly, device=device, dtype=torch.float64)
    s = FlowSolver2d(mesh, Function(FunctionSpace(mesh, "CG", 1)).assign(
        depth))
    o = s.options
    o.element_family = family
    o.polynomial_degree = degree
    o.timestep = period / n_per_period
    o.swe_timestepper_type = "CrankNicolson"
    o.no_exports = True
    s.create_function_spaces()
    if degree == 0:
        o.simulation_export_time = period
        o.simulation_end_time = periods * period - 0.1 * o.timestep
        mids = torch.as_tensor(mesh.cell_midpoints(), device=device)
        eta0 = amp * torch.cos(math.pi * mids[:, :1] / lx)
        s.assign_initial_conditions(elev=eta0, uv=np.asarray([0.0, 0.0]))
    else:
        o.simulation_export_time = period / 4
        o.simulation_end_time = periods * period - 1e-3
        eta0 = Function(s.function_spaces.H_2d).interpolate(
            lambda x, y: amp * torch.cos(math.pi / lx * x)).data
        s.assign_initial_conditions(elev=eta0)
    return s, eta0


def hdiv_cases():
    """Phases 26a and 27a in a process of its own (``python3
    chip_smoke.py hdiv_cases``, started in phase 21's block): the
    reference tests' standing waves at their sizes, f64, against their
    bounds: ``test_rtdg_flowsolver`` (60x2, 40 steps: volume 1e-6,
    amplitude 0.05) and ``test_rt2_facade`` for rt-dg and bdm-dg (16x2,
    half a period: 0.1); then Williamson 2 at its regression size."""
    phase_device()
    dev = torch.device("cuda")
    reset_counts()
    s, eta0 = hdiv_standing_wave(dev, "rt-dg", 0, 60, 40, 1.0)
    s.initialize()
    v0 = s.compute_volume_2d()
    _, t = sync_time(s.iterate)
    dv = abs(s.compute_volume_2d() - v0) / abs(v0)
    rel = float(s.eq_sw.norm_elev(s.fields.elev_2d.data - eta0)) \
        / math.sqrt(5e3 * 1e3) / 0.01
    if s.iteration != 40 or not dv < 1e-6 or not rel < 0.05:
        raise AssertionError(f"rtdg flowsolver: {s.iteration} steps, "
                             f"volume {dv}, amplitude {rel}")
    log(f"[hdiv rtdg flowsolver] tests/test_rtdg.py case, f64 60x2, 40 CN "
        f"steps in {t:.2f} s: volume change {dv:.2e} < 1e-6, amplitude "
        f"error {rel:.4f} < 0.05")
    for family in ("rt-dg", "bdm-dg"):
        s, eta0 = hdiv_standing_wave(dev, family, 1, 16, 64, 0.5)
        _, t = sync_time(s.iterate)
        err = float(s.asm.norm_l2(s.fields.elev_2d.data + eta0)) / float(
            s.asm.norm_l2(eta0))
        if not err < 0.1 or not bool(torch.isfinite(
                s.fields.uv_2d.data).all()):
            raise AssertionError(f"rt2 facade {family}: error {err}")
        log(f"[hdiv rt2 facade] tests/test_rt2.py case, {family} p = 1, "
            f"f64 16x2, {s.iteration} CN steps in {t:.2f} s: error "
            f"{err:.4f} < 0.1")
    require_no_kernel("hdiv cases", counts())
    williamson2_case()


def write_msh(path, nx, ny):
    """The bench's rectangle (``RectangleMesh(nx, ny, LX, LY)``'s vertices
    and cells, in its order) as a gmsh 2.2 file: physical lines 1-4 on
    the sides (left, right, bottom, top), physical surface 7."""
    x = np.linspace(0.0, LX, nx + 1)
    y = np.linspace(0.0, LY, ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    i, j = (a.ravel() for a in np.meshgrid(np.arange(nx), np.arange(ny),
                                           indexing="ij"))
    cells = np.concatenate([
        np.stack([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)], 1),
        np.stack([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)], 1)])
    lines = ([(vid(0, k), vid(0, k + 1), 1) for k in range(ny)]
             + [(vid(nx, k), vid(nx, k + 1), 2) for k in range(ny)]
             + [(vid(k, 0), vid(k + 1, 0), 3) for k in range(nx)]
             + [(vid(k, ny), vid(k + 1, ny), 4) for k in range(nx)])
    out = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
           str(len(coords))]
    out += [f"{n + 1} {float(px)!r} {float(py)!r} 0"
            for n, (px, py) in enumerate(coords)]
    out += ["$EndNodes", "$Elements", str(len(lines) + len(cells))]
    e = 0
    for a, b, tag in lines:
        e += 1
        out.append(f"{e} 1 2 {tag} {tag} {a + 1} {b + 1}")
    for c in cells:
        e += 1
        out.append(f"{e} 2 2 7 1 {c[0] + 1} {c[1] + 1} {c[2] + 1}")
    out.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def gmsh_step(device, dtype, nx=NX, ny=NY):
    """A .msh of the bench's rectangle written here, read onto ``device``
    by ``mesh/gmsh.py``, then one dg-dg SSPRK33 step of the bench's
    Gaussian (dt 0.08 hmin/c, an ``elev`` boundary on physical line 2);
    returns the solver and the read and write seconds."""
    from thetis_tpu_torch.config import BUILD_DIR
    from thetis_tpu_torch.mesh.gmsh import Mesh

    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"box_{nx}x{ny}.msh")
    t0 = time.perf_counter()
    write_msh(path, nx, ny)
    t_write = time.perf_counter() - t0
    mesh, t_read = sync_time(lambda: Mesh(path, device=device, dtype=dtype))
    s = FlowSolver2d(mesh, 50.0)
    o = s.options
    o.swe_timestepper_type = "SSPRK33"
    o.swe_timestepper_options.use_automatic_timestep = False
    o.timestep = 0.08 * float(mesh.cell_hmin_np.min()) / math.sqrt(
        9.81 * 51.0)
    o.no_exports = True
    s.bnd_functions["shallow_water"] = {2: {"elev": 0.0}}
    x = torch.as_tensor(mesh.coords_np, device=device)[mesh.cells]
    s.assign_initial_conditions(elev=torch.exp(
        -(((x[..., 0] - LX / 2) / 15e3) ** 2)
        - ((x[..., 1] - LY / 2) / 15e3) ** 2))
    return s, t_write, t_read


def phase_sphere(smi):
    """Phase 27b: Williamson 2 at refinement 6 (81,920 cells) under rt-dg
    and bdm-dg, f32, 1 + 3 steps, the volume to 1e-9; 27c: a .msh of the
    bench's rectangle read onto the card and one dg-dg step.  (27a runs
    in phase 21's block.)"""
    dev = torch.device("cuda")
    total = {k: 0 for k in KERNELS}
    for family in ("rt-dg", "bdm-dg"):
        (s, eta0, amp), t_setup = sync_time(lambda: williamson2_solver(
            dev, torch.float32, W2_REFINEMENT, family, params=F32_PARAMS))
        n = family_run(f"sphere williamson2 {family} refinement "
                       f"{W2_REFINEMENT}", s, t_setup, smi,
                       HDIV_VOLUME_RTOL)
        log(f"[sphere williamson2 {family}] after {s.iteration} steps: "
            f"elevation rel. L2 error {williamson2_l2(s, eta0, amp):.4e}")
        for k in KERNELS:
            total[k] += n[k]
    reset_counts()
    s, t_write, t_read = gmsh_step(dev, torch.float32)
    ref = RectangleMesh(NX, NY, LX, LY, device=dev, dtype=torch.float32)
    mesh = s.mesh2d
    for name in ("cells_np", "facet_marker_np", "facet_cells_np"):
        if not np.array_equal(getattr(mesh, name), getattr(ref, name)):
            raise AssertionError(f"gmsh: {name} differs from RectangleMesh")
    if mesh.boundary_len != ref.boundary_len or set(
            mesh.cell_markers_np) != {7}:
        raise AssertionError(f"gmsh: markers {mesh.boundary_len}")
    v0 = s.compute_volume_2d()
    _, t = sync_time(lambda: iterate_steps(s, 1))
    n = counts()
    check_finite("gmsh", s._get_state())
    require_no_kernel("gmsh", n)
    for k in KERNELS:
        total[k] += n[k]
    log(f"[gmsh] the bench's {NX}x{NY} rectangle as a gmsh 2.2 file "
        f"(written in {t_write:.2f} s), read onto the card in {t_read:.2f} s"
        f": {mesh.nv} vertices, {mesh.nc} cells, markers "
        f"{mesh.boundary_markers} (the RectangleMesh's tables); one SSPRK33 "
        f"step in {t * 1e3:.1f} ms, volume change "
        f"{abs(s.compute_volume_2d() - v0) / v0:.2e}; launches {n}; card: "
        f"{smi}")
    return total


def phase_model_parity_families():
    """Phase 21's f64 GPU-against-CPU step of each configuration of phases
    25-27 at a size the CPU affords, each solved to roundoff: dg-cg PPP
    and the three H(div) pairs on 20x10, Williamson 2 (rt-dg, bdm-dg) at
    refinement 3, and the read .msh's SSPRK33 step on 20x10."""
    small = dict(params=FAMILY_PARITY_PARAMS, nx=NX_FAMILY, ny=NY_FAMILY)
    cases = {
        "dg-cg ppp": lambda d: family_solver(
            d, torch.float64, "dg-cg", stepper="PressureProjectionPicard",
            cfl=10.0, **small)[0],
        **{f"hdiv {name}": (lambda d, fam=fam, deg=deg: family_solver(
            d, torch.float64, fam, deg, **small)[0])
           for name, (fam, deg) in HDIV_CASES.items()},
        **{f"williamson2 {fam}": (lambda d, fam=fam: williamson2_solver(
            d, torch.float64, 3, fam, params=FAMILY_PARITY_PARAMS)[0])
           for fam in ("rt-dg", "bdm-dg")},
        "gmsh ssprk33": lambda d: gmsh_step(d, torch.float64, NX_FAMILY,
                                            NY_FAMILY)[0],
    }
    for name, make in cases.items():
        out, secs = {}, {}
        for dv in ("cuda", "cpu"):
            s = make(torch.device(dv))
            start = {k: v.clone() for k, v in s._get_state().items()}
            reset_counts()
            t0 = time.perf_counter()
            iterate_steps(s, 1)
            if dv == "cuda":
                torch.cuda.synchronize()
                require_no_kernel(f"parity {name}", counts())
            secs[dv] = time.perf_counter() - t0
            out[dv] = s._get_state()
        moved = {k: float((out["cpu"][k] - start[k]).abs().max())
                 for k in out["cpu"]}
        errs = compare(f"parity {name}", out["cuda"], out["cpu"],
                       FAMILY_PARITY_RTOL)
        log(f"[parity families {name}] f64 one step, GPU {secs['cuda']:.2f} s"
            f" vs CPU {secs['cpu']:.2f} s: max|diff|/max {errs} <= "
            f"{FAMILY_PARITY_RTOL:g}: ok (the step moved {moved})")


def profile_families():
    """The profiler's view of one step (the coupled advance) of each
    full-width case of phases 25-27 after a warm-up step, from a fresh
    process (``python3 chip_smoke.py profile_families``, started in phase
    21's block): device kernels and device ms a step, the step's Newton
    iterations and FGMRES cycles."""
    phase_device()
    dev = torch.device("cuda")
    f32 = torch.float32
    cases = {
        "25b dg-cg PPP": lambda: family_solver(
            dev, f32, "dg-cg", stepper="PressureProjectionPicard",
            params=F32_PPP, cfl=10.0)[0],
        **{f"26b {name}": (lambda fam=fam, deg=deg: family_solver(
            dev, f32, fam, deg)[0]) for name, (fam, deg) in
           HDIV_CASES.items()},
        **{f"27b williamson2 {fam}": (lambda fam=fam: williamson2_solver(
            dev, f32, W2_REFINEMENT, fam, params=F32_PARAMS)[0])
           for fam in ("rt-dg", "bdm-dg")},
    }
    device_rows(lambda: torch.ones(8, device=dev) + 1)  # profiler warm-up
    for name, make in cases.items():
        s = make()
        timed_steps(s, 1)
        st = s._get_state()
        args = (s.simulation_time, st, s._gather_swe_fields(), {},
                s._gather_bnd("shallow_water"), {})
        torch.cuda.synchronize()
        rows = device_rows(lambda: s._advance(*args), host=False)
        if not rows:
            raise RuntimeError(f"the profiler saw no device kernel in {name}")
        tag = "[families profile]"
        log(f"{tag} {name}, one step's coupled advance: "
            f"{sum(r[1] for r in rows)} device kernels, device busy "
            f"{sum(r[0] for r in rows) / 1e3:.3f} ms; the step's solver "
            f"{s.timestepper.stats}; top by device time:")
        for us, cnt, key in rows[:4]:
            log(f"{tag}   {us / 1e3:8.3f} ms  x{cnt:<5d} {key[:90]}")



# -- phase 28: the adjoint ------------------------------------------------
#: 28a's steps (the gradient's timed run) and the memory comparison's
ADJ_STEPS, ADJ_MEM_STEPS = 4, 8
#: the f64 checks' solve: tight enough that a Taylor remainder is not the
#: Krylov tolerance's noise
F64_ADJ = dict(ksp_rtol=1e-11, ksp_max_it=480, gmres_restart=24)
#: f64 gradient, kernels against plain versions and GPU against CPU
ADJ_RTOL = 1e-9
#: examples/channel_inversion/inverse_problem.py at its regression size
CHANNEL = dict(lx=20e3, ly=2e3, nx=32, ny=4, true=0.05, guess=0.02,
               steps=20, maxiter=8, x=[2.5e3, 7.5e3, 12.5e3, 17.5e3],
               y=[1e3] * 4)


def adjoint_forward(s, n, checkpoint=False):
    """Phase 28's functional: J = the domain integral of u_x at the end
    plus the L2 norm of the elevation summed over the steps (times dt),
    as a function of the drag field and the initial elevation."""
    asm = s.asm
    return s.differentiable_forward(
        ["quadratic_drag_coefficient", "initial_elev"],
        terminal_functional=lambda st: asm.integrate(st["uv"][..., 0]),
        step_functional=lambda st, f, t: asm.norm_l2(st["elev"]),
        n_steps=n, checkpoint=checkpoint)


def adjoint_controls(s):
    m = s.mesh2d
    return (torch.full((m.nv,), 2.5e-3, dtype=m.dtype, device=m.device),
            s.fields.elev_2d.data.clone())


def adjoint_grad(fwd, controls):
    """``(J, gradients)`` at detached copies of ``controls``."""
    xs = [c.detach().clone().requires_grad_(True) for c in controls]
    J = fwd(*xs)
    return J.detach(), torch.autograd.grad(J, xs)


def tight_cn(s, params=F64_ADJ):
    """The solver's semi-implicit CN solved to ``params``."""
    p = s.timestepper.params
    for k, v in params.items():
        setattr(p, k, v)
    return s


@contextlib.contextmanager
def plain_kernels():
    """The ring matvec and block-Jacobi wrappers routed to their plain
    versions on the card, for 28b's comparison only."""
    import thetis_tpu_torch.solvers.assembled as asm_mod

    saved = (ringmv.ring_mv, asm_mod.ring_mv, asm_mod.block_diag_mv)
    ringmv.ring_mv = asm_mod.ring_mv = ringmv.ring_mv_reference
    asm_mod.block_diag_mv = ringmv.block_diag_mv_reference
    try:
        yield
    finally:
        ringmv.ring_mv, asm_mod.ring_mv, asm_mod.block_diag_mv = saved


def max_rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def phase_adjoint(smi):
    """Phase 28a: the bench's 2D CN (320x160, f32, ring matvec and
    block-Jacobi kernels) under ``differentiable_forward`` over
    ``ADJ_STEPS`` steps: the forward and the backward each profiled
    (device ms, device kernels) and counted (launches; the backward's
    ring_mv must be > 0), their wall times, and the peak memory of an
    ``ADJ_MEM_STEPS``-step gradient stored and checkpointed (chunk 2).
    Returns the launches of the gradient's run (forward + backward)."""
    dev = torch.device("cuda")
    s, t_setup = model2d("cn", dev, torch.float32)
    fwd = adjoint_forward(s, ADJ_STEPS)
    ctl = adjoint_controls(s)
    _, t_warm = sync_time(lambda: adjoint_grad(fwd, ctl))
    held = []

    def forward():
        xs = [c.detach().clone().requires_grad_(True) for c in ctl]
        held.append((fwd(*xs), xs))

    reset_counts()
    rows_f = device_rows(forward, host=False)
    n_f = counts()
    J, xs = held.pop()
    grads = []
    reset_counts()
    rows_b = device_rows(lambda: grads.append(torch.autograd.grad(J, xs)),
                         host=False)
    n_b = counts()
    if not rows_f or not rows_b:
        raise RuntimeError("28a: the profiler saw no device kernel")
    if n_b["ring_mv"] < 1 or n_f["ring_mv"] < 1:
        raise AssertionError(f"28a: ring_mv launches forward {n_f}, "
                             f"backward {n_b}")
    for g in grads[0]:
        if not torch.isfinite(g).all() or float(g.abs().max()) == 0.0:
            raise AssertionError("28a: gradient not finite or zero")
    _, t_f = sync_time(lambda: forward())
    J, xs = held.pop()
    _, t_b = sync_time(lambda: torch.autograd.grad(J, xs))
    st = s.timestepper.stats
    for name, rows, n, t in (("forward", rows_f, n_f, t_f),
                             ("backward", rows_b, n_b, t_b)):
        log(f"[28a adjoint {name}] {NX}x{NY} f32 CN, {ADJ_STEPS} steps: "
            f"device {sum(r[0] for r in rows) / 1e3:.3f} ms, "
            f"{sum(r[1] for r in rows)} device kernels, wall "
            f"{t * 1e3:.1f} ms; ring_mv {n['ring_mv']}, block_diag_mv "
            f"{n['block_diag_mv']} launches")
    log(f"[28a adjoint] J {float(J.detach()):.6e}; last step's FGMRES cycles "
        f"{st.get('ksp_cycles')}, adjoint cycles "
        f"{st.get('adjoint_ksp_cycles')}; setup {t_setup:.2f} s, first "
        f"gradient {t_warm:.2f} s; card: {smi}")
    peaks = {}
    out = {}
    for ck in (False, 2):
        f8 = adjoint_forward(s, ADJ_MEM_STEPS, checkpoint=ck)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (j8, g8), t8 = sync_time(lambda: adjoint_grad(f8, ctl))
        peaks[ck] = (torch.cuda.max_memory_allocated() - base) / 2**20
        out[ck] = (j8, g8, t8)
    errs = [max_rel(a, b) for a, b in zip(out[2][1], out[False][1])]
    if max(errs) > 1e-3:
        raise AssertionError(f"28a: checkpointed gradient differs {errs}")
    log(f"[28a adjoint memory] {ADJ_MEM_STEPS} steps: peak above the "
        f"solver {peaks[False]:.1f} MiB stored, {peaks[2]:.1f} MiB with "
        f"checkpoint=2; gradient {out[False][2]:.2f} s and "
        f"{out[2][2]:.2f} s; checkpointed against stored max|diff|/max "
        f"{max(errs):.2e}; card: {smi}")
    return {k: n_f[k] + n_b[k] for k in KERNELS}


def taylor_rate(fwd, controls, which, dc, h0):
    """The Taylor rate of ``fwd`` in control ``which`` along ``dc``."""
    from thetis_tpu_torch.adjoint import Control, ReducedFunctional, \
        taylor_test

    def one(v):
        vals = list(controls)
        vals[which] = v
        return fwd(*vals)

    rf = ReducedFunctional(one, Control(controls[which]))
    return taylor_test(rf, controls[which], dc, h0=h0)


def pcg_replays(s, fn):
    """Run ``fn``; the mass PCGs' graph replays during it and their eager
    CUDA solves (28d requires replays and no eager solve)."""
    pcgs = solver_pcgs(s)
    r0 = [p.replays for p in pcgs]
    out = fn()
    return out, [p.replays - r for p, r in zip(pcgs, r0)], \
        [p.eager_cuda for p in pcgs]


def sum_squares(st):
    return sum((v ** 2).sum() for v in st.values())


def phase_adjoint_checks(smi):
    """Phases 28b-28d, f64, timing nothing: (b) the full-width CN
    gradient with the kernels against the plain versions and its Taylor
    rate, and the 40x20 gradient on the card against the CPU's; (c) the
    channel-inversion example in a process of its own (``python3
    chip_smoke.py channel_inversion``), started first; (d) the Taylor
    rates through one explicit dg-cg step and one RT1 CN step at the
    bench's width (every mass PCG replayed its graph in the backward, none
    solved eagerly) and through the tidal-farm example's density."""
    procs = start_cases([["channel_inversion"]])
    try:
        dev = torch.device("cuda")
        s, _ = model2d("cn", dev, torch.float64)
        tight_cn(s)
        fwd = adjoint_forward(s, 2)
        ctl = adjoint_controls(s)
        j_k, g_k = adjoint_grad(fwd, ctl)
        with plain_kernels():
            reset_counts()
            j_p, g_p = adjoint_grad(fwd, ctl)
            if counts()["ring_mv"] or counts()["block_diag_mv"]:
                raise AssertionError("28b: a kernel ran in the plain run")
        errs = [max_rel(a, b) for a, b in zip(g_k, g_p)]
        if max(errs) > ADJ_RTOL:
            raise AssertionError(f"28b: kernels against plain {errs}")
        e0 = ctl[1]
        rate = taylor_rate(fwd, ctl, 1, 0.1 * torch.rand_like(e0), 0.2)
        if not rate > 1.9:
            raise AssertionError(f"28b: Taylor rate {rate}")
        log(f"[28b adjoint f64] {NX}x{NY}, 2 steps: gradient with the "
            f"kernels against the plain versions max|diff|/max "
            f"{max(errs):.2e} (drag, elevation; <= {ADJ_RTOL:g}); Taylor "
            f"rate in the initial elevation {rate:.4f} (> 1.9)")
        gs = {}
        for d in (dev, torch.device("cpu")):
            sp, _ = model2d("cn", d, torch.float64, nx=NX_PARITY // 2,
                            ny=NY_PARITY // 2)
            tight_cn(sp)
            gs[d.type] = adjoint_grad(adjoint_forward(sp, 2),
                                      adjoint_controls(sp))
        errs = [max_rel(a.cpu(), b)
                for a, b in zip(gs["cuda"][1], gs["cpu"][1])]
        if max(errs) > ADJ_RTOL:
            raise AssertionError(f"28b: GPU against CPU {errs}")
        log(f"[28b adjoint f64] {NX_PARITY // 2}x{NY_PARITY // 2}: GPU "
            f"gradient against the CPU's max|diff|/max {max(errs):.2e} "
            f"(<= {ADJ_RTOL:g})")
        phase_adjoint_families()
    finally:
        finish_cases(procs)


def phase_adjoint_families():
    """28d: Taylor rates through the mass PCGs and the farm, f64."""
    dev = torch.device("cuda")
    for tag, family, degree, stepper, cfl in (
            ("dg-cg SSPRK33", "dg-cg", 1, "SSPRK33", 0.1),
            ("rt-dg p0 CN", "rt-dg", 0, "CrankNicolson", 2.0)):
        s, _ = family_solver(dev, torch.float64, family, degree, stepper,
                             params=dict(ksp_rtol=1e-12, ksp_max_it=240,
                                         gmres_restart=40), cfl=cfl)
        fwd = s.differentiable_forward(
            ["initial_elev"], terminal_functional=sum_squares, n_steps=1)
        e0 = s.fields.elev_2d.data.clone()
        _, replays, eager = pcg_replays(
            s, lambda: adjoint_grad(fwd, [e0]))
        if not replays or min(replays) < 1 or any(eager):
            raise AssertionError(f"28d {tag}: mass PCG replays in the "
                                 f"gradient {replays}, eager {eager}")
        # the backward alone replays too
        xs = [e0.clone().requires_grad_(True)]
        J = fwd(*xs)
        _, replays_b, eager = pcg_replays(
            s, lambda: torch.autograd.grad(J, xs))
        if min(replays_b) < 1 or any(eager):
            raise AssertionError(f"28d {tag}: backward replays "
                                 f"{replays_b}, eager {eager}")
        rate = taylor_rate(fwd, [e0], 0, 0.1 * torch.rand_like(e0), 0.5)
        if not rate > 1.9:
            raise AssertionError(f"28d {tag}: Taylor rate {rate}")
        log(f"[28d adjoint {tag}] {s.mesh2d.nc} cells f64, one step: Taylor "
            f"rate in the initial elevation {rate:.4f} (> 1.9); mass PCG "
            f"graph replays in a gradient {replays}, in its backward "
            f"{replays_b}, eager CUDA solves {eager}")
    fwd, rf, density = tidalfarm_case(dev)
    rng = torch.Generator(device="cpu").manual_seed(3)
    dc = 0.001 * torch.rand(density.shape, generator=rng, dtype=density.dtype)
    from thetis_tpu_torch.adjoint import taylor_test
    rate = taylor_test(rf, density, dc.to(dev), h0=0.2)
    if not rate > 1.9:
        raise AssertionError(f"28d tidalfarm: Taylor rate {rate}")
    log(f"[28d adjoint tidalfarm] examples/tidalfarm at its regression size "
        f"(50x15, 5 steps, f64): Taylor rate in turbine_density_0 "
        f"{rate:.4f} (> 1.9)")


def tidalfarm_case(device):
    """``examples/tidalfarm/tidalfarm.py`` at its regression size (5
    steps) written for the port: returns the forward, the reduced
    functional (scale -1e-5, the example's) and the initial density."""
    from thetis_tpu_torch.adjoint import Control, ReducedFunctional
    from thetis_tpu_torch.model.turbines import (TidalTurbineFarmOptions,
                                                 TidalTurbineOptions)

    lx, ly = 2000.0, 600.0
    mesh = RectangleMesh(50, 15, lx, ly, device=device, dtype=torch.float64)
    p1 = FunctionSpace(mesh, "CG", 1)
    so = FlowSolver2d(mesh, Function(p1).assign(40.0))
    o = so.options
    o.timestep = 10.0
    o.simulation_export_time = 200.0
    o.simulation_end_time = 200.0
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.horizontal_viscosity = Constant(2.0)
    o.quadratic_drag_coefficient = Constant(0.0025)
    farm = TidalTurbineFarmOptions()
    farm.turbine_options = TidalTurbineOptions(diameter=18.0,
                                               thrust_coefficient=0.8)
    x, y = SpatialCoordinate(mesh)
    mask = ((x - lx / 2).abs() < 300.0) & ((y - ly / 2).abs() < 200.0)
    farm.turbine_density = Function(p1).interpolate(
        torch.where(mask, 0.003, 0.0))
    farm.break_even_wattage = 200.0
    o.tidal_turbine_farms = {"everywhere": [farm]}
    so.bnd_functions["shallow_water"] = {1: {"un": Constant(-2.0)},
                                         2: {"elev": Constant(0.0)}}
    so.assign_initial_conditions(uv=torch.tensor([2.0, 0.0]), elev=0.0)
    so.initialize()
    n_steps, asm, farm_obj, dt = 5, so.asm, so.tidal_farms[0], so.dt

    def profit_step(state, fields, t):
        uv_q = asm.cell_values(state["uv"])
        eta_q = asm.cell_values(state["elev"])
        H_q = so.depth.total_depth(so.eq_sw.bathy_q, eta_q)
        density_q = fields["turbine_density_0"]
        power = asm.integrate_cellq(
            farm_obj.turbine.power(uv_q, H_q) * density_q)
        cost = farm.break_even_wattage * asm.integrate_cellq(density_q)
        return (power - cost) / (n_steps * dt)

    fwd = so.differentiable_forward(["turbine_density_0"],
                                    step_functional=profit_step,
                                    n_steps=n_steps)
    rf = ReducedFunctional(fwd, Control(farm.turbine_density), scale=-1e-5)
    return fwd, rf, farm.turbine_density.data.clone()


def channel_inversion_solver(device, manning, c=CHANNEL):
    mesh = RectangleMesh(c["nx"], c["ny"], c["lx"], c["ly"], device=device,
                         dtype=torch.float64)
    p1 = FunctionSpace(mesh, "CG", 1)
    so = FlowSolver2d(mesh, Function(p1).assign(20.0))
    o = so.options
    o.timestep = 30.0
    o.simulation_export_time = 30.0 * c["steps"]
    o.simulation_end_time = 30.0 * c["steps"]
    o.no_exports = True
    o.swe_timestepper_type = "CrankNicolson"
    o.manning_drag_coefficient = Function(p1).assign(float(manning))
    so.bnd_functions["shallow_water"] = {1: {"un": Constant(-0.5)},
                                         2: {"elev": Constant(0.0)}}
    so.assign_initial_conditions(uv=torch.tensor([0.5, 0.0]), elev=0.0)
    return so


def channel_inversion(device, c=CHANNEL, output_dir=None):
    """``examples/channel_inversion/inverse_problem.py`` written for the
    port: the truth run's station records, then the inversion of the
    Manning field from the first guess through ``InversionManager``
    (L-BFGS-B, gradient regularisation).  Returns (J0, J1, recovered
    mean Manning)."""
    from thetis_tpu_torch.adjoint.inversion_tools import (
        GradientRegularizationCalculator, InversionManager,
        StationObservationManager)

    names = [f"station{k}" for k in "ABCD"]
    so = channel_inversion_solver(device, c["true"], c)
    sta = StationObservationManager(so)
    sta._xy = list(zip(c["x"], c["y"]))
    sta.construct_evaluator()
    state = so._get_state()
    fields = so._gather_swe_fields()
    bnd = so._gather_bnd("shallow_water")
    times, samples = [], []
    with torch.no_grad():
        for i in range(c["steps"]):
            state = so._advance(0.0, state, fields, {}, bnd, {})
            samples.append(sta.sample(state).cpu().numpy())
            times.append((i + 1) * so.dt)
    samples = np.asarray(samples).T
    so = channel_inversion_solver(device, c["guess"], c)
    sta = StationObservationManager(so)
    sta.register_observation_data(names, "elev", [times] * len(names),
                                  list(samples), c["x"], c["y"])
    sta.construct_evaluator()
    im = InversionManager(sta, real_cost_function_scaling=1.0,
                          output_dir=output_dir or os.path.join(
                              "chiprun_out", "channel_inversion"))
    reg = GradientRegularizationCalculator(so.asm, gamma=1e-4)
    im.add_control("manning_drag_coefficient",
                   so.options.manning_drag_coefficient, regularization=reg)
    rf = im.get_reduced_functional(c["steps"])
    J0 = rf()
    result = im.minimize(maxiter=c["maxiter"], ftol=1e-14, gtol=1e-14)
    J1 = rf([result])
    return J0, J1, float(result.mean())


def channel_inversion_case():
    """Phase 28c in a process of its own (``python3 chip_smoke.py
    channel_inversion``): the example at its regression size (32x4, 20
    steps, 8 L-BFGS iterations), f64, against its own checks."""
    t0 = time.perf_counter()
    J0, J1, rec = channel_inversion(torch.device("cuda"))
    if not (J1 < 0.1 * J0 and abs(rec - CHANNEL["true"])
            < abs(CHANNEL["guess"] - CHANNEL["true"])):
        raise AssertionError(f"28c channel inversion: J {J0} -> {J1}, "
                             f"recovered Manning {rec}")
    log(f"[28c channel inversion] 32x4, 20 steps, 8 L-BFGS iterations, "
        f"f64: J {J0:.4e} -> {J1:.4e} (< 0.1 J0), recovered Manning "
        f"{rec:.4f} (truth {CHANNEL['true']}, first guess "
        f"{CHANNEL['guess']}); {time.perf_counter() - t0:.1f} s")


# -- phase 29: I/O and forcing, as the North Sea demo runs them ----------
#: demos/north_sea_mesh.py's simplified coastline, counter-clockwise
#: (lon, lat), and its open-boundary segments (Dover strait, the north)
NS_OUTLINE = np.array([
    (1.60, 51.20), (1.75, 52.40), (1.40, 52.90), (0.30, 53.40),
    (-0.20, 54.20), (-1.20, 55.20), (-1.80, 56.20), (-2.40, 57.20),
    (-1.90, 58.20), (-1.30, 59.20), (-1.00, 60.60), (1.00, 60.80),
    (3.00, 60.80), (4.80, 60.70), (5.30, 59.60), (6.30, 58.30),
    (7.80, 57.80), (8.60, 56.80), (8.20, 55.60), (8.00, 54.60),
    (7.20, 53.80), (5.60, 53.35), (4.60, 52.90), (3.90, 51.90),
    (2.60, 51.25)])
NS_OPEN_SEGMENTS = [(24, 0), (10, 13)]
#: demos/demo_2d_north_sea.py: tide-gauge stations (lat, lon), its time
#: step and export interval at 40 km, the Manning coefficient
NS_STATIONS = {"aberdeen": (57.14, -2.08), "lowestoft": (52.47, 1.75),
               "delfzijl": (53.33, 6.93)}
NS_RES_KM, NS_DT = 40.0, 3600.0
NS_MANNING, NS_OMEGA = 3.0e-02, 7.292e-05
NS_INIT_DATE = (2022, 1, 1)
NS_TPXO_NAME = "h_synthetic_tpxo.nc"


def _point_in_polygon(pts, poly):
    """Vectorised ray casting (north_sea_mesh.py:46-57)."""
    x, y = pts[:, 0], pts[:, 1]
    inside = np.zeros(len(pts), dtype=bool)
    n = len(poly)
    for i in range(n):
        x0, y0 = poly[i]
        x1, y1 = poly[(i + 1) % n]
        cond = (y0 > y) != (y1 > y)
        xint = (x1 - x0) * (y - y0) / (y1 - y0 + 1e-300) + x0
        inside ^= cond & (x < xint)
    return inside


@functools.lru_cache(maxsize=2)
def north_sea_mesh_arrays(resolution_km=NS_RES_KM):
    """``make_north_sea_mesh`` of demos/north_sea_mesh.py:60-157 without
    its Mesh2d: returns ``(coords, cells, markers, coord_system)``,
    ``markers`` the boundary-marker function of edge midpoints (100 open
    ocean, 200 coast).  The distance of each lattice point to the
    boundary is taken in chunks (the same numbers, a bounded memory at
    3.2 km).  Cached: the arrays are read, never written."""
    from scipy.spatial import Delaunay

    from thetis_tpu_torch.utils.coordsys import UTMCoordinateSystem

    cs = UTMCoordinateSystem(utm_zone=30)
    res = resolution_km * 1e3
    poly_xy = np.array([cs.to_xy(lo, la) for lo, la in NS_OUTLINE])
    bpts = []
    for i in range(len(poly_xy)):
        a = poly_xy[i]
        b = poly_xy[(i + 1) % len(poly_xy)]
        nseg = max(1, int(round(np.linalg.norm(b - a) / res)))
        for k in range(nseg):
            bpts.append(a + (b - a) * (k / nseg))
    bpts = np.asarray(bpts)
    x0, y0 = poly_xy.min(axis=0) - res
    x1, y1 = poly_xy.max(axis=0) + res
    xs = np.arange(x0, x1, res)
    ys = np.arange(y0, y1, res * np.sqrt(3) / 2)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    X[:, 1::2] += 0.5 * res
    grid = np.stack([X.ravel(), Y.ravel()], axis=1)
    inside = _point_in_polygon(grid, poly_xy)
    d2b = np.concatenate([
        np.min(np.linalg.norm(grid[i:i + 4096, None, :] - bpts[None, :, :],
                              axis=-1), axis=1)
        for i in range(0, len(grid), 4096)])
    interior = grid[inside & (d2b > 0.55 * res)]
    pts = np.concatenate([bpts, interior])
    cells = Delaunay(pts).simplices
    keep = _point_in_polygon(pts[cells].mean(axis=1), poly_xy)
    p0, p1, p2 = pts[cells[:, 0]], pts[cells[:, 1]], pts[cells[:, 2]]
    area2 = np.abs((p1 - p0)[:, 0] * (p2 - p0)[:, 1]
                   - (p1 - p0)[:, 1] * (p2 - p0)[:, 0])
    keep &= area2 > 0.05 * res * res
    cells = cells[keep]
    used = np.unique(cells.ravel())
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    coords = pts[used]
    cells = remap[cells]
    open_lines = []
    for i0, i1 in NS_OPEN_SEGMENTS:
        idx = [i0]
        j = i0
        while j != i1:
            j = (j + 1) % len(NS_OUTLINE)
            idx.append(j)
        open_lines.append(poly_xy[idx])

    def markers(mids):
        m = np.full(len(mids), 200, dtype=np.int32)
        for line in open_lines:
            dmin = np.full(len(mids), np.inf)
            for k in range(len(line) - 1):
                a, b = line[k], line[k + 1]
                ab = b - a
                tpar = np.clip(((mids - a) @ ab) / max(ab @ ab, 1e-300),
                               0.0, 1.0)
                proj = a + tpar[:, None] * ab
                dmin = np.minimum(dmin, np.linalg.norm(mids - proj, axis=1))
            m[dmin < 0.3 * res] = 100
        return m

    return coords, cells.astype(np.int32), markers, cs


def write_north_sea_tpxo(path):
    """The demo's synthetic TPXO-format constituent file, M2 and S2
    (demo_2d_north_sea.py:90-124), in netCDF3."""
    from scipy.io import netcdf_file

    lon_ax = np.linspace(-5.0, 12.0, 35)
    lat_ax = np.linspace(49.0, 62.0, 27)
    LON, LAT = np.meshgrid(lon_ax, lat_ax, indexing="ij")
    amp_m2 = 1.2 + 0.3 * np.sin(np.deg2rad(LON))
    pha_m2 = np.deg2rad(LON * 8.0)
    amp_s2 = np.full_like(LON, 0.4)
    pha_s2 = np.deg2rad(LON * 8.0 + 30)
    h_re = np.stack([amp_m2 * np.cos(pha_m2), amp_s2 * np.cos(pha_s2)])
    h_im = np.stack([-amp_m2 * np.sin(pha_m2), -amp_s2 * np.sin(pha_s2)])
    with netcdf_file(path, "w") as f:
        f.createDimension("nc", 2)
        f.createDimension("nct", 4)
        f.createDimension("nx", len(lon_ax))
        f.createDimension("ny", len(lat_ax))
        con = f.createVariable("con", "c", ("nc", "nct"))
        con[0, :] = np.frombuffer(b"m2  ", dtype="S1")
        con[1, :] = np.frombuffer(b"s2  ", dtype="S1")
        f.createVariable("lon_z", "d", ("nx",))[:] = lon_ax
        f.createVariable("lat_z", "d", ("ny",))[:] = lat_ax
        f.createVariable("hRe", "d", ("nc", "nx", "ny"))[:] = h_re
        f.createVariable("hIm", "d", ("nc", "nx", "ny"))[:] = h_im


def north_sea_solver(device, dtype, outdir, resolution_km=NS_RES_KM,
                     dt=NS_DT, steps=24, exports=True, export_every=1,
                     params=None, station_hdf5=False):
    """demos/demo_2d_north_sea.py through the port, as the demo builds
    it: the shelf bathymetry, Manning drag, Coriolis from latitude, DIRK22
    semi-implicit, the TPXO file written to ``outdir`` and read back by
    ``TPXOTidalBoundaryForcing`` on the open boundary (tag 100), and the
    three tide-gauge stations evaluated every step.  ``steps`` steps of
    ``dt``, an export every ``export_every`` steps (``exports`` False:
    ``no_exports``; ``station_hdf5``: the stations write their HDF5
    series).  Returns ``(solver, update_forcings, stations)``."""
    import datetime

    from thetis_tpu_torch.model.callback import TimeSeriesCallback2D
    from thetis_tpu_torch.model.forcing import TPXOTidalBoundaryForcing
    from thetis_tpu_torch.utils.timezone import FixedTimeZone

    coords, cells, markers, cs = north_sea_mesh_arrays(resolution_km)
    mesh2d = Mesh2d(coords, cells, boundary_markers=markers,
                    name="north_sea_synthetic", device=device, dtype=dtype)
    P1 = FunctionSpace(mesh2d, "CG", 1)
    lon, lat = cs.get_mesh_lonlat_function(mesh2d)
    lon, lat = np.asarray(lon), np.asarray(lat)
    bathy = Function(P1, name="Bathymetry", data=np.clip(
        20.0 + 150.0 * np.clip((lat - 50.0) / 12.0, 0, 1) ** 2
        + 30.0 * np.cos(np.deg2rad(lon) * 3), 10.0, 700.0))
    manning = Function(P1, name="Manning coefficient").assign(NS_MANNING)
    coriolis = Function(P1, name="Coriolis forcing").interpolate(
        2 * NS_OMEGA * np.sin(lat * np.pi / 180.0))
    s = FlowSolver2d(mesh2d, bathy)
    o = s.options
    o.element_family = "dg-dg"
    o.polynomial_degree = 1
    o.coriolis_frequency = coriolis
    o.manning_drag_coefficient = manning
    o.horizontal_velocity_scale = Constant(1.5)
    o.use_lax_friedrichs_velocity = True
    o.simulation_export_time = export_every * dt
    o.simulation_end_time = steps * dt
    o.swe_timestepper_type = "DIRK22"
    o.swe_timestepper_options.use_semi_implicit_linearization = True
    if params is not None:
        o.swe_timestepper_options.solver_parameters = params
    o.timestep = dt
    o.fields_to_export = ["elev_2d", "uv_2d"]
    o.no_exports = not exports
    o.output_directory = os.path.join(outdir, "outputs")
    init_date = datetime.datetime(*NS_INIT_DATE,
                                  tzinfo=FixedTimeZone(0, "UTC"))
    open_nodes = np.unique(
        mesh2d.facet_verts_np[mesh2d.facet_marker_np == 100].ravel())
    tpxo = os.path.join(outdir, NS_TPXO_NAME)
    os.makedirs(outdir, exist_ok=True)
    if not os.path.exists(tpxo):
        write_north_sea_tpxo(tpxo)
    tide = TPXOTidalBoundaryForcing(
        np.stack([lat[open_nodes], lon[open_nodes]], axis=-1), init_date,
        constituents=["M2", "S2"], data_dir=outdir, elev_file=NS_TPXO_NAME)
    elev_bc = Function(P1, name="tidal elevation")
    s.bnd_functions["shallow_water"] = {100: {"elev": elev_bc}, 200: {}}

    def update_forcings(t):
        vals = np.zeros(mesh2d.nv)
        vals[open_nodes] = tide.set_tidal_field(t)
        elev_bc.data = torch.as_tensor(vals, dtype=dtype, device=device)

    update_forcings(0.0)
    s.assign_initial_conditions(elev=elev_bc)
    stations = {}
    for name, (slat, slon) in NS_STATIONS.items():
        x, y = cs.to_xy(slon, slat)
        stations[name] = TimeSeriesCallback2D(
            s, ["elev_2d"], float(x), float(y), name, append_to_log=False,
            export_to_hdf5=station_hdf5)
        s.add_callback(stations[name], "timestep")
    return s, update_forcings, stations


#: phase 29b: the North Sea at 104,423 cells, dt scaled with the
#: resolution (the demo's wave CFL), 1 warm-up + 12 steps, an export every
#: 4 steps
NS_FINE_KM = 3.2
NS_FINE_STEPS = 12
NS_FINE_EXPORT_EVERY = 4
NS_STEPS = 24                           # 29a: the demo's day, hourly
NS_FINE_NC = 104423
#: the ERA5 case of 29d: a 10 m wind of ~8 m/s and 1010 hPa over the
#: North Sea, two hourly records
ERA5_LON, ERA5_LAT = np.linspace(-5.0, 12.0, 18), np.linspace(62.0, 49.0, 14)


def have_h5py():
    import importlib.util

    return importlib.util.find_spec("h5py") is not None


def h5py_text():
    if have_h5py():
        import h5py

        return (f"h5py {h5py.__version__} is installed: every part of "
                "phase 29 runs")
    return ("h5py is not installed on this machine: phase 29 leaves out the "
            "HDF5 checkpoints, load_state (29b's restart and 29c's "
            "checkpoint cases), DiagnosticHDF5 (the stations' HDF5 series) "
            "and the NetCDF4 reader; it runs the VTK and NPZ exporters, the "
            "stations without HDF5, the NetCDF3 TPXO and ERA5 forcing and "
            "the kernels")


def drop_hdf5(s):
    """Without h5py the solver's HDF5 checkpoint exporter cannot write;
    the phase removes it (the code picks no other format)."""
    if not have_h5py():
        s.exporters.pop("hdf5", None)


def timed(obj, name, acc, sync=True):
    """Wrap ``obj.name`` so that each call's wall seconds (device work
    queued before it finished first) are appended to ``acc``."""
    fn = getattr(obj, name)

    def run(*a, **kw):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        acc.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, run)


def count_rows(s, stations):
    """Record each station evaluation's time (``evaluate`` wrapped)."""
    rows = {name: [] for name in stations}
    for name, cb in stations.items():
        ev = cb.evaluate

        def evaluate(index=None, ev=ev, name=name):
            ev(index)
            rows[name].append(s.simulation_time)

        cb.evaluate = evaluate
    return rows


def export_files(outdir):
    """{series: number of files} under a solver's output directory (its
    non-empty subdirectories)."""
    out = {}
    for sub in sorted(os.listdir(outdir)):
        path = os.path.join(outdir, sub)
        if os.path.isdir(path) and os.listdir(path):
            out[sub] = len(os.listdir(path))
    return out


def north_sea_bounds(tag, s):
    """tests/test_north_sea.py's checks."""
    e, u = s.fields.elev_2d.data, s.fields.uv_2d.data
    if not (bool(torch.isfinite(e).all()) and bool(torch.isfinite(u).all())):
        raise AssertionError(f"{tag}: non-finite fields")
    umax, emax = float(u.abs().max()), float(e.abs().max())
    if not (1e-3 < umax < 10.0 and emax < 10.0):
        raise AssertionError(f"{tag}: |u|max {umax}, |e|max {emax}")
    if len(s.callbacks["timestep"]) != 3:
        raise AssertionError(f"{tag}: {len(s.callbacks['timestep'])} "
                             "station callbacks")
    return umax, emax


def fine_dt():
    return NS_DT * NS_FINE_KM / NS_RES_KM


def fine_solver(dev, outdir, exports):
    """29b's case: the North Sea at 3.2 km in f32 (Krylov budget F32_PARAMS,
    an rtol f32 reaches), 1 + NS_FINE_STEPS steps."""
    s, uf, st = north_sea_solver(
        dev, torch.float32, outdir, resolution_km=NS_FINE_KM, dt=fine_dt(),
        steps=1 + NS_FINE_STEPS, exports=exports,
        export_every=NS_FINE_EXPORT_EVERY, params=NewtonParameters(
            **F32_PARAMS), station_hdf5=exports and have_h5py())
    drop_hdf5(s)
    if not exports:
        s.callbacks["timestep"].clear()
    return s, uf, st


def phase_io(smi, dev=None):
    """Phase 29 (a, b): the North Sea demo through the port with its I/O
    on, at the demo's size and at the bench's width.  Returns the ring
    kernels' launches of both runs (counts set to 0 before 29a)."""
    import tempfile

    dev = dev or torch.device("cuda")
    log(f"[29 io] {h5py_text()}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    reset_counts()
    # (a) the demo at its own size: 40 km, f64, 24 hourly steps
    s, uf, st = north_sea_solver(dev, torch.float64, os.path.join(tmp, "a"),
                                 steps=NS_STEPS, station_hdf5=have_h5py())
    drop_hdf5(s)
    rows = count_rows(s, st)
    _, t_a = sync_time(lambda: s.iterate(update_forcings=uf))
    umax, emax = north_sea_bounds("29a", s)
    if any(len(r) != NS_STEPS for r in rows.values()):
        raise AssertionError(f"29a: station rows {rows}")
    files = export_files(s.options.output_directory)
    want = {"Elevation2d": NS_STEPS + 2, "Velocity2d": NS_STEPS + 2}
    if have_h5py():
        want["hdf5"] = 2 * (NS_STEPS + 1) + 1
    if files != want:
        raise AssertionError(f"29a: export files {files}, expected {want}")
    n_a = counts()
    a_ii = float(SCHEMES["DIRK22"]().a[-1][-1])
    log(f"[29a north sea] 40 km ({s.mesh2d.nc} cells), f64, DIRK22 "
        f"(implicit wave CFL {s._wave_cfl(a_ii * s.dt):.2f} -> "
        f"{type(s.timestepper.coarse).__name__}), "
        f"{NS_STEPS} steps of {NS_DT:g} s with the TPXO boundary every step,"
        f" hourly exports and 3 stations: {t_a:.2f} s; |u|max {umax:.4f} in"
        f" (1e-3, 10), |e|max {emax:.4f} < 10; station rows "
        f"{ {k: len(v) for k, v in rows.items()} } (one per step); export "
        f"files {files}; ring_mv {n_a['ring_mv']}, block_diag_mv "
        f"{n_a['block_diag_mv']} launches; stations "
        + ", ".join(f"{k} {float(v()[0][0]):+.4f} m" for k, v in st.items()))
    # (b) the bench's width: 104,423 cells, f32, with and without I/O
    out = {}
    for io in (True, False):
        s, uf, st = fine_solver(dev, os.path.join(tmp, f"b{int(io)}"), io)
        if s.mesh2d.nc != NS_FINE_NC:
            raise AssertionError(f"29b: {s.mesh2d.nc} cells")
        acc = {"vtk": [], "hdf5": [], "stations": []}
        for k, m in s.exporters.items():
            timed(m, "export", acc[k])
        for cb in st.values():
            timed(cb, "evaluate", acc["stations"])
        o = s.options
        o.simulation_end_time = s.dt
        _, t_warm = sync_time(lambda: s.iterate(update_forcings=uf))
        for v in acc.values():
            v.clear()
        n0 = counts()
        o.simulation_end_time = (1 + NS_FINE_STEPS) * s.dt
        _, t = sync_time(lambda: s.iterate(update_forcings=uf))
        n1 = counts()
        per = {k: (n1[k] - n0[k]) / NS_FINE_STEPS for k in KERNELS}
        require_hand_kernels("29b", {k: n1[k] - n0[k] for k in KERNELS},
                             NS_FINE_STEPS)
        if io:
            north_sea_bounds("29b", s)
        out[io] = dict(s=s, t=t, per=per, acc=acc, warm=t_warm,
                       stats=dict(s.timestepper.stats))
    s = out[True]["s"]
    coeff = a_ii * s.dt
    pc = type(s.timestepper.coarse).__name__
    ms = {io: out[io]["t"] / NS_FINE_STEPS * 1e3 for io in out}
    acc = out[True]["acc"]
    marks = s.mesh2d.facet_marker_np
    log(f"[29b north sea] {NS_FINE_KM:g} km: {s.mesh2d.nc} cells, "
        f"{s.mesh2d.nv} vertices, {int((marks == 100).sum())} open / "
        f"{int((marks == 200).sum())} coast "
        f"facets, {9 * s.mesh2d.nc} DOF, f32, dt {s.dt:g} s: implicit wave "
        f"CFL {s._wave_cfl(coeff):.2f} -> {pc}; 1 + {NS_FINE_STEPS} steps: "
        f"{ms[True]:.1f} ms/step with I/O (VTK every "
        f"{NS_FINE_EXPORT_EVERY} steps, 3 stations every step), "
        f"{ms[False]:.1f} ms/step without; ring_mv "
        f"{out[True]['per']['ring_mv']:.1f}, block_diag_mv "
        f"{out[True]['per']['block_diag_mv']:.1f} launches a step; last "
        f"step's FGMRES cycles {out[True]['stats'].get('ksp_cycles')} over "
        f"{out[True]['stats'].get('stages')} stages; card: {smi}")
    log(f"[29b io costs] seconds per export: VTK "
        + (f"{np.mean(acc['vtk']):.3f} (x{len(acc['vtk'])}, two fields of "
           f"{3 * s.mesh2d.nc} points)" if acc["vtk"] else "none")
        + (f", HDF5 {np.mean(acc['hdf5']):.3f} (x{len(acc['hdf5'])})"
           if acc["hdf5"] else ", HDF5 not run (no h5py)")
        + f"; seconds per station evaluation {np.mean(acc['stations']):.5f} "
        f"(x{len(acc['stations'])}); setup-free warm-up step with the "
        f"initial export {out[True]['warm']:.2f} s, without "
        f"{out[False]['warm']:.2f} s; card: {smi}")
    if have_h5py():
        io_restart_fine(dev, tmp, out[True]["s"])
    n = counts()
    shutil_rmtree(tmp)
    return n


def shutil_rmtree(path):
    import shutil

    shutil.rmtree(path, ignore_errors=True)


def io_restart_fine(dev, tmp, s_full):
    """29b's restart (h5py only): a fresh solver ``load_state(2)`` from
    the run with I/O, run on to its end, against it, beside a second
    uninterrupted run."""
    def run_from_start(outdir):
        s, uf, _ = fine_solver(dev, outdir, True)
        s.options.simulation_end_time = s.dt
        s.iterate(update_forcings=uf)
        s.options.simulation_end_time = (1 + NS_FINE_STEPS) * s.dt
        s.iterate(update_forcings=uf)
        return s

    s2 = run_from_start(os.path.join(tmp, "b2"))
    r, uf, _ = fine_solver(dev, os.path.join(tmp, "b3"), True)
    r.load_state(2, outputdir=s_full.options.output_directory)
    t_load = r.simulation_time
    r.options.simulation_end_time = (1 + NS_FINE_STEPS) * r.dt
    r.iterate(update_forcings=uf)
    a, b, c = s_full._get_state(), s2._get_state(), r._get_state()
    spread = {k: max_rel(b[k], a[k]) for k in a}
    dist = {k: max_rel(c[k], a[k]) for k in a}
    if any(dist[k] > spread[k] for k in a):  # bit-equal where spread is 0
        raise AssertionError(f"29b restart: {dist} beyond {spread}")
    log(f"[29b restart] load_state(2) at t = {t_load:g} s, run on to "
        f"{r.simulation_time:g} s: max|diff|/max {dist}; a second "
        f"uninterrupted run {spread}")


def profile_io():
    """The profiler's view of one step of 29b's case (3.2 km, f32, no I/O)
    after a warm-up step, from a fresh process (``python3 chip_smoke.py
    profile_io``, started in phase 21's block)."""
    import tempfile

    phase_device()
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_profile_")
    s, uf, _ = fine_solver(dev, tmp, False)
    device_rows(lambda: torch.ones(8, device=dev) + 1)  # profiler warm-up
    timed_steps(s, 1, uf)
    uf(s.simulation_time + s.dt)
    st = s._get_state()
    args = (s.simulation_time, st, s._gather_swe_fields(),
            s._gather_tracer_extra(st), s._gather_bnd("shallow_water"),
            s._gather_bnd("tracer"))
    torch.cuda.synchronize()
    rows = device_rows(lambda: s._advance(*args))
    shutil_rmtree(tmp)
    if not rows:
        raise RuntimeError("the profiler saw no device kernel in 29b's step")
    hand = {k: (sum(c for _, c, key in rows if f"{k}_kernel" in key),
                sum(us for us, _, key in rows if f"{k}_kernel" in key) / 1e3)
            for k in ("ring_mv", "block_diag_mv")}
    tag = "[29b profile]"
    log(f"{tag} one step (the coupled advance) of the North Sea at "
        f"{NS_FINE_KM:g} km ({s.mesh2d.nc}"
        f" cells, f32, DIRK22, no I/O): {sum(r[1] for r in rows)} device "
        f"kernels, device busy {sum(r[0] for r in rows) / 1e3:.3f} ms; hand "
        f"kernels (launches, device ms) {hand}; top by device time:")
    for us, cnt, key in rows[:5]:
        log(f"{tag}   {us / 1e3:8.3f} ms  x{cnt:<5d} {key[:90]}")


def north_sea_kernel_shapes():
    """The ring kernels at the North Sea's own ring table (3.2 km: an
    unstructured mesh whose 883 boundary facets leave mirror slots)."""
    coords, cells, markers, _ = north_sea_mesh_arrays(NS_FINE_KM)
    mesh = Mesh2d(coords, cells, boundary_markers=markers,
                  device=torch.device("cuda"), dtype=torch.float64)
    nb = int(mesh.facet_is_boundary_np.sum())
    return (f"nc={mesh.nc} (North Sea {NS_FINE_KM:g} km, {nb} boundary "
            "facets)", phase_kernel_ring(0, 0, False, mesh))


def checkpoint2d_solver(device, outdir, t_end):
    """tests/test_checkpoint.py's 2D case (10x2, CN, f64)."""
    lx, ly = 40e3, 2e3
    mesh = RectangleMesh(10, 2, lx, ly, device=device, dtype=torch.float64)
    P1 = FunctionSpace(mesh, "CG", 1)
    s = FlowSolver2d(mesh, Function(P1).assign(20.0))
    o = s.options
    o.timestep = 50.0
    o.simulation_export_time = 200.0
    o.simulation_end_time = t_end
    o.swe_timestepper_type = "CrankNicolson"
    o.output_directory = outdir
    o.fields_to_export = []
    o.fields_to_export_hdf5 = ["elev_2d", "uv_2d"]
    s.assign_initial_conditions(elev=Function(P1).interpolate(
        lambda x, y: torch.exp(-(((x - lx / 2) / 6000.0) ** 2))))
    return s


def checkpoint3d_solver(device, outdir, t_end, exports=True):
    """tests/test_checkpoint.py's 3D case (8x2 x 4 layers, f64), the VTK
    series on, and with ``exports`` the 3D callbacks of
    tests/test_solver3d.py's callback case."""
    from thetis_tpu_torch.model.callback import (TimeSeriesCallback3D,
                                                 TransectCallback,
                                                 VerticalProfileCallback)

    lx = 20e3
    mesh = RectangleMesh(8, 2, lx, 4e3, device=device, dtype=torch.float64)
    P1 = FunctionSpace(mesh, "CG", 1)
    s = FlowSolver(mesh, Function(P1).assign(20.0), 4)
    o = s.options
    o.timestep = 30.0
    o.simulation_export_time = 300.0
    o.simulation_end_time = t_end
    o.output_directory = outdir
    s.initialize()
    drop_hdf5(s)
    s.assign_initial_conditions(
        elev=Function(P1).interpolate(
            lambda x, y: 0.4 * torch.exp(-(((x - lx / 2) / 3e3) ** 2))),
        temp=Function(FunctionSpace(mesh, "DG", 1)).interpolate(
            lambda x, y: 10.0 + 2.0 * x / lx).data, salt=35.0)
    cbs = []
    if exports:
        cbs = [VerticalProfileCallback(s, ["temp_3d", "uv_3d"], 10e3, 2e3,
                                       "mid", append_to_log=False),
               TransectCallback(s, ["temp_3d"], [5e3, 10e3, 15e3],
                                [2e3] * 3, "axis", append_to_log=False),
               TimeSeriesCallback3D(s, ["uv_3d"], 7e3, 1e3, -5.0, "sta",
                                    append_to_log=False)]
        for cb in cbs:
            s.add_callback(cb)
    return s, cbs


def phase_io_checks(smi, gpu=None):
    """Phase 29 (c, d), f64, after phase 21's block: the I/O paths on the
    card (``gpu``) against the CPU, the HDF5 checkpoint cases where h5py
    is installed, and ERA5 forcing set into the card's fields."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_checks_")
    devs = (("gpu", gpu or torch.device("cuda")), ("cpu", torch.device("cpu")))
    # (c) one step of the North Sea at 40 km, GPU against CPU, stations too
    out = {}
    for key, dv in devs:
        s, uf, st = north_sea_solver(dv, torch.float64,
                                     os.path.join(tmp, f"ns_{key}"),
                                     steps=1, exports=False)
        s.iterate(update_forcings=uf)
        out[key] = (s._get_state(), {k: torch.as_tensor(v()[0])
                                     for k, v in st.items()})
    errs = compare("29c north sea", out["gpu"][0], out["cpu"][0],
                   PARITY_RTOL)
    serr = compare("29c stations", out["gpu"][1], out["cpu"][1], PARITY_RTOL)
    log(f"[29c north sea parity] 40 km, f64, one DIRK22 step with the TPXO "
        f"boundary: GPU against CPU max|diff|/max {errs}; stations {serr} "
        f"<= {PARITY_RTOL:g}: ok")
    # (c) the 3D case with its VTK series and 3D callbacks (tridiag)
    res = {}
    for key, dv in devs:
        s, cbs = checkpoint3d_solver(dv, os.path.join(tmp, f"3d_{key}"),
                                     600.0)
        reset_counts()
        s.iterate()
        n = counts()
        res[key] = (s._get_state(), [torch.as_tensor(np.concatenate(
            [np.ravel(v) for v in cb()])) for cb in cbs], n,
            export_files(s.options.output_directory))
    if res["gpu"][2]["tridiag"] < 1 and devs[0][1].type == "cuda":
        raise AssertionError(f"29c 3D: no tridiag launch {res['gpu'][2]}")
    if res["gpu"][3] != res["cpu"][3]:
        raise AssertionError(f"29c 3D: export files {res['gpu'][3]} vs "
                             f"{res['cpu'][3]}")
    errs = compare("29c 3D", res["gpu"][0], res["cpu"][0], PARITY_RTOL)
    cerr = compare("29c 3D callbacks", dict(enumerate(res["gpu"][1])),
                   dict(enumerate(res["cpu"][1])), PARITY_RTOL)
    log(f"[29c 3D exports] tests/test_checkpoint.py's 3D case, 20 steps "
        f"with the VTK series and the profile, transect and station "
        f"callbacks at 3 exports: tridiag {res['gpu'][2]['tridiag']} "
        f"launches; files {res['gpu'][3]} as the CPU's; GPU against CPU "
        f"max|diff|/max {errs}; callbacks {cerr} <= {PARITY_RTOL:g}: ok")
    if have_h5py():
        io_checkpoint_cases(tmp, devs)
    else:
        log("[29c checkpoints] not run: h5py is not installed (the 2D and 3D"
            " restarts on the card, card -> CPU and CPU -> card)")
    io_forcing_check(tmp, devs)
    shutil_rmtree(tmp)


def io_checkpoint_cases(tmp, devs):
    """29c's checkpoint cases (h5py only): the 2D case restarted on the
    card against its uninterrupted run, a card checkpoint continued on
    the CPU and the reverse, and the 3D case restarted on the card."""
    gpu = dict(devs)["gpu"]

    def full_and_restart(make, dv, tag, t_mid, t_end):
        d = os.path.join(tmp, tag)
        a = make(dv, d + "_full", t_end)
        a.iterate()
        make(dv, d, t_mid).iterate()
        b = make(dv, d, t_end)
        b.load_state(2)
        b.iterate()
        return a, b

    def make3d(dv, d, t):
        return checkpoint3d_solver(dv, d, t, exports=False)[0]

    for tag, make, t_mid, t_end in (("2d", checkpoint2d_solver, 400.0, 800.0),
                                    ("3d", make3d, 600.0, 1200.0)):
        a, b = full_and_restart(make, gpu, tag, t_mid, t_end)
        sa, sb = a._get_state(), b._get_state()
        dist = {k: max_rel(sb[k], sa[k]) for k in sa}
        if max(dist.values()) > 1e-12:
            raise AssertionError(f"29c {tag} restart on the card: {dist}")
        same = all(torch.equal(sa[k], sb[k]) for k in sa)
        log(f"[29c {tag} checkpoint] restart at export 2 on the card against"
            f" the uninterrupted run: max|diff|/max {dist} <= 1e-12 "
            f"({'bit-equal' if same else 'not bit-equal'}): ok")
    ref = {k: checkpoint2d_solver(dv, os.path.join(tmp, f"x_{k}"), 800.0)
           for k, dv in devs}
    for s in ref.values():
        s.iterate()
    for src, dst in (("gpu", "cpu"), ("cpu", "gpu")):
        c = checkpoint2d_solver(dict(devs)[dst], os.path.join(tmp, f"y_{dst}"),
                                800.0)
        c.load_state(2, outputdir=ref[src].options.output_directory)
        c.iterate()
        errs = compare(f"29c {src} -> {dst}", c._get_state(),
                       {k: v.cpu() for k, v in ref[src]._get_state().items()},
                       PARITY_RTOL)
        log(f"[29c checkpoint {src} -> {dst}] export 2 written on the {src} "
            f"and continued on the {dst} against the {src}'s own "
            f"continuation: max|diff|/max {errs} <= {PARITY_RTOL:g}: ok")


def write_era5(path):
    """A synthetic ERA5-format netCDF3 file: u10/v10/msl over descending
    latitude, a ``valid_time`` axis of two hourly records."""
    from scipy.io import netcdf_file

    LAT, LON = np.meshgrid(ERA5_LAT, ERA5_LON, indexing="ij")
    with netcdf_file(path, "w") as f:
        f.createDimension("valid_time", 2)
        f.createDimension("latitude", len(ERA5_LAT))
        f.createDimension("longitude", len(ERA5_LON))
        tv = f.createVariable("valid_time", "d", ("valid_time",))
        tv[:] = [0.0, 3600.0]
        tv._attributes["units"] = b"seconds since 2022-01-01 00:00:00"
        f.createVariable("longitude", "d", ("longitude",))[:] = ERA5_LON
        f.createVariable("latitude", "d", ("latitude",))[:] = ERA5_LAT
        dims = ("valid_time", "latitude", "longitude")
        for name, grid in (
                ("u10", 8.0 + 2.0 * np.sin(np.deg2rad(4 * LON))),
                ("v10", -3.0 + 0.2 * (LAT - 55.0)),
                ("msl", 101000.0 + 300.0 * np.cos(np.deg2rad(6 * LAT)))):
            f.createVariable(name, "d", dims)[:] = np.stack([grid, 1.1 * grid])


def io_forcing_check(tmp, devs):
    """29d: ERA5 wind stress and pressure set into the card's fields (the
    host's numpy values, to 1e-12), then one North Sea step with them on
    the card against the CPU."""
    import datetime

    from thetis_tpu_torch.model.forcing_adapters import ERA5Interpolator
    from thetis_tpu_torch.utils.coordsys import UTMCoordinateSystem
    from thetis_tpu_torch.utils.timezone import FixedTimeZone

    path = os.path.join(tmp, "era5_000.nc")
    write_era5(path)
    init = datetime.datetime(*NS_INIT_DATE, tzinfo=FixedTimeZone(0, "UTC"))
    out, errs = {}, []
    for key, dv in devs:
        s, uf, _ = north_sea_solver(dv, torch.float64,
                                    os.path.join(tmp, f"era5_{key}"),
                                    steps=1, exports=False)
        mesh = s.mesh2d
        lon, lat = UTMCoordinateSystem(utm_zone=30).get_mesh_lonlat_function(
            mesh)
        wind = Function(FunctionSpace(mesh, "CG", 1, dim=2), name="wind")
        pres = Function(FunctionSpace(mesh, "CG", 1), name="pressure")
        era = ERA5Interpolator(np.stack([lon, lat], axis=-1),
                               os.path.join(tmp, "era5_*.nc"), init,
                               wind_stress_field=wind,
                               atm_pressure_field=pres)
        vals = era.set_fields(1800.0)
        for f, name in ((wind, "wind_stress"),
                        (pres, "atmospheric_pressure")):
            if f.data.device.type != dv.type or f.data.dtype != torch.float64:
                raise AssertionError(f"29d: {name} on {f.data.device}")
            ref = torch.as_tensor(vals[name])
            err = float((f.data.cpu() - ref).abs().max()) / float(
                ref.abs().max())
            if err > 1e-12:
                raise AssertionError(f"29d: {name} {err:.2e} off the host's")
            errs.append(f"{dv.type} {name} {err:.1e}")
        s.options.wind_stress = wind
        s.options.atmospheric_pressure = pres
        s.iterate(update_forcings=uf)
        out[key] = s._get_state()
    perr = compare("29d era5 step", out["gpu"], out["cpu"], PARITY_RTOL)
    log(f"[29d forcing] ERA5 (netCDF3, descending latitude, valid_time) "
        f"wind stress and pressure at t = 1800 s into CG1 fields: "
        f"max|field - host numpy|/max {', '.join(errs)} <= 1e-12; one North "
        f"Sea step with them, GPU against CPU max|diff|/max {perr} <= "
        f"{PARITY_RTOL:g}: ok")


# -- phase 30: the repo's demos and examples through the port ------------
#: modules that scripts import from their own directory; not scripts
SCRIPT_HELPERS = ("demos/north_sea_mesh.py",
                  "examples/baroclinic_eddies/diagnostics.py",
                  "examples/tohoku_inversion/okada.py",
                  "examples/tohoku_inversion/sources.py")
#: the only difference between a script's run through the port and the
#: reference's own run: each ``.py`` of demos/ and examples/ is rewritten
#: by rows 1-5 (:class:`ToPort`, on its syntax tree); rows 6-7 hold while
#: the script runs
REWRITE_TABLE = (
    ("import thetis_tpu[.m] / from thetis_tpu[.m] import ...",
     "the same names from thetis_tpu_torch[.m]"),
    ('import jax.numpy as jnp; __import__("jax.numpy", ...)',
     "jnp_torch (jnp_module): torch functions that take tensors, numpy "
     "arrays and numbers and give tensors on the run's device and dtype"),
    ("import jax", "jax_torch: jit(f) -> f, config.update(...) -> nothing, "
     "numpy -> jnp_torch"),
    ("x.at[i].set(v)", "jnp_torch.at_set(x, i, v): x with x[i] = v, "
     "out of place"),
    ("x.astype(t)", "jnp_torch.astype(x, t): numpy's astype, or a "
     "tensor's .to"),
    ("numpy given a tensor (np.asarray, np.array, a ufunc, an operator "
     "beside an ndarray)", "a host copy of it, detached (Tensor.__array__ "
     "while the script runs), as numpy reads the reference's device arrays"),
    ("a solver's exporters, where h5py is not installed",
     "the same without the HDF5 checkpoints (as phase 29 runs the North "
     "Sea demo): the VTK series alone"),
)
SHIMS = {"jax.numpy": "_jnp_torch", "jax": "_jax_torch"}


class ToPort(ast.NodeTransformer):
    """Rows 1-5 of :data:`REWRITE_TABLE` on a script's syntax tree."""

    @staticmethod
    def _shim(attr, *args):
        return ast.Call(ast.Attribute(ast.Name("_jnp_torch", ast.Load()),
                                      attr, ast.Load()), list(args), [])

    def visit_Module(self, node):
        self.generic_visit(node)
        # the helper functions of the table's rows 4-5
        node.body.insert(0, ast.Import([ast.alias("_jnp_torch")]))
        return node

    def visit_Import(self, node):
        for a in node.names:
            if a.name in SHIMS:
                a.asname, a.name = a.asname or a.name, SHIMS[a.name]
            elif a.name.split(".")[0] == "thetis_tpu":
                if a.asname is None and "." in a.name:
                    raise ValueError(f"import {a.name} binds thetis_tpu")
                a.asname = a.asname or "thetis_tpu"
                a.name = "thetis_tpu_torch" + a.name[len("thetis_tpu"):]
        return node

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if mod.split(".")[0] == "thetis_tpu" and node.level == 0:
            node.module = "thetis_tpu_torch" + mod[len("thetis_tpu"):]
        elif mod.split(".")[0] == "jax":
            raise ValueError(f"from {mod} import ...: not in the table")
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        if (isinstance(f, ast.Name) and f.id == "__import__" and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value in SHIMS):
            node.args = [ast.Constant(SHIMS[node.args[0].value])]
            node.keywords = []
        elif (isinstance(f, ast.Attribute) and f.attr == "set"
              and isinstance(f.value, ast.Subscript)
              and isinstance(f.value.value, ast.Attribute)
              and f.value.value.attr == "at"):
            return self._shim("at_set", f.value.value.value,
                              f.value.slice, *node.args)
        elif isinstance(f, ast.Attribute) and f.attr == "astype":
            return self._shim("astype", f.value, *node.args)
        return node


def translate(source):
    """A script's source rewritten by :data:`REWRITE_TABLE`."""
    tree = ToPort().visit(ast.parse(source))
    return ast.unparse(ast.fix_missing_locations(tree))


def jnp_module(device, dtype):
    """jax.numpy as the scripts use it, in torch: each function takes
    tensors, numpy arrays and numbers and gives tensors on ``device``,
    floating data in ``dtype`` (integers and booleans keep their kind)."""
    device = torch.device(device)
    m = types.ModuleType("_jnp_torch")

    def kind(t):
        """A numpy, Python or torch dtype as the run's torch dtype."""
        if isinstance(t, torch.dtype):
            return t
        k = np.dtype(t).kind
        return dtype if k in "fc" else torch.bool if k == "b" else torch.int64

    def asarray(x, dtype=None):
        if isinstance(x, (list, tuple)) and any(
                isinstance(e, torch.Tensor) for e in x):
            t = torch.stack([asarray(e) for e in x])
        elif isinstance(x, torch.Tensor):
            t = x.to(device)
        else:
            a = np.asarray(x)
            t = torch.as_tensor(a, dtype=kind(a.dtype), device=device)
        return t if dtype is None else t.to(kind(dtype))

    def shaped(shape):
        return tuple(shape) if isinstance(shape, (tuple, list)) else (shape,)

    def full(shape, value, dtype=None):
        return torch.full(shaped(shape), float(value), device=device,
                          dtype=kind(dtype or float))

    def zeros(shape, dtype=None):
        return full(shape, 0.0, dtype)

    def full_like(a, value, dtype=None):
        a = asarray(a)
        return torch.full_like(a, float(value),
                               dtype=a.dtype if dtype is None
                               else kind(dtype))

    def stack(arrays, axis=0):
        return torch.stack([asarray(a) for a in arrays], dim=axis)

    def broadcast_to(x, shape):
        # jax arrays are immutable: a copy, not an expanded view
        return torch.broadcast_to(asarray(x), shaped(shape)).contiguous()

    def where(cond, a, b):
        return torch.where(asarray(cond), asarray(a), asarray(b))

    def einsum(spec, *ops):
        return torch.einsum(spec, *[asarray(o) for o in ops])

    def at_set(x, index, value):
        index = index if isinstance(index, tuple) else (index,)
        return asarray(x).index_put(tuple(asarray(i) for i in index),
                                    asarray(value))

    def astype(x, t):
        if isinstance(x, torch.Tensor):
            return x.to(kind(t))
        return x.astype(t)

    m.__dict__.update(
        asarray=asarray, array=asarray, full=full, zeros=zeros,
        full_like=full_like, stack=stack, broadcast_to=broadcast_to,
        where=where, einsum=einsum, at_set=at_set, astype=astype,
        pi=math.pi)
    for name, fn in (("sin", torch.sin), ("cos", torch.cos),
                     ("sqrt", torch.sqrt), ("log", torch.log),
                     ("exp", torch.exp), ("arctan", torch.arctan),
                     ("abs", torch.abs)):
        m.__dict__[name] = functools.partial(
            lambda fn, x: fn(asarray(x)), fn)
    return m


def jax_module(jnp):
    """The three names of ``jax`` the scripts use: ``jit`` (the function
    itself: the port runs eagerly), ``config.update`` (nothing to set)
    and ``numpy``."""
    m = types.ModuleType("_jax_torch")
    m.jit = lambda f, *a, **k: f
    m.config = SimpleNamespace(update=lambda *a, **k: None)
    m.numpy = jnp
    return m


def example_scripts(root=None):
    """The demos and examples, as paths relative to the repository, less
    :data:`SCRIPT_HELPERS`."""
    root = root or os.path.dirname(os.path.abspath(__file__))
    found = (glob.glob(os.path.join(root, "demos", "*.py"))
             + glob.glob(os.path.join(root, "examples", "**", "*.py"),
                         recursive=True))
    rel = (os.path.relpath(p, root).replace(os.sep, "/") for p in found)
    return sorted(p for p in rel if p not in SCRIPT_HELPERS)


def copy_scripts(dest, rewrite=translate):
    """Every ``.py`` of demos/ and examples/ under ``dest``, the layout
    kept (``north_sea.py`` finds ``../../demos``), each passed through
    ``rewrite`` (None: as it is)."""
    root = os.path.dirname(os.path.abspath(__file__))
    for sub in ("demos", "examples"):
        for d, _, files in os.walk(os.path.join(root, sub)):
            for f in files:
                if not f.endswith(".py"):
                    continue
                src = os.path.join(d, f)
                out = os.path.join(dest, os.path.relpath(src, root))
                os.makedirs(os.path.dirname(out), exist_ok=True)
                with open(src) as fi:
                    text = fi.read()
                with open(out, "w") as fo:
                    fo.write(text if rewrite is None else rewrite(text))


@contextlib.contextmanager
def script_process_state(path):
    """A script's run as ``python <path>`` makes it: its directory the
    working directory, its argv, ``THETIS_REGRESSION_TEST=1``, and its
    helper modules imported afresh from its tree; all put back after."""
    helpers = [os.path.splitext(os.path.basename(h))[0]
               for h in SCRIPT_HELPERS]
    saved = (os.getcwd(), list(sys.path), sys.argv,
             os.environ.get("THETIS_REGRESSION_TEST"),
             {h: sys.modules.pop(h) for h in helpers if h in sys.modules})
    os.chdir(os.path.dirname(path))
    sys.argv = [path]
    os.environ["THETIS_REGRESSION_TEST"] = "1"
    try:
        yield
    finally:
        cwd, sys.path[:], sys.argv, flag, mods = saved
        os.chdir(cwd)
        if flag is None:
            os.environ.pop("THETIS_REGRESSION_TEST", None)
        else:
            os.environ["THETIS_REGRESSION_TEST"] = flag
        for h in helpers:
            sys.modules.pop(h, None)
        sys.modules.update(mods)


@contextlib.contextmanager
def numpy_reads_tensors():
    """Row 6 of :data:`REWRITE_TABLE`: numpy reads a tensor on any device
    (a CUDA tensor's own ``__array__`` raises), as it reads the
    reference's arrays, through a detached host copy."""
    own = torch.Tensor.__array__

    def host_array(self, dtype=None, copy=None):
        a = self.detach().cpu().numpy()
        return a if dtype is None else a.astype(dtype, copy=False)

    torch.Tensor.__array__ = host_array
    try:
        yield
    finally:
        torch.Tensor.__array__ = own


@contextlib.contextmanager
def exporters_without_h5py():
    """Row 7 of :data:`REWRITE_TABLE`: where h5py is not installed (the
    card's machine), the solvers' exporters leave out the HDF5
    checkpoints, which cannot be written there."""
    from thetis_tpu_torch.model import flowsolver2d, flowsolver3d

    own = flowsolver2d.solver_exporters

    def without_hdf5(*args):
        exporters = own(*args)
        exporters.pop("hdf5", None)
        return exporters

    mods = (flowsolver2d, flowsolver3d)
    if not have_h5py():
        for m in mods:
            m.solver_exporters = without_hdf5
    try:
        yield
    finally:
        for m in mods:
            m.solver_exporters = own


@contextlib.contextmanager
def mesh_defaults(device, dtype):
    """Every mesh constructor's default device and dtype set to the run's
    (the scripts pass neither, as the reference takes neither): the
    caller asks for the device; the port's own default is the card."""
    from thetis_tpu_torch.mesh import generation, gmsh, mesh2d, sphere

    fns = [mesh2d.Mesh2d.__init__, sphere.SphereMesh.__init__,
           sphere.IcosahedralSphereMesh, gmsh.read_msh, gmsh.Mesh]
    fns += [getattr(generation, n) for n in generation.__all__]
    saved = [dict(f.__kwdefaults__) for f in fns]
    for f in fns:
        f.__kwdefaults__.update(device=torch.device(device), dtype=dtype)
    try:
        yield
    finally:
        for f, kw in zip(fns, saved):
            f.__kwdefaults__ = kw


def exec_script(path, namespace=None):
    """Run the file ``path`` as ``__main__`` in ``namespace`` (a new dict
    by default), which keeps the globals the script reached if it
    raises; returns the namespace."""
    ns = {} if namespace is None else namespace
    ns.update(__name__="__main__", __file__=path)
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    exec(code, ns)
    return ns


@contextlib.contextmanager
def solvers_made(classes, made):
    """Append to the list ``made`` every instance of ``classes`` (each
    defines its ``__init__``) made while the block runs: a script's
    solvers, its functions' own among them."""
    inits = [(c, c.__init__) for c in classes]
    for c, init in inits:
        def record(self, *a, _init=init, **k):
            _init(self, *a, **k)
            made.append(self)

        c.__init__ = functools.wraps(init)(record)
    try:
        yield made
    finally:
        for c, init in inits:
            c.__init__ = init


@contextlib.contextmanager
def jax_shims(device, dtype):
    """Rows 2-3 of :data:`REWRITE_TABLE` importable while the block runs:
    ``_jnp_torch`` (:func:`jnp_module`) and ``_jax_torch``."""
    saved = {k: sys.modules.get(k) for k in SHIMS.values()}
    jnp = jnp_module(device, dtype)
    sys.modules.update(_jnp_torch=jnp, _jax_torch=jax_module(jnp))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def run_script(path, device, dtype=torch.float64, namespace=None,
               solvers=None):
    """Run the script ``path`` (relative to the repository) through the
    port on ``device`` in ``dtype``, as ``__main__``, from a copy of
    demos/ and examples/ rewritten by :data:`REWRITE_TABLE` in a new
    temporary directory, its globals in ``namespace`` and the solvers it
    makes in the list ``solvers`` (new ones by default; given ones keep
    what the script reached if it raises).  Returns its namespace, its
    solvers, its seconds and the kernel launches it made."""
    import tempfile

    tree = tempfile.mkdtemp(prefix="thetis_scripts_")
    solvers = [] if solvers is None else solvers
    try:
        copy_scripts(tree)
        full = os.path.join(tree, path)
        with (jax_shims(device, dtype), script_process_state(full),
              mesh_defaults(device, dtype), numpy_reads_tensors(),
              exporters_without_h5py(),
              solvers_made((FlowSolver2d, FlowSolver), solvers)):
            reset_counts()
            t0 = time.perf_counter()
            ns = exec_script(full, namespace)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = counts()
    finally:
        shutil_rmtree(tree)
    return SimpleNamespace(namespace=ns, solvers=solvers, seconds=seconds,
                           launches=launches)


#: scripts that the reference itself fails at regression size; the port
#: fails them the same way (ROADMAP C)
LOCK_EXCHANGE = "examples/lockExchange/lockExchange.py"
MEANDER = "examples/sediment_meander_2d/meander_example.py"
#: phase 30's GPU-against-CPU scripts: one 2D, one 3D (f64), each of
#: whose runs on the card launches the ring kernels
EXAMPLES_PARITY = ("examples/waveEq2d/channel2d_waveEq.py",
                   "examples/baroclinic_channel/baroclinic_channel.py")
EXAMPLES_PARITY_RTOL = 1e-10
EXAMPLES_AT_ONCE = 8                    # processes at once: the host's cores
#: scripts that an earlier phase runs at the same size, each written for
#: the port (15, 22a, 23a, 24a, 27a, 28c, 29a); the whole script leaves
#: them out of phase 30 to stay inside its time (``python3 chip_smoke.py
#: examples`` runs them too)
EXAMPLES_RUN_EARLIER = (
    "examples/rhineROFI/rhineROFI.py",
    "examples/sediment_trench_2d/trench_example.py",
    "examples/discrete_turbines/tidal_array.py",
    "examples/nonhydrostatic_cases/solitary_wave_nh/solitary_wave_2d.py",
    "examples/williamson2/williamson2.py",
    "examples/channel_inversion/inverse_problem.py",
    "demos/demo_2d_north_sea.py")
#: the scripts that take longest on the CPU (over ~40 s), started first
EXAMPLES_LONG = ("examples/discrete_turbines/tidal_array.py",
                 "examples/reaction/gray_scott.py",
                 "examples/tohoku_inversion/inverse_problem.py",
                 "examples/headland_inversion/inverse_problem.py",
                 "examples/nonhydrostatic_cases/solitary_wave_nh/"
                 "solitary_wave_2d.py",
                 "examples/sediment_trench_2d/trench_example.py",
                 "examples/channel_inversion/inverse_problem.py",
                 "examples/north_sea/north_sea.py",
                 "examples/tidalfarm/tidalfarm.py", "examples/dome/dome.py")


def fails_as_the_reference(path, exc, ns):
    """Whether ``exc``, raised by the script ``path`` that left the
    globals ``ns``, is the reference's own failure of that script at
    regression size: the lock exchange's cold bottom front stays at the
    midline (its last assert); the meander's sediment model takes the
    horizontal viscosity (5e-2 m^2/s) as the water's, which puts its
    grains' dimensionless diameter under 1."""
    if path == LOCK_EXCHANGE:
        return (type(exc) is AssertionError
                and ns.get("front_x") == ns.get("lx", 0.0) / 2)
    if path == MEANDER:
        return (type(exc) is ValueError
                and str(exc) == "dstar value less than 1")
    return False


def solver_fields(s):
    """A solver's fields as host arrays, by name."""
    return {k: f.data.detach().cpu().numpy() for k, f in s.fields.items()
            if isinstance(getattr(f, "data", None), torch.Tensor)}


def example_case(path, dev=torch.device("cuda")):
    """Phase 30: one script through the port on the card, f64, in a
    process of its own (``python3 chip_smoke.py example <path>``): its
    own checks (or the reference's own failure), a 3D script's kernels
    (the ring kernels, and the tridiagonal kernel exactly where its
    vertical solves are implicit), and one result line.  The process
    yields the host's cores to the f64 checks it runs beside
    (``os.nice``)."""
    if not torch.cuda.is_available():
        sys.exit(1)
    os.nice(10)
    ns, solvers = {}, []
    t0 = time.perf_counter()
    try:
        run_script(path, dev, namespace=ns, solvers=solvers)
        outcome = "its checks hold"
    except Exception as e:  # the reference's own failure, or a fault
        if not fails_as_the_reference(path, e, ns):
            raise
        outcome = f"fails as the reference does: {type(e).__name__} {e}"
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n = counts()
    three_d = [s for s in solvers if isinstance(s, FlowSolver)]
    # the 3D barotropic CN runs the ring kernels; the vertical solves
    # are implicit (the tridiagonal kernel) where the script asks
    implicit = any(s.options.use_implicit_vertical_diffusion
                   for s in three_d)
    if three_d and not (n["ring_mv"] > 0 and n["block_diag_mv"] > 0
                        and (n["tridiag"] > 0) == implicit):
        raise AssertionError(f"{path}: a 3D script (implicit vertical "
                             f"solves: {implicit}) launched {n}")
    steps = sum(s.iteration for s in solvers) if solvers else None
    log(f"[30 example] {path}: {seconds:.2f} s, steps "
        f"{'-' if steps is None else steps}, ring_mv {n['ring_mv']}, "
        f"block_diag_mv {n['block_diag_mv']}, tridiag {n['tridiag']}; "
        f"{outcome}")
    log("[30 result] " + json.dumps({"script": path, "seconds": seconds,
                                     "steps": steps, "launches": n,
                                     "three_d": bool(three_d)}))


def example_parity(path, gpu=torch.device("cuda")):
    """Phase 30's GPU-against-CPU check (``python3 chip_smoke.py
    example_parity <path>``): the script through the port on the card and
    on the CPU, f64; the card's run must launch the ring kernels, and
    every field of its solver must agree to :data:`EXAMPLES_PARITY_RTOL`
    of the field's largest value (at :func:`example_case`'s priority)."""
    if not torch.cuda.is_available():
        sys.exit(1)
    os.nice(10)
    got = []
    for dev in (gpu, torch.device("cpu")):
        run = run_script(path, dev)
        (s,) = run.solvers
        got.append(solver_fields(s))
        if dev == gpu:
            n = run.launches
    if not (n["ring_mv"] > 0 and n["block_diag_mv"] > 0):
        raise AssertionError(f"{path}: the card's run launched {n}")
    worst = 0.0
    for k, want in got[1].items():
        scale = max(float(np.abs(want).max()), 1e-300)
        err = float(np.abs(got[0][k] - want).max()) / scale
        if not err <= EXAMPLES_PARITY_RTOL:
            raise AssertionError(f"{path}: {k} GPU against CPU {err}")
        worst = max(worst, err)
    log(f"[30 parity] {path}, f64: the card's run launched ring_mv "
        f"{n['ring_mv']}, block_diag_mv {n['block_diag_mv']}, tridiag "
        f"{n['tridiag']}; {len(got[1])} fields ({', '.join(sorted(got[1]))})"
        f", GPU against CPU max|diff|/max {worst:.2e} <= "
        f"{EXAMPLES_PARITY_RTOL:g}")


def interpolate_checks(dev=torch.device("cuda")):
    """``Function.interpolate`` on the card: a callable that closes over
    a tensor on the card gets the coordinates there; a numpy callable
    (the tidal array's sponge) and one whose numpy results meet the
    card's tensors while numpy reads tensors (row 6 of
    :data:`REWRITE_TABLE`, as in ``demos/demo_2d_tracer.py``) get them on
    the host; each against the same callable on the CPU (f64, to 1e-14
    of scale)."""
    out = {}
    for d in (dev, torch.device("cpu")):
        mesh = RectangleMesh(8, 4, 2e3, 1e3, device=d, dtype=torch.float64)
        space = FunctionSpace(mesh, "DG", 1)
        h0 = Function(space).assign(2.0).data
        seen = []

        def on_device(x, y):
            seen.append(x.device)
            return h0 * torch.exp(-x / 1e3) + y / 1e3

        def sponge(x, y):
            return np.where(x <= 1e3, 51.0 - x / 1e2, 1.0 + 0.0 * y)

        def mixed(x, y):
            return y / 1e3 + np.sin(x / 1e3)

        out[d.type] = [Function(space).interpolate(f).data
                       for f in (on_device, sponge)]
        with numpy_reads_tensors():
            out[d.type].append(Function(space).interpolate(mixed).data)
        if seen != [h0.device]:
            raise AssertionError(f"interpolate on {d}: coordinates on "
                                 f"{seen}")
    for a, b in zip(out[dev.type], out["cpu"]):
        if a.device.type != dev.type or max_rel(a.cpu(), b) > 1e-14:
            raise AssertionError("interpolate: the card against the CPU")
    log("[30 interpolate] a callable of card tensors ran on the card, a "
        "numpy callable and one mixing numpy with torch on host "
        "coordinates; each equals the CPU's")


def function_api_checks(dev=torch.device("cuda")):
    """The user API of ``Function`` on the card: the same seeded dofs in a
    DG1 and a vector DG1 Function on ``dev`` and on the CPU (f64), every
    operator result a tensor on ``dev`` equal to the CPU's to 1e-14 of
    scale; a numpy operand lands on ``dev`` in the Function's dtype (f32
    on an f32 mesh); ``copy()`` on ``dev`` shares no memory with its
    original, whose dofs an in-place update of the copy leaves as they
    were."""
    rng = np.random.default_rng(15)
    a = {}
    out = {}
    worst = {}
    for dim in (1, 2):
        for d in (dev, torch.device("cpu")):
            mesh = RectangleMesh(8, 4, 2e3, 1e3, device=d,
                                 dtype=torch.float64)
            space = FunctionSpace(mesh, "DG", 1, dim=dim)
            if dim not in a:
                a[dim] = [rng.standard_normal(space.dof_shape())
                          for _ in range(3)]
            fd, gd, arr = a[dim]
            f = Function(space, name="f", data=fd)
            g = Function(space, name="g", data=gd)
            t = torch.as_tensor(arr, device=d)

            def field(x, y):
                s = torch.sin(x / 1e3) * y / 1e3
                return s if dim == 1 else torch.stack(
                    [s, torch.cos(y / 1e3)], -1)

            res = [f + g, 2.5 + f, f + t, t + f, f + arr, arr + f,
                   f - g, f - 2.5, 2.0 - f, t - f, f - arr, arr - f,
                   f * g, 3.0 * f, f * t, f * arr, arr * f,
                   f * np.float64(0.75), f.dat.data, f[0], f[1],
                   Function(space).project(field).data,
                   Function(space).project(arr).data]
            for r in res:
                if not isinstance(r, torch.Tensor) or r.device.type != \
                        d.type:
                    raise AssertionError(
                        f"Function API on {d}: {type(r)} on "
                        f"{getattr(r, 'device', None)}")
            c = f.copy()
            before = f.data.clone()
            c.data.add_(1.0)
            if (c.data.data_ptr() == f.data.data_ptr()
                    or not torch.equal(f.data, before)
                    or c.data.device.type != d.type
                    or not torch.equal(c.data, before + 1.0)):
                raise AssertionError(f"Function.copy on {d} is aliased")
            res.append(c.data)
            out[(dim, d.type)] = res
        worst[dim] = max(max_rel(x.cpu(), y) for x, y in
                         zip(out[(dim, dev.type)], out[(dim, "cpu")]))
        if worst[dim] > 1e-14:
            raise AssertionError(f"Function API, dim {dim}: the card "
                                 f"against the CPU {worst[dim]:.3e}")
    mesh32 = RectangleMesh(8, 4, 2e3, 1e3, device=dev, dtype=torch.float32)
    f32 = Function(FunctionSpace(mesh32, "DG", 1), data=a[1][0])
    for r in (f32 + a[1][2], a[1][2] - f32, f32 * a[1][2]):
        if r.dtype != torch.float32 or r.device.type != dev.type:
            raise AssertionError(f"a numpy operand gave {r.dtype} on "
                                 f"{r.device}")
    log(f"[30 function api] + - * both ways, indexing, dat, project and "
        f"copy on {dev.type} against the CPU, {len(out[(1, 'cpu')])} "
        f"results each, f64: scalar DG1 {worst[1]:.3e}, vector DG1 "
        f"{worst[2]:.3e} (bound 1e-14); numpy operands land on "
        f"{dev.type} in the Function's dtype; copy() shares no memory")


def example_modes(scripts):
    """Phase 30's processes: each script of ``scripts`` (the longest
    first) and the GPU-against-CPU scripts; logs the rewrite table."""
    log("[30 examples] the rewrite table, the only difference from the "
        "reference's own run (every .py of demos/ and examples/):")
    for k, (pattern, becomes) in enumerate(REWRITE_TABLE, 1):
        log(f"[30 examples]   ({k}) {pattern} -> {becomes}")
    ordered = sorted(scripts, key=lambda p: (p not in EXAMPLES_LONG, p))
    return ([["example", p] for p in ordered]
            + [["example_parity", p] for p in EXAMPLES_PARITY])


def examples_launches(lines, scripts, smi, seconds):
    """Phase 30's result from its processes' ``lines``: every script
    gave one; returns the launches of all the scripts (each process sets
    its counts to 0 just before its script)."""
    results = [json.loads(line[len("[30 result] "):]) for line in lines
               if line.startswith("[30 result] ")]
    if sorted(r["script"] for r in results) != sorted(scripts):
        raise RuntimeError("phase 30: a script gave no result")
    n = {k: sum(r["launches"][k] for r in results) for k in KERNELS}
    log(f"[30 examples] {len(results)} scripts "
        f"({sum(r['three_d'] for r in results)} 3D) on {smi}: "
        f"{sum(r['seconds'] for r in results):.1f} s of script time, "
        f"{seconds:.1f} s in all; launches {n}")
    return n


# -- phase 31: the partitioned path (thetis_tpu_torch.parallel) ----------
PAR_PARTS = 4                  # partitions, all on the one card
PAR_STEPS = 3                  # f32 timed steps (after one warm-up)
#: the reference's parity parameters: the 3D step's barotropic Krylov
#: (tests/test_parallel.py:335-336) and the assembled CN's (:242)
PAR_3D_PARAMS = dict(ksp_rtol=1e-13, ksp_max_it=192, gmres_restart=48)
PAR_CN_PARAMS = dict(ksp_rtol=1e-13, ksp_max_it=400, gmres_restart=40)
PAR_3D_RTOL = 1e-11            # test_parallel.py:373
PAR_CN_RTOL = 1e-10            # test_parallel.py:252, :296
#: packed [elev (3), u/v interleaved (6)] -> coarse fields eta, u, v (the
#: per-field coarse space FlowSolver2d builds)
PAR_COARSE_FIELDS = [0, 0, 0, 1, 2, 1, 2, 1, 2]


def to_striped(part, tree):
    """Global-order cell tensors -> the partition's striped-global order,
    on their device."""
    perm = torch.as_tensor(part.perm.astype(np.int64))
    return {k: v[perm.to(v.device)] for k, v in tree.items()}


def from_striped(part, tree):
    inv = torch.as_tensor(part.inv_perm.astype(np.int64))
    return {k: v[inv.to(v.device)] for k, v in tree.items()}


def max_rel_tree(ref, got):
    """Largest over the keys of max|got - ref| / max|ref|."""
    return max(float((got[k] - ref[k]).abs().max())
               / max(float(ref[k].abs().max()), 1e-30) for k in ref)


def parallel3d(dev, dtype, params=None):
    """The bench's 3D channel on the non-periodic 48x48 rectangle (the
    stripe partition refuses a periodic-x mesh), serial and split into
    PAR_PARTS partitions on ``dev``: ``(serial, sharded, partition,
    state, swe_fields)``, the state in global order."""
    from thetis_tpu_torch.parallel.sharded3d import ShardedFlowSolver3d
    from thetis_tpu_torch.parallel.submesh import HaloPartition

    opts = (None if params is None else
            dict(barotropic_solver_parameters=NewtonParameters(**params)))
    mesh = RectangleMesh(NX3, NY3, L3, L3, device=dev, dtype=dtype)
    ser, state, swe, _ = workload3d(dev, dtype, options=opts, mesh2d=mesh)
    cor = bench3d_coriolis(mesh)
    part = HaloPartition(mesh, PAR_PARTS, devices=[dev] * PAR_PARTS)
    sh3 = ShardedFlowSolver3d(part, lambda sm, d: bench3d_solver(
        sm, part.local_vertex_values(cor)[d], options=opts))
    return ser, sh3, part, state, swe


def parallel_cn(dev, dtype, coarse):
    """The bench's 2D CN (nc 102,400) serial and over PAR_PARTS
    partitions, both solving to PAR_CN_PARAMS; with ``coarse`` the
    per-field coarse correction built from the rest-state blocks.
    ``(mesh, serial stepper, sharded stepper, partition, sol, fields)``."""
    from thetis_tpu_torch.parallel.assembled_sharded import (
        ShardedAssembledCN)
    from thetis_tpu_torch.parallel.sharded import ShardedEquation
    from thetis_tpu_torch.parallel.submesh import HaloPartition
    from thetis_tpu_torch.solvers.assembled import CoarseCorrection
    from thetis_tpu_torch.timeintegration.steppers import CrankNicolson

    mesh, eq, st, sol, fields = workload(dev, dtype)
    cc = None
    if coarse:
        zero = {k: torch.zeros_like(v) for k, v in sol.items()}
        blocks_T = eq.assemble_operator_blocks(zero, fields, {},
                                               0.5 * st.dt)
        ring, _, _ = get_coloring(mesh)
        cc = CoarseCorrection(blocks_T.permute(3, 0, 1, 2), ring, mesh,
                              fields=PAR_COARSE_FIELDS)
    ser = CrankNicolson(eq, st.dt, semi_implicit=True, assembled_solve=True,
                        coarse=cc,
                        solver_parameters=NewtonParameters(**PAR_CN_PARAMS))
    part = HaloPartition(mesh, PAR_PARTS, devices=[dev] * PAR_PARTS)

    def build_eq(sm, d):
        return ShallowWaterEquations(sm, DGAssembler(sm, FunctionSpace(
            sm, "DG", 1)), eq.options, bathymetry=50.0, bnd_conditions={})

    sh = ShardedAssembledCN(ShardedEquation(part, build_eq), st.dt,
                            solver_parameters=NewtonParameters(
                                **PAR_CN_PARAMS), coarse=cc)
    return mesh, ser, sh, part, sol, fields


def phase_parallel_checks():
    """31a-b in f64: one 3D step and one 2D CN step (without and with the
    coarse correction) over PAR_PARTS partitions on the card against the
    serial port's step on the card, at the reference's bounds; the 3D
    step twice, for the same bits.  Returns the launches of the
    partitioned runs and the CN's partition."""
    dev = torch.device("cuda")
    f64 = torch.float64
    n_par = {k: 0 for k in KERNELS}
    cn_part = None
    ser, sh3, part, state, swe = parallel3d(dev, f64, PAR_3D_PARAMS)
    ref = ser._step(state, swe, {})
    state_s = to_striped(part, state)
    reset_counts()
    f_par = sh3.gather_swe_fields()
    out = sh3.step(state_s, f_par, {})
    torch.cuda.synchronize()
    n = counts()
    again = sh3.step(state_s, f_par, {})
    if any(not torch.equal(out[k], again[k]) for k in out):
        raise AssertionError("31a: two partitioned f64 steps from one "
                             "state differ in their bits")
    err = max_rel_tree(ref, from_striped(part, out))
    if not err <= PAR_3D_RTOL:
        raise AssertionError(f"31a f64: partitioned step {err:.3e} from "
                             f"the serial step > {PAR_3D_RTOL:g}")
    for k in KERNELS:
        n_par[k] += n[k]
    log(f"[31a parallel3d] f64 {NX3}x{NY3}x{NZ3} non-periodic, "
        f"{PAR_PARTS} partitions of n_loc {part.n_loc} (halo {part.halo}, "
        f"n_ext {part.n_ext}) on one card: one step {err:.3e} from the "
        f"serial step (max over fields of max|diff|/max|serial|; bound "
        f"{PAR_3D_RTOL:g}), a second step from the same state the same "
        f"bits; launches {n}; FGMRES cycles serial "
        f"{ser.swe_stepper.stats.get('ksp_cycles')}, partitioned "
        f"{sh3.swe_stepper.stats.get('ksp_cycles')}")
    del ser, sh3, ref, out, again
    for coarse in (False, True):
        mesh, st, sh, part, sol, fields = parallel_cn(dev, f64, coarse)
        ref = st.advance(0.0, sol, fields, fields, {})
        reset_counts()
        got = sh.advance(0.0, to_striped(part, sol), fields, fields, {})
        torch.cuda.synchronize()
        n = counts()
        err = max_rel_tree(ref, from_striped(part, got))
        if not err <= PAR_CN_RTOL:
            raise AssertionError(f"31b f64 coarse={coarse}: partitioned CN "
                                 f"{err:.3e} from serial > {PAR_CN_RTOL:g}")
        for k in KERNELS:
            n_par[k] += n[k]
        log(f"[31b parallel_cn] f64 nc={mesh.nc}, {PAR_PARTS} partitions "
            f"(n_loc {part.n_loc}, n_ext {part.n_ext}), "
            f"{'coarse correction' if coarse else 'block-Jacobi'}: one "
            f"step {err:.3e} from the serial assembled CN (bound "
            f"{PAR_CN_RTOL:g}); FGMRES cycles of "
            f"{PAR_CN_PARAMS['gmres_restart']}: serial "
            f"{st.stats.get('ksp_cycles')}, partitioned "
            f"{sh.stats.get('ksp_cycles')}; launches {n}")
        cn_part = part
    return n_par, cn_part


def step_profile(fn):
    """(device kernels, device ms) of one call of ``fn`` (device
    activity alone)."""
    torch.cuda.synchronize()
    rows = device_rows(fn, host=False)
    if not rows:
        raise RuntimeError("the profiler saw no device kernel in a step")
    return sum(r[1] for r in rows), sum(r[0] for r in rows) / 1e3


def phase_parallel(smi):
    """Phase 31: the partitioned path at the bench's width.  31a-b's f64
    checks (:func:`phase_parallel_checks`), then 31a in f32, the serial step
    and the PAR_PARTS-partition step side by side (1 warm-up and
    PAR_STEPS timed steps each: ms/step, device ms/step and device
    kernels of one step, launches per step): partitions on one card are
    overhead, not scaling; 31c each kernel at one partition's shapes.
    Returns ``(launches of the partitioned runs, {kernel: [(shape,
    results)]})``."""
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    n_par, cn_part = phase_parallel_checks()
    t_checks = time.perf_counter() - t_all
    ser, sh3, part, state, swe = parallel3d(dev, torch.float32)
    state_s = to_striped(part, state)
    runs = {}
    # (each partition takes its own solver's fields, gathered once as the
    # serial step's are)
    for tag, step, st0, f in (
            ("serial", ser._step, state, swe),
            (f"{PAR_PARTS} partitions", sh3.step, state_s,
             sh3.gather_swe_fields())):
        st, t_warm = sync_time(lambda: step(st0, f, {}))
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(PAR_STEPS):
            st = step(st, f, {})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / PAR_STEPS * 1e3
        n = counts()
        kernels, dev_ms = step_profile(lambda: step(st, f, {}))
        for k, v in st.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"31a f32 {tag}: non-finite {k}")
        runs[tag] = (ms, dev_ms, kernels, n, st)
        log(f"[31a parallel3d] f32 {tag}: {ms:.2f} ms/step ({PAR_STEPS} "
            f"steps after a {t_warm * 1e3:.0f} ms warm-up), device "
            f"{dev_ms:.3f} ms/step, {kernels} device kernels/step, "
            f"launches per step "
            + ", ".join(f"{k} {v / PAR_STEPS:g}" for k, v in n.items()))
    (ms1, dm1, k1, _, s1), (msp, dmp, kp, n_sh, sp) = runs.values()
    for k in KERNELS:
        n_par[k] += n_sh[k]
    drift = max_rel_tree(s1, from_striped(part, sp))
    log(f"[31a parallel3d] f32 {PAR_PARTS} partitions against serial on "
        f"one card (partitioning overhead, not scaling): ms/step x"
        f"{msp / ms1:.2f}, device ms/step x{dmp / dm1:.2f}, device kernels "
        f"x{kp / k1:.2f}; states after {PAR_STEPS + 1} steps "
        f"{drift:.2e} apart (f32, Krylov to 1e-5); card: {smi}")
    if min(n_par.values()) == 0:
        raise AssertionError(f"phase 31: a kernel was not launched on the "
                             f"partitioned path: {n_par}")
    # 31c: each kernel at one partition's shapes
    # (ring_mv over a partition's extended rows, block_diag_mv over its
    # owned rows, as ShardedAssembledCN launches them)
    shapes = {k: [] for k in KERNELS}
    for p in (part, cn_part):
        sub = p.submeshes[0]
        # a partition's blocks are cold where the PAR_PARTS partitions'
        # blocks together outgrow the L2 (the solve runs the others in
        # between)
        res = phase_kernel_ring(0, 0, False, sub,
                                PAR_PARTS * 4 * 81 * sub.nc * 4 > 50e6,
                                bjac_rows=p.n_loc)
        of = f"partition 1/{PAR_PARTS} of nc={p.mesh.nc}"
        shapes["ring_mv"].append((f"nc={sub.nc} ({of}, extended)", res))
        shapes["block_diag_mv"].append(
            (f"nc={p.n_loc} ({of}, owned)", res))
    cols = part.submeshes[0].nc * 3
    shapes["tridiag"] += [
        (f"{cols}x{NZ3 + 1} x2 shared (partition 1/{PAR_PARTS})",
         phase_kernel_tridiag(cols, NZ3 + 1, 2)),
        (f"{cols}x{NZ3 + 1} (partition 1/{PAR_PARTS})",
         phase_kernel_tridiag(cols, NZ3 + 1))]
    log(f"[phase_parallel] {time.perf_counter() - t_all:.1f} s (31a-b f64 "
        f"checks {t_checks:.1f} s); launches of the partitioned runs "
        f"{n_par}")
    return n_par, shapes


def parallel_only():
    """Phase 31 alone (``python3 chip_smoke.py parallel``): the device,
    the build and phase 31; ends with the same last line."""
    name = phase_device()
    smi = card()
    phase_build()
    n, shapes = phase_parallel(smi)
    print(json.dumps({"parallel_launches": n, "kernel_shapes": {
        k: [{"shape": label, "dtype": str(dt)[6:],
             **{f: v for f, v in res[(k, dt)].items() if f != "library"}}
            for label, res in rows for dt in (torch.float32, torch.float64)]
        for k, rows in shapes.items()}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


def examples_only():
    """Phase 30 alone (``python3 chip_smoke.py examples``): the device,
    the build and every script; ends with the same last line."""
    name = phase_device()
    smi = card()
    phase_build()
    interpolate_checks()
    function_api_checks()
    scripts = example_scripts()
    t0 = time.perf_counter()
    lines = finish_cases(start_cases(example_modes(scripts),
                                     EXAMPLES_AT_ONCE, one_thread=True),
                         timeout=1100)
    examples_launches(lines, scripts, smi, time.perf_counter() - t0)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


def io_only():
    """Phase 29 alone (``python3 chip_smoke.py io``): the device, the
    build, 29a-b, the ring kernels at the North Sea's ring table, the
    profile process and 29c-d; ends with the same last line."""
    name = phase_device()
    smi = card()
    phase_build()
    t_all = time.perf_counter()
    procs = start_cases([["profile_io"]])
    try:
        t0 = time.perf_counter()
        n = phase_io(smi)
        log(f"[29 io] launches {n}; 29a-b {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        north_sea_kernel_shapes()
        log(f"[29 io] ring kernels at the North Sea's table "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_io_checks(smi)
        log(f"[phase_io_checks] {time.perf_counter() - t0:.1f} s")
    finally:
        finish_cases(procs)
    log(f"[29 io] phase 29 in all {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


def adjoint_only():
    """Phase 28 alone (``python3 chip_smoke.py adjoint``): the device,
    the build and the adjoint's phases; ends with the same last line."""
    name = phase_device()
    smi = card()
    phase_build()
    for phase in (phase_adjoint, phase_adjoint_checks):
        t0 = time.perf_counter()
        phase(smi)
        log(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


def main():
    name = phase_device()
    smi = card()
    log(f"[device] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    phase_build()
    phase_kernel_ragged()
    phase_kernel_tridiag_ragged()
    log(f"[phases 2-3, ragged cases] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # each kernel at the shapes the port runs it at, the 3D step's first
    coords, cells, markers = rofi_mesh_arrays()
    rofi = Mesh2d(coords, cells, boundary_markers=markers,
                  device=torch.device("cuda"), dtype=torch.float64)
    ring = [(f"nc={NX3 * NY3 * 2}", phase_kernel_ring(NX3, NY3, True)),
            (f"nc={NX * NY * 2}", phase_kernel_ring(NX, NY, False)),
            (f"nc={rofi.nc} (ROFI)", phase_kernel_ring(0, 0, False, rofi))]
    t29 = time.perf_counter()
    ring.append(north_sea_kernel_shapes())  # phase 29c's kernel check
    t29 = time.perf_counter() - t29
    cols = NX3 * NY3 * 2 * 3  # (cell, node) columns of the 3D mesh
    rows = NZ3 + 1
    # the velocity solve as the step makes it first, then the tracer
    # solve, the velocity solve with its coefficients copied out to the
    # right-hand side's shape (no caller; the same bytes as the first
    # design moved) and a long column (no port shape)
    shapes = {"ring_mv": ring, "block_diag_mv": list(ring), "tridiag": [
        (f"{cols}x{rows} x2 shared", phase_kernel_tridiag(cols, rows, 2)),
        (f"{cols}x{rows}", phase_kernel_tridiag(cols, rows)),
        (f"{2 * cols}x{rows}", phase_kernel_tridiag(2 * cols, rows)),
        ("4096x300", phase_kernel_tridiag(4096, 300)),
        # the ROFI example's solves: 870 triangles x 3 nodes, 12 layers
        (f"{ROFI_COLS}x{rows} x2 shared (ROFI)",
         phase_kernel_tridiag(ROFI_COLS, rows, 2)),
        (f"{ROFI_COLS}x{rows} (ROFI)",
         phase_kernel_tridiag(ROFI_COLS, rows))]}
    log(f"[phase 3, the port's shapes] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n2, s2 = phase_slice2d(smi)
    phase_parity2d()
    log(f"[phases 4-5] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n3, ms3 = phase_slice3d(smi)
    log(f"[phase 6] {time.perf_counter() - t0:.1f} s")
    # phase 31, the partitioned path, its counts set to 0 just before each
    # partitioned run (early: the profiler's captures are whole here)
    n_par, par_shapes = phase_parallel(smi)
    for k in KERNELS:  # (ring_mv and block_diag_mv at their own rows)
        shapes[k] += par_shapes[k]
    nm = {k: 0 for k in KERNELS}
    for phase, args in ((phase_model_ssprk33, (smi,)),
                        (phase_model_cn, (smi, n2, s2)),
                        (phase_model_policy, (smi,))):
        t0 = time.perf_counter()
        n = phase(*args)
        for k in KERNELS:
            nm[k] += n[k]
        log(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
    ng = {k: 0 for k in KERNELS}
    for phase, args in ((phase_model3d_gls, (smi, ms3)),
                        (phase_model3d_split, (smi,)),
                        (phase_katophillips, (smi,))):
        t0 = time.perf_counter()
        n = phase(*args)
        for k in KERNELS:
            ng[k] += n[k]
        log(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
    # this slice's paths, each with its counts set to 0 just before it
    new = {}
    for key, phase in (("rofi", phase_model3d_rofi),
                       ("estuary", phase_model3d_estuary),
                       ("couplings", phase_model3d_couplings),
                       ("slice2d_tracers", phase_slice2d_tracers),
                       ("wetting_drying", phase_wetting_drying),
                       ("steppers2d", phase_other_steppers)):
        t0 = time.perf_counter()
        out = phase(smi)
        new[key] = out[0] if isinstance(out, tuple) else out
        log(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
    # the morphodynamics, turbine and NH slice, each path's counts set to
    # 0 just before its timed steps; then the element families, the sphere
    # and gmsh (no hand kernel on these paths: each is checked at 0)
    for key, phase in (("morphodynamics", phase_morphodynamics),
                       ("turbines", phase_turbines),
                       ("nonhydrostatic", phase_nonhydrostatic),
                       ("dg-cg", phase_dgcg), ("hdiv", phase_hdiv),
                       ("sphere", phase_sphere)):
        t0 = time.perf_counter()
        new[key] = phase(smi)
        log(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
    # the adjoint: 28a's gradient run, its counts set to 0 just before it
    # (the forward's and then the backward's, summed)
    t0 = time.perf_counter()
    new["adjoint"] = phase_adjoint(smi)
    log(f"[phase_adjoint] {time.perf_counter() - t0:.1f} s")
    # I/O and forcing: 29a-b, their counts set to 0 just before 29a
    t0 = time.perf_counter()
    new["io"] = phase_io(smi)
    t29 += time.perf_counter() - t0
    log(f"[phase_io] {time.perf_counter() - t0:.1f} s")
    # the f64 checks, the profile processes, and then the demos and
    # examples (phase 30), each in a process that sets its counts to 0
    # just before its script, beside the checks
    interpolate_checks()
    function_api_checks()
    scripts = [p for p in example_scripts() if p not in EXAMPLES_RUN_EARLIER]
    t0 = time.perf_counter()
    new["examples"], secs = phase_cases(
        smi, scripts, then=(phase_adjoint_checks, phase_io_checks))
    t29 += secs["phase_io_checks"]
    log(f"[phase_cases] with phase 30, {time.perf_counter() - t0:.1f} s")
    log(f"[29 io] phase 29 in all (29a-b, the ring kernels at the North "
        f"Sea's table, 29c-d; the profile process ran in phase 21's "
        f"block) {t29:.1f} s")
    # the top-level numbers are f32 at the 3D step's shape; "shapes" has
    # every shape and dtype measured in phase 3
    rows = []
    for k in KERNELS:
        main_shape = shapes[k][0][1][(k, torch.float32)]
        row = {"name": k, "route": "cuda", "source": SOURCES[k][0],
               "replaces": SOURCES[k][1],
               "launches": n3[k] + n2[k] + nm[k] + ng[k] + n_par[k]
               + sum(v[k] for v in new.values()),
               "launches_by_path": {"baroclinic3d": n3[k], "cn2d": n2[k],
                                    "flowsolver2d": nm[k],
                                    "flowsolver3d_gls": ng[k],
                                    "rofi": new["rofi"][k],
                                    "estuary": new["estuary"][k],
                                    "couplings3d": new["couplings"][k],
                                    "slice2d_tracers":
                                        new["slice2d_tracers"][k],
                                    "wetting_drying": new["wetting_drying"][k],
                                    "steppers2d": new["steppers2d"][k],
                                    "morphodynamics":
                                        new["morphodynamics"][k],
                                    "turbines": new["turbines"][k],
                                    "nonhydrostatic":
                                        new["nonhydrostatic"][k],
                                    "dg-cg": new["dg-cg"][k],
                                    "hdiv": new["hdiv"][k],
                                    "sphere": new["sphere"][k],
                                    "adjoint": new["adjoint"][k],
                                    "io": new["io"][k],
                                    "examples": new["examples"][k],
                                    "parallel": n_par[k]},
               "library": main_shape["library"]}
        row.update({f: main_shape[f] for f in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "share", "plain_device_ms",
            "library_device_ms")})
        row["shapes"] = [
            {"shape": label, "dtype": str(dt)[6:],
             **{f: v for f, v in res[(k, dt)].items() if f != "library"}}
            for label, res in shapes[k]
            for dt in (torch.float32, torch.float64)]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["profile3d"]:
        profile3d()
    elif sys.argv[1:] == ["profile3d_gls"]:
        profile3d_gls()
    elif sys.argv[1:] == ["profile3d_estuary"]:
        profile3d_estuary()
    elif sys.argv[1:] == ["profile3d_more"]:
        profile3d_more()
    elif sys.argv[1:] == ["profile2d_tracers"]:
        profile2d_tracers()
    elif sys.argv[1:2] == ["thacker"] and len(sys.argv) == 3:
        thacker_case(sys.argv[2])
    elif sys.argv[1:] == ["standing_wave"]:
        standing_wave_case()
    elif sys.argv[1:] == ["tidal_array"]:
        tidal_array_case()
    elif sys.argv[1:] == ["solitary_wave"]:
        solitary_wave_case()
    elif sys.argv[1:] == ["profile_slice9"]:
        profile_slice9()
    elif sys.argv[1:2] == ["dgcg_wave"] and len(sys.argv) == 3:
        dgcg_wave_case(sys.argv[2])
    elif sys.argv[1:] == ["dgcg_volume"]:
        dgcg_volume_case()
    elif sys.argv[1:] == ["hdiv_cases"]:
        hdiv_cases()
    elif sys.argv[1:] == ["profile_families"]:
        profile_families()
    elif sys.argv[1:] == ["channel_inversion"]:
        channel_inversion_case()
    elif sys.argv[1:] == ["adjoint"]:
        adjoint_only()
    elif sys.argv[1:] == ["io"]:
        io_only()
    elif sys.argv[1:2] == ["example"] and len(sys.argv) == 3:
        example_case(sys.argv[2])
    elif sys.argv[1:2] == ["example_parity"] and len(sys.argv) == 3:
        example_parity(sys.argv[2])
    elif sys.argv[1:] == ["examples"]:
        examples_only()
    elif sys.argv[1:] == ["parallel"]:
        parallel_only()
    elif sys.argv[1:] == ["profile_io"]:
        profile_io()
    else:
        main()
