"""Smoke run of the PyTorch/CUDA port (picaso_tpu_torch) on one NVIDIA GPU.

Drives the port's main paths -- ``pipeline.build_problem`` and
``pipeline.forward`` at the production shape: ragged 1060-point (T, P)
grid, 16 molecules, nwno = 50 000, 90 layers, 5 disk angles, cloudy, 2 CIA
continua, Rayleigh, reflected + thermal + transit -- with the Toon solver
(reflected and thermal together, each alone, unfused optics; Raman off or
Pollack) and with the spherical-harmonics solver at 4 and 2 streams, a
4-point reflected phase curve through ``forward_batch``, the int16 opacity
table, and a sqlite database written, loaded and run on the card; then
the gather and sweep-layout probes; then the radiative-convective climate
solve, ``climate.api.run_climate`` in chemical equilibrium at the
production shape of bench.py's climate modes (91 levels, the 196- and
661-bin synthetic CK tables, a 700 K brown dwarf); then the front door,
``justdoit`` as a user calls it (``inputs`` ... ``spectrum``,
``phase_curve``) on the production table: 1D spectra, a 36-facet 3D
spectrum and two phase curves; then retrievals on the same table: the
samplers (``sampler.nested_sample``, ``ensemble_sample``) over batched
forwards (``forward_batch``), the TOML driver (``driver.log_likelihood``,
``driver.run``) and a fit of the bundled WASP-17b spectrum (``ncio``);
then the climate modes through the front door (``inputs(climate=True)``
... ``climate``): disequilibrium chemistry, virga clouds, the moist
adiabat, energy injection with the spectrum of the result, and the
virga, ``virga_3d`` and TOML-climate workflows around them; then a CK
table read from a file (``opannection(ck_db=...)``) into the climate
(``run_climate``, the host Newton ``t_start``, the TOML driver) and the
front door's tools (``guillot_pt``, ``get_contribution``,
``convert_flux_units``); then the host tools: opacity ingestion from raw
files into a spectrum, the native (C++) loader, ``build_3d_input`` into a
100-facet spectrum, ``model_compare``'s literature harnesses and the
port's examples; then the device mesh (the sharded forward, phase curve,
likelihood and climate) and the climate with (mocked) photochemical
kinetics.  It goes
through the 14 hand-written CUDA kernels, and checks each kernel against
its plain PyTorch twin, each forward against a float64 oracle, and each
climate solve against the JAX package's float64 solve
(tests/climate_reference.json, tests/climate_modes_reference.json; the
climate solve itself runs none of the kernels: plain torch).

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero):
 1. the card's name and power limit (nvidia-smi); no CUDA device -> error
 2. build the kernels from picaso_tpu_torch/csrc with nvcc (sm_90a)
 3. build the production problem on the card
 4. gather kernel vs its twin at the production shape (max rel <= 1e-5),
    on the production profile and on a scattered one (every layer of a
    chunk reads 4 rows no other layer of it reads: the most a chunk needs)
 5. spectrum kernel vs its twin at the production shape
    (max rel <= 1e-3, median rel <= 1e-5)
 6. forward on 4 temperature-perturbed scenes: finite outputs, each
    kernel launched exactly once per forward, each forward's peak device
    memory (as in phases 10, 14 and 19)
 7. nwno = 5000 oracle: the plain path in float64 against the kernel path
    in float32 (max rel <= 5e-3, median rel <= 2e-4, TPU_PARITY.json's
    forward tolerances)
 8. timings: forward with kernels vs the plain path, each kernel vs twin,
    and K2's two launches apart (stage A with the thermal pass, stage B)
 9. each SH kernel (reflected/thermal at 4 and 2 streams) vs its twin at
    the production shape (max rel <= 1e-3, median rel <= 1e-5), each timed
    against its twin, its two launches apart; then reflected_sh4 and
    thermal_sh4 alone at the phase curve's 36 angles against their twins,
    timed
10. SH4 and SH2 forwards on the 4 perturbed scenes: finite outputs, each
    SH kernel of the stream and the gather launched once per forward, no
    other kernel
11. nwno = 5000 SH oracle at 4 and 2 streams: the f32 kernel path against
    the f64 plain path (albedo and thermal max rel <= 8e-3, median rel <=
    1e-3, TPU_PARITY.json's SH tolerances; transit as phase 7)
12. timings: SH forwards with kernels vs the plain path; each SH
    forward's peak device memory over one call after gc.collect(),
    torch.cuda.empty_cache() and a reset, beside the bytes alive before it
13. the split Toon kernels vs their twins at the production shape: K3
    (reflected) with Pollack Raman, K4 (thermal) without and with a hard
    surface, K5/K6 (from RTProps) on the unfused props and on the
    test_mode='rayleigh' props, K3 and K5 also at multi_phase=2
    (isotropic) (max rel <= 1e-3, median rel <= 1e-5);
    each timed against its twin, its two stages apart; then K3 and K4
    alone at the phase curve's 36 angles against their twins, timed
14. the split Toon paths, counted over 4 forwards each: reflected-only
    (K1 + K3), thermal-only (K1 + K4), unfused optics (K1 + K5 + K6), and
    forward_batch of 4 phase-curve scenes at 0, 45, 90, 120 degrees
    (reflected-only, 6 x 6 disk: K1 + K3 once per scene); no other kernel
15. nwno = 5000 oracle of the split paths, f32 kernels vs f64 plain path
    (max rel <= 5e-3, median rel <= 2e-4): reflected-only with Oklopcic and
    with Pollack Raman, thermal-only, test_mode='constant_tau'
    (reflected-only, as the literature-validation runs use it)
16. timings: the split-path forwards and the phase-curve batch with
    kernels vs the plain path
17. the int16 table: quantize the production table on the card (bytes,
    seconds)
18. K8, the int16 gather, vs its twin at the production shape (max rel <=
    1e-5), on both profiles of phase 4, timed against its twin
19. forward on the 4 perturbed scenes with the int16 grid: finite outputs,
    K8 and K2 once per forward, K1 never
20. nwno = 5000 oracle: the int16 f32 kernel path against the f64 plain
    path on the float table (max rel <= 5e-3, median rel <= 4e-3, the
    JAX package's int16 gate, scripts/tpu_parity.py:173-192)
21. sqlite round trip: write a '1060'-layout database (2 molecules,
    nwno 2000) with build_synthetic_db, load it onto the card with
    load_opacity_db, quantize it, one forward through K8 against the same
    grid's f32 plain path (phase 20's gate)
22. the probes' kernels vs their twins at the probes' shapes (layer-inner
    gather max rel <= 1e-5 against its twin, <= 1e-4 against K1 on
    stabilised slots; both sweep layouts <= 1e-5), then each probe's
    report with its kernels counted
23. climate at the production shape (bench.py's: 91 levels, 196 bins x 8
    gauss points, a 700 K brown dwarf): one flux evaluation and one
    Jacobian (all perturbations in one evaluation, the default, and 8 at a
    time) in f64 (run_climate's default) and in f32, timed by CUDA events
    behind a stream sleep and by the host clock, their device launches
    counted by the profiler and their aten calls by a dispatch counter,
    the Jacobians' peak memory; the level fluxes F+ and F- of the thermal
    and the reflected (flat stellar flux) solves at the guess: f64 on the
    card against f64 on the CPU (the path the tests hold against the JAX
    package) within phase 7's gates (max rel <= 5e-3, median rel <= 2e-4),
    f32 against f64 on the card reported (the f32 opt-in's thin-layer
    fault, ROADMAP Queue 3)
24. climate, 196 bins: run_climate with its defaults (f64) at 91 levels:
    converged, finite, flux balance max |flux_net| / (sigma Teff^4) <= 1e-3
    over the radiative zone (tests/test_climate.py), the JAX package's f64
    solve of tests/climate_reference.json reproduced (the same converged
    and cvz_locs, max |dT| <= 2 K, TPU_PARITY.json's climate_max_dT), the
    level fluxes at the solution on the card against the CPU (phase 23's
    gates); then the f32 opt-in against f64 at the depth
    scripts/tpu_parity.py validated the JAX package's f32 at (41 levels):
    both converge, flux balance, max |dT| <= 2 K, the level fluxes at the
    f64 solution f32 against f64 within phase 7's gates; each run's wall
    seconds, profile steps, Newton iterations, Jacobians, flux
    evaluations, cvz_locs, flux balance and peak memory; no kernel
    launched
25. climate, 661 bins: the same runs and gates on the 661-bin table (the
    level fluxes at the 91-level solution, card against CPU)
26. the front door, 1D, on the production table (nwno 50 000, 16
    molecules) wrapped as ``justdoit.Opacity``: inputs, phase_angle (10
    angles), gravity, a 5700 K blackbody star, the 91-level profile, the
    cloud deck as an EGP-grid table, approx, then
    spectrum('reflected+thermal+transmission'), 4 calls (the last at
    approx(multi_phase='isotropic')): finite outputs, K1, K5 and K6 each
    launched once per call and no other kernel, each call's wall ms and
    peak bytes over the bytes alive before it
27. the 1D oracle: the same calls at nwno 5000, float32 on the card
    against float64 on the CPU (device='cpu', the kernels' twins), at N=2
    and isotropic (max rel <= 5e-3, median rel <= 2e-4)
28. 3D: the 91-level hot-spot map (12 lon x 8 lat, 16 molecules) on a
    6 x 6 disk, spectrum(dimension='3d') reflected + thermal: K1, K5 and K6
    each launched 36 times, finite outputs, peak over alive <= 2 GB; a
    uniform map's 3D thermal against the 1D thermal (max rel <= 1e-5); the
    oracle of phase 27 on a 3 x 3 disk
29. phase curves: the map rotated by atmosphere_4d over 4 phases, thermal
    (4 x 36 facets: K1 and K6 144 times each), and a 4-scene batched
    reflected curve of the 1D profile at 0, 45, 90, 120 degrees (6 x 6
    disks, through scene_from_case and forward_batch: K1 and K3 4 times
    each), each timed and held against its float64 CPU oracle at nwno 5000
    (the thermal curve on 3 x 3 disks)
30. batched free transmission retrieval at full width
    (examples/retrieval_nested.py's isothermal T and log H2O at 91 levels,
    probes/retrieval.py): nested_sample(nlive=16, max_iter=20, walks=3,
    seed=2), each sampler batch one forward_batch of scene_from_arrays
    scenes: K1 launched once per scene evaluated, no other kernel; finite
    logz and samples; wall s, likelihoods/s, ms per batch
31. the same scenes thermal-only (K1 + K4 per scene), ensemble_sample
    with 8 walkers x 4 steps: launches, finite chain, spectra/s, peak
    bytes over the bytes alive before the run
32. the TOML driver: driver_example.toml at 91 levels on the production
    table, log_likelihood at 4 parameter points per observation type
    (transmission K1, thermal K1 + K6, reflected K1 + K5 per call), each
    call's host ms, one call split into host functions and card busy time;
    then driver.run end to end on a '1060'-layout sqlite database (H2O, CO,
    nwno 2000) written by build_synthetic_db: spectrum mode, then retrieval
    mode (nested, nlive=8, max_iter=5, walks=2), K1 once per likelihood
33. WASP-17b: ncio.read_netcdf(justdoit.w17_data()), the full-width
    transmission forward convolved onto the data's per-point R
    (conv_non_uniform_R), ensemble_sample with 8 walkers x 3 steps: K1
    once per scene, finite chi2; then the oracle of phases 30-33 at nwno
    5000: the models and log-likelihoods f32 on the card against the same
    calls f64 on the CPU (phase 27's gates on transit, thermal and albedo;
    |d log L| <= 1e-3 |log L|)
34. climate modes through the front door (``justdoit.inputs(calculation=
    'browndwarf', climate=True)``, ``inputs_climate``, ``climate``) at the
    production climate shape (91 levels, f64) on the synthetic CK tables
    with their per-gas tables (``opannection(ck_table=...)``: the f64 table
    for the solve, its f32 copy for spectra): disequilibrium chemistry
    with self-consistent Kzz, quenching and resort-rebin mixing, a 900 K T
    dwarf at 1000 m/s^2 on the 196- and the 661-bin table (it balances),
    and the 700 K brown dwarf at 100 m/s^2 on the 661-bin table (it blows
    up, the JAX package's too: ROADMAP Queue 3)
35. cloudy: 1300 K, virga with Mg2SiO4 and Fe, fsed 2 (the cloud forms;
    geometric optics) in the loop
36. moist: 350 K, the moist adiabat
37. energy injection (a Chapman deposition of 1e5 erg/cm^2/s at 0.1 bar)
    with ``with_spec``: K6 launched once per gauss point (8) and no other
    kernel; the spectrum f32 on the card against the same call f64 on the
    CPU (max rel <= 1e-3, median <= 1e-5).  Phases 34-37 are gated
    against the JAX package's f64 solves (tests/climate_modes_reference.
    json, written by tests/climate_modes_record.py): the same converged and
    cvz_locs, max |dT| <= 2 K, flux balance <= 1e-3 of sigma Teff^4 where
    the JAX solve converged and balanced, diseq the same quench levels and
    Kzz within rtol 1e-6 (a finite Kzz and quench levels required), cloudy
    the column optical depth within rtol 1e-6; the 700 K diseq blow-up
    alone may end with a NaN Kzz and no quench level, and where its card
    solve leaves the JAX one after the JAX solve's fluxes went NaN (its
    ``nan_onset``), the card's profile steps before it within 2 K; each
    run's wall s, profile steps, Newton iterations, Jacobians, flux
    evaluations, launches and peak over the bytes alive before it
38. the workflows around the climate: examples/virga_clouds.py's
    ``case.virga`` (its brown dwarf, the condensates virga recommends) and
    a cloudy thermal spectrum on the production table (K1 + K6 once each;
    the cloud dims the emission), its oracle at nwno 5000 (phase 27's
    gates); ``virga_3d`` on phase 28's 12 x 8 map with a kz of
    1e9 cm^2/s and a 36-facet thermal spectrum through its clouds (K1 and
    K6 36 times each); the TOML driver's climate mode
    (``driver.setup_climate_class`` given the 196-bin CK connection, then
    ``case.climate`` as ``driver.run`` calls it) on phase 36's case at 41
    levels: no kernel launched, gated as phases 34-37 against the JAX
    driver's f64 solve
39. a CK table from a file: the legacy 1460-grid ASCII table of
    ``legacy.synthetic_legacy_table`` (24 species, 73 x 20 (T, P) points,
    196 bins) written by the port's ``write_legacy_ascii`` under
    build/ck_files, its SHA-256 equal to the JAX writer's
    (tests/ck_files_reference.json, written by tests/ck_files_record.py),
    opened on the card with ``justdoit.opannection(ck_db=<dir>)`` (the f64
    climate table, its f32 copy for spectra), the loaded arrays against
    the written table (max rel <= 1e-12: the text round-trips).  The hdf5
    formats (premixed, per-gas) are not run: h5py is not installed on the
    card's machine; the CPU tests run them (tests/test_torch_ck_files.py)
40. run_climate in f64 at 91 levels on the loaded table (bench.py's brown
    dwarf): converged, flux balance <= 1e-3, no kernel launched, the same
    converged and cvz_locs as the JAX solve on the same file and max |dT|
    <= 2 K
41. the host Newton solver ``climate.core.t_start`` from the 91-level
    guess at its equilibrium chemistry (``_ClimateState.opacities``), one
    convective zone, f64 on the card: the same Newton steps and converged
    as the JAX t_start, max |dT| <= 1e-6 K; its wall s and flux
    evaluations per step
42. ``driver.run`` in climate mode from a TOML config whose
    ``[OpticalProperties] ck_db`` is that directory, no connection passed,
    41 levels: no kernel launched, the same converged and cvz_locs as the
    JAX driver's run and max |dT| <= 2 K
43. the front door's tools on the production table: a 91-level
    ``guillot_pt`` profile's reflected + thermal spectrum twice (K1, K5
    and K6 once each per call), ``get_contribution`` at nwno 50 000 f32 on
    the card (no kernel) against f64 on the CPU (taus_per_layer and
    tau_p_surface max rel <= 1e-3, tau_p_surface finite on the same
    wavenumbers), ``convert_flux_units`` round trips through FLAM, FNU,
    Jy, mJy and W/(m2 um) (max rel <= 1e-12).  Model save and load need
    h5py and are not run here.  Phases 39-43 each print one JSON line
    with the card's name and power limit
45. opacity ingestion: a raw source tree written from a seed
    (``opacities.ingest.synthetic_raw_tree``: an EGP CIA grid, a HITRAN
    CIA file, H2O as .npy and CH4 as fortran binaries on the 1460 (T, P)
    points of refdata/opacities/grid1460.csv, 20 000 wavenumbers a point)
    ingested by the port (``ingest_molecular_1460``, ``ingest_cia_grid``,
    ``ingest_hitran_cia``, ``add_metadata``) into a sqlite DB under
    build/host_tools; every table against the JAX package's ingestion of
    the same tree (tests/host_tools_reference.json, written by
    tests/host_tools_record.py): the molecular tables and the wavenumber
    grid bitwise (SHA-256), the continuum (10**, log, exp) within max rel
    1e-12 of the record's sum, min, max and samples; then
    ``opannection(filename_db=...)`` on the card and a reflected + thermal
    spectrum from it (K1, K5 and K6 once each), f32 on the card against
    the same call f64 on the CPU (phase 7's gates)
46. the native loader (``picaso_tpu_torch.native``, host C++ built with
    g++ into build/picaso_tpu_torch/native): ``load_opacity_db(native=
    True)`` against ``native=False`` on phase 21's '1060' DB and on the
    ingested DB, float32: the arrays bitwise equal, no warning (the C++
    decode ran); both loads timed
47. ``build_3d_input`` at a GCM's size: ``synthetic_gcm()`` (128 lon x 64
    lat x 53 levels) through ``regrid_xarray`` and
    ``regrid_to_gauss_cheby``, its temperatures written as a MITgcm dump
    through ``rebin_mitgcm_pt``, a cloud dump (8 x 4 columns, 52 layers x
    196 waves) through ``rebin_mitgcm_cld``, all onto 10 x 10
    Gauss-Chebyshev facets: each array within max rel 1e-12 of the JAX
    record; then those maps' reflected + thermal spectrum on the
    production table (100 facets: K1, K5 and K6 100 times each), and the
    same at nwno 5000 f32 on the card against f64 on the CPU (phase 28's
    gates, phase 27's)
48. ``model_compare`` on the card in f32, Toon: ``dlugach_test`` and
    ``madhu_test`` in full (K5 63 and 48 times) and ``thermal_sh_test``
    over its whole grid (constant-tau thermal, K6 165 times), every cell
    against the JAX package's f64 record (max rel <= 5e-3, median rel <=
    2e-4); the largest difference from DLUGACH_TEST.csv printed (physics,
    not a gate)
49. the port's examples (picaso_tpu_torch/examples) through
    ``integration_testing.run_all``, each in a process of its own with a
    timeout, 4 at a time (each example's wall s is under that load): every one exits 0 but retrieval_nested.py, whose JAX
    namesake fails its own posterior assert (the JAX package's CPU run in
    tests/host_tools_reference.json: T median 1411 K against the truth's
    1150 +- 250); the port's copy must fail the same way, printing the
    JAX run's posterior line.  The mesh and photochemistry examples'
    printed lines are logged beside the JAX examples' CPU runs in x64 and
    f32 (tests/examples_reference.json) and gated where the JAX example's
    own asserts stand: the retrieved scale within 2e-2 of the truth, the
    sharded climate converged, at least 2 kinetics calls (finite T and
    flat CH4 are the example's own asserts); the photochemistry
    example's converged and T range are logged, not gated.  The mesh
    example's retrieval line must be the JAX runs' exactly (x64 and f32
    printed the same).  It prints its sharded forwards and its process's
    kernel launches: K1 and K2 (the JAX example's config: reflected,
    thermal and transit) exactly 4 (wave shards) a forward, counted
    among phases 45-49's.  Phases 45-49 are timed by
    ``profiling.Timer``, logged by ``profiling.RunLog``
    (build/host_tools/host_tools.jsonl) and each prints one JSON line with
    the card's name and power limit
50-54. the device mesh (``picaso_tpu_torch.parallel``) over the visible
    cards, ``cuda:0`` repeated where there are fewer cards than shards
    (the mesh's device list printed), and photochemistry; one JSON line
    per phase with the card's name and power limit:
50. ``sharded_forward`` at the production shape over 4 wave shards, Toon
    (K1 + K2) and the int16 table (K8 + K2): each kernel launched once per
    shard, albedo, thermal and transit bitwise phase 6's and phase 19's
    unsharded outputs (the transit depth's slant-path product runs once
    over the gathered optical depths); placement s, wall ms sharded and
    unsharded, peak
51. the front door's batched 4-phase reflected curve (phase 29's) with
    ``phase_curve(mesh=make_mesh(n_wave=2, n_batch=2))``: K1 and K3 once
    per scene and shard, bitwise ``mesh=None``
52. on each of the 8 shards of phase 49's mesh example's scene (its
    config and truth; [24 layers x 64 bins] a shard), K1 and K2 against
    their twins with phases 4 and 5's gates; then
    ``sampler.nested_sample`` over ``sharded_loglike`` on a 2 x 4 mesh at
    tests/test_parallel_climate.py:152-199's width (nwno 256, 25 levels,
    nlive 25, seed 11; reflected-only: the likelihood reads the albedo):
    K1 and K3 once per point and wave shard, the same dead points and
    logz as the unsharded run on the card (nlive 25: phase 49's mesh
    example runs the JAX test's 50 at the same width)
53. ``run_climate(mesh=make_mesh(n_wave=4, n_batch=2))`` in f64 on phase
    24's case (49 bins a shard): the same converged and cvz_locs as phase
    24's solve, T within rtol 1e-4 / atol 0.05 K of it
    (tests/test_parallel_climate.py:133-134) and within 1e-6 K of it, and
    within 2 K of the JAX record; wall s and flux evaluations against
    phase 24's; no kernel
54. phase 34's T dwarf (``diseq_t900_91``) with mocked photochemical
    kinetics in ``inputs['climate']['pc']``: the kinetics once per host
    iteration, cold then warm, the converged profile's CH4 the mock's
    constant, converged and cvz_locs as the JAX f64 solve of the same
    case (tests/photochem_reference.json) and T within 2 K of it
55. the card, one JSON line with the climate numbers, one with the front
    door's (each path's launches, wall times, peaks, oracle and uniform-map
    deviations), one with the retrievals' (launches, rates, host and card
    times, oracle deviations), one with the climate modes' (per run: wall
    s, the solve's counts, launches, peak over alive, the gates' numbers),
    one with phases 39-43's, one with phases 45-49's, one with phases
    50-54's, one with every
    kernel's summary (launches on the paths counted above, the front
    door's, the retrievals', the climate modes', phases 39-43's,
    phases 45-49's and phases 50-53's included and also apart, times, max
    abs error, and the bound: the larger of the
    bytes its inputs and outputs need over 3.35 TB/s and the float32
    operations its twin performs on these inputs, counted per aten call,
    over 67 TFLOP/s), then the result line.
"""

import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

NWNO = 50_000
NLEVEL = 91
ORACLE_NWNO = 5_000
N_SCENES = 4
TOL = {'gather_max_rel': 1e-5, 'spectrum_max_rel': 1e-3,
       'spectrum_median_rel': 1e-5, 'forward_max_rel': 5e-3,
       'forward_median_rel': 2e-4, 'sh_max_rel': 8e-3,
       'sh_median_rel': 1e-3}
SH_REPLACES = {'reflected_sh4': 'picaso_tpu/rt/pallas_sh.py:530',
               'thermal_sh4': 'picaso_tpu/rt/pallas_sh.py:717',
               'reflected_sh2': 'picaso_tpu/rt/pallas_sh.py:925',
               'thermal_sh2': 'picaso_tpu/rt/pallas_sh.py:1084'}
SPLIT_REPLACES = {'reflected_toon': 'picaso_tpu/rt/pallas_toon.py:700',
                  'thermal_toon': 'picaso_tpu/rt/pallas_toon.py:850',
                  'reflected_toon_props': 'picaso_tpu/rt/pallas_toon.py:462',
                  'thermal_toon_props': 'picaso_tpu/rt/pallas_toon.py:658'}
# every kernel: (its source, the TPU kernel it replaces)
KERNELS = {
    'interp_tau': ('interp_tau.cu',
                   'picaso_tpu/opacities/pallas_interp.py:263'),
    'spectrum_toon': ('toon_spectrum.cu', 'picaso_tpu/rt/pallas_toon.py:788'),
    **{name: ('sh_spectrum.cu', line) for name, line in SH_REPLACES.items()},
    **{name: ('toon_spectrum.cu', line)
       for name, line in SPLIT_REPLACES.items()},
    'interp_tau_q': ('interp_tau.cu',
                     'picaso_tpu/opacities/pallas_interp.py:243'),
    'interp_tau_layer_inner': ('gather_probe.cu',
                               'scripts/gather_probe.py:52'),
    'sweep_rows': ('sweep_layout_probe.cu', 'scripts/sweep_layout_probe.py:52'),
    'sweep_staged': ('sweep_layout_probe.cu',
                     'scripts/sweep_layout_probe.py:52'),
}
PHASES_DEG = (0.0, 45.0, 90.0, 120.0)
INT16_TOL = {'max_rel': 5e-3, 'median_rel': 20 * 2e-4}
DB_NWNO = 2_000
# the climate problem of bench.py:492-513: 700 K, 100 m/s^2, no star,
# 91 levels from 1e-4 to 10^2.5 bar, the convective zone guessed 20 levels
# above the bottom
CLIMATE_NLEVEL = 91
CLIMATE_TEFF = 700.0
CLIMATE_DT_MAX = 2.0         # K, TPU_PARITY.json:9 climate_max_dT
# the depth at which the JAX package's f32 climate was validated against
# its f64 oracle (scripts/tpu_parity.py: 41 levels, rcb_guess 31); at 91
# levels an f32 solve ends hundreds of K from the f64 one, the JAX
# package's on the CPU as the port's (tests/climate_f32_record.py, ROADMAP
# Queue 3), so the port's f32 is an opt-in checked at 41 levels
CLIMATE_PARITY_NLEVEL = 41
CLIMATE_BALANCE = 1e-3       # tests/test_climate.py:97-104
# the JAX package's f64 solves at 91 levels (tests/climate_f32_record.py)
CLIMATE_REFERENCE = 'tests/climate_reference.json'
# the JAX package's f64 solves of the climate modes (phases 34-37;
# tests/climate_modes_record.py), and the runs held against them
CLIMATE_MODES_REFERENCE = 'tests/climate_modes_reference.json'
CLIMATE_MODES = (('diseq_t900_91', 34), ('diseq_t900_661_91', 34),
                 ('diseq_661_91', 34), ('cloudy_91', 35), ('moist_91', 36),
                 ('inject_91', 37))
CLIMATE_MODES_RTOL = 1e-6    # Kzz, column optical depth
# the 700 K diseq solve at log g 4 blows up in the JAX package (ROADMAP
# Queue 3: find_strat opens a one-level convective zone, the Newton
# Jacobian is singular, NaN fluxes and Kzz follow).  The one run that may
# end with a NaN Kzz and no quench level, and the one whose card solve may
# leave its record after the JAX solve's NaN onset: then it is held to the
# record's profile steps before the onset.  Every other diseq run must
# have a finite Kzz and quench levels, and meets every gate
CLIMATE_DISEQ_BLOWUP = 'diseq_661_91'
DRIVER_CLIMATE = 'driver_moist_41'   # the TOML climate mode's record
# the JAX package's f64 solves on a CK table read from a legacy file
# (phases 39-42; tests/ck_files_record.py), and where the card writes it
CK_FILES_REFERENCE = 'tests/ck_files_reference.json'
CK_FILES_DIR = 'build/ck_files'
CK_FILES_RTOL = 1e-12        # loaded vs written: the text round-trips
T_START_DT_MAX = 1e-6        # K, the card's t_start against the JAX one
CONTRIB_MAX_REL = 1e-3       # get_contribution, f32 card vs f64 CPU
# the JAX package's float64 results for the host tools (phases 45, 47, 48;
# tests/host_tools_record.py), and where the card writes its files
HOST_TOOLS_REFERENCE = 'tests/host_tools_reference.json'
HOST_TOOLS_DIR = 'build/host_tools'
HOST_TOOLS_RTOL = 1e-12      # where 10**, log or exp enter
GAUSS_CHEBY = dict(num_gangle=10, num_tangle=10)   # 100 facets
EXAMPLE_TIMEOUT_S = 300
# examples run at a time in phase 49, each in a process of its own (the
# card's machine has 8 cores; one at a time took 131 s in PR 17)
EXAMPLE_JOBS = 4
# the JAX package's runs of the mesh and photochemistry examples
# (tests/examples_record.py), and the JAX examples' own assert on the
# retrieved scale
EXAMPLES_REFERENCE = 'tests/examples_reference.json'
MESH_EXAMPLE = 'mesh_sharded_retrieval_climate.py'
PHOTOCHEM_EXAMPLE = 'photochem_coupled_climate.py'
MESH_EXAMPLE_TRUTH, MESH_EXAMPLE_TOL = 1.05, 2e-2
# phases 50-54, the device mesh (picaso_tpu_torch.parallel): the sharded
# climate against the unsharded one at the JAX whole-solve test's bound
# (tests/test_parallel_climate.py:133-134), and the kinetics-coupled
# climate (mocked, tests/photochem_record.py) against the JAX f64 solve
MESH_CLIMATE_RTOL, MESH_CLIMATE_ATOL = 1e-4, 0.05
# and near what it reaches (6.8e-10 K on an H100): the CPU tests' bound
# between the port and the JAX package, so a shard reduction that lost
# float64 precision fails
MESH_CLIMATE_DT_MAX = 1e-6
PHOTOCHEM_REFERENCE = 'tests/photochem_reference.json'
PHOTOCHEM_CASE = 'photochem_t900_91'
PHOTOCHEM_BASE = 'diseq_t900_91'       # phase 34's run of the same case
RETRIEVAL_NWNO, RETRIEVAL_NLEVEL = 256, 25  # tests/test_parallel_climate.py
# phase 52's live points (the JAX test's 50 run in phase 49's mesh example)
RETRIEVAL_NLIVE = 25
# one H100 SXM at its 700 W limit (NVIDIA data sheet): memory rate and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# elementwise float arithmetic counted one operation per output element;
# reductions and scans one per input element
_ELEMENTWISE = {'add', 'sub', 'rsub', 'mul', 'div', 'neg', 'reciprocal',
                'exp', 'expm1', 'exp2', 'log', 'log10', 'log1p', 'log2',
                'pow', 'sqrt', 'rsqrt', 'maximum', 'minimum', 'clamp',
                'clamp_min', 'clamp_max', 'abs', 'sign', 'sin', 'cos',
                'tanh', 'sigmoid', 'lerp', 'addcmul', 'addcdiv'}
_REDUCING = {'sum', 'cumsum', 'cumprod', 'prod', 'mean', 'amax', 'amin'}


def log(msg):
    print(msg, flush=True)


def rel_stats(a, b):
    """(max, median) relative deviation of a from b, with the scale floored
    at 1e-9 of b's largest magnitude (scripts/tpu_parity.py)."""
    a, b = a.double().flatten(), b.double().flatten()
    scale = torch.clamp(b.abs(), min=b.abs().max().item() * 1e-9 + 1e-300)
    rel = (a - b).abs() / scale
    return rel.max().item(), rel.median().item()


def check(name, value, limit):
    ok = value <= limit
    log(f'  {name}: {value:.3e} (limit {limit:.0e}) {"OK" if ok else "FAIL"}')
    if not ok:
        raise AssertionError(f'{name} = {value:.3e} exceeds {limit:.0e}')


def cuda_ms(fn, n):
    """Mean device time of fn() over n calls, by CUDA events.  The stream
    first sleeps ~25 ms, so the n calls are queued before the card reaches
    them: a kernel shorter than its wrapper's host time is timed, not the
    host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def stages_ms(kern, args, kw, n):
    """Mean device time of each stage (A, B) of a two-stage kernel over n
    calls, by CUDA events recorded before, between (the
    wrapper's ``split_event``) and after its two launches."""
    kern(*args, **kw)
    torch.cuda.synchronize()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
              for _ in range(n)]
    for start, mid, end in events:
        start.record()
        kern(*args, split_event=mid, **kw)
        end.record()
    torch.cuda.synchronize()
    return [sum(e[i].elapsed_time(e[i + 1]) for e in events) / n
            for i in (0, 1)]


def forwards_with_peaks(label, fn, items):
    """[fn(x) for x in items], each call's peak device memory
    (max_memory_allocated after a reset) logged under ``label``."""
    outs, peaks = [], []
    for x in items:
        torch.cuda.reset_peak_memory_stats()
        outs.append(fn(x))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
    log(f'     {label}: peak bytes per forward {peaks}')
    return outs


def wall_ms(fn, n, passes=2):
    """Best-of-passes mean wall time of fn() + synchronize over n calls."""
    fn()
    torch.cuda.synchronize()
    best = float('inf')
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e3


def check_counts(got, expected, forwards=N_SCENES):
    """Each kernel named in ``expected`` launched once per forward, every
    other kernel not at all."""
    for name, count in got.items():
        want = forwards if name in expected else 0
        if count != want:
            raise AssertionError(f'{name} launched {count} times in '
                                 f'{forwards} forwards, expected {want}')


def check_outputs(outs, keys=('albedo', 'thermal', 'transit_depth'),
                  shape=(NWNO,)):
    for i, out in enumerate(outs):
        assert set(out) == set(keys), out.keys()
        for key, val in out.items():
            if val.shape != shape or not torch.isfinite(val).all():
                raise AssertionError(f'scene {i} {key}: shape '
                                     f'{tuple(val.shape)} or non-finite')


def check_twin(label, out, ref, phase=13):
    """Kernel output against its twin's: finite, max rel <= 1e-3, median
    rel <= 1e-5.  Returns the max abs difference."""
    if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
        raise AssertionError(f'{label}: non-finite values')
    mx, med = rel_stats(out, ref)
    err = (out - ref).abs().max().item()
    log(f'[{phase}] {label} kernel vs twin {tuple(out.shape)}: max abs '
        f'{err:.3e}')
    check(f'{label} max rel', mx, TOL['spectrum_max_rel'])
    check(f'{label} median rel', med, TOL['spectrum_median_rel'])
    return err


class OpCounter(TorchDispatchMode):
    """Counts the floating-point operations of the aten calls made inside
    it (the operation count of a kernel's twin, which repeats the kernel's
    arithmetic, on the same inputs) and the calls themselves (the host
    dispatches of eager PyTorch)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip('_')
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            if name in _ELEMENTWISE:
                self.ops += out.numel()
            elif name in _REDUCING and isinstance(args[0], torch.Tensor):
                self.ops += args[0].numel()
            elif name in ('mm', 'bmm', 'matmul'):
                self.ops += 2 * out.numel() * args[0].shape[-1]
        return out


def counted(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its floating-point operation count)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.ops


def tensor_bytes(*objs):
    """Bytes of every tensor among ``objs`` (lists, tuples and dict values
    searched too)."""
    total = 0
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            total += obj.numel() * obj.element_size()
        elif isinstance(obj, (list, tuple)):
            total += tensor_bytes(*obj)
        elif isinstance(obj, dict):
            total += tensor_bytes(*obj.values())
    return total


def gather_bytes(table, idx, out, *small):
    """What a gather must move: the distinct table rows its row ids touch
    (every molecule, every wavenumber), the small per-layer inputs, and
    its output."""
    nmol, _, nwno = table.shape
    rows = torch.unique(idx).numel()
    return (rows * nmol * nwno * table.element_size()
            + tensor_bytes(idx, out, *small))


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def perturbed(scene, n):
    """bench.py:179-182: temperatures scaled by (1 + 0.001 i)."""
    return [scene._replace(tlevel=scene.tlevel * (1 + 0.001 * i),
                           tlayer=scene.tlayer * (1 + 0.001 * i))
            for i in range(n)]


# results of earlier phases that phases 50-54 hold the sharded runs
# against (filled as the script runs)
REUSED = {}
SCRIPT_T0 = time.perf_counter()


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; this script runs '
                         'only on a GPU machine')
    # phase 1: the card
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)} '
        f'count {torch.cuda.device_count()}')

    from picaso_tpu_torch import _build, disco, pipeline
    from picaso_tpu_torch.opacities import factory
    from picaso_tpu_torch.opacities.cuda_interp import (interp_tau,
                                                        interp_tau_plain,
                                                        interp_tau_q,
                                                        interp_tau_q_plain)
    from picaso_tpu_torch.opacities.db import load_opacity_db
    from picaso_tpu_torch.optics import combine_optics
    from picaso_tpu_torch.probes import (gather_ab, gather_probe,
                                         sweep_layout_probe)
    from picaso_tpu_torch.rt import cuda_sh, cuda_toon
    from picaso_tpu_torch.rt.cuda_toon import (spectrum_toon,
                                               spectrum_toon_plain)
    from picaso_tpu_torch.rt.toon import ScatteringControls
    dev = torch.device('cuda')
    wrappers = _build.kernel_wrappers()
    if sorted(wrappers) != sorted(KERNELS):
        raise AssertionError(f'kernel wrappers {sorted(wrappers)} are not '
                             f'KERNELS {sorted(KERNELS)}')

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f'[2] built {lib_path} in {time.perf_counter() - t0:.1f} s')

    # phase 3: the production problem
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    scene, grid, config = pipeline.build_problem(NWNO, nlevel=NLEVEL,
                                                 production=True, device=dev)
    torch.cuda.synchronize()
    table_bytes = grid.log_kappa.numel() * grid.log_kappa.element_size()
    log(f'[3] production problem in {time.perf_counter() - t0:.1f} s: '
        f'log_kappa {tuple(grid.log_kappa.shape)} {table_bytes} bytes, '
        f'{scene.ubar0.numel()} angles, peak '
        f'{torch.cuda.max_memory_allocated()} bytes')

    # phase 4: gather kernel vs twin
    g_args = pipeline.gather_args(scene, grid, config)
    k1 = interp_tau(*g_args)
    k1_ref, k1_ops = counted(interp_tau_plain, *g_args)
    torch.cuda.synchronize()
    k1_bytes = gather_bytes(g_args[0], g_args[1], k1, *g_args[2:])
    k1_max, k1_med = rel_stats(k1, k1_ref)
    k1_abs = (k1 - k1_ref).abs().max().item()
    log(f'[4] gather kernel vs twin {tuple(k1.shape)}: median rel '
        f'{k1_med:.3e}, max abs {k1_abs:.3e}')
    check('gather max rel', k1_max, TOL['gather_max_rel'])
    sc_scene = gather_ab.scattered_scene(scene, grid.pt)
    sc_args = pipeline.gather_args(sc_scene, grid, config)
    k1_sc = interp_tau(*sc_args)
    k1_sc_ref = interp_tau_plain(*sc_args)
    k1_abs = max(k1_abs, (k1_sc - k1_sc_ref).abs().max().item())
    log(f'[4] gather kernel vs twin, scattered profile '
        f'({torch.unique(sc_args[1]).numel()} distinct rows)')
    check('gather scattered max rel', rel_stats(k1_sc, k1_sc_ref)[0],
          TOL['gather_max_rel'])
    del k1_sc, k1_sc_ref

    # phase 5: spectrum kernel vs twin
    tg, tr, rf = pipeline.rt_sources(scene, grid, config)
    s_args, s_kw = pipeline.spectrum_args(scene, grid, config, tg, tr, rf)
    xint, therm = spectrum_toon(*s_args, **s_kw)
    (xint_ref, therm_ref), k2_ops = counted(spectrum_toon_plain, *s_args,
                                            **s_kw)
    torch.cuda.synchronize()
    k2_bytes = tensor_bytes(s_args, xint, therm)
    k2_abs = 0.0
    for name, out, ref in (('xint', xint, xint_ref),
                           ('thermal', therm, therm_ref)):
        if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
            raise AssertionError(f'spectrum {name}: non-finite values')
        mx, med = rel_stats(out, ref)
        k2_abs = max(k2_abs, (out - ref).abs().max().item())
        log(f'[5] spectrum kernel vs twin, {name} {tuple(out.shape)}: '
            f'max abs {(out - ref).abs().max().item():.3e}')
        check(f'spectrum {name} max rel', mx, TOL['spectrum_max_rel'])
        check(f'spectrum {name} median rel', med,
              TOL['spectrum_median_rel'])
    del xint, therm, xint_ref, therm_ref

    # phase 6: the main path, counted
    scenes = perturbed(scene, N_SCENES)
    reset_counts()
    outs = forwards_with_peaks(
        '[6] Toon', lambda s: pipeline.forward(s, grid, config), scenes)
    launches = counts()
    log(f'[6] {N_SCENES} forwards, launches {launches}')
    check_counts(launches, ('interp_tau', 'spectrum_toon'))
    check_outputs(outs)
    a = outs[0]
    log(f'    albedo mean {a["albedo"].mean().item():.6g}, thermal mean '
        f'{a["thermal"].mean().item():.6g}, transit mean '
        f'{a["transit_depth"].mean().item():.6g}')
    REUSED['toon'] = (scenes[0], outs[0])    # phase 50's unsharded forward
    del outs

    # phase 7: float64 oracle
    o_scene, o_grid, o_config = pipeline.build_problem(
        ORACLE_NWNO, nlevel=NLEVEL, production=False, device=dev,
        dtype=torch.float64)
    oracle = pipeline.forward(o_scene, o_grid, dataclasses.replace(
        o_config, use_kernels=False))
    f_scene, f_grid, f_config = pipeline.build_problem(
        ORACLE_NWNO, nlevel=NLEVEL, production=False, device=dev)
    f_out = pipeline.forward(f_scene, f_grid, f_config)
    torch.cuda.synchronize()
    for key in ('albedo', 'thermal', 'transit_depth'):
        mx, med = rel_stats(f_out[key], oracle[key])
        log(f'[7] f32 kernels vs f64 oracle, {key}')
        check(f'{key} max rel', mx, TOL['forward_max_rel'])
        check(f'{key} median rel', med, TOL['forward_median_rel'])

    # phase 8: timings (nothing asserted)
    s0 = scenes[0]
    plain_cfg = dataclasses.replace(config, use_kernels=False)
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = wall_ms(lambda: pipeline.forward(s0, grid, config), 10)
    fwd_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plain_ms = wall_ms(lambda: pipeline.forward(s0, grid, plain_cfg), 5)
    plain_peak = torch.cuda.max_memory_allocated()
    fwd_ms2 = wall_ms(lambda: pipeline.forward(s0, grid, config), 10)
    log(f'[8] forward, kernels: {fwd_ms:.3f} / {fwd_ms2:.3f} ms '
        f'({1e3 / min(fwd_ms, fwd_ms2):.2f} forwards/s), peak {fwd_peak} '
        f'bytes; plain path: {plain_ms:.3f} ms '
        f'({1e3 / plain_ms:.2f} forwards/s), peak {plain_peak} bytes')
    k1_ms = cuda_ms(lambda: interp_tau(*g_args), 20)
    k1_plain_ms = cuda_ms(lambda: interp_tau_plain(*g_args), 5)
    k1_sc_ms = cuda_ms(lambda: interp_tau(*sc_args), 20)
    k2_ms = cuda_ms(lambda: spectrum_toon(*s_args, **s_kw), 10)
    k2_plain_ms = cuda_ms(lambda: spectrum_toon_plain(*s_args, **s_kw), 3)
    k2_stages = stages_ms(spectrum_toon, s_args, s_kw, 10)
    log(f'    interp_tau {k1_ms:.3f} ms (scattered profile {k1_sc_ms:.3f}) '
        f'vs twin {k1_plain_ms:.3f} ms; '
        f'spectrum_toon {k2_ms:.3f} ms (stage A + thermal '
        f'{k2_stages[0]:.3f}, stage B {k2_stages[1]:.3f}) vs twin '
        f'{k2_plain_ms:.3f} ms')

    # phase 9: SH kernels vs twins at the production shape
    sh = {}
    for stream in (4, 2):
        cfg = dataclasses.replace(config, rt_method=1, stream=stream)
        (r_args, r_kw), (t_args, t_kw) = pipeline.sh_args(scene, grid, cfg,
                                                          tg, tr, rf)
        for kind, args, kw in (('reflected', r_args, r_kw),
                               ('thermal', t_args, t_kw)):
            name = f'{kind}_sh{stream}'
            kern = getattr(cuda_sh, name)
            twin = getattr(cuda_sh, f'{name}_plain')
            out = kern(*args, **kw)
            ref, ops = counted(twin, *args, **kw)
            torch.cuda.synchronize()
            nbytes = tensor_bytes(args, out)
            err = check_twin(name, out, ref, phase=9)
            del out, ref
            sh[name] = {'max_abs_err': err,
                        'ms': cuda_ms(lambda: kern(*args, **kw), 10),
                        'plain_ms': cuda_ms(lambda: twin(*args, **kw), 2),
                        'bytes': nbytes, 'ops': ops,
                        'stages_ms': stages_ms(kern, args, kw, 10)}
            log(f'    {name} {sh[name]["ms"]:.3f} ms (stages '
                f'{sh[name].get("stages_ms")}) vs twin '
                f'{sh[name]["plain_ms"]:.3f} ms')
    # reflected_sh4 and thermal_sh4 alone at the phase curve's 6 x 6 disk
    # (36 angles, 45 degrees)
    scene_36 = pipeline.with_geometry(scene, disco.make_geometry(
        math.radians(45.0), num_gangle=6, num_tangle=6))
    sh36 = dict(zip(('reflected_sh4', 'thermal_sh4'), pipeline.sh_args(
        scene_36, grid, dataclasses.replace(config, rt_method=1, stream=4),
        tg, tr, rf)))
    for name, (args, kw) in sh36.items():
        kern = getattr(cuda_sh, name)
        out = kern(*args, **kw)
        ref = getattr(cuda_sh, f'{name}_plain')(*args, **kw)
        torch.cuda.synchronize()
        err = check_twin(f'{name} 36 angles', out, ref, phase=9)
        del out, ref
        sh[name].update(
            phase_curve_max_abs_err=err,
            phase_curve_ms=cuda_ms(lambda: kern(*args, **kw), 10),
            phase_curve_stages_ms=stages_ms(kern, args, kw, 10))
        log(f'    {name} at 36 angles {sh[name]["phase_curve_ms"]:.3f} ms '
            f'(stages {sh[name]["phase_curve_stages_ms"]})')
    del sh36, scene_36

    # phase 10: the SH main paths, counted
    for stream in (4, 2):
        cfg = dataclasses.replace(config, rt_method=1, stream=stream)
        reset_counts()
        outs = forwards_with_peaks(
            f'[10] SH{stream}', lambda s: pipeline.forward(s, grid, cfg),
            scenes)
        got = counts()
        log(f'[10] SH{stream}: {N_SCENES} forwards, launches {got}')
        check_counts(got, ('interp_tau', f'reflected_sh{stream}',
                           f'thermal_sh{stream}'))
        check_outputs(outs)
        for kind in ('reflected', 'thermal'):
            launches[f'{kind}_sh{stream}'] = got[f'{kind}_sh{stream}']
        a = outs[0]
        log(f'     albedo mean {a["albedo"].mean().item():.6g}, thermal '
            f'mean {a["thermal"].mean().item():.6g}')
        del outs

    # phase 11: float64 SH oracle
    for stream in (4, 2):
        oracle = pipeline.forward(o_scene, o_grid, dataclasses.replace(
            o_config, rt_method=1, stream=stream, use_kernels=False))
        f_out = pipeline.forward(f_scene, f_grid, dataclasses.replace(
            f_config, rt_method=1, stream=stream))
        torch.cuda.synchronize()
        for key in ('albedo', 'thermal', 'transit_depth'):
            mx, med = rel_stats(f_out[key], oracle[key])
            log(f'[11] SH{stream} f32 kernels vs f64 oracle, {key}')
            kind = 'forward' if key == 'transit_depth' else 'sh'
            check(f'SH{stream} {key} max rel', mx, TOL[f'{kind}_max_rel'])
            check(f'SH{stream} {key} median rel', med,
                  TOL[f'{kind}_median_rel'])

    # phase 12: SH forward timings and peaks (nothing asserted)
    for stream in (4, 2):
        cfg = dataclasses.replace(config, rt_method=1, stream=stream)
        plain_cfg = dataclasses.replace(cfg, use_kernels=False)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        alive = torch.cuda.memory_allocated()
        pipeline.forward(s0, grid, cfg)
        torch.cuda.synchronize()
        fwd_peak = torch.cuda.max_memory_allocated()
        log(f'[12] SH{stream} forward: {held} bytes allocated, {alive} alive '
            f'after gc.collect(); peak {fwd_peak} bytes (+{fwd_peak - alive})')
        fwd_ms = wall_ms(lambda: pipeline.forward(s0, grid, cfg), 10)
        plain_ms = wall_ms(lambda: pipeline.forward(s0, grid, plain_cfg), 2)
        fwd_ms2 = wall_ms(lambda: pipeline.forward(s0, grid, cfg), 10)
        log(f'[12] SH{stream} forward, kernels: {fwd_ms:.3f} / '
            f'{fwd_ms2:.3f} ms ({1e3 / min(fwd_ms, fwd_ms2):.2f} '
            f'forwards/s), peak {fwd_peak} bytes; plain path: '
            f'{plain_ms:.3f} ms ({1e3 / plain_ms:.2f} forwards/s)')

    # phase 13: the split Toon kernels vs their twins (production shape)
    scene_p, _, config_p = pipeline.with_raman(scene, grid, config, 1)
    tg_p, tr_p, rf_p = pipeline.rt_sources(scene_p, grid, config_p)
    props = {mode: combine_optics(tg, tr, scene.cld_opd, scene.cld_w0,
                                  scene.cld_g0, rf, test_mode=mode)
             for mode in (None, 'rayleigh')}
    t_args, t_kw = pipeline.thermal_args(scene, grid, config, tg, tr)
    runs = {  # kernel -> [(label, args, kwargs)], the first one timed
        'reflected_toon': [('reflected_toon pollack', *pipeline.
                            reflected_args(scene_p, config_p, tg_p, tr_p,
                                           rf_p))],
        'reflected_toon_props': [
            (f'reflected_toon_props {mode or "unfused"}', *pipeline.
             reflected_args(scene, config, tg, tr, rf, props[mode]))
            for mode in props],
        'thermal_toon': [
            (f'thermal_toon hard_surface={hs}', t_args,
             dict(t_kw, hard_surface=hs)) for hs in (False, True)],
        'thermal_toon_props': [
            (f'thermal_toon_props {mode or "unfused"}', *pipeline.
             thermal_args(scene, grid, config, tg, tr, props[mode]))
            for mode in props],
    }
    # the reflected kernels at multi_phase=2 (isotropic) too
    iso = ScatteringControls(multi_phase=2)
    for name in ('reflected_toon', 'reflected_toon_props'):
        label, args, kw = runs[name][0]
        runs[name].append((f'{label} isotropic', args,
                           dict(kw, controls=iso)))
    split = {}
    for name, cases in runs.items():
        kern = getattr(cuda_toon, name)
        twin = getattr(cuda_toon, f'{name}_plain')
        err = 0.0
        sizes = []
        for label, args, kw in cases:
            out = kern(*args, **kw)
            ref, ops = counted(twin, *args, **kw)
            torch.cuda.synchronize()
            sizes.append((tensor_bytes(args, out), ops))
            err = max(err, check_twin(label, out, ref))
            del out, ref
        _, args, kw = cases[0]
        split[name] = {'max_abs_err': err,
                       'ms': cuda_ms(lambda: kern(*args, **kw), 10),
                       'plain_ms': cuda_ms(lambda: twin(*args, **kw), 3),
                       'bytes': sizes[0][0], 'ops': sizes[0][1]}
        split[name]['stages_ms'] = stages_ms(kern, args, kw, 10)
        log(f'     {name} {split[name]["ms"]:.3f} ms '
            f'(stages {split[name]["stages_ms"]}) vs twin '
            f'{split[name]["plain_ms"]:.3f} ms')
    del runs, props
    # K3 and K4 alone at the phase curve's 6 x 6 disk (36 angles, 45
    # degrees)
    geom_36 = disco.make_geometry(math.radians(45.0), num_gangle=6,
                                  num_tangle=6)
    scene_36 = pipeline.with_geometry(scene_p, geom_36)
    runs_36 = {
        'reflected_toon': pipeline.reflected_args(
            scene_36, config_p,
            *pipeline.rt_sources(scene_36, grid, config_p)),
        'thermal_toon': pipeline.thermal_args(
            pipeline.with_geometry(scene, geom_36), grid, config, tg, tr),
    }
    for name, (args, kw) in runs_36.items():
        kern = getattr(cuda_toon, name)
        out = kern(*args, **kw)
        ref = getattr(cuda_toon, f'{name}_plain')(*args, **kw)
        torch.cuda.synchronize()
        err = check_twin(f'{name} 36 angles', out, ref)
        del out, ref
        split[name].update(
            phase_curve_max_abs_err=err,
            phase_curve_ms=cuda_ms(lambda: kern(*args, **kw), 10),
            phase_curve_stages_ms=stages_ms(kern, args, kw, 10))
        log(f'     {name} at 36 angles {split[name]["phase_curve_ms"]:.3f} '
            f'ms (stages {split[name]["phase_curve_stages_ms"]})')
    del runs_36, scene_36

    # phase 14: the split Toon paths, counted
    paths = {
        'reflected-only (Pollack)': (
            dataclasses.replace(config_p, thermal=False),
            perturbed(scene_p, N_SCENES), ('interp_tau', 'reflected_toon'),
            ('albedo', 'transit_depth')),
        'thermal-only': (
            dataclasses.replace(config, reflected=False), scenes,
            ('interp_tau', 'thermal_toon'), ('thermal', 'transit_depth')),
        'unfused optics': (
            dataclasses.replace(config, fuse_optics=False), scenes,
            ('interp_tau', 'reflected_toon_props', 'thermal_toon_props'),
            ('albedo', 'thermal', 'transit_depth')),
    }
    for label, (cfg, path_scenes, expected, keys) in paths.items():
        reset_counts()
        outs = forwards_with_peaks(
            f'[14] {label}', lambda s: pipeline.forward(s, grid, cfg),
            path_scenes)
        got = counts()
        log(f'[14] {label}: {N_SCENES} forwards, launches {got}')
        check_counts(got, expected)
        check_outputs(outs, keys)
        for name in expected:
            if name in SPLIT_REPLACES:
                launches[name] = got[name]
        log('     ' + ', '.join(f'{k} mean {outs[0][k].mean().item():.6g}'
                                for k in keys))
        del outs
    refl_cfg = paths['reflected-only (Pollack)'][0]
    phase_batch = pipeline.stack_scenes([
        pipeline.with_geometry(s, disco.make_geometry(
            math.radians(deg), num_gangle=6, num_tangle=6))
        for s, deg in zip(perturbed(scene_p, N_SCENES), PHASES_DEG)])
    reset_counts()
    (batch_out,) = forwards_with_peaks(
        '[14] phase curve', lambda b: pipeline.forward_batch(b, grid,
                                                             refl_cfg),
        [phase_batch])
    got = counts()
    log(f'[14] phase curve at {PHASES_DEG} deg through forward_batch '
        f'({phase_batch.ubar0.shape[1]} x {phase_batch.ubar0.shape[2]} '
        f'disk), launches {got}')
    check_counts(got, ('interp_tau', 'reflected_toon'))
    check_outputs([batch_out], ('albedo', 'transit_depth'),
                  (N_SCENES, NWNO))
    log('     albedo mean per phase '
        + ', '.join(f'{a:.6g}' for a in batch_out['albedo'].mean(1).tolist()))
    del batch_out

    # phase 15: float64 oracle of the split paths
    oracle_cases = {
        'reflected-only, Oklopcic Raman': (0, dict(thermal=False)),
        'reflected-only, Pollack Raman': (1, dict(thermal=False)),
        'thermal-only': (2, dict(reflected=False)),
        "test_mode='constant_tau'": (2, dict(test_mode='constant_tau',
                                             thermal=False)),
    }
    for label, (raman, change) in oracle_cases.items():
        o_s, _, o_c = pipeline.with_raman(o_scene, o_grid, o_config, raman)
        f_s, _, f_c = pipeline.with_raman(f_scene, f_grid, f_config, raman)
        oracle = pipeline.forward(o_s, o_grid, dataclasses.replace(
            o_c, use_kernels=False, **change))
        f_out = pipeline.forward(f_s, f_grid, dataclasses.replace(
            f_c, **change))
        torch.cuda.synchronize()
        for key in f_out:
            mx, med = rel_stats(f_out[key], oracle[key])
            log(f'[15] {label}: f32 kernels vs f64 oracle, {key}')
            check(f'{key} max rel', mx, TOL['forward_max_rel'])
            check(f'{key} median rel', med, TOL['forward_median_rel'])

    # phase 16: timings of the split paths (nothing asserted)
    for label, (cfg, path_scenes, _, _) in paths.items():
        s0 = path_scenes[0]
        plain_cfg = dataclasses.replace(cfg, use_kernels=False)
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = wall_ms(lambda: pipeline.forward(s0, grid, cfg), 10)
        fwd_peak = torch.cuda.max_memory_allocated()
        plain_ms = wall_ms(lambda: pipeline.forward(s0, grid, plain_cfg), 3)
        fwd_ms2 = wall_ms(lambda: pipeline.forward(s0, grid, cfg), 10)
        log(f'[16] {label} forward, kernels: {fwd_ms:.3f} / {fwd_ms2:.3f} '
            f'ms ({1e3 / min(fwd_ms, fwd_ms2):.2f} forwards/s), peak '
            f'{fwd_peak} bytes; plain path: {plain_ms:.3f} ms '
            f'({1e3 / plain_ms:.2f} forwards/s)')
    plain_refl = dataclasses.replace(refl_cfg, use_kernels=False)
    b_ms = wall_ms(lambda: pipeline.forward_batch(phase_batch, grid,
                                                  refl_cfg), 5)
    b_plain_ms = wall_ms(lambda: pipeline.forward_batch(phase_batch, grid,
                                                        plain_refl), 2)
    log(f'[16] phase curve, {N_SCENES} scenes: kernels {b_ms:.3f} ms '
        f'({N_SCENES * 1e3 / b_ms:.2f} spectra/s); plain path '
        f'{b_plain_ms:.3f} ms')

    # phase 17: the int16 table of the production grid, on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g16 = grid.with_blocked_table(quantize=True)
    torch.cuda.synchronize()
    q_seconds = time.perf_counter() - t0
    q_table = g16.log_kappa_blocked
    log(f'[17] int16 table {tuple(q_table.shape)} '
        f'{q_table.numel() * q_table.element_size()} bytes (float table '
        f'{table_bytes}) quantized in {q_seconds:.3f} s; qparams '
        f'{g16.blocked_qparams.tolist()}')

    # phase 18: K8 vs its twin at the production shape
    q_args = pipeline.gather_args(scene, g16, config)
    k8 = interp_tau_q(*q_args)
    k8_ref, k8_ops = counted(interp_tau_q_plain, *q_args)
    torch.cuda.synchronize()
    k8_bytes = gather_bytes(q_args[0], q_args[1], k8, *q_args[2:])
    k8_max, k8_med = rel_stats(k8, k8_ref)
    k8_abs = (k8 - k8_ref).abs().max().item()
    log(f'[18] int16 gather kernel vs twin {tuple(k8.shape)}: median rel '
        f'{k8_med:.3e}, max abs {k8_abs:.3e}; vs the float gather max rel '
        f'{rel_stats(k8, k1)[0]:.3e}')
    check('int16 gather max rel', k8_max, TOL['gather_max_rel'])
    sc_q_args = pipeline.gather_args(sc_scene, g16, config)
    k8_sc = interp_tau_q(*sc_q_args)
    k8_sc_ref = interp_tau_q_plain(*sc_q_args)
    k8_abs = max(k8_abs, (k8_sc - k8_sc_ref).abs().max().item())
    log('[18] int16 gather kernel vs twin, scattered profile')
    check('int16 gather scattered max rel', rel_stats(k8_sc, k8_sc_ref)[0],
          TOL['gather_max_rel'])
    del k8_sc, k8_sc_ref
    k8_ms = cuda_ms(lambda: interp_tau_q(*q_args), 20)
    k8_sc_ms = cuda_ms(lambda: interp_tau_q(*sc_q_args), 20)
    k8_plain_ms = cuda_ms(lambda: interp_tau_q_plain(*q_args), 5)
    log(f'     interp_tau_q {k8_ms:.3f} ms (scattered profile '
        f'{k8_sc_ms:.3f}) vs twin {k8_plain_ms:.3f} ms')
    del k8, k8_ref

    # phase 19: the int16 path, counted
    reset_counts()
    outs = forwards_with_peaks(
        '[19] int16', lambda s: pipeline.forward(s, g16, config), scenes)
    got = counts()
    log(f'[19] int16 table: {N_SCENES} forwards, launches {got}')
    check_counts(got, ('interp_tau_q', 'spectrum_toon'))
    check_outputs(outs)
    launches['interp_tau_q'] = got['interp_tau_q']
    log('     ' + ', '.join(f'{k} mean {v.mean().item():.6g}'
                            for k, v in outs[0].items()))
    REUSED['int16'] = (scenes[0], outs[0])   # phase 50's unsharded forward
    del outs
    s0 = scenes[0]
    q_fwd = [wall_ms(lambda: pipeline.forward(s0, g16, config), 10)
             for _ in range(2)]
    log(f'     int16 forward, kernels: {q_fwd[0]:.3f} / {q_fwd[1]:.3f} ms '
        f'({1e3 / min(q_fwd):.2f} forwards/s)')

    # phase 20: float64 oracle of the int16 path
    oracle = pipeline.forward(o_scene, o_grid, dataclasses.replace(
        o_config, use_kernels=False))
    f_out = pipeline.forward(f_scene, f_grid.with_blocked_table(
        quantize=True), f_config)
    torch.cuda.synchronize()
    for key in ('albedo', 'thermal', 'transit_depth'):
        mx, med = rel_stats(f_out[key], oracle[key])
        log(f'[20] int16 f32 kernels vs f64 oracle, {key}')
        check(f'{key} max rel', mx, INT16_TOL['max_rel'])
        check(f'{key} median rel', med, INT16_TOL['median_rel'])

    # phase 21: sqlite round trip through the loader and K8
    db_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'build', 'chip_smoke')
    os.makedirs(db_dir, exist_ok=True)
    db_path = os.path.join(db_dir, 'opacity_1060.db')
    if os.path.exists(db_path):
        os.remove(db_path)
    t0 = time.perf_counter()
    factory.build_synthetic_db(db_path, np.linspace(300.0, 33000.0, DB_NWNO),
                               molecules=('H2O', 'CO'), pt_layout='1060',
                               device=dev)
    t1 = time.perf_counter()
    db_grid = load_opacity_db(db_path, device=dev)
    db_q = db_grid.with_blocked_table(quantize=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f'[21] wrote {db_path} ({os.path.getsize(db_path)} bytes) in '
        f'{t1 - t0:.2f} s, loaded and quantized in {t2 - t1:.2f} s: '
        f'log_kappa {tuple(db_grid.log_kappa.shape)}, molecules '
        f'{db_grid.molecules}, continua {db_grid.continuum_molecules}')
    db_scene, db_config = profile_scene(pipeline, db_grid)
    reset_counts()
    db_out = pipeline.forward(db_scene, db_q, db_config)
    torch.cuda.synchronize()
    got = counts()
    log(f'[21] one forward, launches {got}')
    check_counts(got, ('interp_tau_q', 'spectrum_toon'), forwards=1)
    db_ref = pipeline.forward(db_scene, db_grid, dataclasses.replace(
        db_config, use_kernels=False))
    check_outputs([db_out], shape=(DB_NWNO,))
    for key in ('albedo', 'thermal', 'transit_depth'):
        mx, med = rel_stats(db_out[key], db_ref[key])
        log(f'[21] database forward through K8 vs its f32 plain path, {key}')
        check(f'{key} max rel', mx, INT16_TOL['max_rel'])
        check(f'{key} median rel', med, INT16_TOL['median_rel'])
    os.remove(db_path)
    del db_grid, db_q

    # phase 22: the probes' kernels vs their twins, then their reports
    log_kappa, mixcol, slots = gather_probe.slot_inputs(scene, grid, config)
    li_kernel = gather_probe.interp_tau_layer_inner
    li_twin = gather_probe.interp_tau_layer_inner_plain
    li_abs = 0.0
    for name in ('raw', 'stabilized', 'parity'):
        ix, w = slots[name]
        out = li_kernel(log_kappa, ix, w, mixcol)
        ref, ops = counted(li_twin, log_kappa, ix, w, mixcol)
        torch.cuda.synchronize()
        li_abs = max(li_abs, (out - ref).abs().max().item())
        log(f'[22] layer-inner gather ({name} slots) vs twin')
        check(f'layer-inner {name} max rel', rel_stats(out, ref)[0],
              TOL['gather_max_rel'])
        check(f'layer-inner {name} vs K1 max rel', rel_stats(out, k1)[0],
              1e-4)
        if name == 'stabilized':
            li_ops, li_bytes = ops, gather_bytes(log_kappa, ix, out, w,
                                                 mixcol)
            li_plain_ms = cuda_ms(lambda: li_twin(log_kappa, ix, w, mixcol),
                                  3)
        del out, ref
    sw_args = sweep_layout_probe.sweep_inputs(90, 1920 * 128, dev)
    sw_ref, sw_ops = counted(sweep_layout_probe.sweep_plain, *sw_args)
    sw_plain_ms = cuda_ms(lambda: sweep_layout_probe.sweep_plain(*sw_args),
                          3)
    sw_abs = {}
    for name, fn in (('sweep_rows', sweep_layout_probe.sweep_rows),
                     ('sweep_staged', sweep_layout_probe.sweep_staged)):
        for kw in ([{}] if name == 'sweep_rows' else
                   [dict(tile=t) for t in sweep_layout_probe.TILES]):
            out = fn(*sw_args, **kw)
            torch.cuda.synchronize()
            sw_abs[name] = max(sw_abs.get(name, 0.0),
                               (out - sw_ref).abs().max().item())
            log(f'[22] {name} {kw} vs twin')
            check(f'{name} max rel', rel_stats(out, sw_ref)[0],
                  TOL['gather_max_rel'])
    sw_bytes = tensor_bytes(sw_args, sw_ref)
    del sw_args, sw_ref, out
    reset_counts()
    g_rep = gather_probe.report(scene, g16, config, n_iter=20, log=log)
    s_rep = sweep_layout_probe.report(n_iter=20, log=log)
    torch.cuda.synchronize()
    got = counts()
    log(f'[22] probes, launches {got}')
    for name in ('interp_tau_layer_inner', 'sweep_rows', 'sweep_staged'):
        if got[name] == 0:
            raise AssertionError(f'{name} was not launched by its probe')
        launches[name] = got[name]
    staged_ms, staged_label = min((v, k) for k, v in s_rep['ms'].items()
                                  if k != 'rows')

    climate = climate_phases(dev, reset_counts, counts)
    front_door = front_door_phases(dev, grid, reset_counts, counts)
    retrieval = retrieval_phases(dev, grid, reset_counts, counts)
    climate_modes = climate_modes_phases(dev, grid, reset_counts, counts)
    ck_files = ck_files_phases(dev, grid, reset_counts, counts, smi[0])
    host_tools = host_tools_phases(dev, grid, reset_counts, counts, smi[0])
    mesh = mesh_phases(dev, grid, g16, config, reset_counts, counts, smi[0])
    for paths in (front_door['launches'], retrieval['launches'],
                  climate_modes['launches'], ck_files['launches'],
                  host_tools['launches'], mesh['launches']):
        for path in paths.values():
            for name, count in path.items():
                launches[name] += count

    # phase 55: summary
    log(f'chip_smoke wall {time.perf_counter() - SCRIPT_T0:.1f} s')
    log(smi[0])
    print(json.dumps({'climate': climate}))
    print(json.dumps({'front_door': front_door}))
    print(json.dumps({'retrieval': retrieval}))
    print(json.dumps({'climate_modes': climate_modes}))
    print(json.dumps({'ck_files': ck_files}))
    print(json.dumps({'host_tools': host_tools}))
    print(json.dumps({'mesh': mesh}))
    stats = {
        'interp_tau': dict(max_abs_err=k1_abs, ms=k1_ms,
                           plain_ms=k1_plain_ms, bytes=k1_bytes, ops=k1_ops,
                           scattered_ms=k1_sc_ms),
        'spectrum_toon': dict(max_abs_err=k2_abs, ms=k2_ms,
                              plain_ms=k2_plain_ms, bytes=k2_bytes,
                              ops=k2_ops, stages_ms=k2_stages),
        **sh, **split,
        'interp_tau_q': dict(max_abs_err=k8_abs, ms=k8_ms,
                             plain_ms=k8_plain_ms, bytes=k8_bytes,
                             ops=k8_ops, scattered_ms=k8_sc_ms),
        'interp_tau_layer_inner': dict(
            max_abs_err=li_abs, ms=g_rep['ms']['layer-inner (stabilized)'],
            plain_ms=li_plain_ms, bytes=li_bytes, ops=li_ops),
        'sweep_rows': dict(max_abs_err=sw_abs['sweep_rows'],
                           ms=s_rep['ms']['rows'], plain_ms=sw_plain_ms,
                           bytes=sw_bytes, ops=sw_ops),
        'sweep_staged': dict(max_abs_err=sw_abs['sweep_staged'],
                             ms=staged_ms, plain_ms=sw_plain_ms,
                             bytes=sw_bytes, ops=sw_ops,
                             layout=staged_label),
    }
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        st = stats[name]
        bound_ms, bound_by = bound(st['bytes'], st['ops'])
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'picaso_tpu_torch/csrc/{source}',
            'replaces': replaces, 'launches': launches[name],
            'front_door_launches': sum(
                path.get(name, 0)
                for path in front_door['launches'].values()),
            'retrieval_launches': sum(
                path.get(name, 0)
                for path in retrieval['launches'].values()),
            'climate_launches': sum(
                path.get(name, 0)
                for path in climate_modes['launches'].values()),
            'ck_files_launches': sum(
                path.get(name, 0)
                for path in ck_files['launches'].values()),
            'host_tools_launches': sum(
                path.get(name, 0)
                for path in host_tools['launches'].values()),
            'mesh_launches': sum(path.get(name, 0)
                                 for path in mesh['launches'].values()),
            **st, 'bound_ms': bound_ms, 'bound_by': bound_by,
            'bound_share': bound_ms / st['ms'], 'library_ms': None})
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def device_launches(fn):
    """(device kernels, their summed device ms, aten calls) of one fn():
    the kernels and memory operations the profiler records on the card,
    and the aten calls a dispatch counter sees."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    with OpCounter() as counter:
        fn()
    torch.cuda.synchronize()
    return (len(on_card), sum(e.device_time for e in on_card) / 1e3,
            counter.calls)


def climate_inputs(nlevel, F0PI=None, rfacv=0.0):
    """bench.py:492-513's brown dwarf at ``nlevel`` levels; at the
    TPU-parity depth the convective-zone guess of scripts/tpu_parity.py
    (rcb_guess 31 of 41), else nlevel - 20."""
    from picaso_tpu_torch.climate.api import ClimateInputs
    pressure = np.logspace(-4, 2.5, nlevel)
    guess = np.clip(CLIMATE_TEFF * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    rcb = 31 if nlevel == CLIMATE_PARITY_NLEVEL else nlevel - 20
    return ClimateInputs(t_eff=CLIMATE_TEFF, gravity=1e4, pressure=pressure,
                         guess=guess, nstr=(0, rcb, nlevel - 2, 0, 0, 0),
                         rfacv=rfacv, F0PI=F0PI)


def climate_level_fluxes(ck, nlevel, temp, where):
    """{label: [thermal F+, F-, reflected F+, F-]} ([nlevel, nwno] each, in
    f64 on the card) at temperature ``temp`` (the opacities of
    build_opacities there), for each (label, device, dtype) of ``where``;
    the reflected half under a flat stellar flux."""
    from picaso_tpu_torch.climate import api, core, fused
    inputs = climate_inputs(nlevel, F0PI=np.ones(ck.nwno), rfacv=1.0)
    card = ck.arrays.wno.device
    level = {}
    for label, dev, dtype in where:
        st = api.climate_state(inputs, ck, device=dev, dtype=dtype,
                               verbose=False)
        a, d = st.ck.arrays, st.data
        t = torch.as_tensor(np.asarray(temp), dtype=dtype, device=dev)
        config = st.fused_config(10, False)
        props = fused.build_opacities(t, d, st.chem_grid, a, config)
        thermal = core.thermal_level_fluxes(t[None], props, d.plevel,
                                            st.geom, a.wno, a.delta_wno,
                                            a.gauss_wts, d.surf_reflect)
        fluxes = [x[:, 0] for x in thermal[:2]] + list(
            core.visible_level_fluxes(props, d.plevel, d.F0PI, a.gauss_wts,
                                      d.surf_reflect, config.controls)[:2])
        level[label] = [x.to(card, torch.float64) for x in fluxes]
    torch.cuda.synchronize()
    return level


LEVEL_NAMES = ('thermal F+', 'thermal F-', 'reflected F+', 'reflected F-')


def report_level_fluxes(label, x_fluxes, y_fluxes, gated):
    """Each level flux of x against y: max and median rel, the levels whose
    max rel exceeds the forward gate and the largest flux there over the
    largest overall; ``gated``: each within phase 7's gates.  Returns
    {name: numbers}."""
    out = {}
    for name, x, y in zip(LEVEL_NAMES, x_fluxes, y_fluxes):
        mx, med = rel_stats(x, y)
        top = y.abs().max().item()
        rel = (x - y).abs() / torch.clamp(y.abs(), min=top * 1e-9)
        over = torch.nonzero(rel.amax(1) > TOL['forward_max_rel'])[:, 0]
        scale = (y[over].abs().max().item() / top) if over.numel() else 0.0
        log(f'{label} {name}: max rel {mx:.3e}, median rel {med:.3e}; '
            f'levels over {TOL["forward_max_rel"]:.0e}: {over.tolist()} '
            f'(largest flux there {scale:.1e} of the largest)')
        out[name] = dict(max_rel=mx, median_rel=med, levels_over=over.tolist(),
                         largest_there=scale)
        if gated:
            check(f'{name} max rel', mx, TOL['forward_max_rel'])
            check(f'{name} median rel', med, TOL['forward_median_rel'])
    return out


def climate_run(label, inputs, ck, dtype, dev, reset_counts, counts):
    """run_climate on the card with its defaults but ``dtype``: finite
    temperatures, no kernel launched, converged, and the flux balance
    max |flux_net| / (sigma Teff^4) over the radiative zone within
    tests/test_climate.py's 1e-3.  Returns (its output, its numbers)."""
    from picaso_tpu_torch.climate import api, core, fused
    solve = fused.ClimateCounts()
    reset_counts()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = api.run_climate(inputs, ck, verbose=False, counts=solve,
                          device=dev, **({} if dtype is None
                                         else dict(dtype=dtype)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = {k: v for k, v in counts().items() if v}
    temp = out['temperature']
    nstr = [int(i) for i in out['cvz_locs']]
    resid = out['flux_balance']['flux_net'][:max(nstr[1], 1)]
    balance = float(np.abs(resid).max()
                    / (core.SIGMA_SB * CLIMATE_TEFF ** 4))
    numbers = dict(wall_s=wall, converged=int(out['converged']),
                   cvz_locs=nstr, flux_balance=balance, peak_bytes=peak,
                   nlevel=len(temp), nwno=ck.nwno,
                   **dataclasses.asdict(solve))
    log(f'     {label}: {json.dumps(numbers)}; T top {temp[0]:.3f} K, '
        f'bottom {temp[-1]:.3f} K')
    if launched:
        raise AssertionError(f'{label}: the climate path launched {launched}')
    if not np.isfinite(temp).all():
        raise AssertionError(f'{label}: non-finite temperatures')
    if out['converged'] != 1:
        raise AssertionError(f'{label}: did not converge')
    check(f'{label} flux balance', balance, CLIMATE_BALANCE)
    return out, numbers


def climate_phases(dev, reset_counts, counts):
    """Phases 23-25: the climate fluxes and full solves on the card."""
    from picaso_tpu_torch.climate import api, core, fused
    from picaso_tpu_torch.opacities.ck import synthetic_ck_table

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           CLIMATE_REFERENCE)) as f:
        reference = json.load(f)
    nl, nl_parity = CLIMATE_NLEVEL, CLIMATE_PARITY_NLEVEL
    cpu = torch.device('cpu')
    f32, f64 = torch.float32, torch.float64
    summary = {}
    # phase 23: the costs at the production shape in both dtypes, and the
    # level fluxes at the guess
    t0 = time.perf_counter()
    ck196 = synthetic_ck_table(device=dev)
    log(f'[23] 196-bin CK table on the card in '
        f'{time.perf_counter() - t0:.2f} s: ln_kappa '
        f'{tuple(ck196.arrays.ln_kappa.shape)}')
    inputs = climate_inputs(nl)
    zones = core.zone_maps(inputs.nstr, 1, nl)
    costs = {}
    for dtype in (f64, f32):
        st = api.climate_state(inputs, ck196, device=dev, dtype=dtype,
                               verbose=False)
        a, d = st.ck.arrays, st.data
        temp = core.reconstruct_profile(
            torch.tensor(inputs.guess, dtype=dtype, device=dev), zones,
            d.plevel, st.adiabat)
        props = fused.build_opacities(temp, d, st.chem_grid, a,
                                      st.fused_config(10, False))

        def flux_eval():
            return core.thermal_fluxes(temp, props, d.plevel, st.geom, a.wno,
                                       a.delta_wno, a.gauss_wts,
                                       d.surf_reflect)

        fni, fnil, _ = flux_eval()
        for label, fn in [('flux_eval', flux_eval)] + [
                (f'jacobian_{jb or "all"}', (lambda c: lambda: fused.jacobian(
                    temp, temp, fni, fnil, props, zones, d, st.geom, a,
                    st.adiabat, c))(st.fused_config(10, False, jb)))
                for jb in (None, 8)]:
            label = f'{label}_{str(dtype)[6:]}'
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ev_ms = cuda_ms(fn, 3)
            peak = torch.cuda.max_memory_allocated()
            host_ms = wall_ms(fn, 3)
            kernels, device_ms, aten = device_launches(fn)
            costs[label] = dict(event_ms=ev_ms, wall_ms=host_ms,
                                device_launches=kernels,
                                device_busy_ms=device_ms, aten_calls=aten,
                                peak_bytes=peak)
            log(f'[23] {label}: {json.dumps(costs[label])}')
        del props, fni, fnil, st, temp
    summary['costs'] = costs
    level = climate_level_fluxes(ck196, nl, inputs.guess, (
        ('card', dev, f64), ('cpu', cpu, f64), ('card f32', dev, f32)))
    summary[f'level_fluxes_{nl}_guess'] = report_level_fluxes(
        f'[23] level fluxes at {nl} levels, the guess, f64 card vs CPU:',
        level['card'], level['cpu'], gated=True)
    summary[f'level_fluxes_{nl}_guess_f32'] = report_level_fluxes(
        f'[23] level fluxes at {nl} levels, the guess, f32 vs f64 on the '
        f'card (reported: the f32 opt-in, ROADMAP Queue 3):',
        level['card f32'], level['card'], gated=False)
    del level

    # phases 24 (196 bins) and 25 (661 bins): the default (f64) solve at
    # the production depth against the JAX package's, then the f32 opt-in
    # against f64 at the TPU-parity depth
    runs = {}
    for table, phase in (('196', 24), ('661', 25)):
        if table == '196':
            ck = ck196
        else:
            t0 = time.perf_counter()
            ck = synthetic_ck_table(grid661=True, device=dev)
            log(f'[25] 661-bin CK table on the card in '
                f'{time.perf_counter() - t0:.2f} s')
        key = f'{table}_{nl}'
        out, runs[key] = climate_run(
            f'[{phase}] {table} bins, {nl} levels, defaults (f64)',
            climate_inputs(nl), ck, None, dev, reset_counts, counts)
        ref = reference[key]
        d_t = float(np.abs(out['temperature']
                           - np.asarray(ref['temperature'])).max())
        runs[key]['max_dT_to_jax'] = d_t
        if key == f'196_{nl}':       # phase 53's unsharded solve
            REUSED['climate'] = dict(temperature=out['temperature'],
                                     numbers=runs[key], ck=ck)
        log(f'[{phase}] {table} bins, {nl} levels, against the JAX '
            f'package\'s f64 solve: converged {ref["converged"]}, cvz_locs '
            f'{ref["cvz_locs"]}')
        if (runs[key]['converged'], runs[key]['cvz_locs']) != (
                ref['converged'], ref['cvz_locs']):
            raise AssertionError(f'{key}: converged / cvz_locs differ from '
                                 f'the JAX package\'s')
        check(f'{table}-bin climate max |dT| to the JAX package (K)', d_t,
              CLIMATE_DT_MAX)
        level = climate_level_fluxes(ck, nl, out['temperature'], (
            ('card', dev, f64), ('cpu', cpu, f64)))
        summary[f'level_fluxes_{key}_solution'] = report_level_fluxes(
            f'[{phase}] level fluxes at the {nl}-level solution, f64 card '
            f'vs CPU:', level['card'], level['cpu'], gated=True)
        del level, out
        temps = {}
        for label, dtype in (('f64', f64), ('f32', f32)):
            k = f'{table}_{nl_parity}_{label}'
            out, runs[k] = climate_run(
                f'[{phase}] {table} bins, {nl_parity} levels, {label}',
                climate_inputs(nl_parity), ck, dtype, dev, reset_counts,
                counts)
            temps[label] = out['temperature']
        d_t = float(np.abs(temps['f32'] - temps['f64']).max())
        runs[f'{table}_{nl_parity}_max_dT'] = d_t
        log(f'[{phase}] {table} bins, {nl_parity} levels, f32 vs f64')
        check(f'{table}-bin climate f32 max |dT| (K)', d_t, CLIMATE_DT_MAX)
        if table == '196':
            level = climate_level_fluxes(ck, nl_parity, temps['f64'], (
                ('f64', dev, f64), ('f32', dev, f32)))
            summary[f'level_fluxes_{nl_parity}_solution_f32'] = (
                report_level_fluxes(
                    f'[24] level fluxes at the {nl_parity}-level f64 '
                    f'solution, f32 vs f64:', level['f32'], level['f64'],
                    gated=True))
            del level
        del ck
    summary['runs'] = runs
    return summary


# ---------------------------------------------------------------------------
# the front door (picaso_tpu_torch.justdoit): phases 26-29
# ---------------------------------------------------------------------------

def oracle_connections(jdi, dev):
    """The facade's connections at nwno = 5000 on the production layout
    (16 molecules, the ragged grid): float32 on the card, float64 on the
    CPU, the same table."""
    from picaso_tpu_torch import pipeline
    from picaso_tpu_torch.opacities import factory
    from picaso_tpu_torch.opacities.db import PTGrid
    wno = np.linspace(300.0, 33000.0, ORACLE_NWNO)
    g64 = factory.synthetic_opacity_grid_ragged(
        wno, molecules=pipeline.MOLECULES_16, dtype=torch.float64,
        device=dev)

    def moved(device, dtype):
        def mv(x):
            return (x.to(device, dtype) if x.is_floating_point()
                    else x.to(device))
        return g64._replace(wno=mv(g64.wno), log_kappa=mv(g64.log_kappa),
                            pt=PTGrid(*(mv(x) for x in g64.pt)),
                            cont_opa=mv(g64.cont_opa),
                            cia_temps=mv(g64.cia_temps))
    card = jdi.Opacity(wno, grid=moved(dev, torch.float32))
    cpu = jdi.Opacity(wno, grid=moved(torch.device('cpu'), torch.float64))
    return card, cpu


def check_oracle(label, out, ref, keys):
    """Each of ``keys`` of the card's f32 output against the CPU's f64
    within phase 7's gates.  Returns {key: [max rel, median rel]}."""
    stats = {}
    for key in keys:
        if isinstance(out, dict) and isinstance(next(iter(out.values())),
                                                dict):
            a = np.concatenate([o[key] for o in out.values()])
            b = np.concatenate([r[key] for r in ref.values()])
        else:
            a, b = out[key], ref[key]
        mx, med = rel_stats(torch.as_tensor(a), torch.as_tensor(b))
        log(f'{label}: f32 card vs f64 CPU, {key}')
        check(f'{key} max rel', mx, TOL['forward_max_rel'])
        check(f'{key} median rel', med, TOL['forward_median_rel'])
        stats[key] = [mx, med]
    return stats


def check_finite(label, out, keys):
    for key in keys:
        val = np.asarray(out[key])
        if val.shape != (NWNO,) or not np.isfinite(val).all():
            raise AssertionError(f'{label} {key}: shape {val.shape} or '
                                 f'non-finite')


def timed_call(fn):
    """(fn(), wall ms to the end of the card's work, peak bytes over the
    bytes alive before the call)."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    alive = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return out, wall, torch.cuda.max_memory_allocated() - alive


def front_door_phases(dev, grid, reset_counts, counts):
    """Phases 26-29: the facade (justdoit) at full width on the production
    table -- 1D spectra, a 36-facet 3D spectrum, a 144-facet thermal phase
    curve and a 4-scene batched reflected phase curve -- with each path's
    kernel launches counted, and each against the same facade in float64
    on the CPU at nwno 5000."""
    from picaso_tpu_torch import justdoit as jdi
    from picaso_tpu_torch.probes.front_door import facade_case
    summary = {'launches': {}}
    opa = jdi.Opacity(grid.wno, grid=grid)
    calc = 'reflected+thermal+transmission'
    keys = ('albedo', 'thermal', 'transit_depth')

    def counted_path(label, fn, expected, calls=1):
        """fn() with the launch counts set to 0 just before and read just
        after: each kernel of ``expected`` launched as often as it says,
        no other kernel."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in counts().items() if v}
        log(f'{label}: launches {got}')
        if got != expected:
            raise AssertionError(f'{label}: launches {got}, expected '
                                 f'{expected}')
        summary['launches'][label] = got
        return out

    # phase 26: 1D at full width, 4 calls (the last at multi_phase=2)
    walls, peaks = [], []
    settings = [dict(scale=1 + 0.001 * i) for i in range(N_SCENES - 1)] + [
        dict(multi_phase='isotropic')]

    def four_calls():
        outs = []
        for kw in settings:
            out, wall, peak = timed_call(
                lambda: facade_case(opa, **kw).spectrum(
                    opa, calculation=calc))
            outs.append(out)
            walls.append(wall)
            peaks.append(peak)
        return outs
    n = len(settings)
    outs = counted_path('[26] 1D spectrum (4 calls)', four_calls, {
        'interp_tau': n, 'reflected_toon_props': n, 'thermal_toon_props': n})
    for i, out in enumerate(outs):
        check_finite(f'[26] call {i}', out, keys)
    iso_change = rel_stats(torch.as_tensor(outs[-1]['albedo']),
                           torch.as_tensor(outs[0]['albedo']))[0]
    log(f'[26] 1D wall ms {walls}, peak bytes over alive {peaks}; '
        f'albedo mean {outs[0]["albedo"].mean():.6g}, thermal mean '
        f'{outs[0]["thermal"].mean():.6g}, isotropic vs N=2 albedo max rel '
        f'{iso_change:.3e}')
    summary['1d'] = dict(wall_ms=walls, peak_bytes=peaks,
                         isotropic_vs_n2_max_rel=iso_change)
    del outs

    # phase 27: the 1D oracle, nwno 5000
    t0 = time.perf_counter()
    o_card, o_cpu = oracle_connections(jdi, dev)
    log(f'[27] oracle connections in {time.perf_counter() - t0:.2f} s')
    summary['1d_oracle'] = {}
    for mp in ('N=2', 'isotropic'):
        out = facade_case(o_card, multi_phase=mp).spectrum(
            o_card, calculation=calc)
        ref = facade_case(o_cpu, multi_phase=mp).spectrum(
            o_cpu, calculation=calc)
        summary['1d_oracle'][mp] = check_oracle(
            f'[27] 1D multi_phase={mp}', out, ref, keys)

    # phase 28: 3D at full width, 36 facets
    nfacet = 36
    kw3 = dict(disk=(6, 6), atmosphere='3d')
    out3, wall3, peak3 = counted_path(
        '[28] 3D spectrum (36 facets)', lambda: timed_call(
            lambda: facade_case(opa, **kw3).spectrum(
                opa, calculation='reflected+thermal', dimension='3d')),
        {'interp_tau': nfacet, 'reflected_toon_props': nfacet,
         'thermal_toon_props': nfacet})
    check_finite('[28] 3D', out3, ('albedo', 'thermal'))
    log(f'[28] 3D wall {wall3:.1f} ms, peak {peak3} bytes over alive; '
        f'albedo mean {out3["albedo"].mean():.6g}, thermal mean '
        f'{out3["thermal"].mean():.6g}')
    check('3D peak over alive (GB)', peak3 / 1e9, 2.0)
    uniform = dict(case='browndwarf', disk=(6, 6))
    u3 = facade_case(opa, atmosphere='uniform', **uniform).spectrum(
        opa, calculation='thermal', dimension='3d')
    u1 = facade_case(opa, clouds=False, **uniform).spectrum(
        opa, calculation='thermal')
    u_rel = rel_stats(torch.as_tensor(u3['thermal']),
                      torch.as_tensor(u1['thermal']))[0]
    log('[28] uniform map, 3D thermal vs 1D thermal')
    check('uniform 3D vs 1D max rel', u_rel, 1e-5)
    kw_o = dict(disk=(3, 3), atmosphere='3d')
    summary['3d'] = dict(
        wall_ms=wall3, peak_bytes=peak3, uniform_max_rel=u_rel,
        oracle=check_oracle(
            '[28] 3D, 3 x 3 disk',
            facade_case(o_card, **kw_o).spectrum(
                o_card, calculation='reflected+thermal', dimension='3d'),
            facade_case(o_cpu, **kw_o).spectrum(
                o_cpu, calculation='reflected+thermal', dimension='3d'),
            ('albedo', 'thermal')))
    del out3, u3, u1

    # phase 29: phase curves
    phases4 = np.linspace(0, 2 * np.pi, 4, endpoint=False)
    kw_t = dict(case='browndwarf', phase_grid=phases4, calculation='thermal',
                atmosphere='4d')
    curve, wall_t, peak_t = counted_path(
        '[29] thermal phase curve (4 phases x 36 facets)',
        lambda: timed_call(lambda: facade_case(
            opa, disk=(6, 6), **kw_t).phase_curve(opa, verbose=False)),
        {'interp_tau': 4 * nfacet, 'thermal_toon_props': 4 * nfacet})
    for ph, out in curve.items():
        check_finite(f'[29] thermal phase {ph:.3f}', out, ('thermal',))
    means = [float(out['thermal'].mean()) for out in curve.values()]
    log(f'[29] thermal phase curve wall {wall_t:.1f} ms, peak {peak_t} '
        f'bytes over alive; disk means {means}')
    phases_r = np.radians(PHASES_DEG)
    kw_r = dict(phase_grid=phases_r, calculation='reflected')
    batch, wall_r, peak_r = counted_path(
        '[29] batched reflected phase curve (4 scenes)',
        lambda: timed_call(lambda: facade_case(
            opa, disk=(6, 6), **kw_r).phase_curve(opa, verbose=False)),
        {'interp_tau': N_SCENES, 'reflected_toon': N_SCENES})
    for ph, out in batch.items():
        check_finite(f'[29] reflected phase {ph:.3f}', out, ('albedo',))
    log(f'[29] batched reflected phase curve wall {wall_r:.1f} ms, peak '
        f'{peak_r} bytes over alive; albedo means '
        f'{[float(o["albedo"].mean()) for o in batch.values()]}')
    summary['phase_curves'] = dict(
        thermal_wall_ms=wall_t, thermal_peak_bytes=peak_t,
        thermal_disk_means=means, reflected_wall_ms=wall_r,
        reflected_peak_bytes=peak_r,
        thermal_oracle=check_oracle(
            '[29] thermal phase curve, 3 x 3 disks',
            facade_case(o_card, disk=(3, 3), **kw_t).phase_curve(
                o_card, verbose=False),
            facade_case(o_cpu, disk=(3, 3), **kw_t).phase_curve(
                o_cpu, verbose=False), ('thermal',)),
        reflected_oracle=check_oracle(
            '[29] batched reflected phase curve',
            facade_case(o_card, disk=(6, 6), **kw_r).phase_curve(
                o_card, verbose=False),
            facade_case(o_cpu, disk=(6, 6), **kw_r).phase_curve(
                o_cpu, verbose=False), ('albedo',)))
    del curve, batch, o_card, o_cpu
    return summary


# ---------------------------------------------------------------------------
# retrievals (sampler, driver, ncio; probes/retrieval.py): phases 30-33
# ---------------------------------------------------------------------------

LOGL_REL = 1e-3


def check_loglike(label, got, ref):
    """Log-likelihoods f32 on the card against f64 on the CPU: |d log L|
    <= 1e-3 |log L| at each point.  Returns the largest ratio."""
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        raise AssertionError(f'{label}: non-finite log-likelihoods')
    worst = float(np.max(np.abs(got - ref) / np.abs(ref)))
    log(f'{label}: log L card {got.tolist()} vs CPU {ref.tolist()}')
    check(f'{label} |d log L| / |log L|', worst, LOGL_REL)
    return worst


def retrieval_phases(dev, grid, reset_counts, counts):
    """Phases 30-33: retrievals on the production table -- the batched
    free retrieval (transmission with the nested sampler, thermal with the
    ensemble sampler), the TOML driver's likelihood per observation type
    and driver.run end to end, and the WASP-17b fit -- with each run's
    kernel launches counted, then each model and log-likelihood f32 on the
    card against f64 on the CPU at nwno 5000."""
    from picaso_tpu_torch import driver
    from picaso_tpu_torch import justdoit as jdi
    from picaso_tpu_torch.opacities import factory
    from picaso_tpu_torch.probes import retrieval as pr
    from picaso_tpu_torch.probes.front_door import _profiled
    from picaso_tpu_torch.sampler import ensemble_sample, nested_sample
    from picaso_tpu_torch.wavelength import mean_regrid
    summary = {'launches': {}}

    def counted_path(label, fn, expected):
        """fn() with the launch counts set to 0 just before and read just
        after; ``expected(out)`` the launches it must show, no other."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in counts().items() if v}
        want = expected(out)
        log(f'{label}: launches {got}')
        if got != want:
            raise AssertionError(f'{label}: launches {got}, expected '
                                 f'{want}')
        summary['launches'][label] = got
        return out

    def finite(label, *arrays):
        for a in arrays:
            if not np.isfinite(np.asarray(a, float)).all():
                raise AssertionError(f'{label}: non-finite values')

    # phase 30: batched free transmission retrieval, nested sampler
    free = pr.FreeRetrieval(grid, 'transmission')
    t0 = time.perf_counter()
    res = counted_path(
        '[30] nested free transmission retrieval',
        lambda: nested_sample(free.loglike, free.prior, 2, nlive=16,
                              max_iter=20, walks=3, seed=2),
        lambda _: {'interp_tau': free.scenes})
    wall = time.perf_counter() - t0
    finite('[30] logz and samples', res.logz, res.samples,
           res.samples_equal)
    med = np.median(res.samples_equal, axis=0)
    log(f'[30] {free.scenes} scenes in {len(free.batch_ms)} batches, '
        f'{wall:.2f} s, {free.scenes / wall:.2f} likelihoods/s, ms per '
        f'batch median {np.median(free.batch_ms):.1f}; logz '
        f'{res.logz:.3f}, medians {med.tolist()} (truth '
        f'{free.truth.tolist()})')
    summary['free_transmission'] = dict(
        scenes=free.scenes, batches=len(free.batch_ms), wall_s=wall,
        likelihoods_per_s=free.scenes / wall,
        batch_ms_median=float(np.median(free.batch_ms)),
        batch_ms_min=min(free.batch_ms), batch_ms_max=max(free.batch_ms),
        ms_per_scene=wall * 1e3 / free.scenes, logz=res.logz,
        niter=res.niter, medians=med.tolist())
    del res

    # phase 31: the same scenes thermal-only, ensemble sampler
    therm = pr.FreeRetrieval(grid, 'thermal')
    p0 = therm.prior(np.random.default_rng(3).random((8, 2)))
    (chain, lps), wall_ms, peak = counted_path(
        '[31] ensemble free emission retrieval (8 walkers x 4 steps)',
        lambda: timed_call(lambda: ensemble_sample(therm.loglike, p0, 4,
                                                   seed=1)),
        lambda _: {'interp_tau': therm.scenes,
                   'thermal_toon': therm.scenes})
    finite('[31] chain and log-probabilities', chain, lps)
    log(f'[31] {therm.scenes} scenes in {wall_ms:.0f} ms, '
        f'{therm.scenes / wall_ms * 1e3:.2f} spectra/s, peak {peak} bytes '
        f'over alive, ms per batch median {np.median(therm.batch_ms):.1f}')
    summary['free_emission'] = dict(
        scenes=therm.scenes, wall_ms=wall_ms,
        spectra_per_s=therm.scenes / wall_ms * 1e3, peak_bytes=peak,
        batch_ms_median=float(np.median(therm.batch_ms)),
        final_log_probs=lps[-1].tolist())

    # phase 32: the TOML driver at full width, per observation type
    opa = jdi.Opacity(grid.wno, grid=grid)
    thetas = [[900.0, -3.5], [1000.0, -3.0], [1100.0, -2.5], [1250.0, -4.0]]
    summary['driver'] = {}
    for obs, rt_kernel in (('transmission', None),
                           ('thermal', 'thermal_toon_props'),
                           ('reflected', 'reflected_toon_props')):
        config = pr.driver_config(obs)
        data = pr.driver_data(config, opa)
        fit = driver.prior_finder(config)
        walls = []

        def likelihoods():
            out = []
            for th in thetas:
                t0 = time.perf_counter()
                out.append(driver.log_likelihood(th, config, opa, fit,
                                                 *data))
                walls.append((time.perf_counter() - t0) * 1e3)
            return out
        want = {'interp_tau': len(thetas)}
        if rt_kernel:
            want[rt_kernel] = len(thetas)
        lls = counted_path(f'[32] driver log_likelihood, {obs} (4 calls)',
                           likelihoods, lambda _: want)
        finite(f'[32] {obs} log-likelihoods', lls)
        split = _profiled(lambda: driver.log_likelihood(
            thetas[1], config, opa, fit, *data))
        log(f'[32] {obs}: ms per likelihood {[round(w, 1) for w in walls]}; '
            f'one call {split["wall_ms"]:.1f} ms wall, card busy '
            f'{split["device_busy_ms"]:.2f} ms in '
            f'{split["device_launches"]} launches; host top '
            f'{split["host_own_ms"][:4]}')
        summary['driver'][obs] = dict(
            ms_per_likelihood=walls, log_likelihood=lls,
            split_wall_ms=split['wall_ms'],
            device_busy_ms=split['device_busy_ms'],
            device_launches=split['device_launches'],
            host_own_ms=split['host_own_ms'][:6])

    # driver.run end to end on a '1060'-layout database (H2O, CO)
    db_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'build', 'chip_smoke')
    os.makedirs(db_dir, exist_ok=True)
    db_path = os.path.join(db_dir, 'retrieval_1060.db')
    if os.path.exists(db_path):
        os.remove(db_path)
    t0 = time.perf_counter()
    factory.build_synthetic_db(db_path, np.linspace(300.0, 33000.0, DB_NWNO),
                               molecules=('H2O', 'CO'), pt_layout='1060',
                               device=dev)
    write_s = time.perf_counter() - t0
    config = pr.driver_config('transmission', opacity_files=db_path)
    bg = config['chemistry']['free']['background']
    config['chemistry']['free'] = {'H2O': {'value': 1e-3, 'unit': 'v/v'},
                                   'CO': {'value': 1e-4, 'unit': 'v/v'},
                                   'background': bg}
    config['calc_type'] = 'spectrum'
    t0 = time.perf_counter()
    case, out = counted_path('[32] driver.run, spectrum mode',
                             lambda: driver.run(config, device=dev),
                             lambda _: {'interp_tau': 1})
    spec_s = time.perf_counter() - t0
    depth = np.asarray(out['transit_depth'])
    if depth.shape != (DB_NWNO,):
        raise AssertionError(f'[32] spectrum shape {depth.shape}')
    finite('[32] driver.run spectrum', depth)
    data_wno = np.sort(1e4 / np.linspace(1.0, 10.0, 30))
    _, y = mean_regrid(out['wavenumber'], out['transit_depth'],
                       newx=data_wno)
    e = np.full(30, 0.01 * np.abs(y).mean())
    config['calc_type'] = 'retrieval'
    t0 = time.perf_counter()
    run_res = counted_path(
        '[32] driver.run, retrieval mode (nested, nlive=8)',
        lambda: driver.run(config, data=(1e4 / data_wno, y, e), nlive=8,
                           max_iter=5, walks=2, verbose=False, device=dev),
        # no ellipsoid before iteration 20: each iteration walks 2 x 4
        lambda r: {'interp_tau': 8 + (r['niter'] - 8) * 2 * 4})
    run_s = time.perf_counter() - t0
    finite('[32] driver.run retrieval', run_res['logz'],
           run_res['samples'])
    os.remove(db_path)
    log(f'[32] driver.run: database written in {write_s:.2f} s, spectrum '
        f'mode {spec_s:.2f} s, retrieval mode {run_s:.2f} s ({run_res["niter"]}'
        f' dead points, logz {run_res["logz"]:.3f})')
    summary['driver_run'] = dict(db_write_s=write_s, spectrum_s=spec_s,
                                 retrieval_s=run_s, niter=run_res['niter'],
                                 logz=run_res['logz'])
    del case, out, run_res

    # phase 33: WASP-17b, ensemble sampler
    w17 = pr.W17Retrieval(grid)
    t0 = time.perf_counter()
    chain, lps = counted_path(
        '[33] WASP-17b ensemble fit (8 walkers x 3 steps)',
        lambda: ensemble_sample(w17.loglike, w17.walkers(8), 3, seed=1),
        lambda _: {'interp_tau': w17.scenes})
    wall = time.perf_counter() - t0
    scenes = w17.scenes
    best = chain.reshape(-1, 3)[int(np.argmax(lps.ravel()))]
    chi2 = -2.0 * float(w17.loglike(best[None])[0]) / len(w17.y)
    finite('[33] chi2', chi2)
    log(f'[33] {len(w17.y)} points, {scenes} scenes in {wall:.2f} '
        f's; best T={best[0]:.0f} K, log H2O={best[1]:.2f}, '
        f'xRp={best[2]:.4f}, chi2/N={chi2:.3f}')
    summary['w17'] = dict(points=len(w17.y), scenes=scenes,
                          wall_s=wall, best=best.tolist(), chi2_per_point=chi2)

    # the oracle of phases 30-33 at nwno 5000: f32 card vs f64 CPU
    o_card, o_cpu = oracle_connections(jdi, dev)
    oracle = {}
    rng = np.random.default_rng(7)
    for kind, key in (('transmission', 'transit_depth'),
                      ('thermal', 'thermal')):
        cpu = pr.FreeRetrieval(o_cpu.grid, kind)
        card = pr.FreeRetrieval(o_card.grid, kind, data=(cpu.y, cpu.err))
        th = cpu.prior(rng.random((3, 2)))
        label = f'[33] oracle, free {kind}'
        oracle[f'free_{kind}'] = dict(
            model=check_oracle(label, {key: card.forward(th)},
                               {key: cpu.forward(th)}, (key,))[key],
            log_likelihood=check_loglike(label, card.loglike(th),
                                         cpu.loglike(th)))
    cpu, card = pr.W17Retrieval(o_cpu.grid), pr.W17Retrieval(o_card.grid)
    th = cpu.walkers(3, seed=5)
    oracle['w17'] = dict(
        model=check_oracle('[33] oracle, WASP-17b',
                           {'transit_depth': card.forward(th)},
                           {'transit_depth': cpu.forward(th)},
                           ('transit_depth',))['transit_depth'],
        log_likelihood=check_loglike('[33] oracle, WASP-17b',
                                     card.loglike(th), cpu.loglike(th)))
    for obs, key in (('transmission', 'transit_depth'),
                     ('thermal', 'thermal'), ('reflected', 'albedo')):
        config = pr.driver_config(obs)
        data = pr.driver_data(config, o_cpu)
        fit = driver.prior_finder(config)
        label = f'[33] oracle, driver {obs}'
        models = [np.concatenate([driver.MODEL(t, config, o, fit, data[0])
                                  for t in thetas[:2]])
                  for o in (o_card, o_cpu)]
        lls = [[driver.log_likelihood(t, config, o, fit, *data)
                for t in thetas[:2]] for o in (o_card, o_cpu)]
        oracle[f'driver_{obs}'] = dict(
            model=check_oracle(label, {key: models[0]}, {key: models[1]},
                               (key,))[key],
            log_likelihood=check_loglike(label, *lls))
    summary['oracle'] = oracle
    del o_card, o_cpu
    return summary


def profile_scene(pipeline, grid, nlevel=NLEVEL):
    """``build_problem``'s profile (bench.py:121-137: cloudy, 2 CIA
    continua, Rayleigh, transit) over ``grid``'s molecules, with
    ``pipeline.MIX_16``'s mixing ratios: (scene, config)."""
    nwno = grid.wno.shape[0]
    nlayer = nlevel - 1
    pressure = np.logspace(-6, 2.5, nlevel)
    temperature = np.clip(1200.0 * (pressure / 50.0) ** 0.08, 150.0, None)
    mix = {'H2': np.zeros(nlevel) + 0.84, 'He': np.zeros(nlevel) + 0.155}
    for m in grid.molecules:
        mix[m] = np.zeros(nlevel) + pipeline.MIX_16[m]
    cld = {'opd': np.repeat(np.linspace(0.0, 1.0, nlayer) ** 2, nwno),
           'g0': np.zeros(nlayer * nwno) + 0.85,
           'w0': np.zeros(nlayer * nwno) + 0.95}
    return pipeline.scene_from_arrays(
        pressure, temperature, mix, grid, gravity=2500.0, radius=7.1492e9,
        mass=1.898e30, cld=cld, rstar=6.96e10)



# ---------------------------------------------------------------------------
# the climate modes through the front door: phases 34-38
# ---------------------------------------------------------------------------

def flux_balance(out, teff):
    """max |flux_net| / (sigma Teff^4) over the radiative zone, of a
    climate output or a recorded solve."""
    from picaso_tpu_torch.climate import core
    nstr = [int(i) for i in out['cvz_locs']]
    net = (out['flux_balance']['flux_net'] if 'flux_balance' in out
           else np.asarray(out['flux_net']))
    resid = np.asarray(net)[:max(nstr[1], 1)]
    return float(np.abs(resid).max() / (core.SIGMA_SB * teff ** 4))


def host_path_layers(ck, spec, out, dev):
    """The host-assembled profile step's layers at the solution of the
    climate output ``out`` (its temperatures, fluxes and zones), each timed
    alone (host clock to a synchronize, the median of 3; the
    resort-rebin mix by CUDA events): the chemistry with Kzz and the
    quench levels (``update_diseq_chem``, the self-consistent Kzz from the
    solution's fluxes), virga (``update_clouds``), the
    optics (``build_props_host``: the atmosphere on the host, resort-rebin
    or premixed kappa, continuum, Rayleigh, clouds) and the resort-rebin
    mix alone."""
    from picaso_tpu_torch.climate import api
    from picaso_tpu_torch.constants import PCONV
    from picaso_tpu_torch.opacities import resortrebin as rr
    pressure = np.logspace(-4, 2.5, spec['nlevel'])
    temp = out['temperature']
    inputs = api.ClimateInputs(
        t_eff=spec['teff'], gravity=spec['gravity'] * 100.0,
        pressure=pressure, guess=temp,
        nstr=(0, spec['rcb_guess'], spec['nlevel'] - 2, 0, 0, 0),
        virga_kwargs=spec['virga_kwargs'])
    st = api.climate_state(inputs, ck, device=dev, verbose=False)
    st.diseq = spec['diseq_chem']
    st.last_fluxes = (out['flux_balance']['flux_net_ir'],
                      out['flux_ir_attop'])
    st.last_nstr = [int(i) for i in out['cvz_locs']]
    st.virga_kwargs = dict(spec['virga_kwargs'] or {})

    def host_ms(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), out

    layers = {}
    layers['chemistry_ms'], df = host_ms(
        lambda: st.update_diseq_chem(temp, pressure) if st.diseq
        else st.premix(temp, pressure))
    cld = None
    if spec['virga_kwargs']:
        layers['virga_ms'], (cld, _) = host_ms(
            lambda: st.update_clouds(temp, pressure))
    layers['optics_ms'], (_, atm) = host_ms(
        lambda: st.build_props_host(df, cld_df=cld))
    if st.diseq:
        a = st.ck.arrays
        args = (st.ck.per_gas, a.t_inv_grid, a.p_log_grid, a.nc_p,
                st._tensor(st.ck.gauss_pts), st._tensor(st.ck.gauss_wts),
                st._tensor(np.stack([0.5 * (df[m][1:] + df[m][:-1])
                                     for m in st.ck.per_gas_molecules])),
                st._tensor(atm.t_layer), st._tensor(atm.p_layer / PCONV))
        layers['resortrebin_ms'] = cuda_ms(
            lambda: rr.resortrebin_kappa(*args), 3)
    return layers


def climate_modes_phases(dev, grid, reset_counts, counts):
    """Phases 34-38: every climate mode through the front door at the
    production climate shape against the JAX package's f64 solves, then
    the virga, virga_3d and TOML-driver workflows around the climate, with
    each run's kernel launches counted."""
    from picaso_tpu_torch import driver, virga
    from picaso_tpu_torch import justdoit as jdi
    from picaso_tpu_torch.climate import fused
    from picaso_tpu_torch.opacities.ck import synthetic_ck_table
    from picaso_tpu_torch.probes.climate_jacobian import modes_case
    from picaso_tpu_torch.probes.front_door import facade_case

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           CLIMATE_MODES_REFERENCE)) as f:
        reference = json.load(f)
    cpu = torch.device('cpu')
    summary = {'launches': {}, 'runs': {}}
    tables = {}

    def connection(table, bins=None):
        """The front door's CK connection on the card: the f64 per-gas
        table on the host, for the solve (moved to the card in f64), and
        its f32 copy on the card for spectra; ``bins`` (stride, stop) takes
        every stride-th bin below stop, as a recorded case may."""
        key = (table, tuple(bins or ()))
        if key not in tables:
            t0 = time.perf_counter()
            ck = synthetic_ck_table(grid661=(table == 661), device=cpu,
                                    with_per_gas=True)
            if bins:
                ck = ck.take_bins(slice(None, bins[1], bins[0]))
            tables[key] = (ck, jdi.opannection(ck_table=ck, device=dev))
            log(f'[34] {table}-bin CK table with per-gas tables in '
                f'{time.perf_counter() - t0:.2f} s: per_gas '
                f'{tuple(ck.per_gas.shape)}')
        return tables[key]

    def counted_run(label, fn, expected):
        """fn() with the launch counts set to 0 just before and read just
        after (each kernel of ``expected`` as often as it says, no other),
        timed, its peak over the bytes alive before it."""
        reset_counts()
        out, wall, peak = timed_call(fn)
        got = {k: v for k, v in counts().items() if v}
        log(f'{label}: launches {got}')
        if got != expected:
            raise AssertionError(f'{label}: launches {got}, expected '
                                 f'{expected}')
        summary['launches'][label] = got
        return out, wall, peak

    # phases 34-37: the modes against the JAX package's f64 solves
    for name, phase in CLIMATE_MODES:
        rec = reference[name]
        spec = rec['case']
        ck, opa = connection(spec['table'], spec['slice'])
        label = f'[{phase}] {name}'
        solve = fused.ClimateCounts()
        ngauss = ck.ngauss
        expected = {'thermal_toon_props': ngauss} if spec['with_spec'] else {}
        out, wall, peak = counted_run(label, lambda: modes_case(
            jdi, spec).climate(opa, diseq_chem=spec['diseq_chem'],
                               with_spec=spec['with_spec'], verbose=False,
                               counts=solve, save_all_profiles=True),
            expected)
        temp = out['temperature']
        nstr = [int(i) for i in out['cvz_locs']]
        d_t = float(np.abs(temp - np.asarray(rec['temperature'])).max())
        numbers = dict(wall_s=wall / 1e3, converged=int(out['converged']),
                       cvz_locs=nstr, max_dT_to_jax=d_t,
                       jax_cpu_s=rec['seconds'], peak_bytes_over_alive=peak,
                       nlevel=len(temp), nwno=ck.nwno,
                       launches=summary['launches'][label],
                       **dataclasses.asdict(solve))
        if name in ('diseq_t900_91', 'cloudy_91'):
            numbers['layers_ms'] = host_path_layers(ck, spec, out, dev)
        if name == PHOTOCHEM_BASE:    # phase 54 runs its case with kinetics
            REUSED['diseq'] = dict(temperature=temp, numbers=numbers,
                                   ck=ck, opa=opa)
        log(f'{label}: T top {temp[0]:.3f} K, bottom {temp[-1]:.3f} K; '
            f'JAX: converged {rec["converged"]}, cvz_locs '
            f'{rec["cvz_locs"]}')
        if not np.isfinite(temp).all():
            raise AssertionError(f'{label}: non-finite temperatures')
        same = ((numbers['converged'], nstr) == (rec['converged'],
                                                 rec['cvz_locs'])
                and d_t <= CLIMATE_DT_MAX)
        if not same and name == CLIMATE_DISEQ_BLOWUP:
            # the JAX solve's fluxes went NaN at this profile step (a
            # singular Newton Jacobian); the card is held to the JAX
            # solve's steps before it
            onset = rec['nan_onset']
            steps = np.asarray(out['all_profiles'])[:onset]
            if len(steps) < onset:
                raise AssertionError(f'{label}: {len(steps)} profile steps, '
                                     f'the JAX solve\'s NaN onset at {onset}')
            d_pre = float(np.abs(steps - np.asarray(
                rec['all_profiles'])[:onset]).max())
            log(f'{label}: the JAX solve\'s fluxes went NaN at profile step '
                f'{onset} (ROADMAP Queue 3); the card\'s steps before it')
            check(f'{name} max |dT| before the NaN onset (K)', d_pre,
                  CLIMATE_DT_MAX)
            numbers['past_jax_nan_onset'] = dict(step=onset,
                                                 max_dT_before=d_pre)
            log(f'{label}: {json.dumps(numbers)}')
            summary['runs'][name] = numbers
            del out
            continue
        if (numbers['converged'], nstr) != (rec['converged'],
                                            rec['cvz_locs']):
            raise AssertionError(f'{label}: converged / cvz_locs differ '
                                 f'from the JAX package\'s')
        check(f'{name} max |dT| to the JAX package (K)', d_t,
              CLIMATE_DT_MAX)
        numbers['flux_balance'] = flux_balance(out, spec['teff'])
        numbers['jax_flux_balance'] = flux_balance(rec, spec['teff'])
        log(f'{label}: flux balance {numbers["flux_balance"]:.3e}, the JAX '
            f'solve\'s {numbers["jax_flux_balance"]:.3e}')
        if rec['converged'] and numbers['jax_flux_balance'] <= \
                CLIMATE_BALANCE:
            check(f'{name} flux balance', numbers['flux_balance'],
                  CLIMATE_BALANCE)
        if spec['diseq_chem']:
            numbers['quench_levels'] = out['quench_levels']
            if name != CLIMATE_DISEQ_BLOWUP and (
                    not out['quench_levels']
                    or not np.isfinite(out['kzz']).all()):
                raise AssertionError(f'{label}: no quench level or a '
                                     f'non-finite Kzz')
            if out['quench_levels'] != rec['quench_levels']:
                raise AssertionError(f'{label}: quench levels '
                                     f'{out["quench_levels"]} vs the JAX '
                                     f'package\'s {rec["quench_levels"]}')
            kzz, ref = np.asarray(out['kzz'], float), np.asarray(
                rec['kzz'], float)
            if not np.array_equal(np.isnan(kzz), np.isnan(ref)):
                raise AssertionError(f'{label}: Kzz NaN where the JAX '
                                     f'package\'s is not, or not where it is')
            ok = ~np.isnan(ref)
            numbers['kzz_nan_levels'] = int((~ok).sum())
            numbers['kzz_max_rel'] = float(np.max(np.abs(
                kzz[ok] / ref[ok] - 1.0), initial=0.0))
            check(f'{name} Kzz max rel', numbers['kzz_max_rel'],
                  CLIMATE_MODES_RTOL)
        if spec['virga_kwargs']:
            col = np.reshape(np.asarray(out['cld_df']['opd']),
                             (spec['nlevel'] - 1, -1)).sum(0)
            ref = np.asarray(rec['column_opd'])
            numbers['column_opd_max'] = float(col.max())
            numbers['column_opd_max_rel'] = float(
                np.max(np.abs(col - ref)) / np.abs(ref).max())
            if not col.max() > 0:
                raise AssertionError(f'{label}: no cloud formed')
            check(f'{name} column OPD max rel',
                  numbers['column_opd_max_rel'], CLIMATE_MODES_RTOL)
        if spec['with_spec']:
            # the same spectrum call, f64 on the CPU
            o_cpu = jdi.opannection(ck_table=ck, device=cpu)
            c_cpu = modes_case(jdi, spec)
            c_cpu.atmosphere(df=out['ptchem_df'])
            ref = c_cpu.spectrum(o_cpu, calculation='thermal',
                                 full_output=True)
            mx, med = rel_stats(torch.as_tensor(
                np.asarray(out['spectrum_output']['thermal'])),
                torch.as_tensor(np.asarray(ref['thermal'])))
            log(f'{label}: with_spec thermal, f32 card vs f64 CPU')
            check('with_spec thermal max rel', mx, TOL['spectrum_max_rel'])
            check('with_spec thermal median rel', med,
                  TOL['spectrum_median_rel'])
            numbers['spectrum_vs_cpu'] = [mx, med]
        log(f'{label}: {json.dumps(numbers)}')
        summary['runs'][name] = numbers
        del out

    # phase 38: virga, virga_3d and the TOML climate mode
    opa = jdi.Opacity(grid.wno, grid=grid)

    def virga_case(o):
        """examples/virga_clouds.py's brown dwarf (300 m/s^2, the bundled
        brown-dwarf profile)."""
        case = jdi.inputs(calculation='brown')
        case.phase_angle(0)
        case.gravity(gravity=300.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
        case.setup_nostar()
        case.atmosphere(filename=jdi.brown_dwarf_pt(), sep=r'\s+')
        return case

    prof = virga_case(opa).inputs['atmosphere']['profile']
    gases = virga.recommend_gas(prof['pressure'], prof['temperature'],
                                mh=1.0, mmw=2.2)
    picks = [g for g in ('MgSiO3', 'Fe', 'H2O') if g in gases][:2] or \
        gases[:2]

    def cloudy_1d(o):
        case = virga_case(o)
        case.virga(picks, fsed=2.0, mh=1.0, kz_min=1e9)
        return case.spectrum(o, calculation='thermal')

    out, wall, peak = counted_run(
        f'[38] virga {picks} + cloudy thermal spectrum', lambda: cloudy_1d(
            opa), {'interp_tau': 1, 'thermal_toon_props': 1})
    check_finite('[38] cloudy 1D', out, ('thermal',))
    clear = virga_case(opa).spectrum(opa, calculation='thermal')
    ratio = float(np.sum(out['thermal']) / np.sum(clear['thermal']))
    log(f'[38] virga {picks}: wall {wall:.1f} ms, peak {peak} bytes over '
        f'alive, cloudy / clear bolometric thermal {ratio:.4f}')
    if not ratio < 1.0:
        raise AssertionError('[38] the cloud does not dim the emission')
    o_card, o_cpu = oracle_connections(jdi, dev)
    summary['virga_1d'] = dict(
        condensates=picks, wall_ms=wall, peak_bytes_over_alive=peak,
        cloudy_over_clear=ratio,
        oracle=check_oracle('[38] cloudy 1D thermal', cloudy_1d(o_card),
                            cloudy_1d(o_cpu), ('thermal',)))
    del out, clear, o_card, o_cpu

    nfacet = 36

    def cloudy_3d():
        case = facade_case(opa, disk=(6, 6), atmosphere='3d')
        data = case.inputs['atmosphere']['profile']
        data['kz'] = np.zeros_like(np.asarray(data['temperature'])) + 1e9
        t0 = time.perf_counter()
        case.virga_3d(picks, fsed=2.0)
        host = time.perf_counter() - t0
        return case.spectrum(opa, calculation='thermal',
                             dimension='3d'), host, case
    (out3, host3, case3), wall3, peak3 = counted_run(
        '[38] virga_3d (12 x 8 columns) + 36-facet thermal spectrum',
        cloudy_3d, {'interp_tau': nfacet, 'thermal_toon_props': nfacet})
    check_finite('[38] cloudy 3D', out3, ('thermal',))
    cld = case3.inputs['clouds']['profile']
    if not (np.isfinite(cld['opd']).all() and cld['opd'].max() > 0):
        raise AssertionError('[38] virga_3d: no finite cloud formed')
    log(f'[38] virga_3d: {cld["opd"].shape} opd, {host3:.2f} s on the '
        f'host; with the spectrum {wall3:.1f} ms, peak {peak3} bytes')
    summary['virga_3d'] = dict(opd_shape=list(cld['opd'].shape),
                               virga_s=host3, wall_ms=wall3,
                               peak_bytes_over_alive=peak3)
    del out3, case3, cld

    rec = reference[DRIVER_CLIMATE]
    config = rec['case']['config']
    _, opa196 = connection(196)
    solve = fused.ClimateCounts()

    def toml_climate():
        case, o = driver.setup_climate_class(config, opa=opa196)
        return case.climate(o, verbose=False, counts=solve,
                            **config['climate']['run_kwargs'])
    label = f'[38] TOML climate mode ({DRIVER_CLIMATE})'
    out, wall, peak = counted_run(label, toml_climate, {})
    temp = out['temperature']
    nstr = [int(i) for i in out['cvz_locs']]
    d_t = float(np.abs(temp - np.asarray(rec['temperature'])).max())
    teff = config['climate']['teff']
    numbers = dict(wall_s=wall / 1e3, converged=int(out['converged']),
                   cvz_locs=nstr, max_dT_to_jax=d_t,
                   jax_cpu_s=rec['seconds'], peak_bytes_over_alive=peak,
                   flux_balance=flux_balance(out, teff),
                   jax_flux_balance=flux_balance(rec, teff),
                   **dataclasses.asdict(solve))
    log(f'{label}: {json.dumps(numbers)}; JAX: converged '
        f'{rec["converged"]}, cvz_locs {rec["cvz_locs"]}')
    if not np.isfinite(temp).all():
        raise AssertionError(f'{label}: non-finite temperatures')
    if (numbers['converged'], nstr) != (rec['converged'], rec['cvz_locs']):
        raise AssertionError(f'{label}: converged / cvz_locs differ from '
                             f'the JAX driver\'s')
    check('TOML climate max |dT| to the JAX driver (K)', d_t,
          CLIMATE_DT_MAX)
    if rec['converged'] and numbers['jax_flux_balance'] <= CLIMATE_BALANCE:
        check('TOML climate flux balance', numbers['flux_balance'],
              CLIMATE_BALANCE)
    summary['toml_climate'] = numbers
    return summary


def ck_files_phases(dev, grid, reset_counts, counts, card):
    """Phases 39-43: a CK table from a file into the climate (the legacy
    ASCII writer and loader, ``opannection(ck_db=...)``, ``run_climate``,
    the host Newton ``t_start``, the TOML driver with a ``ck_db``), then
    the front door's tools at full width; each phase's numbers on a JSON
    line of its own beside the card's name and power limit (``card``)."""
    from picaso_tpu_torch import default_dtype, driver
    from picaso_tpu_torch import justdoit as jdi
    from picaso_tpu_torch.climate import api, core
    from picaso_tpu_torch.opacities.db import PTGrid
    from picaso_tpu_torch.opacities.legacy import (MAX_PC,
                                                   synthetic_legacy_table,
                                                   write_legacy_ascii)
    from picaso_tpu_torch.probes.front_door import (egp_cloud_table,
                                                    facade_case,
                                                    production_profile)
    from picaso_tpu_torch.rt.toon import ScatteringControls

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, CK_FILES_REFERENCE)) as f:
        reference = json.load(f)
    summary = {'launches': {}}

    def report(key, numbers):
        print(json.dumps({key: numbers, 'card': card}), flush=True)
        summary[key] = numbers

    def counted(label, fn, expected):
        """fn() with the launch counts set to 0 just before and read just
        after, each kernel of ``expected`` as often as it says, no other;
        timed, its peak over the bytes alive before it."""
        reset_counts()
        out, wall, peak = timed_call(fn)
        got = {k: v for k, v in counts().items() if v}
        log(f'{label}: launches {got}')
        if got != expected:
            raise AssertionError(f'{label}: launches {got}, expected '
                                 f'{expected}')
        summary['launches'][label] = got
        return out, wall, peak

    # phase 39: the legacy table written, its bytes against the JAX
    # writer's, opened on the card, held against what was written
    directory = os.path.join(root, CK_FILES_DIR)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, 'ascii_data')
    t0 = time.perf_counter()
    table = synthetic_legacy_table()
    write_legacy_ascii(path, **table)
    write_s = time.perf_counter() - t0
    with open(path, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    log(f'[39] legacy table written in {write_s:.2f} s: '
        f'{os.path.getsize(path)} bytes, sha256 {digest}')
    if digest != reference['file']['sha256']:
        raise AssertionError('[39] the legacy file differs from the JAX '
                             f'writer\'s ({reference["file"]["sha256"]})')
    t0 = time.perf_counter()
    opa = jdi.opannection(ck_db=directory, method='preweighted', device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ck = opa.climate_ck
    a = ck.arrays
    if (a.ln_kappa.device.type != dev.type
            or a.ln_kappa.dtype != torch.float64):
        raise AssertionError(f'[39] climate table on {a.ln_kappa.device} '
                             f'in {a.ln_kappa.dtype}')
    if opa.ck.arrays.ln_kappa.dtype != default_dtype(dev):
        raise AssertionError('[39] the spectra table is not in the '
                             'device\'s dtype')
    written = {
        'ln_kappa': (a.ln_kappa, table['kappa'] * np.log(10.0)),
        'p_log_grid': (a.p_log_grid,
                       np.log10(table['pressures_bar'][:MAX_PC])),
        't_inv_grid': (a.t_inv_grid, 1.0 / table['temps']),
        'gauss_wts': (a.gauss_wts, table['gauss_wts']),
        'wno': (a.wno, table['wno']),
        'delta_wno': (a.delta_wno, table['delta_wno']),
        'abunds': (torch.as_tensor(np.stack([ck.full_abunds[m] for m in
                                             table['molecules']], 1)),
                   table['abunds']),
    }
    errs = {}
    for name, (got, want) in written.items():
        want = torch.as_tensor(np.asarray(want, np.float64),
                               device=got.device)
        if got.shape != want.shape:
            raise AssertionError(f'[39] {name}: {tuple(got.shape)} vs '
                                 f'{tuple(want.shape)}')
        errs[name] = rel_stats(got, want)[0]
        check(f'[39] loaded {name} max rel to the written table',
              errs[name], CK_FILES_RTOL)
    report('ck_file', dict(
        sha256=digest, bytes=os.path.getsize(path), write_s=write_s,
        opannection_s=load_s, shape=list(a.ln_kappa.shape),
        species=len(ck.molecules), max_rel_to_written=errs,
        formats_on_card=['legacy ascii_data'],
        not_on_card='premixed hdf5, per-gas hdf5 (no h5py on this machine)'))

    # phase 40: run_climate on the loaded table, against the JAX solve
    rec = reference['climate_91']
    inputs = climate_inputs(CLIMATE_NLEVEL)
    out, numbers = climate_run('[40] run_climate, legacy table', inputs, ck,
                               None, dev, reset_counts, counts)
    summary['launches']['[40] run_climate'] = {}
    nstr = numbers['cvz_locs']
    d_t = float(np.abs(out['temperature']
                       - np.asarray(rec['temperature'])).max())
    numbers.update(max_dT_to_jax=d_t, jax_flux_balance=rec['flux_balance'],
                   jax_cpu_s=rec['seconds'])
    if (numbers['converged'], nstr) != (rec['converged'], rec['cvz_locs']):
        raise AssertionError('[40] converged / cvz_locs differ from the JAX '
                             f'solve\'s {rec["converged"]}, '
                             f'{rec["cvz_locs"]}')
    check('[40] max |dT| to the JAX package (K)', d_t, CLIMATE_DT_MAX)
    report('ck_file_climate', numbers)
    del out

    # phase 41: the host Newton solve from the guess, one convective zone
    rec = reference['t_start_91']
    spec = rec['case']
    st = api.climate_state(inputs, ck, device=dev, verbose=False)
    pressure, guess = inputs.pressure, inputs.guess
    df = st.premix(guess, pressure)
    props, _ = st.opacities(df)
    tidal = core.tidal_flux(CLIMATE_TEFF, len(pressure))

    def newton():
        return core.t_start(
            guess, pressure * 1e6, spec['nstr'], spec['nofczns'], props,
            st.geom, ck.wno, ck.delta_wno, ck.gauss_wts, 0.0,
            np.zeros(ck.nwno), ScatteringControls(), st.adiabat, 1.0,
            spec['rfacv'], tidal, spec['tmin'], spec['tmax'],
            it_max=spec['it_max'], save_profiles=True)
    res, wall, peak = counted('[41] t_start', newton, {})
    d_t = float(np.abs(res.temp - np.asarray(rec['temperature'])).max())
    numbers = dict(wall_s=wall / 1e3, iterations=res.iterations,
                   converged=int(res.converged),
                   flux_evaluations=res.flux_evaluations,
                   flux_evaluations_per_iteration=(
                       res.flux_evaluations / max(res.iterations, 1)),
                   peak_bytes_over_alive=peak, max_dT_to_jax=d_t,
                   jax_iterations=rec['iterations'],
                   jax_converged=rec['converged'], jax_cpu_s=rec['seconds'])
    log(f'[41] t_start: {json.dumps(numbers)}')
    if (res.iterations, int(res.converged)) != (rec['iterations'],
                                                 rec['converged']):
        raise AssertionError('[41] Newton steps / converged differ from the '
                             'JAX solve\'s')
    check('[41] t_start max |dT| to the JAX package (K)', d_t,
          T_START_DT_MAX)
    report('ck_file_t_start', numbers)
    del st, props, res

    # phase 42: the TOML climate mode opening ck_db itself
    rec = reference['driver_41']
    config = json.loads(json.dumps(rec['case']['config']))
    config['OpticalProperties']['ck_db'] = directory
    (case, out), wall, peak = counted(
        '[42] driver.run climate from ck_db',
        lambda: driver.run(config, device=dev, verbose=False), {})
    temp = out['temperature']
    nstr = [int(i) for i in out['cvz_locs']]
    d_t = float(np.abs(temp - np.asarray(rec['temperature'])).max())
    numbers = dict(wall_s=wall / 1e3, converged=int(out['converged']),
                   cvz_locs=nstr, max_dT_to_jax=d_t,
                   flux_balance=flux_balance(out, CLIMATE_TEFF),
                   jax_flux_balance=rec['flux_balance'],
                   jax_cpu_s=rec['seconds'], nlevel=len(temp),
                   peak_bytes_over_alive=peak)
    log(f'[42] TOML climate from ck_db: {json.dumps(numbers)}')
    if not np.isfinite(temp).all():
        raise AssertionError('[42] non-finite temperatures')
    if (numbers['converged'], nstr) != (rec['converged'], rec['cvz_locs']):
        raise AssertionError('[42] converged / cvz_locs differ from the JAX '
                             'driver\'s')
    check('[42] max |dT| to the JAX driver (K)', d_t, CLIMATE_DT_MAX)
    report('ck_file_driver', numbers)
    del case, out, opa, ck

    # phase 43: the tools at full width on the production table
    opa = jdi.Opacity(grid.wno, grid=grid)

    def guillot_case(o):
        case = facade_case(o, clouds=False)
        pt = case.guillot_pt(1200.0, T_int=200.0, nlevel=NLEVEL)
        prof = production_profile(o.molecules)
        prof.update(pressure=pt['pressure'], temperature=pt['temperature'])
        case.atmosphere(df=prof)
        case.clouds(df=egp_cloud_table(NLEVEL - 1))
        return case

    walls = []
    for i in range(2):
        out, wall, _ = counted(
            f'[43] guillot_pt spectrum {i}', lambda: guillot_case(
                opa).spectrum(opa, calculation='reflected+thermal'),
            {'interp_tau': 1, 'reflected_toon_props': 1,
             'thermal_toon_props': 1})
        check_finite('[43] guillot_pt spectrum', out, ('albedo', 'thermal'))
        walls.append(wall)
    thermal, wno = out['thermal'], out['wavenumber']

    reset_counts()
    contrib, wall_c, peak_c = timed_call(
        lambda: jdi.get_contribution(guillot_case(opa), opa))
    if any(counts().values()):
        raise AssertionError('[43] get_contribution launched a kernel')

    def mv(x):
        return (x.to('cpu', torch.float64) if x.is_floating_point()
                else x.to('cpu'))
    cpu_grid = grid._replace(
        wno=mv(grid.wno), log_kappa=mv(grid.log_kappa),
        pt=PTGrid(*(mv(x) for x in grid.pt)), cont_opa=mv(grid.cont_opa),
        cia_temps=mv(grid.cia_temps), log_kappa_blocked=None,
        blocked_qparams=None)
    o_cpu = jdi.Opacity(grid.wno, grid=cpu_grid)
    t0 = time.perf_counter()
    ref = jdi.get_contribution(guillot_case(o_cpu), o_cpu)
    cpu_s = time.perf_counter() - t0
    del o_cpu, cpu_grid
    if set(contrib['taus_per_layer']) != set(ref['taus_per_layer']):
        raise AssertionError('[43] get_contribution species differ')
    taus_rel, p_rel = {}, {}
    for name, want in ref['taus_per_layer'].items():
        got = contrib['taus_per_layer'][name]
        if got.shape != (NLEVEL - 1, NWNO):
            raise AssertionError(f'[43] {name}: shape {got.shape}')
        taus_rel[name] = rel_stats(torch.as_tensor(got),
                                   torch.as_tensor(want))[0]
        pg = contrib['tau_p_surface'][name].astype(np.float64)
        pw = ref['tau_p_surface'][name]
        both = np.isfinite(pg) & np.isfinite(pw)
        if not np.array_equal(np.isfinite(pg), np.isfinite(pw)):
            raise AssertionError(f'[43] {name}: tau_p_surface finite on '
                                 'other wavenumbers')
        p_rel[name] = float(np.max(np.abs(pg[both] / pw[both] - 1.0),
                                   initial=0.0))
    log('[43] get_contribution, f32 card vs f64 CPU')
    check('[43] taus_per_layer max rel', max(taus_rel.values()),
          CONTRIB_MAX_REL)
    check('[43] tau_p_surface max rel', max(p_rel.values()),
          CONTRIB_MAX_REL)

    units = ('FLAM', 'FNU', 'Jy', 'mJy', 'W/(m2 um)')
    round_trip = {}
    for unit in units:
        there = jdi.convert_flux_units(wno, thermal, unit)
        back = jdi.convert_flux_units(wno[::-1], there,
                                      'erg*cm^(-3)*s^(-1)', f_unit=unit)
        round_trip[unit] = rel_stats(
            torch.as_tensor(back[::-1].copy()),
            torch.as_tensor(np.asarray(thermal, np.float64)))[0]
        check(f'[43] convert_flux_units per cm -> {unit} -> per cm max rel',
              round_trip[unit], 1e-12)
    report('tools', dict(
        guillot_spectrum_wall_ms=walls,
        get_contribution=dict(wall_ms=wall_c, peak_bytes_over_alive=peak_c,
                              cpu_f64_s=cpu_s,
                              species=sorted(taus_rel),
                              taus_per_layer_max_rel=taus_rel,
                              tau_p_surface_max_rel=p_rel),
        convert_flux_units_round_trip_max_rel=round_trip,
        model_save_load='not run: needs h5py, absent on this machine'))
    return summary



def check_record(label, got, want, bitwise):
    """One array's ``ingest.array_digest`` against the JAX record: the
    same SHA-256 where ``bitwise``, else the same shape and sum, min, max
    and samples within HOST_TOOLS_RTOL.  Returns (bitwise equal, max
    rel)."""
    if got['shape'] != want['shape']:
        raise AssertionError(f'{label}: shape {got["shape"]}, JAX '
                             f'{want["shape"]}')
    same = got['sha256'] == want['sha256']
    a = np.array([got['sum'], got['min'], got['max'], *got['samples']])
    b = np.array([want['sum'], want['min'], want['max'], *want['samples']])
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
    if bitwise and not same:
        raise AssertionError(f'{label}: SHA-256 differs from the JAX '
                             f'record (max rel {rel:.3g})')
    check(f'{label} max rel to the JAX record', rel, HOST_TOOLS_RTOL)
    return same, rel


def ingest_raw_tree(ingest, root, db, params):
    """tests/host_tools_record.py's ingestion: H2O and CH4 from the raw
    tree's 1460 (T, P) points at new_R (on the old_R working grid), the
    EGP CIA grid with its analytic sources, the HITRAN N2N2 file, the
    metadata.  Returns the wavenumber grid."""
    for mol in ('H2O', 'CH4'):
        ingest.ingest_molecular_1460(
            mol, params['min_wavelength'], params['max_wavelength'], root,
            db, new_R=params['new_R'], old_R=params['old_R'])
    cur, conn = ingest.connect(db)
    cur.execute('SELECT wavenumber_grid FROM header')
    wno = cur.fetchone()[0]
    conn.close()
    ingest.ingest_cia_grid(os.path.join(root, 'master_cia.dat'),
                           list(ingest.RAW_CIA_COLUMNS), wno, db)
    ingest.ingest_hitran_cia(os.path.join(root, 'N2-N2_2018.cia'), 'N2N2',
                             db, wno)
    ingest.add_metadata(db, version='synthetic', resolution=params['new_R'],
                        wavemin=params['min_wavelength'],
                        wavemax=params['max_wavelength'])
    return wno


def host_tools_phases(dev, grid, reset_counts, counts, card):
    """Phases 45-49: opacity ingestion from raw files into a spectrum, the
    native loader, ``build_3d_input`` into a 100-facet spectrum,
    ``model_compare``'s harnesses and the port's examples; each timed by
    ``profiling.Timer``, its numbers logged by ``profiling.RunLog`` and
    printed on a JSON line of their own beside the card's name and power
    limit (``card``), its launches of K1, K5 and K6 counted."""
    import warnings

    from picaso_tpu_torch import build_3d_input as b3d
    from picaso_tpu_torch import integration_testing
    from picaso_tpu_torch import justdoit as jdi
    from picaso_tpu_torch import model_compare, native
    from picaso_tpu_torch.opacities import factory, ingest
    from picaso_tpu_torch.opacities.db import load_opacity_db
    from picaso_tpu_torch.probes.front_door import production_profile
    from picaso_tpu_torch.profiling import RunLog, Timer

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, HOST_TOOLS_REFERENCE)) as f:
        reference = json.load(f)
    directory = os.path.join(root, HOST_TOOLS_DIR)
    os.makedirs(directory, exist_ok=True)
    timer = Timer()
    runlog = RunLog(os.path.join(directory, 'host_tools.jsonl'))
    summary = {'launches': {}}
    kernels = ('interp_tau', 'reflected_toon_props', 'thermal_toon_props')

    def report(key, numbers):
        runlog.log(key, **numbers)
        print(json.dumps({key: numbers, 'card': card}), flush=True)
        summary[key] = numbers

    def counted(label, fn, expected):
        """fn() timed (Timer, synchronised on its output), K1, K5 and K6
        counted from 0; each kernel of ``expected`` as often as it says,
        no other kernel."""
        reset_counts()
        with timer(label) as hold:
            out = fn()
            hold.append(out)
        torch.cuda.synchronize()
        got = {k: v for k, v in counts().items() if v}
        log(f'{label}: launches {got}')
        if got != expected:
            raise AssertionError(f'{label}: launches {got}, expected '
                                 f'{expected}')
        summary['launches'][label] = {k: got.get(k, 0) for k in kernels}
        return out

    # phase 45: a raw source tree ingested into a DB, its tables against
    # the JAX record, then a spectrum from the DB against its CPU oracle
    rec = reference['ingest']
    raw = os.path.join(directory, 'raw')
    with timer('[45] raw tree'):
        ingest.synthetic_raw_tree(raw, nwave=rec['nwave'])
    db = os.path.join(directory, 'ingested.db')
    if os.path.exists(db):
        os.remove(db)
    with timer('[45] ingest'):
        ingest_raw_tree(ingest, raw, db, rec['params'])
    tables = ingest.table_digests(db)
    if sorted(tables) != sorted(rec['tables']):
        raise AssertionError(f'[45] tables {sorted(tables)}, JAX '
                             f'{sorted(rec["tables"])}')
    bitwise, rels = {}, {}
    for name, want in rec['tables'].items():
        bitwise[name], rels[name] = check_record(
            f'[45] {name}', tables[name], want,
            bitwise=not name.startswith('continuum'))
    metadata = [[k, v] for k, v in ingest.get_metadata(db)]
    if metadata != rec['metadata']:
        raise AssertionError(f'[45] metadata {metadata}, JAX '
                             f'{rec["metadata"]}')
    with timer('[45] opannection'):
        opa = jdi.opannection(filename_db=db, device=dev)
    nwno = len(opa.wno)

    def db_case(o):
        case = jdi.inputs()
        case.phase_angle(0.0, num_gangle=10, num_tangle=1)
        case.gravity(mass=1.898e30, mass_unit='g', radius=7.1492e9,
                     radius_unit='cm')
        case.star(o, temp=5700, radius=6.96e10, radius_unit='cm',
                  semi_major=0.05, semi_major_unit='AU')
        case.atmosphere(df=production_profile(o.molecules))
        case.approx()
        return case
    calc = 'reflected+thermal'
    out = counted('[45] spectrum from the ingested DB',
                  lambda: db_case(opa).spectrum(opa, calculation=calc),
                  {'interp_tau': 1, 'reflected_toon_props': 1,
                   'thermal_toon_props': 1})
    for key in ('albedo', 'thermal'):
        if out[key].shape != (nwno,) or not np.isfinite(out[key]).all():
            raise AssertionError(f'[45] {key}: shape {out[key].shape} or '
                                 'non-finite')
    o_cpu = jdi.opannection(filename_db=db, device='cpu')
    oracle = check_oracle('[45] ingested-DB spectrum', out,
                          db_case(o_cpu).spectrum(o_cpu, calculation=calc),
                          ('albedo', 'thermal'))
    report('ingest', dict(
        nwave_per_pt=rec['nwave'], params=rec['params'], nwno=nwno,
        molecules=list(opa.molecules), db_bytes=os.path.getsize(db),
        tables_bitwise=bitwise, tables_max_rel=rels,
        seconds={k: timer.times[k] for k in ('[45] raw tree', '[45] ingest',
                                             '[45] opannection')},
        jax_cpu_ingest_s=rec['seconds'],
        spectrum_ms=timer.times['[45] spectrum from the ingested DB'] * 1e3,
        oracle=oracle))
    del opa, o_cpu, out

    # phase 46: the native loader against the numpy decode, on phase 21's
    # '1060' DB and on the ingested DB
    db_1060 = os.path.join(directory, 'opacity_1060.db')
    if os.path.exists(db_1060):
        os.remove(db_1060)
    factory.build_synthetic_db(db_1060, np.linspace(300.0, 33000.0, DB_NWNO),
                               molecules=('H2O', 'CO'), pt_layout='1060',
                               device=dev)
    if not native.available():
        raise AssertionError('[46] the native library does not build: '
                             f'{native.unavailable_reason()}')
    loads = {}
    for name, path in (('1060', db_1060), ('ingested', db)):
        grids = {}
        for flag in (True, False):
            label = f'[46] {name} native={flag}'
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                with timer(label) as hold:
                    grids[flag] = load_opacity_db(
                        path, device=dev, dtype=torch.float32, native=flag)
                    hold.append(grids[flag].log_kappa)
            native_warnings = [str(w.message) for w in caught
                               if 'native' in str(w.message)]
            if native_warnings:
                raise AssertionError(f'{label}: {native_warnings}')
        equal = {k: torch.equal(getattr(grids[True], k),
                                getattr(grids[False], k))
                 for k in ('log_kappa', 'cont_opa', 'wno', 'cia_temps')}
        log(f'[46] {name}: native vs numpy decode bitwise {equal}')
        if not all(equal.values()):
            raise AssertionError(f'[46] {name}: native and numpy decodes '
                                 f'differ {equal}')
        loads[name] = dict(
            shape=list(grids[True].log_kappa.shape),
            native_s=timer.times[f'[46] {name} native=True'],
            numpy_s=timer.times[f'[46] {name} native=False'])
        del grids
    report('native_loader', dict(loads=loads, bitwise=True,
                                 library=native.build()))
    shutil.rmtree(raw)
    for path in (db, db_1060):
        os.remove(path)

    # phase 47: build_3d_input at a GCM's size onto 10 x 10 facets, then a
    # 100-facet spectrum on the production table
    rec = reference['build_3d']
    with timer('[47] synthetic GCM and MITgcm files'):
        ds = b3d.synthetic_gcm()
        pt_file = b3d.write_mitgcm_pt(os.path.join(directory, 'pt.txt'), ds)
        cld_file = b3d.write_mitgcm_cld(os.path.join(directory, 'cld.txt'))
    with timer('[47] regrid'):
        reg = b3d.regrid_xarray(ds, phase_angle=0.0, **GAUSS_CHEBY)
        _, cube = b3d.regrid_to_gauss_cheby(
            ds.coords['lat'].values, ds.coords['lon'].values,
            ds.data_vars['temperature'].values, phase=0.0, **GAUSS_CHEBY)
        pt = b3d.rebin_mitgcm_pt(pt_file, phase=0.0, **GAUSS_CHEBY)
        cld = b3d.rebin_mitgcm_cld(cld_file, phase=0.0, **GAUSS_CHEBY)
    arrays = {f'regrid_xarray {k}': v for k, v in reg.items()}
    arrays['regrid_to_gauss_cheby temperature'] = cube
    arrays.update({f'rebin_mitgcm_pt {k}': v for k, v in pt.items()})
    arrays.update({f'rebin_mitgcm_cld {k}': v for k, v in cld.items()})
    if sorted(arrays) != sorted(rec):
        raise AssertionError(f'[47] arrays {sorted(arrays)}, JAX '
                             f'{sorted(rec)}')
    regrid_rel, regrid_bitwise = {}, {}
    for name, want in rec.items():
        regrid_bitwise[name], regrid_rel[name] = check_record(
            f'[47] {name}', ingest.array_digest(arrays[name]), want,
            bitwise=False)

    def gcm_case(o):
        case = jdi.inputs()
        case.phase_angle(0.0, **GAUSS_CHEBY)
        case.gravity(mass=1.898e30, mass_unit='g', radius=7.1492e9,
                     radius_unit='cm')
        case.star(o, temp=5700, radius=6.96e10, radius_unit='cm',
                  semi_major=0.05, semi_major_unit='AU')
        column = production_profile(o.molecules, nlevel=len(pt['pressure']))
        data = {'pressure': pt['pressure'], 'lat': pt['lat'],
                'lon': pt['lon'], 'temperature': pt['temperature'],
                'kz': pt['kz']}
        shape = pt['temperature'].shape
        for key, col in column.items():
            if key not in ('pressure', 'temperature'):
                data[key] = np.broadcast_to(col[:, None, None], shape)
        data['H2O'] = reg['H2O']
        case.atmosphere_3d(data)
        case.clouds_3d(opd=cld['opd'], g0=cld['g0'], w0=cld['w0'],
                       wavenumber=jdi.get_cld_input_grid())
        case.approx()
        return case
    opa = jdi.Opacity(grid.wno, grid=grid)
    nfacet = GAUSS_CHEBY['num_gangle'] * GAUSS_CHEBY['num_tangle']
    out3 = counted('[47] 3D spectrum (100 facets)', lambda: gcm_case(
        opa).spectrum(opa, calculation=calc, dimension='3d'),
        {'interp_tau': nfacet, 'reflected_toon_props': nfacet,
         'thermal_toon_props': nfacet})
    check_finite('[47] 3D', out3, ('albedo', 'thermal'))
    o_card, o_cpu = oracle_connections(jdi, dev)
    with timer('[47] 3D oracle, f64 CPU'):
        ref3 = gcm_case(o_cpu).spectrum(o_cpu, calculation=calc,
                                        dimension='3d')
    oracle3 = check_oracle(
        '[47] 3D, 100 facets, nwno 5000',
        gcm_case(o_card).spectrum(o_card, calculation=calc, dimension='3d'),
        ref3, ('albedo', 'thermal'))
    report('build_3d', dict(
        gcm=dict(nlon=len(ds.coords['lon'].values),
                 nlat=len(ds.coords['lat'].values),
                 nlevel=len(ds.coords['pressure'].values)),
        cloud_dump=list(cld['opd'].shape), facets=nfacet,
        regrid_max_rel=regrid_rel, regrid_bitwise=regrid_bitwise,
        seconds={k: timer.times[k] for k in (
            '[47] synthetic GCM and MITgcm files', '[47] regrid',
            '[47] 3D oracle, f64 CPU')},
        spectrum_ms=timer.times['[47] 3D spectrum (100 facets)'] * 1e3,
        oracle=oracle3))
    del out3, ref3, o_card, o_cpu, opa

    # phase 48: model_compare's harnesses, Toon, f32 on the card, against
    # the JAX package's f64 cells
    rec = reference['model_compare']
    real, dlugach = counted(
        '[48] dlugach_test', lambda: model_compare.dlugach_test(device=dev),
        {'reflected_toon_props': 63})
    madhu = counted('[48] madhu_test',
                    lambda: model_compare.madhu_test(device=dev),
                    {'reflected_toon_props': 48})
    thermal = counted('[48] thermal_sh_test',
                      lambda: model_compare.thermal_sh_test(device=dev),
                      {'thermal_toon_props': 165})
    gates = {}
    for name, got, index in (('dlugach', dlugach, 'asy'),
                             ('madhu', madhu, 'ssa'),
                             ('thermal', thermal, 'asy')):
        want = rec[name]
        if ([str(i) for i in got[index]] != [str(i) for i in want[index]]
                or sorted(got) != sorted(want)):
            raise AssertionError(f'[48] {name}: rows or columns differ from '
                                 'the JAX record')
        a = np.concatenate([np.asarray(got[c], np.float64)
                            for c in want if c != index])
        b = np.concatenate([np.asarray(want[c], np.float64)
                            for c in want if c != index])
        mx, med = rel_stats(torch.as_tensor(a), torch.as_tensor(b))
        log(f'[48] {name}: f32 card vs the JAX f64 record, every cell')
        check(f'{name} max rel', mx, TOL['forward_max_rel'])
        check(f'{name} median rel', med, TOL['forward_median_rel'])
        gates[name] = [mx, med]
    cols = [c for c in real if c != 'asy']
    pct = np.abs(np.stack([dlugach[c] - real[c] for c in cols])
                 / np.stack([real[c] for c in cols])) * 100
    report('model_compare', dict(
        f32_vs_jax_f64=gates,
        dlugach_max_pct_diff_from_table=float(pct.max()),
        dlugach_max_pct_diff_by_row=dict(zip(
            real['asy'], [float(x) for x in pct.max(axis=0)])),
        seconds={k: timer.times[f'[48] {k}'] for k in (
            'dlugach_test', 'madhu_test', 'thermal_sh_test')},
        jax_cpu_f64_s=rec['seconds']))

    # phase 49: the port's examples, each in a process of its own; those
    # whose JAX namesakes fail their own asserts held to the JAX run's line
    rec = reference['examples']
    examples = integration_testing.discover()
    procs = {}
    with timer('[49] examples'):
        results = integration_testing.run_all(
            timeout=EXAMPLE_TIMEOUT_S, jobs=EXAMPLE_JOBS, outputs=procs)
    failed = sorted(os.path.basename(p) for p, (ok, _) in results.items()
                    if not ok)
    if len(results) != len(examples) or failed != sorted(rec):
        raise AssertionError(f'[49] examples failed: {failed}; the JAX '
                             f'examples that fail: {sorted(rec)}')
    as_jax = {}
    for name, want in rec.items():
        proc = procs[os.path.join(os.path.dirname(examples[0]), name)]
        lines = [ln.split('  (')[0] for ln in proc.stdout.splitlines()]
        log(f'[49] {name}: exit {proc.returncode}, JAX {want["returncode"]}'
            f'; JAX printed {want["line"]!r}')
        if proc.returncode != want['returncode'] or want['line'] not in lines:
            raise AssertionError(f'[49] {name} does not end as the JAX '
                                 'example does')
        as_jax[name] = want['line']
    beside, gates = example_gates(
        os.path.join(root, EXAMPLES_REFERENCE),
        {name: procs[os.path.join(os.path.dirname(examples[0]), name)]
         for name in (MESH_EXAMPLE, PHOTOCHEM_EXAMPLE)})
    summary['launches'][f'[49] {MESH_EXAMPLE}'] = gates['launches']
    report('examples', dict(
        wall_s={os.path.basename(p): s for p, (_, s) in results.items()},
        total_s=timer.times['[49] examples'],
        failing_as_the_jax_example=as_jax, lines_beside_jax=beside,
        gates=gates,
        launches=f'counted in the example\'s own process: {MESH_EXAMPLE} '
                 'only'))
    summary['timer'] = timer.summary()
    return summary


def example_gates(reference, procs):
    """Phase 49's checks of the mesh and photochemistry examples
    (``procs``: name -> CompletedProcess): each exits 0, its printed lines
    logged beside the JAX runs' in ``reference`` (x64 and f32); the JAX
    examples' own asserts; the mesh example's retrieval line exactly the
    JAX runs', and K1 and K2 launched in it once per sharded forward and
    wave shard.  Returns the lines side by side and the gated numbers."""
    with open(reference) as f:
        jax_runs = json.load(f)
    beside = {}
    for name, proc in procs.items():
        if proc.returncode:
            raise AssertionError(f'[49] {name} exited {proc.returncode}')
        beside[name] = dict(card=proc.stdout.splitlines(), **{
            f'jax_{prec}': jax_runs[name][prec]['lines']
            for prec in ('x64', 'f32')})
        for key, lines in beside[name].items():
            for ln in lines:
                log(f'[49] {name} {key}: {ln}')

    def number(name, pattern):
        text = '\n'.join(beside[name]['card'])
        found = re.search(pattern, text, re.M)
        if not found:
            raise AssertionError(f'[49] {name} printed no {pattern!r}')
        return found

    retrieval = number(MESH_EXAMPLE, r'^retrieved scale = ([\d.]+).*$')
    scale = float(retrieval[1])
    converged = number(MESH_EXAMPLE, r'^sharded RCE: converged=(\w+)')[1]
    forwards = int(number(MESH_EXAMPLE, r'^sharded forwards: (\d+)$')[1])
    launches = json.loads(number(MESH_EXAMPLE,
                                 r'^kernel launches: (.*)$')[1])
    calls = int(number(PHOTOCHEM_EXAMPLE,
                       r'^kinetics solves during the climate run: (\d+)')[1])
    t_range = [int(t) for t in number(
        PHOTOCHEM_EXAMPLE, r'^T range: (\d+) - (\d+) K').groups()]
    pc_converged = number(PHOTOCHEM_EXAMPLE, r'^converged: (\w+)')[1]
    gates = dict(retrieval_line=retrieval[0], retrieved_scale=scale,
                 sharded_climate_converged=converged,
                 sharded_forwards=forwards, launches=launches,
                 kinetics_calls=calls,
                 photochem_converged_logged=pc_converged,
                 photochem_t_range_logged=t_range)
    check(f'[49] {MESH_EXAMPLE} |scale - truth|',
          abs(scale - MESH_EXAMPLE_TRUTH), MESH_EXAMPLE_TOL)
    # the sampler is the JAX one bit for bit, and the JAX example printed
    # this line in x64 and in f32 alike: a kernel fault that the
    # likelihood's own data would cancel shows here
    for prec in ('x64', 'f32'):
        if retrieval[0] not in beside[MESH_EXAMPLE][f'jax_{prec}']:
            raise AssertionError(f'[49] {MESH_EXAMPLE}: {retrieval[0]!r} is '
                                 f'not the JAX {prec} run\'s line')
    if converged != 'True':
        raise AssertionError(f'[49] {MESH_EXAMPLE}: the sharded climate did '
                             'not converge')
    want = {'interp_tau': 4 * forwards, 'spectrum_toon': 4 * forwards}
    if forwards < 1 or launches != want:
        raise AssertionError(f'[49] {MESH_EXAMPLE}: launches {launches}, '
                             f'expected {want}: K1 and K2 once per sharded '
                             'forward and wave shard')
    if calls < 2:
        raise AssertionError(f'[49] {PHOTOCHEM_EXAMPLE}: {calls} kinetics '
                             'calls')
    log(f'[49] {MESH_EXAMPLE}: {retrieval[0]!r} as the JAX runs, converged '
        f'{converged}, launches {launches} over {forwards} sharded forwards; '
        f'{PHOTOCHEM_EXAMPLE}: {calls} kinetics calls, '
        f'converged {pc_converged} (logged), T {t_range} K (logged)')
    return beside, gates


# ---------------------------------------------------------------------------
# the device mesh (picaso_tpu_torch.parallel) and photochemistry: 50-54
# ---------------------------------------------------------------------------

def check_bitwise(label, got, ref):
    """Each key of ``ref`` (tensors or arrays) equal bit for bit in
    ``got``."""
    for key in ref:
        a, b = torch.as_tensor(got[key]), torch.as_tensor(ref[key])
        if a.shape != b.shape or not torch.equal(a.cpu(), b.cpu()):
            diff = ((a.cpu() - b.cpu()).abs().max().item()
                    if a.shape == b.shape else 'shape')
            raise AssertionError(f'{label} {key}: not bitwise the unsharded '
                                 f'result (max abs {diff})')
    log(f'{label}: bitwise the unsharded result ({sorted(ref)})')


def mesh_phases(dev, grid, g16, config, reset_counts, counts, card):
    """Phases 50-54: the mesh (``picaso_tpu_torch.parallel``) on the
    visible cards, ``cuda:0`` repeated where there are fewer cards than
    shards: the sharded forward at the production shape (Toon and the
    int16 table) bitwise phases 6 and 19; the front door's batched phase
    curve over a 2 x 2 mesh bitwise ``mesh=None``; the nested sampler over
    ``sharded_loglike`` with the same dead points as the unsharded run;
    ``run_climate(mesh=...)`` against phase 24's solve; then the
    diseq climate with (mocked) photochemical kinetics against the JAX
    package's f64 solve of the same case.  One JSON line per phase with
    the card's name and power limit."""
    from picaso_tpu_torch import justdoit as jdi
    from picaso_tpu_torch import parallel, pipeline
    from picaso_tpu_torch.climate import api, fused
    from picaso_tpu_torch.opacities import factory
    from picaso_tpu_torch.opacities.cuda_interp import (interp_tau,
                                                        interp_tau_plain)
    from picaso_tpu_torch.photochem import MockKinetics
    from picaso_tpu_torch.probes.climate_jacobian import modes_case
    from picaso_tpu_torch.probes.front_door import facade_case
    from picaso_tpu_torch.rt.cuda_toon import (spectrum_toon,
                                               spectrum_toon_plain)
    from picaso_tpu_torch.sampler import nested_sample

    summary = {'launches': {}}
    t_mesh = time.perf_counter()

    def report(phase, what, numbers):
        numbers = dict(phase=phase, what=what, card=card, **numbers)
        log(json.dumps(numbers))
        summary[what] = numbers

    def counted(label, fn, expected):
        """fn() with the launch counts set to 0 just before and read just
        after; each kernel of ``expected`` as often as it says, no
        other."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in counts().items() if v}
        log(f'{label}: launches {got}')
        if got != expected:
            raise AssertionError(f'{label}: launches {got}, expected '
                                 f'{expected}')
        summary['launches'][label] = got
        return out

    # phase 50: the sharded forward at the production shape, 4 wave shards
    m = parallel.make_mesh(n_wave=4, n_batch=1, devices=parallel.mesh_devices(4))
    log(f'[50] {m}')
    numbers = {'mesh': [[str(d) for d in r] for r in m.devices]}
    for path, g, kernel in (('toon', grid, 'interp_tau'),
                            ('int16', g16, 'interp_tau_q')):
        scene0, ref = REUSED[path]
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scene_s = parallel.shard_scene(scene0, m)
        grid_s = parallel.shard_grid(g, m)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        label = f'[50] sharded forward, {path}'
        out = counted(label, lambda: parallel.sharded_forward(
            scene_s, grid_s, config, m), {kernel: 4, 'spectrum_toon': 4})
        check_bitwise(label, out, ref)
        peak = torch.cuda.max_memory_allocated()
        numbers[path] = dict(
            place_s=place_s, peak_bytes=peak,
            launches_per_shard={kernel: 1, 'spectrum_toon': 1},
            sharded_ms=wall_ms(lambda: parallel.sharded_forward(
                scene_s, grid_s, config, m), 5),
            unsharded_ms=wall_ms(lambda: pipeline.forward(scene0, g,
                                                          config), 5))
        del scene_s, grid_s, out
    report(50, 'sharded_forward', numbers)

    # phase 51: the front door's batched 4-phase reflected curve (phase
    # 29's) over a 2 x 2 mesh: the phases over 'batch', the bins over 'wave'
    m = parallel.make_mesh(n_wave=2, n_batch=2, devices=parallel.mesh_devices(4))
    log(f'[51] {m}')
    opa = jdi.Opacity(grid.wno, grid=grid)
    kw_r = dict(phase_grid=np.radians(PHASES_DEG), calculation='reflected')
    ref, ref_ms, _ = timed_call(lambda: facade_case(
        opa, disk=(6, 6), **kw_r).phase_curve(opa, verbose=False))
    got, got_ms, peak = counted(
        '[51] sharded batched phase curve', lambda: timed_call(
            lambda: facade_case(opa, disk=(6, 6), **kw_r).phase_curve(
                opa, verbose=False, mesh=m)),
        {'interp_tau': 2 * N_SCENES, 'reflected_toon': 2 * N_SCENES})
    if list(got) != list(ref):
        raise AssertionError('[51] the sharded curve\'s phases differ')
    for ph in ref:
        check_bitwise(f'[51] phase {ph:.3f}', got[ph], ref[ph])
    report(51, 'sharded_phase_curve', dict(
        mesh=[[str(d) for d in r] for r in m.devices], sharded_ms=got_ms,
        unsharded_ms=ref_ms, peak_bytes_over_alive=peak))
    del opa, got, ref

    # phase 52: the mesh example's kernels at its shape, then the nested
    # sampler over sharded_loglike (tests/test_parallel_climate.py:152-199
    # at its width, on the card in f32); the likelihood reads the albedo
    # alone, so the sampler's forward is reflected-only (K1 + K3), and
    # each point's chi^2 is its own sum
    wno = np.linspace(2000.0, 18000.0, RETRIEVAL_NWNO)
    nl = RETRIEVAL_NLEVEL
    pressure = np.logspace(-6, 2, nl)
    r_grid = factory.synthetic_opacity_grid(wno, ntemp=6, npress=5,
                                            dtype=torch.float32, device=dev)
    r_scene, r_config = pipeline.scene_from_arrays(
        pressure, 1000.0 * (pressure / 10.0) ** 0.1 + 300.0,
        {'H2': np.zeros(nl) + 0.85, 'He': np.zeros(nl) + 0.14,
         'H2O': np.zeros(nl) + 5e-4, 'CH4': np.zeros(nl) + 3e-4}, r_grid,
        gravity=2500.0, radius=7.1e9, mass=1.9e30, rstar=6.96e10)
    ex_config = r_config       # the mesh example's: reflected and thermal
    r_config = dataclasses.replace(r_config, thermal=False,
                                   transmission=False)

    def scaled(sc, s):
        return sc._replace(tlevel=sc.tlevel * s, tlayer=sc.tlayer * s)

    y = pipeline.forward(scaled(r_scene, 1.02), r_grid, r_config)['albedo']

    def chi2(albs, y_dev):
        return torch.stack([-0.5 * ((a - y_dev) ** 2).sum() / 1e-6
                            for a in albs])

    def ll_ref(x):
        x = torch.as_tensor(x, dtype=y.dtype, device=dev)
        return chi2([pipeline.forward(scaled(r_scene, s[0]), r_grid,
                                      r_config)['albedo'] for s in x],
                    y).cpu().numpy()

    m = parallel.make_mesh(n_wave=4, n_batch=2, devices=parallel.mesh_devices(8))
    log(f'[52] {m}')
    scene_s = parallel.shard_scene(r_scene, m)
    grid_s = parallel.shard_grid(r_grid, m)
    # K1 and K2 on every shard of the mesh example's scene (its config,
    # its truth), each against its twin with phases 4 and 5's gates
    twin_abs = {'interp_tau': 0.0, 'spectrum_toon': 0.0}
    for b, row in enumerate(scene_s.shards):
        for w, sc in enumerate(row):
            sc, g = scaled(sc, MESH_EXAMPLE_TRUTH), grid_s.shards[b][w]
            g_args = pipeline.gather_args(sc, g, ex_config)
            k1, k1_ref = interp_tau(*g_args), interp_tau_plain(*g_args)
            check(f'[52] shard ({b}, {w}) {tuple(k1.shape)} gather max rel',
                  rel_stats(k1, k1_ref)[0], TOL['gather_max_rel'])
            twin_abs['interp_tau'] = max(twin_abs['interp_tau'],
                                         (k1 - k1_ref).abs().max().item())
            s_args, s_kw = pipeline.spectrum_args(
                sc, g, ex_config, *pipeline.rt_sources(sc, g, ex_config))
            for name, out, ref in zip(
                    ('xint', 'thermal'), spectrum_toon(*s_args, **s_kw),
                    spectrum_toon_plain(*s_args, **s_kw)):
                twin_abs['spectrum_toon'] = max(
                    twin_abs['spectrum_toon'], check_twin(
                        f'shard ({b}, {w}) spectrum {name}', out, ref,
                        phase=52))
    points = [0]

    def ll_row(x, b):
        points[0] += x.shape[0]
        x = x.to(y.dtype)
        albs = [parallel.sharded_forward(
            scene_s.row(b).map(lambda sc: scaled(sc, s[0].to(
                sc.tlevel.device))), grid_s.row(b), r_config,
            m.row(b))['albedo'] for s in x]
        return chi2(albs, y.to(x.device))

    def prior(u):
        return 0.9 + 0.3 * u

    t0 = time.perf_counter()
    ref = nested_sample(ll_ref, prior, 1, nlive=RETRIEVAL_NLIVE, seed=11,
                        dlogz=0.5)
    ref_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    got = nested_sample(parallel.sharded_loglike(ll_row, m), prior, 1,
                        nlive=RETRIEVAL_NLIVE, seed=11, dlogz=0.5)
    torch.cuda.synchronize()
    got_s = time.perf_counter() - t0
    label = '[52] nested sampler over sharded_loglike'
    launched = {k: v for k, v in counts().items() if v}
    log(f'{label}: launches {launched}, {points[0]} points (padding '
        f'included) x 4 wave shards')
    if launched != {'interp_tau': 4 * points[0],
                    'reflected_toon': 4 * points[0]}:
        raise AssertionError(f'{label}: launches {launched}, expected K1 '
                             f'and K3 once per point and wave shard')
    summary['launches'][label] = launched
    report(52, 'sharded_loglike', dict(
        mesh=[[str(d) for d in r] for r in m.devices], points=points[0],
        dead_points=len(ref.samples), logz=ref.logz, sharded_s=got_s,
        unsharded_s=ref_s, example_shard_shape=list(k1.shape),
        example_kernels_vs_twins_max_abs=twin_abs))
    if got.logz != ref.logz or not np.array_equal(got.samples, ref.samples):
        raise AssertionError('[52] the sharded run\'s dead points or logz '
                             'differ from the unsharded run\'s')
    log(f'[52] the same {len(ref.samples)} dead points and logz '
        f'{ref.logz:.6f} as the unsharded run')
    del scene_s, grid_s, r_grid, r_scene

    # phase 53: run_climate over a 2 x 4 mesh on phase 24's case
    m = parallel.make_mesh(n_wave=4, n_batch=2, devices=parallel.mesh_devices(8))
    log(f'[53] {m}')
    base = REUSED['climate']
    solve = fused.ClimateCounts()
    out, wall, peak = counted(
        '[53] run_climate(mesh=2 x 4), 196 bins, 91 levels, f64',
        lambda: timed_call(lambda: api.run_climate(
            climate_inputs(CLIMATE_NLEVEL), base['ck'], verbose=False,
            counts=solve, device=dev, mesh=m)), {})
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           CLIMATE_REFERENCE)) as f:
        jax_rec = json.load(f)[f'196_{CLIMATE_NLEVEL}']
    temp = out['temperature']
    nstr = [int(i) for i in out['cvz_locs']]
    d_single = float(np.abs(temp - base['temperature']).max())
    d_rel = float(np.max(np.abs(temp - base['temperature'])
                         / np.abs(base['temperature'])))
    d_jax = float(np.abs(temp - np.asarray(jax_rec['temperature'])).max())
    report(53, 'sharded_climate', dict(
        mesh=[[str(d) for d in r] for r in m.devices], wall_s=wall / 1e3,
        unsharded_wall_s=base['numbers']['wall_s'],
        converged=int(out['converged']), cvz_locs=nstr,
        max_dT_to_unsharded=d_single, max_rel_dT_to_unsharded=d_rel,
        max_dT_to_jax=d_jax, flux_balance=flux_balance(out, CLIMATE_TEFF),
        peak_bytes_over_alive=peak, **{f'{k}': v for k, v in
                                       dataclasses.asdict(solve).items()},
        unsharded_flux_evaluations=base['numbers']['flux_evaluations']))
    if (int(out['converged']), nstr) != (base['numbers']['converged'],
                                         base['numbers']['cvz_locs']):
        raise AssertionError('[53] converged / cvz_locs differ from phase '
                             '24\'s unsharded solve')
    if not np.allclose(temp, base['temperature'], rtol=MESH_CLIMATE_RTOL,
                       atol=MESH_CLIMATE_ATOL):
        raise AssertionError(f'[53] T differs from phase 24\'s beyond rtol '
                             f'{MESH_CLIMATE_RTOL} / atol '
                             f'{MESH_CLIMATE_ATOL} K: max {d_single} K')
    check('[53] sharded climate max |dT| to the unsharded solve (K)',
          d_single, MESH_CLIMATE_DT_MAX)
    check('[53] sharded climate max |dT| to the JAX package (K)', d_jax,
          CLIMATE_DT_MAX)
    del out

    # phase 54: the diseq climate of phase 34's T dwarf with (mocked)
    # photochemical kinetics each host iteration
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           PHOTOCHEM_REFERENCE)) as f:
        rec = json.load(f)[PHOTOCHEM_CASE]
    spec = rec['case']
    diseq = REUSED['diseq']
    case = modes_case(jdi, spec)
    pc = MockKinetics()
    case.inputs['climate']['pc'] = pc
    solve = fused.ClimateCounts()
    out, wall, peak = counted(
        f'[54] {PHOTOCHEM_CASE}: diseq_chem with mocked kinetics',
        lambda: timed_call(lambda: case.climate(
            diseq['opa'], diseq_chem=True, verbose=False, counts=solve,
            save_all_profiles=True)), {})
    temp = out['temperature']
    nstr = [int(i) for i in out['cvz_locs']]
    prof = case.inputs['atmosphere']['profile']
    d_t = float(np.abs(temp - np.asarray(rec['temperature'])).max())
    numbers = dict(
        wall_s=wall / 1e3, jax_cpu_s=rec['seconds'],
        converged=int(out['converged']), cvz_locs=nstr, max_dT_to_jax=d_t,
        kinetics_calls=pc.calls, jax_kinetics_calls=rec['calls'],
        max_dT_to_phase_34=float(np.abs(temp - diseq['temperature']).max()),
        flux_balance=flux_balance(out, spec['teff']),
        jax_flux_balance=flux_balance(rec, spec['teff']),
        peak_bytes_over_alive=peak, **dataclasses.asdict(solve))
    report(54, 'photochem_climate', numbers)
    if not np.isfinite(temp).all():
        raise AssertionError('[54] non-finite temperatures')
    if pc.calls < 2 or pc.guesses[0] or not all(pc.guesses[1:]):
        raise AssertionError(f'[54] kinetics calls {pc.guesses}: not cold '
                             f'once, then warm each host iteration')
    if not np.allclose(prof['CH4'], prof['CH4'][-1]):
        raise AssertionError('[54] the profile lost the kinetics\' CH4')
    if (int(out['converged']), nstr) != (rec['converged'], rec['cvz_locs']):
        raise AssertionError('[54] converged / cvz_locs differ from the JAX '
                             'package\'s')
    check(f'[54] {PHOTOCHEM_CASE} max |dT| to the JAX package (K)', d_t,
          CLIMATE_DT_MAX)
    if rec['converged'] and numbers['jax_flux_balance'] <= CLIMATE_BALANCE:
        check(f'[54] {PHOTOCHEM_CASE} flux balance',
              numbers['flux_balance'], CLIMATE_BALANCE)
    summary['wall_s'] = time.perf_counter() - t_mesh
    log(f'[50-54] mesh and photochemistry phases: {summary["wall_s"]:.1f} s')
    return summary


if __name__ == '__main__':
    sys.exit(main())
