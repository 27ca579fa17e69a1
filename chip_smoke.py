#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on one NVIDIA GPU, through
its hand-written kernels, and check the results.

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the
   card's ``nvidia-smi`` name and power limit.
2. Builds the kernels from ``mpmcxx_tpu_torch/csrc`` (nvcc, sm_90a) and
   prints the build time and ptxas report.
3. The CO2 flagship (mpmcxx_tpu_torch/flagship.py, 10,112 live atoms,
   11,264 slots), with the contraction-schedule variables unset (the
   default schedule, K5): K5 ``contract_planes_sym`` against the
   full-plane plain PyTorch version in plane modes 3, 4 and 5 on the
   flagship's own planes and on seeded symmetric planes at A = 4,096
   and 4,032 (nr = 64 and 63 row tiles, where it is also held against
   its own schedule's plain version); relative error <= 1e-5, two launches on one input bitwise
   equal, K1's time (the call and its main kernel) and GB/s on the same
   planes beside K5's, with K1's full-plane bound.  K2
   ``write_plane_strips`` bitwise on copies of a flagship plane at window
   starts 0, mid-plane and A - S with all-valid and partly valid windows
   of S = 3 and 1 rows, the start int64 and int32; its device time
   (torch.profiler) beside the event-timed call.
   Then its main path: ``init_carry(seed=0)`` and two 64-move chunks of
   ``make_chunk_runner``, checking the initial rd / coulombic /
   polarization within 2e-6 (relative) of the reference binary's single
   point (tests/golden/flagship_co2_singlepoint.json); finite energies;
   incremental rd / coulombic within 1e-8 and polarization within 1e-5
   of a fresh ``energy_breakdown_blocked``; the committed planes within
   1e-6 of a fresh ``cache_init``; K5 >= 4 and K2 >= 1 launches per move,
   K2 with S = 3 rows, K1 and K4 none.
4. K5 (mode 3, K1 beside it) and K2 as in step 3 at the shapes of step
   5's run (the runner's 19,712 atom slots); K3 ``occupancy`` bitwise on
   the 24^3 cavity grid against the atoms, on 51,200 seeded darts against
   that grid's open points, and on points with atoms at r (1 +- 1e-12).
5. The cavity-biased CO2 flagship as a user runs it, through the port's
   command line (``mpmcxx_tpu_torch.cli``) in a temporary directory: a
   ``run.in`` with cavity bias on (24^3 grid, radius 2.6 A) and the
   flagship's PQR, 128 uVT moves in two corrtimes.  Checks: exit code 0;
   the energy log's initial energies within 2e-6 of the golden; before
   each corrtime refresh, incremental energies against the refresh's full
   recompute as in step 3; 0 < cavity mean < 1 and two checkpoints; the
   energy log's rows 0, 64, 128; the restart PQR holding 512 + 3 N atoms;
   K5 >= 4, K2 >= 1 and K3 >= 2 launches per move, K1 and K4 none.  Then
   one more 16-move chunk of the run's chain under torch.profiler, every
   move a CUDA graph replay: its device kernels of K1-K5, by name, equal
   to the launches the wrappers counted; its device time per move, split
   by kernel, beside the wall time per move of an unprofiled 16-move
   chunk.
6. The H2 flagship (2,000 5-site H2, 10,752 slots): K4
   ``contract_planes_tri`` against the plain version in modes 3, 4 and 5
   on its planes and on seeded symmetric planes at the ragged A = 4,000
   (relative error <= 1e-5; two launches on one input bitwise equal),
   with K1's time and GB/s on the same planes beside K4's.  Then, with
   ``MPMCXX_TRI_KERNEL=1`` (restored afterwards), its main path as in
   step 3 against tests/golden/flagship_h2_singlepoint.json: K4 >= 4
   launches per move, K1 and K5 none (the recompute included), K2 with
   S = 5.
7. The monatomic flagship (9,728 sorbates, 10,752 slots): K1
   ``contract_planes`` against its plain version (relative error <= 1e-5,
   two launches bitwise equal, [R, 3] out) in mode 3 on its planes and on
   the middle quarter of their rows ([A/4, A], as a row-sharded caller
   passes them), and in modes 3, 4 and 5 on seeded planes with no
   symmetry (B1 contract_pallas's input) at A = 4,096, on the middle
   quarter of their rows and at A = 4,001 (A % 4 != 0, no TMA), each
   call's time and its main kernel's beside the full-plane bound (and on
   the flagship's symmetric planes the triangle's); then, with
   ``MPMCXX_SYM_KERNEL=0`` (the JAX package's full-plane contract_pallas
   schedule), its main path as in step 3 (no golden exists): K1 >= 4
   launches per move, K4 and K5 none, K2 with S = 1.
8. The seven standard-ensemble examples (``examples/``: gcmc-cavity-argon,
   gcmc-mof-co2, -h2 and -mixture, nvt-, npt- and nve-argon) through the
   port's CLI in a temporary directory, at tests/test_examples.py's
   QUICK_STEPS with corrtime half of them, each on the dense path: exit
   code 0, a finite energy log, the incremental energies against each
   refresh (rd and coulombic 1e-8; polarization 1e-5 where a polar
   cache carries it), K1 >= 4 launches per move on the polarizable ones
   (the XLA branch at 63-213 slots) and no other contraction, K3 >= 1
   per move on the cavity-biased one, no SCF kernel on the LJ-only
   ones, a volume move proposed in NPT; wall seconds and steps/s.  Then
   K1 against its plain version on the polarizable examples' committed
   planes (square, and their first quarter of rows) and on seeded planes
   with no symmetry at A = 57 (modes 3, 4 and 5, square and rows):
   relative error <= 1e-5, repeats bitwise.
9. The CO2 flagship's PQR through the CLI without the polar and cavity
   lines (19,712 slots, blocked, incremental LJ/Ewald, 2 corrtimes of
   64): initial rd and coulombic within 2e-6 of the golden, incremental
   vs each refresh within 1e-8, K1, K2, K4 and K5 never launched;
   moves/s.
10. The monatomic flagship in NPT with its polar cache (flagship.build,
   default schedule, volume moves as npt-argon's, 2 A displacements),
   checked as in step 3 at the final box, with K2 once per local move
   and at least one volume move proposed; the wall time of one volume
   move (its full recompute and cache rebuild).
11. The monatomic flagship with polar_mixed off: 8 moves, each a blocked
   full recompute whose SCF contracts in float64 row tiles; energies
   against a fresh ``energy_breakdown_blocked``, no f32-plane kernel
   launched; ms per move.
12. The two other examples through the port's CLI, on the card and then
   on the CPU with the same seed: gibbs-argon and pi-argon-dimer (``-P 8
   -xyz frames.xyz``) at QUICK_STEPS with corrtime half of them.  Exit
   code 0, finite energy logs (one per box for Gibbs), PI's 8 per-bead
   restart files and frames of 16 sites; the card's accept/reject counts
   equal to the CPU's, its energy logs and carried energies within 1e-9
   relative of the CPU's; no K1-K5 launch.
13. Gibbs VLE of LJ argon at tools/gibbs_vle.py's configuration and 2 x
   256 production shape (N = (497, 15), 994 and 512 slots, the dense
   path): 2 corrtimes of 200 steps through GibbsSimulation; each box's
   incremental energy within 1e-9 of each refresh, N_a + N_b and V_a +
   V_b conserved, a transfer and a volume exchange proposed, no K1-K5
   launch; steps/s, synchronizing calls, kernel launches and device time
   per step, and the device's idle share.
14. PI-NVT of 512 single-site para-H2 at 25 K and 0.0233 A^-3 with P =
   16 beads (8,192 atom-bead slots, the incremental LJ path), 2
   corrtimes of 64 moves through PISimulation.run: the carried
   potential within 1e-9 of each per-bead recompute, the kinetic
   estimator below 1.5 N T P, 16 restart files, each move kind accepted
   >= 5 %, no K1-K5 launch; moves/s, synchronizing calls, kernel
   launches and device time per move, the device's idle share, one
   corrtime's restart-write time.
15. The H2 flagship (10,752 slots, the polar cache, the default
   schedule: K5 and K2) at 77 K with Feynman-Hibbs order 4 (the LJ and
   Ewald corrections), its main path as in step 3 but for the golden
   (the reference's is without FH at 150 K); before it the initial
   blocked rd on the card within 1e-9 relative of the port's on the CPU,
   after it the kernel launches per move over a few moves with FH on
   and off; moves/s and K5/K2 launches per move beside step 6's.
16. The pairwise terms one at a time on step 9's LJ-only CLI state
   (19,712 slots, uVT, the incremental path): Waldman-Hagler, Halgren,
   C6 and the 9th-power and sigma repulsions (omega set), buffered 14-7,
   DREIDING, Silvera-Goldman, the dispersion expansion (Tang-Toennies
   damping, extrapolated C10; per-type PHAST2 parameters), Buckingham
   repulsion, Wolf, rd_only and the cavity_autoreject checks.  Each:
   Delta-E of a displacement, an insertion and a removal within 1e-9
   (of the component's energy) of the difference of two blocked
   recomputes on the card; a 32-move chunk whose carried energies are
   within 1e-8 of a refresh; no K1-K5 launch; moves/s.
17. 512 argon-like atoms at 0.0213 A^-3 in NVT, 16 moves each (a dense
   recompute per move): Axilrod-Teller with the Midzuno-Kihara C9, and
   the many-body vdW term (float64 eigenvalues) with Buckingham
   repulsion.  The initial energy on the card within 1e-9 relative of
   the port's on the CPU; finite energies; accepted moves; no K1-K5
   launch; ms per move and the peak device memory.
18. The CO2 flagship on its polar cache (the default schedule: K5 and
   K2) with (i) a precision-terminated SCF (1e-5 Debye) and Palmo's
   correction, 2 chunks of 32 moves as in step 3 (every committed plane,
   the carried energies against a blocked recompute), no SCF in the
   divergence fallback, then at polar.LOOP_GROUP 1 and 8: 16 moves timed,
   16 moves' synchronizing calls, and 16 moves whose K5 launches (the
   wrapper's count and torch.profiler's kernel events) equal the
   iterations rounded up to whole groups plus one for Palmo; (ii) the
   exact solve (CG over the planes), 2 chunks of 4 moves as in step 3
   and 4 moves whose K5 launches equal the CG steps rounded up to whole
   groups plus one; iterations and CG steps per move, syncs per move,
   moves/s.
19. The same flagship's chain, 2 chunks of 32 moves each as in step 3,
   under linear damping (plane mode 4, the Ewald field), polar_wolf with
   polar_wolf_full (mode 5, no k-space) and the no-PBC field (mode 3, no
   k-space): every plane committed by one K2 launch within 1e-6 of a
   rebuild, K5 >= 4 launches per move; K2 bitwise against its plain
   version on the 4 and 5 planes with their mixed symmetric and
   antisymmetric signs; moves/s and K5's call ms per mode.
20. The gcmc-mof-co2 example's initial state with polar_mixed off (the
   dense float64 A matrix): the exact solve, Gauss-Seidel and ranked
   Gauss-Seidel at precision 1e-10, ZODID, Palmo and the full-Ewald SCF,
   each energy on the card within 1e-9 relative of the CPU's with equal
   iteration counts; 8 NVT moves with ranked Gauss-Seidel (no K1-K5
   launch; ms per move; launches of one sweep); the polar_tensor
   golden's atoms through the CLI with ``polarizability_tensor on``:
   exit 0 and the reference's tensor within its print quantum.
21. The special moves on the dense path: the goldens anharmonic,
   gwp_coulomb_kinetic (with its kinetic term) and spectre_nvt through
   ``energy_breakdown`` on the card within 2e-6 of the reference binary
   and 1e-12 relative of the CPU's; then 64 NVT moves on the card and on
   the CPU (seed 0) of SPECTRE on the spectre_nvt state (1 target + 12
   SPECTRE charges; the reader skips its 8 BOX atoms), GWP on the gwp
   golden's atoms, the anharmonic oscillator
   with Feynman-Hibbs order 4, and nvt-argon with no topology (atom-mask
   moves): the same accept sequence, energies within 1e-9 relative,
   SPECTRE charges within 1e-12 and neutral, GWP widths positive; no
   K1-K5 launch; ms per move.
22. The H2 flagship (10,752 slots, S = 5) with its first 16 molecules
   adiabatic through ``runner.Simulation`` in uVT with quantum rotation
   (spinflip_probability 0.1, adiabatic_probability 0.1) on the polar
   cache under the default schedule, 2 corrtimes of 32 moves: a spin
   flip and an adiabatic move proposed, every adiabatic move on a
   flagged molecule, every flip rejected and the spins unchanged (the
   rotational partition functions stay 0, as in the JAX package), the
   carried energies against each refresh as in step 5, every committed
   plane within 1e-6 of a rebuild, K5 >= 4 and K2 >= 1 launches per
   move; moves/s and launches per move, all of the run as the CLI runs
   it (its moves replayed as a CUDA graph).  Its first 2 x SPIN_CHUNK
   moves run again eager with a hook that reads each adiabatic move's
   target: the first corrtime bitwise equal to the run's.
23. Steps 13's Gibbs VLE and 14's PI-NVT with quantum rotation and
   spinflip_probability 0.2, one corrtime each: the spin flips counted
   as a host replay of the move draws counts them, every one rejected,
   and the rest of each step's gates; steps/s and moves/s.
24. Replicas (``parallel.replicas``, ``parallel.driver``) and the native
   PQR codec.  (a) Step 3's CO2 flagship state (11,264 slots, K5 + K2):
   ``make_replica_runner`` with 2 replicas for one 16-move chunk against
   ``make_chunk_runner`` on each replica's initial carry with key
   fold_in(PRNGKey(0), r): the same move types and accepts, energies
   within 1e-9 relative, the committed planes bitwise equal.  (b) Step
   5's cavity-biased flagship (19,712 slots) through ``python -m
   mpmcxx_tpu_torch.cli --replicas 4`` with parallel tempering (ladder
   150 -> 300 K, ptemp_freq 16, 64 steps, corrtime 32): exit code 0; 4
   restart and 4 final PQRs re-read with each replica's live atom count;
   the final temperatures a permutation of the ladder; swap_attempts
   equal to the host's count of left partners per sweep; before each
   refresh each replica's carried rd and coulombic within 1e-8 and
   polarization within 1e-5 of its refresh and every committed plane
   within 1e-6 of a rebuild; per replica K5 >= 4, K2 >= 1 and K3 >= 1
   launches per move, each within 5 % of step 5's, K1 and K4 none; the
   peak device memory within the budget of max_slots(n_caches=4).
   Moves/s per replica and for the run, the swap acceptance, the peak
   memory and the host seconds of each corrtime's 4 restart writes.  (c)
   The codec must build; ``format_pqr`` of step 5's state through it
   byte-identical to the Python path's; one ``write_state_pqr`` each way,
   timed until it returns and until ``drain()`` returns.
25. The mesh paths (parallel/meshing.py) on MESH_SHARDS shards of the
   one card (``make_mesh(devices=["cuda:0"] * 4)``): (e, first) step
   24a's 2 replicas again through ``make_replica_runner(mesh=...)`` on a
   2-shard mesh, bitwise step 24a's (moves, accepts, positions, energies,
   planes); (a) ``sharded_breakdown`` of step 5's state (19,712 slots)
   against ``energy_breakdown_blocked``: rd and coulombic within 1e-9
   relative, polarization within 1e-5, K1 once per shard and SCF
   iteration, K5 and K4 none; then K1 on each shard's [A/4, A] slice
   against its plain version and one sharded contraction timed beside
   the slices' bound; (b) step 5's flagship through
   ``runner.Simulation(cfg, mesh=...)`` from a run.in, 2 corrtimes of 32
   moves, the planes row-sharded: before each refresh the carried
   energies as in step 5 and every shard's planes within 1e-6 of a
   sharded rebuild; per move K1 >= 16, K2 4 and K3 >= 2 launches, K5 and
   K4 none; peak device memory no more than 5 % above step 5's; moves/s
   beside step 5's; the first corrtime's accept sequence beside a
   one-device run under MPMCXX_SYM_KERNEL=0 (printed, not a gate); (c)
   K2's row-slice mode bitwise against its plain version on copies of
   (b)'s shards at window starts 0, inside a shard, across a shard
   boundary and A - S, with its device and call times; (d) step 14's PI
   fluid (512 H2 x 16 beads) for one corrtime through
   ``PISimulation(mesh=...)`` and with no mesh: positions, accepts and
   the carried potential bitwise equal, 16 restart files each, no K1-K5
   launch.
26. The port's bench module (``mpmcxx_tpu_torch/bench.py``) in-process
   at full width, under the default schedule (K5 and K2): one segment of
   ``bench.MEASURE_STEPS`` moves after the warm-up chunk on each flagship
   (CO2, H2, monatomic), ``thole_solve_ms`` on the monatomic flagship's
   planes and the PIMC argon dimer for one chunk after its warm-up.
   Checks: every rate positive and finite; at each flagship's end the
   carried rd and coulombic within 1e-9 and polarization within 1e-5 of
   a blocked recompute; exactly 4 K5 launches per move plus 4 for the
   initial energy and 1 K2 launch per move, no K1, K3 or K4; the Thole
   solve's K5 launches 4 per solve and its energy within 1e-6 relative
   of the same solve with the plain contraction on the same planes; the
   PIMC carried potential within 1e-9 of a per-bead recompute, no kernel
   launched.  Each number beside the card's name and power limit.
27. The validation studies (``python -m mpmcxx_tpu_torch.validate``,
   mpmcxx_tpu_torch/validate/) in-process at wiring length under the
   default schedule: uvt-argon, uvt-polar, uvt-cavity and npt for 3
   corrtimes of 50 steps through runner.Simulation, gibbs-vle at 2 x 128
   as long, ptemp's tempering and independent runs of 100 steps (4 baths,
   swaps every 25) and warmstart on the CO2 flagship at full width
   (11,264 slots), one 16-move chunk per variant (cold-4, warm-2, -3,
   -4).  Checks: every key of each study's JSON line; the carried
   energies against each refresh (rd, coulombic 1e-8, polarization 1e-5;
   each Gibbs box 1e-9; each tempering replica's final energy 1e-9; each
   warm-start checkpoint's rd and coulombic 1e-9 of its truth's
   recompute); every warm-start truth converged, the last within 1e-6 of
   an exact float64 CG solve; launches: uvt-polar exactly 4 K1 and 1 K2
   per move run, uvt-cavity 2 K3 per move run, warmstart K K5 per move
   plus K for the initial energy and 1 K2 per move per variant, every
   other count 0.  The statistics are not gated (the runs are too
   short).
28. Prints ``{"kernels": [...]}`` (per kernel: the sum over the main paths
   of steps 3, 5-27 of its launches, each path counted from 0, and
   the count of each path; the time, plain time and bound at the shapes
   of step 4 for K2, K3 and K5, step 6 for K4 and step 7 for K1, with
   step 25's sliced K1 and row-slice K2 beside them; the worst error of
   the checks), the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.  Any failure raises: non-zero
   exit, no result line.

Imports torch, numpy and the port only (never jax).
"""

import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

CHUNK = 64
CAV_GRID = 24
CAV_RADIUS = 2.6
CLI_SLOTS = 19712        # 512 + 3 x (3,200 live + 3,200 dead) CO2 slots
CLI_DARTS = 51200        # volume / 10 (src/System.Cavity.cpp:131)
RUN_IN = f"""job_name flagship_cav
ensemble uvt
temperature 150.0
pressure 1.0
insert_probability 0.2
move_factor 0.5
numsteps {2 * CHUNK}
corrtime {CHUNK}
seed 0
polarization on
polar_iterative on
polar_ewald on
polar_mixed on
polar_max_iter 4
polar_damp_type exponential
polar_damp 2.1304
cavity_bias on
cavity_grid {CAV_GRID}
cavity_radius {CAV_RADIUS}
pqr_input flagship_co2.pqr
basis1 80 0 0
basis2 0 80 0
basis3 0 0 80
"""
# the flagship CLI run without polarization (phase b): no SCF, no cavity
RUN_IN_NOPOLAR = "\n".join(
    ln for ln in RUN_IN.replace("flagship_cav", "flagship_lj").splitlines()
    if not ln.startswith(("polar", "cavity"))) + "\n"
# the examples that run through the port (tests/test_examples.py's
# QUICK_STEPS; corrtime half of it) and the polarizable ones among them
EXAMPLE_STEPS = {"gcmc-cavity-argon": 60, "gcmc-mof-co2": 40,
                 "gcmc-mof-h2": 40, "gcmc-mof-mixture": 40,
                 "nvt-argon": 200, "npt-argon": 200, "nve-argon": 200}
POLAR_EXAMPLES = ("gcmc-mof-co2", "gcmc-mof-h2", "gcmc-mof-mixture")
SMALL_A = 57             # a ragged small plane beside the examples' own
NPT_PRESSURE = 50.0      # atm; npt-argon's volume move settings below
NPT_VOLUME_PROBABILITY = 0.05
NPT_VOLUME_CHANGE = 0.12
F64_MOVES = 8            # moves of the float64 SCF phase (d)
# phases (c) and (d): 2 A steps instead of the flagship's half cutoff
# (20 A), under which about 1 in 100 displacements is accepted, so that
# local moves are accepted beside the volume moves and full recomputes
SMALL_MOVE_FACTOR = 0.05
K1_REL_TOL = 1e-5        # f32 sums of ~1e4 terms in another order
# phases (g)-(i): the Gibbs and path-integral examples through the CLI
# (tests/test_examples.py's QUICK_STEPS, corrtime half of them; PI with
# -P 8), the Gibbs VLE at tools/gibbs_vle.py's 2 x 256 production shape,
# and PI-NVT of a dense para-H2 fluid
DISPATCHED_STEPS = {"gibbs-argon": 60, "pi-argon-dimer": 200}
EXAMPLE_BEADS = 8
VLE_N_BOX = 256          # atoms per box at the even split
VLE_STEPS = 200          # a corrtime; two of them
# steps (Gibbs) and moves (PI) after the run that torch.profiler counts
# launches and device time over: its records of ~1.7k and ~10k launches
# per step cost seconds to gather
VLE_PROBE, PI_PROBE = 10, 4
PI_H2 = dict(n=512, L=28.01, T=25.0, eps=34.2, sig=2.96, mass=2.016,
             beads=16, moves=64, chain=4, perturb=0.5, move_factor=0.02,
             seed=21)
# step 15: the H2 flagship at 77 K (the BSSP-style H2 isotherm point)
# with Feynman-Hibbs order 4; the launch probe's moves, FH on and off
FH_TEMPERATURE = 77.0
FH_PROBE = 4
# step 16: the pairwise terms one at a time on the LJ-only CLI state.
# Per type (the flagship PQR's Fw, CC, OC): omega and C6/C8/C10 in atomic
# units; the PHAST2 form's Born-Mayer radius (sigma, A) and exponent
# (epsilon, 1/A); Buckingham's C (sigma, K) and rho (epsilon, A).  They
# feed consistency gates, not physics.
PW_SITE = {"Fw": dict(omega=1.10, c6=25.0, c8=600.0, c10=1.5e4),
           "CC": dict(omega=0.90, c6=15.0, c8=350.0, c10=9.0e3),
           "OC": dict(omega=0.80, c6=11.0, c8=230.0, c10=6.0e3)}
PW_PHAST2 = {"Fw": (3.40, 3.2), "CC": (3.10, 3.6), "OC": (2.95, 3.9)}
PW_BUCK = {"Fw": (4.0e5, 0.28), "CC": (3.0e5, 0.25), "OC": (2.5e5, 0.24)}
PW_SETTINGS = {   # FFlags changes, per-type (sigma, epsilon) or None
    "waldmanhagler": (dict(waldmanhagler=True), None),
    "halgren": (dict(halgren_mixing=True), None),
    "c6_mixing": (dict(c6_mixing=True), None),
    "lj_9th": (dict(cdvdw_9th_repulsion=True), None),
    "sig_repulsion": (dict(cdvdw_sig_repulsion=True), None),
    "buffered_14_7": (dict(using_lj_buffered_14_7=True), None),
    "dreiding": (dict(use_dreiding=True), None),
    "sg": (dict(use_sg=True), None),
    "disp_expansion": (dict(using_disp_expansion=True, damp_dispersion=True,
                            extrapolate_disp_coeffs=True), PW_PHAST2),
    "exp_repulsion": (dict(cdvdw_exp_repulsion=True), PW_BUCK),
    "wolf": (dict(wolf=True), None),
    "rd_only": (dict(rd_only=True), None),
    "cavity_absolute": (dict(cavity_autoreject_absolute=True,
                             cavity_autoreject=True), None),
}
PW_CAVITY_SCALE = 1.0    # A: the absolute check's largest valid scale
PW_MOVES = 32
# step 17: 512 argon-like atoms at 0.0213 A^-3 (liquid argon near 90 K),
# L = 28.87 A: alpha (A^3), omega and C6 (a.u.) of argon; LJ for the
# Axilrod-Teller run, Buckingham C (K) and rho (A) for the many-body vdW
# one (its repulsion); 16 NVT moves of each, every one a dense recompute
MB = dict(n=512, density=0.0213, T=90.0, mass=39.948, alpha=1.6411,
          omega=0.70, c6=64.3, eps=119.8, sig=3.405, buck=(6.8e6, 0.16),
          polar_damp=2.1304, moves=16, move_factor=0.02, seed=7)
# steps 18-20: the polar solvers.  Steps 18 and 19 run 2 chunks of
# SCF_CHUNK moves per setting; step 18's SCF ends at SCF_PRECISION Debye,
# which the f32 planes resolve (the goldens' 1e-8 is below their
# rounding: every move would end in the divergence fallback), and
# measures the grouped loop at each of GROUP_SIZES (polar.LOOP_GROUP)
# over GROUP_PROBE moves; its CG runs CG_MOVES moves.  Step 19's Wolf
# field takes SCF_WOLF_ALPHA.  Step 20 solves DENSE_EXAMPLE's initial
# state under each of DENSE_SETTINGS on the card and the CPU (within
# DENSE_REL) and runs DENSE_MOVES NVT moves with ranked Gauss-Seidel.
SCF_CHUNK = 32
SCF_PRECISION = 1e-5
GROUP_SIZES = (1, 8)
GROUP_PROBE = 8
CG_MOVES = 8
SCF_WOLF_ALPHA = 0.2
CACHE_SETTINGS = {   # step 19: FFlags changes, RunParams changes
    "linear": (dict(damp_type=1), {}),
    "wolf_full": (dict(polar_ewald=False, polar_wolf=True,
                       polar_wolf_full=True),
                  dict(polar_wolf_alpha=SCF_WOLF_ALPHA)),
    "nopbc": (dict(polar_ewald=False), {}),
}
DENSE_EXAMPLE = "gcmc-mof-co2"
DENSE_SETTINGS = {   # step 20: FFlags changes, RunParams changes
    "exact": (dict(polar_iterative=False), {}),
    "gs": (dict(polar_gs=True), dict(polar_precision=1e-10)),
    "gs_ranked": (dict(polar_gs_ranked=True), dict(polar_precision=1e-10)),
    "zodid": (dict(polar_zodid=True), {}),
    "palmo": (dict(polar_palmo=True), {}),
    "ewald_full": (dict(polar_ewald_full=True, polar_ewald=False),
                   dict(polar_precision=1e-10)),
}
DENSE_MOVES = 8
DENSE_REL = 1e-9
# steps 21-23: the special moves.  Step 21 runs SPECIAL_MOVES NVT moves of
# each chain (golden or example, FFlags changes, MCOptions) on the card
# and the CPU; step 22 flags the H2 flagship's first H2_ADIABATIC
# molecules adiabatic and runs 2 corrtimes of SPIN_CHUNK moves; steps 22
# and 23 turn quantum rotation on with QROT_LINES (the validator's
# keywords, read by nothing), step 23 at spinflip_probability SPIN_P
SPECIAL_GOLDENS = ("anharmonic", "gwp_coulomb_kinetic", "spectre_nvt")
SPECIAL_MOVES = 64
SPECIAL_CHAINS = {
    "spectre": ("spectre_nvt", {}, dict(
        move_factor=0.3, spectre=True, spectre_max_charge=50.0,
        spectre_max_target=5.0)),
    "gwp": ("gwp_coulomb_kinetic", {}, dict(
        move_factor=0.2, gwp=True, gwp_probability=0.3)),
    "anharmonic_fh4": ("anharmonic", dict(
        feynman_hibbs=True, feynman_hibbs_order=4), dict(
        move_factor=0.4, rd_anharmonic=True)),
    "argon_no_topology": ("nvt-argon", {}, dict(move_factor=0.2)),
}
H2_ADIABATIC = 16
H2_SPIN_SLOTS = 10752
SPIN_CHUNK = 32
QROT_LINES = ("quantum_rotation on\nquantum_rotation_B 85.3\n"
              "quantum_rotation_level_max 36\nquantum_rotation_l_max 5\n"
              "quantum_rotation_sum 10\n")
SPIN_P = 0.2
# step 24: replicas.  Phase (a) runs REP_PAIR replicas of the CO2
# flagship for one REP_A_MOVES-move chunk beside single chains; phase (b)
# the cavity-biased CLI flagship with --replicas REP_R under tempering
# (RUN_IN at REP_STEPS steps, corrtime REP_CORRTIME, swaps every
# REP_PTEMP steps up to REP_TMAX K); its launches per move per replica
# within REP_LAUNCH_REL of step 5's
REP_PAIR = 2
REP_A_MOVES = 16
REP_R = 4
REP_STEPS = 64
REP_CORRTIME = 32
REP_PTEMP = 16
REP_TMAX = 300.0
REP_LAUNCH_REL = 0.05
# step 25: the mesh paths, MESH_SHARDS shards of the one card.  (b) runs 2
# corrtimes of MESH_CORRTIME moves of the CLI flagship, its peak memory at
# most MESH_PEAK_REL above step 5's; (d) one corrtime of MESH_PI_MOVES
# moves of step 14's PI fluid on each side
MESH_SHARDS = 4
MESH_BLOCK = 256         # (a)'s row tile, sharded_breakdown's default
MESH_CORRTIME = 32
MESH_PEAK_REL = 0.05
MESH_PI_MOVES = 64
# step 26: the bench module's measurements, one segment each
BENCH_MODELS = ("co2", "h2", "ar")
BENCH_REPEATS = 1
THOLE_SOLVES = 31        # thole_solve_ms: a warm-up solve, 3 x 10 timed
# step 27: the validation studies at wiring length: VAL_CORRTIMES
# corrtimes of VAL_CORRTIME steps (uVT, NPT, Gibbs at 2 x 128), tempering
# runs of VAL_PTEMP_STEPS with a swap every VAL_PTEMP_SWAP, one chunk of
# VAL_WARM_MOVES per warm-start variant at full width
VAL_CORRTIME = 50
VAL_CORRTIMES = 3
VAL_PTEMP_STEPS = 100
VAL_PTEMP_SWAP = 25
VAL_WARM_MOVES = 16
VAL_WARM_SLOTS = 11264   # the CO2 flagship with 384 insertion slots
VAL_KEYS = {
    "common": ("study", "steps", "wall_s", "verdict", "device", "card"),
    "means": ("corrtime", "seed", "burn_frac", "samples", "means",
              "truths", "sigma"),
    "ptemp": ("swap_every", "seed", "ladder", "baths", "swap"),
    "warmstart": ("chunks", "chunk_steps", "slots", "variants",
                  "decision", "truths", "truth_failed"),
}
MEAN_KEYS = ("mean", "block_err", "tau_err", "err")
SYNTH_A = 4096
RAGGED_A = 4001          # A % 4 != 0: no TMA tensor map (16-byte rows)
SYM_SYNTH_A = (4096, 4032)   # K5's 64-row tiles: nr = 64 (even), 63 (odd)
TRI_SYNTH_A = 4000       # not a multiple of K4's 64-row tile
PROFILE_MOVES = 16
TIMING_REPS = 10
SCHEDULE_VARS = ("MPMCXX_SYM_KERNEL", "MPMCXX_TRI_KERNEL")
# The card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): memory
# 3.35 TB/s; f32 and f64 outside the tensor cores 67 and 34 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# f32 operations per plane entry of the contraction, counted from the
# kernels' code: mode 3's coefficient recompute (27, with expf and rsqrtf
# one each) once per entry, then 18 per direction (d . mu 5, s 1, s d +
# cd mu 12); the triangle takes both directions from one entry
COEFF_OPS = {3: 27, 4: 0, 5: 0}
DIRECTION_OPS = 18
# f64 operations per point-atom test of K3: three differences, three
# squares, two adds, one compare
OCCUPANCY_OPS = 9


def _say(msg):
    print(msg, flush=True)


def _time_ms(fn, reps=TIMING_REPS):
    """Mean device ms of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``nbytes`` over the memory rate and ``ops`` over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _contract_bound(A, mode, elements, directions, rows=None):
    """Bound of ``-T mu`` that reads ``elements`` entries of each of the
    ``mode`` f32 planes once (the tile triangle of symmetric planes, R x A
    of planes with no symmetry), taking ``directions`` sums from each, and
    mu [3,A] f32, and writes [R,3] f32 (R = ``rows``, A by default)."""
    rows = A if rows is None else rows
    nbytes = mode * elements * 4 + 3 * (A + rows) * 4
    ops = elements * (COEFF_OPS[mode] + directions * DIRECTION_OPS)
    return _bound(nbytes, ops, F32_OPS_PER_S)


@contextlib.contextmanager
def schedule(**env):
    """Run with the contraction-schedule variables set as given (a value)
    or unset (left out), then restore them."""
    old = {k: os.environ.get(k) for k in SCHEDULE_VARS}
    try:
        for k in SCHEDULE_VARS:
            if env.get(k) is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = env[k]
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _wrappers():
    """K1-K5's wrappers by function name (tracing.kernel_wrappers)."""
    from mpmcxx_tpu_torch import tracing
    return {name.split()[1]: fn
            for name, fn in tracing.kernel_wrappers().items()}


def zero_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def launches_now():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _rel(got, want):
    import torch
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


GOLDEN = {"co2": "flagship_co2_singlepoint.json",
          "h2": "flagship_h2_singlepoint.json"}


def _synthetic_planes(A, mode, seed, device):
    """Seeded symmetric/antisymmetric f32 planes of one plane mode; mode 3
    displacements span the physical 1-12 A range."""
    import torch
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device)

    def antisym():
        m = rng.standard_normal((A, A), dtype=np.float32)
        return (m - m.T) / 2

    if mode == 3:
        d = np.stack([antisym() for _ in range(3)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-30
        r = rng.uniform(1.0, 12.0, (A, A)).astype(np.float32)
        d *= ((r + r.T) / 2)[..., None]
        return tuple(t(d[..., i]) for i in range(3))
    co = rng.standard_normal((A, A), dtype=np.float32) * 0.01
    co = (co + co.T) / 2
    cd = rng.standard_normal((A, A), dtype=np.float32) * 0.02
    cd = (cd + cd.T) / 2
    d = [antisym() for _ in range(3)]
    if mode == 5:
        return tuple(t(x) for x in [co, cd] + d)
    w = np.sqrt(-np.minimum(co, 0))
    return tuple(t(x) for x in [cd] + [w * x for x in d])


def _nonsym_planes(A, mode, seed, device):
    """Seeded f32 planes with no symmetry (as B1 contract_pallas takes
    them); mode 3 displacements span the physical 1-12 A range."""
    import torch
    rng = np.random.default_rng(seed)
    if mode == 3:
        d = rng.standard_normal((A, A, 3), dtype=np.float32)
        d *= (rng.uniform(1.0, 12.0, (A, A)).astype(np.float32) /
              (np.linalg.norm(d, axis=-1) + 1e-30))[..., None]
        planes = [d[..., i] for i in range(3)]
    else:
        scales = (0.01, 0.01, 1.0, 1.0, 1.0) if mode == 5 else \
            (0.01, 0.1, 0.1, 0.1)
        planes = [rng.standard_normal((A, A), dtype=np.float32) * s
                  for s in scales]
    return tuple(torch.from_numpy(np.ascontiguousarray(p)).to(device)
                 for p in planes)


def _mode_planes(planes3, flags, l, mode):
    """The pair tensor of the mode-3 planes ``planes3`` in plane mode
    ``mode`` (the representations of fold_outer_rows)."""
    from mpmcxx_tpu_torch.ops.polar import coeffs_from_d, fold_outer_rows
    if mode == 3:
        return planes3
    co, cd = coeffs_from_d(*planes3, l)
    return fold_outer_rows(co, cd, *planes3, flags.replace(
        polar_plane_mode=4) if mode == 4 else flags.replace(
        polar_wolf_full=True))


def _mu(A, device, state=None):
    """Seeded dipoles [A,3] f64; with ``state``, zero where the SCF's are
    (dead atoms and alpha = 0 sites: mu = alpha E).  The H2 model puts
    zero-alpha sites 0.008 A apart (H2E and H2N on one axis), where the
    f32 damping polynomial is all rounding noise; the chain never
    contracts a dipole across such a pair."""
    import torch
    mu = torch.from_numpy(np.random.default_rng(A).normal(
        size=(A, 3)) * 0.1).to(device)
    if state is None:
        return mu
    live = state.atom_alive() & (state.polarizability > 0)
    return torch.where(live[:, None], mu, 0.0)


def check_k1(cache, state, flags, params, device, label="flagship"):
    """K1 vs its plain version (relative error <= K1_REL_TOL; two launches
    on one input bitwise equal) on ``cache``'s planes (of ``state``) in
    mode 3 and on the quarter of their rows from the middle ([A/4, A], the
    self-pairs off the slice's diagonal); on seeded planes with no
    symmetry (B1's input) at SYNTH_A, at the ragged RAGGED_A (A % 4 != 0:
    the cp.async fill) and on the middle quarter of the SYNTH_A rows, in
    modes 3, 4 and 5.  Prints each call's event-timed and main-kernel
    (profiler) times beside the full-plane bound, and beside the tile
    triangle's bound on ``cache``'s whole planes (symmetric: K4 and K5
    need no more); returns the record for the kernels line, timed on
    ``cache``'s mode-3 planes."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar

    l = params.polar_damp
    planes3 = (cache.dx, cache.dy, cache.dz)
    A = planes3[0].shape[0]
    worst_abs = 0.0
    rec = {}

    def middle(planes):
        n = planes[0].shape[1]
        return tuple(p[3 * n // 8:3 * n // 8 + n // 4] for p in planes)

    cases = [(label, state, True, (3,),
              lambda m: _mode_planes(planes3, flags, l, m)),
             (f"{label} rows [A/4, A]", state, False, (3,),
              lambda m: middle(planes3)),
             ("non-symmetric", None, False, (3, 4, 5),
              lambda m: _nonsym_planes(SYNTH_A, m, 30 + m, device)),
             ("non-symmetric rows [A/4, A]", None, False, (3, 4, 5),
              lambda m: middle(_nonsym_planes(SYNTH_A, m, 30 + m, device))),
             ("non-symmetric ragged", None, False, (3, 4, 5),
              lambda m: _nonsym_planes(RAGGED_A, m, 40 + m, device))]
    for name, st, symmetric, modes, planes_of_mode in cases:
        for mode in modes:
            planes = planes_of_mode(mode)
            R, A_ = planes[0].shape
            mu = _mu(A_, device, st)
            got = cuda_polar.contract_planes(planes, mu, l)
            again = cuda_polar.contract_planes(planes, mu, l)
            want = cuda_polar.contract_planes_plain(planes, mu, l)
            torch.cuda.synchronize()
            if got.shape != (R, 3) or not torch.equal(got, again):
                raise AssertionError(
                    f"K1 {name} mode {mode}: shape {tuple(got.shape)}, or "
                    "two launches on one input differ")
            rel = _rel(got, want)
            err = float(torch.max(torch.abs(got - want)))
            ms = _time_ms(lambda: cuda_polar.contract_planes(planes, mu, l))
            main_ms, seen = _main_ms(
                lambda: cuda_polar.contract_planes(planes, mu, l))
            plain_ms = _time_ms(
                lambda: cuda_polar.contract_planes_plain(planes, mu, l))
            full = _contract_bound(A_, mode, R * A_, 1, R)
            tri = (_contract_bound(A_, mode, tri_elements(
                A_, cuda_polar.TRI_TILE), 2) if symmetric else None)
            _say(f"K1 contract_planes {name} {R}x{A_} mode {mode}: "
                 f"max_abs_err {err:.3e} rel_err {rel:.3e}, repeat bitwise "
                 f"equal;  kernel {ms:.4f} ms (main kernel {main_ms:.4f}, "
                 f"{seen} launches recorded; "
                 f"{mode * R * A_ * 4 / ms / 1e6:.0f} GB/s of planes)  "
                 f"plain {plain_ms:.3f} ms  bound {full[0]:.4f} ms "
                 f"({full[1]}, full planes: call {full[0] / ms:.1%}, main "
                 f"{full[0] / main_ms:.1%})"
                 + (f", {tri[0]:.4f} ms ({tri[1]}, the triangle of the "
                    "symmetric planes; K1's contract reaches at most half "
                    "of it)" if tri else ""))
            if not rel <= K1_REL_TOL:
                raise AssertionError(
                    f"K1 {name} mode {mode}: rel err {rel:.3e} > "
                    f"{K1_REL_TOL}")
            worst_abs = max(worst_abs, err)
            if name == label and mode == 3:
                rec = {"ms": ms, "main_ms": main_ms, "plain_ms": plain_ms,
                       "bound": tri, "bound_full_planes_ms": full[0]}
            del planes
    rec["max_abs_err"] = worst_abs
    return rec


def _main_ms(fn):
    """(device ms of one launch, launches recorded) of the main kernel of
    ``fn`` (K1's contract_planes_kernel, the one with the most device
    time) over TIMING_REPS calls under torch.profiler: the mean over the
    launches it recorded."""
    split = device_split(fn, want="contract_planes")
    if not split:
        raise AssertionError("the profiler saw no kernel")
    ms, n = max(split.values())
    return ms / n, round(n * TIMING_REPS)


def tri_elements(A, b):
    """Plane entries in the tile pairs I <= J of b x b tiles of an A x A
    plane, the ragged last tile included: (A^2 + sum of row-tile
    heights^2) / 2, which is A^2/2 + A b/2 when b divides A."""
    heights = [min(b, A - i) for i in range(0, A, b)]
    return (A * A + sum(h * h for h in heights)) // 2


def check_k5(cache, state, flags, params, device, label, modes=(3, 4, 5),
             synthetic=True):
    """K5 vs the full-plane plain version in ``modes`` on ``cache``'s
    planes (of ``state``) and, when ``synthetic``, on seeded symmetric
    planes at each of SYM_SYNTH_A (nr even and odd), where it is also held
    against contract_planes_sym_plain, its own schedule in PyTorch; each
    K5 output bitwise equal to a second launch on the same input.  Prints
    K5's and K1's times and GB/s on the same planes (K5's of the bytes it
    reads, the tile triangle; K1's of the full planes, with its main
    kernel's time on ``cache``'s planes) and, on ``cache``'s mode-3
    planes, one K5 call's device time by kernel; returns the kernels-line
    record, timed on those planes."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar

    l = params.polar_damp
    b = cuda_polar.SYM_TILE
    planes3 = (cache.dx, cache.dy, cache.dz)
    A = planes3[0].shape[0]
    worst_abs = 0.0
    rec = {}
    cases = [(label, A, state,
              lambda m: _mode_planes(planes3, flags, l, m))]
    if synthetic:
        cases += [(f"synthetic nr={A_ // b}", A_, None,
                   lambda m, A_=A_: _synthetic_planes(A_, m, 50 + m, device))
                  for A_ in SYM_SYNTH_A]
    for name, A_, st, planes_of_mode in cases:
        mu = _mu(A_, device, st)
        for mode in modes:
            planes = planes_of_mode(mode)
            got = cuda_polar.contract_planes_sym(planes, mu, l)
            again = cuda_polar.contract_planes_sym(planes, mu, l)
            want = cuda_polar.contract_planes_plain(planes, mu, l)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K5 {name} mode {mode}: two launches "
                                     "on one input differ")
            rel = _rel(got, want)
            sched_rel = (_rel(got, cuda_polar.contract_planes_sym_plain(
                planes, mu, l)) if st is None else 0.0)
            err = float(torch.max(torch.abs(got - want)))
            ms = _time_ms(
                lambda: cuda_polar.contract_planes_sym(planes, mu, l))
            k1_rel = _rel(cuda_polar.contract_planes(planes, mu, l), want)
            k1_ms = _time_ms(
                lambda: cuda_polar.contract_planes(planes, mu, l))
            k1_main_ms = (_main_ms(
                lambda: cuda_polar.contract_planes(planes, mu, l))[0]
                if st is not None else None)
            plain_ms = _time_ms(
                lambda: cuda_polar.contract_planes_plain(planes, mu, l))
            tri_gb = mode * tri_elements(A_, b) * 4 / 1e9
            full_gb = mode * A_ * A_ * 4 / 1e9
            bound = _contract_bound(A_, mode, tri_elements(A_, b), 2)
            k1_bound = _contract_bound(A_, mode, A_ * A_, 1)
            _say(f"K5 contract_planes_sym {name} A={A_} mode {mode}: "
                 f"max_abs_err {err:.3e} rel_err {rel:.3e}"
                 + (f" (vs its schedule's plain {sched_rel:.3e})"
                    if st is None else "") +
                 f", repeat bitwise equal;  K5 {ms:.4f} ms "
                 f"({tri_gb / ms * 1e3:.0f} GB/s of the triangle's "
                 f"{tri_gb:.3f} GB; bound {bound[0]:.4f} ms, "
                 f"{bound[0] / ms:.1%})  K1 {k1_ms:.4f} ms"
                 + (f", main kernel {k1_main_ms:.4f}" if k1_main_ms else "")
                 + f" ({full_gb / k1_ms * 1e3:.0f} GB/s of {full_gb:.3f} "
                 f"GB; its full-plane bound {k1_bound[0]:.4f} ms, call "
                 f"{k1_bound[0] / k1_ms:.1%}"
                 + (f", main {k1_bound[0] / k1_main_ms:.1%}"
                    if k1_main_ms else "")
                 + f"; rel_err {k1_rel:.3e})  plain {plain_ms:.3f} ms")
            if not max(rel, sched_rel, k1_rel) <= K1_REL_TOL:
                raise AssertionError(
                    f"K5 {name} mode {mode}: rel err {rel:.3e} (its "
                    f"schedule's plain {sched_rel:.3e}, K1 {k1_rel:.3e}) "
                    f"> {K1_REL_TOL}")
            worst_abs = max(worst_abs, err)
            if name == label and mode == 3:
                rec = {"ms": ms, "plain_ms": plain_ms, "k1_ms": k1_ms,
                       "bound": bound}
                split = device_split(
                    lambda: cuda_polar.contract_planes_sym(planes, mu, l),
                    want="contract_sym")
                if not split:
                    raise AssertionError("the profiler saw no K5 kernel")
                main_ms = max(ms / n for ms, n in split.values())
                _say("  K5 call's device time by kernel (mean of the "
                     "launches recorded): " + ", ".join(
                         f"{k} {ms / n:.4f} ms" for k, (ms, n) in
                         split.items()) +
                     f"; main kernel {bound[0] / main_ms:.1%} of the bound")
            del planes
    rec["max_abs_err"] = worst_abs
    return rec


def device_split(fn, reps=TIMING_REPS, tries=8, want="", count=0):
    """Device ms and kernels per call of ``fn``, by kernel name
    (torch.profiler over ``reps`` calls after one warm-up call).  On this
    card the profiler now and then records no device event of a session,
    or none of the kernel being measured, so a session without an event
    whose name holds ``want`` (or, with ``count``, with fewer than
    ``count`` such kernels per call) is run again, up to ``tries``
    sessions; every call of ``fn`` runs the same work, so the sessions
    are alike."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        out = {}
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                k = re.search(r"(\w+)(?:<[^>]*>)?\(", e.name)
                key = k.group(1) if k else e.name[:40]
                ms, n = out.get(key, (0.0, 0.0))
                out[key] = (ms + e.time_range.elapsed_us() / 1e3 / reps,
                            n + 1 / reps)
        seen = sum(n for k, (_, n) in out.items() if want in k)
        if seen and seen >= count - 1e-9:
            break
    return out


def check_k4(cache, state, flags, params, device, label="H2 flagship"):
    """K4 vs its plain version (the full-plane contract_planes_plain, the
    reference of both contraction kernels) in plane modes 3, 4 and 5 on
    ``cache``'s planes and on seeded symmetric planes at the ragged
    TRI_SYNTH_A; each K4 output bitwise equal to a second launch on the
    same input.  Prints K4's and K1's times and GB/s on the same planes;
    returns the kernels-line record, timed on ``cache``'s mode-3 planes."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar

    l = params.polar_damp
    b = cuda_polar.TRI_TILE
    planes3 = (cache.dx, cache.dy, cache.dz)
    A = planes3[0].shape[0]
    worst_abs = 0.0
    rec = {}
    for name, A_, st, planes_of_mode in (
            (label, A, state, lambda m: _mode_planes(planes3, flags, l, m)),
            ("synthetic", TRI_SYNTH_A, None,
             lambda m: _synthetic_planes(TRI_SYNTH_A, m, 20 + m, device))):
        mu = _mu(A_, device, st)
        for mode in (3, 4, 5):
            planes = planes_of_mode(mode)
            got = cuda_polar.contract_planes_tri(planes, mu, l)
            again = cuda_polar.contract_planes_tri(planes, mu, l)
            want = cuda_polar.contract_planes_plain(planes, mu, l)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K4 {name} mode {mode}: two launches "
                                     "on one input differ")
            rel = _rel(got, want)
            err = float(torch.max(torch.abs(got - want)))
            ms = _time_ms(
                lambda: cuda_polar.contract_planes_tri(planes, mu, l))
            k1_rel = _rel(cuda_polar.contract_planes(planes, mu, l), want)
            k1_ms = _time_ms(
                lambda: cuda_polar.contract_planes(planes, mu, l))
            plain_ms = _time_ms(
                lambda: cuda_polar.contract_planes_plain(planes, mu, l))
            tri_gb = mode * tri_elements(A_, b) * 4 / 1e9
            _say(f"K4 contract_planes_tri {name} A={A_} mode {mode}: "
                 f"max_abs_err {err:.3e} rel_err {rel:.3e}, repeat "
                 f"bitwise equal;  K4 {ms:.4f} ms "
                 f"({tri_gb / ms * 1e3:.0f} GB/s of the triangle's "
                 f"{tri_gb:.3f} GB)  K1 {k1_ms:.4f} ms "
                 f"({mode * A_ * A_ * 4 / k1_ms / 1e6:.0f} GB/s of "
                 f"{mode * A_ * A_ * 4 / 1e9:.3f} GB, rel_err "
                 f"{k1_rel:.3e})  plain {plain_ms:.3f} ms")
            if not max(rel, k1_rel) <= K1_REL_TOL:
                raise AssertionError(
                    f"K4 {name} mode {mode}: rel err {rel:.3e} (K1 "
                    f"{k1_rel:.3e}) > {K1_REL_TOL}")
            worst_abs = max(worst_abs, err)
            if name == label and mode == 3:
                rec = {"ms": ms, "plain_ms": plain_ms, "k1_ms": k1_ms,
                       "bound": _contract_bound(A_, 3, tri_elements(A_, b),
                                                2)}
            del planes
    rec["max_abs_err"] = worst_abs
    return rec


def check_k2(cache, device):
    """K2 vs its plain version, bitwise, on copies of ``cache``'s plane at
    window starts 0, mid-plane and A - S, for S = 3 (CO2) with all-valid
    and partly valid windows and S = 1 (monatomic), the start as the
    chain's int64 and once as int32.  Times the main path's commit (three
    planes, S = 3): the kernel's device time (torch.profiler) and the
    event-timed call (the wrapper's host work included).  Returns the
    kernels-line record, whose ms is the device time."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar
    from mpmcxx_tpu_torch.ops.polar_cache import commit_strips

    A = cache.dx.shape[0]
    rng = np.random.default_rng(7)
    cases = [(3, v, torch.int64) for v in ((True, True, True),
                                           (True, False, True))]
    cases += [(1, (True,), torch.int64), (1, (False,), torch.int64),
              (3, (True, True, True), torch.int32)]
    for S, valid, dtype in cases:
        for start in (0, A // 2 + 1, A - S):
            base = (cache.dx.clone(),)
            rows = (torch.from_numpy(rng.normal(size=(S, A)).astype(
                np.float32)).to(device),)
            st = torch.tensor(start, dtype=dtype, device=device)
            vt = torch.tensor(valid, device=device)
            blend, cols = commit_strips(base, rows, st, vt, -1.0)
            k = (base[0].clone(),)
            p = (base[0].clone(),)
            cuda_polar.write_plane_strips(k, blend, cols, st)
            cuda_polar.write_plane_strips_plain(p, blend, cols, st)
            torch.cuda.synchronize()
            if not torch.equal(k[0], p[0]):
                raise AssertionError(f"K2 S={S} start {start} valid {valid} "
                                     f"{dtype}: kernel differs from plain")
            _say(f"K2 write_plane_strips S={S} start={start} valid={valid} "
                 f"{str(dtype).split('.')[-1]}: bitwise equal")
            del base, k, p
    # the commit shape of the main path: three planes, S = 3
    S = 3
    planes = (cache.dx, cache.dy, cache.dz)
    st = torch.tensor(A // 2, device=device)
    vt = torch.ones(S, dtype=torch.bool, device=device)
    rows = tuple(pl.index_select(0, st + torch.arange(S, device=device))
                 for pl in planes)
    blend, cols = commit_strips(planes, rows, st, vt, -1.0)

    def call():
        cuda_polar.write_plane_strips(planes, blend, cols, st)
    split = {k: v for k, v in device_split(
        call, want="write_plane_strips").items()
        if "write_plane_strips" in k}
    if not split:
        raise AssertionError("the profiler saw no K2 kernel")
    rec = {"ms": sum(ms / n for ms, n in split.values()),
           "call_ms": _time_ms(call),
           "plain_ms": _time_ms(lambda: cuda_polar.write_plane_strips_plain(
               planes, blend, cols, st)),
           "max_abs_err": 0.0,
           # reads the row and column strips, writes them into the planes
           "bound": _bound(4 * len(planes) * S * A * 4, 0, F32_OPS_PER_S)}
    _say(f"K2 write_plane_strips 3 planes A={A} S={S}: kernel "
         f"{rec['ms']:.4f} ms of device time (profiler, the mean of "
         f"{sum(n for _, n in split.values()) * TIMING_REPS:.0f} launches "
         f"recorded of {TIMING_REPS}), call {rec['call_ms']:.4f} ms "
         f"(events), plain "
         f"{rec['plain_ms']:.4f} ms, bound {rec['bound'][0]:.5f} ms "
         f"({rec['bound'][1]}; launch-bound)")
    return rec


def cli_flagship_state(pqr, device, with_meta=False):
    """The state the runner builds from the flagship's PQR: uVT headroom
    of one dead slot per live sorbate (runner.py:94-107), 19,712 slots
    (and its meta, ``with_meta``)."""
    from mpmcxx_tpu_torch.io.pqr import read_pqr
    from mpmcxx_tpu_torch.state import build_state
    atoms = read_pqr(pqr)
    n_mov = len({a.molecule_id for a in atoms if not a.frozen})
    state, meta = build_state(atoms, np.eye(3) * 80.0,
                              extra_mol_capacity=max(n_mov, 32),
                              device=device)
    return (state, meta) if with_meta else state


def check_k3(state, device):
    """K3 vs its plain version, bitwise, on the CLI run's grid and darts
    and on a seeded near-boundary case; returns the kernels-line record."""
    import torch
    from mpmcxx_tpu_torch.mc import cavity
    from mpmcxx_tpu_torch.ops import cuda_cavity
    from mpmcxx_tpu_torch.pbc import _mul3

    pos = cavity.wrapped_positions(state)
    grid = cavity.grid_points(state, CAV_GRID)
    rng = np.random.default_rng(5)
    darts = _mul3(torch.from_numpy(
        rng.uniform(size=(int(80.0 ** 3 * 0.1), 3)) - 0.5).to(device),
        state.pbc.basis)
    # atoms at r (1 +- 1e-12) of seeded points, a third of them dead
    P = 4096
    pts = torch.from_numpy(rng.uniform(-40, 40, (P, 3))).to(device)
    u = rng.normal(size=(2 * P, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    scale = CAV_RADIUS * (1.0 + 1e-12 * rng.choice([-1.0, 1.0], 2 * P))
    near = pts.repeat(2, 1) + torch.from_numpy(u * scale[:, None]).to(device)
    near_alive = torch.from_numpy(rng.uniform(size=2 * P) > 1 / 3).to(device)

    open_mask = ~cuda_cavity.occupancy_plain(grid, pos, state.aalive,
                                             CAV_RADIUS)
    rec = {"max_abs_err": 0.0}
    for label, args in (
            ("grid", (grid, pos, state.aalive)),
            ("darts", (darts, grid, open_mask)),
            ("near-boundary", (pts, near, near_alive))):
        got = cuda_cavity.occupancy(*args, CAV_RADIUS)
        want = cuda_cavity.occupancy_plain(*args, CAV_RADIUS)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"K3 {label}: {int((got != want).sum())} of {got.numel()} "
                "points differ from the plain version")
        ms = _time_ms(lambda: cuda_cavity.occupancy(*args, CAV_RADIUS))
        plain_ms = _time_ms(
            lambda: cuda_cavity.occupancy_plain(*args, CAV_RADIUS))
        _say(f"K3 occupancy {label}: {args[0].shape[0]} points x "
             f"{args[1].shape[0]} atoms, {int(got.sum())} occupied; bitwise "
             f"equal; kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        if label == "grid":
            # at least one test per occupied point, every live atom for
            # an open one; points and atoms read once, a byte per point out
            n_open = int(open_mask.sum())
            n_alive = int(state.aalive.sum())
            P, A = grid.shape[0], pos.shape[0]
            ops = OCCUPANCY_OPS * (n_open * n_alive + (P - n_open))
            rec.update(ms=ms, plain_ms=plain_ms, bound=_bound(
                P * 24 + A * 25 + P, ops, F64_OPS_PER_S))
            _say(f"  open fraction of the grid: "
                 f"{float(open_mask.double().mean()):.4f}")
        else:
            rec[f"{label}_ms"], rec[f"{label}_plain_ms"] = ms, plain_ms
    return rec


def _instrument_chain(log):
    """Wrap the port's chunk runner and refresher (as the runner looks
    them up) to time each chunk on the card and record the incremental
    energies just before each corrtime refresh beside the refresh's full
    recompute.  Returns a function that undoes the wrapping."""
    import torch
    from mpmcxx_tpu_torch.mc import chain
    orig_runner, orig_refresher = chain.make_chunk_runner, \
        chain.make_refresher
    fields = ("rd_energy", "coulombic_energy", "polarization_energy")

    def make_chunk_runner(*a, **kw):
        run_chunk = orig_runner(*a, **kw)

        def timed(carry):
            torch.cuda.synchronize()
            t0 = time.time()
            carry, outs = run_chunk(carry)
            torch.cuda.synchronize()
            log["chunks"].append((len(outs.movetype), time.time() - t0,
                                  outs))
            return carry, outs
        return timed

    def make_refresher(*a, **kw):
        refresh = orig_refresher(*a, **kw)

        def recorded(carry):
            inc = {f: float(getattr(carry.obs, f)) for f in fields}
            out = refresh(carry)
            log["refresh"].append(
                (inc, {f: float(getattr(out.obs, f)) for f in fields}))
            return out
        return recorded

    chain.make_chunk_runner = make_chunk_runner
    chain.make_refresher = make_refresher

    def undo():
        chain.make_chunk_runner = orig_runner
        chain.make_refresher = orig_refresher
    return undo


def _run_cli(workdir, args, instrument=None, log=None):
    """``cli.run(args)`` in ``workdir`` with every launch count 0 just
    before and the chain instrumented (``instrument``, _instrument_chain
    by default, filling ``log``); returns (the simulation, its chain log,
    launch counts, wall s, stdout)."""
    import torch
    from mpmcxx_tpu_torch import cli
    if log is None:
        log = {"chunks": [], "refresh": []}
    undo = (instrument or _instrument_chain)(log)
    stdout = io.StringIO()
    cwd = os.getcwd()
    zero_launches()
    t0 = time.time()
    try:
        os.chdir(workdir)
        with contextlib.redirect_stdout(stdout):
            rc, sim = cli.run(args)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        undo()
    if rc != 0:
        raise AssertionError(f"the CLI run in {workdir} exited with {rc}")
    return sim, log, launches_now(), time.time() - t0, stdout.getvalue()


def _check_refreshes(label, log, fields, n_refresh):
    """Before each corrtime refresh, the incremental energies against the
    refresh's full recompute, each field within its tolerance: relative,
    of 1 K where the full value is smaller (a term that is 0 exactly, as
    when the last charged molecule left, keeps its Delta-E sums' rounding)."""
    if len(log["refresh"]) != n_refresh:
        raise AssertionError(f"{label}: {len(log['refresh'])} refreshes, "
                             f"want {n_refresh}")
    for c, (inc, full) in enumerate(log["refresh"]):
        for name, tol in fields:
            diff = abs(inc[name] - full[name])
            rel = diff / max(abs(full[name]), 1.0)
            ok = rel <= tol
            _say(f"{label} corrtime {c + 1}: incremental {name} "
                 f"{inc[name]:.9f} vs full {full[name]:.9f}: rel {rel:.2e} "
                 f"(tol {tol:g})")
            if not ok:
                raise AssertionError(f"{label} {name}: incremental vs full "
                                     f"rel {rel}")


def run_cli_flagship(workdir, golden, device="cuda"):
    """Step 5: the cavity-biased flagship through the port's CLI in
    ``workdir`` (which holds flagship_co2.pqr); returns the launch counts
    of the run and {"peak_gb": its peak device memory, "rate": its second
    corrtime's moves/s, "base_gb": the memory allocated before it}."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.io.pqr import read_pqr

    with open(os.path.join(workdir, "run.in"), "w") as f:
        f.write(RUN_IN)
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    sim, log, launches, wall, stdout = _run_cli(
        workdir, ["--device", str(device), "run.in"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for line in stdout.splitlines():
        if line.startswith(("SIM_CONTROL: Simulation complete",
                            "OUTPUT: Grand Total", "OUTPUT: Cavity",
                            "OUTPUT: AR")):
            _say("  cli| " + line)
    _say(f"CLI run: exit code 0, {wall:.1f} s wall including set-up")

    n_moves = 2 * CHUNK
    st = sim.carry.state
    _say(f"CLI run: {st.n_atom_slots} atom slots, grid {CAV_GRID}^3 = "
         f"{CAV_GRID ** 3} points, {sim.opts.cavity_darts} darts per move")
    if st.n_atom_slots != CLI_SLOTS or sim.opts.cavity_darts != CLI_DARTS:
        raise AssertionError("the CLI run is not at the flagship's width")

    # the energy log: header, rows 0, 64 and 128
    with open(os.path.join(workdir, "flagship_cav.energy.dat")) as f:
        lines = f.read().splitlines()
    rows = [[float(x) for x in ln.split()] for ln in lines[1:]]
    if not lines[0].startswith("#step #energy") or \
            [r[0] for r in rows] != [0, CHUNK, 2 * CHUNK]:
        raise AssertionError(f"energy log rows: {[r[0] for r in rows]}")
    if not np.all(np.isfinite(rows)):
        raise AssertionError("the energy log holds non-finite values")
    for comp, col in (("rd", 3), ("coulombic", 2), ("polar", 4)):
        ours = rows[0][col]
        rel = abs(ours - golden[comp]) / abs(golden[comp])
        _say(f"CLI initial {comp} {ours:.6f} vs reference binary "
             f"{golden[comp]:.6f}: rel {rel:.2e} (tol 2e-06)")
        if not rel <= 2e-6:
            raise AssertionError(f"CLI initial {comp} off the golden: {rel}")
    _check_refreshes("CLI", log, (("rd_energy", 1e-8),
                                  ("coulombic_energy", 1e-8),
                                  ("polarization_energy", 1e-5)), 2)
    cav = sim.carry.cavity.tolist()
    _say(f"cavity carry: mean open fraction {cav[0]:.6f}, dart volume "
         f"{cav[1]:.3f} A^3, snapshot {cav[2]:.6f}, checkpoints {cav[3]:g}")
    if not (0.0 < cav[0] < 1.0 and cav[3] == 2.0):
        raise AssertionError(f"cavity carry {cav}")
    outs = [o for _, _, o in log["chunks"]]
    mt = torch.cat([o.movetype for o in outs])
    acc = torch.cat([o.accepted for o in outs])
    biased = torch.cat([o.biased for o in outs])
    ins = mt == const.MOVETYPE_INSERT
    rem = mt == const.MOVETYPE_REMOVE
    n_bi = int((ins & biased & acc).sum())
    _say(f"moves: {int(ins.sum())} inserts ({int((ins & biased).sum())} "
         f"biased, {n_bi} of those accepted), {int(rem.sum())} removes "
         f"({int((rem & biased).sum())} biased, "
         f"{int((rem & biased & acc).sum())} accepted), "
         f"{int(acc.sum())} of {n_moves} moves accepted")
    if n_bi == 0:
        _say("no biased insertion was accepted in this run")
    # the restart PQR read back: the live atoms, frozen + 3 N
    N = int(sim.carry.obs.N)
    n_frozen = int(st.frozen.sum())
    n_atoms = len(read_pqr(os.path.join(workdir,
                                        "flagship_cav.restart.pqr")))
    _say(f"restart PQR: {n_atoms} atoms = {n_frozen} framework + 3 x "
         f"N = {N}")
    if n_atoms != n_frozen + 3 * N:
        raise AssertionError(f"restart PQR has {n_atoms} atoms, N = {N}")
    steps, dt, _ = log["chunks"][-1]
    _say(f"CLI second corrtime: {steps} moves in {dt:.3f} s = "
         f"{steps / dt:.2f} moves/s; peak device memory {peak_gb:.2f} GB; "
         f"launches {launches}")
    for name, per_move in (("contract_planes_sym", 4),
                           ("write_plane_strips", 1), ("occupancy", 2)):
        if launches[name] < per_move * n_moves:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"for {n_moves} moves")
    if launches["contract_planes_tri"] or launches["contract_planes"]:
        raise AssertionError("K1 or K4 ran on the default schedule")
    profile_chunk(sim)
    return launches, {"peak_gb": peak_gb, "base_gb": base_gb,
                      "rate": steps / dt}


# kernel-name fragments -> the kernel they belong to (profiler groups)
KERNEL_GROUPS = (("contract_sym_kernel", "K5 contract_planes_sym"),
                 ("sum_sym_slots", "K5 contract_planes_sym"),
                 ("mu_soa_kernel", "K5 contract_planes_sym"),
                 ("contract_planes_kernel", "K1 contract_planes"),
                 ("sum_row_slots", "K1 contract_planes"),
                 ("contract_tri_kernel", "K4 contract_planes_tri"),
                 ("sum_slots_kernel", "K4 contract_planes_tri"),
                 ("write_plane_strips", "K2 write_plane_strips"),
                 ("occupancy_kernel", "K3 occupancy"),
                 ("Memset", "memsets and copies"),
                 ("Memcpy", "memsets and copies"))


def replayed_kernels(split, delta):
    """Per kernel-name fragment of K1-K5 (KERNEL_GROUPS): (device kernels
    of that name in ``split``, launches its wrapper counted in ``delta``).
    Each launch of a wrapper runs each kernel of its group once."""
    return {frag: (round(sum(n for k, (_, n) in split.items() if frag in k)),
                   delta[group.split()[1]])
            for frag, group in KERNEL_GROUPS if group.startswith("K")}


def profile_chunk(sim, moves=PROFILE_MOVES, tries=8):
    """After the CLI run: one ``moves``-move chunk of its chain under
    torch.profiler (after a warm-up chunk, so that every move of it is a
    replay of the move's CUDA graph), whose device time per move is
    printed split by kernel (ours by name, every other kernel as "torch
    kernels"), beside the wall time per move of one more, unprofiled
    chunk.  Kernels of one stream do not overlap, so their times add.
    Gate: the device kernels of each of K1-K5 the profiler saw in the
    replayed chunk equal the launches its wrapper counted there (a
    session that saw fewer is profiled again, up to ``tries``)."""
    import torch
    from mpmcxx_tpu_torch import tracing
    from mpmcxx_tpu_torch.mc import chain

    if not chain.graphs_apply(sim.carry.state.pos.device, sim.flags,
                              sim.params, sim.opts, sim.carry.pcache):
        raise AssertionError("the CLI run's chain is not graphed")
    run = chain.make_chunk_runner(sim.flags, sim.params, sim.opts, moves,
                                  topology=sim.topology)
    carry = [sim.carry]
    deltas = []

    def chunk():
        before = launches_now()
        carry[0], _ = run(carry[0])
        deltas.append({k: n - before[k] for k, n in launches_now().items()})

    tracing.reset()
    tracing.enable()
    try:
        for session in range(1, tries + 1):
            split = device_split(chunk, reps=1)
            seen = replayed_kernels(split, deltas[-1])
            if all(got == want for got, want in seen.values()):
                break
        counters = {k: v.get("step", 0) for k, v in
                    tracing.snapshot()["counters"].items()
                    if k.startswith("graph_")}
    finally:
        tracing.disable()
        tracing.reset()
    _say(f"CLI profiled chunk replayed (moves of this runner: {counters}): "
         f"device kernels seen vs wrapper launches counted, by kernel: "
         + ", ".join(f"{frag} {got}/{want}"
                     for frag, (got, want) in seen.items())
         + f" (profiler session {session})")
    # one eager move and one capture, in the first chunk: every later
    # chunk replayed every move
    if counters.get("graph_eager") != 1 or \
            counters.get("graph_capture") != 1:
        raise AssertionError(f"the profiled chunk was not replayed: "
                             f"{counters}")
    if any(got != want for got, want in seen.values()) or \
            not any(want for _, want in seen.values()):
        raise AssertionError(f"replayed kernels {seen} in {tries} sessions")
    torch.cuda.synchronize()
    t0 = time.time()
    chunk()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / moves
    sim.carry = carry[0]
    groups = {}
    for name, (ms, n) in split.items():
        group = next((g for frag, g in KERNEL_GROUPS if frag in name),
                     "torch kernels")
        g_ms, g_n = groups.get(group, (0.0, 0.0))
        groups[group] = (g_ms + ms, g_n + n)
    device_ms = sum(ms for ms, _ in groups.values()) / moves
    if device_ms == 0.0:
        raise AssertionError("the profiler saw no device time")
    _say(f"CLI profiled chunk ({moves} moves): device {device_ms:.3f} ms "
         f"per move; unprofiled wall {wall_ms:.3f} ms per move (device busy "
         f"{device_ms / wall_ms:.1%}, idle {1 - device_ms / wall_ms:.1%})")
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        _say(f"  {group}: {ms / moves:.4f} ms per move "
             f"({n / moves:.1f} device kernels per move)")


def load_golden(root, model):
    """The reference binary's single-point breakdown of a flagship
    configuration (tests/golden, gated at rel 2e-6 by
    tests/test_golden.py)."""
    with open(os.path.join(root, "tests", "golden", GOLDEN[model])) as f:
        return json.load(f)["expected"]


def _close(got, want, tol):
    """(relative difference, within tol) with a zero reference allowed."""
    diff = abs(got - want)
    return (diff / abs(want) if want else diff), diff <= tol * abs(want)


def run_flagship_chain(model, state, flags, params, opts, root, card,
                       contraction, label=None, chunk=CHUNK, outs_log=None):
    """One flagship's main path under the schedule switch in force:
    ``init_carry(seed=0)`` and two ``chunk``-move chunks of
    ``make_chunk_runner``, every launch count 0 just before (each chunk's
    StepOut appended to ``outs_log`` when given).  Checks the
    initial rd / coulombic / polarization against the model's golden
    (where one exists, rel 2e-6); finite energies; incremental rd /
    coulombic within 1e-8 and polarization within 1e-5 of a fresh
    ``energy_breakdown_blocked`` (at the final box, after NPT volume
    moves); every committed plane within 1e-6 of a fresh ``cache_init``;
    ``contraction`` (the kernel the switch picks) launched >= 4 times per
    move and the other contraction kernels never, the recompute included;
    K2 >= 1 per move that is not a volume move (a volume move rebuilds
    the planes), always with the model's S window rows; in NPT at least
    one volume move proposed.  Returns (launches of the run, second
    chunk's moves/s, the carry)."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown_blocked
    from mpmcxx_tpu_torch.state import topology

    S = opts.max_mol_atoms
    model = label or model
    others = [k for k in ("contract_planes", "contract_planes_sym",
                          "contract_planes_tri") if k != contraction]
    windows = set()       # rows of each commit's strips (K2's S)
    commit = pcache.write_symmetric_rows

    def commit_window(planes, rows, *args):
        windows.add(int(rows[0].shape[0]))
        return commit(planes, rows, *args)

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    pcache.write_symmetric_rows = commit_window
    try:
        t0 = time.time()
        carry = chain.init_carry(state, flags, params, opts, seed=0)
        runner = chain.make_chunk_runner(flags, params, opts, chunk,
                                         topology=topology(state))
        _say(f"[{model}] init_carry: E = {float(carry.obs.energy):.6f} K, "
             f"N = {int(carry.obs.N)} ({time.time() - t0:.2f} s)")
        if model in GOLDEN:
            golden = load_golden(root, model)
            for comp, field in (("rd", "rd_energy"),
                                ("coulombic", "coulombic_energy"),
                                ("polar", "polarization_energy")):
                ours = float(getattr(carry.obs, field))
                rel = abs(ours - golden[comp]) / abs(golden[comp])
                _say(f"[{model}] initial {comp} {ours:.6f} vs reference "
                     f"binary {golden[comp]:.6f}: rel {rel:.2e} (tol 2e-06)")
                if not rel <= 2e-6:
                    raise AssertionError(
                        f"[{model}] initial {comp} off the reference: {rel}")
        moves_per_s = None
        movetypes = []
        for c in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            carry, outs = runner(carry)
            torch.cuda.synchronize()
            dt = time.time() - t0
            moves_per_s = chunk / dt
            movetypes.append(outs.movetype)
            if outs_log is not None:
                outs_log.append(outs)
            _say(f"[{model}] chunk {c}: {chunk} moves in {dt:.3f} s = "
                 f"{moves_per_s:.2f} moves/s; E = "
                 f"{float(carry.obs.energy):.6f} K, N = {int(carry.obs.N)}")
    finally:
        pcache.write_symmetric_rows = commit
    launches = launches_now()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    acc = carry.stats.accept.cpu().numpy()
    rej = carry.stats.reject.cpu().numpy()
    for mt, name in const.MOVETYPE_NAMES.items():
        if acc[mt] + rej[mt]:
            _say(f"  {name}: {acc[mt]} accepted / {acc[mt] + rej[mt]}")
    _say(f"[{model}] second chunk: {moves_per_s:.2f} moves/s on {card}; "
         f"{state.n_atom_slots} slots, S = {S}; peak device memory "
         f"{peak_gb:.2f} GB; launches {launches}")

    # --- is the result right? --------------------------------------------
    n_moves = 2 * chunk
    obs = carry.obs
    for name in ("energy", "rd_energy", "coulombic_energy",
                 "polarization_energy"):
        if not np.isfinite(float(getattr(obs, name))):
            raise AssertionError(f"[{model}] {name} is not finite")
    if not torch.isfinite(carry.state.mu).all():
        raise AssertionError(f"[{model}] dipoles are not finite")
    eb = energy_breakdown_blocked(carry.state, flags, params)
    for name, full, tol in (("rd_energy", eb.rd, 1e-8),
                            ("coulombic_energy", eb.coulombic, 1e-8),
                            ("polarization_energy", eb.polarization, 1e-5)):
        inc, ref = float(getattr(obs, name)), float(full)
        rel, ok = _close(inc, ref, tol)
        _say(f"[{model}] incremental {name} {inc:.9f} vs full {ref:.9f}: "
             f"rel {rel:.2e} (tol {tol:g})")
        if not ok:
            raise AssertionError(
                f"[{model}] {name}: incremental vs full rel {rel}")
    # the in-place commits (K2) left the planes those of a full rebuild
    fresh = pcache.cache_init(carry.state, flags, params)
    names = ("co", "cd", "dx", "dy", "dz")
    planes = pcache.planes_of(carry.pcache)
    for name, got, want in zip(names[5 - len(planes):], planes,
                               pcache.planes_of(fresh)):
        diff = float(torch.max(torch.abs(got - want)))
        _say(f"[{model}] committed plane {name} vs rebuild: max |diff| "
             f"{diff:.3e}")
        if not diff <= 1e-6:
            raise AssertionError(f"[{model}] plane {name} drifted from a "
                                 "rebuild")
    del fresh, planes
    if launches[contraction] < 4 * n_moves:
        raise AssertionError(f"[{model}] {contraction} launched "
                             f"{launches[contraction]} times for {n_moves} "
                             "moves")
    ran = [k for k in others if launches_now()[k]]
    if ran:
        raise AssertionError(f"[{model}] {ran} ran on this schedule")
    n_volume = int((torch.cat(movetypes) == const.MOVETYPE_VOLUME).sum())
    if opts.ensemble == const.ENSEMBLE_NPT:
        vol = const.MOVETYPE_VOLUME
        _say(f"[{model}] volume moves: {acc[vol] + rej[vol]} proposed, "
             f"{acc[vol]} accepted")
        if n_volume == 0:
            raise AssertionError(f"[{model}] no volume move was proposed")
    if launches["write_plane_strips"] < n_moves - n_volume or \
            windows != {S}:
        raise AssertionError(
            f"[{model}] K2 launched {launches['write_plane_strips']} times "
            f"for {n_moves - n_volume} local moves with windows "
            f"{sorted(windows)}, want S={S}")
    _say(f"[{model}] {contraction} {launches[contraction] / n_moves:.2f} "
         f"launches per move, {' and '.join(others)} none; K2 windows "
         f"S = {S}")
    return launches, moves_per_s, carry


def run_example(name, root, workdir, device="cuda"):
    """Phase (a): one example through the port's CLI on the card, at its
    EXAMPLE_STEPS with corrtime half of them.  Checks: exit code 0 and a
    finite energy log; the incremental energies against each refresh
    (rd, coulombic 1e-8; polarization 1e-5 where a polar cache carries
    it); the dense path (blocked_energy False); K1 >= 4 launches per move
    on the polarizable examples and no other contraction kernel, K3 >= 1
    per move on the cavity-biased one, no SCF kernel on the LJ-only
    ones; at least one volume move proposed in NPT.  Returns (launch
    counts, the Simulation, steps/s)."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    d = os.path.join(workdir, name)
    shutil.copytree(os.path.join(root, "examples", name), d)
    n = EXAMPLE_STEPS[name]
    path = os.path.join(d, "run.in")
    with open(path) as f:
        text = f.read()
    text = re.sub(r"(?m)^numsteps .*$", f"numsteps {n}", text)
    text = re.sub(r"(?m)^corrtime .*$", f"corrtime {n // 2}", text)
    with open(path, "w") as f:
        f.write(text)
    sim, log, launches, wall, _ = _run_cli(
        d, ["--quiet", "--device", str(device), "run.in"])
    rows = np.loadtxt(os.path.join(d, sim.cfg.energy_output), ndmin=2)
    if rows.shape[0] != 3 or not np.all(np.isfinite(rows)):
        raise AssertionError(f"{name}: energy log {rows.shape}, or not "
                             "finite")
    if sim.opts.blocked_energy:
        raise AssertionError(f"{name} took the blocked path")
    cache = sim.carry.pcache is not None
    _check_refreshes(name, log, (("rd_energy", 1e-8),
                                 ("coulombic_energy", 1e-8)) +
                     ((("polarization_energy", 1e-5),) if cache else ()), 2)
    mt = torch.cat([o.movetype for _, _, o in log["chunks"]])
    steps_s = n / sum(dt for _, dt, _ in log["chunks"])
    acc = sim.carry.stats.accept.cpu().numpy()
    rej = sim.carry.stats.reject.cpu().numpy()
    counts = ", ".join(f"{const.MOVETYPE_NAMES[m]} {acc[m]}/{acc[m] + rej[m]}"
                       for m in range(7) if acc[m] + rej[m])
    _say(f"example {name}: {sim.state.n_atom_slots} atom slots, {n} steps "
         f"in {wall:.2f} s wall with set-up, chunks {steps_s:.1f} steps/s; "
         f"accepted {counts}; launches {launches}")
    scf = ("contract_planes", "contract_planes_sym", "contract_planes_tri",
           "write_plane_strips")
    if name in POLAR_EXAMPLES:
        if not cache or launches["contract_planes"] < 4 * n or \
                launches["contract_planes_sym"] or \
                launches["contract_planes_tri"]:
            raise AssertionError(f"{name}: K1 launched "
                                 f"{launches['contract_planes']} times for "
                                 f"{n} moves, or another contraction ran")
    elif any(launches[k] for k in scf):
        raise AssertionError(f"{name}: an SCF kernel ran without "
                             "polarization")
    if sim.opts.cavity_bias and launches["occupancy"] < n:
        raise AssertionError(f"{name}: K3 launched {launches['occupancy']} "
                             f"times for {n} moves")
    if sim.cfg.ensemble == const.ENSEMBLE_NPT:
        n_vol = int((mt == const.MOVETYPE_VOLUME).sum())
        _say(f"example {name}: {n_vol} volume moves proposed, "
             f"{acc[const.MOVETYPE_VOLUME]} accepted")
        if n_vol == 0:
            raise AssertionError(f"{name}: no volume move was proposed")
    return launches, sim, steps_s


def check_k1_small(sims, device):
    """Phase (e): K1 against its plain version at the polarizable
    examples' own plane sizes, on their committed planes (square, and
    their first quarter of rows: the framework's and the first sorbates',
    where the dead slots at the end would give only zeros), and on seeded
    planes with no symmetry at the ragged A = SMALL_A (modes 3, 4 and 5;
    square and the middle quarter of rows): relative error <= K1_REL_TOL,
    two launches bitwise equal.  Returns the worst absolute error."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar

    def middle(planes):
        n = planes[0].shape[1]
        return tuple(p[3 * n // 8:3 * n // 8 + max(n // 4, 1)]
                     for p in planes)

    cases = []
    for name, sim in sims.items():
        pc, st = sim.carry.pcache, sim.carry.state
        planes = (pc.dx, pc.dy, pc.dz)
        l = sim.params.polar_damp
        rows = tuple(p[:max(p.shape[0] // 4, 1)] for p in planes)
        cases += [(name, 3, planes, st, l),
                  (f"{name} first quarter of rows", 3, rows, st, l)]
    l = next(iter(sims.values())).params.polar_damp
    for mode in (3, 4, 5):
        planes = _nonsym_planes(SMALL_A, mode, 60 + mode, device)
        cases += [(f"non-symmetric A={SMALL_A}", mode, planes, None, l),
                  (f"non-symmetric A={SMALL_A} rows", mode, middle(planes),
                   None, l)]
    worst = 0.0
    for label, mode, planes, st, l in cases:
        R, A = planes[0].shape
        mu = _mu(A, device, st)
        got = cuda_polar.contract_planes(planes, mu, l)
        again = cuda_polar.contract_planes(planes, mu, l)
        want = cuda_polar.contract_planes_plain(planes, mu, l)
        torch.cuda.synchronize()
        if got.shape != (R, 3) or not torch.equal(got, again):
            raise AssertionError(f"K1 {label} mode {mode}: shape "
                                 f"{tuple(got.shape)}, or two launches on "
                                 "one input differ")
        rel = _rel(got, want)
        err = float(torch.max(torch.abs(got - want)))
        ms = _time_ms(lambda: cuda_polar.contract_planes(planes, mu, l))
        _say(f"K1 contract_planes {label} {R}x{A} mode {mode}: max_abs_err "
             f"{err:.3e} rel_err {rel:.3e}, repeat bitwise equal; "
             f"{ms:.4f} ms")
        if not rel <= K1_REL_TOL:
            raise AssertionError(f"K1 {label} mode {mode}: rel err "
                                 f"{rel:.3e} > {K1_REL_TOL}")
        worst = max(worst, err)
    return worst


def run_cli_nopolar(workdir, golden, device="cuda"):
    """Phase (b): the CO2 flagship's PQR through the CLI with the polar
    and cavity lines of RUN_IN removed: 19,712 slots on the blocked path,
    the incremental LJ/Ewald branch, 2 corrtimes of CHUNK.  Checks: the
    energy log's initial rd and coulombic within 2e-6 of the golden; the
    incremental rd and coulombic within 1e-8 of each refresh; K1, K2, K4
    and K5 never launched.  Returns (launch counts, second corrtime's
    moves/s)."""
    with open(os.path.join(workdir, "run.in"), "w") as f:
        f.write(RUN_IN_NOPOLAR)
    sim, log, launches, wall, _ = _run_cli(
        workdir, ["--quiet", "--device", str(device), "run.in"])
    st = sim.carry.state
    if st.n_atom_slots != CLI_SLOTS or not sim.opts.blocked_energy or \
            sim.opts.polar_incremental or not sim.opts.incremental:
        raise AssertionError(f"CO2 without polarization: {st.n_atom_slots} "
                             f"slots, options {sim.opts}")
    rows = np.loadtxt(os.path.join(workdir, "flagship_lj.energy.dat"),
                      ndmin=2)
    if rows.shape[0] != 3 or not np.all(np.isfinite(rows)):
        raise AssertionError("CO2 without polarization: energy log")
    for comp, col in (("rd", 3), ("coulombic", 2)):
        rel = abs(rows[0][col] - golden[comp]) / abs(golden[comp])
        _say(f"CO2 without polarization: initial {comp} {rows[0][col]:.6f} "
             f"vs reference binary {golden[comp]:.6f}: rel {rel:.2e} "
             "(tol 2e-06)")
        if not rel <= 2e-6:
            raise AssertionError(f"initial {comp} off the golden: {rel}")
    _check_refreshes("CO2 without polarization", log,
                     (("rd_energy", 1e-8), ("coulombic_energy", 1e-8)), 2)
    ran = [k for k in ("contract_planes", "contract_planes_sym",
                       "contract_planes_tri", "write_plane_strips")
           if launches[k]]
    if ran:
        raise AssertionError(f"CO2 without polarization: {ran} launched")
    steps, dt, _ = log["chunks"][-1]
    acc = int(sim.carry.stats.accept.sum())
    _say(f"CO2 without polarization (CLI, {st.n_atom_slots} slots): "
         f"{wall:.1f} s wall with set-up; second corrtime {steps} moves in "
         f"{dt:.3f} s = {steps / dt:.2f} moves/s; {acc} of {2 * CHUNK} "
         f"accepted, N = {int(sim.carry.obs.N)}; launches {launches}")
    return launches, steps / dt


def time_volume_move(carry, flags, params, opts):
    """Wall ms of one NPT volume move (its full recompute and cache
    rebuild included) on ``carry``, synchronised around the step."""
    import torch
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.state import topology
    step = chain.make_step_fn(flags, params, opts,
                              topology=topology(carry.state))
    _, draws, _ = chain.chunk_draws(carry.key, 1)
    d = draws[0].to(carry.state.pos.device)
    torch.cuda.synchronize()
    t0 = time.time()
    carry, out = step(carry, d, None, True)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    _say(f"[ar-npt] one volume move: {ms:.1f} ms wall (accepted "
         f"{bool(out.accepted)})")
    return ms


def run_f64_scf(state, flags, params, opts):
    """Phase (d): the monatomic flagship with polar_mixed off, F64_MOVES
    uVT moves on the full-recompute branch (every proposal a blocked
    recompute whose SCF contracts in float64 row tiles, contract_blocked).
    Checks: finite energies and dipoles; the chain's energies against a
    fresh ``energy_breakdown_blocked`` (1e-8); no kernel of the f32 planes
    launched.  Returns (launch counts, ms per move)."""
    import torch
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown_blocked
    from mpmcxx_tpu_torch.state import topology
    zero_launches()
    t0 = time.time()
    carry = chain.init_carry(state, flags, params, opts, seed=0)
    runner = chain.make_chunk_runner(flags, params, opts, F64_MOVES,
                                     topology=topology(state))
    torch.cuda.synchronize()
    t_init = time.time() - t0
    t0 = time.time()
    carry, outs = runner(carry)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / F64_MOVES
    launches = launches_now()
    eb = energy_breakdown_blocked(carry.state, flags, params)
    for name, full in (("rd_energy", eb.rd), ("coulombic_energy",
                                              eb.coulombic),
                       ("polarization_energy", eb.polarization)):
        got, ref = float(getattr(carry.obs, name)), float(full)
        rel, ok = _close(got, ref, 1e-8)
        _say(f"[ar-f64] {name} {got:.9f} vs full {ref:.9f}: rel {rel:.2e} "
             "(tol 1e-08)")
        if not (ok and np.isfinite(got)):
            raise AssertionError(f"[ar-f64] {name}: chain vs full rel {rel}")
    if not torch.isfinite(carry.state.mu).all():
        raise AssertionError("[ar-f64] dipoles are not finite")
    ran = [k for k in ("contract_planes", "contract_planes_sym",
                       "contract_planes_tri", "write_plane_strips")
           if launches[k]]
    if ran:
        raise AssertionError(f"[ar-f64] {ran} launched without f32 planes")
    _say(f"[ar-f64] init_carry {t_init:.2f} s; {F64_MOVES} moves, "
         f"{int(outs.accepted.sum())} accepted: {ms:.1f} ms per move")
    return launches, ms


def count_syncs(fn):
    """(fn(), the synchronizing CUDA calls it made), counted by
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def count_launches(fn, tries=8):
    """(fn(), its kernel launches, its device ms, what was counted) under
    torch.profiler with CUDA activity only (recording every op on the
    host too costs about a second per Gibbs step): the runtime's launch
    calls, or where the session recorded none of them or replayed a CUDA
    graph (whose kernels no launch call shows, while its capture's calls
    ran nothing) the device kernels it recorded, and the summed duration
    of the device events (one stream: they do not overlap).  A session
    that records no device event (see device_split) is run again, up to
    ``tries`` sessions; ``fn`` must give the same result each time it is
    called."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        events = prof.events()
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
        if device_ms > 0.0:
            break
    calls = sum("LaunchKernel" in e.name for e in events)
    replayed = any("GraphLaunch" in e.name for e in events)
    if calls and not replayed:
        return out, calls, device_ms, "launch calls"
    kernels = sum(not re.search("memcpy|memset", e.name, re.I)
                  for e in device)
    return out, kernels, device_ms, "device kernels recorded" + (
        ", CUDA graph replayed" if replayed else "")


def _energy_logs(sim, workdir):
    """The energy log rows of a Gibbs (one per box) or PI run."""
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.io.pqr import make_filename
    cfg = sim.cfg
    names = [make_filename(cfg.energy_output, i) for i in range(2)] \
        if cfg.ensemble == const.ENSEMBLE_NVT_GIBBS else [cfg.energy_output]
    return {n: np.loadtxt(os.path.join(workdir, n), ndmin=2) for n in names}


def _carried_energies(sim):
    c = sim.carry
    if hasattr(c, "energy_a"):
        return [float(c.energy_a), float(c.energy_b)]
    return [float(c.potential_current)] + c.obs_components.tolist()


def run_dispatched_example(name, root, workdir):
    """Phase (g): gibbs-argon, or pi-argon-dimer with ``-P 8 -xyz
    frames.xyz``, through the port's CLI on the card and then on the CPU
    (``--device cpu``, the same seed), at DISPATCHED_STEPS with corrtime
    half of them.  Checks: exit code 0 and finite energy logs (one per
    box for Gibbs); for PI the 8 per-bead restart files and frames of 16
    sites; the card's accept/reject counts per move type equal to the
    CPU's, its energy logs and final carried energies within 1e-9
    relative of the CPU's (the logs to their printed 6 decimals); no
    K1-K5 launch.  Returns (launch counts, steps/s on the card)."""
    import torch
    from mpmcxx_tpu_torch import cli
    from mpmcxx_tpu_torch.io.pqr import make_filename
    n = DISPATCHED_STEPS[name]
    pi = name.startswith("pi-")
    runs = {}
    for dev in ("cuda", "cpu"):
        d = os.path.join(workdir, f"{name}-{dev}")
        shutil.copytree(os.path.join(root, "examples", name), d)
        path = os.path.join(d, "run.in")
        with open(path) as f:
            text = f.read()
        text = re.sub(r"(?m)^numsteps .*$", f"numsteps {n}", text)
        text = re.sub(r"(?m)^corrtime .*$", f"corrtime {n // 2}", text)
        with open(path, "w") as f:
            f.write(text)
        args = ["--quiet", "--device", dev] + (
            ["-P", str(EXAMPLE_BEADS), "-xyz", "frames.xyz"] if pi else []) \
            + ["run.in"]
        cwd = os.getcwd()
        zero_launches()
        t0 = time.time()
        try:
            os.chdir(d)
            rc, sim = cli.run(args)
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        if rc != 0:
            raise AssertionError(f"{name} on {dev} exited with {rc}")
        runs[dev] = (sim, d, launches_now(), time.time() - t0)
    (sim, d, launches, wall), (sim_c, d_c, _, wall_c) = runs["cuda"], \
        runs["cpu"]
    logs, logs_c = _energy_logs(sim, d), _energy_logs(sim_c, d_c)
    for fn, rows in logs.items():
        if rows.shape[0] != 3 or not np.all(np.isfinite(rows)):
            raise AssertionError(f"{name}: energy log {fn} {rows.shape}")
        if not np.allclose(rows, logs_c[fn], rtol=1e-9, atol=1e-6):
            raise AssertionError(f"{name}: {fn} differs from the CPU run's")
    got, want = _carried_energies(sim), _carried_energies(sim_c)
    rel = max(_close(g, w, 1e-9)[0] for g, w in zip(got, want))
    if not rel <= 1e-9:
        raise AssertionError(f"{name}: carried energies card {got} vs CPU "
                             f"{want}: rel {rel}")
    acc, rej = sim.carry.accept.cpu(), sim.carry.reject.cpu()
    if not (torch.equal(acc, sim_c.carry.accept) and
            torch.equal(rej, sim_c.carry.reject)):
        raise AssertionError(f"{name}: accept/reject counts card "
                             f"{acc.tolist()}/{rej.tolist()} vs CPU "
                             f"{sim_c.carry.accept.tolist()}/"
                             f"{sim_c.carry.reject.tolist()}")
    if pi:
        for s in range(EXAMPLE_BEADS):
            fn = os.path.join(d, make_filename(sim.cfg.pqr_restart, s))
            if not os.path.getsize(fn):
                raise AssertionError(f"{name}: no restart file {fn}")
        with open(os.path.join(d, "frames.xyz")) as f:
            frames = f.read().splitlines()
        if frames[0] != "16" or len(frames) != 2 * 18:
            raise AssertionError(f"{name}: frames file {frames[:2]}, "
                                 f"{len(frames)} lines")
    if any(launches.values()):
        raise AssertionError(f"{name}: an SCF or cavity kernel ran: "
                             f"{launches}")
    counts = ", ".join(f"{const_name(m)} {int(acc[m])}/{int(acc[m] + rej[m])}"
                       for m in range(7) if acc[m] + rej[m])
    _say(f"example {name}: {n} steps on the card in {wall:.2f} s wall with "
         f"set-up ({n / wall:.1f} steps/s), on the CPU {wall_c:.2f} s; "
         f"accepted {counts}, equal on both; carried energies card vs CPU "
         f"rel {rel:.2e}; launches {launches}")
    return launches, n / wall


def const_name(movetype):
    from mpmcxx_tpu_torch import constants as const
    return const.MOVETYPE_NAMES[movetype]


def run_gibbs_vle(workdir, device="cuda"):
    """Phase (h): Gibbs VLE of LJ argon at tools/gibbs_vle.py's
    configuration and 2 x 256 production shape (T* = 0.90, lever start
    N = (497, 15), equal boxes of L = 32.30 A, rd_lrc, transfers 0.25,
    volume exchanges 0.02 by 0.10, move_factor 0.05; 994 and 512 slots,
    the dense path), 2 corrtimes of VLE_STEPS through GibbsSimulation.
    Checks: at each refresh each box's incremental energy within 1e-9 of
    the full recompute; N_a + N_b and V_a + V_b (1e-12) conserved; a
    transfer and a volume exchange proposed; no K1-K5 launch.  Returns
    (launch counts, second corrtime's steps/s, syncs per step, launches
    per step, the device's idle share)."""
    import torch
    from mpmcxx_tpu_torch.mc.gibbs import make_gibbs_chunk_runner

    sim = vle_simulation(workdir, device)
    zero_launches()
    carry = sim._init_carry()
    n0 = float(carry.obs_a.N + carry.obs_b.N)
    v0 = float(carry.state_a.pbc.volume + carry.state_b.pbc.volume)
    moves_seen = []
    for c in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        (carry, outs), syncs = count_syncs(lambda: sim._run_chunk(carry))
        torch.cuda.synchronize()
        dt = time.time() - t0
        moves_seen.append(outs.movetype.cpu())
        carry = _vle_refresh(sim, carry, f"corrtime {c + 1}")
    launches = launches_now()
    _vle_gates(carry, n0, v0, torch.cat(moves_seen), launches)
    n = VLE_PROBE
    t0 = time.time()
    (carry, _), n_launch, dev_ms, counted = count_launches(
        lambda: make_gibbs_chunk_runner(sim.flags, sim.params, sim.opts, n,
                                        sim.topologies)(carry))
    probe_s = time.time() - t0
    wall_ms = dt * 1e3 / VLE_STEPS
    idle = 1 - dev_ms / n / wall_ms
    _say(f"[gibbs-vle] second corrtime: {VLE_STEPS} steps in {dt:.3f} s = "
         f"{VLE_STEPS / dt:.2f} steps/s; {syncs} synchronizing calls "
         f"({syncs / VLE_STEPS:.3f} per step); {n_launch / n:.1f} kernel "
         f"launches ({counted}) and {dev_ms / n:.3f} ms of device time per "
         f"step ({n} more steps, profiled in {probe_s:.1f} s) against "
         f"{wall_ms:.3f} ms of wall: device idle {idle:.1%}")
    return launches, VLE_STEPS / dt, syncs / VLE_STEPS, n_launch / n, idle


def vle_simulation(workdir, device="cuda", extra="", corrtimes=2,
                   label="gibbs-vle"):
    """Step 13's GibbsSimulation in ``workdir``/``label`` (input lines
    ``extra`` added, ``corrtimes`` corrtimes of VLE_STEPS), its shape
    checked: N = (497, 15) on 994 and 512 slots, the dense incremental
    path.  The boxes, temperature and lever-rule split are the VLE
    study's (mpmcxx_tpu_torch/validate/systems.py)."""
    from mpmcxx_tpu_torch.config.parser import read_config
    from mpmcxx_tpu_torch.mc.gibbs import GibbsSimulation
    from mpmcxx_tpu_torch.validate import systems as vle

    # the lever rule at the literature densities (gibbs_vle.main)
    n_a, n_b, L = vle.vle_split(VLE_N_BOX)
    d = os.path.join(workdir, label)
    os.makedirs(d)
    vle.write_box(os.path.join(d, "boxA.pqr"), n_a, L, 4)
    vle.write_box(os.path.join(d, "boxB.pqr"), n_b, L, 5)
    with open(os.path.join(d, "run.in"), "w") as f:
        f.write(f"""job_name vle
ensemble nvt_gibbs
rd_lrc on
temperature {vle.T_K}
transfer_probability 0.25
volume_probability 0.02
volume_change_factor 0.10
numsteps {corrtimes * VLE_STEPS}
corrtime {VLE_STEPS}
seed 4
move_factor 0.05
pqr_input {os.path.join(d, "boxA.pqr")}
pqr_input_B {os.path.join(d, "boxB.pqr")}
energy_output off
pqr_restart off
pqr_output off
traj_output off
basis1 {L:.6f} 0 0
basis2 0 {L:.6f} 0
basis3 0 0 {L:.6f}
{extra}""")
    sim = GibbsSimulation(read_config(os.path.join(d, "run.in")), quiet=True,
                          device=device)
    slots = (sim.state_a.n_atom_slots, sim.state_b.n_atom_slots)
    _say(f"[{label}] N = ({n_a}, {n_b}), L = {L:.2f} A, {slots} atom "
         f"slots, T = {vle.T_K:.2f} K")
    if (n_a, n_b) != (497, 15) or slots != (994, 512) or \
            sim.opts.blocked_energy or not sim.opts.incremental:
        raise AssertionError(f"[{label}] shape {n_a, n_b} {slots}, "
                             f"options {sim.opts}")
    return sim


def _vle_refresh(sim, carry, what, label="gibbs-vle"):
    """The refresh after a VLE corrtime: each box's incremental energy
    within 1e-9 of its full recompute."""
    inc = (float(carry.energy_a), float(carry.energy_b))
    carry = sim._refresh(carry)
    for box, got, full in (("A", inc[0], float(carry.energy_a)),
                           ("B", inc[1], float(carry.energy_b))):
        rel, ok = _close(got, full, 1e-9)
        _say(f"[{label}] {what} box {box}: incremental {got:.9f} vs full "
             f"{full:.9f}: rel {rel:.2e} (tol 1e-09)")
        if not ok:
            raise AssertionError(f"[{label}] box {box}: rel {rel}")
    return carry


def _vle_gates(carry, n0, v0, mt, launches, label="gibbs-vle"):
    """N_a + N_b and V_a + V_b (1e-12) conserved, a transfer and a volume
    exchange among the move types ``mt``, no K1-K5 launch; returns the
    counts of transfers and volume exchanges."""
    from mpmcxx_tpu_torch import constants as const
    n1 = float(carry.obs_a.N + carry.obs_b.N)
    v1 = float(carry.state_a.pbc.volume + carry.state_b.pbc.volume)
    n_xfer = int((mt == const.MOVETYPE_INSERT).sum())
    n_vol = int((mt == const.MOVETYPE_VOLUME).sum())
    acc = carry.accept.tolist()
    _say(f"[{label}] N = ({float(carry.obs_a.N):g}, "
         f"{float(carry.obs_b.N):g}), V = "
         f"({float(carry.state_a.pbc.volume):.3f}, "
         f"{float(carry.state_b.pbc.volume):.3f}); {n_xfer} transfers "
         f"proposed ({acc[const.MOVETYPE_INSERT]} accepted), {n_vol} volume "
         f"exchanges ({acc[const.MOVETYPE_VOLUME]}), displacements "
         f"accepted {acc[const.MOVETYPE_DISPLACE]}")
    if n1 != n0 or abs(v1 - v0) > 1e-12 * v0:
        raise AssertionError(f"[{label}] N {n0} -> {n1}, V {v0} -> {v1}")
    if n_xfer == 0 or n_vol == 0:
        raise AssertionError(f"[{label}] no transfer or no volume "
                             "exchange proposed")
    if any(launches.values()):
        raise AssertionError(f"[{label}] kernels launched: {launches}")
    return n_xfer, n_vol


def write_h2_fluid(path):
    """PI_H2's para-H2 fluid: single-site H2 on a jittered 8^3 lattice of
    the box, seeded (PQR, e units)."""
    h = PI_H2
    rng = np.random.default_rng(h["seed"])
    g = int(round(h["n"] ** (1 / 3)))
    s = h["L"] / g
    pts = (np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                    -1).reshape(-1, 3) + 0.5) * s - h["L"] / 2
    pts = pts + rng.uniform(-0.25, 0.25, pts.shape)
    with open(path, "w") as f:
        for m, (x, y, z) in enumerate(pts):
            f.write(f"ATOM  {m + 1:5d} H2   H2 M {m + 1:4d}   "
                    f"{x:8.3f}{y:8.3f}{z:8.3f} {h['mass']:.5f}  0.00000 "
                    f"0.00000 {h['eps']:.5f} {h['sig']:.5f} 0.0 0.0\n")
        f.write("END\n")


def write_pi_h2(workdir, extra="", corrtimes=2, label="pi-h2", moves=None):
    """Step 14's input in ``workdir``/``label``: the fluid's PQR and a
    run.in of ``corrtimes`` corrtimes of ``moves`` (PI_H2["moves"] by
    default) with the input lines ``extra``; returns the directory."""
    h = dict(PI_H2, moves=moves or PI_H2["moves"])
    d = os.path.join(workdir, label)
    os.makedirs(d)
    write_h2_fluid(os.path.join(d, "h2.pqr"))
    with open(os.path.join(d, "run.in"), "w") as f:
        f.write(f"""job_name ph2
ensemble pi_nvt
temperature {h['T']}
numsteps {corrtimes * h['moves']}
corrtime {h['moves']}
seed 1
move_factor {h['move_factor']}
bead_perturb_probability {h['perturb']}
pi_trial_chain_length {h['chain']}
pqr_input h2.pqr
basis1 {h['L']} 0 0
basis2 0 {h['L']} 0
basis3 0 0 {h['L']}
{extra}""")
    return d


def pi_h2_simulation(device="cuda", label="pi-h2"):
    """The PISimulation of the run.in in the working directory (see
    write_pi_h2) at PI_H2's beads, its stack and path checked."""
    from mpmcxx_tpu_torch.config.parser import read_config
    from mpmcxx_tpu_torch.mc import pi
    h = PI_H2
    cfg = read_config("run.in")
    cfg.total_trotter_number = h["beads"]      # as -P does
    sim = pi.PISimulation(cfg, quiet=True, device=device)
    if sim.stack.pos.shape[:2] != (h["beads"], h["n"]) or \
            not sim.incremental:
        raise AssertionError(f"[{label}] stack {tuple(sim.stack.pos.shape)}"
                             f", incremental {sim.incremental}")
    return sim


def run_pi_h2(workdir, device="cuda"):
    """Phase (i): PI-NVT of 512 single-site para-H2 (Buch's LJ) at 25 K and
    0.0233 A^-3 (L = 28.01 A, cutoff L/2), P = 16 beads, bead
    perturbations half the moves with trial chains of 4, through
    PISimulation.run: 2 corrtimes of PI_H2["moves"] on the incremental LJ
    path (8,192 atom-bead slots).  Checks: at each corrtime the carried
    bead-averaged potential within 1e-9 of the full per-bead recompute;
    the kinetic estimator finite and below 1.5 N T P; 16 restart files;
    each move kind accepted >= 5 %; no K1-K5 launch.  Returns (launch
    counts, second corrtime's moves/s, syncs per move, launches per move,
    the device's idle share, one corrtime's restart-write seconds)."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.io.pqr import make_filename
    from mpmcxx_tpu_torch.mc import pi

    h = PI_H2
    d = write_pi_h2(workdir)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        sim = pi_h2_simulation(device)
        log = {"chunks": [], "recompute": [], "writes": []}
        run_chunk, recompute, write = sim._run_chunk, sim._recompute, \
            sim._write_beads

        def timed_chunk(carry):
            torch.cuda.synchronize()
            t0 = time.time()
            if log["chunks"]:
                out, syncs = count_syncs(lambda: run_chunk(carry))
            else:
                out, syncs = run_chunk(carry), None
            torch.cuda.synchronize()
            log["chunks"].append((time.time() - t0, syncs))
            return out

        def recorded(carry):
            out = recompute(carry)
            log["recompute"].append((float(carry.potential_current),
                                     float(out.potential_current)))
            return out

        def timed_write(carry, basename):
            t0 = time.time()
            write(carry, basename)
            log["writes"].append(time.time() - t0)

        sim._run_chunk, sim._recompute, sim._write_beads = timed_chunk, \
            recorded, timed_write
        zero_launches()
        t0 = time.time()
        sim.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = launches_now()
        for c, (inc, full) in enumerate(log["recompute"]):
            rel, ok = _close(inc, full, 1e-9)
            _say(f"[pi-h2] corrtime {c + 1}: carried bead-averaged "
                 f"potential {inc:.9f} vs full per-bead recompute "
                 f"{full:.9f}: rel {rel:.2e} (tol 1e-09)")
            if not ok:
                raise AssertionError(f"[pi-h2] corrtime {c + 1}: rel {rel}")
        if len(log["recompute"]) != 2:
            raise AssertionError("[pi-h2] not two recomputes")
        carry = sim.carry
        kin = float(pi.pi_kinetic(carry.stack, carry.temperature))
        bound = 1.5 * h["n"] * h["T"] * h["beads"]
        if not (np.isfinite(kin) and kin < bound):
            raise AssertionError(f"[pi-h2] kinetic {kin} vs 1.5 N T P "
                                 f"{bound}")
        for s in range(h["beads"]):
            if not os.path.getsize(make_filename(sim.cfg.pqr_restart, s)):
                raise AssertionError(f"[pi-h2] no restart file for bead {s}")
        acc, rej = carry.accept.tolist(), carry.reject.tolist()
        rates = {m: acc[m] / max(acc[m] + rej[m], 1)
                 for m in (const.MOVETYPE_DISPLACE,
                           const.MOVETYPE_PERTURB_BEADS)}
        if any(r < 0.05 for r in rates.values()):
            raise AssertionError(f"[pi-h2] acceptance {rates}")
        if any(launches.values()):
            raise AssertionError(f"[pi-h2] kernels launched: {launches}")
        n_probe = PI_PROBE
        t0 = time.time()
        (carry, _), n_launch, dev_ms, counted = count_launches(
            lambda: sim._chunk_runner(n_probe)(carry))
        probe_s = time.time() - t0
    finally:
        os.chdir(cwd)
    dt, syncs = log["chunks"][1]
    m = h["moves"]
    wall_ms = dt * 1e3 / m
    idle = 1 - dev_ms / n_probe / wall_ms
    _say(f"[pi-h2] {h['n']} H2 x {h['beads']} beads, T = {h['T']} K: "
         f"{2 * m} moves, {wall:.1f} s wall with set-up; accepted "
         f"displace {acc[const.MOVETYPE_DISPLACE]}/"
         f"{acc[const.MOVETYPE_DISPLACE] + rej[const.MOVETYPE_DISPLACE]}, "
         f"bead perturbation {acc[const.MOVETYPE_PERTURB_BEADS]}/"
         f"{acc[const.MOVETYPE_PERTURB_BEADS] + rej[const.MOVETYPE_PERTURB_BEADS]}"
         f"; kinetic estimator "
         f"{kin:.3f} K (< 1.5 N T P = {bound:g})")
    _say(f"[pi-h2] second corrtime: {m} moves in {dt:.3f} s = "
         f"{m / dt:.2f} moves/s; {syncs} synchronizing calls "
         f"({syncs / m:.3f} per move); {n_launch / n_probe:.1f} kernel "
         f"launches ({counted}) and {dev_ms / n_probe:.3f} ms of device "
         f"time per move "
         f"({n_probe} more moves, profiled in {probe_s:.1f} s) against "
         f"{wall_ms:.3f} ms of "
         f"wall: device idle {idle:.1%}; one corrtime's {h['beads']} "
         f"restart writes {log['writes'][0]:.3f} s")
    return launches, m / dt, syncs / m, n_launch / n_probe, idle, \
        log["writes"][0]


def to_device(state, device):
    """A copy of ``state`` on ``device``."""
    from mpmcxx_tpu_torch.pbc import PBC
    fields = {f.name: getattr(state, f.name).to(device)
              for f in dataclasses.fields(state) if f.name != "pbc"}
    pbc = PBC(**{f.name: getattr(state.pbc, f.name).to(device)
                 for f in dataclasses.fields(PBC)})
    return dataclasses.replace(state, pbc=pbc, **fields)


def run_h2_fh4(state, flags, params, opts, root, card, fh_off):
    """Step 15: the H2 flagship (the default schedule: K5 and K2) at
    FH_TEMPERATURE with Feynman-Hibbs order 4, through
    ``run_flagship_chain`` (2 chunks of CHUNK moves; the carried rd and
    coulombic within 1e-8 and polarization within 1e-5 of a refresh, the
    planes those of a rebuild, K5 >= 4 and K2 >= 1 per move).  Before
    it, the initial blocked rd on the card against the port's on the CPU
    at the same state (1e-9 relative; both with rd_only: rd reads
    neither the SCF nor the electrostatics).  After it, kernel launches
    per move over FH_PROBE moves with FH on and off.  ``fh_off`` is step
    6's (launches, moves/s) of the H2 flagship without FH.  Returns
    (launches, moves/s)."""
    import torch
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown_blocked
    from mpmcxx_tpu_torch.state import topology
    fh = flags.replace(feynman_hibbs=True, feynman_hibbs_order=4)
    fh_params = params.replace(temperature=FH_TEMPERATURE)
    # rd alone: it reads neither the SCF nor the electrostatics, which
    # would take most of the CPU's time
    no_scf = fh.replace(polarization=False, rd_only=True)
    card_rd = float(energy_breakdown_blocked(state, no_scf, fh_params).rd)
    t0 = time.time()
    cpu_rd = float(energy_breakdown_blocked(to_device(state, "cpu"), no_scf,
                                            fh_params).rd)
    rel, ok = _close(card_rd, cpu_rd, 1e-9)
    _say(f"[h2-fh4] initial blocked rd (FH4, {FH_TEMPERATURE:g} K): card "
         f"{card_rd:.9f} vs CPU {cpu_rd:.9f}: rel {rel:.2e} (tol 1e-09; "
         f"CPU {time.time() - t0:.1f} s)")
    if not ok:
        raise AssertionError(f"[h2-fh4] card vs CPU blocked rd rel {rel}")
    launches, rate, carry = run_flagship_chain(
        "h2", state, fh, fh_params, opts, root, card, "contract_planes_sym",
        label="h2-fh4")
    per_move = {}
    for name, f in (("FH4", fh), ("no FH", flags)):
        runner = chain.make_chunk_runner(f, fh_params, opts, FH_PROBE,
                                         topology=topology(carry.state))
        _, n, _, what = count_launches(lambda: runner(carry))
        per_move[name] = n / FH_PROBE
    n_moves = 2 * CHUNK
    off_launches, off_rate = fh_off
    _say(f"[h2-fh4] {rate:.2f} moves/s (second chunk) on {card}; "
         f"K5 {launches['contract_planes_sym'] / n_moves:.2f} and K2 "
         f"{launches['write_plane_strips'] / n_moves:.2f} launches per move; "
         f"kernel launches per move ({what}, {FH_PROBE} moves): FH4 "
         f"{per_move['FH4']:.1f}, without FH {per_move['no FH']:.1f}; "
         f"step 6's H2 without FH (K4 schedule, {params.temperature:g} K): "
         f"{off_rate:.2f} moves/s, K4 "
         f"{off_launches['contract_planes_tri'] / n_moves:.2f} and K2 "
         f"{off_launches['write_plane_strips'] / n_moves:.2f} per move")
    return launches, rate


def pairwise_state(pqr, device, se):
    """The LJ-only CLI state (cli_flagship_state's 19,712 slots) with
    PW_SITE's omega and C6/C8/C10 on every atom and, where ``se`` is
    given, its per-type (sigma, epsilon)."""
    from mpmcxx_tpu_torch.io.pqr import read_pqr
    from mpmcxx_tpu_torch.state import build_state
    atoms = read_pqr(pqr)
    for a in atoms:
        for k, v in PW_SITE[a.atomtype].items():
            setattr(a, k, v)
        if se is not None:
            a.sigma, a.epsilon = se[a.atomtype]
    n_mov = len({a.molecule_id for a in atoms if not a.frozen})
    return build_state(atoms, np.eye(3) * 80.0,
                       extra_mol_capacity=max(n_mov, 32), device=device)[0]


def run_pairwise_terms(workdir, device="cuda"):
    """Step 16: each setting of PW_SETTINGS on the LJ-only CO2 CLI state
    (19,712 slots, uVT, the incremental path, blocked recomputes).  Per
    setting: Delta-E of a displacement, an insertion and a removal of
    molecule slot 1 against the difference of two blocked recomputes on
    the card (rd and coulombic, within 1e-9 of the component's energy);
    one PW_MOVES chunk whose carried rd and coulombic are within 1e-8 of
    a refresh; finite energies; no K1-K5 launch.  Returns (the summed
    launch counts, moves/s per setting)."""
    import torch
    from mpmcxx_tpu_torch import flagship
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.flags import FFlags, RunParams
    from mpmcxx_tpu_torch.mc import chain, moves
    from mpmcxx_tpu_torch.mc.chain import MCOptions
    from mpmcxx_tpu_torch.ops import delta
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown_blocked
    from mpmcxx_tpu_torch.state import topology
    pqr = os.path.join(workdir, "flagship_co2.pqr")
    flagship.write_pqr_co2(pqr)
    states = {}
    base = FFlags()
    params = RunParams(temperature=150.0, ewald_alpha=3.5 / 40.0,
                       cavity_autoreject_scale=PW_CAVITY_SCALE)
    opts = MCOptions(ensemble=const.ENSEMBLE_UVT, move_factor=0.5,
                     insert_probability=0.2, fugacity=1.0, incremental=True,
                     max_mol_atoms=3, blocked_energy=True)
    total = dict.fromkeys(_wrappers(), 0)
    rates = {}
    t_step = time.time()
    for name, (fkw, se) in PW_SETTINGS.items():
        key = id(se)
        if key not in states:
            states[key] = pairwise_state(pqr, device, se)
        s0 = states[key]
        flags = base.replace(**fkw)
        topo = topology(s0)
        mol = torch.ones((), dtype=torch.int64, device=device)
        rows = moves.molecule_rows(
            *(torch.as_tensor(t, device=device) for t in topo), mol, 3)
        g = torch.Generator().manual_seed(3)
        u = torch.rand(10, generator=g, dtype=torch.float64).to(device)
        s_disp = moves.displace_rows(s0, u[:6], u[6:9] - 0.5, u[9], rows,
                                     rows >= 0, 0.05, 1.0)
        s_dead = moves.remove(s0, mol)
        zero_launches()
        carry = chain.init_carry(s0, flags, params, opts, seed=0)
        # the initial state's blocked recompute is init_carry's
        full = {"s0": dict(rd=carry.obs.rd_energy,
                           coulombic=carry.obs.coulombic_energy)}
        for k, s in (("disp", s_disp), ("dead", s_dead)):
            eb = energy_breakdown_blocked(s, flags, params)
            full[k] = dict(rd=eb.rd, coulombic=eb.coulombic)
        worst = 0.0
        for move, old, new in (("displace", "s0", "disp"),
                               ("insert", "dead", "s0"),
                               ("remove", "s0", "dead")):
            so = {"s0": s0, "disp": s_disp, "dead": s_dead}
            sf = delta.sf_compute(so[old], flags, params) \
                if delta.uses_recip(flags) else delta.empty_sf(device)
            d = delta.delta_energy(so[old], so[new], rows, sf, flags, params)
            for comp, got in (("rd", d.d_rd), ("coulombic", d.d_coul)):
                want = float(full[new][comp]) - float(full[old][comp])
                scale = abs(float(full[old][comp]))
                err = abs(float(got) - want)
                worst = max(worst, err / scale if scale else err)
                if not (np.isfinite(float(got)) and err <= 1e-9 * scale):
                    raise AssertionError(
                        f"[pairwise {name}] {move} d_{comp} {float(got)!r} "
                        f"vs blocked difference {want!r}")
        runner = chain.make_chunk_runner(flags, params, opts, PW_MOVES,
                                         topology=topo)
        refresh = chain.make_refresher(flags, params, opts)
        torch.cuda.synchronize()
        t0 = time.time()
        carry, outs = runner(carry)
        torch.cuda.synchronize()
        rates[name] = PW_MOVES / (time.time() - t0)
        inc = (float(carry.obs.rd_energy), float(carry.obs.coulombic_energy))
        carry = refresh(carry)
        ref = (float(carry.obs.rd_energy), float(carry.obs.coulombic_energy))
        carried = 0.0
        for comp, a, b in zip(("rd", "coulombic"), inc, ref):
            rel, ok = _close(a, b, 1e-8)
            carried = max(carried, rel)
            if not (ok and np.isfinite(a)):
                raise AssertionError(f"[pairwise {name}] carried {comp} "
                                     f"{a!r} vs refresh {b!r}: rel {rel}")
        n = launches_now()
        if any(n.values()):
            raise AssertionError(f"[pairwise {name}] kernels launched: {n}")
        for k in total:
            total[k] += n[k]
        _say(f"[pairwise {name}] Delta-E vs blocked difference: worst "
             f"{worst:.2e} of the component (tol 1e-09); {PW_MOVES} moves "
             f"at {rates[name]:.2f} moves/s, "
             f"{int(outs.accepted.sum())} accepted; carried vs refresh rel "
             f"{carried:.2e} (tol 1e-08)")
    _say(f"step 16 (pairwise terms, {len(PW_SETTINGS)} settings at "
         f"{states[id(None)].n_atom_slots} slots) took "
         f"{time.time() - t_step:.1f} s")
    return total, rates


def manybody_state(device, buck):
    """MB's argon-like fluid: n atoms on a jittered cubic lattice of the
    box (seeded), LJ or, with ``buck``, Buckingham parameters."""
    from mpmcxx_tpu_torch.state import AtomRecord, build_state
    n, L = MB["n"], (MB["n"] / MB["density"]) ** (1.0 / 3.0)
    g = int(round(n ** (1 / 3)))
    rng = np.random.default_rng(MB["seed"])
    pts = (np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                    -1).reshape(-1, 3) + 0.5) * (L / g) - L / 2
    pts = pts + rng.uniform(-0.05, 0.05, pts.shape)
    sig, eps = MB["buck"] if buck else (MB["sig"], MB["eps"])
    atoms = [AtomRecord("Ar", "ARG", m + 1, x=x, y=y, z=z, mass=MB["mass"],
                        polarizability=MB["alpha"], omega=MB["omega"],
                        c6=MB["c6"], epsilon=eps, sigma=sig)
             for m, (x, y, z) in enumerate(pts)]
    return build_state(atoms, np.eye(3) * L, device=device)[0], L


def run_many_body(device="cuda"):
    """Step 17: MB's fluid in NVT with (i) Axilrod-Teller (Midzuno-Kihara
    C9) and (ii) the many-body vdW term with Buckingham repulsion, each
    MB["moves"] moves on the dense full recompute that
    ``runner.capacity_opts`` picks for them.  Gates: the initial energy on
    the card within 1e-9 relative of the port's on the CPU (each
    component); finite energies; accepted moves; no K1-K5 launch.
    Returns (the summed launch counts, ms per move of each setting)."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch import runner as runner_mod
    from mpmcxx_tpu_torch.flags import FFlags, RunParams
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.mc.chain import MCOptions
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown
    from mpmcxx_tpu_torch.state import topology
    total = dict.fromkeys(_wrappers(), 0)
    ms = {}
    for name, fkw, buck in (
            ("axilrod_teller", dict(using_axilrod_teller=True,
                                    midzuno_kihara_approx=True), False),
            ("polarvdw_exp", dict(polarvdw=True, cdvdw_exp_repulsion=True),
             True)):
        state, L = manybody_state(device, buck)
        flags = FFlags(**fkw)
        params = RunParams(temperature=MB["T"], ewald_alpha=3.5 / (L / 2),
                           polar_damp=MB["polar_damp"])
        opts = runner_mod.capacity_opts(
            MCOptions(ensemble=const.ENSEMBLE_NVT,
                      move_factor=MB["move_factor"]), flags, state)
        if opts.incremental or opts.blocked_energy:
            raise AssertionError(f"[{name}] not on the dense path: {opts}")
        t0 = time.time()
        cpu = energy_breakdown(to_device(state, "cpu"), flags, params)
        t_cpu = time.time() - t0
        card = energy_breakdown(state, flags, params)
        worst = 0.0
        for comp in ("total", "rd", "vdw", "three_body"):
            rel, ok = _close(float(getattr(card, comp)),
                             float(getattr(cpu, comp)), 1e-9)
            worst = max(worst, rel)
            if not ok:
                raise AssertionError(f"[{name}] initial {comp} card vs CPU "
                                     f"rel {rel}")
        _say(f"[{name}] {MB['n']} atoms, L = {L:.3f} A: initial E = "
             f"{float(card.total):.6f} K (rd {float(card.rd):.6f}, vdw "
             f"{float(card.vdw):.6f}, 3-body {float(card.three_body):.6f}); "
             f"card vs CPU rel {worst:.2e} (tol 1e-09; CPU {t_cpu:.1f} s)")
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        carry = chain.init_carry(state, flags, params, opts, seed=0)
        runner = chain.make_chunk_runner(flags, params, opts, MB["moves"],
                                         topology=topology(state))
        torch.cuda.synchronize()
        t0 = time.time()
        carry, outs = runner(carry)
        torch.cuda.synchronize()
        ms[name] = (time.time() - t0) * 1e3 / MB["moves"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_acc = int(outs.accepted.sum())
        energies = [float(getattr(carry.obs, f)) for f in (
            "energy", "rd_energy", "vdw_energy", "three_body_energy")]
        if not (np.all(np.isfinite(energies)) and n_acc > 0):
            raise AssertionError(f"[{name}] energies {energies}, {n_acc} "
                                 "accepted")
        n = launches_now()
        if any(n.values()):
            raise AssertionError(f"[{name}] kernels launched: {n}")
        for k in total:
            total[k] += n[k]
        _say(f"[{name}] {MB['moves']} NVT moves, {n_acc} accepted: "
             f"{ms[name]:.1f} ms per move (dense recompute); E = "
             f"{energies[0]:.6f} K; peak device memory {peak:.2f} GB")
    return total, ms


def _k5_due(counts, cap, group, extra=1):
    """K5 launches a move's solve makes: the grouped loop runs whole
    groups of ``group`` iterations up to ``cap`` (polar._grouped_while),
    then ``extra`` more contractions (Palmo's, or CG's initial A(x0))."""
    return sum(min(cap, group * -(-int(c) // group)) + extra for c in counts)


def check_scf_fallback(proposals, outs, flags, params, cap):
    """The moves of a chain whose f32 SCF ended in the divergence
    fallback (MAX_ITERATION_COUNT sweeps without meeting the precision):
    none accepted, and the first of them solved again in float64 on the
    blocked path (polar_mixed off, contract_blocked in 1,024-row tiles)
    falls back too, so the fallback is the Jacobi iteration's own and
    not the f32 planes'.  Where no move fell back, the first move is
    solved in float64 and must converge as its f32 SCF did.
    ``proposals`` holds (proposed state, PolarResult) per move."""
    import torch
    from mpmcxx_tpu_torch.ops import polar as polar_mod
    accepted = torch.cat([o.accepted for o in outs]).cpu().tolist()
    failed = [bool(r.iterator_failed) for _, r in proposals]
    if len(failed) != len(accepted):
        raise AssertionError(f"{len(failed)} proposals for "
                             f"{len(accepted)} moves")
    if any(a and f for a, f in zip(accepted, failed)):
        raise AssertionError("[co2-precision] a move whose SCF fell back "
                             "was accepted")
    i = failed.index(True) if True in failed else 0
    state, res = proposals[i]
    t0 = time.time()
    ref = polar_mod.polar_blocked(state, flags.replace(polar_mixed=False),
                                  params, block=1024)
    _say(f"[co2-precision] move {i}: f32 SCF {float(res.iterations):.0f} "
         f"iterations ({'failed' if failed[i] else 'converged'}), float64 "
         f"blocked SCF {float(ref.iterations):.0f} iterations "
         f"({'failed' if bool(ref.iterator_failed) else 'converged'}) in "
         f"{time.time() - t0:.1f} s")
    if bool(ref.iterator_failed) != failed[i] or \
            (failed[i] and float(ref.iterations) != cap):
        raise AssertionError(f"[co2-precision] move {i}: the float64 SCF "
                             "does not end as the f32 one")


def scf_launch_gate(label, carry, runner, due, tries=4):
    """One chunk of ``runner`` under torch.profiler (CUDA activity) with
    every launch count 0 just before: K5's wrapper count equal to
    ``due(outs)``, the count the step's own iterations imply, and the
    profiler's ``contract_sym_kernel`` events equal to it too.  The
    profiler on this card now and then drops records of a session: a
    session in which it saw fewer K5 kernels than the wrapper launched is
    followed by one more chunk, up to ``tries``; more than the wrapper
    launched fails at once.  Returns (carry, outs)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        zero_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            carry, outs = runner(carry)
            torch.cuda.synchronize()
        want = due(outs)
        got = launches_now()["contract_planes_sym"]
        if got != want:
            raise AssertionError(f"[{label}] K5 launched {got} times, the "
                                 f"step's counts imply {want}")
        seen = sum(e.device_type == DeviceType.CUDA and
                   "contract_sym_kernel" in e.name for e in prof.events())
        _say(f"[{label}] K5: {got} launches (wrapper), {seen} "
             f"contract_sym_kernel events (profiler), {want} implied by the "
             f"step's counts, over {len(outs.accepted)} moves")
        if seen > want:
            raise AssertionError(f"[{label}] the profiler saw {seen} K5 "
                                 f"kernels, the step's counts imply {want}")
        if seen == want:
            return carry, outs
    raise AssertionError(f"[{label}] the profiler recorded every K5 kernel "
                         f"in none of {tries} sessions")


@contextlib.contextmanager
def eager_moves():
    """Every chunk runner runs its moves eager while the block runs (no
    CUDA graph replay: a hook on a function of the step sees only the
    moves whose Python runs)."""
    from mpmcxx_tpu_torch.mc import chain
    rule = chain.graphs_apply
    chain.graphs_apply = lambda *a, **k: False
    try:
        yield
    finally:
        chain.graphs_apply = rule


@contextlib.contextmanager
def record_cg_steps(steps):
    """Append each ``polar.cg_solve``'s step count (a 0-d device tensor)
    to ``steps`` while the block runs."""
    from mpmcxx_tpu_torch.ops import polar as polar_mod
    solve = polar_mod.cg_solve

    def recording(*args, **kw):
        x, k = solve(*args, **kw)
        steps.append(k)
        return x, k

    polar_mod.cg_solve = recording
    try:
        yield
    finally:
        polar_mod.cg_solve = solve


def run_scf_solvers(state, flags, params, opts, root, card):
    """Step 18: the CO2 flagship on its polar cache (the default
    schedule: K5 and K2).  (i) A precision-terminated SCF
    (SCF_PRECISION) with Palmo's correction through
    ``run_flagship_chain`` (2 x SCF_CHUNK moves), whose moves that end
    in the divergence fallback are checked by check_scf_fallback; then,
    at each group size of
    GROUP_SIZES, GROUP_PROBE moves timed, GROUP_PROBE moves under
    count_syncs and a launch gate (scf_launch_gate: K5 launches per move
    = the iterations rounded up to whole groups, + 1 for Palmo).  (ii)
    The exact solve (polar_iterative off: CG over the planes) through
    ``run_flagship_chain`` (2 x CG_MOVES / 2 moves) and a launch gate of
    CG_MOVES / 2 moves (K5 = the CG steps rounded up to whole groups, +
    1 for the initial A(x0)).  Returns (launches by path, a dict of the
    numbers to print)."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops import polar as polar_mod
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    from mpmcxx_tpu_torch.state import topology
    out, launches = {}, {}
    cap = int(const.MAX_ITERATION_COUNT)
    f_i = flags.replace(polar_palmo=True)
    p_i = params.replace(polar_precision=SCF_PRECISION)
    outs, proposals = [], []
    propose = pcache.polar_proposal

    def recording(cache, old, new, rows, *args, **kw):
        res = propose(cache, old, new, rows, *args, **kw)
        proposals.append((new, (res[0] if kw.get("with_commit") else res)))
        return res

    pcache.polar_proposal = recording
    try:
        launches["co2-precision"], out["precision_rate"], carry = \
            run_flagship_chain("co2", state, f_i, p_i, opts, root, card,
                               "contract_planes_sym", label="co2-precision",
                               chunk=SCF_CHUNK, outs_log=outs)
    finally:
        pcache.polar_proposal = propose
    check_scf_fallback(proposals, outs, f_i, p_i, cap)
    its = torch.cat([o.polarization_iterations for o in outs]).cpu()
    out["iterations"] = (float(its.mean()), float(its.max()),
                         int((its >= cap).sum()), len(its))
    _say(f"[co2-precision] SCF iterations per move: mean "
         f"{out['iterations'][0]:.2f}, max {out['iterations'][1]:.0f}; "
         f"{out['iterations'][2]} of {len(its)} moves in the divergence "
         f"fallback (precision {SCF_PRECISION:g} D, Palmo on)")
    group = polar_mod.LOOP_GROUP
    out["groups"] = {g: ([], None) for g in GROUP_SIZES}
    runner = chain.make_chunk_runner(f_i, p_i, opts, GROUP_PROBE,
                                     topology=topology(state))
    try:
        # the same GROUP_PROBE moves from one carry at each group size, in
        # turns (1, 8, 8, 1): the result is bitwise the same at any size
        for g in GROUP_SIZES + GROUP_SIZES[::-1]:
            polar_mod.LOOP_GROUP = g
            c = copy.deepcopy(carry)
            torch.cuda.synchronize()
            t0 = time.time()
            runner(c)
            torch.cuda.synchronize()
            out["groups"][g][0].append(GROUP_PROBE / (time.time() - t0))
            del c
        for g in GROUP_SIZES:
            polar_mod.LOOP_GROUP = g
            c = copy.deepcopy(carry)
            (c, probe), syncs = count_syncs(lambda: runner(c))
            c, probe2 = scf_launch_gate(
                f"co2-precision LOOP_GROUP={g}", c, runner,
                lambda o, g=g: _k5_due(o.polarization_iterations.tolist(),
                                       cap, g))
            for o in (probe, probe2):
                if bool(torch.any(o.accepted &
                                  (o.polarization_iterations >= cap))):
                    raise AssertionError("[co2-precision] a move whose SCF "
                                         "fell back was accepted")
            rates = out["groups"][g][0]
            out["groups"][g] = (rates, syncs / GROUP_PROBE)
            _say(f"[co2-precision] LOOP_GROUP={g}: " + ", ".join(
                f"{r:.2f}" for r in rates) + f" moves/s (the same "
                f"{GROUP_PROBE} moves), {syncs / GROUP_PROBE:.2f} syncs per "
                f"move on {card}")
            del c
    finally:
        polar_mod.LOOP_GROUP = group
    del carry
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    f_ii = flags.replace(polar_iterative=False)
    launches["co2-cg"], out["cg_rate"], carry = run_flagship_chain(
        "co2", state, f_ii, params, opts, root, card, "contract_planes_sym",
        label="co2-cg", chunk=CG_MOVES // 2)
    steps = []
    runner = chain.make_chunk_runner(f_ii, params, opts, CG_MOVES // 2,
                                     topology=topology(state))
    with record_cg_steps(steps):
        carry, _ = scf_launch_gate(
            "co2-cg", carry, runner,
            lambda o: _k5_due([int(k) for k in steps[-len(o.accepted):]],
                              polar_mod.CG_MAXITER, polar_mod.LOOP_GROUP))
    k = np.array([int(x) for x in steps])
    out["cg_steps"] = (float(k.mean()), int(k.max()))
    _say(f"[co2-cg] CG steps per solve: mean {k.mean():.1f}, max "
         f"{k.max()} of {polar_mod.CG_MAXITER} (tol {polar_mod.CG_TOL:g} "
         "relative)")
    del carry
    return launches, out


def check_k2_signs(planes, device):
    """K2 against its plain version, bitwise, on copies of the P = 4 or 5
    flagship planes of one plane mode with their mixed signs
    (polar_cache.plane_signs: co and cd +1, the displacement planes -1),
    at window starts 0, mid-plane and A - 3, all-valid and partly valid;
    after the commit each valid row's column is the row times the plane's
    sign away from the S x S window (inside it the columns win)."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar
    from mpmcxx_tpu_torch.ops.polar_cache import commit_strips, plane_signs
    P, A, S = len(planes), planes[0].shape[0], 3
    signs = plane_signs(P)
    rng = np.random.default_rng(P)
    for valid in ((True, True, True), (True, False, True)):
        for start in (0, A // 2 + 1, A - S):
            rows = tuple(torch.from_numpy(rng.normal(size=(S, A)).astype(
                np.float32)).to(device) for _ in range(P))
            st = torch.full((), start, dtype=torch.int64, device=device)
            vt = torch.tensor(valid, device=device)
            blend, cols = commit_strips(planes, rows, st, vt, signs)
            k = tuple(p.clone() for p in planes)
            cuda_polar.write_plane_strips(k, blend, cols, st)
            p_ = tuple(p.clone() for p in planes)
            cuda_polar.write_plane_strips_plain(p_, blend, cols, st)
            torch.cuda.synchronize()
            away = torch.ones(A, dtype=torch.bool, device=device)
            away[start:start + S] = False
            for i, (a, b, sg) in enumerate(zip(k, p_, signs)):
                if not torch.equal(a, b):
                    raise AssertionError(f"K2 P={P} plane {i} start {start} "
                                         f"valid {valid}: kernel differs "
                                         "from plain")
                for r in (start + j for j, v in enumerate(valid) if v):
                    if not torch.equal(a[r][away], sg * a[:, r][away]):
                        raise AssertionError(
                            f"K2 P={P} plane {i}: column {r} is not "
                            f"{sg:+g} x row {r} away from the window")
            del k, p_
    _say(f"K2 write_plane_strips P={P} planes A={A} S={S} signs {signs}: "
         "bitwise equal to plain at 6 windows")


def run_cache_modes(state, flags, params, opts, root, card):
    """Step 19: the CO2 flagship's chain on its polar cache under each of
    CACHE_SETTINGS (linear damping: plane mode 4 with the Ewald field;
    polar_wolf + polar_wolf_full: mode 5, no k-space; the no-PBC field:
    mode 3, no k-space) through ``run_flagship_chain`` (2 x SCF_CHUNK
    moves; K5 >= 4 and K2 >= 1 per move with S = 3).  Per setting, K5's
    call on the committed planes (event-timed); in modes 4 and 5 K2
    against its plain version on those planes (check_k2_signs).  Returns
    (launches by path, {setting: (moves/s, plane mode, K5 call ms)})."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar
    from mpmcxx_tpu_torch.ops import polar as polar_mod
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    launches, out = {}, {}
    for name, (fkw, pkw) in CACHE_SETTINGS.items():
        f, p = flags.replace(**fkw), params.replace(**pkw)
        label = f"co2-{name}"
        launches[label], rate, carry = run_flagship_chain(
            "co2", state, f, p, opts, root, card, "contract_planes_sym",
            label=label, chunk=SCF_CHUNK)
        mode = polar_mod.plane_mode(f)
        planes = pcache.planes_of(carry.pcache)
        k_empty = carry.pcache.cosp.shape[1] == 0
        if len(planes) != mode or k_empty == bool(f.polar_ewald):
            raise AssertionError(f"[{label}] {len(planes)} planes, k-space "
                                 f"{'empty' if k_empty else 'held'}; want "
                                 f"mode {mode}")
        mu = _mu(planes[0].shape[0], planes[0].device, carry.state)
        ms = _time_ms(lambda: cuda_polar.contract_planes_sym(
            planes, mu, p.polar_damp))
        out[name] = (rate, mode, ms)
        _say(f"[{label}] plane mode {mode}: {rate:.2f} moves/s; K5 call "
             f"{ms:.4f} ms on the committed planes on {card}")
        if mode in (4, 5):
            check_k2_signs(planes, planes[0].device)
        del carry, planes
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return launches, out


def _golden_records(fix):
    """(atoms as PQR records) of a golden fixture (tests/golden/*.json)."""
    return [dict(atomtype=at, moleculetype=mt, molecule_id=mid, x=x, y=y,
                 z=z, mass=mass, charge_e=q, polarizability=al, epsilon=eps,
                 sigma=sig)
            for (at, mt, mid, x, y, z, mass, q, al, eps, sig, *_)
            in fix["atoms"]]


def _write_pqr(path, recs):
    """``recs`` (charges in e) as a PQR the port's reader takes."""
    with open(path, "w") as f:
        for i, r in enumerate(recs, 1):
            f.write(f"ATOM  {i:5d} {r['atomtype']:<4s} "
                    f"{r['moleculetype']:<3s} M {r['molecule_id']:4d}   "
                    f"{r['x']:.6f} {r['y']:.6f} {r['z']:.6f} "
                    f"{r['mass']:.6f} {r['charge_e']:.8f} "
                    f"{r['polarizability']:.6f} {r['epsilon']:.6f} "
                    f"{r['sigma']:.6f} 0.0 0.0\n")
        f.write("END\n")


def run_tensor_cli(root, workdir, device="cuda"):
    """The polar_tensor golden's atoms through the port's CLI on the card
    with its config (``polarizability_tensor on``, ``polar_iterative
    off``): exit 0 and the printed tensor and isotropic value within the
    reference's print quantum (2e-4)."""
    with open(os.path.join(root, "tests", "golden", "polar_tensor.json")) \
            as f:
        fix = json.load(f)
    d = os.path.join(workdir, "polar_tensor")
    os.makedirs(d)
    _write_pqr(os.path.join(d, "in.pqr"), _golden_records(fix))
    b = fix["basis"]
    with open(os.path.join(d, "run.in"), "w") as f:
        f.write(f"job_name tensor\nensemble nvt\ntemperature "
                f"{fix['temperature']}\nnumsteps 10\ncorrtime 5\n"
                f"basis1 {b} 0 0\nbasis2 0 {b} 0\nbasis3 0 0 {b}\n"
                "pqr_input in.pqr\n" + fix["config_extra"])
    _, _, _, wall, text = _run_cli(
        d, ["--quiet", "--device", str(device), "run.in"])
    lines = text.splitlines()
    i = lines.index("POLARIZATION: polarizability tensor (A^3):")
    got = np.array([[float(v) for v in lines[i + 2 + r].split()]
                    for r in range(3)])
    want = np.array(fix["expected"]["tensor"])
    iso = float(lines[i + 6].split("=")[1])
    err = max(float(np.abs(got - want).max()),
              abs(iso - fix["expected"]["isotropic"]))
    _say(f"[polar_tensor] the CLI printed the tensor in {wall:.2f} s: max "
         f"|diff| vs the reference's print {err:.1e} (tol 2e-4); "
         f"isotropic {iso:.4f}")
    if not err < 2e-4:
        raise AssertionError("[polar_tensor] the tensor is off the golden")


def run_dense_solvers(root, workdir, card, device="cuda"):
    """Step 20: DENSE_EXAMPLE's initial state with polar_mixed off (the
    dense float64 A matrix): each of DENSE_SETTINGS' energies on the card
    and on the CPU within DENSE_REL; then DENSE_MOVES NVT moves with
    ranked Gauss-Seidel (a dense recompute per move; no K1-K5 launch),
    the carried energy against a recompute; the launches of one GS sweep
    (torch.profiler); the polar_tensor golden through the CLI
    (run_tensor_cli).  Returns (launches, ms per move, launches per
    sweep)."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.config.parser import read_config
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops import polar as polar_mod
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown
    from mpmcxx_tpu_torch.ops.pairwise import build_pairs
    from mpmcxx_tpu_torch.runner import Simulation
    from mpmcxx_tpu_torch.state import topology
    d = os.path.join(workdir, DENSE_EXAMPLE)
    shutil.copytree(os.path.join(root, "examples", DENSE_EXAMPLE), d)
    cwd = os.getcwd()
    try:
        os.chdir(d)
        cfg = read_config("run.in")
        cfg.polar_mixed = False
        sim = Simulation(cfg, quiet=True, device=device)
    finally:
        os.chdir(cwd)
    state, A = sim.state, sim.state.n_atom_slots
    if sim.opts.blocked_energy or sim.carry.pcache is not None:
        raise AssertionError(f"[{DENSE_EXAMPLE}] not on the dense path")
    cpu = to_device(state, "cpu")
    for name, (fkw, pkw) in DENSE_SETTINGS.items():
        f, p = sim.flags.replace(**fkw), sim.params.replace(**pkw)
        t0 = time.time()
        card_eb = energy_breakdown(state, f, p)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        cpu_eb = energy_breakdown(cpu, f, p)
        for comp in ("polarization", "total"):
            got, want = float(getattr(card_eb, comp)), float(
                getattr(cpu_eb, comp))
            rel, ok = _close(got, want, DENSE_REL)
            if not (ok and np.isfinite(got)):
                raise AssertionError(f"[{DENSE_EXAMPLE} {name}] {comp} card "
                                     f"{got} vs CPU {want}: rel {rel}")
        if float(card_eb.polarization_iterations) != float(
                cpu_eb.polarization_iterations) or bool(
                card_eb.iterator_failed):
            raise AssertionError(f"[{DENSE_EXAMPLE} {name}] iterations or "
                                 "failure differ from the CPU's")
        _say(f"[{DENSE_EXAMPLE} {name}] {A} slots: polarization "
             f"{float(card_eb.polarization):.9f} K on the card, rel "
             f"{rel:.1e} vs the CPU (tol {DENSE_REL:g}); "
             f"{float(card_eb.polarization_iterations):.0f} iterations; "
             f"{ms:.1f} ms")

    f, p = sim.flags.replace(polar_gs_ranked=True), sim.params.replace(
        polar_precision=1e-10)
    opts = dataclasses.replace(sim.opts, ensemble=const.ENSEMBLE_NVT,
                               incremental=False, polar_incremental=False,
                               blocked_energy=False)
    zero_launches()
    carry = chain.init_carry(state, f, p, opts, seed=0)
    runner = chain.make_chunk_runner(f, p, opts, DENSE_MOVES,
                                     topology=topology(state))
    torch.cuda.synchronize()
    t0 = time.time()
    carry, outs = runner(carry)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / DENSE_MOVES
    launches = launches_now()
    eb = energy_breakdown(carry.state, f, p)
    rel, ok = _close(float(carry.obs.energy), float(eb.total), DENSE_REL)
    if not (ok and np.isfinite(float(eb.total))):
        raise AssertionError(f"[{DENSE_EXAMPLE} gs_ranked NVT] carried vs "
                             f"recompute rel {rel}")
    if any(launches.values()):
        raise AssertionError(f"[{DENSE_EXAMPLE} gs_ranked NVT] K1-K5 "
                             f"launched: {launches}")
    its = outs.polarization_iterations.cpu().numpy()
    pt = build_pairs(state, f)
    M = polar_mod.contract_matrix(polar_mod.thole_amatrix(state, pt, f, p))
    E = polar_mod.thole_field(state, pt, f, p)
    alpha = state.polarizability
    ok_i = state.atom_alive() & (alpha != 0.0)
    _, sweep, _, _ = count_launches(lambda: polar_mod._gs_sweep(
        M, E, alpha, ok_i, alpha[:, None] * E, list(range(A))))
    _say(f"[{DENSE_EXAMPLE} gs_ranked NVT] {DENSE_MOVES} moves, "
         f"{int(outs.accepted.sum())} accepted, {its.mean():.1f} sweeps per "
         f"move: {ms:.1f} ms per move on {card}; one sweep {sweep} "
         f"launches ({sweep / A:.1f} per atom, {A} slots)")
    run_tensor_cli(root, workdir, device)
    return launches, ms, sweep


SPECIAL_FIELD = {"rd": "rd", "coulombic": "coulombic", "kinetic": "kinetic"}


def special_system(root, source, device, flag_changes=None):
    """(state, flags, params) on ``device`` of a special-move golden's
    atoms and config (tests/golden, read as tests/test_golden.py reads
    them) or, for "nvt-argon", of that example's PQR and run.in."""
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.config.parser import parse_config
    from mpmcxx_tpu_torch.flags import FFlags, RunParams
    from mpmcxx_tpu_torch.io.pqr import read_pqr
    from mpmcxx_tpu_torch.state import AtomRecord, build_state
    if source == "nvt-argon":
        atoms = read_pqr(os.path.join(root, "examples", source,
                                      "argon.pqr"))
        L, T, cfg_flags = 22.0, 120.0, FFlags()
        alpha = 3.5 / (L / 2.0)
        params = RunParams(temperature=T, ewald_alpha=alpha,
                           polar_ewald_alpha=alpha)
    else:
        with open(os.path.join(root, "tests", "golden",
                               source + ".json")) as f:
            fix = json.load(f)
        if "pqr_text" in fix:
            atoms = read_pqr(fix["pqr_text"], is_text=True)
        else:
            atoms = [AtomRecord(
                atomtype=at, moleculetype=mt, molecule_id=mid, x=x, y=y,
                z=z, mass=mass, charge=q * const.E2REDUCED,
                polarizability=al, epsilon=eps, sigma=sig, omega=om,
                gwp_alpha=gw)
                for (at, mt, mid, x, y, z, mass, q, al, eps, sig, om, gw,
                     *_) in fix["atoms"]]
        L = fix["basis"]
        cfg = parse_config(fix["config_extra"])
        cfg.temperature = fix["temperature"]
        cfg_flags, params = cfg.to_flags(), cfg.to_params()
        if not cfg.ewald_alpha_set:
            params = params.replace(ewald_alpha=3.5 / (L / 2.0))
        if not cfg.polar_ewald_alpha_set:
            params = params.replace(polar_ewald_alpha=3.5 / (L / 2.0))
    state, _ = build_state(atoms, np.eye(3) * L, device=device)
    return state, cfg_flags.replace(**(flag_changes or {})), params


def run_special_moves(root, device="cuda"):
    """Step 21: the special moves' energies and chains on the dense path.
    The goldens anharmonic, gwp_coulomb_kinetic (with kinetic) and
    spectre_nvt through ``energy_breakdown`` on the card within 2e-6 of
    the reference binary and 1e-12 relative of the CPU's; then
    SPECIAL_MOVES NVT moves of each of SPECIAL_CHAINS on the card and on
    the CPU (seed 0): the same accept sequence, energies within 1e-9
    relative, SPECTRE charges within 1e-12 and their live sum 0 (the
    renormalization's), GWP widths positive, some moves accepted; no
    K1-K5 launch.  Returns (launch counts, card ms per move by chain)."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown
    from mpmcxx_tpu_torch.runner import capacity_opts
    from mpmcxx_tpu_torch.state import topology

    zero_launches()
    for name in SPECIAL_GOLDENS:
        with open(os.path.join(root, "tests", "golden",
                               name + ".json")) as f:
            fix = json.load(f)
        ebs = [energy_breakdown(*special_system(root, name, dev))
               for dev in (device, "cpu")]
        for comp in fix["compare"]:
            want = fix["expected"][comp] + \
                fix.get("known_delta", {}).get(comp, 0.0)
            card, cpu = (float(getattr(eb, SPECIAL_FIELD[comp]))
                         for eb in ebs)
            rel, ok = _close(card, cpu, 1e-12)
            _say(f"[special] {name} {comp}: card {card:.9f}, reference "
                 f"binary {want:.9f} (|diff| {abs(card - want):.1e}, tol "
                 f"2e-06), CPU rel {rel:.1e} (tol 1e-12)")
            if not (abs(card - want) <= 2e-6 and ok):
                raise AssertionError(f"[special] {name} {comp}")
    ms = {}
    for name, (source, fkw, okw) in SPECIAL_CHAINS.items():
        runs = {}
        for dev in (device, "cpu"):
            state, flags, params = special_system(root, source, dev, fkw)
            opts = capacity_opts(chain.MCOptions(
                ensemble=const.ENSEMBLE_NVT, numsteps=SPECIAL_MOVES, **okw),
                flags, state)
            carry = chain.init_carry(state, flags, params, opts, seed=0)
            runner = chain.make_chunk_runner(
                flags, params, opts, SPECIAL_MOVES,
                topology=None if name.endswith("no_topology")
                else topology(state))
            torch.cuda.synchronize()
            t0 = time.time()
            carry, outs = runner(carry)
            torch.cuda.synchronize()
            runs[dev] = (state, carry, outs, time.time() - t0)
        (st, card, outs, dt), (_, cpu, outs_cpu, dt_cpu) = \
            runs[device], runs["cpu"]
        acc = outs.accepted.tolist()
        if acc != outs_cpu.accepted.tolist() or not any(acc):
            raise AssertionError(f"[special] {name}: accept sequences "
                                 f"differ or nothing accepted")
        rel, ok = _close(float(card.obs.energy), float(cpu.obs.energy), 1e-9)
        if not ok:
            raise AssertionError(f"[special] {name}: energy rel {rel}")
        extra = ""
        if name == "spectre":
            q, q_cpu = card.state.charge.cpu(), cpu.state.charge
            live = (st.spectre & st.aalive).cpu()
            dq = float(torch.max(torch.abs(q - q_cpu)))
            total = float(q[live].sum())
            extra = f"; charges card vs CPU {dq:.1e}, live sum {total:.1e}"
            if not (dq <= 1e-12 and abs(total) <= 1e-9):
                raise AssertionError(f"[special] spectre charges{extra}")
        if name == "gwp":
            ga = card.state.gwp_alpha[st.gwp_spin]
            extra = f"; widths {ga.tolist()}"
            if not bool(torch.all(ga > 0)):
                raise AssertionError(f"[special] gwp widths{extra}")
        ms[name] = dt * 1e3 / SPECIAL_MOVES
        _say(f"[special] {name}: {sum(acc)}/{SPECIAL_MOVES} accepted on "
             f"both; E card {float(card.obs.energy):.9f} vs CPU rel "
             f"{rel:.1e}{extra}; {ms[name]:.2f} ms per move on the card, "
             f"{dt_cpu * 1e3 / SPECIAL_MOVES:.2f} on the CPU")
    launches = launches_now()
    if any(launches.values()):
        raise AssertionError(f"[special] kernels launched: {launches}")
    return launches, ms


def write_h2_spin_input(workdir):
    """Step 22's input in ``workdir``: the port's H2 flagship
    PQR with its first H2_ADIABATIC molecules flagged adiabatic (A), and
    a uVT run.in with the flagship's settings, spin flips and adiabatic
    moves, 2 corrtimes of SPIN_CHUNK."""
    from mpmcxx_tpu_torch import flagship
    pqr = os.path.join(workdir, "flagship_h2.pqr")
    flagship.write_pqr_h2(pqr)
    with open(pqr) as f:
        lines = f.read().splitlines()
    flagged = set()
    for i, ln in enumerate(lines):
        tok = ln.split()
        if tok and tok[0] == "ATOM" and tok[3] == "H2" and (
                tok[5] in flagged or len(flagged) < H2_ADIABATIC):
            flagged.add(tok[5])
            lines[i] = ln.replace(" H2  M ", " H2  A ", 1)
    with open(pqr, "w") as f:
        f.write("\n".join(lines) + "\n")
    L = flagship.L
    with open(os.path.join(workdir, "run.in"), "w") as f:
        f.write(f"""job_name h2_spin
ensemble uvt
temperature {flagship.TEMPERATURE}
pressure {flagship.FUGACITY}
insert_probability {flagship.INSERT_PROB}
move_factor {flagship.MOVE_FACTOR}
spinflip_probability 0.1
adiabatic_probability 0.1
numsteps {2 * SPIN_CHUNK}
corrtime {SPIN_CHUNK}
seed 0
polarization on
polar_iterative on
polar_ewald on
polar_mixed on
polar_max_iter {flagship.POLAR_MAX_ITER}
polar_damp_type exponential
polar_damp {flagship.POLAR_DAMP}
{QROT_LINES}pqr_input flagship_h2.pqr
basis1 {L} 0 0
basis2 0 {L} 0
basis3 0 0 {L}
""")


def run_h2_spin(workdir, card, device="cuda"):
    """Step 22: the H2 flagship (mpmcxx_tpu_torch/flagship.py; its first
    H2_ADIABATIC molecules adiabatic) through ``runner.Simulation`` in uVT
    with quantum rotation, spin flips and adiabatic moves on the polar
    cache under the default schedule (K5 and K2), at 10,752 slots (S = 5),
    2 corrtimes of SPIN_CHUNK moves, as the CLI runs them (replayed as a
    CUDA graph where chain.graphs_apply).  Checks: a spin flip and an
    adiabatic move proposed; every flip rejected and the spins unchanged
    (the rotational partition functions stay 0: NaN factor); before each
    refresh the carried rd and coulombic within 1e-8 and polarization
    within 1e-5 of its full recompute, and every committed plane within
    1e-6 of a rebuild; K5 >= 4 and K2 >= 1 launches per move, K1, K3 and
    K4 none.  Then 2 x SPIN_CHUNK moves from the run's start again, eager
    with a hook on moves.displace: every adiabatic move on a flagged
    molecule, and the first corrtime bitwise the run's.  Then the kernel
    launches per move over FH_PROBE more moves.  Returns (launch counts,
    second corrtime's moves/s)."""
    from mpmcxx_tpu_torch import flagship
    import torch
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.config.parser import read_config
    from mpmcxx_tpu_torch.mc import chain, moves
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    from mpmcxx_tpu_torch.runner import Simulation

    write_h2_spin_input(workdir)
    cwd = os.getcwd()
    os.chdir(workdir)
    displace = moves.displace
    try:
        sim = Simulation(read_config("run.in"), quiet=True,
                         uvt_capacity_factor=1.0 + (
                             flagship.H2_EXTRA_SLOTS + 0.5) / flagship.N_H2,
                         device=device)
        st0 = sim.carry.state
        if st0.n_atom_slots != H2_SPIN_SLOTS or \
                sim.opts.max_mol_atoms != 5 or \
                not sim.opts.polar_incremental:
            raise AssertionError(f"[h2-spin] {st0.n_atom_slots} slots, "
                                 f"options {sim.opts}")
        spins0 = st0.nuclear_spin.clone()
        log = {"chunks": [], "refresh": [], "planes": []}
        targets = []
        fields = ("rd_energy", "coulombic_energy", "polarization_energy")
        run_chunk, refresh = sim.run_chunk, sim.refresh

        def timed(carry):
            if not log["chunks"]:
                log["start"] = copy.deepcopy(carry)
            torch.cuda.synchronize()
            t0 = time.time()
            carry, outs = run_chunk(carry)
            torch.cuda.synchronize()
            log["chunks"].append((time.time() - t0, outs))
            if len(log["chunks"]) == 1:
                log["first"] = [t.clone() for t in _spin_carry(carry)]
            return carry, outs

        def checked(carry):
            fresh = pcache.cache_init(carry.state, sim.flags, sim.params)
            log["planes"].append(max(
                float(torch.max(torch.abs(got - want))) for got, want in
                zip(pcache.planes_of(carry.pcache),
                    pcache.planes_of(fresh))))
            del fresh
            inc = {f: float(getattr(carry.obs, f)) for f in fields}
            out = refresh(carry)
            log["refresh"].append(
                (inc, {f: float(getattr(out.obs, f)) for f in fields}))
            return out

        def recorded(state, dice, axis, u_angle, mol, *a):
            # the adiabatic branch's displacement, built every uVT step
            targets.append(mol.clone())
            return displace(state, dice, axis, u_angle, mol, *a)

        # the run as the CLI runs it (graphed where graphs_apply holds)
        sim.run_chunk, sim.refresh = timed, checked
        zero_launches()
        sim.run()
        torch.cuda.synchronize()
        launches = launches_now()
        graphed = chain.graphs_apply(st0.pos.device, sim.flags, sim.params,
                                     sim.opts, sim.carry.pcache)
        # its first 2 chunks' moves again, eager (no refresh between), with
        # each move's adiabatic target read in Python
        moves.displace = recorded
        with eager_moves():
            eager = chain.make_chunk_runner(sim.flags, sim.params, sim.opts,
                                            SPIN_CHUNK, topology=sim.topology)
            c_e, o_first = eager(log.pop("start"))
            first = [t.clone() for t in _spin_carry(c_e)]
            c_e, o_second = eager(c_e)
        del c_e
    finally:
        moves.displace = displace
        os.chdir(cwd)
    n_moves = 2 * SPIN_CHUNK
    _check_refreshes("[h2-spin]", log, (("rd_energy", 1e-8),
                                        ("coulombic_energy", 1e-8),
                                        ("polarization_energy", 1e-5)), 2)
    _say(f"[h2-spin] committed planes vs rebuild before each refresh: max "
         f"|diff| {max(log['planes']):.3e} (tol 1e-06)")
    if not max(log["planes"]) <= 1e-6:
        raise AssertionError("[h2-spin] a plane drifted from a rebuild")
    outs = [o for _, o in log["chunks"]]
    for name, a, b in (("movetype", outs[0].movetype, o_first.movetype),
                       ("accepted", outs[0].accepted, o_first.accepted),
                       *zip(("pos", "mu", "energy"), log["first"], first)):
        if not torch.equal(a, b):
            raise AssertionError(f"[h2-spin] the run's first corrtime and "
                                 f"its eager rerun differ in {name}")
    path = "graphed" if graphed else "eager"
    _say(f"[h2-spin] the run's first corrtime ({path}) and its eager "
         f"rerun: movetypes, accepts, positions, dipoles and energy "
         f"bitwise equal")
    mt = torch.cat([o.movetype for o in outs])
    acc = torch.cat([o.accepted for o in outs])
    spin = mt == const.MOVETYPE_SPINFLIP
    adia = mt == const.MOVETYPE_ADIABATIC
    if len(targets) != n_moves:
        raise AssertionError(f"[h2-spin] {len(targets)} adiabatic "
                             f"proposals for {n_moves} eager moves")
    hit = st0.mol_adiabatic[torch.stack(targets)[torch.cat(
        [o_first.movetype, o_second.movetype]) == const.MOVETYPE_ADIABATIC]]
    carry = sim.carry
    _say(f"[h2-spin] {int(spin.sum())} spin flips ({int((spin & acc).sum())}"
         f" accepted), {int(adia.sum())} adiabatic moves "
         f"({int((adia & acc).sum())} accepted), {int(acc.sum())} of "
         f"{n_moves} moves accepted; N = {int(carry.obs.N)}; the eager "
         f"rerun's {int(hit.numel())} adiabatic moves every one on a "
         f"flagged molecule: {bool(torch.all(hit))}")
    if not spin.any() or not adia.any() or not hit.numel() or \
            not bool(torch.all(hit)):
        raise AssertionError("[h2-spin] no spin flip, no adiabatic move or "
                             "one off the flagged molecules")
    if bool((spin & acc).any()) or not torch.equal(
            carry.state.nuclear_spin[:len(spins0)], spins0):
        raise AssertionError("[h2-spin] a spin flip was accepted")
    per_move = {k: launches[k] / n_moves for k in
                ("contract_planes_sym", "write_plane_strips")}
    if per_move["contract_planes_sym"] < 4 or \
            per_move["write_plane_strips"] < 1 or \
            launches["contract_planes"] or launches["contract_planes_tri"] \
            or launches["occupancy"]:
        raise AssertionError(f"[h2-spin] launches {launches}")
    probe = chain.make_chunk_runner(sim.flags, sim.params, sim.opts,
                                    FH_PROBE, topology=sim.topology)
    _, n_launch, _, what = count_launches(lambda: probe(carry))
    dt = log["chunks"][-1][0]
    _say(f"[h2-spin] second corrtime ({path}): {SPIN_CHUNK} moves in {dt:.3f} s = "
         f"{SPIN_CHUNK / dt:.2f} moves/s on {card}; K5 "
         f"{per_move['contract_planes_sym']:.2f} and K2 "
         f"{per_move['write_plane_strips']:.2f} launches per move (the "
         f"refreshes' solves included); kernel launches per move ({what}, "
         f"{FH_PROBE} moves): {n_launch / FH_PROBE:.1f}; launches "
         f"{launches}")
    return launches, SPIN_CHUNK / dt


def _spin_carry(carry):
    """What step 22 compares of a carry: positions, dipoles, energy."""
    return carry.state.pos, carry.state.mu, carry.obs.energy


def _flips_rejected(label, outs, replayed):
    """The spin flips among ``outs``: their count equal to ``replayed``
    (the host's replay of the move draws) and none accepted."""
    from mpmcxx_tpu_torch import constants as const
    spin = outs.movetype.cpu() == const.MOVETYPE_SPINFLIP
    n, n_acc = int(spin.sum()), int((spin & outs.accepted.cpu()).sum())
    _say(f"[{label}] {n} spin flips (the host's replay of the draws: "
         f"{replayed}), {n_acc} accepted")
    if n != replayed or not n or n_acc:
        raise AssertionError(f"[{label}] spin flips {n} vs {replayed}, "
                             f"{n_acc} accepted")


def run_spin_ensembles(workdir, device="cuda"):
    """Step 23: step 13's Gibbs VLE and step 14's PI-NVT with quantum
    rotation and spinflip_probability SPIN_P, one corrtime each.  Checks:
    the spin-flip count equal to a host replay of the move draws, every
    flip rejected and the spins unchanged, and step 13's (incremental
    energies at the refresh, N and V conserved, a transfer and a volume
    exchange, no K1-K5 launch) and step 14's gates (the carried potential
    at the recompute, the kinetic bound, the restart files, displacements
    and bead moves accepted >= 5 %, no K1-K5 launch).  Returns (launch
    counts of each, Gibbs steps/s, PI moves/s)."""
    import torch
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.io.pqr import make_filename
    from mpmcxx_tpu_torch.mc import gibbs, pi

    extra = QROT_LINES + f"spinflip_probability {SPIN_P}\n"
    label = "gibbs-spin"
    sim = vle_simulation(workdir, device, extra=extra, corrtimes=1,
                         label=label)
    zero_launches()
    carry = sim._init_carry()
    spins = (carry.state_a.nuclear_spin.clone(),
             carry.state_b.nuclear_spin.clone())
    n0 = float(carry.obs_a.N + carry.obs_b.N)
    v0 = float(carry.state_a.pbc.volume + carry.state_b.pbc.volume)
    replay = gibbs.move_picks(sim.opts, gibbs.gibbs_draws(carry.key,
                                                          VLE_STEPS)[1])
    torch.cuda.synchronize()
    t0 = time.time()
    carry, outs = sim._run_chunk(carry)
    torch.cuda.synchronize()
    dt = time.time() - t0
    carry = _vle_refresh(sim, carry, "corrtime 1", label)
    _vle_gates(carry, n0, v0, outs.movetype.cpu(), launches_now(), label)
    _flips_rejected(label, outs, sum(m == gibbs.SPIN for m, _ in replay))
    if not (torch.equal(carry.state_a.nuclear_spin, spins[0]) and
            torch.equal(carry.state_b.nuclear_spin, spins[1])):
        raise AssertionError(f"[{label}] the spins changed")
    gibbs_launches = launches_now()
    gibbs_rate = VLE_STEPS / dt
    _say(f"[{label}] {VLE_STEPS} steps in {dt:.3f} s = {gibbs_rate:.2f} "
         f"steps/s")

    label = "pi-spin"
    h = PI_H2
    d = write_pi_h2(workdir, extra=extra, corrtimes=1, label=label)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        sim = pi_h2_simulation(device, label)
        spins = sim.stack.nuclear_spin.clone()
        log = {"chunks": [], "recompute": []}
        run_chunk, recompute = sim._run_chunk, sim._recompute

        def timed(carry):
            picks = pi.move_picks(sim.opts, pi.pi_draws(
                carry.key, h["moves"], sim.cfg.PI_trial_chain_length,
                h["beads"], sim.any_orientation)[1])
            torch.cuda.synchronize()
            t0 = time.time()
            carry, outs = run_chunk(carry)
            torch.cuda.synchronize()
            log["chunks"].append((time.time() - t0, outs, picks))
            return carry, outs

        def recorded(carry):
            out = recompute(carry)
            log["recompute"].append((float(carry.potential_current),
                                     float(out.potential_current)))
            return out

        sim._run_chunk, sim._recompute = timed, recorded
        zero_launches()
        sim.run()
        torch.cuda.synchronize()
        pi_launches = launches_now()
        carry = sim.carry
        for s in range(h["beads"]):
            if not os.path.getsize(make_filename(sim.cfg.pqr_restart, s)):
                raise AssertionError(f"[{label}] no restart file for bead "
                                     f"{s}")
    finally:
        os.chdir(cwd)
    (inc, full), = log["recompute"]
    rel, ok = _close(inc, full, 1e-9)
    kin = float(pi.pi_kinetic(carry.stack, carry.temperature))
    bound = 1.5 * h["n"] * h["T"] * h["beads"]
    acc, rej = carry.accept.tolist(), carry.reject.tolist()
    rates = {const.MOVETYPE_NAMES[m]: acc[m] / max(acc[m] + rej[m], 1)
             for m in (const.MOVETYPE_DISPLACE, const.MOVETYPE_PERTURB_BEADS)}
    _say(f"[{label}] carried potential {inc:.9f} vs per-bead recompute "
         f"{full:.9f}: rel {rel:.2e} (tol 1e-09); kinetic estimator "
         f"{kin:.3f} K (< {bound:g}); acceptance {rates}")
    if not ok or not (np.isfinite(kin) and kin < bound) or \
            any(r < 0.05 for r in rates.values()) or \
            any(pi_launches.values()):
        raise AssertionError(f"[{label}] rel {rel}, kinetic {kin}, "
                             f"acceptance {rates}, launches {pi_launches}")
    dt, outs, picks = log["chunks"][0]
    _flips_rejected(label, outs, picks.count(const.MOVETYPE_SPINFLIP))
    if not torch.equal(carry.stack.nuclear_spin, spins):
        raise AssertionError(f"[{label}] the spins changed")
    pi_rate = h["moves"] / dt
    _say(f"[{label}] {h['moves']} moves in {dt:.3f} s = {pi_rate:.2f} "
         f"moves/s")
    return gibbs_launches, pi_launches, gibbs_rate, pi_rate


def replica_input():
    """RUN_IN as step 24's tempering run: REP_STEPS steps in corrtimes of
    REP_CORRTIME, a swap sweep every REP_PTEMP steps over the ladder from
    its temperature to REP_TMAX."""
    keep = [ln for ln in RUN_IN.replace("flagship_cav",
                                        "flagship_rep").splitlines()
            if not ln.startswith(("numsteps", "corrtime"))]
    return "\n".join(keep + [
        f"numsteps {REP_STEPS}", f"corrtime {REP_CORRTIME}",
        "parallel_tempering on", f"max_temperature {REP_TMAX}",
        f"ptemp_freq {REP_PTEMP}"]) + "\n"


def _launch_delta(before):
    now = launches_now()
    return {k: now[k] - before[k] for k in now}


def check_replicas_vs_single(state, flags, params, opts):
    """Step 24a: REP_PAIR replicas of the CO2 flagship (step 3's state,
    K5 + K2) through ``make_replica_runner``, one REP_A_MOVES-move chunk,
    against ``make_chunk_runner`` on each replica's initial carry with key
    fold_in(PRNGKey(0), r).  Gates: the same move types and accepts,
    energies within 1e-9 relative, the committed planes bitwise equal.
    Returns the launch counts of the replica run and, for step 25e, the
    initial carry, the replicas after the chunk and their StepOuts."""
    import torch
    from mpmcxx_tpu_torch import random as rnd
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    from mpmcxx_tpu_torch.parallel import replicas as rep
    from mpmcxx_tpu_torch.state import topology

    carry = chain.init_carry(state, flags, params, opts, seed=0)
    reps = rep.replicate_carry(carry, REP_PAIR, base_seed=0)
    singles = [dataclasses.replace(copy.deepcopy(carry),
                                   key=rnd.fold_in(rnd.PRNGKey(0), r))
               for r in range(REP_PAIR)]
    zero_launches()
    t0 = time.time()
    reps, outs = rep.make_replica_runner(flags, params, opts,
                                         REP_A_MOVES)(reps)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = launches_now()
    one = chain.make_chunk_runner(flags, params, opts, REP_A_MOVES,
                                  topology=topology(state))
    for r in range(REP_PAIR):
        single, outs_1 = one(singles[r])
        same = (torch.equal(outs[r].movetype, outs_1.movetype) and
                torch.equal(outs[r].accepted, outs_1.accepted))
        rel = abs(float(reps[r].obs.energy) - float(single.obs.energy)) / \
            abs(float(single.obs.energy))
        planes = all(torch.equal(a, b) for a, b in zip(
            pcache.planes_of(reps[r].pcache), pcache.planes_of(single.pcache)))
        _say(f"[replicas-a] replica {r}: {int(outs[r].accepted.sum())} of "
             f"{REP_A_MOVES} moves accepted, moves and accepts equal to the "
             f"single chain's: {same}; energy {float(reps[r].obs.energy):.9f}"
             f" vs {float(single.obs.energy):.9f} (rel {rel:.2e}, tol "
             f"1e-09); committed planes bitwise equal: {planes}")
        if not (same and rel <= 1e-9 and planes):
            raise AssertionError(f"[replicas-a] replica {r} differs from its "
                                 "single chain")
        singles[r] = None
        del single
    if torch.equal(reps[0].state.pos, reps[1].state.pos):
        raise AssertionError("[replicas-a] the replicas did not diverge")
    n = REP_PAIR * REP_A_MOVES
    _say(f"[replicas-a] {REP_PAIR} x {REP_A_MOVES} moves at "
         f"{state.n_atom_slots} slots in {dt:.3f} s ({n / dt:.2f} moves/s "
         f"for the pair); launches {launches}")
    if launches["contract_planes_sym"] < 4 * n or \
            launches["write_plane_strips"] < n:
        raise AssertionError(f"[replicas-a] launches {launches}")
    return launches, {"init": carry, "reps": reps, "outs": outs}


def _instrument_replicas(log):
    """Like _instrument_chain, for a replica run: each chunk's replica
    (the chunk runners are made one per replica, in replica order, at
    their first call), moves, seconds, StepOut and launch counts; before
    each refresh (replicas in order) the committed planes' largest
    difference from a rebuild, then the carried energies beside the
    refresh's and the refresh's own launches."""
    import torch
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    orig_runner, orig_refresher = chain.make_chunk_runner, \
        chain.make_refresher
    fields = ("rd_energy", "coulombic_energy", "polarization_energy")
    made = []

    def make_chunk_runner(*a, **kw):
        run_chunk = orig_runner(*a, **kw)
        tag = len(made)
        made.append(tag)

        def timed(carry):
            torch.cuda.synchronize()
            before = launches_now()
            t0 = time.time()
            carry, outs = run_chunk(carry)
            torch.cuda.synchronize()
            log["chunks"].append((tag, len(outs.movetype), time.time() - t0,
                                  outs, _launch_delta(before)))
            return carry, outs
        return timed

    def make_refresher(flags, params, opts):
        refresh = orig_refresher(flags, params, opts)

        def recorded(carry):
            if carry.pcache is not None:
                fresh = pcache.cache_init(carry.state, flags, params)
                log["planes"].append(max(
                    float(torch.max(torch.abs(got - want))) for got, want in
                    zip(pcache.planes_of(carry.pcache),
                        pcache.planes_of(fresh))))
                del fresh
            inc = {f: float(getattr(carry.obs, f)) for f in fields}
            before = launches_now()
            out = refresh(carry)
            torch.cuda.synchronize()
            log["refresh"].append(
                (inc, {f: float(getattr(out.obs, f)) for f in fields}))
            log["refresh_launches"].append(_launch_delta(before))
            return out
        return recorded

    chain.make_chunk_runner = make_chunk_runner
    chain.make_refresher = make_refresher

    def undo():
        chain.make_chunk_runner = orig_runner
        chain.make_refresher = orig_refresher
    return undo


def run_replica_flagship(workdir, cli_launches, card, device="cuda"):
    """Step 24b: the cavity-biased CO2 flagship of step 5 (``workdir``
    holds flagship_co2.pqr) through the CLI with ``--replicas REP_R``
    under parallel tempering (replica_input).  Gates: exit code 0; REP_R
    restart and REP_R final PQRs, each re-read with its replica's live
    atom count; the final temperatures a permutation of the ladder;
    swap_attempts equal to the host's count of left partners per sweep;
    before each refresh, each replica's carried rd and coulombic within
    1e-8 and polarization within 1e-5 of its refresh, and every committed
    plane within 1e-6 of a rebuild; per replica, K5 >= 4, K2 >= 1 and K3
    >= 1 launches per move and each within REP_LAUNCH_REL of step 5's
    (``cli_launches``, 2 CHUNK moves, without the initial carry's), K1
    and K4 none; on a GPU the peak
    device memory within the budget of max_slots(n_caches=REP_R).
    Returns (launch counts of the run, a dict of its measurements)."""
    import torch
    from mpmcxx_tpu_torch.io import pqr as pqr_io
    from mpmcxx_tpu_torch.io.pqr import read_pqr
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    from mpmcxx_tpu_torch.ops.polar import plane_mode
    from mpmcxx_tpu_torch.parallel import replicas as rep
    from mpmcxx_tpu_torch.parallel.driver import ReplicaSimulation

    with open(os.path.join(workdir, "run.in"), "w") as f:
        f.write(replica_input())
    log = {"chunks": [], "refresh": [], "refresh_launches": [],
           "planes": [], "writes": []}
    write_pqrs, drain = ReplicaSimulation._write_pqrs, pqr_io.drain

    def timed_writes(sim, basename):
        t0 = time.time()
        write_pqrs(sim, basename)
        log["writes"].append((basename, time.time() - t0))

    def timed_drain():
        t0 = time.time()
        drain()
        log["writes"].append(("drain", time.time() - t0))

    ReplicaSimulation._write_pqrs = timed_writes
    pqr_io.drain = timed_drain
    torch.cuda.reset_peak_memory_stats()
    try:
        sim, _, launches, wall, stdout = _run_cli(
            workdir, ["--device", str(device), "--replicas", str(REP_R),
                      "run.in"], instrument=_instrument_replicas, log=log)
    finally:
        ReplicaSimulation._write_pqrs = write_pqrs
        pqr_io.drain = drain
    peak = torch.cuda.max_memory_allocated()
    for line in stdout.splitlines():
        if line.startswith(("SIM_CONTROL: Simulation complete",
                            "OUTPUT: AR", "MC:")):
            _say("  cli| " + line)
    R = REP_R
    if not isinstance(sim, ReplicaSimulation) or sim.R != R or \
            not sim.tempering:
        raise AssertionError(f"[replicas] the CLI ran {type(sim).__name__}")
    st = sim.carries[0].state
    _say(f"[replicas] CLI run: exit code 0, {wall:.1f} s wall including "
         f"set-up; {R} replicas of {st.n_atom_slots} atom slots, "
         f"{sim.base.opts.cavity_darts} darts per move, polar cache "
         f"{sim.base.opts.polar_incremental}")
    if st.n_atom_slots != CLI_SLOTS or sim.base.opts.cavity_darts != \
            CLI_DARTS or not sim.base.opts.polar_incremental:
        raise AssertionError("[replicas] not the flagship's width, or no "
                             "polar cache")

    # the ladder, the swaps
    ladder = rep.temperature_ladder(float(sim.cfg.temperature), REP_TMAX, R)
    temps = [float(c.temperature) for c in sim.carries]
    sweeps = REP_STEPS // min(REP_PTEMP, REP_CORRTIME)
    want = sum(1 for s in range(sweeps) for i in range(R - 1)
               if i % 2 == s % 2)
    _say(f"[replicas] final temperatures {temps} (ladder "
         f"{ladder.tolist()}); swaps {sim.swap_accepts} of "
         f"{sim.swap_attempts} accepted (host count of left partners "
         f"{want})")
    if sorted(temps) != ladder.tolist() or sim.swap_attempts != want:
        raise AssertionError("[replicas] temperatures or swap count")

    # the carried energies and the planes against each refresh
    _check_refreshes("[replicas]", log, (("rd_energy", 1e-8),
                                         ("coulombic_energy", 1e-8),
                                         ("polarization_energy", 1e-5)),
                     R * (REP_STEPS // REP_CORRTIME))
    worst = max(log["planes"])
    _say(f"[replicas] committed planes vs rebuild before each of "
         f"{len(log['planes'])} refreshes: max |diff| {worst:.3e} (tol 1e-06)")
    if len(log["planes"]) != len(log["refresh"]) or not worst <= 1e-6:
        raise AssertionError("[replicas] a plane drifted from a rebuild")

    # the restart and final PQRs, re-read
    n_frozen = int(st.frozen.sum())
    for kind in ("restart", "final"):
        counts = []
        for r, c in enumerate(sim.carries):
            path = os.path.join(workdir, f"flagship_rep.{kind}-000{r}.pqr")
            n_atoms = len(read_pqr(path))
            counts.append(n_atoms)
            if n_atoms != n_frozen + 3 * int(c.obs.N):
                raise AssertionError(f"[replicas] {path}: {n_atoms} atoms, "
                                     f"N = {int(c.obs.N)}")
        _say(f"[replicas] {kind} PQRs re-read: {counts} atoms = {n_frozen} "
             f"framework + 3 N per replica")

    # launches and rates per replica
    tags = sorted({t for t, *_ in log["chunks"]})
    if len(tags) != R:
        raise AssertionError(f"[replicas] {len(tags)} chunk runners")
    rates, moves_all, dt_all = [], 0, 0.0
    # the run's launches outside its chunks and refreshes are the initial
    # carry's (one init_carry of the same state as step 5's): step 5's
    # per move without them
    init = {k: launches[k] - sum(c[4][k] for c in log["chunks"]) -
            sum(d[k] for d in log["refresh_launches"]) for k in launches}
    step5 = {k: (cli_launches[k] - init[k]) / (2 * CHUNK)
             for k in cli_launches}
    _say(f"[replicas] the initial carry's launches {init}")
    names = ("contract_planes_sym", "write_plane_strips", "occupancy")
    for r, tag in enumerate(tags):
        mine = [c for c in log["chunks"] if c[0] == tag]
        moves = sum(n for _, n, *_ in mine)
        dt = sum(t for _, _, t, *_ in mine)
        moves_all, dt_all = moves_all + moves, dt_all + dt
        counts = {k: sum(c[4][k] for c in mine) +
                  sum(d[k] for d in log["refresh_launches"][r::R])
                  for k in launches}
        per = {k: counts[k] / moves for k in counts}
        rates.append(moves / dt)
        _say(f"[replicas] replica {r}: {moves} moves in {dt:.3f} s = "
             f"{moves / dt:.2f} moves/s; launches per move (refreshes "
             f"included) " + ", ".join(
                 f"{k} {per[k]:.3f} (step 5 {step5[k]:.3f})" for k in names))
        if per["contract_planes_sym"] < 4 or per["write_plane_strips"] < 1 \
                or per["occupancy"] < 1 or counts["contract_planes"] or \
                counts["contract_planes_tri"]:
            raise AssertionError(f"[replicas] replica {r} launches {counts}")
        for k in names:
            if abs(per[k] - step5[k]) > REP_LAUNCH_REL * step5[k]:
                raise AssertionError(f"[replicas] replica {r} {k} "
                                     f"{per[k]:.3f} per move vs step 5's "
                                     f"{step5[k]:.3f}")
    if launches["contract_planes"] or launches["contract_planes_tri"]:
        raise AssertionError("[replicas] K1 or K4 ran")

    # memory against the R-cache budget
    n_planes = plane_mode(sim.base.flags)
    planes_gb = n_planes * 4 * CLI_SLOTS ** 2 / 1e9
    if torch.device(device).type == "cuda":
        total = torch.cuda.get_device_properties(0).total_memory
        budget = pcache.DEVICE_MEMORY_SHARE * total
        cap = pcache.max_slots(device, n_planes, R)
        _say(f"[replicas] peak device memory {peak / 1e9:.2f} GB; budget "
             f"{budget / 1e9:.2f} GB ({pcache.DEVICE_MEMORY_SHARE:g} of "
             f"{total / 1e9:.2f} GB); planes {planes_gb:.2f} GB per cache, "
             f"{R} + {pcache.PLANE_COPIES_AT_PEAK - 1} copies at the peak = "
             f"{(R + pcache.PLANE_COPIES_AT_PEAK - 1) * planes_gb:.2f} GB; "
             f"max_slots(n_caches={R}) = {cap}")
        if not peak <= budget or CLI_SLOTS > cap:
            raise AssertionError("[replicas] over the R-cache budget")
    restart = [t for b, t in log["writes"] if b == sim.cfg.pqr_restart]
    final = [t for b, t in log["writes"] if b == sim.cfg.pqr_output]
    drains = [t for b, t in log["writes"] if b == "drain"]
    out = {"rates": rates, "rate": moves_all / dt_all,
           "swap": (sim.swap_accepts, sim.swap_attempts),
           "peak_gb": peak / 1e9, "restart_s": restart,
           "final_s": final, "drain_s": drains}
    _say(f"[replicas] on {card}: {moves_all} replica-moves in {dt_all:.3f} s "
         f"of chunks = {out['rate']:.2f} moves/s for the run ("
         + ", ".join(f"{x:.2f}" for x in rates) + " per replica); swap "
         f"acceptance {sim.swap_accepts}/{sim.swap_attempts}; {R} restart "
         f"writes per corrtime took " + ", ".join(f"{t:.3f}" for t in restart)
         + " s on the host until they returned (final " +
         ", ".join(f"{t:.3f}" for t in final) + " s, drain " +
         ", ".join(f"{t:.3f}" for t in drains) + " s)")
    return launches, out


def check_codec(pqr, device="cuda"):
    """Step 24c: the native PQR codec on this machine.  It must build;
    ``format_pqr`` of step 5's 19,712-slot state through the codec must be
    byte-identical to the Python path's; one ``write_state_pqr`` of that
    state each way, timed on the host until the call returns and until
    ``drain()`` returns.  Returns those times."""
    from mpmcxx_tpu_torch.io import pqr as pqr_io
    from mpmcxx_tpu_torch.runtime import native

    t0 = time.time()
    if native.get_lib() is None:
        raise AssertionError("[codec] the native codec did not build")
    _say(f"[codec] built and loaded in {time.time() - t0:.2f} s: "
         f"{native.lib_path()}")
    state, meta = cli_flagship_state(pqr, device, with_meta=True)
    basis = state.pbc.basis.cpu().numpy()
    data = pqr_io.state_to_atoms_data(state, meta)
    get_lib = native.get_lib
    t0 = time.time()
    native_text = pqr_io.format_pqr(data, basis)
    t_native = time.time() - t0
    native.get_lib = lambda: None
    try:
        t0 = time.time()
        python_text = pqr_io.format_pqr(data, basis)
        t_python = time.time() - t0
    finally:
        native.get_lib = get_lib
    n = len(data["atomtype"])
    _say(f"[codec] format_pqr of {n} live atoms ({state.n_atom_slots} "
         f"slots): codec {t_native:.3f} s, Python {t_python:.3f} s; "
         f"byte-identical: {native_text == python_text}")
    if native_text != python_text:
        raise AssertionError("[codec] the codec's PQR differs from Python's")
    times = {}
    with tempfile.TemporaryDirectory() as d:
        for how in ("codec", "python"):
            path = os.path.join(d, f"{how}.pqr")
            if how == "python":
                native.get_lib = lambda: None
            try:
                t0 = time.time()
                pqr_io.write_state_pqr(path, state, meta)
                t_return = time.time() - t0
                pqr_io.drain()
                times[how] = (t_return, time.time() - t0)
            finally:
                native.get_lib = get_lib
        pqr_io.drain()
        with open(os.path.join(d, "codec.pqr"), "rb") as a, \
                open(os.path.join(d, "python.pqr"), "rb") as b:
            if a.read() != b.read():
                raise AssertionError("[codec] the written files differ")
    for how, (ret, done) in times.items():
        _say(f"[codec] write_state_pqr via {how}: returned after {ret:.3f} "
             f"s, on disk after {done:.3f} s")
    return times


def mesh_input():
    """RUN_IN as step 25b's run: 2 corrtimes of MESH_CORRTIME moves."""
    keep = [ln for ln in RUN_IN.replace("flagship_cav",
                                        "flagship_mesh").splitlines()
            if not ln.startswith(("numsteps", "corrtime"))]
    return "\n".join(keep + [f"numsteps {2 * MESH_CORRTIME}",
                             f"corrtime {MESH_CORRTIME}"]) + "\n"


def check_sharded_energy(pqr, flags, params, mesh, device="cuda"):
    """Step 25a: ``sharded_breakdown`` of the CLI flagship's state (19,712
    slots) on ``mesh`` against ``energy_breakdown_blocked``: rd and
    coulombic within 1e-9 relative, polarization within 1e-5; K1 exactly
    one launch per shard holding rows and SCF iteration, K5 and K4 none.
    Then the
    sliced K1 on the even [A/n, A] row slices of the planes (the chain's
    shards): each shard's launch against its plain version (relative
    error <= K1_REL_TOL, repeats bitwise), and one sharded contraction
    (n launches) timed: events, device time (profiler), plain time and
    the slices' bound.  Returns (the path's launch counts, the record of
    the sliced K1)."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar
    from mpmcxx_tpu_torch.ops import polar as polar_mod
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown_blocked
    from mpmcxx_tpu_torch.parallel import meshing
    from mpmcxx_tpu_torch.parallel.sharded_energy import (_row_slices,
                                                          sharded_breakdown)

    state = cli_flagship_state(pqr, device)
    A = state.n_atom_slots
    # the shards whose padded row slice holds rows (all of them at 19,712)
    holding = sum(int((r >= 0).any())
                  for r in _row_slices(A, mesh.size, MESH_BLOCK))
    want = energy_breakdown_blocked(state, flags, params)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.time()
    got = sharded_breakdown(state, flags, params, mesh, block=MESH_BLOCK)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = launches_now()
    iters = int(got.polarization_iterations)
    for comp, tol in (("rd", 1e-9), ("coulombic", 1e-9),
                      ("polarization", 1e-5)):
        g, w = float(getattr(got, comp)), float(getattr(want, comp))
        rel, ok = _close(g, w, tol)
        _say(f"[mesh-energy] {comp} {g:.9f} on {mesh.size} shards vs "
             f"blocked {w:.9f}: rel {rel:.2e} (tol {tol:g})")
        if not ok:
            raise AssertionError(f"[mesh-energy] {comp}: rel {rel}")
    _say(f"[mesh-energy] {A} slots on {mesh.size} shards of "
         f"{mesh.leader} ({holding} holding rows): {dt:.2f} s; {iters} SCF "
         f"iterations; launches {launches}")
    if launches["contract_planes"] != holding * iters or iters < 1 or \
            launches["contract_planes_sym"] or \
            launches["contract_planes_tri"]:
        raise AssertionError(f"[mesh-energy] launches {launches}: want "
                             f"{holding} K1 per SCF iteration only")
    del want, got

    # the sliced K1 at the chain's shapes
    l = params.polar_damp
    ranges = meshing.even_rows(A, mesh.size)
    planes, _ = pcache.sharded_rows(state, flags, params, mesh, ranges)
    mu = _mu(A, device, state)
    got, want = [], []
    for d, (r0, R) in enumerate(ranges):
        part = tuple(p.parts[d] for p in planes)
        k = cuda_polar.contract_planes(part, mu, l)
        again = cuda_polar.contract_planes(part, mu, l)
        torch.cuda.synchronize()
        if k.shape != (R, 3) or not torch.equal(k, again):
            raise AssertionError(f"[mesh-energy] K1 on rows {r0}..{r0 + R}:"
                                 " shape, or repeats differ")
        got.append(k)
        want.append(cuda_polar.contract_planes_plain(part, mu, l))
    # the relative error over all rows (a shard of dead slots gives 0)
    got, want = torch.cat(got), torch.cat(want)
    rel = _rel(got, want)
    worst = float(torch.max(torch.abs(got - want)))
    if not rel <= K1_REL_TOL:
        raise AssertionError(f"[mesh-energy] sliced K1: rel {rel:.3e}")
    del got, want

    def sharded():
        polar_mod.contract_mixed(planes, mu, l=l)

    def plain():
        for d in range(mesh.size):
            cuda_polar.contract_planes_plain(
                tuple(p.parts[d] for p in planes), mu, l)
    split = {k: v for k, v in device_split(
        sharded, want="contract_planes_kernel", count=mesh.size).items()
        if "contract_planes" in k or "sum_row_slots" in k}
    if not split:
        raise AssertionError("[mesh-energy] the profiler saw no K1 kernel")
    bounds = [_contract_bound(A, 3, R * A, 1, R) for _, R in ranges]
    rec = {"ms": _time_ms(sharded),
           "device_ms": sum(ms for ms, _ in split.values()),
           "plain_ms": _time_ms(plain), "max_abs_err": worst,
           "bound": (sum(b[0] for b in bounds), bounds[0][1]),
           "slices": [R for _, R in ranges]}
    _say(f"K1 contract_planes sliced {mesh.size} x [{ranges[0][1]}, {A}] "
         f"mode 3 (one sharded contraction, {mesh.size} launches): call "
         f"{rec['ms']:.4f} ms (events), device {rec['device_ms']:.4f} ms "
         f"(profiler: " + ", ".join(f"{k} {ms:.4f} ms x {n:.0f}"
                                    for k, (ms, n) in split.items()) +
         f"), plain {rec['plain_ms']:.3f} ms, bound {rec['bound'][0]:.4f} "
         f"ms ({rec['bound'][1]}: the slices' full rows; call "
         f"{rec['bound'][0] / rec['ms']:.1%}), max_abs_err {worst:.3e}, "
         f"rel_err {rel:.3e}, repeats bitwise equal")
    return launches, rec


def _instrument_mesh(log):
    """Like _instrument_chain, for a row-sharded run: each chunk's moves,
    seconds, StepOut and launch counts; before each refresh the committed
    planes' largest difference, shard by shard, from a sharded rebuild,
    then the carried energies beside the refresh's.  The peak device
    memory leaves out the rebuild: the running peak is read before it
    and the counter reset after it (log["peak"])."""
    import torch
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    from mpmcxx_tpu_torch.parallel import meshing
    orig_runner, orig_refresher = chain.make_chunk_runner, \
        chain.make_refresher
    fields = ("rd_energy", "coulombic_energy", "polarization_energy")

    def make_chunk_runner(*a, **kw):
        run_chunk = orig_runner(*a, **kw)

        def timed(carry):
            torch.cuda.synchronize()
            before = launches_now()
            t0 = time.time()
            carry, outs = run_chunk(carry)
            torch.cuda.synchronize()
            log["chunks"].append((len(outs.movetype), time.time() - t0,
                                  outs, _launch_delta(before)))
            return carry, outs
        return timed

    def make_refresher(flags, params, opts):
        refresh = orig_refresher(flags, params, opts)

        def recorded(carry):
            mesh = meshing.mesh_of(carry.pcache)
            torch.cuda.synchronize()
            log["peak"] = max(log["peak"], torch.cuda.max_memory_allocated())
            before = launches_now()
            fresh = pcache.cache_init(carry.state, flags, params, mesh=mesh)
            worst = []
            for got, want in zip(pcache.planes_of(carry.pcache),
                                 pcache.planes_of(fresh)):
                worst.append([float(torch.max(torch.abs(g - w)))
                              for g, w in zip(got.parts, want.parts)])
            log["planes"].append([max(c) for c in zip(*worst)])
            del fresh
            torch.cuda.synchronize()
            log["check_launches"].append(_launch_delta(before))
            torch.cuda.reset_peak_memory_stats()
            inc = {f: float(getattr(carry.obs, f)) for f in fields}
            out = refresh(carry)
            log["refresh"].append(
                (inc, {f: float(getattr(out.obs, f)) for f in fields}))
            return out
        return recorded

    chain.make_chunk_runner = make_chunk_runner
    chain.make_refresher = make_refresher

    def undo():
        chain.make_chunk_runner = orig_runner
        chain.make_refresher = orig_refresher
    return undo


def run_mesh_chain(workdir, mesh, cli_stats, card, device="cuda"):
    """Step 25b: the cavity-biased CLI flagship (``workdir`` holds
    flagship_co2.pqr) through ``runner.Simulation(cfg, mesh=mesh)`` from a
    run.in (mesh_input: 2 corrtimes of MESH_CORRTIME), the planes
    row-sharded over ``mesh``.  Gates: before each refresh the carried rd
    and coulombic within 1e-8 and polarization within 1e-5 of the
    refresh, every shard's committed planes within 1e-6 of a sharded
    rebuild; per move K1 >= 4 x n, K2 exactly n and K3 >= 2 launches, K5
    and K4 none in the whole run; the peak device memory no more than
    MESH_PEAK_REL above step 5's (``cli_stats``).  Moves/s beside step
    5's.  Then the first corrtime of the same input with no mesh under
    MPMCXX_SYM_KERNEL=0 (K1 on the whole planes): its accept sequence
    beside the mesh run's (a finding, not a gate: K1's slot split depends
    on R).  Returns (the launch counts, the run's Simulation, a record)."""
    import torch
    from mpmcxx_tpu_torch.config.parser import read_config
    from mpmcxx_tpu_torch.runner import Simulation

    with open(os.path.join(workdir, "run.in"), "w") as f:
        f.write(mesh_input())
    n = mesh.size
    log = {"chunks": [], "refresh": [], "planes": [], "check_launches": [],
           "peak": 0}
    cwd = os.getcwd()
    undo = _instrument_mesh(log)
    try:
        os.chdir(workdir)
        cfg = read_config("run.in")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        zero_launches()
        t0 = time.time()
        sim = Simulation(cfg, quiet=True, device=device, mesh=mesh)
        sim.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        os.chdir(cwd)
        undo()
    launches = launches_now()
    for c in log["check_launches"]:
        for k, v in c.items():
            launches[k] -= v
    peak_gb = max(log["peak"], torch.cuda.max_memory_allocated()) / 1e9
    A = sim.state.n_atom_slots
    parts = sim.carry.pcache.dx.parts
    _say(f"[mesh-chain] {A} slots on {n} shards of {mesh.leader}: planes "
         f"{[tuple(p.shape) for p in parts]}, {wall:.1f} s wall with "
         f"set-up")
    if A != CLI_SLOTS or [tuple(p.shape) for p in parts] != \
            [(A // n, A)] * n:
        raise AssertionError("[mesh-chain] not the flagship's shards")
    _check_refreshes("[mesh-chain]", log, (("rd_energy", 1e-8),
                                           ("coulombic_energy", 1e-8),
                                           ("polarization_energy", 1e-5)),
                     2)
    for c, worst in enumerate(log["planes"]):
        _say(f"[mesh-chain] corrtime {c + 1}: committed planes vs a sharded "
             "rebuild, largest difference per shard " +
             ", ".join(f"{w:.2e}" for w in worst) + " (tol 1e-06)")
        if not max(worst) <= 1e-6:
            raise AssertionError(f"[mesh-chain] planes off by {worst}")
    moves = sum(m for m, *_ in log["chunks"])
    chunk = {k: sum(c[3][k] for c in log["chunks"]) for k in launches}
    per_move = {k: v / moves for k, v in chunk.items()}
    steps, dt = log["chunks"][-1][:2]
    _say(f"[mesh-chain] second corrtime {steps} moves in {dt:.3f} s = "
         f"{steps / dt:.2f} moves/s (step 5 on one device: "
         f"{cli_stats['rate']:.2f}); launches per move " +
         ", ".join(f"{k} {v:.3f}" for k, v in per_move.items()) +
         f"; whole run {launches}; peak device memory {peak_gb:.2f} GB, "
         f"{peak_gb - base_gb:.2f} GB above the {base_gb:.2f} GB held before "
         f"it (step 5: {cli_stats['peak_gb']:.2f} GB, "
         f"{cli_stats['peak_gb'] - cli_stats['base_gb']:.2f} GB above "
         f"{cli_stats['base_gb']:.2f}); {card}")
    if chunk["contract_planes"] < 4 * n * moves or \
            chunk["write_plane_strips"] != n * moves or \
            chunk["occupancy"] < 2 * moves or \
            launches["contract_planes_sym"] or \
            launches["contract_planes_tri"]:
        raise AssertionError(f"[mesh-chain] launches {chunk} per {moves} "
                             f"moves, whole run {launches}")
    if not peak_gb - base_gb <= (1 + MESH_PEAK_REL) * (
            cli_stats["peak_gb"] - cli_stats["base_gb"]):
        step5 = cli_stats["peak_gb"] - cli_stats["base_gb"]
        raise AssertionError(f"[mesh-chain] peak {peak_gb - base_gb:.2f} GB "
                             f"above the run's start vs step 5's {step5:.2f}"
                             " GB")
    first = log["chunks"][0][2]

    # the same first corrtime on one device, K1 on the whole planes
    cwd = os.getcwd()
    try:
        os.chdir(workdir)
        with schedule(MPMCXX_SYM_KERNEL="0"):
            one = Simulation(read_config("run.in"), quiet=True,
                             device=device)
            _, outs = one.run_chunk(one.carry)
            torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    del one
    same_moves = torch.equal(outs.movetype, first.movetype)
    differ = int((outs.accepted != first.accepted).sum())
    _say(f"[mesh-chain] first corrtime against one device with K1 on the "
         f"whole planes: move types equal {same_moves}; {differ} of "
         f"{len(first.accepted)} accept decisions differ (not a gate: the "
         "f32 row sums of K1 split by R)")
    return launches, sim, {"rate": steps / dt,
                           "peak_gb": peak_gb - base_gb, "differ": differ,
                           "per_move": per_move}


def check_k2_row_slices(cache, device):
    """Step 25c: K2's row-slice mode on copies of the shards of a
    row-sharded cache's planes (the flagship's 3 planes, S = 3), bitwise
    against its plain version on the same slices, at window starts 0,
    inside one shard, straddling the first shard boundary and A - S, all
    valid and partly valid.  Then the main path's commit on those planes,
    one launch per shard: device time (profiler), call time (events) and
    plain time.  Returns the record."""
    import torch
    from mpmcxx_tpu_torch.ops import cuda_polar
    from mpmcxx_tpu_torch.ops.polar_cache import commit_strips

    planes = (cache.dx, cache.dy, cache.dz)
    n = len(planes[0].parts)
    A = planes[0].shape[0]
    R = A // n
    S = 3
    rng = np.random.default_rng(11)
    for start in (0, R + 1, R - 2, A - S):
        for valid in ((True, True, True), (False, True, True)):
            rows = tuple(torch.from_numpy(rng.normal(size=(S, A)).astype(
                np.float32)).to(device) for _ in planes)
            st = torch.tensor(start, device=device)
            vt = torch.tensor(valid, device=device)
            blend, cols = commit_strips(planes, rows, st, vt, -1.0)
            for d in range(n):
                r0 = planes[0].row0s[d]
                k = tuple(p.parts[d].clone() for p in planes)
                q = tuple(p.parts[d].clone() for p in planes)
                cuda_polar.write_plane_strips(k, blend, cols, st, row0=r0)
                cuda_polar.write_plane_strips_plain(q, blend, cols, st,
                                                    row0=r0)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(k, q)):
                    raise AssertionError(
                        f"K2 row slice {d} start {start} valid {valid}: "
                        "kernel differs from plain")
            _say(f"K2 write_plane_strips row slices {n} x [{R}, {A}] S={S} "
                 f"start={start} valid={valid}: bitwise equal on every "
                 f"shard{' (straddles a boundary)' if start == R - 2 else ''}")
    st = torch.tensor(R - 1, device=device)
    vt = torch.ones(S, dtype=torch.bool, device=device)
    rows = tuple(p.window_rows(st, S) for p in planes)
    blend, cols = commit_strips(planes, rows, st, vt, -1.0)

    def call():
        for d in range(n):
            cuda_polar.write_plane_strips(
                tuple(p.parts[d] for p in planes), blend, cols, st,
                row0=planes[0].row0s[d])

    def plain():
        for d in range(n):
            cuda_polar.write_plane_strips_plain(
                tuple(p.parts[d] for p in planes), blend, cols, st,
                row0=planes[0].row0s[d])
    split = {k: v for k, v in device_split(
        call, want="write_plane_strips", count=n).items()
        if "write_plane_strips" in k}
    if not split:
        raise AssertionError("the profiler saw no K2 kernel")
    rec = {"ms": sum(ms for ms, _ in split.values()),
           "call_ms": _time_ms(call), "plain_ms": _time_ms(plain),
           "bound": _bound(4 * len(planes) * S * A * 4, 0, F32_OPS_PER_S)}
    _say(f"K2 write_plane_strips row slices {n} x [{R}, {A}], 3 planes, "
         f"S={S}, a window across the first boundary ({n} launches): "
         f"device {rec['ms']:.4f} ms (profiler, "
         f"{sum(c for _, c in split.values()):.1f} kernels per commit), "
         f"call {rec['call_ms']:.4f} ms (events), plain "
         f"{rec['plain_ms']:.4f} ms, bound {rec['bound'][0]:.5f} ms "
         f"({rec['bound'][1]}; launch-bound)")
    return rec


def run_mesh_pi(workdir, mesh, moves, device="cuda"):
    """Step 25d: step 14's para-H2 PI-NVT (512 H2 x PI_H2 beads) for one
    corrtime of ``moves`` moves through PISimulation.run on ``mesh`` (the
    beads split P/n per shard) and with no mesh: positions, accept counts
    and the carried potential bitwise equal, the per-bead restart files
    written, no K1-K5 launch.  Returns (the mesh run's launch counts,
    {"rate": its moves/s, "rate_one": the one-device run's})."""
    import torch
    from mpmcxx_tpu_torch.config.parser import read_config
    from mpmcxx_tpu_torch.io.pqr import make_filename
    from mpmcxx_tpu_torch.mc import pi

    h = PI_H2
    runs = {}
    cwd = os.getcwd()
    try:
        for label, m in (("pi-mesh", mesh), ("pi-one", None)):
            os.chdir(write_pi_h2(workdir, corrtimes=1, label=label,
                                 moves=moves))
            cfg = read_config("run.in")
            cfg.total_trotter_number = h["beads"]
            sim = pi.PISimulation(cfg, quiet=True, device=device, mesh=m)
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.time()
            sim.run()
            torch.cuda.synchronize()
            runs[label] = (sim, time.time() - t0, launches_now())
            for s in range(h["beads"]):
                if not os.path.getsize(make_filename(sim.cfg.pqr_restart,
                                                     s)):
                    raise AssertionError(f"[{label}] no restart for bead {s}")
    finally:
        os.chdir(cwd)
    (sm, tm, launches), (so, to, _) = runs["pi-mesh"], runs["pi-one"]
    got, want = sm.carry, so.carry
    shapes = [p.pos.shape[0] for p in got.stack.parts]
    same = (torch.equal(pi.whole(got.stack).pos, want.stack.pos) and
            torch.equal(got.accept, want.accept) and
            torch.equal(got.potential_current, want.potential_current))
    _say(f"[mesh-pi] {h['n']} H2 x {h['beads']} beads, beads per shard "
         f"{shapes}, one corrtime of {moves} moves: {moves / tm:.2f} moves/s "
         f"with set-up on {mesh.size} shards, {moves / to:.2f} on one "
         f"device; positions, accepts and potential "
         f"{float(got.potential_current):.9f} bitwise equal: {same}; "
         f"{h['beads']} restart files each; launches {launches}")
    if not same or shapes != [h["beads"] // mesh.size] * mesh.size:
        raise AssertionError("[mesh-pi] the mesh run differs from one "
                             "device")
    if any(launches.values()):
        raise AssertionError(f"[mesh-pi] kernels launched: {launches}")
    return launches, {"rate": moves / tm, "rate_one": moves / to}


def check_replicas_on_mesh(rep_a, flags, params, opts, device="cuda"):
    """Step 25e: step 24a's REP_PAIR replicas of the CO2 builder state
    again, through ``make_replica_runner(mesh=...)`` on a REP_PAIR-shard
    mesh of ``device`` (replica r on shard r), one REP_A_MOVES-move chunk
    from the same initial carry: move types, accepts, positions, energies
    and committed planes bitwise step 24a's replicas' (``rep_a``).
    Returns the launch counts."""
    import torch
    from mpmcxx_tpu_torch.ops import polar_cache as pcache
    from mpmcxx_tpu_torch.parallel import replicas as rep

    mesh = rep.make_mesh(devices=[device] * REP_PAIR)
    reps = rep.replicate_carry(rep_a["init"], REP_PAIR, base_seed=0)
    zero_launches()
    t0 = time.time()
    reps, outs = rep.make_replica_runner(flags, params, opts, REP_A_MOVES,
                                         mesh=mesh)(reps)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = launches_now()
    for r in range(REP_PAIR):
        want, wo = rep_a["reps"][r], rep_a["outs"][r]
        same = (torch.equal(outs[r].movetype, wo.movetype) and
                torch.equal(outs[r].accepted, wo.accepted) and
                torch.equal(reps[r].state.pos, want.state.pos) and
                torch.equal(reps[r].obs.energy, want.obs.energy) and
                all(torch.equal(a, b) for a, b in zip(
                    pcache.planes_of(reps[r].pcache),
                    pcache.planes_of(want.pcache))))
        _say(f"[mesh-replicas] replica {r} on {mesh.devices[r]}: moves, "
             f"accepts, positions, energy {float(reps[r].obs.energy):.9f} "
             f"and planes bitwise step 24a's: {same}")
        if not same:
            raise AssertionError(f"[mesh-replicas] replica {r} differs")
    n = REP_PAIR * REP_A_MOVES
    _say(f"[mesh-replicas] {n / dt:.2f} moves/s for the pair; launches "
         f"{launches}")
    if launches["contract_planes_sym"] < 4 * n or \
            launches["write_plane_strips"] != n:
        raise AssertionError(f"[mesh-replicas] launches {launches}")
    return launches


def run_bench_step(card, device="cuda"):
    """Step 26: the port's bench module (mpmcxx_tpu_torch/bench.py)
    in-process at full width: ``flagship_run(m, repeats=1)`` for each of
    BENCH_MODELS under the default schedule, ``thole_solve_ms`` on the
    monatomic flagship and ``pimc_run`` with one segment of one chunk,
    every launch count 0 just before each.  Checks: each rate positive
    and finite; at each flagship's end the carried rd and coulombic
    within 1e-9 and polarization within 1e-5 (relative) of a blocked
    recompute; per flagship exactly 4 K5 launches per move plus 4 for the
    initial energy's solve and 1 K2 launch per move, no K1, K3 or K4;
    the Thole solve's K5 launches 4 per solve, and its energy on the card
    within 1e-6 relative of the same solve with contract_planes_plain on
    the same planes; the PIMC carried potential within 1e-9 relative of
    a per-bead recompute, no kernel launched.  Returns (launch counts per
    path, the measurements)."""
    import torch
    from mpmcxx_tpu_torch import bench, flagship
    from mpmcxx_tpu_torch.mc import pi
    from mpmcxx_tpu_torch.ops import cuda_polar, polar
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown_blocked

    def rate_ok(label, x):
        if not (np.isfinite(x) and x > 0):
            raise AssertionError(f"[{label}] rate {x}")

    launches, out = {}, {}
    moves = bench.CHUNK + BENCH_REPEATS * bench.MEASURE_STEPS
    for model in BENCH_MODELS:
        label = f"bench-{model}"
        zero_launches()
        rates, carry, (flags, params, _) = bench.flagship_run(
            model, repeats=BENCH_REPEATS, device=device)
        launches[label] = n = launches_now()
        for x in rates.values():
            rate_ok(label, x)
        eb = energy_breakdown_blocked(carry.state, flags, params)
        for name, full, tol in (("rd_energy", eb.rd, 1e-9),
                                ("coulombic_energy", eb.coulombic, 1e-9),
                                ("polarization_energy", eb.polarization,
                                 1e-5)):
            inc, ref = float(getattr(carry.obs, name)), float(full)
            rel, ok = _close(inc, ref, tol)
            _say(f"[{label}] carried {name} {inc:.9f} vs full {ref:.9f}: "
                 f"rel {rel:.2e} (tol {tol:g})")
            if not ok:
                raise AssertionError(f"[{label}] {name}: carried vs full "
                                     f"rel {rel}")
        want = dict({k: 0 for k in n}, contract_planes_sym=4 * moves + 4,
                    write_plane_strips=moves)
        if n != want:
            raise AssertionError(f"[{label}] launches {n}, want {want}")
        _say(f"[{label}] {moves} moves, {rates['median']:.2f} moves/s on "
             f"{card}; K5 {(n['contract_planes_sym'] - 4) / moves:.2f} and "
             f"K2 {n['write_plane_strips'] / moves:.2f} launches per move "
             "(+4 K5 for the initial energy)")
        out[model] = rates["median"]
        del carry, eb
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    state, _, flags, params, _ = flagship.build_state(device=device)
    zero_launches()
    out["thole_ms"] = bench.thole_solve_ms(state, flags, params)
    launches["bench-thole"] = n = launches_now()
    rate_ok("bench-thole", out["thole_ms"])
    want = dict({k: 0 for k in n},
                contract_planes_sym=THOLE_SOLVES * flags.polar_max_iter)
    if n != want:
        raise AssertionError(f"[bench-thole] launches {n}, want {want}")
    coeffs, E_static = polar.mixed_field_coeffs(state, flags, params)
    card_e = float(bench.thole_energy(state, flags, params, coeffs,
                                      E_static))
    plain_e = float(polar.finish_polar(
        state, flags, params, E_static,
        lambda m: cuda_polar.contract_planes_plain(
            coeffs, m, params.polar_damp)).energy)
    rel, ok = _close(card_e, plain_e, 1e-6)
    _say(f"[bench-thole] {out['thole_ms']:.3f} ms per solve on {card}; "
         f"energy {card_e:.9f} vs plain contraction {plain_e:.9f}: rel "
         f"{rel:.2e} (tol 1e-06)")
    if not ok:
        raise AssertionError(f"[bench-thole] energy vs plain rel {rel}")
    del state, coeffs, E_static
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    zero_launches()
    out["pimc"], carry, sim = bench.pimc_run(device=device, segments=1,
                                             chunks=1)
    launches["bench-pimc"] = n = launches_now()
    rate_ok("bench-pimc", out["pimc"])
    comps, _ = pi.pi_potential_per_bead(pi.whole(carry.stack), sim.flags,
                                        sim.params)
    inc, ref = float(carry.potential_current), float(comps.mean(0).sum())
    rel, ok = _close(inc, ref, 1e-9)
    _say(f"[bench-pimc] {out['pimc']:.1f} bead sweeps/s on {card}; carried "
         f"potential {inc:.9f} vs recompute {ref:.9f}: rel {rel:.2e} (tol "
         f"1e-09); launches {n}")
    if not ok or any(n.values()):
        raise AssertionError(f"[bench-pimc] rel {rel}, launches {n}")
    return launches, out


def _val_keys(rec, launches):
    """Every key of a validation study's JSON line present, its launch
    counts ``launches`` (and the line serializable)."""
    study = rec["study"]
    if rec.get("launches") != launches:
        raise AssertionError(f"[validate-{study}] the line's launches "
                             f"{rec.get('launches')}, counted {launches}")
    group = study if study in ("ptemp", "warmstart") else "means"
    missing = [k for k in VAL_KEYS["common"] + VAL_KEYS[group]
               if k not in rec]
    if group == "means":
        missing += [f"means.{q}.{k}" for q, m in rec["means"].items()
                    for k in MEAN_KEYS if k not in m]
        missing += [f"sigma.{t}" for t in rec["truths"]
                    if t not in rec["sigma"]]
    elif group == "ptemp":
        missing += [f"baths.{b['T']}.{side}.{k}" for b in rec["baths"]
                    for side in ("tempering", "independent")
                    for k in MEAN_KEYS if k not in b[side]]
        missing += [f"swap.{k}" for k in ("measured", "analytic", "sigma")
                    if k not in rec["swap"]]
    if missing or rec["verdict"] not in ("agree", "disagree"):
        raise AssertionError(f"[validate-{study}] keys missing {missing}, "
                             f"verdict {rec['verdict']!r}")
    return json.dumps(rec)


def _instrument_gibbs(log):
    """Wrap the port's Gibbs refresher (as GibbsSimulation looks it up) to
    record each box's incremental energy beside the refresh's full
    recompute.  Returns a function that undoes the wrapping."""
    from mpmcxx_tpu_torch.mc import gibbs
    orig = gibbs.make_gibbs_refresher

    def make_gibbs_refresher(*a, **kw):
        refresh = orig(*a, **kw)

        def recorded(carry):
            inc = (float(carry.energy_a), float(carry.energy_b))
            out = refresh(carry)
            log.append((inc, (float(out.energy_a), float(out.energy_b))))
            return out
        return recorded

    gibbs.make_gibbs_refresher = make_gibbs_refresher

    def undo():
        gibbs.make_gibbs_refresher = orig
    return undo


def run_validate_step(card, device="cuda"):
    """Step 27: the validation studies (``python -m
    mpmcxx_tpu_torch.validate``) in-process at wiring length, each line
    through ``validate.cli.record`` with every launch count 0 just before
    it: uvt-argon, uvt-polar, uvt-cavity and npt for VAL_CORRTIMES
    corrtimes of VAL_CORRTIME steps, gibbs-vle at 2 x 128 as long,
    ptemp's two runs of VAL_PTEMP_STEPS (swaps every VAL_PTEMP_SWAP) and
    warmstart at full width (11,264 slots) with one chunk of
    VAL_WARM_MOVES moves per variant.  Checks: every key of each JSON
    line; before each refresh the carried rd and coulombic within 1e-8
    and polarization within 1e-5 of the full recompute (uVT, NPT), each
    Gibbs box within 1e-9; each tempering replica's final energy within
    1e-9 of a recompute; each warm-start checkpoint's carried rd and
    coulombic within 1e-9 of the truth's recompute, every truth
    converged and the last one within 1e-6 (relative) of an exact CG
    solve in float64 on the same configuration; launches: uvt-polar
    exactly 4 K1 (the XLA branch of its <= 1,024-slot dense path) and 1
    K2 per move run, uvt-cavity 2 K3 per move run (grid and darts),
    warmstart K K5 per move plus K for the initial energy and 1 K2 per
    move for each variant's K (4 + 2 + 3 + 4), every other count 0.  The
    statistics are not gated: the runs are too short.  Returns (launch
    counts per path, {study: (wall s, verdict)})."""
    import torch
    from mpmcxx_tpu_torch.mc import chain
    from mpmcxx_tpu_torch.ops.energy import energy_breakdown_blocked
    from mpmcxx_tpu_torch.validate import cli, ptemp, systems, warmstart

    def args_of(study, steps, corrtime):
        return cli.parser().parse_args(
            [study, "--steps", str(steps), "--corrtime", str(corrtime),
             "--device", str(device)])

    def gate(label, n, want):
        want = dict({k: 0 for k in n}, **want)
        if n != want:
            raise AssertionError(f"[{label}] launches {n}, want {want}")

    launches, out = {}, {}
    steps = VAL_CORRTIME * VAL_CORRTIMES
    for study in ("uvt-argon", "uvt-polar", "uvt-cavity", "npt"):
        label = f"validate-{study}"
        log = {"chunks": [], "refresh": []}
        undo = _instrument_chain(log)
        t0 = time.time()
        zero_launches()
        try:
            rec = cli.record(study, args_of(study, steps, VAL_CORRTIME),
                             device, card)
        finally:
            undo()
        launches[label] = n = launches_now()
        _say(_val_keys(rec, n))
        polar = study == "uvt-polar"
        _check_refreshes(label, log, (("rd_energy", 1e-8),
                                      ("coulombic_energy", 1e-8)) +
                         ((("polarization_energy", 1e-5),) if polar
                          else ()), VAL_CORRTIMES)
        moves = sum(len(o.movetype) for _, _, o in log["chunks"])
        gate(label, n, {"uvt-polar": dict(contract_planes=4 * moves,
                                          write_plane_strips=moves),
                        "uvt-cavity": dict(occupancy=2 * moves)}.get(
                            study, {}))
        out[study] = (time.time() - t0, rec["verdict"])
        _say(f"[{label}] {moves} moves run ({steps} steps, slots "
             f"{rec.get('mol_slots')}), launches {n}; {out[study][0]:.1f} s")

    label = "validate-gibbs-vle"
    log = []
    undo = _instrument_gibbs(log)
    t0 = time.time()
    zero_launches()
    try:
        rec = cli.record("gibbs-vle", args_of("gibbs-vle", steps,
                                              VAL_CORRTIME), device, card)
    finally:
        undo()
    launches[label] = n = launches_now()
    _say(_val_keys(rec, n))
    if len(log) != VAL_CORRTIMES:
        raise AssertionError(f"[{label}] {len(log)} refreshes")
    for c, (inc, full) in enumerate(log):
        for box, got, want in zip("AB", inc, full):
            rel, ok = _close(got, want, 1e-9)
            _say(f"[{label}] corrtime {c + 1} box {box}: incremental "
                 f"{got:.9f} vs full {want:.9f}: rel {rel:.2e} (tol 1e-09)")
            if not ok:
                raise AssertionError(f"[{label}] box {box}: rel {rel}")
    gate(label, n, {})
    out["gibbs-vle"] = (time.time() - t0, rec["verdict"])

    label = "validate-ptemp"
    finals = []
    orig_chains = ptemp.run_chains

    def run_chains(*a, **kw):
        res = orig_chains(*a, **kw)
        finals.append(res[2])
        return res
    ptemp.run_chains = run_chains
    t0 = time.time()
    zero_launches()
    try:
        rec = cli.record("ptemp", args_of("ptemp", VAL_PTEMP_STEPS,
                                          VAL_PTEMP_SWAP), device, card)
    finally:
        ptemp.run_chains = orig_chains
    launches[label] = n = launches_now()
    _say(_val_keys(rec, n))
    _, flags, params, opts = systems.ptemp_system(ptemp.T_MIN, device)
    refresh = chain.make_refresher(flags, params, opts)
    for run, carries in zip(("tempering", "independent"), finals):
        for r, c in enumerate(carries):
            got = float(c.obs.energy)
            want = float(refresh(c).obs.energy)
            rel, ok = _close(got, want, 1e-9)
            _say(f"[{label}] {run} replica {r} at {float(c.temperature):.2f}"
                 f" K: carried {got:.9f} vs recompute {want:.9f}: rel "
                 f"{rel:.2e} (tol 1e-09)")
            if not ok:
                raise AssertionError(f"[{label}] replica {r}: rel {rel}")
    gate(label, n, {})
    out["ptemp"] = (time.time() - t0, rec["verdict"])

    label = "validate-warmstart"
    last = {}
    orig_variant = warmstart.run_variant

    def on_chunk(carry, fl, params, eb):
        for name, full in (("rd_energy", eb.rd),
                           ("coulombic_energy", eb.coulombic)):
            got, want = float(getattr(carry.obs, name)), float(full)
            rel, ok = _close(got, want, 1e-9)
            _say(f"[{label}] K {fl.polar_max_iter} warm "
                 f"{fl.polar_warm_start}: carried {name} {got:.9f} vs "
                 f"recompute {want:.9f}: rel {rel:.2e} (tol 1e-09)")
            if not ok:
                raise AssertionError(f"[{label}] {name}: rel {rel}")
        last.update(state=carry.state, truth=float(eb.polarization),
                    flags=fl, params=params)

    def run_variant(*a, **kw):
        return orig_variant(*a, **dict(kw, on_chunk=on_chunk))
    warmstart.run_variant = run_variant
    t0 = time.time()
    zero_launches()
    try:
        rec = cli.record("warmstart", args_of("warmstart", VAL_WARM_MOVES,
                                              VAL_WARM_MOVES), device, card)
    finally:
        warmstart.run_variant = orig_variant
    launches[label] = n = launches_now()
    _say(_val_keys(rec, n))
    if rec["truth_failed"] or rec["slots"] != VAL_WARM_SLOTS:
        raise AssertionError(f"[{label}] {rec['truth_failed']} truths "
                             f"failed; {rec['slots']} slots")
    iters = [int(name.split("-")[1]) for name in rec["variants"]]
    m = VAL_WARM_MOVES
    gate(label, n, dict(contract_planes_sym=sum(k * (m + 1) for k in iters),
                        write_plane_strips=m * len(iters)))
    cg = energy_breakdown_blocked(
        last["state"].replace(mu=last["state"].mu * 0.0),
        last["flags"].replace(polar_iterative=False, polar_mixed=False,
                              polar_warm_start=False), last["params"],
        block=warmstart.truth_block(last["state"]))
    rel, ok = _close(last["truth"], float(cg.polarization), 1e-6)
    _say(f"[{label}] converged truth {last['truth']:.9f} vs CG "
         f"{float(cg.polarization):.9f}: rel {rel:.2e} (tol 1e-06); "
         f"decision {rec['decision']}")
    if not ok:
        raise AssertionError(f"[{label}] truth vs CG rel {rel}")
    out["warmstart"] = (time.time() - t0, rec["verdict"])
    del last, cg
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches, out


def ptxas_report(log):
    """Per kernel of nvcc's build log: its registers, barriers and shared
    memory ("Used ...") and its stack and spills, named by the kernel's
    function name (and plane mode, for the templated contractions)."""
    out, name = [], "?"
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']*)'", line)
        if entry:
            k = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d)E)?", entry.group(1))
            name = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
                    if k else entry.group(1))
        elif "ptxas info" in line and "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line:
            out.append(f"{name}: {line.strip()}")
    return out


def _entry(name, source, replaces, rec, launches, **extra):
    """A kernels-line entry; ``launches`` maps each path to its count;
    ``extra`` adds keys."""
    bound_ms, bound_by = rec["bound"]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n[name] for n in launches.values()),
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, **extra}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from mpmcxx_tpu_torch import flagship
    from mpmcxx_tpu_torch import constants as const
    from mpmcxx_tpu_torch.ops import kernels
    from mpmcxx_tpu_torch.ops import polar_cache as pcache

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    _say(f"card: {card}")
    _say(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")
    t_start = time.time()

    t0 = time.time()
    path = kernels.build()
    kernels.load()
    _say(f"kernels built in {time.time() - t0:.1f} s: {path}")
    for line in ptxas_report(kernels.build_log):
        _say("  " + line)

    def flush():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    launches = {}      # path -> launch counts of its run
    rates = {}         # path -> second chunk's moves/s

    # --- 1. the CO2 flagship: K5, K2 vs plain, then its main path --------
    with schedule():
        t0 = time.time()
        state, _, flags, params, opts = flagship.build("co2", device)
        _say(f"CO2 flagship: {state.n_atom_slots} atom slots, "
             f"{int(state.aalive.sum())} live atoms ({time.time() - t0:.1f} "
             "s to build)")
        cache = pcache.cache_init(state, flags, params)
        k5 = check_k5(cache, state, flags, params, device, "CO2 flagship")
        k2 = check_k2(cache, device)
        del cache
        flush()
        launches["co2"], rates["co2"], _ = run_flagship_chain(
            "co2", state, flags, params, opts, root, card,
            "contract_planes_sym")
        del state
        flush()

    # --- 2. K3, then the cavity-biased CO2 flagship through the CLI ------
    with schedule(), tempfile.TemporaryDirectory() as workdir:
        pqr = os.path.join(workdir, "flagship_co2.pqr")
        flagship.write_pqr_co2(pqr)
        # every kernel at the shapes of the CLI run (19,712 slots)
        cli_state = cli_flagship_state(pqr, device)
        cli_cache = pcache.cache_init(cli_state, flags, params)
        k5_cli = check_k5(cli_cache, cli_state, flags, params, device,
                          "CLI flagship", modes=(3,), synthetic=False)
        k2_cli = check_k2(cli_cache, device)
        del cli_cache
        k3 = check_k3(cli_state, device)
        del cli_state
        flush()
        launches["cli"], cli_stats = run_cli_flagship(
            workdir, load_golden(root, "co2"))
    flush()

    # --- 3. the H2 flagship: K4 vs plain, then its path through K4 -------
    t0 = time.time()
    state, _, flags, params, opts = flagship.build("h2", device)
    _say(f"H2 flagship: {state.n_atom_slots} atom slots, "
         f"{int(state.aalive.sum())} live atoms ({time.time() - t0:.1f} s "
         "to build)")
    cache = pcache.cache_init(state, flags, params)
    k4 = check_k4(cache, state, flags, params, device)
    del cache
    flush()
    with schedule(MPMCXX_TRI_KERNEL="1"):
        launches["h2"], rates["h2"], _ = run_flagship_chain(
            "h2", state, flags, params, opts, root, card,
            "contract_planes_tri")
    del state
    flush()

    # --- 4. the monatomic flagship through K1 on B1's schedule -----------
    t0 = time.time()
    state, _, flags, params, opts = flagship.build("ar", device)
    _say(f"monatomic flagship: {state.n_atom_slots} atom slots, "
         f"{int(state.aalive.sum())} live atoms ({time.time() - t0:.1f} s "
         "to build)")
    cache = pcache.cache_init(state, flags, params)
    k1 = check_k1(cache, state, flags, params, device,
                  label="monatomic flagship")
    del cache
    flush()
    with schedule(MPMCXX_SYM_KERNEL="0"):
        launches["ar"], rates["ar"], _ = run_flagship_chain(
            "ar", state, flags, params, opts, root, card, "contract_planes")
    del state
    flush()

    # --- 5. the examples through the CLI; K1 at their plane sizes --------
    step_rates = {}
    with schedule(), tempfile.TemporaryDirectory() as workdir:
        sims = {}
        for name in EXAMPLE_STEPS:
            launches[name], sim, step_rates[name] = run_example(
                name, root, workdir)
            if name in POLAR_EXAMPLES:
                sims[name] = sim
        k1["max_abs_err"] = max(k1["max_abs_err"],
                                check_k1_small(sims, device))
        del sims, sim
    flush()

    # --- 6. the CO2 flagship without polarization through the CLI --------
    with schedule(), tempfile.TemporaryDirectory() as workdir:
        flagship.write_pqr_co2(os.path.join(workdir, "flagship_co2.pqr"))
        launches["co2-lj"], rates["co2-lj"] = run_cli_nopolar(
            workdir, load_golden(root, "co2"))
    flush()

    # --- 7. the monatomic flagship in NPT, with its polar cache ----------
    state, _, flags, params, opts = flagship.build("ar", device)
    npt_params = params.replace(pressure=NPT_PRESSURE)
    npt_opts = dataclasses.replace(
        opts, ensemble=const.ENSEMBLE_NPT, move_factor=SMALL_MOVE_FACTOR,
        volume_probability=NPT_VOLUME_PROBABILITY,
        volume_change_factor=NPT_VOLUME_CHANGE)
    with schedule():
        launches["ar-npt"], rates["ar-npt"], carry = run_flagship_chain(
            "ar", state, flags, npt_params, npt_opts, root, card,
            "contract_planes_sym", label="ar-npt")
        volume_ms = time_volume_move(carry, flags, npt_params, npt_opts)
    del carry, state
    flush()

    # --- 8. the monatomic flagship's float64 SCF (polar_mixed off) -------
    state, _, flags, params, opts = flagship.build("ar", device)
    with schedule():
        launches["ar-f64"], f64_ms = run_f64_scf(
            state, flags.replace(polar_mixed=False), params,
            dataclasses.replace(opts, incremental=False,
                                polar_incremental=False,
                                move_factor=SMALL_MOVE_FACTOR))
    del state
    flush()

    # --- 12. the Gibbs and PI examples through the CLI, card vs CPU ------
    t_gibbs_pi = time.time()
    with tempfile.TemporaryDirectory() as workdir:
        for name in DISPATCHED_STEPS:
            launches[name], step_rates[name] = run_dispatched_example(
                name, root, workdir)
    flush()

    # --- 13. Gibbs VLE at 2 x 256 atoms (tools/gibbs_vle.py) -------------
    with tempfile.TemporaryDirectory() as workdir:
        launches["gibbs-vle"], rates["gibbs-vle"], vle_syncs, \
            vle_launch, vle_idle = run_gibbs_vle(workdir)
    flush()

    # --- 14. PI-NVT of 512 para-H2 x 16 beads -----------------------------
    with tempfile.TemporaryDirectory() as workdir:
        launches["pi-h2"], rates["pi-h2"], pi_syncs, pi_launch, \
            pi_idle, pi_write_s = run_pi_h2(workdir)
    flush()
    _say(f"steps 12-14 (the Gibbs and PI phases) took "
         f"{time.time() - t_gibbs_pi:.1f} s")

    # --- 15. the H2 flagship at 77 K with Feynman-Hibbs order 4 ----------
    t_terms = time.time()
    state, _, flags, params, opts = flagship.build("h2", device)
    with schedule():
        launches["h2-fh4"], rates["h2-fh4"] = run_h2_fh4(
            state, flags, params, opts, root, card,
            (launches["h2"], rates["h2"]))
    del state
    flush()
    _say(f"step 15 took {time.time() - t_terms:.1f} s")

    # --- 16. the pairwise terms at 19,712 slots, one at a time -----------
    with tempfile.TemporaryDirectory() as workdir:
        launches["pairwise"], pw_rates = run_pairwise_terms(workdir)
    flush()

    # --- 17. the dense many-body terms at 512 atoms ------------------------
    t0 = time.time()
    launches["many-body"], mb_ms = run_many_body()
    flush()
    _say(f"step 17 took {time.time() - t0:.1f} s; steps 15-17 "
         f"{time.time() - t_terms:.1f} s")

    # --- 18. precision-terminated SCF, Palmo and CG on the polar cache ---
    t_scf = time.time()
    state, _, flags, params, opts = flagship.build("co2", device)
    with schedule():
        scf_launches, scf = run_scf_solvers(state, flags, params, opts, root,
                                            card)
        launches.update(scf_launches)
        flush()
        _say(f"step 18 took {time.time() - t_scf:.1f} s")

        # --- 19. plane modes 4 and 5, the no-PBC and Wolf fields ----------
        t0 = time.time()
        mode_launches, modes = run_cache_modes(state, flags, params, opts,
                                               root, card)
        launches.update(mode_launches)
    del state
    flush()
    _say(f"step 19 took {time.time() - t0:.1f} s")

    # --- 20. the small-system solvers on the dense path ------------------
    t0 = time.time()
    with schedule(), tempfile.TemporaryDirectory() as workdir:
        launches["dense-gs"], dense_ms, gs_sweep = run_dense_solvers(
            root, workdir, card)
    flush()
    _say(f"step 20 took {time.time() - t0:.1f} s; steps 18-20 "
         f"{time.time() - t_scf:.1f} s")

    # --- 21. the special moves' energies and chains, dense ---------------
    t_special = time.time()
    launches["special"], special_ms = run_special_moves(root)
    flush()
    _say(f"step 21 took {time.time() - t_special:.1f} s")

    # --- 22. the H2 flagship with spin flips and adiabatic molecules -----
    t0 = time.time()
    with schedule(), tempfile.TemporaryDirectory() as workdir:
        launches["h2-spin"], rates["h2-spin"] = run_h2_spin(workdir, card)
    flush()
    _say(f"step 22 took {time.time() - t0:.1f} s")

    # --- 23. spin flips in Gibbs and PI ----------------------------------
    t0 = time.time()
    with tempfile.TemporaryDirectory() as workdir:
        launches["gibbs-spin"], launches["pi-spin"], spin_gibbs, spin_pi = \
            run_spin_ensembles(workdir)
    flush()
    _say(f"step 23 took {time.time() - t0:.1f} s; steps 21-23 "
         f"{time.time() - t_special:.1f} s")

    # --- 24. replicas: against single chains, under tempering, the codec -
    t_rep = time.time()
    state, _, flags, params, opts = flagship.build("co2", device)
    co2_setup = (flags, params, opts)
    with schedule():
        launches["replicas-a"], rep_a = check_replicas_vs_single(
            state, flags, params, opts)
    del state
    flush()
    with schedule(), tempfile.TemporaryDirectory() as workdir:
        pqr = os.path.join(workdir, "flagship_co2.pqr")
        flagship.write_pqr_co2(pqr)
        launches["replicas"], rep = run_replica_flagship(
            workdir, launches["cli"], card)
        flush()
        codec = check_codec(pqr)
    flush()
    _say(f"step 24 took {time.time() - t_rep:.1f} s")

    # --- 25. the mesh paths on MESH_SHARDS shards of the card -------------
    from mpmcxx_tpu_torch.parallel import meshing
    t_mesh = time.time()
    flags, params, opts = co2_setup
    with schedule():
        launches["mesh-replicas"] = check_replicas_on_mesh(rep_a, flags,
                                                           params, opts)
    del rep_a
    flush()
    mesh = meshing.make_mesh(devices=["cuda:0"] * MESH_SHARDS)
    _say(f"[mesh] {mesh.size} shards: {[str(d) for d in mesh.devices]}")
    with schedule(), tempfile.TemporaryDirectory() as workdir:
        pqr = os.path.join(workdir, "flagship_co2.pqr")
        flagship.write_pqr_co2(pqr)
        launches["mesh-energy"], k1_sliced = check_sharded_energy(
            pqr, flags, params, mesh)
        flush()
        launches["mesh-chain"], sim, mesh_chain = run_mesh_chain(
            workdir, mesh, cli_stats, card)
        k2_rows = check_k2_row_slices(sim.carry.pcache, device)
        del sim
        flush()
        launches["mesh-pi"], mesh_pi = run_mesh_pi(workdir, mesh,
                                                   MESH_PI_MOVES)
    flush()
    mesh_s = time.time() - t_mesh
    _say(f"step 25 took {mesh_s:.1f} s (budget 90 s; PI on the mesh: one "
         f"corrtime of {MESH_PI_MOVES} moves each way)")

    # --- 26. the bench module in-process, one segment of each -------------
    t_bench = time.time()
    with schedule():
        bench_launches, bench_out = run_bench_step(card)
    launches.update(bench_launches)
    flush()
    bench_s = time.time() - t_bench
    _say(f"step 26 took {bench_s:.1f} s (budget 120 s)")

    # --- 27. the validation studies at wiring length ---------------------
    t_val = time.time()
    with schedule():
        val_launches, val_out = run_validate_step(card)
    launches.update(val_launches)
    flush()
    val_s = time.time() - t_val
    _say(f"step 27 took {val_s:.1f} s (budget 120 s): " + ", ".join(
        f"{s} {t:.1f} s ({v})" for s, (t, v) in val_out.items()))

    _say(f"second-chunk moves/s on {card}: " + ", ".join(
        f"{m} {r:.2f}" for m, r in rates.items()) +
        f"; examples' chunk steps/s: " + ", ".join(
            f"{m} {r:.1f}" for m, r in step_rates.items()) +
        f"; NPT volume move {volume_ms:.1f} ms; f64 SCF {f64_ms:.1f} ms "
        f"per move; Gibbs VLE {vle_syncs:.3f} syncs and {vle_launch:.1f} "
        f"launches per step, device idle {vle_idle:.1%}; PI H2 "
        f"{pi_syncs:.3f} syncs and {pi_launch:.1f} launches per move, "
        f"device idle {pi_idle:.1%}, restart writes {pi_write_s:.3f} s per "
        f"corrtime; pairwise terms (moves/s): " + ", ".join(
            f"{m} {r:.1f}" for m, r in pw_rates.items()) +
        f"; many-body terms (ms per move): " + ", ".join(
            f"{m} {r:.1f}" for m, r in mb_ms.items()) +
        f"; CO2 precision+Palmo SCF {scf['iterations'][0]:.2f} iterations "
        f"per move (max {scf['iterations'][1]:.0f}), " + ", ".join(
            f"LOOP_GROUP={g} " + "/".join(f"{x:.2f}" for x in r) +
            f" moves/s {n:.2f} syncs/move"
            for g, (r, n) in scf["groups"].items()) +
        f"; CO2 CG {scf['cg_steps'][0]:.1f} steps per solve (max "
        f"{scf['cg_steps'][1]}), {scf['cg_rate']:.2f} moves/s; plane modes: "
        + ", ".join(f"{m} (mode {md}) {r:.2f} moves/s, K5 {k:.4f} ms"
                    for m, (r, md, k) in modes.items()) +
        f"; dense ranked GS {dense_ms:.1f} ms per move, {gs_sweep} "
        f"launches per sweep; special moves (ms per move): " + ", ".join(
            f"{m} {r:.2f}" for m, r in special_ms.items()) +
        f"; Gibbs VLE with spin flips {spin_gibbs:.2f} steps/s, PI H2 with "
        f"spin flips {spin_pi:.2f} moves/s; {REP_R} tempering replicas "
        f"{rep['rate']:.2f} moves/s (per replica " + "/".join(
            f"{x:.2f}" for x in rep["rates"]) + f"), swaps {rep['swap'][0]}/"
        f"{rep['swap'][1]}, peak {rep['peak_gb']:.2f} GB, restart writes "
        + "/".join(f"{t:.3f}" for t in rep["restart_s"]) + " s per "
        f"corrtime; write_state_pqr at {CLI_SLOTS} slots (returned/on disk) "
        + ", ".join(f"{h} {a:.3f}/{b:.3f} s" for h, (a, b) in codec.items())
        + f"; mesh of {MESH_SHARDS} shards: CLI flagship "
        f"{mesh_chain['rate']:.2f} moves/s (one device {cli_stats['rate']:.2f}"
        f"), {mesh_chain['differ']} of {MESH_CORRTIME} decisions apart from "
        f"one device under MPMCXX_SYM_KERNEL=0, peak "
        f"{mesh_chain['peak_gb']:.2f} GB above the start; PI H2 "
        f"{mesh_pi['rate']:.2f} moves/s (one device "
        f"{mesh_pi['rate_one']:.2f}); step 25 {mesh_s:.1f} s"
        + f"; bench module (one segment): " + ", ".join(
            f"{m} {bench_out[m]:.2f} moves/s" for m in BENCH_MODELS)
        + f", Thole {bench_out['thole_ms']:.3f} ms per solve, PIMC "
        f"{bench_out['pimc']:.1f} bead sweeps/s; step 26 {bench_s:.1f} s"
        + f"; validation studies at wiring length {val_s:.1f} s"
        + f"; whole check "
        f"{time.time() - t_start:.1f} s after the card query")
    k5_all = dict(k5_cli, max_abs_err=max(k5["max_abs_err"],
                                          k5_cli["max_abs_err"]))
    k2_all = dict(k2_cli, max_abs_err=max(k2["max_abs_err"],
                                          k2_cli["max_abs_err"]))
    kernels_line = {"kernels": [
        _entry("contract_planes", "mpmcxx_tpu_torch/csrc/contract_planes.cu",
               "mpmcxx_tpu/ops/pallas_polar.py:39",
               dict(k1, max_abs_err=max(k1["max_abs_err"],
                                        k1_sliced["max_abs_err"])),
               launches, main_ms=k1["main_ms"],
               bound_full_planes_ms=k1["bound_full_planes_ms"],
               sliced_rows=k1_sliced["slices"],
               sliced_ms=k1_sliced["ms"],
               sliced_device_ms=k1_sliced["device_ms"],
               sliced_plain_ms=k1_sliced["plain_ms"],
               sliced_bound_ms=k1_sliced["bound"][0]),
        _entry("contract_planes_sym",
               "mpmcxx_tpu_torch/csrc/contract_planes_sym.cu",
               "mpmcxx_tpu/ops/pallas_polar.py:209", k5_all, launches,
               k1_ms_same_planes=k5_cli["k1_ms"]),
        _entry("write_plane_strips",
               "mpmcxx_tpu_torch/csrc/write_plane_strips.cu",
               "mpmcxx_tpu/ops/pallas_polar.py:134", k2_all, launches,
               call_ms=k2_all["call_ms"], row_slice_ms=k2_rows["ms"],
               row_slice_call_ms=k2_rows["call_ms"],
               row_slice_plain_ms=k2_rows["plain_ms"],
               row_slice_bound_ms=k2_rows["bound"][0]),
        _entry("occupancy", "mpmcxx_tpu_torch/csrc/occupancy.cu",
               "mpmcxx_tpu/ops/pallas_cavity.py:54", k3, launches,
               darts_ms=k3["darts_ms"]),
        _entry("contract_planes_tri",
               "mpmcxx_tpu_torch/csrc/contract_planes_tri.cu",
               "mpmcxx_tpu/ops/pallas_polar.py:369", k4, launches),
    ]}
    _say(json.dumps(kernels_line))
    _say(card)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
