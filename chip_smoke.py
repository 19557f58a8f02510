#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (justrelax_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

(``--golden LABEL`` runs one of phase 28's, 30's, 33's, 36's or 39's
goldens, or one of phase 28's moved drives, and prints its result: phases
28 and 30 start three goldens each that way, phase 33 four, phase 36 two
and phase 39 one, in processes of their own, and phase 28 its three drives;
the drives and those of phases 33, 36 and 39 start beside phase 28's.)

Run from the root of a checkout. Phases, each printing JSON lines:

0. device   : the card's name and power limit (nvidia-smi).
1. build    : nvcc builds the six Hopper kernel libraries from
              justrelax_tpu_torch/csrc, one nvcc per source, side by side
              (lines "build" for stokes_vep.cu, "build_ve" for stokes_ve.cu,
              "build_thermal" for thermal.cu, "build_ve3d" for
              stokes3d_ve.cu, "build_vep3d" for stokes3d_vep.cu, the 3D
              VEP edge passes and the fused 3D VEP chunk, and
              "build_window_copy" for window_copy.cu).
2. parity   : the VEP chunk kernel against its plain PyTorch version on the
              card, f64, n=64, nout 1 and 50, in four configurations.
3. golden   : shearband.run(n=32, nt=10, f64) through the kernel against the
              frozen f64 values of the JAX package.
4. main path: one 1024^2 f32 shearband time step through the kernel (the
              production grid), with the launch count read around it; then
              200 iterations kernel vs plain from that step's initial state
              and from a state with old stresses near yield.
5. timing   : per-iteration time of kernel and plain version at 1024^2 f32
              from both states, by CUDA events, beside the bound from the
              words those inputs need (vep_chunk_words) and bench_kernels'
              39; then the split of phase 4's wall time (the chunk calls,
              timed by CUDA events around them; the chunk-final plain
              iterations; the rest).
6. parity_ve: the VE chunk kernel against its plain version, f64, n=64,
              nout 1 and 500, in three configurations (SolCx viscous limit,
              VE compressible, elastic build-up).
7. golden_ve: SolCx (Δη 1e6 and 1), SolKz and the elastic build-up at 32²,
              f64, through the default entry points, on the JAX package's
              oracles.
8. main_path_ve: SolCx at 1024^2 f32 through the default entry point (the
              production grid of the VE solve), 20 000 iterations, with the
              launch count read around it; then 200 iterations kernel vs
              plain from its initial state.
9. timing_ve: per-iteration time of the VE kernel and its plain version at
              1024^2 f32, by CUDA events, beside the bound from the words
              its inputs need (ve_chunk_words) and bench_kernels' 23; then
              the split of phase 8's wall time.
10. parity_thermal: the thermal chunk kernel against its plain version, f64,
              n=64, nout 1 and 500, in three configurations (the set-up of
              tests/test_pallas_thermal.py with H and adiabatic; constant
              values on all four faces with shear heating; an insulated box).
11. golden_thermal: heatdiffusion_PT at 32^2 f64 through the default entry
              point against frozen f64 values of the JAX solve;
              diffusion2d.run at 32^2 f64 (plain path by contract) on its
              goldens; blankenbach.run at 32^2 f64, 10 steps, its Stokes
              solve through the VEP kernel, on its goldens.
12. main_path_thermal: heatdiffusion_PT at 1024^2 f32 through the default
              entry point (the production grid of bench_kernels.py's
              thermal2d), 20 000 iterations, with the launch count read around
              it; then 200 iterations kernel vs plain from its initial state.
13. timing_thermal: per-iteration time of the thermal kernel and its plain
              version at 1024^2 f32, by CUDA events.
14. parity_ve3d: the 3D VE chunk kernel against its plain version, f64, nout
              1 and 200: the general VE form at (22, 9, 7), the viscous form
              at 32^3 with and without the free-slip ghosts, the general form
              with dt = inf at 32^3 (its uniform canvases passed as scalars),
              and the viscous_consts route against the plain chunk on the
              viscous coefficients; then the dt = inf, general and
              no-free-slip forms on grids that do not fill B7's (y, z) tile,
              span two z tiles or split x into ranges (VE3D_RAGGED). The
              kernel derives what it computes bit for bit from eta and
              eta_tau (pack_coeffs' derive_from); the input carry is not
              written.
15. golden_ve3d: SolVi 3D at 16^3 f64 through the default entry point (B7;
              norm_Rx < 1e-8 within 5 000 iterations, the plain path's count
              beside it) and Burstedde at 16^3 f64 on the plain path (Vx
              within 5e-2, no B7 launch).
16. main_path_ve3d: SolVi 3D at 126^3 f32 (the production 3D grid of
              bench_kernels.py's ve3d) through the default entry point,
              10 000 iterations, with the launch count read around it; the
              kernel's and the plain version's time per iteration on the
              solve's own first-chunk inputs, by CUDA events (and the parent
              commit's kernel with --parent DIR), and the split of its wall
              time (set-up, kernel, the rest); then 200 iterations kernel vs
              plain from those inputs in f32 and f64.
17. timing_ve3d: per-iteration time of the 3D kernel and its plain version
              at 126^3 and 254^3 f32 (bench_kernels.py's ve3d set-up), by
              CUDA events.
18. parity_vep3d: the 3D VEP edge kernel (B6, and B9 on the hoisted
              interpolants) against its plain version, f64 and f32: one
              call, then hybrid chunks of 1 and 50 iterations (f32:
              F32_VEP3D_NOUT), in four
              configurations (the set-up of tests/test_pallas_vep3d_blocked.py
              at 10^3, plastic on and off; a non-cubic (11, 8, 6) grid with
              random state near yield, dilatancy and a tension cap;
              ShearBand3D at 10^3 with Kb = inf and old stresses near
              yield); then one call on ragged grids (VEP3D_EDGE_RAGGED) that
              leave the kernel's (y, z) tile unfilled, span two tiles and
              split x into ranges; the slots a family does not own come back
              bit-equal; with --parent DIR each call also against the parent
              commit's kernel.
19. golden_vep3d: the vep3d_hybrid configuration of bench.py at 10^3 f64
              through the default entry point (B6), on the "blocked" route
              (B8) and on the serial path, on bench.py's gates (ShearBand3D's
              n=12 goldens run as the slow cuda test
              test_shearband3d_golden_f64).
20. main_path_vep3d: ShearBand3D at 126^3 f32 (bench_kernels.py's vep3d
              grid), one time step through the default entry point (B6),
              iter_max 2 000, nout 200, with the launch counts read around
              it; B6 and its plain version timed on the solve's first-chunk
              inputs; then 200 iterations of the same step on the
              "edges_split" route (B9), its launches read around it, and B9
              timed on that route's first-chunk inputs; one f64 call of each
              on those inputs against the plain version; then ShearBand3D's
              set-up at 126^3 with stresses near yield: one call and 50
              hybrid iterations of B6 and B9 against the plain version, f64
              and f32, lambda_e > 0, and their times there. Each time comes
              with its bound (the larger of the words over the HBM peak and
              the operations, vep3d_edges_ops, over the f32 peak) and, with
              --parent DIR, the parent commit's kernel timed in turns.
21. timing_vep3d: bench_kernels.py's pallas_vep3d_edges configuration at
              126^3 f32: B6, B9 and vep3d_edges_reference per call, and the
              hybrid iteration against the plain canvas iteration per PT
              iteration, by CUDA events; T_eff and the share of each bound.
22. parity_vep3d_chunk: the fused 3D VEP chunk kernel (B8) against its
              plain version (the canvas chunk), f64 for 1 and 50 iterations
              and f32 for F32_VEP3D_NOUT, in the four configurations of
              phase 18 and a
              fifth with buoyancy and a power-law creep table; the input
              carry is not written; ShearBand3D's set-up at 37^3 (slots that
              do not fill the stress pass's tiles); then its set-up at 126^3
              near yield, f64, 1 and 50 iterations, lambda and lambda_e > 0,
              and B8's time per iteration there.
23. main_path_vep3d_blocked: the ShearBand3D 126^3 f32 step of phase 20 on
              the "blocked" route (B8), with the launch counts read around
              it, its tauII max against the default route's; B8 and its
              plain version (and the parent commit's kernel with --parent
              DIR) timed per iteration on the solve's first-chunk inputs; 50
              iterations kernel vs plain from them, f32 against f64.
24. timing_vep3d_chunk: B8 per iteration in phase 21's set-up, beside the
              hybrid and the plain canvas iteration.
25. window_copy: R, the 2D dynamic-window copy: the port's repro script
              (justrelax_tpu_torch/scripts/repro_2d_dma.py) in its three
              modes through the kernel, with the launch count read around
              it; the kernel against its plain version, bit for bit, in each
              mode, on the script's ramp and on noise; then per mode the
              kernel (ms), the plain version, the one indexing call that
              computes the same copy (library_ms) and the byte floor, one
              device-to-device copy_ of the same 2 MiB (floor_ms), each by
              the card's time per call (device_time_ms: CUDA events behind a
              torch.cuda._sleep that outlasts the host's queueing) with the
              host's wall time per call beside it (wall_ms), in turns with
              the parent commit's kernel with --parent DIR (parent_ms).
26. launches_per_iteration: the CUDA launches each kernel makes per PT
              iteration, counted by torch.profiler (run after phase 41,
              before phase 42's process group).
27. kernel_refusals: on the card, with use_kernel left to its default, a 3D
              heatdiffusion_PT and solve_vep(visc_plastic_tau=True) raise
              ValueError naming use_kernel=False.
28. golden_models: the models of the module queue through their default
              entry points, f64, at the JAX tests' sizes and on their
              assertions: the sinking block at 32^2 (B2/B3), diffusion3d at
              32^3, global convection at 32^2 over 3 steps (B1/B4), the
              thermal stresses at 48^2 over 2 steps (B5), shear heating at
              32^2 over 5 steps, 3D shear heating at 12^3 over 2 steps (B7),
              the visc_plastic_tau shear band at 32^2 over 10 steps, SolVi
              2D at 96^2 for both viscosity ratios; each with the launches
              of the kernel it routes through (> 0) and of no other.
              diffusion3d, global convection and SolVi 2D run in processes
              of their own; the thermal stresses, shear heating and the
              visc_plastic_tau band run as the slow cuda test
              test_model_golden_f64 for their time (GOLDENS_MOVED).
              moved_drives: the paths of shear heating, the visc_plastic_tau
              band and the DYREL volcano (whose goldens are slow cuda tests)
              one step each at the golden's size, f64, in processes of their
              own (the volcano's DYREL solve capped, VOLCANO_DRIVE_CAPS),
              within MOVED_DRIVE_TOL of the JAX model's values after that
              step, with no kernel launched (MOVED_DRIVES).
29. main_path_models: the new paths at production grids in f32 (PROD): the
              sinking block at 1024^2 through B2/B3 on the flagship's budget,
              the thermal stresses at 1024^2 (B5, then the plain alpha_dT
              Stokes solve), 3D shear heating at 126^3 (B7 for both Picard
              solves, the plain 3D thermal solve) and diffusion3d at 126^3
              over one step; wall time, its split by CUDA events (the
              kernel's chunk calls, each solve with its iterations, err and
              whether it stopped before its cap) and the rest.
30. golden_dyrel: DYREL (solve_dyrel: each chunk of nout DR iterations a
              CUDA graph replay) and its models through their default entry
              points, f64, at the JAX tests' sizes and on their assertions:
              the DYREL shear band at 32^2 over 10 steps and its tension-cap
              variant, the cross-solver band (its APT half through B2/B3),
              the thermal stresses at 32^2 over 2 steps (B5), the sinking
              block with its APT half (B2/B3), the power-law refresh at
              24^2, the displacement-driven band at 24^2 over 3 steps
              (B2/B3); each with the launches of the kernel it routes
              through (> 0) and of no other.
31. dyrel_graph_parity: a DR chunk's graph replay against the chunk run
              eagerly from the same mid-solve state at 64^2 f64, with and
              without the viscosity refresh, bit for bit; then
              dyrel_card_vs_cpu: solve_dyrel at 16^2 f64 on the card against
              the CPU (equal iterations, fields within 1e-10).
32. main_path_dyrel: the DYREL band at 1024^2 f32, one step, at most
              10 000 DR iterations (PROD); wall time, iterations, err, the
              graph's capture time, ms per DR iteration by CUDA events
              around the replays, and on the solve's final state the
              graphs', the chunk captured as one graph's (the capture before
              GRAPH_BLOCK) and the eager chunk's ms per iteration and the
              operations one
              eager DR iteration launches (torch.profiler), beside the bytes
              bound (dyrel_words); dyrel_per_iteration: the same at 32^2
              f64, the goldens' grid.
33. golden_particles: the particle models through their default entry
              points, f64, at the JAX tests' sizes and on their assertions:
              the rising blob at 16^3 over 3 steps and over 1 on bench.py's
              |Vz| max (B7), Van Keken at 32^2 over 100 steps (B2/B3), the
              multi-phase diffusion at 32^2 and 32^3 (plain by contract),
              Blankenbach with particle-carried T at 32^2 over 10 steps
              (B2/B3), the layered convection at 16^2 over 2 steps (Stokes
              plain by contract, thermal B5; its 3D twin at 12^3, plain by
              contract, runs as the slow cuda test
              test_layered_convection3d_golden_f64), its DYREL variant at
              32^2 over 2 steps (B5) and the
              sticky-air subduction through DYREL at 50x20 over 2 steps on
              its residual oracle; each with the launches of the kernel it
              routes through (> 0) and of no other. The two layered
              convections, Van Keken and the subduction run in processes of
              their own, started beside phase 28's and collected before
              phase 29 takes its timings.
34. particles_card_vs_cpu: every particle operation on the card against
              the CPU from the same numpy inputs, f64, at 64^2 x 24 slots and
              16^3 x 12 (particles_numpy: a divergence-free field moving
              particles across cell faces, starved and emptied cells): init,
              advection, the move (and its x-slab form, also against the
              whole-grid move on the card), injection, grid2particle and
              centroid2particle and the marker chain's advection and
              topography correction bit for bit; particle2grid,
              particle2centroid, the phase ratios and the subgrid diffusion
              within 1e-13 of each field's max (sums and scatter-adds).
35. main_path_particles: one step of Van Keken at 1024^2 (its own 40/80/20
              particles and Stokes cap, through B2/B3) and of the rising blob
              at 126^3 (8/20/4 particles, B7), f32, through the default entry
              points: wall time split by CUDA events into the Stokes solve
              (iterations, err, converged), advection, the move, injection
              and the phase ratios, the rest; the particles' draw and copy to
              the card; peak device memory; the kernel launches; the active
              particles before and after and the smallest count per cell
              after injection (>= min_xcell).
36. golden_variational: the variational solvers (each chunk's core
              iterations a CUDA graph replay) and the free-surface models
              through their default entry points, f64, at the JAX tests'
              sizes and on their assertions: phi = 1 against solve_vep at
              16^2 and against solve_ve_3d at 8^3, the sticky-air blob at
              32^2 and sphere at 12x12x16, volcano2d at 16x8 over 2 steps
              and its DYREL twin, the Rayleigh-Taylor overturn, the plume
              (plain solve_vep by contract) and the variational plume at
              32^2, Crameri's relaxation at 32^2 over 4 steps, the 2D
              subduction at 64x24 and the 3D subduction at 48x8x16 (the
              plume, Crameri, the two subductions, the overturn and the
              DYREL volcano run as the slow cuda test
              test_variational_golden_f64 for their time,
              VARIATIONAL_MOVED); each with its graph captures and replays
              by solve class and no launch of a kernel of the port. The
              volcano and the variational plume run in processes of their
              own, started beside phase 28's (whose processes wait on the
              host) and collected before phase 29 takes its timings.
37. variational_graph_parity: a variational chunk's graph replay against
              the chunk run eagerly from the same mid-solve sticky-air state,
              2D at 64^2 with and without the free-surface term and 3D at
              16^3, bit for bit; then variational_card_vs_cpu:
              solve_variational at 16^2 (both), solve_variational_3d at 8^3
              and the masked solve_vep_3d at 8^3 on the card against the CPU
              (equal iterations, fields within 1e-10).
38. main_path_variational: one f32 step of the Rayleigh-Taylor overturn at
              1024^2 (its own particles, nout and iter_min; Stokes cap
              6 000) and of the 3D subduction at 252x96x84 (Stokes cap one
              nout, 1 000) through the default entry points: wall time split
              by CUDA events into the Stokes solve (iterations, err,
              converged; the graph's capture seconds and ms per replayed
              iteration), the particle operations (2D), the thermal solve
              (3D) and the rest; on the final state the graphed and eager ms
              per variational iteration over one captured block (replay bit
              for bit against the eager iterations) and the operations one
              eager iteration launches (torch.profiler), and the eager ms per
              masked 3D VEP iteration, beside the bytes bound
              (variational_words, masked_vep3d_words); peak device memory.
39. nonuniform: every ported solver on a tanh-stretched grid
              (NonuniformGeometry) of a few hundred cells, f64, a fixed
              count of iterations, on the card against the CPU
              (nonuniform_solve: solve_ve, solve_vep, heatdiffusion_PT, the
              explicit step, solve_dyrel, solve_variational, the stretched
              Taylor-Green's solve_ve_3d, solve_vep_3d without and with
              phi, solve_variational_3d; equal iterations, fields within
              1e-12 of their max), every graphed chunk's replay against its
              eager chunk bit for bit, the refined shear band's first two
              steps at 32^2 on the analytic curve and the JAX model's frozen
              values (in a process of its own beside phase 28's; its full
              n=32 golden is the slow cuda test
              test_shearband_refined_golden_f64), and each kernel route
              asked for on a stretched grid raising ValueError naming
              use_kernel=False; no kernel launched. It takes no timing, so
              it runs while phase 28's golden processes run on.
40. main_path_nonuniform: one f32 step of the refined shear band at 1024^2
              (shearband-refined-1024-f32, plain by contract, Stokes cap
              1 000), after phase 38: wall time, ms per iteration, the
              kernels one eager iteration launches (torch.profiler), the
              bytes bound
              (vep_chunk_words plus the spacing vectors), and the uniform
              flagship's B2/B3 per iteration measured again beside it.
41. io_restart: checkpoints and restart (io/checkpoint.py) through the
              kernels, after phase 40: (a) tests/test_restart_equivalence.py's
              16^2 f64 VE loop, four steps straight against two steps, a
              checkpoint, a reload into fresh states and two more, bit for
              bit through B1/B4; (b) phase 4's 1024^2 f32 shear band state
              written and read back on the card, every field bit-equal, its
              bytes and write and read seconds, then 100 B2/B3 iterations
              from the original and from the reloaded state bit-equal; (c)
              that file read on the CPU, equal to the card's state; (d)
              subduction2d.run_particles at 48x16 (Stokes cap
              PARTICLES_RESTART_STOKES_CAP): two straight 2-step runs and a
              restart from a step-1 checkpoint, the restart and the second
              straight run each held to the first within
              PARTICLES_RESTART_TOL; (e) save_vti's seconds for the
              flagship's 1024^2 cell fields.
42. distributed: the distributed layer (justrelax_tpu_torch/parallel/),
              no kernel. Started beside phase 28's processes: (a) a world of
              one rank on NCCL, every set-up of
              dist_cases.suite_cases("card") on a mesh of ones: the sharded
              VE (SolCx and every term), thermal 2D and 3D, VEP and
              variational solves (32^2, 16^3; the VEP and the variational
              blob at 16^2), the 3D VE (free and no slip) and 3D VEP solves
              (8^3, three loading steps), DYREL (32^2, and the creeping
              band at 16^2 whose eta the DR loop refreshes, to convergence) and
              the 2D and 3D particle steps (16^2, 8^3, three steps), f64,
              each against its serial plain solve on the card with its gate
              (dist_cases.case_gate: fields within 1e-12 of their max and
              err within rel 1e-6; DYREL 1e-12 absolute and err 1e-10;
              particles' rows within 1e-13 and equal occupancy); (b) four
              rank processes on this card over gloo, two "hosts" of two
              (LOCAL_RANK, GROUP_RANK), each batch of halo slabs staged
              through host memory: every case on dist_cases.CARD_MESHES
              ((2, 2), (2, 2, 1)) on the card and on the CPU against the
              serial solve there, overlap bit-equal to no overlap, and SolCx
              on the multi-host mesh; the ranks wait for the card by
              blocking there (dist_cases.wait_by_blocking); the kinds not in
              dist_cases.CPU_TWIN_KINDS run on the card only (their CPU runs
              are the CPU tests'). After phase 41, each with the card to
              itself and CUDA's default wait: (c) the production cells on the four ranks, then on the world of one,
              then their serial plain solves in this process: the
              flagship's shear band at 1024^2 f32, 500 fixed iterations
              (2x2 tiles, and the world of one); ShearBand3D at 126^3 f32,
              100 fixed iterations (2x2x1 tiles, and the world of one);
              shearband-dyrel's 1024^2 f32 solve, 200 DR iterations (2x2,
              eager); one advect + move step of 83.9 M particle slots at
              1024^2 f32 (Van Keken's density; 2x2): ms per iteration (per
              step), the part of it in the halo functions (CUDA events),
              halo bytes and batches per iteration against the tile's
              bytes, P against the serial solve's within TOL_F32_1024
              (DYREL: P after the first chunk, the final residual norms
              within DYREL_NORM_RATIO of the serial's; the particles: every
              particle kept, and the cells whose occupancy differs
              counted). Every kernel's count stays 0, in this
              process and in each rank.

Bounds are the bytes an iteration must move over the HBM peak, counted from
the run's own inputs (hopper_stokes_vep.vep_chunk_words and
hopper_stokes.ve_chunk_words for the 2D chunks, ve3d_words for the 3D VE
kernel, vep3d_edges_words for the edge kernel, with its operations over the
f32 peak beside them (vep3d_edges_ops), vep3d_chunk_words for the
fused 3D VEP chunk; R: its 2 MiB read and 2 MiB written).

Then the script's seconds (the line "elapsed"), the kernels line (each
entry with its launches on the main path it
was first ported for, and launches_models: its launches in phases 28-42),
and last {"ok": true, "device": {...}}. Any failure
raises and exits non-zero; with no CUDA device it exits non-zero before
printing any result. With --parent DIR (a parent commit's
justrelax_tpu_torch/ops and csrc, e.g. from git archive) the redesigned
kernels' lines also give the parent's time on the same inputs (parent_ms);
without it parent_ms is null.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from justrelax_tpu_torch.core.grid import Geometry, NonuniformGeometry  # noqa: E402
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs, PTThermalCoeffs  # noqa: E402
from justrelax_tpu_torch.core.state import StokesState, ThermalState  # noqa: E402
from justrelax_tpu_torch.models import (  # noqa: E402
    blankenbach,
    burstedde,
    diffusion2d,
    diffusion2d_multiphase,
    diffusion3d,
    elastic_buildup,
    global_convection2d,
    layered_convection3d,
    layered_convection_dyrel,
    layered_convection_nondim,
    rising_blob3d,
    shearband,
    shearband_dyrel,
    shearheating,
    shearheating3d,
    sinking_block,
    solcx,
    solkz,
    shearband3d,
    solvi2d,
    solvi3d,
    subduction2d_dyrel,
    thermal_stresses,
    thermal_stresses_dyrel,
    vankeken,
)
from justrelax_tpu_torch.models import (  # noqa: E402
    crameri2d,
    rayleigh_taylor,
    shearband_refined,
    subduction2d,
    subduction3d,
    volcano2d,
    volcano2d_dyrel,
)
from justrelax_tpu_torch.models.shearband import _circle_phase_ratios  # noqa: E402
from justrelax_tpu_torch.ops import _cuda_build  # noqa: E402
from justrelax_tpu_torch.ops import hopper_stokes as hs  # noqa: E402
from justrelax_tpu_torch.ops import hopper_stokes3d as h3  # noqa: E402
from justrelax_tpu_torch.ops import hopper_stokes3d_vep as hc  # noqa: E402
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv  # noqa: E402
from justrelax_tpu_torch.ops import hopper_thermal as ht  # noqa: E402
from justrelax_tpu_torch.ops import hopper_vep3d_edges as he  # noqa: E402
from justrelax_tpu_torch.ops import hopper_window_copy as hw  # noqa: E402
from justrelax_tpu_torch.ops.bc import (  # noqa: E402
    Faces,
    TemperatureBoundaryConditions,
    VelocityBoundaryConditions,
    flow_bcs,
    pureshear_bc,
    thermal_bcs,
)
from justrelax_tpu_torch.io.checkpoint import checkpointing, load_checkpoint  # noqa: E402
from justrelax_tpu_torch.io.vtk import save_vti  # noqa: E402
from justrelax_tpu_torch.solvers import dyrel as solver_dyrel  # noqa: E402
from justrelax_tpu_torch.solvers import stokes2d as solver_ve  # noqa: E402
from justrelax_tpu_torch.solvers import stokes2d_vep as solver_vep  # noqa: E402
from justrelax_tpu_torch.solvers import stokes3d as solver_ve3d  # noqa: E402
from justrelax_tpu_torch.solvers import thermal as solver_thermal  # noqa: E402
from justrelax_tpu_torch.solvers.stokes3d import kernel_chunk_inputs  # noqa: E402
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT  # noqa: E402
from justrelax_tpu_torch.ops.stencil import av_vertex_to_center, expand_edges, maxloc  # noqa: E402
from justrelax_tpu_torch.ops.stokes import spacing_families_2d  # noqa: E402
from justrelax_tpu_torch.ops.stokes3d_canvas import pack_carry, ve3d_canvas_coefficients  # noqa: E402
from justrelax_tpu_torch.ops.stokes3d_vep_canvas import (  # noqa: E402
    VEP3DCanvasCarry,
    edge_masks,
    pack_vep_carry,
    vep3d_canvas_consts,
    vep3d_chunk_canvas,
)
from justrelax_tpu_torch.ops.rock_ratio import (  # noqa: E402
    RockRatio,
    update_rock_ratio,
    update_rock_ratio_3d,
)
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field  # noqa: E402
from justrelax_tpu_torch.solvers.graphed_chunk import GRAPH_BLOCK, GraphedChunk  # noqa: E402
from justrelax_tpu_torch.solvers.stokes3d_vep import canvas_chunk_inputs, solve_vep_3d  # noqa: E402
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack  # noqa: E402
from justrelax_tpu_torch.rheology.viscosity import phase_viscosity  # noqa: E402
from justrelax_tpu_torch.scripts import repro_2d_dma  # noqa: E402
import dist_cases as dc  # noqa: E402

FIELDS = ("Vx", "Vy", "theta", "P", "txx", "tyy", "txy_c", "txy_v", "eta",
          "eta_v", "lam", "lam_v")
TOL_NOUT1 = 1e-12  # rounding only (differences as rel_diffs defines them)
TOL_NOUT50 = 2e-6  # yield-branch flips of cells on the yield surface
# f32, 200 iterations: 1e-4, or twice the plain version's own f32 error
# against its f64 result where rounding grows larger than that (near yield)
TOL_F32_1024 = 1e-4
HBM_PEAK = {"PCIe": 2.0e12, "SXM": 3.35e12}  # B/s, NVIDIA data sheets
VE_FIELDS = ("Vx", "Vy", "P", "txx", "tyy", "txy")
VE_CASES = ("solcx", "ve_compressible", "elastic_buildup")
TOL_VE_NOUT1 = 1e-12  # rounding only (differences as rel_diffs_ve defines them)
TOL_VE_NOUT500 = 1e-10
# words per cell and PT iteration in the repo's accounting
# (justrelax_tpu/utils/bench_kernels.py: vep2d 39, ve2d 23)
WORDS_VEP, WORDS_VE = 39, 23
VE3D_FIELDS = ("Vx", "Vy", "Vz", "P", "txx", "tyy", "tzz", "tyz", "txz", "txy")
VE3D_CASES = ("ve_general", "viscous", "viscous_no_free_slip", "ve_dt_inf")
# grids that do not fill B7's (y, z) tile, one that spans two z tiles, and
# one x extent that the wrapper splits into ranges
VE3D_RAGGED = ((5, 4, 3), (11, 8, 6), (4, 10, 35), (3, 5, 70), (130, 9, 37))
TOL_VE3D_NOUT1 = 1e-13  # rounding only (differences as rel_diffs_ve3d defines them)
TOL_VE3D_NOUT200 = 1e-10
TH_FIELDS = ("T", "qx", "qy")
TH_CASES = ("pallas_setup", "dirichlet_box", "insulated")
TOL_TH_NOUT1 = 1e-12  # rounding only (differences as rel_diffs_th defines them)
TOL_TH_NOUT500 = 1e-10
# Thermal: the compulsory traffic of one chunk iteration, 12 words per cell
# (T, qx, qy read and written; six chunk-invariant cell inputs read once);
# bench_kernels.py's thermal2d counts 16, q2x/q2y included, which the chunk
# does not carry
WORDS_TH, WORDS_TH_BENCH = 12, 16
# heatdiffusion_PT on the 32^2 set-up of tests/test_pallas_thermal.py, frozen
# from the JAX package in float64 on the CPU (x64): its heatdiffusion_PT on
# test_pallas_thermal._setup(32) with PTThermalCoeffs.make(K, rc, 0.3, di, li),
# K=K, rho_Cp=rc, iter_max=4000, nout=200, printing info.iters, info.err,
# T[17, 17], T[1, 1] and T[32, 32]. This command reruns that solve and holds
# these values to it:
#   python -m pytest tests/test_torch_thermal.py -k golden_thermal_constants
GOLDEN_THERMAL = {"iters": 400, "err": 1.1513363166971779e-09,
                  "T_centre": 0.4813572752812458, "T_corner_lo": 0.9840796475262239,
                  "T_corner_hi": 0.016517392162716873}
URMS0_F64 = 0.29207194481326537  # blankenbach 32^2 f64 after one step (bench.py)
VEP3D_CASES = ("blocked_plastic", "blocked_elastic", "noncubic_near_yield",
               "shearband3d_kb_inf")
VEP3D_CHUNK_CASES = VEP3D_CASES + ("buoyant_powerlaw",)
# grids of "noncubic_near_yield" for the edge kernel: they leave its 4 x 32
# (y, z) tile unfilled, span two or more y and z tiles, and give x ranges
# of one or two planes on a card of 132 SMs
VEP3D_EDGE_RAGGED = ((5, 4, 3), (3, 9, 33), (9, 5, 4), (130, 9, 37))
VEP3D_EDGE_FIELDS = ("tyz", "txz", "txy", "lam_yz", "lam_xz", "lam_xy")
VEP3D_CARRY_FIELDS = ("Vx", "Vy", "Vz", "P", "theta", "txx", "tyy", "tzz", "tyz_c", "txz_c",
                      "txy_c", "tyz", "txz", "txy", "eta", "lam", "lam_yz", "lam_xz", "lam_xy")
TOL_VEP3D_CALL = 1e-12    # rounding only (one call, and a hybrid chunk of one iteration)
TOL_VEP3D_NOUT50 = 2e-6   # yield-branch flips of edges on the yield surface
# the 3D VEP f32 checks of phases 18 and 22 (kernel f32 against plain f32,
# within 1e-4 or twice the plain f32's own error against f64) run this many
# iterations (50 until the distributed phase needed the script's time; the
# f64 checks keep 50, with plasticity engaged)
F32_VEP3D_NOUT = 20
# the 3D VEP iteration's words per cell (bench_kernels.py::vep3d: 36 unknown,
# 13 write-only, 22 read-only)
WORDS_VEP3D = 71
# bench.py's vep3d_hybrid golden: max τII of the frozen CPU/f64 solve
GOLDEN_VEP3D_HYBRID = 0.16069082924126105


T_LOADED = time.perf_counter()


def emit(phase, **kw):
    """One JSON line: the phase, ``at`` (its seconds since the script was
    loaded, from which each phase's seconds are read) and ``kw``."""
    print(json.dumps({"phase": phase, "at": time.perf_counter() - T_LOADED, **kw}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel_diffs(a, b):
    """max |a − b| per field relative to the field's max |b| (b the plain
    version), the max floored at 1: the configurations are non-dimensional
    with O(1) fields, and a field that is zero up to rounding (θ under pure
    shear) has no relative error."""
    return {name: float((x - y).abs().max()) / max(float(y.abs().max()), 1.0)
            for name, x, y in zip(FIELDS, a, b)}


def to_f64(x):
    """A chunk argument in float64 (tensors, tuples of them and the material
    stack)."""
    if isinstance(x, torch.Tensor):
        return x.double()
    if isinstance(x, MaterialStack):
        return x.to(dtype=torch.float64)
    if isinstance(x, tuple):
        return tuple(map(to_f64, x))
    return x


def _rel_no_floor(names, a, b):
    out = {}
    for name, x, y in zip(names, a, b):
        d, m = float((x - y).abs().max()), float(y.abs().max())
        out[name] = 0.0 if d == 0.0 else (d / m if m > 0.0 else math.inf)
    return out


def rel_diffs_ve(a, b):
    """max |a − b| per VE field relative to the field's max |b| (b the plain
    version), with no floor: SolCx velocities are far below 1. A field that
    is zero in both has no difference."""
    return _rel_no_floor(VE_FIELDS, a, b)


def rel_diffs_ve3d(a, b):
    """max |a − b| per 3D VE canvas relative to the canvas's max |b| (b the
    plain version), with no floor."""
    return _rel_no_floor(VE3D_FIELDS, a, b)


def rel_diffs_th(a, b):
    """max |a − b| of T, qx and qy relative to the field's max |b| (b the
    plain version), with no floor: the 1024^2 fluxes are far below 1."""
    return _rel_no_floor(TH_FIELDS, a, b)


def f32_gaps(kernel, reference, rel, args, kw, nout):
    """Kernel against plain in f32, and both against the plain version in
    f64 on the same inputs: how far the kernel is from the plain version,
    and how far f32 rounding alone takes the plain version. Returns (gap per
    field, max gap, kernel vs f64, plain vs f64, the plain f32 result)."""
    out = kernel(*args, nout=nout, **kw)
    ref = reference(*args, nout=nout, **kw)
    ref64 = reference(*map(to_f64, args), nout=nout, **{k: to_f64(v) for k, v in kw.items()})
    gap = rel(out, ref)
    return gap, max(gap.values()), max(rel(out, ref64).values()), \
        max(rel(ref, ref64).values()), ref


def abs_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


# ---- the four configurations of the parity phase ---------------------------
def chunk_case(name, n, dtype, dev):
    """Inputs of one chunk call: (args, kwargs). Shear band class with old
    stresses near yield so that the return mapping is active."""
    kw = dict(dtype=dtype, device=dev)
    C = 1.6 / math.cos(math.radians(30.0))
    geometry = Geometry((n, n), (1.0, 1.0))
    xci, xvi = geometry.xci, geometry.xvi
    pr_c = torch.as_tensor(_circle_phase_ratios(xci[0], xci[1], (0.5, 0.5), 0.1), **kw)
    pr_v = torch.as_tensor(_circle_phase_ratios(xvi[0], xvi[1], (0.5, 0.5), 0.1), **kw)
    bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True))
    T = T_v = None
    P_init = 0.0
    dt, cutoff, relax = 0.25, (1e-3, 1e3), 0.5
    plastic = dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0, C=C, friction_angle=30.0)
    if name == "shearband":
        mats = [Material(G=1.0, eta_reg=8e-3, **plastic), Material(G=0.5, eta_reg=8e-3, **plastic)]
    elif name == "dpcap":
        common = dict(plastic, dilation_angle=3.0, eta_reg=1e-3, tension_pT=-0.5)
        mats = [Material(G=1.0, **common), Material(G=0.5, **common)]
        P_init = -0.2  # tension side, where the cap is below the cone
    elif name == "powerlaw_noslip":
        common = dict(plastic, dilation_angle=10.0, eta_reg=1e-2)
        mats = [Material(G=1.0, disl_A=0.4, disl_n=3.0, disl_E=1.0e3, **common),
                Material(G=0.5, diff_A=0.3, diff_m=1.0, grain_size=0.5, diff_E=5.0e2, **common)]
        bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True),
                                        no_slip=Faces(top=True, bot=True))
        xc = torch.as_tensor(xci[0], **kw)
        T = 300.0 + 50.0 * torch.sin(2.0 * math.pi * xc[:, None]) * torch.ones((1, n), **kw)
        T_v = av_vertex_to_center(expand_edges(T))
    elif name == "buoyancy":
        geometry = Geometry((n, n), (1.0, 1.0), origin=(0.0, -1.0))
        mats = [Material(rho0=1.0, T0=0.0, alpha=0.5, beta=0.0, G=1.0, eta0=1.0, gravity=1.0)]
        pr_c = pr_v = None
        xc = torch.as_tensor(geometry.xci[0], **kw)
        yc = torch.as_tensor(geometry.xci[1], **kw)
        T = torch.exp(-(((xc[:, None] - 0.5) ** 2 + (yc[None, :] + 0.6) ** 2) / 0.02))
        dt, cutoff, relax = math.inf, (-math.inf, math.inf), 1e-2
    else:
        raise ValueError(name)
    material = MaterialStack.make(mats, **kw)
    zc = torch.zeros((n, n), **kw)
    zv = torch.zeros((n + 1, n + 1), **kw)
    if name == "buoyancy":
        Vx = torch.zeros((n + 1, n + 2), **kw)
        Vy = torch.zeros((n + 2, n + 1), **kw)
        tau_o = (zc, zc, zc, zv)
        eta, eta_v = torch.ones_like(zc), torch.ones_like(zv)
        EII = zc
    else:
        xv = torch.as_tensor(xvi[0], **kw)
        yv = torch.as_tensor(xvi[1], **kw)
        Vx, Vy = flow_bcs((xv[:, None].expand(n + 1, n + 2),
                           (-yv)[None, :].expand(n + 2, n + 1)), bc)
        tau_o = (zc + 1.6, zc - 1.6, zc + 1.0, zv + 1.0)
        eta = phase_viscosity(material, torch.ones_like(zc), T, pr_c, "tau") * 1.1
        eta_v = phase_viscosity(material, torch.ones_like(zv), T_v, pr_v, "tau") * 1.1
        EII = zc + 0.001
    P = zc + P_init
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.75 / math.sqrt(2.1))
    args = (Vx, Vy, P, P, *tau_o, eta, eta_v, zc, zv,
            P, zc, *tau_o, EII, material, pr_c, pr_v, T,
            dt, 1.0 / geometry.di[0], 1.0 / geometry.di[1], pt.r, pt.theta_dtau,
            pt.etadtau, 0.2, relax, cutoff)
    return args, dict(flow_bc=bc, T_v=T_v)


# ---- the three configurations of the VE parity phase ----------------------
def ve_case(name, n, dtype, dev):
    """Inputs of one ``stokes_chunk`` call: (args, kwargs), from a numpy
    seed. Every carried field is non-trivial after one iteration."""
    rng = np.random.default_rng(3)
    kw = dict(dtype=dtype, device=dev)
    c, v = (n, n), (n + 1, n + 1)

    def rand(shape, scale, offset=0.0):
        return torch.as_tensor(offset + scale * rng.standard_normal(shape), **kw)

    if name == "solcx":  # viscous limit, smoothed Δη = 1e6, from a random state
        geometry, st, pt, _, rho_g, G, K, _ = solcx._setup(n, n, 1e6, 1.0, 1.0, dtype, dev)
        eta = st.viscosity.eta
        carry = (rand((n + 1, n + 2), 1e-3), rand((n + 2, n + 1), 1e-3),
                 rand(c, 0.1), rand(c, 0.1), rand(c, 0.1), rand(v, 0.1))
        phys = dict(G=G, K=K, dt=0.1)
    elif name == "ve_compressible":  # the set-up of tests/test_pallas.py:104-140
        geometry = Geometry(c, (1.0, 1.0))
        pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1))
        eta = torch.as_tensor(np.exp(rng.uniform(0.0, 2.0, c)), **kw)
        rho_g = (rand(c, 0.3), rand(c, 0.2, 1.0))
        carry = (torch.zeros((n + 1, n + 2), **kw), torch.zeros((n + 2, n + 1), **kw),
                 *(torch.zeros(c, **kw) for _ in range(3)), torch.zeros(v, **kw))
        phys = dict(G=torch.full(c, 4.0, **kw), K=torch.full(c, 9.0, **kw),
                    P0=rand(c, 0.1), Q=rand(c, 0.05),
                    tau_o=(rand(c, 0.1), rand(c, 0.1), rand(v, 0.1)), dt=0.5)
    elif name == "elastic_buildup":  # pure-shear boundary velocities, G finite, K = ∞
        geometry, st, pt, _, rho_g, G, K = elastic_buildup._setup(
            n, n, 100.0e3, 100.0e3, 1.0e21, 1.0e-14, 10.0e9, dtype, dev)
        eta = st.viscosity.eta
        Vx, Vy = st.V.Vx.clone(), st.V.Vy.clone()
        Vx[1:-1, 1:-1] += rand((n - 1, n), 1e-12)  # interior only: the normal
        Vy[1:-1, 1:-1] += rand((n, n - 1), 1e-12)  # boundary faces keep pure shear
        tau_o = (rand(c, 1e6), rand(c, 1e6), rand(v, 1e6))
        carry = (Vx, Vy, torch.zeros(c, **kw), *tau_o)
        phys = dict(G=G, K=K, tau_o=tau_o, dt=0.05 * elastic_buildup.KYR)
    else:
        raise ValueError(name)
    args = carry + (eta, maxloc(eta, 1), *rho_g, 1.0 / geometry.di[0],
                    1.0 / geometry.di[1], pt.r, pt.theta_dtau, pt.etadtau)
    return args, phys


# ---- random states on any grid, for the tiled 2D chunk kernels -------------
FACE_NAMES = ("left", "right", "bot", "top")
FACE_MODES = tuple(itertools.product(("free_slip", "no_slip"), repeat=4))


def vep_random_case(ni, modes, dtype, dev, vary=True, seed=0):
    """Inputs of one ``stokes_vep_chunk`` call on an ``(nx, ny)`` grid from
    a numpy seed: (args, kwargs). The state is random, ghosts included, with
    stresses around the yield stress; ``modes`` gives the faces (left,
    right, bot, top), each "free_slip" or "no_slip". ``vary`` draws a second
    phase with other moduli, plastic parameters (a tension cap among them)
    and creep, and random old stresses and plastic strain, so every slot
    family varies; otherwise both phases are one material and the old
    stresses are uniform, so nearly every slot is a scalar."""
    nx, ny = ni
    rng = np.random.default_rng(seed)
    kw = dict(dtype=dtype, device=dev)
    geometry = Geometry(ni, (1.0, ny / nx))
    xci, xvi = geometry.xci, geometry.xvi
    origin, radius = (0.5, 0.5 * ny / nx), 0.3 * min(1.0, ny / nx)
    pr_c = torch.as_tensor(_circle_phase_ratios(xci[0], xci[1], origin, radius), **kw)
    pr_v = torch.as_tensor(_circle_phase_ratios(xvi[0], xvi[1], origin, radius), **kw)
    C = 1.6 / math.cos(math.radians(30.0))
    base = dict(rho0=0.0, Kb=4.0, eta0=1.0, G=1.0, is_plastic=1.0, C=C,
                friction_angle=30.0, eta_reg=8e-3)
    other = (dict(base, G=0.5, Kb=3.0, eta0=2.0, C=0.8 * C, friction_angle=25.0,
                  dilation_angle=5.0, eta_reg=1e-2, tension_pT=-0.5) if vary else base)
    material = MaterialStack.make([Material(**base), Material(**other)], **kw)
    c, v = (nx, ny), (nx + 1, ny + 1)

    def r(shape, scale, mean=0.0):
        return torch.as_tensor(mean + scale * rng.standard_normal(shape), **kw)

    Vx, Vy = r((nx + 1, ny + 2), 1.0), r((nx + 2, ny + 1), 1.0)
    tau = (r(c, 0.3, 1.6), r(c, 0.3, -1.6), r(c, 0.3, 1.0), r(v, 0.3, 1.0))
    zc, zv = torch.zeros(c, **kw), torch.zeros(v, **kw)
    tau_o = ((r(c, 0.3, 1.6), r(c, 0.3, -1.6), r(c, 0.3, 1.0), r(v, 0.3, 1.0)) if vary
             else (zc + 1.6, zc - 1.6, zc + 1.0, zv + 1.0))
    eta = torch.exp(r(c, 0.2))
    eta_v = torch.exp(r(v, 0.2))
    lam, lam_v = r(c, 0.01).abs(), r(v, 0.01).abs()
    P = r(c, 0.3)
    EII = r(c, 1e-3).abs() if vary else zc + 1e-3
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.75 / math.sqrt(2.1))
    bc = VelocityBoundaryConditions(
        free_slip=Faces(**{f: m == "free_slip" for f, m in zip(FACE_NAMES, modes)}),
        no_slip=Faces(**{f: m == "no_slip" for f, m in zip(FACE_NAMES, modes)}))
    args = (Vx, Vy, P, P, *tau, eta, eta_v, lam, lam_v,
            P, zc, *tau_o, EII, material, pr_c, pr_v, None,
            0.25, 1.0 / geometry.di[0], 1.0 / geometry.di[1], pt.r, pt.theta_dtau,
            pt.etadtau, 0.2, 0.5, (1e-3, 1e3))
    return args, dict(flow_bc=bc)


def ve_random_case(ni, dtype, dev, vary=True, seed=0):
    """Inputs of one ``stokes_chunk`` call on an ``(nx, ny)`` grid from a
    numpy seed: (args, physics), a random state with ghosts. ``vary`` draws
    every input at random (G, K, P0, Q, the old stresses, ρg) with an η_τ
    that is not maxloc(η), so the kernel reads it; otherwise η is uniform,
    η_τ = maxloc(η) and the physics is the viscous limit (G = K = ∞), so
    every slot is a scalar or derived."""
    nx, ny = ni
    rng = np.random.default_rng(seed)
    kw = dict(dtype=dtype, device=dev)
    c, v = (nx, ny), (nx + 1, ny + 1)

    def r(shape, scale, mean=0.0):
        return torch.as_tensor(mean + scale * rng.standard_normal(shape), **kw)

    geometry = Geometry(ni, (1.0, ny / nx))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1))
    carry = (r((nx + 1, ny + 2), 1.0), r((nx + 2, ny + 1), 1.0),
             r(c, 0.1), r(c, 0.1), r(c, 0.1), r(v, 0.1))
    if vary:
        eta = torch.exp(r(c, 0.5))
        eta_tau = maxloc(eta, 1) * 1.25
        rho_g = (r(c, 0.3), r(c, 0.2, 1.0))
        phys = dict(G=torch.exp(r(c, 0.1, 1.0)), K=torch.exp(r(c, 0.1, 2.0)),
                    P0=r(c, 0.1), Q=r(c, 0.05),
                    tau_o=(r(c, 0.1), r(c, 0.1), r(v, 0.1)), dt=0.5)
    else:
        eta = torch.full(c, 2.0, **kw)
        eta_tau = maxloc(eta, 1)
        rho_g = (torch.zeros(c, **kw), torch.ones(c, **kw))
        phys = {}
    args = carry + (eta, eta_tau, *rho_g, 1.0 / geometry.di[0], 1.0 / geometry.di[1],
                    pt.r, pt.theta_dtau, pt.etadtau)
    return args, phys


# ---- the three configurations of the 3D VE parity phase --------------------
def ve3d_numpy(name, ni):
    """numpy inputs of one 3D chunk call at ``ni`` cells, from a seed:
    (the 10 staggered fields, (η, fx, fy, fz), the VE physics, the lengths,
    free_slip). "ve_general" is the set-up of
    tests/test_pallas3d_blocked.py:52-73 (seeds 4 and 7: G, K, P0, Q, τ_o
    and dt = 0.5, the general coefficient form); "viscous" and
    "viscous_no_free_slip" draw the state from seeds 5 and 6 and take the
    viscous form (G = None), the second without the free-slip ghosts;
    "ve_dt_inf" draws the state from seed 8 and the physics of "ve_general"
    with dt = ∞, where 12 of the general form's canvases are uniform and
    the kernel takes them as scalars or leaves them out."""
    nx, ny, nz = ni
    seed = {"ve_general": 4, "viscous": 5, "viscous_no_free_slip": 6, "ve_dt_inf": 8}[name]
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape)

    fields = (r(nx + 1, ny + 2, nz + 2), r(nx + 2, ny + 1, nz + 2), r(nx + 2, ny + 2, nz + 1),
              r(*ni), r(*ni), r(*ni), r(*ni),
              r(nx, ny + 1, nz + 1), r(nx + 1, ny, nz + 1), r(nx + 1, ny + 1, nz))
    consts = (np.exp(0.5 * r(*ni)), r(*ni), r(*ni), r(*ni))
    phys = {}
    if name in ("ve_general", "ve_dt_inf"):
        rng2 = np.random.default_rng(7)

        def r2(*shape):
            return rng2.standard_normal(shape) * 0.1

        phys = dict(G=np.exp(r2(*ni) + 1.0), K=np.exp(r2(*ni) + 2.0), P0=r2(*ni), Q=r2(*ni),
                    tau_o=(r2(*ni), r2(*ni), r2(*ni), r2(nx, ny + 1, nz + 1),
                           r2(nx + 1, ny, nz + 1), r2(nx + 1, ny + 1, nz)),
                    dt=0.5 if name == "ve_general" else math.inf)
    return fields, consts, phys, (1.0, 1.3, 0.8), name != "viscous_no_free_slip"


def ve3d_case(name, ni, dtype, dev):
    """Inputs of one ``stokes3d_chunk`` call from :func:`ve3d_numpy`:
    (carry, co, inv_di, free_slip, (viscous_consts, pt_scalars)), the last
    the ``viscous_consts`` route's inputs for the same η and f."""
    fields, consts, phys, li, free_slip = ve3d_numpy(name, ni)

    def t(a):
        if isinstance(a, tuple):
            return tuple(map(t, a))
        return torch.as_tensor(a, dtype=dtype, device=dev) if isinstance(a, np.ndarray) else a

    geometry = Geometry(ni, li)
    pt = PTStokesCoeffs.make(li, geometry.di, CFL=0.9 / math.sqrt(3.1))
    eta, fx, fy, fz = t(consts)
    eta_tau = maxloc(eta, 1)
    co = ve3d_canvas_coefficients(eta, eta_tau, pt.r, pt.theta_dtau, pt.etadtau,
                                  fx=fx, fy=fy, fz=fz, **{k: t(v) for k, v in phys.items()})
    derive = ((eta, eta_tau, fx, fy, fz), (pt.r / pt.theta_dtau, pt.theta_dtau, pt.etadtau))
    return (tuple(pack_carry(*t(fields))), co, tuple(1.0 / d for d in geometry.di),
            free_slip, derive)


# ---- the three configurations of the thermal parity phase -----------------
def pallas_thermal_setup(n, dtype, dev):
    """The set-up of tests/test_pallas_thermal.py::_setup: lognormal K,
    variable ρCp, no_flux left/right, constant_value top 0 / bottom 1, a
    linear T profile. Returns (geometry, K, ρCp, BCs, ghosted T)."""
    kw = dict(dtype=dtype, device=dev)
    rng = np.random.default_rng(0)
    K = torch.as_tensor(np.exp(0.2 * rng.normal(size=(n, n))), **kw)
    rc = torch.as_tensor(1.0 + 0.1 * rng.random((n, n)), **kw)
    bc = TemperatureBoundaryConditions(no_flux=Faces(left=True, right=True),
                                       constant_value=Faces(top=0.0, bot=1.0))
    Tg = np.zeros((n + 2, n + 2))
    Tg[:, 1:-1] = np.linspace(1, 0, n)[None, :] * np.ones((n + 2, 1))
    return Geometry((n, n), (1.0, 1.0)), K, rc, bc, thermal_bcs(torch.as_tensor(Tg, **kw), bc)


def thermal_case(name, n, dtype, dev):
    """Inputs of one ``thermal_chunk`` call: (args, kwargs), from a numpy
    seed. T, qx and qy all move in the first iteration."""
    kw = dict(dtype=dtype, device=dev)
    c = (n, n)
    if name == "pallas_setup":  # tests/test_pallas_thermal.py, with H and adiabatic
        geometry, K, rc, bc, T = pallas_thermal_setup(n, dtype, dev)
        qx, qy = torch.zeros((n + 1, n), **kw), torch.zeros((n, n + 1), **kw)
        H_tot = torch.as_tensor(0.1 * np.random.default_rng(2).random(c), **kw)
        ad = torch.as_tensor(0.01 * np.random.default_rng(1).random(c), **kw)
        dt = 0.3
    else:
        rng = np.random.default_rng(5 if name == "dirichlet_box" else 7)
        geometry = Geometry(c, (1.0, 1.0))
        K = torch.as_tensor(np.exp(0.3 * rng.normal(size=c)), **kw)
        rc = torch.as_tensor(1.0 + 0.2 * rng.random(c), **kw)
        Tg = np.zeros((n + 2, n + 2))
        Tg[1:-1, 1:-1] = 0.5 + 0.2 * rng.normal(size=c)
        qx = torch.as_tensor(0.1 * rng.normal(size=(n + 1, n)), **kw)
        qy = torch.as_tensor(0.1 * rng.normal(size=(n, n + 1)), **kw)
        if name == "dirichlet_box":  # the BCs of models/thermal_stresses.py, per face
            bc = TemperatureBoundaryConditions(
                constant_value=Faces(left=0.2, right=0.4, bot=1.0, top=0.0))
            H, shear_heating = 0.05 * rng.random(c), 0.5 * rng.random(c)
            H_tot = torch.as_tensor(H, **kw) + torch.as_tensor(shear_heating, **kw)
            ad, dt = None, 0.1
        elif name == "insulated":  # no_flux on all four faces, a heat source
            bc = TemperatureBoundaryConditions(
                no_flux=Faces(left=True, right=True, bot=True, top=True))
            H_tot = torch.as_tensor(rng.random(c), **kw)
            ad = torch.as_tensor(-0.02 * rng.random(c), **kw)
            dt = 0.5
        else:
            raise ValueError(name)
        T = thermal_bcs(torch.as_tensor(Tg, **kw), bc)
    pt = PTThermalCoeffs.make(K, rc, dt, geometry.di, geometry.li)
    args = (T, qx, qy, T, K, rc, H_tot, pt.dtau_rho, pt.theta_r_dtau, 1.0 / dt,
            1.0 / geometry.di[0], 1.0 / geometry.di[1], bc)
    return args, dict(adiabatic=ad)


def thermal_1024_setup(n, dtype):
    """bench_kernels.py::pallas_thermal2d at n²: L = 100 km, K = 3,
    ρCp = 3.3e6, dt = 1.5e11, T = 1500 + 10·N(0, 1), no_flux left/right,
    constant_value top 1500 / bottom 1600, H = 0; the state on the default
    device. Returns (thermal, pt, bc, geometry, K, ρCp, dt)."""
    geometry = Geometry((n, n), (100.0e3, 100.0e3))
    thermal = ThermalState.make((n, n), dtype=dtype)
    kw = dict(dtype=dtype, device=thermal.T.device)
    K, rc, dt = torch.full((n, n), 3.0, **kw), torch.full((n, n), 3.3e6, **kw), 1.5e11
    bc = TemperatureBoundaryConditions(no_flux=Faces(left=True, right=True),
                                       constant_value=Faces(top=1500.0, bot=1600.0))
    T = thermal_bcs(torch.as_tensor(
        1500.0 + 10.0 * np.random.default_rng(0).normal(size=(n + 2, n + 2)), **kw), bc)
    pt = PTThermalCoeffs.make(K, rc, dt, geometry.di, geometry.li)
    return thermal.replace(T=T, Told=T), pt, bc, geometry, K, rc, dt


# a parent commit's tree (its justrelax_tpu_torch/ops and csrc), from
# --parent DIR: its kernels are timed beside this tree's on the same inputs
PARENT = None


def load_parent(name, parent=None):
    """The parent tree's ``ops/<name>.py`` as a module of its own, its
    ``SOURCE`` pointed at the parent's kernel source; ``None`` without a
    parent tree."""
    import importlib.util
    from pathlib import Path

    parent = parent or PARENT
    if parent is None:
        return None
    path = Path(parent) / "justrelax_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if hasattr(mod, "SOURCE"):
        mod.SOURCE = Path(parent) / "justrelax_tpu_torch" / "csrc" / mod.SOURCE.name
    if hasattr(mod, "he"):  # the fused chunk builds its library through the edge module
        mod.he = load_parent("hopper_vep3d_edges", parent)
    return mod


@functools.lru_cache(maxsize=None)
def parent_edges():
    """The parent tree's edge-kernel module (--parent DIR), or None."""
    return load_parent("hopper_vep3d_edges")


def vs_parent_edges(args, ekw, out, split, label):
    """``out`` (τ_e×3, λ_e×3) against the parent tree's edge kernel on these
    ``vep3d_edges`` arguments: {"equals_parent": bit for bit,
    "vs_parent": the largest difference relative to each field's max}, or
    {} without --parent. The two differ where the compiler contracted a
    product and a sum into a fused multiply-add in one and not the other, so
    they are held to each other as to the plain version: 1e-12 in f64, 1e-4
    in f32."""
    old = parent_edges()
    if old is None:
        return {}
    co = args[6].co if isinstance(args[6], he.PackedEdgeConsts) else args[6]
    ref = old.vep3d_edges(*args[:6], co, args[7], split=split, **ekw)
    ref = (*ref[0], *ref[1])
    gap = max(rel_diffs_edges(out, ref).values())
    tol = TOL_VEP3D_CALL if out[0].dtype == torch.float64 else TOL_F32_1024
    check(gap <= tol, f"{label}: {gap} from the parent kernel")
    return {"equals_parent": all(torch.equal(a, b) for a, b in zip(out, ref)),
            "vs_parent": gap}


def bound_ms(words, n_cells, itemsize, kind):
    """Least time per PT iteration: the accounting's words per cell over
    the HBM peak (the operations, a few dozen per cell, take far less at
    the card's 67 TFLOP/s f32)."""
    return words * n_cells * itemsize / HBM_PEAK[kind] * 1e3


def cuda_time_ms(fn, repeats=5):
    """Median wall time of ``fn`` on the card, by CUDA events, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


SLEEP_HZ = 2.0e9  # cycles per second of torch.cuda._sleep: the H100's top SM clock


def device_time_ms(fn, reps=20, repeats=7):
    """The card's time per call of ``fn`` and the host's, apart:
    ``{"ms": device ms, "wall_ms": host ms, "wall_min_ms": the host's
    fastest run, "queued": bool}``, medians of ``repeats`` runs of ``reps``
    calls after one warm-up call (the host's clock varies more than the
    card's: its cores are shared).

    ``wall_ms`` is the host's clock from the first call to the end of the
    last on the card, over ``reps``: where the host's work per call (Python,
    allocation, launch) outlasts the card's, it is the host's rate of calls.
    ``ms`` is read between two CUDA events that a ``torch.cuda._sleep`` puts
    behind the host: the card sleeps until every call is queued, so the
    events bracket the card's work alone. ``queued`` says that the start
    event was still pending when the last call was queued in every run (the
    sleep is lengthened once and the run repeated where it was not). Keep
    ``reps`` times the launches per call well inside the card's queue of
    pending launches (about a thousand): past it the host waits for the card
    and the events take in that wait."""
    fn()
    torch.cuda.synchronize()
    walls, devs, queued = [], [], True
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / reps * 1e3)
    wall = statistics.median(walls)
    cycles = int(4.0 * wall * 1e-3 * reps * SLEEP_HZ) + 200_000
    for _ in range(repeats):
        for attempt in range(2):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            ok = not a.query()  # the card still asleep when the last call was queued
            torch.cuda.synchronize()
            if ok or attempt:
                break
            cycles *= 4
        queued &= ok
        devs.append(a.elapsed_time(b) / reps)
    return {"ms": statistics.median(devs), "wall_ms": wall, "wall_min_ms": min(walls),
            "queued": queued}


@contextlib.contextmanager
def timed_calls(module, name):
    """``module.name`` wrapped so that CUDA events bracket each call on the
    current stream (the wrapper's set-up, its host reads and its kernel
    launches); yields the list of (start, end) events."""
    fn = getattr(module, name)
    pairs = []

    def shim(*args, **kwargs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kwargs)
        b.record()
        pairs.append((a, b))
        return out

    setattr(module, name, shim)
    try:
        yield pairs
    finally:
        setattr(module, name, fn)


def events_s(pairs):
    """Seconds between each (start, end) event pair, summed."""
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) * 1e-3


def chunk_inputs_from_state(st, material, pr_c, pr_v, geometry, pt, dt):
    """Chunk inputs at the start of a solve from ``st`` (solve_vep's entry)."""
    z = torch.zeros_like
    return (st.V.Vx, st.V.Vy, st.P, st.P, st.tau.xx, st.tau.yy, st.tau.xy_c,
            st.tau.xy, st.viscosity.eta, st.viscosity.eta_v, z(st.P), z(st.tau.xy),
            st.P, st.Q, st.tau_o.xx, st.tau_o.yy, st.tau_o.xy_c, st.tau_o.xy,
            st.EII_pl, material, pr_c, pr_v, None, dt,
            1.0 / geometry.di[0], 1.0 / geometry.di[1], pt.r, pt.theta_dtau,
            pt.etadtau, 0.2, 1e-2, (-math.inf, math.inf))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # ---- 0. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # ---- 1. build: one nvcc per source, started together
    def build(source):
        t0 = time.perf_counter()
        path = _cuda_build.build_library(source)
        return path, time.perf_counter() - t0

    mods = (hv, hs, ht, h3, he, hw)
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        builds = list(pool.map(build, [mod.SOURCE for mod in mods]))
    for mod in mods:
        mod._library()
    for phase, (lib_path, build_s) in zip(("build", "build_ve", "build_thermal", "build_ve3d",
                                           "build_vep3d", "build_window_copy"), builds):
        log = lib_path.with_suffix(".log")
        ptxas = []
        for ln in log.read_text().splitlines() if log.exists() else []:
            kernel = re.search(r"\d(k_[a-z_]+)I([fd])", ln) if "Compiling" in ln else None
            if kernel:  # the kernel and its type (f: float, d: double)
                ptxas.append("{}<{}>".format(*kernel.groups()))
            elif "registers" in ln or "spill" in ln:
                ptxas.append(ln.strip())
        emit(phase, seconds=build_s, library=os.path.relpath(lib_path, ROOT), ptxas=ptxas)

    # ---- 2. kernel against plain, f64, n=64
    worst_rel, worst_abs = 0.0, 0.0
    for case in ("shearband", "dpcap", "powerlaw_noslip", "buoyancy"):
        args, kw = chunk_case(case, 64, torch.float64, dev)
        for nout, tol in ((1, TOL_NOUT1), (50, TOL_NOUT50)):
            ref = hv.stokes_vep_chunk_reference(*args, nout=nout, **kw)
            out = hv.stokes_vep_chunk(*args, nout=nout, **kw)
            torch.cuda.synchronize()
            d = rel_diffs(out, ref)
            worst = max(d.values())
            worst_rel, worst_abs = max(worst_rel, worst), max(worst_abs, abs_diff(out, ref))
            lam_max = float(ref[10].max())
            emit("parity", case=case, nout=nout, max_rel_diff=worst, tol=tol,
                 lam_max=lam_max, per_field=d)
            check(worst <= tol, f"{case} nout={nout}: {worst} > {tol}")
            if case != "buoyancy":
                check(lam_max > 0.0, f"{case}: plasticity inactive")
            else:
                check(float(ref[1].abs().max()) > 0.0, "buoyancy: no flow")

    # ---- 3. golden through the kernel, f64
    hv.stokes_vep_chunk.launches = 0
    t0 = time.perf_counter()
    st, info, tau_max, _, tII = shearband.run(
        n=32, nt=10, dtype=torch.float64, use_kernel=True, device=dev)
    g = dict(err=float(info.err), tauII_min=float(tII.min()), tauII_max=float(tII.max()),
             txx_max_last=tau_max[-1], launches=hv.stokes_vep_chunk.launches,
             seconds=time.perf_counter() - t0)
    emit("golden", **g)
    check(g["err"] < 1e-6, "golden: err")
    check(abs(g["tauII_max"] - 1.641536) <= 1e-4, "golden: tauII max")
    check(abs(g["tauII_min"] - 1.512963) <= 1e-4, "golden: tauII min")
    check(abs(g["txx_max_last"] - 1.637653) <= 1e-4, "golden: txx max")
    check(g["launches"] > 0, "golden: the kernel was not launched")

    # ---- 4. main path: production grid, one time step through the kernel
    n = 1024
    hv.stokes_vep_chunk.launches = hs.stokes_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_calls(solver_vep, "stokes_vep_chunk") as calls:
        st, info, _, _, tII = shearband.run(
            n=n, nt=1, dtype=torch.float32, use_kernel=True, device=dev,
            iter_max=40_000, nout=1_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chunk_calls_s = events_s(calls)
    main_launches = hv.stokes_vep_chunk.launches
    finite = all(bool(torch.isfinite(t).all()) for t in (
        st.V.Vx, st.V.Vy, st.P, st.tau.xx, st.tau.yy, st.tau.xy, st.tau.II,
        st.viscosity.eta, st.viscosity.eta_v, st.EII_pl))
    emit("main_path", n=n, dtype="float32", iters=int(info.iters), err=float(info.err),
         tauII_max=float(tII.max()), wall_s=wall, launches=main_launches, finite=finite)
    check(finite, "main path: non-finite fields")
    check(main_launches > 0, "main path: the kernel was not launched")

    # 200 iterations, kernel vs plain: from the main path's initial state
    # (elastic loading), and from the shear band case with old stresses near
    # yield (the return mapping active)
    geometry, material, pr_c, pr_v, st0, pt, _ = shearband._setup(
        n, dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0,
                C=1.6 / math.cos(math.radians(30.0)), friction_angle=30.0,
                eta_reg=8.0e-3), 0.5, torch.float32, dev,
        eps_rel=1.0e-6, CFL=0.75 / math.sqrt(2.1))
    states = {
        "initial": (chunk_inputs_from_state(st0, material, pr_c, pr_v, geometry, pt, 0.25), {}),
        "near_yield": chunk_case("shearband", n, torch.float32, dev),
    }
    saved = hv.stokes_vep_chunk.launches
    worst32 = 0.0
    for label, (args, kw) in states.items():
        per_field, gap, k_vs_64, p_vs_64, ref = f32_gaps(
            hv.stokes_vep_chunk, hv.stokes_vep_chunk_reference, rel_diffs, args, kw, 200)
        lam_max = float(ref[10].max())
        tol = max(TOL_F32_1024, 2.0 * p_vs_64)
        worst32 = max(worst32, gap)
        emit("f32_1024_parity", state=label, nout=200, max_rel_diff=gap, tol=tol,
             kernel_vs_plain_f64=k_vs_64, plain_f32_vs_plain_f64=p_vs_64,
             lam_max=lam_max, per_field=per_field)
        check(gap <= tol, f"f32 1024^2 {label}: {gap} > {tol}")
    torch.cuda.synchronize()

    # ---- 5. timing at 1024^2 f32, in turns kernel, plain, plain, kernel
    nk, npl = 500, 20
    kind = "PCIe" if "PCIe" in name else "SXM"
    bytes_iter = WORDS_VEP * n * n * 4
    times, words = {}, {}
    for label, (args, kw) in states.items():
        words[label] = hv.vep_chunk_words(*args, **kw)
        tk1 = cuda_time_ms(lambda: hv.stokes_vep_chunk(*args, nout=nk, **kw)) / nk
        tp1 = cuda_time_ms(lambda: hv.stokes_vep_chunk_reference(*args, nout=npl, **kw)) / npl
        tp2 = cuda_time_ms(lambda: hv.stokes_vep_chunk_reference(*args, nout=npl, **kw)) / npl
        tk2 = cuda_time_ms(lambda: hv.stokes_vep_chunk(*args, nout=nk, **kw)) / nk
        t_k, t_p = min(tk1, tk2), min(tp1, tp2)
        t_eff = bytes_iter / (t_k * 1e-3)
        times[label] = (t_k, t_p)
        bound = bound_ms(words[label], n * n, 4, kind)
        emit("timing", state=label, n=n, dtype="float32", kernel_ms_per_iter=[tk1, tk2],
             plain_ms_per_iter=[tp1, tp2], words=words[label], bound_ms=bound,
             bound_share=bound / t_k, bound_ms_39_words=bound_ms(WORDS_VEP, n * n, 4, kind),
             T_eff_39_words_GBs=t_eff / 1e9, hbm_peak_GBs=HBM_PEAK[kind] / 1e9,
             hbm_share_39_words=t_eff / HBM_PEAK[kind], plain_over_kernel=t_p / t_k,
             nvidia_smi=smi)
    hv.stokes_vep_chunk.launches = saved  # comparison launches do not count
    t_k, t_p = times["initial"]
    # the step's wall time: the chunk calls (nout - 1 kernel iterations each
    # and the wrapper's invariant stacks), measured by CUDA events around
    # them; the chunk-final iteration of each chunk on the plain path, from
    # the plain version's time above; the rest (the model's set-up,
    # residuals, host reads)
    plain_s = main_launches * t_p * 1e-3
    emit("main_path_split", n=n, wall_s=wall, iters=int(info.iters), chunks=main_launches,
         chunk_calls_s=chunk_calls_s, kernel_iterations_s=(int(info.iters) - main_launches) * t_k
         * 1e-3, chunk_final_plain_s=plain_s, rest_s=wall - chunk_calls_s - plain_s)
    vep_line = {
        "name": "stokes_vep_chunk",
        "route": "cuda",
        "source": "justrelax_tpu_torch/csrc/stokes_vep.cu",
        "replaces": ("justrelax_tpu/ops/pallas_stokes_vep.py:473 (B2 stokes_vep_chunk_vmem); "
                     "justrelax_tpu/ops/pallas_stokes_vep.py:864 (B3 stokes_vep_chunk_blocked)"),
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "max_rel_diff_f64": worst_rel,
        "max_rel_diff_f32_1024": worst32,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound_ms(words["initial"], n * n, 4, kind),
        "bound_by": "bytes",
        "library_ms": None,
        "words": words["initial"],
        "bound_ms_39_words": bound_ms(WORDS_VEP, n * n, 4, kind),
        "near_yield_ms": times["near_yield"][0],
    }

    ve_line = run_ve(dev, smi, kind)
    th_line = run_thermal(dev, smi, kind)
    ve3d_line = run_ve3d(dev, smi, kind)
    b6_line, b9_line, bench, tau_edges = run_vep3d(dev, smi, kind)
    b8_line = run_vep3d_chunk(dev, smi, kind, bench, tau_edges)
    r_line = run_window_copy(dev, smi, kind)
    # the longest goldens of phases 33, 36 and 39 run in processes of their
    # own beside phase 28's, whose processes wait on the host's dispatch;
    # phase 39 runs in this process while they do; all are collected before
    # phase 29 takes its timings (phase 40, a timing, after phase 38).
    # Phase 42's worlds (four ranks and one) run their correctness cases
    # beside them too; the rest of phase 42 runs after phase 41
    procs = start_goldens(MOVED_DRIVES + PARTICLES_APART + VARIATIONAL_APART + NONUNIFORM_APART)
    distributed = DistributedPhase(dev)
    try:
        apart, nonuniform_launches = {}, {}
        try:
            model_launches = run_models(
                dev, smi, before_29=lambda: apart.update(finish_goldens(procs, "golden_apart")),
                beside_28=lambda: nonuniform_launches.update(run_nonuniform_parity(dev, smi)),
                apart_results=apart)
        finally:
            stop_processes(procs)
        for phase in (run_dyrel(dev, smi, kind), run_particles(dev, smi, apart),
                      run_variational(dev, smi, kind, apart), nonuniform_launches,
                      nonuniform_goldens(smi, apart),
                      run_nonuniform_production(dev, smi, kind),
                      run_io_restart(dev, smi, (st, material, pr_c, pr_v, geometry, pt, 0.25))):
            for kernel, by_phase in phase.items():
                model_launches.setdefault(kernel, {}).update(by_phase)
        # phase 26's profiler counts before phase 42: after phase 42's production
        # the profiler loses events, for a reason not found (PERF.md section 7)
        per_iter = launches_per_iteration(dev)
        for kernel, by_phase in distributed.finish(smi).items():
            model_launches.setdefault(kernel, {}).update(by_phase)
    finally:
        distributed.stop()
    check(all(n == 0 for n in (by_phase["distributed"] for by_phase in model_launches.values())),
          "distributed: a kernel launched")
    lines = [vep_line, ve_line, th_line, ve3d_line, b6_line, b9_line, b8_line, r_line]
    for line in lines:
        line["launches_per_iteration"] = per_iter[line["name"]]
        line["launches_models"] = model_launches.get(line["name"], {})
    emit("elapsed", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


def run_ve(dev, smi, kind):
    """Phases 6-9, the VE solve; returns the VE kernel's entry of the
    kernels line."""
    # ---- 6. VE kernel against plain, f64, n=64
    worst_rel, worst_abs = 0.0, 0.0
    for case in VE_CASES:
        args, kw = ve_case(case, 64, torch.float64, dev)
        for nout, tol in ((1, TOL_VE_NOUT1), (500, TOL_VE_NOUT500)):
            ref = hs.stokes_chunk_reference(*args, nout=nout, **kw)
            out = hs.stokes_chunk(*args, nout=nout, **kw)
            torch.cuda.synchronize()
            d = rel_diffs_ve(out, ref)
            worst = max(d.values())
            worst_rel, worst_abs = max(worst_rel, worst), max(worst_abs, abs_diff(out, ref))
            moved = min(float((o - a).abs().max()) for o, a in zip(out[:2], args[:2]))
            emit("parity_ve", case=case, nout=nout, max_rel_diff=worst, tol=tol,
                 V_moved=moved, per_field=d)
            check(worst <= tol, f"{case} nout={nout}: {worst} > {tol}")
            check(moved > 0.0, f"{case} nout={nout}: the kernel left V unchanged")

    # ---- 7. goldens through the default entry points, f64, 32^2
    def golden(label, fn, checks):
        hs.stokes_chunk.launches = 0
        t0 = time.perf_counter()
        g = fn()
        g.update(launches=hs.stokes_chunk.launches, seconds=time.perf_counter() - t0)
        emit("golden_ve", case=label, **g)
        for key, ok in checks(g):
            check(ok, f"golden_ve {label}: {key}")
        check(g["launches"] > 0, f"golden_ve {label}: the kernel was not launched")

    def run_solcx(d_eta):
        _, st, info, _ = solcx.run(nx=32, ny=32, d_eta=d_eta, dtype=torch.float64)
        vmax = max(float(st.V.Vx.abs().max()), float(st.V.Vy.abs().max()))
        return dict(iters=int(info.iters), err=float(info.err), vmax=vmax)

    def run_solkz():
        _, _, info = solkz.run(nx=32, ny=32, dtype=torch.float64)
        return dict(iters=int(info.iters), err=float(info.err))

    def run_buildup():
        _, av, sol, _, info = elastic_buildup.run(nx=32, ny=32, endtime_kyr=10.0,
                                                  dtype=torch.float64)
        err = statistics.mean(abs(abs(a) - s) / s for a, s in zip(av, sol))
        return dict(steps=len(av), iters_last=int(info.iters), mean_rel_err=err)

    analytic_vmax = 1.0 / (4.0 * math.pi ** 2)
    golden("solcx_deta1e6", lambda: run_solcx(1e6), lambda g: [("err", g["err"] < 1e-8)])
    golden("solcx_deta1", lambda: run_solcx(1.0), lambda g: [
        ("err", g["err"] < 1e-8),
        ("vmax", abs(g["vmax"] - analytic_vmax) <= 2e-3 * analytic_vmax)])
    golden("solkz", run_solkz, lambda g: [("err", g["err"] < 1e-8)])
    golden("elastic_buildup", run_buildup, lambda g: [("mean_rel_err", g["mean_rel_err"] <= 5e-3)])

    # ---- 8. main path: SolCx at the production grid, the default entry point
    n = 1024
    hs.stokes_chunk.launches = hv.stokes_vep_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_calls(solver_ve, "stokes_chunk") as calls:
        _, st, info, _ = solcx.run(nx=n, ny=n, dtype=torch.float32, iter_max=20_000,
                                   nout=1_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chunk_calls_s = events_s(calls)
    main_launches = hs.stokes_chunk.launches
    check(st.P.device.type == "cuda", "main path VE: the default device is not the card")
    finite = all(bool(torch.isfinite(t).all()) for t in (
        st.V.Vx, st.V.Vy, st.P, st.tau.xx, st.tau.yy, st.tau.xy, st.tau.II))
    emit("main_path_ve", n=n, dtype="float32", iters=int(info.iters), err=float(info.err),
         wall_s=wall, launches=main_launches, finite=finite)
    check(finite, "main path VE: non-finite fields")
    check(main_launches > 0, "main path VE: the kernel was not launched")

    # 200 iterations kernel vs plain from the main path's initial state
    geometry, st0, pt, _, rho_g, G, K, _ = solcx._setup(n, n, 1e6, 1.0, 1.0, torch.float32, dev)
    eta = st0.viscosity.eta
    args = (st0.V.Vx, st0.V.Vy, st0.P, st0.tau.xx, st0.tau.yy, st0.tau.xy,
            eta, maxloc(eta, 1), *rho_g, 1.0 / geometry.di[0], 1.0 / geometry.di[1],
            pt.r, pt.theta_dtau, pt.etadtau)
    kw = dict(G=G, K=K, P0=st0.P0, Q=st0.Q,
              tau_o=(st0.tau_o.xx, st0.tau_o.yy, st0.tau_o.xy), dt=0.1)
    per_field, worst32, k_vs_64, p_vs_64, _ = f32_gaps(
        hs.stokes_chunk, hs.stokes_chunk_reference, rel_diffs_ve, args, kw, 200)
    tol = max(TOL_F32_1024, 2.0 * p_vs_64)
    emit("f32_1024_parity_ve", nout=200, max_rel_diff=worst32, tol=tol,
         kernel_vs_plain_f64=k_vs_64, plain_f32_vs_plain_f64=p_vs_64, per_field=per_field)
    check(worst32 <= tol, f"f32 1024^2 VE: {worst32} > {tol}")

    # ---- 9. timing at 1024^2 f32, in turns kernel, plain, plain, kernel
    nk, npl = 1000, 20
    saved = hs.stokes_chunk.launches
    tk1 = cuda_time_ms(lambda: hs.stokes_chunk(*args, nout=nk, **kw)) / nk
    tp1 = cuda_time_ms(lambda: hs.stokes_chunk_reference(*args, nout=npl, **kw)) / npl
    tp2 = cuda_time_ms(lambda: hs.stokes_chunk_reference(*args, nout=npl, **kw)) / npl
    tk2 = cuda_time_ms(lambda: hs.stokes_chunk(*args, nout=nk, **kw)) / nk
    hs.stokes_chunk.launches = saved  # comparison launches do not count
    t_k, t_p = min(tk1, tk2), min(tp1, tp2)
    t_eff = WORDS_VE * n * n * 4 / (t_k * 1e-3)
    words = hs.ve_chunk_words(*args, **kw)
    bound = bound_ms(words, n * n, 4, kind)
    emit("timing_ve", n=n, dtype="float32", kernel_ms_per_iter=[tk1, tk2],
         plain_ms_per_iter=[tp1, tp2], words=words, bound_ms=bound, bound_share=bound / t_k,
         bound_ms_23_words=bound_ms(WORDS_VE, n * n, 4, kind), T_eff_23_words_GBs=t_eff / 1e9,
         hbm_peak_GBs=HBM_PEAK[kind] / 1e9, hbm_share_23_words=t_eff / HBM_PEAK[kind],
         plain_over_kernel=t_p / t_k, nvidia_smi=smi)
    # the solve's wall time: the chunk calls (every iteration in the kernel,
    # and the wrapper's invariant stacks), measured by CUDA events around
    # them; the rest (the model's set-up, residuals, host reads)
    emit("main_path_ve_split", n=n, wall_s=wall, iters=int(info.iters), chunks=main_launches,
         chunk_calls_s=chunk_calls_s, kernel_iterations_s=int(info.iters) * t_k * 1e-3,
         rest_s=wall - chunk_calls_s)
    return {
        "name": "stokes_chunk",
        "route": "cuda",
        "source": "justrelax_tpu_torch/csrc/stokes_ve.cu",
        "replaces": ("justrelax_tpu/ops/pallas_stokes.py:264 (B1 stokes_chunk_vmem); "
                     "justrelax_tpu/ops/pallas_stokes.py:470 (B4 stokes_chunk_blocked)"),
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "max_rel_diff_f64": worst_rel,
        "max_rel_diff_f32_1024": worst32,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": None,
        "words": words,
        "bound_ms_23_words": bound_ms(WORDS_VE, n * n, 4, kind),
    }


def run_thermal(dev, smi, kind):
    """Phases 10-13, the thermal solve; returns the thermal kernel's entry of
    the kernels line."""
    # ---- 10. thermal kernel against plain, f64, n=64
    worst_rel, worst_abs = 0.0, 0.0
    for case in TH_CASES:
        args, kw = thermal_case(case, 64, torch.float64, dev)
        for nout, tol in ((1, TOL_TH_NOUT1), (500, TOL_TH_NOUT500)):
            ref = ht.thermal_chunk_reference(*args, nout=nout, **kw)
            out = ht.thermal_chunk(*args, nout=nout, **kw)
            torch.cuda.synchronize()
            d = rel_diffs_th(out, ref)
            worst = max(d.values())
            worst_rel, worst_abs = max(worst_rel, worst), max(worst_abs, abs_diff(out, ref))
            moved = float((out[0] - args[0]).abs().max())
            emit("parity_thermal", case=case, nout=nout, max_rel_diff=worst, tol=tol,
                 T_moved=moved, per_field=d)
            check(worst <= tol, f"{case} nout={nout}: {worst} > {tol}")
            check(moved > 0.0, f"{case} nout={nout}: the kernel left T unchanged")

    # ---- 11. goldens through the default entry points, f64, 32^2
    n = 32
    geometry, K, rc, bc, Tg = pallas_thermal_setup(n, torch.float64, dev)
    th0 = ThermalState.make((n, n)).replace(T=Tg, Told=Tg)
    pt = PTThermalCoeffs.make(K, rc, 0.3, geometry.di, geometry.li)
    ht.thermal_chunk.launches = 0
    t0 = time.perf_counter()
    th, info = heatdiffusion_PT(th0, pt, bc, 0.3, geometry, K=K, rho_Cp=rc,
                                iter_max=4000, nout=200)
    T = th.T
    g = dict(iters=int(info.iters), err=float(info.err), T_centre=float(T[17, 17]),
             T_corner_lo=float(T[1, 1]), T_corner_hi=float(T[32, 32]))
    rel_T = max(abs(g[k] - GOLDEN_THERMAL[k]) / abs(GOLDEN_THERMAL[k])
                for k in ("T_centre", "T_corner_lo", "T_corner_hi"))
    rel_err = abs(g["err"] - GOLDEN_THERMAL["err"]) / GOLDEN_THERMAL["err"]
    emit("golden_thermal", case="heatdiffusion_PT_32", **g, rel_T=rel_T, rel_err=rel_err,
         launches=ht.thermal_chunk.launches, seconds=time.perf_counter() - t0)
    check(g["iters"] == GOLDEN_THERMAL["iters"], "golden_thermal: iterations")
    check(rel_T <= 1e-10, f"golden_thermal: T {rel_T}")
    # err is a residual of O(1) terms near 1e-9: rounding moves it by ~1e-7
    # relative, the FMA contraction of the kernel included
    check(rel_err <= 1e-4, f"golden_thermal: err {rel_err}")
    check(ht.thermal_chunk.launches > 0, "golden_thermal: the kernel was not launched")

    ht.thermal_chunk.launches = 0
    t0 = time.perf_counter()
    th, info = diffusion2d.run(nx=32, ny=32, dtype=torch.float64)
    T = th.T
    g = dict(T_17_17=float(T[17, 17]), T_16_16=float(T[16, 16]), err=float(info.err),
             iters_last=int(info.iters), launches=ht.thermal_chunk.launches,
             seconds=time.perf_counter() - t0)
    emit("golden_thermal", case="diffusion2d_32", **g)
    check(th.T.device.type == "cuda", "diffusion2d: the default device is not the card")
    check(abs(g["T_17_17"] - 1817.9448461176817) <= 0.1, "diffusion2d: T[17, 17]")
    check(abs(g["T_16_16"] - 1827.4674313638786) <= 0.1, "diffusion2d: T[16, 16]")
    check(g["err"] < 1e-8, "diffusion2d: err")
    check(g["launches"] == 0, "diffusion2d: the material path launched the thermal kernel")

    hv.stokes_vep_chunk.launches = ht.thermal_chunk.launches = 0
    t0 = time.perf_counter()
    urms, nu, info, _, _ = blankenbach.run(nx=32, ny=32, nit=10, dtype=torch.float64)
    g = dict(Urms_first=urms[0], Urms_last=urms[-1], Nu_last=nu[-1], err=float(info.err),
             iters_last=int(info.iters), launches=hv.stokes_vep_chunk.launches,
             thermal_launches=ht.thermal_chunk.launches, seconds=time.perf_counter() - t0)
    emit("golden_thermal", case="blankenbach_32", **g)
    check(abs(g["Urms_first"] - URMS0_F64) <= 1e-3 * URMS0_F64, "blankenbach: Urms[0]")
    check(abs(g["Urms_last"] - 0.40987052065118357) <= 1e-1 * 0.40987052065118357,
          "blankenbach: Urms[-1]")
    check(abs(g["Nu_last"] - 1.0026242251320245) <= 1e-2 * 1.0026242251320245,
          "blankenbach: Nu[-1]")
    check(g["err"] < 1e-4, "blankenbach: err")
    check(g["launches"] > 0, "blankenbach: the VEP kernel was not launched")

    # ---- 12. main path: the production grid, the default entry point
    n = 1024
    thermal, pt, bc, geometry, K, rc, dt = thermal_1024_setup(n, torch.float32)
    hv.stokes_vep_chunk.launches = hs.stokes_chunk.launches = ht.thermal_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    th, info = heatdiffusion_PT(thermal, pt, bc, dt, geometry, K=K, rho_Cp=rc,
                                iter_max=20_000, nout=1_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = ht.thermal_chunk.launches
    check(th.T.device.type == "cuda", "main path thermal: the default device is not the card")
    finite = all(bool(torch.isfinite(t).all()) for t in (
        th.T, th.qTx, th.qTy, th.qTx2, th.qTy2, th.ResT))
    emit("main_path_thermal", n=n, dtype="float32", iters=int(info.iters),
         err=float(info.err), wall_s=wall, wall_ms_per_iter=wall / int(info.iters) * 1e3,
         launches=main_launches, finite=finite)
    check(finite, "main path thermal: non-finite fields")
    check(main_launches > 0, "main path thermal: the kernel was not launched")

    # 200 iterations kernel vs plain from the main path's initial state
    args = (thermal.T, thermal.qTx, thermal.qTy, thermal.T, K, rc,
            thermal.H + thermal.shear_heating, pt.dtau_rho, pt.theta_r_dtau, 1.0 / dt,
            1.0 / geometry.di[0], 1.0 / geometry.di[1], bc)
    kw = dict(adiabatic=thermal.adiabatic)
    per_field, worst32, k_vs_64, p_vs_64, _ = f32_gaps(
        ht.thermal_chunk, ht.thermal_chunk_reference, rel_diffs_th, args, kw, 200)
    tol = max(TOL_F32_1024, 2.0 * p_vs_64)
    emit("f32_1024_parity_thermal", nout=200, max_rel_diff=worst32, tol=tol,
         kernel_vs_plain_f64=k_vs_64, plain_f32_vs_plain_f64=p_vs_64, per_field=per_field)
    check(worst32 <= tol, f"f32 1024^2 thermal: {worst32} > {tol}")

    # ---- 13. timing at 1024^2 f32, in turns kernel, plain, plain, kernel
    nk, npl = 1000, 20
    tk1 = cuda_time_ms(lambda: ht.thermal_chunk(*args, nout=nk, **kw)) / nk
    tp1 = cuda_time_ms(lambda: ht.thermal_chunk_reference(*args, nout=npl, **kw)) / npl
    tp2 = cuda_time_ms(lambda: ht.thermal_chunk_reference(*args, nout=npl, **kw)) / npl
    tk2 = cuda_time_ms(lambda: ht.thermal_chunk(*args, nout=nk, **kw)) / nk
    ht.thermal_chunk.launches = main_launches  # comparison launches do not count
    t_k, t_p = min(tk1, tk2), min(tp1, tp2)
    t_eff = WORDS_TH * n * n * 4 / (t_k * 1e-3)
    t_eff_bench = WORDS_TH_BENCH * n * n * 4 / (t_k * 1e-3)
    bound = bound_ms(WORDS_TH, n * n, 4, kind)
    emit("timing_thermal", n=n, dtype="float32", kernel_ms_per_iter=[tk1, tk2],
         plain_ms_per_iter=[tp1, tp2], T_eff_GBs=t_eff / 1e9,
         T_eff_16_word_convention_GBs=t_eff_bench / 1e9,
         hbm_peak_GBs=HBM_PEAK[kind] / 1e9, hbm_share=t_eff / HBM_PEAK[kind],
         bound_ms=bound, bound_share=bound / t_k, plain_over_kernel=t_p / t_k,
         nvidia_smi=smi)
    return {
        "name": "thermal_chunk",
        "route": "cuda",
        "source": "justrelax_tpu_torch/csrc/thermal.cu",
        "replaces": "justrelax_tpu/ops/pallas_thermal.py:113 (B5 thermal_chunk_vmem)",
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "max_rel_diff_f64": worst_rel,
        "max_rel_diff_f32_1024": worst32,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": None,
    }


def ve3d_words(eta, eta_tau, f):
    """Words per cell that one 3D VE iteration with dt = ∞ must move: the 10
    unknowns read and written, and each read-only input its result depends
    on (η, ητ, fx, fy, fz) that does not hold one value everywhere (a kernel
    takes such an input as a scalar). bench_kernels.py::ve3d counts 35, with
    15 read-only inputs; the other ten (G, K, P0, Q, τ_o×6) drop out of
    every coefficient where dt = ∞."""
    return 20 + sum(not bool((t == t.reshape(-1)[0]).all()) for t in (eta, eta_tau, *f))


def solvi3d_inputs(n, dtype, dev):
    """The first chunk's inputs of solvi3d.run at n³, from the model's own
    set-up through the solver's kernel_chunk_inputs: ((carry, packed
    coefficients, inv_di), (η, ρg, dt))."""
    geometry, st, pt, _, rho_g, G, K, dt = solvi3d._setup(nx=n, ny=n, nz=n, dtype=dtype,
                                                          device=dev)
    return (kernel_chunk_inputs(st, pt, geometry, rho_g, G, K, dt),
            (st.viscosity.eta, rho_g, dt))


def ve3d_bench_inputs(n, dtype, dev):
    """bench_kernels.py::pallas_ve3d_blocked at n³: η = exp(0.3·N(0, 1)),
    fz ~ N(0, 1) (seed 0), the viscous coefficient form (G = K = dt = ∞),
    zero fields, all free slip. Returns (carry, packed coefficients,
    inv_di, words per cell)."""
    kw = dict(dtype=dtype, device=dev)
    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di)
    rng = np.random.default_rng(0)
    eta = torch.as_tensor(np.exp(0.3 * rng.normal(size=ni)), **kw)
    fz = torch.as_tensor(rng.normal(size=ni), **kw)
    z = torch.zeros(ni, **kw)
    eta_tau = maxloc(eta, 1)
    co = ve3d_canvas_coefficients(eta, eta_tau, pt.r, pt.theta_dtau, pt.etadtau,
                                  fx=z, fy=z, fz=fz)
    X = n + 2
    carry = tuple(torch.zeros((X, X, X), **kw) for _ in range(10))
    packed = h3.pack_coeffs(co, derive_from=(eta, eta_tau, (pt.r / pt.theta_dtau,
                                                            pt.theta_dtau, pt.etadtau)))
    return (carry, packed, tuple(1.0 / d for d in geometry.di),
            ve3d_words(eta, eta_tau, (z, z, fz)))


def time_ve3d(carry, co, inv_di, nk, npl):
    """ms per iteration of the 3D VE kernel and its plain version on the
    same inputs, in turns kernel, plain, plain, kernel: ([k1, k2], [p1, p2])."""
    tk1 = cuda_time_ms(lambda: h3.stokes3d_chunk(carry, co, inv_di, nk)) / nk
    tp1 = cuda_time_ms(lambda: h3.stokes3d_chunk_reference(carry, co, inv_di, npl)) / npl
    tp2 = cuda_time_ms(lambda: h3.stokes3d_chunk_reference(carry, co, inv_di, npl)) / npl
    tk2 = cuda_time_ms(lambda: h3.stokes3d_chunk(carry, co, inv_di, nk)) / nk
    return [tk1, tk2], [tp1, tp2]


def run_ve3d(dev, smi, kind):
    """Phases 14-17, the 3D VE solve; returns the 3D VE kernel's entry of
    the kernels line."""
    # ---- 14. 3D VE kernel against plain, f64
    worst_rel, worst_abs = 0.0, 0.0
    routes = ([(case, case, (22, 9, 7) if case == "ve_general" else (32, 32, 32))
               for case in VE3D_CASES] + [("viscous_consts", "viscous", (32, 32, 32))]
              + [(case, case, ni) for ni in VE3D_RAGGED
                 for case in ("ve_dt_inf", "ve_general", "viscous_no_free_slip")])
    for label, case, ni in routes:
        carry, co, inv_di, free_slip, (consts, scalars) = ve3d_case(case, ni, torch.float64,
                                                                    dev)
        # the coefficients the kernel derives from eta and eta_tau
        packed = h3.pack_coeffs(co, derive_from=(consts[0], consts[1], scalars))
        before = [t.clone() for t in carry]
        for nout, tol in ((1, TOL_VE3D_NOUT1), (200, TOL_VE3D_NOUT200)):
            # the viscous_consts route against the plain chunk on co (G = None)
            ref = h3.stokes3d_chunk_reference(carry, co, inv_di, nout, free_slip=free_slip)
            if label == "viscous_consts":
                out = h3.stokes3d_chunk(carry, None, inv_di, nout, viscous_consts=consts,
                                        pt_scalars=scalars)
            else:
                out = h3.stokes3d_chunk(carry, packed, inv_di, nout, free_slip=free_slip)
            torch.cuda.synchronize()
            d = rel_diffs_ve3d(out, ref)
            worst = max(d.values())
            worst_rel, worst_abs = max(worst_rel, worst), max(worst_abs, abs_diff(out, ref))
            moved = min(float((o - a).abs().max()) for o, a in zip(out[:3], carry[:3]))
            emit("parity_ve3d", case=label, ni=list(ni), nout=nout, max_rel_diff=worst, tol=tol,
                 V_moved=moved, derived=list(packed.derived.names) if packed.derived else [],
                 per_field=d)
            check(worst <= tol, f"{label} nout={nout}: {worst} > {tol}")
            check(moved > 0.0, f"{label} nout={nout}: the kernel left V unchanged")
            if not free_slip:
                check(torch.equal(out[0][:, 0], carry[0][:, 0]), f"{label}: ghosts moved")
        check(all(torch.equal(a, b) for a, b in zip(before, carry)),
              f"{label} {ni}: the input carry was written")

    # ---- 15. goldens through the default entry points, f64, 16^3
    h3.stokes3d_chunk.launches = 0
    t0 = time.perf_counter()
    geom, st, info = solvi3d.run(dtype=torch.float64)
    nrx = info.norm_Rx.cpu().numpy()
    Vx = st.V.Vx.cpu().numpy()
    xv = np.asarray(geom.xvi[0])
    g = dict(iters=int(info.iters), err=float(info.err),
             norm_Rx_last=float(nrx[np.isfinite(nrx)][-1]),
             boundary_Vx_err=float(max(np.abs(Vx[0, 1:-1, 1:-1] - xv[0]).max(),
                                       np.abs(Vx[-1, 1:-1, 1:-1] - xv[-1]).max())),
             launches=h3.stokes3d_chunk.launches, seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    _, _, info_plain = solvi3d.run(dtype=torch.float64, use_kernel=False)
    g.update(iters_plain=int(info_plain.iters), seconds_plain=time.perf_counter() - t0)
    emit("golden_ve3d", case="solvi3d_16", **g)
    check(st.P.device.type == "cuda", "solvi3d: the default device is not the card")
    check(g["norm_Rx_last"] < 1e-8 and g["iters"] <= 5_000, "solvi3d: norm_Rx")
    check(g["boundary_Vx_err"] <= 1e-12, "solvi3d: boundary Vx")
    check(g["launches"] > 0, "solvi3d: the kernel was not launched")

    h3.stokes3d_chunk.launches = 0
    t0 = time.perf_counter()
    geom, st, info = burstedde.run(nx=16, ny=16, nz=16, iter_max=20_000, nout=1_000,
                                   dtype=torch.float64)
    vx_a, _ = burstedde.analytic_velocity(geom)
    vx = st.V.Vx[:, 1:-1, 8].cpu().numpy()
    rel = float(np.linalg.norm(vx - vx_a) / np.linalg.norm(vx_a))
    emit("golden_ve3d", case="burstedde_16", rel_err=rel, tol=5e-2, iters=int(info.iters),
         err=float(info.err), launches=h3.stokes3d_chunk.launches,
         seconds=time.perf_counter() - t0)
    check(rel < 5e-2, f"burstedde: Vx relative error {rel}")
    check(h3.stokes3d_chunk.launches == 0, "burstedde: the plain path launched B7")

    # ---- 16. main path: SolVi at the production 3D grid, the default entry
    n = 126
    hv.stokes_vep_chunk.launches = hs.stokes_chunk.launches = 0
    ht.thermal_chunk.launches = h3.stokes3d_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st, info = solvi3d.run(nx=n, ny=n, nz=n, dtype=torch.float32, iter_max=10_000,
                              nout=1_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = h3.stokes3d_chunk.launches
    check(st.P.device.type == "cuda", "main path 3D: the default device is not the card")
    finite = all(bool(torch.isfinite(t).all()) for t in (
        st.V.Vx, st.V.Vy, st.V.Vz, st.P, st.tau.xx, st.tau.zz, st.tau.yz, st.tau.xy, st.tau.II))
    emit("main_path_ve3d", n=n, dtype="float32", iters=int(info.iters), err=float(info.err),
         wall_s=wall, wall_ms_per_iter=wall / int(info.iters) * 1e3, launches=main_launches,
         other_launches=hv.stokes_vep_chunk.launches + hs.stokes_chunk.launches
         + ht.thermal_chunk.launches, finite=finite)
    check(finite, "main path 3D: non-finite fields")
    check(main_launches > 0, "main path 3D: the kernel was not launched")

    # the main path's first-chunk inputs, built as the solve builds them;
    # their set-up is part of the solve's wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (carry, co, inv_di), (eta, rho_g, dt) = solvi3d_inputs(n, torch.float32, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(math.isinf(dt), "main path 3D: ve3d_words counts dt = inf only")
    words = ve3d_words(eta, maxloc(eta, 1), rho_g)
    # the kernel and its plain version on those inputs, and the split of the
    # solve's wall time they give
    tk, tp = time_ve3d(carry, co, inv_di, 200, 10)
    t_main, tp_main = min(tk), min(tp)
    bound_main = bound_ms(words, n ** 3, 4, kind)
    kernel_s = t_main * 1e-3 * int(info.iters)
    # the parent commit's kernel on the same inputs (chip_smoke.py --parent DIR)
    parent = load_parent("hopper_stokes3d")
    t_parent = None
    if parent is not None:
        old = parent.pack_coeffs(co.co)
        nk = 200
        t_parent = [cuda_time_ms(lambda: parent.stokes3d_chunk(carry, old, inv_di, nk)) / nk,
                    cuda_time_ms(lambda: h3.stokes3d_chunk(carry, co, inv_di, nk)) / nk,
                    cuda_time_ms(lambda: parent.stokes3d_chunk(carry, old, inv_di, nk)) / nk]
        emit("parent_ve3d", n=n, parent_ms_per_iter=t_parent[::2], kernel_ms_per_iter=t_parent[1],
             nvidia_smi=smi)
    emit("main_path_ve3d_split", n=n, n_canvas=int(co.stack.shape[0]), words=words,
         streamed_words=h3.streamed_words(co),
         derived=list(co.derived.names) if co.derived else [],
         kernel_ms_per_iter=tk, plain_ms_per_iter=tp,
         T_eff_GBs=words * n ** 3 * 4 / (t_main * 1e-3) / 1e9, bound_ms=bound_main,
         bound_share=bound_main / t_main, setup_s=setup_s, kernel_s=kernel_s,
         rest_s=wall - setup_s - kernel_s, kernel_share=kernel_s / wall, nvidia_smi=smi)

    # 200 iterations kernel vs plain from the main path's initial state: the
    # kernel reads the packed (uniform canvases as scalars), the plain
    # version the full canvases
    (carry64, co64, _), _ = solvi3d_inputs(n, torch.float64, dev)
    out = h3.stokes3d_chunk(carry, co, inv_di, 200)
    ref = h3.stokes3d_chunk_reference(carry, co, inv_di, 200)
    ref64 = h3.stokes3d_chunk_reference(carry64, co64, inv_di, 200)
    per_field = rel_diffs_ve3d(out, ref)
    worst32, p_vs_64 = max(per_field.values()), max(rel_diffs_ve3d(ref, ref64).values())
    k_vs_64 = max(rel_diffs_ve3d(out, ref64).values())
    tol = max(TOL_F32_1024, 2.0 * p_vs_64)
    emit("f32_126_parity_ve3d", nout=200, max_rel_diff=worst32, tol=tol,
         kernel_vs_plain_f64=k_vs_64, plain_f32_vs_plain_f64=p_vs_64, per_field=per_field)
    check(worst32 <= tol, f"f32 126^3: {worst32} > {tol}")
    out64 = h3.stokes3d_chunk(carry64, co64, inv_di, 200)
    worst64 = max(rel_diffs_ve3d(out64, ref64).values())
    worst_abs = max(worst_abs, abs_diff(out64, ref64))
    emit("f64_126_parity_ve3d", nout=200, max_rel_diff=worst64, tol=TOL_VE3D_NOUT200)
    check(worst64 <= TOL_VE3D_NOUT200, f"f64 126^3: {worst64}")
    del carry, co, carry64, co64, out, ref, ref64, out64

    # ---- 17. timing, bench_kernels.py::ve3d at 126^3 and 254^3 f32
    timing = {}
    for n, nk, npl in ((126, 200, 10), (254, 100, 3)):
        carry, co, inv_di, words_b = ve3d_bench_inputs(n, torch.float32, dev)
        tk, tp = time_ve3d(carry, co, inv_di, nk, npl)
        t_k, t_p = min(tk), min(tp)
        t_eff = words_b * n ** 3 * 4 / (t_k * 1e-3)
        bound = bound_ms(words_b, n ** 3, 4, kind)
        timing[n] = (t_k, t_p, bound)
        emit("timing_ve3d", n=n, dtype="float32", n_canvas=int(co.stack.shape[0]), words=words_b,
             kernel_ms_per_iter=tk, plain_ms_per_iter=tp, T_eff_GBs=t_eff / 1e9,
             T_eff_35_word_convention_GBs=35 * n ** 3 * 4 / (t_k * 1e-3) / 1e9,
             hbm_peak_GBs=HBM_PEAK[kind] / 1e9, hbm_share=t_eff / HBM_PEAK[kind],
             bound_ms=bound, bound_share=bound / t_k, plain_over_kernel=t_p / t_k,
             nvidia_smi=smi)
        del carry, co
    h3.stokes3d_chunk.launches = main_launches  # comparison launches do not count
    return {
        "name": "stokes3d_chunk",
        "route": "cuda",
        "source": "justrelax_tpu_torch/csrc/stokes3d_ve.cu",
        "replaces": ("justrelax_tpu/ops/pallas_stokes3d_blocked.py:296 "
                     "(B7 stokes3d_chunk_blocked)"),
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "max_rel_diff_f64": worst_rel,
        "max_rel_diff_f32_126": worst32,
        "ms": t_main,
        "plain_ms": tp_main,
        "bound_ms": bound_main,
        "bound_by": "bytes",
        "library_ms": None,
        "parent_ms": None if t_parent is None else min(t_parent[::2]),
        "words": words,
        "ve3d_ms_126": timing[126][0],
        "ve3d_plain_ms_126": timing[126][1],
        "ve3d_bound_ms_126": timing[126][2],
        "ve3d_ms_254": timing[254][0],
        "ve3d_plain_ms_254": timing[254][1],
        "ve3d_bound_ms_254": timing[254][2],
    }


# ---- the 3D VEP edge kernel (B6/B9) ----------------------------------------
def vep3d_numpy(name, n=10, ni=None):
    """numpy inputs of one configuration of the edge kernel's parity phase,
    from a seed: a dict with the grid (``ni``, ``li``), the materials
    (``mats``, Material keyword dicts), the cell phase index, the staggered
    state (V×3, P, θ, τ_c×6, τ_e×3, η, λ, λ_e×3), the old stresses
    (τ_o_c×6, τ_o_e×3), EII, P0, Q, dt and the CFL number.

    "blocked_plastic"/"blocked_elastic" are the set-up of
    tests/test_pallas_vep3d_blocked.py::_setup at n³ (pure shear, a
    spherical weak inclusion, zero stresses, τxx_o = −τyy_o = 0.3 with
    plasticity on, C = 1e9 with it off). "noncubic_near_yield" is a
    (11, 8, 6) grid with unequal spacings, random stresses, multipliers and
    pressures around the yield stress, dilatancy, a tension cap and a finite
    Kb, on a random two-phase field (seed 11), or the same on the grid
    ``ni``. "buoyant_powerlaw" adds to it
    a density ρ(T, P)·g with a random temperature (seed 2) and a power-law
    creep table (n = 3): the body force and the power-law viscosity target
    of the fused chunk."""
    if name == "buoyant_powerlaw":
        d = vep3d_numpy("noncubic_near_yield", n, ni)
        d["mats"] = [dict(m, rho0=1.0 + k, alpha=0.1, T0=0.5, beta=0.01, gravity=1.0,
                          disl_A=0.5, disl_n=3.0) for k, m in enumerate(d["mats"])]
        d["T"] = 0.5 + 0.1 * np.random.default_rng(2).standard_normal(d["ni"])
        return d
    if name in ("blocked_plastic", "blocked_elastic"):
        plastic = name == "blocked_plastic"
        ni, li = (n, n, n), (1.0, 1.0, 1.0)
        common = dict(rho0=0.0, Kb=4.0, is_plastic=1.0,
                      C=(0.2 if plastic else 1.0e9) / math.cos(math.radians(30.0)),
                      friction_angle=30.0, dilation_angle=0.0, eta_reg=1.25e-2)
        mats = [dict(G=1.0, eta0=1.0, **common), dict(G=0.5, eta0=0.1, **common)]
        geometry = Geometry(ni, li)
        X, Y, Z = np.meshgrid(*[np.asarray(c) for c in geometry.xci], indexing="ij")
        inside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Z - 0.5) ** 2 <= 0.04
        xv, zv = np.asarray(geometry.xvi[0]), np.asarray(geometry.xvi[2])
        V = (np.broadcast_to(xv[:, None, None], (n + 1, n + 2, n + 2)).copy(),
             np.zeros((n + 2, n + 1, n + 2)),
             np.broadcast_to(-zv[None, None, :], (n + 2, n + 2, n + 1)).copy())
        z = np.zeros(ni)
        edges = (np.zeros((n, n + 1, n + 1)), np.zeros((n + 1, n, n + 1)),
                 np.zeros((n + 1, n + 1, n)))
        txx_o = np.full(ni, 0.3 if plastic else 0.0)
        d = dict(phase=inside.astype(np.int64), V=V, P=z, theta=z, tau_c=(z,) * 6, tau_e=edges,
                 eta=np.where(inside, 0.1, 1.0), lam=z, lam_e=edges,
                 tau_o_c=(txx_o, -txx_o, z, z, z, z), tau_o_e=edges, EII=z, P0=z, Q=z,
                 dt=0.125)
    elif name == "noncubic_near_yield":
        ni, li = ni or (11, 8, 6), (1.0, 1.0, 1.0)
        nx, ny, nz = ni
        rng = np.random.default_rng(11)
        common = dict(rho0=0.0, Kb=6.0, is_plastic=1.0, C=0.3 / math.cos(math.radians(30.0)),
                      friction_angle=30.0, dilation_angle=10.0, eta_reg=1.0e-2,
                      tension_pT=-0.6)
        mats = [dict(G=1.0, eta0=1.0, **common), dict(G=0.6, eta0=0.2, **common)]

        def r(*shape, scale=0.3):
            return scale * rng.standard_normal(shape)

        eshape = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz))
        geometry = Geometry(ni, li)
        xv, zv = np.asarray(geometry.xvi[0]), np.asarray(geometry.xvi[2])
        V = (xv[:, None, None] + r(nx + 1, ny + 2, nz + 2, scale=0.05),
             r(nx + 2, ny + 1, nz + 2, scale=0.05),
             -zv[None, None, :] + r(nx + 2, ny + 2, nz + 1, scale=0.05))
        P = r(*ni, scale=0.15)
        d = dict(phase=(rng.random(ni) < 0.3).astype(np.int64), V=V, P=P,
                 theta=P + r(*ni, scale=0.02),
                 tau_c=tuple(r(*ni) for _ in range(6)), tau_e=tuple(r(*s) for s in eshape),
                 eta=np.exp(r(*ni)), lam=np.abs(r(*ni, scale=0.05)),
                 lam_e=tuple(np.abs(r(*s, scale=0.05)) for s in eshape),
                 tau_o_c=tuple(r(*ni) for _ in range(6)), tau_o_e=tuple(r(*s) for s in eshape),
                 EII=np.abs(r(*ni, scale=0.01)), P0=P, Q=np.zeros(ni), dt=0.2)
    else:
        raise ValueError(name)
    d.update(ni=ni, li=li, mats=mats, CFL=0.75 / math.sqrt(3.1))
    return d


def _vep3d_inputs(geometry, material, pr_c, pr_e, V, P, theta, tau_c, tau_e, eta, lam, lam_e,
                  tau_o_c, tau_o_e, EII, P0, Q, dt, pt, T=None):
    """(carry, consts for B6 and B8, consts for B9, material, inv_di, chunk
    keywords) of one configuration."""
    carry = pack_vep_carry(V, P, theta, tau_c, tau_e, eta, lam, lam_e)
    ckw = dict(tau_o_c6=tau_o_c, tau_o_e3=tau_o_e, EII_pl=EII, P0=P0, Q=Q,
               phase_ratios_center=pr_c, phase_ratios_edges=pr_e, T=T,
               scalar_plastic=True, scalar_K=True)
    co6 = vep3d_canvas_consts(material, hoist_tau_o=False, **ckw)
    co9 = vep3d_canvas_consts(material, hoist_tau_o=True, **ckw)
    kw = dict(dt=dt, r=pt.r, theta_dtau=pt.theta_dtau, etadtau=pt.etadtau,
              lambda_relaxation=0.2, viscosity_relaxation=1.0e-2)
    return carry, co6, co9, material, tuple(1.0 / d for d in geometry.di), kw


def vep3d_case(name, dtype, dev, n=10, ni=None):
    """Inputs of the 3D VEP kernels' parity phases: (carry, consts for B6
    and B8, consts for B9, material, inv_di, chunk keywords). The numpy
    configurations of :func:`vep3d_numpy` (``ni``: the grid of
    "noncubic_near_yield"), and "shearband3d_kb_inf":
    ShearBand3D's own set-up (``models/shearband3d._setup``, Kb = ∞) at n³
    with random stresses, multipliers and old stresses around its yield
    stress 1.6 (seed 13)."""
    kw = dict(dtype=dtype, device=dev)

    def t(a):
        if isinstance(a, tuple):
            return tuple(map(t, a))
        return torch.as_tensor(np.ascontiguousarray(a), **kw)

    if name == "shearband3d_kb_inf":
        geometry, st, material, (pr_c, pr_e), _, pt, dt = shearband3d._setup(n, dtype, dev)
        rng = np.random.default_rng(13)
        ni = (n, n, n)
        eshape = ((n, n + 1, n + 1), (n + 1, n, n + 1), (n + 1, n + 1, n))

        def r(*shape, scale=0.5, mean=0.0):
            return t(mean + scale * rng.standard_normal(shape))

        normals = (r(*ni, mean=1.6), r(*ni, mean=-1.6), r(*ni))
        return _vep3d_inputs(
            geometry, material, pr_c, pr_e, (st.V.Vx, st.V.Vy, st.V.Vz), st.P, st.P,
            normals + tuple(r(*ni) for _ in range(3)), tuple(r(*s) for s in eshape),
            st.viscosity.eta, st.lam, tuple(r(*s, scale=0.05).abs() for s in eshape),
            normals + tuple(r(*ni) for _ in range(3)), tuple(r(*s) for s in eshape),
            st.EII_pl, st.P, st.Q, dt, pt)
    d = vep3d_numpy(name, n, ni)
    geometry = Geometry(d["ni"], d["li"])
    material = MaterialStack.make([Material(**m) for m in d["mats"]], **kw)
    pr = phase_ratios_from_field(torch.as_tensor(d["phase"], device=dev), 2, dtype=dtype)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=d["CFL"])
    return _vep3d_inputs(
        geometry, material, pr.center, (pr.edge_yz, pr.edge_xz, pr.edge_xy), t(d["V"]),
        t(d["P"]), t(d["theta"]), t(d["tau_c"]),
        t(d["tau_e"]), t(d["eta"]), t(d["lam"]), t(d["lam_e"]), t(d["tau_o_c"]),
        t(d["tau_o_e"]), t(d["EII"]), t(d["P0"]), t(d["Q"]), d["dt"], pt,
        T=t(d["T"]) if "T" in d else None)


def edge_args(carry, co, inv_di, kw):
    """(positional, keyword) arguments of one ``vep3d_edges`` call on the
    canvases of ``carry``."""
    return ((carry.V, carry.theta, carry.eta, carry.tau_c[:3], carry.tau_e, carry.lam_e, co,
             inv_di),
            dict(dt=kw["dt"], theta_dtau=kw["theta_dtau"],
                 lambda_relaxation=kw["lambda_relaxation"]))


def check_edges_kept(carry, out, label):
    """The slots a family does not own come back bit-equal to the input."""
    _, Me = edge_masks(tuple(carry.P.shape), carry.P.device)
    kept = all(torch.equal(o[~Me[k % 3].expand(o.shape)], b[~Me[k % 3].expand(o.shape)])
               for k, (o, b) in enumerate(zip(out, (*carry.tau_e, *carry.lam_e))))
    check(kept, f"{label}: a slot outside the owned edges moved")


def flat_vep_carry(c: VEP3DCanvasCarry):
    return (*c.V, c.P, c.theta, *c.tau_c, *c.tau_e, c.eta, c.lam, *c.lam_e)


def rel_diffs_edges(a, b):
    """max |a − b| of the six edge outputs relative to the field's max |b|
    (b the plain version), with no floor."""
    return _rel_no_floor(VEP3D_EDGE_FIELDS, a, b)


def rel_diffs_vep3d(a, b):
    """max |a − b| per carry canvas relative to the canvas's max |b|, the max
    floored at 1, as rel_diffs: the configurations are non-dimensional with
    O(1) fields, and θ and the velocities transverse to the pure shear are
    zero up to rounding."""
    return {name: float((x - y).abs().max()) / max(float(y.abs().max()), 1.0)
            for name, x, y in zip(VEP3D_CARRY_FIELDS, flat_vep_carry(a), flat_vep_carry(b))}


def hybrid_chunk(carry, co, material, inv_di, kw, nit, split, plain=False, packed=None):
    """``nit`` hybrid iterations, the edge passes in B6 (B9 with ``split``)
    or, with ``plain``, in their plain version; ``packed`` the edge consts
    when already packed."""
    packed = he.pack_edge_consts(co, split) if packed is None else packed
    fn = he.vep3d_edges_reference if plain else he.vep3d_edges
    return vep3d_chunk_canvas(carry, co, material, inv_di, nit,
                              edges_fn=functools.partial(fn, co=packed, split=split), **kw)


def fused_chunk(carry, co, inv_di, kw, nit, plain=False):
    """``nit`` iterations of the fused chunk (B8) or, with ``plain``, of its
    plain version."""
    fn = hc.stokes3d_vep_chunk_reference if plain else hc.stokes3d_vep_chunk
    return fn(carry, co, inv_di, nit, **kw)


def vep3d_chunk_states(n, dtype, dev):
    """B8's inputs on its main path at n³: the first chunk of the ShearBand3D
    step on "blocked" (as solve_vep_3d builds it) and ShearBand3D's set-up
    near yield: {label: (carry, packed consts, inv_di, chunk keywords)}."""
    geometry, st0, material, (pr_c, pr_e), _, pt, dt = shearband3d._setup(n, dtype, dev)
    carry, _, packed = canvas_chunk_inputs(st0, material, pr_c, pr_e, route="blocked")
    kw = dict(dt=dt, r=pt.r, theta_dtau=pt.theta_dtau, etadtau=pt.etadtau,
              lambda_relaxation=0.2, viscosity_relaxation=1.0)
    near, co_near, _, _, inv_near, kw_near = vep3d_case("shearband3d_kb_inf", dtype, dev, n=n)
    return {"first_chunk": (carry, packed, tuple(1.0 / d for d in geometry.di), kw),
            "near_yield": (near, hc.pack_chunk_consts(co_near), inv_near, kw_near)}


def vep3d_chunk_words(packed):
    """Words per slot that one fused iteration must move: the 19 carry
    canvases read and written, and each constant canvas that does not hold
    one value on the slots it is read on (the kernel takes those as
    scalars)."""
    return 2 * 19 + sum(t is not None for t in packed.canvases)


def vep3d_edges_words(packed):
    """Words per slot that one edge-kernel call must move: 14 dynamic inputs
    read, 6 outputs written, and each G_e and old-stress canvas that does
    not hold one value on the slots it is read on (the kernel takes those as
    scalars): at most 29 for B6 (τ_o_c normals×3, τ_o_e×3 and G_e×3), 41 for
    B9 (18 hoisted τ_o and G_e×3)."""
    tau_o = packed.tau_o if packed.split else packed.tau_o[:1]
    return 20 + sum(g is not None for g in packed.G) + \
        sum(t is not None for fam in tau_o for t in fam)


# Operations of the edge passes (each add, subtract, multiply, division and
# root one; comparisons and selects none), counted from csrc/stokes3d_vep.cu:
# per owned slot of a family, the eight center averages (6 each), 1/eta_e,
# 1/(G_e dt) and dtau (7), the four averages of the two other families (24),
# the trial stress (54), its invariant (13), the cone without a tension cap
# (6; with one 15; the volume term with a finite K 3) and the update (1);
# a slot that yields 15 more, and each tau_o canvas B6 averages 6; per
# point, once, the normal strain rates and 1/eta at a cell (15) and the
# three shear strain rates at an edge point (18)
EDGE_FAMILY_OPS, EDGE_CAP_OPS, EDGE_K_OPS, EDGE_YIELD_OPS, EDGE_AVG_OPS = 153, 9, 3, 15, 6
EDGE_CELL_OPS, EDGE_POINT_OPS = 15, 18
FLOPS_F32 = {"PCIe": 51.2e12, "SXM": 67.0e12}  # FLOP/s outside the tensor cores, data sheets


def vep3d_edges_ops(packed, lam_in, lam_out):
    """Operations one edge-kernel call needs on these inputs (the counts
    above): the slots each family owns, the ones that yield (λ_e moved from
    ``lam_in`` to ``lam_out``), whether a tension cap or a finite K is
    there, and for B6 each τ_o canvas a family averages."""
    shape = tuple(lam_in[0].shape)
    nx, ny, nz = (d - 2 for d in shape)
    _, Me = edge_masks(shape, lam_in[0].device)
    pT, K = packed.scalars[7], packed.scalars[-1]
    per = EDGE_FAMILY_OPS + (EDGE_CAP_OPS if pT != 0 else 0) + \
        (EDGE_K_OPS if math.isfinite(K) else 0)
    ops = nx * ny * nz * EDGE_CELL_OPS + (nx + 1) * (ny + 1) * (nz + 1) * EDGE_POINT_OPS
    for k, (m, a, b) in enumerate(zip(Me, lam_in, lam_out)):
        m = m.expand(shape)
        averaged = 0 if packed.split else sum(
            packed.tau_o[k][j] is not None for j in (0, 1, 2, 3 + (k + 1) % 3, 3 + (k + 2) % 3))
        ops += int(m.sum()) * (per + EDGE_AVG_OPS * averaged)
        ops += int((m & (a != b)).sum()) * EDGE_YIELD_OPS
    return ops


def edge_bounds(packed, lam_in, lam_out, kind):
    """(bound_ms, bound_by, bytes bound ms, operations bound ms, words,
    operations) of one edge-kernel call on these f32 inputs: the larger of
    the words it must move over the HBM peak and its operations over the
    f32 peak."""
    words = vep3d_edges_words(packed)
    n = math.prod(d - 2 for d in lam_in[0].shape)
    by_bytes = bound_ms(words, n, 4, kind)
    ops = vep3d_edges_ops(packed, lam_in, lam_out)
    by_ops = ops / FLOPS_F32[kind] * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", by_bytes,
            by_ops, words, ops)


def vep3d_hybrid_setup(dtype, dev):
    """bench.py's vep3d_hybrid configuration (bench.py:332-394) at 10³:
    (positional, keyword) arguments of ``solve_vep_3d``."""
    n = 10
    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    kw = dict(dtype=dtype, device=dev)
    common = dict(Kb=4.0, eta0=1.0, is_plastic=1.0, C=0.15 / math.cos(math.radians(30.0)),
                  friction_angle=30.0, eta_reg=8.0e-3)
    mat = MaterialStack.make([Material(G=1.0, **common), Material(G=0.5, **common)], **kw)
    X, Y, Z = geometry.cell_centers_mesh()
    sph = ((X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Z - 0.5) ** 2) < 0.15 ** 2
    pr = phase_ratios_from_field(torch.as_tensor(sph.astype(np.int64), device=dev), 2,
                                 dtype=dtype)
    st = StokesState.make(ni, **kw)
    st = st.replace(viscosity=st.viscosity.replace(eta=torch.ones(ni, **kw)))
    xv = torch.as_tensor(geometry.xvi[0], **kw)
    zv = torch.as_tensor(geometry.xvi[2], **kw)
    bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True,
                                                    front=True, back=True))
    V = flow_bcs((xv[:, None, None].expand(n + 1, n + 2, n + 2),
                  torch.zeros((n + 2, n + 1, n + 2), **kw),
                  (-zv)[None, None, :].expand(n + 2, n + 2, n + 1)), bc)
    st = st.replace(V=st.V.replace(Vx=V[0], Vy=V[1], Vz=V[2]))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, eps_rel=1.0e-5, eps_abs=1.0e-5,
                             CFL=0.75 / math.sqrt(3.1))
    return ((st, pt, geometry, bc, mat, pr.center, (pr.edge_yz, pr.edge_xz, pr.edge_xy), 0.25),
            dict(iter_max=3000, iter_min=100, nout=100))


def vep3d_bench_inputs(n, dtype, dev):
    """bench_kernels.py::vep3d_canvas (:1026-1165) at n³, the configuration
    of its pallas_vep3d_edges family: ShearBand3D-like material with Kb = 4,
    a weak inclusion of radius 0.1, τxx_o = −τyy_o = 1, zero stresses, dt =
    0.125. Returns (carry, consts for B6, consts for B9, the plain canvas
    chunk's consts, material, inv_di, chunk keywords)."""
    kw = dict(dtype=dtype, device=dev)
    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    common = dict(rho0=0.0, Kb=4.0, is_plastic=1.0, C=1.6 / math.cos(math.radians(30.0)),
                  friction_angle=30.0, dilation_angle=0.0, eta_reg=1.25e-2)
    material = MaterialStack.make([Material(G=1.0, eta0=1.0, **common),
                                   Material(G=0.5, eta0=0.1, **common)], **kw)
    X, Y, Z = geometry.cell_centers_mesh()
    inside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Z - 0.5) ** 2 <= 0.01
    pr = phase_ratios_from_field(torch.as_tensor(inside.astype(np.int64), device=dev), 2,
                                 dtype=dtype)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.75 / math.sqrt(3.1))
    bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True,
                                                    front=True, back=True))
    xv = torch.as_tensor(geometry.xvi[0], **kw)
    zv = torch.as_tensor(geometry.xvi[2], **kw)
    V = flow_bcs((xv[:, None, None].expand(n + 1, n + 2, n + 2),
                  torch.zeros((n + 2, n + 1, n + 2), **kw),
                  (-zv)[None, None, :].expand(n + 2, n + 2, n + 1)), bc)
    z = torch.zeros(ni, **kw)
    edges = (torch.zeros((n, n + 1, n + 1), **kw), torch.zeros((n + 1, n, n + 1), **kw),
             torch.zeros((n + 1, n + 1, n), **kw))
    eta = torch.where(torch.as_tensor(inside, device=dev), 0.1, 1.0).to(dtype)
    one = torch.ones(ni, **kw)
    carry, co6, co9, material, inv_di, ckw = _vep3d_inputs(
        geometry, material, pr.center, (pr.edge_yz, pr.edge_xz, pr.edge_xy), V, z, z,
        (z,) * 6, edges, eta, z, edges,
        (one, -one, z, z, z, z), edges, z, z, z, 0.125, pt)
    co_plain = vep3d_canvas_consts(material, (one, -one, z, z, z, z), edges, z, z, z,
                                   pr.center, (pr.edge_yz, pr.edge_xz, pr.edge_xy))
    return carry, co6, co9, co_plain, material, inv_di, ckw


def time_pair(kernel, plain, nk=1, npl=1):
    """ms per call of ``kernel`` and ``plain``, in turns kernel, plain,
    plain, kernel: ([k1, k2], [p1, p2])."""
    tk1 = cuda_time_ms(kernel) / nk
    tp1 = cuda_time_ms(plain) / npl
    tp2 = cuda_time_ms(plain) / npl
    tk2 = cuda_time_ms(kernel) / nk
    return [tk1, tk2], [tp1, tp2]


EDGE_CALLS = 20  # edge-kernel calls per timed run


def time_edges_main(args, ekw, split, kind, smi, state="first_chunk"):
    """B6 (B9 with ``split``) per call over EDGE_CALLS calls back to back,
    and its plain version per call, on these f32 inputs, in turns, with the
    parent tree's kernel (--parent DIR) in turns
    parent, this, this, parent, and its bounds; holds the kernel to the
    parent's (vs_parent_edges). Returns {ms, plain_ms, parent_ms, bound_ms,
    ...}."""
    label = "B9" if split else "B6"

    def calls(fn, a):  # back to back, so that the card and not the host sets the time
        return lambda: [fn(*a, split=split, **ekw) for _ in range(EDGE_CALLS)]

    tk, tp = time_pair(calls(he.vep3d_edges, args),
                       lambda: he.vep3d_edges_reference(*args, split=split, **ekw), EDGE_CALLS)
    out = he.vep3d_edges(*args, split=split, **ekw)
    bound, bound_by, by_bytes, by_ops, words, ops = edge_bounds(
        he.pack_edge_consts(args[6], split), args[5], out[1], kind)
    t_parent, parent = None, vs_parent_edges(args, ekw, (*out[0], *out[1]), split,
                                             f"{label} {state}")
    old = parent_edges()
    if old is not None:
        co = old.pack_edge_consts(args[6].co, split)
        a_old = args[:6] + (co,) + args[7:]
        t_parent = [cuda_time_ms(calls(fn, a)) / EDGE_CALLS
                    for fn, a in ((old.vep3d_edges, a_old), (he.vep3d_edges, args),
                                  (he.vep3d_edges, args), (old.vep3d_edges, a_old))]
    n = math.prod(d - 2 for d in args[1].shape)
    emit("main_path_vep3d_timing", kernel=label, state=state, n_cells=n, words=words,
         ops=ops, kernel_ms=tk, plain_ms=tp, parent_then_kernel_ms=t_parent,
         **parent, bound_ms=bound, bound_by=bound_by, bytes_bound_ms=by_bytes,
         ops_bound_ms=by_ops, bound_share=bound / min(tk), nvidia_smi=smi)
    return dict(ms=min(tk), plain_ms=min(tp),
                parent_ms=None if t_parent is None else min(t_parent[0], t_parent[3]),
                bound_ms=bound, bound_by=bound_by, bytes_bound_ms=by_bytes,
                ops_bound_ms=by_ops, words=words, ops=ops)


def run_vep3d(dev, smi, kind):
    """Phases 18-21, the 3D VEP solve; returns the entries of the edge
    kernel's two routes (B6, B9) in the kernels line."""
    # ---- 18. B6 and B9 against their plain version, f64 and f32
    worst_rel, worst_abs, worst32 = 0.0, 0.0, 0.0
    for case in VEP3D_CASES:
        inputs = {dt: vep3d_case(case, dt, dev) for dt in (torch.float64, torch.float32)}
        for split in (False, True):
            label = f"{case}_{'B9' if split else 'B6'}"
            res = {}
            for dt, (carry, co6, co9, material, inv_di, kw) in inputs.items():
                co = co9 if split else co6
                args, ekw = edge_args(carry, co, inv_di, kw)
                out = he.vep3d_edges(*args, split=split, **ekw)
                ref = he.vep3d_edges_reference(*args, split=split, **ekw)
                torch.cuda.synchronize()
                out, ref = (*out[0], *out[1]), (*ref[0], *ref[1])
                res[dt] = (out, ref)
                check_edges_kept(carry, out, label)
                parent = vs_parent_edges(args, ekw, out, split, label)
                if parent:
                    emit("parent_vep3d_edges", case=label, dtype=str(dt), **parent)
            (o64, r64), (o32, r32) = res[torch.float64], res[torch.float32]
            d = rel_diffs_edges(o64, r64)
            worst = max(d.values())
            gap32 = max(rel_diffs_edges(o32, r32).values())
            p32 = max(rel_diffs_edges(tuple(x.double() for x in r32), r64).values())
            tol32 = max(TOL_F32_1024, 2.0 * p32)
            worst_rel, worst_abs = max(worst_rel, worst), max(worst_abs, abs_diff(o64, r64))
            worst32 = max(worst32, gap32)
            emit("parity_vep3d", case=label, call="one", max_rel_diff=worst, tol=TOL_VEP3D_CALL,
                 f32_max_rel_diff=gap32, f32_tol=tol32, plain_f32_vs_plain_f64=p32,
                 lam_e_max=max(float(x.max()) for x in r64[3:]), per_field=d)
            check(worst <= TOL_VEP3D_CALL, f"{label} one call: {worst}")
            check(gap32 <= tol32, f"{label} one call f32: {gap32} > {tol32}")

            carry, co6, co9, material, inv_di, kw = inputs[torch.float64]
            co = co9 if split else co6
            for nit, tol in ((1, TOL_VEP3D_CALL), (50, TOL_VEP3D_NOUT50)):
                out = hybrid_chunk(carry, co, material, inv_di, kw, nit, split)
                ref = hybrid_chunk(carry, co, material, inv_di, kw, nit, split, plain=True)
                torch.cuda.synchronize()
                d = rel_diffs_vep3d(out, ref)
                worst = max(d.values())
                worst_rel = max(worst_rel, worst)
                lam_max = max(float(x.max()) for x in ref.lam_e)
                emit("parity_vep3d", case=label, call="hybrid_chunk", nout=nit,
                     max_rel_diff=worst, tol=tol, lam_e_max=lam_max, per_field=d)
                check(worst <= tol, f"{label} nout={nit}: {worst} > {tol}")
                if nit == 50 and case != "blocked_elastic":
                    check(lam_max > 0.0, f"{label}: plasticity inactive on the edges")
            # f32, F32_VEP3D_NOUT hybrid iterations: 1e-4, or twice the plain
            # version's own f32 error against f64
            c32, co6_32, co9_32, mat32, _, kw32 = inputs[torch.float32]
            co32 = co9_32 if split else co6_32
            n32 = F32_VEP3D_NOUT
            out = hybrid_chunk(c32, co32, mat32, inv_di, kw32, n32, split)
            ref = hybrid_chunk(c32, co32, mat32, inv_di, kw32, n32, split, plain=True)
            ref64 = hybrid_chunk(carry, co, material, inv_di, kw, n32, split, plain=True)
            gap = max(rel_diffs_vep3d(out, ref).values())
            p32 = max(rel_diffs_vep3d(VEP3DCanvasCarry(*(
                tuple(x.double() for x in f) if isinstance(f, tuple) else f.double()
                for f in ref)), ref64).values())
            tol32 = max(TOL_F32_1024, 2.0 * p32)
            worst32 = max(worst32, gap)
            emit("parity_vep3d", case=label, call="hybrid_chunk_f32", nout=n32,
                 max_rel_diff=gap, tol=tol32, plain_f32_vs_plain_f64=p32)
            check(gap <= tol32, f"{label} f32 nout={n32}: {gap} > {tol32}")
        del inputs
    # the random near-yield configuration on ragged grids: one call, f64 and
    # f32, against the plain version (and bit for bit the parent's kernel
    # with --parent)
    for ni, split in itertools.product(VEP3D_EDGE_RAGGED, (False, True)):
        label = f"ragged_{'_'.join(map(str, ni))}_{'B9' if split else 'B6'}"
        res = {}
        for dt in (torch.float64, torch.float32):
            carry, co6, co9, _, inv_di, kw = vep3d_case("noncubic_near_yield", dt, dev, ni=ni)
            args, ekw = edge_args(carry, co9 if split else co6, inv_di, kw)
            out = he.vep3d_edges(*args, split=split, **ekw)
            ref = he.vep3d_edges_reference(*args, split=split, **ekw)
            out, ref = (*out[0], *out[1]), (*ref[0], *ref[1])
            check_edges_kept(carry, out, label)
            res[dt] = (out, ref, vs_parent_edges(args, ekw, out, split, label))
        (o64, r64, par64), (o32, r32, par32) = res[torch.float64], res[torch.float32]
        worst = max(rel_diffs_edges(o64, r64).values())
        gap32 = max(rel_diffs_edges(o32, r32).values())
        p32 = max(rel_diffs_edges(tuple(x.double() for x in r32), r64).values())
        tol32 = max(TOL_F32_1024, 2.0 * p32)
        worst_rel, worst_abs = max(worst_rel, worst), max(worst_abs, abs_diff(o64, r64))
        worst32 = max(worst32, gap32)
        emit("parity_vep3d", case=label, call="one", max_rel_diff=worst, tol=TOL_VEP3D_CALL,
             f32_max_rel_diff=gap32, f32_tol=tol32, parent_f64=par64, parent_f32=par32)
        check(worst <= TOL_VEP3D_CALL, f"{label}: {worst}")
        check(gap32 <= tol32, f"{label} f32: {gap32} > {tol32}")

    # ---- 19. goldens through the default entry points, f64: the default
    # route (B6), the fused chunk (B8) and the serial path
    args, kw = vep3d_hybrid_setup(torch.float64, dev)
    t0 = time.perf_counter()
    out_x, info_x = solve_vep_3d(*args, use_kernel=False, **kw)
    t_x = time.perf_counter() - t0
    scale = float(out_x.tau.II.abs().max())
    for route, counter in ((None, (he.vep3d_edges, "launches")),
                           ("blocked", (hc.stokes3d_vep_chunk, "launches"))):
        setattr(*counter, 0)
        t0 = time.perf_counter()
        out_h, info_h = solve_vep_3d(*args, use_kernel=route, **kw)
        t_h = time.perf_counter() - t0
        launches = getattr(*counter)
        gap = float((out_h.tau.II - out_x.tau.II).abs().max()) / scale
        v = float(out_h.tau.II.abs().max())
        rel_abs = abs(v - GOLDEN_VEP3D_HYBRID) / GOLDEN_VEP3D_HYBRID
        label = "B6" if route is None else "B8"
        emit("golden_vep3d", case="vep3d_hybrid_10", kernel=label, tauII_max=v,
             tauII_max_serial=scale, golden_f64=GOLDEN_VEP3D_HYBRID, rel_vs_golden=rel_abs,
             rel_gap=gap, iters=int(info_h.iters), iters_serial=int(info_x.iters),
             err=float(info_h.err), launches=launches, seconds=t_h, seconds_serial=t_x)
        check(out_h.P.device.type == "cuda", "vep3d_hybrid: the default device is not the card")
        check(rel_abs < 2e-2 and gap < 1e-3 and math.isfinite(scale) and scale > 0,
              f"vep3d_hybrid {label}: gap {gap}, rel {rel_abs}")
        check(launches > 0, f"vep3d_hybrid: {label} was not launched")

    # ShearBand3D n=12 nt=14 on tests/test_shearband3d.py's goldens takes
    # 54-86 s on an H100, bound by the host's dispatch of the hybrid
    # iteration's plain launches: it runs as tests/test_torch_cuda.py::
    # test_shearband3d_golden_f64 (slow) instead

    # ---- 20. main path: ShearBand3D at 126^3 f32, one step, the default entry
    n = 126
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, info, tau, _ = shearband3d.run(n=n, nt=1, dtype=torch.float32, iter_max=2_000,
                                       nout=200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = he.vep3d_edges.launches
    other = sum(counts().values()) - main_launches
    check(st.P.device.type == "cuda", "main path 3D VEP: the default device is not the card")
    finite = all(bool(torch.isfinite(t).all()) for t in (
        st.V.Vx, st.V.Vy, st.V.Vz, st.P, st.tau.xx, st.tau.zz, st.tau.yz, st.tau.xz,
        st.tau.xy, st.tau.II, st.viscosity.eta, st.EII_pl))
    emit("main_path_vep3d", n=n, dtype="float32", iters=int(info.iters), err=float(info.err),
         tauII_max=tau[-1], wall_s=wall, wall_ms_per_iter=wall / int(info.iters) * 1e3,
         launches=main_launches, other_launches=other, finite=finite)
    check(finite, "main path 3D VEP: non-finite fields")
    check(main_launches > 0, "main path 3D VEP: B6 was not launched")
    tau_edges = tau[-1]
    del st

    # B6 and its plain version on the solve's first-chunk inputs, built by the
    # solver's own canvas_chunk_inputs: the kernels line's numbers for B6
    geometry, st0, material, (pr_c, pr_e), _, pt, dt = shearband3d._setup(n, torch.float32,
                                                                          dev)
    carry, co, packed = canvas_chunk_inputs(st0, material, pr_c, pr_e, route="edges")
    kw = dict(dt=dt, r=pt.r, theta_dtau=pt.theta_dtau, etadtau=pt.etadtau,
              lambda_relaxation=0.2, viscosity_relaxation=1.0)
    inv_di = tuple(1.0 / d for d in geometry.di)
    args, ekw = edge_args(carry, packed, inv_di, kw)
    main6 = time_edges_main(args, ekw, False, kind, smi)
    # 50 hybrid iterations kernel vs plain from those inputs, f32 against f64
    out = hybrid_chunk(carry, co, material, inv_di, kw, 50, False, packed=packed)
    ref = hybrid_chunk(carry, co, material, inv_di, kw, 50, False, plain=True, packed=packed)
    _, st64, mat64, (pr_c64, pr_e64), _, _, _ = shearband3d._setup(n, torch.float64, dev)
    carry64, co64, packed64 = canvas_chunk_inputs(st64, mat64, pr_c64, pr_e64, route="edges")
    ref64 = hybrid_chunk(carry64, co64, mat64, inv_di, kw, 50, False, plain=True,
                         packed=packed64)
    gap = max(rel_diffs_vep3d(out, ref).values())
    p32 = max(rel_diffs_vep3d(as_f64(ref), ref64).values())
    tol = max(TOL_F32_1024, 2.0 * p32)
    emit("f32_126_parity_vep3d", kernel="B6", nout=50, max_rel_diff=gap, tol=tol,
         plain_f32_vs_plain_f64=p32)
    check(gap <= tol, f"f32 126^3 VEP: {gap} > {tol}")
    del carry, co, packed, out, ref, carry64, co64, packed64, ref64, st64

    # the "edges_split" route (B9) on the same step, cut to 200 iterations
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, info9, tau9, _ = shearband3d.run(n=n, nt=1, dtype=torch.float32, iter_max=200,
                                         nout=100, use_kernel="edges_split")
    torch.cuda.synchronize()
    wall9 = time.perf_counter() - t0
    split_launches = he.vep3d_edges.split_launches
    other9 = sum(counts().values()) - split_launches
    finite9 = all(bool(torch.isfinite(t).all()) for t in (
        st.V.Vx, st.V.Vz, st.P, st.tau.xx, st.tau.yz, st.tau.II))
    emit("main_path_vep3d_split_route", n=n, dtype="float32", iters=int(info9.iters),
         err=float(info9.err), tauII_max=tau9[-1], wall_s=wall9,
         split_launches=split_launches, other_launches=other9, finite=finite9)
    check(finite9, "edges_split 126^3: non-finite fields")
    check(split_launches > 0 and other9 == 0,
          "edges_split 126^3: B9 was not launched, or another kernel was")
    del st
    # B9 and its plain version on that route's first-chunk inputs: the
    # kernels line's numbers for B9
    carry, co, packed = canvas_chunk_inputs(st0, material, pr_c, pr_e, route="edges_split")
    args, ekw = edge_args(carry, packed, inv_di, kw)
    main9 = time_edges_main(args, ekw, True, kind, smi)
    del carry, co, packed, args

    # the first-chunk inputs in f64: one call of B6 and B9 against the plain
    # version (and bit for bit the parent's kernel with --parent)
    _, st64, mat64, (pr_c64, pr_e64), _, _, _ = shearband3d._setup(n, torch.float64, dev)
    for split in (False, True):
        label = "B9" if split else "B6"
        carry64, _, packed64 = canvas_chunk_inputs(st64, mat64, pr_c64, pr_e64,
                                                   route="edges_split" if split else "edges")
        args, ekw = edge_args(carry64, packed64, inv_di, kw)
        out = he.vep3d_edges(*args, split=split, **ekw)
        ref = he.vep3d_edges_reference(*args, split=split, **ekw)
        out, ref = (*out[0], *out[1]), (*ref[0], *ref[1])
        d1 = max(rel_diffs_edges(out, ref).values())
        parent = vs_parent_edges(args, ekw, out, split, f"first chunk 126^3 {label} f64")
        emit("first_chunk_126_f64_vep3d", kernel=label, n=n, one_call_max_rel_diff=d1,
             tol=TOL_VEP3D_CALL, **parent)
        check(d1 <= TOL_VEP3D_CALL, f"first chunk 126^3 {label} f64: {d1}")
    del st64, carry64, packed64, args, out, ref

    # near yield at 126^3: ShearBand3D's set-up with old stresses, stresses
    # and multipliers around its yield stress (vep3d_case "shearband3d_kb_inf"),
    # so that the yield branch runs at full width: one call and 50 hybrid
    # iterations of B6 and B9 against the plain version (one call also bit
    # for bit against the parent's kernel with --parent), and their times there
    near = {d: vep3d_case("shearband3d_kb_inf", d, dev, n=n)
            for d in (torch.float64, torch.float32)}
    near_ms = {}
    for split in (False, True):
        label = "B9" if split else "B6"
        carry, co6, co9, material_n, inv_n, kw_n = near[torch.float64]
        co = co9 if split else co6
        args, ekw = edge_args(carry, co, inv_n, kw_n)
        out = he.vep3d_edges(*args, split=split, **ekw)
        ref = he.vep3d_edges_reference(*args, split=split, **ekw)
        parent = vs_parent_edges(args, ekw, (*out[0], *out[1]), split,
                                 f"near yield 126^3 {label} f64")
        d1 = max(rel_diffs_edges((*out[0], *out[1]), (*ref[0], *ref[1])).values())
        lam1 = max(float(x.max()) for x in ref[1])
        out = hybrid_chunk(carry, co, material_n, inv_n, kw_n, 50, split)
        ref64 = hybrid_chunk(carry, co, material_n, inv_n, kw_n, 50, split, plain=True)
        d50 = max(rel_diffs_vep3d(out, ref64).values())
        lam50 = max(float(x.max()) for x in ref64.lam_e)
        c32, co6_32, co9_32, mat32, _, kw32 = near[torch.float32]
        co32 = co9_32 if split else co6_32
        out = hybrid_chunk(c32, co32, mat32, inv_n, kw32, 50, split)
        ref = hybrid_chunk(c32, co32, mat32, inv_n, kw32, 50, split, plain=True)
        gap = max(rel_diffs_vep3d(out, ref).values())
        p32 = max(rel_diffs_vep3d(as_f64(ref), ref64).values())
        tol32 = max(TOL_F32_1024, 2.0 * p32)
        a32, e32 = edge_args(c32, he.pack_edge_consts(co32, split), inv_n, kw32)
        t = time_edges_main(a32, e32, split, kind, smi, state="near_yield")
        near_ms[split] = dict(near_yield_ms=t["ms"], near_yield_plain_ms=t["plain_ms"],
                              near_yield_parent_ms=t["parent_ms"],
                              near_yield_bound_ms=t["bound_ms"])
        emit("near_yield_126_vep3d", kernel=label, n=n, one_call_max_rel_diff=d1,
             tol=TOL_VEP3D_CALL, nout50_max_rel_diff=d50, nout50_tol=TOL_VEP3D_NOUT50,
             lam_e_max_one_call=lam1, lam_e_max_nout50=lam50, f32_nout50_max_rel_diff=gap,
             f32_tol=tol32, plain_f32_vs_plain_f64=p32, parent_f64=parent, **near_ms[split])
        check(d1 <= TOL_VEP3D_CALL, f"near yield 126^3 {label} one call: {d1}")
        check(d50 <= TOL_VEP3D_NOUT50, f"near yield 126^3 {label} nout=50: {d50}")
        check(gap <= tol32, f"near yield 126^3 {label} f32 nout=50: {gap} > {tol32}")
        check(lam1 > 0.0 and lam50 > 0.0, f"near yield 126^3 {label}: lambda_e stays 0")
        del out, ref, ref64

    # ---- 21. timing, bench_kernels.py's pallas_vep3d_edges set-up, 126^3 f32
    carry, co6, co9, co_plain, material, inv_di, kw = vep3d_bench_inputs(n, torch.float32, dev)
    timing = {}
    for split, co in ((False, co6), (True, co9)):
        packed = he.pack_edge_consts(co, split)
        args, ekw = edge_args(carry, packed, inv_di, kw)
        ekw["split"] = split
        tk, tp = time_pair(lambda: he.vep3d_edges(*args, **ekw),
                           lambda: he.vep3d_edges_reference(*args, **ekw))
        out = he.vep3d_edges(*args, **ekw)
        bound, bound_by, _, by_ops, words, ops = edge_bounds(packed, carry.lam_e, out[1], kind)
        t_k = min(tk)
        timing[split] = (t_k, min(tp), bound, words)
        emit("timing_vep3d", kernel="B9" if split else "B6", n=n, dtype="float32",
             words=words, ops=ops, kernel_ms=tk, plain_ms=tp,
             T_eff_GBs=words * n ** 3 * 4 / (t_k * 1e-3) / 1e9, bound_ms=bound,
             bound_by=bound_by, ops_bound_ms=by_ops, bound_share=bound / t_k,
             bound_ms_at_most=bound_ms(41 if split else 29, n ** 3, 4, kind),
             plain_over_kernel=min(tp) / t_k, nvidia_smi=smi)
    packed6 = he.pack_edge_consts(co6, False)
    nit = 20
    th, tc = time_pair(
        lambda: hybrid_chunk(carry, co6, material, inv_di, kw, nit, False, packed=packed6),
        lambda: vep3d_chunk_canvas(carry, co_plain, material, inv_di, nit, **kw), nit, nit)
    bound_it = bound_ms(WORDS_VEP3D, n ** 3, 4, kind)
    t_h = min(th)
    emit("timing_vep3d", kernel="hybrid_iteration", n=n, dtype="float32", words=WORDS_VEP3D,
         hybrid_ms_per_iter=th, plain_canvas_ms_per_iter=tc,
         T_eff_GBs=WORDS_VEP3D * n ** 3 * 4 / (t_h * 1e-3) / 1e9, bound_ms=bound_it,
         bound_share=bound_it / t_h, edges_share=timing[False][0] / t_h,
         plain_over_hybrid=min(tc) / t_h, nvidia_smi=smi)
    bench = dict(carry=carry, co6=co6, co_plain=co_plain, material=material, inv_di=inv_di,
                 kw=kw, hybrid_ms=t_h, plain_canvas_ms=min(tc))

    def entry(split, launches, main):
        b_k, b_p, b_bound, b_words = timing[split]
        line = ":449 (B9 vep3d_edges_split)" if split else ":242 (B6 vep3d_edges_blocked)"
        return {
            "name": "vep3d_edges_split" if split else "vep3d_edges",
            "route": "cuda",
            "source": "justrelax_tpu_torch/csrc/stokes3d_vep.cu",
            "replaces": "justrelax_tpu/ops/pallas_vep3d_edges.py" + line,
            "launches": launches,
            "max_abs_err": worst_abs,
            "max_rel_diff_f64": worst_rel,
            "max_rel_diff_f32": worst32,
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
            "parent_ms": main["parent_ms"],
            "bytes_bound_ms": main["bytes_bound_ms"],
            "ops_bound_ms": main["ops_bound_ms"],
            "words": main["words"],
            "ops": main["ops"],
            **near_ms[split],
            "bench_ms": b_k,
            "bench_plain_ms": b_p,
            "bench_bound_ms": b_bound,
            "bench_words": b_words,
            "hybrid_iteration_ms": t_h,
            "hybrid_iteration_bound_ms": bound_it,
        }

    return (entry(False, main_launches, main6), entry(True, split_launches, main9),
            bench, tau_edges)


counts = dc.kernel_counts  # the launch counter of every kernel wrapper
restore_counts = dc.set_kernel_counts  # every counter back to counts()'s


def reset_counts():
    dc.set_kernel_counts({})


def as_f64(c: VEP3DCanvasCarry):
    return VEP3DCanvasCarry(*(tuple(x.double() for x in f) if isinstance(f, tuple)
                              else f.double() for f in c))


def run_vep3d_chunk(dev, smi, kind, bench, tau_edges):
    """Phases 22-24, the fused 3D VEP chunk (B8); returns its entry in the
    kernels line."""
    # ---- 22. B8 against its plain version, f64 and f32
    worst_rel, worst_abs, worst32 = 0.0, 0.0, 0.0
    for case in VEP3D_CHUNK_CASES:
        inputs = {d: vep3d_case(case, d, dev) for d in (torch.float64, torch.float32)}
        carry, co, _, material, inv_di, kw = inputs[torch.float64]
        before = [t.clone() for t in flat_vep_carry(carry)]
        for nit, tol in ((1, TOL_VEP3D_CALL), (50, TOL_VEP3D_NOUT50)):
            out = fused_chunk(carry, co, inv_di, kw, nit)
            ref = fused_chunk(carry, co, inv_di, kw, nit, plain=True)
            torch.cuda.synchronize()
            d = rel_diffs_vep3d(out, ref)
            worst = max(d.values())
            worst_rel = max(worst_rel, worst)
            worst_abs = max(worst_abs, abs_diff(flat_vep_carry(out), flat_vep_carry(ref)))
            lam_max = max(float(ref.lam.max()), *(float(x.max()) for x in ref.lam_e))
            emit("parity_vep3d_chunk", case=case, nout=nit, max_rel_diff=worst, tol=tol,
                 lam_max=lam_max, per_field=d)
            check(worst <= tol, f"B8 {case} nout={nit}: {worst} > {tol}")
            if nit == 50 and case != "blocked_elastic":
                check(lam_max > 0.0, f"B8 {case}: plasticity inactive")
        check(all(torch.equal(a, b) for a, b in zip(before, flat_vep_carry(carry))),
              f"B8 {case}: the input carry was written")
        # f32, F32_VEP3D_NOUT iterations: 1e-4, or twice the plain version's
        # own f32 error against f64
        c32, co32, _, _, _, kw32 = inputs[torch.float32]
        out = fused_chunk(c32, co32, inv_di, kw32, F32_VEP3D_NOUT)
        ref = fused_chunk(c32, co32, inv_di, kw32, F32_VEP3D_NOUT, plain=True)
        ref64 = fused_chunk(carry, co, inv_di, kw, F32_VEP3D_NOUT, plain=True)
        gap = max(rel_diffs_vep3d(out, ref).values())
        p32 = max(rel_diffs_vep3d(as_f64(ref), ref64).values())
        tol32 = max(TOL_F32_1024, 2.0 * p32)
        worst32 = max(worst32, gap)
        emit("parity_vep3d_chunk", case=case, nout=F32_VEP3D_NOUT, dtype="float32",
             max_rel_diff=gap, tol=tol32, plain_f32_vs_plain_f64=p32)
        check(gap <= tol32, f"B8 {case} f32 nout={F32_VEP3D_NOUT}: {gap} > {tol32}")
        del inputs

    # a grid whose slots do not fill the stress pass's tiles in y or z, f64
    carry, co, _, _, inv_r, kw_r = vep3d_case("shearband3d_kb_inf", torch.float64, dev, n=37)
    before = [t.clone() for t in flat_vep_carry(carry)]
    for nit, tol in ((1, TOL_VEP3D_CALL), (50, TOL_VEP3D_NOUT50)):
        d = max(rel_diffs_vep3d(fused_chunk(carry, co, inv_r, kw_r, nit),
                                fused_chunk(carry, co, inv_r, kw_r, nit, plain=True)).values())
        emit("parity_vep3d_chunk", case="shearband3d_kb_inf", n=37, nout=nit,
             max_rel_diff=d, tol=tol)
        check(d <= tol, f"B8 n=37 nout={nit}: {d} > {tol}")
        worst_rel = max(worst_rel, d)
    check(all(torch.equal(a, b) for a, b in zip(before, flat_vep_carry(carry))),
          "B8 n=37: the input carry was written")
    del carry, co

    # near yield at 126^3, f64: one and 50 iterations, the yield branch active
    n = 126
    near = {d: vep3d_case("shearband3d_kb_inf", d, dev, n=n)
            for d in (torch.float64, torch.float32)}
    carry, co, _, _, inv_n, kw_n = near[torch.float64]
    for nit, tol in ((1, TOL_VEP3D_CALL), (50, TOL_VEP3D_NOUT50)):
        out = fused_chunk(carry, co, inv_n, kw_n, nit)
        ref = fused_chunk(carry, co, inv_n, kw_n, nit, plain=True)
        d = max(rel_diffs_vep3d(out, ref).values())
        lam = float(ref.lam.max())
        lam_e = max(float(x.max()) for x in ref.lam_e)
        emit("near_yield_126_vep3d_chunk", n=n, nout=nit, max_rel_diff=d, tol=tol,
             lam_max=lam, lam_e_max=lam_e)
        check(d <= tol, f"near yield 126^3 B8 nout={nit}: {d} > {tol}")
        check(lam > 0.0 and lam_e > 0.0, "near yield 126^3 B8: plasticity inactive")
        worst_rel = max(worst_rel, d)
    del carry, co, out, ref
    c32, co32, _, _, _, kw32 = near[torch.float32]
    pk32 = hc.pack_chunk_consts(co32)
    nk, npl = 20, 5
    tk, tp = time_pair(lambda: fused_chunk(c32, pk32, inv_n, kw32, nk),
                       lambda: fused_chunk(c32, co32, inv_n, kw32, npl, plain=True), nk, npl)
    near_ms = dict(near_yield_ms=min(tk), near_yield_plain_ms=min(tp),
                   near_yield_words=vep3d_chunk_words(pk32))
    emit("near_yield_126_vep3d_chunk_timing", n=n, kernel_ms_per_iter=tk,
         plain_ms_per_iter=tp, words=vep3d_chunk_words(pk32), nvidia_smi=smi)
    del near, c32, co32, pk32

    # ---- 23. main path: ShearBand3D at 126^3 f32, one step on "blocked" (B8)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, info, tau, _ = shearband3d.run(n=n, nt=1, dtype=torch.float32, iter_max=2_000,
                                       nout=200, use_kernel="blocked")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hc.stokes3d_vep_chunk.launches
    other = sum(counts().values()) - launches
    finite = all(bool(torch.isfinite(t).all()) for t in (
        st.V.Vx, st.V.Vy, st.V.Vz, st.P, st.tau.xx, st.tau.zz, st.tau.yz, st.tau.xz,
        st.tau.xy, st.tau.II, st.viscosity.eta, st.EII_pl))
    gap = abs(tau[-1] - tau_edges) / abs(tau_edges)
    emit("main_path_vep3d_blocked", n=n, dtype="float32", iters=int(info.iters),
         err=float(info.err), tauII_max=tau[-1], tauII_max_edges_route=tau_edges,
         rel_gap_to_edges_route=gap, wall_s=wall,
         wall_ms_per_iter=wall / int(info.iters) * 1e3, launches=launches,
         other_launches=other, finite=finite)
    check(st.P.device.type == "cuda", "main path B8: the state is not on the card")
    check(finite, "main path B8: non-finite fields")
    check(launches > 0 and other == 0, "main path B8: B8 was not launched, or another was")
    check(gap < 1e-3, f"main path B8: tauII max {tau[-1]} vs {tau_edges} on 'edges'")
    del st

    # B8 and its plain version on the solve's first-chunk inputs: the kernels
    # line's numbers
    geometry, st0, material, (pr_c, pr_e), _, pt, dt = shearband3d._setup(n, torch.float32,
                                                                          dev)
    carry, co, packed = canvas_chunk_inputs(st0, material, pr_c, pr_e, route="blocked")
    kw = dict(dt=dt, r=pt.r, theta_dtau=pt.theta_dtau, etadtau=pt.etadtau,
              lambda_relaxation=0.2, viscosity_relaxation=1.0)
    inv_di = tuple(1.0 / d for d in geometry.di)
    tk, tp = time_pair(lambda: fused_chunk(carry, packed, inv_di, kw, nk),
                       lambda: fused_chunk(carry, co, inv_di, kw, npl, plain=True), nk, npl)
    words = vep3d_chunk_words(packed)
    bound_main = bound_ms(words, n ** 3, 4, kind)
    t_k = min(tk)
    # the parent commit's kernel on the same inputs (chip_smoke.py --parent DIR)
    parent = load_parent("hopper_stokes3d_vep")
    t_parent = None
    if parent is not None:
        old = parent.pack_chunk_consts(packed.co)
        t_parent = [cuda_time_ms(lambda: parent.stokes3d_vep_chunk(carry, old, inv_di, nk,
                                                                   **kw)) / nk,
                    cuda_time_ms(lambda: fused_chunk(carry, packed, inv_di, kw, nk)) / nk,
                    cuda_time_ms(lambda: parent.stokes3d_vep_chunk(carry, old, inv_di, nk,
                                                                   **kw)) / nk]
        emit("parent_vep3d_chunk", n=n, parent_ms_per_iter=t_parent[::2],
             kernel_ms_per_iter=t_parent[1], nvidia_smi=smi)
    emit("main_path_vep3d_blocked_timing", n=n, words=words, kernel_ms_per_iter=tk,
         plain_ms_per_iter=tp, T_eff_GBs=words * n ** 3 * 4 / (t_k * 1e-3) / 1e9,
         bound_ms=bound_main, bound_share=bound_main / t_k, bound_ms_71_words=bound_ms(
             WORDS_VEP3D, n ** 3, 4, kind), nvidia_smi=smi)
    # 50 iterations kernel vs plain from those inputs, f32 against f64
    out = fused_chunk(carry, packed, inv_di, kw, 50)
    ref = fused_chunk(carry, co, inv_di, kw, 50, plain=True)
    _, st64, mat64, (pr_c64, pr_e64), _, _, _ = shearband3d._setup(n, torch.float64, dev)
    carry64, co64, _ = canvas_chunk_inputs(st64, mat64, pr_c64, pr_e64, route="blocked")
    ref64 = fused_chunk(carry64, co64, inv_di, kw, 50, plain=True)
    gap = max(rel_diffs_vep3d(out, ref).values())
    p32 = max(rel_diffs_vep3d(as_f64(ref), ref64).values())
    tol = max(TOL_F32_1024, 2.0 * p32)
    worst32 = max(worst32, gap)
    emit("f32_126_parity_vep3d", kernel="B8", nout=50, max_rel_diff=gap, tol=tol,
         plain_f32_vs_plain_f64=p32)
    check(gap <= tol, f"f32 126^3 B8: {gap} > {tol}")
    main8 = (t_k, min(tp), bound_main, words)
    del carry, co, packed, out, ref, carry64, co64, ref64, st64, st0

    # ---- 24. timing, bench_kernels.py's pallas_vep3d_edges set-up, 126^3 f32
    b = bench
    pk = hc.pack_chunk_consts(b["co6"])
    tk, tp = time_pair(lambda: fused_chunk(b["carry"], pk, b["inv_di"], b["kw"], nk),
                       lambda: fused_chunk(b["carry"], b["co6"], b["inv_di"], b["kw"], npl,
                                           plain=True), nk, npl)
    words = vep3d_chunk_words(pk)
    bound = bound_ms(words, n ** 3, 4, kind)
    t_b = min(tk)
    emit("timing_vep3d_chunk", n=n, dtype="float32", words=words, kernel_ms_per_iter=tk,
         plain_ms_per_iter=tp, T_eff_GBs=words * n ** 3 * 4 / (t_b * 1e-3) / 1e9,
         bound_ms=bound, bound_share=bound / t_b, hybrid_ms_per_iter=b["hybrid_ms"],
         plain_canvas_ms_per_iter=b["plain_canvas_ms"], hybrid_over_fused=b["hybrid_ms"] / t_b,
         nvidia_smi=smi)
    t_k, t_p, bound_main, words_main = main8
    return {
        "name": "stokes3d_vep_chunk",
        "route": "cuda",
        "source": "justrelax_tpu_torch/csrc/stokes3d_vep.cu",
        "replaces": ("justrelax_tpu/ops/pallas_stokes3d_vep_blocked.py:327 "
                     "(B8 stokes3d_vep_chunk_blocked)"),
        "launches": launches,
        "max_abs_err": worst_abs,
        "max_rel_diff_f64": worst_rel,
        "max_rel_diff_f32": worst32,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound_main,
        "bound_by": "bytes",
        "library_ms": None,
        "per": "iteration (3 launches)",
        "parent_ms": None if t_parent is None else min(t_parent[::2]),
        "words": words_main,
        **near_ms,
        "bench_ms": t_b,
        "bench_plain_ms": min(tp),
        "bench_bound_ms": bound,
        "bench_words": words,
    }


def run_window_copy(dev, smi, kind):
    """Phase 25, R: the 2D dynamic-window copy; returns its entry of the
    kernels line."""
    # ---- 25. the port's repro script in each mode, through the kernel
    reset_counts()
    t0 = time.perf_counter()
    sums = {}
    for mode in hw.MODES:
        out = repro_2d_dma.main([mode])
        check(bool(np.isfinite(out).all()), f"window_copy {mode}: non-finite values")
        sums[mode] = float(out.sum())
    main_launches = hw.window_copy.launches
    emit("main_path_window_copy", sums=sums, launches=main_launches,
         seconds=time.perf_counter() - t0)
    check(main_launches == 3 * len(hw.MODES), "window_copy: the kernel was not launched")

    # kernel against plain, bit for bit, on the script's input and a random
    # one (and the parent tree's kernel with --parent); then each timed by
    # the card's time per call and the host's (device_time_ms): the kernel
    # (in turns with the parent's), the plain version, the one indexing call
    # and the byte floor, one device-to-device copy of the same 2 MiB
    N, X, Y, Z = repro_2d_dma.N, repro_2d_dma.X, repro_2d_dma.Y, repro_2d_dma.Z
    geom = dict(W=repro_2d_dma.W, Wy=repro_2d_dma.Wy, R=repro_2d_dma.R, Ry=repro_2d_dma.Ry)
    ramp = (torch.arange(N * X * Y * Z, dtype=torch.float32, device=dev)
            .reshape(N, X, Y, Z) / 1e6)
    noise = torch.as_tensor(np.random.default_rng(17).standard_normal((N, X, Y, Z)),
                            dtype=torch.float32, device=dev)
    old = load_parent("hopper_window_copy")
    # each output word written once and read once from the source
    bound = 2 * X * Y * Z * 4 / HBM_PEAK[kind] * 1e3
    worst_abs, per_mode = 0.0, {}
    for mode in hw.MODES:
        for src in (ramp, noise):
            ref = hw.window_copy_reference(src, mode, **geom)
            for who in (hw, old) if old else (hw,):
                out = who.window_copy(src, mode, **geom)
                torch.cuda.synchronize()
                check(torch.equal(out, ref),
                      f"window_copy {mode}: {'kernel' if who is hw else 'parent'} differs "
                      "from plain")
                worst_abs = max(worst_abs, float((out - ref).abs().max()))
        xi, yi = hw.window_indices(X, Y, mode, **geom, device=dev)
        floor_out = torch.empty((X, Y, Z), dtype=torch.float32, device=dev)
        fns = {"kernel": lambda: hw.window_copy(ramp, mode, **geom),
               "plain": lambda: hw.window_copy_reference(ramp, mode, **geom),
               "library": lambda: ramp[0][xi[:, None], yi[None, :]],
               "floor": lambda: floor_out.copy_(ramp[0])}
        order = ["kernel", "plain", "library", "floor", "kernel"]
        if old:
            fns["parent"] = lambda: old.window_copy(ramp, mode, **geom)
            order = ["parent", *order, "parent"]
        t = {}
        for name in order:
            t.setdefault(name, []).append(device_time_ms(fns[name]))
        best = {name: min(r, key=lambda x: x["ms"]) for name, r in t.items()}
        per_mode[mode] = {
            **{("ms" if n == "kernel" else f"{n}_ms"): b["ms"] for n, b in best.items()},
            **{("wall_ms" if n == "kernel" else f"{n}_wall_ms"): b["wall_ms"]
               for n, b in best.items()},
            **{("wall_min_ms" if n == "kernel" else f"{n}_wall_min_ms"):
               min(x["wall_min_ms"] for x in t[n]) for n in t},
            "runs_ms": {n: [x["ms"] for x in r] for n, r in t.items()},
            "queued": all(x["queued"] for r in t.values() for x in r),
            "bound_share": bound / best["kernel"]["ms"]}
        check(per_mode[mode]["queued"], f"window_copy {mode}: the card caught up with the "
              "host while timing; a device time was not read")
    hw.window_copy.launches = main_launches  # comparison launches do not count
    emit("window_copy", max_abs_err=worst_abs, bound_ms=bound, per_mode=per_mode,
         nvidia_smi=smi)
    return {
        "name": "window_copy",
        "route": "cuda",
        "source": "justrelax_tpu_torch/csrc/window_copy.cu",
        "replaces": "scripts/repro_2d_dma.py:55 (R kern, defined at :27)",
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "ms": per_mode["2d"]["ms"],
        "plain_ms": per_mode["2d"]["plain_ms"],
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": per_mode["2d"]["library_ms"],
        "wall_ms": per_mode["2d"]["wall_ms"],
        "floor_ms": per_mode["2d"]["floor_ms"],
        "parent_ms": per_mode["2d"].get("parent_ms"),
        "per": "copy (device time)",
        "per_mode": per_mode,
    }


# ---- the models of the module queue (phases 27-29) ---------------------------
# The kernel each model's default entry point routes through on the card
# (None: plain by contract), its golden at the JAX test's size in f64, and
# its production grid in f32. Cuts at the production grids are of steps
# and iteration caps only, never of the grid (PERF.md §4).
MODEL_KERNEL = {
    "sinking_block": "stokes_vep_chunk",
    "global_convection2d": "stokes_chunk",
    "thermal_stresses": "thermal_chunk",
    "diffusion3d": None,
    "shearheating": None,
    "shearheating3d": "stokes3d_chunk",
    "shearband_visc_plastic_tau": None,
    "solvi2d": None,
}
SINKING_BLOCK_VMAX = 4.841885609356093e-10  # tests/test_more_benchmarks.py
DIFFUSION3D_T = {(15, 15, 15): 1813.2470160788096, (16, 16, 16): 1831.2568044653274}
YR = 3600.0 * 24.0 * 365.25
# production runs and their cuts: the sinking block on the flagship's
# budget (40 000 iterations, the model's own cap 150 000); the thermal
# stresses' plain alpha_dT Stokes solve capped at 6 000 (the model's
# 100 000: ~1.2-1.8 ms per iteration on the host's dispatch; 20 000 until
# the nonuniform phases needed the script's time); one time step of each
# model (the JAX tests run 2, 3 and 10); the models' other caps as they are
PROD = {
    "sinking_block": dict(n=1024, iter_max=40_000, nout=1_000),
    "thermal_stresses": dict(nx=1024, ny=1024, nt=1, stokes_iter_max=6_000),
    "shearheating3d": dict(nx=126, ny=126, nz=126, nt=1),
    "diffusion3d": dict(n=126, ttot=50 * diffusion3d.KYR),
}


# phase 28's goldens that run as the slow cuda test test_model_golden_f64
# instead: the host's dispatch of plain PyTorch iterations holds each for
# 220-300 s on an H100's host (PERF.md §4; in processes of their own beside
# phase 28 until the IO phase needed the script's time); the thermal
# stresses' path runs in phase 29, the other two as MOVED_DRIVES
GOLDENS_MOVED = ("thermal_stresses", "shearheating", "shearband_visc_plastic_tau")
# phase 28's goldens in processes of their own (22-28 s each; in the
# script's process until the IO phase needed its time)
GOLDENS_APART = ("diffusion3d", "global_convection2d", "solvi2d")


def golden_result(label, fn):
    """Run one golden of phase 28 with every launch counter at 0; its
    result with the seconds it took, the kernel its model routes through,
    that kernel's launches and the launches of every other."""
    reset_counts()
    t0 = time.perf_counter()
    g = fn()
    torch.cuda.synchronize()
    c = counts()
    kernel = MODEL_KERNEL[label]
    g.update(seconds=time.perf_counter() - t0, kernel=kernel,
             launches=None if kernel is None else c[kernel],
             other_launches=sum(v for k, v in c.items() if k != kernel), all_launches=c)
    return g


def golden_cases():
    """Phase 28's goldens: label → (run, checks), each run through the
    model's default entry point on the card in f64 at its JAX test's size,
    each check that test's assertion."""
    from scipy.ndimage import binary_erosion

    f64 = torch.float64

    def g_sinking_block():
        st, info, vmax = sinking_block.run(n=32, dtype=f64)
        return dict(iters=int(info.iters), err=float(info.err), vmax=vmax)

    def g_diffusion3d():
        th, info = diffusion3d.run(n=32, dtype=f64)
        T = {f"T{i[0]}": float(th.T[i]) for i in DIFFUSION3D_T}
        return dict(iters=int(info.iters), err=float(info.err), **T)

    def g_global_convection():
        _, st, th, info, t, eta_hist = global_convection2d.run(n=32, nt=3, dtype=f64)
        T = th.T[1:-1, 1:-1]
        Vy = st.V.Vy
        nx = T.shape[0]
        return dict(iters=int(info.iters), err=float(info.err), T_min=float(T.min()),
                    T_max=float(T.max()), finite=bool(torch.isfinite(T).all()),
                    eta_min=eta_hist[-1][0], eta_max=eta_hist[-1][1],
                    upwelling=float(Vy[1 + nx // 2, :].max()),
                    vmax_cmyr=float(Vy.max()) * 100.0 * YR, t=t)

    def g_thermal_stresses():
        st, th, phi, info, chamber = thermal_stresses.run(nx=48, ny=48, nt=2, dtype=f64)
        P, phi = st.P.cpu().numpy(), phi.cpu().numpy()
        rr = np.hypot(*np.meshgrid(np.linspace(-1, 1, P.shape[0]),
                                   np.linspace(-1, 1, P.shape[1]), indexing="ij"))
        core, far = rr < 0.15, rr > 0.8
        near = ~chamber & ~far
        dT = (th.T - th.Told).cpu().numpy()[1:-1, 1:-1]
        return dict(iters=int(info.iters), err=float(info.err),
                    phi_core_min=float(phi[core].min()), phi_host_max=float(phi[~chamber].max()),
                    P_near_max=float(P[near].max()), P_chamber_min=float(P[chamber].min()),
                    P_far=float(abs(P[far]).max()), P_abs_max=float(np.abs(P).max()),
                    P_bound=float((1.0 / 6.0e-11) * 6.0e-5 * np.abs(dT).max() * 1.5))

    def g_shearheating():
        st, th, info = shearheating.run(nx=32, ny=32, nt=5, dtype=f64)
        H = th.shear_heating
        return dict(iters=int(info.iters), err=float(info.err), H_min=float(H.min()),
                    H_max=float(H.max()), H_median=float(H.flatten().median()))

    def g_shearheating3d():
        st, th, info = shearheating3d.run(nx=12, ny=12, nz=12, nt=2, rc=8.0e3, dtype=f64)
        H = th.shear_heating
        return dict(iters=int(info.iters), err=float(info.err), H_min=float(H.min()),
                    H_max=float(H.max()), T_max=float(th.T.max()),
                    H_inclusion=float(H[6, 6, 4]), H_far=float(H[1, 1, 1]))

    def g_shearband_vpt():
        _, info, _, _, tII = shearband.run(n=32, nt=10, dtype=f64, visc_plastic_tau=True,
                                           use_kernel=False)
        return dict(iters=int(info.iters), err=float(info.err), tauII_min=float(tII.min()),
                    tauII_max=float(tII.max()))

    def g_solvi2d():
        out = {}
        for d_eta in (1e-3, 1e3):
            _, st, info, inside = solvi2d.run(n=96, d_eta=d_eta, rc=0.2, L=4.0, dtype=f64)
            core = torch.as_tensor(binary_erosion(inside, iterations=2), device=st.P.device)
            txx, P = st.tau.xx[core], st.P[core]
            a = solvi2d.interior_amplitude(1.0, d_eta, 1.0)
            mean = float(txx.mean())
            out[f"deta{d_eta:g}"] = dict(iters=int(info.iters), err=float(info.err),
                                        mean_rel=abs(mean - a) / abs(a),
                                        std_rel=abs(float(txx.std(unbiased=False)) / mean),
                                        P_mean=abs(float(P.mean())))
        return dict(cases=out)

    return {
        "sinking_block": (g_sinking_block, lambda g: [
            ("err", g["err"] < 1e-5),
            ("vmax", abs(g["vmax"] - SINKING_BLOCK_VMAX) <= 0.10 * SINKING_BLOCK_VMAX)]),
        "diffusion3d": (g_diffusion3d, lambda g: [("err", g["err"] < 1e-5)] + [
            (f"T{i[0]}", abs(g[f"T{i[0]}"] - v) <= 1e-3 * v) for i, v in DIFFUSION3D_T.items()]),
        "global_convection2d": (g_global_convection, lambda g: [
            ("err", g["err"] < 1e-4), ("finite", g["finite"]),
            ("T bounds", g["T_min"] >= 299.0 and g["T_max"] <= 3.5e3 + 1.0),
            ("eta span", 1e16 <= g["eta_min"] < 1e21 and g["eta_max"] <= 1e24 + 1.0
             and g["eta_max"] / g["eta_min"] > 1e3),
            ("upwelling", g["upwelling"] > 0.0 and 1e-3 < g["vmax_cmyr"] < 100.0),
            ("time", g["t"] > 0.0)]),
        "thermal_stresses": (g_thermal_stresses, lambda g: [
            ("iters", g["iters"] < 100_000), ("err", g["err"] < 1e-5),
            ("molten core", g["phi_core_min"] > 0.95), ("solid host", g["phi_host_max"] < 0.5),
            ("over-pressure", g["P_near_max"] > 10.0 * g["P_far"]),
            ("suction", g["P_chamber_min"] < -10.0 * g["P_far"]),
            ("elastic bound", g["P_abs_max"] < g["P_bound"])]),
        "shearheating": (g_shearheating, lambda g: [
            ("err", g["err"] < 1e-4), ("H >= 0", g["H_min"] >= 0.0),
            ("H concentrated", g["H_max"] > 5.0 * g["H_median"])]),
        "shearheating3d": (g_shearheating3d, lambda g: [
            ("err", g["err"] < 1e-4), ("H >= 0", g["H_min"] >= 0.0), ("H > 0", g["H_max"] > 0.0),
            ("heated", g["T_max"] > 674.0), ("at the inclusion", g["H_inclusion"] > g["H_far"])]),
        "shearband_visc_plastic_tau": (g_shearband_vpt, lambda g: [
            ("err", g["err"] < 1e-6), ("tauII min", abs(g["tauII_min"] - 1.4422770) <= 1e-4),
            ("tauII max", abs(g["tauII_max"] - 1.6643166) <= 1e-4)]),
        "solvi2d": (g_solvi2d, lambda g: [
            (f"{k} {name}", ok) for k, c in g["cases"].items() for name, ok in (
                ("err", c["err"] < 1e-8), ("mean", c["mean_rel"] < 0.04),
                ("std", c["std_rel"] < 0.25), ("P", c["P_mean"] < 0.04))]),
    }


# one step of each path whose golden runs only as a slow cuda test and that
# no production step drives (the 2D shear heating, the visc_plastic_tau band,
# the DYREL volcano): at the golden's size through the default entry point
# in f64, in processes of their own beside phase 28's, each held within
# MOVED_DRIVE_TOL of every value the JAX model gives after that step
# (run(..., nt=1) on the CPU with x64), the iterations of the plain solves
# equal. The DYREL volcano's solve is capped as its CPU test caps it
# (VOLCANO_DRIVE_CAPS; the model's 50 000): uncapped, its nonlinear solve
# stops where err first falls below 1e-4, and runs that differ at rounding
# stop thousands of iterations apart (JAX 23 800, the port on the CPU
# 29 000; Vy within 2e-4 and tauII within 4e-3 of JAX's; 121 s on an H100
# beside phase 28's processes), so it is held to JAX's err and iterations
# at the cap instead of to a tolerance
MOVED_DRIVES = ("shearheating_step", "shearband_visc_plastic_tau_step", "volcano2d_dyrel_step")
MODEL_KERNEL.update({label: None for label in MOVED_DRIVES})
MOVED_DRIVE_TOL = 1e-6
VOLCANO_DRIVE_CAPS = dict(total_iter_max=1_000, iter_max=1_000, nout=20)
MOVED_DRIVE_JAX = {
    "shearheating_step": dict(
        iters=3000, H_min=3.812679323663037e-05, H_max=0.00038062247150605545,
        T_max=720.6231514194703, P_max=1771944044.090171),
    "shearband_visc_plastic_tau_step": dict(
        iters=1100, tauII_min=0.2842937096006669, tauII_max=0.4296010338212822,
        tau_max=0.4293120415790336),
    "volcano2d_dyrel_step": dict(
        iters=1280, err=0.0038289281243771398, Vy_max_cmyr=58.158961885511815,
        Vy_min_cmyr=-63.96126105990661, T_min=270.1675675753668, T_max=1173.0,
        phi_m_max=0.030114495235671973, tauII_max=17977594.921423282),
}


def moved_drive_cases():
    """Phase 28's drives of MOVED_DRIVES: label → (run, checks), the checks
    the solve's tolerance (the golden's; the capped volcano: JAX's err),
    finite fields and the JAX model's values after the step."""
    f64 = torch.float64
    cmyr = 100.0 * YR

    def d_shearheating():
        st, th, info = shearheating.run(nx=32, ny=32, nt=1, dtype=f64)
        H = th.shear_heating
        return dict(iters=int(info.iters), err=float(info.err), H_min=float(H.min()),
                    H_max=float(H.max()), T_max=float(th.T.max()),
                    P_max=float(st.P.abs().max()),
                    finite=bool(torch.isfinite(H).all() and torch.isfinite(st.P).all()))

    def d_shearband_vpt():
        _, info, tau_max, _, tII = shearband.run(n=32, nt=1, dtype=f64, visc_plastic_tau=True,
                                                 use_kernel=False)
        return dict(iters=int(info.iters), err=float(info.err), tauII_min=float(tII.min()),
                    tauII_max=float(tII.max()), tau_max=float(tau_max[0]),
                    finite=bool(torch.isfinite(tII).all()))

    def d_volcano_dyrel():
        with capped(volcano2d_dyrel, "solve_dyrel", **VOLCANO_DRIVE_CAPS):
            st, th, _, phi_m, info, _ = volcano2d_dyrel.run(nx=16, ny=8, nt=1, dtype=f64)
        Vy = st.V.Vy
        return dict(iters=int(info.iters), err=float(info.err),
                    Vy_max_cmyr=float(Vy.max()) * cmyr, Vy_min_cmyr=float(Vy.min()) * cmyr,
                    T_min=float(th.T.min()), T_max=float(th.T.max()),
                    phi_m_max=float(phi_m.max()), tauII_max=float(st.tau.II.max()),
                    finite=bool(torch.isfinite(st.tau.II).all() and torch.isfinite(Vy).all()))

    def checks(label, tol=None):
        def held(g):
            out = [("finite", g["finite"])] + ([] if tol is None else [("err", g["err"] < tol)])
            for key, v in MOVED_DRIVE_JAX[label].items():
                ok = g[key] == v if key == "iters" else abs(g[key] - v) <= MOVED_DRIVE_TOL * abs(v)
                out.append((f"{key} (JAX {v!r})", ok))
            return out
        return held

    return {
        "shearheating_step": (d_shearheating, checks("shearheating_step", 1e-4)),
        "shearband_visc_plastic_tau_step": (d_shearband_vpt,
                                            checks("shearband_visc_plastic_tau_step", 1e-6)),
        "volcano2d_dyrel_step": (d_volcano_dyrel, checks("volcano2d_dyrel_step")),
    }


def golden_apart(label):
    """``--golden LABEL``: one golden of phase 28 in this process, its result
    printed as the last line (the phase's process holds it to its checks)."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    for mod in (hv, hs, ht, h3):
        mod._library()  # built by the phase's process
    cases = {**golden_cases(), **moved_drive_cases(), **dyrel_golden_cases(),
             **particle_golden_cases(), **variational_golden_cases(),
             **nonuniform_golden_cases()}
    print(json.dumps(golden_result(label, cases[label][0])), flush=True)


def with_caps(fn, caps, first=None):
    """``fn`` called with ``caps`` (iter_max, nout, ...) over its caller's
    arguments; the first call's (args, kwargs) appended to ``first`` when
    it is a list."""
    def call(*args, **kwargs):
        kwargs = {**kwargs, **caps}
        if first is not None and not first:
            first.append((args, kwargs))
        return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def capped(module, name, **caps):
    """``module.name`` as ``with_caps`` makes it until the block ends;
    yields the list that receives its first call's (args, kwargs)."""
    fn, first = getattr(module, name), []
    setattr(module, name, with_caps(fn, caps, first))
    try:
        yield first
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def timed_solves(module, name):
    """``module.name`` (a solver returning ``(state, info)``) wrapped as
    ``timed_calls`` does; yields the list of (start, end, info) per call."""
    fn = getattr(module, name)
    calls = []

    def shim(*args, **kwargs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kwargs)
        b.record()
        calls.append((a, b, out[1], kwargs.get("iter_max")))
        return out

    setattr(module, name, shim)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def solves_summary(calls):
    """Per solve: iterations, err, err/err₁ and whether it stopped before
    its cap (a solve that ran to its cap is counted as not converged), and
    the seconds between its events."""
    torch.cuda.synchronize()
    out = []
    for a, b, info, cap in calls:
        hist = info.err_history
        hist = hist.amax(dim=-1) if hist.ndim > 1 else hist
        err, err1 = float(info.err), float(hist[0])
        iters = int(info.iters)
        out.append(dict(iters=iters, err=err, err_rel=err / err1 if err1 else math.nan,
                        cap=cap, converged=cap is None or iters < cap,
                        seconds=a.elapsed_time(b) * 1e-3))
    return out


def run_models(dev, smi, before_29=None, beside_28=None, apart_results=None):
    """Phases 27-29; returns the launches of each kernel per model phase.
    ``beside_28`` is called while phase 28's golden processes run on, after
    its goldens here; ``before_29`` between phases 28 and 29, after which
    ``apart_results`` holds the results of the MOVED_DRIVES processes."""
    f64, f32 = torch.float64, torch.float32
    launches = {}

    # ---- 27. the kernel refusals on the card: a 3D thermal solve and
    # solve_vep(visc_plastic_tau=True) with use_kernel left to its default
    g3 = Geometry((8, 8, 8), (1.0, 1.0, 1.0))
    th3 = ThermalState.make((8, 8, 8), dtype=f64)
    K3 = torch.ones((8, 8, 8), dtype=f64, device=dev)
    bc3 = TemperatureBoundaryConditions(constant_value=Faces(top=0.0, bot=1.0))
    pt3 = PTThermalCoeffs.make(K3, K3, 0.3, g3.di, g3.li)
    refusals = {}
    try:
        heatdiffusion_PT(th3, pt3, bc3, 0.3, g3, K=K3, rho_Cp=K3, iter_max=10, nout=10)
    except ValueError as e:
        refusals["thermal_3d"] = str(e)
    try:
        shearband.run(n=8, nt=1, dtype=f64, visc_plastic_tau=True, iter_max=10, nout=10)
    except ValueError as e:
        refusals["visc_plastic_tau"] = str(e)
    emit("kernel_refusals", **refusals)
    for key in ("thermal_3d", "visc_plastic_tau"):
        check("use_kernel=False" in refusals.get(key, ""), f"refusal {key}: not raised")

    # ---- 28. goldens through the default entry points on the card, f64, at
    # the JAX tests' sizes and on their assertions; three in processes of
    # their own beside the others (the card has room to spare; phase 29's
    # timings start after every one has ended), three as a slow cuda test
    cases = {k: v for k, v in golden_cases().items() if k not in GOLDENS_MOVED}
    emit("golden_models_moved", cases=GOLDENS_MOVED,
         test="tests/test_torch_cuda.py::test_model_golden_f64 (slow, cuda)")
    run_golden_set(cases, "golden_models", smi, launches, apart=GOLDENS_APART,
                   beside=beside_28)

    if before_29 is not None:
        before_29()
    # the paths of three of the moved goldens, one step each (MOVED_DRIVES)
    run_golden_set(moved_drive_cases(), "moved_drives", smi, launches,
                   apart_results=apart_results)

    # ---- 29. the new paths at production grids, f32, through the default
    # entry points: wall time and its split (CUDA events around the kernel's
    # chunk calls and around each solve; the rest is the model's set-up,
    # host reads and the glue between solves)
    def production(label, fn, timers):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            recs = {name: stack.enter_context(ctx) for name, ctx in timers.items()}
            result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        kernel = MODEL_KERNEL[label]
        split = {}
        for name, rec in recs.items():
            if rec and len(rec[0]) == 4:
                split[name] = solves_summary(rec)
            else:
                split[name] = events_s(rec)
        solve_s = sum(x["seconds"] for v in split.values() if isinstance(v, list) for x in v)
        emit("main_path_models", case=label, dtype="float32", wall_s=wall, kernel=kernel,
             launches=None if kernel is None else c[kernel], split=split,
             rest_s=wall - solve_s, nvidia_smi=smi, **result)
        check(result["finite"], f"main_path_models {label}: non-finite fields")
        if kernel is not None:
            launches.setdefault(kernel, {})[f"production_{label}"] = c[kernel]
            check(c[kernel] > 0, f"main_path_models {label}: {kernel} was not launched")

    def finite(*ts):
        return all(bool(torch.isfinite(t).all()) for t in ts)

    def p_sinking_block():
        st, info, vmax = sinking_block.run(dtype=f32, **PROD["sinking_block"])
        return dict(grid=PROD["sinking_block"], vmax=vmax,
                    finite=finite(st.V.Vx, st.V.Vy, st.P, st.tau.II) and math.isfinite(vmax))

    production("sinking_block", p_sinking_block, {
        "stokes_vep_chunk_s": timed_calls(solver_vep, "stokes_vep_chunk"),
        "solve_vep": timed_solves(sinking_block, "solve_vep")})

    def p_thermal_stresses():
        st, th, phi, info, _ = thermal_stresses.run(dtype=f32, **PROD["thermal_stresses"])
        return dict(grid=PROD["thermal_stresses"], P_max=float(st.P.abs().max()),
                    phi_max=float(phi.max()), finite=finite(st.P, st.V.Vx, th.T, phi))

    production("thermal_stresses", p_thermal_stresses, {
        "thermal_chunk_s": timed_calls(solver_thermal, "thermal_chunk"),
        "heatdiffusion_PT": timed_solves(thermal_stresses, "heatdiffusion_PT"),
        "solve_ve": timed_solves(thermal_stresses, "solve_ve")})

    def p_shearheating3d():
        st, th, info = shearheating3d.run(dtype=f32, **PROD["shearheating3d"])
        H = th.shear_heating
        return dict(grid=PROD["shearheating3d"], H_min=float(H.min()), H_max=float(H.max()),
                    finite=finite(st.V.Vx, st.P, th.T, H) and float(H.min()) >= 0.0
                    and float(H.max()) > 0.0)

    production("shearheating3d", p_shearheating3d, {
        "stokes3d_chunk_s": timed_calls(solver_ve3d, "stokes3d_chunk"),
        "solve_ve_3d": timed_solves(shearheating3d, "solve_ve_3d"),
        "heatdiffusion_PT": timed_solves(shearheating3d, "heatdiffusion_PT")})

    def p_diffusion3d():
        th, info = diffusion3d.run(dtype=f32, **PROD["diffusion3d"])
        return dict(grid={k: v for k, v in PROD["diffusion3d"].items() if k != "ttot"},
                    steps=1, T_center=float(th.T[64, 64, 64]), finite=finite(th.T))

    production("diffusion3d", p_diffusion3d, {
        "heatdiffusion_PT": timed_solves(diffusion3d, "heatdiffusion_PT")})
    return launches


# ---- DYREL: phases 30-32 -----------------------------------------------------
# the kernel each DYREL golden routes through besides DYREL (whose chunks
# are CUDA graph replays of plain PyTorch operations, no kernel of the port)
MODEL_KERNEL.update({
    "shearband_dyrel": None,
    "shearband_dyrel_dpcap": None,
    "cross_solver": "stokes_vep_chunk",
    "thermal_stresses_dyrel": "thermal_chunk",
    "sinking_block_dyrel": "stokes_vep_chunk",
    "dyrel_nonlinear": None,
    "shearband_displacement": "stokes_vep_chunk",
})
# the DYREL band at the flagship's grid, one step, at most 10 000 DR
# iterations (the model's caps are 50 000 each; 20 000 until the nonuniform
# phases needed the script's time): total_iter_max is checked between inner
# solves, so each inner solve is capped at 5 000 and a second one starts
# only below 5 000 in all
PROD["shearband_dyrel"] = dict(n=1024, nt=1, iter_max=5_000, total_iter_max=5_000)
# phase 30's goldens in processes of their own: the longest replays
DYREL_APART = ("thermal_stresses_dyrel", "dyrel_nonlinear", "sinking_block_dyrel")
DYREL_CARRIED = ("Vx", "Vy", "lam", "lam_v", "dVx", "dVy", "Rx", "Ry", "eta", "eta_v")
MPA = 1.0e6


def dyrel_band_setup(n, dtype, dev):
    """``shearband_dyrel.run``'s set-up and solve arguments."""
    common = dict(rho0=0.0, Kb=5.0, eta0=1.0, is_plastic=1.0,
                  C=1.6 / math.cos(math.radians(30.0)), friction_angle=30.0,
                  dilation_angle=0.0, eta_reg=1.0e-2)
    geometry, mat, prc, prv, st, bc = shearband_dyrel._setup(n, common, 1.0, True, dtype, dev)
    return st, geometry, bc, mat, prc, prv, dict(eps=1.0e-6, nout=50, rel_drop=0.5)


dyrel_nonlinear_setup = dc.dyrel_nonlinear_setup


def sinking_block_dyrel_setup(n, dtype, dev):
    """tests/test_sinking_block_dyrel.py's set-up on the port."""
    ly = 500.0e3
    geometry = Geometry((n, n), (ly, ly), origin=(0.0, -ly))
    st = StokesState.make((n, n), dtype=dtype, device=dev)
    f = dict(dtype=st.P.dtype, device=st.P.device)
    mat = MaterialStack.make([Material(rho0=3.2e3, eta0=1.0e21, gravity=9.81),
                              Material(rho0=3.3e3, eta0=1.0e23, gravity=9.81)], **f)
    X, Y = geometry.cell_centers_mesh()
    X, Y = np.asarray(X), np.asarray(Y)
    block = (np.abs(X - 250.0e3) <= 50.0e3) & (np.abs(-Y - 100.0e3) <= 50.0e3)
    pr = phase_ratios_from_field(torch.as_tensor(block.astype(int), device=f["device"]), 2,
                                 dtype=f["dtype"])
    eta0_v = phase_viscosity(mat, torch.ones((n + 1, n + 1), **f), None, pr.vertex, "tau")
    rho = torch.as_tensor(np.where(block, 3.3e3, 3.2e3), **f)
    st = st.replace(P=rho * 9.81 * torch.as_tensor(np.abs(Y), **f),
                    viscosity=st.viscosity.replace(
                        eta=torch.as_tensor(np.where(block, 1.0e23, 1.0e21), **f), eta_v=eta0_v))
    bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True))
    kw = dict(rho_g=(torch.zeros((n, n), **f), rho * 9.81), eps=1.0e-7, nout=100)
    return st, geometry, bc, mat, pr.center, pr.vertex, kw


_DYREL_BAND = {}  # the DYREL band of phase 30, shared by its two goldens


def dyrel_golden_cases():
    """Phase 30's goldens: label → (run, checks), each through the default
    entry points on the card in f64 at its JAX test's size, each check that
    test's assertion."""
    from justrelax_tpu_torch.ops.interpolation import velocity2vertex
    from justrelax_tpu_torch.ops.stokes import tensor_invariant_staggered_2d

    f64 = torch.float64
    solve_dyrel = solver_dyrel.solve_dyrel

    def band():
        if "out" not in _DYREL_BAND:
            _DYREL_BAND["out"] = shearband_dyrel.run(n=32, nt=10, dtype=f64)
        return _DYREL_BAND["out"]

    def g_shearband_dyrel():
        st, info, tmax, sol, tII = band()
        return dict(iters=info.iters, err=float(info.err), sol_last=sol[-1],
                    tauII_max=float(tII.max()), tauII_min=float(tII.min()), txx_max_last=tmax[-1])

    def g_dpcap():
        st, info, tII = shearband_dyrel.run_dpcap(n=32, nt=10, dtype=f64)
        ev = st.eps_vol_pl
        return dict(iters=info.iters, err=float(info.err), tauII_max=float(tII.max()),
                    eps_pl_max=float(st.eps_pl.xx.abs().max()),
                    EVol_max=float(st.EVol_pl.abs().max()), eps_vol_min=float(ev.min()),
                    eps_vol_max=float(ev.max()))

    def g_cross_solver():
        # the APT half through B2/B3: the same band with the full-field
        # initial velocity (tests/test_cross_solver.py)
        common = dict(rho0=0.0, Kb=5.0, eta0=1.0, is_plastic=1.0,
                      C=1.6 / math.cos(math.radians(30.0)), friction_angle=30.0,
                      dilation_angle=0.0, eta_reg=1.0e-2)
        geometry, mat, pr_c, pr_v, st, pt, bc = shearband._setup(
            32, common, 0.5, f64, None, eps_rel=1.0e-6, CFL=0.75 / math.sqrt(2.1))
        for _ in range(10):
            st, info = solver_vep.solve_vep(st, pt, geometry, bc, mat, pr_c, pr_v, 0.25,
                                            iter_max=50_000, nout=100)
        tau_apt = tensor_invariant_staggered_2d(st.tau.xx, st.tau.yy, st.tau.xy)
        sd, _, _, _, _ = band()
        tau_dyr = tensor_invariant_staggered_2d(sd.tau.xx, sd.tau.yy, sd.tau.xy)
        return dict(apt_iters=int(info.iters), tau_diff=float((tau_apt - tau_dyr).abs().max()),
                    tau_max_apt=float(tau_apt.max()), tau_max_dyrel=float(tau_dyr.max()),
                    tau_min_apt=float(tau_apt.min()), tau_min_dyrel=float(tau_dyr.min()),
                    P_diff=float((st.P - sd.P).abs().max()),
                    Vx_diff=float((st.V.Vx - sd.V.Vx).abs().max()))

    def g_thermal_stresses_dyrel():
        st, th, phi, info, chamber = thermal_stresses_dyrel.run(nx=32, ny=32, nt=2, dtype=f64)
        P, Vy = st.P.cpu().numpy(), st.V.Vy.cpu().numpy()
        return dict(iters=info.iters, err=float(info.err),
                    finite=bool(np.isfinite(P).all() and np.isfinite(Vy).all()),
                    phi_max=float(phi.max()), P_max=float(P.max()),
                    P_chamber_max=float(P[chamber].max()), Vy_max=float(np.abs(Vy).max()))

    def g_sinking_block_dyrel():
        st, geometry, bc, mat, prc, prv, kw = sinking_block_dyrel_setup(32, f64, None)
        s, info = solve_dyrel(st, geometry, bc, mat, prc, prv, 1.0, **kw)
        Vx_v, Vy_v = velocity2vertex(s.V.Vx, s.V.Vy)
        vmax = float(torch.sqrt(Vx_v**2 + Vy_v**2).max())
        _, info_apt, vmax_apt = sinking_block.run(n=32, dtype=f64)
        return dict(iters=info.iters, err=float(info.err), vmax=vmax, vmax_apt=vmax_apt,
                    apt_iters=int(info_apt.iters))

    def g_dyrel_nonlinear():
        st, geometry, bc, mat, prc, prv, eta0, kw = dyrel_nonlinear_setup(24, f64, None)
        out, info = solve_dyrel(st, geometry, bc, mat, prc, prv, 0.25, **kw)
        eta_f = out.viscosity.eta.cpu().numpy()
        tII = out.tau.II.cpu().numpy()
        return dict(iters=info.iters, err=float(info.err),
                    eta_ratio=float(eta_f.max() / float(eta0.max())),
                    eta_median=float(np.median(eta_f)),
                    expect_bg=float(0.5 / 0.5 * np.median(tII) ** (1.0 - 3.0)))

    def g_displacement():
        sv, _, hv_, _, tv = shearband.run(n=24, nt=3, dtype=f64)
        su, info, hu, _, tu = shearband.run(n=24, nt=3, dtype=f64, displacement_driven=True)
        return dict(iters=int(info.iters), hist_rel=max(abs(a - b) / abs(b) for a, b in zip(hu, hv_)),
                    tauII_diff=float((tu - tv).abs().max()),
                    U_diff=float((su.U.Ux - su.V.Vx * 0.25).abs().max()))

    return {
        "shearband_dyrel": (g_shearband_dyrel, lambda g: [
            ("err", g["err"] < 1e-6), ("sol", abs(g["sol_last"] - 1.8358) <= 1e-4),
            ("tauII max", abs(g["tauII_max"] - 1.639) <= 1e-3),
            ("tauII min", abs(g["tauII_min"] - 1.5383533580936255) <= 1e-2),
            ("txx max", abs(g["txx_max_last"] - 1.6377101324888117) <= 5e-3),
            ("iters", g["iters"] < 20_000)]),
        "cross_solver": (g_cross_solver, lambda g: [
            ("tauII field", g["tau_diff"] < 5e-3),
            ("tauII max", abs(g["tau_max_apt"] - g["tau_max_dyrel"]) <= 1e-3),
            ("tauII min", abs(g["tau_min_apt"] - g["tau_min_dyrel"]) <= 1e-3),
            ("P", g["P_diff"] < 2e-2), ("Vx", g["Vx_diff"] < 5e-3),
            ("capped", g["tau_max_apt"] < 1.65 and g["tau_max_dyrel"] < 1.65)]),
        "shearband_dyrel_dpcap": (g_dpcap, lambda g: [
            ("err", g["err"] < 1e-5),
            ("tauII", math.isfinite(g["tauII_max"]) and g["tauII_max"] < 2.0),
            ("eps_pl", g["eps_pl_max"] > 0.0), ("EVol", g["EVol_max"] > 0.0),
            ("dilation", g["eps_vol_min"] >= 0.0 and g["eps_vol_max"] > 0.0)]),
        "thermal_stresses_dyrel": (g_thermal_stresses_dyrel, lambda g: [
            ("err", g["err"] < 1e-4), ("finite", g["finite"]),
            ("phi", 0.0 < g["phi_max"] <= 1.0),
            ("P scale", 5.0 * MPA < g["P_max"] < 25.0 * MPA),
            ("chamber depressurized", g["P_chamber_max"] < 0.0),
            ("P max", abs(g["P_max"] - 11.369 * MPA) <= 2e-2 * 11.369 * MPA),
            ("Vy max", abs(g["Vy_max"] - 2.7418e-11) <= 2e-2 * 2.7418e-11)]),
        "sinking_block_dyrel": (g_sinking_block_dyrel, lambda g: [
            ("vmax", abs(g["vmax"] - 4.8419e-10) <= 0.08 * 4.8419e-10),
            ("vs APT", abs(g["vmax"] - g["vmax_apt"]) <= 2e-2 * g["vmax_apt"])]),
        "dyrel_nonlinear": (g_dyrel_nonlinear, lambda g: [
            ("err", g["err"] < 1e-6), ("iters", g["iters"] < 200_000),
            ("refreshed", abs(g["eta_ratio"] - 1.0) > 0.5),
            ("power law", 0.3 * g["expect_bg"] < g["eta_median"] < 3.0 * g["expect_bg"])]),
        "shearband_displacement": (g_displacement, lambda g: [
            ("hist", g["hist_rel"] <= 1e-12), ("tauII", g["tauII_diff"] <= 1e-12),
            ("U = V dt", g["U_diff"] <= 1e-15)]),
    }


@contextlib.contextmanager
def dyrel_chunks():
    """``_DyrelSolve.run_chunk`` wrapped: each call's solve object, the
    graphs' capture time (host clock around the capture, synchronized) and
    CUDA events around each replay. Yields a dict with ``solves`` (the
    objects, in order), ``capture_s`` and ``replays`` ((start, end, nout))."""
    rec = {"solves": [], "capture_s": [], "replays": []}
    # run_chunk is GraphedChunk's: the exit deletes the shim rather than
    # pinning that function on the class, which would hide it from
    # variational_chunks' wrapper
    own = "run_chunk" in vars(solver_dyrel._DyrelSolve)
    orig = solver_dyrel._DyrelSolve.run_chunk

    def shim(self, nout):
        if self.graphs is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.capture(nout)
            torch.cuda.synchronize()
            rec["capture_s"].append(time.perf_counter() - t0)
            rec["solves"].append(self)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        self.replay()
        b.record()
        rec["replays"].append((a, b, nout))

    solver_dyrel._DyrelSolve.run_chunk = shim
    try:
        yield rec
    finally:
        if own:
            solver_dyrel._DyrelSolve.run_chunk = orig
        else:
            del solver_dyrel._DyrelSolve.run_chunk


def dyrel_carried(s):
    return [getattr(s, k) for k in DYREL_CARRIED]


def dyrel_iteration_times(s, nout, reps=3):
    """ms per DR iteration on the state of the solve object ``s``: its
    graphs' replay (``GRAPH_BLOCK``-iteration blocks and the rest), the
    chunk captured here as one graph (as before the blocks), and the chunk
    run eagerly, by CUDA events, each from the same state (the carried
    fields restored between runs); whether each replay leaves the carried
    fields bit-equal to the eager chunk; and the kernels one eager DR
    iteration launches on the card. The state is left as found."""
    saved = [t.clone() for t in dyrel_carried(s)]

    def restore():
        for t, v in zip(dyrel_carried(s), saved):
            t.copy_(v)

    def timed(fn):
        out = []
        for _ in range(reps):
            restore()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b) / nout)
        return out, [t.clone() for t in dyrel_carried(s)]

    graph_ms, after_graph = timed(s.replay)
    restore()
    whole = s._capture_one(nout)
    whole_ms, after_whole = timed(whole.replay)
    del whole
    eager_ms, after_eager = timed(lambda: s.chunk(nout))
    equal = all(torch.equal(a, b) for a, b in zip(after_graph, after_eager))
    equal_whole = all(torch.equal(a, b) for a, b in zip(after_whole, after_eager))
    moved = any(not torch.equal(a, b) for a, b in zip(after_eager, saved))
    restore()
    launches = dyrel_launches_per_iteration(s)
    restore()
    return dict(graph_ms_per_iter=graph_ms, whole_graph_ms_per_iter=whole_ms,
                eager_ms_per_iter=eager_ms, replay_bit_equal=equal and equal_whole,
                replay_moved=moved, **launches)


def dyrel_launches_per_iteration(s, k=5):
    """The kernels one eager DR iteration launches on the card:
    ``torch.profiler`` over a chunk of ``k`` iterations after a warm-up
    chunk, divided by ``k``, twice (the count must repeat). Counted as the
    card's kernel events (memory copies and sets left out) and as the
    host's kernel-launch calls; ``None`` where the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile

    host_calls = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
    s.chunk(k)
    torch.cuda.synchronize()
    kernels, calls = [], []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            s.chunk(k)
            torch.cuda.synchronize()
        events = prof.key_averages()
        dev = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith(("Memcpy", "Memset")))
        host = sum(e.count for e in events if e.key in host_calls)
        kernels.append(dev / k if dev else None)
        calls.append(host / k if host else None)
    return dict(launches_per_iter=kernels, launch_calls_per_iter=calls)


def dyrel_words(s):
    """Words per cell one DR iteration must move: the carried fields read
    and written (V, dV and λ at centers and vertices; R written), and each
    read-only input that does not hold one value everywhere (τ_o at centers
    and vertices, η, ηv, P, P0, γ_eff, the bulk term, the source, D, λmax
    and the phase ratios); counted from the run's own inputs."""
    def varying(t):
        return t is not None and isinstance(t, torch.Tensor) and t.numel() > 1 and bool(
            (t != t.reshape(-1)[0]).any())

    ro = list(s.to_c) + list(s.to_v) + [s.eta, s.eta_v, s.P, s.P0, s.gamma_eff, s.etab,
                                        s.rp_src, s.Dx_f, s.Dy_f, s.lmx, s.lmy]
    ro += list(s.r_c) + list(s.r_v)
    return 6 * 2 + 2 + sum(1 for t in ro if varying(t))


def dyrel_parity_solve(label, d):
    """Phase 31's 16^2 f64 solve on device ``d``: the DYREL band (two
    steps) or the power-law refresh; (state, info)."""
    if label == "band":
        st, info, _, _, _ = shearband_dyrel.run(n=16, nt=2, dtype=torch.float64, device=d)
        return st, info
    st, geometry, bc, mat, prc, prv, _, kw = dyrel_nonlinear_setup(16, torch.float64, d)
    return solver_dyrel.solve_dyrel(st, geometry, bc, mat, prc, prv, 0.25, **kw)


# Phase 31's card-against-CPU limits, relative to each field's max, 1e-10
# where not named. RP is rounding of its terms at convergence: held to
# their scale, max |V|/dx (dx = 1/16). ∇·V is a real field here (Kb·dt = 1):
# on its own max, at the limit that lies between the sound solves' readings
# (1.3e-10) and a solve whose chunks run one DR iteration short (9.1e-8);
# PERF.md.
DYREL_CARD_VS_CPU_LIMITS = {"grad_V": 1e-9}


def dyrel_field_diffs(a, b):
    """max |a − b| of every field of two states, over max |b| (over 16·max|V|
    for RP, 0 where equal)."""
    vmax = max(float(b.V.Vx.abs().max()), float(b.V.Vy.abs().max()))
    scales = {"R.Rx": vmax, "R.Ry": vmax, "R.RP": 16.0 * vmax}
    out = {}
    for name, x, y in flat_state(a, b):
        d = float((x.cpu() - y).abs().max())
        out[name] = 0.0 if d == 0.0 else d / scales.get(name, float(y.abs().max()))
    return out


def run_dyrel(dev, smi, kind):
    """Phases 30-32; returns the launches of B2/B3 and B5 per DYREL golden."""
    solve_dyrel = solver_dyrel.solve_dyrel
    f64, f32 = torch.float64, torch.float32
    launches = {}

    # ---- 30. DYREL goldens through the default entry points, f64
    run_golden_set(dyrel_golden_cases(), "golden_dyrel", smi, launches, apart=DYREL_APART)

    # ---- 31. the graph against the eager chunk, bit for bit, from the same
    # mid-solve state at 64^2 f64 (the band: after a step, its old stresses
    # scaled to above yield so that the return mapping acts, as in
    # tests/test_torch_dyrel.py); the card's 16^2 solve against the CPU's
    for label in ("linear", "nonlinear"):
        if label == "linear":
            st, geometry, bc, mat, prc, prv, kw = dyrel_band_setup(64, f64, dev)
            st, _ = solve_dyrel(st, geometry, bc, mat, prc, prv, 0.25,
                                **dict(kw, iter_max=300, total_iter_max=300))
            st = st.replace(tau_o=st.tau_o.replace(**{
                k: 8.0 * getattr(st.tau, k) for k in ("xx", "yy", "xy", "xy_c", "xx_v", "yy_v")}))
        else:
            st, geometry, bc, mat, prc, prv, _, kw = dyrel_nonlinear_setup(64, f64, dev)
        with dyrel_chunks() as rec:
            solve_dyrel(st, geometry, bc, mat, prc, prv, 0.25,
                        **dict(kw, iter_max=300, total_iter_max=300))
        s = rec["solves"][-1]
        nout = rec["replays"][-1][2]
        saved = [t.clone() for t in dyrel_carried(s)]
        s.chunk(nout)
        eager = [t.clone() for t in dyrel_carried(s)]
        for t, v in zip(dyrel_carried(s), saved):
            t.copy_(v)
        s.replay()
        torch.cuda.synchronize()
        diff = {k: float((a - b).abs().max()) for k, a, b in zip(DYREL_CARRIED, dyrel_carried(s),
                                                                   eager)}
        equal = all(torch.equal(a, b) for a, b in zip(dyrel_carried(s), eager))
        moved = any(not torch.equal(a, b) for a, b in zip(eager, saved))
        emit("dyrel_graph_parity", case=label, n=64, nout=nout, bit_equal=equal, moved=moved,
             lam_max=float(s.lam.max()), max_abs_diff=diff)
        check(equal, f"dyrel_graph_parity {label}: the replay differs from the eager chunk")
        check(moved, f"dyrel_graph_parity {label}: the chunk did not move the state")
        if label == "linear":
            check(float(s.lam.max()) > 0.0, "dyrel_graph_parity: plasticity inactive")
    for label in ("band", "nonlinear"):
        outs = {}
        for d in (dev, torch.device("cpu")):
            outs[d.type] = dyrel_parity_solve(label, d)
        (sc, ic), (sh, ih) = outs["cuda"], outs["cpu"]
        worst = dyrel_field_diffs(sc, sh)
        limits = {k: DYREL_CARD_VS_CPU_LIMITS.get(k, 1e-10) for k in worst}
        over = {k: v for k, v in worst.items() if v > limits[k]}
        line = dict(case=label, n=16, iters_card=ic.iters, iters_cpu=ih.iters,
                    err_card=float(ic.err), err_cpu=float(ih.err),
                    max_rel_diff=max(worst.values()), worst_field=max(worst, key=worst.get),
                    grad_V=worst["grad_V"], R_RP=worst["R.RP"], per_field=worst)
        if label == "nonlinear":
            # a faulty solve for the limits to tell apart: each chunk one
            # DR iteration short, on the CPU, against the sound CPU solve
            orig = solver_dyrel._DyrelSolve.chunk
            solver_dyrel._DyrelSolve.chunk = lambda self, nout: orig(self, nout - 1)
            try:
                sf, _ = dyrel_parity_solve(label, torch.device("cpu"))
            finally:
                solver_dyrel._DyrelSolve.chunk = orig
            fault = dyrel_field_diffs(sf, sh)
            line["fault_grad_V"], line["fault_R_RP"] = fault["grad_V"], fault["R.RP"]
            check(fault["grad_V"] > limits["grad_V"] and fault["R.RP"] > limits["R.RP"],
                  f"dyrel_card_vs_cpu: the limits pass a faulty solve ({fault})")
        emit("dyrel_card_vs_cpu", **line)
        check(ic.iters == ih.iters, f"dyrel_card_vs_cpu {label}: iterations differ")
        check(not over, f"dyrel_card_vs_cpu {label}: over the limit: {over}")

    # ---- 32. the DYREL band at 1024^2 f32, one step, 10 000 DR iterations at
    # most; then the per-iteration numbers at 32^2 f64 (the goldens' grid)
    for n, dtype, kw in ((1024, f32, PROD["shearband_dyrel"]), (32, f64, dict(n=32, nt=1))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with dyrel_chunks() as rec:
            st, info, _, _, tII = shearband_dyrel.run(dtype=dtype, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = rec["solves"][-1]
        iters = sum(nout for _, _, nout in rec["replays"])
        replay_s = sum(a.elapsed_time(b) for a, b, _ in rec["replays"]) * 1e-3
        nout = rec["replays"][-1][2]
        per_iter = dyrel_iteration_times(s, nout)
        words = dyrel_words(s)
        finite = all(bool(torch.isfinite(t).all()) for t in (
            st.V.Vx, st.V.Vy, st.P, st.tau.xx, st.tau.II))
        emit("main_path_dyrel" if n == 1024 else "dyrel_per_iteration", n=n,
             dtype=str(dtype).replace("torch.", ""), grid=kw, wall_s=wall, iters=info.iters,
             dr_iterations_replayed=iters, err=float(info.err),
             converged=float(info.err) <= 1e-6, tauII_max=float(tII.max()),
             graph_replay_s=replay_s, graph_ms_per_iter_solve=1e3 * replay_s / iters,
             capture_s=rec["capture_s"], words=words,
             bound_ms=bound_ms(words, n * n, torch.finfo(dtype).bits // 8, kind),
             finite=finite, nvidia_smi=smi, **per_iter)
        check(finite, f"main_path_dyrel {n}: non-finite fields")
        check(per_iter["replay_bit_equal"] and per_iter["replay_moved"],
              f"main_path_dyrel {n}: the replay is not bit-equal to the eager chunk")
        check(iters > 0 and info.iters > 0, f"main_path_dyrel {n}: no DR iteration ran")
    return launches


# ---- particles: phases 33-35 -------------------------------------------------
# the kernel each particle model's default entry point routes through on the
# card (None: plain by contract, or DYREL's graph replays only)
MODEL_KERNEL.update({
    "rising_blob3d": "stokes3d_chunk",
    "rising_blob3d_nt1": "stokes3d_chunk",
    "vankeken": "stokes_vep_chunk",
    "diffusion2d_multiphase": None,
    "diffusion3d_multiphase": None,
    "blankenbach_particles": "stokes_vep_chunk",
    "layered_convection_nondim": "thermal_chunk",
    "layered_convection3d": None,
    "layered_convection_dyrel": "thermal_chunk",
    "subduction2d_dyrel": None,
})
# phase 33's goldens in processes of their own, the longest (the host's
# dispatch of plain PyTorch iterations and of 50-iteration chunks), started
# beside phase 28's (with subduction2d_dyrel, in the script's process until
# the IO phase needed its time) and collected before phase 29
PARTICLES_APART = ("layered_convection_nondim", "vankeken", "layered_convection_dyrel",
                   "subduction2d_dyrel")
# the golden that runs as a slow cuda test instead (tests/test_torch_cuda.py::
# test_layered_convection3d_golden_f64): its serial 3D VEP solves, plain by
# contract, take 370-480 s of the host's dispatch on an H100 (PERF.md §5)
PARTICLES_MOVED = ("layered_convection3d",)
# bench.py's rising-blob golden: |Vz| max of the frozen CPU/f64 step at 16^3
RISING_BLOB_VZ = 3.2058708898361283e-09
DIFFUSION3D_MP_T = {(15, 15, 15): 1816.8262937737384, (16, 16, 16): 1834.4197141500213}
LAYERED_DYREL_VMAX = (3.1098e-5, 4.8768e-7)  # tests/test_layered_convection_dyrel.py
LAYERED_APT_VMAX = (3.2067e-5, 4.4046e-7)
# the two production steps of phase 35: each model's own particles, caps and
# nout, one step (the JAX tests run 100 and 3)
PROD["vankeken"] = dict(nx=1024, ny=1024, nt=1)
PROD["rising_blob3d"] = dict(n=126, nt=1)
# the particle operations held card against CPU that are pure selection,
# gathers and elementwise arithmetic (bit for bit); the others sum or
# scatter-add in another order on the card (PARTICLE_TOL of each field's max)
PARTICLE_BIT_EQUAL = ("init", "advect", "move", "move_slab", "inject", "grid2particle",
                      "centroid2particle", "centroid2particle_ghosted", "chain",
                      "chain_topography")
PARTICLE_TOL = 1e-13


def swirl_2d(geometry, amplitude=0.3):
    """A divergence-free cell (stream function sin·sin) on the ghosted
    staggered velocity grids of a 2D ``geometry``, numpy f64."""
    (ox, oy), (lx, ly) = geometry.origin, geometry.li
    (xv, yc), (xc, yv) = geometry.xi_vel
    X, Y = np.meshgrid(xv, yc, indexing="ij")
    Vx = amplitude * np.pi / ly * np.sin(np.pi * (X - ox) / lx) * np.cos(np.pi * (Y - oy) / ly)
    X, Y = np.meshgrid(xc, yv, indexing="ij")
    Vy = -amplitude * np.pi / lx * np.cos(np.pi * (X - ox) / lx) * np.sin(np.pi * (Y - oy) / ly)
    return Vx, Vy


def swirl_3d(geometry, a=0.25, b=0.2):
    """Two divergence-free cells, stream functions ψ1(x, y) and ψ2(x, z):
    Vx = ∂yψ1 + ∂zψ2, Vy = −∂xψ1, Vz = −∂xψ2, on the ghosted staggered
    grids of a 3D ``geometry``, numpy f64."""
    o, li = geometry.origin, geometry.li
    k = [np.pi / li[d] for d in range(3)]

    def s(u, d):
        return np.sin(k[d] * (u - o[d]))

    def c(u, d):
        return np.cos(k[d] * (u - o[d]))

    X, Y, Z = np.meshgrid(*geometry.xi_vel[0], indexing="ij")
    Vx = a * k[1] * s(X, 0) * c(Y, 1) + b * k[2] * s(X, 0) * c(Z, 2)
    X, Y, Z = np.meshgrid(*geometry.xi_vel[1], indexing="ij")
    Vy = -a * k[0] * c(X, 0) * s(Y, 1)
    X, Y, Z = np.meshgrid(*geometry.xi_vel[2], indexing="ij")
    Vz = -b * k[0] * c(X, 0) * s(Z, 2)
    return Vx, Vy, Vz


def particles_numpy(ndim, n, mx, seed=0):
    """Phase 34's inputs, numpy f64, for an n^ndim grid with ``mx`` slots:
    the geometry and slot counts, the divergence-free velocity and a dt that
    moves the fastest particle 0.8 cells, an active mask with 45 % of the
    initial particles dropped and a 3^ndim block of cells emptied (its
    center cell receives none in one step), particle phase (three phases)
    and T, a center and a ghosted center T, a vertex field and a cell phase
    field."""
    rng = np.random.default_rng(seed)
    if ndim == 2:
        li, origin = (2.0, 1.5), (0.3, -1.0)
    else:
        li, origin = (1.2, 1.0, 0.9), (0.0, 0.2, -0.9)
    ni = (n,) * ndim
    geometry = Geometry(ni, li, origin=origin)
    V = swirl_2d(geometry) if ndim == 2 else swirl_3d(geometry)
    dt = 0.8 * min(geometry.di) / max(float(np.abs(v).max()) for v in V)
    shape = ni + (mx,)
    nxcell = mx // 2
    active = np.zeros(shape, bool)
    active[..., :nxcell] = rng.random(ni + (nxcell,)) > 0.45
    block = tuple(slice(n // 3 - 1, n // 3 + 2) for _ in range(ndim))
    active[block] = False
    return dict(
        geometry=geometry, nxcell=nxcell, max_xcell=mx, min_xcell=(3 * mx) // 8, seed=seed,
        V=V, dt=dt, active=active, phase=np.floor(rng.random(shape) * 3.0),
        T=300.0 + 50.0 * rng.random(shape), Tc=300.0 + 50.0 * rng.random(ni),
        Tg=300.0 + 50.0 * rng.random(tuple(m + 2 for m in ni)),
        dTg=5.0 * rng.random(tuple(m + 2 for m in ni)),
        vert=rng.random(tuple(m + 1 for m in ni)),
        cell_phase=np.floor(rng.random(ni) * 3.0), empty=tuple(n // 3 for _ in range(ndim)))


def particle_ops(case, dev):
    """Every particle operation of the ``particles_numpy`` case's dimension
    on ``dev``, f64, from the case's numpy inputs: name → tuple of tensors
    (2D also the marker chain). ``starved`` counts the cells below
    ``min_xcell`` after the move, ``emptied`` the particles of the emptied
    cell then."""
    from justrelax_tpu_torch.particles import marker_chain as pmc
    from justrelax_tpu_torch.particles import particles as p2
    from justrelax_tpu_torch.particles import particles3d as p3

    g, ndim = case["geometry"], len(case["geometry"].ni)
    f = dict(dtype=torch.float64, device=dev)

    def t(name):
        return torch.as_tensor(case[name], **f)

    axes = ("px", "py", "pz")[:ndim]
    if ndim == 2:
        init, advect, move, inject = (p2.init_particles, p2.advect_rk2, p2.move_particles,
                                      p2.inject_particles)
        g2p, c2p, p2g, p2c = (p2.grid2particle, p2.centroid2particle, p2.particle2grid,
                              p2.particle2centroid)
        ratios = p2.phase_ratios_from_particles
        phases = t("cell_phase")
    else:
        init, advect, move, inject = (p3.init_particles_3d, p3.advect_rk2_3d,
                                      p3.move_particles_3d, p3.inject_particles_3d)
        g2p, c2p, p2g, p2c = (p3.grid2particle_3d, p3.centroid2particle_3d,
                              p3.particle2grid_3d, p3.particle2centroid_3d)
        ratios = p3.phase_ratios_from_particles_3d
        phases = 3

    def pos(p):
        return tuple(getattr(p, a) for a in axes)

    out = {}
    p = init(g, case["nxcell"], case["max_xcell"], case["min_xcell"], seed=case["seed"],
             device=dev)
    out["init"] = pos(p) + (p.active,)
    p = p.replace(active=torch.as_tensor(case["active"], device=dev))
    p = advect(p, tuple(torch.as_tensor(v, **f) for v in case["V"]), g, case["dt"])
    out["advect"] = pos(p)
    fields = {"phase": t("phase"), "T": t("T")}
    pm, fm = move(p, g, fields)
    out["move"] = pos(pm) + (pm.active, fm["phase"], fm["T"])
    ps, fs = move(p, g, fields, x_slab=max(1, g.ni[0] // 5))
    out["move_slab"] = pos(ps) + (ps.active, fs["phase"], fs["T"])
    count = pm.count()
    out["starved"] = int((count < pm.min_xcell).sum())
    out["emptied"] = int(count[case["empty"]])
    pi, fi = inject(pm, g, {"T": t("Tc")}, phases=phases, fields=fm)
    out["inject"] = pos(pi) + (pi.active, fi["phase"], fi["T"])
    out["min_count"] = int(pi.count().min())
    out["grid2particle"] = (g2p(t("vert"), pi, g),)
    out["centroid2particle"] = (c2p(t("Tc"), pi, g),)
    out["particle2grid"] = (p2g(fi["T"], pi, g),)
    out["particle2centroid"] = (p2c(fi["T"], pi, g),)
    out["phase_ratios"] = ratios(pi, fi["phase"], 3, g)
    if ndim == 2:
        out["centroid2particle_ghosted"] = (c2p(t("Tg"), pi, g),)
        mat = Material(rho0=3.3e3, alpha=2e-5, Cp=1.1e3, k=3.0)
        Tc_g = t("Tg")[1:-1, 1:-1]
        dt0 = p2.subgrid_characteristic_time(mat, Tc_g, torch.zeros_like(Tc_g), None, g.di)
        out["subgrid_diffusion"] = (p2.subgrid_diffusion(
            fi["T"], t("Tg"), t("dTg"), dt0, pi, g, 0.3 * float(dt0.min().cpu())),)
        chain = pmc.init_marker_chain(
            g, lambda x: g.origin[1] + 0.6 * g.li[1] + 0.05 * np.cos(2 * np.pi * x / g.li[0]),
            n_per_cell=3, device=dev)
        V = tuple(torch.as_tensor(v, **f) for v in case["V"])
        for _ in range(2):
            chain = pmc.advect_marker_chain(chain, V, g, case["dt"])
        out["chain"] = (chain.x, chain.y)
        pc, nbad = pmc.update_phases_given_markerchain(chain, pi, fi["phase"], 2)
        out["chain_topography"] = (pc.active, nbad)
    return out


def particle_diffs(card, cpu):
    """Per operation of ``particle_ops``: (bit_equal, max |card − cpu| over
    the max |cpu| of each tensor)."""
    out = {}
    for name, ts in cpu.items():
        if not isinstance(ts, tuple):
            continue
        eq, rel = True, 0.0
        for a, b in zip(card[name], ts):
            a = a.cpu()
            eq = eq and torch.equal(a, b)
            if b.is_floating_point():
                scale = float(b.abs().max()) if b.numel() else 0.0
                d = float((a - b).abs().max()) if b.numel() else 0.0
                rel = max(rel, d / scale if scale else d)
        out[name] = (eq, rel)
    return out


def mom_residual(geometry, st, eta, eta_v, rho_gy):
    """tests/test_subduction2d_dyrel.py's independent residual: the RMS of
    the plain staggered viscous momentum residual (τ = 2η ε̇ with the
    solve's η fields) and max |∇·V|."""
    inv_dx, inv_dy = 1.0 / geometry.di[0], 1.0 / geometry.di[1]
    Vx, Vy = st.V.Vx, st.V.Vy
    dVxdx = (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * inv_dx
    dVydy = (Vy[1:-1, 1:] - Vy[1:-1, :-1]) * inv_dy
    divV = dVxdx + dVydy
    exx, eyy = dVxdx - divV / 3.0, dVydy - divV / 3.0
    exy = 0.5 * ((Vx[:, 1:] - Vx[:, :-1]) * inv_dy + (Vy[1:, :] - Vy[:-1, :]) * inv_dx)
    txx, tyy, txy = 2 * eta * exx, 2 * eta * eyy, 2 * eta_v * exy
    P = st.P
    Rx = ((txx[1:, :] - txx[:-1, :]) * inv_dx + (txy[1:-1, 1:] - txy[1:-1, :-1]) * inv_dy
          - (P[1:, :] - P[:-1, :]) * inv_dx)
    Ry = ((tyy[:, 1:] - tyy[:, :-1]) * inv_dy + (txy[1:, 1:-1] - txy[:-1, 1:-1]) * inv_dx
          - (P[:, 1:] - P[:, :-1]) * inv_dy - 0.5 * (rho_gy[:, 1:] + rho_gy[:, :-1]))

    def rms(A):
        return float(torch.linalg.norm(A) / math.sqrt(A.numel()))

    return rms(Rx), rms(Ry), float(divV.abs().max())


def particle_golden_cases():
    """Phase 33's goldens: label → (run, checks), each through the model's
    default entry point on the card in f64 at its JAX test's size, each
    check that test's assertion (bench.py's for the rising blob at nt=1)."""
    from justrelax_tpu_torch.ops.interpolation import velocity2vertex
    from justrelax_tpu_torch.utils.units import dimensionalize, nondimensionalize

    f64 = torch.float64
    KM = subduction2d_dyrel.KM

    def g_rising_blob():
        d_rho, eta0, R = -100.0, 1.0e21, 0.12
        st, par, ph, info, zc = rising_blob3d.run(n=16, nt=3, d_rho=d_rho, eta0=eta0, R=R,
                                                  dtype=f64)
        a = par.active & (ph > 0.5)
        return dict(iters=int(info.iters), err=float(info.err), zc=zc,
                    vmax=float(st.V.Vz.max()),
                    v_stokes=2.0 / 9.0 * abs(d_rho) * 9.81 * (R * 1.0e6) ** 2 / eta0,
                    px_std=float(par.px[a].std(unbiased=False)),
                    pz_std=float(par.pz[a].std(unbiased=False)), R_L=R * 1.0e6)

    def g_rising_blob_nt1():
        st, _, _, info, zc = rising_blob3d.run(n=16, nt=1, dtype=f64)
        return dict(iters=int(info.iters), err=float(info.err), zc=zc[0],
                    vz_abs_max=float(st.V.Vz.abs().max()))

    def g_vankeken():
        urms, info, st, par, ph = vankeken.run(nx=32, ny=32, nt=100, dtype=f64)
        return dict(iters=int(info.iters), err=float(info.err), urms_first=urms[0],
                    urms_last=urms[-1], urms_max=max(urms), min_count=int(par.count().min()),
                    min_xcell=par.min_xcell)

    def g_diffusion2d_mp():
        th, info = diffusion2d_multiphase.run(nx=32, ny=32, dtype=f64)
        return dict(iters=int(info.iters), err=float(info.err), T17=float(th.T[17, 17]),
                    T16=float(th.T[16, 16]))

    def g_diffusion3d_mp():
        th, info = diffusion3d.run_multiphase(n=32, dtype=f64)
        return dict(iters=int(info.iters), err=float(info.err),
                    **{f"T{i[0]}": float(th.T[i]) for i in DIFFUSION3D_MP_T})

    def g_blankenbach_particles():
        urms, nu, info, st, th = blankenbach.run_particles(nx=32, ny=32, nit=10, dtype=f64)
        return dict(iters=int(info.iters), err=float(info.err), urms_last=urms[-1],
                    urms_3=urms[2], nu_last=nu[-1])

    def g_layered_nondim():
        st, th, par, ph, info, u, vmax = layered_convection_nondim.run(
            nx=16, ny=16, nt=2, nxcell=12, max_xcell=24, min_xcell=6, dtype=f64)
        T = th.T
        v_si = dimensionalize(max(vmax), "velocity", u)
        return dict(iters=int(info.iters), err=float(info.err), T_min=float(T.min()),
                    T_max=float(T.max()), Vy_max=float(st.V.Vy.max()),
                    phases=sorted(float(x) for x in torch.unique(ph[par.active]).cpu()),
                    T_top=nondimensionalize(273.0, "temperature", u),
                    T_bot=nondimensionalize(1492.0, "temperature", u),
                    dT=nondimensionalize(200.0, "temperature", u),
                    roundtrip=abs(nondimensionalize(v_si, "velocity", u) / max(vmax) - 1.0),
                    cm_yr=v_si * 100 * 365.25 * 24 * 3600)

    def g_layered3d():
        st, th, par, ph, info, vmax = layered_convection3d.run(
            nx=12, ny=12, nz=12, nt=2, nxcell=6, max_xcell=12, min_xcell=3, dtype=f64)
        T = th.T[1:-1, 1:-1, 1:-1]
        return dict(iters=int(info.iters), err=float(info.err),
                    phases=sorted(float(x) for x in torch.unique(ph[par.active]).cpu()),
                    T_min=float(T.min()), T_max=float(T.max()), T_max_ghosted=float(th.T.max()),
                    Vz_max=float(st.V.Vz.max()), finite=bool(torch.isfinite(st.V.Vz).all()),
                    vmax_1=vmax[0])

    def g_layered_dyrel():
        st, th, par, ph, info, u, vmax = layered_convection_dyrel.run(nx=32, ny=32, nt=2,
                                                                      dtype=f64)
        Vy = st.V.Vy
        return dict(iters=int(info.iters), err=float(info.err), vmax=vmax,
                    finite=bool(torch.isfinite(Vy).all() and torch.isfinite(th.T).all()),
                    Vy_max=float(Vy.max()), Vy_min=float(Vy.min()))

    def g_subduction_dyrel():
        nx, ny = 50, 20
        st, par, ph, prc, info, tip, aux = subduction2d_dyrel.run(nx=nx, ny=ny, nt=2, dtype=f64)
        geometry = Geometry((nx, ny), (3000.0 * KM, 750.0 * KM), origin=(0.0, -700.0 * KM))
        rx, ry, divmax = mom_residual(geometry, st, aux["eta"], aux["eta_v"], aux["rho_gy"])
        yc = torch.as_tensor(geometry.xci[1], device=st.P.device)
        tII = st.tau.II
        Vxv, Vyv = velocity2vertex(st.V.Vx, st.V.Vy)
        yv = torch.as_tensor(geometry.xvi[1], device=st.P.device)
        return dict(iters=int(info.iters), err=float(info.err), rx=rx, ry=ry, divmax=divmax,
                    tip=tip, t_air=float(tII[:, yc > 5.0 * KM].max()),
                    t_rock=float(tII[:, yc < -5.0 * KM].max()),
                    v_rock=float(torch.sqrt(Vxv**2 + Vyv**2)[:, yv < 0.0].max()))

    def near(a, b, rtol):
        return abs(a - b) <= rtol * abs(b)

    return {
        "rising_blob3d": (g_rising_blob, lambda g: [
            ("err", g["err"] < 1e-6),
            ("rising", all(b > a for a, b in zip(g["zc"], g["zc"][1:]))),
            ("Stokes speed", 0.6 * g["v_stokes"] < g["vmax"] < 1.4 * g["v_stokes"]),
            ("coherent", g["px_std"] < 1.5 * g["R_L"] and g["pz_std"] < 1.5 * g["R_L"])]),
        "rising_blob3d_nt1": (g_rising_blob_nt1, lambda g: [
            ("|Vz| max", near(g["vz_abs_max"], RISING_BLOB_VZ, 2e-2)),
            ("finite", math.isfinite(g["vz_abs_max"]) and g["vz_abs_max"] > 0.0)]),
        "vankeken": (g_vankeken, lambda g: [
            ("err", g["err"] < 1e-4), ("Urms < 1e-2", g["urms_max"] < 1e-2),
            ("growth", g["urms_last"] > g["urms_first"]),
            ("min count", g["min_count"] >= g["min_xcell"])]),
        "diffusion2d_multiphase": (g_diffusion2d_mp, lambda g: [
            ("err", g["err"] < 1e-5), ("T[17, 17]", abs(g["T17"] - 1814.029) <= 1e-1),
            ("T[16, 16]", abs(g["T16"] - 1823.548) <= 1e-1)]),
        "diffusion3d_multiphase": (g_diffusion3d_mp, lambda g: [("err", g["err"] < 1e-5)] + [
            (f"T{i[0]}", near(g[f"T{i[0]}"], v, 1e-3)) for i, v in DIFFUSION3D_MP_T.items()]),
        "blankenbach_particles": (g_blankenbach_particles, lambda g: [
            ("err", g["err"] < 1e-4),
            ("Urms", near(g["urms_last"], 0.40987052065118357, 2e-1)),
            ("Nu", near(g["nu_last"], 1.0026242251320245, 1e-2)),
            ("spin-up", g["urms_last"] > g["urms_3"] > 0.0)]),
        "layered_convection_nondim": (g_layered_nondim, lambda g: [
            ("err", g["err"] < 1e-5),
            ("T window", g["T_min"] > 0.5 * g["T_top"] and g["T_max"] < g["T_bot"] + g["dT"] + 0.1),
            ("upward", g["Vy_max"] > 0.0), ("phases", g["phases"] == [0.0, 1.0, 2.0]),
            ("units", g["roundtrip"] <= 1e-12), ("ascent", 1e-6 < g["cm_yr"] < 10.0),
            ("Vy max", near(g["Vy_max"], 4.160546429279427e-06, 1e-5)),
            ("T max", near(g["T_max"], 1.5278565116446254, 1e-6))]),
        "layered_convection3d": (g_layered3d, lambda g: [
            ("err", g["err"] < 1e-5), ("phases", g["phases"] == [0.0, 1.0, 2.0]),
            ("T window", 270.0 < g["T_min"] and g["T_max"] < 1492.0 + 251.0),
            ("upward", g["Vz_max"] > 0.0 and g["finite"]),
            ("Vz max", near(g["vmax_1"], 7.086241845485486e-11, 1e-5)),
            ("T max", near(g["T_max_ghosted"], 1542.5441453335352, 1e-6))]),
        "layered_convection_dyrel": (g_layered_dyrel, lambda g: [
            ("finite", g["finite"]), ("err", g["err"] < 1e-4)] + [
            (f"vmax {k}", near(g["vmax"][k], LAYERED_DYREL_VMAX[k], 0.05)
             and near(g["vmax"][k], LAYERED_APT_VMAX[k], 0.15)) for k in range(2)] + [
            ("circulation", g["Vy_max"] > 0.2 * abs(g["Vy_min"])
             and g["Vy_min"] < -0.2 * g["Vy_max"])]),
        "subduction2d_dyrel": (g_subduction_dyrel, lambda g: [
            ("err", g["err"] < 1e-5), ("residual", g["rx"] < 10.0 and g["ry"] < 40.0),
            ("div V", g["divmax"] < 1e-12), ("tip", g["tip"][0] < -180.0 * KM),
            ("descent", all(b < a for a, b in zip(g["tip"], g["tip"][1:]))),
            ("air stress", g["t_air"] < 0.05 * g["t_rock"]),
            ("rock |V|", 1.0e-8 < g["v_rock"] < 2.0e-8)]),
    }


@contextlib.contextmanager
def particle_step_timers(module, names):
    """CUDA events around each call of ``module``'s functions ``names``
    (``timed_calls``), the active particles handed to the first call of the
    first name (the step's count before) and the host clock around
    ``init_name`` (the numpy draw and its copy to the card): yields a dict
    name → event pairs, with ``active_before`` and ``init_s``."""
    rec = {}
    with contextlib.ExitStack() as stack:
        for name in names:
            rec[name] = stack.enter_context(timed_calls(module, name))
        advect = getattr(module, names[0])
        init_name = next(n for n in dir(module) if n.startswith("init_particles"))
        init = getattr(module, init_name)

        def counted(particles, *a, **k):
            rec.setdefault("active_before", int(particles.active.sum()))
            return advect(particles, *a, **k)

        def timed_init(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = init(*a, **k)
            torch.cuda.synchronize()
            rec["init_s"] = time.perf_counter() - t0
            return out

        setattr(module, names[0], counted)
        setattr(module, init_name, timed_init)
        try:
            yield rec
        finally:
            setattr(module, names[0], advect)
            setattr(module, init_name, init)


def run_particles(dev, smi, apart_results):
    """Phases 33-35; returns the launches of each kernel per particle phase.
    ``apart_results`` hold the results of phase 33's goldens that ran in
    processes of their own (``PARTICLES_APART``, started beside phase 28)."""
    f32 = torch.float32
    launches = {}

    # ---- 33. goldens through the default entry points, f64, the JAX tests'
    # sizes and assertions; four ran in processes of their own
    cases = {k: v for k, v in particle_golden_cases().items() if k not in PARTICLES_MOVED}
    emit("golden_particles_moved", cases=PARTICLES_MOVED,
         test="tests/test_torch_cuda.py::test_layered_convection3d_golden_f64 (slow, cuda)")
    run_golden_set(cases, "golden_particles", smi, launches, apart_results=apart_results)

    # ---- 34. each particle operation on the card against the CPU, f64, from
    # the same numpy inputs
    for ndim, n, mx in ((2, 64, 24), (3, 16, 12)):
        case = particles_numpy(ndim, n, mx)
        card, cpu = particle_ops(case, dev), particle_ops(case, torch.device("cpu"))
        diffs = particle_diffs(card, cpu)
        slab_eq = all(torch.equal(a, b) for a, b in zip(card["move"], card["move_slab"]))
        emit("particles_card_vs_cpu", ndim=ndim, grid=[n] * ndim, slots=mx,
             starved=card["starved"], emptied=card["emptied"], min_count=card["min_count"],
             slab_equals_whole=slab_eq,
             ops={k: {"bit_equal": e, "max_rel_diff": r} for k, (e, r) in diffs.items()})
        for name, (eq, rel) in diffs.items():
            if name in PARTICLE_BIT_EQUAL:
                check(eq, f"particles_card_vs_cpu {ndim}D {name}: not bit-equal")
            else:
                check(rel <= PARTICLE_TOL, f"particles_card_vs_cpu {ndim}D {name}: {rel}")
        check(slab_eq, f"particles_card_vs_cpu {ndim}D: the slab move differs from the whole")
        check(card["starved"] > 0 and card["emptied"] == 0,
              f"particles_card_vs_cpu {ndim}D: no starved or emptied cell")
        check(card["min_count"] >= case["min_xcell"],
              f"particles_card_vs_cpu {ndim}D: a cell below min_xcell after injection")

    # ---- 35. one step of each production model, f32, through the default
    # entry point: wall time split by CUDA events into the Stokes solve and
    # the particle operations, peak memory, launches, particle counts
    prod = {
        "vankeken": (vankeken, ("advect_rk2", "move_particles", "inject_particles",
                                "phase_ratios_from_particles"), "solve_vep", vankeken.run),
        "rising_blob3d": (rising_blob3d, ("advect_rk2_3d", "move_particles_3d",
                                          "inject_particles_3d",
                                          "phase_ratios_from_particles_3d"), "solve_ve_3d",
                          rising_blob3d.run),
    }
    for label, (module, names, solver, run) in prod.items():
        kernel = MODEL_KERNEL[label]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with particle_step_timers(module, names) as rec, timed_solves(module, solver) as solves:
            out = run(dtype=f32, **PROD[label])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        particles = out[3] if label == "vankeken" else out[1]
        stokes = out[2] if label == "vankeken" else out[0]
        split = {name.replace("_3d", ""): events_s(rec[name]) for name in names}
        stokes_split = solves_summary(solves)
        stokes_s = sum(s["seconds"] for s in stokes_split)
        count = particles.count()
        finite = all(bool(torch.isfinite(t).all()) for t in (
            stokes.V.Vx, stokes.V.Vy, stokes.P, particles.px, particles.py))
        line = dict(case=label, dtype="float32", grid=PROD[label], wall_s=wall,
                    stokes=stokes_split, stokes_s=stokes_s, particles_s=split,
                    init_particles_s=rec.get("init_s"),
                    rest_s=wall - stokes_s - sum(split.values()),
                    peak_memory_GiB=torch.cuda.max_memory_allocated() / 2**30,
                    kernel=kernel, launches=c[kernel],
                    other_launches=sum(v for k, v in c.items() if k != kernel),
                    active_before=rec.get("active_before"), active_after=int(count.sum()),
                    min_count_after=int(count.min()), min_xcell=particles.min_xcell,
                    finite=finite, nvidia_smi=smi)
        emit("main_path_particles", **line)
        launches.setdefault(kernel, {})[f"production_{label}"] = c[kernel]
        check(finite, f"main_path_particles {label}: non-finite fields")
        check(c[kernel] > 0, f"main_path_particles {label}: {kernel} was not launched")
        check(line["min_count_after"] >= particles.min_xcell,
              f"main_path_particles {label}: a cell below min_xcell after injection")
        del out, particles, stokes
        torch.cuda.empty_cache()
    return launches


# ---- the variational solvers: phases 36-38 ---------------------------------
# every variational golden runs plain PyTorch (the variational chunks as CUDA
# graph replays) and no kernel of the port
VARIATIONAL_LABELS = (
    "variational_phi_one", "variational_sticky_air", "variational3d_phi_one",
    "variational3d_sticky_air", "volcano2d", "volcano2d_dyrel", "rayleigh_taylor",
    "run_plume", "run_plume_variational", "crameri2d", "subduction2d", "subduction3d")
MODEL_KERNEL.update({label: None for label in VARIATIONAL_LABELS})
# phase 36's goldens in processes of their own beside phase 28's
VARIATIONAL_APART = ("volcano2d", "run_plume_variational")
# the goldens that run as slow cuda tests instead (tests/test_torch_cuda.py::
# test_variational_golden_f64), for their time on an H100 (PERF.md): the 3D
# subduction's masked 3D VEP solves and the plume's solve_vep, plain by
# contract, dispatch each of tens of thousands of iterations from the host;
# the 2D subduction's two solves run to their 80 000 cap; Crameri's four
# solves (130 000 graphed iterations) took 293 s as a fifth process and put
# the script past 800 s; the overturn (two solves, 48 000 graphed iterations
# of ~500 small kernels each) and the DYREL volcano took 177 and 186 s as
# processes beside phase 28 and went when the IO phase needed the script's
# time (the overturn's path runs in phase 38, the volcano's as one of
# MOVED_DRIVES)
VARIATIONAL_MOVED = ("subduction3d", "run_plume", "subduction2d", "crameri2d",
                     "volcano2d_dyrel", "rayleigh_taylor")
# phase 38's two production steps and their cuts: one step each; the
# overturn's Stokes cap 6 000 (three of its 2 000-iteration chunks; the
# model's 50 000; 10 000 until the nonuniform phases needed the script's
# time); the 3D subduction's Stokes cap cut to one nout (1 000; the model's
# 60 000), set on its solve_vep_3d calls
PROD["rayleigh_taylor"] = dict(nx=1024, ny=1024, nt=1, iter_max=6_000)
PROD["subduction3d"] = dict(nx=252, ny=96, nz=84, nt=1)
SUBDUCTION3D_STOKES_CAP = 1_000
CM_YR = 1.0e-2 / (365.25 * 24 * 3600)
KYR = 1.0e3 * 365.25 * 24 * 3600


@contextlib.contextmanager
def variational_chunks():
    """``GraphedChunk.run_chunk`` wrapped: each solve object with graphs,
    the capture time (host clock, synchronized) and CUDA events around each
    chunk's replays, each under its solve's class (``_VariationalSolve``,
    ``_Variational3DSolve``, ``_DyrelSolve``). Yields a dict with
    ``solves``, ``capture_s`` ((class, s)) and ``replays`` ((start, end,
    iterations, graphs, class))."""
    rec = {"solves": [], "capture_s": [], "replays": []}
    orig = GraphedChunk.run_chunk

    def shim(self, n):
        if n == 0:
            return
        if self.graphs is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.capture(n)
            torch.cuda.synchronize()
            rec["capture_s"].append((type(self).__name__, time.perf_counter() - t0))
            rec["solves"].append(self)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        self.replay()
        b.record()
        rec["replays"].append((a, b, n, len(self.graphs), type(self).__name__))

    GraphedChunk.run_chunk = shim
    try:
        yield rec
    finally:
        GraphedChunk.run_chunk = orig


def replays_summary(rec):
    """``{"graphs": {solve class: ...}}``: for each class of solve that
    captured graphs, its captures, chunks replayed (and the graph launches
    they made), the iterations replayed and the ms per replayed iteration by
    the events around the replays."""
    torch.cuda.synchronize()
    out = {}
    for name in dict.fromkeys(c for c, _ in rec["capture_s"]):
        replays = [r for r in rec["replays"] if r[4] == name]
        iters = sum(r[2] for r in replays)
        ms = sum(r[0].elapsed_time(r[1]) for r in replays)
        out[name] = dict(graph_captures=sum(c == name for c, _ in rec["capture_s"]),
                         capture_s=[t for c, t in rec["capture_s"] if c == name],
                         graph_replays=len(replays), graph_launches=sum(r[3] for r in replays),
                         iterations_replayed=iters,
                         graph_ms_per_iter_solve=ms / iters if iters else None)
    return {"graphs": out}


def blob_setup(n, dtype, dev, free_surface=False):
    """tests/test_variational.py's sticky-air blob at n²: (state, coeffs,
    geometry, BCs, materials, ratios, rock ratio, dt, kwargs)."""
    geometry = Geometry((n, n), (1.0, 1.0))
    st = StokesState.make((n, n), dtype=dtype, device=dev)
    f = dict(dtype=st.P.dtype, device=st.P.device)
    X, Y = geometry.cell_centers_mesh()
    phase = np.zeros((n, n), dtype=int)
    phase[Y > 0.75] = 1
    phase[(X - 0.5) ** 2 + (Y - 0.4) ** 2 <= 0.1**2] = 2
    pr = phase_ratios_from_field(torch.as_tensor(phase, device=f["device"]), 3, dtype=f["dtype"])
    phi = update_rock_ratio(pr, air_phase=1)
    mat = MaterialStack.make([Material(rho0=1.0, eta0=1.0, gravity=10.0),
                              Material(rho0=0.0, eta0=1.0e-3, gravity=10.0),
                              Material(rho0=2.0, eta0=1.0, gravity=10.0)], **f)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, eps_rel=1e-6, CFL=1.0 / math.sqrt(2.1))
    bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True))
    kw = dict(iter_max=30_000, nout=500)
    dt = math.inf
    if free_surface:
        dt = 0.1
        kw.update(free_surface=True, mask_step_floor=0.3, air_phase=1)
    return st, pt, geometry, bc, mat, pr, phi, dt, kw, phase


def phi_one_setup(n, dtype, dev):
    """tests/test_variational.py's φ ≡ 1 set-up at n²: one phase, ρ
    perturbed through T."""
    geometry = Geometry((n, n), (1.0, 1.0))
    st = StokesState.make((n, n), dtype=dtype, device=dev)
    f = dict(dtype=st.P.dtype, device=st.P.device)
    ones = functools.partial(torch.ones, **f)
    phi = RockRatio(center=ones((n, n)), vertex=ones((n + 1, n + 1)), Vx=ones((n + 1, n)),
                    Vy=ones((n, n + 1)))
    X, Y = geometry.cell_centers_mesh()
    T = -torch.as_tensor(0.1 * np.sin(np.pi * X) * np.sin(np.pi * Y), **f)
    mat = MaterialStack.make([Material(rho0=1.0, alpha=1.0, T0=0.0, eta0=1.0, gravity=1.0)], **f)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1))
    bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True))
    return st, pt, geometry, bc, mat, ones((n, n, 1)), ones((n + 1, n + 1, 1)), phi, T


def sphere_setup(ni, dtype, dev, air_z=1.0, lz=4.0 / 3.0):
    """tests/test_variational3d.py's sticky-air sphere: (state, coeffs,
    geometry, BCs, ρg, G, K, rock ratio, the cell phases)."""
    geometry = Geometry(ni, (1.0, 1.0, lz))
    st = StokesState.make(ni, dtype=dtype, device=dev)
    f = dict(dtype=st.P.dtype, device=st.P.device)
    x, y, z = geometry.cell_centers_mesh()
    air = z > air_z
    sphere = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2 < 0.2**2
    phases = np.where(air, 2, np.where(sphere, 1, 0))
    pr = phase_ratios_from_field(torch.as_tensor(phases, device=f["device"]), 3, dtype=f["dtype"])
    phi = update_rock_ratio_3d(pr, air_phase=2)
    st = st.replace(viscosity=st.viscosity.replace(
        eta=torch.as_tensor(np.where(sphere, 10.0, 1.0), **f)))
    rho = torch.as_tensor(np.where(air, 0.0, np.where(sphere, 2.0, 1.0)), **f)
    z0 = torch.zeros(ni, **f)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(3.0), eps_rel=1.0e-6)
    bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True,
                                                    front=True, back=True))
    return (st, pt, geometry, bc, (z0, z0, rho), torch.full(ni, math.inf, **f),
            torch.tensor(math.inf, **f), phi, phases)


def masked_vep3d_setup(n, dtype, dev, geometry=None):
    """The masked 3D VEP solve's set-up of tests/test_torch_variational3d.py
    at n³ on the unit cube, or on ``geometry``: a plastic crust, a stiff
    sphere and sticky air, elastic; (solve_vep_3d's arguments, the rock
    ratio)."""
    if geometry is None:
        geometry = Geometry((n, n, n), (1.0, 1.0, 1.0))
    ni = geometry.ni
    st = StokesState.make(ni, dtype=dtype, device=dev)
    f = dict(dtype=st.P.dtype, device=st.P.device)
    x, y, z = geometry.cell_centers_mesh()
    sphere = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.4) ** 2 < 0.3**2
    phases = np.where(z > 0.7, 2, np.where(sphere, 1, 0))
    mat = MaterialStack.make([
        Material(rho0=1.0, eta0=1.0, gravity=1.0, G=1.0, Kb=10.0, is_plastic=1.0, C=0.05,
                 friction_angle=30.0, eta_reg=1.0e-2),
        Material(rho0=2.0, eta0=10.0, gravity=1.0, G=1.0, Kb=10.0),
        Material(rho0=0.0, eta0=1.0e-2, gravity=1.0, G=1.0, Kb=10.0)], **f)
    pr = phase_ratios_from_field(torch.as_tensor(phases, device=f["device"]), 3, dtype=f["dtype"])
    st = st.replace(viscosity=st.viscosity.replace(
        eta=torch.as_tensor(np.choose(phases, [1.0, 10.0, 1.0e-2]), **f)))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.9 / math.sqrt(3.1), eps_rel=1.0e-6)
    bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True,
                                                    front=True, back=True))
    args = (st, pt, geometry, bc, mat, pr.center, (pr.edge_yz, pr.edge_xz, pr.edge_xy), 0.5)
    return args, update_rock_ratio_3d(pr, air_phase=2)


def variational_golden_cases():
    """Phase 36's goldens: label → (run, checks), each through the default
    entry points on the card in f64 at its JAX test's size, each check that
    test's assertion; each reports the variational graph's captures and
    replays."""
    from justrelax_tpu_torch.ops.rock_ratio import valid_masks, valid_masks_3d
    from justrelax_tpu_torch.solvers.stokes2d_variational import solve_variational
    from justrelax_tpu_torch.solvers.stokes3d_variational import solve_variational_3d

    f64 = torch.float64

    def graphed(fn):
        def run():
            with variational_chunks() as rec:
                g = fn()
            g.update(replays_summary(rec))
            return g
        return run

    def g_phi_one():
        st, pt, geometry, bc, mat, prc, prv, phi, T = phi_one_setup(16, f64, None)
        sv, iv = solve_variational(st, pt, geometry, bc, mat, prc, prv, phi, math.inf, T=T,
                                   iter_max=4000, nout=200)
        sp, ip = solver_vep.solve_vep(st, pt, geometry, bc, mat, prc, prv, math.inf, T=T,
                                      iter_max=4000, nout=200, use_kernel=False)
        return dict(iters=int(iv.iters), iters_vep=int(ip.iters),
                    Vx_diff=float((sv.V.Vx - sp.V.Vx).abs().max()),
                    P_diff=float((sv.P - sp.P).abs().max()))

    def g_sticky_air():
        st, pt, geometry, bc, mat, pr, phi, dt, kw, phase = blob_setup(32, f64, None)
        s, info = solve_variational(st, pt, geometry, bc, mat, pr.center, pr.vertex, phi, dt,
                                    **kw)
        vm = valid_masks(phi)
        Vy_in = s.V.Vy[1:-1, 1:-1]
        blob = torch.as_tensor(phase[:, :-1] == 2, device=Vy_in.device)
        return dict(iters=int(info.iters), err=float(info.err),
                    air_Vy_max=float(Vy_in[~vm.vy[:, 1:-1]].abs().max()),
                    blob_Vy_mean=float(Vy_in[blob].mean()))

    def g_phi_one_3d():
        ni = (8, 8, 8)
        geometry = Geometry(ni, (1.0, 1.0, 1.0))
        rng = np.random.default_rng(1)
        st = StokesState.make(ni, dtype=f64)
        f = dict(dtype=f64, device=st.P.device)
        st = st.replace(viscosity=st.viscosity.replace(
            eta=torch.as_tensor(np.exp(rng.normal(size=ni) * 0.3), **f)))
        rho = torch.as_tensor(1.0 + 0.1 * rng.normal(size=ni), **f)
        z0 = torch.zeros(ni, **f)
        pr = phase_ratios_from_field(torch.zeros(ni, dtype=torch.long, device=f["device"]), 2)
        phi = update_rock_ratio_3d(pr, air_phase=1)
        pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(3.0),
                                 eps_rel=1e-30, eps_abs=1e-30)
        bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True,
                                                        bot=True, front=True, back=True))
        G, K = torch.full(ni, math.inf, **f), torch.tensor(math.inf, **f)
        sr, _ = solver_ve3d.solve_ve_3d(st, pt, geometry, bc, (z0, z0, rho), G, K, math.inf,
                                        iter_max=200, nout=100, use_kernel=False)
        sv, info = solve_variational_3d(st, pt, geometry, bc, (z0, z0, rho), G, K, phi,
                                        math.inf, iter_max=200, nout=100)
        return dict(iters=int(info.iters), Vz_diff=float((sv.V.Vz - sr.V.Vz).abs().max()),
                    P_diff=float((sv.P - sr.P).abs().max()))

    def g_sticky_air_3d():
        st, pt, geometry, bc, rho_g, G, K, phi, _ = sphere_setup((12, 12, 16), f64, None)
        s, info = solve_variational_3d(st, pt, geometry, bc, rho_g, G, K, phi, math.inf,
                                       iter_max=20_000, nout=500)
        vm = valid_masks_3d(phi)
        Vz = s.V.Vz
        return dict(iters=int(info.iters), err=float(info.err), Vz_666=float(Vz[6, 6, 6]),
                    air_Vz_max=float(Vz[1:-1, 1:-1, 1:-1][~vm.vz[:, :, 1:-1]].abs().max()))

    def g_volcano():
        st, th, par, chain, phi_m, info = volcano2d.run(nx=16, ny=8, nt=2, dtype=f64)
        Vy, y, T = st.V.Vy, chain.y, th.T
        px = par.px[par.active]
        return dict(iters=int(info.iters), err=float(info.err),
                    finite=bool(torch.isfinite(Vy).all() and torch.isfinite(y).all()),
                    Vy_max=float(Vy.abs().max()), y_min=float(y.min()), y_max=float(y.max()),
                    y_abs_max=float(y.abs().max()), phi_m_max=float(phi_m.max()),
                    T_min=float(T.min()), T_max=float(T.max()),
                    active=int(par.active.sum()), px_min=float(px.min()),
                    px_max=float(px.max()), tauII_max=float(st.tau.II.max()),
                    upwelling=float(Vy[6:12, 4:6].mean()))

    def g_volcano_dyrel():
        nx, ny = 16, 8
        st, th, par, phi_m, info, aux = volcano2d_dyrel.run(nx=nx, ny=ny, nt=2, dtype=f64)
        geometry = Geometry((nx, ny), (30.0e3, 25.0e3), origin=(0.0, -20.0e3))
        inv_dx, inv_dy = 1.0 / geometry.di[0], 1.0 / geometry.di[1]
        tyy, txy, P, rho_gy = st.tau.yy, st.tau.xy, st.P, aux["rho_gy"]
        Ry = ((tyy[:, 1:] - tyy[:, :-1]) * inv_dy + (txy[1:, 1:-1] - txy[:-1, 1:-1]) * inv_dx
              - (P[:, 1:] - P[:, :-1]) * inv_dy - 0.5 * (rho_gy[:, 1:] + rho_gy[:, :-1]))
        Vy = st.V.Vy
        cmyr = 100.0 * 365.25 * 24 * 3600
        return dict(iters=int(info.iters), err=float(info.err),
                    rms=float(torch.linalg.norm(Ry) / math.sqrt(Ry.numel())),
                    scale=float(rho_gy.abs().mean()), Vy_max_cmyr=float(Vy.max()) * cmyr,
                    Vy_min_cmyr=float(Vy.min()) * cmyr, T_min=float(th.T.min()),
                    T_max=float(th.T.max()), phi_m_max=float(phi_m.max()),
                    finite=bool(torch.isfinite(st.tau.II).all()),
                    upwelling=float(Vy[6:12, 4:6].mean()))

    def g_rt():
        st, par, ph, info, vmax, t = rayleigh_taylor.run(nx=32, ny=32, nt=2, dtype=f64)
        a = par.active
        counts = [int(((ph == k) & a).sum()) for k in range(3)]
        return dict(iters=int(info.iters), err=float(info.err), vmax=vmax, counts=counts,
                    P_max=float(st.P.max()))

    def g_plume():
        st, par, ph, info, vmax, t = rayleigh_taylor.run_plume(nx=32, ny=32, nt=1, dtype=f64)
        Vy = st.V.Vy
        iy = int(torch.argmax(Vy).item()) % Vy.shape[1]
        return dict(iters=int(info.iters), err=float(info.err), vmax=vmax,
                    finite=bool(torch.isfinite(Vy).all()), Vx_max=float(st.V.Vx.abs().max()),
                    iy=iy, ny=Vy.shape[1] - 1)

    def g_plume_var():
        st, par, ph, info, vmax, t = rayleigh_taylor.run_plume_variational(nx=32, ny=32, nt=2,
                                                                           dtype=f64)
        return dict(iters=int(info.iters), err=float(info.err), vmax=vmax,
                    finite=bool(torch.isfinite(st.V.Vy).all()))

    def g_crameri():
        st, par, ph, info, h, t = crameri2d.run(nx=32, ny=32, nt=4, dt_max_kyr=5.0, dtype=f64)
        k = np.polyfit(t, np.log(h), 1)[0]
        return dict(iters=int(info.iters), err=float(info.err), h=h.tolist(),
                    t_relax_kyr=-1.0 / k / KYR)

    def g_subduction2d():
        st, th, info, phases = subduction2d.run(nx=64, ny=24, nt=2, dtype=f64)
        h = info.err_history.cpu().numpy()
        valid = h[np.isfinite(h)]
        Vy = st.V.Vy.cpu().numpy()
        Vy_c = 0.5 * (Vy[1:-1, :-1] + Vy[1:-1, 1:])
        slab, air = phases == subduction2d.LITH, phases == subduction2d.AIR
        return dict(iters=int(info.iters), err=float(info.err), h_first=float(valid[0]),
                    h_last=float(valid[-1]),
                    v_cm_yr=float(Vy_c[slab].mean() * 100 * 365.25 * 24 * 3600),
                    air_max=float(np.abs(Vy_c[air]).max()),
                    slab_mean_abs=float(np.abs(Vy_c[slab]).mean()),
                    Vy_max=float(np.abs(Vy).max()), T_mean=float(th.T.mean()))

    def g_subduction3d():
        st, th, info, phases = subduction3d.run(nx=48, ny=8, nz=16, nt=2, dtype=f64)
        Vz, Vy = st.V.Vz, st.V.Vy
        T = th.T[1:-1, 1:-1, 1:-1]
        return dict(iters=int(info.iters), err=float(info.err),
                    finite=bool(torch.isfinite(Vz).all()), Vz_min=float(Vz.min()),
                    Vz_max=float(Vz.max()), Vz_abs_max=float(Vz.abs().max()),
                    Vy_abs_max=float(Vy.abs().max()), T_min=float(T.min()), T_max=float(T.max()))

    def near(a, b, rtol):
        return abs(a - b) <= rtol * abs(b)

    cases = {
        "variational_phi_one": (g_phi_one, lambda g: [
            ("iters", g["iters"] == g["iters_vep"]),
            ("vs solve_vep", g["Vx_diff"] <= 1e-12 and g["P_diff"] <= 1e-12)]),
        "variational_sticky_air": (g_sticky_air, lambda g: [
            ("err", g["err"] < 1e-4), ("air at rest", g["air_Vy_max"] == 0.0),
            ("blob sinks", g["blob_Vy_mean"] < 0.0)]),
        "variational3d_phi_one": (g_phi_one_3d, lambda g: [
            ("vs solve_ve_3d", g["Vz_diff"] <= 1e-13 and g["P_diff"] <= 1e-13)]),
        "variational3d_sticky_air": (g_sticky_air_3d, lambda g: [
            ("iters", g["iters"] < 20_000), ("sphere sinks", g["Vz_666"] < -1.0e-4),
            ("air at rest", g["air_Vz_max"] == 0.0)]),
        "volcano2d": (g_volcano, lambda g: [
            ("err", g["err"] < 1e-4), ("iters", g["iters"] < 100_000), ("finite", g["finite"]),
            ("topography", g["y_abs_max"] < 2.0e3), ("melt", g["phi_m_max"] > 1e-3),
            ("T", g["T_min"] > 200.0 and g["T_max"] < 1800.0), ("active", g["active"] > 0),
            ("in domain", g["px_min"] >= -1.0 and g["px_max"] <= 30.0e3 + 1.0),
            ("upwelling", g["upwelling"] > 0.0),
            ("Vy max", near(g["Vy_max"], 1.3946289129149216e-05, 1e-5)),
            ("y min", near(g["y_min"], -263.5669607300024, 1e-5)),
            ("y max", near(g["y_max"], 323.05486911291047, 1e-5)),
            ("phi_m max", near(g["phi_m_max"], 0.7155154808992358, 1e-5)),
            ("T min", near(g["T_min"], 272.7302522410007, 1e-6)),
            ("tauII max", near(g["tauII_max"], 18340921.940666106, 1e-5))]),
        "volcano2d_dyrel": (g_volcano_dyrel, lambda g: [
            ("err", g["err"] < 1e-4), ("force balance", g["rms"] < 2.0e-4 * g["scale"]),
            ("Vy max", near(g["Vy_max_cmyr"], 93.196, 2e-2)),
            ("Vy min", near(g["Vy_min_cmyr"], -94.879, 2e-2)),
            ("T", g["T_min"] > 250.0 and g["T_max"] <= 1623.0 + 1e-6),
            ("melt", 0.0 < g["phi_m_max"] <= 1.0), ("finite", g["finite"]),
            ("upwelling", g["upwelling"] > 0.0)]),
        "rayleigh_taylor": (g_rt, lambda g: [
            ("err", math.isfinite(g["err"]) and g["err"] < 1e-2),
            ("iters", g["iters"] < 50_000), ("growth", g["vmax"][1] > g["vmax"][0] > 0.0),
            ("phases", g["counts"] == [4069, 3764, 16743]),
            ("vmax 0", near(g["vmax"][0], 5.318893356245688e-06, 1e-5)),
            ("vmax 1", near(g["vmax"][1], 1.2842506924408967e-05, 1e-5)),
            ("P max", near(g["P_max"], 1.5405634554251656e10, 1e-4))]),
        "run_plume": (g_plume, lambda g: [
            ("err", math.isfinite(g["err"])), ("finite", g["finite"]),
            ("vmax", near(g["vmax"][0], 8.132817330884509e-09, 1e-5)),
            ("Vx max", near(g["Vx_max"], 1.148033224900681e-08, 1e-5)),
            ("rising", g["iy"] > g["ny"] // 4)]),
        "run_plume_variational": (g_plume_var, lambda g: [
            ("err", g["err"] < 1e-4), ("finite", g["finite"]),
            ("vmax 0", near(g["vmax"][0], 4.9869242014546195e-09, 1e-5)),
            ("vmax 1", near(g["vmax"][1], 2.8594736096290873e-09, 1e-4))]),
        "crameri2d": (g_crameri, lambda g: [
            ("err", g["err"] < 1e-3), ("decay", all(b < a for a, b in zip(g["h"], g["h"][1:]))),
            ("h0 > 5 km", g["h"][0] > 5.0e3), ("relaxation", 14.0 < g["t_relax_kyr"] < 27.0),
            ("h first", near(g["h"][0], 5738.77020554, 1e-6)),
            ("h last", near(g["h"][-1], 2147.6, 5e-3))]),
        "subduction2d": (g_subduction2d, lambda g: [
            ("convergence", g["h_last"] < 0.05 * g["h_first"]),
            ("slab sinks", -100.0 < g["v_cm_yr"] < -0.1),
            ("air at rest", g["air_max"] < 50 * g["slab_mean_abs"]),
            ("v slab", near(g["v_cm_yr"], -8.12271522695263, 1e-5)),
            ("Vy max", near(g["Vy_max"], 2.776206296426089e-08, 1e-5)),
            ("T mean", near(g["T_mean"], 1561.9627799560321, 1e-6))]),
        "subduction3d": (g_subduction3d, lambda g: [
            ("err", g["err"] < 1e-4), ("finite", g["finite"]),
            ("slab sinks", -20 * CM_YR < g["Vz_min"] < -0.5 * CM_YR),
            ("T", 250.0 < g["T_min"] and g["T_max"] < 1800.0),
            ("2D", g["Vy_abs_max"] < 0.05 * g["Vz_abs_max"]),
            ("Vz min", near(g["Vz_min"], -1.0311600516051363e-09, 1e-5)),
            ("Vz max", near(g["Vz_max"], 4.863380641192766e-10, 1e-5)),
            ("T min", near(g["T_min"], 429.1688847185895, 1e-6))]),
    }
    return {label: (graphed(fn), checks) for label, (fn, checks) in cases.items()}


def block_iteration_times(s, reps=3):
    """ms per iteration of the solve object ``s``'s first captured graph
    (``GRAPH_BLOCK`` iterations, or the whole chunk when it is shorter):
    its replay and the same iterations run eagerly, by CUDA events, each
    from the same state (the carried fields restored between runs); whether
    the replay leaves the carried fields bit-equal to the eager iterations;
    and the kernels one eager iteration launches. The state is left as
    found."""
    n = min(s.graph_iterations, GRAPH_BLOCK)
    saved = [t.clone() for t in s.carried()]

    def restore():
        for t, v in zip(s.carried(), saved):
            t.copy_(v)

    def timed(fn):
        out = []
        for _ in range(reps):
            restore()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b) / n)
        return out, [t.clone() for t in s.carried()]

    graph_ms, after_graph = timed(s.graphs[0].replay)
    eager_ms, after_eager = timed(lambda: s.chunk(n))
    equal = all(torch.equal(a, b) for a, b in zip(after_graph, after_eager))
    moved = any(not torch.equal(a, b) for a, b in zip(after_eager, saved))
    restore()
    launches = dyrel_launches_per_iteration(s)
    restore()
    return dict(block_iterations=n, graph_ms_per_iter=graph_ms, eager_ms_per_iter=eager_ms,
                replay_bit_equal=equal, replay_moved=moved, **launches)


def _varying(t):
    return isinstance(t, torch.Tensor) and t.numel() > 1 and bool(
        (t != t.reshape(-1)[0]).any())


def words_per_cell(carried, read_only, n_cells, itemsize):
    """Words per cell one iteration must move: each carried field read and
    written, each read-only input that does not hold one value everywhere
    read once (a bool mask as a byte), counted from the tensors themselves."""
    def words(t):
        return t.numel() * t.element_size() / itemsize / n_cells

    return 2 * sum(words(t) for t in carried) + sum(words(t) for t in read_only if _varying(t))


def variational_words(s):
    """``words_per_cell`` of one 2D variational iteration of the solve
    object ``s``: its 12 carried fields, and its read-only inputs (P0, Q,
    the old stresses and moduli, the plastic parameters at centers and
    vertices, the rock ratio and its masks, the step preconditioner, the
    buoyancy, the viscosity tables or the phase ratios, T)."""
    inv = s.inv
    ro = [s.P0, s.Q, s.pcx, s.pcy, s.rho_gy, s.T, *s.phi, *s.vm]
    ro += [inv.txx_o, inv.tyy_o, inv.txy_c_o, inv.txy_v_o, inv.txx_ov, inv.tyy_ov,
           inv.K_c, inv.G_c, inv.K_v, inv.G_v, *inv.ppc, *inv.ppv]
    ro += list(s.eta_tables) if s.eta_tables is not None else [s.visc_c, s.visc_v]
    return words_per_cell(s.carried(), [t for t in ro if t is not None], s.P.numel(),
                          s.P.element_size())


def masked_vep3d_words(args, kwargs):
    """``words_per_cell`` of one masked serial 3D VEP iteration from the
    solve's inputs: the 19 carried fields (V, P, θ, six center and three
    edge stresses, η, λ at the centers and edges), and the read-only inputs
    (P0, Q, τ_o, EII_pl, T, the phase ratios, the rock ratio and its masks)."""
    from justrelax_tpu_torch.ops.rock_ratio import valid_masks_3d

    st, pr_c, pr_e = args[0], args[5], args[6]
    tau, to, phi = st.tau, st.tau_o, kwargs["phi"]
    carried = [st.V.Vx, st.V.Vy, st.V.Vz, st.P, st.P, tau.xx, tau.yy, tau.zz, tau.yz_c,
               tau.xz_c, tau.xy_c, tau.yz, tau.xz, tau.xy, st.viscosity.eta, st.P,
               tau.yz, tau.xz, tau.xy]
    ro = [st.P, st.Q, to.xx, to.yy, to.zz, to.yz_c, to.xz_c, to.xy_c, to.yz, to.xz, to.xy,
          st.EII_pl, kwargs.get("T"), pr_c, *pr_e, *phi, *valid_masks_3d(phi)]
    return words_per_cell(carried, [t for t in ro if t is not None], st.P.numel(),
                          st.P.element_size())


# the masked 3D VEP's card-against-CPU solve, at its cap either way (500
# until the distributed phase needed the script's time)
MASKED_VEP3D_PARITY_ITERS = 300


def variational_parity_solve(label, d):
    """Phase 37's card-against-CPU solves on device ``d``, f64:
    (state, info)."""
    from justrelax_tpu_torch.solvers.stokes2d_variational import solve_variational
    from justrelax_tpu_torch.solvers.stokes3d_variational import solve_variational_3d

    f64 = torch.float64
    if label in ("2d", "2d_free_surface"):
        st, pt, geometry, bc, mat, pr, phi, dt, kw, _ = blob_setup(
            16, f64, d, free_surface=label == "2d_free_surface")
        return solve_variational(st, pt, geometry, bc, mat, pr.center, pr.vertex, phi, dt,
                                 **dict(kw, iter_max=4_000, nout=200))
    if label == "3d":
        st, pt, geometry, bc, rho_g, G, K, phi, _ = sphere_setup((8, 8, 8), f64, d, 0.7, 1.0)
        return solve_variational_3d(st, pt, geometry, bc, rho_g, G, K, phi, math.inf,
                                    iter_max=2_000, nout=200)
    args, phi = masked_vep3d_setup(8, f64, d)
    return solve_vep_3d(*args, phi=phi, use_kernel=False, iter_max=MASKED_VEP3D_PARITY_ITERS,
                        iter_min=100, nout=100)


def variational_field_diffs(a, b):
    """max |a − b| of every field of two states, over max |b| (the momentum
    residuals over max |ρg| = 20, RP and ∇·V over max |V|·n, 0 where
    equal)."""
    V = [getattr(b.V, k) for k in ("Vx", "Vy", "Vz") if getattr(b.V, k) is not None]
    vmax = max(float(v.abs().max()) for v in V) * b.P.shape[0]
    scales = {"R.Rx": 20.0, "R.Ry": 20.0, "R.Rz": 20.0, "R.RP": vmax, "grad_V": vmax}
    out = {}
    for name, x, y in flat_state(a, b):
        d = float((x.cpu() - y).abs().nan_to_num(0.0).max())
        scale = scales.get(name, float(y.abs().nan_to_num(0.0).max()))
        out[name] = 0.0 if d == 0.0 else d / scale
    return out


def start_goldens(labels):
    """One ``--golden LABEL`` process for each of ``labels``, started now."""
    return {label: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--golden",
                                     label], cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            for label in labels}


def finish_goldens(procs, phase):
    """Wait for the golden processes ``procs``; their results by label.
    A failed process fails the phase; none is left running."""
    results = {}
    try:
        for label, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            check(proc.returncode == 0 and lines,
                  f"{phase} {label}: its process failed ({proc.returncode}):\n{err[-3000:]}")
            results[label] = json.loads(lines[-1])
    finally:
        stop_processes(procs)
    return results


def stop_processes(procs):
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_golden_set(cases, phase, smi, launches, apart=(), apart_results=None, beside=None):
    """Run a phase's goldens: those in ``apart`` in processes of their own,
    started here and run beside the others; those whose results
    ``apart_results`` already holds (their processes ran earlier); the rest
    here, and then ``beside()`` while the processes run on. Emit each with
    its checks: its own assertions, the kernel its model routes through
    launched (its count added to ``launches``) and no other. Returns the
    results."""
    done = {k: v for k, v in (apart_results or {}).items() if k in cases}
    procs = start_goldens(apart)
    try:
        here = {label: golden_result(label, cases[label][0])
                for label in cases if label not in procs and label not in done}
        if beside is not None:
            beside()
        done.update(finish_goldens(procs, phase))
    finally:
        stop_processes(procs)
    results = {**here, **done}
    for label, (_, checks) in cases.items():
        g = results[label]
        kernel = g["kernel"]
        emit(phase, case=label, nvidia_smi=smi, apart=label in done, **g)
        for key, ok in checks(g):
            check(ok, f"{phase} {label}: {key}")
        if kernel is not None:
            launches.setdefault(kernel, {})[f"golden_{label}"] = g["launches"]
            check(g["launches"] > 0, f"{phase} {label}: {kernel} was not launched")
        check(g["other_launches"] == 0, f"{phase} {label}: another kernel launched")
    return results


def run_variational(dev, smi, kind, apart_results):
    """Phases 36-38; returns each kernel's launches per variational golden
    and production step (all 0: the variational paths run no kernel).
    ``apart_results`` are the results of phase 36's goldens that ran in
    processes of their own (``VARIATIONAL_APART``, started before phase 28
    and collected before phase 29: they share the card while phase 28's
    goldens wait on the host's dispatch, and no timing is taken meanwhile)."""
    from justrelax_tpu_torch.solvers.stokes2d_variational import solve_variational

    f64, f32 = torch.float64, torch.float32
    launches = {}

    # ---- 36. goldens through the default entry points, f64, the JAX tests'
    # sizes and assertions; four ran in processes of their own
    cases = {k: v for k, v in variational_golden_cases().items() if k not in VARIATIONAL_MOVED}
    emit("golden_variational_moved", cases=VARIATIONAL_MOVED,
         test="tests/test_torch_cuda.py::test_variational_golden_f64 (slow, cuda)")
    results = run_golden_set(cases, "golden_variational", smi, launches,
                             apart_results=apart_results)
    for label, g in results.items():
        for kernel, n in g["all_launches"].items():
            launches.setdefault(kernel, {})[f"golden_{label}"] = n

    # ---- 37. the graph against the eager chunk, bit for bit, from the same
    # mid-solve sticky-air state (2D at 64^2 with and without the
    # free-surface term, 3D at 16^3); then the card's solves against the CPU
    from justrelax_tpu_torch.solvers.stokes3d_variational import solve_variational_3d

    for label in ("2d", "2d_free_surface", "3d"):
        if label == "3d":
            st, pt, geometry, bc, rho_g, G, K, phi, _ = sphere_setup((16, 16, 16), f64, dev,
                                                                     0.7, 1.0)
            st, _ = solve_variational_3d(st, pt, geometry, bc, rho_g, G, K, phi, math.inf,
                                         iter_max=100, nout=100)
            with variational_chunks() as rec:
                solve_variational_3d(st, pt, geometry, bc, rho_g, G, K, phi, math.inf,
                                     iter_max=100, nout=100)
        else:
            st, pt, geometry, bc, mat, pr, phi, dt, kw, _ = blob_setup(
                64, f64, dev, free_surface=label == "2d_free_surface")
            kw = dict(kw, iter_max=200, iter_min=0, nout=200)
            st, _ = solve_variational(st, pt, geometry, bc, mat, pr.center, pr.vertex, phi, dt,
                                      **kw)
            with variational_chunks() as rec:
                solve_variational(st, pt, geometry, bc, mat, pr.center, pr.vertex, phi, dt,
                                  **kw)
        s = rec["solves"][-1]
        n = s.graph_iterations
        saved = [t.clone() for t in s.carried()]
        s.chunk(n)
        eager = [t.clone() for t in s.carried()]
        for t, v in zip(s.carried(), saved):
            t.copy_(v)
        s.replay()
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(s.carried(), eager))
        moved = any(not torch.equal(a, b) for a, b in zip(eager, saved))
        diff = max(float((a - b).abs().max()) for a, b in zip(s.carried(), eager))
        emit("variational_graph_parity", case=label, grid=list(st.P.shape), iterations=n,
             bit_equal=equal, moved=moved, max_abs_diff=diff)
        check(equal, f"variational_graph_parity {label}: the replay differs from the eager chunk")
        check(moved, f"variational_graph_parity {label}: the chunk did not move the state")
    for label in ("2d", "2d_free_surface", "3d", "vep3d_masked"):
        (sc, ic), (sh, ih) = (variational_parity_solve(label, d)
                              for d in (dev, torch.device("cpu")))
        worst = variational_field_diffs(sc, sh)
        over = {k: v for k, v in worst.items() if v > 1e-10}
        emit("variational_card_vs_cpu", case=label, iters_card=int(ic.iters),
             iters_cpu=int(ih.iters), err_card=float(ic.err), err_cpu=float(ih.err),
             max_rel_diff=max(worst.values()), worst_field=max(worst, key=worst.get),
             per_field=worst)
        check(int(ic.iters) == int(ih.iters), f"variational_card_vs_cpu {label}: iterations")
        check(not over, f"variational_card_vs_cpu {label}: over 1e-10: {over}")

    # ---- 38. the production steps, f32, through the default entry points
    # the Rayleigh-Taylor overturn at 1024^2 (its own particles and caps)
    names = ("advect_rk2", "move_particles", "inject_particles", "phase_ratios_from_particles")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with particle_step_timers(rayleigh_taylor, names) as prec, \
            timed_solves(rayleigh_taylor, "solve_variational") as solves, \
            variational_chunks() as rec:
        st, par, ph, info, vmax, _ = rayleigh_taylor.run(dtype=f32, **PROD["rayleigh_taylor"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    c = counts()
    stokes_split = solves_summary(solves)
    stokes_s = sum(x["seconds"] for x in stokes_split)
    split = {name: events_s(prec[name]) for name in names}
    s = rec["solves"][-1]
    per_iter = block_iteration_times(s)
    words = variational_words(s)
    n_cells = st.P.numel()
    finite = all(bool(torch.isfinite(t).all()) for t in (st.V.Vx, st.V.Vy, st.P, par.px))
    emit("main_path_variational", case="rayleigh-taylor-1024-f32", grid=PROD["rayleigh_taylor"],
         dtype="float32", wall_s=wall, stokes=stokes_split, stokes_s=stokes_s,
         particles_s=split, init_particles_s=prec.get("init_s"),
         rest_s=wall - stokes_s - sum(split.values()), **replays_summary(rec),
         vmax=vmax, peak_memory_GiB=peak, words=words,
         bound_ms=bound_ms(words, n_cells, 4, kind), finite=finite,
         active_after=int(par.active.sum()), launches=c, nvidia_smi=smi, **per_iter)
    check(finite, "main_path_variational rayleigh_taylor: non-finite fields")
    check(per_iter["replay_bit_equal"] and per_iter["replay_moved"],
          "main_path_variational rayleigh_taylor: the replay is not bit-equal to the eager chunk")
    check(sum(c.values()) == 0, "main_path_variational rayleigh_taylor: a kernel launched")
    for kernel, n in c.items():
        launches.setdefault(kernel, {})["production_rayleigh_taylor"] = n
    del st, par, ph, s, rec
    torch.cuda.empty_cache()

    # the 3D subduction at 252x96x84 (2.03 M cells), its Stokes cap one nout
    solve = subduction3d.solve_vep_3d
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    # the cap wraps the timed solver, so the timing sees it as the call's own
    with timed_solves(subduction3d, "solve_vep_3d") as solves, \
            timed_solves(subduction3d, "heatdiffusion_PT") as thermal_solves, \
            capped(subduction3d, "solve_vep_3d", iter_max=SUBDUCTION3D_STOKES_CAP) as calls:
        st, th, info, _ = subduction3d.run(dtype=f32, **PROD["subduction3d"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    c = counts()
    stokes_split = solves_summary(solves)
    stokes_s = sum(x["seconds"] for x in stokes_split)
    thermal_s = events_s([(a, b) for a, b, _, _ in thermal_solves])
    thermal_iters = [int(x[2].iters) for x in thermal_solves]
    # one eager masked iteration on the step's own inputs: the difference of
    # a 10- and a 5-iteration solve (one chunk each), its time by CUDA events
    # and its launches by torch.profiler (the step warmed everything up)
    args, kwargs = calls[0]

    def short(k):
        return lambda: solve(*args, **dict(kwargs, iter_max=k, iter_min=0, nout=k))

    eager_ms = (cuda_time_ms(short(10), repeats=1) - cuda_time_ms(short(5), repeats=1)) / 5
    n10, n5 = (profiled_launches(short(k), warm_up=False) for k in (10, 5))
    words = masked_vep3d_words(args, kwargs)
    n_cells = st.P.numel()
    finite = all(bool(torch.isfinite(t).all()) for t in (st.V.Vx, st.V.Vy, st.V.Vz, st.P, th.T))
    emit("main_path_variational", case="subduction3d-252x96x84-f32",
         grid=dict(PROD["subduction3d"], stokes_iter_max=SUBDUCTION3D_STOKES_CAP),
         dtype="float32", wall_s=wall, stokes=stokes_split,
         stokes_s=stokes_s, thermal_s=thermal_s, thermal_iters=thermal_iters,
         rest_s=wall - stokes_s - thermal_s, eager_ms_per_iter=eager_ms,
         launches_per_iter=None if None in (n10, n5) else (n10 - n5) / 5,
         words=words, bound_ms=bound_ms(words, n_cells, 4, kind), peak_memory_GiB=peak,
         finite=finite, err=float(info.err), launches=c, nvidia_smi=smi)
    check(finite, "main_path_variational subduction3d: non-finite fields")
    check(sum(c.values()) == 0, "main_path_variational subduction3d: a kernel launched")
    for kernel, n in c.items():
        launches.setdefault(kernel, {})["production_subduction3d"] = n
    return launches


# ---- nonuniform grids: phases 39-40 -------------------------------------------
# The nonuniform paths run plain PyTorch by contract (every kernel needs a
# uniform grid), so no kernel of the port launches in them.
MODEL_KERNEL.update({"shearband_refined": None, "shearband_refined_preyield": None})
# the refined band's full golden (n=32, nt=10: 528 s of plain iterations,
# each the host's dispatch of ~480 kernels) runs as the slow cuda test
# test_shearband_refined_golden_f64; phase 39 keeps its first two steps
# (three, 65-113 s, until the IO phase needed the script's time), in a
# process of its own beside phase 28's (in the script's process until then)
NONUNIFORM_MOVED = ("shearband_refined",)
NONUNIFORM_APART = ("shearband_refined_preyield",)
# frozen f64 values of the JAX model (justrelax_tpu/models/shearband_refined.py,
# run(n=32, nt=2) on the CPU with x64): the last step's iterations and err,
# max τxx per step, τII's extrema and max |P|
REFINED_PREYIELD = dict(
    iters=3700, err=3.459436850877808e-08,
    tau_max=(0.4285850368787478, 0.7679284703691031),
    tII_min=0.5035523430977397, tII_max=0.767570944867357, P_max=0.22039117314484333)
# phase 40: one step of the refined band at the flagship's grid, its Stokes
# cap cut to 1 000 (the model's 50 000; 2 000 until the IO phase needed the
# script's time) through a wrapper of its solver
PROD["shearband_refined"] = dict(n=1024, nt=1)
SHEARBAND_REFINED_STOKES_CAP = 1_000
NONUNIFORM_LABELS = ("ve", "vep", "thermal", "explicit", "dyrel", "variational", "ve3d",
                     "vep3d", "vep3d_phi", "variational3d")
NONUNIFORM_CARD_VS_CPU = 1e-12  # of each field's max (the residuals: their terms' scale)


def tanh_vertices(n, length=1.0, beta=1.5):
    """n + 1 tanh-clustered vertices on [0, length], refined at the center."""
    s = np.linspace(-1.0, 1.0, n + 1)
    return 0.5 * length * (np.tanh(beta * s) / np.tanh(beta) + 1.0)


def nonuniform_solve(label, d):
    """Phase 39's solve ``label`` on device ``d`` in f64, on a tanh-stretched
    grid of a few hundred cells (24 × 20 in 2D, 8 × 7 × 6 in 3D), a fixed
    count of iterations (``iter_max = nout``; DYREL three outer iterations
    of one 50-iteration chunk each; the explicit step ten steps, no info):
    (state, info, the residuals' scale: the momentum residuals' body force,
    or the thermal residual's terms ρCp·T/dt + ∇·q)."""
    from justrelax_tpu_torch.models import taylor_green
    from justrelax_tpu_torch.solvers import thermal_explicit as te
    from justrelax_tpu_torch.solvers.stokes2d_variational import solve_variational
    from justrelax_tpu_torch.solvers.stokes3d_variational import solve_variational_3d

    f = dict(dtype=torch.float64, device=d)
    t = functools.partial(torch.as_tensor, **f)
    faces2 = Faces(left=True, right=True, top=True, bot=True)
    faces3 = Faces(left=True, right=True, top=True, bot=True, front=True, back=True)
    if label in ("ve3d", "vep3d", "vep3d_phi", "variational3d"):
        g = NonuniformGeometry((tanh_vertices(8, 1.0, 1.2), tanh_vertices(7, 1.0, 1.5),
                                tanh_vertices(6, 1.0, 1.0)))
    else:
        g = NonuniformGeometry((tanh_vertices(24), tanh_vertices(20, 1.0, 2.0)))
    ni = g.ni
    X, Y = g.cell_centers_mesh()[:2]
    if label == "ve":
        st = StokesState.make(ni, **f)
        eta = 1.0 + 0.5 * np.cos(2.0 * np.pi * X) * np.cos(np.pi * Y)
        st = st.replace(viscosity=st.viscosity.replace(eta=t(eta)))
        rho = np.where(Y > 0.7, 0.1, 1.0 + 0.3 * np.sin(np.pi * X))
        pt = PTStokesCoeffs.make(g.li, g.di, CFL=1.0 / math.sqrt(2.1))
        st, info = solver_ve.solve_ve(
            st, pt, g, VelocityBoundaryConditions(free_slip=faces2), (t(0 * rho), t(rho)),
            t(np.ones(ni)), t(np.full(ni, 10.0)), 0.05, iter_max=500, nout=500,
            free_surface=True, use_kernel=False)
        return st, info, 1.3
    if label == "vep":  # pure shear round a softer inclusion, yielding in the second step
        common = dict(Kb=4.0, eta0=1.0, is_plastic=1.0, C=0.6 / math.cos(math.radians(30.0)),
                      friction_angle=30.0, eta_reg=8.0e-3)
        mat = MaterialStack.make([Material(G=1.0, **common), Material(G=0.5, **common)], **f)
        pr_c = t(_circle_phase_ratios(g.xci[0], g.xci[1], (0.45, 0.55), 0.15))
        pr_v = t(_circle_phase_ratios(g.xvi[0], g.xvi[1], (0.45, 0.55), 0.15))
        st = StokesState.make(ni, **f)
        bc = VelocityBoundaryConditions(free_slip=faces2)
        Vx = t(np.broadcast_to(g.xvi[0][:, None], (ni[0] + 1, ni[1] + 2)).copy())
        Vy = t(np.broadcast_to(-g.xvi[1][None, :], (ni[0] + 2, ni[1] + 1)).copy())
        Vx, Vy = flow_bcs((Vx, Vy), bc)
        st = st.replace(V=st.V.replace(Vx=Vx, Vy=Vy),
                        viscosity=st.viscosity.replace(eta=t(np.ones(ni))))
        pt = PTStokesCoeffs.make(g.li, g.di, eps_rel=1.0e-8, eps_abs=1.0e-8,
                                 CFL=0.9 / math.sqrt(2.1))
        for _ in range(2):
            st, info = solver_vep.solve_vep(st, pt, g, bc, mat, pr_c, pr_v, 0.25, iter_max=200,
                                            iter_min=100, nout=200, use_kernel=False)
        return st, info, 1.0
    if label in ("thermal", "explicit"):
        rng = np.random.default_rng(4)
        bc = TemperatureBoundaryConditions(no_flux=Faces(left=True, right=True),
                                           constant_value=Faces(top=0.0, bot=1.0))
        T = thermal_bcs(t(rng.random((ni[0] + 2, ni[1] + 2))), bc)
        K, rc = t(rng.uniform(0.5, 2.0, ni)), t(rng.uniform(0.8, 1.2, ni))
        th = ThermalState.make(ni, **f).replace(T=T, Told=T, H=t(0.1 * rng.random(ni)))
        if label == "thermal":
            pt = PTThermalCoeffs.make(K, rc, 0.05, g.di, g.li)
            th, info = heatdiffusion_PT(th, pt, bc, 0.05, g, K=K, rho_Cp=rc, iter_max=500,
                                        nout=500, use_kernel=False)
            # ResT's terms: ρCp·T/dt and ∇·q (max |q| over the narrowest cell)
            scale = (float(rc.max() * th.T.abs().max()) / 0.05
                     + max(float(q.abs().max()) for q in (th.qTx2, th.qTy2)) / min(g.di))
            return th, info, scale
        params = te.ThermalParameters.make(K, rc)
        V = tuple(t(rng.standard_normal(tuple(n + 1 if a == c else n + 2
                                              for a, n in enumerate(ni)))) for c in range(2))
        th = te.solve_explicit(th, params, g, bc, 0.5 * te.stable_dt_explicit(params, g.di), 10,
                               V=V)
        return th, None, None
    if label == "dyrel":  # the DYREL shear band's two phases, one step
        common = dict(rho0=0.0, Kb=5.0, eta0=1.0, is_plastic=1.0,
                      C=1.6 / math.cos(math.radians(30.0)), friction_angle=30.0, eta_reg=8e-3)
        mat = MaterialStack.make([Material(G=1.0, **common), Material(G=0.5, **common)], **f)
        bc = VelocityBoundaryConditions(free_slip=faces2)
        st = StokesState.make(ni, **f)
        Vx = t(np.broadcast_to(g.xvi[0][:, None], (ni[0] + 1, ni[1] + 2)).copy())
        Vy = t(np.broadcast_to(-g.xvi[1][None, :], (ni[0] + 2, ni[1] + 1)).copy())
        Vx, Vy = flow_bcs((Vx, Vy), bc)
        st = st.replace(V=st.V.replace(Vx=Vx, Vy=Vy))
        pr_c = t(_circle_phase_ratios(g.xci[0], g.xci[1], (0.5, 0.5), 0.15))
        pr_v = t(_circle_phase_ratios(g.xvi[0], g.xvi[1], (0.5, 0.5), 0.15))
        st, info = solver_dyrel.solve_dyrel(st, g, bc, mat, pr_c, pr_v, 0.25, eps=1e-30,
                                            nout=50, iter_max=50, max_ph=3)
        return st, info, 1.0
    if label == "variational":  # a dense blob under sticky air
        phase = np.zeros(ni, dtype=int)
        phase[Y > 0.75] = 1
        phase[(X - 0.5) ** 2 + (Y - 0.4) ** 2 <= 0.15**2] = 2
        pr = phase_ratios_from_field(torch.as_tensor(phase, device=d), 3, dtype=f["dtype"])
        mat = MaterialStack.make([Material(rho0=1.0, eta0=1.0, gravity=10.0),
                                  Material(rho0=0.0, eta0=1.0e-3, gravity=10.0),
                                  Material(rho0=2.0, eta0=1.0, gravity=10.0)], **f)
        pt = PTStokesCoeffs.make(g.li, g.di, eps_rel=1e-6, CFL=1.0 / math.sqrt(2.1))
        st, info = solve_variational(
            StokesState.make(ni, **f), pt, g, VelocityBoundaryConditions(free_slip=faces2), mat,
            pr.center, pr.vertex, update_rock_ratio(pr, air_phase=1), math.inf, iter_max=300,
            nout=300)
        return st, info, 20.0
    if label == "ve3d":  # the stretched Taylor-Green
        _, st, info = taylor_green.run(iter_max=200, nout=200, geometry=g, dtype=f["dtype"],
                                       device=d)
        return st, info, 36.0 * math.pi**2
    x, y, z = g.cell_centers_mesh()
    bc = VelocityBoundaryConditions(free_slip=faces3)
    st = StokesState.make(ni, **f)
    if label == "variational3d":  # a sphere under sticky air
        phases = np.where(z > 0.7, 2, np.where((x - 0.5) ** 2 + (y - 0.5) ** 2
                                               + (z - 0.4) ** 2 < 0.25**2, 1, 0))
        pr = phase_ratios_from_field(torch.as_tensor(phases, device=d), 3, dtype=f["dtype"])
        st = st.replace(viscosity=st.viscosity.replace(eta=t(np.where(phases == 1, 10.0, 1.0))))
        rho = t(np.where(phases == 2, 0.0, np.where(phases == 1, 2.0, 1.0)))
        pt = PTStokesCoeffs.make(g.li, g.di, CFL=1.0 / math.sqrt(3.0), eps_rel=1.0e-6)
        inf = t(np.full(ni, math.inf))
        st, info = solve_variational_3d(st, pt, g, bc, (0 * rho, 0 * rho, rho), inf,
                                        t(math.inf), update_rock_ratio_3d(pr, air_phase=2),
                                        math.inf, iter_max=200, nout=200)
        return st, info, 2.0
    pt = PTStokesCoeffs.make(g.li, g.di, CFL=0.9 / math.sqrt(3.1), eps_rel=1.0e-6)
    kw = dict(iter_max=100, iter_min=100, nout=100, use_kernel=False)
    if label == "vep3d_phi":  # a plastic crust, a stiff sphere and sticky air
        args, phi = masked_vep3d_setup(None, f["dtype"], d, geometry=g)
        st, info = solve_vep_3d(*args, phi=phi, **kw)
        return st, info, 2.0
    # pure shear in x-z round a softer sphere, two steps
    phases = ((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.4) ** 2 < 0.25**2).astype(int)
    pr = phase_ratios_from_field(torch.as_tensor(phases, device=d), 2, dtype=f["dtype"])
    common = dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0,
                  C=0.6 / math.cos(math.radians(30.0)), friction_angle=30.0, eta_reg=8.0e-3)
    mat = MaterialStack.make([Material(G=1.0, **common), Material(G=0.5, **common)], **f)
    Vx = np.broadcast_to(g.xvi[0][:, None, None], (ni[0] + 1, ni[1] + 2, ni[2] + 2))
    Vz = np.broadcast_to(-g.xvi[2][None, None, :], (ni[0] + 2, ni[1] + 2, ni[2] + 1))
    st = st.replace(V=st.V.replace(Vx=t(Vx.copy()), Vz=t(Vz.copy())),
                    viscosity=st.viscosity.replace(eta=t(np.ones(ni))))
    for _ in range(2):
        st, info = solve_vep_3d(st, pt, g, bc, mat, pr.center,
                                (pr.edge_yz, pr.edge_xz, pr.edge_xy), 0.25, **kw)
    return st, info, 1.0


def nonuniform_field_diffs(a, b, res_scale):
    """max |a − b| of every field of two states over max |b|; the momentum
    residuals over their terms' scale (max |P|, |τ| times the cells per
    axis, plus ``res_scale``, max |ρg|), RP and ∇·V over max |V| times the
    cells per axis, the thermal residual over ``res_scale`` (0 where
    equal)."""
    scales = {} if res_scale is None else {"ResT": res_scale}
    if hasattr(b, "V"):
        n = max(b.P.shape)
        V = [getattr(b.V, k) for k in ("Vx", "Vy", "Vz") if getattr(b.V, k) is not None]
        vmax = max(float(v.abs().max()) for v in V) * n * 4
        terms = max(float(x.abs().max()) for x in (b.P, b.tau.xx, b.tau.yy, b.tau.xy))
        scales = {"R.Rx": terms * n * 4 + res_scale, "R.Ry": terms * n * 4 + res_scale,
                  "R.Rz": terms * n * 4 + res_scale, "R.RP": vmax, "grad_V": vmax}
    out = {}
    for name, x, y in flat_state(a, b):
        d = float((x.cpu() - y).abs().nan_to_num(0.0).max())
        scale = scales.get(name, float(y.abs().nan_to_num(0.0).max()))
        out[name] = 0.0 if d == 0.0 else d / scale
    return out


def nonuniform_golden_cases():
    """Phase 39's goldens: the refined shear band through its entry point on
    the card, f64, n=32, on tests/test_shearband_refined.py's assertions:
    its first two (pre-yield) steps here, held also to the JAX model's
    frozen values (REFINED_PREYIELD); all ten as the slow cuda test."""
    f64 = torch.float64

    def g_refined(nt):
        def run():
            st, info, tau_max, sol, tII = shearband_refined.run(n=32, nt=nt, dtype=f64)
            return dict(iters=int(info.iters), err=float(info.err), tau_max=tau_max, sol=sol,
                        tII_min=float(tII.min()), tII_max=float(tII.max()),
                        P_max=float(st.P.abs().max()))
        return run

    def rel(a, b):
        return abs(a - b) / abs(b)

    return {
        "shearband_refined_preyield": (g_refined(2), lambda g: [
            ("err", g["err"] < 1e-6),
            ("analytic curve", all(abs(a - s) <= 4e-2 * abs(s)
                                   for a, s in zip(g["tau_max"], g["sol"]))),
            ("iterations as JAX", g["iters"] == REFINED_PREYIELD["iters"]),
            ("tau_max as JAX", all(rel(a, b) <= 1e-9 for a, b in
                                   zip(g["tau_max"], REFINED_PREYIELD["tau_max"]))),
            ("tauII and P as JAX", all(rel(g[k], REFINED_PREYIELD[k]) <= 1e-9
                                       for k in ("tII_min", "tII_max", "P_max")))]),
        "shearband_refined": (g_refined(10), lambda g: [
            ("err", g["err"] < 1e-6),
            ("analytic curve", all(abs(a - s) <= 4e-2 * abs(s)
                                   for a, s in zip(g["tau_max"][:5], g["sol"][:5]))),
            ("tauII min", abs(g["tII_min"] - 1.51336) <= 2e-3),
            ("tauII max", abs(g["tII_max"] - 1.63926) <= 2e-3),
            ("tauII min uniform", abs(g["tII_min"] - 1.49798) <= 2e-2),
            ("tauII max uniform", abs(g["tII_max"] - 1.64485) <= 1e-2),
            ("txx max last", abs(g["tau_max"][-1] - 1.64586) <= 2e-3)]),
    }


def stretched_refusals(dev):
    """Each kernel route asked for on a stretched grid, on the card: the
    error's text, by route (``None`` where nothing was raised)."""
    f = dict(dtype=torch.float64, device=dev)
    g2 = NonuniformGeometry((tanh_vertices(8), tanh_vertices(6)))
    g3 = NonuniformGeometry((tanh_vertices(6), tanh_vertices(5), tanh_vertices(4)))
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)

    st2, z2 = StokesState.make(g2.ni, **f), torch.zeros(g2.ni, **f)
    pt2 = PTStokesCoeffs.make(g2.li, g2.di)
    bc2 = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True))
    mat = MaterialStack.make([Material(G=1.0, Kb=4.0)], **f)
    th = ThermalState.make(g2.ni, **f)
    tbc = TemperatureBoundaryConditions(constant_value=Faces(top=0.0, bot=1.0))
    one = torch.ones(g2.ni, **f)
    for route in (None, True, "blocked"):
        attempt(f"solve_ve[{route}]", lambda: solver_ve.solve_ve(
            st2, pt2, g2, bc2, (z2, z2), z2 + math.inf, math.inf, math.inf, iter_max=10,
            nout=10, use_kernel=route))
        attempt(f"solve_vep[{route}]", lambda: solver_vep.solve_vep(
            st2, pt2, g2, bc2, mat, None, None, 0.25, iter_max=10, nout=10, use_kernel=route))
    for route in (None, True):
        attempt(f"heatdiffusion_PT[{route}]", lambda: heatdiffusion_PT(
            th, PTThermalCoeffs.make(one, one, 0.3, g2.di, g2.li), tbc, 0.3, g2, K=one,
            rho_Cp=one, iter_max=10, nout=10, use_kernel=route))
    st3, z3 = StokesState.make(g3.ni, **f), torch.zeros(g3.ni, **f)
    pt3 = PTStokesCoeffs.make(g3.li, g3.di)
    bc3 = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True,
                                                     front=True, back=True))
    for route in (None, True, "blocked"):
        attempt(f"solve_ve_3d[{route}]", lambda: solver_ve3d.solve_ve_3d(
            st3, pt3, g3, bc3, (z3, z3, z3), z3 + math.inf, z3 + math.inf, math.inf,
            iter_max=10, nout=10, use_kernel=route))
    for route in (None, True, "edges", "edges_split", "blocked", "canvas"):
        attempt(f"solve_vep_3d[{route}]", lambda: solve_vep_3d(
            st3, pt3, g3, bc3, mat, None, (None, None, None), 0.25, iter_max=10, nout=10,
            use_kernel=route))
    return out


def record_counts(launches, key):
    """Each kernel's launch count into ``launches[kernel][key]``."""
    for kernel, n in counts().items():
        launches.setdefault(kernel, {})[key] = n


def run_nonuniform_parity(dev, smi):
    """Phase 39; returns each kernel's launches per case (all 0: the
    nonuniform paths run plain by contract). It takes no timing, so it runs
    while phase 28's golden processes wait on the host."""
    launches = {}

    # ---- 39. nonuniform goldens, f64: every ported solver on a stretched
    # grid, card against CPU with equal iterations
    for label in NONUNIFORM_LABELS:
        reset_counts()
        t0 = time.perf_counter()
        with variational_chunks() as rec:
            sc, ic, res_scale = nonuniform_solve(label, dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        record_counts(launches, f"nonuniform_{label}")
        sh, ih, _ = nonuniform_solve(label, torch.device("cpu"))
        worst = nonuniform_field_diffs(sc, sh, res_scale)
        over = {k: v for k, v in worst.items() if v > NONUNIFORM_CARD_VS_CPU}
        iters = (None, None) if ic is None else (int(ic.iters), int(ih.iters))
        emit("nonuniform_card_vs_cpu", case=label, grid=list(sc.P.shape if hasattr(sc, "P")
                                                              else sc.T.shape),
             iters_card=iters[0], iters_cpu=iters[1], card_s=card_s,
             max_rel_diff=max(worst.values()), worst_field=max(worst, key=worst.get),
             bit_equal=max(worst.values()) == 0.0, launches=counts(), per_field=worst,
             **replays_summary(rec))
        check(iters[0] == iters[1], f"nonuniform_card_vs_cpu {label}: iterations")
        check(not over, f"nonuniform_card_vs_cpu {label}: over {NONUNIFORM_CARD_VS_CPU}: {over}")
        check(sum(counts().values()) == 0, f"nonuniform_card_vs_cpu {label}: a kernel launched")
        # every graphed chunk: its replay against the chunk run eagerly from
        # the same state, bit for bit
        if label in ("dyrel", "variational", "variational3d"):
            check(len(rec["solves"]) == 1, f"nonuniform_graph_parity {label}: no graph recorded")
        for s in rec["solves"]:
            n = s.graph_iterations
            saved = [x.clone() for x in s.carried()]
            s.chunk(n)
            eager = [x.clone() for x in s.carried()]
            for x, v in zip(s.carried(), saved):
                x.copy_(v)
            s.replay()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(s.carried(), eager))
            moved = any(not torch.equal(a, b) for a, b in zip(eager, saved))
            emit("nonuniform_graph_parity", case=label, solve=type(s).__name__, iterations=n,
                 bit_equal=equal, moved=moved)
            check(equal, f"nonuniform_graph_parity {label}: the replay differs from the eager "
                         "chunk")
            check(moved, f"nonuniform_graph_parity {label}: the chunk did not move the state")
    refusals = stretched_refusals(dev)
    emit("nonuniform_refusals", **refusals)
    for key, msg in refusals.items():
        check(msg is not None and "use_kernel=False" in msg,
              f"nonuniform_refusals {key}: {msg!r}")
    return launches


def nonuniform_goldens(smi, apart_results):
    """Phase 39's goldens, whose processes (``NONUNIFORM_APART``) ran beside
    phase 28; returns each kernel's launches per golden (all 0)."""
    launches = {}
    cases = {k: v for k, v in nonuniform_golden_cases().items() if k not in NONUNIFORM_MOVED}
    emit("golden_nonuniform_moved", cases=NONUNIFORM_MOVED,
         test="tests/test_torch_cuda.py::test_shearband_refined_golden_f64 (slow, cuda)")
    results = run_golden_set(cases, "golden_nonuniform", smi, launches,
                             apart_results=apart_results)
    for label, g in results.items():
        for kernel, n in g["all_launches"].items():
            launches.setdefault(kernel, {})[f"golden_{label}"] = n
    return launches


def run_nonuniform_production(dev, smi, kind):
    """Phase 40; returns each kernel's launches in it (all 0)."""
    f32 = torch.float32
    launches = {}

    # ---- 40. shearband-refined-1024-f32: one step at the flagship's grid on
    # the plain path, beside the uniform flagship's B2/B3 per iteration
    solve = shearband_refined.solve_vep
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    # the cap wraps the timed solver, so the timing sees it as the call's own
    with timed_solves(shearband_refined, "solve_vep") as solves, \
            capped(shearband_refined, "solve_vep", iter_max=SHEARBAND_REFINED_STOKES_CAP) as calls:
        st, info, tau_max, _, tII = shearband_refined.run(dtype=f32, device=dev,
                                                          **PROD["shearband_refined"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    record_counts(launches, "production_shearband_refined")
    split = solves_summary(solves)
    iters = int(info.iters)
    args, kwargs = calls[0]

    def short(k):
        return lambda: solve(*args, **dict(kwargs, iter_max=k, iter_min=0, nout=k))

    n10, n5 = (profiled_launches(short(k), warm_up=False) for k in (10, 5))
    st0, pt, geometry, material, pr_c, pr_v, dt = (args[0], args[1], args[2], args[4],
                                                   args[5], args[6], args[7])
    words = hv.vep_chunk_words(*chunk_inputs_from_state(st0, material, pr_c, pr_v, geometry,
                                                        pt, dt))
    inv_dx, inv_dy, strain_v, mom = spacing_families_2d(geometry, st0.P)
    spacing_bytes = sum(x.numel() * x.element_size()
                        for x in (inv_dx, inv_dy, *strain_v.values(), *mom))
    n_cells = st.P.numel()
    bound = (words * n_cells * 4 + spacing_bytes) / HBM_PEAK[kind] * 1e3
    # the uniform flagship's B2/B3 per iteration, measured again here
    n = PROD["shearband_refined"]["n"]
    geometry_u, material_u, pr_cu, pr_vu, st_u, pt_u, _ = shearband._setup(
        n, dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0,
                C=1.6 / math.cos(math.radians(30.0)), friction_angle=30.0,
                eta_reg=8.0e-3), 0.5, f32, dev, eps_rel=1.0e-6, CFL=0.75 / math.sqrt(2.1))
    uargs = chunk_inputs_from_state(st_u, material_u, pr_cu, pr_vu, geometry_u, pt_u, 0.25)
    saved = counts()
    b23_ms = [cuda_time_ms(lambda: hv.stokes_vep_chunk(*uargs, nout=500)) / 500
              for _ in range(2)]
    restore_counts(saved)
    finite = all(bool(torch.isfinite(x).all()) for x in (st.V.Vx, st.V.Vy, st.P, tII))
    emit("main_path_nonuniform", case="shearband-refined-1024-f32",
         grid=dict(PROD["shearband_refined"], stokes_iter_max=SHEARBAND_REFINED_STOKES_CAP),
         dtype="float32", wall_s=wall, stokes=split,
         iters=iters, err=float(info.err), ms_per_iter=split[0]["seconds"] * 1e3 / iters,
         launches_per_iter=None if None in (n10, n5) else (n10 - n5) / 5, words=words,
         spacing_bytes=spacing_bytes, bound_ms=bound, tau_max=tau_max,
         tauII_max=float(tII.max()), finite=finite, launches=c,
         uniform_b23_ms_per_iter=b23_ms, nvidia_smi=smi)
    check(finite, "main_path_nonuniform: non-finite fields")
    check(sum(c.values()) == 0, "main_path_nonuniform: a kernel launched")
    return launches


# ---- phase 41: checkpoints and restart through the kernels
VE_RESTART_DT = 0.05 * elastic_buildup.KYR
# run_particles at JAX's 48x16 (tests/test_subduction2d.py), its Stokes cap
# cut from the model's 80 000 to one nout, 1 000, on every run by a wrapper
# of the model's solve_variational (phase 41 d)
PARTICLES_RESTART = dict(nx=48, ny=16)
PARTICLES_RESTART_STOKES_CAP = 1_000
# each field's largest difference over its largest finite value, for the
# restart against the straight run and for two straight runs: the vertex
# phase ratios sum with index_add_'s atomics, so two runs on an H100 need
# not hold the same bits; the spread measured there was 1.9e-17 of eta_v's
# max (straight against straight in one run, the restart against the
# straight run in another; 0 in every other field, PERF.md), so the limit
# is that spread with ~50x headroom
PARTICLES_RESTART_TOL = 1e-15


def ve_restart_setup(dtype, dev):
    """tests/test_restart_equivalence.py's set-up: a 16^2 box of 100 km, a
    Maxwell body (eta 1e21 Pa s, G 1e10 Pa) in pure shear at 1e-14 1/s with
    free slip; returns (stokes, pt, geometry, bc, rho_g, G, K, (eta0, G,
    eps_bg))."""
    ni = (16, 16)
    geometry = Geometry(ni, (100.0e3, 100.0e3))
    stokes = StokesState.make(ni, dtype=dtype, device=dev)
    f = dict(dtype=stokes.P.dtype, device=stokes.P.device)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1),
                             eps_abs=1.0e-6, eps_rel=1.0e-6)
    eta0, G, eps_bg = 1.0e21, 10.0e9, 1.0e-14
    bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True))
    Vx, Vy = flow_bcs(pureshear_bc(stokes.V.Vx, stokes.V.Vy, geometry.xvi, eps_bg), bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy),
                            viscosity=stokes.viscosity.replace(eta=torch.full(ni, eta0, **f)))
    rho_g = (torch.zeros(ni, **f), torch.zeros(ni, **f))
    return (stokes, pt, geometry, bc, rho_g, torch.full(ni, G, **f),
            torch.full(ni, math.inf, **f), (eta0, G, eps_bg))


def ve_restart_step(stokes, pt, geometry, bc, rho_g, G, K, iter_max=20_000):
    """One time step of the set-up: solve_ve with dt 0.05 kyr and the JAX
    test's cap, B1/B4 on the card."""
    return solver_ve.solve_ve(stokes, pt, geometry, bc, rho_g, G, K, VE_RESTART_DT,
                              iter_max=iter_max, nout=500)


def ve_restart(dev, dst):
    """The f64 set-up four steps straight, and two steps, a checkpoint into
    ``dst``, a reload into fresh states and two steps more; returns (the
    straight state, the restarted one, each run's iterations per step, the
    time and the timestep as loaded)."""
    stokes, *problem, _ = ve_restart_setup(torch.float64, dev)
    runs = {"straight": (stokes, [], 4), "restarted": (stokes, [], 2)}
    for label, (s, iters, nt) in runs.items():
        for _ in range(nt):
            s, info = ve_restart_step(s, *problem)
            iters.append(int(info.iters))
        runs[label] = (s, iters, nt)
    s, iters, _ = runs["restarted"]
    ni = tuple(stokes.P.shape)
    path = checkpointing(dst, s, ThermalState.make(ni, device=dev), time=2 * VE_RESTART_DT,
                         timestep=VE_RESTART_DT)
    s, _, t, dt = load_checkpoint(path, StokesState.make(ni, device=dev),
                                  ThermalState.make(ni, device=dev))
    for _ in range(2):
        s, info = ve_restart_step(s, *problem)
        iters.append(int(info.iters))
    return runs["straight"][0], s, runs["straight"][1], iters, t, dt


def particles_restart(dev, dst):
    """run_particles at PARTICLES_RESTART, its Stokes cap
    PARTICLES_RESTART_STOKES_CAP on every run: two steps straight twice
    (two straight runs on the card need not be bit-equal: the phase ratios
    sum with index_add_'s atomics), and one step with a checkpoint into
    ``dst`` followed by a restart from it to two. Returns the three runs'
    outputs."""
    with capped(subduction2d, "solve_variational", iter_max=PARTICLES_RESTART_STOKES_CAP):
        a = subduction2d.run_particles(**PARTICLES_RESTART, nt=2, device=dev)
        b = subduction2d.run_particles(**PARTICLES_RESTART, nt=2, device=dev)
        subduction2d.run_particles(**PARTICLES_RESTART, nt=1, out_dir=dst, checkpoint_every=1,
                                   device=dev)
        c = subduction2d.run_particles(**PARTICLES_RESTART, nt=2, restart_from=dst, device=dev)
    return a, b, c


def bit_equal(a, b):
    """Whether two tensors hold the same bits (NaNs included: EII_pl is
    NaN in every cell after a run_particles step, as in the JAX model)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def particles_run_diffs(x, y):
    """Two run_particles outputs: each field's largest difference over its
    largest finite value, 0 where the bits are equal and inf where a NaN
    or an infinity of one is not the other's (the states, the particle
    positions, active masks and fields)."""
    (sx, tx, px, (phx, Tx), _), (sy, ty, py, (phy, Ty), _) = x, y
    pairs = flat_state(sx, sy, "stokes.") + flat_state(tx, ty, "thermal.") + [
        ("px", px.px, py.px), ("py", px.py, py.py), ("active", px.active, py.active),
        ("phase", phx, phy), ("T", Tx, Ty)]
    out = {}
    for name, a, b in pairs:
        if bit_equal(a, b):
            out[name] = 0.0
        elif a.dtype == torch.bool:
            out[name] = math.inf
        else:
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            d = float(torch.where(same, 0.0, (a - b).abs()).max())
            scale = float(torch.where(torch.isfinite(a), a.abs(), 0.0).max())
            out[name] = math.inf if not math.isfinite(d) else d / scale if scale else d
    return out


def run_io_restart(dev, smi, flagship):
    """Phase 41; ``flagship`` is phase 4's 1024^2 f32 shear band step: its
    final state and (material, pr_c, pr_v, geometry, pt, dt). Returns each
    kernel's launches in the phase."""
    st, material, pr_c, pr_v, geometry, pt, dt = flagship
    launches = {}
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as tmp:
        # (a) the VE restart at the JAX test's 16^2 f64 set-up through B1
        straight, restarted, it_a, it_b, t, dts = ve_restart(dev, os.path.join(tmp, "ve"))
        unequal = [name for name, a, b in flat_state(straight, restarted)
                   if not bit_equal(a, b)]
        b1 = hs.stokes_chunk.launches
        emit("io_restart_ve", n=16, dtype="float64", iters_straight=it_a,
             iters_restarted=it_b, time=t, timestep=dts, unequal=unequal, launches=b1)
        check(not unequal, f"io_restart_ve: the restart is not bit-equal in {unequal}")
        check(it_a == it_b, "io_restart_ve: iterations differ")
        check((t, dts) == (2 * VE_RESTART_DT, VE_RESTART_DT), "io_restart_ve: time, timestep")
        check(b1 > 0, "io_restart_ve: B1 was not launched")

        # (b) the flagship's 1024^2 f32 state written, read back on the card,
        # and 100 B2/B3 iterations from both
        ni = tuple(st.P.shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpointing(os.path.join(tmp, "flagship"), st, None, dt, dt)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        st2, _, _, _ = load_checkpoint(path, StokesState.make(ni, dtype=st.P.dtype, device=dev))
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        pairs = flat_state(st, st2)
        unequal = [name for name, a, b in pairs if not (a.device == b.device and bit_equal(a, b))]
        outs = [hv.stokes_vep_chunk(*chunk_inputs_from_state(s, material, pr_c, pr_v, geometry,
                                                             pt, dt), nout=100)
                for s in (st, st2)]
        chunk_equal = all(bit_equal(a, b) for a, b in zip(*outs))
        # (c) the card's file read on the CPU
        st_cpu, _, _, _ = load_checkpoint(path, StokesState.make(ni, dtype=st.P.dtype,
                                                                 device="cpu"))
        cpu_unequal = [name for name, a, b in flat_state(st, st_cpu)
                       if not bit_equal(a.cpu(), b)]
        emit("io_restart_flagship", n=ni[0], dtype="float32", fields=len(pairs),
             bytes=os.path.getsize(path), write_s=write_s, read_s=read_s,
             unequal=unequal, chunk_bit_equal=chunk_equal, cpu_unequal=cpu_unequal,
             launches=hv.stokes_vep_chunk.launches, nvidia_smi=smi)
        check(not unequal, f"io_restart_flagship: reloaded fields differ {unequal}")
        check(chunk_equal, "io_restart_flagship: B2/B3 from the reloaded state differs")
        check(not cpu_unequal, f"io_restart_flagship: the CPU's load differs {cpu_unequal}")
        check(hv.stokes_vep_chunk.launches > 0, "io_restart_flagship: B2/B3 was not launched")

        # (d) run_particles: a restart from a step-1 checkpoint against two
        # straight runs
        t0 = time.perf_counter()
        a, b, c = particles_restart(dev, os.path.join(tmp, "particles"))
        seconds = time.perf_counter() - t0
        straight = particles_run_diffs(a, b)
        restart = particles_run_diffs(a, c)
        emit("io_restart_particles", grid=dict(PARTICLES_RESTART, nt=2),
             stokes_iter_max=PARTICLES_RESTART_STOKES_CAP, iters=[int(r[4].iters) for r in
                                                                  (a, b, c)],
             straight_vs_straight=max(straight.values()), restart_vs_straight=max(
                 restart.values()), worst_field=max(restart, key=restart.get), seconds=seconds)
        check(int(a[4].iters) == int(b[4].iters) == int(c[4].iters),
              "io_restart_particles: iterations differ")
        check(max(straight.values()) <= PARTICLES_RESTART_TOL,
              f"io_restart_particles: two straight runs differ by more than "
              f"{PARTICLES_RESTART_TOL} {straight}")
        check(max(restart.values()) <= PARTICLES_RESTART_TOL,
              f"io_restart_particles: the restart is not within {PARTICLES_RESTART_TOL} of "
              f"the straight run {restart}")

        # (e) save_vti of the flagship's cell fields
        cells = {"P": st.P, "tauII": st.tau.II, "eta_vep": st.viscosity.eta_vep,
                 "EII_pl": st.EII_pl, "txx": st.tau.xx, "tyy": st.tau.yy, "txy_c": st.tau.xy_c}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vti = save_vti(os.path.join(tmp, "flagship"), geometry, cell_data=cells)
        vti_s = time.perf_counter() - t0
        emit("io_vti_flagship", n=ni[0], fields=list(cells), bytes=os.path.getsize(vti),
             seconds=vti_s, nvidia_smi=smi)
    record_counts(launches, "io_restart")
    return launches


# ---- phase 42: the distributed layer (parallel/) on the card
DIST_WORLD_TIMEOUT = 1100.0  # each world: from beside phase 28 to the end of phase 42
DIST_RANK_TIMEOUT = 600.0  # each collective of a rank of the world of four
# the f32 DYREL production's final residual norms against the serial solve's
# (the trajectories part after the first chunk; a factor, either way)
DYREL_NORM_RATIO = 2.0


def _go_file():
    go = tempfile.NamedTemporaryFile(prefix="chip_smoke_go_", delete=False).name
    os.unlink(go)
    return go


def _rel_gap(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


class DistributedPhase:
    """Phase 42: its world of four ranks and its world of one start with the
    object and run their correctness cases (and the serial references)
    beside phase 28's processes; :meth:`finish` (after phase 41) lets the
    four ranks' production cells run, then the world of one's, each with the
    card to itself, then the serial plain solves in this process, then
    every check. ``size="test"`` shrinks it for a rehearsal on the CPU."""

    def __init__(self, dev, size="card"):
        self.dev, self.size = dev, size
        self.cases = dc.suite_cases(size)
        self.go, self.go_one = _go_file(), _go_file()
        # (b) four ranks on this card over gloo, two "hosts" of two: the cases
        # of CARD_MESHES on the card (CPU_TWIN_KINDS on the CPU too), then (c)
        # once `go` appears
        self.world = dc.world("card", size, self.go, device=dev.type, backend="gloo", hosts=2,
                              timeout=DIST_WORLD_TIMEOUT, rank_timeout=DIST_RANK_TIMEOUT)
        # (a) a world of one, NCCL on the card (gloo on the CPU): every
        # set-up on a mesh of ones, then its productions once `go_one` appears
        self.one = dc.world("one", size, self.go_one, nranks=1, device=dev.type,
                            backend="nccl" if dev.type == "cuda" else "gloo",
                            timeout=DIST_WORLD_TIMEOUT, rank_timeout=DIST_RANK_TIMEOUT)

    def finish(self, smi):
        """(c), then every check of phase 42; returns each kernel's
        launches in it, in this process and in the worlds' ranks (all 0:
        the sharded solvers run plain PyTorch, in JAX as in the port)."""
        launches = {}
        dev = self.dev
        reset_counts()
        try:
            open(self.go, "w").close()  # the four ranks' (c): this process waits
            got = self.world.result()
            open(self.go_one, "w").close()  # then the world of one's
            one = self.one.result()
        finally:
            self.stop()
            for f in (self.go, self.go_one):
                if os.path.exists(f):
                    os.unlink(f)
        # the serial plain solves, each with the card to itself
        prod_serial = dc.production_serial(dev, self.size)
        serial_vep3d = dc.production_vep3d_serial(dev, self.size)
        serial_dyrel = dc.production_dyrel_serial(dev, self.size)
        serial_particles = dc.production_particles_serial(dev, self.size)
        # the serial references, computed by the world's rank 0 beside phase 28
        serial, serial_cpu = got["serial"]["card"], got["serial"]["cpu"]
        backend = "nccl" if dev.type == "cuda" else "gloo"

        def report(phase, label, case, res, ref, **kw):
            worst, tol, iters_ok, err_ok = dc.case_gate(case, res, ref)
            emit(phase, case=label, kind=case.kind, mesh=list(case.mesh),
                 iters=[r["iters"] for r in dc.steps_of(res)],
                 err=[r["err"] for r in dc.steps_of(res)],
                 serial_err=[r["err"] for r in dc.steps_of(ref)],
                 seconds=sum(r.get("seconds", 0.0) for r in dc.steps_of(res)),
                 max_diff=worst, tol=tol, **kw)
            check(iters_ok and err_ok, f"{phase} {label}: iterations or err")
            check(worst <= tol, f"{phase} {label}: {worst} > {tol}")

        for label, case in dc.setups(self.cases).items():  # (a)
            one_case = dataclasses.replace(case, mesh=(1,) * len(case.mesh))
            report("distributed_nccl_one", label, one_case, one[label],
                   serial[dc.setup_key(case)], backend=backend)
        # (b) the world of four: card and CPU against their serial solves
        for label, case in self.cases.items():
            if label not in got:
                continue
            key = dc.setup_key(case)
            for where, ref in (("card", serial[key]), ("cpu", serial_cpu[key])):
                res = got.get(label if where == "card" else label + "@cpu")
                if res is not None:
                    report("distributed_gloo_four", label, case, res, ref, on=where)
        kinds = {case.kind for label, case in self.cases.items() if label in got}
        check(kinds >= {"ve", "thermal", "thermal3d", "vep", "variational", "ve3d", "vep3d",
                        "dyrel", "particles", "particles3d"},
              f"distributed_gloo_four: kinds missing ({sorted(kinds)})")
        for suffix in ("", "@cpu"):
            a, b = got["ve_solcx" + suffix], got["ve_solcx_no_overlap" + suffix]
            equal = a["err"] == b["err"] and all(np.array_equal(a[k], b[k])
                                                 for k in dc.VE_FIELDS)
            emit("distributed_overlap", case="ve_solcx", on="cpu" if suffix else "card",
                 bit_equal=equal)
            check(equal, f"distributed_overlap ve_solcx{suffix}: overlap=True differs")
        case = self.cases["ve_solcx"]
        worst, tol, iters_ok, err_ok = dc.case_gate(case, got["multihost"],
                                                 serial[dc.setup_key(case)])
        emit("distributed_multihost", ranks=got["multihost_layout"]["ranks"].tolist(),
             max_rel_diff=worst, tol=tol, blocking_wait=got.get("blocking_wait"),
             default_wait_in_production=got.get("default_wait_in_production"))
        check(got["multihost_layout"]["ranks"].tolist() == [[0, 1], [2, 3]],
              "distributed_multihost: hosts are not along x")
        check(iters_ok and err_ok and worst <= tol, f"distributed_multihost: {worst}")

        # (c) the production cells at full width, f32, fixed iterations, each
        # beside its serial plain solve
        cells = (("distributed_production", "production", prod_serial, ("nccl_one", "gloo_four")),
                 ("distributed_production_vep3d", "production_vep3d", serial_vep3d,
                  ("nccl_one", "gloo_four")))
        for phase, key, ref, worlds in cells:
            for label in worlds:
                prod = (one if label == "nccl_one" else got)[key]
                gap = _rel_gap(prod["P"], ref["P"])
                emit(phase, world=label, nvidia_smi=smi, serial_ms_per_iter=ref["ms_per_iter"],
                     P_rel_diff_vs_serial=gap, **{k: v for k, v in prod.items() if k != "P"})
                check(prod["finite"] and prod["iters"] == ref["iters"],
                      f"{phase} {label}: not finite or iterations differ")
                check(gap <= TOL_F32_1024, f"{phase} {label}: P {gap} from serial")
        # DYREL: the first chunk runs before any reduction reaches the state,
        # so its P holds to the serial's; after it the damping comes from
        # sums whose order differs, and the f32 trajectories part (the DR
        # tuning amplifies a rounding difference; PERF.md section 6):
        # the run holds to the serial's residual norms within DYREL_NORM_RATIO
        prod = got["production_dyrel"]
        first = _rel_gap(prod["P_first_chunk"], serial_dyrel["P_first_chunk"])
        ratios = [a / b for a, b in zip(prod["residual_norms"], serial_dyrel["residual_norms"])]
        emit("distributed_production_dyrel", world="gloo_four", nvidia_smi=smi,
             serial_ms_per_iter=serial_dyrel["ms_per_iter"], P_first_chunk_rel_diff=first,
             P_rel_diff_vs_serial=_rel_gap(prod["P"], serial_dyrel["P"]),
             serial_residual_norms=serial_dyrel["residual_norms"], residual_norm_ratios=ratios,
             **{k: v for k, v in prod.items() if k not in ("P", "P_first_chunk")})
        check(prod["finite"] and prod["iters"] == serial_dyrel["iters"],
              "distributed_production_dyrel: not finite or iterations differ")
        check(first <= TOL_F32_1024, f"distributed_production_dyrel: first chunk's P {first}")
        check(all(1.0 / DYREL_NORM_RATIO <= r <= DYREL_NORM_RATIO for r in ratios),
              f"distributed_production_dyrel: residual norms {ratios} of the serial's")
        prod = got["production_particles"]
        count, ref_count = prod["count"], serial_particles["count"]
        differing = int((count != ref_count).sum())
        emit("distributed_production_particles", world="gloo_four", nvidia_smi=smi,
             serial_ms_per_step=serial_particles["ms_per_step"],
             active=int(count.sum()), serial_active=int(ref_count.sum()),
             active_before=serial_particles["active_before"], cells_differing=differing,
             cells=int(count.size), **{k: v for k, v in prod.items() if k != "count"})
        # f32 positions in the block frame round apart from the global ones
        # by an ulp, so a particle within an ulp of a cell face may land in
        # its neighbour: the gate is that every particle is kept
        check(int(count.sum()) == int(ref_count.sum()) == serial_particles["active_before"],
              "distributed_production_particles: particles lost or duplicated")
        for phase, ref in (("distributed_serial", prod_serial),
                           ("distributed_serial_vep3d", serial_vep3d),
                           ("distributed_serial_dyrel", serial_dyrel),
                           ("distributed_serial_particles", serial_particles)):
            emit(phase, nvidia_smi=smi, **{k: v for k, v in ref.items()
                                            if k not in ("P", "P_first_chunk", "count")})
        record_counts(launches, "distributed")
        for world in (got, one):
            for kernel, n in world["launches"].items():
                launches[kernel]["distributed"] += n
        emit("distributed_launches", here=counts(), ranks=got["launches"],
             world_of_one=one["launches"])
        check(sum(by_phase["distributed"] for by_phase in launches.values()) == 0,
              "distributed: a kernel launched")
        return launches

    def stop(self):
        self.world.stop()
        self.one.stop()


def run_distributed(dev, smi, size="card"):
    """Phase 42 in one piece, its world of four started now."""
    return DistributedPhase(dev, size).finish(smi)


def nccl_two_ranks_one_card(timeout=120.0):
    """Two ranks asking for NCCL on the one card: the world's failure text
    (``None`` if it came up)."""
    try:
        dc.world("probe", nranks=2, device="cuda", backend="nccl", timeout=timeout,
                 rank_timeout=timeout / 2).result()
    except RuntimeError as e:
        return str(e)
    return None


def profiled_launches(fn, warm_up=True):
    """The kernels ``fn()`` launches on the card (memory copies and sets
    left out), counted by ``torch.profiler`` (after one warm-up call);
    ``None`` where the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile

    if warm_up:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset")))
    return n or None


def flat_state(a, b, prefix=""):
    """(name, tensor of ``a``, tensor of ``b``) over two states' tensors."""
    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            out.extend(flat_state(x, y, f"{prefix}{f.name}."))
        elif isinstance(x, torch.Tensor):
            out.append((prefix + f.name, x, y))
    return out


def kernel_launches(fn):
    """How many kernels of the port's CUDA sources ``fn()`` launches, from
    ``torch.profiler``; ``None`` if the profiler recorded no device kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    if sum(e.count for e in events) == 0:
        return None
    return sum(e.count for e in events if "(anonymous namespace)::k_" in e.key)


def launches_per_iteration(dev):
    """Phase 26: the CUDA launches each kernel makes per PT iteration (per
    call for B6/B9 inside a hybrid iteration, and for R), counted by the
    profiler over a few iterations of small inputs. Launch counters are
    restored."""
    nit = 4
    saved = counts()
    f32 = torch.float32
    vep_args, vep_kw = chunk_case("shearband", 64, f32, dev)
    ve_args, ve_kw = ve_case("solcx", 64, f32, dev)
    th_args, th_kw = thermal_case("pallas_setup", 64, f32, dev)
    carry3, co3, inv3, fs3, _ = ve3d_case("viscous", (32, 32, 32), f32, dev)
    c, co6, co9, mat, inv_di, kw = vep3d_case("blocked_plastic", f32, dev)
    src = torch.zeros((4, 64, 64, 128), dtype=f32, device=dev)
    runs = {
        "stokes_vep_chunk": (lambda: hv.stokes_vep_chunk(*vep_args, nout=nit, **vep_kw), nit),
        "stokes_chunk": (lambda: hs.stokes_chunk(*ve_args, nout=nit, **ve_kw), nit),
        "thermal_chunk": (lambda: ht.thermal_chunk(*th_args, nout=nit, **th_kw), nit),
        "stokes3d_chunk": (lambda: h3.stokes3d_chunk(carry3, co3, inv3, nit, free_slip=fs3), nit),
        "vep3d_edges": (lambda: hybrid_chunk(c, co6, mat, inv_di, kw, nit, False), nit),
        "vep3d_edges_split": (lambda: hybrid_chunk(c, co9, mat, inv_di, kw, nit, True), nit),
        "stokes3d_vep_chunk": (lambda: fused_chunk(c, co6, inv_di, kw, nit), nit),
        "window_copy": (lambda: hw.window_copy(src), 1),
    }
    out = {}
    for name, (fn, per) in runs.items():
        n = kernel_launches(fn)
        out[name] = None if n is None else n / per
    restore_counts(saved)
    emit("launches_per_iteration", **out)
    for name in ("stokes_vep_chunk", "stokes_chunk"):
        check(out[name] in (None, 1.0), f"{name}: {out[name]} launches per iteration")
    return out


if __name__ == "__main__":
    if "--golden" in sys.argv:
        golden_apart(sys.argv[sys.argv.index("--golden") + 1])
        sys.exit(0)
    if "--parent" in sys.argv:
        PARENT = sys.argv[sys.argv.index("--parent") + 1]
    main()
