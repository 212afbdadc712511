"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the script exits
non-zero:

1. device: the card, its power limit, CUDA and nvcc versions; full-float32
   matmuls (TF32 off);
2. build: compile the six hand-written kernel sources from
   ``phoskintime_tpu_torch/csrc``, one ``nvcc`` per source, all started
   together, and print each instance's registers and spills;
3f. the FP32 FMA peak: ``sq_chain`` (the port of ``benchmarks/vpu_peak.py``)
   against its plain version at 2 steps (where the output still depends on
   the seeds and on c's x term), nacc 1/2/4/8, within 1e-6 of max |plain|,
   the FFMAs of each instance's SASS (reps x nacc an element), then the
   sweep over nacc x threads a block (256 and 512), each arm by the slope of 8 and 24 chained
   launches: its best arm is this run's measured FP32 peak, printed beside
   the data sheet's 67 TFLOP/s with the card's power limit. Every later
   FP32 bound is printed against both (``share_of_bound``: the data sheet;
   ``share_of_measured_bound``: the measured peak);
3. kernel vs plain: ``phi_tables`` (w <= 8) against ``phi_tables_reference``
   on the card at the main path's own shapes (one 2048-member chunk of the
   bench problem) and at every block width 2..8, scaled atol 2e-5; the
   kernel (by CUDA events and, on the device, by the profiler), the plain
   version and ``torch.linalg.matrix_exp`` of the augmented matrix timed,
   and the kernel's bound and its share of it worked out; the squaring
   counts' mean a lane and a warp at the main-path chunk;
3b. the same for ``phi_tables_wide`` (9 <= w <= 17) at the model-2 chunk's
   class shapes (w = 9 and 17), at the unbucketed chunk's full width (w =
   17 over all 92,160 lanes) and at every width 9..17, and for
   ``phi_vectors`` (one pair) at w = 7 and 17;
3c. the same for ``etd2rk_scan`` (the whole ETD2RK scan) against
   ``etd2rk_scan_reference`` and the eager scan, on the model-0 chunk's own
   inputs (w = 6) and on an unbucketed model-2 chunk (w = 17), and at every
   width 2..17 on small random problems, rtol 2e-3 / atol 1e-5 on the
   trajectory, and on members of 199 to 225 proteins (one member a block)
   at w = 6, 14, 16 and 17, each side of the switch from E in shared
   memory to E streamed; the kernel (events and device), the plain
   version, the eager scan and that scan replayed from a CUDA graph timed,
   the kernel's bound and share of it worked out, and the variant named;
4. main path, model 0: the population objective at pop 8192 in chunks of
   2048 on the bench problem (``build_demo_network(40, 12, seed=0)``,
   float32), counting kernel launches, checking F against the plain
   tables, and timing evals/s;
4b. main path, model 2: the same objective on the combinatorial mechanism
   (``build_demo_network(40, 12, model=2, seed=0)``) at pop 2048 in one
   chunk: 3 launches of ``phi_tables`` and 2 of ``phi_tables_wide``;
4c. the scan kernel on the main path: the model-0 objective at pop 8192
   with ``use_scan_kernel=True`` (one ``etd2rk_scan`` launch per chunk, F
   against the eager objective, evals/s, stage cut, idle share), then the
   model-2 objective unbucketed with the scan kernel at pop 2048 (one
   ``etd2rk_scan`` and one ``phi_tables_wide`` launch, F against the default
   bucketed objective, evals/s beside the unbucketed eager rate);
5. accuracy, model 0: fold changes at the true parameters against a tight
   SciPy LSODA oracle (rtol 1e-7, atol 1e-9) of the same equations, max
   relative error below 1e-3, by the eager scan and by the scan kernel;
5b. precision, model 2: float32 fold changes on the card against the
   port's float64 result on the CPU, max relative error below 1e-3, and
   both against a LSODA oracle of the hypercube equations; again with the
   scan kernel, unbucketed.

The RK45 oracle path and the steady states:

3d. ``hypercube_flux`` (the model-2 edge flux) against its plain gather
   version in float32 and float64 at the RK45 objective's shape (92,160
   rows of 16 states), at smax 0..10, and at the row counts of the JAX
   package's size table (B = 40 .. 327,680); scaled tolerance 2e-5
   (float32) and 1e-12 (float64); times, bound (the bytes over the HBM
   rate, held against the device time with L2 flushed before each call;
   back-to-back calls find the data in L2 and are printed beside it) and
   the wrapper's host µs a call;
3e. ``thomas_solve_batched`` against its plain version and
   ``torch.linalg.solve`` of the dense matrices, float32 and float64, at
   the steady state's own shape (45 chains of 5) beside one chain of 2
   (the launch floor), at a population's chains (368,640 of 5) and at
   n = 2..17; times and bound;
4d. main path, RK45: ``make_objective(solver="rk45")`` on the model-2
   bench network at pop 2048, float32, alone on the card: 7 flux launches
   a loop iteration plus 2, evals/s, steps, and the idle share of a
   profiled window; then, in worker processes started together (each RK45
   run is host-bound, so they overlap), F on 8 members against the plain
   flux and against the port's float64 CPU result (rel 1e-3), and models 0
   and 1 once at pop 2048;
5c. RK45 accuracy (workers): fold changes at the true parameters against
   the LSODA oracles, models 0 and 2, float32 and float64 on the card,
   below 1e-3;
6. steady states on the card: the three mechanisms on an isolated network
   against the CPU (1e-12), the RHS there within 1e-9 of 0, one Thomas
   launch for the sequential one (and on the bench network's 45 chains),
   and, in a worker, ``simulate_until_steady`` on the bench model-0
   network.

3g. float64 on the card: the float64 instances of ``phi_tables`` (the model-0
   chunk), ``phi_tables_wide`` (the model-2 w = 17 and w = 9 classes and the
   unbucketed full width) and ``etd2rk_scan`` (the model-0 chunk and the
   unbucketed model-2 chunk) against their plain versions (tables 1e-12
   scaled, the scan rtol 1e-10 / atol 1e-12), timed against the FP64 peak
   or bytes; then ``make_population_objective`` at float64 on the card
   (model 0 by both scan routes, model 2 bucketed and unbucketed through the
   scan kernel) against the port's float64 CPU result on 8 members (rel
   1e-9), with its launches;
7. the global fit: ``run_global_fit`` on the north-star network
   (``build_demo_network(150, 24, seed=1)``, float32, N = 150, 1,103
   parameters) at pop 10,000, by the all-device loop (``gens_per_dispatch=5``,
   two blocks) and by the default route (device variation, host survival)
   for 2 generations: launches, evals/s, seconds a generation, the ideal
   point never rising, the survivors' F against a re-evaluation of their X
   (rel 1e-3); one generation of each route profiled (idle share, the
   host survival's share on the host clock, synchronizing reads); then on
   the bench network pop 256 for 5 generations with one refinement round
   and the Fréchet pick (``n_evals`` covering both rounds, ``best_idx``
   within the Pareto set).

Model 4 and the last oracle solvers:

8a. the model-4 population objective (``build_demo_network(40, 12,
   model=4, seed=0)``, float32, N = 45, w = 6) at pop 2048 in one chunk,
   as ``benchmarks/model_rates.py``: no table or scan kernel launched, F
   finite and within 1e-3 of the port's float64 objective on the CPU (64
   members), the trajectory at the true parameters within 5e-3 of a
   SciPy LSODA oracle of the saturating equations (the JAX package's gate
   for its Rosenbrock path; fold changes printed beside), evals/s, one
   call under the profiler, and the stage cut (unpack, block Jacobians,
   the in-scan phi build and its share, sub-steps, loss; each the median
   of three calls);
8b. ESDIRK (``simulate_batched(solver="esdirk")``, rtol 1e-8, atol 1e-10,
   float64) to t = 0.55 min, across the first kinase boundary, on the
   model-2 bench network (d = 765) at pop 16 and on model 0 at pop 64:
   the Jacobian through the flux kernel against the plain flux's (1e-12
   scaled, two launches), the model-2 run launching the kernel 21 times a
   loop iteration (every stage and the Jacobian) and never the plain
   version, ys within rtol 1e-5 / atol 1e-7 of RK45 at rtol 1e-8 on the
   CPU; steps, seconds, ms a step and each part's share of a step;
8c. ``solver="expo"``: ``simulate`` of models 0 and 4 against the batched
   paths and ``make_objective(solver="expo")`` at pop 64 against the
   population objective, rel 1e-3 in float32; times.

Gradients and polish, on the bench network at float32 (the derivative
passes take the plain tables with a static ladder and the eager scan, as
the kernels carry no derivative; the production scoring launches the table
kernel):

9a. the differentiable objective on one chunk of 128 members: F against
   the production objective (rtol 2e-4, atol 1e-6), a finite gradient, no
   table or scan launch in the forward and reverse passes and one in the
   production call; at float64 on the card the gradient against the CPU's
   (8 members, 1e-9 scaled) and against central differences along 3
   seeded directions (rel 1e-6); forward and forward+reverse ms, one step
   under the profiler, peak memory;
9b. ``polish_solutions`` on 32 members for 20 steps: no member worse than
   its input under its own weights, every member inside [xl, xu], ms a
   step, one table launch (the final scoring);
9c. the LM finish from the true parameters perturbed by 2%, zero-residual
   (``r_offset``): sum(r**2) against F.sum() (rel 2e-4 float32, 1e-9
   float64), ms a forward-mode Jacobian (329 tangents in chunks of 256),
   ``lm_refine_mixed`` (8 float32 iterations, no worse than the input,
   then 6 at float64 on the card, ending below 1e-3 x the float32 sse),
   ms an iteration, the largest relative parameter error (printed);
9d. ``run_global_fit`` at pop 256 for 3 generations with
   ``polish_steps=20`` and ``gn_iters=3``, and ``optimizer="gradient"`` at
   pop 64 (100 steps): ``n_evals`` by the JAX package's bookkeeping, the
   Pareto set the first front of every member (a polished member in it),
   the table launches, each stage's seconds.

The per-gene stack (``fit/``, ``models/``, ``ops/linear.py``, ``ops/lm.py``,
``ops/morris.py``; plain PyTorch, no hand-written kernel: its launches are
recorded as 0 for every kernel and asserted so):

10a. for each mechanism (distmod, succmod, randmod) and n = 1..5 sites,
   4,096 seeded parameter vectors in the default box through
   ``solve_ode_batched`` on the card: float64 within max(1e-12, 8 2^s eps)
   (scaled) of the port's float64 CPU result, float32 within 1e-3, NaN
   lanes in the same
   places; the port's ``expm`` and ``torch.linalg.matrix_exp`` timed on
   the same batch, whether each synchronizes (``set_sync_debug_mode``)
   and its device-to-host copies; both again at the stage-2 batch of
   randmod n = 5 (a Jacobian pass). s is the batch's largest squaring
   count: each squaring can double a rounding difference. The CPU references come from worker processes and are checked after
   10b's float32 cohorts;
10b. for each mechanism and n = 1, 2 and 5 (3 and 4 cut since phase 11
   came in), 8 noise-free synthetic genes (the
   JAX package's ``synth_gene`` recipe) through ``normest_batch`` at the
   defaults (10 lambdas, the default weight library, 48 starts, 80 LM
   iterations, regularisation on), float32 in this process and float64
   in two worker processes on the card at the same time (the cohorts are
   host-bound; randmod at n = 5, the one device-bound cohort, runs first
   here and last in its worker): each stage's host ms, lanes, chunks and
   ms an iteration, peak memory, the LM loops under
   ``set_sync_debug_mode("error")``; at n = 5 (float32, alone on the card)
   each stage profiled at 1 and 3 iterations (device events an iteration,
   idle share); the float64 card fits of n = 2 against the port's float64
   CPU fit of one of its genes, made in worker processes (the same lambda
   and weight, score, error and params within 1e-6);
10c. the JAX package's recovery gate (distmod, n = 2, seed 5, no
   regularisation, 24 starts, 120 iterations): float64 error < 1e-8 and
   params within rtol 5e-2; float32 printed and held to rtol 5e-2;
10d. ``run_model_pipeline`` on a column-dict cohort (distmod, one gene a
   site count 1..5, knockouts on) on its default device, then
   ``process_gene`` with Morris (200 x 40) and 8 bootstraps: seconds, Morris
   solves a second.

kinopt, tfopt and the network sensitivity (plain PyTorch but for the flux
kernel on the sensitivity path; the CPU references in two spawned worker
processes):

11a. kinopt on the bench generator's problem (30 sites, 5 kinases of 4
   source rows) and at 1,000 sites, 100 kinases, 3 kinases a site (n =
   3,400): ``run_local`` (48 starts, 800 steps), DE (pop 100, 200
   generations), NSGA-II on the host and all-device (pop 100, 50
   generations, blocks of 10), float32: ms a step or generation, device
   events a step or generation and the idle share (profiled at k and 0
   units), loss, feasible, peak memory, the host NSGA-II's host share; no
   kernel launched. Float64 on the card against the CPU: ``run_local``'s
   loss within 1e-9 relative, one ``de_generation`` on the same draws
   within 1e-12; ``kkt_check`` at the float64 optimum primal feasible, its
   stationarity residual printed;
11b. tfopt at 500 genes, 100 TFs, 4 regulators a gene, 0-6 psites a TF
   (pop 400): ``run_local``, then optimizers 0 (host and all-device), 1
   (SMS-EMOA) and 2 (AGE-MOEA) for 20 generations: seconds a generation,
   loss, the pick's feasibility, the host share of a host generation;
11c. ``run_sensitivity_analysis`` on the model-2 bench network (N = 45, w
   = 17), 2 trajectories in one batch, float32, over the bundle's grid:
   the flux kernel launched 7 times an RK45 iteration plus 2, solves a
   second, the idle share of a run to t = 4 (profiled); the demo
   network at N = 10, model 2, float64 over t <= 30: Morris mu, mu* and
   sigma on the card within 1e-9 of the CPU's, relative to the index or,
   where larger, to the parameter's mu* (the size of the elementary
   effects whose rounding they carry).

``python3 chip_smoke.py --pergene-only`` runs phase 1 and phase 10 alone
(no kernel build, no JSON lines); ``--sensitivity-kinopt-only`` runs
phases 1, 2 and 11 (no JSON lines).

The line before the last is a JSON summary of each kernel (the float64
instances and ``sq_chain`` included, each with the launches of its own main
path); the last line is ``{"ok": true, "device": {...}}``. There is no CPU
fallback.
"""

from __future__ import annotations

import importlib
import json
import re
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.demo import GRID, RNA_GRID, build_demo_network
from phoskintime_tpu_torch.fit import pipeline as pipeline_mod
from phoskintime_tpu_torch.fit.normest import normest, normest_batch
from phoskintime_tpu_torch.fit.pipeline import process_gene, run_model_pipeline
from phoskintime_tpu_torch.kinopt import kkt_check as kinopt_kkt_check
from phoskintime_tpu_torch.kinopt import optimize as kinopt_opt
from phoskintime_tpu_torch.kinopt.model import build_problem as kinopt_build_problem
from phoskintime_tpu_torch.kinopt.model import kinopt_loss
from phoskintime_tpu_torch.kinopt.optimize import run_evolutionary as kinopt_run_evolutionary
from phoskintime_tpu_torch.kinopt.optimize import run_local as kinopt_run_local
from phoskintime_tpu_torch.models.kinetics import (_BUILDERS, initial_condition, n_params,
                                                   solve_ode, solve_ode_batched, state_dim)
from phoskintime_tpu_torch.network import expo, polish, steadystate
from phoskintime_tpu_torch.network.analysis import simulate_until_steady
from phoskintime_tpu_torch.network.objective import (_auto_pop_chunk, _scorer,
                                                     make_objective,
                                                     make_population_objective,
                                                     make_residual_fn)
from phoskintime_tpu_torch.network.optimize import run_global_fit
from phoskintime_tpu_torch.network.params import softplus, unpack_params
from phoskintime_tpu_torch.network.polish import (forward_jacobian, lm_refine_mixed,
                                                  polish_solutions, simplex_weights)
from phoskintime_tpu_torch.network.simulate import (extract_observables, fold_changes,
                                                    simulate, simulate_batched)
from phoskintime_tpu_torch.network import sensitivity as sens_mod
from phoskintime_tpu_torch.network.sensitivity import run_sensitivity_analysis
from phoskintime_tpu_torch.network.system import GlobalSystem, default_params
from phoskintime_tpu_torch.network.topology import build_topology
from phoskintime_tpu_torch.ops import constrained, cuda_build
from phoskintime_tpu_torch.ops import fma_peak
from phoskintime_tpu_torch.ops.de_jit import DEDraws, de_draws, de_generation, de_init_draws
from phoskintime_tpu_torch.ops.hypercube_flux import hypercube_flux, hypercube_flux_reference
from phoskintime_tpu_torch.ops.linear import affine_augment, expm
from phoskintime_tpu_torch.ops.nsga import (das_dennis, fast_non_dominated_sort,
                                            make_device_ga_step, nsga3_survival)
from phoskintime_tpu_torch.ops.nsga_device import make_device_ga_blocks
from phoskintime_tpu_torch.ops.tridiag import thomas_solve_batched, thomas_solve_reference
from phoskintime_tpu_torch.ops import phi_tables as phi_mod
from phoskintime_tpu_torch.ops.phi_tables import (phi_tables, phi_tables_reference,
                                                  phi_tables_wide, phi_vectors)
from phoskintime_tpu_torch.ops.scan_kernel import (etd2rk_scan, etd2rk_scan_reference,
                                                   random_scan_problem, scan_launch_shape)
from phoskintime_tpu_torch.ops.stiff import batched_jacobian
from phoskintime_tpu_torch.tfopt import optimize as tfopt_opt
from phoskintime_tpu_torch.tfopt.model import TfoptProblem
from phoskintime_tpu_torch.tfopt.optimize import run_evolutionary as tfopt_run_evolutionary
from phoskintime_tpu_torch.tfopt.optimize import run_local as tfopt_run_local

POP, CHUNK, N_PROTEINS, N_KINASES = 8192, 2048, 40, 12
POP2 = 2048               # model 2: one chunk, as benchmarks/model_rates.py
# simulate_until_steady's horizon in phase 6, minutes: one day, not the
# function's seven (about 12,000 host-bound steps, ~100 s; PERF.md)
STEADY_T_FINAL = 24 * 60.0
KERNEL_ATOL = 2e-5        # scaled by max |plain|, as tests/test_pallas.py
F_RTOL = 1e-3             # objective with the kernels vs with the plain tables
ACCURACY_GATE = 1e-3      # fold changes vs the LSODA oracle, as bench.py
PRECISION_GATE = 1e-3     # model 2: float32 on the card vs float64 on the CPU
# the whole scan against its plain version and the eager scan, on the
# trajectory: the JAX package's tolerance for its Pallas scan kernel
# (tests/test_pallas.py:262-263)
SCAN_RTOL, SCAN_ATOL = 2e-3, 1e-5
# the card's published peaks (H100 SXM data sheet): FP32 and FP64 outside
# the tensor cores, and HBM bandwidth; every bound_ms is taken against them
PEAK_FP32_FLOPS, PEAK_FP64_FLOPS, PEAK_HBM_BYTES = 67e12, 34e12, 3.35e12
# the FP32 FMA peak this run measures in phase 3f (sq_chain's best arm),
# beside which every FP32 bound is printed a second time
MEASURED = {"fp32_flops": None}
# threads a block in 3f's sweep (the module's full sweep adds 128 and 1024;
# on the H100 the best arm was at 256 or 512 threads)
SWEEP_THREADS = (256, 512)
KERNELS = (phi_tables, phi_tables_wide, etd2rk_scan, hypercube_flux, thomas_solve_batched,
           fma_peak.sq_chain)
# float64 on the card (3g): tables against their plain versions scaled as
# the float64 kernels; the scan elementwise; an objective against the
# port's float64 result on the CPU
F64_SCAN_RTOL, F64_SCAN_ATOL, F64_OBJECTIVE_RTOL = 1e-10, 1e-12, 1e-9
# the global fit (7): the north-star network and population (bench.py:407-412)
NORTHSTAR = dict(n_proteins=150, n_kinases=24, seed=1)
NORTHSTAR_POP = 10_000
FIT_F_RTOL = 1e-3         # survivors' F against a re-evaluation of their X
# the new kernels against their plain versions, scaled by the largest entry:
# float32 as the table kernels; float64 rounding only
SCALED_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
STEADY_TOL = 1e-12        # steady states on the card vs the CPU, float64
RHS_AT_STEADY = 1e-9      # |dy/dt| at an analytic steady state
# rows of the flux size table (smax 4, float32): the row counts of the JAX
# package's own table (pallas_kernels.py:21-26), timed on this card
FLUX_SIZE_ROWS = (40, 400, 4096, 40960, 327680)
# back-to-back calls that time the flux wrapper's host cost
HOST_CALLS = 1000
# three proteins of 2, 1 and 3 sites under one kinase, no TF edges: the JAX
# package's isolated network (tests/test_network.py:225-236)
ISOLATED = [("GA", "S1", "K"), ("GA", "S2", "K"), ("GB", "S1", "K"),
            ("GC", "S1", "K"), ("GC", "S2", "K"), ("GC", "S3", "K")]
# 8: model 4's trajectory against LSODA, the JAX package's own gate for its
# Rosenbrock path (tests/test_expo.py:104-115); ESDIRK and RK45 both at rtol
# 1e-8 / atol 1e-10, ESDIRK within rtol 1e-5 / atol 1e-7 of RK45
# (tests/test_coverage_gaps.py:249-260), at these members per mechanism;
# the per-candidate expo objective's members
ROSENBROCK_GATE = 5e-3
ESDIRK_TOLS = dict(rtol=1e-8, atol=1e-10, max_steps=100_000)
# 8b integrates the opening transient and across the first kinase
# boundary (t = 0.5 min), so that every member changes bucket once; at rtol
# 1e-8 this window is bounded by the third-order method's precision, not by
# stiffness (RK45 takes fewer steps there), and its ~500 steps cost
# ~60-90 ms each, host-bound; the whole horizon (to 960) is
# tools/esdirk_steps.py's
ESDIRK_T_END = 0.55
ESDIRK_TIMES = np.linspace(0.0, ESDIRK_T_END, 6)
ESDIRK_RTOL, ESDIRK_ATOL = 1e-5, 1e-7
ESDIRK_POP = {2: 16, 0: 64}
# flux launches of an ESDIRK loop iteration on model 2: the Jacobian's two
# (the primal and every tangent column at once), 18 Newton RHS (six a stage,
# three implicit stages) and the RHS after the step; one more before the loop
ESDIRK_FLUX_PER_STEP = 21
# calls a model-4 stage is timed over (8a's stage cut; the median is kept)
STAGE_CALLS = 3
EXPO_POP = 64
# 9: the gradient stage on the bench network. The differentiable objective
# on polish's default chunk against the production one at the JAX package's
# gate (tests/test_polish.py:43-57: rtol 2e-4, atol 1e-6); at float64 its
# gradient against the CPU's (on GRAD_CPU_MEMBERS of the chunk's members,
# scaled by the largest entry) and against central differences
GRAD_CHUNK, GRAD_CPU_MEMBERS = 128, 8
GRAD_F_RTOL, GRAD_F_ATOL, GRAD_F64_RTOL = 2e-4, 1e-6, 1e-9
GRAD_FD_RTOL, GRAD_FD_EPS, GRAD_FD_DIRECTIONS = 1e-6, 1e-6, 3
# the polish (9b), its slack as the JAX package's test (tests/test_polish.py:80)
POLISH_POP, POLISH_STEPS, POLISH_SLACK = 32, 20, 1e-4
# the LM finish (9c): sum(r**2) against F.sum() at each precision, the
# iterations of each stage, the mixed finish against the float32 sse (the
# JAX package's gate, tests/test_polish.py:383-389), tangents a Jacobian pass
LM_SSE_RTOL = {torch.float32: 2e-4, torch.float64: 1e-9}
LM_ITERS_LO, LM_ITERS_HI, LM_MIXED_GATE, JAC_CHUNK = 8, 6, 1e-3, 256
# the fits of 9d: the GA then polish and LM; the gradient multistart
GRADFIT_POP, GRADFIT_GENS, GRADFIT_GN_ITERS, GRADFIT_MULTISTART_POP = 256, 3, 3, 64
# 10: the per-gene stack. The protein time grid and the default box (all
# bounds (0, 20)); the three mechanisms at n = 1..5 sites; PG_GENES genes a
# cohort at normest's defaults (PG_LM_ITERS is its lm_iters); PG_SOLVES
# parameter vectors a solve check (10a) against the CPU, scaled by the
# largest entry; the float64 card fits against the CPU's on PG_CPU_GENES
# genes at n = PG_CPU_SITES (rtol: the JAX package's batch-vs-single gate,
# tests/test_normest.py:155-156); the recovery gate of tests/test_normest.py:42-50
# the module (fit/__init__ re-exports the function under its name)
normest_mod = importlib.import_module("phoskintime_tpu_torch.fit.normest")
PG_TIMES = np.array([0.0, 0.5, 0.75, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0, 120.0, 240.0,
                     480.0, 960.0])
PG_BOUNDS = {k: (0.0, 20.0) for k in ("A", "B", "C", "D", "S(i)", "D(i)")}
PG_MODELS, PG_SITES, PG_GENES, PG_LM_ITERS = ("distmod", "succmod", "randmod"), (1, 2, 3, 4, 5), 8, 80
# 10b's cohorts: the narrowest, the one checked against the CPU and the
# widest (the device-bound randmod); 3 and 4 were cut to keep the script's
# time as phase 11 grew it
PG_COHORT_SITES = (1, 2, 5)
PG_SOLVES, PG_F64_SCALED, PG_F32_SCALED, PG_MAXNORM_F64 = 4096, 1e-12, 1e-3, 5.371920351148152
PG_CPU_SITES, PG_CPU_GENES, PG_CPU_RTOL, PG_CPU_THREADS = 2, 1, 1e-6, 1
# worker processes of phase 10: two run the float64 cohorts on the card,
# three the CPU references, one thread each
PG_WORKERS = 5
PG_RECOVERY_ERROR, PG_RECOVERY_RTOL, PG_BOOTSTRAPS = 1e-8, 5e-2, 8
PG_DEVICE = "cuda"
STEADY = {0: steadystate.steady_state_distributive, 1: steadystate.steady_state_sequential,
          2: steadystate.steady_state_combinatorial}


# phase 11: kinopt problems (sites, kinases, source rows a kinase, kinases a
# site): the bench generator's size and the same recipe at 1,000 sites
# (n = 3,400 parameters); tfopt (genes, TFs, regulators a gene, most psites
# a TF); the fits' budgets (the reference's tfopt budget is 1,000
# generations); float64 card-vs-CPU gates
KINOPT_PROBLEMS = {"bench": (30, 5, 4, 2), "scaled": (1000, 100, 4, 3)}
KINOPT_LOCAL = dict(n_starts=48, steps=800)
KINOPT_F64_RTOL = 1e-9
DE_F64_ATOL = 1e-12
TFOPT_PROBLEM = (500, 100, 4, 6)
TFOPT_LOCAL = dict(n_starts=48, steps=800)
TFOPT_GENS = 20
SENS_TIMES_F64 = np.array([0.0, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0])
SENS_TIMES_PROFILE = np.array([0.0, 0.5, 1.0, 2.0, 4.0])
SENS_F64_RTOL = 1e-9

T_START = time.perf_counter()


def say(phase: str, **fields) -> None:
    """One log line: the phase, the seconds since the script started, and
    the fields."""
    print(f"[{phase}] t={time.perf_counter() - T_START:.1f} "
          + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, by CUDA
    events after a warm-up call and a synchronize."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def scaled_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float(torch.max(torch.abs(got - want)))
    return err, err / (float(torch.max(torch.abs(want))) + 1e-30)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "this script runs on an NVIDIA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the port needs full float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("1 device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=repr(nvcc.splitlines()[-1]),
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    built = cuda_build.build_libraries()
    say("2 build", wall_seconds=f"{time.perf_counter() - t0:.2f}")
    for path, seconds in built.items():
        say("2 build", library=path.name, seconds=f"{seconds:.2f}")
        for ln in path.with_suffix(".log").read_text().splitlines():
            inst = re.search(r"Compiling entry function '\w*?_kernel\w*?I([fd]?)((?:L[ib]\d+E)+)",
                             ln)
            if inst:
                args = re.findall(r"L[ib](\d+)E", inst.group(2))
                print(f"    {'float64' if inst.group(1) == 'd' else 'float32'} "
                      f"<{', '.join(args)}>")
            elif "registers" in ln or "spill" in ln:
                print("    " + ln.split("ptxas info    : ")[-1].strip())


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def expect(**nonzero) -> dict:
    """The launch counts of a path: the named kernels, 0 for the rest."""
    return {k.__name__: nonzero.get(k.__name__, 0) for k in KERNELS}


class Bound(NamedTuple):
    ms: float               # the larger of bytes / HBM rate and operations / data-sheet peak
    by: str                 # "bytes" or "operations"
    ms_measured: float      # the same with this run's measured FP32 peak (FP64: data sheet)


def bound(nbytes: float, ops: float, itemsize: int = 4) -> Bound:
    """The least time of a function that moves ``nbytes`` and does ``ops``
    operations of the type of ``itemsize`` (4: FP32, 8: FP64)."""
    peak = PEAK_FP32_FLOPS if itemsize == 4 else PEAK_FP64_FLOPS
    measured = (MEASURED["fp32_flops"] or PEAK_FP32_FLOPS) if itemsize == 4 else PEAK_FP64_FLOPS
    t_ops, t_bytes = ops / peak, nbytes / PEAK_HBM_BYTES
    return Bound(1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
                 1e3 * max(ops / measured, t_bytes))


def bound_fields(b: Bound, dev_ms) -> dict:
    """A bound and the device time's share of it, against the data sheet
    and against the measured FP32 peak, for a log line."""
    return {"bound_ms": f"{b.ms:.4f}", "bound_by": b.by, "share_of_bound": share(b.ms, dev_ms),
            "bound_ms_measured_peak": f"{b.ms_measured:.4f}",
            "share_of_measured_bound": share(b.ms_measured, dev_ms)}


def table_bound(L, binv, h_u, ladder) -> Bound:
    """The bound of a table build on these inputs: the bytes it must move
    (L read once, the tables written once) and its FMAs. FMAs per (pair,
    lane), n the series' terms (8 in float32, 12 in float64): (n - 1) w^3
    (Horner) + (n - 1) w^2 (series) + s (w^3 + 2 w^2) (ladder), with s the
    lane's own squaring count on this data."""
    w, B = L.shape[1], L.shape[3]
    isz = L.element_size()
    terms, radius = (8, 0.5) if isz == 4 else (12, 0.25)
    fmas = 0.0
    for b, h in zip(np.asarray(binv), np.asarray(h_u)):
        A = L[int(b)] * float(h)
        norm = torch.amax(torch.sum(torch.abs(A), dim=1), dim=0)
        s = torch.clamp(torch.ceil(torch.log2(torch.clamp(norm, min=1e-30) / radius)),
                        0.0, float(ladder))
        steps = float(torch.nan_to_num(s, nan=0.0).sum())
        fmas += B * (terms - 1) * (w ** 3 + w ** 2) + steps * (w ** 3 + 2 * w ** 2)
    nbytes = float(isz) * (L.numel() + len(binv) * (w * w + 2 * w) * B)
    return bound(nbytes, 2.0 * fmas, isz)


def augmented(L, binv, h_u) -> torch.Tensor:
    """(U*B, w+2, w+2) matrices [[L h, e0, 0], [0, 0, 1], [0, 0, 0]] whose
    exponential holds E, phi1(L h) e0 and phi2(L h) e0: the input of the
    library yardstick ``torch.linalg.matrix_exp``."""
    U, w, B = len(binv), L.shape[1], L.shape[3]
    h = torch.as_tensor(np.asarray(h_u), dtype=L.dtype, device=L.device)
    M = L.new_zeros((U, B, w + 2, w + 2))
    M[:, :, :w, :w] = (L[torch.as_tensor(np.asarray(binv, np.int64), device=L.device)]
                       * h[:, None, None, None]).permute(0, 3, 1, 2)
    M[:, :, 0, w] = 1.0
    M[:, :, w, w + 1] = 1.0
    return M.reshape(U * B, w + 2, w + 2)


def library_check(X, want, h_u) -> float:
    """Scaled error of the matrix_exp tables against the plain version."""
    E, p1, p2 = want
    U, w, B = E.shape[0], E.shape[1], E.shape[3]
    X = X.reshape(U, B, w + 2, w + 2)
    h = torch.as_tensor(np.asarray(h_u), dtype=X.dtype, device=X.device)[:, None, None]
    got = (X[:, :, :w, :w].permute(0, 2, 3, 1),
           (X[:, :, :w, w] * h).permute(0, 2, 1),
           (X[:, :, :w, w + 1] * h * h).permute(0, 2, 1))
    return max(scaled_err(g, r)[1] for g, r in zip(got, want))


def compartmental(rng, Bu, w, B) -> torch.Tensor:
    """Blocks like the model's own: non-negative transfer rates off the
    diagonal, each column's outflow plus its own decay on the diagonal."""
    Lw = rng.uniform(0.0, 2.0, (Bu, w, w, B))
    Lw[:, np.arange(w), np.arange(w), :] = 0.0
    decay = rng.uniform(0.01, 4.0, (Bu, w, B))
    Lw[:, np.arange(w), np.arange(w), :] = -(Lw.sum(axis=1) + decay)
    return torch.as_tensor(Lw, dtype=torch.float32, device="cuda")


def check_and_time(label, L, binv, h_u, ladder, card, reps=20, run_k=None,
                   run_p=None, kernel=None, plain_reps=3) -> dict:
    """One table build through a kernel against its plain version (by
    default ``phi_tables``, which routes by width, and
    ``phi_tables_reference``): errors (scaled tolerance by L's type), then
    times in the order plain, kernel, kernel, plain, matrix_exp, the bound,
    and (``kernel``: a part of the kernel's name) its device time by the
    profiler and share of the bound."""
    run_k = run_k or (lambda: phi_tables(L, binv, h_u, ladder))
    run_p = run_p or (lambda: phi_tables_reference(L, binv, h_u, ladder))
    tol = SCALED_TOL[L.dtype]
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    errs = [scaled_err(g, w) for g, w in zip(got, want)]
    max_abs, worst = max(e[0] for e in errs), max(e[1] for e in errs)
    extra = {}
    if L.dtype == torch.float32:
        # both float32 versions against the float64 plain tables (12 terms)
        exact = phi_tables_reference(L.double(), binv, h_u, ladder)
        vs64 = lambda outs: max(scaled_err(g.double(), x)[1] for g, x in zip(outs, exact))
        extra = {"kernel_vs_f64": f"{vs64(got):.3e}", "plain_vs_f64": f"{vs64(want):.3e}"}
        del exact
    say(f"{label} check", shape=tuple(L.shape), dtype=str(L.dtype).split(".")[-1],
        pairs=len(binv), ladder=ladder, max_abs_err=f"{max_abs:.3e}",
        max_scaled_err=f"{worst:.3e}", tol=tol, **extra)
    if not worst <= tol:
        raise AssertionError(f"{label}: kernel disagrees with the plain version: {worst:.3e}")

    p1, k1, k2, p2 = (cuda_ms(run_p, plain_reps), cuda_ms(run_k, reps),
                      cuda_ms(run_k, reps), cuda_ms(run_p, plain_reps))
    M = augmented(L, binv, h_u)
    lib_ms = cuda_ms(lambda: torch.linalg.matrix_exp(M), 3)
    lib_err = library_check(torch.linalg.matrix_exp(M), want, h_u)
    del M
    b = table_bound(L, binv, h_u, ladder)
    dev_ms = kernel_ms_on_device(run_k, kernel, reps)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    say(f"{label} timing", ms=f"{ms:.4f}", device_ms=measured(dev_ms),
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}", **bound_fields(b, dev_ms),
        runs_ms=[round(x, 4) for x in (p1, k1, k2, p2)],
        library_vs_plain=f"{lib_err:.3e}", card=repr(card))
    return {"max_abs_err": max_abs, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b.ms, "bound_by": b.by, "bound_ms_measured_peak": b.ms_measured,
            "library_ms": lib_ms}


def kernel_ms_on_device(run, kernel, reps):
    """Mean device ms of the kernels named ``kernel`` over ``reps`` calls of
    ``run`` under the profiler; None without a name or a trace."""
    if not kernel:
        return None
    return kernel_device_ms(device_events(lambda: [run() for _ in range(reps)])[0], kernel)


def share(bound_ms, dev_ms) -> str:
    """The bound over the device time, or "not measured"."""
    return "not measured" if not dev_ms else f"{bound_ms / dev_ms:.3f}"


def check_widths(widths) -> None:
    """Every block width on compartmental blocks over 1000 lanes (not a
    multiple of the kernels' tiles), three pairs over two buckets."""
    rng = np.random.default_rng(1)
    for w in widths:
        Lw = compartmental(rng, 2, w, 1000)
        bw = np.asarray([0, 1, 1], np.int32)
        hw = np.asarray([0.0625, 2.0, 16.0])
        lad = max(phi_mod.ladder_len(w, h) for h in hw)
        errs = [scaled_err(g, r) for g, r in
                zip(phi_tables(Lw, bw, hw, lad), phi_tables_reference(Lw, bw, hw, lad))]
        torch.cuda.synchronize()
        worst_w = max(e[1] for e in errs)
        say("3 kernel width", w=w, lanes=1000, max_scaled_err=f"{worst_w:.3e}")
        if not worst_w <= KERNEL_ATOL:
            raise AssertionError(f"kernel disagrees at w={w}: {worst_w:.3e}")


def squaring_counts(L, binv, h_u, ladder) -> dict:
    """The mean squaring count s of a (pair, lane) on these inputs, and the
    mean over the kernel's warps of their largest lane's s (a warp of 32
    neighbouring lanes runs its ladder to that)."""
    isz = L.element_size()
    radius = 0.5 if isz == 4 else 0.25
    lane, warp = [], []
    for b, h in zip(np.asarray(binv), np.asarray(h_u)):
        A = L[int(b)] * float(h)
        norm = torch.amax(torch.sum(torch.abs(A), dim=1), dim=0)
        s = torch.clamp(torch.ceil(torch.log2(torch.clamp(norm, min=1e-30) / radius)),
                        0.0, float(ladder))
        s = torch.nan_to_num(s, nan=0.0)
        lane.append(float(s.mean()))
        pad = torch.nn.functional.pad(s, (0, -s.numel() % 32))
        warp.append(float(pad.reshape(-1, 32).amax(dim=1).mean()))
    return {"mean_s_a_lane": f"{np.mean(lane):.3f}", "mean_s_a_warp": f"{np.mean(warp):.3f}"}


def phase_kernel(b, thetas, card) -> dict:
    params_b = unpack_params(thetas[:CHUNK], b["slices"], b["topo"])
    (L, binv, h_u, ladder), = expo.table_inputs(b["system"], params_b, b["grid"])
    out = check_and_time("3 kernel main-path", L, binv, h_u, ladder, card,
                         kernel="phi_tables_kernel")
    say("3 kernel squaring counts", **squaring_counts(L, binv, h_u, ladder))
    check_widths(range(2, 9))
    return {"name": "phi_tables", "route": "cuda",
            "source": "phoskintime_tpu_torch/csrc/phi_tables.cu",
            "replaces": "phoskintime_tpu/ops/phi_pallas.py:352", **out}


def phase_wide_kernel(b2, thetas2, card) -> dict:
    """3b: the wide kernel at the model-2 chunk's own class shapes (the
    w = 17 class is the main-path entry of the summary) and at the
    unbucketed chunk's full width, every width 9..17, and phi_vectors at
    w = 7 and 17."""
    params_b = unpack_params(thetas2[:CHUNK], b2["slices"], b2["topo"])
    per_class = expo.table_inputs(b2["system"], params_b, b2["grid"])
    summary = {}
    for L, binv, h_u, ladder in per_class:
        if L.shape[1] > 8:
            summary[L.shape[1]] = check_and_time(
                f"3b wide main-path w={L.shape[1]}", L, binv, h_u, ladder, card, reps=5,
                kernel="phi_tables_wide_kernel")
    del per_class
    full, = expo.table_inputs(b2["system"], params_b, b2["grid"], width_bucketing=False)
    unbucketed = check_and_time("3b wide main-path unbucketed w=17", *full, card, reps=5,
                                kernel="phi_tables_wide_kernel")
    del full
    check_widths(range(9, 18))

    # phi_vectors, one pair (U = 1) of compartmental blocks, h = 2
    rng = np.random.default_rng(2)
    for w in (7, 17):
        Lv = compartmental(rng, 1, w, 20480)
        lad = phi_mod.ladder_len(w, 2.0)
        one = lambda **kw: tuple(x[None] for x in phi_vectors(Lv[0], 2.0, lad, **kw))
        check_and_time(f"3b phi_vectors w={w}", Lv, [0], [2.0], lad, card,
                       run_k=one, run_p=lambda: one(use_kernel=False),
                       kernel="phi_tables_wide_kernel" if w > 8 else "phi_tables_kernel")
    return {"name": "phi_tables_wide", "route": "cuda",
            "source": "phoskintime_tpu_torch/csrc/phi_tables_wide.cu",
            "replaces": "phoskintime_tpu/ops/phi_pallas.py:406", **summary[17],
            "class_w9": summary[9], "unbucketed_w17": unbucketed}


def scan_bound(args, plan) -> Bound:
    """The bound of one scan on these inputs: every input read once and the
    T snapshots written once, against its operations of the working type.
    Per segment and lane: E y (w^2 FMAs), p1 g and p2h d (w each), two
    totals (w - 1 each), two TF matvecs (nnz/N FMAs each) and two rational
    rates (~15 operations each); an FMA is 2."""
    E = args[0]
    w, B = E.shape[1], E.shape[3]
    S, P = len(plan.uidx), B // plan.N
    nbytes = float(E.element_size()) * (sum(x.numel() for x in args) + plan.T * w * B)
    ops = S * (B * (2 * w * w + 4 * w + 4 * (w - 1) + 31) + 4 * P * len(plan.tf_col))
    return bound(nbytes, ops, E.element_size())


def scan_tols(dtype) -> tuple[float, float]:
    """(rtol, atol) of a scan against another route: the JAX package's
    (tests/test_pallas.py:262-263) in float32, rounding only in float64."""
    return (SCAN_RTOL, SCAN_ATOL) if dtype == torch.float32 else (F64_SCAN_RTOL, F64_SCAN_ATOL)


def scan_close(label, got, want) -> tuple[float, float]:
    """Gate the trajectory at rtol/atol (by its type); returns (max abs
    error, max abs error / max |want|)."""
    rtol, atol = scan_tols(got.dtype)
    bad = torch.abs(got - want) > atol + rtol * torch.abs(want)
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: {int(bad.sum())} entries outside rtol "
                             f"{rtol} / atol {atol}")
    return scaled_err(got, want)


def graph_of(fn):
    """(replay, output) of ``fn`` captured once in a CUDA graph, after a
    warm-up on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph.replay, out


def check_and_time_scan(label, b, thetas, card, **kw) -> dict:
    """The scan of one chunk by three routes on the inputs the integrator
    assembles (``expo.ScanSetup``; ``kw``: its options): the kernel against
    the plain version and the eager scan (gated), then times in the order
    plain, kernel, kernel, plain, eager, eager replayed from a CUDA graph,
    and the bound."""
    params_b = unpack_params(thetas, b["slices"], b["topo"])
    scan = expo.ScanSetup(b["system"], params_b, b["grid"], **kw)
    args, plan, eager = scan.kernel_args(), scan.plan, scan.run_eager
    E = args[0]
    w, B = E.shape[1], E.shape[3]
    T, P, N = plan.T, B // plan.N, plan.N
    variant = scan_launch_shape(w, N, E.element_size()).variant
    run_k = lambda: etd2rk_scan(*args, plan)
    run_p = lambda: etd2rk_scan_reference(*args, plan)
    got, want = run_k(), run_p()
    ys_e = eager()
    torch.cuda.synchronize()
    max_abs, scaled = scan_close(f"{label} vs plain", got, want)
    as_eager = got.reshape(T, w, P, N).permute(2, 0, 3, 1).reshape(P, T, N * w)
    _, scaled_e = scan_close(f"{label} vs eager", as_eager, ys_e)
    rtol, atol = scan_tols(E.dtype)
    say(f"{label} check", w=w, dtype=str(E.dtype).split(".")[-1], lanes=B,
        segments=len(plan.uidx), pairs=E.shape[0], runs=len(plan.runs), variant=variant,
        snapshots=T, max_abs_err=f"{max_abs:.3e}", max_scaled_err=f"{scaled:.3e}",
        kernel_vs_eager_scaled=f"{scaled_e:.3e}", rtol=rtol, atol=atol)

    p1, k1, k2, p2 = (cuda_ms(run_p, 3), cuda_ms(run_k, 10), cuda_ms(run_k, 10),
                      cuda_ms(run_p, 3))
    eager_ms = cuda_ms(eager, 3)
    replay, ys_g = graph_of(eager)
    replay()
    torch.cuda.synchronize()
    if not torch.equal(ys_g, ys_e):
        raise AssertionError(f"{label}: the CUDA graph's scan differs from the eager one")
    graph_ms = cuda_ms(replay, 5)
    del replay, ys_g
    b = scan_bound(args, plan)
    dev_ms = kernel_ms_on_device(run_k, "etd2rk_scan_kernel", 10)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    say(f"{label} timing", variant=variant, ms=f"{ms:.4f}", device_ms=measured(dev_ms),
        plain_ms=f"{plain_ms:.4f}", eager_ms=f"{eager_ms:.4f}",
        cuda_graph_ms=f"{graph_ms:.4f}", **bound_fields(b, dev_ms),
        runs_ms=[round(x, 4) for x in (p1, k1, k2, p2)], card=repr(card))
    return {"max_abs_err": max_abs, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b.ms, "bound_by": b.by, "bound_ms_measured_peak": b.ms_measured,
            "library_ms": None, "variant": variant, "eager_ms": eager_ms,
            "cuda_graph_ms": graph_ms}


def phase_scan_kernel(b, thetas, b2, thetas2, card) -> dict:
    """3c: the scan kernel at the model-0 chunk (the summary's entry) and
    an unbucketed model-2 chunk, then every width 2..17, then members of
    199 to 225 proteins, each side of the variant switch."""
    out = check_and_time_scan("3c scan main-path", b, thetas[:CHUNK], card)
    out["model2_unbucketed"] = check_and_time_scan(
        "3c scan model-2 unbucketed", b2, thetas2[:CHUNK], card, width_bucketing=False)
    wide_members = [(6, 200), (14, 200), (16, 224), (16, 225), (17, 199), (17, 200)]
    for w, N in [(w, 7) for w in range(2, 18)] + wide_members:
        args, plan = random_scan_problem(w, N=N, P=300 if N == 7 else 12, seed=w,
                                         device="cuda")
        got, want = etd2rk_scan(*args, plan), etd2rk_scan_reference(*args, plan)
        torch.cuda.synchronize()
        max_abs, scaled = scan_close(f"3c scan w={w} N={N}", got, want)
        say("3c scan width", w=w, proteins=N, lanes=args[0].shape[3],
            variant=scan_launch_shape(w, N).variant, max_abs_err=f"{max_abs:.3e}",
            max_scaled_err=f"{scaled:.3e}")
    return {"name": "etd2rk_scan", "route": "cuda",
            "source": "phoskintime_tpu_torch/csrc/etd2rk_scan.cu",
            "replaces": "phoskintime_tpu/ops/scan_pallas.py:246", **out}


def flux_bound(rows: int, smax: int, itemsize: int) -> Bound:
    """Bound of one edge flux: X read and dX written once, smax site rates
    and one dephospho rate a row; two products and two sums a site and
    state."""
    M = 1 << smax
    return bound(itemsize * rows * (2 * M + smax + 1), 4.0 * rows * M * smax, itemsize)


def flux_inputs(rows, smax, dtype) -> tuple:
    """Random rows of states, site rates and dephospho rates on the card."""
    rng = np.random.default_rng(rows + smax)
    f = dict(dtype=dtype, device="cuda")
    return (torch.as_tensor(rng.uniform(0, 1, (rows, 1 << smax)), **f),
            torch.as_tensor(rng.uniform(0.1, 2.0, (rows, smax)), **f),
            torch.as_tensor(rng.uniform(0.1, 2.0, rows), **f))


def host_cost(fn, n: int = HOST_CALLS) -> dict:
    """µs a call of ``fn``: the host's to issue ``n`` back-to-back calls
    with no synchronize, the wall's once one synchronize ends them, and by
    CUDA events over ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"host_us": 1e6 * (t1 - t0) / n, "wall_us": 1e6 * (t2 - t0) / n,
            "events_us": 1e3 * cuda_ms(fn, n)}


def l2_flush_buffer() -> torch.Tensor:
    """A buffer of four times the card's L2: summing it leaves L2 holding
    its clean lines alone, nothing of an earlier kernel's data and nothing
    to write back."""
    return torch.zeros(torch.cuda.get_device_properties(0).L2_cache_size, dtype=torch.float32,
                       device="cuda")


def check_and_time_flux(label, rows, smax, dtype, card, reps=20, quiet=False,
                        flush=None) -> dict:
    """The flux kernel against its plain (gather) version on random rows:
    the gate, then times in the order plain, kernel, kernel, plain, the
    bound, and the kernel's device time with ``flush`` (a buffer larger
    than L2) read before each call, the time held against the bound,
    beside its time on back-to-back calls, which find the data in L2."""
    X, S, E = flux_inputs(rows, smax, dtype)
    run_k = lambda: hypercube_flux(X, S, E, smax)
    run_p = lambda: hypercube_flux(X, S, E, smax, use_kernel=False)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    max_abs, scaled = scaled_err(got, want)
    if not scaled <= SCALED_TOL[dtype]:
        raise AssertionError(f"{label}: flux kernel disagrees: {scaled:.3e}")
    if quiet:
        return {"max_abs_err": max_abs}
    p1, k1, k2, p2 = (cuda_ms(run_p, reps), cuda_ms(run_k, reps), cuda_ms(run_k, reps),
                      cuda_ms(run_p, reps))
    warm_ms = kernel_device_ms(device_events(lambda: [run_k() for _ in range(reps)])[0],
                               "hypercube_flux_kernel")
    dev_ms = kernel_device_ms(device_events(lambda: [(flush.sum(), run_k())
                                                     for _ in range(reps)])[0],
                              "hypercube_flux_kernel")
    b = flux_bound(rows, smax, X.element_size())
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    say(label, rows=rows, smax=smax, dtype=str(dtype).split(".")[-1],
        max_abs_err=f"{max_abs:.3e}", max_scaled_err=f"{scaled:.3e}",
        tol=SCALED_TOL[dtype], ms=f"{ms:.4f}", device_ms_l2_flushed=measured(dev_ms),
        device_ms_l2_warm=measured(warm_ms), plain_ms=f"{plain_ms:.4f}",
        **bound_fields(b, dev_ms), runs_ms=[round(x, 4) for x in (p1, k1, k2, p2)],
        card=repr(card))
    return {"max_abs_err": max_abs, "ms": ms, "device_ms": dev_ms,
            "device_ms_l2_warm": warm_ms, "plain_ms": plain_ms,
            "bound_ms": b.ms, "bound_by": b.by, "bound_ms_measured_peak": b.ms_measured,
            "library_ms": None}


def phase_flux_kernel(card) -> dict:
    """3d: the flux kernel at the RK45 objective's shape (pop 2048 x 45
    proteins, 16 states), float32 (the summary's entry) and float64, with
    the wrapper's host µs a call; at smax 0..10 in both dtypes; and at the
    row counts of the JAX package's size table. The device times held
    against the bound are taken with L2 flushed before each call."""
    rows = POP2 * 45
    flush = l2_flush_buffer()
    out = check_and_time_flux("3d flux main-path", rows, 4, torch.float32, card, flush=flush)
    out["float64"] = check_and_time_flux("3d flux main-path", rows, 4, torch.float64, card,
                                         flush=flush)
    for dtype in (torch.float32, torch.float64):
        X, S, E = flux_inputs(rows, 4, dtype)
        host = host_cost(lambda: hypercube_flux(X, S, E, 4))
        say("3d flux host cost", rows=rows, smax=4, dtype=str(dtype).split(".")[-1],
            calls=HOST_CALLS, **{k: f"{v:.2f}" for k, v in host.items()}, card=repr(card))
        out.setdefault("host_us_per_call", {})[str(dtype).split(".")[-1]] = host
    for smax in range(0, 11):
        for dtype in (torch.float32, torch.float64):
            err = check_and_time_flux("3d flux width", 10001, smax, dtype, card,
                                      quiet=True)["max_abs_err"]
            say("3d flux width", smax=smax, rows=10001, dtype=str(dtype).split(".")[-1],
                max_abs_err=f"{err:.3e}")
    table = {}
    for B in FLUX_SIZE_ROWS:
        t = check_and_time_flux("3d flux size", B, 4, torch.float32, card, flush=flush)
        table[B] = {k: t[k] for k in ("ms", "device_ms", "device_ms_l2_warm", "plain_ms",
                                      "bound_ms")}
        say("3d flux size table", rows=B, kernel_us=f"{1e3 * t['ms']:.2f}",
            kernel_device_us_l2_flushed=measured(t["device_ms"], 1e3, 2),
            kernel_device_us_l2_warm=measured(t["device_ms_l2_warm"], 1e3, 2),
            plain_gather_us=f"{1e3 * t['plain_ms']:.2f}")
    out["size_table"] = table
    return {"name": "hypercube_flux", "route": "cuda",
            "source": "phoskintime_tpu_torch/csrc/hypercube_flux.cu",
            "replaces": "phoskintime_tpu/ops/pallas_kernels.py:165", **out}


def tridiagonal(B, n, dtype, seed=0):
    """Diagonally dominant systems on the card, as tests/test_pallas.py's."""
    rng = np.random.default_rng(seed)
    a, c, d = (rng.normal(0, 1, (B, n)) for _ in range(3))
    b = np.abs(rng.normal(0, 1, (B, n))) + 4.0
    a[:, 0] = c[:, -1] = 0.0
    return [torch.as_tensor(v, dtype=dtype, device="cuda") for v in (a, b, c, d)]


def check_and_time_thomas(label, B, n, dtype, card, reps=20, quiet=False) -> dict:
    """The Thomas kernel against its plain version and against
    torch.linalg.solve of the dense matrices (the library yardstick):
    gates, then times in the order plain, kernel, kernel, plain, library,
    and the bound."""
    a, b, c, d = args = tridiagonal(B, n, dtype, seed=B + n)
    dense = torch.diag_embed(b) + torch.diag_embed(a[:, 1:], -1) + torch.diag_embed(c[:, :-1], 1)
    run_k = lambda: thomas_solve_batched(*args)
    run_p = lambda: thomas_solve_reference(*args)
    run_l = lambda: torch.linalg.solve(dense, d)
    got, want, lib = run_k(), run_p(), run_l()
    torch.cuda.synchronize()
    max_abs, scaled = scaled_err(got, want)
    lib_err = scaled_err(got, lib)[1]
    if not (scaled <= SCALED_TOL[dtype] and lib_err <= 10 * SCALED_TOL[dtype]):
        raise AssertionError(f"{label}: Thomas kernel disagrees: {scaled:.3e}, "
                             f"vs the dense solve {lib_err:.3e}")
    if quiet:
        return {"max_abs_err": max_abs}
    p1, k1, k2, p2 = (cuda_ms(run_p, reps), cuda_ms(run_k, reps), cuda_ms(run_k, reps),
                      cuda_ms(run_p, reps))
    lib_ms = cuda_ms(run_l, reps)
    dev_ms = kernel_device_ms(device_events(lambda: [run_k() for _ in range(reps)])[0],
                              "thomas_kernel")
    isz = a.element_size()
    b = bound(isz * 5 * B * n, 8.0 * B * n, isz)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    say(label, systems=B, n=n, dtype=str(dtype).split(".")[-1],
        max_abs_err=f"{max_abs:.3e}", max_scaled_err=f"{scaled:.3e}",
        vs_dense_solve=f"{lib_err:.3e}", ms=f"{ms:.4f}", device_ms=measured(dev_ms),
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}", **bound_fields(b, dev_ms),
        runs_ms=[round(x, 4) for x in (p1, k1, k2, p2)], card=repr(card))
    return {"max_abs_err": max_abs, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b.ms, "bound_by": b.by, "bound_ms_measured_peak": b.ms_measured,
            "library_ms": lib_ms}


def phase_thomas_kernel(card) -> dict:
    """3e: the Thomas kernel at the steady state's own shape (45 chains of
    5, float64: the summary's entry) beside one chain of 2 (the launch
    floor), and float32, at a population's chains
    (8192 x 45 of 5) in both dtypes, and at n = 2..17."""
    out = check_and_time_thomas("3e thomas main-path", 45, 5, torch.float64, card)
    # one chain of 2: the least work a launch can do, beside the 45 chains
    out["one_chain"] = check_and_time_thomas("3e thomas one chain", 1, 2, torch.float64, card)
    say("3e thomas launch floor", chains_45_device_ms=measured(out["device_ms"]),
        one_chain_device_ms=measured(out["one_chain"]["device_ms"]), card=repr(card))
    out["float32"] = check_and_time_thomas("3e thomas main-path", 45, 5, torch.float32, card)
    out["population"] = {str(dtype).split(".")[-1]: check_and_time_thomas(
        "3e thomas population", 8192 * 45, 5, dtype, card)
        for dtype in (torch.float32, torch.float64)}
    for n in range(2, 18):
        for dtype in (torch.float32, torch.float64):
            err = check_and_time_thomas("3e thomas n", 1000, n, dtype, card,
                                        quiet=True)["max_abs_err"]
            say("3e thomas n", n=n, systems=1000, dtype=str(dtype).split(".")[-1],
                max_abs_err=f"{err:.3e}")
    return {"name": "thomas_solve_batched", "route": "cuda",
            "source": "phoskintime_tpu_torch/csrc/thomas.cu",
            "replaces": "phoskintime_tpu/ops/pallas_kernels.py:95", **out}


def device_events(fn):
    """(device events (name, start us, end us), host wall ms) of one call
    under torch.profiler (CUDA activity only), ended by a synchronize. The
    events are read from the profiler's raw results: its event list costs
    ~0.1 ms of host time an event to build, over a minute for a fit
    generation's trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    raw = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    # µs from the first event, taken in integer ns (absolute ns in a double
    # keep only a quarter-µs)
    t0_ns = min((a for _, a, _ in raw), default=0)
    return [(name, (a - t0_ns) / 1e3, (z - t0_ns) / 1e3) for name, a, z in raw], wall_ms


def measured(x, scale: float = 1.0, digits: int = 4) -> str:
    """A measured number for a log line, or "not measured" where the
    trace had none."""
    return "not measured" if x is None else f"{scale * x:.{digits}f}"


def kernel_device_ms(events, name_part: str):
    """Mean device duration (ms) of the events whose name holds
    ``name_part``; None where the trace holds none."""
    durs = [z - a for name, a, z in events if name_part in name]
    return sum(durs) / len(durs) / 1e3 if durs else None


def profile_call(fn, kernel: str | None = None) -> dict:
    """One call under torch.profiler: the device's kernel and copy events,
    the union of their intervals (device-busy ms), and the host wall of
    the call ended by a synchronize; the idle share is 1 - busy / wall.
    ``kernel``: also the mean device time of the kernels of that name."""
    return summarize_events(*device_events(fn), kernel)


def summarize_events(events, wall_ms, kernel: str | None = None) -> dict:
    """:func:`profile_call`'s fields from one call's device events."""
    spans = sorted((a, z) for _, a, z in events)
    busy_us, end = 0.0, float("-inf")
    for a, z in spans:
        if z > end:
            busy_us += z - max(a, end)
            end = z
    if not spans:
        return {"device_events": 0, "wall_ms": f"{wall_ms:.3f}",
                "busy_ms": "not measured (empty device trace)"}
    out = {"device_events": len(spans), "busy_ms": f"{busy_us / 1e3:.3f}",
           "wall_ms": f"{wall_ms:.3f}",
           "idle_share": f"{1.0 - busy_us / 1e3 / wall_ms:.3f}"}
    if kernel:
        out[f"{kernel}_device_us"] = measured(kernel_device_ms(events, kernel), 1e3, 2)
    return out


def stage_cut(label, b, thetas, objective, card, **kw) -> None:
    """Where one chunk's time goes, by CUDA events around each stage run
    on its own: softplus unpack, the linear blocks, the tables, the whole
    batched simulate (blocks + tables + scan) and the whole objective;
    then one objective call under the profiler. ``kw`` goes to the
    integrator (``width_bucketing``, ``use_scan_kernel``)."""
    system, grid = b["system"], b["grid"]
    params_b = unpack_params(thetas, b["slices"], b["topo"])
    wb = kw.get("width_bucketing")
    inputs = expo.table_inputs(system, params_b, grid, width_bucketing=wb)
    ms = {"unpack": cuda_ms(lambda: unpack_params(thetas, b["slices"], b["topo"]), 3),
          "blocks": cuda_ms(lambda: expo.table_inputs(system, params_b, grid,
                                                      width_bucketing=wb), 3),
          "tables": cuda_ms(lambda: [phi_tables(*a) for a in inputs], 10),
          "simulate": cuda_ms(lambda: expo.exponential_simulate_batched(
              system, params_b, grid, **kw), 3),
          "objective": cuda_ms(lambda: objective(thetas), 3)}
    ms["scan"] = ms["simulate"] - ms["blocks"] - ms["tables"]
    ms["loss_and_unpack"] = ms["objective"] - ms["simulate"]
    say(f"{label} stages", members=thetas.shape[0],
        **{k: f"{v:.3f}" for k, v in ms.items()}, unit="ms", card=repr(card))
    say(f"{label} profile", members=thetas.shape[0],
        **profile_call(lambda: objective(thetas)))


def phase_main_path(b, thetas, card) -> int:
    args = (b["system"], b["slices"], b["loss_data"], b["defaults"],
            b["lambdas"], b["grid"])
    objective = make_population_objective(*args, pop_chunk=CHUNK)
    torch.cuda.synchronize()
    objective(thetas)                      # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()

    reset_counts()
    F = objective(thetas)
    torch.cuda.synchronize()
    launches = counts()
    n_chunks = -(-POP // CHUNK)
    if tuple(F.shape) != (POP, 3) or not bool(torch.isfinite(F).all()):
        raise AssertionError("non-finite or misshapen objectives")
    if launches != expect(phi_tables=n_chunks):
        raise AssertionError(f"kernel launches {launches} for {n_chunks} chunks")
    say("4 main path", pop=POP, chunk=CHUNK, F_shape=tuple(F.shape),
        finite=True, launches=launches)

    plain = make_population_objective(*args, pop_chunk=CHUNK, use_kernel=False)
    Fp = plain(thetas[:256])
    rel = float(torch.max(torch.abs(F[:256] - Fp) / torch.abs(Fp)))
    say("4 main path vs plain", members=256, max_rel_err=f"{rel:.3e}", tol=F_RTOL)
    if not rel <= F_RTOL:
        raise AssertionError(f"objective with the kernel drifted: {rel:.3e}")

    ms = cuda_ms(lambda: objective(thetas), 3)
    say("4 main path rate", evals_per_s=f"{POP / (ms / 1e3):.1f}",
        ms_per_pop=f"{ms:.3f}", card=repr(card))
    stage_cut("4", b, thetas[:CHUNK], objective, card)
    return launches


def phase_main_path_model2(b2, thetas2, card) -> dict:
    """4b: the model-2 objective, width-bucketed into five classes: w = 2,
    3, 5 through phi_tables, w = 9, 17 through phi_tables_wide."""
    args = (b2["system"], b2["slices"], b2["loss_data"], b2["defaults"],
            b2["lambdas"], b2["grid"])
    objective = make_population_objective(*args, pop_chunk=CHUNK)
    torch.cuda.synchronize()
    objective(thetas2)                     # warm-up
    torch.cuda.synchronize()

    reset_counts()
    F = objective(thetas2)
    torch.cuda.synchronize()
    launches = counts()
    if tuple(F.shape) != (POP2, 3) or not bool(torch.isfinite(F).all()):
        raise AssertionError("model 2: non-finite or misshapen objectives")
    if launches != expect(phi_tables=3, phi_tables_wide=2):
        raise AssertionError(f"model 2: kernel launches {launches}, want 3 and 2")
    say("4b model-2 main path", pop=POP2, chunk=CHUNK, F_shape=tuple(F.shape),
        finite=True, classes=[(wc, len(i)) for wc, i in expo.width_classes(b2["topo"])],
        launches=launches)

    plain = make_population_objective(*args, pop_chunk=CHUNK, use_kernel=False)
    Fp = plain(thetas2[:256])
    rel = float(torch.max(torch.abs(F[:256] - Fp) / torch.abs(Fp)))
    say("4b model-2 vs plain", members=256, max_rel_err=f"{rel:.3e}", tol=F_RTOL)
    if not rel <= F_RTOL:
        raise AssertionError(f"model 2: objective with the kernels drifted: {rel:.3e}")

    ms = cuda_ms(lambda: objective(thetas2), 3)
    say("4b model-2 rate", evals_per_s=f"{POP2 / (ms / 1e3):.1f}",
        ms_per_pop=f"{ms:.3f}", card=repr(card))
    stage_cut("4b", b2, thetas2, objective, card)
    return launches


def scan_path(label, b, thetas, card, want_launches, **kw) -> dict:
    """One objective run through the scan kernel (``kw``: the integrator's
    options besides ``use_scan_kernel=True``), in chunks of CHUNK: launches
    per kernel, F against the default objective (eager scan), evals/s,
    stage cut and profiler. Returns the launches."""
    args = (b["system"], b["slices"], b["loss_data"], b["defaults"], b["lambdas"],
            b["grid"])
    objective = make_population_objective(*args, pop_chunk=CHUNK, use_scan_kernel=True,
                                          **kw)
    torch.cuda.synchronize()
    objective(thetas)                      # warm-up
    torch.cuda.synchronize()

    reset_counts()
    F = objective(thetas)
    torch.cuda.synchronize()
    launches = counts()
    pop = thetas.shape[0]
    if tuple(F.shape) != (pop, 3) or not bool(torch.isfinite(F).all()):
        raise AssertionError(f"{label}: non-finite or misshapen objectives")
    if launches != want_launches:
        raise AssertionError(f"{label}: kernel launches {launches}, want {want_launches}")
    say(f"{label} main path", pop=pop, chunk=CHUNK, F_shape=tuple(F.shape), finite=True,
        launches=launches, **kw)

    default = make_population_objective(*args, pop_chunk=CHUNK)
    Fe = default(thetas)
    rel = float(torch.max(torch.abs(F - Fe) / torch.abs(Fe)))
    say(f"{label} vs eager", members=pop, max_rel_err=f"{rel:.3e}", tol=F_RTOL,
        reference="default objective (eager scan)")
    if not rel <= F_RTOL:
        raise AssertionError(f"{label}: objective through the scan kernel drifted: {rel:.3e}")

    ms = cuda_ms(lambda: objective(thetas), 3)
    rates = {"evals_per_s": f"{pop / (ms / 1e3):.1f}", "ms_per_pop": f"{ms:.3f}"}
    if kw:                                 # the same layout through the eager scan
        eager = make_population_objective(*args, pop_chunk=CHUNK, **kw)
        ms_e = cuda_ms(lambda: eager(thetas), 3)
        rates["eager_same_layout_evals_per_s"] = f"{pop / (ms_e / 1e3):.1f}"
    say(f"{label} rate", **rates, card=repr(card))
    stage_cut(label, b, thetas[:CHUNK], objective, card, use_scan_kernel=True, **kw)
    return launches


def phase_scan_paths(b, thetas, b2, thetas2, card) -> dict:
    """4c: the model-0 objective at pop 8192 and the unbucketed model-2
    objective at pop 2048 through the scan kernel."""
    n_chunks = -(-POP // CHUNK)
    return {
        "model0-pop8192-scan": scan_path(
            "4c model-0 scan", b, thetas, card,
            expect(phi_tables=n_chunks, etd2rk_scan=n_chunks)),
        "model2-pop2048-unbucketed-scan": scan_path(
            "4c model-2 scan", b2, thetas2, card,
            expect(phi_tables_wide=1, etd2rk_scan=1),
            width_bucketing=False)}


def oracle_rhs(b):
    """dy/dt of the distributive mechanism (model 0), float64 numpy, written
    out from the equations: synthesis from the squashed TF input, mRNA
    decay, translation, per-site phosphorylation and dephosphorylation."""
    topo, system = b["topo"], b["system"]
    p = {k: np.asarray(v, float) for k, v in b["true"].items()}
    Kmat, grid = np.asarray(system.Kmat, float), np.asarray(system.kin_grid, float)
    msk = topo.site_mask().astype(float)
    N, w = topo.N, topo.width
    driven = topo.driver_map >= 0

    def rhs(y, t):
        Y = y.reshape(N, w)
        jb = min(max(int(np.searchsorted(grid, t, side="right") - 1), 0),
                 Kmat.shape[1] - 1)
        Kt = Kmat[:, jb] * p["c_k"]
        S = np.einsum("nsk,k->ns", topo.W_pad, Kt) * msk
        sites = Y[:, 2:] * msk
        Pv = Y[:, 1] + sites.sum(1)
        Pv[driven] = Kt[topo.driver_map[driven]]
        v = (topo.tf_mat @ Pv) / topo.tf_deg
        u = v / (1.0 + np.abs(v))
        act = p["A_i"] * (1.0 + p["tf_scale"] * u / (1.0 + u + 1e-6))
        rep = p["A_i"] / (1.0 + p["tf_scale"] * np.abs(u))
        dY = np.zeros_like(Y)
        dY[:, 0] = np.where(u >= 0.0, act, rep) - p["B_i"] * Y[:, 0]
        dY[:, 1] = (p["C_i"] * Y[:, 0] - (p["D_i"] + S.sum(1)) * Y[:, 1]
                    + p["E_i"] * sites.sum(1))
        dY[:, 2:] = (S * Y[:, 1:2] - (p["E_i"][:, None] + p["Dp_i"]
                                      + p["D_i"][:, None]) * sites) * msk
        return dY.reshape(-1)

    return rhs


def fold_changes_np(Y, times, msk):
    """(fc_rna, fc_protein, fc_phospho at valid sites) of a (T, N, w) run."""
    base = lambda t0: int(np.argmin(np.abs(times - t0)))
    fc = lambda sig, b: np.maximum(sig, 1e-12) / np.maximum(sig[b][None], 1e-12)
    sites = Y[:, :, 2:] * msk
    return (fc(Y[:, :, 0], base(4.0)), fc(Y[:, :, 1] + sites.sum(2), base(0.0)),
            fc(sites, base(0.0))[:, msk])


def phase_accuracy(b, **kw) -> None:
    """5: the model-0 fold changes against the LSODA oracle; ``kw`` goes to
    the integrator (``use_scan_kernel=True``: through the scan kernel)."""
    system, topo = b["system"], b["topo"]
    times = np.asarray(b["grid"], float)
    msk = topo.site_mask()
    p_b = {k: np.asarray(v)[None] for k, v in b["true"].items()}
    before = etd2rk_scan.launches
    ys, success = expo.exponential_simulate_batched(system, p_b, times, **kw)
    torch.cuda.synchronize()
    scan_launches = etd2rk_scan.launches - before
    if not bool(success[0]):
        raise AssertionError("ETD2RK failed at the true parameters")
    if scan_launches != int(bool(kw.get("use_scan_kernel"))):
        raise AssertionError(f"the accuracy run made {scan_launches} scan-kernel launches")
    obs = extract_observables(system, ys[0])
    got = [x.double().cpu().numpy() for x in fold_changes(obs, times)]
    got[2] = got[2][:, msk]
    want = lsoda_fold_changes(b)
    err = max(float(np.max(np.abs(g - o) / np.maximum(np.abs(o), 1e-6)))
              for g, o in zip(got, want))
    say("5 accuracy", scan_kernel_launches=scan_launches,
        max_rel_err=f"{err:.3e}", gate=ACCURACY_GATE,
        dtype="float32", oracle="LSODA rtol 1e-7 atol 1e-9")
    if not err < ACCURACY_GATE:
        raise AssertionError(f"ETD2RK drifted from the LSODA oracle: {err:.3e}")


def rel_err(got, want) -> float:
    """Max relative error over lists of arrays, |want| floored at 1e-6."""
    return max(float(np.max(np.abs(g - o) / np.maximum(np.abs(o), 1e-6)))
               for g, o in zip(got, want))


def hypercube(topo):
    """(bit (Smax, M), neighbour (Smax, M), valid sites (N, Smax), valid
    states (N, M)) of the combinatorial mechanism: state m of a protein
    sets bit j when site j is phosphorylated; m ^ 2^j is its neighbour
    across site j."""
    smax = topo.max_sites
    m = np.arange(1 << smax)
    j = np.arange(smax)[:, None]
    return ((m[None, :] >> j) & 1, m[None, :] ^ (1 << j),
            topo.site_mask().astype(float), topo.state_mask().astype(float))


def oracle_rhs_model2(b):
    """dy/dt of the combinatorial mechanism (model 2), float64 numpy, written
    out from the equations: state m of a protein gains from its neighbour
    across site j by phosphorylation (bit j set in m, rate S_j) or by
    dephosphorylation (bit j clear, rate E) and loses by the reverse
    edges; it decays at D (m = 0) or at the sum of Dp_j + D over its set
    bits; translation C R feeds m = 0; mRNA as in model 0."""
    topo, system = b["topo"], b["system"]
    p = {k: np.asarray(v, float) for k, v in b["true"].items()}
    Kmat, grid = np.asarray(system.Kmat, float), np.asarray(system.kin_grid, float)
    bit, nbr, valid_s, valid_m = hypercube(topo)
    N, w = topo.N, topo.width
    driven = topo.driver_map >= 0
    D = p["D_i"][:, None]
    decay = np.where(np.arange(valid_m.shape[1])[None, :] == 0, D,
                     ((p["Dp_i"] + D) * valid_s) @ bit)            # (N, M)
    E = p["E_i"][:, None, None]

    def rhs(y, t):
        Y = y.reshape(N, w)
        R, X = Y[:, 0], Y[:, 1:] * valid_m
        jb = min(max(int(np.searchsorted(grid, t, side="right") - 1), 0),
                 Kmat.shape[1] - 1)
        Kt = Kmat[:, jb] * p["c_k"]
        S = np.einsum("nsk,k->ns", topo.W_pad, Kt)[:, :, None]     # (N, Smax, 1)
        Pv = X.sum(1)
        Pv[driven] = Kt[topo.driver_map[driven]]
        v = (topo.tf_mat @ Pv) / topo.tf_deg
        u = v / (1.0 + np.abs(v))
        act = p["A_i"] * (1.0 + p["tf_scale"] * u / (1.0 + u + 1e-6))
        rep = p["A_i"] / (1.0 + p["tf_scale"] * np.abs(u))
        gain = np.where(bit[None] == 1, S, E) * X[:, nbr]            # (N, Smax, M)
        loss = np.where(bit[None] == 1, E, S) * X[:, None, :]
        dX = ((gain - loss) * valid_s[:, :, None]).sum(1) - decay * X
        dX[:, 0] += p["C_i"] * R
        dY = np.concatenate([(np.where(u >= 0.0, act, rep) - p["B_i"] * R)[:, None],
                             dX * valid_m], axis=1)
        return dY.reshape(-1)

    return rhs


def fold_changes_model2_np(Y, times, topo):
    """(fc_rna, fc_protein, fc_phospho at valid sites) of a model-2 run
    (T, N, w): the total sums the valid states, site j sums the states
    with bit j set."""
    bit, _, _, valid_m = hypercube(topo)
    base = lambda t0: int(np.argmin(np.abs(times - t0)))
    fc = lambda sig, b: np.maximum(sig, 1e-12) / np.maximum(sig[b][None], 1e-12)
    X = Y[:, :, 1:] * valid_m
    pho = np.einsum("tnm,jm->tnj", X, bit)
    return (fc(Y[:, :, 0], base(4.0)), fc(X.sum(2), base(0.0)),
            fc(pho, base(0.0))[:, topo.site_mask()])


_ORACLES: dict = {}


def lsoda_fold_changes(b):
    """The fold changes of a LSODA oracle (rtol 1e-7, atol 1e-9) of the
    bundle's mechanism (0 or 2) at its true parameters, float64 numpy;
    computed once per mechanism."""
    from scipy.integrate import odeint

    system, topo = b["system"], b["topo"]
    if topo.model not in _ORACLES:
        times = np.asarray(b["grid"], float)
        rhs = oracle_rhs(b) if topo.model == 0 else oracle_rhs_model2(b)
        Y = odeint(rhs, system.y0().reshape(-1), times, rtol=1e-7, atol=1e-9,
                   mxstep=20000).reshape(len(times), topo.N, topo.width)
        _ORACLES[topo.model] = (fold_changes_np(Y, times, topo.site_mask())
                                if topo.model == 0 else fold_changes_model2_np(Y, times, topo))
    return _ORACLES[topo.model]


def fold_changes_of(system, ys, times):
    """A trajectory's fold changes (phospho at valid sites), float64 numpy."""
    got = [x.double().cpu().numpy() for x in
           fold_changes(extract_observables(system, ys), times)]
    got[2] = got[2][:, system.topo.site_mask()]
    return got


def port_fold_changes(system, true, times, **kw):
    """The port's ETD2RK fold changes at one parameter set, as float64
    numpy; ``kw`` goes to the integrator."""
    p_b = {k: np.asarray(v)[None] for k, v in true.items()}
    ys, success = expo.exponential_simulate_batched(system, p_b, times, **kw)
    if not bool(success[0]):
        raise AssertionError("ETD2RK failed at the true parameters")
    return fold_changes_of(system, ys[0], times)


def phase_precision_model2(b2) -> None:
    """5b: float32 on the card against the port's float64 on the CPU (the
    gate), and both against a LSODA oracle of the hypercube equations."""
    system, topo = b2["system"], b2["topo"]
    times = np.asarray(b2["grid"], float)
    got32 = port_fold_changes(system, b2["true"], times)
    sys64 = GlobalSystem(topo, system.kin_grid, system.Kmat, dtype=torch.float64,
                         device="cpu")
    got64 = port_fold_changes(sys64, b2["true"], times)
    err = rel_err(got32, got64)
    want = lsoda_fold_changes(b2)
    say("5b model-2 precision", f32_card_vs_f64_cpu=f"{err:.3e}", gate=PRECISION_GATE,
        f32_vs_lsoda=f"{rel_err(got32, want):.3e}",
        f64_vs_lsoda=f"{rel_err(got64, want):.3e}", oracle="LSODA rtol 1e-7 atol 1e-9")
    if not err < PRECISION_GATE:
        raise AssertionError(f"model 2: float32 drifted from float64: {err:.3e}")

    before = etd2rk_scan.launches
    scan32 = port_fold_changes(system, b2["true"], times, width_bucketing=False,
                               use_scan_kernel=True)
    launches = etd2rk_scan.launches - before
    err = rel_err(scan32, got64)
    say("5b model-2 precision", scan_kernel_launches=launches, width_bucketing=False,
        f32_card_vs_f64_cpu=f"{err:.3e}", gate=PRECISION_GATE,
        f32_vs_lsoda=f"{rel_err(scan32, want):.3e}")
    if launches != 1 or not err < PRECISION_GATE:
        raise AssertionError(f"model 2, scan kernel ({launches} launches): float32 "
                             f"drifted from float64: {err:.3e}")


def bundle_args(b) -> tuple:
    return (b["system"], b["slices"], b["loss_data"], b["defaults"], b["lambdas"], b["grid"])


def host_bundle(b) -> dict:
    """A bundle's host data: what a worker process needs to make the same
    system and objective at another dtype or on another device."""
    system = b["system"]
    return {"topo": system.topo, "kin_grid": system.kin_grid, "Kmat": system.Kmat,
            **{k: b[k] for k in ("true", "slices", "loss_data", "defaults", "lambdas",
                                 "grid")}}


def worker_job(job: str, hb: dict, dtype: str, device: str, arg=None):
    """One RK45 run in a worker process, on a system made from ``hb``:
    ``"objective"`` F of the members ``arg = (thetas, use_kernel)``;
    ``"fold_changes"`` the fold changes at the true parameters;
    ``"until_steady"`` simulate_until_steady to ``t_final = arg``. Returns
    (result, steps, seconds)."""
    torch.set_num_threads(1)
    system = GlobalSystem(hb["topo"], hb["kin_grid"], hb["Kmat"],
                          dtype=getattr(torch, dtype), device=device)
    t0 = time.perf_counter()
    if job == "objective":
        thetas, use_kernel = arg
        objective = make_objective(system, *(hb[k] for k in ("slices", "loss_data",
                                                               "defaults", "lambdas", "grid")),
                                   use_kernel=use_kernel)
        F = objective(thetas)
        out, steps = F.double().cpu().numpy(), int(objective.n_steps.max())
    elif job == "fold_changes":
        times = np.asarray(hb["grid"], float)
        res = simulate(system, hb["true"], times)
        if not bool(res.success):
            raise AssertionError(f"RK45 failed at the true parameters ({dtype})")
        out, steps = fold_changes_of(system, res.ys, times), int(res.n_steps)
    else:
        rep = simulate_until_steady(system, hb["true"], t_final=arg)
        out, steps = rep, None
    if device == "cuda":
        torch.cuda.synchronize()
    return out, steps, time.perf_counter() - t0


def start_rk45_workers(b, b1, b2, thetas, thetas1, thetas2) -> tuple:
    """The RK45 runs that need no launch count, each in its own process on
    the card (or the CPU), all started together: every run is host-bound
    at some milliseconds a step, so they overlap instead of queueing.
    Returns (pool, {name: future})."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    hb0, hb1, hb2 = host_bundle(b), host_bundle(b1), host_bundle(b2)
    th2 = thetas2.cpu().numpy()
    jobs = {
        "4d plain flux": ("objective", hb2, "float32", "cuda", (th2[:8], False)),
        "4d float64 cpu": ("objective", hb2, "float64", "cpu", (th2[:8], None)),
        "4d model0": ("objective", hb0, "float32", "cuda", (thetas[:POP2].cpu().numpy(), None)),
        "4d model1": ("objective", hb1, "float32", "cuda", (thetas1.cpu().numpy(), None)),
        **{f"5c model{hb['topo'].model} {dt}": ("fold_changes", hb, dt, "cuda")
           for hb in (hb0, hb2) for dt in ("float32", "float64")},
        "6 until_steady": ("until_steady", hb0, "float64", "cuda", STEADY_T_FINAL),
    }
    pool = ProcessPoolExecutor(max_workers=len(jobs), mp_context=get_context("spawn"))
    return pool, {name: pool.submit(worker_job, *spec) for name, spec in jobs.items()}


def phase_rk45_path(b2, thetas2, card) -> dict:
    """4d: the RK45 objective on the model-2 bench network at pop 2048 (one
    chunk), float32, in this process, alone on the card. The batched loop
    runs as many iterations as its slowest member takes steps (frozen
    members are evaluated too): 7 flux launches an iteration, 2 before
    the loop. Then a short profiled window."""
    system, topo = b2["system"], b2["topo"]
    objective = make_objective(*bundle_args(b2))
    reset_counts()
    t0 = time.perf_counter()
    F = objective(thetas2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    steps = objective.n_steps.cpu().numpy()
    iters = int(steps.max())
    if tuple(F.shape) != (POP2, 3) or not bool(torch.isfinite(F).all()):
        raise AssertionError("4d: non-finite or misshapen objectives")
    if launches != expect(hypercube_flux=7 * iters + 2):
        raise AssertionError(f"4d: kernel launches {launches} for {iters} iterations, "
                             f"want {7 * iters + 2} of hypercube_flux")
    say("4d rk45 main path", pop=POP2, F_shape=tuple(F.shape), launches=launches,
        steps_max=iters, steps_median=f"{np.median(steps):.1f}",
        failed_members=int((F >= 1e12).any(dim=1).sum()),
        evals_per_s=f"{POP2 / wall:.1f}", seconds=f"{wall:.3f}",
        ms_per_iteration=f"{1e3 * wall / iters:.3f}", card=repr(card))

    # a steady window of the loop under the profiler (the whole call holds
    # millions of events)
    params_b = unpack_params(thetas2, b2["slices"], topo)
    say("4d rk45 profile", members=POP2, window="the first 40 iterations",
        **profile_call(lambda: simulate_batched(system, params_b, b2["grid"], max_steps=40),
                       kernel="hypercube_flux_kernel"))
    return {"model2-rk45-pop2048": launches}, F


def finish_rk45_workers(pool, futures, F, oracles, card) -> None:
    """4d, 5c and 6's worker runs: F against the plain flux and against
    float64 on the CPU, models 0 and 1, the accuracy gates against the
    LSODA ``oracles`` ({model: fold changes}), and simulate_until_steady."""
    try:
        got = {name: fut.result() for name, fut in futures.items()}
    finally:
        pool.shutdown()
    for name, ref in (("4d plain flux", "plain flux (use_kernel=False)"),
                      ("4d float64 cpu", "float64 on the CPU")):
        Fr, steps, secs = got[name]
        rel = float(np.max(np.abs(F[:8].double().cpu().numpy() - Fr) / np.abs(Fr)))
        say(name, members=8, max_rel_err=f"{rel:.3e}", tol=F_RTOL, reference=ref,
            steps_max=steps, seconds=f"{secs:.2f}")
        if not rel <= F_RTOL:
            raise AssertionError(f"{name}: the RK45 objective drifted: {rel:.3e}")
    for name in ("4d model0", "4d model1"):
        Fm, steps, secs = got[name]
        if not np.isfinite(Fm).all():
            raise AssertionError(f"{name}: non-finite objectives")
        say(f"{name} rk45", pop=len(Fm), evals_per_s=f"{len(Fm) / secs:.1f}",
            steps_max=steps, failed_members=int((Fm >= 1e12).any(axis=1).sum()),
            seconds=f"{secs:.2f}", note="run beside the other workers", card=repr(card))
    for name in sorted(k for k in got if k.startswith("5c")):
        fc, steps, secs = got[name]
        model = int(name.split()[1][-1])
        err = rel_err(fc, oracles[model])
        say("5c rk45 accuracy", model=model, dtype=name.split()[-1], steps=steps,
            max_rel_err=f"{err:.3e}", gate=ACCURACY_GATE, oracle="LSODA rtol 1e-7 atol 1e-9",
            seconds=f"{secs:.2f}")
        if not err < ACCURACY_GATE:
            raise AssertionError(f"{name}: RK45 drifted from LSODA: {err:.3e}")
    rep, _, secs = got["6 until_steady"]
    if not (np.isfinite(rep.tot).all() and np.isfinite(rep.final_rate).all()):
        raise AssertionError("6: simulate_until_steady gave non-finite levels")
    say("6 simulate_until_steady", model=0, t_final_min=STEADY_T_FINAL,
        converged=f"{int(rep.converged.sum())}/{len(rep.converged)}",
        max_final_rate=f"{float(rep.final_rate.max()):.3e}", seconds=f"{secs:.2f}",
        dtype="float64", card=repr(card))


def isolated(model: int):
    topo = build_topology(ISOLATED, None, model=model)
    topo.driver_map[:] = -1
    return topo


def steady_vs_cpu(label, fn, topo, want_launches) -> tuple:
    """One steady state on the card, its launches, against the CPU."""
    reset_counts()
    Y = fn(topo)
    n = counts()
    if n != want_launches:
        raise AssertionError(f"{label}: launches {n}, want {want_launches}")
    cpu = fn(topo, device="cpu")
    err = float(np.max(np.abs(Y - cpu)) / np.max(np.abs(cpu)))
    if not err <= STEADY_TOL:
        raise AssertionError(f"{label}: the card's steady state differs: {err:.3e}")
    return Y, n, err


def phase_steady_states(b1) -> dict:
    """6: the three steady states on the card (float64) against the CPU,
    the RHS there, and the sequential one on the bench network's 45 chains
    (the Thomas kernel's path run)."""
    for model, fn in STEADY.items():
        topo = isolated(model)
        want = expect(thomas_solve_batched=1) if model == 1 else expect()
        Y, n, err = steady_vs_cpu(f"6 model {model}", fn, topo, want)
        system = GlobalSystem(topo, GRID, np.ones((topo.K, len(GRID))), dtype=torch.float64,
                              device="cuda")
        params = default_params(topo)
        params["Dp_i"] = params["Dp_i"] * topo.site_mask()
        pt = {k: torch.as_tensor(np.asarray(v, float), dtype=torch.float64, device="cuda")
              for k, v in params.items()}
        y = torch.as_tensor(Y.reshape(1, -1), dtype=torch.float64, device="cuda")
        dy = system.rhs.batched(0.0, y, torch.zeros(1, dtype=torch.long, device="cuda"),
                                {k: v[None] for k, v in pt.items()})
        resid = max(float(torch.max(torch.abs(dy))),
                    float(torch.max(torch.abs(system.rhs(0.0, y[0], 0, pt)))))
        say("6 steady state", model=model, proteins=topo.N, vs_cpu=f"{err:.3e}",
            tol=STEADY_TOL, rhs_max_abs=f"{resid:.3e}", rhs_tol=RHS_AT_STEADY,
            launches={k: v for k, v in n.items() if v})
        if not resid <= RHS_AT_STEADY:
            raise AssertionError(f"6: the RHS at the model-{model} steady state: {resid:.3e}")

    _, launches, err = steady_vs_cpu("6 bench chains", steadystate.steady_state_sequential,
                                     b1["topo"], expect(thomas_solve_batched=1))
    say("6 steady state bench", model=1, chains=b1["topo"].N,
        n=b1["topo"].max_sites + 1, vs_cpu=f"{err:.3e}", launches=launches)

    return {"steady-state-sequential-bench": launches}


# --- 3f: the FMA-peak probe ----------------------------------------------------------


def phase_fma_peak(card) -> tuple[dict, dict]:
    """3f: sq_chain against its plain version at ``fma_peak.CHECK_REPS``
    steps, nacc 1/2/4/8, within ``fma_peak.CHECK_TOL`` of max |plain| (the
    kernel contracts y*y + c into one FMA, the plain version rounds the
    multiply and the add; at so few steps the output still depends on the
    seeds, on c's x term and on the step count, and the check fails unless
    it spreads far beyond the tolerance); the FFMAs in each instance's SASS
    (reps x nacc, or something shortened the chains); then the peak sweep,
    the probe's main path (each arm by the slope of 8 and 24 chained
    launches), whose best arm becomes this run's measured FP32 peak.
    Returns (the kernel's entry, {path: launches})."""
    X = fma_peak.probe_input("cuda")
    max_abs, reps, tol = 0.0, fma_peak.CHECK_REPS, fma_peak.CHECK_TOL
    for nacc in fma_peak.NACCS:
        got, want = fma_peak.sq_chain(X, reps, nacc), fma_peak.sq_chain_reference(X, reps, nacc)
        torch.cuda.synchronize()
        err, scaled = scaled_err(got, want)
        spread = float(want.max() - want.min()) / float(want.abs().max())
        say("3f sq_chain check", nacc=nacc, reps=reps, elements=X.numel(),
            max_abs_err=f"{err:.3e}", max_scaled_err=f"{scaled:.3e}", tol=tol,
            scaled_spread=f"{spread:.3e}")
        if not scaled <= tol or not spread > 1e4 * tol:
            raise AssertionError(f"3f: sq_chain disagrees at nacc={nacc}: {scaled:.3e} "
                                 f"(the plain output's scaled spread {spread:.3e})")
        max_abs = max(max_abs, err)
    ffma = fma_peak.sass_ffma_counts()
    want = {(n, r): n * r for n in fma_peak.NACCS for r in fma_peak.BUILT_REPS}
    say("3f sq_chain sass", ffma={f"nacc{n}_reps{r}": c for (n, r), c in sorted(ffma.items())},
        want="reps * nacc an element")
    if ffma != want:
        raise AssertionError(f"3f: FFMA counts {ffma}, want {want}")

    reset_counts()
    sweep = fma_peak.measure_peak(X, threads=SWEEP_THREADS, emit=lambda arm: say(
        "3f peak arm", nacc=arm["nacc"], threads=arm["threads"], reps=arm["reps"],
        tflops=f"{arm['tflops']:.3f}", chain_ms=arm["chain_ms"], card=repr(card)))
    launches = counts()
    if launches != expect(sq_chain=launches["sq_chain"]) or not launches["sq_chain"]:
        raise AssertionError(f"3f: the sweep's launches {launches}")
    peak = sweep["peak_tflops"]
    MEASURED["fp32_flops"] = peak * 1e12
    best = sweep["best"]
    say("3f peak", tflops=f"{peak:.3f}", nacc=best["nacc"], threads=best["threads"],
        datasheet_tflops=PEAK_FP32_FLOPS / 1e12,
        share_of_datasheet=f"{peak * 1e12 / PEAK_FP32_FLOPS:.3f}", card=repr(card))

    # the best arm at the probe's own size: per-launch time from the slope,
    # device time, the plain version, the bound (operations, data sheet)
    nacc, th = best["nacc"], best["threads"]
    ms = (best["chain_ms"]["24"] - best["chain_ms"]["8"]) / 16
    dev_ms = kernel_ms_on_device(lambda: fma_peak.sq_chain(X, fma_peak.REPS, nacc, threads=th),
                                 "sq_chain_kernel", 10)
    plain_ms = cuda_ms(lambda: fma_peak.sq_chain_reference(X, fma_peak.REPS, nacc), 1)
    b = bound(8.0 * X.numel(), fma_peak.chain_flops(X, fma_peak.REPS, nacc))
    say("3f sq_chain timing", nacc=nacc, threads=th, reps=fma_peak.REPS, ms=f"{ms:.4f}",
        device_ms=measured(dev_ms), plain_ms=f"{plain_ms:.4f}", **bound_fields(b, dev_ms),
        card=repr(card))
    entry = {"name": "sq_chain", "route": "cuda",
             "source": "phoskintime_tpu_torch/csrc/sq_chain.cu",
             "replaces": "benchmarks/vpu_peak.py:58", "max_abs_err": max_abs, "ms": ms,
             "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b.ms, "bound_by": b.by,
             "bound_ms_measured_peak": b.ms_measured, "library_ms": None,
             "measured_peak_tflops": peak, "best_arm": {"nacc": nacc, "threads": th}}
    return entry, {"fma-peak-sweep": launches}


# --- 3g: float64 on the card ---------------------------------------------------------


def at_float64(b) -> dict:
    """The bundle with its system at float64 on the card."""
    return {**b, "system": b["system"].astype(torch.float64)}


def float64_path(label, b64, thetas, card, want, **kw) -> dict:
    """A float64 objective on the card in chunks of CHUNK: its launches, F
    on 8 members against the port's float64 CPU result (rel 1e-9), evals/s."""
    objective = make_population_objective(*bundle_args(b64), pop_chunk=CHUNK, **kw)
    objective(thetas[:8])                  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    F = objective(thetas)
    torch.cuda.synchronize()
    launches = counts()
    if tuple(F.shape) != (len(thetas), 3) or not bool(torch.isfinite(F).all()):
        raise AssertionError(f"{label}: non-finite or misshapen objectives")
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, want {want}")
    s = b64["system"]
    cpu = GlobalSystem(s.topo, s.kin_grid, s.Kmat, dtype=torch.float64, device="cpu")
    Fc = make_population_objective(cpu, *bundle_args(b64)[1:], **kw)(thetas[:8].cpu())
    rel = float(torch.max(torch.abs(F[:8].cpu() - Fc) / torch.abs(Fc)))
    ms = cuda_ms(lambda: objective(thetas), 2)
    say(f"{label} float64 path", pop=len(thetas), launches=launches,
        vs_f64_cpu=f"{rel:.3e}", tol=F64_OBJECTIVE_RTOL,
        evals_per_s=f"{len(thetas) / (ms / 1e3):.1f}", card=repr(card), **kw)
    if not rel <= F64_OBJECTIVE_RTOL:
        raise AssertionError(f"{label}: float64 on the card drifted from the CPU: {rel:.3e}")
    return launches


def phase_float64(b, thetas, b2, thetas2, card) -> tuple[list, dict]:
    """3g: the float64 instances of the three kernels at the main path's
    shapes (tables within 1e-12 scaled of their plain versions, the scan
    within rtol 1e-10 / atol 1e-12, times and bounds at the FP64 peak), then
    the float64 objective on the card (model 0 by both scan routes, model 2
    bucketed and unbucketed through the scan kernel) against the CPU.
    Returns (the three kernels' entries, {path: launches})."""
    b64, b2_64 = at_float64(b), at_float64(b2)
    th, th2 = thetas[:CHUNK].double(), thetas2[:CHUNK].double()
    params_b = unpack_params(th, b64["slices"], b64["topo"])
    (L, binv, h_u, ladder), = expo.table_inputs(b64["system"], params_b, b64["grid"])
    tables = check_and_time("3g f64 tables model-0", L, binv, h_u, ladder, card, reps=10,
                            plain_reps=1, kernel="phi_tables_kernel")
    del L
    params2 = unpack_params(th2, b2_64["slices"], b2_64["topo"])
    wide = {}
    for L, binv, h_u, ladder in expo.table_inputs(b2_64["system"], params2, b2_64["grid"]):
        if L.shape[1] > 8:
            wide[L.shape[1]] = check_and_time(f"3g f64 wide w={L.shape[1]}", L, binv, h_u,
                                              ladder, card, reps=5, plain_reps=1,
                                              kernel="phi_tables_wide_kernel")
        del L
    full, = expo.table_inputs(b2_64["system"], params2, b2_64["grid"], width_bucketing=False)
    wide_full = check_and_time("3g f64 wide unbucketed w=17", *full, card, reps=3,
                               plain_reps=1, kernel="phi_tables_wide_kernel")
    del full
    scan = check_and_time_scan("3g f64 scan model-0", b64, th, card)
    scan2 = check_and_time_scan("3g f64 scan model-2 unbucketed", b2_64, th2, card,
                                width_bucketing=False)
    paths = {
        "model0-f64-chunk2048": float64_path("3g model-0", b64, th, card, expect(phi_tables=1)),
        "model0-f64-chunk2048-scan": float64_path(
            "3g model-0 scan", b64, th, card, expect(phi_tables=1, etd2rk_scan=1),
            use_scan_kernel=True),
        "model2-f64-chunk2048": float64_path("3g model-2", b2_64, th2, card,
                                             expect(phi_tables=3, phi_tables_wide=2)),
        "model2-f64-chunk2048-unbucketed-scan": float64_path(
            "3g model-2 scan", b2_64, th2, card, expect(phi_tables_wide=1, etd2rk_scan=1),
            width_bucketing=False, use_scan_kernel=True)}
    entries = [
        {"name": "phi_tables_f64", "counter": "phi_tables", "route": "cuda",
         "source": "phoskintime_tpu_torch/csrc/phi_tables.cu",
         "replaces": "phoskintime_tpu/ops/phi_pallas.py:352", **tables},
        {"name": "phi_tables_wide_f64", "counter": "phi_tables_wide", "route": "cuda",
         "source": "phoskintime_tpu_torch/csrc/phi_tables_wide.cu",
         "replaces": "phoskintime_tpu/ops/phi_pallas.py:406", **wide[17], "class_w9": wide[9],
         "unbucketed_w17": wide_full},
        {"name": "etd2rk_scan_f64", "counter": "etd2rk_scan", "route": "cuda",
         "source": "phoskintime_tpu_torch/csrc/etd2rk_scan.cu",
         "replaces": "phoskintime_tpu/ops/scan_pallas.py:246", **scan,
         "model2_unbucketed": scan2}]
    return entries, paths


# --- 7: the global fit ---------------------------------------------------------------


def generation_profile(label, fn, card) -> None:
    """One generation ``fn`` (its route already warm) under the profiler and
    CUDA's sync debug mode: its synchronizing reads (one warning each; the
    mode does not see every kind), device events, busy and idle share.
    ``fn`` returns the host clock's ms of the generation's host-only step
    (the default route's survival) or None where it has none; its share
    of the generation's wall is taken on that one clock."""
    import warnings

    host = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            events, wall_ms = device_events(lambda: host.append(fn()))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    host_fields = ({"host_steps": "none (every step on the card)"} if host[0] is None else
                   {"host_survival_ms": f"{host[0]:.3f}",
                    "host_survival_share": f"{host[0] / wall_ms:.3f}"})
    say(f"{label} profile", sync_reads=syncs, **host_fields,
        **summarize_events(events, wall_ms), card=repr(card))


def fit_route(label, ns, card, n_gen, n_chunks, **kw) -> tuple:
    """run_global_fit on the north-star network at pop NORTHSTAR_POP: its
    launches (phi_tables once a chunk of every evaluation), generations,
    evals/s and seconds a generation (the callback's clock, each
    generation ended by a synchronize), the ideal point never rising, and
    the survivors' F against a re-evaluation of their X."""
    marks = []

    def cb(gen, X, F):
        torch.cuda.synchronize()
        marks.append((gen, time.perf_counter()))
        return False

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_global_fit(*bundle_args(ns), ns["xl"], ns["xu"], pop=NORTHSTAR_POP, n_gen=n_gen,
                         seed=0, ftol=0.0, ftol_period=10_000, n_max_evals=None,
                         frechet_pick=False, callback=cb, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    gens = len(res.history)
    if launches != expect(phi_tables=(gens + 1) * n_chunks):
        raise AssertionError(f"{label}: launches {launches} for {gens + 1} evaluations "
                             f"of {n_chunks} chunks")
    ideals = np.array([h[1] for h in res.history])
    rises = int((np.diff(ideals, axis=0) > 0).sum())
    F_re = make_population_objective(*bundle_args(ns))(res.X).cpu().numpy()
    rel = float(np.max(np.abs(F_re - res.F) / np.abs(res.F)))
    per_gen = np.diff([t for _, t in marks]) / np.diff([g for g, _ in marks]) if len(marks) > 1 \
        else np.asarray([(marks[0][1] - t0) / marks[0][0]])
    say(f"{label}", pop=NORTHSTAR_POP, generations=gens, n_evals=res.n_evals,
        launches=launches, wall_s=f"{wall:.2f}", evals_per_s=f"{res.n_evals / wall:.1f}",
        s_per_generation=[round(float(x), 3) for x in per_gen],
        pareto=len(res.pareto_F), ideal=[float(x) for x in ideals[-1]],
        ideal_rises=rises, survivors_vs_reeval=f"{rel:.3e}", tol=FIT_F_RTOL, card=repr(card),
        **kw)
    if rises or not rel <= FIT_F_RTOL or not np.isfinite(res.F).all():
        raise AssertionError(f"{label}: ideal rose {rises} times or survivors' F drifted "
                             f"({rel:.3e})")
    return res, launches


def phase_global_fit(b, card) -> dict:
    """7: run_global_fit at full width on the north-star network
    (``build_demo_network(150, 24, seed=1)``, float32, bench.py:407-412) at
    pop 10,000: the all-device loop (gens_per_dispatch=5, two blocks), then
    the default route (device variation, host survival) for 2 generations;
    then one generation of each route profiled; then, on the bench network,
    pop 256 for 5 generations with one refinement round and the Fréchet
    pick. Returns {path: launches}."""
    t0 = time.perf_counter()
    ns = build_demo_network(**NORTHSTAR, dtype=torch.float32, device="cuda")
    n_chunks = -(-NORTHSTAR_POP // _auto_pop_chunk(ns["topo"].N))
    say("7 setup", N=ns["topo"].N, K=ns["topo"].K, n_theta=len(ns["theta0"]),
        chunks=n_chunks, seconds=f"{time.perf_counter() - t0:.2f}")
    dev, dev_launches = fit_route("7 global fit all-device", ns, card, 10, n_chunks,
                                  gens_per_dispatch=5)
    host, host_launches = fit_route("7 global fit default", ns, card, 2, n_chunks)

    # one generation of each route, as run_global_fit runs it
    objective = make_population_objective(*bundle_args(ns))
    f = dict(dtype=torch.float32, device="cuda")
    n_var = len(ns["xl"])
    bl, bu = torch.as_tensor(ns["xl"], **f), torch.as_tensor(ns["xu"], **f)
    init, block, _ = make_device_ga_blocks(objective, n_var, NORTHSTAR_POP, gens_per_block=1,
                                           **f)
    carry = init(dev.X)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def device_generation():
        block(*carry, gen, bl, bu)

    generation_profile("7 all-device generation", device_generation, card)
    refs = das_dennis(3, 20)
    rng = np.random.default_rng(1)
    X, F, rank, _, nd = nsga3_survival(host.X, host.F, NORTHSTAR_POP, refs, rng)
    step = make_device_ga_step(objective, ns["xl"], ns["xu"], NORTHSTAR_POP, **f)

    def host_generation():
        off, F_off = step(X, rank, nd, 7)
        t0 = time.perf_counter()
        nsga3_survival(np.vstack([X, off]), np.vstack([F, F_off]), NORTHSTAR_POP, refs, rng)
        return 1e3 * (time.perf_counter() - t0)

    generation_profile("7 default-route generation", host_generation, card)
    del ns, objective, carry, init, block

    # refinement and the Frechet pick on the bench network
    reset_counts()
    t0 = time.perf_counter()
    res = run_global_fit(*bundle_args(b), b["xl"], b["xu"], pop=256, n_gen=5, seed=0, ftol=0.0,
                         refine=True, num_refinements=1, frechet_pick=True,
                         df_prot=b["df_prot"], df_rna=b["df_rna"], df_pho=b["df_pho"],
                         t_points=(GRID, RNA_GRID, GRID))
    torch.cuda.synchronize()
    refine_launches = counts()
    want_evals = 256 * 6 + 256 * 11        # main fit (1 + 5), the round (1 + 10)
    say("7 refinement and pick", pop=256, n_evals=res.n_evals, want=want_evals,
        pareto=len(res.pareto_X), best_idx=res.best_idx,
        best_score=f"{float(res.frechet_scores[res.best_idx]):.6g}",
        launches=refine_launches, seconds=f"{time.perf_counter() - t0:.2f}", card=repr(card))
    if res.n_evals != want_evals or not 0 <= res.best_idx < len(res.pareto_X) \
            or not refine_launches["phi_tables"]:
        raise AssertionError("7: refinement or the pick went wrong")
    return {"global-fit-pop10000-all-device": dev_launches,
            "global-fit-pop10000-default": host_launches,
            "global-fit-pop256-refine-pick": refine_launches}


# --- 8: model 4 and the last oracle solvers ------------------------------------------


def oracle_rhs_model4(b):
    """dy/dt of the saturating mechanism (model 4), float64 numpy, written
    out from the equations: mRNA as in model 0; translation C R / (1 + R)
    and per-site phosphorylation S_j P0 / (1 + P0) saturate; sites return
    to P0 at E and decay at Dp_j + D; P0 decays at D."""
    topo, system = b["topo"], b["system"]
    p = {k: np.asarray(v, float) for k, v in b["true"].items()}
    Kmat, grid = np.asarray(system.Kmat, float), np.asarray(system.kin_grid, float)
    msk = topo.site_mask().astype(float)
    N, w = topo.N, topo.width
    driven = topo.driver_map >= 0

    def rhs(y, t):
        Y = y.reshape(N, w)
        R, P0 = Y[:, 0], Y[:, 1]
        jb = min(max(int(np.searchsorted(grid, t, side="right") - 1), 0),
                 Kmat.shape[1] - 1)
        Kt = Kmat[:, jb] * p["c_k"]
        S = np.einsum("nsk,k->ns", topo.W_pad, Kt) * msk
        sites = Y[:, 2:] * msk
        Pv = P0 + sites.sum(1)
        Pv[driven] = Kt[topo.driver_map[driven]]
        v = (topo.tf_mat @ Pv) / topo.tf_deg
        u = v / (1.0 + np.abs(v))
        act = p["A_i"] * (1.0 + p["tf_scale"] * u / (1.0 + u + 1e-6))
        rep = p["A_i"] / (1.0 + p["tf_scale"] * np.abs(u))
        fwd = S * (P0 / (1.0 + P0))[:, None]
        back = p["E_i"][:, None] * sites
        dY = np.zeros_like(Y)
        dY[:, 0] = np.where(u >= 0.0, act, rep) - p["B_i"] * R
        dY[:, 1] = (p["C_i"] * R / (1.0 + R) - p["D_i"] * P0 - fwd.sum(1) + back.sum(1))
        dY[:, 2:] = (fwd - (p["Dp_i"] + p["D_i"][:, None]) * sites - back) * msk
        return dY.reshape(-1)

    return rhs


def median_ms(fn, calls: int = STAGE_CALLS) -> tuple[float, float, float]:
    """(median, least, most) device milliseconds of ``fn()`` over ``calls``
    calls, each alone between CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start, stop = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times)), min(times), max(times)


def stage_cut_model4(b4, thetas, objective, card) -> None:
    """Where a model-4 chunk's time goes, each stage run on its own, the
    median of ``STAGE_CALLS`` calls by CUDA events (the range beside it):
    the softplus unpack, the block Jacobians and the in-scan phi builds of
    every chunk of the plan (at y0), the whole batched simulate, the loss
    (the objective's scorer on the simulated trajectories) and the whole
    objective; sub-steps = simulate - Jacobians - phi builds, the one stage
    taken by difference."""
    system, grid = b4["system"], b4["grid"]
    rhs = system.rhs
    N, w = rhs.N, rhs.width
    params_b = unpack_params(thetas, b4["slices"], b4["topo"])
    P = thetas.shape[0]
    seg_t0, seg_h, seg_jb = expo._plan(system, grid, 16.0)[:3]
    _, c_h, c_jb, c_n = expo._chunk_plan(seg_t0, seg_h, seg_jb)
    Y0 = torch.as_tensor(system.y0(), dtype=thetas.dtype, device="cuda")
    Y0 = Y0[None].expand(P, N, w)

    def jacobians():
        return [rhs.jac_blocks_saturating(
            Y0, rhs.site_rates(rhs.Kmat[:, int(jb)][None] * params_b["c_k"]), params_b)
            .reshape(P * N, w, w).permute(1, 2, 0) for jb in c_jb]

    Ls = jacobians()
    hs = [torch.full((P * N,), float(h), dtype=thetas.dtype, device="cuda") for h in c_h]
    ys, ok = expo.exponential_simulate_batched(system, params_b, grid)
    score = _scorer(system, b4["loss_data"], b4["defaults"], b4["lambdas"], len(grid), 0,
                    1e12, dense_loss=True)
    timed = {"unpack": median_ms(lambda: unpack_params(thetas, b4["slices"], b4["topo"])),
             "jacobians": median_ms(jacobians),
             "phi_build": median_ms(lambda: [expo._phi_matrices_lanes(L, h)
                                             for L, h in zip(Ls, hs)]),
             "simulate": median_ms(lambda: expo.exponential_simulate_batched(
                 system, params_b, grid)),
             "loss": median_ms(lambda: score(params_b, ys, ok)),
             "objective": median_ms(lambda: objective(thetas))}
    ms = {k: v[0] for k, v in timed.items()}
    ms["sub_steps"] = ms["simulate"] - ms["jacobians"] - ms["phi_build"]
    say("8a model-4 stages", members=P, chunks=len(c_h), segments=int(c_n.sum()),
        calls=STAGE_CALLS, **{k: f"{v:.3f}" for k, v in ms.items()}, unit="ms (median)",
        **{f"{k}_range": f"{v[1]:.3f}-{v[2]:.3f}" for k, v in timed.items()},
        phi_share=f"{ms['phi_build'] / ms['objective']:.3f}",
        sub_step_share=f"{ms['sub_steps'] / ms['objective']:.3f}", card=repr(card))


def phase_model4(card) -> tuple[dict, dict]:
    """8a: the model-4 population objective at full width
    (``build_demo_network(40, 12, model=4, seed=0)``, float32, N = 45, w =
    6) at pop 2048 in one chunk, as ``benchmarks/model_rates.py``: no
    table or scan kernel launched; F finite and within 1e-3 of the port's
    float64 objective on the CPU on 64 members; the trajectory at the true
    parameters within 5e-3 of SciPy LSODA (fold changes printed beside);
    evals/s, one call profiled, the stage cut. Returns ({path: launches},
    the bundle)."""
    t0 = time.perf_counter()
    b4 = build_demo_network(N_PROTEINS, N_KINASES, model=4, seed=0, dtype=torch.float32,
                            device="cuda")
    topo = b4["topo"]
    thetas = population(b4, POP2)
    say("8a setup", model=4, N=topo.N, w=topo.width, n_theta=len(b4["theta0"]),
        seconds=f"{time.perf_counter() - t0:.2f}")
    objective = make_population_objective(*bundle_args(b4), pop_chunk=POP2)
    objective(thetas)                      # warm-up
    torch.cuda.synchronize()
    reset_counts()
    F = objective(thetas)
    torch.cuda.synchronize()
    launches = counts()
    if tuple(F.shape) != (POP2, 3) or not bool(torch.isfinite(F).all()):
        raise AssertionError("8a: non-finite or misshapen objectives")
    if launches != expect():
        raise AssertionError(f"8a: model 4 launched {launches}; it runs no table or scan kernel")
    s = b4["system"]
    cpu = GlobalSystem(topo, s.kin_grid, s.Kmat, dtype=torch.float64, device="cpu")
    Fc = make_population_objective(cpu, *bundle_args(b4)[1:])(thetas[:64].double().cpu())
    rel = float(torch.max(torch.abs(F[:64].double().cpu() - Fc) / torch.abs(Fc)))
    ms = cuda_ms(lambda: objective(thetas), 3)
    say("8a model-4 main path", pop=POP2, chunk=POP2, F_shape=tuple(F.shape), finite=True,
        launches=launches, vs_f64_cpu=f"{rel:.3e}", tol=F_RTOL,
        evals_per_s=f"{POP2 / (ms / 1e3):.1f}", ms_per_pop=f"{ms:.3f}", card=repr(card))
    if not rel <= F_RTOL:
        raise AssertionError(f"8a: float32 on the card drifted from float64: {rel:.3e}")
    say("8a model-4 profile", members=POP2, **profile_call(lambda: objective(thetas)))
    stage_cut_model4(b4, thetas, objective, card)

    from scipy.integrate import odeint
    times = np.asarray(b4["grid"], float)
    Y = odeint(oracle_rhs_model4(b4), s.y0().reshape(-1), times, rtol=1e-7, atol=1e-9,
               mxstep=20000)
    ys, ok = expo.exponential_simulate_batched(s, {k: np.asarray(v)[None]
                                                   for k, v in b4["true"].items()}, times)
    if not bool(ok[0]):
        raise AssertionError("8a: the Rosenbrock path failed at the true parameters")
    got = ys[0].double().cpu().numpy()
    traj = float(np.max(np.abs(got - Y) / (np.abs(Y) + 1e-8)))
    fc = rel_err(fold_changes_of(s, ys[0], times),
                 fold_changes_np(Y.reshape(len(times), topo.N, topo.width), times,
                                 topo.site_mask()))
    say("8a model-4 accuracy", trajectory_max_rel_err=f"{traj:.3e}", gate=ROSENBROCK_GATE,
        fold_change_max_rel_err=f"{fc:.3e}", dtype="float32",
        oracle="LSODA rtol 1e-7 atol 1e-9")
    if not traj < ROSENBROCK_GATE:
        raise AssertionError(f"8a: the Rosenbrock path drifted from LSODA: {traj:.3e}")
    return {"model4-pop2048": launches}, b4


def esdirk_run(label, b64, thetas, card, want_flux: bool) -> tuple:
    """One ``simulate_batched(solver="esdirk")`` on the card at float64
    (rtol 1e-8, atol 1e-10) to ``ESDIRK_T_END``: its launches, the plain
    flux's calls (none allowed), steps, seconds and ms a step; then the
    step's parts timed alone at the run's shapes, each the median of single
    calls between CUDA events (the ``torch.func`` Jacobian, the LU, one
    RHS, one LU solve), and one short window under the profiler. Returns
    (result, launches)."""
    system = b64["system"]
    params = unpack_params(thetas, b64["slices"], b64["topo"])
    reset_counts()
    hypercube_flux_reference.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate_batched(system, params, ESDIRK_TIMES, solver="esdirk", **ESDIRK_TOLS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = counts(), hypercube_flux_reference.calls
    steps = res.n_steps.cpu().numpy()
    if not bool(res.success.all()):
        raise AssertionError(f"{label}: ESDIRK failed for {int((~res.success).sum())} members")
    want = ESDIRK_FLUX_PER_STEP * int(steps.max()) + 1 if want_flux else 0
    if plain or launches != expect(hypercube_flux=want):
        raise AssertionError(f"{label}: launches {launches} (hypercube_flux: want {want}), "
                             f"plain flux calls {plain}")
    step_ms = 1e3 * wall / steps.max()
    say(label, pop=len(thetas), d=b64["topo"].N * b64["topo"].width, t_end=ESDIRK_T_END,
        steps_max=int(steps.max()), steps_median=f"{np.median(steps):.1f}",
        seconds=f"{wall:.2f}", ms_per_step=f"{step_ms:.3f}", launches=launches,
        plain_flux_calls=plain, card=repr(card))

    rhs = system.rhs_batched(params)
    P, d = res.ys.shape[0], res.ys.shape[2]
    y, t = res.ys[:, -1].contiguous(), torch.zeros(P, dtype=torch.float64, device="cuda")
    jb = torch.zeros(P, dtype=torch.long, device="cuda")
    M = torch.eye(d, dtype=torch.float64, device="cuda") - 0.01 * batched_jacobian(rhs, t, y, jb)
    lu, piv, _ = torch.linalg.lu_factor_ex(M)
    timed = {"jacobian": median_ms(lambda: batched_jacobian(rhs, t, y, jb)),
             "lu_factor": median_ms(lambda: torch.linalg.lu_factor_ex(M)),
             "rhs": median_ms(lambda: rhs(t, y, jb), 9),
             "lu_solve": median_ms(lambda: torch.linalg.lu_solve(lu, piv, y[:, :, None]), 9)}
    part = {k: v[0] for k, v in timed.items()}
    # a step: the Jacobian, one LU, 19 RHS (6 Newton iterations of 3 stages
    # and the derivative after the step) and 18 LU solves
    shares = {"jacobian": part["jacobian"], "lu_factor": part["lu_factor"],
              "rhs_x19": 19 * part["rhs"], "lu_solve_x18": 18 * part["lu_solve"]}
    say(f"{label} step parts", **{f"{k}_ms": f"{v:.3f}" for k, v in part.items()},
        **{f"{k}_range": f"{v[1]:.3f}-{v[2]:.3f}" for k, v in timed.items()},
        **{f"{k}_share": f"{v / step_ms:.3f}" for k, v in shares.items()},
        rest_share=f"{1 - sum(shares.values()) / step_ms:.3f}", card=repr(card))
    say(f"{label} profile", window="5 steps", **profile_call(lambda: simulate_batched(
        system, params, ESDIRK_TIMES, solver="esdirk", rtol=1e-8, atol=1e-10,
        max_steps=5)))
    return res, launches


def phase_esdirk(b, b2, thetas, thetas2, card) -> dict:
    """8b, on the card: ESDIRK on the model-2 bench network at float64 (N =
    45, w = 17, d = 765) at pop 16 and on model 0 at pop 64 (rtol 1e-8,
    atol 1e-10) over the first ``ESDIRK_T_END`` minutes, across the first
    kinase boundary; the model-2 run launches the flux kernel 21 times a
    loop iteration (its Jacobian twice, through the kernel's forward-mode
    and vmap rules) and never the plain version; the Jacobian by the kernel
    against the one by the plain flux.
    Each run's ys against tight RK45 (:func:`check_esdirk`). Returns
    {path: launches}."""
    b64, b2_64 = at_float64(b), at_float64(b2)
    if not np.asarray(b64["system"].kin_grid)[1] < ESDIRK_T_END:
        raise AssertionError("8b: the window ends before the first kinase boundary")
    th2, th0 = thetas2[:ESDIRK_POP[2]].double(), thetas[:ESDIRK_POP[0]].double()
    params = unpack_params(th2, b2_64["slices"], b2_64["topo"])
    system = b2_64["system"]
    d = system.topo.N * system.topo.width
    y = torch.as_tensor(system.y0().reshape(1, -1), dtype=torch.float64,
                        device="cuda").expand(len(th2), d) * 1.1
    t = torch.zeros(len(th2), dtype=torch.float64, device="cuda")
    jb = torch.full((len(th2),), 3, dtype=torch.long, device="cuda")
    reset_counts()
    hypercube_flux_reference.calls = 0
    J = batched_jacobian(system.rhs_batched(params), t, y, jb)
    torch.cuda.synchronize()
    jac_launches, plain = counts()["hypercube_flux"], hypercube_flux_reference.calls
    J_plain = batched_jacobian(system.rhs_batched(params, use_kernel=False), t, y, jb)
    err, scaled = scaled_err(J, J_plain)
    say("8b esdirk jacobian", model=2, pop=len(th2), d=d, flux_launches=jac_launches,
        plain_flux_calls=plain, max_abs_err=f"{err:.3e}", scaled=f"{scaled:.3e}",
        tol=SCALED_TOL[torch.float64], reference="the plain flux's Jacobian",
        card=repr(card))
    if plain or jac_launches != 2 or not scaled <= SCALED_TOL[torch.float64]:
        raise AssertionError(f"8b: the Jacobian through the flux kernel ({jac_launches} "
                             f"launches, {plain} plain calls) differs: {scaled:.3e}")
    del J, J_plain
    paths = {}
    for model, bb, th in ((2, b2_64, th2), (0, b64, th0)):
        label = f"8b esdirk model-{model}"
        res, paths[f"esdirk-model{model}-pop{len(th)}"] = esdirk_run(
            label, bb, th, card, want_flux=model == 2)
        check_esdirk(label, bb, th, res.ys)
    return paths


def check_esdirk(label, b64, thetas, ys) -> None:
    """8b's gate: ESDIRK's ys against RK45 at rtol 1e-8 / atol 1e-10 on the
    same members (float64 on the CPU), within rtol 1e-5 / atol 1e-7."""
    s = b64["system"]
    cpu = GlobalSystem(s.topo, s.kin_grid, s.Kmat, dtype=torch.float64, device="cpu")
    params = unpack_params(thetas.cpu(), b64["slices"], b64["topo"])
    ref = simulate_batched(cpu, params, ESDIRK_TIMES, rtol=1e-8, atol=1e-10,
                           max_steps=ESDIRK_TOLS["max_steps"])
    want, got = ref.ys.numpy(), ys.cpu().numpy()
    bad = np.abs(got - want) > ESDIRK_RTOL * np.abs(want) + ESDIRK_ATOL
    worst = float(np.max(np.abs(got - want) / (ESDIRK_RTOL * np.abs(want) + ESDIRK_ATOL)))
    say(f"{label} vs rk45", members=len(got), entries_off=int(bad.sum()),
        worst_share_of_tol=f"{worst:.3f}", rtol=ESDIRK_RTOL, atol=ESDIRK_ATOL,
        max_abs_err=f"{float(np.max(np.abs(got - want))):.3e}",
        rk45_steps_max=int(ref.n_steps.max()),
        reference="RK45 rtol 1e-8 atol 1e-10, float64, CPU")
    if bad.any() or not bool(ref.success.all()):
        raise AssertionError(f"{label}: ESDIRK drifted from RK45 at {int(bad.sum())} entries")


def phase_expo(b, b4, thetas, card) -> None:
    """8c: the per-candidate exponential integrator (``solver="expo"``):
    ``simulate`` of models 0 and 4 at the true parameters against the
    batched path (the ETD2RK tables, the Rosenbrock path), and
    ``make_objective(solver="expo")`` at pop 64 on model 0 against the
    population objective, rel 1e-3 in float32; times."""
    for bb in (b, b4):
        system, times = bb["system"], np.asarray(bb["grid"], float)
        one = lambda: simulate(system, bb["true"], times, solver="expo")
        batched = lambda: expo.exponential_simulate_batched(
            system, {k: np.asarray(v)[None] for k, v in bb["true"].items()}, times)
        got, want = one(), batched()
        rel = float(torch.max(torch.abs(got.ys - want[0][0]) / (torch.abs(want[0][0]) + 1e-6)))
        say("8c expo simulate", model=bb["topo"].model, max_rel_err=f"{rel:.3e}", tol=F_RTOL,
            reference="exponential_simulate_batched", steps=int(got.n_steps),
            ms=f"{cuda_ms(one, 1):.3f}", batched_ms=f"{cuda_ms(batched, 1):.3f}",
            card=repr(card))
        if not (bool(got.success) and rel <= F_RTOL):
            raise AssertionError(f"8c: simulate(solver='expo') of model {bb['topo'].model} "
                                 f"drifted: {rel:.3e}")
    th = thetas[:EXPO_POP]
    per_candidate = make_objective(*bundle_args(b), solver="expo")
    population_obj = make_population_objective(*bundle_args(b))
    F, Fp = per_candidate(th), population_obj(th)
    rel = float(torch.max(torch.abs(F - Fp) / torch.abs(Fp)))
    ms = cuda_ms(lambda: per_candidate(th), 1)
    say("8c expo objective", model=0, pop=EXPO_POP, max_rel_err=f"{rel:.3e}", tol=F_RTOL,
        reference="make_population_objective", evals_per_s=f"{EXPO_POP / (ms / 1e3):.1f}",
        ms=f"{ms:.3f}", population_ms=f"{cuda_ms(lambda: population_obj(th), 1):.3f}",
        card=repr(card))
    if not (bool(torch.isfinite(F).all()) and rel <= F_RTOL):
        raise AssertionError(f"8c: make_objective(solver='expo') drifted: {rel:.3e}")


# --- 9: gradients and polish ---------------------------------------------------------


def phase_gradients(b, thetas, card) -> dict:
    """9a: the differentiable objective on one chunk of GRAD_CHUNK members
    (polish's default chunk): F against the production objective (rel 2e-4,
    the JAX package's gate), a finite gradient, no table or scan launch in
    the forward and reverse passes and one in the production call; at
    float64 on the card the gradient against the CPU's (8 members, scaled
    by its largest entry) and against central differences along 3 seeded
    directions; forward and forward+reverse ms (median of 3, CUDA events),
    one step under the profiler, peak memory. Returns {path: launches}."""
    args = bundle_args(b)
    th = thetas[:GRAD_CHUNK]
    differentiable = make_population_objective(*args, differentiable=True)
    production = make_population_objective(*args)

    def scalar(objective, X):
        return torch.sum(objective(X)) / 3.0

    def value_and_grad(objective, X):
        X = X.detach().requires_grad_(True)
        s = scalar(objective, X)
        return s, torch.autograd.grad(s, X)[0]

    value_and_grad(differentiable, th)                 # warm-up
    torch.cuda.synchronize()
    reset_counts()
    X = th.detach().requires_grad_(True)
    F_d = differentiable(X)
    g, = torch.autograd.grad(F_d.sum(), X)
    torch.cuda.synchronize()
    derivative = counts()
    reset_counts()
    F_p = production(th)
    torch.cuda.synchronize()
    scoring = counts()
    F_d = F_d.detach()
    rel = float(torch.max(torch.abs(F_d - F_p) / torch.abs(F_p)))
    close = bool(torch.all(torch.abs(F_d - F_p) <= GRAD_F_ATOL + GRAD_F_RTOL * torch.abs(F_p)))
    fwd = median_ms(lambda: differentiable(th.detach().requires_grad_(True)))
    step = median_ms(lambda: value_and_grad(differentiable, th))
    torch.cuda.reset_peak_memory_stats()
    value_and_grad(differentiable, th)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("9a gradients", members=GRAD_CHUNK, vs_production=f"{rel:.3e}", tol=GRAD_F_RTOL,
        grad_finite=bool(torch.isfinite(g).all()), derivative_launches=derivative,
        scoring_launches=scoring, forward_ms=f"{fwd[0]:.3f}",
        forward_ms_range=f"{fwd[1]:.3f}-{fwd[2]:.3f}", forward_reverse_ms=f"{step[0]:.3f}",
        forward_reverse_ms_range=f"{step[1]:.3f}-{step[2]:.3f}", peak_gib=f"{peak:.3f}",
        card=repr(card))
    say("9a profile", members=GRAD_CHUNK,
        **profile_call(lambda: value_and_grad(differentiable, th)))
    if not (close and bool(torch.isfinite(g).all())):
        raise AssertionError(f"9a: the differentiable objective drifted ({rel:.3e}) "
                             "or its gradient is not finite")
    if derivative != expect() or scoring != expect(phi_tables=1):
        raise AssertionError(f"9a: launches {derivative} in the derivative passes, "
                             f"{scoring} in the production call")

    # float64 on the card: against the CPU and against central differences
    b64 = at_float64(b)
    s = b64["system"]
    cpu = GlobalSystem(s.topo, s.kin_grid, s.Kmat, dtype=torch.float64, device="cpu")
    diff64 = make_population_objective(*bundle_args(b64), differentiable=True)
    X64 = th.double()
    _, g64 = value_and_grad(diff64, X64)
    _, g_cpu = value_and_grad(make_population_objective(cpu, *bundle_args(b64)[1:],
                                                        differentiable=True),
                              X64[:GRAD_CPU_MEMBERS].cpu())
    vs_cpu = float(torch.max(torch.abs(g64[:GRAD_CPU_MEMBERS].cpu() - g_cpu))
                   / torch.max(torch.abs(g_cpu)))
    rng = np.random.default_rng(9)
    fd_errs = []
    with torch.no_grad():
        for _ in range(GRAD_FD_DIRECTIONS):
            d = torch.as_tensor(rng.normal(size=tuple(X64.shape)), dtype=torch.float64,
                                device="cuda")
            d /= torch.linalg.norm(d)
            fd = (float(scalar(diff64, X64 + GRAD_FD_EPS * d))
                  - float(scalar(diff64, X64 - GRAD_FD_EPS * d))) / (2 * GRAD_FD_EPS)
            fd_errs.append(abs(float(torch.sum(g64 * d)) - fd) / abs(fd))
    say("9a float64 gradients", members=GRAD_CHUNK, vs_cpu=f"{vs_cpu:.3e}",
        cpu_members=GRAD_CPU_MEMBERS, tol=GRAD_F64_RTOL,
        vs_central_differences=[f"{e:.3e}" for e in fd_errs], fd_tol=GRAD_FD_RTOL,
        eps=GRAD_FD_EPS, card=repr(card))
    if not (vs_cpu <= GRAD_F64_RTOL and max(fd_errs) <= GRAD_FD_RTOL):
        raise AssertionError(f"9a: the float64 gradient drifted: {vs_cpu:.3e} from the CPU, "
                             f"{max(fd_errs):.3e} from central differences")
    return {"gradient-9a-derivative": derivative, "gradient-9a-production": scoring}


def phase_polish(b, thetas, card) -> dict:
    """9b: polish_solutions on POLISH_POP members for POLISH_STEPS steps,
    each along its own simplex_weights direction: no member worse than its
    input (the JAX package's slack), every member inside [xl, xu]; ms a
    step; the table launches of the whole call, all of them the final
    production scoring. Returns {path: launches}."""
    args = bundle_args(b)
    X0 = thetas[:POLISH_POP].cpu().numpy().astype(float)
    F0 = make_population_objective(*args)(X0).cpu().numpy().astype(float)
    W = simplex_weights(F0)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X, F = polish_solutions(*args, X0, b["xl"], b["xu"], weights=W, steps=POLISH_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    s0, s1 = (F0 * W).sum(axis=1), (F * W).sum(axis=1)
    inside = bool(np.all(X >= b["xl"] - 1e-6) and np.all(X <= b["xu"] + 1e-6))
    say("9b polish", members=POLISH_POP, steps=POLISH_STEPS,
        ms_per_step=f"{1e3 * wall / POLISH_STEPS:.3f}", seconds=f"{wall:.2f}", launches=launches,
        score_ratio_mean=f"{float(np.mean(s1 / s0)):.4f}",
        score_ratio_max=f"{float(np.max(s1 / s0)):.6f}", slack=POLISH_SLACK, inside=inside,
        card=repr(card))
    if not (np.all(s1 <= s0 * (1 + POLISH_SLACK) + 1e-6) and inside):
        raise AssertionError("9b: a polished member got worse or left the box")
    if launches != expect(phi_tables=1):
        raise AssertionError(f"9b: launches {launches}; want the final scoring's one")
    return {"polish-pop32": launches}


def phase_lm(b, card) -> dict:
    """9c: the LM finish from the demo's true parameters (clipped to the
    box), perturbed by 2%, in the zero-residual form (r_offset = r(theta*)
    at each precision, tests/test_polish.py:318-389): sum(r**2) against
    F.sum() at float32 (rel 2e-4) and float64 (1e-9); the forward-mode
    Jacobian's ms (n tangents in chunks of JAC_CHUNK, median of 3);
    lm_refine_mixed (LM_ITERS_LO float32 iterations, then LM_ITERS_HI at
    float64 on the card), whose float32 stage (read by a spy on
    lm_refine) must end no worse than its input, and whose end below
    LM_MIXED_GATE x the float32 sse; ms an iteration; the largest relative
    error of the physical parameters against the true ones (printed, not
    gated). Returns {path: launches}."""
    b64 = at_float64(b)
    xl, xu = b["xl"], b["xu"]
    th_star = np.clip(np.asarray(b["theta_true"], float), xl, xu)
    rng = np.random.default_rng(3)
    th0 = np.clip(th_star + 0.02 * rng.standard_normal(th_star.size) * (1 + np.abs(th_star)),
                  xl, xu)
    residuals, offsets, sse_rel = {}, {}, {}
    for bb in (b, b64):
        dt = bb["system"].dtype
        res = residuals[dt] = make_residual_fn(*bundle_args(bb))
        with torch.no_grad():
            offsets[dt] = res(torch.as_tensor(th_star, device="cuda")).cpu().double().numpy()
            r = res(torch.as_tensor(th0, device="cuda"))
            F = make_population_objective(*bundle_args(bb), differentiable=True)(th0[None])
        sse_rel[dt] = abs(float(torch.sum(r.double() ** 2)) / float(F.double().sum()) - 1.0)
    res32 = residuals[torch.float32]
    th0_t = torch.as_tensor(th0, dtype=torch.float32, device="cuda")
    jac = median_ms(lambda: forward_jacobian(res32, th0_t, JAC_CHUNK))
    say("9c residuals", n=th0.size, M=offsets[torch.float32].size,
        sse_vs_F_f32=f"{sse_rel[torch.float32]:.3e}", tol_f32=LM_SSE_RTOL[torch.float32],
        sse_vs_F_f64=f"{sse_rel[torch.float64]:.3e}", tol_f64=LM_SSE_RTOL[torch.float64],
        jacobian_ms=f"{jac[0]:.3f}", jacobian_ms_range=f"{jac[1]:.3f}-{jac[2]:.3f}",
        jac_chunk=JAC_CHUNK, card=repr(card))
    if any(sse_rel[dt] > LM_SSE_RTOL[dt] for dt in sse_rel):
        raise AssertionError(f"9c: sum(r**2) drifted from F.sum(): {sse_rel}")

    stages = []
    real = polish.lm_refine

    def spy(system, *a, **kw):
        t0 = time.perf_counter()
        out = real(system, *a, **kw)
        torch.cuda.synchronize()
        stages.append((system.dtype, kw["iters"], out[1], time.perf_counter() - t0))
        return out

    r0 = offsets[torch.float32]
    with torch.no_grad():
        sse_in = float(np.sum((res32(th0_t).cpu().double().numpy() - r0) ** 2))
    reset_counts()
    polish.lm_refine = spy
    try:
        th, sse = lm_refine_mixed(*bundle_args(b), th0, xl, xu, iters_lo=LM_ITERS_LO,
                                  iters_hi=LM_ITERS_HI, r_offset_lo=r0,
                                  r_offset_hi=offsets[torch.float64], jac_chunk=JAC_CHUNK)
    finally:
        polish.lm_refine = real
    launches = counts()
    (_, n32, sse32, sec32), (_, n64, _, sec64) = stages
    phys_star = softplus(torch.as_tensor(th_star))
    par_err = float(torch.max(torch.abs(softplus(torch.as_tensor(th)) - phys_star) / phys_star))
    say("9c lm", sse_in=f"{sse_in:.6e}", sse_f32=f"{sse32:.6e}", sse_mixed=f"{sse:.6e}",
        gate=f"{LM_MIXED_GATE} x sse_f32", ms_per_iteration_f32=f"{1e3 * sec32 / n32:.1f}",
        ms_per_iteration_f64=f"{1e3 * sec64 / n64:.1f}", iterations=(n32, n64),
        max_rel_param_err=f"{par_err:.3e}", north_star=1e-6, launches=launches,
        card=repr(card))
    if not (sse32 <= sse_in and sse < LM_MIXED_GATE * sse32):
        raise AssertionError(f"9c: the LM finish missed: in {sse_in:.3e}, float32 {sse32:.3e}, "
                             f"mixed {sse:.3e}")
    if launches != expect():
        raise AssertionError(f"9c: the LM finish launched {launches}")
    return {"lm-finish": launches}


def phase_gradient_fits(b, card) -> dict:
    """9d: run_global_fit on the bench network with the gradient options:
    pop 256 for 3 generations, then polish_steps=20 and gn_iters=3; then
    optimizer="gradient" at pop 64 with polish_steps=20 (JAX's minimum of
    100 steps). Gates: n_evals by the JAX package's bookkeeping, the
    Pareto set the first front of every member with at least one polished
    member in it, the table launches (the GA's evaluations and one a
    production scoring). Prints each stage's seconds. Returns {path:
    launches}."""
    args = bundle_args(b)
    marks = []

    class Clock:
        """A logger that stamps the fit's own messages with the host clock."""
        def info(self, msg):
            marks.append((str(msg).split(" ")[0], time.perf_counter()))

    def cb(gen, X, F):
        torch.cuda.synchronize()
        marks.append(("gen", time.perf_counter()))
        return False

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_global_fit(*args, b["xl"], b["xu"], pop=GRADFIT_POP, n_gen=GRADFIT_GENS, seed=0,
                         ftol=0.0, frechet_pick=False, polish_steps=POLISH_STEPS,
                         gn_iters=GRADFIT_GN_ITERS, callback=cb, logger=Clock())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    t_ga = max(t for k, t in marks if k == "gen")
    t_polish = next(t for k, t in marks if k == "[Polish]")
    t_gn = next(t for k, t in marks if k == "[GN]")
    n_pol = len(res.X) - GRADFIT_POP - 1
    want = (GRADFIT_POP * (1 + GRADFIT_GENS) + 3 * POLISH_STEPS * n_pol
            + 30 * GRADFIT_GN_ITERS)
    front = fast_non_dominated_sort(res.F)[0]
    in_front = int(np.sum(front >= GRADFIT_POP))
    say("9d fit polish lm", pop=GRADFIT_POP, generations=GRADFIT_GENS, polished=n_pol,
        n_evals=res.n_evals, want=want, pareto=len(res.pareto_F),
        polished_or_lm_in_front=in_front, launches=launches,
        ga_s=f"{t_ga - t0:.2f}", polish_s=f"{t_polish - t_ga:.2f}",
        lm_s=f"{t_gn - t_polish:.2f}", wall_s=f"{wall:.2f}", card=repr(card))
    if not (res.n_evals == want and in_front >= 1 and n_pol >= 1
            and np.array_equal(res.pareto_F, res.F[front]) and np.isfinite(res.F).all()):
        raise AssertionError("9d: the polish and LM bookkeeping or merge went wrong")
    if launches != expect(phi_tables=1 + GRADFIT_GENS + 2):
        raise AssertionError(f"9d: launches {launches}")
    paths = {"fit-pop256-polish-lm": launches}

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_global_fit(*args, b["xl"], b["xu"], pop=GRADFIT_MULTISTART_POP, seed=0,
                         optimizer="gradient", polish_steps=POLISH_STEPS, frechet_pick=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    steps = max(100, POLISH_STEPS)
    front = fast_non_dominated_sort(res.F)[0]
    say("9d gradient multistart", pop=GRADFIT_MULTISTART_POP, steps=steps,
        n_evals=res.n_evals, want=GRADFIT_MULTISTART_POP * 3 * steps,
        pareto=len(res.pareto_F), best_sum=f"{float(res.F.sum(axis=1).min()):.6g}",
        launches=launches, seconds=f"{wall:.2f}",
        ms_per_step=f"{1e3 * wall / steps:.1f}", card=repr(card))
    if not (res.n_evals == GRADFIT_MULTISTART_POP * 3 * steps
            and np.array_equal(res.pareto_F, res.F[front]) and np.isfinite(res.F).all()):
        raise AssertionError("9d: the gradient multistart's bookkeeping went wrong")
    if launches != expect(phi_tables=1):
        raise AssertionError(f"9d: the multistart launched {launches}")
    paths["fit-gradient-pop64"] = launches
    return paths


# --- 10: the per-gene stack --------------------------------------------------------


def pergene_gene(model: str, n: int, seed: int) -> tuple:
    """Noise-free synthetic data of one gene from known parameters, by the
    JAX package's recipe (tests/test_normest.py:21-37): (true, y0, pr_data,
    p_data, r_data), made on the CPU at float64."""
    rng = np.random.default_rng(seed)
    true = rng.uniform(0.3, 2.5, n_params(model, n))
    y0 = initial_condition(n, model, device="cpu").numpy()
    _, fit = solve_ode(true, y0, n, PG_TIMES, model, device="cpu")
    fit = fit.numpy()
    T = len(PG_TIMES)
    return true, y0, fit[T - 5:2 * T - 5], fit[2 * T - 5:].reshape(n, T), fit[:T - 5]


def pergene_cohort(model: str, n: int) -> tuple:
    """normest_batch's positional arguments for PG_GENES synthetic genes."""
    data = [pergene_gene(model, n, 100 * n + g) for g in range(PG_GENES)]
    return ([f"G{n}_{g}" for g in range(PG_GENES)], np.stack([d[2] for d in data]),
            np.stack([d[3] for d in data]), np.stack([d[4] for d in data]), data[0][1], n,
            PG_TIMES, PG_BOUNDS)


def pergene_cpu_job(model: str) -> dict:
    """The float64 CPU reference of 10b (a worker process): normest_batch
    of the first PG_CPU_GENES genes of the n = PG_CPU_SITES cohort at the
    defaults. A gene's fit does not depend on its cohort-mates, so these
    equal the card's fits of the same genes."""
    torch.set_num_threads(PG_CPU_THREADS)
    t0 = time.perf_counter()
    genes, pr, p, r, *rest = pergene_cohort(model, PG_CPU_SITES)
    k = PG_CPU_GENES
    out = normest_batch(genes[:k], pr[:k], p[:k], r[:k], *rest, model=model, device="cpu")
    return {"fits": out, "seconds": time.perf_counter() - t0}


def pergene_solve_job(P, model: str, n: int) -> np.ndarray:
    """10a's float64 CPU reference (a worker process): the solves of P."""
    torch.set_num_threads(PG_CPU_THREADS)
    y0 = initial_condition(n, model, device="cpu").numpy()
    return solve_ode_batched(P, y0, n, PG_TIMES, model, device="cpu")[0].numpy()


def sync_events(fn) -> tuple:
    """(synchronizes, device-to-host copies): ``fn()`` under
    set_sync_debug_mode("error"), then its profiled device-to-host copies."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        syncs = False
    except RuntimeError:
        syncs = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    events, _ = device_events(fn)
    return syncs, sum("DtoH" in name for name, _, _ in events)


def pergene_draws() -> dict:
    """10a's seeded parameter vectors, {(model, n): (PG_SOLVES, n_params)}."""
    rng = np.random.default_rng(10)
    return {(m, n): rng.uniform(0.0, 20.0, (PG_SOLVES, n_params(m, n)))
            for m in PG_MODELS for n in PG_SITES}


def phase_pergene_solves(draws, card) -> tuple:
    """10a, on the card: for each model and n = 1..5, PG_SOLVES seeded
    parameter vectors in the default box (``draws``) through
    solve_ode_batched at float64 and float32; the port's expm and
    torch.linalg.matrix_exp timed on the solve's batch of augmented
    matrices (float32), and whether each synchronizes; then both at the
    stage-2 batch of randmod n = 5 (a Jacobian pass: lanes x T x
    (n_params + 1) matrices). Returns ({path: launches}, {(model, n):
    ({dtype: sol on the host}, log fields)}) for :func:`check_pergene_solves`."""
    reset_counts()
    out = {}
    dts = torch.diff(torch.as_tensor(PG_TIMES, dtype=torch.float32, device=PG_DEVICE),
                     prepend=torch.zeros(1, device=PG_DEVICE))
    for (model, n), P in draws.items():
        y0 = initial_condition(n, model, device="cpu").numpy()
        got = {dt: solve_ode_batched(P, y0, n, PG_TIMES, model, device=PG_DEVICE,
                                     dtype=dt)[0].double().cpu()
               for dt in (torch.float64, torch.float32)}
        M, b = _BUILDERS[model](torch.as_tensor(P, dtype=torch.float32, device=PG_DEVICE), n)
        A = affine_augment(M, b)[:, None] * dts[:, None, None]
        out[(model, n)] = got, dict(w=A.shape[-1], matrices=A.shape[0] * A.shape[1],
                                    expm_ms=f"{cuda_ms(lambda: expm(A), 3):.3f}",
                                    matrix_exp_ms=f"{cuda_ms(lambda: torch.linalg.matrix_exp(A), 3):.3f}")
    expm_sync = sync_events(lambda: expm(A))
    mexp_sync = sync_events(lambda: torch.linalg.matrix_exp(A))
    say("10a synchronizes", batch=tuple(A.shape), expm=expm_sync[0], expm_dtoh=expm_sync[1],
        matrix_exp=mexp_sync[0], matrix_exp_dtoh=mexp_sync[1])
    # the stage-2 batch of randmod at n = 5: 384 lanes x T x (n_params + 1)
    model, n = "randmod", 5
    rows = PG_GENES * 48 * (n_params(model, n) + 1)
    lanes = torch.as_tensor(np.random.default_rng(11).uniform(0.0, 20.0,
                                                              (rows, n_params(model, n))),
                            dtype=torch.float32, device=PG_DEVICE)
    A = affine_augment(*_BUILDERS[model](lanes, n))[:, None] * dts[:, None, None]
    ms_expm = cuda_ms(lambda: expm(A), 3)
    ms_mexp = cuda_ms(lambda: torch.linalg.matrix_exp(A), 3)
    _, diff = scaled_err(expm(A), torch.linalg.matrix_exp(A))
    say("10a stage-2 batch", model=model, n=n, matrices=rows * len(PG_TIMES),
        w=A.shape[-1], dtype="float32", expm_ms=f"{ms_expm:.3f}",
        matrix_exp_ms=f"{ms_mexp:.3f}", scaled_diff=f"{diff:.3e}", card=repr(card))
    del A, lanes
    launches = counts()
    if launches != expect():
        raise AssertionError(f"10a: the per-gene solves launched {launches}")
    return {"pergene-10a-solves": launches}, out


def check_pergene_solves(draws, solves, refs) -> None:
    """10a's check: the card's solves against the port's float64 CPU
    result (``refs``, futures of worker processes): float64 within
    max(1e-12, 8 2^s eps) (scaled; s the batch's largest squaring count),
    float32 within 1e-3, NaN lanes in the same places."""
    worst32 = 0.0
    for (model, n), (got, fields) in solves.items():
        want = torch.as_tensor(refs[(model, n)].result())
        # each squaring can double a rounding difference of the Pade step
        # (tests/test_torch_kinetics.py): the float64 gate after the batch's
        # largest squaring count s is max(1e-12, 8 2^s eps)
        M, b = _BUILDERS[model](torch.as_tensor(draws[(model, n)]), n)
        norm = (float(torch.max(affine_augment(M, b).abs().sum(-2).amax(-1)))
                * float(np.max(np.diff(PG_TIMES))))
        s_max = max(0, int(np.floor(np.log2(norm / PG_MAXNORM_F64))))
        gate = max(PG_F64_SCALED, 8 * 2.0 ** s_max * np.finfo(float).eps)
        errs = {}
        for dt, sol in got.items():
            if not torch.equal(torch.isnan(sol), torch.isnan(want)):
                raise AssertionError(f"10a {model} n={n} {dt}: NaN lanes differ")
            fin = torch.isfinite(want)
            errs[dt] = float(torch.max(torch.abs(sol[fin] - want[fin]))
                             / torch.max(torch.abs(want[fin])))
        say("10a solves", model=model, n=n, lanes=PG_SOLVES, squarings_max=s_max,
            vs_cpu_f64=f"{errs[torch.float64]:.3e}", tol_f64=f"{gate:.3e}",
            vs_cpu_f32=f"{errs[torch.float32]:.3e}", tol_f32=PG_F32_SCALED,
            nan_lanes=int(torch.isnan(want).any(dim=(1, 2)).sum()), **fields)
        if errs[torch.float64] > gate:
            raise AssertionError(f"10a {model} n={n}: float64 {errs[torch.float64]:.3e} "
                                 f"from the CPU after {s_max} squarings (gate {gate:.3e})")
        worst32 = max(worst32, errs[torch.float32])
    if not worst32 <= PG_F32_SCALED:
        raise AssertionError(f"10a: the card's float32 solves drifted from the CPU: {worst32:.3e}")


class StageSpy:
    """Wraps normest's lane batches: the host seconds of each stage (each
    ends in its one host read), and the LM iterations run under
    set_sync_debug_mode("error"), so that a host read inside the loop
    fails the run."""

    def __init__(self):
        self.stages, self.calls = [], []
        self.real_run, self.real_loop = normest_mod._Lanes.run, normest_mod.lm_loop

    def __enter__(self):
        spy = self

        def run(lanes, *args, hessian):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = spy.real_run(lanes, *args, hessian=hessian)
            spy.stages.append((len(args[0]), -(-len(args[0]) // lanes.chunk),
                               time.perf_counter() - t0))
            spy.calls.append((lanes, args, hessian))
            return out

        def strict_loop(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return spy.real_loop(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        normest_mod._Lanes.run, normest_mod.lm_loop = run, strict_loop
        return self

    def __exit__(self, *exc):
        normest_mod._Lanes.run, normest_mod.lm_loop = self.real_run, self.real_loop


def lm_iteration_profile(lanes, args, hessian) -> dict:
    """Device events an LM iteration (the difference of a 3- and a
    1-iteration run of one stage's lanes, each under the profiler) and the
    3-iteration run's busy, wall and idle share."""
    real = lanes.lm_iters
    try:
        prof = {}
        for k in (1, 3):
            lanes.lm_iters = k
            prof[k] = profile_call(lambda: lanes.run(*args, hessian=hessian))
    finally:
        lanes.lm_iters = real
    return {"events_per_iteration": (prof[3]["device_events"] - prof[1]["device_events"]) // 2,
            "profile_3_iterations": prof[3]}


def pergene_cohort_fit(model: str, n: int, dt) -> tuple:
    """One 10b cohort through normest_batch at the defaults on the card:
    ({field: value} for its log line, the fits, the spy's stage calls)."""
    args = pergene_cohort(model, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StageSpy() as spy:
        fits = normest_batch(*args, model=model, device=PG_DEVICE, dtype=dt)
    wall = time.perf_counter() - t0
    errs = [f.error for f in fits.values()]
    if not np.all(np.isfinite(errs)) or len(spy.stages) != 2:
        raise AssertionError(f"10b {model} n={n} {dt}: a fit failed")
    (l1, c1, s1), (l2, c2, s2) = spy.stages
    fields = dict(model=model, n=n, dtype=str(dt).split(".")[-1], genes=PG_GENES,
                  n_params=n_params(model, n), w=state_dim(model, n) + 1,
                  stage1_lanes=l1, stage1_chunks=c1, stage1_ms=f"{1e3 * s1:.1f}",
                  stage1_ms_per_iteration=f"{1e3 * s1 / c1 / PG_LM_ITERS:.2f}",
                  stage2_lanes=l2, stage2_chunks=c2, stage2_ms=f"{1e3 * s2:.1f}",
                  stage2_ms_per_iteration=f"{1e3 * s2 / c2 / PG_LM_ITERS:.2f}",
                  wall_s=f"{wall:.2f}",
                  peak_gib=f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f}",
                  max_error=f"{max(errs):.3e}", median_error=f"{np.median(errs):.3e}")
    return fields, fits, spy.calls


def pergene_float64_job(models: tuple) -> tuple:
    """10b's float64 cohorts of ``models`` on the card, in a worker process
    beside the main process's float32 ones (each cohort but randmod's
    widest is host-bound), the widest site count last: the main process
    runs its own widest cohort first, so that the two device-bound runs do
    not overlap. Returns ([log fields], {model: fits at n = PG_CPU_SITES},
    {path: launches})."""
    torch.set_num_threads(1)
    order = [(m, n) for m in models for n in PG_COHORT_SITES]
    reset_counts()
    lines, fits_at = [], {}
    for model, n in order:
        fields, fits, _ = pergene_cohort_fit(model, n, torch.float64)
        lines.append(fields)
        if n == PG_CPU_SITES:
            fits_at[model] = fits
    return lines, fits_at, counts()


def phase_pergene_cohort(f64_jobs, card, after_f32=None) -> tuple[dict, dict]:
    """10b: for each model and n in PG_COHORT_SITES, a cohort of PG_GENES noise-free
    synthetic genes through normest_batch at the defaults (10 lambdas, the
    default weight library, 48 starts, 80 LM iterations, regularisation
    on): float32 here, float64 in worker processes on the card at the same
    time (``f64_jobs``): per stage the host ms, lanes and chunks, ms an LM
    iteration, peak memory; every LM loop under set_sync_debug_mode("error").
    randmod at n = 5, the one device-bound cohort, runs first here and last
    in its worker. Then, alone on the card, one stage-1 and one stage-2
    batch of each model at n = 5 (float32) profiled at 1 and 3 iterations
    (device events an iteration, idle share). Returns ({path: launches}, {model: the
    float64 card fits at n = PG_CPU_SITES})."""
    reset_counts()
    widest = {}
    order = [(m, n) for m in PG_MODELS for n in PG_COHORT_SITES]
    order.remove((PG_MODELS[-1], PG_COHORT_SITES[-1]))
    for model, n in [(PG_MODELS[-1], PG_COHORT_SITES[-1])] + order:
        fields, _, calls = pergene_cohort_fit(model, n, torch.float32)
        say("10b cohort", **fields, process="main, beside the float64 workers")
        if n == PG_COHORT_SITES[-1]:
            widest[model] = calls
    launches = counts()
    if after_f32 is not None:
        after_f32()
    f64_fits, f64_launches = {}, expect()
    for job in f64_jobs:
        lines, fits, job_launches = job.result()
        f64_fits.update(fits)
        f64_launches = {k: f64_launches[k] + v for k, v in job_launches.items()}
        for fields in lines:
            say("10b cohort", **fields, process="worker, beside the float32 cohorts")
    for model, calls in widest.items():
        for stage, call in zip(("stage1", "stage2"), calls):
            say("10b lm profile", model=model, n=PG_COHORT_SITES[-1], stage=stage,
                dtype="float32",
                lanes=len(call[1][0]), **lm_iteration_profile(*call))
    if launches != expect() or f64_launches != expect():
        raise AssertionError(f"10b: the per-gene cohorts launched {launches}, {f64_launches}")
    return {"pergene-10b-cohort-f32": launches, "pergene-10b-cohort-f64": f64_launches}, f64_fits


def rel_to(got, want) -> float:
    """max |got - want| / |want|, where a zero of ``want`` must be met
    exactly."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    diff = np.abs(got - want)
    if np.any(diff[want == 0] != 0):
        return float("inf")
    nz = want != 0
    return float(np.max(diff[nz] / np.abs(want[nz]), initial=0.0))


def check_pergene_cpu(futures, f64_fits, card) -> None:
    """10b's float64 card fits against the port's float64 CPU fits of the
    same genes: lambda and weight name equal, score and error within rel
    1e-6, params within rtol 1e-6 (the JAX package's batch-vs-single gate,
    tests/test_normest.py:155-156)."""
    for model, fut in futures.items():
        ref = fut.result()
        worst = 0.0
        for gene, want in ref["fits"].items():
            got = f64_fits[model][gene]
            if (got.lambda_reg, got.weight_name) != (want.lambda_reg, want.weight_name):
                raise AssertionError(f"10b {model} {gene}: lambda/weight differ from the CPU")
            worst = max(worst, rel_to(got.score, want.score), rel_to(got.error, want.error),
                        rel_to(got.params, want.params))
        say("10b card vs cpu", model=model, n=PG_CPU_SITES, genes=len(ref["fits"]),
            dtype="float64", max_rel=f"{worst:.3e}", tol=PG_CPU_RTOL,
            cpu_seconds=f"{ref['seconds']:.1f}", card=repr(card))
        if not worst <= PG_CPU_RTOL:
            raise AssertionError(f"10b {model}: the card's float64 fits differ from the CPU's "
                                 f"by {worst:.3e}")


def phase_pergene_recovery(card) -> dict:
    """10c: the JAX package's recovery gate (tests/test_normest.py:42-50):
    distmod, n = 2, seed 5, no regularisation, 24 starts, 120 iterations:
    float64 error < 1e-8 and params within rtol 5e-2 of the truth; float32
    printed and held to rtol 5e-2. Returns {path: launches}."""
    true, y0, pr, p, r = pergene_gene("distmod", 2, 5)
    reset_counts()
    for dt in (torch.float64, torch.float32):
        t0 = time.perf_counter()
        res = normest("GENEA", pr, p, r, y0, 2, PG_TIMES, PG_BOUNDS, model="distmod",
                      use_regularization=False, n_starts=24, lm_iters=120, device=PG_DEVICE,
                      dtype=dt)
        par = float(np.max(np.abs(res.params - true) / true))
        say("10c recovery", dtype=str(dt).split(".")[-1], error=f"{res.error:.3e}",
            error_gate=PG_RECOVERY_ERROR if dt == torch.float64 else "printed",
            max_rel_param_err=f"{par:.3e}", param_rtol=PG_RECOVERY_RTOL,
            seconds=f"{time.perf_counter() - t0:.2f}", card=repr(card))
        if par > PG_RECOVERY_RTOL or (dt == torch.float64 and not res.error < PG_RECOVERY_ERROR):
            raise AssertionError(f"10c: recovery missed at {dt}: error {res.error:.3e}, "
                                 f"params {par:.3e}")
    launches = counts()
    if launches != expect():
        raise AssertionError(f"10c: launched {launches}")
    return {"pergene-10c-recovery": launches}


def phase_pergene_pipeline(card) -> dict:
    """10d: run_model_pipeline on a column-dict cohort (distmod, one gene at
    each n = 1..5, knockouts on), then process_gene for one gene with
    Morris (the function's defaults: 200 trajectories x 40 levels) and 8
    bootstraps: seconds of each, Morris solves a second. Returns {path:
    launches}."""
    cols = {"prot": ([], [], []), "pho": ([], [], [], []), "rna": ([], [], [])}
    for n in PG_SITES:
        _, _, pr, p, r = pergene_gene("distmod", n, 500 + n)
        name = f"P{n}"
        for t, v in zip(PG_TIMES, pr):
            for col, x in zip(cols["prot"], (name, t, v)):
                col.append(x)
        for j in range(n):
            for t, v in zip(PG_TIMES, p[j]):
                for col, x in zip(cols["pho"], (name, f"S{j + 1}", t, v)):
                    col.append(x)
        for t, v in zip(PG_TIMES[5:], r):
            for col, x in zip(cols["rna"], (name, t, v)):
                col.append(x)
    df_p = dict(zip(("protein", "time", "fc"), map(np.asarray, cols["prot"])))
    df_ph = dict(zip(("protein", "psite", "time", "fc"), map(np.asarray, cols["pho"])))
    df_r = dict(zip(("protein", "time", "fc"), map(np.asarray, cols["rna"])))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_model_pipeline(df_p, df_ph, df_r, time_points=PG_TIMES,
                             rna_time_points=PG_TIMES[5:], bounds=PG_BOUNDS, model="distmod")
    wall = time.perf_counter() - t0
    if len(out) != len(PG_SITES) or not all(
            o.knockout_solutions is not None and np.isfinite(o.knockout_solutions).all()
            and np.isfinite(o.result.error) for o in out.values()):
        raise AssertionError("10d: the pipeline's outputs are incomplete or not finite")
    say("10d run_model_pipeline", genes=len(out), sites=PG_SITES, seconds=f"{wall:.2f}",
        knockouts=sum(len(o.knockout_labels) for o in out.values()),
        max_error=f"{max(o.result.error for o in out.values()):.3e}", card=repr(card))

    gene = "P3"
    _, _, pr, p, r = pergene_gene("distmod", 3, 503)
    morris = []
    real = pipeline_mod.sensitivity_analysis

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = real(*a, **kw)
        morris.append(time.perf_counter() - t1)
        return res

    pipeline_mod.sensitivity_analysis = timed
    try:
        t0 = time.perf_counter()
        res = process_gene(gene, pr, p, r, 3, PG_TIMES, PG_BOUNDS, model="distmod",
                           bootstraps=PG_BOOTSTRAPS, run_sensitivity=True)
        wall = time.perf_counter() - t0
    finally:
        pipeline_mod.sensitivity_analysis = real
    sens = res.sensitivity
    rows = len(sens.samples)
    if not (res.result.boot_params.shape == (PG_BOOTSTRAPS, n_params("distmod", 3))
            and np.isfinite(sens.Y).all() and np.isfinite(sens.morris.mu_star).all()):
        raise AssertionError("10d: process_gene's bootstrap or Morris output is wrong")
    say("10d process_gene", gene=gene, bootstraps=PG_BOOTSTRAPS, morris_rows=rows,
        seconds=f"{wall:.2f}", morris_seconds=f"{morris[0]:.3f}",
        morris_solves_per_s=f"{rows / morris[0]:.1f}",
        top_mu_star=sens.param_names[int(np.argmax(sens.morris.mu_star))], card=repr(card))
    launches = counts()
    if launches != expect():
        raise AssertionError(f"10d: launched {launches}")
    return {"pergene-10d-pipeline": launches}


def phase_pergene(card) -> dict:
    """10: the per-gene stack. Spawned worker processes, started together,
    run 10b's float64 cohorts on the card (randmod in one, distmod and
    succmod in another) and make 10a's float64 CPU references and 10b's
    float64 CPU fits, beside the main process's work; 10a is checked after
    the float32 cohorts."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    t0 = time.perf_counter()
    draws = pergene_draws()
    pool = ProcessPoolExecutor(max_workers=PG_WORKERS, mp_context=get_context("spawn"))
    try:
        f64_jobs = [pool.submit(pergene_float64_job, models)
                    for models in (("randmod",), ("distmod", "succmod"))]
        refs = {key: pool.submit(pergene_solve_job, P, *key) for key, P in draws.items()}
        futures = {m: pool.submit(pergene_cpu_job, m) for m in PG_MODELS}
        paths, solves = phase_pergene_solves(draws, card)
        cohort_paths, f64_fits = phase_pergene_cohort(
            f64_jobs, card, after_f32=lambda: check_pergene_solves(draws, solves, refs))
        paths.update(cohort_paths)
        check_pergene_cpu(futures, f64_fits, card)
    finally:
        pool.shutdown(cancel_futures=True)
    paths.update(phase_pergene_recovery(card))
    paths.update(phase_pergene_pipeline(card))
    say("10 per-gene", seconds=f"{time.perf_counter() - t0:.1f}", card=repr(card))
    return paths


def kinopt_synthetic(n_sites: int, n_kinases: int, rows: int, per_site: int, seed: int = 0):
    """``benchmarks/bench_suite.py:250-256``'s kinopt generator: ``rows``
    source rows a kinase, ``per_site`` kinases a site (consecutive, mod
    n_kinases), Dirichlet betas, each site the mean of its kinases'
    signals (so alpha = 1 / per_site fits exactly), T = 14."""
    rng = np.random.default_rng(seed)
    K_array = rng.uniform(0.5, 2.0, (rows * n_kinases, 14))
    kinase_rows = [list(range(rows * j, rows * j + rows)) for j in range(n_kinases)]
    site_kinases = [[(j + k) % n_kinases for k in range(per_site)] for j in range(n_sites)]
    beta = rng.dirichlet(np.ones(rows), n_kinases)
    sig = np.stack([beta[j] @ K_array[kinase_rows[j]] for j in range(n_kinases)])
    P_obs = np.stack([np.mean(sig[s], axis=0) for s in site_kinases])
    return kinopt_build_problem(P_obs, site_kinases, kinase_rows, K_array)


def tfopt_synthetic(n_genes: int, n_tf: int, n_reg: int, max_ps: int, seed: int = 0):
    """``tests/test_kinopt_tfopt.py:110-133``'s tfopt generator scaled:
    ``n_reg`` distinct regulators a gene, 0..``max_ps`` psites a TF,
    Dirichlet weights, mRNA from the model at the true weights, T = 9 (the
    reference's mRNA grid)."""
    T = 9
    rng = np.random.default_rng(seed)
    protein = rng.uniform(0.5, 2.0, (n_tf, T))
    num_psites = rng.integers(0, max_ps + 1, n_tf).astype(np.int32)
    psites = rng.uniform(0.2, 1.5, (n_tf, max_ps, T))
    psites *= (np.arange(max_ps)[None, :] < num_psites[:, None])[..., None]
    regulators = np.stack([rng.choice(n_tf, n_reg, replace=False)
                           for _ in range(n_genes)]).astype(np.int32)
    beta = np.zeros((n_tf, 1 + max_ps))
    for f in range(n_tf):
        beta[f, :1 + num_psites[f]] = rng.dirichlet(np.ones(1 + num_psites[f]))
    alpha = rng.dirichlet(np.ones(n_reg), n_genes)
    effect = beta[:, :1] * protein + np.einsum("fk,fkt->ft", beta[:, 1:], psites)
    mRNA = np.einsum("gr,grt->gt", alpha, effect[regulators])
    return TfoptProblem(mRNA, regulators, protein, psites, num_psites)


class TimedCalls:
    """Wraps the first argument (the evaluate callable) of ``module.name``
    so that the host clock inside it adds up: what a host route spends
    evaluating on the device (its calls return numpy, so each ends in a
    read), against the whole generation."""

    def __init__(self, module, name: str | None):
        self.module, self.name, self.seconds, self.calls = module, name, 0.0, 0
        self.real = getattr(module, name) if name else None

    def __enter__(self):
        if self.name is None:
            return self

        def wrapped(evaluate, *a, **kw):
            def timed(X):
                t0 = time.perf_counter()
                out = evaluate(X)
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                return out
            return self.real(timed, *a, **kw)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        if self.name is not None:
            setattr(self.module, self.name, self.real)


def per_unit_events(run, n: int) -> dict:
    """Device events a unit (an Adam step or a generation) and the idle
    share: ``run(k)`` makes k units after a fixed set-up, profiled at k = 0
    and k = n; the events a unit are the difference over n, the idle share
    the k = n call's."""
    base, _ = device_events(lambda: run(0))
    events, wall_ms = device_events(lambda: run(n))
    s = summarize_events(events, wall_ms)
    return {"events_per_unit": f"{(len(events) - len(base)) / n:.1f}",
            "idle_share": s.get("idle_share", "not measured")}


def timed_run(fn):
    """(result, seconds, peak GiB) of ``fn()`` on the card, ended by a
    synchronize."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 30


def kinopt_local_cpu_job(problem: tuple, kw: dict):
    """run_local of a kinopt problem at float64 on the CPU (a worker
    process), the card's float64 reference."""
    torch.set_num_threads(1)
    res = kinopt_run_local(kinopt_synthetic(*problem), device="cpu", **kw)
    return res.loss, res.all_losses, res.alpha, res.beta


def sensitivity_cpu_job(hb: dict, theta, kw: dict):
    """run_sensitivity_analysis at float64 on the CPU (a worker process)."""
    torch.set_num_threads(1)
    system = GlobalSystem(hb["topo"], hb["kin_grid"], hb["Kmat"], dtype=torch.float64,
                          device="cpu")
    out = run_sensitivity_analysis(system, hb["slices"], theta, SENS_TIMES_F64, **kw)
    return out.morris, out.Y


def rel_over(d_abs, denom) -> float:
    """The largest ``d_abs / denom``: 0 where both are 0 (a parameter of no
    effect on either side), inf where only the denominator is."""
    safe = np.where(denom > 0, denom, 1.0)
    return float(np.max(np.where(denom > 0, d_abs / safe, np.where(d_abs > 0, np.inf, 0.0))))


def phase_kinopt(card, pool) -> dict:
    """11a: kinopt on the bench problem and on the scaled one: run_local
    (48 starts, 800 steps), DE (pop 100, 200 generations), NSGA-II on the
    host and all-device (pop 100, 50 generations, blocks of 10): ms a step
    or generation, device events a unit and idle share, loss, feasible,
    peak memory; no hand-written kernel launched. Float64 on the card
    against the CPU: run_local's loss (1e-9 relative), one de_generation on
    the same draws (1e-12); kkt_check at the local optimum. Returns {path:
    launches}."""
    ref = pool.submit(kinopt_local_cpu_job, KINOPT_PROBLEMS["bench"], KINOPT_LOCAL)
    paths = {}
    for label, spec in KINOPT_PROBLEMS.items():
        prob = kinopt_synthetic(*spec)
        n = prob.n_alpha + prob.n_beta
        say("11a kinopt", problem=label, sites=prob.n_gp, kinases=prob.n_k,
            n_params=n, card=repr(card))
        reset_counts()
        res, sec, peak = timed_run(lambda: kinopt_run_local(prob, **KINOPT_LOCAL))
        gm, km = torch.as_tensor(prob.gp_mask, device="cuda"), torch.as_tensor(
            prob.k_mask, device="cuda")
        A0 = torch.as_tensor(np.stack([prob.gp_mask / prob.gp_mask.sum(1, keepdims=True)]
                                      * KINOPT_LOCAL["n_starts"]), dtype=torch.float32,
                             device="cuda")
        B0 = torch.as_tensor(np.stack([prob.k_mask / prob.k_mask.sum(1, keepdims=True)]
                                      * KINOPT_LOCAL["n_starts"]), dtype=torch.float32,
                             device="cuda")
        ev = per_unit_events(lambda k: constrained.projected_adam(
            lambda x: kinopt_loss(prob, x[0], x[1]), (A0, B0),
            lambda x: (constrained.project_sum_box(x[0], prob.lb, prob.ub, gm),
                       constrained.project_sum_box(x[1], prob.lb, prob.ub, km)), steps=k), 3)
        if not (np.isfinite(res.loss) and res.feasible):
            raise AssertionError(f"11a {label}: run_local loss {res.loss}, "
                                 f"feasible {res.feasible}")
        say("11a run_local", problem=label, starts=KINOPT_LOCAL["n_starts"],
            steps=KINOPT_LOCAL["steps"], ms_per_step=f"{1e3 * sec / KINOPT_LOCAL['steps']:.3f}",
            device_events_per_step=ev["events_per_unit"], idle_share=ev["idle_share"],
            loss=f"{res.loss:.6e}", feasible=res.feasible, peak_gib=f"{peak:.3f}",
            seconds=f"{sec:.2f}", card=repr(card))
        for method, gpd, n_gen in (("DE", 1, 200), ("NSGA-II", 1, 50), ("NSGA-II", 10, 50)):
            route = "DE" if method == "DE" else ("NSGA-II device" if gpd > 1
                                                else "NSGA-II host")
            run = lambda k: kinopt_run_evolutionary(prob, method=method, pop_size=100,
                                                    n_gen=k, seed=0, gens_per_dispatch=gpd)
            host_route = route == "NSGA-II host"
            with TimedCalls(kinopt_opt, "run_nsga2" if host_route else None) as timer:
                res, sec, peak = timed_run(lambda: run(n_gen))
            if not np.isfinite(res.loss) or (method == "DE" and not res.feasible):
                raise AssertionError(f"11a {label} {route}: loss {res.loss}, "
                                     f"feasible {res.feasible}")
            ev = per_unit_events(run, gpd if gpd > 1 else 3)
            host = {"host_share": f"{1 - timer.seconds / sec:.3f}"} if host_route else {}
            say("11a evolutionary", problem=label, route=route, pop=100, gens=n_gen,
                ms_per_gen=f"{1e3 * sec / n_gen:.3f}",
                device_events_per_gen=ev["events_per_unit"], idle_share=ev["idle_share"],
                **host, loss=f"{res.loss:.6e}", feasible=res.feasible,
                peak_gib=f"{peak:.3f}", card=repr(card))
        launches = counts()
        if launches != expect():
            raise AssertionError(f"11a {label}: launched {launches}")
        paths[f"kinopt-{label}"] = launches

    # float64 on the card against the CPU
    prob = kinopt_synthetic(*KINOPT_PROBLEMS["bench"])
    res64 = kinopt_run_local(prob, dtype=torch.float64, **KINOPT_LOCAL)
    loss_cpu, losses_cpu, _, _ = ref.result()
    rel = abs(res64.loss - loss_cpu) / abs(loss_cpu)
    rel_all = float(np.max(np.abs(res64.all_losses - losses_cpu) / np.abs(losses_cpu)))
    if rel > KINOPT_F64_RTOL:
        raise AssertionError(f"11a: float64 run_local on the card vs the CPU: {rel:.3e}")
    flat_c, flat_g = (kinopt_opt._Flat(prob, torch.device(d)) for d in ("cpu", "cuda"))
    n = prob.n_alpha + prob.n_beta
    gen = torch.Generator().manual_seed(11)
    xl, xu = torch.full((n,), prob.lb, dtype=torch.float64), torch.full((n,), prob.ub,
                                                                        dtype=torch.float64)
    X = flat_c.repair(xl + de_init_draws(gen, 100, n, torch.float64) * (xu - xl))
    f = kinopt_loss(prob, *flat_c.padded(X))
    draws = de_draws(gen, 100, n)
    want = de_generation(X, f, draws, lambda Z: kinopt_loss(prob, *flat_c.padded(Z)), xl, xu,
                         repair_fn=flat_c.repair)
    g = lambda t: t.cuda()
    got = de_generation(g(X), g(f), DEDraws(*map(g, draws)),
                        lambda Z: kinopt_loss(prob, *flat_g.padded(Z)), g(xl), g(xu),
                        repair_fn=flat_g.repair)
    de_err = max(float(torch.max(torch.abs(a.cpu() - b))) for a, b in zip(got, want))
    if de_err > DE_F64_ATOL:
        raise AssertionError(f"11a: de_generation float64 card vs CPU: {de_err:.3e}")
    rep = kinopt_kkt_check(prob, res64.alpha, res64.beta,
                           lambda a, b: kinopt_loss(prob, a, b))
    if not rep.primal_feasible:
        raise AssertionError(f"11a: KKT primal infeasible ({rep.max_violation:.3e})")
    say("11a float64", run_local_rel_err=f"{rel:.3e}", per_start_max_rel_err=f"{rel_all:.3e}",
        gate=KINOPT_F64_RTOL, de_generation_max_abs_err=f"{de_err:.3e}", de_gate=DE_F64_ATOL,
        kkt_primal_feasible=rep.primal_feasible, kkt_max_violation=f"{rep.max_violation:.3e}",
        kkt_stationarity_residual=f"{rep.stationarity_residual:.3e}",
        kkt_active_box=rep.n_active_box, card=repr(card))
    return paths


def phase_tfopt(card) -> dict:
    """11b: tfopt on the scaled generator (500 genes, 100 TFs, 4 regulators
    a gene, 0-6 psites a TF; pop = min(2n, 400)): run_local, then
    optimizers 0 (host and all-device, blocks of 10), 1 and 2 for 20
    generations each: seconds a generation, loss, the pick's feasibility,
    the host share of a generation on the host routes; no hand-written
    kernel launched. Returns {path: launches}."""
    prob = tfopt_synthetic(*TFOPT_PROBLEM)
    n = prob.n_alpha + prob.n_beta
    pop = min(2 * n, 400)
    say("11b tfopt", genes=prob.n_genes, tfs=prob.n_TF, n_params=n, pop=pop, card=repr(card))
    reset_counts()
    res, sec, peak = timed_run(lambda: tfopt_run_local(prob, **TFOPT_LOCAL))
    if not np.isfinite(res.loss):
        raise AssertionError(f"11b: run_local loss {res.loss}")
    say("11b run_local", starts=TFOPT_LOCAL["n_starts"], steps=TFOPT_LOCAL["steps"],
        ms_per_step=f"{1e3 * sec / TFOPT_LOCAL['steps']:.3f}", loss=f"{res.loss:.6e}",
        feasible=res.feasible, peak_gib=f"{peak:.3f}", seconds=f"{sec:.2f}", card=repr(card))
    for opt, gpd, host_fn in ((0, 1, "run_unsga3"), (0, 10, None), (1, 1, "run_smsemoa"),
                              (2, 1, "run_agemoea")):
        with TimedCalls(tfopt_opt, host_fn) as timer:
            res, sec, peak = timed_run(lambda: tfopt_run_evolutionary(
                prob, optimizer=opt, n_gen=TFOPT_GENS, seed=0, gens_per_dispatch=gpd))
        if not np.isfinite(res.loss):
            raise AssertionError(f"11b: optimizer {opt} loss {res.loss}")
        host = {"host_share": f"{1 - timer.seconds / sec:.3f}"} if host_fn else {}
        say("11b evolutionary", optimizer=opt, route="device" if gpd > 1 else "host",
            gens=TFOPT_GENS, s_per_gen=f"{sec / TFOPT_GENS:.4f}", **host,
            loss=f"{res.loss:.6e}", pick_feasible=res.feasible, peak_gib=f"{peak:.3f}",
            card=repr(card))
    launches = counts()
    if launches != expect():
        raise AssertionError(f"11b: launched {launches}")
    return {"tfopt": launches}


def phase_sensitivity(b2, card, pool) -> dict:
    """11c: run_sensitivity_analysis on the model-2 bench network (N = 45, w
    = 17), 2 trajectories (2 (d + 1) solves) in one batch at float32 over
    the bundle's grid: solves a second, RK45 iterations, the flux launches
    (7 an iteration plus 2), the idle share of a profiled run to t = 4;
    then the demo network at N = 10, model 2, float64: Morris mu,
    mu*, sigma on the card against the CPU's (1e-9, relative to the index
    or to the parameter's mu*, the larger). Returns {path: launches}."""
    b10 = build_demo_network(10, 4, model=2, seed=0, dtype=torch.float64, device="cpu")
    hb10 = host_bundle(b10)
    kw10 = dict(n_trajectories=3, seed=0)
    ref = pool.submit(sensitivity_cpu_job, hb10, b10["theta_true"], kw10)
    d = len(b2["theta_true"])
    steps = []
    real = sens_mod.simulate_batched

    def spy(*a, **kw):
        res = real(*a, **kw)
        steps.append(int(res.n_steps.max()))
        return res

    sens_mod.simulate_batched = spy
    try:
        reset_counts()
        out, sec, peak = timed_run(lambda: run_sensitivity_analysis(
            b2["system"], b2["slices"], b2["theta_true"], b2["grid"], n_trajectories=2,
            batch_size=2 * (d + 1)))
        launches = counts()
    finally:
        sens_mod.simulate_batched = real
    if launches != expect(hypercube_flux=7 * steps[0] + 2) or len(steps) != 1:
        raise AssertionError(f"11c: launched {launches} over {steps} iterations")
    if not (np.isfinite(out.Y).all() and np.isfinite(out.morris.mu_star).all()):
        raise AssertionError("11c: the Morris outputs are not finite")
    short = profile_call(lambda: run_sensitivity_analysis(
        b2["system"], b2["slices"], b2["theta_true"], SENS_TIMES_PROFILE, n_trajectories=2,
        batch_size=2 * (d + 1)), "hypercube")
    say("11c sensitivity", N=b2["topo"].N, w=b2["topo"].width, d=d, solves=len(out.Y),
        seconds=f"{sec:.2f}", solves_per_s=f"{len(out.Y) / sec:.1f}", rk45_iterations=steps[0],
        hypercube_flux_launches=launches["hypercube_flux"],
        ms_per_iteration=f"{1e3 * sec / steps[0]:.3f}", peak_gib=f"{peak:.3f}",
        profiled_to_t4_idle_share=short.get("idle_share"),
        profiled_to_t4_device_events=short["device_events"],
        flux_device_us=short.get("hypercube_device_us"), card=repr(card))
    system64 = GlobalSystem(hb10["topo"], hb10["kin_grid"], hb10["Kmat"],
                            dtype=torch.float64, device="cuda")
    got = run_sensitivity_analysis(system64, hb10["slices"], b10["theta_true"],
                                   SENS_TIMES_F64, **kw10)
    want, Y_cpu = ref.result()
    errs, own = {}, {}
    for k in ("mu", "mu_star", "sigma"):
        a, w = getattr(got.morris, k), getattr(want, k)
        d_abs = np.abs(a - w)
        # gated: relative to the index or, where larger, to the size of the
        # parameter's elementary effects (mu*), which carry the rounding of
        # Y: sigma of effects that agree to 1% is a difference of nearly
        # equal numbers, its own relative error 1e2 that of the effects
        errs[k] = rel_over(d_abs, np.maximum(np.abs(w), want.mu_star))
        # printed: relative to the index alone, floored at 1e-3 of the largest
        own[k] = rel_over(d_abs, np.maximum(np.abs(w), 1e-3 * np.abs(w).max()))
    say("11c float64", N=10, d=len(b10["theta_true"]), solves=len(Y_cpu),
        Y_max_rel_err=f"{float(np.max(np.abs(got.Y - Y_cpu) / np.abs(Y_cpu))):.3e}",
        **{f"{k}_err": f"{v:.3e}" for k, v in errs.items()}, gate=SENS_F64_RTOL,
        **{f"{k}_own_rel_err": f"{v:.3e}" for k, v in own.items()}, card=repr(card))
    for k, v in errs.items():
        if not v <= SENS_F64_RTOL:
            raise AssertionError(f"11c: float64 Morris {k} card vs CPU: {v:.3e}")
    return {"sensitivity-model2": launches}


def phase_sensitivity_kinopt(card, b2) -> dict:
    """11: kinopt (11a), tfopt (11b) and the network sensitivity (11c); the
    CPU references in spawned worker processes beside them."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(max_workers=2, mp_context=get_context("spawn"))
    try:
        paths = phase_kinopt(card, pool)
        paths.update(phase_tfopt(card))
        paths.update(phase_sensitivity(b2, card, pool))
    finally:
        pool.shutdown(cancel_futures=True)
    say("11 kinopt/tfopt/sensitivity", seconds=f"{time.perf_counter() - t0:.1f}",
        card=repr(card))
    return paths


def population(b, pop: int) -> torch.Tensor:
    """theta0 plus seeded noise, as bench.py and benchmarks/model_rates.py."""
    rng = np.random.default_rng(0)
    return torch.as_tensor(
        b["theta0"][None] + 0.05 * rng.normal(size=(pop, len(b["theta0"]))),
        dtype=torch.float32, device="cuda")


def main() -> int:
    card = phase_device()
    if "--pergene-only" in sys.argv[1:]:
        phase_pergene(card)
        say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
        return 0
    if "--sensitivity-kinopt-only" in sys.argv[1:]:
        phase_build()
        b2 = build_demo_network(N_PROTEINS, N_KINASES, model=2, seed=0, dtype=torch.float32,
                                device="cuda")
        phase_sensitivity_kinopt(card, b2)
        say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
        return 0
    phase_build()
    probe, probe_paths = phase_fma_peak(card)
    t0 = time.perf_counter()
    b, b1, b2 = (build_demo_network(N_PROTEINS, N_KINASES, model=m, seed=0,
                                    dtype=torch.float32, device="cuda") for m in (0, 1, 2))
    thetas, thetas1, thetas2 = population(b, POP), population(b1, POP2), population(b2, POP2)
    for bb in (b, b1, b2):
        topo = bb["topo"]
        say("setup", model=topo.model, N=topo.N, K=topo.K, w=topo.width,
            n_theta=len(bb["theta0"]), T=len(bb["grid"]))
    say("setup", seconds=f"{time.perf_counter() - t0:.2f}")
    kernel = phase_kernel(b, thetas, card)
    wide = phase_wide_kernel(b2, thetas2, card)
    scan = phase_scan_kernel(b, thetas, b2, thetas2, card)
    flux = phase_flux_kernel(card)
    thomas = phase_thomas_kernel(card)
    f64_entries, paths64 = phase_float64(b, thetas, b2, thetas2, card)
    paths = {"model0-pop8192": phase_main_path(b, thetas, card),
             "model2-pop2048": phase_main_path_model2(b2, thetas2, card),
             **phase_scan_paths(b, thetas, b2, thetas2, card)}
    rk45_paths, F_rk45 = phase_rk45_path(b2, thetas2, card)
    paths.update(rk45_paths)
    pool, futures = start_rk45_workers(b, b1, b2, thetas, thetas1, thetas2)
    try:
        phase_accuracy(b)
        phase_accuracy(b, use_scan_kernel=True)
        phase_precision_model2(b2)
        paths.update(phase_steady_states(b1))
    except BaseException:
        pool.shutdown(cancel_futures=True)
        raise
    finish_rk45_workers(pool, futures, F_rk45, {0: lsoda_fold_changes(b),
                                                 2: lsoda_fold_changes(b2)}, card)
    paths.update(phase_global_fit(b, card))
    model4_paths, b4 = phase_model4(card)
    paths.update(model4_paths)
    paths.update(phase_esdirk(b, b2, thetas, thetas2, card))
    phase_expo(b, b4, thetas, card)
    paths.update(phase_gradients(b, thetas, card))
    paths.update(phase_polish(b, thetas, card))
    paths.update(phase_lm(b, card))
    paths.update(phase_gradient_fits(b, card))
    paths.update(phase_pergene(card))
    paths.update(phase_sensitivity_kinopt(card, b2))
    for group, group_paths in (([kernel, wide, scan, flux, thomas], paths),
                               (f64_entries, paths64), ([probe], probe_paths)):
        for entry in group:
            counter = entry.pop("counter", entry["name"])
            entry["launches_by_path"] = {p: n[counter] for p, n in group_paths.items()}
            entry["launches"] = sum(entry["launches_by_path"].values())
            if not entry["launches"]:
                raise AssertionError(f"{entry['name']}: no launch on its main path")
    entries = [kernel, wide, scan, flux, thomas, probe, *f64_entries]
    say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
