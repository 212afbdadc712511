"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the script exits
non-zero:

1. device: the card, its power limit, CUDA and nvcc versions; full-float32
   matmuls (TF32 off);
2. build: compile the seven hand-written kernel sources from
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
4d. (its float64 CPU run starts before phase 4, in a worker of its own)
   main path, RK45: ``make_objective(solver="rk45")`` on the model-2
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
   parameters) at pop 10,000, by the all-device loop (``gens_per_dispatch=3``,
   one block; two blocks of 5 before phase 14 came in, one of 5 before
   phases 3h and 16) and by the default route (device
   variation, host survival)
   for 1 generation (2 before phase 12 came in): launches, evals/s,
   seconds a generation, the ideal
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
   model-2 bench network (d = 765) at pop 16 and on model 0 at pop 32:
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
9b. ``polish_solutions`` on 32 members for 10 steps: no member worse than
   its input under its own weights, every member inside [xl, xu], ms a
   step, one table launch (the final scoring);
9c. the LM finish from the true parameters perturbed by 2%, zero-residual
   (``r_offset``): sum(r**2) against F.sum() (rel 2e-4 float32, 1e-9
   float64), ms a forward-mode Jacobian (329 tangents in chunks of 256),
   ``lm_refine_mixed`` (8 float32 iterations, no worse than the input,
   then 6 at float64 on the card, ending below 1e-3 x the float32 sse),
   ms an iteration, the largest relative parameter error (printed);
9d. ``run_global_fit`` at pop 256 for 2 generations with
   ``polish_steps=10`` and ``gn_iters=2``, and ``optimizer="gradient"`` at
   pop 32 (100 steps): ``n_evals`` by the JAX package's bookkeeping, the
   Pareto set the first front of every member (a polished member in it),
   the table launches, each stage's seconds.

Phases 10, 11, 12 and 3j run one after the other in a side lane, a spawned
worker process on the card started after phase 6, beside phases 7-9 and 13
in the main process (its lines carry the main process's clock; phase 15
reads phase 11's fits from it), so "this process" below is that worker and
its timings are taken with the main process's work on the card too. 3j
runs beside phase 13: its float32 stream-kernel calls hold the whole card
for ~1.7 s each, so both phases' seconds are taken under the other's load
(``--runner-only`` and ``--stream-only`` take each alone).

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
10b. for each mechanism and n = 2 and 5 (1, 3 and 4 cut as phases 11 and
   12 came in), 8 noise-free synthetic genes (the
   JAX package's ``synth_gene`` recipe) through ``normest_batch`` at the
   defaults (10 lambdas, the default weight library, 48 starts, 80 LM
   iterations, regularisation on), float32 in this process and float64
   in two worker processes on the card at the same time (the cohorts are
   host-bound; randmod at n = 5, the one device-bound cohort, runs first
   here and last in its worker): each stage's host ms, lanes, chunks and
   ms an iteration, peak memory, the LM loops under
   ``set_sync_debug_mode("error")``; at n = 5 (float32, after the cohorts)
   each stage profiled at 1 and 3 iterations (device events an iteration,
   idle share); the float64 card fits of n = 2 against the port's float64
   CPU fit of one of its genes, made in worker processes (the same lambda
   and weight, score, error and params within 1e-6);
10c. (10c and 10d run while 10b's float64 cohorts run in their workers)
   the JAX package's recovery gate (distmod, n = 2, seed 5, no
   regularisation, 24 starts, 120 iterations): float64 error < 1e-8 and
   params within rtol 5e-2; float32 printed and held to rtol 5e-2;
10d. ``run_model_pipeline`` on a column-dict cohort (distmod, one gene a
   site count 1..3, knockouts on) on its default device, then
   ``process_gene`` with Morris (200 x 40) and 8 bootstraps: seconds, Morris
   solves a second.

kinopt, tfopt and the network sensitivity (plain PyTorch but for the flux
kernel on the sensitivity path; the CPU references in two spawned worker
processes):

11a. kinopt on the bench generator's problem (30 sites, 5 kinases of 4
   source rows) and at 1,000 sites, 100 kinases, 3 kinases a site (n =
   3,400): ``run_local`` (48 starts, 200 steps), DE (pop 100, 50
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

The data-in layer, the loss-weight scan and MOTPE, on the bench network
(model 0, N = 45, 329 parameters) read back from input files; every
objective call launches ``phi_tables``:

12a. the bench bundle written with the csv module as the reference's
   inputs (input1 GeneID/Psite/x1..x14, input2 with {kinase} sets, input3
   x1..x9, input4 Source/Target, the kinopt Alpha sheet's CSV sibling, a
   config.toml at the JAX defaults but ``use_initial_condition_from_data``),
   loaded by ``PhosKinConfig.from_toml`` and ``load_data``: the
   observations equal to the bundle's within 1 ulp, matched by (protein,
   psite, time), ``build_topology`` of the loaded tables equal to the
   demo's (proteins, sites, kinases, ``W_pad``); then the problem as the
   runner builds it: the kinase input from the data, uniform weights, the
   float32 system on the card, ``build_y0_from_data``, the loss data, the
   bio bounds and the raw parameters;
12b. (after 12c's float32 run, beside 12d's two worker processes)
   ``run_hyperparameter_scan`` (expo) at the config's sizing, 20 trials x
   15 generations x pop 64, reports every 5, with a checkpoint: one
   ``phi_tables`` launch an evaluation of every trial, seconds a trial, ms
   a generation, the pruned; one trial's GA profiled (idle share); then
   resumed to 22 trials (20 loaded, 2 run);
12c. ``run_global_fit(optimizer="optuna")`` at float32 for 160 trials (the
   config's 1,000 cut: the host ask grows with the history) with the
   Fréchet pick: ms an ask batch on the host beside ms an evaluation, the
   host share, one launch an evaluation; float64 on the card against the
   CPU at 48 trials: X identical, F within 1e-9;
12d. ``simulate_and_measure`` (RK45, up to the config's ``ode_max_steps``:
   the pick of a short MOTPE run is stiff) of the pick at float64 on the
   card against the CPU's float64, rel 1e-3, both in worker processes
   started after 12c's float32 run and read after 12b.

The entry points (``python -m phoskintime_tpu_torch``), on the bench
network written as input files:

13a. in subprocesses: ``python -m phoskintime_tpu_torch --help`` (exit 0,
   every subcommand) and an import of the CLI, the runner, the exporters,
   the influence analysis and the report layer (its drawing layer, the
   plotter and the dashboard included) that loads no JAX, JAX package,
   pandas, matplotlib, PIL, plotly, streamlit, sklearn or seaborn (the
   fit panels, the embeddings and the diagram imported too);
13b. ``global-model`` through ``cli.main`` in this process at the
   reference's pop 300, 5 generations (cut from 1,000), 1 Morris
   trajectory (cut from 100), no polish: ``phi_tables`` launched once an
   objective call (a chunk of 2048) plus once for the Fréchet pick, once
   for the trajectory export and once for the global knockout explorer
   (its K + 1 scenarios one batched ETD2RK call), no other kernel; the
   written file set (``runner_files``, the one the CPU tests hold: the
   tables, ``pareto_interactive.html``, ``report.html``,
   ``influence/{influence_network,global_knockouts,live_explorer}.html``,
   the dashboard bundle and the figures: one ``ts_<protein>.png`` a
   protein of any modality, the ``gof_sol<id>.png`` of the top ids, the
   heatmap at up to 200 parameters, the S-rate PDF, the convergence
   figures, the animation and the Pareto figures); every PNG checked by
   the script's own decoder (signature, each chunk's CRC, IHDR against
   the inflated length), the PDF's cross-reference and page count and the
   GIF's frame count against what the run implies, ``report.html``
   embedding each PNG, the bundle's front equal to the written ``.npy``
   files, ``render_dashboard`` of the bundle writing ``dashboard.html``
   with its three PNGs; the seconds of each figure writer and the runner's
   ``figures`` total;
   the knockout explorer's float32 fold changes against the same call at
   float64 on the CPU (rel 1e-3, |fc| floored at 1e-6);
   ``live_explorer.html`` equal to the page written from a CPU copy of the
   system (its payload is host data); the seconds of each HTML writer;
   the written front's F
   against a float64 re-evaluation of its X on the card (rel 1e-3); the
   written trajectories at the pick against a float64
   ``simulate_and_measure`` on the card run to the config's
   ``ode_max_steps`` and succeeding (1e-3 of each column's largest value,
   at the times the runner's float32 solve reached before RK45's
   5,000-step cap; the rows left out printed); the pick's solve ended or
   stopped at that cap, failing no other way; a row a protein in
   ``steady_state_check.csv``; finite Morris arrays; the seconds of each
   runner stage; every RK45 solve graphed (``simulate_batched`` replays
   a CUDA graph on the card), and the graphed loop bit for bit against
   the eager one at the pick over 200 passes, ms a pass of each (the
   graphed one's capture included);
13c. ``mechanisms`` (models 0 1 2 4, pop 48, 3 generations, cut from 25)
   through ``cli.main`` in a spawned worker beside 13b, which reads its own
   counts: ``phi_tables`` and ``phi_tables_wide`` once a width class an
   objective call and for each Fréchet pick, ``hypercube_flux`` 7 times an
   iteration plus 2 in model 2's RK45 simulation of its pick; each
   mechanism's pick solve printed with its success, and none failing but
   by the 5,000-step cap (the JAX package ranks such a pick on its
   truncated predictions too); four rows with finite AIC and BIC and
   Akaike weights summing to 1 (1e-6); the two overlays decoded, at
   their predicted pixel size; ``mechanism_selection.html``
   written, naming the best mechanism and holding the written
   ModelSelection table as ``table_html`` renders it.

The fit commands' figures (``report/plotter.py``, ``report/diagram.py``,
``analysis/fitpanels.py``, ``analysis/embed.py``, the readout, KKT and scan
figures; drawn on the host, no kernel):

14. (in a spawned worker on the card, beside phases 13 and 15: it
   launches no kernel and is host-bound) on the bench inputs of phases
   12-13 (the same files, config.toml with
   the weight fits' sections), each through ``cli.main`` on the card with
   the counts set to 0 just before and read just after: ``model`` on two
   genes of 1 and 2 sites (two one-gene cohorts), ``model`` on a gene of
   3 sites with ``--bootstraps 8 --sensitivity`` (every figure
   ``process_gene`` draws: the diagram, fit, GOF, KLD, state grid, phase
   space, CI bars, PCA, parallel coordinates, knockouts, Morris,
   perturbation cloud), ``kinopt`` and ``tfopt --mode local`` (their
   fit-analysis panels with t-SNE, the readout figures, the KKT report),
   ``fitanalysis --which kinopt|tfopt`` from the CSV sheets they wrote:
   no kernel launched by any; each command's written files equal to the
   set derived from its run (``model_files``, ``weight_fit_files``,
   ``panel_files``, which the CPU tests hold against the CPU's runs);
   every PNG through the script's own decoder; each model folder's
   ``report.html`` embedding each of its PNGs; each figure writer's calls
   and seconds and each command's seconds. 12b's scan writes its report
   (``scan_results_trials.csv`` and the history, importance and
   parallel-coordinate plots, each PNG decoded) with its launches as
   before.

Part 3 of the report layer (``analysis/thermal.py``, ``report/apps.py``,
``report/schematic.py``, ``analysis/network_tools.py``; the float64 CPU
references of 15a and 15b in two spawned workers started before phase 13):

15a. ``compare_thermal_standard`` on the model-0 bench network at its true
   parameters (Tm seeded in [36, 44] C): float32 on the card, each
   temperature's RK45 steps and whether it stopped at the 5,000-step cap
   (read by a spy on ``simulate_batched``), float64 on the card against
   the CPU's within 1e-9 of the largest fold change, the float32 result's
   distance from it, ``thermal_comparison.png`` decoded at its size; no
   launch;
15b. the thermal system at 39 C through the batched ETD2RK path at
   float32 on the card: model 0 against a float64 RK45 solve on the card
   (rtol 1e-8, atol 1e-10), model 2 (bucketed, w = 17) against the port's
   float64 ETD2RK on the CPU, each within 1e-3 (fold changes, as 5 and
   5b); the ``phi_tables`` / ``phi_tables_wide`` launches one a width
   class, predicted and asserted (in the kernels line's paths);
15c. ``render_kinopt_app`` and ``render_tfopt_app`` on phase 11's local fits
   (the bench kinopt problem, the 500-gene tfopt one): the written files,
   each PNG decoded, the knockout preview (one batched ``predict`` on the
   card, float64) against the CPU's within 1e-12; no launch;
15d. ``diagram --alpha-file`` through ``cli.main`` on a kinopt workbook that
   ``io/export.py`` writes from 15c's fit: seven PNGs at 300 dpi, each
   decoded, each figure's seconds; no launch;
15e. ``curve_similarity_matrix`` over the bench network's 45 protein curves
   (990 pairs in one batched Fréchet DP on the card, float64) against the
   CPU's within 1e-12, ``cluster_curves`` and ``export_subnetwork`` around
   the busiest protein; no launch.

The last slices (``phi_tables_xwide``, population sharding, the wide scan):

3h. the widest table kernel, ``csrc/phi_tables_xwide.cu`` (18 <= w <= 129),
   on model 2 at mechanisms' default cap of 6 sites (width classes 2, 3, 33,
   65), model 2 with a protein of 7 sites (classes 2, 3, 5, 129; float64
   there through a cluster of two blocks a lane) and model 0 with a protein
   of 20 sites (w = 22), each cut to six proteins (their observations by
   RK45 on the CPU in spawned workers, the 7-site one's from the start): its
   ptxas report (no spill in either instance), the objective at pop 2048
   (float32; its
   launches, one a width class, each class to its kernel by width, against
   the prediction from ``width_classes``; F on 8 members within 1e-3 of the
   port's float64 on the CPU) and at pop 256 (float64, within 1e-9); the
   kernel against its plain version at each class wider than 17 on the
   first chunk's own inputs, float32 (2e-5 scaled) and float64 (1e-12),
   timed beside its FMA bound (float64: at the FP64 tensor cores' rate,
   and at the FP64 FMA pipes' beside it), the plain version (at w = 129 on the first
   XWIDE_CHECK_LANES lanes: the whole class would take seconds) and
   ``matrix_exp``; a NaN lane that leaves every other lane's bits as they
   were;
3i. the scan kernel past w = 17 and N = 256 (``csrc/etd2rk_scan.cu``'s wide
   kernel, 2 <= w <= 129, members over clusters of up to 8 blocks, up to
   N = 16,384): ptxas's report of the wide kernel's eight builds (no
   spill);
   the kernel (one launch) against its plain version at w = 18, 22, 32,
   33, 64, 65, 96, 97, 128 and 129 (N = 7), at N = 257, 1,024, 4,096,
   8,193 and 16,384 for w = 6 and 22, and at (65, 257) and (65, 4,096), in
   both types (rtol 2e-3 / atol 1e-5 float32, 1e-10 / 1e-12 float64), each
   with its variant, threads a lane's rows, column warps, lanes a thread,
   cluster and push (the members past 6,144 proteins listed in
   the kernels line); a NaN member at w = 65, at N = 1,024 and at N =
   16,384 that leaves every other member's bits as they were; then the
   objective unbucketed with ``use_scan_kernel=True`` on 3h's three
   networks (w = 22, 65, 129) and on ``build_demo_network(300, 24,
   seed=1)`` (N = 285, w = 6) at pop 2048 float32 and 256 float64: one
   ``etd2rk_scan`` and one table launch a chunk against the prediction, F
   within 1e-3 / 1e-9 of the eager scan's and of the CPU's float64 (3h's
   references, the 285-protein one in a worker beside them), and the scan
   of all those members by the 3c fields (kernel, device, plain, eager and
   CUDA-graph ms, the bound and its share);
3j. past w = 129, off the main lane (in the side lane after phase 12; its
   CPU reference in a worker of its own from the side lane's start): the
   stream table kernel ``csrc/phi_tables_stream.cu`` (w >= 130) and the
   flux's spans kernel, their ptxas reports (no spill);
   model 2 with a protein of 8 sites (``build_demo_network(4, 3,
   max_sites=8, model=2, seed=7)``, classes 2, 3, 9, 257): the bucketed
   objective at pop 2048 float32 and pop 256 float64 (one table launch a
   class, the 257 class to the stream kernel; F on 8 members within 1e-3
   / 1e-9 of the port's float64 on the CPU), the kernel at the first
   chunk's w = 257 class against its plain version on 64 lanes (2e-5 /
   1e-12 scaled, a NaN lane), timed on the whole class (two calls after a
   warm-up, one on the device) beside its FMA bound, the plain version and
   ``matrix_exp`` (in chunks of 4,096 matrices); the unbucketed objective through the scan kernel at pop 256
   float32 and 64 float64 (one ``etd2rk_scan`` and one stream launch a
   chunk, F against the eager scan's and the CPU's; the scan against the
   plain version and the eager scan, rtol 2e-3 / atol 1e-5 and 1e-10 /
   1e-12, timed); tables and scan at w = 513 on 56 lanes; the flux at 11,
   12 and 13 sites (2^22 states) against its plain version beside its
   bytes bound; ``use_kron=True`` on the bench model-2 network at substep
   0.5 against the dense path (rtol 2e-2 / atol 1e-4, no launch); the
   peak device memory;
16. population sharding on the card (``parallel/mesh.py``): two gloo ranks
   in spawned processes sharing the card, CUDA tensors (NCCL refuses two
   ranks on one device), started beside phases 13-15, on the bench model-0
   network: ``evaluate_population`` at pop 8192 against this process's
   unsharded call (bit for bit, else the largest relative difference gated
   at 1e-6), 2 ``phi_tables`` launches a rank, the column-sharded ranks of
   that F equal to the replicated ones, a short sharded
   ``run_unsga3_device`` (pop 512, 4 generations) whose ideal point is the
   unsharded run's within 1e-3 (the JAX package's tolerance), the ranks'
   populations the same; and NCCL over a one-rank group, bit for bit. Two
   ranks on one card measure no speed: their seconds are printed as what
   they are.

``python3 chip_smoke.py --pergene-only`` runs phase 1 and phase 10 alone
(no kernel build, no JSON lines); ``--sensitivity-kinopt-only`` runs
phases 1, 2 and 11, ``--hyperscan-only`` phases 1, 2 and 12,
``--runner-only`` phases 1, 2 and 13, ``--fitfigures-only`` phases 1, 2
and 14, ``--part3-only`` phases 1, 2 and 15 (15c at the phase-11 problems'
exact weights, in place of phase 11's fits; no JSON lines), ``--xwide-only``
phases 1, 2 and 3h, ``--scan-wide-only`` phases 1, 2 and 3i,
``--stream-only`` phases 1, 2 and 3j (the stream kernel's entries as its
JSON line), ``--mesh-only`` phases 1, 2 and 16.

The line before the last is a JSON summary of each kernel (the float64
instances and ``sq_chain`` included, each with the launches of its own main
path); the last line is ``{"ok": true, "device": {...}}``. There is no CPU
fallback.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from phoskintime_tpu_torch.analysis import influence as influence_mod
from phoskintime_tpu_torch.config.loader import PhosKinConfig
from phoskintime_tpu_torch.demo import GRID, RNA_GRID, build_demo_network
from phoskintime_tpu_torch.fit import pipeline as pipeline_mod
from phoskintime_tpu_torch.fit.normest import normest, normest_batch
from phoskintime_tpu_torch.fit.pipeline import process_gene, run_model_pipeline
from phoskintime_tpu_torch.io.load import load_data
from phoskintime_tpu_torch.io.utils import write_csv
from phoskintime_tpu_torch.kinopt import kkt_check as kinopt_kkt_check
from phoskintime_tpu_torch.kinopt import optimize as kinopt_opt
from phoskintime_tpu_torch.kinopt.model import build_problem as kinopt_build_problem
from phoskintime_tpu_torch.kinopt.model import kinopt_loss
from phoskintime_tpu_torch.kinopt.optimize import run_evolutionary as kinopt_run_evolutionary
from phoskintime_tpu_torch.kinopt.optimize import run_local as kinopt_run_local
from phoskintime_tpu_torch.models.kinetics import (_BUILDERS, initial_condition, n_params,
                                                   solve_ode, solve_ode_batched, state_dim)
from phoskintime_tpu_torch.network import expo, polish, steadystate
from phoskintime_tpu_torch.network import optimize as optimize_mod
from phoskintime_tpu_torch.network import runner as runner_mod
from phoskintime_tpu_torch.network import scan as scan_mod
from phoskintime_tpu_torch.network import simulate as sim_mod
from phoskintime_tpu_torch.network.analysis import simulate_until_steady
from phoskintime_tpu_torch.network.bounds import calculate_bio_bounds
from phoskintime_tpu_torch.network.kinase_input import build_kinase_matrix
from phoskintime_tpu_torch.network.lossdata import prepare_loss_data
from phoskintime_tpu_torch.network.objective import (_auto_pop_chunk, _scorer,
                                                     evaluate_population, make_objective,
                                                     make_population_objective,
                                                     make_residual_fn)
from phoskintime_tpu_torch.network.optimize import run_global_fit
from phoskintime_tpu_torch.network.params import init_raw_params, softplus, unpack_params
from phoskintime_tpu_torch.network.polish import (forward_jacobian, lm_refine_mixed,
                                                  polish_solutions, simplex_weights)
from phoskintime_tpu_torch.network.scan import run_hyperparameter_scan
from phoskintime_tpu_torch.network.simulate import (extract_observables, fold_changes,
                                                    simulate, simulate_and_measure,
                                                    simulate_batched)
from phoskintime_tpu_torch.network import sensitivity as sens_mod
from phoskintime_tpu_torch.network.sensitivity import run_sensitivity_analysis
from phoskintime_tpu_torch.network.steadystate import build_y0_from_data
from phoskintime_tpu_torch.network.system import GlobalSystem, default_params
from phoskintime_tpu_torch.network.topology import build_topology
from phoskintime_tpu_torch.ops import constrained, cuda_build
from phoskintime_tpu_torch.ops import fma_peak
from phoskintime_tpu_torch.ops.de_jit import DEDraws, de_draws, de_generation, de_init_draws
from phoskintime_tpu_torch.ops.hypercube_flux import SOURCE as FLUX_SOURCE
from phoskintime_tpu_torch.ops.hypercube_flux import hypercube_flux, hypercube_flux_reference
from phoskintime_tpu_torch.ops.linear import affine_augment, expm
from phoskintime_tpu_torch.ops.nsga import (das_dennis, fast_non_dominated_sort,
                                            make_device_ga_step, nsga3_survival)
from phoskintime_tpu_torch.network.weights import build_weight_functions
from phoskintime_tpu_torch.ops.nsga_device import (device_nd_ranks, make_device_ga_blocks,
                                                   run_unsga3_device)
from phoskintime_tpu_torch.ops.tridiag import thomas_solve_batched, thomas_solve_reference
from phoskintime_tpu_torch.ops import phi_tables as phi_mod
from phoskintime_tpu_torch.ops.phi_tables import (phi_tables, phi_tables_reference,
                                                  phi_tables_stream, phi_tables_wide,
                                                  phi_tables_xwide, phi_vectors)
from phoskintime_tpu_torch.ops.scan_kernel import SOURCE as SCAN_SOURCE
from phoskintime_tpu_torch.ops.scan_kernel import VARIANTS as SCAN_VARIANTS
from phoskintime_tpu_torch.ops.scan_kernel import (etd2rk_scan, etd2rk_scan_reference,
                                                   random_scan_problem, scan_launch_shape)
from phoskintime_tpu_torch.ops.stiff import batched_jacobian
from phoskintime_tpu_torch.report import html as html_mod
from phoskintime_tpu_torch.io import export as export_mod
from phoskintime_tpu_torch.report import dashboard as dashboard_mod
from phoskintime_tpu_torch.report import plotter as plotter_mod
from phoskintime_tpu_torch.report import interactive as interactive_mod
from phoskintime_tpu_torch.report import live_model as live_model_mod
from phoskintime_tpu_torch.ops.tpe import MOTPESampler
from phoskintime_tpu_torch.tfopt import optimize as tfopt_opt
from phoskintime_tpu_torch.tfopt.model import TfoptProblem
from phoskintime_tpu_torch.tfopt.optimize import run_evolutionary as tfopt_run_evolutionary
from phoskintime_tpu_torch.tfopt.optimize import run_local as tfopt_run_local
from tools.smoke_cases import (SCAN_WIDE_NETWORKS, STREAM_NETWORK, XWIDE_NETWORKS, augmented,
                               hypercube_blocks)

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
# the tensor cores, and HBM bandwidth; every bound_ms is taken against them,
# but that of a kernel whose float64 products run on the FP64 tensor cores
# (phi_tables_xwide), taken against their rate
PEAK_FP32_FLOPS, PEAK_FP64_FLOPS, PEAK_HBM_BYTES = 67e12, 34e12, 3.35e12
PEAK_FP64_TC_FLOPS = 67e12
# the FP32 FMA peak this run measures in phase 3f (sq_chain's best arm),
# beside which every FP32 bound is printed a second time
MEASURED = {"fp32_flops": None}
# threads a block in 3f's sweep (the module's full sweep adds 128 and 1024;
# on the H100 the best arm was at 256 or 512 threads)
SWEEP_THREADS = (256, 512)
KERNELS = (phi_tables, phi_tables_wide, phi_tables_xwide, phi_tables_stream, etd2rk_scan,
           hypercube_flux, thomas_solve_batched, fma_peak.sq_chain)
# 3h: the networks of tools/smoke_cases.py::XWIDE_NETWORKS (their
# observations come from RK45 on the CPU, in a worker); the float32
# objective at XWIDE_POP (as 4b), the float64 one at XWIDE_POP_F64
XWIDE_POP, XWIDE_POP_F64 = 2048, 256
# lanes of a class held against the plain version (lane 37 made NaN), and
# the widest class whose plain version is timed whole (past it, on these)
XWIDE_CHECK_LANES = 256
XWIDE_PLAIN_WHOLE_MAX_W = 65
# the objective's arguments after the system in a host bundle
HOST_ARGS = ("slices", "loss_data", "defaults", "lambdas", "grid")
# 16: population sharding on the one card: gloo ranks in spawned processes
# (NCCL refuses two ranks on one device) on the bench model-0 network,
# evaluate_population at MESH_POP (each rank's block in whole chunks of
# 2048, so its F is expected bit for bit; MESH_F_RTOL gates it otherwise),
# and a short sharded all-device GA held to the unsharded run's ideal point
# at the JAX package's tolerance (tests/test_nsga_device.py:357-359)
MESH_RANKS, MESH_POP = 2, 8192
MESH_GA = dict(pop_size=512, n_gen=4, gens_per_block=2, seed=0, ftol=0.0, n_max_evals=None)
MESH_F_RTOL, MESH_IDEAL_RTOL = 1e-6, 1e-3
# 3i: the scan kernel past w = 17 and N = 256 (its wide kernel): random
# problems at these widths (N = 7) and member sizes (w = 6 and 22), and at
# two more shapes, for the variants that stream E (w = 65, N = 257) and
# that keep the state in device memory (w = 65, N = 4,096), in both
# types; the objective unbucketed on 3h's networks and on the 300-protein
# demo (N = 285, its CPU reference in a worker beside 3h's), at XWIDE_POP
# (float32) and XWIDE_POP_F64 (float64)
SCAN_WIDE_WIDTHS = (18, 22, 32, 33, 64, 65, 96, 97, 128, 129)
SCAN_WIDE_PROTEINS = (257, 1024, 4096, 8193, 16384)
SCAN_WIDE_MORE = ((65, 257), (65, 4096))
# 3i's timing calls (kernel, plain, eager, graph): fewer than 3c's, to keep
# the phase in its budget
SCAN_WIDE_REPS = (2, 1, 1, 1)
# (w, N, members, the NaN member): a member a block at w = 65, a member
# over a cluster at N = 1,024 and at N = 16,384
SCAN_WIDE_NAN = ((65, 7, 40, 5), (6, 1024, 3, 1), (6, 16384, 2, 1))
REFERENCE_NETWORKS = SCAN_WIDE_NETWORKS
# 3h's networks: tools/smoke_cases.py's up to w = 129 (3j takes STREAM_NETWORK)
XWIDE_3H = tuple(n for n in XWIDE_NETWORKS if n != STREAM_NETWORK)
# 3j, past w = 129, in the side lane after phase 12: the 8-site network's
# bucketed objective at STREAM_POP (float32) and STREAM_POP_F64 (float64);
# the stream kernel against its plain version on STREAM_CHECK_LANES lanes
# of its class, timed over STREAM_REPS calls after a warm-up (one pass, one
# call on the device: a float32 w = 257 call holds the whole card for ~1.7
# s, and 3j runs beside phase 13) beside matrix_exp in chunks of
# STREAM_LIBRARY_CHUNK matrices; the unbucketed objective through the scan
# kernel at STREAM_SCAN_POP members (E alone 4.7 GB at pop 256 float32); w
# = 513 on STREAM_513_LANES lanes; the flux at STREAM_FLUX_SITES sites;
# use_kron=True on the bench model-2 network at STREAM_KRON_POP members
STREAM_POP, STREAM_POP_F64 = 2048, 256
STREAM_CHECK_LANES, STREAM_REPS, STREAM_LIBRARY_CHUNK = 64, 2, 4096
STREAM_SCAN_POP = {torch.float32: 256, torch.float64: 64}
STREAM_513_LANES = 56
STREAM_FLUX_SITES = (11, 12, 13)
STREAM_KRON_POP = 64
# the seconds phases 3h, 3i and 16 may take in the whole script (printed
# beside their own; phase 16's ranks run beside phases 13-15)
PHASE_BUDGET_S = {"3h": 50, "3i": 45, "16": 40}
# float64 on the card (3g): tables against their plain versions scaled as
# the float64 kernels; the scan elementwise; an objective against the
# port's float64 result on the CPU
F64_SCAN_RTOL, F64_SCAN_ATOL, F64_OBJECTIVE_RTOL = 1e-10, 1e-12, 1e-9
# the global fit (7): the north-star network and population (bench.py:407-412)
NORTHSTAR = dict(n_proteins=150, n_kinases=24, seed=1)
NORTHSTAR_POP = 10_000
# the all-device route's generations: one block of 3 (two blocks of 5
# before phase 14 came in, one of 5 before phases 3h and 16; cut to keep
# the script's time)
NORTHSTAR_GENS = 3
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
ESDIRK_POP = {2: 16, 0: 32}              # model 0 at 64 before phase 15 came in
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
# (POLISH_STEPS was 20 before phase 15 came in)
POLISH_POP, POLISH_STEPS, POLISH_SLACK = 32, 10, 1e-4
# the LM finish (9c): sum(r**2) against F.sum() at each precision, the
# iterations of each stage, the mixed finish against the float32 sse (the
# JAX package's gate, tests/test_polish.py:383-389), tangents a Jacobian pass
LM_SSE_RTOL = {torch.float32: 2e-4, torch.float64: 1e-9}
LM_ITERS_LO, LM_ITERS_HI, LM_MIXED_GATE, JAC_CHUNK = 8, 6, 1e-3, 256
# the fits of 9d: the GA then polish and LM; the gradient multistart
# (gn_iters 3 and the multistart's pop 64 before phase 15 came in)
GRADFIT_POP, GRADFIT_GENS, GRADFIT_GN_ITERS, GRADFIT_MULTISTART_POP = 256, 2, 2, 32
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
# 10b's cohorts: the one checked against the CPU and the widest (the
# device-bound randmod); 1, 3 and 4 were cut to keep the script's time as
# phases 11 and 12 came in
PG_COHORT_SITES = (2, 5)
# 10d's cohort: one distmod gene a site count (1..5 before phase 12 came in)
PG_PIPELINE_SITES = (1, 2, 3)
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
# run_local's depth: 200 steps (800 before phase 12 came in, 400 before
# phase 13, cut to keep the script's time; a step's cost does not change
# with the count)
KINOPT_LOCAL = dict(n_starts=48, steps=200)
DE_GENS = 50              # 200 before phase 12 came in, 100 before phase 13
KINOPT_F64_RTOL = 1e-9
DE_F64_ATOL = 1e-12
TFOPT_PROBLEM = (500, 100, 4, 6)
TFOPT_LOCAL = dict(n_starts=48, steps=200)
TFOPT_GENS = 20
SENS_TIMES_F64 = np.array([0.0, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0])
SENS_TIMES_PROFILE = np.array([0.0, 0.5, 1.0, 2.0, 4.0])
SENS_F64_RTOL = 1e-9
# phase 12: the bench network written as the reference's input files and
# read back; its observations within 1 ulp; the scan at the config's own
# sizing (20 trials x 15 generations x pop 64), reports every 5
# generations, then resumed to 22 trials; MOTPE cut from the config's
# 1,000 trials to 160 (its host ask grows with the told history); float64
# MOTPE on the card against the CPU at 48 trials; the pick's measurements
# on the card against the CPU's float64
OBS_RTOL = 1e-15
HYPERSCAN_GEN_STEP, HYPERSCAN_RESUME = 5, 22
MOTPE_TRIALS, MOTPE_F64_TRIALS, MOTPE_F64_RTOL = 160, 48, 1e-9
PICK_RTOL = 1e-3
CONFIG_TOML = """[global_model]
kinase_net = "input2.csv"
tf_net = "input4.csv"
ms = "input1.csv"
rna = "input3.csv"
kinopt = "kinopt_results.xlsx"
tfopt = "tfopt_results.xlsx"
optimizer = "pymoo"
seed = 42
n_trials = 1000
scan_trials = 20
scan_inner_gens = 15
scan_inner_pop = 64
scaling_method = "raw"
use_initial_condition_from_data = true
"""

# phase 13: the entry points on the bench inputs. global-model at the
# reference's pop 300 with 5 generations (cut from 1,000), 1 Morris
# trajectory (cut from 100) and no polish; mechanisms at its default pop
# 48 with 3 generations (cut from 25)
RUNNER_CONFIG = """pop = 300
n_gen = 5
sensitivity_trajectories = 1
polish_steps = 0

[ode.inputs]
protein_excel = "input1.csv"
"""
MECH_GENS = 3
#: the tables and pages global-model writes whatever the run (the CPU tests
#: hold the same set); :func:`runner_files` adds what depends on the run
RUNNER_TABLES = frozenset({
    "S_rates_picked.csv", "convergence_history.csv", "influence/global_knockouts.html",
    "influence/influence_network.html", "influence/influence_sweep.csv",
    "influence/live_explorer.html", "pareto_interactive.html", "report.html",
    "kinase_activity_kinase_activity.csv", "lambda_scan.csv", "lambda_scan_recommended.json",
    "lambda_scan_unique_picks.csv", "mechanistic_discovery_report_1_refractory_period.csv",
    "mechanistic_discovery_report_2_kinetic_lag.csv",
    "mechanistic_discovery_report_3_saturation.csv",
    "mechanistic_discovery_report_4_feedback_gain.csv",
    "param_correlations_param_correlations.csv",
    "param_distributions_param_distributions.csv", "parameters_parameters.csv",
    "pareto_F.npy", "pareto_X.npy", "pareto_objectives.csv", "pareto_solutions.csv",
    "pareto_trajectories_summary.csv", "pareto_trajectories_traj_phospho.csv",
    "pareto_trajectories_traj_protein.csv", "pareto_trajectories_traj_rna.csv",
    "pymoo_optimization_result.pkl", "residuals_residuals.csv", "sensitivity.npz",
    "steady_state_check.csv", "trajectories_obs_phospho.csv", "trajectories_obs_protein.csv",
    "trajectories_obs_rna.csv", "trajectories_pred_phospho.csv",
    "trajectories_pred_protein.csv", "trajectories_pred_rna.csv", "dashboard_bundle.pkl",
    "pareto_3d.png", "pareto_parallel.png"})
HEATMAP_MAX_PARAMS = 200    # the correlation heatmap is drawn up to this many parameters
VIDEO_MAX_FRAMES = 60       # create_convergence_video's default
TRAJ_RTOL = 1e-3          # trajectories at the pick vs float64, of each column's largest
KO_FC_RTOL = 1e-3         # the knockout explorer's fold changes vs float64 (PERF.md §2)
GRAPH_CHECK_STEPS = 200   # the graphed RK45 loop vs the eager one, bit for bit

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


def bound(nbytes: float, ops: float, itemsize: int = 4, peak: float | None = None) -> Bound:
    """The least time of a function that moves ``nbytes`` and does ``ops``
    operations of the type of ``itemsize`` (4: FP32, 8: FP64) on its FMA
    pipes, or at ``peak`` where another unit does them (the FP64 tensor
    cores; no measured rate then)."""
    if peak is None:
        peak = PEAK_FP32_FLOPS if itemsize == 4 else PEAK_FP64_FLOPS
        measured = (MEASURED["fp32_flops"] or PEAK_FP32_FLOPS) if itemsize == 4 else peak
    else:
        measured = peak
    t_ops, t_bytes = ops / peak, nbytes / PEAK_HBM_BYTES
    return Bound(1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
                 1e3 * max(ops / measured, t_bytes))


def bound_fields(b: Bound, dev_ms) -> dict:
    """A bound and the device time's share of it, against the data sheet
    and against the measured FP32 peak, for a log line."""
    return {"bound_ms": f"{b.ms:.4f}", "bound_by": b.by, "share_of_bound": share(b.ms, dev_ms),
            "bound_ms_measured_peak": f"{b.ms_measured:.4f}",
            "share_of_measured_bound": share(b.ms_measured, dev_ms)}


def table_bound(L, binv, h_u, ladder, peak: float | None = None) -> Bound:
    """The bound of a table build on these inputs: the bytes it must move
    (L read once, the tables written once) and its FMAs, on the type's FMA
    pipes or at ``peak`` (:func:`bound`). FMAs per (pair, lane), n the
    series' terms (8 in float32, 12 in float64): (n - 1) w^3 (Horner) +
    (n - 1) w^2 (series) + s (w^3 + 2 w^2) (ladder), with s the lane's own
    squaring count on this data."""
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
    return bound(nbytes, 2.0 * fmas, isz, peak)


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


def check_and_time_scan(label, b, thetas, card, reps=(10, 3, 3, 5), **kw) -> dict:
    """The scan of one chunk by three routes on the inputs the integrator
    assembles (``expo.ScanSetup``; ``kw``: its options): the kernel against
    the plain version and the eager scan (gated), then times in the order
    plain, kernel, kernel, plain, eager, eager replayed from a CUDA graph,
    and the bound; ``reps``: the calls each time is taken over (kernel,
    plain, eager, graph)."""
    k_reps, p_reps, e_reps, g_reps = reps
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

    p1, k1, k2, p2 = (cuda_ms(run_p, p_reps), cuda_ms(run_k, k_reps), cuda_ms(run_k, k_reps),
                      cuda_ms(run_p, p_reps))
    eager_ms = cuda_ms(eager, e_reps)
    replay, ys_g = graph_of(eager)
    replay()
    torch.cuda.synchronize()
    if not torch.equal(ys_g, ys_e):
        raise AssertionError(f"{label}: the CUDA graph's scan differs from the eager one")
    graph_ms = cuda_ms(replay, g_reps)
    del replay, ys_g
    b = scan_bound(args, plan)
    dev_ms = kernel_ms_on_device(run_k, "etd2rk_scan_wide_kernel" if variant.startswith("wide")
                                 else "etd2rk_scan_kernel", k_reps)
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
        "4d model0": ("objective", hb0, "float32", "cuda", (thetas[:POP2].cpu().numpy(), None)),
        "4d model1": ("objective", hb1, "float32", "cuda", (thetas1.cpu().numpy(), None)),
        **{f"5c model{hb['topo'].model} {dt}": ("fold_changes", hb, dt, "cuda")
           for hb in (hb0, hb2) for dt in ("float32", "float64")},
        "6 until_steady": ("until_steady", hb0, "float64", "cuda", STEADY_T_FINAL),
    }
    pool = ProcessPoolExecutor(max_workers=len(jobs), mp_context=get_context("spawn"))
    return pool, {name: pool.submit(worker_job, *spec) for name, spec in jobs.items()}


def start_cpu_reference(b2, thetas2):
    """4d's float64 RK45 run on the CPU (8 members), the longest of the RK45
    workers (~70 s, host-bound), in a spawned worker of its own started
    before phase 4 so that it is done when 4d's checks read it. Returns
    (pool, future)."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    pool = ProcessPoolExecutor(max_workers=1, mp_context=get_context("spawn"))
    return pool, pool.submit(worker_job, "objective", host_bundle(b2), "float64", "cpu",
                             (thetas2[:8].cpu().numpy(), None))


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


def finish_rk45_workers(pools, futures, F, oracles, card) -> None:
    """4d, 5c and 6's worker runs: F against the plain flux and against
    float64 on the CPU, models 0 and 1, the accuracy gates against the
    LSODA ``oracles`` ({model: fold changes}), and simulate_until_steady."""
    try:
        got = {name: fut.result() for name, fut in futures.items()}
    finally:
        for pool in pools:
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
    pop 10,000: the all-device loop (gens_per_dispatch=3, one block), then
    the default route (device variation, host survival) for 1 generation;
    then one generation of each route profiled; then, on the bench network,
    pop 256 for 5 generations with one refinement round and the Fréchet
    pick. Returns {path: launches}."""
    t0 = time.perf_counter()
    ns = build_demo_network(**NORTHSTAR, dtype=torch.float32, device="cuda")
    n_chunks = -(-NORTHSTAR_POP // _auto_pop_chunk(ns["topo"].N))
    say("7 setup", N=ns["topo"].N, K=ns["topo"].K, n_theta=len(ns["theta0"]),
        chunks=n_chunks, seconds=f"{time.perf_counter() - t0:.2f}")
    dev, dev_launches = fit_route("7 global fit all-device", ns, card, NORTHSTAR_GENS, n_chunks,
                                  gens_per_dispatch=NORTHSTAR_GENS)
    host, host_launches = fit_route("7 global fit default", ns, card, 1, n_chunks)

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
    45, w = 17, d = 765) at pop 16 and on model 0 at pop 32 (rtol 1e-8,
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
    pop 256 for 2 generations, then POLISH_STEPS of polish and
    GRADFIT_GN_ITERS; then optimizer="gradient" at GRADFIT_MULTISTART_POP
    with POLISH_STEPS (JAX's minimum of
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
    each n = 1..3, knockouts on), then process_gene for one gene with
    Morris (the function's defaults: 200 trajectories x 40 levels) and 8
    bootstraps: seconds of each, Morris solves a second. Returns {path:
    launches}."""
    cols = {"prot": ([], [], []), "pho": ([], [], [], []), "rna": ([], [], [])}
    for n in PG_PIPELINE_SITES:
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
    if len(out) != len(PG_PIPELINE_SITES) or not all(
            o.knockout_solutions is not None and np.isfinite(o.knockout_solutions).all()
            and np.isfinite(o.result.error) for o in out.values()):
        raise AssertionError("10d: the pipeline's outputs are incomplete or not finite")
    say("10d run_model_pipeline", genes=len(out), sites=PG_PIPELINE_SITES,
        seconds=f"{wall:.2f}",
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
    the float32 cohorts, then 10c and 10d run before the float64 cohorts
    are read."""
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

        def after_f32():
            # 10a's check, then 10c and 10d while the float64 cohorts run
            check_pergene_solves(draws, solves, refs)
            paths.update(phase_pergene_recovery(card))
            paths.update(phase_pergene_pipeline(card))

        cohort_paths, f64_fits = phase_pergene_cohort(f64_jobs, card, after_f32=after_f32)
        paths.update(cohort_paths)
        check_pergene_cpu(futures, f64_fits, card)
    finally:
        pool.shutdown(cancel_futures=True)
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


def phase_kinopt(card, pool, fits=None) -> dict:
    """11a: kinopt on the bench problem and on the scaled one: run_local
    (48 starts, 200 steps), DE (pop 100, 50 generations), NSGA-II on the
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
        if fits is not None and label == "bench":
            fits["kinopt"] = (prob, res)             # phase 15c's app renders this fit
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
        for method, gpd, n_gen in (("DE", 1, DE_GENS), ("NSGA-II", 1, 50), ("NSGA-II", 10, 50)):
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


def phase_tfopt(card, fits=None) -> dict:
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
    if fits is not None:
        fits["tfopt"] = (prob, res)                  # phase 15c's app renders this fit
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


def phase_sensitivity_kinopt(card, b2, fits=None) -> dict:
    """11: kinopt (11a), tfopt (11b) and the network sensitivity (11c); the
    CPU references in spawned worker processes beside them. ``fits``, where
    given, receives the bench kinopt and the tfopt local fits as {which:
    (problem, result)}."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(max_workers=1, mp_context=get_context("spawn"))
    try:
        paths = phase_kinopt(card, pool, fits)
        paths.update(phase_tfopt(card, fits))
        paths.update(phase_sensitivity(b2, card, pool))
    finally:
        pool.shutdown(cancel_futures=True)
    say("11 kinopt/tfopt/sensitivity", seconds=f"{time.perf_counter() - t0:.1f}",
        card=repr(card))
    return paths


# --- 12: the data-in layer, the loss-weight scan and MOTPE -----------------------------


def write_reference_inputs(b, root) -> None:
    """The bench bundle as the reference's input files, written with the
    csv module: input1 (GeneID, Psite, x1..x14: each protein's fold
    changes, then each site's), input2 (GeneID, Psite, {kinases}), input3
    (GeneID, x1..x9), input4 (Source, Target), the kinopt Alpha sheet's
    CSV sibling (every edge 1.0) and config.toml."""
    topo = b["topo"]
    fc = {}
    for name, cols in (("p", b["df_prot"]), ("r", b["df_rna"]), ("s", b["df_pho"])):
        sites = cols["psite"] if "psite" in cols else [""] * len(cols["protein"])
        for p, s_, t, v in zip(cols["protein"], sites, cols["time"], cols["fc"]):
            fc[(name, p, s_, float(t))] = float(v)
    rows1 = []
    for i, p in enumerate(topo.proteins):
        rows1.append((p, "", [fc[("p", p, "", float(t))] for t in GRID]))
        rows1 += [(p, s_, [fc[("s", p, s_, float(t))] for t in GRID]) for s_ in topo.sites[i]]
    write_csv(root / "input1.csv", {
        "GeneID": [r[0] for r in rows1], "Psite": [r[1] for r in rows1],
        **{f"x{j + 1}": [r[2][j] for r in rows1] for j in range(len(GRID))}})
    edges = [(p, s_, [topo.kinases[k] for k in np.flatnonzero(topo.W_pad[i, j])])
             for i, p in enumerate(topo.proteins) for j, s_ in enumerate(topo.sites[i])]
    write_csv(root / "input2.csv", {"GeneID": [e[0] for e in edges],
                                    "Psite": [e[1] for e in edges],
                                    "Kinase": ["{" + ", ".join(e[2]) + "}" for e in edges]})
    write_csv(root / "input3.csv", {
        "GeneID": list(topo.proteins),
        **{f"x{j + 1}": [fc[("r", p, "", float(t))] for p in topo.proteins]
           for j, t in enumerate(RNA_GRID)}})
    tgt, src = np.nonzero(topo.tf_mat)
    write_csv(root / "input4.csv", {"Source": [topo.proteins[i] for i in src],
                                    "Target": [topo.proteins[i] for i in tgt]})
    alpha = [(p, s_, k) for p, s_, ks in edges for k in ks]
    write_csv(root / "kinopt_results_alpha_values.csv", {
        "Gene": [a[0] for a in alpha], "Psite": [a[1] for a in alpha],
        "Kinase": [a[2] for a in alpha], "Alpha": [1.0] * len(alpha)})
    (root / "config.toml").write_text(CONFIG_TOML)


def same_observations(got, want, keys) -> float:
    """The largest relative difference of fc between two tables matched
    by ``keys``; raises where their keys differ."""
    def by_key(t):
        return {tuple(k): float(v) for k, v in zip(zip(*(list(t[c]) for c in keys)), t["fc"])}
    g, w = by_key(got), by_key(want)
    if set(g) != set(w) or len(g) != len(got["fc"]):
        raise AssertionError(f"12a: observations {len(g)} read vs {len(w)} written")
    return max(abs(g[k] - w[k]) / abs(w[k]) for k in w)


def phase_data_in(b, root, card) -> dict:
    """12a: write the bench bundle as input files, load them through the
    config and load_data, check the observations (1 ulp) and the topology
    against the bundle's, then build the problem as the runner does:
    kinase input from the data, uniform weights, the system at float32 on
    the card, y0 from the data, the loss data, bio bounds, raw params."""
    t0 = time.perf_counter()
    write_reference_inputs(b, root)
    cfg = PhosKinConfig.from_toml(root / "config.toml")
    at = lambda rel: str(root / rel)
    tp, tr = np.asarray(cfg.time_points_protein), np.asarray(cfg.time_points_rna)
    kin, tf, prot, pho, rna, kb, tb, ka, te = load_data(
        at(cfg.kinase_net), at(cfg.tf_net), at(cfg.ms), at(cfg.rna),
        kinopt_path=at(cfg.kinopt), tfopt_path=at(cfg.tfopt), time_points_protein=tp,
        time_points_rna=tr, scaling_method=cfg.scaling_method)
    errs = [same_observations(prot, b["df_prot"], ("protein", "time")),
            same_observations(rna, b["df_rna"], ("protein", "time")),
            same_observations(pho, b["df_pho"], ("protein", "psite", "time"))]
    topo = build_topology(kin, tf, kin_beta_map=kb, tf_beta_map=tb, kin_alpha=ka,
                          tf_edge_weights=te, model=cfg.model)
    want = b["topo"]
    same_topo = (topo.proteins == want.proteins and topo.kinases == want.kinases
                 and topo.sites == want.sites and np.array_equal(topo.W_pad, want.W_pad)
                 and np.array_equal(topo.tf_mat, want.tf_mat)
                 and topo.proxy_map == want.proxy_map)
    if max(errs) > OBS_RTOL or not same_topo or len(ka) != int(np.count_nonzero(want.W_pad)):
        raise AssertionError(f"12a: read back {errs}, topology equal {same_topo}")

    Kmat = build_kinase_matrix(topo.kinases, zip(prot["protein"], prot["time"], prot["fc"]), tp)
    w_prot, w_rna = build_weight_functions(tp, tr, cfg.weighting_method_protein,
                                           cfg.weighting_method_rna)
    w_pho, _ = build_weight_functions(tp, tr, cfg.weighting_method_phospho,
                                      cfg.weighting_method_rna)
    prot, rna, pho = ({**t, "w": w(np.asarray(t["time"]))}
                      for t, w in ((prot, w_prot), (rna, w_rna), (pho, w_pho)))
    system = GlobalSystem(topo, tp, Kmat, dtype=torch.float32, device="cuda")
    y0 = build_y0_from_data(topo, prot, rna, pho) if cfg.use_initial_condition_from_data \
        else None
    system.custom_y0 = y0
    grid = np.unique(np.concatenate([tp, tr]))
    loss_data = prepare_loss_data(topo, prot, rna, pho, grid)
    defaults = default_params(topo, np.float32)
    _, slices, xl, xu = init_raw_params(defaults, topo, calculate_bio_bounds(topo, prot, rna,
                                                                             Kmat))
    lambdas = {"protein": cfg.lambda_protein, "rna": cfg.lambda_rna,
               "phospho": cfg.lambda_phospho, "prior": cfg.lambda_prior}
    say("12a data in", files=sorted(p.name for p in root.iterdir()), model=cfg.model,
        N=topo.N, K=topo.K, sites=topo.total_sites, n_theta=len(xl),
        rows=(len(prot["fc"]), len(rna["fc"]), len(pho["fc"])),
        read_back_max_rel_err=[f"{e:.3e}" for e in errs], tol=OBS_RTOL,
        topology_equal=same_topo, alpha_edges=len(ka),
        y0_present_range=None if y0 is None else f"[{y0[y0 > 0].min():.4g}, {y0.max():.4g}]",
        seconds=f"{time.perf_counter() - t0:.2f}")
    return dict(cfg=cfg, system=system, slices=slices, loss_data=loss_data, defaults=defaults,
                grid=grid, xl=xl, xu=xu, lambdas=lambdas, prot=prot, rna=rna, pho=pho, tp=tp,
                tr=tr, y0=y0)


def problem_args(p) -> tuple:
    return (p["system"], p["slices"], p["loss_data"], p["defaults"])


class TrialSpy:
    """Records, for every inner GA of the scan, its table launches, its
    seconds (ended by a synchronize) and its generations."""

    def __init__(self):
        self.real, self.trials = scan_mod.run_unsga3_device, []

    def __enter__(self):
        def spy(*a, **kw):
            before, t0 = phi_tables.launches, time.perf_counter()
            res = self.real(*a, **kw)
            torch.cuda.synchronize()
            self.trials.append((phi_tables.launches - before, time.perf_counter() - t0,
                                res.n_gen))
            return res
        scan_mod.run_unsga3_device = spy
        return self

    def __exit__(self, *exc):
        scan_mod.run_unsga3_device = self.real


def phase_hyperscan(p, root, card) -> dict:
    """12b: run_hyperparameter_scan (expo) at the config's sizing, float32,
    with a checkpoint: a phi_tables launch in every evaluation of every
    trial, seconds a trial, ms a generation, the pruned; one trial's GA
    profiled (idle share); then resumed to 22 trials (20 loaded, 2 run).
    Returns {path: launches}."""
    cfg = p["cfg"]
    ck = str(root / "scan" / "scan_state.json")
    report_dir = root / "scan_report"
    kw = dict(inner_gens=cfg.scan_inner_gens, inner_pop=cfg.scan_inner_pop, seed=cfg.seed,
              loss_mode=cfg.loss, gen_step=HYPERSCAN_GEN_STEP, checkpoint_path=ck,
              out_dir=str(report_dir))
    args = (*problem_args(p), p["grid"], p["xl"], p["xu"])
    reset_counts()
    t0 = time.perf_counter()
    with TrialSpy() as spy:
        best, trials = run_hyperparameter_scan(*args, n_outer=cfg.scan_trials, **kw)
    wall = time.perf_counter() - t0
    launches = counts()
    per = spy.trials
    if len(per) != cfg.scan_trials or any(n != g + 1 for n, _, g in per) \
            or launches != expect(phi_tables=sum(n for n, _, _ in per)) \
            or [t.n_gen for t in trials] != [g for _, _, g in per]:
        raise AssertionError(f"12b: trials {[(n, g) for n, _, g in per]}, launches {launches}")
    if not all(np.isfinite(t.score) for t in trials):
        raise AssertionError("12b: a trial's score is not finite")
    secs = np.asarray([s for _, s, _ in per])
    gens = sum(g for _, _, g in per)
    best_t = min((t for t in trials if t.state == "complete"), key=lambda t: t.score)
    objective = make_population_objective(*problem_args(p), best_t.lambdas, p["grid"])
    prof = profile_call(lambda: run_unsga3_device(
        objective, p["xl"], p["xu"], pop_size=cfg.scan_inner_pop, n_gen=cfg.scan_inner_gens,
        seed=cfg.seed, ftol=0.0, n_max_evals=None, gens_per_block=HYPERSCAN_GEN_STEP,
        device="cuda", dtype=torch.float32), "phi_tables")
    say("12b hyperscan", trials=len(trials), inner=f"{cfg.scan_inner_gens}x{cfg.scan_inner_pop}",
        gen_step=HYPERSCAN_GEN_STEP, pruned=sum(t.state == "pruned" for t in trials),
        generations=gens, launches=launches["phi_tables"], wall_s=f"{wall:.2f}",
        s_per_trial=f"{secs.mean():.3f}", s_per_trial_range=f"[{secs.min():.3f}, {secs.max():.3f}]",
        ms_per_generation=f"{1e3 * secs.sum() / gens:.2f}",
        best=[f"{k}={v:.4g}" for k, v in best.items()], best_score=f"{best_t.score:.6g}",
        card=repr(card))
    say("12b one trial profiled", **prof, card=repr(card))

    with TrialSpy() as spy2:
        _, resumed = run_hyperparameter_scan(*args, n_outer=HYPERSCAN_RESUME, **kw)
    kept = all(a.lambdas == b_.lambdas and a.score == b_.score
               for a, b_ in zip(resumed, trials))
    say("12b resume", loaded=len(trials), trials=len(resumed), run=len(spy2.trials),
        loaded_unchanged=kept)
    if len(resumed) != HYPERSCAN_RESUME or len(spy2.trials) != HYPERSCAN_RESUME - len(trials) \
            or not kept:
        raise AssertionError("12b: the resume did not load 20 trials and run 2")
    done = sum(t.state == "complete" for t in resumed)
    want_files = {"scan_results_trials.csv", "optimization_history.png"}
    want_files |= {"param_importance.png"} if done >= 3 else set()
    want_files |= {"parallel_coordinates.png"} if done >= 2 else set()
    got_files = set(os.listdir(report_dir))
    sizes = {f: png_check(report_dir / f) for f in sorted(got_files) if f.endswith(".png")}
    say("12b scan report", files=sorted(got_files), png_sizes=sizes, completed=done)
    if got_files != want_files:
        raise AssertionError(f"12b: scan_report wrote {sorted(got_files)}")
    return {f"hyperscan-{cfg.scan_trials}x{cfg.scan_inner_gens}x{cfg.scan_inner_pop}": launches}


class MotpeClock:
    """Host seconds of MOTPE's asks and tells, and the host clock of each
    batch's evaluation (ended by its read of F) with its table launches,
    inside run_global_fit(optimizer="optuna")."""

    def __init__(self):
        self.ask = self.tell = 0.0
        self.evals: list = []

    def __enter__(self):
        clock = self

        class Timed(MOTPESampler):
            def ask_batch(self, n):
                t0 = time.perf_counter()
                out = super().ask_batch(n)
                clock.ask += time.perf_counter() - t0
                return out

            def tell_batch(self, X, F):
                t0 = time.perf_counter()
                super().tell_batch(X, F)
                clock.tell += time.perf_counter() - t0

        real_eval = optimize_mod.make_batched_evaluate

        def timed_eval(objective, **kw):
            evaluate = real_eval(objective, **kw)

            def run(X):
                before, t0 = phi_tables.launches, time.perf_counter()
                F = evaluate(X)
                clock.evals.append((time.perf_counter() - t0, phi_tables.launches - before))
                return F
            return run
        self.saved = (optimize_mod.MOTPESampler, real_eval)
        optimize_mod.MOTPESampler, optimize_mod.make_batched_evaluate = Timed, timed_eval
        return self

    def __exit__(self, *exc):
        optimize_mod.MOTPESampler, optimize_mod.make_batched_evaluate = self.saved


def phase_motpe(p, card) -> tuple[dict, object]:
    """12c: run_global_fit(optimizer="optuna") on the loaded problem at
    float32 with the Fréchet pick: ms an ask batch on the host beside ms
    an evaluation, the host share, the launches (one an evaluation).
    Returns ({path: launches}, the fit's result)."""
    cfg = p["cfg"]
    fit_args = (*problem_args(p), p["lambdas"], p["grid"], p["xl"], p["xu"])
    reset_counts()
    t0 = time.perf_counter()
    with MotpeClock() as clock:
        res = run_global_fit(*fit_args, optimizer="optuna", n_trials=MOTPE_TRIALS, seed=cfg.seed,
                             y0=p["y0"], frechet_pick=True, df_prot=p["prot"], df_rna=p["rna"],
                             df_pho=p["pho"], t_points=(p["tp"], p["tr"], p["tp"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    n_batch = -(-MOTPE_TRIALS // optimize_mod.MOTPE_BATCH)
    eval_s = sum(s for s, _ in clock.evals)
    host = clock.ask + clock.tell
    if len(clock.evals) != n_batch or any(n != 1 for _, n in clock.evals) \
            or launches["phi_tables"] <= n_batch or launches != expect(
                phi_tables=launches["phi_tables"]) or not np.isfinite(res.F).all() \
            or not 0 <= res.best_idx < len(res.pareto_X):
        raise AssertionError(f"12c: launches {launches}, evaluations {clock.evals}, "
                             f"best {res.best_idx} of {len(res.pareto_X)}")
    say("12c motpe", trials=len(res.X), batches=n_batch, config_trials=cfg.n_trials,
        ms_per_ask_batch=f"{1e3 * clock.ask / n_batch:.2f}",
        ms_per_evaluation=f"{1e3 * eval_s / n_batch:.2f}",
        ms_per_tell_batch=f"{1e3 * clock.tell / n_batch:.3f}",
        host_share=f"{host / (host + eval_s):.3f}", wall_s=f"{wall:.2f}",
        pareto=len(res.pareto_X), best_idx=res.best_idx,
        best_score=f"{float(res.frechet_scores[res.best_idx]):.6g}", launches=launches,
        card=repr(card))
    return {f"motpe-{MOTPE_TRIALS}": launches}, res


def phase_motpe_float64(p, card) -> None:
    """12c: MOTPE at float64 on the card against float64 on the CPU at 48
    trials: X equal, F within 1e-9."""
    cfg = p["cfg"]
    system = p["system"]
    cpu = GlobalSystem(system.topo, system.kin_grid, system.Kmat, custom_y0=p["y0"],
                       dtype=torch.float64, device="cpu")
    kw = dict(optimizer="optuna", n_trials=MOTPE_F64_TRIALS, seed=cfg.seed, y0=p["y0"],
              frechet_pick=False)
    rest = (*problem_args(p)[1:], p["lambdas"], p["grid"], p["xl"], p["xu"])
    t0 = time.perf_counter()
    got = run_global_fit(system.astype(torch.float64), *rest, **kw)
    card_s = time.perf_counter() - t0
    want = run_global_fit(cpu, *rest, **kw)
    same_x = np.array_equal(got.X, want.X)
    rel = float(np.max(np.abs(got.F - want.F) / np.abs(want.F))) if same_x else float("inf")
    say("12c motpe float64", trials=MOTPE_F64_TRIALS, X_identical=same_x,
        F_max_rel_err=f"{rel:.3e}", gate=MOTPE_F64_RTOL, card_seconds=f"{card_s:.2f}",
        card=repr(card))
    if not (same_x and rel <= MOTPE_F64_RTOL):
        raise AssertionError(f"12c: float64 MOTPE on the card vs the CPU: X equal {same_x}, "
                             f"F {rel:.3e}")


def pick_job(hb: dict, theta, grids, y0, max_steps: int, device: str):
    """12d in a worker process: simulate_and_measure of the picked member
    (RK45) at float64 on ``device``; on the CPU also RK45's success and
    steps. Returns (tables, seconds, success or None, steps or None)."""
    torch.set_num_threads(1)
    system = GlobalSystem(hb["topo"], hb["kin_grid"], hb["Kmat"], custom_y0=y0,
                          dtype=torch.float64, device=device)
    params = {k: v[0] for k, v in unpack_params(
        torch.as_tensor(theta, dtype=torch.float64, device=device), hb["slices"],
        hb["topo"]).items()}
    t0 = time.perf_counter()
    tables = simulate_and_measure(system, params, *grids, max_steps=max_steps, y0=y0)
    seconds = time.perf_counter() - t0
    if device != "cpu":
        return tables, seconds, None, None
    res = simulate(system, params, np.unique(np.concatenate(grids)), max_steps=max_steps, y0=y0)
    return tables, seconds, bool(res.success), int(res.n_steps)


def start_pick_measurements(p, res, pool) -> tuple:
    """Submit 12d for the picked member of ``res``: at float64 on the card
    and on the CPU, each in a worker process. Returns the two futures."""
    system = p["system"]
    hb = {"topo": system.topo, "kin_grid": system.kin_grid, "Kmat": system.Kmat,
          "slices": p["slices"]}
    args = (hb, res.pareto_X[res.best_idx][None], (p["tp"], p["tr"], p["tp"]), p["y0"],
            p["cfg"].ode_max_steps)
    return pool.submit(pick_job, *args, "cuda"), pool.submit(pick_job, *args, "cpu")


def fc_errors(got, want) -> tuple[list, list]:
    """Per table: the largest relative error of pred_fc and where it is
    (curve, time, the reference's fold change)."""
    rel, where = [], []
    for g, w in zip(got, want):
        if list(g["protein"]) != list(w["protein"]) or not np.array_equal(g["time"], w["time"]):
            raise AssertionError("12d: the measurement tables' rows differ")
        r = np.abs(g["pred_fc"] - w["pred_fc"]) / np.abs(w["pred_fc"])
        i = int(np.argmax(r))
        curve = (w["protein"][i], w["psite"][i]) if "psite" in w else w["protein"][i]
        rel.append(float(r[i]))
        where.append((curve, float(w["time"][i]), f"{w['pred_fc'][i]:.4g}"))
    return rel, where


def phase_pick_measure(p, on_card, on_cpu, card) -> None:
    """12d: simulate_and_measure (RK45, up to the config's ``ode_max_steps``:
    the pick of a short MOTPE run is stiff) of the picked member at
    float64 on the card against the CPU's float64, both in worker
    processes started after 12c's pick: RK45 succeeds on the CPU, and
    every predicted fold change on the card is within 1e-3 relative.
    (Float32 on the card was 1.411e-03 from it on a phospho fold change
    of 0.0007715, where RK45's atol bounds the error: PERF.md §6; the
    float32 RK45 path is checked in 4d and 5c.)"""
    t0 = time.perf_counter()
    got, card_s, _, _ = on_card.result()
    want, cpu_s, success, steps = on_cpu.result()
    waited = time.perf_counter() - t0
    rel, where = fc_errors(got, want)
    finite = all(np.isfinite(t["pred_fc"]).all() for t in got)
    say("12d pick measured", rows=[len(t["pred_fc"]) for t in got], cpu_rk45_success=success,
        cpu_rk45_steps=steps, max_steps=p["cfg"].ode_max_steps, dtype="float64",
        max_rel_err=[f"{e:.3e}" for e in rel], worst_at=where, gate=PICK_RTOL,
        card_seconds=f"{card_s:.2f}", card_ms_per_step=f"{1e3 * card_s / steps:.2f}",
        cpu_seconds=f"{cpu_s:.2f}", waited_after_12b_s=f"{waited:.2f}", card=repr(card))
    if not (success and finite and max(rel) <= PICK_RTOL):
        raise AssertionError(f"12d: the pick's measurements on the card vs the CPU: {rel} "
                             f"(CPU RK45 success {success})")


def phase_hyperscan_motpe(card, b) -> dict:
    """12: the data-in layer (12a), the scan (12b), MOTPE (12c) and the
    pick's measurements (12d) on the bench network read from input files.
    Returns {path: launches}."""
    import tempfile
    from pathlib import Path

    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(max_workers=2, mp_context=get_context("spawn"))
    try:
        with tempfile.TemporaryDirectory(prefix="phoskintime_inputs_") as tmp:
            root = Path(tmp)
            p = phase_data_in(b, root, card)
            paths, res = phase_motpe(p, card)
            # 12d's two RK45 runs (host-bound) go on in workers beside 12b
            on_card, on_cpu = start_pick_measurements(p, res, pool)
            paths.update(phase_hyperscan(p, root, card))
            phase_motpe_float64(p, card)
            phase_pick_measure(p, on_card, on_cpu, card)
    finally:
        pool.shutdown(cancel_futures=True)
    say("12 data in/hyperscan/motpe", seconds=f"{time.perf_counter() - t0:.1f}", card=repr(card))
    return paths


# --- 13: the entry points ---------------------------------------------------------------


def phase_entry_subprocess(card) -> None:
    """13a: ``python -m phoskintime_tpu_torch --help`` and an import of the
    CLI, the runner and the exporters, each in a fresh interpreter."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    helped = subprocess.run([sys.executable, "-m", "phoskintime_tpu_torch", "--help"],
                            capture_output=True, text=True, timeout=120, cwd=root)
    commands = ("prep", "tfopt", "kinopt", "model", "global-model", "mechanisms",
                "fitanalysis", "diagram", "all", "clean")
    missing = [c for c in commands if c not in helped.stdout]
    code = ("import sys, phoskintime_tpu_torch.cli, phoskintime_tpu_torch.network.runner, "
            "phoskintime_tpu_torch.io.export, phoskintime_tpu_torch.analysis.influence, "
            "phoskintime_tpu_torch.report, phoskintime_tpu_torch.report.draw, "
            "phoskintime_tpu_torch.report.plotter, phoskintime_tpu_torch.report.dashboard, "
            "phoskintime_tpu_torch.report.diagram, phoskintime_tpu_torch.analysis.fitpanels, "
            "phoskintime_tpu_torch.analysis.embed; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'pandas', "
            "'matplotlib', 'PIL', 'plotly', 'streamlit', 'sklearn', 'seaborn', "
            "'phoskintime_tpu')))")
    imported = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=120, cwd=root)
    say("13a entry points", help_rc=helped.returncode, missing_commands=missing,
        import_rc=imported.returncode, foreign_modules=imported.stdout.strip(),
        seconds=f"{time.perf_counter() - t0:.2f}")
    if helped.returncode or missing or imported.returncode or imported.stdout.strip() != "[]":
        raise AssertionError(f"13a: {helped.stderr[-2000:]} {imported.stderr[-2000:]}")


def tables_per_call(topo) -> dict:
    """{kernel: launches} of the table kernels in one population-objective
    chunk or one batched ETD2RK simulation: one a width class (the classes
    of ``expo.width_classes``, or the full width), each to its kernel by
    width (``phi_tables`` w <= 8, ``phi_tables_wide`` 9..17,
    ``phi_tables_xwide`` 18..129, ``phi_tables_stream`` past 129); none for
    model 4 (its exponential-Rosenbrock path builds no table)."""
    widths = [] if topo.model == 4 else [wc for wc, _ in expo.width_classes(topo)] or [topo.width]
    return {"phi_tables": sum(w <= 8 for w in widths),
            "phi_tables_wide": sum(8 < w <= 17 for w in widths),
            "phi_tables_xwide": sum(17 < w <= 129 for w in widths),
            "phi_tables_stream": sum(w > 129 for w in widths)}


class Solve(NamedTuple):
    """One RK45 ``simulate_batched`` call the entry points made: the model,
    the output times, the loop's iterations (the slowest member's steps),
    whether every member succeeded, the passes a graph replay held (0: the
    eager loop) and, for a one-member call, its trajectory (T, d) on the
    host."""
    model: int
    times: np.ndarray
    steps: int
    success: bool
    graphed: int
    ys: np.ndarray | None

    def row(self) -> tuple:
        return self.model, self.steps, self.success, self.graphed


class EntrySpy:
    """Records, while the entry points run, every population-objective call
    (the topology and the members) and every RK45 ``simulate_batched``
    call reached through ``simulate`` (:class:`Solve`)."""

    def __init__(self):
        self.calls, self.solves, self.passes = [], [], []
        self.real = (optimize_mod.make_population_objective, sim_mod.simulate_batched,
                     sim_mod.odeint_rk45)

    def __enter__(self):
        make, batched, odeint = self.real

        def make_spy(system, *a, **kw):
            objective = make(system, *a, **kw)

            def counted(thetas):
                self.calls.append((system.topo, int(thetas.shape[0])))
                return objective(thetas)
            return counted

        def odeint_spy(*a, graph_steps=0, **kw):
            self.passes.append(graph_steps)
            return odeint(*a, graph_steps=graph_steps, **kw)

        def batched_spy(system, params_b, t_eval, *a, **kw):
            n = len(self.passes)
            res = batched(system, params_b, t_eval, *a, **kw)
            if len(self.passes) > n:            # RK45, not ETD2RK or ESDIRK
                ys = res.ys[0].cpu().numpy() if res.ys.shape[0] == 1 else None
                self.solves.append(Solve(system.topo.model, np.asarray(t_eval, float),
                                         int(res.n_steps.max()), bool(res.success.all()),
                                         self.passes[-1], ys))
            return res
        optimize_mod.make_population_objective = make_spy
        sim_mod.simulate_batched, sim_mod.odeint_rk45 = batched_spy, odeint_spy
        return self

    def __exit__(self, *exc):
        (optimize_mod.make_population_objective, sim_mod.simulate_batched,
         sim_mod.odeint_rk45) = self.real

    def predicted(self, picks) -> dict:
        """The launch counts the code predicts: the tables once a width
        class a chunk of each objective call and of each topology's picks
        (``picks``: [topo], one batched ETD2RK simulation each), the flux 7
        times an iteration plus 2 in each model-2 RK45 simulation."""
        tables = dict.fromkeys(("phi_tables", "phi_tables_wide", "phi_tables_xwide",
                                "phi_tables_stream"), 0)
        for topo, chunks in ([(topo, -(-members // _auto_pop_chunk(topo.N)))
                              for topo, members in self.calls] + [(t, 1) for t in picks]):
            for k, n in tables_per_call(topo).items():
                tables[k] += n * chunks
        flux = sum(7 * s.steps + 2 for s in self.solves if s.model == 2)
        return expect(**tables, hypercube_flux=flux)


class WriterSpy:
    """Times, while the runner writes, each HTML and figure writer (ended by
    a synchronize of the card) and keeps what the knockout explorer's
    scenarios returned (its fold changes, on the host)."""

    HTML = ((interactive_mod, "pareto_explorer_from_frames"),
            (influence_mod, "write_influence_html"),
            (influence_mod, "export_global_knockout_explorer"),
            (live_model_mod, "write_live_model_explorer"),
            (html_mod, "create_report"))
    # the writers of the runner's ``figures`` stage (the correlation heatmap,
    # drawn at most 200 parameters, is timed with its table under ``exports``)
    FIGURES = ((export_mod, "plot_gof_solutions"),
               (export_mod, "plot_s_rates_report"), (export_mod, "process_convergence_history"),
               (export_mod, "create_convergence_video"),
               (export_mod, "save_all_gene_timeseries"), (plotter_mod, "plot_pareto_3d"),
               (plotter_mod, "plot_convergence"), (plotter_mod, "plot_parallel_coords_pareto"),
               (dashboard_mod, "save_dashboard_bundle"))
    TIMED = HTML + FIGURES

    def __init__(self):
        self.seconds, self.scenarios = {}, []
        self.real = [getattr(m, n) for m, n in self.TIMED] + [influence_mod.knockout_scenarios]

    def __enter__(self):
        def timing(name, fn):
            def timed_call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
                return out
            return timed_call

        def scenarios(*a, **kw):
            out = self.real[-1](*a, **kw)
            self.scenarios.append(out)
            return out
        for (m, n), fn in zip(self.TIMED, self.real):
            setattr(m, n, timing(n, fn))
        influence_mod.knockout_scenarios = scenarios
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.TIMED, self.real):
            setattr(m, n, fn)
        influence_mod.knockout_scenarios = self.real[-1]


def capped_or_succeeded(steps: int, success: bool, max_steps: int = 5000) -> bool:
    """RK45 reached its end, or stopped at the step cap that the JAX
    package's ``simulate_and_measure`` sets by default (the trajectory past
    there is the zero state, as the JAX package writes it), and did not
    fail otherwise."""
    return success or steps == max_steps


def mechanisms_job(root: str) -> dict:
    """13c, in a spawned worker: ``mechanisms`` through ``cli.main`` on the
    card with this process's counts set to 0 just before and read just
    after; the predicted counts, the selection table and the seconds."""
    from phoskintime_tpu_torch import cli

    out_dir = f"{root}/mechanisms"
    reset_counts()
    t0 = time.perf_counter()
    with EntrySpy() as spy:
        sel = cli.main(["mechanisms", "--config", f"{root}/config.toml", "--out-dir", out_dir,
                        "--n-gen", str(MECH_GENS), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    picks = list({id(t): t for t, _ in spy.calls}.values())      # one pick a model
    return dict(launches=launches, predicted=spy.predicted(picks), seconds=seconds,
                calls=[(t.model, m) for t, m in spy.calls],
                solves=[s.row() for s in spy.solves],
                table={k: np.asarray(v).tolist() for k, v in sel.table.items()},
                files=sorted(os.listdir(out_dir)))


def runner_files(out_dir, kinases) -> set:
    """The files global-model writes, derived from the run in ``out_dir``:
    :data:`RUNNER_TABLES`; the influence cascades of ``kinases``; the
    correlation heatmap at up to 200 parameters; one
    ``gof_solutions/gof_sol<id>.png`` for each id of the trajectory
    summary; one ``gene_timeseries/ts_<protein>.png`` for each protein of
    any written observation or prediction table; the S-rate PDF where
    ``S_rates_picked.csv`` has rows; the convergence figures and the
    animation, since ``convergence_history.csv`` holds generations."""
    from pathlib import Path

    from phoskintime_tpu_torch.io.utils import read_csv

    out_dir = Path(out_dir)
    files = set(RUNNER_TABLES) | {f"influence/cascade_{k}.csv" for k in kinases}
    files |= {"convergence.png", "convergence_plot.png", "optimization_history.gif"}
    if np.load(out_dir / "pareto_X.npy").shape[1] <= HEATMAP_MAX_PARAMS:
        files.add("param_correlations.png")
    ids = read_csv(out_dir / "pareto_trajectories_summary.csv")["sol_id"]
    files |= {f"gof_solutions/gof_sol{int(i)}.png" for i in ids}
    proteins = set()
    for kind in ("obs", "pred"):
        for m in ("protein", "rna", "phospho"):
            proteins |= {str(v) for v in read_csv(out_dir / f"trajectories_{kind}_{m}.csv")
                         .get("protein", [])}
    files |= {f"gene_timeseries/ts_{v}.png" for v in proteins}
    if len(read_csv(out_dir / "S_rates_picked.csv")["S"]):
        files.add("S_rates_report.pdf")
    return files


def png_check(path) -> tuple[int, int]:
    """A PNG file checked without an image library: the signature, every
    chunk's CRC-32, 8-bit RGB or RGBA, the inflated IDAT exactly (1 + w x
    channels) x h bytes with valid filter bytes. Returns (w, h)."""
    import struct
    import zlib

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG signature")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big"):
            raise AssertionError(f"{path}: bad CRC in its {kind!r} chunk")
        if kind == b"IHDR":
            head = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype = head
    raw = zlib.decompress(b"".join(idat))
    rows = np.frombuffer(raw, np.uint8)
    if depth != 8 or ctype not in (2, 6) or len(raw) != h * (1 + w * (3 if ctype == 2 else 4)):
        raise AssertionError(f"{path}: IHDR {head} against {len(raw)} inflated bytes")
    if (rows.reshape(h, -1)[:, 0] > 4).any():
        raise AssertionError(f"{path}: a scanline with an unknown filter")
    return w, h


def gif_frames(path) -> int:
    """The image count of a GIF file, walked block by block."""
    d = open(path, "rb").read()
    if d[:6] not in (b"GIF87a", b"GIF89a"):
        raise AssertionError(f"{path}: not a GIF")
    pos = 13 + (3 * 2 ** ((d[10] & 7) + 1) if d[10] & 0x80 else 0)
    frames = 0

    def skip(p):
        while d[p]:
            p += d[p] + 1
        return p + 1
    while d[pos] != 0x3B:
        if d[pos] == 0x21:
            pos = skip(pos + 2)
        elif d[pos] == 0x2C:
            frames += 1
            flags = d[pos + 9]
            pos += 10 + (3 * 2 ** ((flags & 7) + 1) if flags & 0x80 else 0)
            pos = skip(pos + 1)
        else:
            raise AssertionError(f"{path}: unknown block {d[pos]:#x} at {pos}")
    return frames


def pdf_check(path) -> int:
    """A PDF's cross-reference table (each in-use entry at ``<n> 0 obj``)
    and its page count (the page tree's /Count)."""
    data = open(path, "rb").read()
    start = int(re.search(rb"startxref\s+(\d+)", data).group(1))
    m = re.match(rb"xref\s+0 (\d+)\s+", data[start:])
    count, pos = int(m.group(1)), start + m.end()
    for n in range(1, count):
        off = int(data[pos + 20 * n: pos + 20 * n + 10])
        if not data[off:].startswith(f"{n} 0 obj".encode()):
            raise AssertionError(f"{path}: object {n} is not at its offset {off}")
    return int(re.search(rb"/Type /Pages /Kids \[[^\]]*\] /Count (\d+)", data).group(1))


def s_rate_pages(csv) -> int:
    """The pages ``plot_s_rates_report`` writes for the S-rate CSV: the AUC
    bars, early against late (where a site has both), and for each protein
    a heatmap and its top 24 sites' series, 12 a page."""
    from phoskintime_tpu_torch.io.utils import read_csv

    t = read_csv(csv)
    times = np.asarray(t["time"], float)
    late_cut = min(120.0, float(times.max()))
    sites: dict = {}
    for p, q, tt in zip(t["protein"], t["psite"], times):
        sites.setdefault(p, {}).setdefault(q, []).append(tt)
    both = any(min(ts) <= 2.0 and max(ts) >= late_cut for qs in sites.values()
               for ts in qs.values())
    return 1 + int(both) + sum(1 + -(-min(24, len(qs)) // 12) for qs in sites.values())


def video_frames(snapshots: int, max_frames: int = VIDEO_MAX_FRAMES) -> int:
    """The frames ``create_convergence_video`` draws from ``snapshots``:
    all, or every ceil(n / max_frames)-th with the last kept."""
    if snapshots <= max_frames:
        return snapshots
    step = -(-snapshots // max_frames)
    return len(range(0, snapshots, step)) + int((snapshots - 1) % step != 0)


def check_runner_figures(out: dict, out_dir, writers: WriterSpy, card) -> None:
    """13b's figures: every PNG decodes (its own decoder), the S-rate PDF's
    cross-reference and page count, the animation's frames against the
    fit's snapshots, ``report.html`` embedding each PNG, the bundle's front
    equal to the written arrays, and ``render_dashboard`` on the bundle;
    each figure writer's seconds."""
    import pickle
    import tempfile

    pngs = sorted(out_dir.rglob("*.png"))
    sizes = {str(p.relative_to(out_dir)): png_check(p) for p in pngs}
    pages = pdf_check(out_dir / "S_rates_report.pdf")
    want_pages = s_rate_pages(out_dir / "S_rates_picked.csv")
    frames = gif_frames(out_dir / "optimization_history.gif")
    want_frames = video_frames(len(out["result"].pop_history))
    report = (out_dir / "report.html").read_text()
    with open(out_dir / "dashboard_bundle.pkl", "rb") as fh:
        bundle = pickle.load(fh)
    same_front = (np.array_equal(bundle["pareto_F"], np.load(out_dir / "pareto_F.npy"))
                  and np.array_equal(bundle["pareto_X"], np.load(out_dir / "pareto_X.npy")))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        page = dashboard_mod.render_dashboard(str(out_dir / "dashboard_bundle.pkl"), tmp)
        dash_pngs = sorted(f for f in os.listdir(tmp) if f.endswith(".png"))
        for f in dash_pngs:
            png_check(f"{tmp}/{f}")
        dash_imgs = open(page).read().count("<img")
    dash_s = time.perf_counter() - t0
    fig_s = {n: f"{writers.seconds[n]:.3f}" for _, n in WriterSpy.FIGURES if n in writers.seconds}
    say("13b figures", pngs=len(pngs), gene_timeseries=sum(k.startswith("gene_timeseries/")
                                                          for k in sizes),
        gof=sorted(k for k in sizes if k.startswith("gof_solutions/")),
        sizes={k: v for k, v in sizes.items() if not k.startswith("gene_timeseries/")},
        pdf_pages=pages, predicted_pages=want_pages, gif_frames=frames,
        predicted_frames=want_frames, report_imgs=report.count("<img"),
        bundle_front_equal=same_front, dashboard_pngs=dash_pngs, dashboard_imgs=dash_imgs,
        render_dashboard_s=f"{dash_s:.2f}", writer_seconds=fig_s,
        figures_s=f"{out['seconds']['figures']:.2f}", card=repr(card))
    if not (pages == want_pages and frames == want_frames and report.count("<img") == len(pngs)
            and same_front and dash_pngs == ["convergence.png", "pareto_3d.png",
                                             "pareto_parallel.png"] and dash_imgs == 3
            and set(fig_s) == {n for _, n in WriterSpy.FIGURES}):
        raise AssertionError("13b: a figure check failed (see the line above)")


def phase_global_model(b, root, card) -> dict:
    """13b: global-model through cli.main on the card, in this process.
    Returns {path: launches}."""
    import pickle

    from phoskintime_tpu_torch import cli
    from phoskintime_tpu_torch.io.utils import read_csv

    out_dir = root / "global"
    reset_counts()
    t0 = time.perf_counter()
    with EntrySpy() as spy, WriterSpy() as writers:
        out = cli.main(["global-model", "--config", str(root / "config.toml"), "--out-dir",
                        str(out_dir), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    p = out["problem"]
    # the Fréchet pick, the trajectory export and the knockout explorer
    want = spy.predicted([p.topo, p.topo, p.topo])
    files = {str(f.relative_to(out_dir)) for f in out_dir.rglob("*") if f.is_file()}
    say("13b global-model", N=p.topo.N, n_theta=len(p.theta0), pop=p.cfg.pop,
        generations=p.cfg.n_gen, objective_calls=len(spy.calls), launches=launches,
        predicted=want, files=len(files), wall_s=f"{wall:.1f}", card=repr(card))
    say("13b stage seconds", **{k: f"{v:.2f}" for k, v in out["seconds"].items()},
        rk45=[s.row() for s in spy.solves])
    if launches != want:
        raise AssertionError(f"13b: launches {launches}, predicted {want}")
    want_files = runner_files(out_dir, p.topo.kinases[:2])
    if files != want_files:
        raise AssertionError(f"13b: files {sorted(files ^ want_files)} differ")
    check_runner_html(p, out, out_dir, writers, card)
    check_runner_figures(out, out_dir, writers, card)

    # the written front against a float64 re-evaluation on the card
    p64 = runner_mod.prepare(p.cfg, device="cuda", dtype=torch.float64)
    X, F = np.load(out_dir / "pareto_X.npy"), np.load(out_dir / "pareto_F.npy")
    F64 = make_population_objective(p64.system, p64.slices, p64.loss_data, p64.defaults,
                                    p.lambdas, p64.grid, y0=p64.y0)(
        torch.as_tensor(X, dtype=torch.float64, device="cuda")).cpu().numpy()
    f_err = float(np.max(np.abs(F - F64) / np.abs(F64)))

    # the written trajectories at the pick against float64 on the card, run
    # to the config's step cap; compared at the times the runner's float32
    # solve reached (past RK45's 5,000-step cap it writes the zero state's
    # fold changes, as the JAX runner does)
    with open(out_dir / "pymoo_optimization_result.pkl", "rb") as fh:
        res = pickle.load(fh)
    theta = res["pareto_X"][res["best_idx"]]
    times = np.unique(np.concatenate([p.tp_p, p.tp_r]))
    export = next(s for s in spy.solves if np.array_equal(s.times, times))
    reached = times[(times <= 0) | (export.ys != 0).any(axis=1)]
    t0 = time.perf_counter()
    with EntrySpy() as ref_spy:
        pred64 = simulate_and_measure(p64.system, runner_mod.best_params(p64, theta), p.tp_p,
                                      p.tp_r, p.tp_p, y0=p64.y0, max_steps=p.cfg.ode_max_steps)
    traj_s = time.perf_counter() - t0
    ref = ref_spy.solves[0]
    traj, compared, left_out = {}, {}, {}
    for name, want_t in zip(("protein", "rna", "phospho"), pred64):
        got_t = read_csv(out_dir / f"trajectories_pred_{name}.csv")
        on = np.isin(np.asarray(want_t["time"], float), reached)
        w = np.asarray(want_t["pred_fc"], float)[on]
        g = np.asarray(got_t["pred_fc"], float)[on]
        traj[name] = float(np.max(np.abs(g - w)) / np.max(np.abs(w)))
        compared[name], left_out[name] = int(on.sum()), int((~on).sum())
    ss = read_csv(out_dir / "steady_state_check.csv")
    sens = np.load(out_dir / "sensitivity.npz")
    finite = all(np.isfinite(sens[k]).all() for k in ("mu", "mu_star", "sigma"))

    # the graphed RK45 loop the card takes, bit for bit against the eager one
    params = runner_mod.best_params(p, theta)
    full = sim_mod.RK45_GRAPH_STEPS
    runs, loop_ms = [], []
    try:
        for g in (0, full):
            sim_mod.RK45_GRAPH_STEPS = g
            t1 = time.perf_counter()
            runs.append(simulate(p.system, params, times, y0=p.y0, max_steps=GRAPH_CHECK_STEPS))
            torch.cuda.synchronize()
            loop_ms.append(1e3 * (time.perf_counter() - t1) / max(int(runs[-1].n_steps), 1))
    finally:
        sim_mod.RK45_GRAPH_STEPS = full
    same = all(torch.equal(a, b_) for a, b_ in zip(*runs))
    graphed = all(s.graphed == full for s in spy.solves)
    say("13b checks", F_vs_float64_max_rel_err=f"{f_err:.3e}", tol=FIT_F_RTOL,
        pick_rk45_steps=export.steps, pick_rk45_success=export.success,
        float64_max_steps=p.cfg.ode_max_steps, float64_steps=ref.steps,
        float64_success=ref.success, times_reached=f"{len(reached)}/{len(times)}",
        trajectories_vs_float64_scaled_err={k: f"{v:.3e}" for k, v in traj.items()},
        rows_compared=compared, rows_left_out=left_out,
        traj_tol=TRAJ_RTOL, float64_pick_s=f"{traj_s:.2f}",
        steady_state_rows=len(ss["protein"]), N=p.topo.N, morris_finite=finite,
        converged=sum(v == "True" for v in ss["converged"]), rk45_all_graphed=graphed,
        graph_vs_eager_equal=same, graph_check_steps=int(runs[0].n_steps),
        ms_per_pass_eager=f"{loop_ms[0]:.3f}", ms_per_pass_graph=f"{loop_ms[1]:.3f}")
    if not (f_err <= FIT_F_RTOL and ref.success and capped_or_succeeded(export.steps,
                                                                          export.success)
            and all(compared.values()) and max(traj.values()) <= TRAJ_RTOL
            and len(ss["protein"]) == p.topo.N and finite and graphed and same):
        raise AssertionError("13b: a check failed (see the line above)")
    return {"runner-global-model": launches}


def check_runner_html(p, out: dict, out_dir, writers: WriterSpy, card) -> None:
    """13b's HTML: the knockout explorer's one scenario call, its float32
    fold changes from the card against the same call at float64 on the
    CPU, ``live_explorer.html`` against the page written from a CPU copy of
    the system, the Pareto explorer's front, each writer's seconds."""
    import tempfile

    from phoskintime_tpu_torch.io.utils import host

    params = {k: host(v) for k, v in out["params_best"].items()}
    sys_kw = dict(custom_y0=p.system.custom_y0, device="cpu")
    t0 = time.perf_counter()
    ko64 = influence_mod.knockout_scenarios(
        GlobalSystem(p.topo, p.system.kin_grid, p.Kmat, dtype=torch.float64, **sys_kw), params)
    cpu_s = time.perf_counter() - t0
    ko = writers.scenarios[0] if len(writers.scenarios) == 1 else None
    fc_err = (rel_err([ko["est"], ko["ko_est"]], [ko64["est"], ko64["ko_est"]])
              if ko is not None else float("nan"))
    with tempfile.TemporaryDirectory() as tmp:
        live_model_mod.write_live_model_explorer(
            f"{tmp}/live.html", GlobalSystem(p.topo, p.system.kin_grid, p.Kmat,
                                             dtype=torch.float32, **sys_kw),
            params, title="live global-model explorer", df_prot=p.df_prot, df_rna=p.df_rna,
            df_pho=p.df_pho)
        with open(f"{tmp}/live.html") as fh:
            live_cpu = fh.read()
    live = (out_dir / "influence" / "live_explorer.html").read_text()
    pareto = (out_dir / "pareto_interactive.html").read_text()
    front = json.loads(re.search(r"window\.__PARETODATA__ = (\{.*?\});</script>", pareto,
                                 re.DOTALL).group(1))["F"]
    F = np.load(out_dir / "pareto_F.npy")
    say("13b html", knockout_calls=len(writers.scenarios), K=p.topo.K,
        curves=None if ko is None else len(ko["curve_names"]),
        ko_fc_vs_float64_max_rel_err=f"{fc_err:.3e}", tol=KO_FC_RTOL,
        float64_cpu_s=f"{cpu_s:.2f}", live_page_equal_cpu_copy=live == live_cpu,
        live_page_bytes=len(live), pareto_members=len(front),
        report_bytes=(out_dir / "report.html").stat().st_size,
        writer_seconds={n: f"{writers.seconds[n]:.3f}" for _, n in WriterSpy.HTML
                        if n in writers.seconds}, card=repr(card))
    if not (ko is not None and ko["ko_est"].shape[0] == p.topo.K and fc_err <= KO_FC_RTOL
            and live == live_cpu and len(front) == len(F)
            and np.array_equal(front, np.round(np.nan_to_num(F), 4))
            and {n for _, n in WriterSpy.HTML} <= set(writers.seconds)):
        raise AssertionError("13b: an HTML check failed (see the line above)")


def check_mechanisms(job: dict, card, out_dir: str, n_proteins: int) -> dict:
    """13c's checks on the worker's result and its files in ``out_dir``
    (the bench inputs observe each of ``n_proteins`` proteins in both
    overlays' modalities). Returns {path: launches}."""
    table = job["table"]
    w = np.asarray(table["akaike_weight"], float)
    finite = all(np.isfinite(table[k]).all() for k in ("aic", "bic"))
    # each mechanism's RK45 pick: (model, steps, success, graph passes); a
    # pick stopped at the 5,000-step cap is ranked on its truncated
    # predictions, as the JAX package ranks it
    picks = {model: (steps, ok) for model, steps, ok, _ in job["solves"]}
    say("13c mechanisms", models=table["model"], mechanisms=table["mechanism"],
        aic=[f"{v:.1f}" for v in table["aic"]], akaike_weights=[f"{v:.4g}" for v in w],
        launches=job["launches"], predicted=job["predicted"],
        objective_calls=len(job["calls"]), rk45=job["solves"],
        pick_success={m: ok for m, (_, ok) in picks.items()},
        picks_at_step_cap=[m for m, (steps, ok) in picks.items() if not ok and steps == 5000],
        files=job["files"], seconds=f"{job['seconds']:.1f}", card=repr(card))
    if sorted(picks) != sorted(table["model"]) or len(job["solves"]) != len(picks) or not all(
            capped_or_succeeded(*v) for v in picks.values()):
        raise AssertionError(f"13c: an RK45 pick failed: {job['solves']}")
    if job["launches"] != job["predicted"] or not all(
            job["launches"][k] for k in ("phi_tables", "phi_tables_wide", "hypercube_flux")):
        raise AssertionError(f"13c: launches {job['launches']}, predicted {job['predicted']}")
    if len(table["model"]) != 4 or not finite or abs(w.sum() - 1.0) > 1e-6:
        raise AssertionError("13c: the selection table is not four finite rows")
    # the HTML summary holds the written table as table_html renders it
    from phoskintime_tpu_torch.io.utils import read_csv

    written = read_csv(f"{out_dir}/mechanism_selection_modelselection.csv")
    page = open(f"{out_dir}/mechanism_selection.html").read()
    rendered = html_mod.table_html(written, float_format=lambda v: f"{v:.4g}")
    best = f"Best mechanism by AIC: <b>{table['mechanism'][0]}</b>"
    say("13c html", page_bytes=len(page), table_in_page=rendered in page,
        best_named=best in page, written_rows=len(written["model"]))
    if rendered not in page or best not in page or written["model"].tolist() != table["model"]:
        raise AssertionError("13c: mechanism_selection.html does not hold the written table")
    # the overlays: min(6, N) panels, 3 a row, 4 x 3 inches each at 150 dpi
    panels = min(6, n_proteins)
    ncol = min(3, panels)
    want = (int(4 * ncol * 150), int(3 * -(-panels // ncol) * 150))
    sizes = {m: png_check(f"{out_dir}/overlay_{m}.png") for m in ("protein", "rna")}
    say("13c overlays", sizes=sizes, predicted=want)
    if any(v != want for v in sizes.values()):
        raise AssertionError(f"13c: overlay sizes {sizes}, predicted {want}")
    return {"mechanisms-select": job["launches"]}


def phase_entry_points(card, b) -> dict:
    """13: the bench bundle written as input files; 13c's worker started,
    13a and 13b here, then 13c's result read. Returns {path: launches}."""
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context
    from pathlib import Path

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="phoskintime_runner_") as tmp:
        root = Path(tmp)
        write_reference_inputs(b, root)
        (root / "config.toml").write_text(CONFIG_TOML + RUNNER_CONFIG)
        pool = ProcessPoolExecutor(max_workers=1, mp_context=get_context("spawn"))
        try:
            mech = pool.submit(mechanisms_job, str(root))
            phase_entry_subprocess(card)
            paths = phase_global_model(b, root, card)
            paths.update(check_mechanisms(mech.result(), card, f"{root}/mechanisms",
                                          b["topo"].N))
        finally:
            pool.shutdown(cancel_futures=True)
    say("13 entry points", seconds=f"{time.perf_counter() - t0:.1f}", card=repr(card))
    return paths


# --- 14: the fit commands' figures ---------------------------------------------------------

# phase 14: the commands that write the fit figures, on the bench inputs of
# phases 12-13 (the same files and config, with the weight fits' sections):
# ``model`` on three genes of different site counts, two of them as one
# cohort and one with bootstraps and Morris sensitivity (every writer
# process_gene calls); ``kinopt`` and ``tfopt --mode local`` with their
# fit-analysis panels and the KKT report; ``fitanalysis --which kinopt|tfopt``
# re-rendering the panels from the CSV sheets those runs wrote
FITFIG_CONFIG = """
[paths]
data_dir = "."

[kinopt]
loss_type = "base"
scaling_method = "none"

[tfopt]
loss_type = 5

[ode.inputs]
protein_excel = "input1.csv"
"""
FITFIG_BOOTSTRAPS = 8
#: the writers timed in phase 14 (module, function or class.method)
FITFIG_WRITERS = (
    ("report.diagram", "illustrate"),
    *(("report.plotter", f"Plotter.{m}") for m in (
        "plot_model_fit", "plot_gof", "plot_kld", "plot_time_state_grid", "plot_phase_space",
        "plot_params_bar", "plot_pca", "plot_parallel", "plot_knockouts", "plot_morris",
        "plot_perturbation_cloud")),
    *(("analysis.fitpanels", n) for n in (
        "goodness_of_fit_plot", "kld_plot", "pca_tsne_plots", "param_distribution_panels",
        "residual_panels", "sankey_html", "important_connections", "alpha_strips_per_mrna",
        "beta_bars_per_tf")),
    ("analysis.network_tools", "plot_signal_readout"),
    ("kinopt.kkt", "plot_constraint_violations"),
    ("kinopt.kkt", "plot_sensitivity_analysis"),
    ("report.html", "create_report"),
)
KINOPT_SHEETS = ("observed", "estimated", "alpha_values", "beta_values", "residuals",
                 "kinase_load", "edge_load", "target_fragility", "knockout_effects")
TFOPT_SHEETS = ("observed", "estimated", "alpha_values", "beta_values", "tf_load", "edge_load",
                "gene_fragility", "knockout_effects")
KKT_FILES = ("kkt_summary.tex", "active_constraints.csv", "lagrange_multipliers.csv",
             "high_sensitivity_sites.csv", "kkt_report.json", "constraint_violations.png",
             "sensitivity.png")
PANEL_FILES = ("Goodness_of_Fit.png", "kld.png", "PCA.png", "distribution_parameters.png",
               "boxplot_parameters.png", "cdf_parameters.png", "violin_parameters.png",
               "time_residuals.png", "variance_residuals.png", "error_trends.png",
               "residual_profiles.png", "network_sankey.html", "important_connections.png",
               "important_connections.csv")
TFOPT_DETAIL = 12          # fitpanels' max_detail: the mRNAs and TFs drawn one a figure


def gene_files(out) -> set:
    """The figures ``process_gene`` writes for one gene (a ``GeneOutput``),
    under the JAX pipeline's conditions, relative to the model's out_dir."""
    g = out.gene
    names = ["diagram", "model_fit", "gof", "kld", "state_grid", "phase"]
    res = out.result
    if res.ci is not None:
        names.append("params_ci")
    if res.boot_params is not None and len(res.boot_params) >= 3:
        names += ["pca", "parallel"]
    if out.knockout_solutions is not None:
        names.append("knockouts")
    if out.sensitivity is not None:
        names += ["morris", "perturb_0"]
    return {f"{g}/{g}_{n}.png" for n in names}


def model_files(outputs: dict) -> set:
    """The files ``model`` writes into its out_dir for {gene: GeneOutput}."""
    files = {"model_results_results.csv", "report.html"}
    for out in outputs.values():
        files |= gene_files(out)
    return files


def _sheet(data_dir, which: str, slug: str) -> dict:
    from phoskintime_tpu_torch.io.utils import read_csv

    return read_csv(f"{data_dir}/{which}_results_{slug}.csv")


def panel_files(data_dir, which: str) -> set:
    """The panels ``fit_analysis_from_workbook`` writes from the sheets in
    ``data_dir``: the fixed set, t-SNE from 8 profile rows, and for tfopt
    one alpha strip a mRNA and one beta figure a TF (the first 12 of
    each)."""
    est = _sheet(data_dir, which, "estimated")
    files = set(PANEL_FILES)
    if len(next(iter(est.values()))) >= 8:
        files.add("tSNE.png")
    if which == "tfopt":
        alpha, beta = _sheet(data_dir, which, "alpha_values"), _sheet(data_dir, which,
                                                                     "beta_values")
        mrna = list(dict.fromkeys(str(v) for v in alpha["mRNA"]))[:TFOPT_DETAIL]
        tfs = list(dict.fromkeys(str(v) for v in beta["TF"]))[:TFOPT_DETAIL]
        files |= {f"alpha_distribution_{g}.png" for g in mrna}
        files |= {f"TF_{t}_beta_group.png" for t in tfs}
    return files


def weight_fit_files(data_dir, which: str) -> set:
    """The files ``kinopt``/``tfopt`` write into the data folder with
    ``fit_analysis`` on: the result sheets, the panels and the readout
    figures in ``<which>_fitanalysis/`` and, for kinopt, the KKT report in
    ``kinopt_kkt/``."""
    sheets = KINOPT_SHEETS if which == "kinopt" else TFOPT_SHEETS
    files = {f"{which}_results_{s}.csv" for s in sheets}
    folder = f"{which}_fitanalysis"
    files |= {f"{folder}/{f}" for f in panel_files(data_dir, which)}
    load = _sheet(data_dir, which, "kinase_load" if which == "kinopt" else "tf_load")
    if len(next(iter(load.values()), ())):
        files |= {f"{folder}/{which}_{n}.png" for n in ("control_load_top", "breadth_vs_load")}
    ko = _sheet(data_dir, which, "knockout_effects")
    if len(ko.get("delta_auc_abs", ())):
        files |= {f"{folder}/{which}_{n}.png" for n in (
            "knockout_distribution", "knockout_top_activating", "knockout_top_suppressing")}
    if which == "kinopt":
        files |= {f"kinopt_kkt/{f}" for f in KKT_FILES}
    return files


class FigureClock:
    """Times each of :data:`FITFIG_WRITERS` while the commands run (the
    calls and the seconds, summed), and keeps the GeneOutput of every
    ``process_gene`` call."""

    def __init__(self):
        self.seconds, self.calls, self.genes = {}, {}, {}
        self.patched = []

    def __enter__(self):
        def timing(name, fn):
            def timed_call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
                self.calls[name] = self.calls.get(name, 0) + 1
                return out
            return timed_call

        for mod_name, attr in FITFIG_WRITERS:
            mod = importlib.import_module(f"phoskintime_tpu_torch.{mod_name}")
            owner, name = (getattr(mod, attr.split(".")[0]), attr.split(".")[1]) \
                if "." in attr else (mod, attr)
            real = getattr(owner, name)
            self.patched.append((owner, name, real))
            setattr(owner, name, timing(attr, real))
        real_gene = pipeline_mod.process_gene

        def gene(*a, **kw):
            out = real_gene(*a, **kw)
            self.genes[out.gene] = out
            return out
        self.patched.append((pipeline_mod, "process_gene", real_gene))
        pipeline_mod.process_gene = gene
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self.patched):
            setattr(owner, name, real)


def fit_figures_job(card: str) -> float:
    """Phase 14 in a spawned worker on the card, on the bench bundle built
    anew there (the same draws and observations): it launches no kernel
    and is host-bound, so it runs beside phases 13 and 15. Returns its
    seconds."""
    t0 = time.perf_counter()
    b = build_demo_network(N_PROTEINS, N_KINASES, seed=0, dtype=torch.float32, device="cpu")
    phase_fit_figures(card, b)
    return time.perf_counter() - t0


def start_fit_figures(card: str):
    """Starts :func:`fit_figures_job`; returns (pool, future)."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    pool = ProcessPoolExecutor(max_workers=1, mp_context=get_context("spawn"))
    return pool, pool.submit(fit_figures_job, card)


def finish_fit_figures(job) -> None:
    """Reads phase 14's worker (its checks raise there)."""
    pool, future = job
    t0 = time.perf_counter()
    try:
        seconds = future.result()
    finally:
        pool.shutdown()
    say("14 worker", seconds=f"{seconds:.1f}", waited=f"{time.perf_counter() - t0:.1f}")


def pick_genes(b) -> list:
    """Three proteins of the bench network with different site counts
    (1-5), the fewest sites first."""
    topo = b["topo"]
    by_count = {}
    for p, sites in zip(topo.proteins, topo.sites):
        if 1 <= len(sites) <= 5:
            by_count.setdefault(len(sites), p)
    counts = sorted(by_count)
    if len(counts) < 3:
        raise AssertionError(f"14: the bench network has site counts {counts} only")
    return [by_count[n] for n in counts[:3]], counts[:3]


def run_command(argv, root) -> tuple[dict, float]:
    """``cli.main(argv)`` with the counts set to 0 just before; (counts,
    seconds)."""
    from phoskintime_tpu_torch import cli

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    return counts(), time.perf_counter() - t0


def written_under(root) -> set:
    from pathlib import Path

    root = Path(root)
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def phase_fit_figures(card, b) -> None:
    """14: ``model``, ``kinopt``, ``tfopt`` and ``fitanalysis`` through
    ``cli.main`` on the card on the bench inputs: no kernel launched on the
    per-gene and weight-fit paths; each command's written file set equal
    to the one derived from its run (as the CPU tests derive it); every
    PNG through the script's own decoder; ``report.html`` embedding each
    gene's PNGs; each writer's calls and seconds."""
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    genes, n_sites = pick_genes(b)
    with tempfile.TemporaryDirectory(prefix="phoskintime_fitfig_") as tmp:
        root = Path(tmp)
        write_reference_inputs(b, root)
        (root / "kinopt_results_alpha_values.csv").unlink()     # kinopt writes its own
        (root / "config.toml").write_text(CONFIG_TOML + FITFIG_CONFIG)
        cfg = str(root / "config.toml")
        before = written_under(root)
        launches, seconds, files = {}, {}, {}
        with FigureClock() as clock:
            for key, argv in (
                    ("model-cohort", ["model", "--genes", *genes[:2], "--out-dir",
                                      str(root / "model_cohort")]),
                    ("model-boot-sens", ["model", "--genes", genes[2], "--bootstraps",
                                         str(FITFIG_BOOTSTRAPS), "--sensitivity", "--out-dir",
                                         str(root / "model_boot")]),
                    ("kinopt", ["kinopt", "--mode", "local"]),
                    ("tfopt", ["tfopt", "--mode", "local"])):
                launches[key], seconds[key] = run_command([*argv, "--config", cfg], root)
            after_fits = written_under(root)
            for which in ("kinopt", "tfopt"):
                key = f"fitanalysis-{which}"
                launches[key], seconds[key] = run_command(
                    ["fitanalysis", "--which", which, "--config", cfg, "--out-dir",
                     str(root / f"rerendered_{which}")], root)
        new = after_fits - before
        cohort = {g: clock.genes[g] for g in genes[:2]}
        files["model-cohort"] = ({f"model_cohort/{f}" for f in model_files(cohort)},
                                 {f for f in new if f.startswith("model_cohort/")})
        files["model-boot-sens"] = ({f"model_boot/{f}" for f in model_files(
            {genes[2]: clock.genes[genes[2]]})}, {f for f in new if f.startswith("model_boot/")})
        fits = {f for f in new if not f.startswith(("model_cohort/", "model_boot/"))}
        for which in ("kinopt", "tfopt"):
            files[which] = (weight_fit_files(root, which),
                            {f for f in fits if f.startswith(f"{which}_")})
            files[f"fitanalysis-{which}"] = (
                {f"rerendered_{which}/{f}" for f in panel_files(root, which)},
                {f for f in written_under(root) if f.startswith(f"rerendered_{which}/")})
        pngs = sorted(root.rglob("*.png"))
        sizes = [png_check(p) for p in pngs]
        reports = {}
        for d in ("model_cohort", "model_boot"):
            page = (root / d / "report.html").read_text()
            shown = {f.name for f in (root / d).rglob("*.png")}
            reports[d] = (page.count("<img"), len(shown),
                          all(f"<figcaption>{n}</figcaption>" in page for n in shown))
    boot = clock.genes[genes[2]]
    writer_s = {k: f"{v:.3f}" for k, v in sorted(clock.seconds.items())}
    total = time.perf_counter() - t0
    say("14 fit figures", genes=genes, sites=n_sites, bootstraps=FITFIG_BOOTSTRAPS,
        boot_params=None if boot.result.boot_params is None else len(boot.result.boot_params),
        sensitivity=boot.sensitivity is not None, launches=launches,
        files={k: len(got) for k, (_, got) in files.items()},
        missing={k: sorted(want - got) for k, (want, got) in files.items() if want - got},
        extra={k: sorted(got - want) for k, (want, got) in files.items() if got - want},
        pngs=len(pngs), png_px_min=min(sizes) if sizes else None, reports=reports,
        command_s={k: f"{v:.2f}" for k, v in seconds.items()}, writer_s=writer_s,
        writer_calls=clock.calls, seconds=f"{total:.1f}", card=repr(card))
    if any(n != expect() for n in launches.values()):
        raise AssertionError(f"14: a per-gene or weight-fit path launched a kernel: {launches}")
    if any(want != got for want, got in files.values()):
        raise AssertionError("14: a command's written files differ from its run's")
    if not pngs or any(not (n_img == n_png and all_in) for n_img, n_png, all_in
                       in reports.values()):
        raise AssertionError(f"14: report.html does not embed each gene's PNGs: {reports}")
    if boot.sensitivity is None or boot.result.boot_params is None:
        raise AssertionError("14: the bootstrap and sensitivity gene ran without them")


# --- 15: part 3 of the report layer: the thermal variant, the apps, the schematics, the
# network tools ---------------------------------------------------------------------------

THERMAL_TM_SEED = 17        # the melting temperatures: uniform in [36, 44] C, seeded
THERMAL_F64_GATE = 1e-9     # 15a: float64 on the card vs the CPU, of the largest fold change
THERMAL_T = 39.0            # 15b: the JAX package's test's temperature (just below Tm)
THERMAL_EXPO_GATE = 1e-3    # 15b: ETD2RK float32 vs float64, as the JAX test and phase 5b
# 15b's model-0 reference: RK45 at phase 8b's reference tolerances (RK45's defaults, rtol
# 1e-5, are 8e-3 from a tight solve of the thermal system at 39 C on the CPU)
THERMAL_RK45_TOLS = dict(rtol=1e-8, atol=1e-10, max_steps=200_000)
APP_KO_RTOL = 1e-12         # 15c: the knockout preview on the card vs the CPU, float64
FRECHET_GATE = 1e-12        # 15e: the similarity matrix on the card vs the CPU, float64
APP_FILES = ("identity_band.png", "breadth_load.png", "network_dag.png")
SCHEMATICS = ("kinopt_diagram", "kinopt_constraints", "tfopt_diagram", "tfopt_constraints",
              "global_diagram", "global_constraints", "fitted_network")


def melting_temperatures(n: int) -> np.ndarray:
    return np.random.default_rng(THERMAL_TM_SEED).uniform(36.0, 44.0, n)


def thermal_tables(out: dict) -> dict:
    """{label: [protein, RNA, phospho pred_fc]} of compare_thermal_standard's
    result, float64 numpy."""
    return {lab: [np.asarray(t["pred_fc"], float) for t in tables]
            for lab, tables in out.items()}


def part3_cpu_job(job: str, hb: dict) -> tuple:
    """One of phase 15's float64 references on the CPU, in a worker process:
    ``"thermal"`` 15a's compare_thermal_standard tables on the model-0
    bench network, ``"expo"`` 15b's model-2 thermal ETD2RK fold changes at
    THERMAL_T. Returns (result, seconds)."""
    from phoskintime_tpu_torch.analysis.thermal import compare_thermal_standard, thermalize

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    system = GlobalSystem(hb["topo"], hb["kin_grid"], hb["Kmat"], dtype=torch.float64,
                          device="cpu")
    Tm = melting_temperatures(hb["topo"].N)
    if job == "thermal":
        out = thermal_tables(compare_thermal_standard(system, hb["true"], Tm))
    else:
        sys_T, p_T = thermalize(system, hb["true"], THERMAL_T, Tm)
        out = port_fold_changes(sys_T, p_T, np.asarray(hb["grid"], float))
    return out, time.perf_counter() - t0


def start_part3_references(b, b2):
    """Starts the two :func:`part3_cpu_job` runs, each in its own spawned
    worker (they run beside the phases before 15); returns (pool, {job:
    future})."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    pool = ProcessPoolExecutor(max_workers=2, mp_context=get_context("spawn"))
    return pool, {job: pool.submit(part3_cpu_job, job, host_bundle(bb))
                  for job, bb in (("thermal", b), ("expo", b2))}


def max_scaled(got: list, want: list) -> float:
    """The largest |got - want| over the arrays, of the largest |want|."""
    scale = max(float(np.max(np.abs(w), initial=0.0)) for w in want) or 1.0
    return max(float(np.max(np.abs(g - w), initial=0.0)) for g, w in zip(got, want)) / scale


def flat_tables(tables: dict) -> list:
    return [a for lab in tables for a in tables[lab]]


def phase_thermal(b, card, cpu) -> dict:
    """15a: compare_thermal_standard on the model-0 bench network at its true
    parameters (seeded Tm): float32 on the card with each temperature's RK45
    steps and whether it stopped at the 5,000-step cap (a spy on
    simulate_batched), float64 on the card against the CPU's (the worker's)
    within THERMAL_F64_GATE of the largest fold change, the float32 result's
    distance from it, the figure decoded at its size. No launch."""
    import tempfile

    from phoskintime_tpu_torch.analysis.thermal import (DEFAULT_TEMPERATURES,
                                                        compare_thermal_standard)

    system, topo = b["system"], b["topo"]
    Tm = melting_temperatures(topo.N)
    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="phoskintime_thermal_") as tmp, \
            EntrySpy() as spy:
        out32 = compare_thermal_standard(system, b["true"], Tm, out_dir=tmp)
        torch.cuda.synchronize()
        sec32 = time.perf_counter() - t0
        size = png_check(os.path.join(tmp, "thermal_comparison.png"))
    t1 = time.perf_counter()
    out64 = compare_thermal_standard(system.astype(torch.float64), b["true"], Tm)
    torch.cuda.synchronize()
    sec64 = time.perf_counter() - t1
    launches = counts()
    f32, f64 = thermal_tables(out32), thermal_tables(out64)
    err64 = max_scaled(flat_tables(f64), flat_tables(cpu["thermal"][0]))
    err32 = max_scaled(flat_tables(f32), flat_tables(f64))
    solves = spy.solves
    labels = [lab for lab, _ in DEFAULT_TEMPERATURES]
    n_prot = min(topo.N, 6)
    want_size = (int(4 * len(labels) * 110), int(2.2 * n_prot * 110))
    say("15a thermal", N=topo.N, temperatures=labels,
        steps={lab: s.steps for lab, s in zip(labels, solves)},
        at_cap={lab: s.steps >= 5000 for lab, s in zip(labels, solves)},
        success={lab: s.success for lab, s in zip(labels, solves)},
        f64_card_vs_cpu=f"{err64:.3e}", gate=THERMAL_F64_GATE, f32_vs_f64=f"{err32:.3e}",
        figure_px=size, figure_px_want=want_size, f32_s=f"{sec32:.2f}",
        f64_s=f"{sec64:.2f}", cpu_s=f"{cpu['thermal'][1]:.2f}", launches=launches,
        card=repr(card))
    if len(solves) != len(labels) or not all(capped_or_succeeded(s.steps, s.success)
                                             for s in solves):
        raise AssertionError(f"15a: a thermal RK45 solve failed: {[s.row() for s in solves]}")
    if not err64 <= THERMAL_F64_GATE:
        raise AssertionError(f"15a: float64 on the card vs the CPU: {err64:.3e}")
    if size != want_size or launches != expect():
        raise AssertionError(f"15a: figure {size} (want {want_size}), launches {launches}")
    return {"thermal-rk45": launches}


def phase_thermal_expo(b, b2, card, cpu) -> dict:
    """15b: the thermal system at THERMAL_T through the batched ETD2RK path
    (the table kernels) at float32 on the card, the JAX package's test at
    full width: model 0 against a float64 RK45 solve of the thermal system
    on the card (THERMAL_RK45_TOLS), model 2 (bucketed) against the
    port's float64 ETD2RK on the CPU (the worker's, as phase 5b); the
    table launches predicted from the width classes and asserted."""
    from phoskintime_tpu_torch.analysis.thermal import thermalize

    paths = {}
    for bb in (b, b2):
        system, topo = bb["system"], bb["topo"]
        times = np.asarray(bb["grid"], float)
        sys_T, p_T = thermalize(system, bb["true"], THERMAL_T, melting_temperatures(topo.N))
        want = expect(**tables_per_call(topo))
        reset_counts()
        t0 = time.perf_counter()
        got = port_fold_changes(sys_T, p_T, times)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = counts()
        if topo.model == 0:
            sys64 = sys_T.astype(torch.float64)
            res = simulate(sys64, p_T, times, **THERMAL_RK45_TOLS)
            ref, ref_name = fold_changes_of(sys64, res.ys, times), "RK45 1e-8 float64 card"
            extra = {"rk45_steps": int(res.n_steps), "rk45_success": bool(res.success)}
        else:
            ref, ref_name, extra = cpu["expo"][0], "ETD2RK float64 CPU", {
                "cpu_s": f"{cpu['expo'][1]:.2f}"}
        err = rel_err(got, ref)
        say("15b thermal etd2rk", model=topo.model, N=topo.N, w=topo.width, T=THERMAL_T,
            max_rel_err=f"{err:.3e}", gate=THERMAL_EXPO_GATE, reference=ref_name,
            launches=launches, predicted=want, seconds=f"{sec:.2f}", **extra, card=repr(card))
        if not err < THERMAL_EXPO_GATE:
            raise AssertionError(f"15b model {topo.model}: {err:.3e} from {ref_name}")
        if launches != want:
            raise AssertionError(f"15b model {topo.model}: launches {launches}, want {want}")
        paths[f"thermal-model{topo.model}-etd2rk"] = launches
    return paths


def exact_fits():
    """The phase-11 problems at their generators' exact weights (alpha = 1 /
    per_site, the Dirichlet betas), for a run without phase 11's fits."""
    from types import SimpleNamespace

    kp = kinopt_synthetic(*KINOPT_PROBLEMS["bench"])
    ka = kp.gp_mask / kp.gp_mask.sum(1, keepdims=True)
    kb = kp.k_mask / kp.k_mask.sum(1, keepdims=True)
    tp = tfopt_synthetic(*TFOPT_PROBLEM)
    ta = tp.alpha_mask / tp.alpha_mask.sum(1, keepdims=True)
    tb = tp.beta_mask / tp.beta_mask.sum(1, keepdims=True)
    return {"kinopt": (kp, SimpleNamespace(alpha=ka, beta=kb)),
            "tfopt": (tp, SimpleNamespace(alpha=ta, beta=tb))}


def phase_apps(fits, root, card) -> dict:
    """15c: render_kinopt_app and render_tfopt_app on phase 11's local fits
    (their bench kinopt problem and the 500-gene tfopt one): the written
    files, every PNG decoded, the knockout preview (one batched predict on
    the card, float64, read by a spy) against the CPU's within APP_KO_RTOL;
    no launch. Returns {which: seconds}."""
    from phoskintime_tpu_torch.report import apps as apps_mod

    previews = {}
    real = {w: getattr(apps_mod, f"{w}_knockout_predictions") for w in ("kinopt", "tfopt")}

    def spy(which):
        def preview(prob, alpha, beta, device="cuda"):
            out = real[which](prob, alpha, beta, device)
            previews[which] = (prob, alpha, beta, out)
            return out
        return preview
    seconds = {}
    reset_counts()
    for which in ("kinopt", "tfopt"):
        setattr(apps_mod, f"{which}_knockout_predictions", spy(which))
    try:
        for which, render in (("kinopt", apps_mod.render_kinopt_app),
                              ("tfopt", apps_mod.render_tfopt_app)):
            prob, res = fits[which]
            t0 = time.perf_counter()
            render(prob, res, str(root / f"{which}_app"))
            seconds[which] = time.perf_counter() - t0
    finally:
        for which in real:
            setattr(apps_mod, f"{which}_knockout_predictions", real[which])
    launches = counts()
    files, errs, sizes = {}, {}, []
    for which in ("kinopt", "tfopt"):
        d = root / f"{which}_app"
        files[which] = written_under(d)
        want = set(APP_FILES) | {f"{which}_interactive.html", f"{which}_app.html"}
        if files[which] != want:
            raise AssertionError(f"15c {which}: wrote {sorted(files[which])}, want {sorted(want)}")
        sizes += [png_check(d / f) for f in APP_FILES]
        prob, alpha, beta, card_ko = previews[which]
        cpu_ko = real[which](prob, alpha, beta, "cpu")
        errs[which] = max_scaled([card_ko], [cpu_ko])
    prob_k, prob_t = fits["kinopt"][0], fits["tfopt"][0]
    say("15c apps", kinopt_sites=prob_k.n_gp, kinopt_kinases=prob_k.n_k,
        tfopt_genes=prob_t.n_genes, tfopt_tfs=prob_t.n_TF,
        knockouts={w: list(previews[w][3].shape) for w in previews},
        ko_card_vs_cpu={w: f"{e:.3e}" for w, e in errs.items()}, gate=APP_KO_RTOL,
        pngs=len(sizes), png_px_min=min(sizes), seconds={w: f"{s:.2f}" for w, s in
                                                         seconds.items()},
        launches=launches, card=repr(card))
    if any(e > APP_KO_RTOL for e in errs.values()):
        raise AssertionError(f"15c: the knockout preview on the card vs the CPU: {errs}")
    if launches != expect():
        raise AssertionError(f"15c: the apps launched {launches}")
    return seconds


def phase_diagram(fits, root, card) -> None:
    """15d: ``diagram --alpha-file`` through ``cli.main`` on a kinopt workbook
    that io/export writes from 15c's kinopt fit: the six schematics and the
    fitted network, each PNG decoded, the seconds of each figure at 300 dpi;
    no launch."""
    from phoskintime_tpu_torch.io.export import export_kinopt_results
    from phoskintime_tpu_torch.report import schematic as schematic_mod

    prob, res = fits["kinopt"]
    book = root / "kinopt_results.xlsx"
    export_kinopt_results(book, prob, res)
    (root / "config.toml").write_text("[paths]\n")
    real = schematic_mod.Diagram.render
    seconds = {}

    def timed(self, outfile, *a, **kw):
        t0 = time.perf_counter()
        out = real(self, outfile, *a, **kw)
        seconds[os.path.basename(str(outfile))] = time.perf_counter() - t0
        return out
    schematic_mod.Diagram.render = timed
    try:
        launches, total = run_command(["diagram", "--config", str(root / "config.toml"),
                                       "--alpha-file", str(book), "--out-dir",
                                       str(root / "diagrams")], root)
    finally:
        schematic_mod.Diagram.render = real
    files = written_under(root / "diagrams")
    want = {f"{n}.png" for n in SCHEMATICS}
    sizes = {f: png_check(root / "diagrams" / f) for f in sorted(files)}
    say("15d diagram", files=len(files), px=sizes, dpi=300,
        seconds={f: f"{s:.2f}" for f, s in seconds.items()}, command_s=f"{total:.2f}",
        launches=launches, card=repr(card))
    if files != want:
        raise AssertionError(f"15d: wrote {sorted(files)}, want {sorted(want)}")
    if launches != expect():
        raise AssertionError(f"15d: diagram launched {launches}")


def phase_network_tools(b, card) -> None:
    """15e: curve_similarity_matrix over the bench network's protein curves
    (normalized time, fold change; all pairs in one batched Fréchet DP on
    the card, float64) against the CPU's within FRECHET_GATE of the largest
    distance; cluster_curves (3 clusters) and export_subnetwork around the
    busiest protein (one hop). No launch."""
    from phoskintime_tpu_torch.analysis import network_tools as nt
    from phoskintime_tpu_torch.ops import frechet

    topo, prot = b["topo"], b["df_prot"]
    names = np.asarray(prot["protein"], dtype=object)
    t, fc = np.asarray(prot["time"], float), np.asarray(prot["fc"], float)
    curves = {p: np.column_stack([t[names == p] / t.max(), fc[names == p]])
              for p in topo.proteins if (names == p).any()}
    calls = []
    real = frechet.frechet_distance

    def counted(a, b_):
        calls.append(tuple(a.shape))
        return real(a, b_)
    reset_counts()
    frechet.frechet_distance = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = nt.curve_similarity_matrix(curves)
        sec = time.perf_counter() - t0
    finally:
        frechet.frechet_distance = real
    cpu_sim = nt.curve_similarity_matrix(curves, device="cpu")
    _, D = nt.similarity_matrix(sim)
    _, D_cpu = nt.similarity_matrix(cpu_sim)
    err = max_scaled([D], [D_cpu])
    clusters = nt.cluster_curves(sim, n_clusters=3)
    degree = (np.count_nonzero(topo.W_pad, axis=(1, 2)) + np.count_nonzero(topo.tf_mat, axis=0)
              + np.count_nonzero(topo.tf_mat, axis=1))
    center = topo.proteins[int(np.argmax(degree))]
    edges, nodes = nt.export_subnetwork(topo, center, radius=1)
    launches = counts()
    n = len(curves)
    say("15e network tools", curves=n, pairs=n * (n - 1) // 2, dp_calls=len(calls),
        batch=calls[0][0] if calls else 0, T=next(iter(curves.values())).shape[0],
        card_vs_cpu=f"{err:.3e}", gate=FRECHET_GATE, ms=f"{1e3 * sec:.1f}",
        cluster_sizes=np.bincount(clusters["cluster"]).tolist(), center=center,
        subnetwork_edges=len(edges["kind"]), subnetwork_nodes=len(nodes), launches=launches,
        card=repr(card))
    if not err <= FRECHET_GATE:
        raise AssertionError(f"15e: the similarity matrix on the card vs the CPU: {err:.3e}")
    if calls != [(n * (n - 1) // 2, *next(iter(curves.values())).shape)]:
        raise AssertionError(f"15e: the pairs took {len(calls)} DP calls: {calls}")
    if launches != expect() or not len(edges["kind"]):
        raise AssertionError(f"15e: launches {launches}, {len(edges['kind'])} edges")


def phase_part3(card, b, b2, fits, references) -> dict:
    """15: the thermal variant (15a, 15b), the apps (15c), ``diagram``
    (15d) and the network tools (15e). ``references``: the (pool, future)
    of :func:`start_part3_references`, read after 15c-15e. Returns {path:
    launches}."""
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    pool, futures = references
    try:
        paths = {}
        with tempfile.TemporaryDirectory(prefix="phoskintime_part3_") as tmp:
            phase_apps(fits, Path(tmp), card)
            phase_diagram(fits, Path(tmp), card)
        phase_network_tools(b, card)
        t1 = time.perf_counter()
        cpu = {job: f.result() for job, f in futures.items()}
        say("15 references", waited_s=f"{time.perf_counter() - t1:.1f}",
            cpu_s={job: f"{sec:.1f}" for job, (_, sec) in cpu.items()})
        paths.update(phase_thermal(b, card, cpu))
        paths.update(phase_thermal_expo(b, b2, card, cpu))
    finally:
        pool.shutdown(cancel_futures=True)
    say("15 report part 3", seconds=f"{time.perf_counter() - t0:.1f}", card=repr(card))
    return paths


# --- 3h: the widest tables ------------------------------------------------------------


def xwide_cpu_job(name: str) -> tuple:
    """3h's and 3i's CPU side, in a spawned worker: the network ``name`` of
    REFERENCE_NETWORKS at float32 with its observations by RK45 on the CPU
    (as every demo bundle's), as host data with theta0 and the bounds; its
    XWIDE_POP members; and the port's float64 objective of the first 8 on
    the CPU."""
    torch.set_num_threads(1)
    b = build_demo_network(**{**REFERENCE_NETWORKS, **XWIDE_NETWORKS}[name], dtype=torch.float32,
                           device="cpu")
    hb = {**host_bundle(b), **{k: b[k] for k in ("theta0", "xl", "xu")}}
    thetas = members(b["theta0"], XWIDE_POP)
    cpu = GlobalSystem(hb["topo"], hb["kin_grid"], hb["Kmat"], dtype=torch.float64,
                       device="cpu")
    F64 = make_population_objective(cpu, *(hb[k] for k in HOST_ARGS))(thetas[:8])
    return hb, thetas, F64.numpy()


def start_xwide_references(names=XWIDE_3H, refs=None):
    """Submit the :func:`xwide_cpu_job` runs of the networks ``names``, each
    in its own spawned worker of one pool (made where ``refs`` is None);
    returns ``refs``, (pool, {name: future})."""
    if refs is None:
        from concurrent.futures import ProcessPoolExecutor
        from multiprocessing import get_context

        refs = (ProcessPoolExecutor(max_workers=len(REFERENCE_NETWORKS),
                                    mp_context=get_context("spawn")), {})
    pool, futures = refs
    futures.update({name: pool.submit(xwide_cpu_job, name) for name in names})
    return refs


def card_system(hb, dtype=torch.float32):
    """The system of host data ``hb`` on the card at ``dtype``, and the
    objective's other arguments."""
    system = GlobalSystem(hb["topo"], hb["kin_grid"], hb["Kmat"], dtype=dtype, device="cuda")
    return (system, *(hb[k] for k in HOST_ARGS))


def xwide_ptxas() -> None:
    """The compiler's report of ``csrc/phi_tables_xwide.cu``'s instances
    (kept beside its library): registers and spills of each; fails on a
    spill."""
    log = cuda_build.library_path(phi_mod.XWIDE_SOURCE).with_suffix(".log").read_text()
    kernels = re.findall(r"Compiling entry function '(\w+)'", log)
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    say("3h ptxas", instances=len(kernels), registers=regs, spill_stores=spills)
    if not kernels or len(spills) < len(kernels) or any(spills):
        raise AssertionError(f"3h: phi_tables_xwide.cu spills or was not reported: {spills}")


def check_xwide(label, L, binv, h_u, ladder, card) -> dict:
    """3h's check of one class: the kernel against its plain version on the
    first XWIDE_CHECK_LANES lanes (scaled tolerance by type) and a NaN lane
    there, then on the whole class the kernel (CUDA events, kernel, kernel;
    and on the device), the plain version once and ``matrix_exp``, and the
    FMA bound. The plain version repeats the kernel's arithmetic one
    launch an operation: one call of it at w = 65 takes ~1-2 s, so past
    XWIDE_PLAIN_WHOLE_MAX_W it is timed on the checked lanes alone."""
    sub = L[..., :XWIDE_CHECK_LANES].contiguous()
    got, want = phi_tables(sub, binv, h_u, ladder), phi_tables_reference(sub, binv, h_u, ladder)
    torch.cuda.synchronize()
    errs = [scaled_err(g, w) for g, w in zip(got, want)]
    max_abs, worst = max(e[0] for e in errs), max(e[1] for e in errs)
    tol = SCALED_TOL[L.dtype]
    say(f"{label} check", shape=tuple(L.shape), lanes_checked=sub.shape[-1], pairs=len(binv),
        ladder=ladder, max_abs_err=f"{max_abs:.3e}", max_scaled_err=f"{worst:.3e}", tol=tol)
    if not worst <= tol:
        raise AssertionError(f"{label}: kernel disagrees with the plain version: {worst:.3e}")
    nan_lane_check(label, sub, binv, h_u, ladder)
    run_k = lambda: phi_tables(L, binv, h_u, ladder)  # noqa: E731
    k1, k2 = cuda_ms(run_k, 5), cuda_ms(run_k, 5)
    plain_L = L if L.shape[1] <= XWIDE_PLAIN_WHOLE_MAX_W else sub
    plain_ms = cuda_ms(lambda: phi_tables_reference(plain_L, binv, h_u, ladder), 1)
    M = augmented(L, binv, h_u)
    lib_ms = cuda_ms(lambda: torch.linalg.matrix_exp(M), 3)
    del M
    # float64's products run on the FP64 tensor cores: its bound at their
    # rate, and beside it the FP64 FMA pipes' (the first version's unit)
    f64 = L.dtype == torch.float64
    b = table_bound(L, binv, h_u, ladder, PEAK_FP64_TC_FLOPS if f64 else None)
    fma = {"bound_ms_fp64_fma": table_bound(L, binv, h_u, ladder).ms} if f64 else {}
    dev_ms = kernel_ms_on_device(run_k, "phi_tables_xwide_kernel", 5)
    ms = (k1 + k2) / 2
    say(f"{label} timing", ms=f"{ms:.4f}", device_ms=measured(dev_ms),
        plain_ms=f"{plain_ms:.4f}", plain_lanes=plain_L.shape[-1],
        library_ms=f"{lib_ms:.4f}", **bound_fields(b, dev_ms),
        **{k: f"{v:.4f}" for k, v in fma.items()},
        **({"share_of_fp64_fma_bound": share(fma["bound_ms_fp64_fma"], dev_ms)} if f64 else {}),
        runs_ms=[round(x, 4) for x in (k1, k2)], card=repr(card))
    # matrix_exp's workspace at w = 129 (tens of GB in float64) freed from
    # the allocator's cache: the RK45 workers of phase 4d share the card
    torch.cuda.empty_cache()
    return {"max_abs_err": max_abs, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "plain_lanes": plain_L.shape[-1], "bound_ms": b.ms, "bound_by": b.by,
            "bound_ms_measured_peak": b.ms_measured, **fma, "library_ms": lib_ms}


def nan_lane_check(label, L, binv, h_u, ladder) -> None:
    """A NaN in one lane (37, inside a block of the widest kernel's lanes)
    gives that lane NaN tables and leaves every other lane's bits as they
    were."""
    clean = phi_tables(L, binv, h_u, ladder)
    Ln = L.clone()
    Ln[..., 37] = float("nan")
    dirty = phi_tables(Ln, binv, h_u, ladder)
    torch.cuda.synchronize()
    keep = torch.arange(L.shape[-1], device=L.device) != 37
    same = all(torch.equal(c[..., keep], d[..., keep]) for c, d in zip(clean, dirty))
    nan = all(bool(torch.isnan(d[..., 37]).all()) for d in dirty)
    say(f"{label} nan lane", lanes=L.shape[-1], others_unchanged=same, lane_all_nan=nan)
    if not (same and nan):
        raise AssertionError(f"{label}: a NaN lane leaked into its neighbours or kept numbers")


def xwide_objective(label, args, thetas, F64, card, want, kernel="phi_tables_xwide") -> dict:
    """One population-objective call through the widest kernel (``kernel``):
    its launches against ``want``, F of the first 8 members against the
    CPU's float64 (PRECISION_GATE at float32, F64_OBJECTIVE_RTOL at
    float64), evals/s."""
    objective = make_population_objective(*args)
    objective(thetas[:8])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    F = objective(thetas)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = counts()
    F64 = torch.as_tensor(F64)
    rel = float(torch.max(torch.abs(F[:8].cpu().double() - F64) / torch.abs(F64)))
    tol = PRECISION_GATE if thetas.dtype == torch.float32 else F64_OBJECTIVE_RTOL
    say(f"{label} objective", pop=len(thetas), launches=launches, predicted=want,
        vs_f64_cpu=f"{rel:.3e}", tol=tol, seconds=f"{sec:.3f}",
        evals_per_s=f"{len(thetas) / sec:.1f}", card=repr(card))
    if tuple(F.shape) != (len(thetas), 3) or not bool(torch.isfinite(F).all()):
        raise AssertionError(f"{label}: non-finite or misshapen objectives")
    if launches != want or not launches[kernel]:
        raise AssertionError(f"{label}: kernel launches {launches}, predicted {want}")
    if not rel <= tol:
        raise AssertionError(f"{label}: {rel:.3e} from the CPU's float64")
    return launches


def phase_xwide_kernel(card, references) -> tuple[list, dict, dict, dict]:
    """3h: the widest table kernel (18 <= w <= 129): first its ptxas report,
    no spill in either instance. On model 2 at 6 sites (classes 2, 3, 33,
    65) and at 7 (2, 3, 5, 129) and model 0 with a 20-site protein (w = 22), pop
    XWIDE_POP: the objective's launches, one a width class and chunk, each
    class to its kernel by width, against the prediction from
    ``width_classes``; F against the CPU's float64 on 8 members; then the
    kernel at every class wider than 17 on the first chunk's own inputs,
    float32 and float64 (:func:`check_xwide`: against its plain version and
    a NaN lane on a lane subset; times, the FMA bound and share and
    ``matrix_exp`` on the whole class), and a float64 objective on the card.
    Returns (its two entries, float32 paths, float64 paths, {name: every
    started reference}, for 3i)."""
    t0 = time.perf_counter()
    xwide_ptxas()
    pool, futures = references
    try:
        out, paths32, paths64 = xwide_networks(card, futures)
        refs = {name: f.result() for name, f in futures.items()}
    finally:
        pool.shutdown(cancel_futures=True)
    say("3h xwide", seconds=f"{time.perf_counter() - t0:.1f}", budget_s=PHASE_BUDGET_S["3h"],
        card=repr(card))
    entries = []
    for dtype, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
        by_w = out[dtype]
        entries.append({"name": f"phi_tables_xwide{suffix}", "counter": "phi_tables_xwide",
                        "route": "cuda", "source": "phoskintime_tpu_torch/csrc/phi_tables_xwide.cu",
                        "replaces": "phoskintime_tpu/ops/phi_pallas.py:406", **by_w[65],
                        **{f"w{w}": by_w[w] for w in sorted(by_w) if w != 65}})
    return entries, paths32, paths64, refs


def xwide_networks(card, futures) -> tuple[dict, dict, dict]:
    """3h's checks of each network of XWIDE_3H, in their order, each
    as soon as its CPU reference is in (the 7-site one, the slowest, last).
    Returns ({dtype: {w: check}}, float32 paths, float64 paths)."""
    out = {torch.float32: {}, torch.float64: {}}
    paths32, paths64 = {}, {}
    for name in XWIDE_3H:
        t0 = time.perf_counter()
        hb, thetas_np, F64 = futures[name].result()
        say("3h references", name=name, seconds_waited=f"{time.perf_counter() - t0:.1f}")
        topo = hb["topo"]
        chunks = -(-XWIDE_POP // _auto_pop_chunk(topo.N))
        want = expect(**{k: n * chunks for k, n in tables_per_call(topo).items()})
        say("3h network", name=name, N=topo.N, sites=[len(x) for x in topo.sites],
            width_classes=[wc for wc, _ in expo.width_classes(topo)] or [topo.width],
            chunks=chunks)
        for dtype in (torch.float32, torch.float64):
            args = card_system(hb, dtype)
            thetas = torch.as_tensor(thetas_np, dtype=dtype, device="cuda")
            if dtype == torch.float32:
                paths32[f"{name}-pop{XWIDE_POP}"] = xwide_objective(
                    f"3h {name}", args, thetas, F64, card, want)
            else:
                few = thetas[:XWIDE_POP_F64]
                paths64[f"{name}-f64-pop{XWIDE_POP_F64}"] = xwide_objective(
                    f"3h {name} f64", args, few, F64, card,
                    expect(**tables_per_call(topo)))
            params_b = unpack_params(thetas[:_auto_pop_chunk(topo.N)], hb["slices"], topo)
            for L, binv, h_u, ladder in expo.table_inputs(args[0], params_b, hb["grid"]):
                w = L.shape[1]
                if w > 17:
                    label = f"3h xwide {name} w={w} {str(dtype).split('.')[-1]}"
                    out[dtype][w] = check_xwide(label, L, binv, h_u, ladder, card)
                del L
    return out, paths32, paths64


# --- 3i: the scan kernel past w = 17 and N = 256 ----------------------------------------


def scan_wide_ptxas() -> None:
    """The compiler's report of the wide kernel's eight builds (three
    variants, two types, wide-shared with a simple and a general build),
    kept beside ``csrc/etd2rk_scan.cu``'s two libraries: registers and
    spills of each; fails on a spill."""
    log = "".join(cuda_build.library_path(SCAN_SOURCE, part).with_suffix(".log").read_text()
                  for part, _ in cuda_build.parts(SCAN_SOURCE))
    builds = {}
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'")[0]
        inst = re.search(r"etd2rk_scan_wide_kernelI([fd])Li(\d+)ELb([01])E", name)
        if inst:
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores", part)
            what = f"{SCAN_VARIANTS[int(inst.group(2))]}{' multi' * (inst.group(3) == '1')}"
            key = f"{'float64' if inst.group(1) == 'd' else 'float32'} {what}"
            builds[key] = (int(regs.group(1)) if regs else None,
                           int(spill.group(1)) if spill else None)
    say("3i ptxas", instances=len(builds),
        builds={k: f"{r} registers, {sp} bytes spilled" for k, (r, sp) in builds.items()})
    if len(builds) != 8 or any(sp is None or sp for _, sp in builds.values()):
        raise AssertionError(f"3i: a wide scan build spills or was not reported: {builds}")


def scan_wide_members(w: int, N: int) -> int:
    """Members of a 3i random problem: several, but one from N = 4,096."""
    return 16 if N == 7 else 8 if N < 1024 else 2 if N < 4096 else 1


def scan_wide_random() -> dict:
    """3i's random problems: the kernel (one launch) against its plain
    version at SCAN_WIDE_WIDTHS (N = 7), SCAN_WIDE_PROTEINS (w = 6 and 22)
    and SCAN_WIDE_MORE, float32 and float64, each with its launch shape.
    Returns {dtype: [the members past 6,144 proteins: shape and error]}
    for the kernels line."""
    cases = ([(w, 7) for w in SCAN_WIDE_WIDTHS]
             + [(w, N) for w in (6, 22) for N in SCAN_WIDE_PROTEINS] + list(SCAN_WIDE_MORE))
    past = {torch.float32: [], torch.float64: []}
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).split(".")[-1]
        for w, N in cases:
            P = scan_wide_members(w, N)
            args, plan = random_scan_problem(w, N=N, P=P, seed=w + N, dtype=dtype, device="cuda")
            shape = scan_launch_shape(w, N, dtype.itemsize)
            before = etd2rk_scan.launches
            got = etd2rk_scan(*args, plan)
            want = etd2rk_scan_reference(*args, plan)
            torch.cuda.synchronize()
            if etd2rk_scan.launches != before + 1:
                raise AssertionError(f"3i w={w} N={N} {dt}: not one launch")
            max_abs, scaled = scan_close(f"3i scan w={w} N={N} {dt}", got, want)
            say("3i scan shape", w=w, proteins=N, lanes=P * N, dtype=dt, variant=shape.variant,
                group=shape.group, cols=shape.cols, per=shape.per, cluster=shape.cluster,
                push=shape.push, members=shape.members,
                threads=shape.threads, shared_bytes=shape.shared_bytes,
                max_abs_err=f"{max_abs:.3e}", max_scaled_err=f"{scaled:.3e}")
            if N > 6144:
                past[dtype].append({"w": w, "N": N, "members": P, **shape._asdict(),
                                    "max_abs_err": max_abs, "max_scaled_err": scaled})
            del args, got, want
    return past


def scan_wide_nan_members() -> None:
    """3i's NaN members (SCAN_WIDE_NAN), both types: the member's snapshots
    NaN, every other member's bit-identical."""
    for w, N, P, member in SCAN_WIDE_NAN:
        for dtype in (torch.float32, torch.float64):
            args, plan = random_scan_problem(w, N=N, P=P, seed=w, dtype=dtype, device="cuda")
            clean = etd2rk_scan(*args, plan)
            A = args[5].clone()
            A[N * member:N * (member + 1)] = float("nan")
            dirty = etd2rk_scan(*args[:5], A, args[6], plan)
            torch.cuda.synchronize()
            keep = (torch.arange(N * P, device="cuda") // N) != member
            same = torch.equal(clean[..., keep], dirty[..., keep])
            nan = bool(torch.isnan(dirty[1:, 0, ~keep]).all())
            shape = scan_launch_shape(w, N, dtype.itemsize)
            say("3i nan member", w=w, proteins=N, members=P, dtype=str(dtype).split(".")[-1],
                variant=shape.variant, cluster=shape.cluster, others_unchanged=same,
                member_all_nan=nan)
            if not (same and nan):
                raise AssertionError(f"3i w={w} N={N}: a NaN member leaked or kept numbers")


def scan_wide_objective(label, args, thetas, F64, card, want) -> dict:
    """The objective unbucketed through the scan kernel: its launches
    against ``want``, F against the same objective by the eager scan and,
    on the first 8 members, against the CPU's float64 (PRECISION_GATE at
    float32, F64_OBJECTIVE_RTOL at float64), evals/s."""
    objective = make_population_objective(*args, width_bucketing=False, use_scan_kernel=True)
    objective(thetas[:8])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    F = objective(thetas)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = counts()
    Fe = make_population_objective(*args, width_bucketing=False)(thetas)
    rel_e = float(torch.max(torch.abs(F - Fe) / torch.abs(Fe)))
    F64 = torch.as_tensor(F64)
    rel_c = float(torch.max(torch.abs(F[:8].cpu().double() - F64) / torch.abs(F64)))
    tol = PRECISION_GATE if thetas.dtype == torch.float32 else F64_OBJECTIVE_RTOL
    say(f"{label} objective", pop=len(thetas), launches=launches, predicted=want,
        vs_eager_scan=f"{rel_e:.3e}", vs_f64_cpu=f"{rel_c:.3e}", tol=tol,
        seconds=f"{sec:.3f}", evals_per_s=f"{len(thetas) / sec:.1f}", card=repr(card))
    if tuple(F.shape) != (len(thetas), 3) or not bool(torch.isfinite(F).all()):
        raise AssertionError(f"{label}: non-finite or misshapen objectives")
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, predicted {want}")
    if not (rel_e <= tol and rel_c <= tol):
        raise AssertionError(f"{label}: {rel_e:.3e} from the eager scan, {rel_c:.3e} from "
                             "the CPU's float64")
    return launches


def scan_wide_networks(card, refs) -> tuple[dict, dict, dict]:
    """3i's objectives: each network of REFERENCE_NETWORKS unbucketed at
    XWIDE_POP (float32) and XWIDE_POP_F64 (float64) through the scan kernel
    (:func:`scan_wide_objective`: one ``etd2rk_scan`` and one table launch
    a chunk), then the scan of all those members at once by
    :func:`check_and_time_scan` (the kernel against the plain version and
    the eager scan; times, bound). Returns ({dtype: {network: check}},
    float32 paths, float64 paths)."""
    out = {torch.float32: {}, torch.float64: {}}
    paths32, paths64 = {}, {}
    for name in REFERENCE_NETWORKS:
        hb, thetas_np, F64 = refs[name]
        topo = hb["topo"]
        table = ("phi_tables" if topo.width <= 8 else
                 "phi_tables_wide" if topo.width <= 17 else "phi_tables_xwide")
        say("3i network", name=name, N=topo.N, w=topo.width,
            shape32=scan_launch_shape(topo.width, topo.N, 4)._asdict(),
            shape64=scan_launch_shape(topo.width, topo.N, 8)._asdict())
        for dtype, pop in ((torch.float32, XWIDE_POP), (torch.float64, XWIDE_POP_F64)):
            dt = str(dtype).split(".")[-1]
            args = card_system(hb, dtype)
            thetas = torch.as_tensor(thetas_np[:pop], dtype=dtype, device="cuda")
            chunks = -(-pop // _auto_pop_chunk(topo.N))
            want = expect(etd2rk_scan=chunks, **{table: chunks})
            paths = paths32 if dtype == torch.float32 else paths64
            paths[f"{name}-unbucketed-scan-{dt}-pop{pop}"] = scan_wide_objective(
                f"3i {name} {dt}", args, thetas, F64, card, want)
            b = {"system": args[0], "slices": hb["slices"], "topo": topo, "grid": hb["grid"]}
            out[dtype][name] = check_and_time_scan(f"3i scan {name} {dt}", b, thetas, card,
                                                   reps=SCAN_WIDE_REPS, width_bucketing=False)
            del args, b, thetas
            torch.cuda.empty_cache()
    return out, paths32, paths64


def phase_scan_wide(card, refs) -> tuple[dict, dict, dict]:
    """3i: the scan kernel past w = 17 and N = 256. Its wide kernel's ptxas
    report (no spill in any of eight builds); random problems against the
    plain version (:func:`scan_wide_random`); NaN members; then the
    objective's shapes (:func:`scan_wide_networks`). Returns ({dtype:
    {network: check}}, float32 paths, float64 paths)."""
    t0 = time.perf_counter()
    scan_wide_ptxas()
    past = scan_wide_random()
    scan_wide_nan_members()
    out, paths32, paths64 = scan_wide_networks(card, refs)
    for dtype, cases in past.items():
        out[dtype]["members_past_6144"] = cases
    say("3i scan wide", seconds=f"{time.perf_counter() - t0:.1f}",
        budget_s=PHASE_BUDGET_S["3i"], card=repr(card))
    return out, paths32, paths64


# --- 3j: past w = 129 (the stream table kernel, the scan and flux past it, kron) --------


def stream_ptxas() -> None:
    """The compiler's report of ``csrc/phi_tables_stream.cu``'s two
    instances and of the flux's spans kernel (rows past 1,024 states):
    registers and spills of each; fails on a spill."""
    out = {}
    for source, pattern in ((phi_mod.STREAM_SOURCE, "phi_tables_stream_kernel"),
                            (FLUX_SOURCE, "hypercube_flux_kernel_spans")):
        log = cuda_build.library_path(source).with_suffix(".log").read_text()
        for part in log.split("Compiling entry function '")[1:]:
            name = part.split("'")[0]
            if pattern in name:
                regs = re.search(r"Used (\d+) registers", part)
                spill = re.search(r"(\d+) bytes spill stores", part)
                out[name] = (int(regs.group(1)) if regs else None,
                             int(spill.group(1)) if spill else None)
    say("3j ptxas", instances=len(out),
        builds={k: f"{r} registers, {sp} bytes spilled" for k, (r, sp) in out.items()})
    if len(out) != 6 or any(sp is None or sp for _, sp in out.values()):
        raise AssertionError(f"3j: a stream or spans build spills or was not reported: {out}")


def check_stream(label, L, binv, h_u, ladder, card) -> dict:
    """3j's check of one class past w = 129: the stream kernel against its
    plain version on the first STREAM_CHECK_LANES lanes (scaled tolerance
    by type) with a NaN lane there, then on the whole class the kernel
    (CUDA events over STREAM_REPS calls; one call on the device), the
    plain version on the checked lanes, ``matrix_exp`` in chunks of at
    most STREAM_LIBRARY_CHUNK matrices (the whole class at once needs tens
    of GB), and the FMA bound (float64 at the FP64 tensor cores' rate)."""
    sub = L[..., :STREAM_CHECK_LANES].contiguous()
    before = phi_tables_stream.launches
    got, want = phi_tables(sub, binv, h_u, ladder), phi_tables_reference(sub, binv, h_u, ladder)
    torch.cuda.synchronize()
    if phi_tables_stream.launches != before + 1:
        raise AssertionError(f"{label}: not one stream kernel launch")
    errs = [scaled_err(g, w) for g, w in zip(got, want)]
    max_abs, worst = max(e[0] for e in errs), max(e[1] for e in errs)
    tol = SCALED_TOL[L.dtype]
    say(f"{label} check", shape=tuple(L.shape), lanes_checked=sub.shape[-1], pairs=len(binv),
        ladder=ladder, max_abs_err=f"{max_abs:.3e}", max_scaled_err=f"{worst:.3e}", tol=tol)
    if not worst <= tol:
        raise AssertionError(f"{label}: kernel disagrees with the plain version: {worst:.3e}")
    nan_lane_check(label, sub, binv, h_u, ladder)
    run_k = lambda: phi_tables(L, binv, h_u, ladder)  # noqa: E731
    ms = cuda_ms(run_k, STREAM_REPS)
    plain_ms = cuda_ms(lambda: phi_tables_reference(sub, binv, h_u, ladder), 1)
    M = augmented(L, binv, h_u)

    def library():
        for c in range(0, M.shape[0], STREAM_LIBRARY_CHUNK):
            torch.linalg.matrix_exp(M[c:c + STREAM_LIBRARY_CHUNK])

    lib_ms = cuda_ms(library, 1)
    del M
    f64 = L.dtype == torch.float64
    b = table_bound(L, binv, h_u, ladder, PEAK_FP64_TC_FLOPS if f64 else None)
    dev_ms = kernel_ms_on_device(run_k, "phi_tables_stream_kernel", 1)
    shape = phi_mod.stream_launch_shape(L.shape[1], L.element_size(), len(binv) * L.shape[3],
                                        phi_mod.resident_clusters(L.device, L.dtype))
    say(f"{label} timing", ms=f"{ms:.4f}", device_ms=measured(dev_ms),
        plain_ms=f"{plain_ms:.4f}", plain_lanes=sub.shape[-1], library_ms=f"{lib_ms:.4f}",
        library_chunk=STREAM_LIBRARY_CHUNK, **bound_fields(b, dev_ms),
        reps=STREAM_REPS, slots=shape.slots,
        scratch_mb=f"{shape.slots * shape.slot_words * L.element_size() / 1e6:.1f}",
        card=repr(card))
    torch.cuda.empty_cache()
    return {"max_abs_err": max_abs, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "plain_lanes": sub.shape[-1], "bound_ms": b.ms, "bound_by": b.by,
            "bound_ms_measured_peak": b.ms_measured, "library_ms": lib_ms,
            "lanes": L.shape[3], "pairs": len(binv)}


def stream_objectives(hb, thetas_np, F64, card) -> tuple[dict, dict, dict]:
    """3j's objectives on the 8-site network: bucketed at STREAM_POP
    (float32) and STREAM_POP_F64 (float64), one table launch a width class
    and chunk against the prediction (the w = 257 class to the stream
    kernel), F on 8 members against the CPU's float64; the stream kernel
    at the first float32 and float64 chunk's w = 257 class
    (:func:`check_stream`). Returns ({dtype: check}, float32 paths,
    float64 paths)."""
    topo = hb["topo"]
    out, paths32, paths64 = {}, {}, {}
    for dtype, pop in ((torch.float32, STREAM_POP), (torch.float64, STREAM_POP_F64)):
        dt = str(dtype).split(".")[-1]
        args = card_system(hb, dtype)
        thetas = torch.as_tensor(thetas_np[:pop], dtype=dtype, device="cuda")
        chunks = -(-pop // _auto_pop_chunk(topo.N))
        want = expect(**{k: n * chunks for k, n in tables_per_call(topo).items()})
        paths = paths32 if dtype == torch.float32 else paths64
        paths[f"{STREAM_NETWORK}-{dt}-pop{pop}"] = xwide_objective(
            f"3j {STREAM_NETWORK} {dt}", args, thetas, F64, card, want, "phi_tables_stream")
        params_b = unpack_params(thetas[:_auto_pop_chunk(topo.N)], hb["slices"], topo)
        for L, binv, h_u, ladder in expo.table_inputs(args[0], params_b, hb["grid"]):
            if L.shape[1] > 129:
                out[dtype] = check_stream(f"3j stream {STREAM_NETWORK} w={L.shape[1]} {dt}",
                                          L, binv, h_u, ladder, card)
            del L
        del args, params_b
        torch.cuda.empty_cache()
    return out, paths32, paths64


def stream_scan(hb, F64, card) -> tuple[dict, dict]:
    """3j's unbucketed objective through the scan kernel (w = 257, every
    protein at the full width) at STREAM_SCAN_POP members of each type: one
    ``etd2rk_scan`` and one stream table launch a chunk, F against the
    eager scan's and the CPU's float64; then the scan of those members by
    :func:`check_and_time_scan` (kernel against plain and eager, times,
    bound). E is U w^2 P N words: at pop 256 float32 14 x 66,049 x 1,280 x
    4 B = 4.7 GB, and L about the same. Returns ({dtype: check}, {path:
    launches})."""
    topo = hb["topo"]
    thetas_np = members(hb["theta0"], max(STREAM_SCAN_POP.values()))
    out, paths = {}, {}
    for dtype, pop in STREAM_SCAN_POP.items():
        dt = str(dtype).split(".")[-1]
        args = card_system(hb, dtype)
        thetas = torch.as_tensor(thetas_np[:pop], dtype=dtype, device="cuda")
        chunks = -(-pop // _auto_pop_chunk(topo.N))
        want = expect(etd2rk_scan=chunks, phi_tables_stream=chunks)
        paths[f"{STREAM_NETWORK}-unbucketed-scan-{dt}-pop{pop}"] = scan_wide_objective(
            f"3j {STREAM_NETWORK} scan {dt}", args, thetas, F64, card, want)
        b = {"system": args[0], "slices": hb["slices"], "topo": topo, "grid": hb["grid"]}
        out[dtype] = check_and_time_scan(f"3j scan {STREAM_NETWORK} {dt}", b, thetas, card,
                                         reps=SCAN_WIDE_REPS, width_bucketing=False)
        del args, b, thetas
        torch.cuda.empty_cache()
    return out, paths


def stream_513(card) -> dict:
    """3j at w = 513 (model 2's class of 9 sites), STREAM_513_LANES lanes,
    both types: the stream kernel on blocks shaped like model 2's
    (:func:`check_stream`), and the scan (one launch, wide kernel, E
    streamed) against its plain version on a random problem of its own
    tables. Returns {dtype: check}."""
    out = {}
    rng = np.random.default_rng(513)
    L_np = hypercube_blocks(rng, 2, 9, STREAM_513_LANES)
    binv, h_u = np.asarray([0, 1, 1]), np.asarray([0.0625, 2.0, 16.0])
    ladder = max(phi_mod.ladder_len(513, h) for h in h_u)
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).split(".")[-1]
        L = torch.as_tensor(L_np, dtype=dtype, device="cuda")
        out[dtype] = check_stream(f"3j stream w=513 {dt}", L, binv, h_u, ladder, card)
        del L
        args, plan = random_scan_problem(513, N=7, P=STREAM_513_LANES // 7, seed=513,
                                         dtype=dtype, device="cuda")
        shape = scan_launch_shape(513, 7, dtype.itemsize)
        before = etd2rk_scan.launches
        got = etd2rk_scan(*args, plan)
        want = etd2rk_scan_reference(*args, plan)
        torch.cuda.synchronize()
        if etd2rk_scan.launches != before + 1:
            raise AssertionError(f"3j scan w=513 {dt}: not one launch")
        max_abs, scaled = scan_close(f"3j scan w=513 {dt}", got, want)
        k_ms = cuda_ms(lambda: etd2rk_scan(*args, plan), 3)
        say("3j scan w=513", dtype=dt, lanes=args[3].shape[1], variant=shape.variant,
            group=shape.group, cols=shape.cols, cluster=shape.cluster, threads=shape.threads,
            shared_bytes=shape.shared_bytes, max_abs_err=f"{max_abs:.3e}",
            max_scaled_err=f"{scaled:.3e}", ms=f"{k_ms:.4f}", card=repr(card))
        out[dtype]["scan"] = {"max_abs_err": max_abs, "ms": k_ms, "variant": shape.variant}
        del args, got, want
        torch.cuda.empty_cache()
    return out


def stream_flux(card) -> dict:
    """3j's flux past 10 sites (rows over several blocks): at 11, 12 and 13
    sites, 2^22 states a call, both types, the kernel (one launch) against
    the plain version (2e-5 scaled float32, 1e-12 float64) and timed beside
    the bytes bound (each state read once and written once, the rates read
    once). Returns {dtype: {smax: check}}."""
    out = {torch.float32: {}, torch.float64: {}}
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).split(".")[-1]
        f = dict(dtype=dtype, device="cuda")
        for smax in STREAM_FLUX_SITES:
            rows = (1 << 22) >> smax
            rng = np.random.default_rng(smax)
            X = torch.as_tensor(rng.uniform(0, 1, (rows, 1 << smax)), **f)
            S = torch.as_tensor(rng.uniform(0.1, 2.0, (rows, smax)), **f)
            E = torch.as_tensor(rng.uniform(0.1, 2.0, rows), **f)
            before = hypercube_flux.launches
            got = hypercube_flux(X, S, E, smax)
            want = hypercube_flux_reference(X, S, E, smax)
            torch.cuda.synchronize()
            if hypercube_flux.launches != before + 1:
                raise AssertionError(f"3j flux smax={smax} {dt}: not one launch")
            max_abs, scaled = scaled_err(got, want)
            if not scaled <= SCALED_TOL[dtype]:
                raise AssertionError(f"3j flux smax={smax} {dt}: {scaled:.3e} from plain")
            k_ms = cuda_ms(lambda: hypercube_flux(X, S, E, smax), 20)
            p_ms = cuda_ms(lambda: hypercube_flux_reference(X, S, E, smax), 2)
            isz = X.element_size()
            b = bound(isz * (2.0 * X.numel() + S.numel() + E.numel()), 4.0 * smax * X.numel(),
                      isz)
            dev_ms = kernel_ms_on_device(lambda: hypercube_flux(X, S, E, smax),
                                         "hypercube_flux_kernel_spans", 5)
            say("3j flux", smax=smax, rows=rows, dtype=dt, max_abs_err=f"{max_abs:.3e}",
                max_scaled_err=f"{scaled:.3e}", ms=f"{k_ms:.4f}", device_ms=measured(dev_ms),
                plain_ms=f"{p_ms:.4f}", **bound_fields(b, dev_ms), card=repr(card))
            out[dtype][smax] = {"rows": rows, "max_abs_err": max_abs, "ms": k_ms,
                                "device_ms": dev_ms, "plain_ms": p_ms, "bound_ms": b.ms,
                                "bound_by": b.by}
            del X, S, E, got, want
    return out


def stream_kron(b2, card) -> None:
    """3j's Kronecker-factorized model-2 path (``use_kron=True``, plain
    PyTorch on the card) on the bench model-2 network at STREAM_KRON_POP
    members, substep 0.5 (its stable regime), against the dense path at
    the same substep (rtol 2e-2 / atol 1e-4, the JAX package's gate for
    the two splittings); no table or scan launch."""
    params_b = unpack_params(population(b2, STREAM_KRON_POP), b2["slices"], b2["topo"])
    reset_counts()
    t0 = time.perf_counter()
    ys_k, ok_k = expo.exponential_simulate_batched(b2["system"], params_b, b2["grid"],
                                                   substep=0.5, use_kron=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = counts()
    ys_d, ok_d = expo.exponential_simulate_batched(b2["system"], params_b, b2["grid"],
                                                   substep=0.5)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bad = torch.abs(ys_k - ys_d) > 1e-4 + 2e-2 * torch.abs(ys_d)
    say("3j kron", pop=STREAM_KRON_POP, substep=0.5, segments=len(expo._plan(
        b2["system"], b2["grid"], 0.5)[0]), kron_s=f"{t1 - t0:.3f}", dense_s=f"{t2 - t1:.3f}",
        outside=int(bad.sum()), max_rel=f"{float(torch.max(torch.abs(ys_k - ys_d) / (torch.abs(ys_d) + 1e-4))):.3e}",
        launches=launches, card=repr(card))
    if not (bool(ok_k.all()) and bool(ok_d.all())) or bool(bad.any()):
        raise AssertionError("3j kron: the factorized path left the dense one's tolerance")
    if any(launches.values()):
        raise AssertionError(f"3j kron: kernel launches {launches}, none expected")


def phase_stream(card, b2, reference) -> tuple[list, dict]:
    """3j: past w = 129, in the side lane after phase 12. The stream
    table kernel's and the flux spans kernel's ptxas reports (no spill);
    on the 8-site network (classes 2, 3, 9, 257; its CPU reference, the
    observations by RK45 and the float64 objective of 8 members, from a
    worker started with the side lane) the bucketed objectives and the
    kernel at its w = 257 class (:func:`stream_objectives`), the
    unbucketed objective through the scan kernel (:func:`stream_scan`);
    tables and scan at w = 513 (:func:`stream_513`); the flux at 11-13
    sites (:func:`stream_flux`); ``use_kron=True`` against the dense path
    (:func:`stream_kron`); the peak device memory of all of it. Returns
    (the kernels line's entries of the stream kernel, float32 and float64,
    {path: launches} of the scan paths)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    stream_ptxas()
    hb, thetas_np, F64 = reference.result()
    say("3j references", seconds_waited=f"{time.perf_counter() - t0:.1f}")
    tables, paths32, paths64 = stream_objectives(hb, thetas_np, F64, card)
    scans, scan_paths = stream_scan(hb, F64, card)
    at513 = stream_513(card)
    flux = stream_flux(card)
    stream_kron(b2, card)
    peak = torch.cuda.max_memory_allocated()
    say("3j past w = 129", seconds=f"{time.perf_counter() - t0:.1f}",
        max_memory_allocated_gb=f"{peak / 1e9:.2f}", card=repr(card))
    entries = []
    for dtype, suffix, paths in ((torch.float32, "", paths32), (torch.float64, "_f64", paths64)):
        by_path = {p: n["phi_tables_stream"] for p, n in paths.items()}
        by_path.update({p: n["phi_tables_stream"] for p, n in scan_paths.items()
                        if p.endswith(f"{str(dtype).split('.')[-1]}-pop"
                                      f"{STREAM_SCAN_POP[dtype]}")})
        entries.append({"name": f"phi_tables_stream{suffix}", "route": "cuda",
                        "source": "phoskintime_tpu_torch/csrc/phi_tables_stream.cu",
                        "replaces": "phoskintime_tpu/ops/phi_pallas.py:406",
                        **tables[dtype], "w513": at513[dtype], "scan_w257": scans[dtype],
                        "flux": flux[dtype], "launches_by_path": by_path,
                        "launches": sum(by_path.values()),
                        "max_memory_allocated": peak})
    return entries, scan_paths


# --- 16: population sharding ----------------------------------------------------------


def mesh_rank_job(rank: int, world: int, init: str, hb: dict, backend: str,
                  fit: bool = True) -> dict:
    """One rank of phase 16, in a spawned process on the card: a group of
    ``world`` ranks over ``backend`` (gloo with CUDA tensors, two ranks
    sharing the card; or NCCL over a one-rank group), a
    :class:`PopulationMesh` of it, and on the bench model-0 network
    ``evaluate_population`` at MESH_POP, the column-sharded ranks of that F
    and (``fit``) a short sharded ``run_unsga3_device``. Returns the
    results on the host with each part's seconds and the launches."""
    from datetime import timedelta

    import torch.distributed as dist

    from phoskintime_tpu_torch.parallel.mesh import PopulationMesh

    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    try:
        mesh = PopulationMesh(None, rank, world, torch.device("cuda", 0))
        args = card_system(hb)
        objective = make_population_objective(*args)
        thetas = torch.as_tensor(members(hb["theta0"], MESH_POP), dtype=torch.float32,
                                 device="cuda")
        evaluate_population(objective, thetas[:8 * world], mesh)         # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        F = evaluate_population(objective, thetas, mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = counts()
        ranks = device_nd_ranks(F, mesh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = {"F": F.cpu().numpy(), "ranks": ranks.cpu().numpy(), "launches": launches,
               "seconds": {"evaluate": t1 - t0, "ranks": t2 - t1}}
        if fit:
            res = run_unsga3_device(objective, hb["xl"], hb["xu"], device="cuda", mesh=mesh,
                                    **MESH_GA)
            out["ideal"] = res.pareto_F.min(axis=0)
            out["X"] = res.X
            out["seconds"]["run_unsga3_device"] = time.perf_counter() - t2
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def start_mesh_ranks(b):
    """Phase 16's ranks, all started together beside phases 13-15: MESH_RANKS
    gloo ranks and one NCCL rank, each its own spawned process; their group
    files in a temporary directory. Returns (pool, {name: future})."""
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    d = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    hb = {**host_bundle(b), **{k: b[k] for k in ("theta0", "xl", "xu")}}
    pool = ProcessPoolExecutor(max_workers=MESH_RANKS + 1, mp_context=get_context("spawn"))
    futures = {f"gloo{r}": pool.submit(mesh_rank_job, r, MESH_RANKS, f"file://{d}/gloo", hb,
                                       "gloo") for r in range(MESH_RANKS)}
    futures["nccl"] = pool.submit(mesh_rank_job, 0, 1, f"file://{d}/nccl", hb, "nccl", False)
    return pool, futures


def phase_mesh(b, card, ranks) -> None:
    """16: population sharding on the card. The unsharded references in this
    process: F at MESH_POP, its replicated ranks, the GA unsharded; then each
    rank's results: F bit for bit (else the largest relative difference,
    gated at MESH_F_RTOL), ranks equal, the sharded GA's ideal point within
    MESH_IDEAL_RTOL, the same on every rank; and the NCCL one-rank group's
    F and ranks bit for bit. Two ranks on one card measure nothing about
    speed: their seconds are printed as what they are."""
    t0 = time.perf_counter()
    pool, futures = ranks
    args = bundle_args(b)
    objective = make_population_objective(*args)
    thetas = torch.as_tensor(members(b["theta0"], MESH_POP), dtype=torch.float32, device="cuda")
    reset_counts()
    F = objective(thetas)
    torch.cuda.synchronize()
    launches = counts()
    r_ref = device_nd_ranks(F).cpu().numpy()
    ref = run_unsga3_device(objective, b["xl"], b["xu"], device="cuda", **MESH_GA)
    F = F.cpu().numpy()
    try:
        got = {name: f.result() for name, f in futures.items()}
    finally:
        pool.shutdown(cancel_futures=True)
    chunks = -(-MESH_POP // MESH_RANKS // _auto_pop_chunk(b["topo"].N))
    for name, g in got.items():
        diff = float(np.max(np.abs(g["F"] - F) / np.abs(F)))
        bits = bool(np.array_equal(g["F"], F))
        fields = {"F_bit_for_bit": bits, "F_max_rel_diff": f"{diff:.3e}",
                  "ranks_equal": bool(np.array_equal(g["ranks"], r_ref)),
                  "launches": g["launches"],
                  "seconds": {k: f"{v:.3f}" for k, v in g["seconds"].items()}}
        if "ideal" in g:
            fields["ideal_rel_diff"] = f"{float(np.max(np.abs(g['ideal'] - ref.pareto_F.min(axis=0)) / np.abs(ref.pareto_F.min(axis=0)))):.3e}"
        say(f"16 mesh {name}", pop=MESH_POP, **fields, card=repr(card))
        if not (bits or (name != "nccl" and diff <= MESH_F_RTOL)):
            raise AssertionError(f"16 {name}: F {diff:.3e} from the unsharded call")
        if not fields["ranks_equal"]:
            raise AssertionError(f"16 {name}: sharded ranks differ from the replicated ones")
        if name.startswith("gloo") and g["launches"] != expect(phi_tables=chunks):
            raise AssertionError(f"16 {name}: launches {g['launches']}, want {chunks} a rank")
        if "ideal" in g:
            np.testing.assert_allclose(g["ideal"], ref.pareto_F.min(axis=0), rtol=MESH_IDEAL_RTOL,
                                       atol=1e-6, err_msg=f"16 {name}: ideal point")
    gloo = [got[f"gloo{r}"] for r in range(MESH_RANKS)]
    if not all(np.array_equal(g["X"], gloo[0]["X"]) and np.array_equal(g["F"], gloo[0]["F"])
               for g in gloo):
        raise AssertionError("16: the ranks ended with different populations")
    say("16 mesh", ranks=MESH_RANKS, unsharded_launches=launches,
        seconds=f"{time.perf_counter() - t0:.1f}", budget_s=PHASE_BUDGET_S["16"],
        card=repr(card))


def members(theta0, pop: int) -> np.ndarray:
    """theta0 plus seeded noise, as bench.py and benchmarks/model_rates.py."""
    rng = np.random.default_rng(0)
    return theta0[None] + 0.05 * rng.normal(size=(pop, len(theta0)))


def population(b, pop: int) -> torch.Tensor:
    """:func:`members` of the bundle's theta0, float32 on the card."""
    return torch.as_tensor(members(b["theta0"], pop), dtype=torch.float32, device="cuda")


def main() -> int:
    card = phase_device()
    if "--pergene-only" in sys.argv[1:]:
        phase_pergene(card)
        say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
        return 0
    if "--hyperscan-only" in sys.argv[1:]:
        phase_build()
        b = build_demo_network(N_PROTEINS, N_KINASES, seed=0, dtype=torch.float32,
                               device="cuda")
        phase_hyperscan_motpe(card, b)
        say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
        return 0
    if "--runner-only" in sys.argv[1:]:
        phase_build()
        b = build_demo_network(N_PROTEINS, N_KINASES, seed=0, dtype=torch.float32,
                               device="cuda")
        phase_entry_points(card, b)
        say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
        return 0
    if "--fitfigures-only" in sys.argv[1:]:
        phase_build()
        b = build_demo_network(N_PROTEINS, N_KINASES, seed=0, dtype=torch.float32,
                               device="cuda")
        phase_fit_figures(card, b)
        say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
        return 0
    if "--part3-only" in sys.argv[1:]:
        phase_build()
        b, b2 = (build_demo_network(N_PROTEINS, N_KINASES, model=m, seed=0, dtype=torch.float32,
                                    device="cuda") for m in (0, 2))
        paths = phase_part3(card, b, b2, exact_fits(), start_part3_references(b, b2))
        say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card),
            launches_by_path=paths)
        return 0
    if "--sensitivity-kinopt-only" in sys.argv[1:]:
        phase_build()
        b2 = build_demo_network(N_PROTEINS, N_KINASES, model=2, seed=0, dtype=torch.float32,
                                device="cuda")
        phase_sensitivity_kinopt(card, b2)
        say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
        return 0
    if "--xwide-only" in sys.argv[1:]:
        phase_build()
        phase_xwide_kernel(card, start_xwide_references())
        say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
        return 0
    if "--scan-wide-only" in sys.argv[1:]:
        refs = start_xwide_references(tuple(REFERENCE_NETWORKS))
        try:
            phase_build()
            got = {name: f.result() for name, f in refs[1].items()}
        finally:
            refs[0].shutdown(cancel_futures=True)
        phase_scan_wide(card, got)
        say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
        return 0
    if "--stream-only" in sys.argv[1:]:
        pool, reference = start_stream_reference()
        try:
            phase_build()
            b2 = build_demo_network(N_PROTEINS, N_KINASES, model=2, seed=0, dtype=torch.float32,
                                    device="cuda")
            entries, _ = phase_stream(card, b2, reference)
        finally:
            pool.shutdown(cancel_futures=True)
        say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
        print(json.dumps({"kernels": entries}, default=str))
        return 0
    if "--mesh-only" in sys.argv[1:]:
        phase_build()
        b = build_demo_network(N_PROTEINS, N_KINASES, seed=0, dtype=torch.float32,
                               device="cuda")
        phase_mesh(b, card, start_mesh_ranks(b))
        say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
        return 0
    # 3h's CPU references, one worker a network: the 7-site network's (RK45
    # observations, then the float64 objective at w = 129; about two minutes
    # on a busy host) from the start, beside the build; the other two after
    # the bench bundles, whose RK45 they would slow, beside phases 3-3g
    xwide_refs = start_xwide_references(("model2-7sites",))
    try:
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
        start_xwide_references(("model2-6sites", "model0-20sites", "demo300-N285"), xwide_refs)
        return run_all_phases(card, probe, probe_paths, b, b1, b2, thetas, thetas1, thetas2,
                              xwide_refs)
    except BaseException:
        xwide_refs[0].shutdown(cancel_futures=True)
        raise


def side_lane_job(card: str, t_start: float) -> tuple[dict, dict, float, list, dict]:
    """Phases 10, 11, 12 and 3j in a spawned worker on the card, one after
    the other, beside phases 7-9 and 13 in the main process: each is
    host-bound or needs nothing of the phases before it but the bench
    bundles, built anew here (the same draws and observations); 3j's CPU
    reference builds in a worker of its own from the start. Its lines
    carry the main process's clock (``t_start``). Returns ({path:
    launches}, {which: phase 11's local fit result}, its seconds, 3j's
    kernels-line entries, 3j's {path: launches})."""
    global T_START
    T_START = t_start
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pool, reference = start_stream_reference()
    try:
        paths = phase_pergene(card)
        b, b2 = (build_demo_network(N_PROTEINS, N_KINASES, model=m, seed=0, dtype=torch.float32,
                                    device="cuda") for m in (0, 2))
        fits = {}
        paths.update(phase_sensitivity_kinopt(card, b2, fits))
        paths.update(phase_hyperscan_motpe(card, b))
        stream_entries, stream_paths = phase_stream(card, b2, reference)
    finally:
        pool.shutdown(cancel_futures=True)
    # the results are host arrays; the problems are made anew from their seeds
    return (paths, {which: res for which, (_, res) in fits.items()}, time.perf_counter() - t0,
            stream_entries, stream_paths)


def start_stream_reference():
    """3j's CPU reference (:func:`xwide_cpu_job` of STREAM_NETWORK) in a
    spawned worker of its own; returns (pool, future)."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    pool = ProcessPoolExecutor(max_workers=1, mp_context=get_context("spawn"))
    return pool, pool.submit(xwide_cpu_job, STREAM_NETWORK)


def start_side_lane(card: str):
    """Starts :func:`side_lane_job`; returns (pool, future)."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    pool = ProcessPoolExecutor(max_workers=1, mp_context=get_context("spawn"))
    return pool, pool.submit(side_lane_job, card, T_START)


def finish_side_lane(job) -> tuple[dict, dict, list, dict]:
    """Reads the side lane (its checks raise there): ({path: launches},
    phase 11's fits as {which: (problem, result)} for phase 15, 3j's
    kernels-line entries, 3j's {path: launches})."""
    pool, future = job
    t0 = time.perf_counter()
    try:
        paths, results, seconds, stream_entries, stream_paths = future.result()
    finally:
        pool.shutdown()
    say("10-12, 3j side lane", seconds=f"{seconds:.1f}",
        waited=f"{time.perf_counter() - t0:.1f}")
    problems = {"kinopt": kinopt_synthetic(*KINOPT_PROBLEMS["bench"]),
                "tfopt": tfopt_synthetic(*TFOPT_PROBLEM)}
    return (paths, {which: (problems[which], res) for which, res in results.items()},
            stream_entries, stream_paths)


def run_all_phases(card, probe, probe_paths, b, b1, b2, thetas, thetas1, thetas2,
                   xwide_refs) -> int:
    """Every phase after the setup, in order (3h's and 3i's references
    building in their workers since the start or the setup; 4d's float64
    CPU run in its own since the end of 3h; phases 10-12 and 3j in a side lane
    beside 7-9 and 13)."""
    kernel = phase_kernel(b, thetas, card)
    wide = phase_wide_kernel(b2, thetas2, card)
    scan = phase_scan_kernel(b, thetas, b2, thetas2, card)
    flux = phase_flux_kernel(card)
    thomas = phase_thomas_kernel(card)
    f64_entries, paths64 = phase_float64(b, thetas, b2, thetas2, card)
    (xwide, xwide64), xpaths, xpaths64, refs = phase_xwide_kernel(card, xwide_refs)
    cpu_ref = start_cpu_reference(b2, thetas2)
    pools = [cpu_ref[0]]
    try:
        scan_wide, spaths32, spaths64 = phase_scan_wide(card, refs)
        scan["wide"] = scan_wide[torch.float32]
        scan64, = (e for e in f64_entries if e["name"] == "etd2rk_scan_f64")
        scan64["wide"] = scan_wide[torch.float64]
        for group_paths, wide_paths in ((xpaths, spaths32), (xpaths64, spaths64),
                                        (paths64, spaths64)):
            group_paths.update(wide_paths)
        paths = {"model0-pop8192": phase_main_path(b, thetas, card),
                 "model2-pop2048": phase_main_path_model2(b2, thetas2, card),
                 **phase_scan_paths(b, thetas, b2, thetas2, card), **spaths32}
        rk45_paths, F_rk45 = phase_rk45_path(b2, thetas2, card)
        paths.update(rk45_paths)
        pool, futures = start_rk45_workers(b, b1, b2, thetas, thetas1, thetas2)
        pools.append(pool)
        futures["4d float64 cpu"] = cpu_ref[1]
        phase_accuracy(b)
        phase_accuracy(b, use_scan_kernel=True)
        phase_precision_model2(b2)
        paths.update(phase_steady_states(b1))
    except BaseException:
        for wp in pools:
            wp.shutdown(cancel_futures=True)
        raise
    finish_rk45_workers(pools, futures, F_rk45, {0: lsoda_fold_changes(b),
                                                  2: lsoda_fold_changes(b2)}, card)
    torch.cuda.empty_cache()                 # the side lane's cohorts need the card's memory
    side = start_side_lane(card)
    pools = [side[0]]
    try:
        paths.update(phase_global_fit(b, card))
        model4_paths, b4 = phase_model4(card)
        paths.update(model4_paths)
        paths.update(phase_esdirk(b, b2, thetas, thetas2, card))
        phase_expo(b, b4, thetas, card)
        paths.update(phase_gradients(b, thetas, card))
        paths.update(phase_polish(b, thetas, card))
        paths.update(phase_lm(b, card))
        paths.update(phase_gradient_fits(b, card))
        references = start_part3_references(b, b2)
        ranks = start_mesh_ranks(b)
        fit_figures = start_fit_figures(card)
        pools += [references[0], ranks[0], fit_figures[0]]
        paths.update(phase_entry_points(card, b))
        side_paths, fits, stream_entries, stream_paths = finish_side_lane(side)
        paths.update(side_paths)
        paths.update(phase_part3(card, b, b2, fits, references))
        finish_fit_figures(fit_figures)
    except BaseException:
        for pool in pools:
            pool.shutdown(cancel_futures=True)
        raise
    phase_mesh(b, card, ranks)
    for group, group_paths in (([kernel, wide, scan, flux, thomas], paths),
                               (f64_entries, paths64), ([xwide], xpaths),
                               ([xwide64], xpaths64), ([probe], probe_paths)):
        for entry in group:
            counter = entry.pop("counter", entry["name"])
            entry["launches_by_path"] = {p: n[counter] for p, n in group_paths.items()}
            entry["launches"] = sum(entry["launches_by_path"].values())
            if not entry["launches"]:
                raise AssertionError(f"{entry['name']}: no launch on its main path")
    for entry in stream_entries:
        if not entry["launches"]:
            raise AssertionError(f"{entry['name']}: no launch on its main path")
    scan["wide"]["past_129"] = stream_paths
    entries = [kernel, wide, xwide, *stream_entries[:1], scan, flux, thomas, probe, *f64_entries,
               xwide64, *stream_entries[1:]]
    say("done", seconds=f"{time.perf_counter() - T_START:.1f}", card=repr(card))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
