"""Smoke run of the PyTorch port (agp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, turn TF32 off, print the card's name and power
   limit (nvidia-smi);
2. build: compile the CUDA kernels from the repo's sources with nvcc for
   sm_90a, one nvcc per source, all at once (each kernel's registers and
   spills from ptxas); then the TF32 tensor-core instructions that
   ``cuobjdump -sass`` finds in each instance of kernels 1-9 (cavi_rows,
   latent_rows, kappa_moments_batched, kappa_single, stats_tc,
   variant_rows; none fails the run), and kernels 1-4, 6 and 8-9's shared
   memory against the wrappers' Python copies of it, which choose their
   row tiles and the fused dispatch;
3. kernels vs plain: each CUDA kernel against its plain PyTorch version on
   the same card tensors, at its main path's shape, a ragged B=300 and
   M=128, then both timed at the main path's shape (CUDA events, in the
   order plain, kernel, kernel, plain):
   - fused_cavi_stats at B=4096, M=64, D=20 (the flagship), then each of
     its 8 likelihood branches (rbf) at that shape and at B=300, and each
     of its 4 gram kinds (Student-t) at M=64 and M=128, each timed at the
     flagship shape, a second call of each bit-equal; then at the oracle
     paths' shape (B=8192, D=2, M=128) each branch (rbf) and each Matern
     kind (Student-t), held against the plain version in float64 with no
     floor (see FLOAT32_FACTOR);
   - fused_cavi_stats_multiclass at B=2048, M=64, D=10, K=10, and
     fused_cavi_stats_het at B=2048, M=64, D=10, each with every kind, at
     B=300, M=128 and D=64 (M=128), a second call of each bit-equal and S2
     exactly symmetric; at the reference's multi-latent oracle shapes cut
     to M=128 (multiclass K=3, B=8192, D=2; heteroscedastic B=16,384,
     D=1) with every kind against the float64 plain version with no
     floor; the device us of each launch and the products alone
     (torch.bmm) at the paths' shape;
4. flagship path: SVGP + RBF + logistic, N=200,000, D=20, M=64, B=4096,
   block sampling, float32, trained through agp_tpu_torch.train with one
   kernel launch per step; training accuracy and steady-state CAVI
   iterations/s;
5. Student-t rate: the same shape with y = the flagship's latent
   + 0.1 t_4 and the Student-t likelihood, its launches and steady-state
   iterations/s, the first path of a child process
   (``python3 chip_smoke.py studentt-rate``);
6. oracle and cross-device parity: the N=300 2-D oracle on the card
   (accuracy > 0.9), and 20 flagship steps on the card (float32) against
   the same 20 steps on the CPU (float32 and float64) from the same draws,
   in float32 within ORACLE_DEVICE_FACTOR times the CPU's own float32
   noise (the CPU run again with Z reordered), no fixed floor;
7. multiclass path: the bench.py configuration (logistic-softmax, K=10,
   N=50,000, D=10, M=64, B=2048, slice sampling, float32), trained the same
   way; training accuracy and iterations/s;
8. heteroscedastic path: the bench.py configuration (N=50,000, D=10, M=64,
   B=2048, slice sampling, float32); RMSE of predict_y against the
   noiseless sin(x_0), and iterations/s;
9. multi-latent parity: 20 steps of each of paths 7 and 8, and of path 7
   with the Matern-3/2 kernel, on the card (float32) against the same 20
   steps on the CPU (float32), same draws, within ORACLE_DEVICE_FACTOR
   times each path's own float32 noise, no fixed floor;
10. single-latent oracles: the fused-tier oracles of
   benchmarks/tpu_acceptance.py for the seven other likelihoods (N=30,000,
   D=2, M=128, B=8192, slice sampling, 150 steps) and the Student-t one
   with each Matern kernel, each through agp_tpu_torch.train with one
   launch per step and its floor;
11. single-latent parity: 20 steps of each path of phase 10 on the card
   (float32) against the same steps on the CPU (float32), at the
   flagship's conditioning and at the oracle configuration, each against
   its own float32 noise (MATERN12_PARITY_TOL for the Matern-1/2 kernel at
   the flagship's conditioning), at the oracle configuration also against
   the card with the plain version in the kernel's place (see
   ORACLE_DEVICE_FACTOR), no fixed floor;
12. the batched pair (kernels 4-5, several latents) and the single-latent
   split pair (kernels 6-7, one latent beyond the fused range) against
   their plain versions at the M=512 paths' shapes (at the ill-conditioned
   ones against float64, within FLOAT32_FACTOR times the float32 plain
   version's own error), the flagship's, ragged B=300, M=129 (kernels 4-5
   with 1-3 latents) and each Matern kind, a second call of each kernel
   bit-equal, timed beside the plain versions and torch.bmm / torch.matmul
   (for kernels 4 and 6 their tensor products alone); kernel 4's and
   kernel 6's autograd;
13. logistic_m512_b65536 (bench.py: N=500,000, D=20, M=512, B=65,536) and
   the reference's seven single-latent oracles at M=512, each with one
   launch of kernel 6 and of kernel 7 a step, and the reference's M=512
   multiclass (K=3) and heteroscedastic oracles, each with one launch of
   kernel 4 and of kernel 5 a step, each with its floor;
14. the pairs' parity: 20 steps of each path of phase 13, at B=2048, on
   the card against the CPU, each against its own float32 noise;
15. the hyperparameter step (the reference's default Adam(0.01) on the
   kernel, every iteration): path A, the flagship (one launch of kernel 1
   a step and of kernel 6 a hyperparameter step), and path B,
   logistic_m512_b65536 (kernel 6 twice and kernel 7 once an iteration),
   each with its floor, moved and finite log-hyperparameters and its
   steady rate; then 20 iterations of each on the card against the CPU,
   against each path's own float32 noise;
16. kernels 8-9 (the bench's fused variants): each variant against its
   plain version at the flagship's B=4096, D=20, M=64, a ragged B=300 with
   M=128, the sweep's four rows (B=262,144, M=128; B=8192, M=512;
   B=65,536, M=256 and 512; D=8) and a ragged B=300 at M=129 and M=520,
   a second call bit-equal; at the ill-conditioned oracle shapes (M=128,
   with kernel 1, and M=512) against the float64 plain version with no
   floor (Ktilde's, S2's and mf's errors logged); timed at the flagship
   shape and the sweep's rows beside kernel 1 (M <= 128), the sweep's bar
   and the plain versions, with device us (kernels 1, 8, 9 and the bar) at
   B=262,144, M=128; then the bench's variants mode, their main path, with
   its exact launches;
17. kernel 10 (the bench's tile gather) bit-equal to index_select on the
   tile view (tiles of 32 and 64 rows, a ragged T, the scalar paths),
   timed beside it; then the bench's gather mode with its exact launches;
18. the bench's entry point, ``python3 -m agp_tpu_torch.bench`` at a cut
   step count in a child process: its JSON line parses and its rate is
   finite and positive;
19. the exact GP (Slice E): benchmarks/tpu_acceptance.py's regression toy
   at N=8,192, GP.create's defaults (noise 0.1 learnt by Adam(0.05), the
   kernel by Adam(0.01)), 60 iterations through agp_tpu_torch.train with
   no kernel launch: the RMSE of predict_f on 2,048 held-out points,
   sigma^2 moved toward 0.01, the log-hyperparameters moved, log p(y) up
   from iteration 2; the full covariance and sample_f on 512 points (the
   samples' mean and covariance within SAMPLE_SE standard errors of
   predict_f's), predict_y in chunks bit-equal to the whole call;
20. the dense VGP: (a) Matern-5/2 + Student-t(4) with the default Adam on
   the toy at N=4,096 with outliers, (b) the reference's heteroscedastic
   oracle (lambda=8, fixed hyperparameters) at N=2,048: floors, no kernel
   launch;
21. an SVGP whose Gaussian likelihood learns its noise at the flagship's
   shape, 300 steps, one launch of kernel 6 and one of kernel 7 a step
   (a learnt noise refuses the fused pass): its RMSE floor and sigma^2
   closer to its fixed point (the mean of (y - mu)^2 + var) every 50
   steps;
22. parity of paths 19-20 at N=1,024 (10 iterations) and path 21 (20
   steps): card (float32) against CPU (float32) within each path's own
   float32 noise; then the dense algebra one op at a time (logged).
   Phases 19-21 log their steady iterations/s and peak device memory;
23. the samplers (Slice G): PG(1, c) at c = 0, 1, 2.5, PG(3.5, 0.5) and
   GIG in each of its routes at 2^20 lanes on the card, each mean and
   variance within 6 standard errors of its closed form, a two-sample KS
   test against 2^17 CPU draws, ms a draw by CUDA events, and the masked
   loop's trips and host reads a draw;
24. the port bench's Gibbs row (an MCGP with the logistic likelihood,
   N=2048 in 8-D, 4 chains, 50 burn-in sweeps, 400 samples) with the CG
   and the Cholesky global resample: chain-sweeps/s, host reads and trips
   a sweep, the draws' share of a sweep, peak device memory, no kernel
   launch; every sample finite or the failure printed as a finding (no
   fallback; the CG row must be finite), the posterior mean's sign
   agreement with the labels and its correlation with the CAVI VGP's mean
   above GIBBS_FLOORS (from ``gibbs-cpu``);
25. examples/grand_tour.py's sampling flow on its N=40 logistic data
   (Gibbs, SMC, HMC, NUTS, SVGD: every sample finite), NUTS and HMC on a
   conjugate Gaussian posterior (corr > 0.999 with the exact mean), and
   each sampler's ms a sample at N=512;
26. the fed-noise global resample (both solvers), 16 leapfrog steps and
   50 SVGD steps from fed particles, card (float32) against CPU (float32)
   within SAMPLER_PARITY_FACTOR times the CPU float32's own error;
27. the online model (Slice I): bench.py:241-285's streaming row
   (OnlineSVGP + RBF + Gaussian noise 0.05 fixed, OIPS, 128 slots, X
   uniform on [-2, 2]^2, 8 batches of 256 points, 20 iterations each)
   through online_train with no kernel launch: the first batch takes the
   port's C++ OIPS (built, called once, equal to the numpy selection), the
   RMSE floor (ONLINE_FLOORS, from ``online-cpu``), the CPU's active count,
   card-vs-CPU parity of mu and Sigma within ONLINE_PARITY_FACTOR times the
   CPU float32's own error; online_train_stream bit-equal to online_train
   batch by batch; the bench's two rows (points/s), ms a batch by part
   (save-old, the selection, the kernel matrices, the CAVI iterations),
   host reads a batch, peak device memory;
28. the other streaming paths at that shape: the default Adam(0.01)
   (log-hyperparameters moved, parity), the logistic likelihood (accuracy
   floor), UniGridOnline(8), Webscale(64), StreamKmeans(128, 0.25) with
   their invariants and floors;
29. a wide stream (512 slots, D=8, batches of 2,048): finite, parity,
   points/s and ms a batch; then the warm eta -> moments conversions
   (both branches) against the exact one at [1, 128, 128] and
   [1, 512, 512];
30. numerical VI by quadrature (Slice F): the flagship's SVGP (N=200,000,
   D=20, M=64, B=4096, the iid gather) with QuadratureSVI(4096,
   n_points=100) and sgd(1e-3, 0.9), 300 steps through agp_tpu_torch.train
   with one launch of kernel 6 and one of kernel 7 a step, its accuracy
   floor (NUMERICAL_FLOORS) and steady iterations/s; path 30h, the same
   with the default Adam(0.01) for 100 iterations (kernel 6 once more a
   hyperparameter step), log-hyperparameters moved;
31. numerical VI by Monte Carlo: SoftMaxLikelihood(10) at the bench's
   multiclass shape (N=50,000, D=10, M=64, B=2048, the iid gather) with
   MCIntegrationSVI(2048, n_mc=200) and sgd(1e-3, 0.9), 300 steps with one
   launch of kernel 4 and one of kernel 5 a step, its accuracy floor,
   proba_y's rows summing to 1, steady iterations/s;
32. the generic augmented likelihood: (a) the logistic septuple at the
   flagship's shape through AnalyticSVI (kernels 6 and 7 a step, the
   flagship's floor); (b) the Laplace septuple at the Laplace oracle's
   configuration against the built-in (kernel 1), mu within 2e-2, the
   oracle's RMSE floor; (c) its Laplace-transform draws (PG(1, c)/2) at
   2^20 lanes: the mean within 6 standard errors of the grid's tilted
   mean and within 1 % of tanh(c/2)/(4c), a KS test against CPU draws;
   an MCGP with the logistic septuple by Gibbs on
   examples/custom_likelihood.py's data against the built-in logistic's
   Gibbs mean; no kernel launch;
33. the dense numerical paths (tpu_acceptance.py's quadrature VGP at
   N=400, accuracy > 0.9; the Student-t VGP with Adam(0.05)), no kernel
   launch, the PSD step's rungs and host reads logged; 20 steps of paths
   30, 31 and 32a card (float32) against CPU (float32) from the same
   draws and normals, within their own float32 noise; 32a against the
   built-in logistic on the card; the PSD step's ms a call;
34. the Student-t process (Slice H): tpu_acceptance.py:141-153's VStP
   (N=400, outliers, Student-t(4), nu 5, 60 iterations) with no kernel
   launch: RMSE of predict_f under the floor (SLICE_H_FLOORS, from
   ``slice-h-cpu``), chi finite and positive; then at N=4,096 its steady
   iterations/s, idle share and peak memory;
35. the multi-output MOSVGP at full width, tpu_acceptance.py:416-436's
   model (M=512, B=16,384, Q=2, N=30,000, D=2, Gaussian(0.1) and logistic
   tasks, 100 iterations through agp_tpu_torch.mo_train): exactly one
   launch each of kernels 4 and 5 a step and nothing else, task 0's RMSE
   under 0.35 and the floor, A's rows unit-norm, steady iterations/s,
   idle share, launches a step, peak memory; 35h the same with Adam(0.01)
   on the kernel every 3rd iteration (kernel 4 once more a hyperparameter
   step), the log-hyperparameters moved;
36. the smaller multi-output paths: mo_proba_y at tpu_acceptance.py:
   591-610 (N=2,048, M=32, 80 iterations: separation > 0.2, p in [0, 1]),
   a Q=1 MOSVGP (kernels 6 + 7 once a step) with its floor, the MOVGP of
   tests/test_movgp.py's per-task check (RMSE < 0.3, the logistic task
   held to the CPU's float64 run); then 20 steps of phase 35's model at
   N=20,000, B=2,048 from fed indices, card (float32) against CPU
   (float32) within ORACLE_DEVICE_FACTOR times its own float32 noise and
   the card with the plain versions within the noise, no fixed floor;
37. autoregressive prediction: tests/test_engines.py:311-326's model
   (kernel 1 once a training step), predict_ar's MAE over 20 steps < 0.5,
   sample_ar 4 x 10, then 1,024 trajectories x 100 steps timed (ms a step,
   0 host reads); the rollouts launch no kernel;
38. checkpoints (Slice J): the flagship saved after 150 of 300 fed steps,
   loaded onto a fresh card template (and by allow_pickle) and trained
   on, bit-equal to the 300 uninterrupted; a float64 CPU checkpoint of it
   on a float32 card template trains to the flagship's floor; phase 27's
   online model and phase 35's MOSVGP round-tripped, every leaf bit-equal,
   resumed bit-equal (kernels 1, 4-5 with exact launches);
39. the sharded SVI trainer (Slice K) on one process over NCCL: the
   flagship and benchmarks/scaling.py's tpu1m (N=1,000,000, D=8, M=64,
   batch 512, slice) through sharded_svi_train, bit-equal to vi_steps on
   fed draws, one kernel-1 launch a step (a group of one runs no
   all-reduce), their rates against train's in the same process and their
   profiled steps, the NCCL all-reduce's host cost;
   logistic_m512_b65536 with fused=None on kernels 6 + 7;
40. two processes on the one card over gloo (``jk-rank`` children): the
   flagship through sharded_svi_train at B/2 a rank (kernel 1),
   sharded_train on 200,001 rows for logistic and Poisson (the pad row's
   mask: kernels 6 + 7) and mo_sharded_train on phase 35's data (kernels
   4 + 5); rank 0 against a world-1 run on the same global rows within
   ORACLE_DEVICE_FACTOR times the path's float32 noise, its metrics
   against SLICE_JK_FLOORS, the children's exact launches in the kernels
   line;
41. rank 0's checkpoint of the sharded state (the gathered local
   variables) after 50 steps loaded on one process and trained to 100 on
   the same global rows, within that noise of rank 0's run; then path A's
   20 iterations with kernel 1 alone and kernel 6 alone in their plain
   versions (ROADMAP queue 3 item 5), as shares of its noise;
42. Slice L, path 42: the flagship's shape with with_transform(
   SqExponentialKernel(), LinearTransform(A0 [4, 20])) + LinearKernel(0.1)
   and the default Adam(0.01) every iteration, 100 iterations through
   agp_tpu_torch.train: kernel 7 once a CAVI step and nothing else (the
   plain kappa), the accuracy floor (SLICE_L_FLOORS, from
   ``slice-l-cpu``), A moved, the positive leaves positive; its rate with
   and without the hyperparameter step; profiled iterations of it beside
   the flagship's and path A's (kernel 1) on the same host; 20 iterations
   card vs CPU within ORACLE_DEVICE_FACTOR times its float32 noise;
43. path 43: bench.py's multiclass configuration (K=10) with
   RationalQuadraticKernel(alpha=2) at fixed hyperparameters, 300 steps:
   kernel 5 once a step and nothing else, its floor, its rate, 20 steps
   card vs CPU;
44. the kernel library: every form of tests/test_components.py's
   ALL_KERNELS and FBM at a saturated Hurst index, gram [4096, 512] and
   diag at D=20 on the card against the CPU's float64 within
   ORACLE_DEVICE_FACTOR times the CPU's own float32 error; path 44,
   logistic_m512_b65536 with SqExp + Matern-5/2 (lengthscale 2 each), 20
   steps: kernel 7 once a step, its floor, rate, peak memory, profiled
   step, the step's parts (each gram, kappa's product, kernel 7) by CUDA
   events;
45. the rest of the surface: the flagship with alrsvi (kernel 1 once a
   step, its floor, 20 steps card vs CPU), a VGP with an AffineMean on
   phase 20a's data (its floor, no launch), utils.metrics on path 42's
   model against the CPU's float64, utils.profiling.trace around 5
   iterations of path 42 (its trace names kernel 7), plot_gp and
   plot_multilatent on the card's models (Agg; where matplotlib is
   installed), and agp_tpu_torch.examples.grand_tour on the card;
46. float64 on the card: kernels 4-7's float64 forms (FP64 tensor-core
   tiles) against their plain versions in float64 on the same card
   tensors, each output within max(F64_FACTOR times the plain version's
   own card-vs-CPU float64 difference, F64_FLOOR) of its largest entry, at
   the flagship's shape, logistic_m512_b65536, the ill-conditioned oracle
   shapes at M=128 and M=512, the multiclass (K=3, B=8192) and
   heteroscedastic (B=16,384) M=512 shapes (kernels 6-7 where one latent),
   ragged B=300 at an odd M=129 with 1 and 3 latents and each Matern kind,
   M=1,000 and M=1,184 (16-row tiles), a second call bit-equal, S2 exactly
   symmetric, every launch in ``launches_f64``; each of the first six
   shapes timed by CUDA events and device us beside its plain version,
   its library call in float64 and the float32 kernel on the same inputs
   (kernels 5 and 7 also beside their m8n8k4 geometry, ``k4_stats``);
47. float64 paths against the port's float64 run on the host's CPU from
   the same draws, with exact launches of kernels 6 + 7 or 4 + 5 in
   float64 and none of kernels 1-3: the flagship shape (10 steps, within
   1e-8), path A with the default Adam (10 iterations, 1e-7), the M=512
   multiclass oracle (K=3, 10 steps, 1e-8), the exact GP and the dense
   VGPs at N=1,024 (1e-8, no launch);
48. the drift (ROADMAP queue 3 item 3): the ten oracle paths at M=128 and
   the pair's ten M=512 paths, F64_DRIFT_STEPS steps on the card in
   float64 and in float32 and on the CPU in float32, each one's distance
   to the CPU's float64 run (logged);
49. the float64 flagship's and logistic_m512_b65536's steady iterations/s
   and profiled idle share;
50. kernels 4 and 6 in their column-blocked form (csrc/kappa_cols.cuh)
   past the row slab's old ceilings: float64 at M=1,185-2,048 and float32
   at M=2,393-4,096 against their plain versions (float64 within
   F64_FACTOR times the plain's own card-vs-CPU difference, float32
   within FLOAT32_FACTOR times the float32 plain's error against float64,
   no floor), a second call bit-equal, one launch counted a call; at
   B=16,384 timed beside the plain version, the products alone and the
   bound; then float64 kernels 6 + 7 and 4 + 5 at B=8,388,481, past the
   old grid, with M=129 and 260 (``large_b_check``) (``cols`` runs phases
   50-52 alone);
51. the float32 column-blocked form at ill-conditioned shapes past M=2,406
   (D=2 and D=1) against float64, within FLOAT32_FACTOR, no floor;
52. the paths past the old ceilings: an SVGP at M=4,096 (float32) and
   M=2,048 (float64), a MOVGP on 3,000 (float32) and 1,500 (float64)
   points, each against the host CPU's float64 run from the same draws
   (floor, parity) with exact launches, then trained on the card;
53. the (data, latent) mesh (``tail-rank`` children on the one card over
   gloo, 2 as 1 x 2, then 4 as 2 x 2): bench.py's K=10 multiclass through
   sharded_svi_train, TAIL_MC_STEPS steps (5 latents a rank), and the M=512
   multiclass oracle (K=3: latents 2 + 1) on 1 x 2; rank 0's gathered mu
   and Sigma against the world-1 card run on the same global rows (kernel
   2 at M=64, 4 + 5 at M=512) within ORACLE_DEVICE_FACTOR times its float32
   noise, the accuracy floors (SLICE_TAIL_FLOORS), every rank's exact
   launches (kernels 4 and 5 once a step, kernel 2 never) in the kernels
   line, it/s against world 1's, rank 0's profiled K=10 step on 2 x 2;
54. particle-parallel SMC (phase 25's N=512 rule, 64 particles, 8
   temperatures) and chain-parallel Gibbs (phase 24's row, 2 chains a
   rank) over 2 processes: the particles and log Z against world 1 within
   its float32 noise, each rank's chains bit-equal to its one-process twin,
   the pooled mean within TAIL_SE standard errors of phase 24's, the sign
   floor, chain-sweeps/s;
55. phase 27's streaming row and phase 29's wide stream over 2 processes
   (the batch's rows split, the selection on process 0): the same inducing
   set as world 1, mu and Sigma within its float32 noise, points/s, rank
   0's profiled batch; the flagship's checkpoint gathered on rank 0 after
   JK_SVI_SAVE of JK_SVI_STEPS steps (kernel 1), resumed on 2 processes and
   on one, each within phase 40's noise of the uninterrupted run.

Each path's launch counts are set to 0 just before it and read just after.
Each phase's wall time is logged, then all of them and the total.  Prints
the kernels' JSON line, then the device JSON line last.

Other modes: ``cols`` (phases 50-52), ``probe [cols]`` (the measurement
programs of csrc/probes/), ``studentt-rate`` (phase 5's child), ``profile logistic``,
``profile multiclass``, ``profile multiclass_k10|het|noise`` or ``profile
hyper A|B`` (torch.profiler over 20 steps of an M=512 path, of path 7, 8
or 21,
or 20 iterations of path A or B with a hyperparameter step each),
``profile kernels`` (device time of the bench's
candidates at each of its shapes: kernels 1 (M <= 128), 8, 9, the sweep's
bar; kernel 10 and index_select),
``moved-paths`` (a row-weighted step and elbo at fused-range shapes),
``stats`` (kernels 5 and 7 at phase 12's timed shapes by CUDA events and
device us, logistic_m512_b65536's steady it/s and ``profile logistic``),
``kappa`` (kernels 6 and 4 at phase 12's timed shapes by CUDA events and
device us beside their tensor products alone, the steady it/s of
logistic_m512_b65536 and of path B, ``profile logistic`` and ``profile
multiclass``), ``probe`` (builds and runs
agp_tpu_torch/csrc/probes/kappa_tc.cu: kernel 6's parts, kernels 4 and 6
at other tile shapes, the mma.sync rate with and without 3xTF32's
splits), ``variants`` (kernels 8-9 at the flagship shape and the sweep's
rows by CUDA events and device us beside the bar, and each form with
each row tile at the sweep's M=128 and M=512 rows), ``fused`` (kernel 1
by CUDA events and device us at the flagship, the oracle shape and the
sweep's row, beside the sweep's bar), ``paths`` (the rates of the
host-bound paths that take kernel 1), ``multi`` (kernels 2-3 by CUDA
events and device us at the paths' shapes and the oracle shapes beside
their products alone, the multiclass and heteroscedastic paths' rates
and profiles), ``bits FILE`` (digests of kernels 1 and 4-9's outputs on
seeded inputs, written to FILE or held bit-equal to it), ``dense``
(phases 19-22 alone), ``dense-cpu`` (phases 19-21's paths with the plain
code on the CPU in float32, no floors: what DENSE_FLOORS comes from),
``ladder`` (the dense ladders' lazy rungs against the batch of all rungs),
``profile dense gp|vgp`` (torch.profiler over 5 iterations of path 19 or
20a), ``samplers`` (phases 23-26 alone), ``gibbs-cpu`` (phase 24's row
with each solver in float64 on the host's CPU, no card needed: what
GIBBS_FLOORS comes from), ``profile gibbs`` (torch.profiler over 20
sweeps of the Gibbs row with each solver), ``online`` (phases 27-29 alone),
``online-cpu`` (every online path in float64 on the host's CPU, no card
needed: what ONLINE_FLOORS comes from), ``profile online``
(torch.profiler over batches 2-8 of phase 27's stream), ``numerical``
(phases 30-33 alone), ``numerical-cpu`` (every path of phases 30-33 in
float64 on the host's CPU, no card needed: what NUMERICAL_FLOORS comes
from), ``profile numerical quad|mc`` (torch.profiler over 20 steps of
path 30 or 31), ``softmax-forms`` (path 31's steady rate and one
mc_grads call with SoftMax's closed-form gradient against the AD form),
``slice-h`` (phases 34-37 alone), ``slice-h-cpu`` (phases 34-36's paths
in float64 on the host's CPU, no card needed: what SLICE_H_FLOORS comes
from), ``profile mo`` (torch.profiler over 20 steps of phase 35's model),
``slice-jk`` (phases 38-41 alone), ``slice-jk-cpu`` (phase 40's paths at
world 1 in float64 on the host's CPU, no card needed: what SLICE_JK_FLOORS
comes from), ``slice-jk-nccl`` (phases 40-41 over NCCL, one process on
each card of a machine with several), ``slice-l`` (phases 42-45 alone),
``slice-l-cpu`` (paths 42-44, alrsvi and the AffineMean VGP in float64 on
the host's CPU, no card needed: what SLICE_L_FLOORS comes from),
``slice-tail`` (phases 53-55 alone), ``slice-tail-nccl`` (phases 53-55
over NCCL, one process on each card of a machine with 2 or 4),
``slice-tail-cpu`` (phase 53's paths at world 1 in float64 on the host's
CPU, no card needed: what SLICE_TAIL_FLOORS comes from),
``float64`` (phases 46-49 alone, after the SASS and shared-memory checks).
``ab ROOT
MODE...`` runs any mode with agp_tpu_torch imported from ROOT (an
earlier commit unpacked under _chip/), to compare two trees in one call:
``ab ROOT kappa`` and ``kappa`` (or ``variants``, ``fused``, ``paths``,
``multi``) in the order parent, this, this, parent; ``ab ROOT bits
FILE`` then ``bits FILE`` holds this tree's kernels 1 and 4-9 bit-equal
to ROOT's.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# flagship shape
N, D, M, B = 200_000, 20, 64, 4096
MAIN_STEPS = 300
TIMED_STEPS = 1000
# kernel vs plain: largest |kernel - plain| over the output's largest entry
# (float32 on both arms, sums in another order; float32 against float64 the
# plain version is off by ~1e-6 at these shapes, whose Kmm has cond ~5)
KERNEL_TOL = 1e-4
# kernel 1 at the oracle paths' shape (B=8192, D=2, M=128, lengthscale 1,
# Z on the batch's rows): K^-1's entries reach ~800, so float32 fixes the
# outputs only to ~5e-3 of their largest entry (the plain version against
# itself in float64 on the same inputs), and kernel and plain version in
# float32 differ by up to 2.5e-4 there.  Each output is held against the
# float64 plain version instead, within this many times the float32 plain
# version's own error (on an H100 the ratio reads 0.83-1.05).
FLOAT32_FACTOR = 2.0
# cross-device parity of the flagship's mu after 20 steps, as max |d mu| /
# max |mu|, card float32 against CPU float64: the dtype-keyed jitter
# differs (1e-3 against 1e-4), which moves mu by ~5e-4 on its own.  Card
# against CPU in float32 is held to ORACLE_DEVICE_FACTOR times the CPU's own
# float32 noise (``parity_check``).
PARITY_TOL = {torch.float64: 2e-3}
# flagship training accuracy floor: the labels are a linear rule in 20-D,
# which 64 RBF inducing points fit only in part (0.8965 for the plain
# version on a CPU); chance is 0.5
MIN_FLAGSHIP_ACC = 0.8
# the multi-latent configurations of bench.py (multiclass_k10_m64_b2048,
# heteroscedastic_m64_b2048)
MN, MD, MK, MM, MB = 50_000, 10, 10, 64, 2048
MULTI_TIMED_STEPS = 500
# floors after MAIN_STEPS steps.  With the plain versions on a CPU (float32,
# the same data and draws as the card's run) the multiclass training
# accuracy is 0.8702 (chance 0.1) and the heteroscedastic RMSE of predict_y
# against sin(x_0) is 0.3810 (predicting 0 gives 0.6578)
MIN_MC_ACC, MAX_HET_RMSE = 0.8, 0.45
# the fixed floor that card-vs-CPU float32 parity once had under its noise
# bound (max |d mu| / max |mu|, and |d lam| / lam, after 20 steps); only
# the paths of PARITY_FLOORED keep it
MULTI_PARITY_TOL = 1e-4
# the single-latent oracles of benchmarks/tpu_acceptance.py:278-367, at
# M=128 (the reference's 512 is above the CUDA kernel's range)
ON, OM, OB, OSTEPS = 30_000, 128, 8192, 150
ORACLE_LIKS = ("gaussian", "studentt", "laplace", "matern32", "bayesiansvm", "poisson", "negbinomial")
# floors of the oracle paths, by "likelihood/kernel": (metric, floor) on
# X[:4096], as the reference measures them: "rmse" of predict_f against the
# noiseless f (below the floor), "acc" of predict_y (above), "corr" of
# predict_y with the true rate or mean (above).  Each allows about three
# times the plain version's error on a CPU (1 - accuracy for the SVM; the
# correlations are held at 0.99) (float32, the same data, CPU draws:
# RMSE 0.0037 Gaussian, 0.0095 Student-t, 0.0055 Laplace, 0.0052
# Matern-3/2 noise, 0.0582 / 0.0224 / 0.0141 Student-t with Matern
# 1/2, 3/2, 5/2; accuracy 0.9875; corr 0.9992 Poisson, 0.9995 negative
# binomial) and inside the reference's own floor (RMSE 0.25, 0.25, 0.3;
# accuracy 0.9; corr 0.8; none for the Gaussian).
ORACLE_FLOORS = {
    "gaussian/SqExponentialKernel": ("rmse", 0.012),
    "studentt/SqExponentialKernel": ("rmse", 0.03),
    "laplace/SqExponentialKernel": ("rmse", 0.017),
    "matern32/SqExponentialKernel": ("rmse", 0.016),
    "bayesiansvm/SqExponentialKernel": ("acc", 0.96),
    "poisson/SqExponentialKernel": ("corr", 0.99),
    "negbinomial/SqExponentialKernel": ("corr", 0.99),
    "studentt/Matern12Kernel": ("rmse", 0.18),
    "studentt/Matern32Kernel": ("rmse", 0.07),
    "studentt/Matern52Kernel": ("rmse", 0.045),
}
MATERN_KERNELS = ("Matern12Kernel", "Matern32Kernel", "Matern52Kernel")
# the batched pair's paths, M=512 (beyond the fused kernels' range):
# bench.py's logistic_m512_b65536 (N, D, B) and the reference's batched
# multiclass (K=3, B=8192, 200 steps) and heteroscedastic (B=16384, 100
# steps) oracles, tpu_acceptance.py:370-412
LN, LD, PM, LB = 500_000, 20, 512, 65_536
L_TRAIN_STEPS, L_TIMED_STEPS = 50, 300
PAIR_MC_B, PAIR_MC_STEPS, PAIR_HET_B, PAIR_HET_STEPS = 8192, 200, 16384, 100
# the Student-t steady state at the flagship shape
T_TIMED_STEPS = 1000
# iterations (each with a hyperparameter step) of the steady rates of the
# hyperparameter paths A (the flagship) and B (logistic_m512_b65536)
A_TIMED_STEPS, B_TIMED_STEPS = 300, 60
# the log-hyperparameters of paths A and B must move by more than this
# (Adam(0.01) moves each by up to 0.01 a step)
MIN_HYPER_MOVE = 1e-2
# single-latent parity at the flagship's conditioning (N rows)
PN = 20_000
# card vs CPU (float32) after 20 steps for Student-t with the Matern-1/2
# kernel at the flagship's conditioning, as max |d mu| / max |mu|: Kmm's
# diagonal comes through the expanded |z|^2 + |z|^2 - 2 z.z, whose rounding
# (~eps |z|^2) the Matern-1/2 gram carries as its square root (the diagonal
# reads 0.9986 where it is 1, at D=20), so float32 determines mu there only
# to ~6e-4: the plain version on a CPU, run again with X's features in
# another order, moves it by 6.1e-4 (1e-6 for the other kernels).  The
# bound is five times that; the other paths are held to their own noise
# (``parity_check``).
MATERN12_PARITY_TOL = 3e-3
# 20 steps at the oracle configuration (M=128 in 2-D at lengthscale 1),
# as max |d mu| / max |mu| (and |d lam| / lam), each path against its own
# float32 noise: the plain version on the CPU, run again with the inducing
# points in another order, moves mu by 5.4e-6 - 3.4e-3 there.
# - The kernel's part: the card with the kernel against the card with the
#   plain version in its place, within the noise (on an H100 it reads
#   0.008-0.13 times the noise).
# - Card against CPU (both float32) within ORACLE_DEVICE_FACTOR times the
#   noise: the card's own dense float32 algebra (Cholesky, solves, K^-1)
#   moves mu by up to 5.1 times the noise on these paths, with the plain
#   version in the kernel's place as much as with the kernel (within 2 %
#   on an H100), so that part of the gap is not the kernel's.
# Neither bound has a fixed floor (``parity_check``); the flagship's,
# the multi-latent paths' and the flagship-conditioning half of phase 11
# are held to the same bound, their noise measured the same way.
ORACLE_DEVICE_FACTOR = 10.0
# card-vs-CPU parity paths still held at the MULTI_PARITY_TOL floor under
# their noise bound (``parity_check``): each is a fault with its numbers in
# ROADMAP.md queue 3.  Every other path is held to its bound with no floor
# (on an H100 they read 0.049-0.509 of 10 times their noise, and the card
# against its plain versions 0.18-0.78 of 1 times it).  Path A's card
# against the card with the plain versions reads 5.161e-07, 1.25 times its
# noise of 4.129e-07 (kernel 1's 3xTF32 sums against FP32 ones over 20
# iterations with 17 hyperparameter steps, at float32's own rounding).
PARITY_FLOORED = frozenset({"path A kernels"})


def log(msg):
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    return torch.device("cuda:0")


def phase_build(ck):
    info = ck.build()
    ck._library()
    log(f"build: {info['seconds']:.2f} s -> {os.path.relpath(info['path'])}")
    name = ""
    for line in info["log"].splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {name[:90]}: {line.split(':', 1)[-1].strip()}")
    return info["path"]


# the kernels that run on the tensor cores, by the name of their CUDA
# function: every float instance must hold TF32 mma instructions, every
# double instance (kernels 4-7's float64 form) FP64 ones (DMMA)
TC_KERNELS = {"cavi_rows": "kernel 1", "latent_rows": "kernels 2-3", "kappa_moments_batched": "kernel 4",
              "stats_tc": "kernels 1-3, 5, 7 and 8-9", "kappa_single": "kernel 6", "variant_rows": "kernels 8-9",
              "kappa_cols": "kernels 4 and 6 column-blocked"}
# those with a float64 form
F64_TC_KERNELS = ("kappa_moments_batched", "stats_tc", "kappa_single", "kappa_cols")


def is_f64_instance(fn):
    """Whether a mangled kernel name is a double instance: a TileShape of
    doubles (kernels 4 and 6) or stats_tc on a StatsGeometry of doubles (5
    and 7)."""
    import re

    return bool(re.search(r"TileShapeI(?:Li\d+E)+dE", fn) or "StatsGeometryId" in fn or "ColShapeId" in fn)


def check_tc_sass(lib_path):
    """Kernels 1-9 run on the tensor cores: every float instance of
    cavi_rows (kernel 1), latent_rows (2-3), kappa_moments_batched (4),
    kappa_single (6), stats_tc (5 and 7, and the statistics of 1-3 and
    8-9) and variant_rows (8-9, every form) in the built library holds TF32
    HMMA (or HGMMA) instructions, and every double instance (kernels 4-7's
    float64 form) FP64 DMMA ones, as ``cuobjdump -sass`` shows them; each
    of the six has a float instance and kernels 4-7 a double one."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    # the function's own name in the mangled one (the anonymous namespace's
    # name holds the source file's, e.g. kappa_single_cu)
    own = re.compile(r"\d(" + "|".join(TC_KERNELS) + r")I")
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if own.search(name):
                counts[name] = 0
        elif name in counts and (("DMMA" in line) if is_f64_instance(name) else
                                 ("HMMA" in line and "TF32" in line or "HGMMA" in line)):
            counts[name] += 1
    missing = [k for k in TC_KERNELS if not any(own.search(n)[1] == k and not is_f64_instance(n) for n in counts)]
    missing += [f"{k} (float64)" for k in F64_TC_KERNELS
                if not any(own.search(n)[1] == k and is_f64_instance(n) for n in counts)]
    if missing or not all(counts.values()):
        raise AssertionError(f"a tensor-core kernel holds no tensor-core instruction of its type in its SASS: "
                             f"{counts}, no instance of {missing}")
    for fn, n in sorted(counts.items()):
        f64 = is_f64_instance(fn)
        stats = re.search(r"stats_tcINS_13StatsGeometryI[fd]Li(\d+)E(?:Li\d+E){5}Li(\d+)EEELb(\d)", fn)
        tile = re.search(r"(cavi_rows|latent_rows|kappa_single|kappa_moments_batched|variant_rows)"
                         r"INS_9TileShapeILi(\d+)ELi(\d+)ELi(\d+)E", fn)
        cols = re.search(r"kappa_colsINS_8ColShapeI[fd]Li(\d+)ELi(\d+)E.*?ELb(\d)ELb(\d)E", fn)
        if stats:
            mma = ("3xTF32 m16n8k8" if not f64 else "m16n8k8" if stats[2] == "8" else "m8n8k4 pairs")
            label = f"stats_tc<{stats[1]}-row stages, {mma}, {'16-byte' if stats[3] == '1' else 'one-element'} copies>"
        elif cols:
            label = (f"kappa_cols<{cols[1]} x {cols[2]} tiles, "
                     + {("1", "0"): "kappa", ("1", "1"): "kappa with mf", ("0", "0"): "kappa Sigma"}[cols[3], cols[4]]
                     + ">")
        elif tile:
            label = f"{tile[1]}<{tile[2]}-row tiles, {tile[3]} x {tile[4]} warps>"
        else:
            label = fn[:90]
        kernel = TC_KERNELS[own.search(fn)[1]]
        what = "FP64 DMMA" if f64 else "TF32 HMMA/HGMMA"
        log(f"  SASS: {label}{' float64' if f64 else ''} ({kernel}; {fn[:40]}...): {n} {what}")


def kernel_inputs(b, m, device, seed=0):
    """Float32 card tensors as the main path hands them to the kernel: Z is
    the first m rows of the data, K^-1 from the RBF gram, rho = N/B."""
    from agp_tpu_torch.ops import linalg

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b + m, D))
    A = rng.normal(size=(m, m))
    t = {
        "X": X[m:], "Z": X[:m], "y": np.where(rng.normal(size=b) > 0, 1.0, -1.0),
        "mu": rng.normal(size=m), "Sigma": A @ A.T / m + np.eye(m),
    }
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in t.items()}
    Z = t["Z"] / 2.0
    r2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    L = linalg.safe_cholesky(torch.exp(-0.5 * r2), 1e-3)
    eye = torch.eye(m, dtype=torch.float32, device=device)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).T.contiguous()
    return t


def call(fn, t):
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], 2.0, 1.0, 1e-3, N / B)


def cuda_ms(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_vs_plain(ck, device):
    names = ("s1", "S2", "c", "theta", "mf", "vf")
    errs = {}
    for b, m in ((B, M), (300, M), (B, 128)):
        t = kernel_inputs(b, m, device)
        out = call(ck.fused_cavi_stats, t)
        torch.cuda.synchronize()
        ref = call(ck.fused_cavi_stats_reference, t)
        torch.cuda.synchronize()
        row = check_outputs(f"kernel vs plain at B={b}, M={m}", names, out, ref)
        check_stats_repeat(f"kernel 1 at B={b}, M={m}", lambda: call(ck.fused_cavi_stats, t), (), out)
        errs[f"B{b}_M{m}"] = row
        log(f"kernel vs plain B={b} M={m}: max abs err " + " ".join(f"{k}={v:.2e}" for k, v in row.items()))
    t = kernel_inputs(B, M, device)
    kern_ms, plain_ms = timed_pair(lambda: call(ck.fused_cavi_stats, t), lambda: call(ck.fused_cavi_stats_reference, t))
    log(f"flagship B={B} D={D} M={M}: kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms per call")
    return errs, kern_ms, plain_ms


def multi_inputs(b, m, n_latent, device, seed=0, kind="rbf", d=MD):
    """Float32 card tensors as the multi-latent paths hand them to their
    kernels: Z from the data, per-latent lengthscale 2 sqrt(d / 10) (the
    paths' 2 at their D=10) and variance 1, K^-1 from the gram of
    ``kind``, random SPD Sigma, one-hot labels (multiclass), y = sin(x_0)
    (heteroscedastic), alpha = beta = K as at the first step, rho = N/B of
    the paths and lambda 1."""
    import agp_tpu_torch as agt
    from agp_tpu_torch.ops import linalg

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b + m, d))
    A = rng.normal(size=(n_latent, m, m))
    ls = 2.0 * (d / MD) ** 0.5
    t = {
        "X": X[m:], "Z": np.stack([X[:m]] * n_latent), "ls": np.full((n_latent, d), ls),
        "var": np.ones(n_latent), "mu": rng.normal(size=(n_latent, m)),
        "Sigma": A @ A.transpose(0, 2, 1) / m + np.eye(m),
        "onehot": np.eye(n_latent)[rng.integers(0, n_latent, size=b)], "y": np.sin(X[m:, 0]),
        "alpha": np.full(b, float(n_latent)), "beta": np.full(b, float(n_latent)),
    }
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in t.items()}
    kern = {v: k for k, v in agt.kernels.FUSED_KINDS.items()}[kind](lengthscale=ls)
    L = linalg.safe_cholesky(kern.gram(t["Z"][0]), 1e-3)
    eye = torch.eye(m, dtype=torch.float32, device=device)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).T.expand(n_latent, m, m).contiguous()
    t.update(kind=kind, rho=MN / MB, lam=1.0)
    return t


def multi_oracle_inputs(which, device, kind="rbf"):
    """Card tensors of kernels 2-3 at the reference's multi-latent oracles
    (tpu_acceptance.py:370-412) cut to M=128, as phase 12 takes them at
    M=512 (pair_inputs: Z on the batch's rows, lengthscale 1, K^-1 from
    the float32 Cholesky of the kind's Kmm, cond up to ~1e5): multiclass
    K=3, B=8192, D=2 (pair_mc_data; one-hot labels, alpha = beta = K as at
    the first step) or heteroscedastic B=16,384, D=1 (pair_het_data;
    lambda 8); rho = N/B."""
    if which == "multiclass":
        X, y = pair_mc_data("cpu")
        b = PAIR_MC_B
        t = pair_inputs(X, b, OM, 3, device, kind=kind, ls=1.0)
        f32 = dict(dtype=torch.float32, device=device)
        t.update(onehot=torch.eye(3, **f32)[y[:b].to(device)], alpha=torch.full((b,), 3.0, **f32),
                 beta=torch.full((b,), 3.0, **f32))
    else:
        X, y, _ = pair_het_data("cpu")
        b = PAIR_HET_B
        t = pair_inputs(X, b, OM, 2, device, kind=kind, ls=1.0)
        t["y"] = y[:b].to(device).contiguous()
    t.update(rho=ON / b, lam=8.0)
    return t


def call_mc(fn, t):
    return fn(t["X"], t["onehot"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], t["var"], 1e-3, t["rho"],
              t["alpha"], t["beta"], kind=t["kind"])


def call_het(fn, t):
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], t["var"], 1e-3, t["rho"], t["lam"],
              kind=t["kind"])


# kernels 2 and 3: (path, latents at the bench's shape, caller, output names)
MULTI_KERNELS = {
    "fused_cavi_stats_multiclass": ("multiclass", MK, call_mc, ("s1", "S2", "c", "theta", "gamma", "alpha")),
    "fused_cavi_stats_het": ("het", 2, call_het, ("s1", "S2", "c", "phi", "gamma", "theta", "sigg")),
}


def multi_products(ck, t):
    """One PyTorch call each of kernels 2-3's three tensor products alone,
    torch.bmm(Knm, K^-1), torch.bmm(kappa, Sigma) and
    torch.bmm((theta kappa)^T, kappa), on float32 operands the plain
    version forms from the case's inputs: a yardstick of the products, not
    the whole function, which the port never calls."""
    kinv = ck._kinv(t["L_invT"])
    ls = t["ls"][:, None, :]
    kappa, _, knm = ck._kappa_ktilde(t["X"][None] / ls, t["Z"] / ls, kinv, t["var"], 1e-3, t["kind"])
    th = torch.rand(kappa.shape[:2], device=kappa.device, generator=torch.Generator(kappa.device).manual_seed(0))
    return lambda: (torch.bmm(knm, kinv), torch.bmm(kappa, t["Sigma"]), torch.bmm((kappa * th[..., None]).mT, kappa))


def multi_oracle_check(ck, name, kind, device):
    """Kernel ``name`` at its oracle shape (multi_oracle_inputs) against
    the float64 plain version with no floor: every output within
    FLOAT32_FACTOR times the float32 plain version's own error; S2 exactly
    symmetric and a second call bit-equal.  Returns {output: (kernel,
    float32 plain) error against float64}."""
    which, _, call_fn, names = MULTI_KERNELS[name]
    t = multi_oracle_inputs(which, device, kind)
    kern, plain = getattr(ck, name), getattr(ck, name + "_reference")
    got = call_fn(kern, t)
    torch.cuda.synchronize()
    ref, ref64 = call_fn(plain, t), call_fn(plain, to_float64(t))
    label = f"{name} {kind} oracle B={t['X'].shape[0]} D={t['X'].shape[1]} M={OM}"
    check_outputs(label, names, got, ref, ref64, floor=0.0)
    check_stats_repeat(label, lambda: call_fn(kern, t), (), got)
    out = {}
    for i, n in enumerate(names):
        scale = max(float(ref64[i].abs().max()), 1.0)
        out[n] = tuple(float((o[i].double() - ref64[i]).abs().max()) / scale for o in (got, ref))
    return out


def phase_multi_kernels_vs_plain(ck, device):
    """Both multi-latent kernels against their plain versions: rbf at the
    path's shape, B=300, M=128 and D=64 at M=128 (B=2048 and 300), each
    Matern kind at the path's shape, a second call of each bit-equal and S2
    exactly symmetric; at the oracle shapes (multi_oracle_inputs) with
    every kind against the float64 plain version with no floor
    (multi_oracle_check); then each kind timed at the path's shape beside
    the plain version, and at rbf the device us of each launch (profiler)
    and the products alone (multi_products).  Returns {name: {"worst":
    largest abs error against the float32 plain version, "ms", "plain_ms"
    (rbf), "per_kind": {kind: (ms, plain ms)}, "device_us",
    "device_us_by_kernel", "products_ms", "products_device_us", "oracle":
    {kind: multi_oracle_check's}}}."""
    out = {}
    for name, (_, n_latent, call_fn, names) in MULTI_KERNELS.items():
        kern, plain = getattr(ck, name), getattr(ck, name + "_reference")
        worst, per_kind, oracle = 0.0, {}, {}
        checks = [("rbf", MB, MM, MD), ("rbf", 300, MM, MD), ("rbf", MB, 128, MD), ("rbf", MB, 128, 64),
                  ("rbf", 300, 128, 64)] + [(k, MB, MM, MD) for k in ck.KINDS[1:]]
        for kind, b, m, d in checks:
            t = multi_inputs(b, m, n_latent, device, kind=kind, d=d)
            got = call_fn(kern, t)
            torch.cuda.synchronize()
            ref = call_fn(plain, t)
            torch.cuda.synchronize()
            label = f"{name} {kind} B={b} D={d} M={m}"
            row = check_outputs(label, names, got, ref)
            check_stats_repeat(label, lambda: call_fn(kern, t), (), got)
            worst = max(worst, *row.values())
            log(f"{name} vs plain {kind} B={b} D={d} M={m}: max abs err "
                + " ".join(f"{k}={v:.2e}" for k, v in row.items()))
        for kind in ck.KINDS:
            oracle[kind] = multi_oracle_check(ck, name, kind, device)
            log(f"{name} {kind} at the oracle shape against float64, kernel / float32 plain: "
                + " ".join(f"{k}={a:.3e}/{p:.3e}" for k, (a, p) in oracle[kind].items()))
        for kind in ck.KINDS:
            t = multi_inputs(MB, MM, n_latent, device, kind=kind)
            per_kind[kind] = timed_pair(lambda: call_fn(kern, t), lambda: call_fn(plain, t))
            log(f"{name} {kind} B={MB} D={MD} M={MM} L={n_latent}: kernel {per_kind[kind][0]:.4f} ms, "
                f"plain {per_kind[kind][1]:.4f} ms per call")
        t = multi_inputs(MB, MM, n_latent, device)
        dev, dev_by = device_us(lambda: call_fn(kern, t))
        products = multi_products(ck, t)
        out[name] = {"worst": worst, "ms": per_kind["rbf"][0], "plain_ms": per_kind["rbf"][1], "per_kind": per_kind,
                     "device_us": dev, "device_us_by_kernel": dev_by, "products_ms": cuda_ms(products),
                     "products_device_us": device_us(products)[0], "oracle": oracle}
        log(f"{name} rbf B={MB} D={MD} M={MM}: device {dev:.1f} us ("
            + ", ".join(f"{k} {v:.1f}" for k, v in dev_by.items()) + f"); the products alone (torch.bmm x3) "
            f"{out[name]['products_ms']:.4f} ms, device {out[name]['products_device_us']:.1f} us")
    return out


def flagship_data(device, n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D)).astype(np.float32)
    w = rng.normal(size=D).astype(np.float32)
    y = np.where(X @ w > 0, 1.0, -1.0).astype(np.float32)
    return torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)


def flagship_model(agt, X, b=B, optimiser=None):
    return agt.SVGP.create(
        agt.SqExponentialKernel(lengthscale=2.0, variance=1.0),
        agt.LogisticLikelihood.create(),
        agt.AnalyticSVI(b, minibatch_sampling="block"),
        X[:M],
        optimiser=optimiser,
    )


def phase_main_path(agt, ck, device):
    from agp_tpu_torch.training.train import vi_steps

    X, y = flagship_data(device)
    model = flagship_model(agt, X)
    gen = torch.Generator(device=device).manual_seed(0)
    reset_launches(ck)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=MAIN_STEPS, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = expect_launches(ck, "flagship", route_launches(MAIN_STEPS, "fused"))
    if not (bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())):
        raise AssertionError("non-finite posterior after the main path")
    acc = float((agt.predict_y(model, state, X) == y).float().mean())
    if acc < MIN_FLAGSHIP_ACC:
        raise AssertionError(f"flagship training accuracy {acc:.4f} < {MIN_FLAGSHIP_ACC}")
    log(f"main path: {MAIN_STEPS} steps through agp_tpu_torch.train in {train_s:.3f} s "
        f"(first call, kernel loaded), {launches} launches, training accuracy {acc:.4f}")

    model, state = vi_steps(model, state, X, y, 50, generator=gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, state = vi_steps(model, state, X, y, TIMED_STEPS, generator=gen)
    torch.cuda.synchronize()
    ips = TIMED_STEPS / (time.perf_counter() - t0)
    log(f"steady state: {ips:.1f} CAVI iterations/s over {TIMED_STEPS} steps")
    return launches


def phase_oracle_and_parity(agt, device):
    from agp_tpu_torch.training.train import vi_steps

    rng = np.random.default_rng(0)
    Xo = rng.uniform(-2, 2, size=(300, 2))
    yo = (np.sin(2 * Xo[:, 0]) + 0.5 * Xo[:, 1] > 0).astype(np.float32)
    Xo = torch.as_tensor(Xo, dtype=torch.float32, device=device)
    yo = torch.as_tensor(yo, device=device)
    model = agt.SVGP.create(
        agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticSVI(64),
        Z=Xo[:32], optimiser=None,
    )
    model, state = agt.train(model, Xo, yo, iterations=150,
                             generator=torch.Generator(device=device).manual_seed(0))
    acc = float(((agt.predict_y(model, state, Xo) > 0) == (yo > 0)).float().mean())
    if acc <= 0.9:
        raise AssertionError(f"oracle accuracy {acc:.4f} <= 0.9")
    log(f"oracle (N=300, M=32, B=64, 150 iterations): accuracy {acc:.4f}")

    n = 20_000
    Xc, yc = flagship_data("cpu", n=n, seed=1)
    draws = torch.randint(0, n // 64, (20, B // 64), generator=torch.Generator().manual_seed(1))

    def mu_after_20(dev, dt, perm=None):
        X, y = Xc.to(device=dev, dtype=dt), yc.to(device=dev, dtype=dt)
        model = flagship_model(agt, X)
        if perm is not None:
            model = model.replace(Z=model.Z[:, perm].contiguous())
        state = agt.init_state(model, X, y)
        _, state = vi_steps(model, state, X, y, 20, draws=draws.to(dev))
        mu = state.mu.double().cpu()
        return mu if perm is None else mu[:, torch.argsort(perm)]

    def err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    mu_card = mu_after_20(device, torch.float32)
    mu_cpu = mu_after_20(torch.device("cpu"), torch.float32)
    perm = torch.randperm(M, generator=torch.Generator().manual_seed(2))
    noise = err(mu_after_20(torch.device("cpu"), torch.float32, perm), mu_cpu)
    parity_check("flagship", err(mu_card, mu_cpu), noise)
    mu64 = mu_after_20(torch.device("cpu"), torch.float64)
    e64, tol64 = err(mu_card, mu64), PARITY_TOL[torch.float64]
    if not e64 <= tol64:
        raise AssertionError(f"card float32 vs CPU float64 mu after 20 steps: {e64:.3e} > {tol64}")
    log(f"parity: 20 steps card (float32) vs CPU (float64), max |d mu| / max |mu| = {e64:.3e} (bound {tol64}: the "
        f"dtype-keyed jitter)")


def parity_check(label, err, noise, factor=ORACLE_DEVICE_FACTOR, what="card (float32) vs CPU (float32)"):
    """Holds ``err`` to ``factor`` times the path's own float32 noise (the
    CPU run again with its inputs reordered), with no fixed floor unless
    ``label`` is in PARITY_FLOORED; logs the error as a share of that
    bound.  Returns the share."""
    tol = factor * noise
    bound = max(tol, MULTI_PARITY_TOL) if label in PARITY_FLOORED else tol
    log(f"{label} parity: {what} {err:.3e}, {err / tol:.3f} of {factor:g} x its noise {noise:.3e}"
        + (f" (floored at {MULTI_PARITY_TOL})" if label in PARITY_FLOORED else ""))
    if not err <= bound:
        raise AssertionError(f"{label}: {what} {err:.3e} > {bound:.3e} ({factor:g} x its noise {noise:.3e})")
    return err / tol


def mc_data(device, seed=0):
    """bench.py's multiclass data: X standard normal, labels the argmax of
    X W with W [D, K] standard normal."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(MN, MD)).astype(np.float32)
    y = np.argmax(X @ rng.normal(size=(MD, MK)).astype(np.float32), axis=1)
    return torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)


def het_data(device, seed=0):
    """bench.py's heteroscedastic data: y = sin(x_0) + 0.1 eps."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(MN, MD)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.1 * rng.normal(size=MN)).astype(np.float32)
    return torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)


def multi_model(agt, X, which, kernel="SqExponentialKernel"):
    lik = agt.LogisticSoftMaxLikelihood.create(MK) if which == "multiclass" else agt.HeteroscedasticLikelihood.create()
    return agt.SVGP.create(
        getattr(agt, kernel)(lengthscale=2.0), lik, agt.AnalyticSVI(MB, minibatch_sampling="slice"),
        X[:MM], optimiser=None,
    )


def multi_quality(agt, model, state, X, y, which):
    """Training accuracy (multiclass) or RMSE of predict_y against the
    noiseless sin(x_0) (heteroscedastic)."""
    pred = agt.predict_y(model, state, X)
    if which == "multiclass":
        return float((pred == y).float().mean())
    return float(torch.sqrt(torch.mean((pred - torch.sin(X[:, 0])) ** 2)))


def phase_multi_path(agt, ck, device, which):
    """One multi-latent bench configuration through agp_tpu_torch.train:
    MAIN_STEPS steps with one kernel launch each, its floor, then
    steady-state iterations/s.  Returns (launches, quality, it/s)."""
    from agp_tpu_torch.training.train import vi_steps

    wrapper = ck.fused_cavi_stats_multiclass if which == "multiclass" else ck.fused_cavi_stats_het
    X, y = (mc_data if which == "multiclass" else het_data)(device)
    model = multi_model(agt, X, which)
    gen = torch.Generator(device=device).manual_seed(0)
    reset_launches(ck)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=MAIN_STEPS, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = expect_launches(ck, which, route_launches(MAIN_STEPS, "fused", fused=wrapper.__name__))
    tensors = [state.mu, state.Sigma] + ([model.likelihood.lam] if which == "het" else [])
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise AssertionError(f"{which}: non-finite posterior or lambda after the main path")
    quality = multi_quality(agt, model, state, X, y, which)
    if which == "multiclass" and not quality >= MIN_MC_ACC:
        raise AssertionError(f"multiclass training accuracy {quality:.4f} < {MIN_MC_ACC}")
    if which == "het" and not quality <= MAX_HET_RMSE:
        raise AssertionError(f"heteroscedastic RMSE {quality:.4f} > {MAX_HET_RMSE}")
    extra = f", lambda {float(model.likelihood.lam):.4f}" if which == "het" else ""
    log(f"{which} path: {MAIN_STEPS} steps through agp_tpu_torch.train in {train_s:.3f} s, {launches} launches, "
        f"{'training accuracy' if which == 'multiclass' else 'RMSE vs sin(x_0)'} {quality:.4f}{extra}")

    y_t = model.likelihood.treat_labels(y)[0].to(X.dtype)
    model, state = vi_steps(model, state, X, y_t, 50, generator=gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, state = vi_steps(model, state, X, y_t, MULTI_TIMED_STEPS, generator=gen)
    torch.cuda.synchronize()
    ips = MULTI_TIMED_STEPS / (time.perf_counter() - t0)
    log(f"{which} steady state: {ips:.1f} CAVI iterations/s over {MULTI_TIMED_STEPS} steps")
    return launches, quality, ips


def after_20(agt, model, X, y, draws, steps=20):
    """mu (and lambda, where the likelihood has one) after 20 steps (or
    ``steps``) of ``model`` on (X, y) with the given draws, on X's device,
    as float64 on the CPU."""
    from agp_tpu_torch.training.train import vi_steps

    y_t, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    y_t = y_t.to(device=X.device, dtype=X.dtype)
    state = agt.init_state(model, X, y_t)
    model, state = vi_steps(model, state, X, y_t, steps, draws=draws.to(X.device))
    lam = getattr(model.likelihood, "lam", None)
    return state.mu.double().cpu(), None if lam is None else lam.double().cpu()


def rel_err(a, b):
    """max |d mu| / max |mu| (and |d lam| / lam) between two after_20
    results, b the CPU's."""
    err = float((a[0] - b[0]).abs().max() / b[0].abs().max())
    if b[1] is not None:
        err = max(err, float((a[1] - b[1]).abs() / b[1]))
    return err


def phase_multi_parity(agt, device):
    """20 steps of each multi-latent path, and of the multiclass one with
    the Matern-3/2 kernel, on the card (float32) against the same 20 steps on
    the CPU (float32, the plain versions), same draws, within
    ORACLE_DEVICE_FACTOR times the path's own float32 noise (the CPU run
    again with the inducing points in another order)."""
    draws = torch.randint(0, MN - MB + 1, (20,), generator=torch.Generator().manual_seed(1))
    perm = torch.randperm(MM, generator=torch.Generator().manual_seed(2))
    for which, data, kernel in (("multiclass", mc_data, "SqExponentialKernel"), ("het", het_data, "SqExponentialKernel"),
                                ("multiclass", mc_data, "Matern32Kernel")):
        Xc, yc = data("cpu", seed=1)
        card, cpu = (after_20(agt, multi_model(agt, X, which, kernel), X, y, draws)
                     for X, y in ((Xc.to(device), yc.to(device)), (Xc, yc)))
        m = multi_model(agt, Xc, which, kernel)
        mu_p, lam_p = after_20(agt, m.replace(Z=m.Z[:, perm].contiguous()), Xc, yc, draws)
        noise = rel_err((mu_p[:, torch.argsort(perm)], lam_p), cpu)
        parity_check(f"{which} {kernel}", rel_err(card, cpu), noise,
                     what="20 steps card (float32) vs CPU (float32), max |d mu| / max |mu| (and |d lam| / lam)")


# --------------------------------------------- the single-latent branches
def single_latent_lik(agt, name):
    """The port's likelihood of fused_cavi_stats's branch ``name`` as the
    kernel checks take it, here and in tests/test_torch_cuda.py, with
    parameters away from their defaults (Student-t's sigma != 1 tests its
    sigma^2 slot)."""
    return {
        "logistic": lambda: agt.LogisticLikelihood.create(),
        "gaussian": lambda: agt.GaussianLikelihood.create(0.05),
        "studentt": lambda: agt.StudentTLikelihood.create(4.0, 0.7),
        "laplace": lambda: agt.LaplaceLikelihood.create(0.3),
        "matern32": lambda: agt.Matern32Likelihood.create(0.7),
        "bayesiansvm": lambda: agt.BayesianSVM.create(),
        "negbinomial": lambda: agt.NegBinomialLikelihood.create(5.0),
        "poisson": lambda: agt.PoissonLikelihood.create(2.0),
    }[name]()


def single_latent_labels(name, f, rng):
    """Labels for likelihood ``name`` around the latent f: f plus noise of
    the likelihood's kind (regression), sign(f) (classification), counts
    of rate 5 sigma(f) (Poisson) or NB(5, sigma(f - 1)) drawn as
    Poisson(Gamma) (negative binomial)."""
    if name in ("logistic", "bayesiansvm"):
        return np.where(f > 0, 1.0, -1.0)
    if name == "poisson":
        return rng.poisson(5.0 / (1.0 + np.exp(-f))).astype(float)
    if name == "negbinomial":
        p = 1.0 / (1.0 + np.exp(-(f - 1.0)))
        return rng.poisson(rng.gamma(5.0, p / (1.0 - p))).astype(float)
    noise = {"studentt": lambda: rng.standard_t(4.0, size=f.shape), "laplace": lambda: rng.laplace(size=f.shape)}
    return f + 0.1 * noise.get(name, lambda: rng.normal(size=f.shape))()


def branch_inputs(agt, b, m, device, lik, kind, at="flagship", seed=0):
    """Float32 card tensors as a main path hands them to kernel 1 for
    likelihood ``lik`` and gram kind ``kind``: a random mu and SPD Sigma,
    K^-1 from that kind's gram, and the likelihood's (p0, p1) as the step
    takes them.
    - at="flagship": X standard normal in D dimensions, Z the m rows before
      the batch, lengthscale 2, rho = N/B, labels around sin(x_0) + 0.5 x_1;
    - at="oracle": an oracle path's first slice, the first b rows of its
      data (D=2, labels as the oracle draws them), Z = X[:m] on those rows,
      lengthscale 1 (the kernels' default), rho = ON/OB."""
    from agp_tpu_torch.inference.analytic_vi import _fused_lik_spec
    from agp_tpu_torch.ops import linalg

    rng = np.random.default_rng(seed)
    if at == "flagship":
        X = rng.normal(size=(b + m, D))
        data = {"X": X[m:], "Z": X[:m], "y": single_latent_labels(lik, np.sin(X[m:, 0]) + 0.5 * X[m:, 1], rng)}
        ls, rho = 2.0, N / B
    else:
        X, y, _ = oracle_data(lik, "cpu")
        data = {"X": X[:b], "Z": X[:m], "y": y[:b]}
        ls, rho = 1.0, ON / OB
    A = rng.normal(size=(m, m))
    data.update(mu=rng.normal(size=m), Sigma=A @ A.T / m + np.eye(m))
    t = {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in data.items()}
    kern = {v: k for k, v in agt.kernels.FUSED_KINDS.items()}[kind](lengthscale=ls)
    L = linalg.safe_cholesky(kern.gram(t["Z"]), 1e-3)
    eye = torch.eye(m, dtype=torch.float32, device=device)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).T.contiguous()
    _, t["p0"], t["p1"], _ = _fused_lik_spec(single_latent_lik(agt, lik).to(device=device, dtype=torch.float32))
    t.update(kind=kind, lik=lik, ls=ls, rho=rho)
    return t


def call_branch(fn, t):
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], 1.0, 1e-3, t["rho"],
              lik_p0=t["p0"], lik_p1=t["p1"], kind=t["kind"], lik=t["lik"])


def check_outputs(label, names, got, ref, ref64=None, floor=KERNEL_TOL):
    """Every output finite and within KERNEL_TOL of the plain version's, as
    |d| over the output's largest entry (at least 1).  With ``ref64``, the
    plain version in float64 on the same inputs, each output's error is
    taken against it instead, within max(floor, FLOAT32_FACTOR times the
    float32 plain version's own error against it); the tensor-core kernels
    (1, 4-9) pass floor=0, so that their arithmetic is held to float32's
    own error however small.  Returns the largest absolute error against the
    plain version of each output."""
    row, against64 = {}, []
    for i, (name, o, r) in enumerate(zip(names, got, ref)):
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{label}: output {name} not finite")
        abs_err = float((o - r).abs().max())
        rel, tol = abs_err / max(float(r.abs().max()), 1.0), KERNEL_TOL
        if ref64 is not None:
            scale = max(float(ref64[i].abs().max()), 1.0)
            rel = float((o.double() - ref64[i]).abs().max()) / scale
            plain = float((r.double() - ref64[i]).abs().max()) / scale
            tol = max(floor, FLOAT32_FACTOR * plain)
            against64.append(f"{name}={rel:.2e}/{plain:.2e}")
        if rel > tol:
            raise AssertionError(f"{label}: {name} error {rel:.3e} > {tol:.3e}")
        row[name] = abs_err
    if against64:
        log(f"  {label} against float64, kernel/plain: " + " ".join(against64))
    return row


def to_float64(t):
    return {k: v.double() if isinstance(v, torch.Tensor) else v for k, v in t.items()}


def timed_pair(kern_fn, plain_fn, reps=200):
    """(kernel ms, plain ms) per call, in the order plain, kernel, kernel,
    plain, each the mean of its two runs."""
    plain = [cuda_ms(plain_fn, reps)]
    kern = [cuda_ms(kern_fn, reps) for _ in range(2)]
    plain.append(cuda_ms(plain_fn, reps))
    return sum(kern) / 2, sum(plain) / 2


def phase_branches_vs_plain(agt, ck, device):
    """Kernel 1 against its plain version on each likelihood branch (rbf)
    at the flagship shape and B=300, on each gram kind (Student-t) at M=64
    and M=128, and at the oracle paths' shape (B=8192, D=2, M=128) on each
    likelihood branch (rbf) and each Matern kind (Student-t), there against
    the float64 plain version with no floor; a second call of each
    bit-equal; each branch and kind timed at the flagship shape, Student-t
    at the oracle shape.
    Returns (largest abs error, {lik: (kernel ms, plain ms)}, {kind:
    (kernel ms, plain ms)}, (kernel ms, plain ms) at the oracle shape)."""
    names = ("s1", "S2", "c", "theta", "mf", "vf")
    worst, per_lik, per_kind = 0.0, {}, {}
    cases = [(lik, "rbf", b, M, "flagship") for lik in ck.LIKS for b in (B, 300)]
    cases += [("studentt", kind, B, m, "flagship") for kind in ck.KINDS for m in (M, 128)]
    cases += [(lik, "rbf", OB, OM, "oracle") for lik in ck.LIKS]
    cases += [("studentt", kind, OB, OM, "oracle") for kind in ck.KINDS[1:]]
    for lik, kind, b, m, at in cases:
        t = branch_inputs(agt, b, m, device, lik, kind, at=at)
        got = call_branch(ck.fused_cavi_stats, t)
        torch.cuda.synchronize()
        ref = call_branch(ck.fused_cavi_stats_reference, t)
        ref64 = call_branch(ck.fused_cavi_stats_reference, to_float64(t)) if at == "oracle" else None
        torch.cuda.synchronize()
        d = t["X"].shape[1]
        label = f"fused_cavi_stats {lik}/{kind} B={b} D={d} M={m}"
        row = check_outputs(label, names, got, ref, ref64, floor=0.0)
        check_repeat(label, lambda: call_branch(ck.fused_cavi_stats, t), got)
        worst = max(worst, *row.values())
        log(f"kernel vs plain {lik}/{kind} B={b} D={d} M={m}: max abs err "
            + " ".join(f"{k}={v:.2e}" for k, v in row.items()))
    t = branch_inputs(agt, OB, OM, device, "studentt", "rbf", at="oracle")
    oracle_ms = timed_pair(lambda: call_branch(ck.fused_cavi_stats, t),
                           lambda: call_branch(ck.fused_cavi_stats_reference, t))
    log(f"fused_cavi_stats studentt/rbf B={OB} D=2 M={OM} (oracle shape): kernel {oracle_ms[0]:.4f} ms, "
        f"plain {oracle_ms[1]:.4f} ms")
    for lik in ck.LIKS:
        t = branch_inputs(agt, B, M, device, lik, "rbf")
        per_lik[lik] = timed_pair(lambda: call_branch(ck.fused_cavi_stats, t),
                                  lambda: call_branch(ck.fused_cavi_stats_reference, t))
        log(f"fused_cavi_stats {lik}/rbf B={B} D={D} M={M}: kernel {per_lik[lik][0]:.4f} ms, plain {per_lik[lik][1]:.4f} ms")
    for kind in ck.KINDS:
        t = branch_inputs(agt, B, M, device, "studentt", kind)
        per_kind[kind] = timed_pair(lambda: call_branch(ck.fused_cavi_stats, t),
                                    lambda: call_branch(ck.fused_cavi_stats_reference, t))
        log(f"fused_cavi_stats studentt/{kind} B={B} D={D} M={M}: kernel {per_kind[kind][0]:.4f} ms, "
            f"plain {per_kind[kind][1]:.4f} ms")
    return worst, per_lik, per_kind, oracle_ms


def studentt_flagship_data(device, seed=0):
    """The flagship's X and latent X w, with y = X w + 0.1 t_4."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=D).astype(np.float32)
    y = (X @ w + 0.1 * rng.standard_t(4.0, size=N)).astype(np.float32)
    return torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)


def studentt_rate_first_in_process():
    """phase_studentt_rate as the first path of a process of its own
    (``python3 chip_smoke.py studentt-rate``), so that its rate compares
    with the flagship's, the first path of this one: the host's cost per
    launch grows over a process's life.  Relays that process's output and
    returns its launches."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "studentt-rate"],
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"Student-t rate process exited {proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    for line in lines[:-1]:
        log(f"  [studentt-rate] {line}")
    return json.loads(lines[-1])["launches"]


def phase_studentt_rate(agt, ck, device):
    """Student-t(4) at the flagship shape: MAIN_STEPS steps through
    agp_tpu_torch.train (one launch each), then steady-state iterations/s
    over T_TIMED_STEPS steps.  Returns (launches, it/s)."""
    from agp_tpu_torch.training.train import vi_steps

    X, y = studentt_flagship_data(device)
    model = agt.SVGP.create(
        agt.SqExponentialKernel(lengthscale=2.0, variance=1.0), agt.StudentTLikelihood.create(4.0),
        agt.AnalyticSVI(B, minibatch_sampling="block"), X[:M], optimiser=None,
    )
    gen = torch.Generator(device=device).manual_seed(0)
    reset_launches(ck)
    model, state = agt.train(model, X, y, iterations=MAIN_STEPS, generator=gen)
    torch.cuda.synchronize()
    launches = ck.fused_cavi_stats.launches
    if launches != MAIN_STEPS:
        raise AssertionError(f"Student-t: {MAIN_STEPS} steps launched the kernel {launches} times")
    if not (bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())):
        raise AssertionError("Student-t: non-finite posterior")
    model, state = vi_steps(model, state, X, y, 50, generator=gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, state = vi_steps(model, state, X, y, T_TIMED_STEPS, generator=gen)
    torch.cuda.synchronize()
    ips = T_TIMED_STEPS / (time.perf_counter() - t0)
    log(f"Student-t steady state (N={N}, D={D}, M={M}, B={B}, block): {ips:.1f} CAVI iterations/s over "
        f"{T_TIMED_STEPS} steps; {launches} launches in {MAIN_STEPS} steps")
    return launches, ips


def oracle_data(lik, device, seed=0):
    """The reference's oracle data for likelihood ``lik``, made with numpy:
    X uniform on [-2, 2]^2, f = sin(2 x_0) + 0.5 x_1, y as
    benchmarks/tpu_acceptance.py draws it.  Returns (X, y, truth), truth
    the noiseless f (regression), the labels (SVM; logistic, which the
    kernel checks take at this shape), the rate (Poisson) or
    the mean (negative binomial)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(ON, 2))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    if lik in ("bayesiansvm", "logistic"):
        y = truth = np.sign(f)
    elif lik == "poisson":
        truth = 20.0 / (1.0 + np.exp(-f))
        y = rng.poisson(truth).astype(float)
    elif lik == "negbinomial":
        p = 1.0 / (1.0 + np.exp(-(f - 1.0)))
        truth = 5.0 * p / (1.0 - p)
        y = rng.poisson(rng.gamma(5.0, p / (1.0 - p))).astype(float)
    else:
        draw = {"studentt": lambda: rng.standard_t(4.0, size=ON), "laplace": lambda: rng.laplace(size=ON)}
        noise = draw.get(lik, lambda: rng.normal(size=ON))()
        y, truth = f + (0.05 if lik == "gaussian" else 0.1) * noise, f
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in (X, y, truth))


def oracle_model(agt, X, lik, kernel="SqExponentialKernel", m=OM, b=OB):
    """The reference's oracle model (tpu_acceptance.py _fused_svgp) with m
    inducing points (M=128 for the fused pass, the reference's 512 for the
    batched pair): default kernel hyperparameters, slice sampling, B=b
    (the reference's 8192 unless a parity check cuts it)."""
    liks = {
        "studentt": lambda: agt.StudentTLikelihood.create(4.0),
        "laplace": lambda: agt.LaplaceLikelihood.create(0.1),
        "matern32": lambda: agt.Matern32Likelihood.create(0.2),
        "gaussian": lambda: agt.GaussianLikelihood.create(0.05),
        "bayesiansvm": lambda: agt.BayesianSVM.create(),
        "poisson": lambda: agt.PoissonLikelihood.create(10.0),
        "negbinomial": lambda: agt.NegBinomialLikelihood.create(5.0),
    }
    return agt.SVGP.create(getattr(agt, kernel)(), liks[lik](), agt.AnalyticSVI(b, minibatch_sampling="slice"),
                           X[:m], optimiser=None)


def oracle_metric(agt, model, state, X, truth, metric):
    """The oracle's metric on X[:4096]: RMSE of predict_f against f,
    accuracy of predict_y, or corr(predict_y, truth)."""
    Xe, te = X[:4096], truth[:4096]
    if metric == "rmse":
        return float(torch.sqrt(torch.mean((agt.predict_f(model, state, Xe) - te) ** 2)))
    pred = agt.predict_y(model, state, Xe)
    if metric == "acc":
        return float(((pred > 0) == (te > 0)).float().mean())
    return float(torch.corrcoef(torch.stack([pred, te]))[0, 1])


def phase_oracles(agt, ck, device, m=OM, floors=None, paths=None):
    """Each oracle path through agp_tpu_torch.train with m inducing points:
    OSTEPS steps, finite posterior (and lambda), its floor.  At m <= 128
    each step launches kernel 1 once; beyond, kernels 6 and 7 once each and
    no fused kernel.  Returns (total launches of the path's kernels,
    {path: metric})."""
    floors = ORACLE_FLOORS if floors is None else floors
    results, total = {}, 0
    for lik, kernel in single_paths() if paths is None else paths:
        X, y, truth = oracle_data(lik, device)
        model = oracle_model(agt, X, lik, kernel, m=m)
        reset_launches(ck)
        t0 = time.perf_counter()
        model, state = agt.train(model, X, y, iterations=OSTEPS, generator=torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        name = f"{lik}/{kernel}"
        launches = expect_launches(ck, f"oracle {name} M={m}",
                                   route_launches(OSTEPS, "single" if m > ck.MAX_M else "fused"))
        total += launches
        tensors = [state.mu, state.Sigma] + ([model.likelihood.lam] if lik == "poisson" else [])
        if not all(bool(torch.isfinite(t).all()) for t in tensors):
            raise AssertionError(f"oracle {name}: non-finite posterior or lambda")
        metric, floor = floors[name]
        value = oracle_metric(agt, model, state, X, truth, metric)
        ok = value < floor if metric == "rmse" else value > floor
        if not ok:
            raise AssertionError(f"oracle {name} M={m}: {metric} {value:.4f} misses its floor {floor}")
        extra = f", lambda {float(model.likelihood.lam):.4f}" if lik == "poisson" else ""
        log(f"oracle {name} (N={ON}, D=2, M={m}, B={OB}, {OSTEPS} steps): {metric} {value:.4f} "
            f"(floor {floor}){extra}, {launches} launches, {train_s:.3f} s")
        results[name] = value
    return total, results


def route_launches(steps, route, fused="fused_cavi_stats", hyper_steps=0, f64=False):
    """Each kernel's launches in ``steps`` CAVI steps on ``route`` ("fused":
    kernel ``fused`` once a step; "single": kernels 6 and 7; "batched":
    kernels 4 and 5) and ``hyper_steps`` hyperparameter steps of one latent
    (kernel 6's forward once each; the backward launches nothing); with
    ``f64``, of kernels 4-7's float64 forms (a float64 model: the fused
    kernels take float32 only)."""
    want = {"fused": {fused: steps}, "single": {"fused_kappa": steps, "cavi_stats": steps},
            "batched": {"fused_kappa_moments_batched": steps, "cavi_stats_batched": steps}}[route]
    if hyper_steps:
        want["fused_kappa"] = want.get("fused_kappa", 0) + hyper_steps
    if f64:
        if route == "fused":
            raise ValueError("the fused kernels take float32 only")
        want = {f"{name}_f64": n for name, n in want.items()}
    return want


# each kernel's launches over every main-path run of this process (the
# kernels line's "launches")
LAUNCHES = dict()


def expect_launches(ck, label, want):
    """Fails unless the run just made launched each kernel as many times as
    ``want`` names (route_launches) and nothing else; adds them to
    LAUNCHES and returns their sum."""
    counts = {name: launches_of(ck, name) for name in LAUNCH_COUNTERS}
    expected = {name: want.get(name, 0) for name in LAUNCH_COUNTERS}
    if counts != expected:
        raise AssertionError(f"{label}: launched {counts}, expected {expected}")
    for name, n in counts.items():
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n
    return sum(counts.values())


def single_paths():
    return [(lik, "SqExponentialKernel") for lik in ORACLE_LIKS] + [("studentt", k) for k in MATERN_KERNELS]


def phase_single_parity(agt, ck, device):
    """Card (float32) against CPU (float32, the plain version) after 20
    steps from the same draws, for each single-latent path:
    - at the flagship's conditioning (N=20,000, D=20, M=64, lengthscale 2,
      B=4096, slice; labels around sin(x_0) + 0.5 x_1), within
      ORACLE_DEVICE_FACTOR times the CPU's own float32 noise there (the
      same CPU run with X's features in another order), or
      MATERN12_PARITY_TOL for the Matern-1/2 kernel;
    - at the oracle configuration itself, against each path's own float32
      noise there (the same CPU run with the inducing points in another
      order): the card within ORACLE_DEVICE_FACTOR times it of the CPU,
      and within it of the card with the plain version in the kernel's
      place."""
    draws = torch.randint(0, PN - B + 1, (20,), generator=torch.Generator().manual_seed(1))
    fperm = torch.randperm(D, generator=torch.Generator().manual_seed(3))
    for lik, kernel in single_paths():
        rng = np.random.default_rng(1)
        Xn = rng.normal(size=(PN, D))
        y = single_latent_labels(lik, np.sin(Xn[:, 0]) + 0.5 * Xn[:, 1], rng)
        Xc, yc = (torch.as_tensor(a, dtype=torch.float32) for a in (Xn, y))

        def model(X):
            lik_t = oracle_model(agt, X, lik).likelihood
            return agt.SVGP.create(getattr(agt, kernel)(lengthscale=2.0), lik_t,
                                   agt.AnalyticSVI(B, minibatch_sampling="slice"), X[:M], optimiser=None)

        cpu = after_20(agt, model(Xc), Xc, yc, draws)
        err = rel_err(after_20(agt, model(Xc.to(device)), Xc.to(device), yc.to(device), draws), cpu)
        Xp = Xc[:, fperm].contiguous()
        noise = rel_err(after_20(agt, model(Xp), Xp, yc, draws), cpu)
        what = f"(N={PN}, D={D}, M={M}, B={B}) 20 steps card (float32) vs CPU (float32)"
        if kernel != "Matern12Kernel":
            parity_check(f"{lik}/{kernel} flagship-conditioning", err, noise, what=what)
            continue
        if not err <= MATERN12_PARITY_TOL:
            raise AssertionError(f"{lik}/{kernel}: card float32 vs CPU float32 after 20 steps: {err:.3e} > "
                                 f"{MATERN12_PARITY_TOL}")
        log(f"{lik}/{kernel} parity {what}, max |d mu| / max |mu| (and |d lam| / lam) = {err:.3e} (bound "
            f"{MATERN12_PARITY_TOL}); CPU with features reordered vs CPU {noise:.3e}")
    draws = torch.randint(0, ON - OB + 1, (20,), generator=torch.Generator().manual_seed(1))
    perm = torch.randperm(OM, generator=torch.Generator().manual_seed(2))
    for lik, kernel in single_paths():
        Xc, yc, _ = oracle_data(lik, "cpu", seed=1)
        Xd, yd = Xc.to(device), yc.to(device)
        cpu = after_20(agt, oracle_model(agt, Xc, lik, kernel), Xc, yc, draws)
        card = after_20(agt, oracle_model(agt, Xd, lik, kernel), Xd, yd, draws)
        with plain_kernels(ck):
            card_plain = after_20(agt, oracle_model(agt, Xd, lik, kernel), Xd, yd, draws)
        m = oracle_model(agt, Xc, lik, kernel)
        mu_p, lam_p = after_20(agt, m.replace(Z=m.Z[:, perm].contiguous()), Xc, yc, draws)
        noise = rel_err((mu_p[:, torch.argsort(perm)], lam_p), cpu)
        label = f"oracle {lik}/{kernel}"
        parity_check(label, rel_err(card, cpu), noise)
        parity_check(label + " kernel", rel_err(card, card_plain), noise, factor=1.0,
                     what="card vs the card with the plain version")


# ------------------------------------------- the batched pair (M > 128)
def big_logistic_data(device, n=LN, seed=0):
    """bench.py's logistic_m512_b65536 data: X standard normal in LD=20
    dimensions, labels the sign of X w."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, LD)).astype(np.float32)
    y = np.where(X @ rng.normal(size=LD).astype(np.float32) > 0, 1.0, -1.0).astype(np.float32)
    return torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)


def big_logistic_model(agt, X, b=LB, optimiser=None):
    return agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create(),
                           agt.AnalyticSVI(b, minibatch_sampling="slice"), X[:PM], optimiser=optimiser)


def pair_mc_data(device, seed=0):
    """tpu_acceptance.py's batched multiclass oracle data: X standard
    normal in 2-D (N=30,000), the label of the nearest of three centres."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ON, 2))
    centres = np.array([[1.5, 0.0], [-1.5, 1.0], [0.0, -1.5]])
    y = np.argmin(((X[:, None, :] - centres[None]) ** 2).sum(-1), axis=1)
    return torch.as_tensor(X, dtype=torch.float32, device=device), torch.as_tensor(y, device=device)


def pair_het_data(device, seed=0):
    """tpu_acceptance.py's batched heteroscedastic oracle data: x uniform
    on [-2, 2] (N=30,000), f = sin(2x), g = -1.5 + 1.2 tanh(x),
    y = f + eps / sqrt(8 sigma(g)).  Returns (X, y, f)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(ON, 1))
    f = np.sin(2 * X[:, 0])
    g = -1.5 + 1.2 * np.tanh(X[:, 0])
    y = f + np.sqrt(1.0 / (8.0 / (1.0 + np.exp(-g)))) * rng.normal(size=ON)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in (X, y, f))


def pair_multi_model(agt, X, which, b=None):
    """The reference's batched-tier oracle models at M=512: logistic-softmax
    K=3 with B=8192, or heteroscedastic (lambda 8) with B=16384 (or B=b);
    the default kernel, slice sampling."""
    if which == "multiclass":
        lik, b = agt.LogisticSoftMaxLikelihood.create(3), b or PAIR_MC_B
    else:
        lik, b = agt.HeteroscedasticLikelihood.create(lam=8.0), b or PAIR_HET_B
    return agt.SVGP.create(agt.SqExponentialKernel(), lik, agt.AnalyticSVI(b, minibatch_sampling="slice"),
                           X[:PM], optimiser=None)


@contextlib.contextmanager
def plain_kernels(ck, names=("fused_cavi_stats",)):
    """The step takes the plain versions in the named kernels' place."""
    wrappers = {name: getattr(ck, name) for name in names}
    for name in names:
        setattr(ck, name, getattr(ck, name + "_reference"))
    try:
        yield
    finally:
        for name, fn in wrappers.items():
            setattr(ck, name, fn)


# the kernels of the split pairs: batched (4-5) and single-latent (6-7)
SPLIT_PAIRS = ("fused_kappa_moments_batched", "cavi_stats_batched", "fused_kappa", "cavi_stats")
# the kernels' launch counts: NAME is the float32 kernel's, NAME_f64 the
# float64 form's of kernels 4-7 (``launch_count``)
LAUNCH_COUNTERS = ("fused_cavi_stats", "fused_cavi_stats_multiclass", "fused_cavi_stats_het",
                   "fused_kappa_moments_batched", "cavi_stats_batched", "fused_kappa", "cavi_stats",
                   "direct_stats", "two_factor_nt", "gather_row_tiles") + tuple(f"{n}_f64" for n in SPLIT_PAIRS)


def wrapper(ck, name):
    """The wrapper of kernel ``name``: one of ops/cuda_kernels.py, or one of
    the bench's kernels (agp_tpu_torch/benchmarks/)."""
    from agp_tpu_torch.benchmarks import fused_variants, gather_modes

    for module in (ck, fused_variants, gather_modes):
        if hasattr(module, name):
            return getattr(module, name)
    raise KeyError(name)


def launch_count(ck, name):
    """(wrapper, attribute) of counter ``name`` of LAUNCH_COUNTERS: kernels
    4-7's float64 forms count in their wrapper's ``launches_f64``."""
    if name.endswith("_f64"):
        return wrapper(ck, name.removesuffix("_f64")), "launches_f64"
    return wrapper(ck, name), "launches"


def launches_of(ck, name):
    return getattr(*launch_count(ck, name))


def reset_launches(ck):
    for name in LAUNCH_COUNTERS:
        setattr(*launch_count(ck, name), 0)


# -------------------------------------------- the batched pair's phases
def check_fused_fits(ck):
    """fused_fits (Python, the same on the CPU) against the library's own
    shared-memory functions of kernels 1-3 on a grid of (latents, D, M)
    (neither depends on D)."""
    lib, n = ck._library(), 0
    for d in (1, 2, 10, 20, 44, 45, 46, 64, 4096):
        for m in (1, 16, 63, 64, 127, 128, 129, 512):
            for n_latent in (1, 2, 10):
                smem = lib.agp_fused_cavi_smem_bytes(m) if n_latent == 1 else lib.agp_multi_smem_bytes(m)
                if ck.fused_fits(n_latent, d, m) != (m <= ck.MAX_M and smem <= ck.SMEM_OPTIN):
                    raise AssertionError(f"fused_fits({n_latent}, {d}, {m}) disagrees with {smem} bytes")
                n += 1
    log(f"fused_fits agrees with the library's shared-memory functions at {n} (latents, D, M)")


def check_kappa_tiles(ck):
    """kappa_smem_bytes (Python, the same on the CPU) against the library's
    own shared-memory functions of kernels 4 and 6 at every row tile, and
    so the wrapper's tile choice (kappa_tile_rows), on a grid of M."""
    lib, n = ck._library(), 0
    grid = (1, 8, 64, 128, 129, 320, 321, 336, 337, 512, 680, 681, 696, 697, 700, 1184, 1185, 1192, 1193, 1392, 1393,
            1408, 1409, 1680, 2158, 2392, 2393, 2406, 2407)
    for dtype, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
        for which, fn in (("moments", getattr(lib, "agp_kappa_moments_smem_bytes" + suffix)),
                          ("single", getattr(lib, "agp_fused_kappa_smem_bytes" + suffix))):
            for m in grid:
                for tb in (64, 32, 16):
                    if fn(m, tb) != ck.kappa_smem_bytes(which, m, tb, dtype):
                        raise AssertionError(f"kappa_smem_bytes({which!r}, {m}, {tb}, {dtype}) disagrees with "
                                             f"{fn(m, tb)} bytes")
                    n += 1
        tiles = {which: {m: ck.kappa_tile_rows(which, m, dtype=dtype) for m in (64, 512, 1184, 1680, 2158)}
                 for which in ("moments", "single")}
        log(f"kappa_smem_bytes ({dtype}) agrees with the library's shared-memory functions; row tiles (kernel 4, "
            f"moments / kernel 6, single): {tiles}; largest M {ck.kappa_max_m('moments', dtype=dtype)} / "
            f"{ck.kappa_max_m('single', dtype=dtype)}")
    log(f"kappa_smem_bytes: {n} (dtype, kernel, M, tile) checked")
    for dtype, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
        smem = getattr(lib, "agp_kappa_cols_smem_bytes" + suffix)()
        if smem != ck.kappa_cols_smem_bytes(dtype):
            raise AssertionError(f"kappa_cols_smem_bytes({dtype}) = {ck.kappa_cols_smem_bytes(dtype)}, the library's "
                                 f"{smem}")
        scratch = getattr(lib, "agp_kappa_cols_scratch" + suffix)
        for which in ("moments", "single"):
            for b, m, n_latent in ((1, 1, 1), (300, 129, 3), (65_536, 512, 1), (16_384, 4096, 1), (3000, 3000, 2)):
                if scratch(int(which == "moments"), b, m, n_latent) != ck.kappa_cols_scratch(which, b, m, n_latent, dtype):
                    raise AssertionError(f"kappa_cols_scratch({which!r}, {b}, {m}, {n_latent}, {dtype}) disagrees "
                                         f"with the library's {scratch(int(which == 'moments'), b, m, n_latent)}")
        log(f"kappa_cols_smem_bytes ({dtype}): {smem} bytes a block, the library's; kappa_cols_scratch agrees")


def check_variant_tiles(ck):
    """variant_smem_bytes (Python, the same on the CPU) against the
    library's own shared-memory function of kernels 8-9 at every row tile
    on a grid of M, and so the wrappers' tile choice (variant_tile); an
    unknown tile gets SIZE_MAX."""
    import ctypes

    from agp_tpu_torch.benchmarks import fused_variants as fv

    lib, n = ck._library(), 0
    for m in (1, 8, 64, 127, 128, 129, 512, 520, 680, 681, 1392, 1393, 2392, 2393):
        for tile in fv._VARIANT_TILES:
            if lib.agp_fused_variant_smem_bytes(m, tile[0], tile[1]) != fv.variant_smem_bytes(m, tile):
                raise AssertionError(f"variant_smem_bytes({m}, {tile}) disagrees with the library's "
                                     f"{lib.agp_fused_variant_smem_bytes(m, tile[0], tile[1])} bytes")
            n += 1
    if lib.agp_fused_variant_smem_bytes(64, 64, 64) != ctypes.c_size_t(-1).value:
        raise AssertionError("agp_fused_variant_smem_bytes takes an unknown tile")
    tiles = {m: fv.variant_tile(m)[:2] for m in (64, 128, 129, 512, 681, 1393, 2392)}
    log(f"variant_smem_bytes agrees with the library at {n} (M, tile); row tiles (rows, columns) by M: {tiles}; "
        f"largest M {fv.variant_max_m()}")


def pair_inputs(X_all, b, m, n_latent, device, kind="rbf", ls=2.0, seed=0):
    """Float32 card tensors as a path hands them to kernel 4: the batch
    X_all[:b], Z = X_all[:m] (on the batch's rows, as a path's first slice)
    for each latent, lengthscale ls, variance 1, L^-T from the float32
    Cholesky of that kind's Kmm with jitter 1e-3, a random mu and SPD
    Sigma; and kernel 5's g (normal) and theta (uniform on [0, 0.5])."""
    import agp_tpu_torch as agt
    from agp_tpu_torch.ops import linalg

    rng = np.random.default_rng(seed)
    X = X_all[:b].to(device=device, dtype=torch.float32).contiguous()
    Z = X_all[:m].to(device=device, dtype=torch.float32)
    A = rng.normal(size=(n_latent, m, m))
    f32 = dict(dtype=torch.float32, device=device)
    t = {"X": X, "Z": Z.expand(n_latent, m, X.shape[1]).contiguous(),
         "ls": torch.full((n_latent, X.shape[1]), ls, **f32), "var": torch.ones(n_latent, **f32),
         "mu": torch.as_tensor(rng.normal(size=(n_latent, m)), **f32),
         "Sigma": torch.as_tensor(A @ A.transpose(0, 2, 1) / m + np.eye(m), **f32),
         "g": torch.as_tensor(rng.normal(size=(n_latent, b)), **f32),
         "theta": torch.as_tensor(rng.uniform(0, 0.5, size=(n_latent, b)), **f32), "kind": kind}
    kern = {v: k for k, v in agt.kernels.FUSED_KINDS.items()}[kind](lengthscale=ls)
    L = linalg.safe_cholesky(kern.gram(Z), 1e-3)
    t["L_invT"] = torch.linalg.solve_triangular(L, torch.eye(m, **f32), upper=False).T.expand(n_latent, m, m).contiguous()
    return t


def call_k4(fn, t):
    return fn(t["X"], t["Z"], t["L_invT"], t["ls"], t["var"], t["mu"], t["Sigma"], 1e-3, t["kind"])


def pair_cases(device):
    """(label, inputs, float64 check, timed) of each shape the pair is held
    at: the paths' own shapes and the flagship's (B=4096, D=20, M=64; all
    timed), ragged B=300, M=129 with 1-3 latents, and each Matern kind.
    The oracle, multiclass and heteroscedastic shapes (Z on the batch's
    rows, lengthscale 1, low dimension) are ill-conditioned (cond(Kmm) up
    to ~5e5), so there each output is held against the plain version in
    float64."""
    Xl, _ = big_logistic_data("cpu", n=LB)
    Xf, _ = flagship_data("cpu", n=B)
    Xo = oracle_data("studentt", "cpu")[0]
    cases = [("logistic_m512_b65536", pair_inputs(Xl, LB, PM, 1, device), False, True),
             ("flagship_m64_b4096", pair_inputs(Xf, B, M, 1, device), False, True),
             ("oracle_m512_b8192", pair_inputs(Xo, OB, PM, 1, device, ls=1.0), True, True),
             ("multiclass_m512_b8192", pair_inputs(pair_mc_data("cpu")[0], PAIR_MC_B, PM, 3, device, ls=1.0), True, True),
             ("het_m512_b16384", pair_inputs(pair_het_data("cpu")[0], PAIR_HET_B, PM, 2, device, ls=1.0), True, True)]
    cases += [(f"ragged_L{n}", pair_inputs(Xl, 300, 129, n, device, seed=n), False, False) for n in (1, 2, 3)]
    cases += [(f"{k}_ragged_L2", pair_inputs(Xl, 300, 129, 2, device, kind=k), False, False) for k in MATERN_KINDS]
    cases += [(f"{k}_oracle_m512", pair_inputs(Xo, OB, PM, 1, device, kind=k, ls=1.0), True, False)
              for k in MATERN_KINDS]
    return cases


MATERN_KINDS = ("matern12", "matern32", "matern52")
# the H100's published peaks (SXM, NVIDIA's data sheet, dense): FP32 outside
# the tensor cores, TF32 on them, and HBM3 bandwidth
PEAK_FP32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES_S = 67e12, 495e12, 3.35e12


def bound(fmas, nbytes):
    """(ms, "operations" or "bytes"): the larger of 2 fmas over the FP32
    peak and nbytes over the memory rate."""
    ops_ms, bytes_ms = 2.0 * fmas / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# FMAs a row needs for a symmetric product: the quadratic form kappa Sigma
# kappa^T (Sigma symmetric) or one row's share of S2 = kappa^T diag(theta)
# kappa (S2 symmetric), each counted on the upper triangle
def sym_fmas(m):
    return m * (m + 1) // 2


def fused_bound(b, d, m, n_latent, label_words):
    """Kernels 1-3: per row and latent kappa (M^2), vf's quadratic form and
    S2 (each ``sym_fmas``), the gram (M D) and ~5 M more FMAs; the inputs
    read and the outputs written once (label_words: the per-row inputs and
    outputs beyond x).  Returns three bounds, each (ms, by), as
    kappa_bounds: the function's (its products once at the TF32 peak,
    ``tc_bound``), a 3xTF32 design's (kappa and kappa Sigma in full and S2's
    upper triangle in three TF32 passes: kernels 1-3's design) and the
    FP32 one (``bound``)."""
    tc = n_latent * b * (m * m + 2 * sym_fmas(m))
    design = 3 * n_latent * b * (2 * m * m + sym_fmas(m))
    simt = n_latent * b * (m * d + 5 * m)
    nbytes = 4 * (b * d + b * label_words + n_latent * (m * d + 2 * m * m + 2 * m + m * m))
    return tc_bound(tc, simt, nbytes), tc_bound(design, simt, nbytes), bound(tc + simt, nbytes)


def tc_bound(tc_fmas, simt_fmas, nbytes):
    """(ms, "operations" or "bytes"): the larger of tc_fmas at the TF32
    tensor-core peak, simt_fmas at the FP32 one (another pipe, so the two
    overlap) and nbytes over the memory rate."""
    ops_ms = max(2.0 * tc_fmas / PEAK_TF32_FLOPS, 2.0 * simt_fmas / PEAK_FP32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def kappa_bounds(b, d, m, n_latent, moments):
    """Kernel 4 (moments: kappa, mf, vf; L latents) or 6 (kappa, Ktilde):
    per row and latent kappa's M^2 FMAs, for kernel 4 the quadratic form
    kappa Sigma kappa^T (``sym_fmas``; the design forms kappa Sigma in
    full, M^2), and on the FP32 pipes the gram's M D and the row sums' M
    (kernel 4: 3 M); reads X, Z, L^-T, ls, var (and mu, Sigma), writes
    kappa and Ktilde (mf, vf).  Returns three bounds, each (ms, by): the
    function's (its products once at the TF32 peak, ``tc_bound``), the
    design's (each full product in three TF32 passes) and the FP32 SIMT one
    (``bound``)."""
    tc = n_latent * b * (m * m + (sym_fmas(m) if moments else 0))
    design = 3 * n_latent * b * m * m * (2 if moments else 1)
    simt = n_latent * b * (m * d + (3 if moments else 1) * m)
    if moments:
        nbytes = 4 * (b * d + n_latent * (m * d + 2 * m * m + d + 1 + m + b * m + 2 * b))
    else:
        nbytes = 4 * (b * d + m * d + m * m + d + 1 + b * m + b)
    return tc_bound(tc, simt, nbytes), tc_bound(design, simt, nbytes), bound(tc + simt, nbytes)


def pair_bounds(b, d, m, n_latent):
    """Kernels 4 and 5: ``kappa_bounds`` and ``stats_bounds``."""
    return kappa_bounds(b, d, m, n_latent, True), stats_bounds(b, m, n_latent)


def single_bounds(b, d, m):
    """Kernels 6 and 7: ``kappa_bounds`` and ``stats_bounds`` with one
    latent."""
    return kappa_bounds(b, d, m, 1, False), stats_bounds(b, m, 1)


def stats_bounds(b, m, n_latent):
    """Kernels 5 and 7 (L latents): S2 (``sym_fmas`` a row) and s1 (M);
    reads kappa, g, theta, writes s1, S2.  Returns three bounds, each (ms,
    by): the function's, S2's FMAs once on the tensor cores and s1's on the
    FP32 pipes (``tc_bound``); the design's, with S2's three TF32 passes
    (3xTF32); and the FP32 SIMT one (``bound``)."""
    s2_fmas, s1_fmas = n_latent * b * sym_fmas(m), n_latent * b * m
    nbytes = 4 * n_latent * (b * m + 2 * b + m + m * m)
    return (tc_bound(s2_fmas, s1_fmas, nbytes), tc_bound(3 * s2_fmas, s1_fmas, nbytes),
            bound(s2_fmas + s1_fmas, nbytes))


def kernel_name(key):
    """A profiler event's kernel name without its return type, anonymous
    namespace and arguments, at most 60 characters."""
    return key.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0].strip()[:60]


def device_us(fn, n=10):
    """(device us a call, {kernel: us a call}) of fn by torch.profiler over
    n calls after one, each kernel by ``kernel_name``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
            key = kernel_name(e.key)
            by[key] = by.get(key, 0.0) + e.self_device_time_total / n
    return sum(by.values()), by


def check_repeat(label, fn, got):
    """Kernels 4-7: a second call, fn(), bit-equal to the first's outputs
    ``got`` (no atomics; every sum in a fixed order)."""
    again = fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: a second call differs from the first")


def check_stats_repeat(label, fn, args, got):
    """Kernels 5 and 7: S2 exactly symmetric, and a second call bit-equal to
    the first."""
    if not torch.equal(got[1], got[1].mT):
        raise AssertionError(f"{label}: S2 is not exactly symmetric")
    check_repeat(label, lambda: fn(*args), got)


def kappa_products(ck, t, single):
    """One PyTorch call of kernel 6's product alone, torch.matmul(Knm,
    K^-1) ("kappa's product alone"), or of kernel 4's two, torch.bmm(Knm,
    K^-1) and torch.bmm(kappa, Sigma), on float32 operands the plain
    version forms from the case's inputs: a yardstick of the tensor
    products, not the whole function, which the port never calls."""
    kinv = ck._kinv(t["L_invT"])
    if single:
        ls = t["ls"]
        knm = ck._kappa_ktilde((t["X"] / ls)[None], (t["Z"] / ls)[None], kinv[None], t["var"].reshape(1), 1e-3,
                               t["kind"])[2][0]
        return lambda: torch.matmul(knm, kinv)
    ls = t["ls"][:, None, :]
    kappa, _, knm = ck._kappa_ktilde(t["X"][None] / ls, t["Z"] / ls, kinv, t["var"], 1e-3, t["kind"])
    return lambda: (torch.bmm(knm, kinv), torch.bmm(kappa, t["Sigma"]))


def kappa_timing(ck, name, t, reps):
    """Kernel ``name`` (fused_kappa_moments_batched or fused_kappa) at one
    shape: its ms by CUDA events beside its plain version (plain, kernel,
    kernel, plain) and its device us (profiler), and the same of its
    products alone (``kappa_products``)."""
    single = name == "fused_kappa"
    caller = call_k6 if single else call_k4
    fn, plain = getattr(ck, name), getattr(ck, name + "_reference")
    ms, plain_ms = timed_pair(lambda: caller(fn, t), lambda: caller(plain, t), reps)
    dev, dev_by = device_us(lambda: caller(fn, t))
    products = kappa_products(ck, t, single)
    return {"ms": ms, "plain_ms": plain_ms, "device_us": dev, "device_us_by_kernel": dev_by,
            "products_ms": cuda_ms(products, reps), "products_device_us": device_us(products)[0]}


def kappa_line(label, name, r):
    what = "kappa's product alone, torch.matmul" if name == "kernel 6" else "the products alone, torch.bmm x2"
    return (f"  {label}: {name} {r['ms']:.4f} ms, device {r['device_us']:.1f} us ("
            + ", ".join(f"{k} {v:.1f}" for k, v in r["device_us_by_kernel"].items()) + f"); plain "
            f"{r['plain_ms']:.4f}; {what} {r['products_ms']:.4f} ms, device {r['products_device_us']:.1f} us")


def stats_timing(ck, name, kappa, g, th, reps, library_fn):
    """Kernel ``name`` (cavi_stats_batched or cavi_stats) at one shape: its
    ms by CUDA events beside its plain version (plain, kernel, kernel,
    plain) and ``library_fn`` (one PyTorch call of the same sums, which the
    port never calls), and the device us of the kernel and the library call
    (profiler)."""
    fn, plain = getattr(ck, name), getattr(ck, name + "_reference")
    ms, plain_ms = timed_pair(lambda: fn(kappa, g, th), lambda: plain(kappa, g, th), reps)
    lib_ms = cuda_ms(library_fn, reps)
    dev, dev_by = device_us(lambda: fn(kappa, g, th))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "device_us": dev, "device_us_by_kernel": dev_by,
            "library_device_us": device_us(library_fn)[0]}


def stats_line(label, name, r):
    return (f"  {label}: {name} {r['ms']:.4f} ms, device {r['device_us']:.1f} us "
            + "(" + ", ".join(f"{k} {v:.1f}" for k, v in r["device_us_by_kernel"].items()) + f"); plain "
            f"{r['plain_ms']:.4f}; library {r['library_ms']:.4f} ms, device {r['library_device_us']:.1f} us")


def phase_pair_kernels_vs_plain(ck, device):
    """Kernels 4 and 5 against their plain versions at every case of
    pair_cases (at the float64 cases with no KERNEL_TOL floor: within
    FLOAT32_FACTOR times the float32 plain version's own error), then timed
    at the paths' shapes beside their plain versions (kernel 4 beside its
    products alone, kappa_timing; kernel 5 beside torch.bmm, stats_timing;
    neither of which the port calls), with their device us.  Kernel 5's S2
    exactly symmetric, and a second call of each bit-equal, at every case.
    Returns {kernel: (largest abs error, {shape: (ms, plain ms)}, {shape:
    library ms}, {shape: kappa_timing's or stats_timing's dict})}."""
    worst = {"fused_kappa_moments_batched": 0.0, "cavi_stats_batched": 0.0}
    extra = {"fused_kappa_moments_batched": {}, "cavi_stats_batched": {}}
    times = {"fused_kappa_moments_batched": {}, "cavi_stats_batched": {}}
    library = {"fused_kappa_moments_batched": {}, "cavi_stats_batched": {}}
    for label, t, f64, timed in pair_cases(device):
        got = call_k4(ck.fused_kappa_moments_batched, t)
        torch.cuda.synchronize()
        ref = call_k4(ck.fused_kappa_moments_batched_reference, t)
        ref64 = call_k4(ck.fused_kappa_moments_batched_reference, to_float64(t)) if f64 else None
        row = check_outputs(f"fused_kappa_moments_batched {label}", ("kappa", "mf", "vf"), got, ref, ref64, floor=0.0)
        check_repeat(f"fused_kappa_moments_batched {label}", lambda: call_k4(ck.fused_kappa_moments_batched, t), got)
        worst["fused_kappa_moments_batched"] = max(worst["fused_kappa_moments_batched"], *row.values())
        kappa = ref[0].contiguous()
        s_got = ck.cavi_stats_batched(kappa, t["g"], t["theta"])
        torch.cuda.synchronize()
        s_ref = ck.cavi_stats_batched_reference(kappa, t["g"], t["theta"])
        s64 = ck.cavi_stats_batched_reference(kappa.double(), t["g"].double(), t["theta"].double()) if f64 else None
        row5 = check_outputs(f"cavi_stats_batched {label}", ("s1", "S2"), s_got, s_ref, s64, floor=0.0)
        check_stats_repeat(f"cavi_stats_batched {label}", ck.cavi_stats_batched, (kappa, t["g"], t["theta"]), s_got)
        worst["cavi_stats_batched"] = max(worst["cavi_stats_batched"], *row5.values())
        L_, B_, M_ = kappa.shape
        log(f"pair vs plain {label} (B={B_}, D={t['X'].shape[1]}, M={M_}, L={L_}, {t['kind']}): max abs err "
            + " ".join(f"{k}={v:.2e}" for k, v in {**row, **row5}.items()))
        if timed:
            reps = 10 if B_ > 20000 else 30
            r4 = kappa_timing(ck, "fused_kappa_moments_batched", t, reps)
            extra["fused_kappa_moments_batched"][label] = r4
            times["fused_kappa_moments_batched"][label] = (r4["ms"], r4["plain_ms"])
            g, th = t["g"], t["theta"]
            r = stats_timing(ck, "cavi_stats_batched", kappa, g, th, reps, lambda: (
                torch.bmm((kappa * th[..., None]).mT, kappa), torch.bmm(kappa.mT, g[..., None])))
            extra["cavi_stats_batched"][label] = r
            times["cavi_stats_batched"][label] = (r["ms"], r["plain_ms"])
            library["cavi_stats_batched"][label] = r["library_ms"]
            log(kappa_line(label, "kernel 4", r4))
            log(stats_line(label, "kernel 5", r) + " (library: torch.bmm x2)")
        del got, ref, ref64, s_got, s_ref, s64
    return {name: (worst[name], times[name], library[name], extra[name]) for name in worst}


def phase_pair_autograd(ck, device):
    """Kernel 4's gradients (its backward is the plain version's vjp)
    against the plain version's, w.r.t. every tensor argument, at B=300,
    M=129, two latents."""
    Xl, _ = big_logistic_data("cpu", n=300)
    t = pair_inputs(Xl, 300, 129, 2, device)
    names = ("X", "Z", "L_invT", "ls", "var", "mu", "Sigma")
    gen = torch.Generator(device=device).manual_seed(0)
    w = [torch.randn(s, generator=gen, device=device) for s in ((2, 300, 129), (2, 300), (2, 300))]
    grads = []
    for fn in (ck.fused_kappa_moments_batched, ck.fused_kappa_moments_batched_reference):
        inputs = [t[k].clone().requires_grad_(True) for k in names]
        out = fn(*inputs, 1e-3, "rbf")
        grads.append(torch.autograd.grad(sum(torch.sum(o * wi) for o, wi in zip(out, w)), inputs))
    errs = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1.0) for n, a, b in zip(names, *grads)}
    if not all(e <= KERNEL_TOL for e in errs.values()):
        raise AssertionError(f"kernel 4's gradients differ from the plain version's: {errs}")
    log("kernel 4 autograd vs plain (B=300, M=129, L=2): " + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))


# floor of logistic_m512_b65536's training accuracy after L_TRAIN_STEPS
# steps: the labels are a linear rule in 20-D, which 512 RBF inducing
# points fit to 0.9769 on an H100 (float32), where the flagship's 64 reach
# 0.8965 (the plain version on a CPU); chance is 0.5
MIN_BIG_ACC = 0.9
# floors of the M=512 oracles, as ORACLE_FLOORS was worked out: about three
# times the plain version's error on a CPU (float32, the same data, CPU
# draws: RMSE 0.0050 Gaussian, 0.0083 Student-t, 0.0052 Laplace, 0.0056
# Matern-3/2 noise; accuracy 0.9868; corr 0.9993 Poisson, 0.9995 negative
# binomial, held at 0.99), inside the reference's own floors (RMSE 0.25,
# 0.25, 0.3; accuracy 0.9; corr 0.8; none for the Gaussian)
PAIR_ORACLE_FLOORS = {
    "gaussian/SqExponentialKernel": ("rmse", 0.015),
    "studentt/SqExponentialKernel": ("rmse", 0.025),
    "laplace/SqExponentialKernel": ("rmse", 0.016),
    "matern32/SqExponentialKernel": ("rmse", 0.017),
    "bayesiansvm/SqExponentialKernel": ("acc", 0.96),
    "poisson/SqExponentialKernel": ("corr", 0.99),
    "negbinomial/SqExponentialKernel": ("corr", 0.99),
}
# the reference's floors of the batched multiclass and heteroscedastic
# oracles (tpu_acceptance.py:387, :411); the plain version on a CPU
# reaches accuracy 0.9966 and RMSE 0.3290 there (float32, CPU draws)
MIN_PAIR_MC_ACC, MAX_PAIR_HET_RMSE = 0.85, 0.4


def phase_big_logistic(agt, ck, device):
    """bench.py's logistic_m512_b65536 through agp_tpu_torch.train:
    L_TRAIN_STEPS steps with one launch of each kernel of the single-latent
    split pair (kernels 6-7), the training accuracy, then steady-state
    iterations/s over L_TIMED_STEPS steps.  Returns (launches, accuracy,
    it/s)."""
    from agp_tpu_torch.training.train import vi_steps

    X, y = big_logistic_data(device)
    model = big_logistic_model(agt, X)
    gen = torch.Generator(device=device).manual_seed(0)
    reset_launches(ck)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=L_TRAIN_STEPS, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = expect_launches(ck, "logistic_m512_b65536", route_launches(L_TRAIN_STEPS, "single"))
    if not (bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())):
        raise AssertionError("logistic_m512_b65536: non-finite posterior")
    acc = float((agt.predict_y(model, state, X) == y).float().mean())
    if not acc >= MIN_BIG_ACC:
        raise AssertionError(f"logistic_m512_b65536 training accuracy {acc:.4f} < {MIN_BIG_ACC}")
    t0 = time.perf_counter()
    model, state = vi_steps(model, state, X, y, L_TIMED_STEPS, generator=gen)
    torch.cuda.synchronize()
    ips = L_TIMED_STEPS / (time.perf_counter() - t0)
    log(f"logistic_m512_b65536 (N={LN}, D={LD}, M={PM}, B={LB}, slice): {L_TRAIN_STEPS} steps through "
        f"agp_tpu_torch.train in {train_s:.3f} s, {launches} launches, training accuracy {acc:.4f}; "
        f"steady state {ips:.2f} CAVI iterations/s over {L_TIMED_STEPS} steps")
    return launches, acc, ips


def phase_pair_multi(agt, ck, device, which):
    """The reference's batched multiclass or heteroscedastic oracle at
    M=512 through agp_tpu_torch.train, with one launch of each kernel of
    the pair a step, and its floor.  Returns (launches, metric)."""
    if which == "multiclass":
        X, y = pair_mc_data(device)
        steps = PAIR_MC_STEPS
    else:
        X, y, f = pair_het_data(device)
        steps = PAIR_HET_STEPS
    model = pair_multi_model(agt, X, which)
    reset_launches(ck)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=steps, generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = expect_launches(ck, f"{which} M={PM}", route_launches(steps, "batched"))
    if which == "multiclass":
        value = float((agt.predict_y(model, state, X[:4096]) == y[:4096]).float().mean())
        ok, what = value > MIN_PAIR_MC_ACC, f"accuracy {value:.4f} (floor {MIN_PAIR_MC_ACC})"
    else:
        value = float(torch.sqrt(torch.mean((agt.predict_f(model, state, X[:4096])[0] - f[:4096]) ** 2)))
        ok, what = value < MAX_PAIR_HET_RMSE, f"RMSE of f {value:.4f} (floor {MAX_PAIR_HET_RMSE})"
        what += f", lambda {float(model.likelihood.lam):.4f}"
    if not ok or not bool(torch.isfinite(state.mu).all()):
        raise AssertionError(f"{which} M={PM}: {what}")
    log(f"{which} M={PM} (N={ON}, B={model.inference.batchsize}, {steps} steps): {what}, {launches} launches, "
        f"{train_s:.3f} s")
    return launches, value


# batch of the pair's parity runs: each path's 20 steps run twice on the
# CPU, whose float32 [L, B, 512, 512] products took 54 s of a 120 s script
# at the paths' own B (8192-65,536) on an H100 host's 8 cores; at
# B=2048 the conditioning (Z, lengthscale, data) is the path's own and the
# kernels' own shapes are held in phase 12
PAIR_PARITY_B = 2048


def pair_parity_paths(agt, device):
    """(name, CPU data, model builder, slice batch) of each path of the
    pair, for card-vs-CPU parity, at B=PAIR_PARITY_B; logistic_m512_b65536
    on N=20,000 rows."""
    b = PAIR_PARITY_B
    Xl, yl = big_logistic_data("cpu", n=PN, seed=1)
    Xm, ym = pair_mc_data("cpu", seed=1)
    Xh, yh, _ = pair_het_data("cpu", seed=1)
    paths = [("logistic_m512", Xl, yl, lambda X: big_logistic_model(agt, X, b=b)),
             ("multiclass M=512", Xm, ym, lambda X: pair_multi_model(agt, X, "multiclass", b=b)),
             ("het M=512", Xh, yh, lambda X: pair_multi_model(agt, X, "het", b=b))]
    for lik in ORACLE_LIKS:
        Xo, yo, _ = oracle_data(lik, "cpu", seed=1)
        paths.append((f"oracle {lik} M=512", Xo, yo, lambda X, lik=lik: oracle_model(agt, X, lik, m=PM, b=b)))
    return [(name, X, y, build, b) for name, X, y, build in paths]


def phase_pair_parity(agt, ck, device):
    """20 steps of each path of the pair at B=PAIR_PARITY_B on the card
    (float32) against the same steps on the CPU (float32, the plain
    versions), same draws, each against its own float32 noise (the CPU run
    again with the inducing points in another order), as the oracle
    parity of kernel 1: the card
    within ORACLE_DEVICE_FACTOR times it of the CPU, and within it of the
    card with the plain versions in the kernels' place."""
    perm = torch.randperm(PM, generator=torch.Generator().manual_seed(2))
    for name, Xc, yc, build, b in pair_parity_paths(agt, device):
        t0 = time.perf_counter()
        draws = torch.randint(0, Xc.shape[0] - b + 1, (20,), generator=torch.Generator().manual_seed(1))
        Xd, yd = Xc.to(device), yc.to(device)
        cpu = after_20(agt, build(Xc), Xc, yc, draws)
        card = after_20(agt, build(Xd), Xd, yd, draws)
        with plain_kernels(ck, SPLIT_PAIRS):
            card_plain = after_20(agt, build(Xd), Xd, yd, draws)
        m = build(Xc)
        mu_p, lam_p = after_20(agt, m.replace(Z=m.Z[:, perm].contiguous()), Xc, yc, draws)
        noise = rel_err((mu_p[:, torch.argsort(perm)], lam_p), cpu)
        parity_check(name, rel_err(card, cpu), noise)
        parity_check(name + " kernels", rel_err(card, card_plain), noise, factor=1.0,
                     what="card vs the card with the plain versions")
        log(f"{name} parity: {time.perf_counter() - t0:.2f} s")


# ------------------------------------- the single-latent split pair (6-7)
def single_args(t):
    """Kernel 6's and 7's arguments from pair_inputs' one-latent tensors: X,
    Z [M, D], L^-T [M, M], ls [D], var [], g and theta [B]."""
    return {"X": t["X"], "Z": t["Z"][0].contiguous(), "L_invT": t["L_invT"][0].contiguous(), "ls": t["ls"][0],
            "var": t["var"][0], "g": t["g"][0].contiguous(), "theta": t["theta"][0].contiguous(), "kind": t["kind"]}


def call_k6(fn, s):
    return fn(s["X"], s["Z"], s["L_invT"], s["ls"], s["var"], 1e-3, s["kind"])


def single_cases(device):
    """(label, kernel 6's and 7's inputs, float64 check, timed) of each shape
    the single-latent split pair is held at: logistic_m512_b65536 (timed),
    path A's hyperparameter step at the flagship shape (B=4096, D=20,
    M=64, timed), the ill-conditioned M=512 oracle shape (timed, against
    the float64 plain version), ragged B=300, M=129, and each Matern kind
    at the ragged and the oracle shapes."""
    Xl, _ = big_logistic_data("cpu", n=LB)
    Xf, _ = flagship_data("cpu", n=B)
    Xo = oracle_data("studentt", "cpu")[0]
    cases = [("logistic_m512_b65536", pair_inputs(Xl, LB, PM, 1, device), False, True),
             ("flagship_m64_b4096", pair_inputs(Xf, B, M, 1, device), False, True),
             ("oracle_m512_b8192", pair_inputs(Xo, OB, PM, 1, device, ls=1.0), True, True),
             ("ragged_m129", pair_inputs(Xl, 300, 129, 1, device, seed=1), False, False)]
    cases += [(f"{k}_ragged_m129", pair_inputs(Xl, 300, 129, 1, device, kind=k), False, False) for k in MATERN_KINDS]
    cases += [(f"{k}_oracle_m512", pair_inputs(Xo, OB, PM, 1, device, kind=k, ls=1.0), True, False)
              for k in MATERN_KINDS]
    return [(label, single_args(t), f64, timed) for label, t, f64, timed in cases]


def phase_single_kernels_vs_plain(ck, device):
    """Kernels 6 and 7 against their plain versions at every case of
    single_cases (at the float64 cases with no KERNEL_TOL floor; S2
    exactly symmetric), then timed at the timed shapes beside their plain
    versions, kernel 6 beside kappa's product alone (torch.matmul,
    kappa_timing) and kernel 7 beside torch.matmul for the same two sums
    (stats_timing), none of which the port calls, with their device us; a
    second call of each bit-equal at every case.  Returns {kernel:
    (largest abs error, {shape: (ms, plain ms)}, {shape: library ms},
    {shape: kappa_timing's or stats_timing's dict})}."""
    worst = {"fused_kappa": 0.0, "cavi_stats": 0.0}
    extra = {"fused_kappa": {}, "cavi_stats": {}}
    times = {"fused_kappa": {}, "cavi_stats": {}}
    library = {"fused_kappa": {}, "cavi_stats": {}}
    for label, t, f64, timed in single_cases(device):
        got = call_k6(ck.fused_kappa, t)
        torch.cuda.synchronize()
        ref = call_k6(ck.fused_kappa_reference, t)
        ref64 = call_k6(ck.fused_kappa_reference, to_float64(t)) if f64 else None
        row = check_outputs(f"fused_kappa {label}", ("kappa", "Ktilde"), got, ref, ref64, floor=0.0)
        check_repeat(f"fused_kappa {label}", lambda: call_k6(ck.fused_kappa, t), got)
        worst["fused_kappa"] = max(worst["fused_kappa"], *row.values())
        kappa, g, th = ref[0].contiguous(), t["g"], t["theta"]
        s_got = ck.cavi_stats(kappa, g, th)
        torch.cuda.synchronize()
        check_stats_repeat(f"cavi_stats {label}", ck.cavi_stats, (kappa, g, th), s_got)
        s_ref = ck.cavi_stats_reference(kappa, g, th)
        s64 = ck.cavi_stats_reference(kappa.double(), g.double(), th.double()) if f64 else None
        row7 = check_outputs(f"cavi_stats {label}", ("s1", "S2"), s_got, s_ref, s64, floor=0.0)
        worst["cavi_stats"] = max(worst["cavi_stats"], *row7.values())
        B_, M_ = kappa.shape
        log(f"single pair vs plain {label} (B={B_}, D={t['X'].shape[1]}, M={M_}, {t['kind']}): max abs err "
            + " ".join(f"{k}={v:.2e}" for k, v in {**row, **row7}.items()))
        if timed:
            reps = 10 if B_ > 20000 else 30
            r6 = kappa_timing(ck, "fused_kappa", t, reps)
            extra["fused_kappa"][label] = r6
            times["fused_kappa"][label] = (r6["ms"], r6["plain_ms"])
            r = stats_timing(ck, "cavi_stats", kappa, g, th, reps,
                             lambda: ((kappa * th[:, None]).T @ kappa, kappa.T @ g))
            extra["cavi_stats"][label] = r
            times["cavi_stats"][label] = (r["ms"], r["plain_ms"])
            library["cavi_stats"][label] = r["library_ms"]
            log(kappa_line(label, "kernel 6", r6))
            log(stats_line(label, "kernel 7", r) + " (library: torch.matmul x2)")
        del got, ref, ref64, s_got, s_ref, s64
    return {name: (worst[name], times[name], library[name], extra[name]) for name in worst}


def phase_kappa_autograd(ck, device):
    """Kernel 6's gradients (its backward is the plain version's vjp)
    against the plain version's, w.r.t. X, Z, L^-T, the [D] lengthscales
    and the variance, at B=300, M=129."""
    Xl, _ = big_logistic_data("cpu", n=300)
    t = single_args(pair_inputs(Xl, 300, 129, 1, device))
    names = ("X", "Z", "L_invT", "ls", "var")
    gen = torch.Generator(device=device).manual_seed(0)
    w = [torch.randn(s, generator=gen, device=device) for s in ((300, 129), (300,))]
    grads = []
    for fn in (ck.fused_kappa, ck.fused_kappa_reference):
        inputs = [t[k].clone().requires_grad_(True) for k in names]
        out = fn(*inputs, 1e-3, "rbf")
        grads.append(torch.autograd.grad(sum(torch.sum(o * wi) for o, wi in zip(out, w)), inputs))
    errs = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1.0) for n, a, b in zip(names, *grads)}
    if not all(e <= KERNEL_TOL for e in errs.values()):
        raise AssertionError(f"kernel 6's gradients differ from the plain version's: {errs}")
    log("kernel 6 autograd vs plain (B=300, M=129): " + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))


# --------------------------------------------------- the hyperparameter step
def hyper_path(agt, X, which, b=None):
    """Path A (the flagship) or B (logistic_m512_b65536) with the
    reference's default optimiser, Adam(0.01) on the log kernel parameters
    every iteration (atfrequency 1); b cuts the batch (parity)."""
    if which == "A":
        return flagship_model(agt, X, b=b or B, optimiser="default")
    return big_logistic_model(agt, X, b=b or LB, optimiser="default")


def log_hypers(model):
    """The kernel's log lengthscale and log variance as float64 on the CPU."""
    k = model.kernel
    return torch.cat([torch.log(k.lengthscale).reshape(-1), torch.log(k.variance).reshape(-1)]).double().cpu()


def phase_hyper_path(agt, ck, device, which):
    """Path A or B through agp_tpu_torch.train: its first steps with the
    exact launches (path A: kernel 1 once a step and kernel 6 once a
    hyperparameter step; path B: kernels 6 and 7 once a step and kernel 6
    once more a hyperparameter step; no other kernel), the training
    accuracy floor, a finite posterior, log-hyperparameters finite and
    moved by more than MIN_HYPER_MOVE; then its steady rate, iterations
    (each with a hyperparameter step but the run's first three and its
    last) per second.  Returns (launches, accuracy, it/s)."""
    if which == "A":
        X, y = flagship_data(device)
        steps, timed, floor, route, name = MAIN_STEPS, A_TIMED_STEPS, MIN_FLAGSHIP_ACC, "fused", "path A (flagship)"
    else:
        X, y = big_logistic_data(device)
        steps, timed, floor, route, name = L_TRAIN_STEPS, B_TIMED_STEPS, MIN_BIG_ACC, "single", "path B (logistic_m512_b65536)"
    model = hyper_path(agt, X, which)
    log0 = log_hypers(model)
    gen = torch.Generator(device=device).manual_seed(0)
    reset_launches(ck)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=steps, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = expect_launches(ck, name, route_launches(steps, route, hyper_steps=steps - 3))
    logs = log_hypers(model)
    if not (bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())
            and bool(torch.isfinite(logs).all())):
        raise AssertionError(f"{name}: non-finite posterior or hyperparameters")
    moved = float((logs - log0).abs().max())
    if not moved > MIN_HYPER_MOVE:
        raise AssertionError(f"{name}: the log-hyperparameters moved by {moved:.3e} <= {MIN_HYPER_MOVE}")
    acc = float((agt.predict_y(model, state, X) == y).float().mean())
    if not acc >= floor:
        raise AssertionError(f"{name}: training accuracy {acc:.4f} < {floor}")
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=timed, state=state, generator=gen)
    torch.cuda.synchronize()
    ips = timed / (time.perf_counter() - t0)
    k = model.kernel
    log(f"{name}: {steps} iterations through agp_tpu_torch.train in {train_s:.3f} s, {launches} launches, "
        f"training accuracy {acc:.4f}, log-hyperparameters moved by {moved:.4f} (lengthscale "
        f"{float(k.lengthscale.reshape(-1)[0]):.4f}, variance {float(k.variance.reshape(-1)[0]):.4f}); steady state "
        f"{ips:.2f} iterations/s over {timed} iterations ({timed - 3} hyperparameter steps)")
    return launches, acc, ips


def phase_hyper_parity(agt, ck, device):
    """20 iterations of paths A and B (B at B=PAIR_PARITY_B on N=20,000
    rows) on the card (float32) against the same iterations on the CPU
    (float32, the plain versions), same draws, as max |d mu| / max |mu|
    and max |d log-hyperparameter|, each against its own float32 noise
    (the CPU run again with the inducing points in another order): the
    card within ORACLE_DEVICE_FACTOR times it of the CPU, and within it of
    the card with the plain versions in the kernels' place."""
    def after(model, X, y, draws):
        model, state = agt.train(model, X, y, iterations=20, draws=draws.to(X.device))
        return state.mu.double().cpu(), log_hypers(model)

    def err(a, b, perm=None):
        mu = a[0] if perm is None else a[0][:, torch.argsort(perm)]
        return max(float((mu - b[0]).abs().max() / b[0].abs().max()), float((a[1] - b[1]).abs().max()))

    for which in ("A", "B"):
        t0 = time.perf_counter()
        if which == "A":
            Xc, yc = flagship_data("cpu", n=PN, seed=1)
            draws = torch.randint(0, PN // 64, (20, B // 64), generator=torch.Generator().manual_seed(1))
            b, m = B, M
        else:
            Xc, yc = big_logistic_data("cpu", n=PN, seed=1)
            b, m = PAIR_PARITY_B, PM
            draws = torch.randint(0, PN - b + 1, (20,), generator=torch.Generator().manual_seed(1))
        perm = torch.randperm(m, generator=torch.Generator().manual_seed(2))
        Xd, yd = Xc.to(device), yc.to(device)
        cpu = after(hyper_path(agt, Xc, which, b), Xc, yc, draws)
        card = after(hyper_path(agt, Xd, which, b), Xd, yd, draws)
        with plain_kernels(ck, ("fused_cavi_stats",) + SPLIT_PAIRS):
            card_plain = after(hyper_path(agt, Xd, which, b), Xd, yd, draws)
        mp = hyper_path(agt, Xc, which, b)
        noise = err(after(mp.replace(Z=mp.Z[:, perm].contiguous()), Xc, yc, draws), cpu, perm)
        what = f"(B={b}, M={m}, 20 iterations, 17 hyperparameter steps) card (float32) vs CPU (float32)"
        parity_check(f"path {which}", err(card, cpu), noise, what=what)
        parity_check(f"path {which} kernels", err(card, card_plain), noise, factor=1.0,
                     what="card vs the card with the plain versions")
        log(f"path {which} parity: {time.perf_counter() - t0:.2f} s")


def profile_hyper_path(agt, device, which):
    """torch.profiler over 20 iterations of path A or B (after 30), each a
    CAVI step and a hyperparameter step on its minibatch
    (``python3 chip_smoke.py profile hyper A|B``): wall and device-busy
    time an iteration, the idle share, launches an iteration, the peak
    device memory, the largest kernels and the host operations that take
    the most CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from agp_tpu_torch.inference import analytic_vi
    from agp_tpu_torch.training import autotuning
    from agp_tpu_torch.training.train import _minibatches

    X, y = flagship_data(device) if which == "A" else big_logistic_data(device)
    model = hyper_path(agt, X, which)
    gen = torch.Generator(device=device).manual_seed(0)
    model, state = agt.train(model, X, y, iterations=30, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 20

    def iterations(model, state):
        for x_b, y_b in _minibatches(model, X, y, n, generator=gen):
            model, state = analytic_vi.variational_update(model, state, x_b, y_b)
            model, state = autotuning.hyper_step(model, state, x_b, y_b)
        return model, state

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, state = iterations(model, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / n * 1e6
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / n, e.count / n, e.key) for e in events
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")) / n
    log(f"profile hyper (path {which}, CAVI + hyperparameter step): wall {wall_us:.1f} us/iteration, device busy "
        f"{busy:.1f} us/iteration, idle share {1 - busy / wall_us:.4f}, {launches:.1f} kernel launches/iteration, "
        f"{sum(r[1] for r in rows):.1f} device ops/iteration, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for us, count, key in rows[:10]:
        log(f"  device {us:10.1f} us/iteration  x{count:.1f}  {key[:90]}")
    host = sorted(((e.self_cpu_time_total / n, e.count / n, e.key) for e in events
                   if not str(e.device_type).endswith("CUDA")), reverse=True)
    for us, count, key in host[:12]:
        log(f"  host {us:10.1f} us/iteration  x{count:.1f}  {key[:90]}")


def profile_window(fn, n):
    """torch.profiler over one call of ``fn``, which runs n steps: wall and
    device-busy us a step, the idle share, kernel launches and device ops a
    step, and the device kernels' (us a step, calls a step, name) rows."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / n * 1e6
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / n, e.count / n, e.key) for e in events
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")) / n
    return {"wall_us": wall_us, "busy_us": busy, "idle_share": 1 - busy / wall_us, "launches": launches,
            "ops": sum(r[1] for r in rows), "rows": rows}


def log_profile(label, p, top):
    """Logs a profile_window result and its ``top`` device kernels."""
    log(f"{label}: wall {p['wall_us']:.1f} us/step, device busy {p['busy_us']:.1f} us/step, idle share "
        f"{p['idle_share']:.4f}, {p['launches']:.1f} kernel launches/step, {p['ops']:.1f} device ops/step")
    for us, count, key in p["rows"][:top]:
        log(f"  {us:10.1f} us/step  x{count:.1f}  {key[:100]}")


def profile_pair_path(agt, device, which):
    """torch.profiler over 20 steady-state steps (after 30) of
    logistic_m512_b65536, the M=512 multiclass path, the bench's
    multiclass (K=10) and heteroscedastic paths at M=64 or path 21 (the
    SVGP with a learnt noise) (``python3 chip_smoke.py profile
    logistic|multiclass|multiclass_k10|het|noise``): wall
    and device-busy time per step, the device's idle share, kernel
    launches per step and the device time of the largest kernels."""
    from agp_tpu_torch.training.train import vi_steps

    if which == "logistic":
        X, y = big_logistic_data(device)
        model = big_logistic_model(agt, X)
    elif which == "multiclass":
        X, y = pair_mc_data(device)
        model = pair_multi_model(agt, X, "multiclass")
    elif which == "noise":
        X, _, y = noise_data(device)
        model = noise_model(agt, X)
    else:  # the bench's multi-latent paths (phases 7-8)
        path = "multiclass" if which == "multiclass_k10" else "het"
        X, y = (mc_data if path == "multiclass" else het_data)(device)
        model = multi_model(agt, X, path)
    y_t, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    y_t = y_t.to(X.dtype)
    state = agt.init_state(model, X, y_t)
    gen = torch.Generator(device=device).manual_seed(0)
    model, state = vi_steps(model, state, X, y_t, 30, generator=gen)
    p = profile_window(lambda: vi_steps(model, state, X, y_t, 20, generator=gen), 20)
    log_profile(f"profile {which}", p, 20)
    return p


def profile_bench_kernels(device, n=20):
    """torch.profiler over n calls of each candidate of the bench's variants
    mode at each of its shapes, and of kernel 10 and index_select at the
    flagship's draw (``python3 chip_smoke.py profile kernels``): device us
    a call, in all and by the kernels each call launches."""
    from torch.profiler import ProfilerActivity, profile

    from agp_tpu_torch import bench
    from agp_tpu_torch.benchmarks import gather_modes as gm

    cases = []
    for b, d, m in bench.VARIANT_SHAPES:
        calls = bench.variant_calls(bench.sweep_inputs(b, d, m, device))
        cases += [(f"{name} B={b} D={d} M={m}", fn) for name, fn in calls.items()]
    X, _ = flagship_data(device)
    for tr in (32, 64):
        tidx = torch.randint(0, N // tr, (B // tr,), device=device,
                             generator=torch.Generator(device=device).manual_seed(0))
        view = X[: N // tr * tr].reshape(N // tr, tr, D)
        cases.append((f"gather_row_tiles B={B} D={D} tr={tr}",
                       lambda tidx=tidx, tr=tr: gm.gather_row_tiles(X, tidx, tile_rows=tr)))
        cases.append((f"index_select B={B} D={D} tr={tr}", lambda view=view, tidx=tidx: view.index_select(0, tidx)))
    for label, fn in cases:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.self_device_time_total / n, e.count / n, e.key) for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0), reverse=True)
        log(f"profile {label}: device {sum(r[0] for r in rows):.2f} us a call; "
            + "; ".join(f"{key[:70]} {us:.2f} us x{count:.0f}" for us, count, key in rows[:5]))


def stats_mode(agt, ck, device):
    """``python3 chip_smoke.py stats`` (``ab ROOT stats`` for an earlier
    tree): kernels 5 and 7 at phase 12's timed shapes by CUDA events and
    device us beside torch.bmm / torch.matmul (stats_timing),
    logistic_m512_b65536's steady it/s (phase 13's run) and ``profile
    logistic``; last a JSON line of them."""
    tree = os.path.relpath(os.path.dirname(agt.__file__))
    log(f"stats: agp_tpu_torch from {tree}")
    out = {"tree": tree, "cavi_stats_batched": {}, "cavi_stats": {}}
    for label, t, _, timed in pair_cases(device):
        if timed:
            kappa = call_k4(ck.fused_kappa_moments_batched_reference, t)[0].contiguous()
            g, th = t["g"], t["theta"]
            r = stats_timing(ck, "cavi_stats_batched", kappa, g, th, 10 if kappa.shape[1] > 20000 else 30, lambda: (
                torch.bmm((kappa * th[..., None]).mT, kappa), torch.bmm(kappa.mT, g[..., None])))
            out["cavi_stats_batched"][label] = r
            log(stats_line(label, "kernel 5", r))
    for label, t, _, timed in single_cases(device):
        if timed:
            kappa, g, th = call_k6(ck.fused_kappa_reference, t)[0].contiguous(), t["g"], t["theta"]
            r = stats_timing(ck, "cavi_stats", kappa, g, th, 10 if kappa.shape[0] > 20000 else 30,
                             lambda: ((kappa * th[:, None]).T @ kappa, kappa.T @ g))
            out["cavi_stats"][label] = r
            log(stats_line(label, "kernel 7", r))
    del kappa, g, th, t
    torch.cuda.empty_cache()
    out["logistic_m512_b65536_ips"] = phase_big_logistic(agt, ck, device)[2]
    out["profile_logistic"] = profile_pair_path(agt, device, "logistic")
    print(json.dumps(out))


def kappa_mode(agt, ck, device):
    """``python3 chip_smoke.py kappa`` (``ab ROOT kappa`` for an earlier
    tree): kernels 6 and 4 at phase 12's timed shapes by CUDA events and
    device us beside their products alone (kappa_timing), the steady it/s
    of logistic_m512_b65536 (phase 13's run) and of path B (phase 15's),
    ``profile logistic`` and ``profile multiclass``; last a JSON line of
    them."""
    tree = os.path.relpath(os.path.dirname(agt.__file__))
    log(f"kappa: agp_tpu_torch from {tree}")
    out = {"tree": tree, "fused_kappa": {}, "fused_kappa_moments_batched": {}}
    for name, label_of, cases in (("fused_kappa", "kernel 6", single_cases), ("fused_kappa_moments_batched",
                                                                             "kernel 4", pair_cases)):
        for label, t, _, timed in cases(device):
            if timed:
                reps = 10 if t["X"].shape[0] > 20000 else 30
                out[name][label] = kappa_timing(ck, name, t, reps)
                log(kappa_line(label, label_of, out[name][label]))
        del t
        torch.cuda.empty_cache()
    out["logistic_m512_b65536_ips"] = phase_big_logistic(agt, ck, device)[2]
    out["path_b_ips"] = phase_hyper_path(agt, ck, device, "B")[2]
    out["profile_logistic"] = profile_pair_path(agt, device, "logistic")
    out["profile_multiclass"] = profile_pair_path(agt, device, "multiclass")
    print(json.dumps(out))


def variants_mode(agt, device):
    """``python3 chip_smoke.py variants`` (``ab ROOT variants`` for an
    earlier tree): kernels 8 ("nt", "packed") and 9 at each shape of
    VARIANT_TIMED by CUDA events beside the sweep's bar (at the flagship's
    host-bound shape the median of three turns round the kernels, and the
    host us a call over 1000 calls), then (the profiler after every
    timing) their device us; a shape the tree's kernels refuse reads "out
    of range".  Where the tree has kernels 8-9's row tiles
    (fused_variants._VARIANT_TILES), each form at the sweep's M=128 and
    M=512 rows with every tile whose shared memory fits, through the
    wrapper's launch with that tile (no launch counted).  Last a JSON line
    of them."""
    from agp_tpu_torch import bench
    from agp_tpu_torch.benchmarks import fused_variants as fv

    tree = os.path.relpath(os.path.dirname(agt.__file__))
    log(f"variants: agp_tpu_torch from {tree}")
    out = {"tree": tree, "ms": {}, "device_us": {}, "bar_ms": {}, "host_us": {}}
    kernels = timed_variant_kernels(fv)
    for profile in (False, True):
        for b, d, m in VARIANT_TIMED:
            key, reps = shape_key(b, d, m), 200 if b <= B else BIG_VARIANT_REPS
            t = bench.sweep_inputs(b, d, m, device)
            if not profile:
                out["bar_ms"][key] = cuda_ms(bench.variant_calls(t)["xla_stats_reference"], reps)
            fns = {f"{key} {label}": lambda kern=kern, kw=kw: sweep_call(kern, t, **kw)
                   for label, (kern, _, kw) in kernels.items()}
            for name, fn in fns.items():
                if profile and not isinstance(out["ms"][name], str):
                    out["device_us"][name] = device_us(fn)[0]
                elif not profile:
                    try:
                        fn()
                        out["ms"][name] = cuda_ms(fn, reps)
                    except ValueError as e:
                        out["ms"][name] = f"out of range: {e}"
            if not profile and b <= B:  # host-bound: two more turns round the kernels, the median
                ok = [n for n in fns if not isinstance(out["ms"][n], str)]
                turns = {n: [out["ms"][n]] for n in ok}
                for _ in range(2):
                    for n in ok:
                        turns[n].append(cuda_ms(fns[n], reps))
                for n in ok:
                    out["ms"][n] = sorted(turns[n])[1]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(1000):
                        fns[n]()
                    out["host_us"][n] = (time.perf_counter() - t0) * 1e3
                    torch.cuda.synchronize()
            if not profile:
                log(f"variants at {key}: bar {out['bar_ms'][key]:.4f} ms; " + "; ".join(
                    f"{k.split(' ')[1]} {v if isinstance(v, str) else f'{v:.4f} ms'}" for k, v in out["ms"].items()
                    if k.startswith(key + " ")))
            del t
    log("variants, device us: " + "; ".join(f"{k} {v:.1f}" for k, v in out["device_us"].items()))
    log("variants, host us a call: " + "; ".join(f"{k} {v:.1f}" for k, v in out["host_us"].items()))
    if hasattr(fv, "_VARIANT_TILES"):
        out["tiles"] = {}
        names = {"direct": "direct_stats", "packed": "direct_stats", "two_factor": "two_factor_nt"}
        limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
        for b, d, m in ((262_144, 8, 128), (65_536, 8, 512)):
            t = bench.sweep_inputs(b, d, m, device)
            for form in fv._FORMS:
                for tile in fv._VARIANT_TILES:
                    if fv.variant_smem_bytes(m, tile) > limit:
                        continue
                    key = f"{shape_key(b, d, m)} {form} {tile[0]}x{tile[1]}"
                    out["tiles"][key] = cuda_ms(lambda: fv._variant_launch(names[form], form, *bench.sweep_args(t),
                                                                           tile=tile), BIG_VARIANT_REPS)
                    log(f"  tile {key}: {out['tiles'][key]:.4f} ms"
                        + (" (variant_tile's choice)" if tile == fv.variant_tile(m) else ""))
            del t
    print(json.dumps(out))


def fused_mode(agt, ck, device):
    """``python3 chip_smoke.py fused`` (``ab ROOT fused`` for an earlier
    tree): kernel 1 at the flagship, the oracle paths' shape (Student-t, as
    phase 3 times it) and the sweep's row, on the sweep's inputs there
    (agp_tpu_torch.bench.sweep_inputs), by CUDA events (the median of three
    runs of 200 calls, 10 at the sweep's row) beside the sweep's bar
    (xla_stats_reference) at the flagship and the sweep's row, with the host
    us a call at the host-bound flagship and oracle shapes (the median of
    three runs of 1000 calls); then (the profiler after every timing) the
    device us of each, by kernel.  Last a JSON line of them."""
    from agp_tpu_torch import bench

    tree = os.path.relpath(os.path.dirname(agt.__file__))
    log(f"fused: agp_tpu_torch from {tree}")
    out = {"tree": tree, "ms": {}, "host_us": {}, "bar_ms": {}, "device_us": {}, "device_us_by_kernel": {},
           "bar_device_us": {}}
    cases = {}
    for name, (b, d, m) in {"flagship": (B, D, M), "oracle": (OB, 2, OM), "sweep": VARIANT_MAIN}.items():
        if name == "oracle":
            t = branch_inputs(agt, b, m, device, "studentt", "rbf", at="oracle")
            calls = {"fused_cavi_stats": lambda t=t: call_branch(ck.fused_cavi_stats, t)}
        else:
            calls = bench.variant_calls(bench.sweep_inputs(b, d, m, device))
        fn, reps = calls["fused_cavi_stats"], 200 if b <= OB else BIG_VARIANT_REPS
        cases[name] = (fn, calls.get("xla_stats_reference"))
        out["ms"][name] = sorted(cuda_ms(fn, reps) for _ in range(3))[1]
        if b <= OB:
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(1000):
                    fn()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            out["host_us"][name] = sorted(runs)[1]
        if cases[name][1] is not None:
            out["bar_ms"][name] = cuda_ms(cases[name][1], reps)
        log(f"fused {name} B={b} D={d} M={m}: kernel 1 {out['ms'][name]:.4f} ms"
            + (f", host {out['host_us'][name]:.1f} us a call" if name in out["host_us"] else "")
            + (f"; bar {out['bar_ms'][name]:.4f} ms" if name in out["bar_ms"] else ""))
    for name, (fn, bar) in cases.items():
        out["device_us"][name], out["device_us_by_kernel"][name] = device_us(fn)
        if bar is not None:
            out["bar_device_us"][name] = device_us(bar)[0]
        log(f"fused {name}, device us: kernel 1 {out['device_us'][name]:.2f} (" + ", ".join(
            f"{k} {v:.2f}" for k, v in out["device_us_by_kernel"][name].items()) + ")"
            + (f"; bar {out['bar_device_us'][name]:.2f}" if bar is not None else ""))
    print(json.dumps(out))


def paths_mode(agt, ck, device):
    """``python3 chip_smoke.py paths`` (``ab ROOT paths`` for an earlier
    tree): the host-bound paths that take kernel 1, as phases 4, 5, 10 and
    15 run them, in one process: the flagship's steady rate, Student-t's
    (here not first in its process), the ten oracle paths at M=128 (150
    steps of train each, set-up included) and path A's steady rate; then,
    in a tree that has them, phases 19-21's paths."""
    log(f"paths: agp_tpu_torch from {os.path.relpath(os.path.dirname(agt.__file__))}")
    phase_main_path(agt, ck, device)
    phase_studentt_rate(agt, ck, device)
    phase_oracles(agt, ck, device)
    phase_hyper_path(agt, ck, device, "A")
    if hasattr(agt, "GP"):  # the dense paths and path 21, from Slice E on
        for which in DENSE_PATHS:
            phase_dense(agt, ck, device, which)
        phase_noise(agt, ck, device)


def multi_mode(agt, ck, device):
    """``python3 chip_smoke.py multi`` (``ab ROOT multi`` for an earlier
    tree): kernels 2-3 at the bench's paths' shapes and at the oracle
    shapes (multi_oracle_inputs), rbf, by CUDA events (the median of three
    runs of 200 calls) with the host us a call (the median of three runs
    of 1000 calls), beside their products alone (multi_products); then
    (the profiler after every timing) the device us of each, by kernel;
    then the multiclass and heteroscedastic paths' steady rates (phases
    7-8) and their profiles (profile_pair_path).  Last a JSON line of
    them."""
    tree = os.path.relpath(os.path.dirname(agt.__file__))
    log(f"multi: agp_tpu_torch from {tree}")
    out = {"tree": tree, "ms": {}, "host_us": {}, "products_ms": {}, "device_us": {}, "device_us_by_kernel": {},
           "products_device_us": {}, "ips": {}, "profile": {}}
    cases = {}
    for name, (which, n_latent, call_fn, _) in MULTI_KERNELS.items():
        for at, t in (("bench", multi_inputs(MB, MM, n_latent, device)), ("oracle", multi_oracle_inputs(which, device))):
            key = f"{name} {at} B={t['X'].shape[0]} D={t['X'].shape[1]} M={t['Z'].shape[1]} L={t['Z'].shape[0]}"
            cases[key] = (lambda t=t, fn=getattr(ck, name), c=call_fn: c(fn, t), multi_products(ck, t))
    for key, (fn, products) in cases.items():
        out["ms"][key] = sorted(cuda_ms(fn) for _ in range(3))[1]
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        out["host_us"][key] = sorted(runs)[1]
        out["products_ms"][key] = cuda_ms(products)
        log(f"multi {key}: kernel {out['ms'][key]:.4f} ms, host {out['host_us'][key]:.1f} us a call; the products "
            f"alone (torch.bmm x3) {out['products_ms'][key]:.4f} ms")
    for key, (fn, products) in cases.items():
        out["device_us"][key], out["device_us_by_kernel"][key] = device_us(fn)
        out["products_device_us"][key] = device_us(products)[0]
        log(f"multi {key}, device us: kernel {out['device_us'][key]:.2f} (" + ", ".join(
            f"{k} {v:.2f}" for k, v in out["device_us_by_kernel"][key].items())
            + f"); products {out['products_device_us'][key]:.2f}")
    for which, profiled in (("multiclass", "multiclass_k10"), ("het", "het")):
        out["ips"][which] = phase_multi_path(agt, ck, device, which)[2]
        out["profile"][which] = profile_pair_path(agt, device, profiled)
    print(json.dumps(out))


def bits_mode(agt, ck, device, path):
    """``python3 chip_smoke.py bits FILE`` (``ab ROOT bits FILE`` for an
    earlier tree): a SHA-256 of each output of the kernels whose device
    code the shared headers carry, on inputs made from seeds: kernel 1 at
    the flagship and at the oracle shape on each likelihood branch (rbf)
    and each Matern kind (Student-t); kernels 4-5 at each case of
    pair_cases, 6-7 at each of single_cases; kernels 8-9, each variant, at
    the sweep's main row and B=300, M=129.  Written to FILE (JSON) when it
    does not exist; else every output must be bit-equal to FILE's (the
    same digest), or the mode fails."""
    import hashlib

    from agp_tpu_torch import bench
    from agp_tpu_torch.benchmarks import fused_variants as fv

    digests = {}

    def keep(key, outs):
        torch.cuda.synchronize()
        digests[key] = [hashlib.sha256(o.contiguous().cpu().numpy().tobytes()).hexdigest() for o in outs]
        return outs

    keep("fused_cavi_stats flagship", call(ck.fused_cavi_stats, kernel_inputs(B, M, device)))
    for lik, kind in [(lik, "rbf") for lik in ck.LIKS] + [("studentt", k) for k in ck.KINDS[1:]]:
        t = branch_inputs(agt, OB, OM, device, lik, kind, at="oracle")
        keep(f"fused_cavi_stats {lik}/{kind} oracle", call_branch(ck.fused_cavi_stats, t))
    for label, t, _, _ in pair_cases(device):
        kappa = keep(f"fused_kappa_moments_batched {label}", call_k4(ck.fused_kappa_moments_batched, t))[0]
        keep(f"cavi_stats_batched {label}", ck.cavi_stats_batched(kappa, t["g"], t["theta"]))
    for label, a, _, _ in single_cases(device):
        kappa = keep(f"fused_kappa {label}", call_k6(ck.fused_kappa, a))[0]
        keep(f"cavi_stats {label}", ck.cavi_stats(kappa, a["g"], a["theta"]))
    for b, d, m in (VARIANT_MAIN, (300, 8, 129)):
        t = bench.sweep_inputs(b, d, m, device)
        for label, (fn, _, kw) in variant_kernels(fv).items():
            keep(f"{label} {shape_key(b, d, m)}", sweep_call(fn, t, **kw))
    if not os.path.exists(path):
        with open(path, "w") as f:
            json.dump(digests, f)
        log(f"bits: {len(digests)} calls' digests written to {path}")
        return
    with open(path) as f:
        before = json.load(f)
    differ = [k for k in digests if digests[k] != before.get(k)]
    if differ or set(before) != set(digests):
        raise AssertionError(f"bits: outputs differ from {path} at {differ} (calls {len(digests)} / {len(before)})")
    log(f"bits: all {len(digests)} calls' outputs bit-equal to {path}")


def probe_mode(ck, which="all"):
    """``python3 chip_smoke.py probe [cols]``: builds the measurement
    programs of agp_tpu_torch/csrc/probes/ with nvcc for sm_90a into the
    build directory and runs them on the card: dmma_shapes.cu once for each
    FP64 mma.sync shape (m16n8k4, k8, k16, and m8n8k4 in pairs: whether
    ptxas takes it, its fragment layout, its rate) and kappa_cols.cu (the column-blocked form's
    gram and tiles); with ``all`` also kappa_tc.cu (kernel 6's gram and
    product apart at logistic_m512_b65536's shape, kernels 4 and 6 at
    other tile shapes, the mma.sync rate with and without 3xTF32's
    splits).  A program that does not build or run is logged, and the mode
    fails after the others ran."""
    out_dir = ck._BUILD_ROOT / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    probes = [(f"dmma_shapes_k{k}", "dmma_shapes.cu", [f"-DDMMA_K={k}"]) for k in (4, 8, 16)]
    probes.append(("dmma_shapes_m8n8k4", "dmma_shapes.cu", ["-DDMMA_K=4", "-DDMMA_PAIR"]))
    probes.append(("kappa_cols", "kappa_cols.cu", []))
    if which == "all":
        probes.append(("kappa_tc", "kappa_tc.cu", []))
    failed = []
    for name, src, flags in probes:
        exe = out_dir / name
        build = subprocess.run([ck._nvcc(), *ck._ARCH, "-std=c++17", "-O3", *flags, "-o", str(exe),
                                str(ck._PKG / "csrc" / "probes" / src)], capture_output=True, text=True)
        if build.returncode != 0:
            failed.append(name)
            log(f"probe {name}: nvcc failed ({build.returncode}):\n{build.stdout}{build.stderr}")
            continue
        run = subprocess.run([str(exe)], capture_output=True, text=True, timeout=600)
        log(f"probe {name} (exit {run.returncode}):\n{run.stdout}{run.stderr}")
        if run.returncode != 0:
            failed.append(name)
    if failed:
        raise AssertionError(f"probes failed: {failed}")


MOVED_CALLS = 200


def time_moved_paths(agt, device):
    """Wall time per call, on the host clock around MOVED_CALLS calls after
    20 and a torch.cuda.synchronize(), of the two calls that take the
    batched pair at shapes within fused_fits: a row-weighted CAVI step
    (``variational_update`` with w of ones, never fused) and ``elbo`` on
    its batch, at the flagship (L=1) and at the bench.py multiclass (L=10)
    and heteroscedastic (L=2) shapes (``python3 chip_smoke.py
    moved-paths``; ``ab ROOT moved-paths`` for an earlier tree)."""
    from agp_tpu_torch.inference import analytic_vi

    log(f"moved paths: agp_tpu_torch from {os.path.relpath(os.path.dirname(agt.__file__))}")
    X, y = flagship_data(device)
    cases = [("flagship", flagship_model(agt, X), X, y, B)]
    for which, data in (("multiclass", mc_data), ("het", het_data)):
        Xm, ym = data(device)
        cases.append((which, multi_model(agt, Xm, which), Xm, ym, MB))
    for name, model, X, y, b in cases:
        y_t, lik = model.likelihood.treat_labels(y)
        model = model.replace(likelihood=lik)
        y_t = y_t.to(X.dtype)
        state = agt.init_state(model, X, y_t)
        xb, yb = X[:b].contiguous(), y_t[:b].contiguous()
        w = torch.ones(b, dtype=X.dtype, device=device)
        step_us = elbo_us = 0.0
        for n in (20, MOVED_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                model, state = analytic_vi.variational_update(model, state, xb, yb, w=w)
            torch.cuda.synchronize()
            step_us = (time.perf_counter() - t0) / n * 1e6
            t0 = time.perf_counter()
            for _ in range(n):
                value = agt.elbo(model, state, xb, yb)
            torch.cuda.synchronize()
            elbo_us = (time.perf_counter() - t0) / n * 1e6
        if not (bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(value))):
            raise AssertionError(f"moved paths {name}: non-finite state or ELBO")
        log(f"moved paths {name} (B={b}, M={model.n_inducing}, L={model.n_latent}): row-weighted step "
            f"{step_us:.1f} us, elbo {elbo_us:.1f} us per call over {MOVED_CALLS} calls (ELBO {float(value):.6g})")


# ------------------------------------------ the bench's kernels (8-10)
# shapes (B, D, M) at which kernels 8-9 are held against their plain
# versions: the flagship's statistics, a ragged B with M=128, the sweep's
# four rows (benchmarks/fused_variants.py:286: the 64-row tile, two output
# tiles at M=512), and a ragged B at M=129 (past the narrow tile, M % 4 = 1:
# 4-byte copies) and M=520 (two output tiles, the last ragged)
VARIANT_CASES = ((B, D, M), (300, D, 128), (262_144, 8, 128), (8192, 8, 512), (65_536, 8, 256), (65_536, 8, 512),
                 (300, 8, 129), (300, 8, 520))
# the shapes at which kernels 8-9 are timed: the flagship's statistics and
# the sweep's four rows; the kernels line's main shape is the sweep's
# B=262,144 row, where the bar is timed at its largest
VARIANT_TIMED = ((B, D, M), (8192, 8, 512), (65_536, 8, 256), (65_536, 8, 512), (262_144, 8, 128))
VARIANT_MAIN = (262_144, 8, 128)
# the bench's variants and gather modes as phases 16-17 drive them: timed
# calls of each candidate (a tenth at B=262,144) and draws of each arm
VARIANT_REPS, GATHER_DRAWS = 20, 500
# calls timed at the sweep's rows (B >= 8192)
BIG_VARIANT_REPS = 10
# the bench's primary line at a cut step count (phase 18)
BENCH_ITERS, BENCH_CHUNK = 1000, 500
STATS_NAMES = ("s1", "S2", "c", "theta", "mf", "vf")


def shape_key(b, d, m):
    return f"B{b}_D{d}_M{m}"


def variant_kernels(fv):
    """{label: (kernel, plain version, keywords)} of kernel 8 (each variant)
    and kernel 9."""
    out = {f"direct_stats/{v}": (fv.direct_stats, fv.direct_stats_reference, {"variant": v}) for v in fv.VARIANTS}
    out["two_factor_nt"] = (fv.two_factor_nt, fv.two_factor_nt_reference, {})
    return out


def timed_variant_kernels(fv):
    """variant_kernels without "transpose", the same form as "nt"."""
    return {k: v for k, v in variant_kernels(fv).items() if k != "direct_stats/transpose"}


def sweep_call(fn, t, **kw):
    """fn on the sweep's inputs t (agp_tpu_torch.bench.sweep_inputs)."""
    from agp_tpu_torch import bench

    return fn(*bench.sweep_args(t), **kw)


def ill_conditioned_inputs(agt, device, m=OM, seed=0):
    """Card tensors of kernels 1, 8 and 9 at the oracle paths' shape
    (B=8192, D=2, M=m: 128, or the M=512 paths', lengthscale 1, Z on the
    batch's rows, L^-T from the float32 Cholesky with jitter 1e-3, as phase
    3 takes it), with a random mu and Sigma = 0, so that vf is Ktilde
    itself."""
    from agp_tpu_torch.ops import linalg

    X, y, _ = oracle_data("logistic", "cpu")
    rng = np.random.default_rng(seed)
    t = {"X": X[:OB], "y": y[:OB], "Z": X[:m], "mu": torch.as_tensor(rng.normal(size=m), dtype=torch.float32),
         "Sigma": torch.zeros((m, m))}
    t = {k: v.to(device).contiguous() for k, v in t.items()}
    L = linalg.safe_cholesky(agt.SqExponentialKernel().gram(t["Z"]), 1e-3)
    eye = torch.eye(m, device=device, dtype=L.dtype)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).T.contiguous()
    return t


def ill_call(fn, t, **kw):
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], 1.0, 1.0, 1e-3, ON / OB, **kw)


def ill_conditioned_variants(agt, ck, device):
    """Kernels 8 (each variant) and 9 at the ill-conditioned oracle shapes
    (M=128 and M=512), and kernel 1 at M=128, against the float64 plain
    version, within FLOAT32_FACTOR times the float32 plain version's own
    error with no floor; each a second call bit-equal.  Returns {label
    M=m: {output: (kernel, float32 plain) error against float64}} for
    Ktilde (vf, with Sigma = 0), S2 and mf, each logged."""
    from agp_tpu_torch.benchmarks import fused_variants as fv

    ill = {}
    for m in (OM, PM):
        t = ill_conditioned_inputs(agt, device, m)
        t64 = to_float64(t)
        cases = [(label, fn, plain, kw) for label, (fn, plain, kw) in variant_kernels(fv).items()]
        if m == OM:
            cases.insert(0, ("fused_cavi_stats", ck.fused_cavi_stats, ck.fused_cavi_stats_reference,
                             {"kind": "rbf", "lik": "logistic"}))
        for label, fn, plain, kw in cases:
            got = ill_call(fn, t, **kw)
            torch.cuda.synchronize()
            ref, ref64 = ill_call(plain, t, **kw), ill_call(plain, t64, **kw)
            check_outputs(f"{label} at B={OB}, D=2, M={m}, Sigma = 0", STATS_NAMES, got, ref, ref64, floor=0.0)
            check_repeat(f"{label} at B={OB}, D=2, M={m}", lambda: ill_call(fn, t, **kw), got)

            def against64(i):
                scale = max(float(ref64[i].abs().max()), 1.0)
                return tuple(float((o[i].double() - ref64[i]).abs().max()) / scale for o in (got, ref))

            key = f"{label} M={m}"
            ill[key] = {"Ktilde": against64(5), "S2": against64(1), "mf": against64(4)}
            log(f"ill-conditioned {label} (B={OB}, D=2, M={m}, ls 1, Sigma = 0, vf = Ktilde) against float64, "
                "kernel / float32 plain: " + " ".join(f"{k}={a:.3e}/{p:.3e}" for k, (a, p) in ill[key].items()))
        del t, t64
    return ill


def variant_timing(fv, bench, device):
    """Kernels 8 ("nt", "packed") and 9 at each shape of VARIANT_TIMED by
    CUDA events beside their plain versions (plain, kernel, kernel, plain),
    kernel 1 where it takes the shape and the sweep's bar
    (xla_stats_reference, library_ms); at VARIANT_MAIN each kernel's
    device us, kernel 1's and the bar's (profiler).  Returns ({shape:
    {label: (ms, plain ms)}}, {shape: bar ms}, {shape: kernel 1 ms},
    {label: (device us, {kernel: us})})."""
    times, bar, k1, dev = {}, {}, {}, {}
    for b, d, m in VARIANT_TIMED:
        key, reps = shape_key(b, d, m), 200 if b <= B else BIG_VARIANT_REPS
        t = bench.sweep_inputs(b, d, m, device)
        times[key] = {label: timed_pair(lambda: sweep_call(kern, t, **kw), lambda: sweep_call(plain, t, **kw), reps)
                      for label, (kern, plain, kw) in timed_variant_kernels(fv).items()}
        calls = bench.variant_calls(t)
        bar[key] = cuda_ms(calls["xla_stats_reference"], reps)
        if "fused_cavi_stats" in calls:
            k1[key] = cuda_ms(calls["fused_cavi_stats"], reps)
        if (b, d, m) == VARIANT_MAIN:
            dev = {label: device_us(lambda: sweep_call(kern, t, **kw))
                   for label, (kern, _, kw) in timed_variant_kernels(fv).items()}
            dev["fused_cavi_stats"] = device_us(calls["fused_cavi_stats"])
            dev["xla_stats_reference"] = device_us(calls["xla_stats_reference"])
        log(f"kernels 8-9 at B={b} D={d} M={m}, ms (plain): " + " ".join(
            f"{k} {a:.4f} ({p:.4f})" for k, (a, p) in times[key].items()) + f"; xla_stats_reference {bar[key]:.4f}"
            + (f", kernel 1 {k1[key]:.4f}" if key in k1 else ""))
        del t
    for label, (us, by) in dev.items():
        log(f"  device at {shape_key(*VARIANT_MAIN)}: {label} {us:.1f} us (" + ", ".join(
            f"{k} {v:.1f}" for k, v in by.items()) + ")")
    return times, bar, k1, dev


def phase_variant_kernels_vs_plain(agt, ck, device):
    """Kernels 8 (every variant) and 9 against their plain versions on the
    same card tensors at VARIANT_CASES, within KERNEL_TOL, each a second
    call bit-equal; then at the ill-conditioned oracle shapes against the
    float64 plain version (ill_conditioned_variants); then timed
    (variant_timing).  Returns ({kernel: largest abs error}, the
    ill-conditioned errors, and variant_timing's four tables)."""
    from agp_tpu_torch import bench
    from agp_tpu_torch.benchmarks import fused_variants as fv

    worst = {"direct_stats": 0.0, "two_factor_nt": 0.0}
    kernels = variant_kernels(fv)
    for b, d, m in VARIANT_CASES:
        t = bench.sweep_inputs(b, d, m, device)
        for label, (kern, plain, kw) in kernels.items():
            got = sweep_call(kern, t, **kw)
            torch.cuda.synchronize()
            ref = sweep_call(plain, t, **kw)
            torch.cuda.synchronize()
            row = check_outputs(f"{label} B={b} D={d} M={m}", STATS_NAMES, got, ref)
            check_repeat(f"{label} B={b} D={d} M={m}", lambda: sweep_call(kern, t, **kw), got)
            worst[kern.__name__] = max(worst[kern.__name__], *row.values())
            log(f"{label} vs plain B={b} D={d} M={m} (row tile {fv.variant_tile(m)[:2]}): "
                "max abs err " + " ".join(f"{k}={v:.2e}" for k, v in row.items()))
        del t, got, ref
    ill = ill_conditioned_variants(agt, ck, device)
    return (worst, ill, *variant_timing(fv, bench, device))


def phase_bench_variants(ck):
    """The bench's variants mode (agp_tpu_torch.bench.variants), the main
    path of kernels 8-9: counts reset before it and read after it, each
    candidate launched once for its error and 1 + variant_reps times for
    its time at each shape (kernel 1 where it takes the shape); every
    candidate's s1/S2 within 1e-3 of the float64 plain version, kernel 1's
    column out of range exactly at M > 128."""
    from agp_tpu_torch import bench

    reset_launches(ck)
    rows = bench.variants(reps=VARIANT_REPS)
    torch.cuda.synchronize()
    calls = {(b, d, m): 2 + bench.variant_reps(b, VARIANT_REPS) for b, d, m in bench.VARIANT_SHAPES}
    launches = expect_launches(ck, "bench variants", {
        "fused_cavi_stats": sum(n for (b, d, m), n in calls.items() if ck.fused_fits(1, d, m)),
        "direct_stats": 2 * sum(calls.values()), "two_factor_nt": sum(calls.values())})
    for row in rows:
        errs = {k: v for k, v in row.items() if k.endswith("_err")}
        if not all(e <= 1e-3 for e in errs.values()) or len(errs) != 4 + ck.fused_fits(1, row["D"], row["M"]):
            raise AssertionError(f"bench variants at B={row['B']}, M={row['M']}: {errs}")
        if ("fused_cavi_stats_out_of_range" in row) != (row["M"] > ck.MAX_M):
            raise AssertionError(f"bench variants at M={row['M']}: kernel 1's range is misreported: {row}")
        log(f"bench variants: {json.dumps(row)}")
    log(f"bench variants: {launches} launches")
    return rows


def phase_gather_vs_plain(device):
    """Kernel 10 bit-equal to its plain version (index_select on the tile
    view: a copy) at the flagship's draw with tiles of 32 and 64 rows, at a
    ragged T with int32 indices, with 99-float tiles (D=33, tr=3) and with
    16-byte tiles from an unaligned view (the scalar paths); then timed at
    the flagship's draw beside its plain version (plain, kernel, kernel,
    plain) and index_select on the view alone (library_ms).  Returns
    ({tr: (ms, plain ms)}, {tr: library ms})."""
    from agp_tpu_torch.benchmarks import gather_modes as gm

    X, _ = flagship_data(device)
    rng = np.random.default_rng(1)
    X33 = torch.as_tensor(rng.normal(size=(1000, 33)).astype(np.float32), device=device)
    X6 = torch.as_tensor(rng.normal(size=(1001, 6)).astype(np.float32), device=device)[1:]
    gen = torch.Generator(device=device).manual_seed(0)
    cases = [(X, 32, B // 32, torch.int64), (X, 64, B // 64, torch.int64), (X, 32, 77, torch.int32),
             (X33, 3, 50, torch.int64), (X6, 2, 40, torch.int64)]
    for Xc, tr, T, dt in cases:
        tidx = torch.randint(0, Xc.shape[0] // tr, (T,), generator=gen, device=device).to(dt)
        got = gm.gather_row_tiles(Xc, tidx, tile_rows=tr)
        torch.cuda.synchronize()
        if not torch.equal(got, gm.gather_row_tiles_reference(Xc, tidx, tile_rows=tr)):
            raise AssertionError(f"gather_row_tiles differs from index_select at D={Xc.shape[1]}, tr={tr}, T={T}")
        log(f"gather_row_tiles bit-equal to its plain version: D={Xc.shape[1]}, tr={tr}, T={T}, {dt}")
    times, library = {}, {}
    for tr in (32, 64):
        tidx = torch.randint(0, N // tr, (B // tr,), generator=gen, device=device)
        view = X[: N // tr * tr].reshape(N // tr, tr, D)
        times[tr] = timed_pair(lambda: gm.gather_row_tiles(X, tidx, tile_rows=tr),
                               lambda: gm.gather_row_tiles_reference(X, tidx, tile_rows=tr))
        library[tr] = cuda_ms(lambda: view.index_select(0, tidx))
        log(f"gather_row_tiles B={B} D={D} tr={tr}: kernel {times[tr][0]:.4f} ms, plain {times[tr][1]:.4f} ms, "
            f"index_select {library[tr]:.4f} ms")
    return times, library


def phase_bench_gather(ck):
    """The bench's gather mode (agp_tpu_torch.bench.gather), the main path
    of kernel 10: counts reset before it and read after it, one launch for
    its check and 2 (1 + draws) for its times at each tile height."""
    from agp_tpu_torch import bench

    reset_launches(ck)
    rows = bench.gather(draws=GATHER_DRAWS)
    torch.cuda.synchronize()
    launches = expect_launches(ck, "bench gather",
                               {"gather_row_tiles": len(bench.GATHER_TILES) * (1 + 4 * GATHER_DRAWS)})
    log(f"bench gather: {json.dumps(rows)}; {launches} launches")
    return rows


def phase_bench_entry():
    """The bench's primary line (``python3 -m agp_tpu_torch.bench``) in a
    child process, at BENCH_ITERS timed steps: its last line must parse,
    name the port's metric and give a finite positive rate."""
    proc = subprocess.run([sys.executable, "-m", "agp_tpu_torch.bench", "--iters", str(BENCH_ITERS),
                           "--chunk", str(BENCH_CHUNK)], cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"the bench exited {proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    for line in lines[:-1]:
        log(f"  [bench] {line}")
    result = json.loads(lines[-1])
    value = result.get("value")
    if result.get("metric") != "torch_cavi_iters_per_sec_svgp_m64_logistic_b4096" or not (
            isinstance(value, float) and value > 0 and value < float("inf")):
        raise AssertionError(f"the bench's line is wrong: {lines[-1]}")
    log(f"bench entry point ({BENCH_ITERS} timed steps): {lines[-1]}")
    return result


def variant_bound(b, d, m, two_factor):
    """Kernels 8-9 as fused_bound for one latent (logistic: 5 words a row
    beyond x), with kappa in the two-factor form as two triangular products
    (W = Knm L^-T, kappa = W L^-1: ``sym_fmas`` each) instead of one M^2;
    the design's bound counts kappa and kappa Sigma in full in three TF32
    passes, kernel 9's W in four (L^-T split in three) and S2's upper
    triangle in three."""
    tc = b * ((2 * sym_fmas(m) if two_factor else m * m) + 2 * sym_fmas(m))
    design = b * ((4 + 3) * m * m if two_factor else 3 * m * m) + 3 * b * (m * m + sym_fmas(m))
    simt = b * (m * d + 5 * m)
    nbytes = 4 * (b * d + 5 * b + m * d + 3 * m * m + 2 * m)
    return tc_bound(tc, simt, nbytes), tc_bound(design, simt, nbytes), bound(tc + simt, nbytes)


def gather_bound(t, tr, d):
    """Kernel 10: no arithmetic; reads T tiles of tr D floats and T int64
    indices, writes the T tiles."""
    return bound(0, 2 * 4 * t * tr * d + 8 * t)


def timing_fields(extra, main_shape):
    """Kernels 4-7's further keys of the kernels line from kappa_timing's
    (4, 6) or stats_timing's (5, 7) dicts by shape: device us, and the
    device us of the products alone (4, 6) or of the library call (5, 7),
    at the main shape and at each timed shape, and what each bound counts;
    none for the other kernels."""
    if not extra:
        return {}
    rows = {"device_us": extra[main_shape]["device_us"],
            "per_shape_device_us": {k: v["device_us_by_kernel"] for k, v in extra.items()}}
    if "products_ms" in extra[main_shape]:
        return {**rows, "products_ms": {k: v["products_ms"] for k, v in extra.items()},
                "products_device_us": {k: v["products_device_us"] for k, v in extra.items()},
                "products": "kappa's product alone (torch.matmul; kernel 4: torch.bmm for kappa and for kappa "
                            "Sigma): a yardstick, not the whole function",
                "bound": "kappa's M^2 FMAs (kernel 4: and the quadratic form's upper triangle) once at 495 TFLOP/s "
                         "TF32, the gram and row sums at 67 FP32, bytes at 3.35 TB/s",
                "bound_3xtf32": "the design's three TF32 passes of kappa (kernel 4: and of kappa Sigma in full), the "
                                "rest at FP32, bytes",
                "bound_fp32": "everything at 67 TFLOP/s FP32, bytes"}
    return {**rows, "library_device_us": extra[main_shape]["library_device_us"],
            "per_shape_library_device_us": {k: v["library_device_us"] for k, v in extra.items()},
            "bound": "S2's upper-triangle FMAs once at 495 TFLOP/s TF32, s1 at 67 FP32, bytes at 3.35 TB/s",
            "bound_3xtf32": "the design's three TF32 passes of S2, s1 at FP32, bytes",
            "bound_fp32": "S2 and s1 at 67 TFLOP/s FP32, bytes"}


def ms_table(pairs):
    return {k: {"ms": kern, "plain_ms": plain} for k, (kern, plain) in pairs.items()}


# ------------------------------------------- Slice E: the exact GP and the dense VGP
# phase 19, the exact GP: benchmarks/tpu_acceptance.py:57-71's toy at
# N=8,192 (the reference's 400), examples/regression.py's 60 iterations,
# 2,048 held-out points; full covariance and sample_f on 512 of them
GN, GH, G_ITERS, SN, SAMPLES = 8192, 2048, 60, 512, 4000
# phase 20: (a) examples/robust_regression.py's VGP (Matern-5/2,
# Student-t(4), the default Adam(0.01)) on the toy at N=4,096 with
# y[::29] += 8; (b) the reference's heteroscedastic VGP oracle
# (tpu_acceptance.py:123-138, lambda=8, fixed hyperparameters) at N=2,048
# (the reference's 512), D=1; 60 iterations each
VN, HN, V_ITERS = 4096, 2048, 60
# phase 21: the flagship's shape with a Gaussian likelihood that learns its
# noise (Adam(0.05) on log sigma^2), fixed kernel, 300 steps
NOISE_STEPS = 300
# iterations of train timed after each dense path's run (steady state)
DENSE_TIMED = 10
# phase 22: the dense paths at N=1,024 for 10 iterations, path 21 for 20
# steps at N=PN, card against CPU (both float32)
DN, D_ITERS = 1024, 10
# the paths' RMSE floors (against the noiseless f: held-out for the GP, on
# the training inputs for the VGPs, against X w on 8,192 rows for path
# 21), from the plain code's float32 RMSE on the CPU on the same data
# (``python3 chip_smoke.py dense-cpu`` on the card's host): GP 0.0061,
# Student-t VGP 0.0403, heteroscedastic VGP 0.3395, path 21 2.7986.  Each
# floor is about three times that, and inside the reference's own (GP
# 0.1, heteroscedastic 0.4, tpu_acceptance.py:57-71, 123-138); three
# times would not beat predicting 0 for the last two (RMS of f 0.7, of
# X w ~4.5), so the heteroscedastic floor is the reference's and path
# 21's 1.2 times the CPU's.
DENSE_FLOORS = {"gp": 0.02, "vgp_studentt": 0.12, "vgp_het": 0.4, "svgp_noise": 3.3}
# sample_f against predict_f: each entry of the 4,000 samples' mean and
# covariance within this many standard errors (float64 statistics)
SAMPLE_SE = 6.0
DENSE_PATHS = ("gp", "vgp_studentt", "vgp_het")


def dense_data(which, n, device, seed=0):
    """(X, f, y) float32 of a dense path: the toy X ~ U[-2, 2]^D,
    f = sin(2 x_0) + 0.5 x_1 (D=2; D=1 for the heteroscedastic oracle,
    whose noise has precision 8 sigmoid(-1.5 + 1.2 tanh(x_0))), y = f +
    0.1 eps, with y[::29] += 8 for the Student-t path."""
    rng = np.random.default_rng(seed)
    d = 1 if which == "vgp_het" else 2
    X = rng.uniform(-2, 2, size=(n, d))
    f = np.sin(2 * X[:, 0]) + (0.5 * X[:, 1] if d > 1 else 0.0)
    if which == "vgp_het":
        g = -1.5 + 1.2 * np.tanh(X[:, 0])
        y = f + np.sqrt(1.0 / (8.0 / (1.0 + np.exp(-g)))) * rng.normal(size=n)
    else:
        y = f + 0.1 * rng.normal(size=n)
    if which == "vgp_studentt":
        y[::29] += 8.0
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in (X, f, y))


def dense_model(agt, which, X, y):
    if which == "gp":
        return agt.GP.create(X, y, agt.SqExponentialKernel())
    if which == "vgp_studentt":
        return agt.VGP.create(X, y, agt.Matern52Kernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticVI())
    return agt.VGP.create(X, y, agt.SqExponentialKernel(), agt.HeteroscedasticLikelihood.create(lam=8.0),
                          agt.AnalyticVI(), optimiser=None)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dense_rmse(agt, which, model, state, device):
    """RMSE of predict_f against the noiseless f: on GH held-out points
    for the GP, on the training inputs for the VGPs (the first latent)."""
    if which == "gp":
        Xh, fh, _ = dense_data(which, GH, device, seed=1)
        mu = agt.predict_f(model, state, Xh)
    else:
        Xh, fh = model.train_x, dense_data(which, model.train_x.shape[0], device)[1]
        mu = agt.predict_f(model, state, Xh)
        mu = mu[0] if mu.ndim == 2 else mu
    return float(torch.sqrt(torch.mean((mu - fh) ** 2)))


def dense_path(agt, ck, device, which, n=None, check=True, timed=True):
    """A dense path through agp_tpu_torch.train (phase 19 or 20): its run
    with no kernel launch, its floor, the hyperparameters moved and
    finite, then its steady rate (DENSE_TIMED iterations of train) and the
    peak device memory.  Returns its numbers."""
    n = n or {"gp": GN, "vgp_studentt": VN, "vgp_het": HN}[which]
    iters = G_ITERS if which == "gp" else V_ITERS
    X, _, y = dense_data(which, n, device)
    model = dense_model(agt, which, X, y)
    log0 = log_hypers(model)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        reset_launches(ck)
        sync(device)
        torch.cuda.reset_peak_memory_stats()
    early = {}

    def at_2(m, s, i):
        if i == 2:
            early["value"] = float(agt.elbo(m, s))

    t0 = time.perf_counter()
    model, state = agt.train(model, iterations=iters, callback=at_2 if which == "gp" else None)
    sync(device)
    train_s = time.perf_counter() - t0
    if cuda:
        expect_launches(ck, which, {})
    out = {"rmse": dense_rmse(agt, which, model, state, device), "train_s": train_s}
    logs = log_hypers(model)
    out["moved"] = float((logs - log0).abs().max())
    lik = model.likelihood
    out["param"] = float(getattr(lik, {"gp": "sigma2", "vgp_het": "lam", "vgp_studentt": "nu"}[which]))
    post = state.alpha if which == "gp" else state.mu
    if check:
        floor = DENSE_FLOORS[which]
        if not (bool(torch.isfinite(post).all()) and bool(torch.isfinite(logs).all())
                and np.isfinite(out["param"])):
            raise AssertionError(f"{which}: non-finite posterior, hyperparameters or likelihood parameter")
        if not out["rmse"] <= floor:
            raise AssertionError(f"{which}: RMSE {out['rmse']:.4f} > {floor}")
        if which != "vgp_het" and not out["moved"] > MIN_HYPER_MOVE:
            raise AssertionError(f"{which}: the log-hyperparameters moved by {out['moved']:.3e} <= {MIN_HYPER_MOVE}")
    if which == "gp":
        out["log_py"], out["log_py_2"] = float(agt.elbo(model, state)), early["value"]
        if check:
            s2 = out["param"]
            if not abs(np.log(s2 / 0.01)) < abs(np.log(0.1 / 0.01)):
                raise AssertionError(f"gp: sigma^2 {s2:.5f} did not move from 0.1 toward 0.01")
            if not out["log_py"] > out["log_py_2"]:
                raise AssertionError(f"gp: log p(y) {out['log_py']:.3f} not above iteration 2's {out['log_py_2']:.3f}")
            gp_predictions(agt, model, state, device, out)
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if timed:
        t0 = time.perf_counter()
        model, state = agt.train(model, iterations=DENSE_TIMED, state=state)
        sync(device)
        out["ips"] = DENSE_TIMED / (time.perf_counter() - t0)
    return out


def gp_predictions(agt, model, state, device, out):
    """Full-covariance predict_f and sample_f on SN held-out points: the
    mean and covariance of SAMPLES samples within SAMPLE_SE standard errors
    of predict_f's (its covariance plus the jitter sample_f adds); then
    predict_y in chunks of 1,000 rows bit-equal to the whole call."""
    Xh, _, _ = dense_data("gp", GH, device, seed=1)
    Xs = Xh[:SN]
    mu, cov = agt.predict_f(model, state, Xs, cov=True, diag=False)
    gen = torch.Generator(device=device).manual_seed(0)
    x = agt.sample_f(model, state, Xs, SAMPLES, generator=gen).double()
    mu, cov = mu.double(), cov.double() + agt.config.jitter(torch.float32) * torch.eye(SN, dtype=torch.float64,
                                                                                      device=cov.device)
    var = torch.diagonal(cov)
    mean_z = float(((x.mean(0) - mu).abs() / torch.sqrt(var / SAMPLES)).max())
    se = torch.sqrt((var[:, None] * var[None, :] + cov**2) / SAMPLES)
    cov_z = float(((torch.cov(x.T) - cov).abs() / se).max())
    if not (mean_z <= SAMPLE_SE and cov_z <= SAMPLE_SE):
        raise AssertionError(f"gp: sample_f's mean / covariance {mean_z:.2f} / {cov_z:.2f} standard errors from "
                             f"predict_f's (bound {SAMPLE_SE})")
    whole = agt.predict_y(model, state, Xh)
    chunked = agt.predict_y(model, state, Xh, chunk_size=1000)
    if not torch.equal(whole, chunked):
        raise AssertionError(f"gp: predict_y with chunk_size=1000 differs from the whole call by "
                             f"{float((whole - chunked).abs().max()):.3e}")
    out.update(sample_mean_se=mean_z, sample_cov_se=cov_z)


def noise_data(device, n=N, seed=0):
    """The flagship's X with y = X w + 0.1 eps, and X w."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D)).astype(np.float32)
    f = X @ rng.normal(size=D).astype(np.float32)
    y = (f + 0.1 * rng.normal(size=n)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (X, f, y))


def noise_model(agt, X, b=B):
    return agt.SVGP.create(
        agt.SqExponentialKernel(lengthscale=2.0, variance=1.0), agt.GaussianLikelihood.create(0.1, opt_noise=True),
        agt.AnalyticSVI(b, minibatch_sampling="block"), X[:M], optimiser=None,
    )


def noise_path(agt, ck, device, check=True, timed=True):
    """Phase 21: the SVGP with Gaussian noise learning at the flagship's
    shape, NOISE_STEPS steps through agp_tpu_torch.train: one launch of
    kernel 6 and one of kernel 7 a step and none of kernel 1 (a learnt
    noise takes the split pair), sigma^2 and the RMSE of predict_f against
    X w on 8,192 rows; then the steady rate.  Returns its numbers."""
    from agp_tpu_torch.training.train import vi_steps

    X, f, y = noise_data(device)
    model = noise_model(agt, X)
    gen = torch.Generator(device=device).manual_seed(0)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        reset_launches(ck)
        torch.cuda.reset_peak_memory_stats()
    sigma2 = []
    model, state = agt.train(model, X, y, iterations=NOISE_STEPS, generator=gen,
                             callback=lambda m, s, i: sigma2.append(m.likelihood.sigma2) if i % 50 == 0 else None)
    sync(device)
    out = {}
    if cuda:
        out["launches"] = expect_launches(ck, "svgp_noise", route_launches(NOISE_STEPS, "single"))
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["sigma2"] = [float(s) for s in sigma2]
    mu, var = agt.predict_f(model, state, X[:8192], cov=True)
    out["rmse"] = float(torch.sqrt(torch.mean((mu - f[:8192]) ** 2)))
    # the noise's fixed point: its gradient vanishes where sigma^2 is the
    # mean of (y - mu)^2 + var.  The flagship's kernel fits X w only in
    # part, so the point is the misfit (~8.8), not the data's 0.01; Adam's
    # memory of the first steps' large gradients slows the approach
    out["fixed_point"] = float(torch.mean((y[:8192] - mu) ** 2 + var))
    gaps = [abs(s - out["fixed_point"]) for s in [0.1] + out["sigma2"]]
    if check:
        floor = DENSE_FLOORS["svgp_noise"]
        if not (bool(torch.isfinite(state.mu).all()) and all(np.isfinite(out["sigma2"]))):
            raise AssertionError("svgp_noise: non-finite posterior or sigma^2")
        if not out["rmse"] <= floor:
            raise AssertionError(f"svgp_noise: RMSE {out['rmse']:.4f} > {floor}")
        if not all(b < a for a, b in zip(gaps, gaps[1:])):
            raise AssertionError(f"svgp_noise: sigma^2 every 50 steps {out['sigma2']} (from 0.1) does not move "
                                 f"steadily toward its fixed point {out['fixed_point']:.5f}")
    if timed:
        model, state = vi_steps(model, state, X, y, 50, generator=gen)  # warm-up
        sync(device)
        t0 = time.perf_counter()
        model, state = vi_steps(model, state, X, y, NOISE_STEPS, generator=gen)
        sync(device)
        out["ips"] = NOISE_STEPS / (time.perf_counter() - t0)
    return out


def log_dense(which, r, device="the card"):
    extra = ""
    if which == "gp":
        extra = (f", sigma^2 {r['param']:.5f} (from 0.1), log p(y) {r['log_py_2']:.2f} at iteration 2 -> "
                 f"{r['log_py']:.2f}")
        if "sample_mean_se" in r:
            extra += (f"; sample_f ({SAMPLES} samples, {SN} points) mean / covariance within {r['sample_mean_se']:.2f}"
                      f" / {r['sample_cov_se']:.2f} standard errors of predict_f's, predict_y chunked bit-equal")
    elif which == "vgp_het":
        extra = f", lambda {r['param']:.4f}"
    rate = f", steady {r['ips']:.2f} iterations/s over {DENSE_TIMED} iterations" if "ips" in r else ""
    memory = f"; peak device memory {r['peak_gib']:.3f} GiB; 0 kernel launches" if "peak_gib" in r else ""
    log(f"{which} on {device}: RMSE {r['rmse']:.4f} (floor {DENSE_FLOORS[which]}), log-hyperparameters moved by "
        f"{r['moved']:.4f}{extra}; train {r['train_s']:.2f} s{rate}{memory}")


def phase_dense(agt, ck, device, which):
    r = dense_path(agt, ck, device, which)
    log_dense(which, r)
    return r


def phase_noise(agt, ck, device):
    r = noise_path(agt, ck, device)
    log(f"svgp_noise (N={N}, D={D}, M={M}, B={B}, block, Gaussian noise learnt by Adam(0.05)): RMSE against X w "
        f"{r['rmse']:.4f} (floor {DENSE_FLOORS['svgp_noise']}), sigma^2 every 50 steps "
        f"{', '.join(f'{s:.5f}' for s in r['sigma2'])} (from 0.1), its fixed point {r['fixed_point']:.5f}; "
        f"{r['launches']} launches (kernels 6 and 7 once a "
        f"step); steady {r['ips']:.1f} CAVI iterations/s over {NOISE_STEPS} steps; peak device memory "
        f"{r['peak_gib']:.3f} GiB")
    return r


def dense_cpu_mode(agt, ck):
    """``python3 chip_smoke.py dense-cpu``: the paths of phases 19-21 with
    the plain code on the CPU in float32, on the same data, without their
    floors: the errors DENSE_FLOORS is set from."""
    r = noise_path(agt, ck, "cpu", check=False, timed=False)
    log(f"svgp_noise on the CPU: RMSE {r['rmse']:.4f}, sigma^2 every 50 steps "
        f"{', '.join(f'{s:.5f}' for s in r['sigma2'])}, its fixed point {r['fixed_point']:.5f}")
    for which in ("vgp_het", "vgp_studentt", "gp"):
        log_dense(which, dense_path(agt, ck, "cpu", which, check=False, timed=False), "the CPU")


def dense_after(agt, which, X, y, perm=None):
    """The posterior (alpha for the GP, mu [L, N] for a VGP) in the data's
    own row order after D_ITERS iterations of train on (X, y) (its rows in
    the order ``perm`` when given), the likelihood's learnt parameter and
    the log-hyperparameters, as float64 on the CPU."""
    if perm is not None:
        X, y = X[perm], y[perm]
    model, state = agt.train(dense_model(agt, which, X, y), iterations=D_ITERS)
    post = (state.alpha[None] if which == "gp" else state.mu).double().cpu()
    if perm is not None:
        post = post[:, torch.argsort(perm)]
    lik = model.likelihood
    param = lik.sigma2 if which == "gp" else getattr(lik, "lam", None)
    return post, None if param is None else param.double().cpu(), log_hypers(model)


def triple_err(a, b):
    """max |d post| / max |post|, |d param| / param and max |d log-hyperparameter|."""
    err = max(float((a[0] - b[0]).abs().max() / b[0].abs().max()), float((a[2] - b[2]).abs().max()))
    if b[1] is not None:
        err = max(err, float((a[1] - b[1]).abs() / b[1]))
    return err


def noise_trajectories(agt, device):
    """The GP's sigma^2 after each of D_ITERS iterations at N=DN on the card
    (float32) and on the CPU (float32 and float64): its gradient
    (|alpha|^2 - tr(Sigma^-1)) / 2 is the difference of two terms of size
    N / sigma^2 that meet at the optimum.  Logged only."""
    Xc, _, yc = dense_data("gp", DN, "cpu", seed=1)
    runs = {}
    for label, dev, dt in (("card", device, torch.float32), ("CPU float32", "cpu", torch.float32),
                           ("CPU float64", "cpu", torch.float64)):
        seen = []
        agt.train(dense_model(agt, "gp", Xc.to(device=dev, dtype=dt), yc.to(device=dev, dtype=dt)),
                  iterations=D_ITERS, callback=lambda m, s, i: seen.append(m.likelihood.sigma2))
        runs[label] = np.array([float(v) for v in seen])
    ref = runs["CPU float64"]
    log(f"gp sigma^2 over {D_ITERS} iterations (N={DN}): card {' '.join(f'{v:.6f}' for v in runs['card'])}; "
        f"largest relative gap to float64: card {np.max(np.abs(runs['card'] / ref - 1)):.3e}, CPU float32 "
        f"{np.max(np.abs(runs['CPU float32'] / ref - 1)):.3e}")


def noise_after(agt, X, y, draws, Z_perm=None):
    """mu (in Z's own order), sigma^2 and no log-hyperparameters after 20
    steps of path 21 on (X, y) with the given draws."""
    from agp_tpu_torch.training.train import vi_steps

    model = noise_model(agt, X)
    if Z_perm is not None:
        model = model.replace(Z=model.Z[:, Z_perm].contiguous())
    state = agt.init_state(model, X, y)
    model, state = vi_steps(model, state, X, y, 20, draws=draws.to(X.device))
    mu = state.mu.double().cpu()
    if Z_perm is not None:
        mu = mu[:, torch.argsort(Z_perm)]
    return mu, model.likelihood.sigma2.double().cpu(), torch.zeros(1, dtype=torch.float64)


def phase_dense_parity(agt, device):
    """Card (float32) against CPU (float32, the plain code) for paths 19,
    20a and 20b at N=DN after D_ITERS iterations and path 21 at N=PN after
    20 steps from the same draws: the posterior (max |d| / max), the learnt
    noise or lambda (relative) and the log-hyperparameters (absolute),
    within ORACLE_DEVICE_FACTOR times each path's own float32 noise (the
    CPU run again with the data's rows, for path 21 the inducing points,
    in another order), with no fixed floor.  Then the card's
    float32 dense algebra against the CPU's one op at a time at N=DN
    (logged, no bound)."""
    for which in DENSE_PATHS:
        Xc, _, yc = dense_data(which, DN, "cpu", seed=1)
        perm = torch.randperm(DN, generator=torch.Generator().manual_seed(2))
        cpu = dense_after(agt, which, Xc, yc)
        card = dense_after(agt, which, Xc.to(device), yc.to(device))
        noise = triple_err(dense_after(agt, which, Xc, yc, perm), cpu)
        parity_check(which, triple_err(card, cpu), noise,
                     what=f"(N={DN}, {D_ITERS} iterations) card (float32) vs CPU (float32)")
    noise_trajectories(agt, device)
    Xc, _, yc = noise_data("cpu", n=PN, seed=1)
    draws = torch.randint(0, PN // 64, (20, B // 64), generator=torch.Generator().manual_seed(1))
    perm = torch.randperm(M, generator=torch.Generator().manual_seed(2))
    cpu = noise_after(agt, Xc, yc, draws)
    card = noise_after(agt, Xc.to(device), yc.to(device), draws)
    noise = triple_err(noise_after(agt, Xc, yc, draws, perm), cpu)
    parity_check("svgp_noise", triple_err(card, cpu), noise,
                 what=f"(N={PN}, B={B}, 20 steps; mu and sigma^2) card (float32) vs CPU (float32)")
    dense_ops_parity(agt, device)


def dense_ops_parity(agt, device):
    """The dense step's algebra one op at a time at N=DN on the Matern-5/2
    gram of path 20a's inputs: safe_cholesky, chol_solve, chol_inv and
    nat_to_moments (eta2 = -(Diag(0.5) + K^-1/2)), each on the same float32
    inputs on the card and on the CPU, as max |d| / max against the CPU's
    float32 and float64 results.  Logged only."""
    from agp_tpu_torch.ops import linalg

    X, _, _ = dense_data("vgp_studentt", DN, "cpu", seed=1)
    K = agt.Matern52Kernel().gram(X)
    rng = np.random.default_rng(3)
    b = torch.as_tensor(rng.normal(size=DN), dtype=torch.float32)
    eta1 = torch.as_tensor(rng.normal(size=DN), dtype=torch.float32)

    def ops(K, b, eta1):
        L = linalg.safe_cholesky(K, agt.config.jitter(torch.float32))
        K_inv = linalg.chol_inv(L)
        eta2 = linalg.symmetrize(-(0.25 * torch.eye(DN, dtype=K.dtype, device=K.device) + 0.5 * K_inv))
        return {"safe_cholesky": L, "chol_solve": linalg.chol_solve(L, b), "chol_inv": K_inv,
                "nat_to_moments": linalg.nat_to_moments(eta1, eta2, lazy_rungs=True)[1]}

    cpu = ops(K, b, eta1)
    card = ops(K.to(device), b.to(device), eta1.to(device))
    f64 = ops(K.double(), b.double(), eta1.double())
    for name in cpu:
        ref = cpu[name].double()
        d_cpu = float((card[name].double().cpu() - ref).abs().max() / ref.abs().max())
        r64 = f64[name]
        e_card = float((card[name].double().cpu() - r64).abs().max() / r64.abs().max())
        e_cpu = float((ref - r64).abs().max() / r64.abs().max())
        log(f"dense op {name} (N={DN}): card vs CPU (float32) {d_cpu:.3e}; against float64 card {e_card:.3e}, "
            f"CPU {e_cpu:.3e}")


def profile_dense(agt, device, which):
    """torch.profiler over 5 iterations (after 5) of the exact GP at N=GN
    (an analytic refresh and a hyperparameter step each) or the Student-t
    VGP at N=VN (a CAVI step and a hyperparameter step each)
    (``python3 chip_smoke.py profile dense gp|vgp``): wall and device-busy
    time an iteration, the idle share, the peak device memory and the
    largest device operations."""
    from torch.profiler import ProfilerActivity, profile

    from agp_tpu_torch.inference import analytic_vi
    from agp_tpu_torch.models.gp import analytic_update
    from agp_tpu_torch.training import autotuning
    from agp_tpu_torch.training.train import _gp_hyper_step

    name = "gp" if which == "gp" else "vgp_studentt"
    X, _, y = dense_data(name, GN if which == "gp" else VN, device)
    model = dense_model(agt, name, X, y)
    model, state = agt.train(model, iterations=5)
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    n = 5

    def iterations(model, state):
        for _ in range(n):
            if which == "gp":
                model, state = analytic_update(model, state)
                model, state = _gp_hyper_step(model, state)
            else:
                model, state = analytic_vi.variational_update(model, state, X, model.train_y)
                model, state = autotuning.hyper_step(model, state, X, model.train_y)
        return model, state

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, state = iterations(model, state)
        sync(device)
        wall_us = (time.perf_counter() - t0) / n * 1e6
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / n, e.count / n, e.key) for e in events
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile dense {which} ({name}, N={X.shape[0]}): wall {wall_us:.1f} us/iteration, device busy {busy:.1f} "
        f"us/iteration, idle share {1 - busy / wall_us:.4f}, {sum(r[1] for r in rows):.1f} device ops/iteration, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for us, count, key in rows[:12]:
        log(f"  device {us:10.1f} us/iteration  x{count:.1f}  {key[:90]}")


def ladder_mode(agt, device):
    """``python3 chip_smoke.py ladder``: the dense ladders with their rungs
    factored lazily (rung 0 alone, one host read) against all rungs as one
    batch, at path 20a's N=VN (one latent) and path 20b's N=HN (two):
    safe_cholesky of K and nat_to_moments, by CUDA events (P T T P, each
    reps calls) and device us by the profiler; then path 20a's steady rate
    with each."""
    from torch.profiler import ProfilerActivity, profile

    from agp_tpu_torch.ops import linalg

    for which, n in (("vgp_studentt", VN), ("vgp_het", HN)):
        X, _, y = dense_data(which, n, device)
        model = dense_model(agt, which, X, y)
        state = agt.init_state(model)
        K = agt.kernels.batch_gram(model.kernel, X)
        eta2 = linalg.symmetrize(-(0.25 * torch.eye(n, device=device) + 0.5 * state.kmat["K_inv"]))
        eta1 = torch.ones_like(state.mu)
        calls = {
            "safe_cholesky": lambda lazy: linalg.safe_cholesky(K, 1e-3, lazy_rungs=lazy),
            "nat_to_moments": lambda lazy: linalg.nat_to_moments(eta1, eta2, lazy_rungs=lazy),
        }
        for name, fn in calls.items():
            times = {}
            for lazy in (False, True, True, False):
                times.setdefault(lazy, []).append(cuda_ms(lambda: fn(lazy), reps=10))
            dev = {}
            for lazy in (False, True):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        fn(lazy)
                    sync(device)
                dev[lazy] = sum(e.self_device_time_total for e in prof.key_averages()
                                if str(e.device_type).endswith("CUDA")) / 5
            log(f"ladder {which} {name} ([{K.shape[0]}, {n}, {n}]): batched {times[False][0]:.3f}, "
                f"{times[False][1]:.3f} ms / lazy {times[True][0]:.3f}, {times[True][1]:.3f} ms by events; "
                f"device {dev[False]:.1f} / {dev[True]:.1f} us")
    X, _, y = dense_data("vgp_studentt", VN, device)
    real = linalg._ladder_cholesky
    for lazy in (False, True, True, False):
        linalg._ladder_cholesky = (lambda A, j, lazy_rungs=False: real(A, j, False)) if not lazy else real
        try:
            model, state = agt.train(dense_model(agt, "vgp_studentt", X, y), iterations=5)
            sync(device)
            t0 = time.perf_counter()
            agt.train(model, iterations=DENSE_TIMED, state=state)
            sync(device)
            log(f"ladder: vgp_studentt steady {DENSE_TIMED / (time.perf_counter() - t0):.2f} iterations/s with the "
                f"{'lazy' if lazy else 'batched'} ladders")
        finally:
            linalg._ladder_cholesky = real


def dense_mode(agt, ck, device):
    """``python3 chip_smoke.py dense``: phases 19-22 alone."""
    for which in DENSE_PATHS:
        timed_phase(which, phase_dense, agt, ck, device, which)
    timed_phase("svgp_noise", phase_noise, agt, ck, device)
    timed_phase("dense parity", phase_dense_parity, agt, device)


# ------------------------------------------------- Slice G: the samplers
# phase 23: each sampler at SAMPLER_LANES lanes on the card (float32), its
# mean and variance within SAMPLER_SE standard errors of the closed forms
# (the variance's from the draws' own fourth moment), and a two-sample KS
# test (p > SAMPLER_KS_P) against SAMPLER_CPU_LANES draws on the CPU
SAMPLER_LANES, SAMPLER_CPU_LANES = 2**20, 2**17
SAMPLER_SE, SAMPLER_KS_P = 6.0, 1e-3
# phase 24: the port bench's Gibbs row (bench.gibbs_workload: N=2048 in
# 8-D, 4 chains, 50 burn-in sweeps, 400 samples), each solver
GIBBS_SOLVERS = ("cg", "chol")
GIBBS_SAMPLES, GIBBS_CHAINS = 400, 4
# the CAVI comparison: the dense VGP on the same data, fixed
# hyperparameters, this many full-batch iterations
GIBBS_VGP_ITERS = 30
# the Gibbs row's floors, from ``python3 chip_smoke.py gibbs-cpu`` (the same
# shape in float64 on a CPU): the posterior mean's sign agreement with the
# labels (0.99170 with CG, 0.99121 with the Cholesky) and its correlation
# with the CAVI VGP's mean (0.99998 with both), each floor below the lower
# of the two by more than a run's Monte Carlo spread
GIBBS_FLOORS = {"sign": 0.98, "corr": 0.999}
# phase 25: the grand tour's sampling flow (examples/grand_tour.py:38-50)
# on its N=40 logistic data; the conjugate Gaussian check (N=30, noise
# CONJ_NOISE) for NUTS and HMC; each sampler's ms a sample at N=SAMPLER_N
CONJ_NOISE, CONJ_CORR = 0.01, 0.999
SAMPLER_N = 512
# phase 26: card (float32) against CPU (float32), each within this many
# times the CPU float32's own error against float64
SAMPLER_PARITY_FACTOR = 10.0


def sampler_cases():
    """{name: (draw(generator, n, device) -> float32 draws, mean, var)} of
    PG(1, c), PG(b, c) and GIG in each of its routes, with the closed-form
    moments (scipy's Bessel ratios for GIG)."""
    import scipy.special as sp

    from agp_tpu_torch.distributions import gig, polyagamma as pg

    def full(n, v, device):
        return torch.full((n,), v, dtype=torch.float32, device=device)

    def gig_moments(a, b, p):
        om, sc = np.sqrt(a * b), np.sqrt(b / a)
        m1 = sc * sp.kv(p + 1, om) / sp.kv(p, om)
        return m1, sc**2 * sp.kv(p + 2, om) / sp.kv(p, om) - m1**2

    cases = {}
    for c in (0.0, 1.0, 2.5):
        cases[f"PG(1, {c})"] = (lambda g, n, dev, c=c: pg.sample_pg1(g, full(n, c, dev)),
                                float(pg.pg_mean(1.0, c)), float(pg.pg_var(1.0, c)))
    cases["PG(3.5, 0.5)"] = (lambda g, n, dev: pg.sample_pg(g, full(n, 3.5, dev), full(n, 0.5, dev)),
                             float(pg.pg_mean(3.5, 0.5)), float(pg.pg_var(3.5, 0.5)))
    for a, b, p in ((2.0, 3.0, 0.5), (3.0, 0.5, 1.5), (0.05, 0.05, 0.3)):
        cases[f"GIG({a}, {b}, {p})"] = (lambda g, n, dev, a=a, b=b, p=p: gig.sample_gig(g, full(n, a, dev),
                                                                                       full(n, b, dev), p),
                                        *gig_moments(a, b, p))
    return cases


def phase_samplers(agt, ck, device):
    """Phase 23: each sampler's moments at SAMPLER_LANES lanes on the card,
    its KS test against CPU draws, ms a draw by CUDA events (one call over
    all the lanes), and the masked loop's trips and host reads a draw."""
    import scipy.stats as st

    from agp_tpu_torch.utils.tensors import host_read, run_trips

    out = {}
    reset_launches(ck)
    for i, (name, (draw, mean, var)) in enumerate(sampler_cases().items()):
        g = torch.Generator(device=device).manual_seed(100 + i)
        s = draw(g, SAMPLER_LANES, device)
        s64 = s.double()
        m4 = float(((s64 - s64.mean()) ** 4).mean())
        z_mean = (float(s64.mean()) - mean) / np.sqrt(var / SAMPLER_LANES)
        z_var = (float(s64.var()) - var) / np.sqrt((m4 - float(s64.var()) ** 2) / SAMPLER_LANES)
        cpu = draw(torch.Generator().manual_seed(200 + i), SAMPLER_CPU_LANES, "cpu")
        ks_p = float(st.ks_2samp(s.cpu().numpy(), cpu.numpy()).pvalue)
        finite = bool(torch.isfinite(s).all()) and bool((s > 0).all())
        trips, reads = run_trips.trips, host_read.reads
        ms = cuda_ms(lambda: draw(g, SAMPLER_LANES, device), reps=3)
        # cuda_ms's warm-up call and its 3 timed calls
        per_trips, per_reads = (run_trips.trips - trips) / 4, (host_read.reads - reads) / 4
        out[name] = dict(z_mean=z_mean, z_var=z_var, ks_p=ks_p, ms=ms, trips=per_trips, reads=per_reads)
        log(f"sampler {name} at {SAMPLER_LANES} lanes: mean {float(s64.mean()):.6g} (closed form {mean:.6g}, "
            f"{z_mean:+.2f} SE), variance {float(s64.var()):.6g} ({var:.6g}, {z_var:+.2f} SE); KS against "
            f"{SAMPLER_CPU_LANES} CPU draws p = {ks_p:.4f}; {ms:.3f} ms a draw, {per_trips:.2f} trips and "
            f"{per_reads:.2f} host reads a draw")
        if not (finite and abs(z_mean) < SAMPLER_SE and abs(z_var) < SAMPLER_SE and ks_p > SAMPLER_KS_P):
            raise AssertionError(f"sampler {name}: finite/positive {finite}, z {z_mean:.2f} / {z_var:.2f}, "
                                 f"KS p {ks_p:.2e}")
    expect_launches(ck, "samplers", {})
    return out


def gibbs_vgp_mean(agt, model, iters=GIBBS_VGP_ITERS):
    """The CAVI posterior mean of the dense VGP on the MCGP's data (the
    same kernel and likelihood, fixed hyperparameters)."""
    vgp = agt.VGP.create(model.train_x, model.train_y, agt.SqExponentialKernel(lengthscale=2.0),
                         agt.LogisticLikelihood.create(), agt.AnalyticVI(), optimiser=None)
    _, state = agt.train(vgp, iterations=iters)
    return state.mu[0]


def gibbs_path(agt, ck, device, solver, dtype=torch.float32, vgp_mu=None):
    """The bench's Gibbs row with ``solver`` (phase 24, or ``gibbs-cpu``):
    chain-sweeps/s, host reads and trips a sweep, the draws' share of a
    sweep, peak device memory, whether every sample is finite, and the
    posterior mean's sign agreement with the labels and correlation with
    the CAVI VGP's mean (``vgp_mu``)."""
    from agp_tpu_torch import bench
    from agp_tpu_torch.inference import gibbs
    from agp_tpu_torch.means import batch_call
    from agp_tpu_torch.models import mcgp
    from agp_tpu_torch.utils.tensors import host_read, run_trips

    model = bench.gibbs_workload(device, solver, dtype=dtype)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        reset_launches(ck)
        sync(device)
        torch.cuda.reset_peak_memory_stats()
    reads, trips, cg_its = host_read.reads, run_trips.trips, gibbs._global_resample_cg.iterations
    rate, s = bench.gibbs_rate(model, GIBBS_SAMPLES, GIBBS_CHAINS)
    sweeps = GIBBS_SAMPLES + model.inference.n_burnin + 10  # timed, and the warm-up call's
    out = {"rate": rate, "reads": (host_read.reads - reads) / sweeps, "trips": (run_trips.trips - trips) / sweeps,
           "cg_iterations": (gibbs._global_resample_cg.iterations - cg_its) / sweeps}
    if cuda:
        expect_launches(ck, f"gibbs {solver}", {})
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["finite"] = bool(torch.isfinite(s).all())
    out["chain_means"] = s.mean(1)[:, 0]
    mean = s.mean((0, 1))[0]
    out["sign"] = float((torch.sign(mean) == model.train_y).double().mean())
    if vgp_mu is not None:
        out["corr"] = float(np.corrcoef(mean.double().cpu().numpy(), vgp_mu.double().cpu().numpy())[0, 1])
    # the draws' share of a sweep: SHARE_SWEEPS sweeps, then their draws alone
    kmat = mcgp.gibbs_setup(model)
    mu0 = batch_call(model.mean, model.train_x, 1)
    lik, y = model.likelihood, model.train_y
    local = lik.init_local_vars(y.shape[0], dtype, model.train_x.device)
    f = s[:, -1]
    g = torch.Generator(device=model.train_x.device).manual_seed(3)
    timed = {}
    for what in ("sweep", "draws"):
        sync(device)
        t0 = time.perf_counter()
        for _ in range(SHARE_SWEEPS):
            if what == "sweep":
                gibbs.gibbs_step(model, kmat, mu0, g, f, local)
            else:
                lik.sample_local(g, y, f, local)
        sync(device)
        timed[what] = (time.perf_counter() - t0) / SHARE_SWEEPS * 1e3
    out["sweep_ms"], out["draws_ms"] = timed["sweep"], timed["draws"]
    return out


SHARE_SWEEPS = 20


def log_gibbs(solver, r, where):
    corr = f", correlation with the CAVI VGP's mean {r['corr']:.5f}" if "corr" in r else ""
    memory = f"; peak device memory {r['peak_gib']:.3f} GiB; 0 kernel launches" if "peak_gib" in r else ""
    log(f"gibbs {solver} on {where} (N=2048, D=8, {GIBBS_CHAINS} chains, 50 burn-in sweeps, {GIBBS_SAMPLES} samples): "
        f"{r['rate']:.2f} chain-sweeps/s; every sample finite: {r['finite']}; sign agreement with the labels "
        f"{r['sign']:.5f}{corr}; {r['reads']:.2f} host reads, {r['trips']:.2f} rejection trips and "
        f"{r['cg_iterations']:.2f} CG iterations a sweep; {1e3 * GIBBS_CHAINS / r['rate']:.3f} ms a sweep in the timed "
        f"call; again from the last samples, a sweep {r['sweep_ms']:.3f} ms, its draws alone {r['draws_ms']:.3f} ms "
        f"(share {r['draws_ms'] / r['sweep_ms']:.3f}){memory}")


def phase_gibbs(agt, ck, device):
    """Phase 24: the Gibbs row with each solver.  A solver whose samples
    are not all finite is printed as a finding (no fallback hides it); the
    floors hold the finite ones."""
    from agp_tpu_torch import bench

    vgp_mu = gibbs_vgp_mean(agt, bench.gibbs_workload(device, "cg"))
    out = {}
    for solver in GIBBS_SOLVERS:
        r = gibbs_path(agt, ck, device, solver, vgp_mu=vgp_mu)
        log_gibbs(solver, r, "the card")
        out[solver] = r
        if not r["finite"]:
            log(f"FINDING: gibbs {solver}: non-finite samples in float32 at N=2048 (no fallback is taken)")
            continue
        if not (r["sign"] >= GIBBS_FLOORS["sign"] and r["corr"] >= GIBBS_FLOORS["corr"]):
            raise AssertionError(f"gibbs {solver}: sign agreement {r['sign']:.5f} (floor {GIBBS_FLOORS['sign']}), "
                                 f"correlation {r['corr']:.5f} (floor {GIBBS_FLOORS['corr']})")
    if not out["cg"]["finite"]:
        raise AssertionError("gibbs cg: non-finite samples (the bench's row)")
    GIBBS_ROW["cg"] = out["cg"].pop("chain_means")
    return out


def gibbs_cpu_mode(agt):
    """``python3 chip_smoke.py gibbs-cpu``: the Gibbs row's shape with each
    solver in float64 on the host's CPU, the source of GIBBS_FLOORS (no
    floors held)."""
    from agp_tpu_torch import bench

    torch.set_default_dtype(torch.float64)
    mu = gibbs_vgp_mean(agt, bench.gibbs_workload("cpu", "cg", dtype=torch.float64))
    for solver in GIBBS_SOLVERS:
        log_gibbs(solver, gibbs_path(agt, None, "cpu", solver, dtype=torch.float64, vgp_mu=mu), "the CPU, float64")


def grand_tour_data(device, dtype=torch.float32):
    """examples/grand_tour.py's data: X ~ U[-2, 2]^2 (120 points),
    f = sin(2 x_0) + 0.5 x_1, 0/1 labels f > 0; its sampling flow takes the
    first 40."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(120, 2))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    return torch.as_tensor(X, dtype=dtype, device=device), (f > 0).astype(int)


def conjugate_data(device, n=30, seed=0):
    """X ~ U[0, 1]^2, f a draw of the unit squared-exponential GP,
    y = f + sqrt(CONJ_NOISE) eps, and the exact posterior mean with the
    prior's float32 jitter (float64 on the host)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=(n, 2))
    K = np.exp(-0.5 * ((X[:, None] - X[None]) ** 2).sum(-1))
    f = np.linalg.cholesky(K + 1e-6 * np.eye(n)) @ rng.normal(size=n)
    y = f + np.sqrt(CONJ_NOISE) * rng.normal(size=n)
    Kj = K + 1e-3 * np.eye(n)
    mean = Kj @ np.linalg.solve(Kj + CONJ_NOISE * np.eye(n), y)
    return (torch.as_tensor(X, dtype=torch.float32, device=device), torch.as_tensor(y, dtype=torch.float32, device=device),
            mean)


def sampler_data(device, n=None):
    """The Gibbs row's data rule at N=n (SAMPLER_N by default): X ~ N(0, 1)
    in 8-D, y = sign(x_0 + 0.5 x_1)."""
    n = SAMPLER_N if n is None else n
    rng = np.random.default_rng(6)
    X = torch.as_tensor(rng.normal(size=(n, 8)), dtype=torch.float32, device=device)
    return X, torch.sign(X[:, 0] + 0.5 * X[:, 1])


def phase_hmc(agt, ck, device):
    """Phase 25: the grand tour's sampling flow on the card (Gibbs, SMC,
    HMC, NUTS, and SVGD on the same model: every sample finite); NUTS and
    HMC on the conjugate Gaussian posterior (corr > CONJ_CORR with the
    exact mean); each sampler's ms a sample at N=SAMPLER_N."""
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    X, yb = grand_tour_data(device)
    reset_launches(ck)
    mg = agt.MCGP.create(X[:40], yb[:40], agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                         agt.GibbsSampling(n_burnin=50))
    runs = {"gibbs": agt.sample(mg, 100, generator=gen(0))}
    runs["smc"], log_z = agt.smc_sample(mg, n_particles=64, n_temps=8, generator=gen(1))
    runs["hmc"] = agt.sample_hmc(mg, 80, generator=gen(2))
    mn = agt.MCGP.create(X[:40], yb[:40], agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                         agt.HMCSampling(n_burnin=60))
    runs["nuts"] = agt.sample(mn, 80, generator=gen(3))
    runs["svgd"] = agt.svgd_sample(mg, n_particles=64, n_steps=100, generator=gen(4))
    labels = torch.as_tensor(2.0 * yb[:40] - 1.0, dtype=torch.float32, device=device)
    signs = {k: float((torch.sign(v.mean(0)[0]) == labels).double().mean()) for k, v in runs.items()}
    finite = {k: bool(torch.isfinite(v).all()) for k, v in runs.items()}
    log(f"grand tour sampling (N=40 logistic, card, {time.perf_counter() - t0:.2f} s): every sample finite {finite}, "
        f"log Z {float(log_z):.4f}; sign agreement of each posterior mean with the labels {signs}")
    t0 = time.perf_counter()
    if not (all(finite.values()) and np.isfinite(float(log_z))):
        raise AssertionError(f"grand tour sampling: finite {finite}, log Z {float(log_z)}")

    Xc, yc, exact = conjugate_data(device)
    corrs = {}
    for algorithm, (burnin, n, chains) in (("nuts", (20, 4, 128)), ("hmc", (60, 20, 32))):
        m = agt.MCGP.create(Xc, yc, agt.SqExponentialKernel(), agt.GaussianLikelihood.create(CONJ_NOISE),
                            agt.HMCSampling(n_burnin=burnin, step_size=0.1, algorithm=algorithm))
        s = agt.sample(m, n, generator=gen(5), n_chains=chains)
        corrs[algorithm] = float(np.corrcoef(s.reshape(-1, 30).double().mean(0).cpu().numpy(), exact)[0, 1])
    log(f"conjugate Gaussian (N=30, noise {CONJ_NOISE}, card, {time.perf_counter() - t0:.2f} s): posterior-mean "
        f"correlation with the exact mean {corrs}")
    if not min(corrs.values()) > CONJ_CORR:
        raise AssertionError(f"conjugate Gaussian: correlations {corrs} not above {CONJ_CORR}")

    from agp_tpu_torch.utils.tensors import host_read

    Xs, ys = sampler_data(device)
    timings, reads = {}, {}

    def timed(label, fn, per):
        sync(device)
        t0, r0 = time.perf_counter(), host_read.reads
        out = fn()
        sync(device)
        timings[label] = (time.perf_counter() - t0) * 1e3 / per
        reads[label] = (host_read.reads - r0) / per
        if not bool(torch.isfinite(out[0] if isinstance(out, tuple) else out).all()):
            raise AssertionError(f"{label} at N={SAMPLER_N}: non-finite samples")

    for solver in GIBBS_SOLVERS:
        m = agt.MCGP.create(Xs, ys, agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create(),
                            agt.GibbsSampling(n_burnin=5, solver=solver))
        agt.sample(m, 2, generator=gen(6), n_chains=4)  # warm-up
        timed(f"gibbs {solver} (4 chains, a chain-sweep)", lambda: agt.sample(m, 20, generator=gen(7), n_chains=4),
              25 * 4)
    for algorithm, steps in (("hmc", 20), ("nuts", 10)):
        m = agt.MCGP.create(Xs, ys, agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create(),
                            agt.HMCSampling(n_burnin=5, algorithm=algorithm))
        timed(f"{algorithm} (4 chains, a chain-step)", lambda: agt.sample(m, steps, generator=gen(8), n_chains=4),
              (steps + 5) * 4)
    m = agt.MCGP.create(Xs, ys, agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create())
    timed("smc (256 particles, 20 temperatures, a particle)", lambda: agt.smc_sample(m, generator=gen(9)), 256)
    timed("svgd (128 particles, 100 steps, a particle)",
          lambda: agt.svgd_sample(m, n_steps=100, generator=gen(10)), 128)
    expect_launches(ck, "samplers' paths", {})
    log(f"ms a sample at N={SAMPLER_N} (card), and host reads a sample: " +
        "; ".join(f"{k} {v:.3f} ms, {reads[k]:.3f} reads" for k, v in timings.items()))
    return {"signs": signs, "corrs": corrs, "ms": timings, "reads": reads}


def parity_err(card, cpu32, cpu64):
    """(|card - cpu32|, |cpu32 - cpu64|), each over cpu64's largest entry."""
    scale = float(cpu64.abs().max())
    return (float((card.double().cpu() - cpu32.double()).abs().max()) / scale,
            float((cpu32.double() - cpu64).abs().max()) / scale)


def phase_sampler_parity(agt, device):
    """Phase 26: the fed-noise global resample (both solvers; N=SAMPLER_N,
    2 chains, omega from a float64 PG draw), 16 leapfrog steps and 50 SVGD
    steps from a fed v0, each on the card (float32) against the CPU
    (float32), within SAMPLER_PARITY_FACTOR times the CPU float32's own
    error against float64."""
    from agp_tpu_torch.inference import gibbs, hmc, svgd
    from agp_tpu_torch.means import batch_call
    from agp_tpu_torch.models import mcgp

    from agp_tpu_torch.distributions.polyagamma import sample_pg1

    rng = np.random.default_rng(11)
    Xs, ys = sampler_data("cpu")
    arms = {"card": (torch.float32, device), "cpu32": (torch.float32, "cpu"), "cpu64": (torch.float64, "cpu")}
    models = {k: agt.MCGP.create(Xs.to(dtype=dt, device=dev), ys.to(dtype=dt, device=dev),
                                 agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create())
              for k, (dt, dev) in arms.items()}
    N = SAMPLER_N
    omega = sample_pg1(torch.Generator().manual_seed(0), torch.full((2, N), 1.0, dtype=torch.float64))
    fed = {k: torch.as_tensor(rng.normal(size=(2, 1, N))) for k in ("v0", "eps", "xi1", "xi2")}
    fed["particles"] = torch.as_tensor(rng.normal(size=(32, 1, N)))
    outs, errs = {}, {}
    for k, (dt, dev) in arms.items():
        m = models[k]
        kmat = mcgp.gibbs_setup(m)
        mu0 = batch_call(m.mean, m.train_x, 1)

        def to(t):
            return t.to(dtype=dt, device=dev)

        gs = to(omega[:, None] / 2.0)
        gmu = to(0.5 * ys.double().expand(2, 1, N))
        outs[k] = {
            "resample chol": gibbs._global_resample_chol(gmu, gs, kmat["K_inv"], mu0, to(fed["eps"])),
            "resample cg": gibbs._global_resample_cg(gmu, gs, kmat["K_inv"], kmat["L_K"], mu0, to(fed["xi1"]),
                                                     to(fed["xi2"])),
        }
        vg = hmc.value_and_grad(hmc.make_log_joint(m, kmat["L_K"], mu0))
        v0 = to(fed["v0"]) * 0.5
        _, g0 = vg(v0)
        outs[k]["leapfrog"] = hmc.leapfrog(vg, v0, to(fed["eps"]), g0, 0.05, 16)[0]
        outs[k]["svgd"] = svgd._svgd_run(m, to(fed["particles"]), 50, 0.05)
    for name in outs["card"]:
        errs[name] = parity_err(outs["card"][name], outs["cpu32"][name], outs["cpu64"][name])
    log("sampler parity (card float32 against CPU float32, and the CPU float32's own error against float64): " +
        "; ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in errs.items()))
    bad = {k: v for k, v in errs.items() if not v[0] <= max(SAMPLER_PARITY_FACTOR * v[1], 1e-6)}
    if bad:
        raise AssertionError(f"sampler parity beyond {SAMPLER_PARITY_FACTOR}x the CPU's own float32 error: {bad}")
    return errs


def profile_gibbs(agt, device):
    """``python3 chip_smoke.py profile gibbs``: torch.profiler over
    SHARE_SWEEPS sweeps of the Gibbs row (4 chains) with each solver:
    wall and device-busy time a sweep, the idle share, the device ops a
    sweep and the largest of them."""
    from torch.profiler import ProfilerActivity, profile

    from agp_tpu_torch import bench
    from agp_tpu_torch.inference import gibbs
    from agp_tpu_torch.means import batch_call
    from agp_tpu_torch.models import mcgp

    for solver in GIBBS_SOLVERS:
        model = bench.gibbs_workload(device, solver)
        kmat = mcgp.gibbs_setup(model)
        mu0 = batch_call(model.mean, model.train_x, 1)
        local = model.likelihood.init_local_vars(model.train_x.shape[0], torch.float32, device)
        g = torch.Generator(device=device).manual_seed(0)
        f = torch.zeros((GIBBS_CHAINS, 1, model.train_x.shape[0]), device=device)
        for _ in range(10):
            f, local = gibbs.gibbs_step(model, kmat, mu0, g, f, local)
        sync(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(SHARE_SWEEPS):
                f, local = gibbs.gibbs_step(model, kmat, mu0, g, f, local)
            sync(device)
            wall_us = (time.perf_counter() - t0) / SHARE_SWEEPS * 1e6
        n = SHARE_SWEEPS
        rows = sorted(((e.self_device_time_total / n, e.count / n, e.key) for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0), reverse=True)
        busy = sum(r[0] for r in rows)
        log(f"profile gibbs {solver} (N=2048, {GIBBS_CHAINS} chains): wall {wall_us:.1f} us/sweep, device busy "
            f"{busy:.1f} us/sweep, idle share {1 - busy / wall_us:.4f}, {sum(r[1] for r in rows):.1f} device ops/sweep")
        for us, count, key in rows[:10]:
            log(f"  device {us:10.1f} us/sweep  x{count:.1f}  {key[:90]}")


def samplers_mode(agt, ck, device):
    """``python3 chip_smoke.py samplers``: phases 23-26 alone."""
    timed_phase("samplers", phase_samplers, agt, ck, device)
    timed_phase("gibbs", phase_gibbs, agt, ck, device)
    timed_phase("hmc nuts smc svgd", phase_hmc, agt, ck, device)
    timed_phase("sampler parity", phase_sampler_parity, agt, device)


# ----------------------------------------------- Slice I: the online model
# phase 27: bench.py:241-285's streaming row (agp_tpu_torch.bench's
# online_workload): OnlineSVGP + RBF + GaussianLikelihood(0.05) fixed, OIPS
# (rho 0.8), 128 slots, no hyperparameter learning, X uniform on [-2, 2]^2,
# 8 batches of 256 points, 20 CAVI iterations each
ONLINE_B, ONLINE_BATCHES, ONLINE_ITERS = 256, 8, 20
# phase 29: a wide stream, 512 slots in 8-D, batches of 2,048
WIDE_CAP, WIDE_D, WIDE_B = 512, 8, 2048
# floors from ``python3 chip_smoke.py online-cpu`` (the same paths in float64
# on a CPU): RMSE of predict_f against f over the 2,048 streamed rows
# oips 0.02960, adam 0.02143, unigrid 0.01033, webscale 0.01179,
# streamkmeans 0.01249; the logistic path's accuracy 0.96240; each RMSE
# floor ~1.5-2.5x the float64 run's (the verify skill's oracle: < 0.1), the
# accuracy's 0.03 under it; the wide path holds finite values and parity
ONLINE_FLOORS = {"oips": {"rmse": 0.045}, "adam": {"rmse": 0.035}, "logistic": {"acc": 0.93},
                 "unigrid": {"rmse": 0.025}, "webscale": {"rmse": 0.025}, "streamkmeans": {"rmse": 0.025},
                 "wide": {}}
# card (float32) against CPU (float32), within this many times the CPU
# float32's own error against float64 (phase 26's rule)
ONLINE_PARITY_FACTOR = 10.0
# the online paths: likelihood, selection algorithm (None: OIPS), optimiser
ONLINE_PATHS = {
    "oips": ("gaussian", None, None),
    "adam": ("gaussian", None, "default"),
    "logistic": ("logistic", None, None),
    "unigrid": ("gaussian", ("UniGridOnline", 8), None),
    "webscale": ("gaussian", ("Webscale", 64), None),
    "streamkmeans": ("gaussian", ("StreamKmeans", 128, 0.25), None),
    "wide": ("gaussian", None, None),
}


def online_data(name, device, dtype):
    """(X, f, labels) of an online path: the bench's streaming data (D=2,
    8 x 256 rows), or for "wide" X uniform on [-2, 2]^8 (8 x 2,048 rows)
    with the same rule; the logistic path's labels the sign of f."""
    from agp_tpu_torch import bench

    if name == "wide":
        rng = np.random.default_rng(8)
        n = ONLINE_BATCHES * WIDE_B
        X = rng.uniform(-2.0, 2.0, size=(n, WIDE_D))
        f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
        y = f + 0.05 * rng.normal(size=n)
        X, f, y = (torch.as_tensor(a, dtype=dtype, device=device) for a in (X, f, y))
    else:
        X, f, y = bench.online_data(device, dtype=dtype)
    return X, f, (torch.sign(f) if name == "logistic" else y)


def online_model(agt, name, device, dtype):
    lik, alg, optimiser = ONLINE_PATHS[name]
    likelihood = agt.GaussianLikelihood.create(0.05) if lik == "gaussian" else agt.LogisticLikelihood.create()
    zalg = None if alg is None else getattr(agt.inducing, alg[0])(*alg[1:])
    wide = name == "wide"
    return agt.OnlineSVGP.create(agt.SqExponentialKernel(), likelihood, agt.AnalyticVI(), Zalg=zalg,
                                 n_dim=WIDE_D if wide else 2, capacity=WIDE_CAP if wide else 128,
                                 optimiser=optimiser, dtype=dtype, device=device)


def online_run(agt, name, device, dtype=torch.float32):
    """An online path streamed batch by batch through online_train from a
    fresh model: {"model", "state", "rmse" (predict_f against f over the
    streamed rows), "active", "max_count", "moved" (the log-hyperparameters'
    largest move), "acc" (logistic), "elbo" (online_elbo on the last
    batch), "seconds"}."""
    X, f, y = online_data(name, device, dtype)
    b = WIDE_B if name == "wide" else ONLINE_B
    model = online_model(agt, name, device, dtype)
    log0 = log_hypers(model)
    state = None
    sync(device)
    t0 = time.perf_counter()
    for i in range(ONLINE_BATCHES):
        model, state = agt.online_train(model, X[i * b:(i + 1) * b], y[i * b:(i + 1) * b], state=state,
                                        iterations=ONLINE_ITERS)
    sync(device)
    seconds = time.perf_counter() - t0
    n = ONLINE_BATCHES * b
    mu = agt.predict_f(model, state, X[:n], chunk_size=4096)
    out = {"model": model, "state": state, "seconds": seconds,
           "rmse": float(torch.sqrt(torch.mean((mu.double() - f[:n].double()) ** 2))),
           "active": int(model.z_mask[0].sum()), "max_count": float(model.z_counts[0].max()),
           "moved": float((log_hypers(model) - log0).abs().max()),
           "elbo": float(agt.online_elbo(model, state, X[n - b:n], y[n - b:n]))}
    if name == "logistic":
        out["acc"] = float((agt.predict_y(model, state, X[:n]) == y[:n]).double().mean())
    return out


def online_parity(agt, name, card):
    """mu's and Sigma's card-vs-CPU errors after the whole stream:
    {name: (|card - cpu32|, |cpu32 - cpu64|)} over cpu64's largest entry,
    and the CPU float32 run's active count."""
    cpu32 = online_run(agt, name, "cpu", torch.float32)
    cpu64 = online_run(agt, name, "cpu", torch.float64)
    errs = {k: parity_err(getattr(card["state"], k), getattr(cpu32["state"], k), getattr(cpu64["state"], k))
            for k in ("mu", "Sigma")}
    log(f"online {name} parity (card float32 against CPU float32, and the CPU float32's own error against "
        f"float64): " + "; ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in errs.items()) +
        f"; active slots card {card['active']}, CPU float32 {cpu32['active']}, float64 {cpu64['active']}")
    bad = {k: v for k, v in errs.items() if not v[0] <= max(ONLINE_PARITY_FACTOR * v[1], 1e-6)}
    if bad:
        raise AssertionError(f"online {name}: parity beyond {ONLINE_PARITY_FACTOR}x the CPU's own float32 error: "
                             f"{bad}")
    if card["active"] != cpu32["active"]:
        raise AssertionError(f"online {name}: {card['active']} active slots on the card, {cpu32['active']} on the CPU")
    return errs


def check_online(name, r):
    """The floors of an online path (ONLINE_FLOORS) and its invariants."""
    state, floors = r["state"], ONLINE_FLOORS[name]
    finite = all(bool(torch.isfinite(t).all()) for t in (state.mu, state.Sigma)) and np.isfinite(r["elbo"])
    if not finite:
        raise AssertionError(f"online {name}: non-finite posterior or ELBO")
    if "rmse" in floors and not r["rmse"] <= floors["rmse"]:
        raise AssertionError(f"online {name}: RMSE {r['rmse']:.5f} > {floors['rmse']}")
    if "acc" in floors and not r["acc"] >= floors["acc"]:
        raise AssertionError(f"online {name}: accuracy {r['acc']:.5f} < {floors['acc']}")
    if name == "adam" and not r["moved"] > MIN_HYPER_MOVE:
        raise AssertionError(f"online adam: the log-hyperparameters moved by {r['moved']:.3e} <= {MIN_HYPER_MOVE}")
    want = {"unigrid": r["active"] == 64, "webscale": r["active"] == 64 and r["max_count"] > 1,
            "streamkmeans": 0 < r["active"] <= 128}.get(name, True)
    if not want:
        raise AssertionError(f"online {name}: {r['active']} active slots, largest count {r['max_count']}")


def log_online(name, r, where="the card"):
    extra = f", accuracy {r['acc']:.5f}" if "acc" in r else ""
    log(f"online {name} on {where} ({ONLINE_BATCHES} batches, {ONLINE_ITERS} iterations each): RMSE "
        f"{r['rmse']:.5f}{extra}, {r['active']} active slots (largest count {r['max_count']:.0f}), "
        f"log-hyperparameters moved {r['moved']:.4f}, online_elbo {r['elbo']:.4f}, {r['seconds']:.3f} s")


def online_batch_split(model, state, X, y, b):
    """Batches 1 .. ONLINE_BATCHES-1 after ``state``, taken apart as
    online_train runs them (optimiser None): ms a batch in save-old, the
    inducing update (the selection), the rest of the prologue (the masked
    kernel matrices, fresh local variables) and the CAVI iterations, each
    ending in a synchronize; and the host reads a batch."""
    from agp_tpu_torch.models import online_svgp as on
    from agp_tpu_torch.utils.tensors import host_read

    device = X.device
    times = {"save-old": 0.0, "selection": 0.0, "kmat and locals": 0.0, "CAVI iterations": 0.0}
    reads = host_read.reads
    for i in range(1, ONLINE_BATCHES):
        xb, yb = X[i * b:(i + 1) * b], y[i * b:(i + 1) * b]
        sync(device)
        t0 = time.perf_counter()
        model, state = on.save_old_parameters(model, state)
        sync(device)
        t1 = time.perf_counter()
        model = on.update_Z(model, xb)
        sync(device)
        t2 = time.perf_counter()
        state = state.replace(kmat=on.masked_kmat(model),
                              local_vars=model.likelihood.init_local_vars(b, xb.dtype, device))
        sync(device)
        t3 = time.perf_counter()
        for _ in range(ONLINE_ITERS):
            model, state = on.online_variational_update(model, state, xb, yb)
        sync(device)
        t4 = time.perf_counter()
        for k, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            times[k] += dt * 1e3 / (ONLINE_BATCHES - 1)
    return times, (host_read.reads - reads) / (ONLINE_BATCHES - 1)


def phase_online(agt, ck, device):
    """Phase 27: the bench's streaming row on the card.  The first batch
    takes the port's C++ OIPS (its library built, its call counted), which
    selects exactly what the numpy selection does; the stream per batch
    with no kernel launch, its RMSE floor, the CPU's active count, card-vs-
    CPU parity; the stream driver bit-equal to the per-batch one; the two
    bench rows' points/s, ms a batch by part, host reads a batch, peak
    memory."""
    from agp_tpu_torch import bench
    from agp_tpu_torch.inducing import algorithms
    from agp_tpu_torch.kernels import latent
    from agp_tpu_torch.utils import native

    if not native.available():
        raise AssertionError(f"the port's host library did not build ({native.library_path()})")
    calls = native.oips.calls
    reset_launches(ck)
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    r = online_run(agt, "oips", device)
    expect_launches(ck, "online oips", {})
    peak = torch.cuda.max_memory_allocated() / 2**20
    if native.oips.calls != calls + 1:
        raise AssertionError(f"online oips: the native OIPS ran {native.oips.calls - calls} times, not once")
    X, _, y = online_data("oips", device, torch.float32)
    k0 = latent(r["model"].kernel, 0)
    available, native.available = native.available, lambda: False  # the numpy selection
    try:
        Z_numpy = algorithms.OIPS(0.8, 128)(X[:ONLINE_B].double().cpu(), kernel=k0.to(dtype=torch.float64))
    finally:
        native.available = available
    Z_native = algorithms.OIPS(0.8, 128)(X[:ONLINE_B].cpu(), kernel=k0)
    if not torch.equal(Z_native.double(), Z_numpy.to(Z_native.device)):
        raise AssertionError("online oips: the native OIPS's first selection differs from the numpy one")
    log(f"online oips: the first batch took the native OIPS ({native.library_path()}), {Z_native.shape[0]} points, "
        f"equal to the numpy selection; {r['active']} active slots after {ONLINE_BATCHES} batches; peak device "
        f"memory {peak:.1f} MiB; 0 kernel launches")
    log_online("oips", r)
    check_online("oips", r)
    parity = online_parity(agt, "oips", r)
    # the drivers from the state after the first batch: bit-equal, then the bench's rows
    m1, s1, Xw, yw = bench.online_workload(device)
    Xs = Xw[: ONLINE_BATCHES * ONLINE_B].reshape(ONLINE_BATCHES, ONLINE_B, 2)
    ys = yw[: ONLINE_BATCHES * ONLINE_B].reshape(ONLINE_BATCHES, ONLINE_B)
    ma, sa = m1, s1
    for i in range(1, ONLINE_BATCHES):
        ma, sa = agt.online_train(ma, Xs[i], ys[i], state=sa, iterations=ONLINE_ITERS)
    mb, sb = agt.online_train_stream(m1, Xs[1:], ys[1:], state=s1, iterations=ONLINE_ITERS)
    same = all(torch.equal(getattr(sa, k), getattr(sb, k)) for k in ("eta1", "eta2", "mu", "Sigma"))
    if not (same and torch.equal(ma.z_mask, mb.z_mask) and torch.equal(ma.Z, mb.Z)):
        raise AssertionError("online: online_train_stream differs from online_train batch by batch on the card")
    reset_launches(ck)
    rates = {stream: bench.online_rate(m1, s1, Xw, yw, stream=stream)[0] for stream in (False, True)}
    split, reads = online_batch_split(m1, s1, Xw, yw, ONLINE_B)
    expect_launches(ck, "online drivers", {})
    total = sum(split.values())
    log(f"online drivers: online_train_stream bit-equal to online_train batch by batch (batches 2-8); the bench's "
        f"rows: online_stream_b256_cap128_pts_per_s {rates[False]:.1f}, online_stream_fused_b256_cap128_pts_per_s "
        f"{rates[True]:.1f}; a batch {total:.3f} ms: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) +
        f"; {reads:.2f} host reads a batch, 0 kernel launches")
    return {"rates": rates, "split": split, "reads": reads, "parity": parity, "rmse": r["rmse"], "peak_mib": peak}


def phase_online_paths(agt, ck, device):
    """Phase 28: the other streaming paths at phase 27's shape, each with no
    kernel launch, its floors and invariants: (a) the default Adam(0.01)
    every iteration (log-hyperparameters moved, card-vs-CPU parity), (b)
    the logistic likelihood on sign(f), (c) UniGridOnline(8), Webscale(64),
    StreamKmeans(128, radius2 0.25)."""
    out = {}
    for name in ("adam", "logistic", "unigrid", "webscale", "streamkmeans"):
        reset_launches(ck)
        r = online_run(agt, name, device)
        expect_launches(ck, f"online {name}", {})
        log_online(name, r)
        check_online(name, r)
        out[name] = r
    online_parity(agt, "adam", out["adam"])
    return out


def time_warm_moments(device, reps=50):
    """nat_to_moments_warm_batched (both branches) against the exact
    nat_to_moments_safe at [1, 128, 128] and [1, 512, 512], ms a call by
    the host clock over ``reps`` calls ending in a synchronize (the warm
    one reads its predicate on the host every call)."""
    from agp_tpu_torch.ops import linalg

    out = {}
    for m in (128, 512):
        g = torch.Generator(device=device).manual_seed(m)
        G = torch.randn(1, m, m, generator=g, device=device)
        A = G @ G.mT / m + torch.eye(m, device=device)
        eta2, eta1 = -0.5 * A, torch.randn(1, m, generator=g, device=device)
        Sigma = torch.linalg.inv(A)
        starts = {"schulz": Sigma * (1 + 1e-4), "cholesky": 3.0 * Sigma}
        calls = {"exact": lambda: linalg.nat_to_moments_safe(eta1, eta2)}
        calls.update({f"warm {k}": (lambda s=s: linalg.nat_to_moments_warm_batched(eta1, eta2, s))
                      for k, s in starts.items()})
        for name, fn in calls.items():
            fn()
            sync(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync(device)
            out[f"{name} M={m}"] = (time.perf_counter() - t0) * 1e3 / reps
    log("eta -> moments, ms a call (host clock, [1, M, M]): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def phase_online_wide(agt, ck, device):
    """Phase 29: a wide stream (512 slots, D=8, batches of 2,048, Gaussian,
    optimiser None; OIPS fills the buffer): finite, card-vs-CPU parity,
    points/s and ms a batch logged; then the warm eta -> moments
    conversions against the exact one."""
    reset_launches(ck)
    r = online_run(agt, "wide", device)
    expect_launches(ck, "online wide", {})
    log_online("wide", r)
    check_online("wide", r)
    log(f"online wide: {ONLINE_BATCHES * WIDE_B / r['seconds']:.1f} points/s, "
        f"{r['seconds'] * 1e3 / ONLINE_BATCHES:.3f} ms a batch (the first batch's selection included)")
    online_parity(agt, "wide", r)
    return r, time_warm_moments(device)


def online_mode(agt, ck, device):
    """``python3 chip_smoke.py online``: phases 27-29 alone."""
    timed_phase("online stream", phase_online, agt, ck, device)
    timed_phase("online paths", phase_online_paths, agt, ck, device)
    timed_phase("online wide", phase_online_wide, agt, ck, device)


def online_cpu_mode(agt):
    """``python3 chip_smoke.py online-cpu``: every online path in float64
    on the host's CPU, the source of ONLINE_FLOORS (no floors held)."""
    torch.set_num_threads(min(torch.get_num_threads(), 8))
    for name in ONLINE_PATHS:
        log_online(name, online_run(agt, name, "cpu", torch.float64), "the CPU, float64")


def profile_online(agt, device):
    """``python3 chip_smoke.py profile online``: torch.profiler over batches
    2-8 of phase 27's stream (online_train): wall and device-busy time a
    batch, the idle share, the device ops a batch and the largest of
    them."""
    from torch.profiler import ProfilerActivity, profile

    from agp_tpu_torch import bench

    m1, s1, X, y = bench.online_workload(device)
    bench.online_rate(m1, s1, X, y, warmup=1)
    n = ONLINE_BATCHES - 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m, s = m1, s1
        for i in range(1, ONLINE_BATCHES):
            m, s = agt.online_train(m, X[i * ONLINE_B:(i + 1) * ONLINE_B], y[i * ONLINE_B:(i + 1) * ONLINE_B],
                                    state=s, iterations=ONLINE_ITERS)
        sync(device)
        wall_us = (time.perf_counter() - t0) / n * 1e6
    rows = sorted(((e.self_device_time_total / n, e.count / n, e.key) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile online (B={ONLINE_B}, 128 slots, {ONLINE_ITERS} iterations a batch): wall {wall_us:.1f} us/batch, "
        f"device busy {busy:.1f} us/batch, idle share {1 - busy / wall_us:.4f}, "
        f"{sum(r[1] for r in rows):.1f} device ops/batch")
    for us, count, key in rows[:10]:
        log(f"  device {us:10.1f} us/batch  x{count:.1f}  {key[:90]}")


# ------------------------------------------- Slice F: numerical VI (30-33)
# path 30: the flagship's shape with QuadratureSVI(B, n_points=QUAD_POINTS)
# and sgd(NUM_LR, 0.9), the rate of tpu_acceptance.py:206-216 (the
# reference's default 1e-5 barely moves in 300 steps); path 30h the same
# with the default Adam(0.01) for NUM_HYPER_ITERS iterations
QUAD_POINTS, NUM_LR, NUM_HYPER_ITERS = 100, 1e-3, 100
# path 31: SoftMaxLikelihood(MK) at the bench's multiclass shape with
# MCIntegrationSVI(MB, n_mc=MC_DRAWS), sgd(NUM_LR, 0.9)
MC_DRAWS = 200
NUM_TIMED_STEPS = 300
# path 32b: the Laplace septuple at the Laplace oracle's scale (its
# built-in twin is LaplaceLikelihood(0.1)); its mu within
# GENERIC_LAPLACE_TOL of the built-in's, as tests/test_engines.py holds it
LAPLACE_B, GENERIC_LAPLACE_TOL = 0.1, 2e-2
# path 32c: the Laplace-transform draws at LAP_LANES lanes on the card
# (KS against LAP_CPU_LANES CPU draws), tilts c^2 for c in LAP_CS; the
# MCGP on examples/custom_likelihood.py's data (N=400, 2-D)
LAP_LANES, LAP_CPU_LANES, LAP_CS = 2**20, 2**16, (0.5, 2.0)
LAP_MEAN_TOL = 0.01
GG_N, GG_BURNIN, GG_SAMPLES = 400, 100, 200
# path 33: tpu_acceptance.py's quadrature_vi_logistic_accuracy (VGP,
# N=400, n_points=30, sgd(1e-3, 0.9), 300 iterations, accuracy > 0.9) and
# tests/test_engines.py:633-648's Student-t VGP (N=30, n_points=20,
# Adam(0.05) on the kernel from lengthscale 3, 40 iterations, mean
# |mu - f| < 1)
QV_N, QV_POINTS, QV_ITERS, QV_ACC = 400, 30, 300, 0.9
TV_N, TV_POINTS, TV_ITERS, TV_MAE = 30, 20, 40, 1.0
# the floors of paths 30, 30h, 31 and 32c, from ``python3 chip_smoke.py
# numerical-cpu`` (the same paths in float64 on the card's host's CPU, CPU
# draws): training accuracy 0.89599, 0.96814 and 0.92168, the septuple
# MCGP's correlation with the built-in's Gibbs mean 0.99977.  Each
# accuracy floor allows three times the CPU's error (1 - accuracy), as
# ORACLE_FLOORS does; the correlation is held at 0.99, as the oracles'
# are.  Path 32a is held to the flagship's floor, path 32b to the Laplace
# oracle's (the CPU: RMSE 0.00507)
NUMERICAL_FLOORS = {"quad": ("acc", 0.69), "quad_hyper": ("acc", 0.9), "mc": ("acc", 0.76),
                    "gibbs": ("corr", 0.99)}


def quad_model(agt, X, b=B, optimiser=None):
    """Path 30: the flagship's SVGP with QuadratureSVI (the iid gather: the
    numerical engines have no minibatch_sampling)."""
    return agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0, variance=1.0), agt.LogisticLikelihood.create(),
                           agt.QuadratureSVI(b, n_points=QUAD_POINTS, optimiser=agt.sgd(NUM_LR, 0.9)), X[:M],
                           optimiser=optimiser)


def softmax_model(agt, X, b=MB):
    """Path 31: SoftMaxLikelihood(MK) with MCIntegrationSVI at the bench's
    multiclass shape."""
    return agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), agt.SoftMaxLikelihood.create(MK),
                           agt.MCIntegrationSVI(b, n_mc=MC_DRAWS, optimiser=agt.sgd(NUM_LR, 0.9)), X[:MM],
                           optimiser=None)


def logistic_septuple(agt):
    """sigma(y f) = 1/2 exp(y f / 2) sech(|f| / 2): C = 1/2, g = y/2,
    alpha = beta = 0, gamma = 1, phi(r) = sech(sqrt(r) / 2); omega is
    PG(1, 0) / 2."""
    return agt.make_augmented_likelihood(
        "SeptupleLogistic", "Classification", C=0.5, g=lambda y: y / 2.0, alpha=torch.zeros_like,
        beta=torch.zeros_like, gamma=torch.ones_like, phi=lambda r: 1.0 / torch.cosh(torch.sqrt(r) / 2.0)).create()


def laplace_septuple(agt, b=LAPLACE_B):
    """Laplace(b): C = 1/(2b), g = 0, alpha = y^2, beta = 2y, gamma = 1,
    phi(r) = exp(-sqrt(r) / b) (examples/custom_likelihood.py)."""
    return agt.make_augmented_likelihood(
        "SeptupleLaplace", "Regression", C=1.0 / (2.0 * b), g=torch.zeros_like, alpha=lambda y: y**2,
        beta=lambda y: 2.0 * y, gamma=torch.ones_like,
        phi=lambda r: torch.exp(-torch.sqrt(torch.clamp(r, min=1e-12)) / b)).create()


def septuple_model(agt, X, b=B):
    """Path 32a: the flagship's model with the logistic septuple."""
    return agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0, variance=1.0), logistic_septuple(agt),
                           agt.AnalyticSVI(b, minibatch_sampling="block"), X[:M], optimiser=None)


def finite_state(state):
    return bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())


def steady_rate(agt, model, state, X, y, gen, steps=NUM_TIMED_STEPS):
    """Steady iterations/s of ``steps`` steps after 30 (the card's clock,
    ending in a synchronize)."""
    from agp_tpu_torch.training.train import vi_steps

    y_t = model.likelihood.treat_labels(y)[0].to(X.dtype)
    model, state = vi_steps(model, state, X, y_t, 30, generator=gen)
    sync(X.device)
    t0 = time.perf_counter()
    vi_steps(model, state, X, y_t, steps, generator=gen)
    sync(X.device)
    return steps / (time.perf_counter() - t0)


def numerical_run(agt, ck, device, which, dtype=torch.float32):
    """Path 30 ("quad"), 30h ("quad_hyper"), 31 ("mc") or 32a ("septuple")
    through agp_tpu_torch.train from a fresh model: {"model", "state",
    "acc" (training accuracy), "seconds", "moved" (the log-hyperparameters'
    largest move), "launches" (on the card: checked against the route, 0
    elsewhere), "steps"} and for "mc" the largest |row sum - 1| of
    proba_y."""
    if which == "mc":
        X, y = mc_data(device)
    else:
        X, y = flagship_data(device)
    X = X.to(dtype)
    y = y if which == "mc" else y.to(dtype)
    steps, route, hyper = MAIN_STEPS, "single", 0
    if which == "quad_hyper":
        steps, hyper = NUM_HYPER_ITERS, NUM_HYPER_ITERS - 3
    if which == "mc":
        model, route = softmax_model(agt, X), "batched"
    elif which == "septuple":
        model = septuple_model(agt, X)
    else:
        model = quad_model(agt, X, optimiser="default" if which == "quad_hyper" else None)
    log0 = log_hypers(model)
    gen = torch.Generator(device=device).manual_seed(0)
    reset_launches(ck)
    sync(device)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=steps, generator=gen)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = 0
    if torch.device(device).type == "cuda":
        launches = expect_launches(ck, f"numerical {which}", route_launches(steps, route, hyper_steps=hyper))
    out = {"model": model, "state": state, "seconds": seconds, "steps": steps, "launches": launches,
           "moved": float((log_hypers(model) - log0).abs().max()), "gen": gen, "X": X, "y": y}
    out["acc"] = float((agt.predict_y(model, state, X) == y).double().mean())
    if which == "mc":
        p = agt.proba_y(model, state, X[:8192])
        out["proba_sum_err"] = float((p.double().sum(-1) - 1.0).abs().max())
    return out


def check_numerical(which, r):
    """A numerical path's floor (NUMERICAL_FLOORS; path 32a the flagship's),
    a finite posterior, moved hyperparameters on path 30h, proba_y's rows
    summing to 1 on path 31."""
    metric, floor = NUMERICAL_FLOORS.get(which, ("acc", MIN_FLAGSHIP_ACC))
    if not finite_state(r["state"]):
        raise AssertionError(f"numerical {which}: non-finite posterior")
    if not r[metric] >= floor:
        raise AssertionError(f"numerical {which}: {metric} {r[metric]:.5f} < {floor}")
    if which == "quad_hyper" and not r["moved"] > MIN_HYPER_MOVE:
        raise AssertionError(f"numerical quad_hyper: the log-hyperparameters moved by {r['moved']:.3e}")
    if which == "mc" and not r["proba_sum_err"] <= 1e-5:
        raise AssertionError(f"numerical mc: proba_y's rows sum to 1 within {r['proba_sum_err']:.3e}")


def log_numerical(which, r, where="the card"):
    timed = NUM_HYPER_ITERS if which == "quad_hyper" else NUM_TIMED_STEPS
    rate = f", steady {r['ips']:.1f} iterations/s over {timed} iterations" if "ips" in r else ""
    extra = f", proba_y rows sum to 1 within {r['proba_sum_err']:.2e}" if "proba_sum_err" in r else ""
    log(f"numerical {which} on {where}: {r['steps']} iterations through agp_tpu_torch.train in {r['seconds']:.3f} s, "
        f"{r['launches']} launches, training accuracy {r['acc']:.5f}, log-hyperparameters moved "
        f"{r['moved']:.4f}{extra}{rate}")


def phase_quadrature(agt, ck, device):
    """Phase 30: path 30 (one launch of kernel 6 and one of kernel 7 a
    step), its floor and steady rate; path 30h (kernel 6 once more a
    hyperparameter step), its floor, moved log-hyperparameters and steady
    rate (iterations with a hyperparameter step each)."""
    out = {}
    for which in ("quad", "quad_hyper"):
        r = numerical_run(agt, ck, device, which)
        check_numerical(which, r)
        if which == "quad":
            r["ips"] = steady_rate(agt, r["model"], r["state"], r["X"], r["y"], r["gen"])
        else:  # iterations with a hyperparameter step each (but the run's first three and last)
            t0 = time.perf_counter()
            agt.train(r["model"], r["X"], r["y"], iterations=NUM_HYPER_ITERS, state=r["state"], generator=r["gen"])
            sync(device)
            r["ips"] = NUM_HYPER_ITERS / (time.perf_counter() - t0)
        log_numerical(which, r)
        out[which] = {k: r[k] for k in ("acc", "seconds", "launches", "moved") + (("ips",) if "ips" in r else ())}
    return out


def phase_monte_carlo(agt, ck, device):
    """Phase 31: path 31 (one launch of kernel 4 and one of kernel 5 a
    step), its floor, proba_y's rows summing to 1, its steady rate."""
    r = numerical_run(agt, ck, device, "mc")
    check_numerical("mc", r)
    r["ips"] = steady_rate(agt, r["model"], r["state"], r["X"], r["y"], r["gen"])
    log_numerical("mc", r)
    return {k: r[k] for k in ("acc", "seconds", "launches", "ips", "proba_sum_err")}


def laplace_septuple_run(agt, ck, device, dtype=torch.float32):
    """Path 32b: the Laplace septuple and the built-in LaplaceLikelihood(0.1)
    at the Laplace oracle's configuration, OSTEPS slice steps each on the
    same draws: (septuple's RMSE, |d mu| / max |mu| against the built-in,
    the septuple's launches, seconds)."""
    X, y, truth = (t.to(dtype) for t in oracle_data("laplace", device))
    runs = {}
    for name, lik in (("septuple", laplace_septuple(agt)), ("builtin", agt.LaplaceLikelihood.create(LAPLACE_B))):
        model = agt.SVGP.create(agt.SqExponentialKernel(), lik, agt.AnalyticSVI(OB, minibatch_sampling="slice"),
                                X[:OM], optimiser=None)
        reset_launches(ck)
        sync(device)
        t0 = time.perf_counter()
        model, state = agt.train(model, X, y, iterations=OSTEPS, generator=torch.Generator(device=device).manual_seed(0))
        sync(device)
        seconds = time.perf_counter() - t0
        launches = 0
        if torch.device(device).type == "cuda":
            launches = expect_launches(ck, f"laplace {name}", route_launches(OSTEPS, "single" if name == "septuple"
                                                                              else "fused"))
        runs[name] = (model, state, launches, seconds)
    (ms, ss, launches, seconds), (_, sb, _, _) = runs["septuple"], runs["builtin"]
    if not finite_state(ss):
        raise AssertionError("septuple laplace: non-finite posterior")
    rmse = oracle_metric(agt, ms, ss, X, truth, "rmse")
    dmu = float((ss.mu - sb.mu).abs().max() / sb.mu.abs().max())
    return rmse, dmu, launches, seconds


def lap_moments(device, c, lanes, seed):
    """Draws of the logistic septuple's auxiliary tilted by s0 = c^2 (PG(1,
    c)/2) at ``lanes`` float32 lanes, and the grid's own tilted mean."""
    from agp_tpu_torch.distributions.lap_transf import LaplaceTransformDistribution, invert_laplace

    dist = LaplaceTransformDistribution(lambda r: 1.0 / torch.cosh(torch.sqrt(r) / 2.0))
    s0 = torch.full((lanes,), c * c, dtype=torch.float32, device=device)
    draws = dist.sample(torch.Generator(device=device).manual_seed(seed), s0)
    t = dist.grid(device=device)
    w = invert_laplace(dist.phi, t) * torch.gradient(t)[0] * torch.exp(-c * c * t)
    return draws, float(torch.sum(t * w) / torch.sum(w))


def septuple_gibbs(agt, device, dtype=torch.float32):
    """Path 32c's MCGP: the logistic septuple and the built-in logistic, each
    sampled by Gibbs (GG_BURNIN burn-in sweeps, GG_SAMPLES samples) on
    examples/custom_likelihood.py's data made with numpy (X ~ U[-2, 2]^2,
    f = sin(2 x_0) + 0.5 x_1, y = sign f): the septuple's samples finite,
    its posterior mean's sign agreement with y and correlation with the
    built-in's, host reads a sweep, seconds."""
    from agp_tpu_torch.utils.tensors import host_read

    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(GG_N, 2))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    X, y = torch.as_tensor(X, dtype=dtype, device=device), torch.as_tensor(np.sign(f), dtype=dtype, device=device)
    means, out = [], {}
    for name, lik in (("septuple", logistic_septuple(agt)), ("builtin", agt.LogisticLikelihood.create())):
        mc = agt.MCGP.create(X, y, agt.SqExponentialKernel(), lik, agt.GibbsSampling(n_burnin=GG_BURNIN))
        reads = host_read.reads
        sync(device)
        t0 = time.perf_counter()
        s = agt.sample(mc, GG_SAMPLES, generator=torch.Generator(device=device).manual_seed(1))
        sync(device)
        if name == "septuple":
            out.update(seconds=time.perf_counter() - t0, finite=bool(torch.isfinite(s).all()),
                       reads=(host_read.reads - reads) / (GG_BURNIN + GG_SAMPLES))
        means.append(s.double().mean(0)[0].cpu())
    out["sign"] = float((torch.sign(means[0]) == y.double().cpu()).double().mean())
    out["corr"] = float(torch.corrcoef(torch.stack(means))[0, 1])
    return out


def phase_generic(agt, ck, device):
    """Phase 32: (a) path 32a, the logistic septuple at the flagship's shape
    (kernels 6 and 7 a step), the flagship's floor; (b) the Laplace
    septuple at the Laplace oracle's configuration (kernels 6 and 7 a step)
    against the built-in (kernel 1 a step): mu within GENERIC_LAPLACE_TOL,
    the oracle's RMSE floor; (c) the Laplace-transform draws (PG(1, c)/2)
    at LAP_LANES lanes: mean within SAMPLER_SE standard errors of the
    grid's tilted mean and within LAP_MEAN_TOL of tanh(c/2)/(4c), a KS test
    against CPU draws; the septuple's MCGP by Gibbs against the built-in's;
    no kernel launch."""
    import scipy.stats as st

    r = numerical_run(agt, ck, device, "septuple")
    check_numerical("septuple", r)
    r["ips"] = steady_rate(agt, r["model"], r["state"], r["X"], r["y"], r["gen"])
    log_numerical("septuple", r)
    out = {"septuple": {k: r[k] for k in ("acc", "seconds", "launches", "ips")}}
    rmse, dmu, launches, seconds = laplace_septuple_run(agt, ck, device)
    floor = ORACLE_FLOORS["laplace/SqExponentialKernel"][1]
    log(f"septuple laplace (N={ON}, M={OM}, B={OB}, {OSTEPS} slice steps): RMSE {rmse:.5f} (floor {floor}), mu "
        f"against the built-in LaplaceLikelihood({LAPLACE_B}) {dmu:.3e} (bound {GENERIC_LAPLACE_TOL}), {launches} "
        f"launches, {seconds:.3f} s")
    if not (rmse <= floor and dmu <= GENERIC_LAPLACE_TOL):
        raise AssertionError(f"septuple laplace: RMSE {rmse:.5f} (floor {floor}), mu off the built-in's by {dmu:.3e}")
    out["laplace"] = {"rmse": rmse, "dmu": dmu, "launches": launches}
    reset_launches(ck)
    for i, c in enumerate(LAP_CS):
        t0 = time.perf_counter()
        draws, grid_mean = lap_moments(device, c, LAP_LANES, 10 + i)
        sync(device)
        seconds = time.perf_counter() - t0
        d = draws.double()
        z = (float(d.mean()) - grid_mean) / (float(d.std()) / np.sqrt(LAP_LANES))
        closed = np.tanh(c / 2) / (4 * c)
        cpu, _ = lap_moments("cpu", c, LAP_CPU_LANES, 20 + i)
        ks_p = float(st.ks_2samp(draws.cpu().numpy(), cpu.numpy()).pvalue)
        log(f"laplace-transform draws PG(1, {c})/2 at {LAP_LANES} lanes: mean {float(d.mean()):.6g} (grid "
            f"{grid_mean:.6g}, {z:+.2f} SE; tanh(c/2)/(4c) {closed:.6g}, grid off by {grid_mean / closed - 1:+.4%}); KS "
            f"against {LAP_CPU_LANES} CPU draws p = {ks_p:.4f}; {seconds:.3f} s")
        if not (bool(torch.isfinite(draws).all()) and abs(z) < SAMPLER_SE and abs(grid_mean / closed - 1) < LAP_MEAN_TOL
                and ks_p > SAMPLER_KS_P):
            raise AssertionError(f"laplace-transform draws at c={c}: z {z:.2f}, grid {grid_mean / closed - 1:+.4%}, "
                                 f"KS p {ks_p:.2e}")
        out[f"lap c={c}"] = {"z": z, "grid_off": grid_mean / closed - 1, "ks_p": ks_p, "seconds": seconds}
    g = septuple_gibbs(agt, device)
    expect_launches(ck, "septuple draws and Gibbs", {})
    floor = NUMERICAL_FLOORS["gibbs"][1]
    log(f"septuple MCGP (N={GG_N}, Gibbs, {GG_BURNIN} + {GG_SAMPLES} sweeps): posterior mean's sign agreement "
        f"{g['sign']:.4f}, correlation with the built-in logistic's {g['corr']:.5f} (floor {floor}); "
        f"{g['reads']:.2f} host reads a sweep; {g['seconds']:.3f} s; 0 kernel launches")
    if not (g["finite"] and g["corr"] >= floor):
        raise AssertionError(f"septuple MCGP: finite {g['finite']}, correlation {g['corr']:.5f} < {floor}")
    out["gibbs"] = g
    return out


@contextlib.contextmanager
def recorded_psd_rungs(numerical_vi, rungs):
    """numerical_vi.psd_apply wrapped for the duration: each call appends
    the rungs it took ([L]) to ``rungs``."""
    psd_apply = numerical_vi.psd_apply

    def recorded(S, dS, lazy=False):
        out, k = psd_apply(S, dS, lazy)
        rungs.append(k)
        return out, k

    numerical_vi.psd_apply = recorded
    try:
        yield
    finally:
        numerical_vi.psd_apply = psd_apply


def quad_vgp_run(agt, device, which, dtype=torch.float32):
    """Path 33's dense runs: "quad_vgp" (quadrature_vi_logistic_accuracy) or
    "studentt_vgp" (the Student-t VGP with Adam(0.05)): {"metric" (the
    accuracy, or mean |mu - f|), "moved", "rungs" (the PSD step's rung, as
    counts by rung over the run's steps), "reads" (host reads an
    iteration), "seconds"}."""
    from agp_tpu_torch.inference import numerical_vi
    from agp_tpu_torch.utils.tensors import host_read

    n = QV_N if which == "quad_vgp" else TV_N
    rng = np.random.default_rng(18 if which == "quad_vgp" else 9)
    X = rng.uniform(-2, 2, size=(n, 2))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    X, f = torch.as_tensor(X, dtype=dtype, device=device), torch.as_tensor(f, dtype=dtype, device=device)
    if which == "quad_vgp":
        y, iters = torch.sign(f), QV_ITERS
        model = agt.VGP.create(X, y, agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                               agt.QuadratureVI(n_points=QV_POINTS, optimiser=agt.sgd(NUM_LR, 0.9)), optimiser=None)
    else:
        y, iters = f + 0.05 * torch.as_tensor(rng.normal(size=n), dtype=dtype, device=device), TV_ITERS
        model = agt.VGP.create(X, y, agt.SqExponentialKernel(lengthscale=3.0), agt.StudentTLikelihood.create(4.0),
                               agt.QuadratureVI(n_points=TV_POINTS), optimiser=agt.adam(0.05))
    log0 = log_hypers(model)
    rungs = []
    reads = host_read.reads
    sync(device)
    t0 = time.perf_counter()
    with recorded_psd_rungs(numerical_vi, rungs):
        model, state = agt.train(model, iterations=iters)
    sync(device)
    out = {"seconds": time.perf_counter() - t0, "reads": (host_read.reads - reads) / iters,
           "moved": float((log_hypers(model) - log0).abs().max()), "finite": finite_state(state)}
    out["rungs"] = dict(zip(*(a.tolist() for a in torch.unique(torch.stack(rungs).cpu(), return_counts=True))))
    if which == "quad_vgp":
        out["metric"] = float((agt.predict_y(model, state, X) == y).double().mean())
    else:
        out["metric"] = float((agt.predict_f(model, state, X) - f).abs().mean())
    return out


def numerical_parity_run(agt, which, X, y, draws, eps=None, perm=None):
    """mu after 20 steps of path 30 ("quad"), 31 ("mc"), 32a ("septuple")
    or the built-in flagship ("builtin") on (X, y) from the given minibatch
    draws (and Monte Carlo normals), on X's device, as float64 on the CPU;
    ``perm`` reorders the inducing points (mu is put back in order)."""
    from agp_tpu_torch.training.train import vi_steps

    b = MB if which == "mc" else B
    model = {"quad": quad_model, "mc": softmax_model, "septuple": septuple_model, "builtin": flagship_model}[which](
        agt, X, b=b)
    if perm is not None:
        model = model.replace(Z=model.Z[:, perm].contiguous())
    y_t, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    y_t = y_t.to(device=X.device, dtype=X.dtype)
    state = agt.init_state(model, X, y_t)
    _, state = vi_steps(model, state, X, y_t, 20, draws=draws.to(X.device),
                        mc_draws=None if eps is None else eps.to(X.device))
    mu = state.mu.double().cpu()
    return mu if perm is None else mu[:, torch.argsort(perm)]


def phase_numerical_dense_and_parity(agt, ck, device):
    """Phase 33: the dense paths (no kernel launch; the PSD step's rungs and
    host reads logged) with their floors; then 20 steps of paths 30, 31
    and 32a on the card (float32) against the CPU (float32) from the same
    minibatch draws and normals, each within ORACLE_DEVICE_FACTOR times
    its own float32 noise (the CPU run again with the inducing points in
    another order) and the card with the plain versions in the kernels'
    place within that noise, with no fixed floor under either; and path 32a
    on the card against the built-in logistic (kernel 1) on the same
    draws, within ORACLE_DEVICE_FACTOR times 32a's noise."""
    out = {}
    for which, floor in (("quad_vgp", QV_ACC), ("studentt_vgp", TV_MAE)):
        reset_launches(ck)
        r = quad_vgp_run(agt, device, which)
        expect_launches(ck, which, {})
        ok = r["finite"] and (r["metric"] > floor if which == "quad_vgp" else r["metric"] < floor)
        if which == "studentt_vgp":
            ok = ok and r["moved"] > MIN_HYPER_MOVE
        log(f"numerical {which}: {'accuracy' if which == 'quad_vgp' else 'mean |mu - f|'} {r['metric']:.5f} "
            f"({'>' if which == 'quad_vgp' else '<'} {floor}), log-hyperparameters moved {r['moved']:.4f}, PSD rungs "
            f"taken {r['rungs']} (rung: steps), {r['reads']:.2f} host reads an iteration, {r['seconds']:.3f} s, "
            f"0 kernel launches")
        if not ok:
            raise AssertionError(f"numerical {which}: {r}")
        out[which] = r
    gen = torch.Generator().manual_seed(1)
    Xq, yq = flagship_data("cpu", n=PN, seed=1)
    Xm, ym = mc_data("cpu", seed=1)
    cases = {
        "quad": (Xq, yq, torch.randint(0, PN, (20, B), generator=gen), None, M),
        "mc": (Xm, ym, torch.randint(0, MN, (20, MB), generator=gen),
               torch.randn((20, MC_DRAWS, MK, MB), generator=gen), MM),
        "septuple": (Xq, yq, torch.randint(0, PN // 64, (20, B // 64), generator=gen), None, M),
    }
    for which, (Xc, yc, draws, eps, m) in cases.items():
        t0 = time.perf_counter()
        Xd, yd = Xc.to(device), yc.to(device)
        cpu = numerical_parity_run(agt, which, Xc, yc, draws, eps)
        card = numerical_parity_run(agt, which, Xd, yd, draws, eps)
        with plain_kernels(ck, ("fused_cavi_stats",) + SPLIT_PAIRS):
            card_plain = numerical_parity_run(agt, which, Xd, yd, draws, eps)
        perm = torch.randperm(m, generator=torch.Generator().manual_seed(2))
        noise = rel_err((numerical_parity_run(agt, which, Xc, yc, draws, eps, perm), None), (cpu, None))
        e, e_plain = rel_err((card, None), (cpu, None)), rel_err((card, None), (card_plain, None))
        tol, tol_plain = ORACLE_DEVICE_FACTOR * noise, noise
        log(f"numerical {which} parity (20 steps): card (float32) vs CPU (float32) {e:.3e} (bound {tol:.3e}, "
            f"{e / tol:.3f} of it), vs the card with the plain versions {e_plain:.3e} (bound {tol_plain:.3e}, "
            f"{e_plain / tol_plain:.3f} of it); CPU with Z reordered vs CPU {noise:.3e}; "
            f"{time.perf_counter() - t0:.2f} s")
        if not (e <= tol and e_plain <= tol_plain):
            raise AssertionError(f"numerical {which} parity: {e:.3e} (bound {tol:.3e}), {e_plain:.3e} "
                                 f"(bound {tol_plain:.3e})")
        out[f"parity {which}"] = {"card_cpu": e, "card_plain": e_plain, "noise": noise}
        if which == "septuple":
            builtin = numerical_parity_run(agt, "builtin", Xd, yd, draws)
            e_b = rel_err((card, None), (builtin, None))
            log(f"numerical septuple against the built-in logistic on the card (20 steps, kernels 6 + 7 against "
                f"kernel 1): {e_b:.3e} (bound {tol:.3e}, {e_b / tol:.3f} of it)")
            if not e_b <= tol:
                raise AssertionError(f"septuple vs built-in on the card: {e_b:.3e} > {tol:.3e}")
            out["septuple vs builtin"] = e_b
    return out


def time_psd(device, reps=50):
    """ms a call of the PSD step (numerical_vi.psd_apply) by the host clock
    over ``reps`` calls ending in a synchronize, rung 0 succeeding: the
    batch of all 27 rungs at [1, 64, 64] (path 30) and [10, 64, 64] (path
    31), beside one Cholesky of the same matrices; the lazy form at [1,
    400, 400] (path 33) and [1, 2048, 2048], beside the batch."""
    from agp_tpu_torch.inference import numerical_vi

    out = {}
    for L, n, lazy in ((1, M, False), (MK, MM, False), (1, QV_N, True), (1, 2048, True)):
        g = torch.Generator(device=device).manual_seed(n)
        A = torch.randn(L, n, n, generator=g, device=device)
        S = A @ A.mT / n + torch.eye(n, device=device)
        dS = 1e-3 * S
        calls = {"psd_apply": lambda: numerical_vi.psd_apply(S, dS, lazy=lazy),
                 "one cholesky": lambda: torch.linalg.cholesky_ex(S + dS)}
        if lazy:
            calls["all rungs"] = lambda: numerical_vi.psd_apply(S, dS)
        for name, fn in calls.items():
            fn()
            sync(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync(device)
            out[f"{name} [{L}, {n}, {n}]"] = (time.perf_counter() - t0) * 1e3 / reps
    log("PSD step, ms a call (host clock): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def numerical_mode(agt, ck, device):
    """``python3 chip_smoke.py numerical``: phases 30-33 alone."""
    out = {"quad": timed_phase("numerical quadrature", phase_quadrature, agt, ck, device)}
    out["mc"] = timed_phase("numerical Monte Carlo", phase_monte_carlo, agt, ck, device)
    out["generic"] = timed_phase("generic likelihood", phase_generic, agt, ck, device)
    out["dense"] = timed_phase("numerical dense and parity", phase_numerical_dense_and_parity, agt, ck, device)
    out["psd"] = time_psd(device)
    return out


@contextlib.contextmanager
def softmax_ad_form(agt):
    """SoftMaxLikelihood without its closed-form mc_grad_hess for the
    duration: mc_grads takes the AD form (a gradient and one jvp per
    latent)."""
    cls = agt.SoftMaxLikelihood
    closed = cls.__dict__["mc_grad_hess"]
    del cls.mc_grad_hess
    try:
        yield
    finally:
        cls.mc_grad_hess = closed


def softmax_forms_mode(agt, ck, device, reps=20):
    """``python3 chip_smoke.py softmax-forms``: path 31 with SoftMax's
    closed-form gradient and Hessian diagonal against the AD form, in the
    order closed, AD, AD, closed: the steady iterations/s (steady_rate,
    NUM_TIMED_STEPS steps from the same state and generator seed), the
    launches of kernels 4 and 5 a step, and ms of one mc_grads call on
    the path's [MC_DRAWS, MK, MB] draws by CUDA events over ``reps``
    calls.  Both forms' outputs are held against each other."""
    from agp_tpu_torch.inference import numerical_vi

    X, y = mc_data(device)
    model = softmax_model(agt, X)
    y_t, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    y_t = y_t.to(X.dtype)
    state = agt.init_state(model, X, y_t)
    g = torch.Generator(device=device).manual_seed(4)
    yb = y_t[:MB]
    mu = torch.randn((MK, MB), generator=g, device=device)
    var = torch.rand((MK, MB), generator=g, device=device) + 0.1
    eps = torch.randn((MC_DRAWS, MK, MB), generator=g, device=device)
    out = {}
    for form in ("closed", "ad", "ad", "closed"):
        with softmax_ad_form(agt) if form == "ad" else contextlib.nullcontext():
            reset_launches(ck)
            ips = steady_rate(agt, model, state, X, y, torch.Generator(device=device).manual_seed(0))
            launches = {k: launches_of(ck, k) / (30 + NUM_TIMED_STEPS) for k in LAUNCH_COUNTERS
                        if launches_of(ck, k)}
            numerical_vi.mc_grads(lik, yb, mu, var, eps, 0.0)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                grads = numerical_vi.mc_grads(lik, yb, mu, var, eps, 0.0)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / reps
        out.setdefault(form, {"ips": [], "ms": [], "grads": grads})["ips"].append(ips)
        out[form]["ms"].append(ms)
        log(f"softmax {form} form on path 31: steady {ips:.1f} iterations/s over {NUM_TIMED_STEPS} iterations, "
            f"launches a step {launches}, mc_grads {ms:.4f} ms a call (CUDA events, {reps} calls)")
    err = max(rel_err((a, None), (b, None)) for a, b in zip(out["closed"]["grads"], out["ad"]["grads"]))
    log(f"softmax forms: closed {json.dumps(out['closed']['ips'])} it/s, {json.dumps(out['closed']['ms'])} ms; "
        f"AD {json.dumps(out['ad']['ips'])} it/s, {json.dumps(out['ad']['ms'])} ms; closed vs AD {err:.3e}")
    if not err <= 1e-5:
        raise AssertionError(f"softmax closed form vs AD form: {err:.3e}")


def numerical_cpu_mode(agt):
    """``python3 chip_smoke.py numerical-cpu``: every path of phases 30-33 in
    float64 on the host's CPU, CPU draws, no floors held: the source of
    NUMERICAL_FLOORS."""
    from agp_tpu_torch.ops import cuda_kernels as ck

    torch.set_num_threads(min(torch.get_num_threads(), 8))
    for which in ("quad", "quad_hyper", "mc", "septuple"):
        log_numerical(which, numerical_run(agt, ck, "cpu", which, torch.float64), "the CPU, float64")
    rmse, dmu, _, seconds = laplace_septuple_run(agt, ck, "cpu", torch.float64)
    log(f"septuple laplace on the CPU, float64: RMSE {rmse:.5f}, mu against the built-in {dmu:.3e}, {seconds:.2f} s")
    g = septuple_gibbs(agt, "cpu", torch.float64)
    log(f"septuple MCGP on the CPU, float64: sign agreement {g['sign']:.4f}, correlation with the built-in's "
        f"{g['corr']:.5f}, {g['seconds']:.2f} s")
    for which in ("quad_vgp", "studentt_vgp"):
        r = quad_vgp_run(agt, "cpu", which, torch.float64)
        log(f"numerical {which} on the CPU, float64: metric {r['metric']:.5f}, moved {r['moved']:.4f}, PSD rungs "
            f"{r['rungs']}, {r['reads']:.2f} host reads an iteration, {r['seconds']:.2f} s")


def profile_numerical(agt, device, which):
    """``python3 chip_smoke.py profile numerical quad|mc``: torch.profiler
    over 20 steady steps (after 30) of path 30 or 31: wall and device-busy
    time a step, the idle share, launches and device ops a step, the
    largest kernels."""
    from agp_tpu_torch.training.train import vi_steps

    X, y = mc_data(device) if which == "mc" else flagship_data(device)
    model = softmax_model(agt, X) if which == "mc" else quad_model(agt, X)
    y_t, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    y_t = y_t.to(X.dtype)
    state = agt.init_state(model, X, y_t)
    gen = torch.Generator(device=device).manual_seed(0)
    model, state = vi_steps(model, state, X, y_t, 30, generator=gen)
    log_profile(f"profile numerical {which}", profile_window(lambda: vi_steps(model, state, X, y_t, 20, generator=gen),
                                                           20), 15)


# --------------------------------- Slice H: VStP, multi-output models, AR
# phase 34: tpu_acceptance.py:141-153's VStP (N=400, 2-D, y = f + 0.05 eps
# with +8 on every 29th point, Student-t(4), nu 5, fixed hyperparameters, 60
# iterations, RMSE of predict_f against f < 0.3), then the same model timed
# at N=4,096 (phase 20a's size)
VS_N, VS_ITERS, VS_TIMED_N, VS_WARM, VS_TIMED = 400, 60, 4096, 5, 10
# phase 35: tpu_acceptance.py:416-436's MOSVGP (X uniform on [-2, 2]^2,
# f = sin(2 x_0) + 0.5 x_1; tasks Gaussian(0.1) on f and logistic on
# sign(f - 0.2); Z = X[:512], Q=2, AnalyticSVI(16384), fixed kernel, the
# default Adam(0.01) on A, 100 iterations, RMSE of task 0 on X[:2048]
# < 0.35); 35h the same with Adam(0.01) on the kernel every 3rd iteration
MO_N, MO_M, MO_B, MO_Q, MO_ITERS, MO_RMSE, MO_EVAL = 30_000, 512, 16_384, 2, 100, 0.35, 2048
MO_TIMED = 100
# phase 36: (a) tpu_acceptance.py:591-610 (N=2,048, Z = X[:32], full batch,
# 80 iterations; mo_proba_y on X[:1024]: the logistic task's mean p on
# y = 1 minus on y = -1 above 0.2, p in [0, 1]); (b) tpu_acceptance.py:
# 187-202's model (N=512, Z = X[:16], full batch, 60 iterations, RMSE of
# task 0 on X[:256] < 0.35) with one latent, Q=1: kernels 6 + 7; (c)
# tests/test_movgp.py's per-task check (a MOVGP on 60 points of a GP draw,
# Gaussian(0.01) + logistic tasks, 60 iterations: RMSE < 0.3; its accuracy
# > 0.85 holds there because its draw's labels are 93 % one class, the one
# the model predicts everywhere: on a numpy draw both packages predict one
# class too, so here the logistic task's labels and probabilities are held
# to the CPU's float64 run on the same data, MV_AGREE of the labels)
PA_N, PA_M, PA_ITERS, PA_SEP = 2048, 32, 80, 0.2
Q1_N, Q1_M, Q1_ITERS = 512, 16, 60
MV_N, MV_ITERS, MV_RMSE, MV_AGREE = 60, 60, 0.3, 0.95
# phase 37: tests/test_engines.py:311-326 (sin over 200 points of 8 pi, lag
# 5, SVGP + Gaussian(1e-3) on Z = Xl[:20], 15 full-batch iterations;
# predict_ar's mean |error| over 20 steps < 0.5, sample_ar 4 x 10), then
# sample_ar's 1,024 trajectories x 100 steps timed
AR_LAG, AR_ITERS, AR_STEPS, AR_MAE, AR_TIMED = 5, 15, 20, 0.5, (1024, 100)
# floors from ``python3 chip_smoke.py slice-h-cpu`` (the same paths in
# float64 on the card's host's CPU, CPU draws): RMSE 0.06239 (VStP),
# 0.00892 and 0.00966 (phase 35 and 35h), 0.15519 (Q=1).  Each is about
# three times the CPU's error, inside the reference's bound (0.3, 0.35):
# for Q=1 three times would pass it, so the reference's bound stays.
SLICE_H_FLOORS = {"vstp": 0.19, "mo": 0.027, "mo_q1": MO_RMSE}
MO_PARITY_B = PAIR_PARITY_B


def vstp_data(n, device, dtype=torch.float32, seed=0):
    """Phase 34's data made with numpy: (X, f, y)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 2))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    y = f + 0.05 * rng.normal(size=n)
    y[::29] += 8.0
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (X, f, y))


def vstp_run(agt, ck, device, n=VS_N, dtype=torch.float32, timed=False):
    """Phase 34's VStP through agp_tpu_torch.train: {"rmse", "chi" (the
    prior's scale, [L]), "seconds"}, with no kernel launch on the card;
    ``timed``: then VS_WARM and VS_TIMED iterations more, "ips", "idle"
    (profiled over 3 iterations) and "peak_gib"."""
    X, f, y = vstp_data(n, device, dtype)
    model = agt.VStP.create(X, y, agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticVI(),
                            nu=5.0, optimiser=None)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        reset_launches(ck)
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    model, state = agt.train(model, iterations=VS_ITERS)
    sync(device)
    out = {"seconds": time.perf_counter() - t0, "chi": state.prior_state["chi"].double().cpu()}
    if cuda:
        expect_launches(ck, f"vstp N={n}", {})
    out["rmse"] = float(torch.sqrt(torch.mean((agt.predict_f(model, state, X) - f) ** 2)))
    if timed:
        model, state = agt.train(model, iterations=VS_WARM, state=state)
        sync(device)
        t0 = time.perf_counter()
        model, state = agt.train(model, iterations=VS_TIMED, state=state)
        sync(device)
        out["ips"] = VS_TIMED / (time.perf_counter() - t0)
        out["idle"] = profile_window(lambda: agt.train(model, iterations=3, state=state), 3)["idle_share"]
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def phase_vstp(agt, ck, device):
    """Phase 34: the VStP check (its RMSE under the reference's 0.3 and the
    floor, chi finite and positive on every latent, no kernel launch), then
    the same model at N=VS_TIMED_N timed (it/s, idle share, peak memory)."""
    r = vstp_run(agt, ck, device)
    chi_ok = bool(torch.isfinite(r["chi"]).all()) and bool((r["chi"] > 0).all())
    log(f"vstp (N={VS_N}, {VS_ITERS} iterations, 0 kernel launches): RMSE {r['rmse']:.5f} (floor "
        f"{SLICE_H_FLOORS['vstp']}), chi {r['chi'].tolist()}, {r['seconds']:.3f} s")
    if not (chi_ok and r["rmse"] < SLICE_H_FLOORS["vstp"]):
        raise AssertionError(f"vstp: RMSE {r['rmse']:.5f}, chi {r['chi'].tolist()}")
    t = vstp_run(agt, ck, device, n=VS_TIMED_N, timed=True)
    log(f"vstp N={VS_TIMED_N}: {VS_ITERS} iterations in {t['seconds']:.3f} s, steady {t['ips']:.2f} iterations/s "
        f"over {VS_TIMED}, idle share {t['idle']:.4f}, peak {t['peak_gib']:.3f} GiB, RMSE {t['rmse']:.5f}, "
        f"0 kernel launches")
    if not (bool(torch.isfinite(t["chi"]).all()) and t["rmse"] < SLICE_H_FLOORS["vstp"]):
        raise AssertionError(f"vstp N={VS_TIMED_N}: RMSE {t['rmse']:.5f}, chi {t['chi'].tolist()}")
    return {"rmse": r["rmse"], "ips": t["ips"], "idle": t["idle"], "peak_gib": t["peak_gib"]}


def mo_data(n, device, dtype=torch.float32, seed=0):
    """tpu_acceptance.py's _toy rule made with numpy, and its two tasks:
    (X, f, (f, sign(f - 0.2)))."""
    X = np.random.default_rng(seed).uniform(-2, 2, size=(n, 2))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    X, f, y2 = (torch.as_tensor(a, dtype=dtype, device=device) for a in (X, f, np.sign(f - 0.2)))
    return X, f, (f, y2)


def mo_model(agt, X, m=MO_M, b=MO_B, q=MO_Q, optimiser=None, atfrequency=1):
    """A MOSVGP on Z = X[:m] (full batch when b is None) over
    Gaussian(0.1) + logistic tasks, its A drawn on the CPU with seed 0 so
    that the card's and the CPU's runs start from the same A."""
    liks = [agt.GaussianLikelihood.create(0.1), agt.LogisticLikelihood.create()]
    inference = agt.AnalyticVI() if b is None else agt.AnalyticSVI(b)
    return seeded_A(agt.MOSVGP.create(agt.SqExponentialKernel(), liks, inference, X[:m], n_latent=q,
                                      optimiser=optimiser, atfrequency=atfrequency))


def seeded_A(model):
    """``model`` with an A drawn on the CPU with seed 0 (rows normalized),
    the same on the card and on the CPU."""
    A = torch.randn(tuple(model.A.shape), generator=torch.Generator().manual_seed(0), dtype=model.A.dtype)
    return model.replace(A=(A / torch.linalg.norm(A, dim=1, keepdim=True)).to(model.A.device))


def mo_treated(model, ys):
    """(model, ys) with the labels treated and cast as mo_train treats them."""
    from agp_tpu_torch.models.base import match_dtype

    out, liks = [], []
    for lik, y in zip(model.likelihoods, ys):
        y2, lik2 = lik.treat_labels(y)
        out.append(match_dtype(y2, model.Z))
        liks.append(lik2)
    return model.replace(likelihoods=tuple(liks)), tuple(out)


def mo_steps(model, state, X, ys, n, gen=None, draws=None):
    """n multi-output CAVI steps (treated labels) without mo_train's setup
    and its final kmat."""
    from agp_tpu_torch.models import multioutput

    for x_b, ys_b in multioutput._mo_batches(model, X, ys, n, draws, gen):
        model, state = multioutput.mo_variational_update(model, state, x_b, ys_b)
        state = state.replace(step=state.step + 1)
    return model, state


def mo_run(agt, ck, device, hyper=False, dtype=torch.float32):
    """Phase 35 (35h with ``hyper``) through agp_tpu_torch.mo_train: {"rmse"
    (task 0 on X[:MO_EVAL]), "finite", "moved", "seconds", "launches"};
    on the card the exact launches (kernels 4 and 5 once a step, kernel 4
    once more a hyperparameter step), then "ips" over MO_TIMED steps,
    "idle" and "launches_per_step" over 10 profiled steps, "peak_gib"."""
    X, f, ys = mo_data(MO_N, device, dtype)
    model = mo_model(agt, X, optimiser=agt.adam(0.01) if hyper else None, atfrequency=3 if hyper else 1)
    log0 = log_hypers(model)
    gen = torch.Generator(device=device).manual_seed(0)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        reset_launches(ck)
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    model, state = agt.mo_train(model, X, ys, iterations=MO_ITERS, generator=gen)
    sync(device)
    out = {"seconds": time.perf_counter() - t0, "moved": float((log_hypers(model) - log0).abs().max())}
    hyper_steps = len([i for i in range(3, MO_ITERS) if i % 3 == 0]) if hyper else 0
    if cuda:
        out["launches"] = expect_launches(ck, "mo" + ("h" if hyper else ""), route_launches(MO_ITERS, "batched")
                                          | {"fused_kappa_moments_batched": MO_ITERS + hyper_steps})
    mu, var = agt.mo_predict_f(model, state, X[:MO_EVAL])
    out["finite"] = bool(torch.isfinite(mu).all() and torch.isfinite(var).all() and torch.isfinite(state.mu).all())
    out["rmse"] = float(torch.sqrt(torch.mean((mu[0] - f[:MO_EVAL]) ** 2)))
    out["A_rows"] = float((torch.linalg.norm(model.A, dim=1) - 1).abs().max())
    if cuda and not hyper:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        model, ys_t = mo_treated(model, ys)
        sync(device)
        t0 = time.perf_counter()
        model, state = mo_steps(model, state, X, ys_t, MO_TIMED, gen)
        sync(device)
        out["ips"] = MO_TIMED / (time.perf_counter() - t0)
        prof = profile_window(lambda: mo_steps(model, state, X, ys_t, 10, gen), 10)
        out["idle"], out["launches_per_step"], out["busy_us"] = prof["idle_share"], prof["launches"], prof["busy_us"]
    return out


def check_mo(which, r, floor):
    if not (r["finite"] and r["rmse"] < MO_RMSE and r["rmse"] < floor and r["A_rows"] <= 1e-5):
        raise AssertionError(f"{which}: RMSE {r['rmse']:.5f} (bound {MO_RMSE}, floor {floor}), finite {r['finite']}, "
                             f"A's rows off unit norm by {r['A_rows']:.2e}")


def phase_mo(agt, ck, device):
    """Phase 35: the MOSVGP at full width (exactly MO_ITERS launches each of
    kernels 4 and 5, none of 1-3, 6, 7), its RMSE under the reference's
    bound and the floor, A's rows unit-norm, its steady rate, idle share,
    launches a step and peak memory; 35h with Adam on the kernel (kernel 4
    once more a hyperparameter step), the log-hyperparameters moved."""
    r = mo_run(agt, ck, device)
    check_mo("mo", r, SLICE_H_FLOORS["mo"])
    log(f"mo (N={MO_N}, M={MO_M}, B={MO_B}, Q={MO_Q}, {MO_ITERS} iterations through agp_tpu_torch.mo_train): "
        f"{r['seconds']:.3f} s, {r['launches']} launches, RMSE {r['rmse']:.5f} (bound {MO_RMSE}, floor "
        f"{SLICE_H_FLOORS['mo']}); steady {r['ips']:.1f} iterations/s over {MO_TIMED}, idle share {r['idle']:.4f}, "
        f"{r['launches_per_step']:.1f} launches and {r['busy_us']:.1f} us of device time a step (profiled), "
        f"peak {r['peak_gib']:.3f} GiB")
    h = mo_run(agt, ck, device, hyper=True)
    check_mo("mo hyper", h, SLICE_H_FLOORS["mo"])
    if not h["moved"] > MIN_HYPER_MOVE:
        raise AssertionError(f"mo hyper: the log-hyperparameters moved by {h['moved']:.3e}")
    log(f"mo 35h (Adam(0.01) on the kernel every 3rd iteration): {h['seconds']:.3f} s, {h['launches']} launches, "
        f"RMSE {h['rmse']:.5f}, log-hyperparameters moved {h['moved']:.4f}")
    return {k: r[k] for k in ("rmse", "seconds", "ips", "idle", "launches_per_step", "busy_us", "peak_gib")} | {
        "hyper_rmse": h["rmse"], "hyper_seconds": h["seconds"], "hyper_moved": h["moved"]}


def gp_draw(n, seed):
    """tests/testingtools.generate_f's rule made with numpy: X uniform on
    [0, 1]^2, f a draw of the unit squared-exponential GP (+1e-5 I); a
    second task's g from the same X."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    K = np.exp(-0.5 * ((X[:, None] - X[None]) ** 2).sum(-1)) + 1e-5 * np.eye(n)
    L = np.linalg.cholesky(K)
    return X, L @ rng.normal(size=n), L @ rng.normal(size=n)


def mo_small_runs(agt, ck, device, dtype=torch.float32):
    """Phase 36's three paths, each with its exact launches on the card:
    {"proba": (separation, p in [0, 1] and the regression task finite),
    "q1": RMSE, "movgp": (RMSE, accuracy, proba_y's accuracy)}."""
    cuda = torch.device(device).type == "cuda"
    out = {}

    def train(label, model, X, ys, iters, route):
        if cuda:
            reset_launches(ck)
        model, state = agt.mo_train(model, X, ys, iterations=iters)
        if cuda:
            expect_launches(ck, label, route_launches(iters, route))
        return model, state

    X, f, ys = mo_data(PA_N, device, dtype, seed=1)
    model, state = train("mo proba", mo_model(agt, X, m=PA_M, b=None), X, ys, PA_ITERS, "batched")
    (mean, var), p = agt.mo_proba_y(model, state, X[:1024])
    y2 = ys[1][:1024]
    out["proba"] = (float(p[y2 > 0].mean() - p[y2 < 0].mean()), bool(((p >= 0) & (p <= 1)).all()),
                    bool(torch.isfinite(mean).all() and torch.isfinite(var).all()))
    X, f, ys = mo_data(Q1_N, device, dtype, seed=2)
    model, state = train("mo q1", mo_model(agt, X, m=Q1_M, b=None, q=1), X, ys, Q1_ITERS, "single")
    out["q1"] = float(torch.sqrt(torch.mean((agt.mo_predict_f(model, state, X[:256])[0][0] - f[:256]) ** 2)))
    out["movgp"] = movgp_run(agt, device, dtype, train)
    return out


def movgp_run(agt, device, dtype, train=None):
    """Phase 36c's MOVGP: (RMSE of the Gaussian task, the logistic task's
    accuracy, its predicted labels and probabilities on the CPU)."""
    X, f1, f2 = gp_draw(MV_N, seed=3)
    y_cls = np.sign(f1 + 0.3 * f2)
    X, y_reg, y_cls = (torch.as_tensor(a, dtype=dtype, device=device) for a in (X, f1, y_cls))
    liks = [agt.GaussianLikelihood.create(0.01), agt.LogisticLikelihood.create()]
    model = seeded_A(agt.MOVGP.create(X, liks, agt.SqExponentialKernel(), agt.AnalyticVI(), n_latent=2,
                                      optimiser=None))
    if train is None:
        model, state = agt.mo_train(model, X, (y_reg, y_cls), iterations=MV_ITERS)
    else:
        model, state = train("movgp", model, X, (y_reg, y_cls), MV_ITERS, "batched")
    pred = agt.mo_predict_y(model, state, X)
    (_, _), p_cls = agt.mo_proba_y(model, state, X)
    return (float(torch.sqrt(torch.mean((pred[0] - y_reg) ** 2))), float((pred[1] == y_cls).double().mean()),
            pred[1].double().cpu(), p_cls.double().cpu())


def phase_mo_small(agt, ck, device):
    """Phase 36: mo_proba_y's check, a Q=1 MOSVGP (kernels 6 + 7 once a step)
    with its floor, and the MOVGP per-task check: its RMSE threshold, its
    logistic task's labels and probabilities against the CPU's float64 run
    on the same data."""
    r = mo_small_runs(agt, ck, device)
    sep, in_01, finite = r["proba"]
    rmse_v, acc, labels, p = r["movgp"]
    _, acc_cpu, labels_cpu, p_cpu = movgp_run(agt, "cpu", torch.float64)
    agree, dp = float((labels == labels_cpu).double().mean()), float((p - p_cpu).abs().max())
    log(f"mo_proba_y (N={PA_N}, M={PA_M}, Q=2, {PA_ITERS} iterations, kernels 4 + 5): separation {sep:.5f} "
        f"(> {PA_SEP}), p in [0, 1] {in_01}, regression task finite {finite}; Q=1 (N={Q1_N}, M={Q1_M}, "
        f"{Q1_ITERS} iterations, kernels 6 + 7): RMSE {r['q1']:.5f} (floor {SLICE_H_FLOORS['mo_q1']}); MOVGP "
        f"(N={MV_N}): RMSE {rmse_v:.5f} (< {MV_RMSE}), the logistic task's accuracy {acc:.4f} (the CPU's float64 "
        f"{acc_cpu:.4f}), its labels agree with the CPU's on {agree:.4f} (>= {MV_AGREE}), p within {dp:.2e}")
    if not (sep > PA_SEP and in_01 and finite):
        raise AssertionError(f"mo_proba_y: {r['proba']}")
    if not r["q1"] < SLICE_H_FLOORS["mo_q1"]:
        raise AssertionError(f"mo q1: RMSE {r['q1']:.5f}")
    if not (rmse_v < MV_RMSE and agree >= MV_AGREE and dp <= 1e-2):
        raise AssertionError(f"movgp: RMSE {rmse_v:.5f}, agreement {agree:.4f}, p within {dp:.2e}")
    return {"proba": r["proba"], "q1": r["q1"], "movgp": (rmse_v, acc, agree, dp)}


def ar_model(agt, device, dtype=torch.float32):
    """Phase 37's series, lag windows and SVGP."""
    series = torch.sin(torch.linspace(0, 8 * np.pi, 200, dtype=torch.float64)).to(device=device, dtype=dtype)
    Xl = torch.stack([series[i:i + AR_LAG] for i in range(200 - AR_LAG)])
    model = agt.SVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(1e-3), agt.AnalyticVI(),
                            Z=Xl[:20], optimiser=None)
    return series, Xl, series[AR_LAG:], model


def phase_ar(agt, ck, device):
    """Phase 37: the AR check (kernel 1 once a training step; the rollouts
    launch nothing), predict_ar's MAE, sample_ar's 4 x 10 trajectories
    finite, then sample_ar's AR_TIMED trajectories x steps timed (ms a
    step, host reads)."""
    from agp_tpu_torch.utils.tensors import host_read

    series, Xl, yl, model = ar_model(agt, device)
    reset_launches(ck)
    model, state = agt.train(model, Xl, yl, iterations=AR_ITERS)
    sync(device)
    expect_launches(ck, "ar training", route_launches(AR_ITERS, "fused"))
    reset_launches(ck)
    preds = agt.predict_ar(model, state, series[-AR_LAG:], AR_STEPS)
    dt = (torch.linspace(0, 8 * np.pi, 200, dtype=torch.float64)[1]).item()
    future = torch.sin(8 * np.pi + dt * torch.arange(1, AR_STEPS + 1, dtype=torch.float64))
    mae = float((preds.double().cpu() - future).abs().mean())
    traj = agt.sample_ar(model, state, series[-AR_LAG:], n_steps=10, n_samples=4,
                         generator=torch.Generator(device=device).manual_seed(0))
    n_traj, n_steps = AR_TIMED
    agt.sample_ar(model, state, series[-AR_LAG:], n_steps=3, n_samples=n_traj)
    reads = host_read.reads
    sync(device)
    t0 = time.perf_counter()
    big = agt.sample_ar(model, state, series[-AR_LAG:], n_steps=n_steps, n_samples=n_traj)
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3 / n_steps
    reads = host_read.reads - reads
    expect_launches(ck, "ar rollouts", {})
    log(f"ar: predict_ar MAE over {AR_STEPS} steps {mae:.5f} (< {AR_MAE}), sample_ar {tuple(traj.shape)} finite "
        f"{bool(torch.isfinite(traj).all())}; sample_ar {n_traj} x {n_steps}: {ms:.4f} ms a step, {reads} host reads, "
        f"finite {bool(torch.isfinite(big).all())}; the rollouts launched no kernel")
    if not (mae < AR_MAE and traj.shape == (4, 10) and bool(torch.isfinite(traj).all())
            and bool(torch.isfinite(big).all()) and reads == 0):
        raise AssertionError(f"ar: MAE {mae:.5f}, trajectories {tuple(traj.shape)}, {reads} host reads")
    return {"mae": mae, "ms_a_step": ms, "reads": reads}


def mo_after_20(agt, X, ys, draws, perm=None):
    """mu (in Z's own order) and A after 20 steps of phase 35's model at
    B=MO_PARITY_B on (X, ys) from the given draws, as float64 on the CPU;
    ``perm`` reorders the inducing points."""
    model = mo_model(agt, X, b=MO_PARITY_B)
    if perm is not None:
        model = model.replace(Z=model.Z[:, perm].contiguous())
    model, ys_t = mo_treated(model, ys)
    state = agt.mo_init_state(model, X, ys_t)
    model, state = mo_steps(model, state, X, ys_t, 20, draws=draws.to(X.device))
    mu = state.mu.double().cpu()
    return (mu if perm is None else mu[:, torch.argsort(perm)]), model.A.double().cpu()


def mo_err(a, b):
    """max |d mu| / max |mu| and max |d A| between two mo_after_20 results."""
    return max(float((a[0] - b[0]).abs().max() / b[0].abs().max()), float((a[1] - b[1]).abs().max()))


def phase_mo_parity(agt, ck, device):
    """20 steps of phase 35's model on N=PN rows at B=MO_PARITY_B from fed
    iid indices: card (float32) against CPU (float32) within
    ORACLE_DEVICE_FACTOR times the CPU's own float32 noise (the CPU run
    again with Z reordered), with no fixed floor; the card against the card
    with the plain versions in kernels 4 and 5's place within that noise."""
    t0 = time.perf_counter()
    Xc, _, ysc = mo_data(PN, "cpu", seed=1)
    draws = torch.randint(0, PN, (20, MO_PARITY_B), generator=torch.Generator().manual_seed(1))
    Xd, ysd = Xc.to(device), tuple(y.to(device) for y in ysc)
    cpu = mo_after_20(agt, Xc, ysc, draws)
    card = mo_after_20(agt, Xd, ysd, draws)
    with plain_kernels(ck, SPLIT_PAIRS):
        card_plain = mo_after_20(agt, Xd, ysd, draws)
    perm = torch.randperm(MO_M, generator=torch.Generator().manual_seed(2))
    noise = mo_err(mo_after_20(agt, Xc, ysc, draws, perm), cpu)
    e, e_plain = mo_err(card, cpu), mo_err(card, card_plain)
    tol = ORACLE_DEVICE_FACTOR * noise
    log(f"mo parity (N={PN}, B={MO_PARITY_B}, M={MO_M}, 20 steps; mu and A): card (float32) vs CPU (float32) {e:.3e} "
        f"(bound {tol:.3e}, {e / tol:.3f} of it), vs the card with the plain versions {e_plain:.3e} (bound "
        f"{noise:.3e}, {e_plain / noise:.3f} of it); CPU with Z reordered vs CPU {noise:.3e}; "
        f"{time.perf_counter() - t0:.2f} s")
    if not (e <= tol and e_plain <= noise):
        raise AssertionError(f"mo parity: {e:.3e} (bound {tol:.3e}), {e_plain:.3e} (bound {noise:.3e})")
    return {"card_cpu": e, "card_plain": e_plain, "noise": noise}


def profile_mo(agt, device):
    """``python3 chip_smoke.py profile mo``: torch.profiler over 20 steps of
    phase 35's model after 30: wall and device-busy time a step, the idle
    share, launches and device ops a step, the device time by kernel."""
    X, _, ys = mo_data(MO_N, device)
    model, ys_t = mo_treated(mo_model(agt, X), ys)
    state = agt.mo_init_state(model, X, ys_t)
    gen = torch.Generator(device=device).manual_seed(0)
    model, state = mo_steps(model, state, X, ys_t, 30, gen)
    p = profile_window(lambda: mo_steps(model, state, X, ys_t, 20, gen), 20)
    log_profile("profile mo", p, 25)
    return p


def slice_h_mode(agt, ck, device):
    """``python3 chip_smoke.py slice-h``: phases 34-37 alone."""
    out = {"vstp": timed_phase("vstp", phase_vstp, agt, ck, device)}
    out["mo"] = timed_phase("mo", phase_mo, agt, ck, device)
    out["mo_small"] = timed_phase("mo small paths", phase_mo_small, agt, ck, device)
    out["mo_parity"] = timed_phase("mo parity", phase_mo_parity, agt, ck, device)
    out["ar"] = timed_phase("ar", phase_ar, agt, ck, device)
    return out


def slice_h_cpu_mode(agt):
    """``python3 chip_smoke.py slice-h-cpu``: the paths of phases 34-37 in
    float64 on the host's CPU, CPU draws, no floors held: the source of
    SLICE_H_FLOORS."""
    from agp_tpu_torch.ops import cuda_kernels as ck

    torch.set_num_threads(min(torch.get_num_threads(), 8))
    r = vstp_run(agt, ck, "cpu", dtype=torch.float64)
    log(f"vstp on the CPU, float64: RMSE {r['rmse']:.5f}, chi {r['chi'].tolist()}, {r['seconds']:.2f} s")
    for hyper in (False, True):
        r = mo_run(agt, ck, "cpu", hyper=hyper, dtype=torch.float64)
        log(f"mo{'h' if hyper else ''} on the CPU, float64: RMSE {r['rmse']:.5f}, moved {r['moved']:.4f}, "
            f"{r['seconds']:.2f} s")
    r = mo_small_runs(agt, ck, "cpu", torch.float64)
    log(f"mo small paths on the CPU, float64: mo_proba_y {r['proba']}, Q=1 RMSE {r['q1']:.5f}, MOVGP RMSE "
        f"{r['movgp'][0]:.5f}, accuracy {r['movgp'][1]:.4f}")


# ------------------------------------------- Slices J and K (phases 38-41)
# phase 38: the flagship's checkpoint after JK_HALF of 2 x JK_HALF steps
# (fed draws); a float64 CPU checkpoint onto a float32 card template; phase
# 27's online model and phase 35's MOSVGP round-tripped (JK_MO_ITERS, then
# JK_MO_RESUME more on both)
JK_HALF, JK_MO_ITERS, JK_MO_RESUME = 150, 20, 5
# phase 39: benchmarks/scaling.py's tpu1m configuration (:300-330, defaults
# :356-362: N=1,000,000, D=8, M=64, batch_per_device 512, slice; its data
# and Z made with numpy seed 0), the rates' steps, the bit-equality steps
TPU1M_N, TPU1M_D, TPU1M_M, TPU1M_B = 1_000_000, 8, 64, 512
JK_RATE_STEPS, JK_RATE_ROUNDS, JK_BIT_STEPS, JK_PAIR_STEPS = 250, 4, 300, 20
# calls of the seam's timing (phase 39 over NCCL, phase 40 over gloo)
JK_SEAM_CALLS = 1000
# phase 40: two processes on the one card over gloo: the flagship through
# sharded_svi_train at batch_per_device B/2 (JK_SVI_STEPS, the checkpoint of
# phase 41 after JK_SVI_SAVE, the last JK_SVI_STEPS - JK_SVI_SAVE timed),
# sharded_train on JK_FULL_N rows (a pad row at world 2) for logistic and
# Poisson and mo_sharded_train on phase 35's data at full batch, each
# JK_FULL_ITERS iterations
JK_WORLD, JK_SVI_STEPS, JK_SVI_SAVE, JK_FULL_N, JK_FULL_ITERS = 2, 100, 50, 200_001, 20
# then JK_PROFILE_STEPS steps more, rank 0's profiled
JK_PROFILE_STEPS = 20
# floors from ``python3 chip_smoke.py slice-jk-cpu`` (the same paths at
# world 1 in float64 on the card's host's CPU): the flagship SVI's and the
# logistic path's training accuracy (0.89617, 0.87256 there; floor the
# flagship's MIN_FLAGSHIP_ACC), the Poisson path's correlation of
# predict_y with the true rate (0.61093 there, above 0.55), the MOSVGP's
# RMSE of task 0 after its 20 full-batch iterations (0.36041, below 0.45)
SLICE_JK_FLOORS = {"svi": MIN_FLAGSHIP_ACC, "logistic": MIN_FLAGSHIP_ACC, "poisson": 0.55, "mo": 0.45}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def poisson_full_data(device, n=JK_FULL_N, seed=0, dtype=torch.float32):
    """Phase 40's Poisson data: X the flagship's rule in D=20 (numpy seed),
    f = 0.5 sin(x_0) + 0.5 x_1, y ~ Poisson(3 sigma(f)): (X, y, the rate)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D))
    rate = 3.0 / (1.0 + np.exp(-(0.5 * np.sin(X[:, 0]) + 0.5 * X[:, 1])))
    y = rng.poisson(rate).astype(float)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (X, y, rate))


def tpu1m_data(device, dtype=torch.float32):
    """benchmarks/scaling.py's _data and _build_model's Z, with numpy seed 0."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((TPU1M_N, TPU1M_D)).astype(np.float32)
    w = rng.standard_normal(TPU1M_D).astype(np.float32)
    y = np.where(X @ w > 0, 1.0, -1.0).astype(np.float32)
    Z = np.random.default_rng(0).standard_normal((TPU1M_M, TPU1M_D)).astype(np.float32)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (X, y, Z))


def tpu1m_model(agt, Z, b=TPU1M_B):
    return agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                           agt.AnalyticSVI(b, minibatch_sampling="slice"), Z, optimiser=None)


def full_data(device, which, dtype=torch.float32):
    """Phase 40's full-batch data: (X, y, truth) of the flagship's rule on
    JK_FULL_N rows (truth None), or of ``poisson_full_data`` (the rate)."""
    if which == "logistic":
        X, y = flagship_data(device, n=JK_FULL_N, seed=2)
        return X.to(dtype), y.to(dtype), None
    return poisson_full_data(device, dtype=dtype)


def full_metric(agt, which, model, state, X, y, truth):
    """The logistic path's training accuracy; the Poisson one's correlation
    of predict_y with the true rate."""
    pred = agt.predict_y(model, state, X)
    if which == "logistic":
        return float((pred == y).double().mean())
    return float(np.corrcoef(pred.double().cpu().numpy(), truth.double().cpu().numpy())[0, 1])


def full_model(agt, X, which):
    """Phase 40's full-batch models on Z = X[:M]: the flagship's kernel with
    the logistic or the Poisson likelihood, AnalyticVI."""
    lik = agt.LogisticLikelihood.create() if which == "logistic" else agt.PoissonLikelihood.create()
    return agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), lik, agt.AnalyticVI(), X[:M], optimiser=None)


def states_equal(a, b, names=("eta1", "eta2", "mu", "Sigma")):
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in names)


def leaves_equal(a, b):
    """Two (model, state) pairs have the same named leaves, bit for bit."""
    from agp_tpu_torch.training.checkpoint import named_leaves

    for x, y, name in ((a[0], b[0], "model"), (a[1], b[1], "state")):
        la, lb = named_leaves(x, name), named_leaves(y, name)
        if [p for p, _ in la] != [p for p, _ in lb]:
            return False
        if not all(u.dtype == v.dtype and u.device == v.device and torch.equal(u, v) for (_, u), (_, v) in zip(la, lb)):
            return False
    return True


def phase_checkpoints(agt, ck, device, root):
    """Phase 38: checkpoints on the card.  (a) The flagship's state after
    JK_HALF steps saved, loaded onto a fresh card template and trained
    JK_HALF more: bit-equal to 2 x JK_HALF uninterrupted steps on the same
    draws, kernel 1 once a step.  (b) A float64 CPU checkpoint of the same
    model (JK_HALF steps on the CPU) loaded onto a float32 card template
    trains JK_HALF more to the flagship's floor.  (c) Phase 27's online
    model (OIPS) after its stream, and (d) phase 35's MOSVGP after
    JK_MO_ITERS iterations: saved, loaded onto templates, every leaf
    bit-equal, resumed bit-equal (one more batch; JK_MO_RESUME iterations on
    fed draws, kernels 4 + 5 once each a step); (a) and (d) also by
    allow_pickle."""
    ckpt = agt.checkpoint
    X, y = flagship_data(device)
    draws = torch.randint(0, N // 64, (2 * JK_HALF, B // 64), generator=torch.Generator().manual_seed(4)).to(device)
    out = {}
    reset_launches(ck)
    t0 = time.perf_counter()
    m_all, s_all = agt.train(flagship_model(agt, X), X, y, iterations=2 * JK_HALF, draws=draws)
    m1, s1 = agt.train(flagship_model(agt, X), X, y, iterations=JK_HALF, draws=draws[:JK_HALF])
    ckpt.save(os.path.join(root, "flagship"), m1, s1)
    template = flagship_model(agt, X)
    m2, s2 = ckpt.load(os.path.join(root, "flagship"), template, agt.init_state(template, X, y))
    loaded = leaves_equal((m2, s2), (m1, s1))
    pickled = leaves_equal(ckpt.load(os.path.join(root, "flagship"), allow_pickle=True), (m1, s1))
    m2, s2 = agt.train(m2, X, y, iterations=JK_HALF, state=s2, draws=draws[JK_HALF:])
    sync(device)
    out["flagship_s"] = time.perf_counter() - t0
    expect_launches(ck, "checkpoint flagship", route_launches(4 * JK_HALF, "fused"))
    if not (loaded and pickled and states_equal(s2, s_all) and torch.equal(s2.local_vars["theta"], s_all.local_vars["theta"])):
        raise AssertionError(f"flagship checkpoint: loaded bit-equal {loaded}, by allow_pickle {pickled}, resumed "
                             f"bit-equal {states_equal(s2, s_all)}")
    log(f"checkpoint flagship: {JK_HALF} + {JK_HALF} steps through a checkpoint bit-equal to {2 * JK_HALF} "
        f"uninterrupted (mu, Sigma, eta, theta); the load by templates and by allow_pickle bit-equal; "
        f"{out['flagship_s']:.3f} s")

    Xc, yc = X.cpu().double(), y.cpu().double()
    m64, s64 = agt.train(flagship_model(agt, Xc), Xc, yc, iterations=JK_HALF, draws=draws[:JK_HALF].cpu())
    ckpt.save(os.path.join(root, "flagship64"), m64, s64)
    m3, s3 = ckpt.load(os.path.join(root, "flagship64"), template, agt.init_state(template, X, y))
    dtypes = {t.dtype for t in (s3.mu, s3.Sigma, s3.eta1, m3.Z, m3.kernel.lengthscale)}
    reset_launches(ck)
    m3, s3 = agt.train(m3, X, y, iterations=JK_HALF, state=s3, draws=draws[JK_HALF:])
    expect_launches(ck, "checkpoint float64", route_launches(JK_HALF, "fused"))
    acc = float((agt.predict_y(m3, s3, X) == y).float().mean())
    out["float64_acc"] = acc
    log(f"checkpoint float64 (CPU) -> float32 (card): dtypes {sorted(str(d) for d in dtypes)}, {JK_HALF} more steps "
        f"on the card, training accuracy {acc:.4f} (floor {MIN_FLAGSHIP_ACC})")
    if not (dtypes == {torch.float32} and acc >= MIN_FLAGSHIP_ACC):
        raise AssertionError(f"float64 checkpoint on a float32 template: dtypes {dtypes}, accuracy {acc:.4f}")

    r = online_run(agt, "oips", device)
    ckpt.save(os.path.join(root, "online"), r["model"], r["state"])
    Xo, _, yo = online_data("oips", device, torch.float32)
    mt, st = online_model(agt, "oips", device, torch.float32), None
    for i in range(2):
        mt, st = agt.online_train(mt, Xo[i * ONLINE_B:(i + 1) * ONLINE_B], yo[i * ONLINE_B:(i + 1) * ONLINE_B],
                                  state=st, iterations=ONLINE_ITERS)
    mo_, so_ = ckpt.load(os.path.join(root, "online"), mt, st)
    online_loaded = leaves_equal((mo_, so_), (r["model"], r["state"]))
    xb, yb = Xo[:ONLINE_B], yo[:ONLINE_B]
    a = agt.online_train(r["model"], xb, yb, state=r["state"], iterations=ONLINE_ITERS)
    b = agt.online_train(mo_, xb, yb, state=so_, iterations=ONLINE_ITERS)
    online_resumed = leaves_equal(a, b)
    log(f"checkpoint online (phase 27's OIPS stream, capacity 128): loaded bit-equal {online_loaded}, one more batch "
        f"bit-equal {online_resumed}")

    Xm, _, ys = mo_data(MO_N, device)
    model = mo_model(agt, Xm)
    reset_launches(ck)
    mm, sm = agt.mo_train(model, Xm, ys, iterations=JK_MO_ITERS, generator=torch.Generator(device=device).manual_seed(0))
    ckpt.save(os.path.join(root, "mo"), mm, sm)
    tmpl = mo_model(agt, Xm)
    tmpl_t, ys_t = mo_treated(tmpl, ys)
    m5, s5 = ckpt.load(os.path.join(root, "mo"), tmpl_t, agt.mo_init_state(tmpl_t, Xm, ys_t))
    mo_loaded = leaves_equal((m5, s5), (mm, sm)) and leaves_equal(ckpt.load(os.path.join(root, "mo"), allow_pickle=True),
                                                                   (mm, sm))
    mo_draws = torch.randint(0, MO_N, (JK_MO_RESUME, MO_B), generator=torch.Generator().manual_seed(5)).to(device)
    ra = agt.mo_train(mm, Xm, ys, iterations=JK_MO_RESUME, state=sm, draws=mo_draws)
    rb = agt.mo_train(m5, Xm, ys, iterations=JK_MO_RESUME, state=s5, draws=mo_draws)
    mo_resumed = states_equal(ra[1], rb[1]) and torch.equal(ra[0].A, rb[0].A)
    expect_launches(ck, "checkpoint mo", route_launches(JK_MO_ITERS + 2 * JK_MO_RESUME, "batched"))
    log(f"checkpoint mo (phase 35's MOSVGP, M={MO_M}, B={MO_B}, Q={MO_Q}): loaded bit-equal (templates, allow_pickle) "
        f"{mo_loaded}, {JK_MO_RESUME} more iterations bit-equal {mo_resumed}")
    if not (online_loaded and online_resumed and mo_loaded and mo_resumed):
        raise AssertionError("online or mo checkpoint not bit-equal")
    return out


def timed_run(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def seam_us(mesh, device, calls=None):
    """Host us a call of the mesh's all-reduce of the flagship's M + M^2
    floats, and of ``batch_sum(s1, S2)`` (cat, all-reduce, views; nothing
    at world 1), each over ``calls`` calls ending in a synchronize."""
    from agp_tpu_torch.utils.batch_sums import batch_sum, sharded

    calls = JK_SEAM_CALLS if calls is None else calls
    s1, S2 = torch.randn(1, M, device=device), torch.randn(1, M, M, device=device)
    flat = torch.cat([s1.reshape(-1), S2.reshape(-1)])
    out = {}
    with sharded(mesh):
        for name, fn in (("all_reduce", lambda: mesh.all_reduce(flat)), ("batch_sum", lambda: batch_sum(s1, S2))):
            for _ in range(10):
                fn()
            sync(device)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            sync(device)
            out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def phase_sharded_world1(agt, ck, device):
    """Phase 39: the sharded SVI trainer on one process over NCCL (world 1).
    The flagship (kernel 1) and tpu1m (kernel 1, slice) on fed draws are
    bit-equal to vi_steps on the same draws; their rates through
    sharded_svi_train against train's, in the same process (JK_RATE_ROUNDS
    rounds of the two, every other one in reverse order, the medians: the
    host's rate moves by a quarter between runs); the profiled launches and
    device time a step of each (a group of one runs no all-reduce, as the
    reference's one-device mesh runs no psum); the seam's host cost;
    logistic_m512_b65536 with fused=None takes kernels 6 + 7, JK_PAIR_STEPS
    steps with exact launches."""
    from agp_tpu_torch.parallel import mesh as pm
    from agp_tpu_torch.training.train import vi_steps
    from agp_tpu_torch.utils.batch_sums import batch_sum

    mesh = pm.initialize_distributed(f"localhost:{free_port()}", 1, 0, device=device)
    if mesh.size != 1 or (mesh.device.type == "cuda" and mesh.backend != "nccl"):
        raise AssertionError(f"world-1 mesh: {mesh}")
    out = {}
    try:
        for name in ("flagship", "tpu1m"):
            if name == "flagship":
                X, y = flagship_data(device)
                make = lambda b=B: flagship_model(agt, X, b)
                draws = torch.randint(0, N // 64, (JK_BIT_STEPS, B // 64), generator=torch.Generator().manual_seed(6))
                fed = draws
            else:
                X, y, Z = tpu1m_data(device)
                make = lambda b=TPU1M_B: tpu1m_model(agt, Z, b)
                draws = torch.randint(0, TPU1M_N - TPU1M_B + 1, (JK_BIT_STEPS,), generator=torch.Generator().manual_seed(6))
                fed = draws[:, None]
            draws, fed = draws.to(device), fed.to(device)
            model = make()
            _, ref = vi_steps(model, agt.init_state(model, X, y), X, y, JK_BIT_STEPS, draws=draws)
            reset_launches(ck)
            calls0 = batch_sum.calls
            _, st = pm.sharded_svi_train(make(), X, y, JK_BIT_STEPS, mesh=mesh, draws=fed)
            sync(device)
            reduces = (batch_sum.calls - calls0) / JK_BIT_STEPS
            launches = expect_launches(ck, f"{name} sharded world 1", route_launches(JK_BIT_STEPS, "fused"))
            equal = states_equal(st, ref) and torch.equal(st.local_vars["theta"], ref.local_vars["theta"])
            gen = lambda: torch.Generator(device=device).manual_seed(1)
            runs = {"train": lambda: agt.train(make(), X, y, iterations=JK_RATE_STEPS, generator=gen()),
                    "sharded": lambda: pm.sharded_svi_train(make(), X, y, JK_RATE_STEPS, mesh=mesh, generator=gen())}
            rates = {k: [] for k in runs}
            for i in range(JK_RATE_ROUNDS):  # the order reversed every other round
                for which in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
                    rates[which].append(JK_RATE_STEPS / timed_run(runs[which], device)[0])
            median = {k: float(np.median(v)) for k, v in rates.items()}
            m0 = make()
            s0 = agt.init_state(m0, X, y)
            steps, m1, s1, Xs, ys = pm.build_svi_trainer(make(), X, y, mesh)
            p_train = profile_window(lambda: vi_steps(m0, s0, X, y, 20, generator=gen()), 20)
            p_sharded = profile_window(lambda: steps(m1, s1, Xs, ys, 20, generator=gen()), 20)
            r = {"bit_equal": equal, "launches": launches, "all_reduces_a_step": reduces,
                 "ips": rates, "ratio": median["sharded"] / median["train"],
                 "train_profile": {k: p_train[k] for k in ("wall_us", "busy_us", "idle_share", "launches")},
                 "sharded_profile": {k: p_sharded[k] for k in ("wall_us", "busy_us", "idle_share", "launches")}}
            out[name] = r
            log(f"{name} sharded_svi_train (NCCL world 1, kernel 1, {JK_BIT_STEPS} fed steps): bit-equal to vi_steps "
                f"{equal}, {launches} launches, {reduces:g} all-reduces a step; {JK_RATE_ROUNDS} rounds of "
                f"{JK_RATE_STEPS} iterations (it/s): "
                + "; ".join(f"{k} {', '.join(f'{v:.1f}' for v in vals)}" for k, vals in rates.items())
                + f"; median sharded / train {r['ratio']:.4f}; profiled a step: "
                f"train {p_train['wall_us']:.1f} us wall, {p_train['busy_us']:.1f} us device, "
                f"{p_train['launches']:.1f} launches; sharded {p_sharded['wall_us']:.1f} us wall, "
                f"{p_sharded['busy_us']:.1f} us device, {p_sharded['launches']:.1f} launches")
            if not equal:
                raise AssertionError(f"{name}: sharded world 1 is not bit-equal to vi_steps")
        out["seam_us"] = seam_us(mesh, device)
        log(f"the seam at world 1 (NCCL), host us a call over {JK_SEAM_CALLS}: all-reduce of M + M^2 floats "
            f"{out['seam_us']['all_reduce']:.1f}, batch_sum(s1, S2) {out['seam_us']['batch_sum']:.1f}")
        X, y = big_logistic_data(device)
        reset_launches(ck)
        _, st = pm.sharded_svi_train(big_logistic_model(agt, X), X, y, JK_PAIR_STEPS, mesh=mesh, fused=None,
                                     generator=torch.Generator(device=device).manual_seed(1))
        launches = expect_launches(ck, "logistic_m512 sharded world 1", route_launches(JK_PAIR_STEPS, "single"))
        finite = bool(torch.isfinite(st.mu).all() and torch.isfinite(st.Sigma).all())
        out["logistic_m512"] = {"launches": launches, "finite": finite}
        log(f"logistic_m512_b65536 sharded_svi_train (NCCL world 1, fused=None): {launches} launches (kernels 6 + 7, "
            f"{JK_PAIR_STEPS} steps), finite {finite}")
        if not finite:
            raise AssertionError("logistic_m512 sharded: non-finite posterior")
    finally:
        torch.distributed.destroy_process_group()
    return out


def jk_rank(rank, world, init, root, device, backend):
    """``python3 chip_smoke.py jk-rank RANK WORLD INIT ROOT DEVICE BACKEND``:
    one process of phase 40 on DEVICE (cuda:0 for every rank over gloo;
    cuda:RANK over NCCL, ``slice-jk-nccl``).  Prints its launch counts as
    its last line; rank 0 writes its results to ROOT/rank0.pt and phase
    41's checkpoint to ROOT/svi50."""
    import agp_tpu_torch as agt
    from agp_tpu_torch.ops import cuda_kernels as ck
    from agp_tpu_torch.parallel import mesh as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(device)
    if device.type == "cuda":
        ck._library()  # built by the parent
    mesh = pm.initialize_distributed(init, world, rank, backend=backend, device=device)
    reset_launches(ck)
    res, seconds = {}, {}
    X, y = flagship_data(device)
    draws = torch.load(os.path.join(root, "draws.pt"))[:, rank].to(device)
    bpd = B // world
    model, state = flagship_model(agt, X), None
    t0 = time.perf_counter()
    model, state = pm.sharded_svi_train(model, X, y, JK_SVI_SAVE, mesh=mesh, batch_per_device=bpd, state=state,
                                        draws=draws[:JK_SVI_SAVE])
    local = pm.gather_local_vars(mesh, state.local_vars)
    if rank == 0:
        agt.checkpoint.save(os.path.join(root, "svi50"), model, state.replace(local_vars=local))
    sync(device)
    t1 = time.perf_counter()
    model, state = pm.sharded_svi_train(model, X, y, JK_SVI_STEPS - JK_SVI_SAVE, mesh=mesh, batch_per_device=bpd,
                                        state=state, draws=draws[JK_SVI_SAVE:])
    sync(device)
    seconds["svi_timed"] = time.perf_counter() - t1
    seconds["svi"] = time.perf_counter() - t0
    # JK_PROFILE_STEPS more on both ranks, rank 0's under the profiler
    steps, m_p, s_p, Xs, ys = pm.build_svi_trainer(model, X, y, mesh, bpd, state)
    run = lambda: steps(m_p, s_p, Xs, ys, JK_PROFILE_STEPS, draws=draws[-JK_PROFILE_STEPS:])
    if rank == 0:
        p = profile_window(run, JK_PROFILE_STEPS)
        seconds["profile"] = {k: p[k] for k in ("wall_us", "busy_us", "idle_share", "launches")}
    else:
        run()
    res["svi"] = (state.mu, state.Sigma)
    res["svi_acc"] = float((agt.predict_y(model, state, X) == y).float().mean())
    for which in ("logistic", "poisson"):
        Xf, yf, truth = full_data(device, which)
        t0 = time.perf_counter()
        m, s = pm.sharded_train(full_model(agt, Xf, which), Xf, yf, JK_FULL_ITERS, mesh=mesh)
        sync(device)
        seconds[which] = time.perf_counter() - t0
        res[which] = (s.mu, s.Sigma, getattr(m.likelihood, "lam", None))
        res[which + "_metric"] = full_metric(agt, which, m, s, Xf, yf, truth)
    Xm, fm, ys = mo_data(MO_N, device)
    t0 = time.perf_counter()
    m, s = pm.mo_sharded_train(mo_model(agt, Xm, b=None), Xm, ys, JK_FULL_ITERS, mesh=mesh)
    sync(device)
    seconds["mo"] = time.perf_counter() - t0
    res["mo"] = (s.mu, s.Sigma, m.A)
    mu, _ = agt.mo_predict_f(m, s, Xm[:MO_EVAL])
    res["mo_rmse"] = float(torch.sqrt(torch.mean((mu[0] - fm[:MO_EVAL]) ** 2)))
    seconds["seam_us"] = seam_us(mesh, device, calls=JK_SEAM_CALLS // 5)
    counts = {name: launches_of(ck, name) for name in LAUNCH_COUNTERS}
    if rank == 0:
        torch.save({"res": {k: tuple(t.cpu() if isinstance(t, torch.Tensor) else t for t in v) if isinstance(v, tuple)
                            else v for k, v in res.items()}, "seconds": seconds}, os.path.join(root, "rank0.pt"))
    torch.distributed.barrier()  # no rank tears down while another is still in a collective
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "launches": counts, "seconds": seconds}), flush=True)


def global_svi(agt, X, y, draws, world, start=0, state=None, model=None, perm=None, flip=False):
    """The world-1 run on phase 40's global rows: step i's batch is each
    rank's 64-row tiles of its own shard (rank r's rows start at r N /
    world), in rank order (reversed with ``flip``), through the
    single-device step (kernel 1 at the global B); from ``model`` and
    ``state`` at step ``start``; ``perm`` reorders Z.  Returns (model,
    state)."""
    from agp_tpu_torch.inference.analytic_vi import variational_update

    rows = X.shape[0] // world
    within = torch.arange(64, device=X.device)
    if model is None:
        model = flagship_model(agt, X)
        if perm is not None:
            model = model.replace(Z=model.Z[:, perm].contiguous())
        state = agt.init_state(model, X, y)
    for i in range(start, draws.shape[0]):
        idx = torch.cat([(r * rows + 64 * draws[i, r][:, None] + within).reshape(-1) for r in range(world)])
        idx = idx.flip(0) if flip else idx
        model, state = variational_update(model, state, X.index_select(0, idx), y.index_select(0, idx))
        state = state.replace(step=state.step + 1)
    return model, state


def mu_err(a, b, perm=None):
    a = a if perm is None else a[:, torch.argsort(perm)]
    return float((a.double().cpu() - b.double().cpu()).abs().max() / b.double().cpu().abs().max())


def phase_sharded_world(agt, ck, device, root, world=JK_WORLD, backend="gloo"):
    """Phase 40: two processes on the one card over gloo (CUDA tensors;
    NCCL refuses two ranks on one GPU), or ``world`` processes on as many
    cards over NCCL (``slice-jk-nccl``): the flagship through
    sharded_svi_train (kernel 1 on each rank's B/2 rows, fed per-rank tile
    draws), sharded_train on JK_FULL_N rows for logistic and Poisson (the
    pad row's mask: kernels 6 + 7) and mo_sharded_train on phase 35's data
    (kernels 4 + 5).  Rank 0's mu (and lambda, A) against a world-1 run on
    the same global rows, within ORACLE_DEVICE_FACTOR times the path's own
    float32 noise (the larger of the world-1 run again with Z reordered and
    with the batch's rows reordered: the sums over the batch are what the
    ranks split), and its
    metrics against SLICE_JK_FLOORS; the children's launches, exact, join
    the kernels line; rank 0's step profiled over JK_PROFILE_STEPS more
    steps.  Then phase 41: rank 0's checkpoint after
    JK_SVI_SAVE steps (the gathered local variables) loaded on one process
    and trained on the same global rows to JK_SVI_STEPS, against rank 0's
    uninterrupted run within the same noise."""
    from agp_tpu_torch.parallel import mesh as pm

    draws = torch.randint(0, (N // world) // 64, (JK_SVI_STEPS, world, B // world // 64),
                          generator=torch.Generator().manual_seed(7))
    torch.save(draws, os.path.join(root, "draws.pt"))
    init = f"file://{os.path.abspath(root)}/rendezvous"
    where = "one card" if backend == "gloo" else f"{world} cards"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "jk-rank", str(r), str(world), init, root,
                               str(device) if backend == "gloo" else f"cuda:{r}", backend],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    wall = time.perf_counter() - t0
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"jk-rank failed ({p.returncode}):\n{text[-4000:]}")
    reports = [json.loads(text.strip().splitlines()[-1]) for text in logs]
    want = {"fused_cavi_stats": JK_SVI_STEPS + JK_PROFILE_STEPS, "fused_kappa": 2 * JK_FULL_ITERS, "cavi_stats": 2 * JK_FULL_ITERS,
            "fused_kappa_moments_batched": JK_FULL_ITERS, "cavi_stats_batched": JK_FULL_ITERS}
    for rep in reports:
        got = {k: v for k, v in rep["launches"].items() if v}
        if got != want and device.type == "cuda":  # the CPU's plain versions launch nothing
            raise AssertionError(f"jk-rank {rep['rank']}: launched {got}, expected {want}")
        for k, v in got.items():
            LAUNCHES[k] = LAUNCHES.get(k, 0) + v
    r0 = torch.load(os.path.join(root, "rank0.pt"))
    res, seconds = r0["res"], r0["seconds"]
    X, y = flagship_data(device)
    draws_d = draws.to(device)
    perm = torch.randperm(M, generator=torch.Generator().manual_seed(2)).to(device)
    _, w1 = global_svi(agt, X, y, draws_d, world)
    _, w1p = global_svi(agt, X, y, draws_d, world, perm=perm)
    _, w1f = global_svi(agt, X, y, draws_d, world, flip=True)
    noise = max(mu_err(w1p.mu, w1.mu, perm.cpu()), mu_err(w1f.mu, w1.mu))
    label = f"{backend} world {world}"
    share = {"svi": parity_check(f"jk svi {label}", mu_err(res["svi"][0], w1.mu), noise,
                                 what=f"rank 0 ({label}) vs world 1 on the same global rows")}
    tmpl = flagship_model(agt, X)
    m41, s41 = agt.checkpoint.load(os.path.join(root, "svi50"), tmpl, agt.init_state(tmpl, X, y))
    _, s41 = global_svi(agt, X, y, draws_d, world, start=JK_SVI_SAVE, state=s41, model=m41)
    share["resume"] = parity_check("jk svi resumed", mu_err(s41.mu, res["svi"][0]), noise,
                                   what=f"one process from rank 0's checkpoint at step {JK_SVI_SAVE} vs rank 0 at "
                                        f"{JK_SVI_STEPS}")
    mesh1 = pm.make_mesh(device)
    for which in ("logistic", "poisson"):
        Xf, yf, _ = full_data(device, which)
        m1, s1 = pm.sharded_train(full_model(agt, Xf, which), Xf, yf, JK_FULL_ITERS, mesh=mesh1)
        mp = full_model(agt, Xf, which)
        mp, sp = pm.sharded_train(mp.replace(Z=mp.Z[:, perm].contiguous()), Xf, yf, JK_FULL_ITERS, mesh=mesh1)
        rp = torch.randperm(JK_FULL_N, generator=torch.Generator().manual_seed(3)).to(device)
        mr, sr = pm.sharded_train(full_model(agt, Xf, which), Xf[rp], yf[rp], JK_FULL_ITERS, mesh=mesh1)
        noise_f = max(mu_err(sp.mu, s1.mu, perm.cpu()), mu_err(sr.mu, s1.mu))
        err = mu_err(res[which][0], s1.mu)
        if which == "poisson":
            lam1 = float(m1.likelihood.lam)
            noise_f = max(noise_f, *(abs(float(m.likelihood.lam) - lam1) / lam1 for m in (mp, mr)))
            err = max(err, abs(float(res[which][2]) - lam1) / lam1)
        share[which] = parity_check(f"jk {which} {label}", err, noise_f,
                                    what=f"rank 0 ({label}, masked) vs world 1 (max |d mu| / max |mu|"
                                         + (", |d lam| / lam)" if which == "poisson" else ")"))
    Xm, _, ys = mo_data(MO_N, device)
    m1, s1 = pm.mo_sharded_train(mo_model(agt, Xm, b=None), Xm, ys, JK_FULL_ITERS, mesh=mesh1)
    perm_m = torch.randperm(MO_M, generator=torch.Generator().manual_seed(2)).to(device)
    mp = mo_model(agt, Xm, b=None)
    mp, sp = pm.mo_sharded_train(mp.replace(Z=mp.Z[:, perm_m].contiguous()), Xm, ys, JK_FULL_ITERS, mesh=mesh1)
    rp = torch.randperm(MO_N, generator=torch.Generator().manual_seed(3)).to(device)
    mr, sr = pm.mo_sharded_train(mo_model(agt, Xm, b=None), Xm[rp], tuple(y[rp] for y in ys), JK_FULL_ITERS,
                                 mesh=mesh1)
    noise_m = max(mu_err(sp.mu, s1.mu, perm_m.cpu()), float((mp.A - m1.A).abs().max()),
                  mu_err(sr.mu, s1.mu), float((mr.A - m1.A).abs().max()))
    err_m = max(mu_err(res["mo"][0], s1.mu), float((res["mo"][2].to(device) - m1.A).abs().max()))
    share["mo"] = parity_check(f"jk mo {label}", err_m, noise_m, what=f"rank 0 ({label}) vs world 1 (mu and A)")
    metrics = {"svi": res["svi_acc"], "logistic": res["logistic_metric"], "poisson": res["poisson_metric"],
               "mo": res["mo_rmse"]}
    prof = seconds.pop("profile")
    log(f"jk {label} (CUDA tensors, {where}): {wall:.2f} s for the {world} processes; rank 0 seconds "
        f"{json.dumps({k: round(v, 3) for k, v in seconds.items() if k != 'seam_us'})}; rank 0's profiled step "
        f"{prof['wall_us']:.1f} us wall, {prof['busy_us']:.1f} us device, idle share {prof['idle_share']:.4f}, "
        f"{prof['launches']:.1f} launches; the seam, host us a call: all-reduce "
        f"{seconds['seam_us']['all_reduce']:.1f}, batch_sum {seconds['seam_us']['batch_sum']:.1f}; flagship SVI "
        f"{(JK_SVI_STEPS - JK_SVI_SAVE) / seconds['svi_timed']:.1f} it/s over its last {JK_SVI_STEPS - JK_SVI_SAVE} "
        f"steps (B/{world} = {B // world} rows a rank); metrics {json.dumps(metrics)} (floors {SLICE_JK_FLOORS}); "
        f"parity shares {json.dumps({k: round(v, 4) for k, v in share.items()})}")
    floors_ok = all(metrics[k] <= v if k == "mo" else metrics[k] >= v for k, v in SLICE_JK_FLOORS.items())
    if not floors_ok:
        raise AssertionError(f"jk {label} metrics {metrics} miss SLICE_JK_FLOORS {SLICE_JK_FLOORS}")
    return {"wall_s": wall, "seconds": seconds, "profile": prof, "metrics": metrics, "share": share,
            "svi_ips": (JK_SVI_STEPS - JK_SVI_SAVE) / seconds["svi_timed"]}


def slice_jk_nccl_mode(agt, ck, device):
    """``python3 chip_smoke.py slice-jk-nccl``: phases 40-41 over NCCL with
    one process on each card of the machine (a 4-card call), against world
    1 on cuda:0."""
    import tempfile

    world = torch.cuda.device_count()
    if world < 2:
        raise SystemExit(f"slice-jk-nccl needs two cards or more; {world} here")
    root = tempfile.mkdtemp(prefix="jk-nccl-", dir=os.environ.get("TMPDIR"))
    return timed_phase(f"sharded world {world} (NCCL) and resume", phase_sharded_world, agt, ck, device, root,
                       world=world, backend="nccl")


def path_a_split(agt, ck, device):
    """ROADMAP queue 3 item 5: path A's 20 iterations (phase 15) on the card
    with kernel 1 alone in its plain version, then kernel 6 alone, each
    against the card with both kernels, as shares of the path's own float32
    noise (the CPU run again with Z reordered, as phase 15 measures it)."""
    def after(model, X, y, draws):
        model, state = agt.train(model, X, y, iterations=20, draws=draws.to(X.device))
        return state.mu.double().cpu(), log_hypers(model)

    def err(a, b, perm=None):
        mu = a[0] if perm is None else a[0][:, torch.argsort(perm)]
        return max(float((mu - b[0]).abs().max() / b[0].abs().max()), float((a[1] - b[1]).abs().max()))

    Xc, yc = flagship_data("cpu", n=PN, seed=1)
    draws = torch.randint(0, PN // 64, (20, B // 64), generator=torch.Generator().manual_seed(1))
    perm = torch.randperm(M, generator=torch.Generator().manual_seed(2))
    Xd, yd = Xc.to(device), yc.to(device)
    cpu = after(hyper_path(agt, Xc, "A"), Xc, yc, draws)
    mp = hyper_path(agt, Xc, "A")
    noise = err(after(mp.replace(Z=mp.Z[:, perm].contiguous()), Xc, yc, draws), cpu, perm)
    card = after(hyper_path(agt, Xd, "A"), Xd, yd, draws)
    out = {"noise": noise}
    for names in (("fused_cavi_stats",), ("fused_kappa",), ("fused_cavi_stats", "fused_kappa")):
        with plain_kernels(ck, names):
            e = err(card, after(hyper_path(agt, Xd, "A"), Xd, yd, draws))
        out[" + ".join(names)] = e / noise
    log(f"path A split (queue 3 item 5): card vs the card with plain versions, as shares of the noise {noise:.3e}: "
        + "; ".join(f"{k} plain {v:.3f}" for k, v in out.items() if k != "noise"))
    return out


def slice_jk_mode(agt, ck, device):
    """``python3 chip_smoke.py slice-jk``: phases 38-41 and path A's split."""
    import tempfile

    root = tempfile.mkdtemp(prefix="jk-", dir=os.environ.get("TMPDIR"))
    out = {"checkpoints": timed_phase("checkpoints", phase_checkpoints, agt, ck, device, root)}
    out["world1"] = timed_phase("sharded world 1", phase_sharded_world1, agt, ck, device)
    out["world2"] = timed_phase("sharded world 2 and resume", phase_sharded_world, agt, ck, device, root)
    out["path_a_split"] = timed_phase("path A split", path_a_split, agt, ck, device)
    return out


def slice_jk_cpu_mode(agt):
    """``python3 chip_smoke.py slice-jk-cpu``: phase 40's paths at world 1 in
    float64 on the host's CPU, on the same global rows, no floors held:
    the source of SLICE_JK_FLOORS."""
    from agp_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(min(torch.get_num_threads(), 8))
    cpu, f64 = torch.device("cpu"), torch.float64
    draws = torch.randint(0, (N // JK_WORLD) // 64, (JK_SVI_STEPS, JK_WORLD, B // JK_WORLD // 64),
                          generator=torch.Generator().manual_seed(7))
    X, y = (t.double() for t in flagship_data(cpu))
    t0 = time.perf_counter()
    m, s = global_svi(agt, X, y, draws, JK_WORLD)
    log(f"jk svi on the CPU, float64: accuracy {float((agt.predict_y(m, s, X) == y).double().mean()):.5f}, "
        f"{time.perf_counter() - t0:.2f} s")
    mesh = pm.make_mesh(cpu)
    for which in ("logistic", "poisson"):
        t0 = time.perf_counter()
        Xf, yf, truth = full_data(cpu, which, f64)
        m, s = pm.sharded_train(full_model(agt, Xf, which), Xf, yf, JK_FULL_ITERS, mesh=mesh)
        metric = full_metric(agt, which, m, s, Xf, yf, truth)
        log(f"jk {which} on the CPU, float64: {'accuracy' if which == 'logistic' else 'corr with the rate'} "
            f"{metric:.5f}, {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    Xm, fm, ys = mo_data(MO_N, cpu, f64)
    m, s = pm.mo_sharded_train(mo_model(agt, Xm, b=None), Xm, ys, JK_FULL_ITERS, mesh=mesh)
    mu, _ = agt.mo_predict_f(m, s, Xm[:MO_EVAL])
    log(f"jk mo on the CPU, float64: RMSE {float(torch.sqrt(torch.mean((mu[0] - fm[:MO_EVAL]) ** 2))):.5f}, "
        f"{time.perf_counter() - t0:.2f} s")


# ------------------------------------------------- Slice L (phases 42-45)
# path 42: the flagship's configuration (N, D, M, B, block sampling, float32)
# with with_transform(SqExponentialKernel(), LinearTransform(A0)) +
# LinearKernel(variance=0.1), A0 [SL_Q, D] standard normal from numpy seed 4
# scaled by 1/sqrt(D) (unit-variance projected coordinates), and
# SVGP.create's default Adam(0.01) every iteration (path A's rhythm):
# tests/test_components.py:147-172's model at the flagship's shape
SL_Q, SL_SEED, SL_ITERS, SL_TIMED, SL_FIXED_TIMED, SL_PROFILED = 4, 4, 100, 60, 300, 20
# phase 44: every form of tests/test_components.py:13-45 and FBM at a
# saturated Hurst index, gram [SL_GB, SL_GM] and diag, D=20; path 44:
# logistic_m512_b65536 with SqExponentialKernel + Matern52Kernel (each at the
# bench's lengthscale 2) at fixed hyperparameters, SL_BIG_STEPS steps
SL_GB, SL_GM, SL_BIG_STEPS = 4096, 512, 20
# phase 45: the flagship with AnalyticSVI(B, optimiser=alrsvi()) for
# MAIN_STEPS steps; a VGP with an AffineMean on phase 20a's data (N=VN,
# D=2, Student-t(4), Matern-5/2, default Adam) for V_ITERS iterations; the
# metrics on SL_EVAL training rows of path 42; profiling.trace around
# SL_TRACE iterations of path 42
SL_EVAL, SL_TRACE = 8192, 5
# floors from ``python3 chip_smoke.py slice-l-cpu`` (the same paths in
# float64 on the card's host's CPU, CPU draws): accuracy 0.99579 (path
# 42), 0.88626 (43), 0.97928 (44), 0.89625 (alrsvi), RMSE 0.03212 (the
# AffineMean VGP).  Each is about three times the CPU's error, or the
# earlier bound where that is tighter: bench.py's multiclass 0.8 for path
# 43 (3x gives 0.66), the flagship's 0.8 for alrsvi (3x gives 0.69).
SLICE_L_FLOORS = {"path42": 0.98, "path43": MIN_MC_ACC, "path44": 0.93, "alrsvi": MIN_FLAGSHIP_ACC,
                  "affine": 0.096}


def slice_l_kernel(agt):
    """Path 42's kernel: a learnt linear projection of the inputs to SL_Q
    dimensions under a squared exponential, plus a linear trend."""
    A0 = np.random.default_rng(SL_SEED).normal(size=(SL_Q, D)) / np.sqrt(D)
    proj = agt.with_transform(agt.SqExponentialKernel(), agt.LinearTransform(A=torch.as_tensor(A0)))
    return proj + agt.LinearKernel(variance=0.1)


def path42_model(agt, X, b=B, optimiser="default"):
    return agt.SVGP.create(slice_l_kernel(agt), agt.LogisticLikelihood.create(),
                           agt.AnalyticSVI(b, minibatch_sampling="block"), X[:M], optimiser=optimiser)


def unconstrained_hypers(model):
    """The kernel's unconstrained parameters (log, logit or as they are),
    flattened in path order, float64 on the CPU."""
    from agp_tpu_torch.kernels import to_unconstrained
    from agp_tpu_torch.utils.tensors import path_leaves

    return torch.cat([v.reshape(-1) for v in path_leaves(to_unconstrained(model.kernel)).values()]).double().cpu()


def path42_run(agt, ck, device, dtype=torch.float32):
    """Path 42 through agp_tpu_torch.train: {"acc", "A_moved", "positive",
    "finite", "seconds"} and, on the card, its exact launches (kernel 7
    once a CAVI step, nothing else: the plain kappa and the hyperparameter
    step by autograd launch no kernel of the port), "ips" over SL_TIMED
    iterations, "fixed_ips" over SL_FIXED_TIMED steps at fixed
    hyperparameters, and the model and state."""
    from agp_tpu_torch.training.train import vi_steps
    from agp_tpu_torch.utils.tensors import path_leaves

    X, y = (t.to(dtype) for t in flagship_data(device))
    model = path42_model(agt, X)
    A0 = model.kernel.left.transform.A.clone()
    gen = torch.Generator(device=device).manual_seed(0)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        reset_launches(ck)
    sync(device)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=SL_ITERS, generator=gen)
    sync(device)
    out = {"seconds": time.perf_counter() - t0}
    if cuda:
        out["launches"] = expect_launches(ck, "path 42", {"cavi_stats": SL_ITERS})
    A = model.kernel.left.transform.A
    leaves = path_leaves(model.kernel)
    out["A_moved"] = float((A - A0).abs().max())
    out["positive"] = all(bool((v > 0).all()) for k, v in leaves.items() if not k.endswith("transform.A"))
    out["finite"] = all(bool(torch.isfinite(t).all()) for t in [state.mu, state.Sigma, *leaves.values()])
    out["acc"] = float((agt.predict_y(model, state, X) == y).double().mean())
    out["model"], out["state"], out["X"], out["y"] = model, state, X, y
    if cuda:
        t0 = time.perf_counter()
        agt.train(model, X, y, iterations=SL_TIMED, state=state, generator=gen)
        sync(device)
        out["ips"] = SL_TIMED / (time.perf_counter() - t0)
        fixed = model.replace(optimiser=None)
        vi_steps(fixed, state, X, y, 20, generator=gen)
        sync(device)
        t0 = time.perf_counter()
        vi_steps(fixed, state, X, y, SL_FIXED_TIMED, generator=gen)
        sync(device)
        out["fixed_ips"] = SL_FIXED_TIMED / (time.perf_counter() - t0)
    return out


def check_path42(r, floor):
    if not (r["finite"] and r["positive"] and r["A_moved"] > MIN_HYPER_MOVE and r["acc"] >= floor):
        raise AssertionError(f"path 42: accuracy {r['acc']:.5f} (floor {floor}), A moved {r['A_moved']:.3e}, "
                             f"positive leaves {r['positive']}, finite {r['finite']}")


def profile_iterations(agt, model, state, X, y, gen, n, hyper):
    """n iterations of ``model`` on its minibatches: a CAVI step each and,
    with ``hyper``, a hyperparameter step on the same batch."""
    from agp_tpu_torch.inference import analytic_vi
    from agp_tpu_torch.training import autotuning
    from agp_tpu_torch.training.train import _minibatches

    for x_b, y_b in _minibatches(model, X, y, n, generator=gen):
        model, state = analytic_vi.variational_update(model, state, x_b, y_b)
        if hyper:
            model, state = autotuning.hyper_step(model, state, x_b, y_b)
    return model, state


def phase_path42(agt, ck, device):
    """Phase 42: path 42 through agp_tpu_torch.train (exact launches: kernel
    7 once a CAVI step, kernels 1 and 6 never), its accuracy floor, A moved,
    finite, the positive leaves positive; its rate with the hyperparameter
    step and at fixed hyperparameters; then SL_PROFILED profiled iterations
    of it with and without the hyperparameter step, beside the flagship's
    (kernel 1) and path A's (kernel 1, kernel 6 in the hyperparameter step)
    on the same host: idle share, launches and device time an iteration,
    the peak memory; then 20 iterations card vs CPU."""
    r = path42_run(agt, ck, device)
    check_path42(r, SLICE_L_FLOORS["path42"])
    model, state, X, y = r["model"], r["state"], r["X"], r["y"]
    k = model.kernel
    log(f"path 42 (flagship shape, SqExp o LinearTransform [{SL_Q}, {D}] + Linear, Adam(0.01) every iteration): "
        f"{SL_ITERS} iterations through agp_tpu_torch.train in {r['seconds']:.3f} s, {r['launches']} launches, "
        f"accuracy {r['acc']:.5f} (floor {SLICE_L_FLOORS['path42']}), A moved {r['A_moved']:.4f}, lengthscale "
        f"{float(k.left.inner.lengthscale[0]):.4f}, linear variance {float(k.right.variance[0]):.4f}; steady "
        f"{r['ips']:.2f} iterations/s over {SL_TIMED} (hyperparameter step each), {r['fixed_ips']:.2f} it/s at fixed "
        f"hyperparameters over {SL_FIXED_TIMED}")
    gen = torch.Generator(device=device).manual_seed(1)
    out = {k2: r[k2] for k2 in ("acc", "A_moved", "seconds", "ips", "fixed_ips", "launches")}
    flag = flagship_model(agt, X)
    flag_state = agt.init_state(flag, X, y)
    fa = flagship_model(agt, X, optimiser="default")
    cases = (("path 42 with the hyperparameter step", model, state, True),
             ("path 42 at fixed hyperparameters", model.replace(optimiser=None), state, False),
             ("flagship at fixed hyperparameters (kernel 1)", flag, flag_state, False),
             ("path A with the hyperparameter step (kernels 1 and 6)", fa, agt.init_state(fa, X, y), True))
    for label, m, s, hyper in cases:
        m, s = profile_iterations(agt, m, s, X, y, gen, 10, hyper)
        torch.cuda.reset_peak_memory_stats()
        p = profile_window(lambda: profile_iterations(agt, m, s, X, y, gen, SL_PROFILED, hyper), SL_PROFILED)
        p["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log_profile(f"profile {label}", p, 8)
        log(f"  peak device memory {p['peak_gib']:.3f} GiB")
        out[label] = {k2: p[k2] for k2 in ("wall_us", "busy_us", "idle_share", "launches", "ops", "peak_gib")}
    out["parity"] = path42_parity(agt, device)
    out["run"] = r
    return out


def path42_after(agt, X, y, draws, perm=None):
    """mu and the unconstrained hyperparameters after 20 iterations of path
    42 (B=B on X's rows, Adam every iteration from the 3rd), float64 on the
    CPU; ``perm`` reorders the inducing points (undone on mu)."""
    model = path42_model(agt, X)
    if perm is not None:
        model = model.replace(Z=model.Z[:, perm].contiguous())
    model, state = agt.train(model, X, y, iterations=20, draws=draws.to(X.device))
    mu = state.mu.double().cpu()
    return (mu if perm is None else mu[:, torch.argsort(perm)]), unconstrained_hypers(model)


def hyper_err(a, b):
    return max(float((a[0] - b[0]).abs().max() / b[0].abs().max()), float((a[1] - b[1]).abs().max()))


def path42_parity(agt, device):
    """20 iterations of path 42 on PN rows, the card (float32) against the CPU
    (float32) from the same draws, as max |d mu| / max |mu| and max |d
    unconstrained hyperparameter|, within ORACLE_DEVICE_FACTOR times the
    path's own float32 noise (the CPU run again with Z reordered)."""
    Xc, yc = flagship_data("cpu", n=PN, seed=1)
    draws = torch.randint(0, PN // 64, (20, B // 64), generator=torch.Generator().manual_seed(1))
    perm = torch.randperm(M, generator=torch.Generator().manual_seed(2))
    cpu = path42_after(agt, Xc, yc, draws)
    card = path42_after(agt, Xc.to(device), yc.to(device), draws)
    noise = hyper_err(path42_after(agt, Xc, yc, draws, perm), cpu)
    return parity_check("path 42", hyper_err(card, cpu), noise,
                        what="20 iterations (17 hyperparameter steps) card (float32) vs CPU (float32)")


def path43_run(agt, ck, device, dtype=torch.float32):
    """Path 43 (bench.py's multiclass configuration with
    RationalQuadraticKernel(alpha=2) at fixed hyperparameters) through
    agp_tpu_torch.train: {"acc", "finite", "seconds"}; on the card its
    exact launches (kernel 5 once a step, nothing else) and "ips" over
    MULTI_TIMED_STEPS steps."""
    from agp_tpu_torch.training.train import vi_steps

    X, y = mc_data(device)
    X = X.to(dtype)
    model = multi_model(agt, X, "multiclass", "RationalQuadraticKernel")
    gen = torch.Generator(device=device).manual_seed(0)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        reset_launches(ck)
    sync(device)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=MAIN_STEPS, generator=gen)
    sync(device)
    out = {"seconds": time.perf_counter() - t0}
    if cuda:
        out["launches"] = expect_launches(ck, "path 43", {"cavi_stats_batched": MAIN_STEPS})
    out["finite"] = bool(torch.isfinite(state.mu).all() and torch.isfinite(state.Sigma).all())
    out["acc"] = multi_quality(agt, model, state, X, y, "multiclass")
    if cuda:
        y_t = model.likelihood.treat_labels(y)[0].to(X.dtype)
        model, state = vi_steps(model, state, X, y_t, 20, generator=gen)
        sync(device)
        t0 = time.perf_counter()
        model, state = vi_steps(model, state, X, y_t, MULTI_TIMED_STEPS, generator=gen)
        sync(device)
        out["ips"] = MULTI_TIMED_STEPS / (time.perf_counter() - t0)
    out["model"], out["state"], out["X"] = model, state, X
    return out


def phase_path43(agt, ck, device):
    """Phase 43: path 43, its exact launches (kernel 5 once a step, kernels
    2 and 4 never), its accuracy floor and rate; then 20 steps card vs CPU
    within ORACLE_DEVICE_FACTOR times the path's own float32 noise."""
    from agp_tpu_torch.training.train import vi_steps

    r = path43_run(agt, ck, device)
    floor = SLICE_L_FLOORS["path43"]
    if not (r["finite"] and r["acc"] >= floor):
        raise AssertionError(f"path 43: accuracy {r['acc']:.5f} < {floor} or non-finite ({r['finite']})")
    log(f"path 43 (K={MK}, N={MN}, D={MD}, M={MM}, B={MB}, slice, RationalQuadratic(alpha=2)): {MAIN_STEPS} steps "
        f"through agp_tpu_torch.train in {r['seconds']:.3f} s, {r['launches']} launches, accuracy {r['acc']:.5f} "
        f"(floor {floor}); steady {r['ips']:.2f} CAVI iterations/s over {MULTI_TIMED_STEPS}")
    X, y_t = r["X"], r["model"].likelihood.treat_labels(mc_data(device)[1])[0].to(r["X"].dtype)
    gen = torch.Generator(device=device).manual_seed(1)
    p = profile_window(lambda: vi_steps(r["model"], r["state"], X, y_t, SL_PROFILED, generator=gen), SL_PROFILED)
    log_profile("profile path 43", p, 8)
    draws = torch.randint(0, MN - MB + 1, (20,), generator=torch.Generator().manual_seed(1))
    perm = torch.randperm(MM, generator=torch.Generator().manual_seed(2))
    Xc, yc = mc_data("cpu", seed=1)
    card, cpu = (after_20(agt, multi_model(agt, X, "multiclass", "RationalQuadraticKernel"), X, y, draws)
                 for X, y in ((Xc.to(device), yc.to(device)), (Xc, yc)))
    m = multi_model(agt, Xc, "multiclass", "RationalQuadraticKernel")
    mu_p, _ = after_20(agt, m.replace(Z=m.Z[:, perm].contiguous()), Xc, yc, draws)
    noise = rel_err((mu_p[:, torch.argsort(perm)], None), cpu)
    share = parity_check("path 43", rel_err(card, cpu), noise,
                         what="20 steps card (float32) vs CPU (float32), max |d mu| / max |mu|")
    out = {k: r[k] for k in ("acc", "seconds", "ips", "launches")}
    out.update(parity=share, idle_share=p["idle_share"], launches_per_step=p["launches"], busy_us=p["busy_us"])
    out["run"] = r
    return out


def library_forms(agt):
    """[(label, kernel)]: the 24 forms of tests/test_components.py:13-45
    (ALL_KERNELS) and FBM at a Hurst index saturated by a step of +50 in
    its logit (the reference's test_fbm_hurst_unit_constrained)."""
    from agp_tpu_torch.kernels import from_unconstrained, to_unconstrained

    forms = [
        agt.SqExponentialKernel(), agt.Matern12Kernel(), agt.Matern32Kernel(), agt.Matern52Kernel(),
        agt.RationalQuadraticKernel(), agt.PeriodicKernel(), agt.LinearKernel(), agt.PolynomialKernel(),
        agt.ConstantKernel(), agt.WhiteKernel(), agt.CosineKernel(), agt.ExponentiatedKernel(lengthscale=3.0),
        *(agt.PiecewisePolynomialKernel(lengthscale=2.0, degree=q) for q in range(4)),
        agt.FBMKernel(hurst=0.4), agt.GaborKernel(lengthscale=1.5, period=2.0), agt.NeuralNetworkKernel(),
        agt.SqExponentialKernel() + agt.Matern32Kernel(), agt.SqExponentialKernel() * agt.LinearKernel(),
        2.5 * agt.SqExponentialKernel(),
        agt.with_transform(agt.SqExponentialKernel(), agt.ScaleTransform(s=0.7)),
        agt.with_transform(agt.Matern32Kernel(), agt.ChainTransform(transforms=(
            agt.SelectTransform(dims=(0, 2)), agt.ARDTransform(v=torch.tensor([0.5, 2.0]))))),
    ]
    labels = [type(k).__name__ for k in forms]
    for q in range(4):
        labels[12 + q] += f"(degree={q})"
    labels[19:24] = ["Sum(SqExp, Matern32)", "Product(SqExp, Linear)", "2.5 x SqExp", "SqExp o Scale",
                     "Matern32 o Chain(Select, ARD)"]
    u = to_unconstrained(agt.FBMKernel(hurst=0.4))
    return list(zip(labels, forms)) + [("FBMKernel(saturated hurst)", from_unconstrained(u.replace(hurst=u.hurst + 50.0)))]


def phase_library(agt, ck, device):
    """Phase 44 (a): each form's gram [SL_GB, SL_GM] and diag [SL_GB] at
    D=20 on the card (float32) against the CPU's float64, within
    ORACLE_DEVICE_FACTOR times the CPU's own float32 error (max |d| / max
    |float64|, gram and diag together), no fixed floor; ms of each card
    gram (CUDA events)."""
    rng = np.random.default_rng(0)
    Xh, Zh = rng.normal(size=(SL_GB, D)), rng.normal(size=(SL_GM, D))
    out = {}
    for label, kern in library_forms(agt):
        def both(k, dev, dt):
            X, Z = (torch.as_tensor(a, dtype=dt, device=dev) for a in (Xh, Zh))
            k = k.to(device=dev, dtype=dt)
            return k.gram(X, Z).double().cpu(), k.diag(X).double().cpu()

        ref = both(kern, "cpu", torch.float64)

        def err(a):
            return max(float((a[i] - ref[i]).abs().max() / max(float(ref[i].abs().max()), 1e-300)) for i in (0, 1))

        e_card, noise = err(both(kern, device, torch.float32)), err(both(kern, "cpu", torch.float32))
        if noise == 0.0:  # exact in float32 on the CPU (a constant, zeros, a broadcast variance): so on the card
            if e_card != 0.0:
                raise AssertionError(f"library {label}: card {e_card:.3e} off float64 where the CPU's float32 is exact")
            log(f"library {label} parity: card (float32) and CPU (float32) both equal to float64")
            share = 0.0
        else:
            share = parity_check(f"library {label}", e_card, noise,
                                 what="gram and diag, card (float32) vs CPU float64")
        kc = kern.to(device=device, dtype=torch.float32)
        Xd, Zd = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (Xh, Zh))
        out[label] = {"err": e_card, "noise": noise, "share": share, "gram_ms": cuda_ms(lambda: kc.gram(Xd, Zd), 20)}
    return out


def big_sum_model(agt, X, b=LB):
    kernel = agt.SqExponentialKernel(lengthscale=2.0) + agt.Matern52Kernel(lengthscale=2.0)
    return agt.SVGP.create(kernel, agt.LogisticLikelihood.create(), agt.AnalyticSVI(b, minibatch_sampling="slice"),
                           X[:PM], optimiser=None)


def path44_run(agt, ck, device, dtype=torch.float32):
    """Path 44 (logistic_m512_b65536 with SqExp + Matern-5/2) through
    agp_tpu_torch.train, SL_BIG_STEPS steps: {"acc", "finite", "seconds"};
    on the card its exact launches (kernel 7 once a step, nothing else),
    the peak memory and the model and state."""
    X, y = big_logistic_data(device)
    X = X.to(dtype)
    model = big_sum_model(agt, X)
    gen = torch.Generator(device=device).manual_seed(0)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        reset_launches(ck)
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=SL_BIG_STEPS, generator=gen)
    sync(device)
    out = {"seconds": time.perf_counter() - t0}
    if cuda:
        out["launches"] = expect_launches(ck, "path 44", {"cavi_stats": SL_BIG_STEPS})
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["finite"] = bool(torch.isfinite(state.mu).all() and torch.isfinite(state.Sigma).all())
    out["acc"] = float((agt.predict_y(model, state, X) == y).double().mean())
    out["model"], out["state"], out["X"], out["y"] = model, state, X, y
    return out


def phase_path44(agt, ck, device):
    """Phase 44 (b): path 44, its exact launches, floor, peak memory, its
    steady rate and profiled step (idle share, device time a step), and the
    step's parts at its shape by CUDA events: each summand's gram [LB, PM],
    kappa's product Knm K^-1 and kernel 7."""
    from agp_tpu_torch.kernels import latent
    from agp_tpu_torch.ops.linalg import _highest_precision
    from agp_tpu_torch.training.train import vi_steps

    r = path44_run(agt, ck, device)
    floor = SLICE_L_FLOORS["path44"]
    if not (r["finite"] and r["acc"] >= floor):
        raise AssertionError(f"path 44: accuracy {r['acc']:.5f} < {floor} or non-finite ({r['finite']})")
    model, state, X, y = r["model"], r["state"], r["X"], r["y"]
    gen = torch.Generator(device=device).manual_seed(1)
    sync(device)
    t0 = time.perf_counter()
    vi_steps(model, state, X, y, SL_BIG_STEPS, generator=gen)
    sync(device)
    ips = SL_BIG_STEPS / (time.perf_counter() - t0)
    p = profile_window(lambda: vi_steps(model, state, X, y, 10, generator=gen), 10)
    log_profile("profile path 44", p, 12)
    x = X[:LB]
    k0, z = latent(model.kernel, 0), model.Z[0]
    K_inv = state.kmat["K_inv"][0]
    Knm = k0.gram(x, z)
    product = _highest_precision(lambda: Knm @ K_inv)
    kappa = product()
    g, th = torch.randn(LB, device=device), torch.rand(LB, device=device)
    parts = {
        "gram SqExp": cuda_ms(lambda: k0.left.gram(x, z), 20),
        "gram Matern52": cuda_ms(lambda: k0.right.gram(x, z), 20),
        "kappa product": cuda_ms(product, 20),
        "kernel 7": cuda_ms(lambda: ck.cavi_stats(kappa, g, th), 20),
    }
    ck.cavi_stats.launches = 0  # the parts' launches are not the path's
    log(f"path 44 (N={LN}, D={LD}, M={PM}, B={LB}, slice, SqExp + Matern52 at lengthscale 2): {SL_BIG_STEPS} steps "
        f"through agp_tpu_torch.train in {r['seconds']:.3f} s, {r['launches']} launches, accuracy {r['acc']:.5f} "
        f"(floor {floor}), peak {r['peak_gib']:.3f} GiB; steady {ips:.2f} CAVI iterations/s, device {p['busy_us']:.1f} "
        f"us a step, idle share {p['idle_share']:.4f}; parts (ms, CUDA events): "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    return {"acc": r["acc"], "seconds": r["seconds"], "launches": r["launches"], "peak_gib": r["peak_gib"],
            "ips": ips, "busy_us": p["busy_us"], "idle_share": p["idle_share"], "launches_per_step": p["launches"],
            "parts_ms": parts}


def alrsvi_model(agt, X, b=B):
    return agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0, variance=1.0), agt.LogisticLikelihood.create(),
                           agt.AnalyticSVI(b, minibatch_sampling="block", optimiser=agt.alrsvi()), X[:M],
                           optimiser=None)


def alrsvi_run(agt, ck, device, dtype=torch.float32):
    """The flagship with alrsvi in place of Robbins-Monro, MAIN_STEPS steps:
    {"acc", "finite", "seconds"}, on the card the exact launches (kernel 1
    once a step)."""
    X, y = (t.to(dtype) for t in flagship_data(device))
    model = alrsvi_model(agt, X)
    gen = torch.Generator(device=device).manual_seed(0)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        reset_launches(ck)
    sync(device)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=MAIN_STEPS, generator=gen)
    sync(device)
    out = {"seconds": time.perf_counter() - t0}
    if cuda:
        out["launches"] = expect_launches(ck, "alrsvi", route_launches(MAIN_STEPS, "fused"))
    out["finite"] = bool(torch.isfinite(state.mu).all() and torch.isfinite(state.opt_state["tau"]))
    out["acc"] = float((agt.predict_y(model, state, X) == y).double().mean())
    out["tau"] = float(state.opt_state["tau"])
    return out


def affine_vgp_run(agt, ck, device, dtype=torch.float32):
    """A VGP with an AffineMean (w = 0, b = 0, learnt by the default Adam
    with the kernel) on phase 20a's data: {"rmse", "finite", "seconds",
    "w"}; on the card no kernel launch."""
    X, f, y = (t.to(dtype) for t in dense_data("vgp_studentt", VN, device))
    model = agt.VGP.create(X, y, agt.Matern52Kernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticVI(),
                           mean=agt.AffineMean(w=torch.zeros(2), b=0.0))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        reset_launches(ck)
    sync(device)
    t0 = time.perf_counter()
    model, state = agt.train(model, iterations=V_ITERS)
    sync(device)
    out = {"seconds": time.perf_counter() - t0}
    if cuda:
        expect_launches(ck, "affine VGP", {})
    mu = agt.predict_f(model, state, X)
    out["rmse"] = float(torch.sqrt(torch.mean((mu - f) ** 2)))
    out["w"] = model.mean.w[0].double().cpu().tolist()
    out["finite"] = bool(torch.isfinite(state.mu).all() and torch.isfinite(model.mean.w).all())
    out["model"], out["state"] = model, state
    return out


def metrics_check(agt, r42, device):
    """The four metrics of utils.metrics on path 42's model over its first
    SL_EVAL training rows, the card (float32) against the same model on the CPU in
    float64: RMSE of the latent mean and NLPD within ORACLE_DEVICE_FACTOR
    times the CPU float32's own error; accuracy and coverage decision by
    decision wherever the float64 margin exceeds that factor times the
    float32 error of the latent moments."""
    from agp_tpu_torch.utils import metrics

    Xe, ye = r42["X"][:SL_EVAL].cpu(), r42["y"][:SL_EVAL].cpu()
    model, state = r42["model"], r42["state"]
    runs = {}
    for name, dev, dt in (("card", device, torch.float32), ("cpu32", "cpu", torch.float32), ("cpu64", "cpu", torch.float64)):
        m, s = model.to(device=dev, dtype=dt), state.to(device=dev, dtype=dt)
        X, y = Xe.to(device=dev, dtype=dt), ye.to(device=dev, dtype=dt)
        mu, var = agt.predict_f(m, s, X, cov=True)
        runs[name] = {"mu": mu.double().cpu(), "var": var.double().cpu(),
                      "acc": float(metrics.accuracy(y, agt.predict_y(m, s, X))),
                      "rmse": float(metrics.rmse(y, mu)),
                      "nlpd": float(metrics.negative_log_predictive_density(m, s, X, y)),
                      "coverage": float(metrics.coverage(y, mu, var))}
    c, n32, r64 = runs["card"], runs["cpu32"], runs["cpu64"]
    for key in ("rmse", "nlpd"):
        parity_check(f"metrics {key}", abs(c[key] - r64[key]) / abs(r64[key]), abs(n32[key] - r64[key]) / abs(r64[key]),
                     what="card (float32) vs CPU float64")
    tol = ORACLE_DEVICE_FACTOR * max(float((n32[k] - r64[k]).abs().max()) for k in ("mu", "var"))
    y = ye.double()
    sure = r64["mu"].abs() > tol
    card_sign, sign64 = torch.sign(c["mu"]), torch.sign(r64["mu"])
    if not bool((card_sign[sure] == sign64[sure]).all()):
        raise AssertionError("metrics: the card's class decisions differ from float64's beyond float32's margin")
    z = 1.959963984540054
    sd64 = r64["var"].clamp(min=0).sqrt()
    edge = torch.minimum((y - (r64["mu"] - z * sd64)).abs(), (y - (r64["mu"] + z * sd64)).abs())
    inside = lambda r: (y >= r["mu"] - z * r["var"].clamp(min=0).sqrt()) & (y <= r["mu"] + z * r["var"].clamp(min=0).sqrt())
    sure = edge > 10 * tol
    if not bool((inside(c)[sure] == inside(r64)[sure]).all()):
        raise AssertionError("metrics: the card's coverage decisions differ from float64's beyond float32's margin")
    log(f"metrics on path 42's model ({SL_EVAL} training rows): " + ", ".join(
        f"{k} card {c[k]:.6f} / CPU float64 {r64[k]:.6f}" for k in ("acc", "rmse", "nlpd", "coverage")))
    return {k: (c[k], r64[k]) for k in ("acc", "rmse", "nlpd", "coverage")}


def phase_surface(agt, ck, device, r42, r43):
    """Phase 45: alrsvi on the flagship (kernel 1 once a step, its floor,
    20 steps card vs CPU), the AffineMean VGP (its floor, no launch), the
    metrics on path 42's model, profiling.trace around SL_TRACE iterations
    of path 42 (the trace names kernel 7), plot_gp and plot_multilatent on
    the card's models (Agg), and the grand tour on the card."""
    import tempfile

    from agp_tpu_torch.training.train import vi_steps
    from agp_tpu_torch.utils import profiling

    out = {}
    r = alrsvi_run(agt, ck, device)
    floor = SLICE_L_FLOORS["alrsvi"]
    if not (r["finite"] and r["acc"] >= floor):
        raise AssertionError(f"alrsvi: accuracy {r['acc']:.5f} < {floor} or non-finite ({r['finite']})")
    log(f"alrsvi (the flagship, AnalyticSVI({B}, optimiser=alrsvi())): {MAIN_STEPS} steps in {r['seconds']:.3f} s, "
        f"{r['launches']} launches, accuracy {r['acc']:.5f} (floor {floor}), tau {r['tau']:.4f}")
    Xc, yc = flagship_data("cpu", n=PN, seed=1)
    draws = torch.randint(0, PN // 64, (20, B // 64), generator=torch.Generator().manual_seed(1))
    perm = torch.randperm(M, generator=torch.Generator().manual_seed(2))

    def alr_after(X, y, p=None):
        m = alrsvi_model(agt, X)
        if p is not None:
            m = m.replace(Z=m.Z[:, p].contiguous())
        _, s = vi_steps(m, agt.init_state(m, X, y), X, y, 20, draws=draws.to(X.device))
        mu = s.mu.double().cpu()
        return mu if p is None else mu[:, torch.argsort(p)]

    cpu = alr_after(Xc, yc)
    noise = float((alr_after(Xc, yc, perm) - cpu).abs().max() / cpu.abs().max())
    card = alr_after(Xc.to(device), yc.to(device))
    r["parity"] = parity_check("alrsvi", float((card - cpu).abs().max() / cpu.abs().max()), noise,
                               what="20 steps card (float32) vs CPU (float32)")
    out["alrsvi"] = {k: r[k] for k in ("acc", "seconds", "launches", "tau", "parity")}

    a = affine_vgp_run(agt, ck, device)
    floor = SLICE_L_FLOORS["affine"]
    if not (a["finite"] and a["rmse"] <= floor):
        raise AssertionError(f"affine VGP: RMSE {a['rmse']:.5f} > {floor} or non-finite ({a['finite']})")
    log(f"AffineMean VGP (N={VN}, D=2, Student-t(4), Matern-5/2, {V_ITERS} iterations): {a['seconds']:.3f} s, no "
        f"launch, RMSE {a['rmse']:.5f} (floor {floor}), w {a['w']}")
    out["affine"] = {k: a[k] for k in ("rmse", "seconds", "w")}

    out["metrics"] = metrics_check(agt, r42, device)

    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as d:
        m, s = r42["model"], r42["state"]
        with profiling.trace(d):
            agt.train(m, r42["X"], r42["y"], iterations=SL_TRACE, state=s)
        with open(os.path.join(d, "trace.json")) as f:
            text = f.read()
    if "stats_tc" not in text:
        raise AssertionError("profiling.trace: the trace names no kernel 7 (stats_tc)")
    log(f"profiling.trace around {SL_TRACE} iterations of path 42: {len(text)} bytes of Chrome trace, "
        f"{text.count('stats_tc')} mentions of kernel 7's stats_tc")
    out["trace_bytes"] = len(text)

    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        log("plotting: not run, this machine has no matplotlib")
        out["plots"] = None
    else:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from agp_tpu_torch.utils.plotting import plot_gp, plot_multilatent

        Xp = a["model"].train_x[:512]
        ax = plot_gp(a["model"], a["state"], Xp)
        ax2 = plot_multilatent(r43["model"], r43["state"], r43["X"][:512])
        if not (len(ax.lines) == 1 and len(ax.collections) >= 1 and len(ax2.lines) == MK):
            raise AssertionError(f"plots: {len(ax.lines)} lines and {len(ax.collections)} ribbons, {len(ax2.lines)} "
                                 "latent lines")
        plt.close("all")
        log(f"plotting: plot_gp (AffineMean VGP) and plot_multilatent (path 43, {MK} latents) on the card's models")
        out["plots"] = True

    from agp_tpu_torch.examples import grand_tour

    t0 = time.perf_counter()
    grand_tour.main([])
    out["grand_tour_seconds"] = time.perf_counter() - t0
    return out


def slice_l_mode(agt, ck, device):
    """``python3 chip_smoke.py slice-l``: phases 42-45 alone."""
    out = {"path42": timed_phase("path 42", phase_path42, agt, ck, device)}
    out["path43"] = timed_phase("path 43", phase_path43, agt, ck, device)
    out["library"] = timed_phase("library", phase_library, agt, ck, device)
    out["path44"] = timed_phase("path 44", phase_path44, agt, ck, device)
    r42, r43 = out["path42"].pop("run"), out["path43"].pop("run")
    out["surface"] = timed_phase("the rest of the surface", phase_surface, agt, ck, device, r42, r43)
    return out


def slice_l_cpu_mode(agt):
    """``python3 chip_smoke.py slice-l-cpu``: paths 42, 43 and 44, alrsvi and
    the AffineMean VGP in float64 on the host's CPU, CPU draws, no floors
    held: the source of SLICE_L_FLOORS."""
    from agp_tpu_torch.ops import cuda_kernels as ck

    torch.set_num_threads(min(torch.get_num_threads(), 8))
    cpu, f64 = torch.device("cpu"), torch.float64
    for name, run, key in (("path 42", path42_run, "acc"), ("path 43", path43_run, "acc"),
                           ("path 44", path44_run, "acc"), ("alrsvi", alrsvi_run, "acc"),
                           ("AffineMean VGP", affine_vgp_run, "rmse")):
        r = run(agt, ck, cpu, f64)
        log(f"{name} on the CPU, float64: {key} {r[key]:.5f}, finite {r['finite']}, {r['seconds']:.2f} s")


# ------------------------------------------------- float64 on the card
# kernels 4-7 in float64 against their plain version on the same card
# inputs: each output within max(F64_FACTOR times the plain version's own
# card-against-CPU float64 difference, F64_FLOOR) of its largest entry
F64_FACTOR, F64_FLOOR = 10.0, 1e-12
# the float64 paths on the card against the port's float64 CPU run from the
# same draws (max |d mu| / max |mu|, and for the dense paths the learnt
# parameter and the log-hyperparameters): CAVI steps, the default Adam
F64_PATH_TOL, F64_HYPER_TOL = 1e-8, 1e-7
F64_STEPS = 10
# steps of phase 48's drift runs (10: the run's time holds phases 50-52
# too)
F64_DRIFT_STEPS = 10
# steps of the float64 rates (after F64_WARM)
F64_TIMED_STEPS, F64_WARM = 200, 20
# the H100's published FP64 peaks (SXM, NVIDIA's data sheet, dense): on the
# tensor cores (DMMA) and outside them
PEAK_FP64_TC_FLOPS, PEAK_FP64_FLOPS = 67e12, 34e12


def f64_bound(tc_fmas, simt_fmas, nbytes):
    """(ms, "operations" or "bytes"): the larger of tc_fmas at the FP64
    tensor-core peak, simt_fmas at the FP64 one (another pipe) and nbytes
    over the memory rate."""
    ops_ms = max(2.0 * tc_fmas / PEAK_FP64_TC_FLOPS, 2.0 * simt_fmas / PEAK_FP64_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def f64_kappa_bound(b, d, m, n_latent, moments):
    """Kernel 4's (moments) or 6's float64 form: kappa_bounds' function
    bound with its products once at the FP64 tensor-core peak, the gram and
    row sums at the FP64 one, and 8-byte elements."""
    tc = n_latent * b * (m * m + (sym_fmas(m) if moments else 0))
    simt = n_latent * b * (m * d + (3 if moments else 1) * m)
    if moments:
        nbytes = 8 * (b * d + n_latent * (m * d + 2 * m * m + d + 1 + m + b * m + 2 * b))
    else:
        nbytes = 8 * (b * d + m * d + m * m + d + 1 + b * m + b)
    return f64_bound(tc, simt, nbytes)


def f64_stats_bound(b, m, n_latent):
    """Kernels 5 and 7's float64 form: S2's upper triangle once at the FP64
    tensor-core peak, s1 at the FP64 one, 8-byte elements."""
    return f64_bound(n_latent * b * sym_fmas(m), n_latent * b * m, 8 * n_latent * (b * m + 2 * b + m + m * m))


def check_f64(label, names, got, card, cpu):
    """Each float64 output of a kernel on the card against its plain version
    on the same card tensors (``card``), within max(F64_FACTOR times the
    plain version's own difference from its CPU run (``cpu``), F64_FLOOR),
    all over the plain version's largest entry.  Returns {name: (abs
    error, relative error, the plain version's card-vs-CPU difference)}."""
    row = {}
    for name, o, r, c in zip(names, got, card, cpu):
        if o.dtype != torch.float64 or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{label}: output {name} is {o.dtype} or not finite")
        scale = max(float(r.abs().max()), 1e-300)
        abs_err = float((o - r).abs().max())
        noise = float((r.cpu() - c).abs().max()) / scale
        tol = max(F64_FACTOR * noise, F64_FLOOR)
        if abs_err / scale > tol:
            raise AssertionError(f"{label}: {name} error {abs_err / scale:.3e} > {tol:.3e} ({F64_FACTOR:g} x the plain "
                                 f"version's card-vs-CPU {noise:.3e}, floor {F64_FLOOR:g})")
        row[name] = (abs_err, abs_err / scale, noise)
    return row


def f64_cases(device):
    """(label, float32 inputs, one latent, timed) of each shape kernels 4-7
    are held at in float64 (kernels 6-7 where one latent): the flagship
    (B=4096, D=20, M=64), logistic_m512_b65536, the ill-conditioned oracle
    shapes at M=128 and M=512 (B=8192, D=2, lengthscale 1), the multiclass
    (K=3, B=8192) and heteroscedastic (B=16,384) M=512 shapes, all timed;
    then ragged B=300 at an odd M=129 (one-element copies, scalar stores)
    with 1 and 3 latents and each Matern kind, and the 16-row tiles at
    M=1,000 and at kernel 4's float64 ceiling M=1,184; the float64 inputs
    are these, cast."""
    Xl, _ = big_logistic_data("cpu", n=LB)
    Xf, _ = flagship_data("cpu", n=B)
    Xo = oracle_data("studentt", "cpu")[0]
    return [("flagship_m64_b4096", pair_inputs(Xf, B, M, 1, device), True, True),
            ("logistic_m512_b65536", pair_inputs(Xl, LB, PM, 1, device), True, True),
            ("oracle_m128_b8192", pair_inputs(Xo, OB, OM, 1, device, ls=1.0), True, True),
            ("oracle_m512_b8192", pair_inputs(Xo, OB, PM, 1, device, ls=1.0), True, True),
            ("multiclass_m512_b8192", pair_inputs(pair_mc_data("cpu")[0], PAIR_MC_B, PM, 3, device, ls=1.0), False,
             True),
            ("het_m512_b16384", pair_inputs(pair_het_data("cpu")[0], PAIR_HET_B, PM, 2, device, ls=1.0), False, True),
            ("ragged_m129_L1", pair_inputs(Xl, 300, 129, 1, device, seed=1), True, False),
            ("ragged_m129_L3", pair_inputs(Xl, 300, 129, 3, device, seed=3), False, False)] + [
            (f"{k}_ragged_m129", pair_inputs(Xl, 300, 129, 1, device, kind=k), True, False) for k in MATERN_KINDS] + [
            ("m1000_b700", pair_inputs(Xl, 700, 1000, 1, device), True, False),
            ("m1184_b300", pair_inputs(Xl, 300, 1184, 1, device), True, False)]


def f64_kernel_timing(ck, name, t32, t64, reps):
    """A float64 kernel at one shape: kappa_timing's or stats_timing's
    numbers on its float64 inputs (its ms by CUDA events beside its plain
    version, its device us, the library call in float64: torch.matmul /
    torch.bmm, cuBLAS on DMMA), the float32 kernel's ms on the same inputs
    in float32, and kernels 4 and 6's row-slab form (``slab_route``) or 5
    and 7's m8n8k4 geometry (``k4_stats``) on the same float64 inputs, in
    the same call."""
    if name in ("fused_kappa", "fused_kappa_moments_batched"):
        caller = call_k6 if name == "fused_kappa" else call_k4
        r = kappa_timing(ck, name, t64, reps)
        r["library_ms"], r["library_device_us"] = r.pop("products_ms"), r.pop("products_device_us")
        r["float32_ms"] = cuda_ms(lambda: caller(getattr(ck, name), t32), reps)
        with slab_route(ck):
            r["slab_ms"] = cuda_ms(lambda: caller(getattr(ck, name), t64), reps)
            r["slab_device_us"] = device_us(lambda: caller(getattr(ck, name), t64))[0]
        return r
    kappa64, g64, th64 = t64["kappa"], t64["g"], t64["theta"]
    if name == "cavi_stats":
        library = lambda: ((kappa64 * th64[:, None]).T @ kappa64, kappa64.T @ g64)  # noqa: E731
    else:
        library = lambda: (torch.bmm((kappa64 * th64[..., None]).mT, kappa64), torch.bmm(kappa64.mT, g64[..., None]))  # noqa: E731
    r = stats_timing(ck, name, kappa64, g64, th64, reps, library)
    fn = getattr(ck, name)
    r["float32_ms"] = cuda_ms(lambda: fn(t32["kappa"], t32["g"], t32["theta"]), reps)

    def k4_call():
        with k4_stats(ck):
            return fn(kappa64, g64, th64)

    # the two geometries interleaved (k4, k8, k8, k4), as timed_pair times a kernel beside its plain version
    r["ms_beside_k4"], r["k4_ms"] = timed_pair(lambda: fn(kappa64, g64, th64), k4_call, reps)
    r["k4_device_us"] = device_us(k4_call)[0]
    return r


def phase_f64_kernels(ck, device):
    """Phase 46: kernels 4-7's float64 forms against their plain versions
    in float64 on the card at each case of f64_cases (``check_f64``), a
    second call of each bit-equal and S2 exactly symmetric, each launch
    counted in its wrapper's ``launches_f64`` and none in ``launches``;
    then each timed case (``f64_kernel_timing``: CUDA events and device us,
    beside the plain version, the library call in float64 and the float32
    kernel).  Returns {kernel: {"worst": largest abs error, "rel": largest
    relative error, "shapes": {label: timing}, "errors": {label: row}}}."""
    names = {"fused_kappa_moments_batched": ("kappa", "mf", "vf"), "cavi_stats_batched": ("s1", "S2"),
             "fused_kappa": ("kappa", "Ktilde"), "cavi_stats": ("s1", "S2")}
    out = {k: {"worst": 0.0, "rel": 0.0, "shapes": {}, "errors": {}} for k in names}

    def record(name, label, row):
        out[name]["errors"][label] = {k: v[1] for k, v in row.items()}
        out[name]["worst"] = max(out[name]["worst"], *(v[0] for v in row.values()))
        out[name]["rel"] = max(out[name]["rel"], *(v[1] for v in row.values()))

    for label, t32, single, timed in f64_cases(device):
        t64 = to_float64(t32)
        cpu64 = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in t64.items()}
        reset_launches(ck)
        calls = [("fused_kappa_moments_batched", call_k4, t64, cpu64)]
        if single:
            calls.append(("fused_kappa", call_k6, single_args(t64), single_args(cpu64)))
        for name, caller, a, a_cpu in calls:
            got = caller(getattr(ck, name), a)
            torch.cuda.synchronize()
            row_k = check_f64(f"{name} float64 {label}", names[name], got,
                              caller(getattr(ck, name + "_reference"), a), caller(getattr(ck, name + "_reference"), a_cpu))
            check_repeat(f"{name} float64 {label}", lambda: caller(getattr(ck, name), a), got)
            record(name, label, row_k)
            stats = "cavi_stats_batched" if name == "fused_kappa_moments_batched" else "cavi_stats"
            kappa = got[0].contiguous()
            g, th = (a["g"], a["theta"])
            s_args = (kappa, g, th)
            s_got = getattr(ck, stats)(*s_args)
            torch.cuda.synchronize()
            check_stats_repeat(f"{stats} float64 {label}", getattr(ck, stats), s_args, s_got)
            plain = getattr(ck, stats + "_reference")
            row = check_f64(f"{stats} float64 {label}", names[stats], s_got, plain(*s_args),
                            plain(*(v.cpu() for v in s_args)))
            record(stats, label, row)
            log(f"float64 {name} + {stats} vs plain {label} (L={t64['Z'].shape[0] if name != 'fused_kappa' else 1}): "
                + " ".join(f"{k}={v[1]:.2e} (plain card-vs-CPU {v[2]:.2e})" for k, v in {**row_k, **row}.items()))
        want = {"fused_kappa_moments_batched_f64": 2, "cavi_stats_batched_f64": 2}
        if single:
            want.update({"fused_kappa_f64": 2, "cavi_stats_f64": 2})
        counts = {n: launches_of(ck, n) for n in LAUNCH_COUNTERS}
        if counts != {n: want.get(n, 0) for n in LAUNCH_COUNTERS}:
            raise AssertionError(f"float64 {label}: launched {counts}, expected {want} (float64 forms only)")
        reps = 5 if t32["X"].shape[0] > 20000 else 20
        for name, caller, a, _ in calls if timed else ():
            stats = "cavi_stats_batched" if name == "fused_kappa_moments_batched" else "cavi_stats"
            kappa32 = caller(getattr(ck, name + "_reference"), t32 if name != "fused_kappa" else single_args(t32))[0]
            kappa32 = kappa32.contiguous()
            s32 = {"kappa": kappa32, "g": a["g"].float(), "theta": a["theta"].float()}
            s64 = {"kappa": kappa32.double(), "g": a["g"], "theta": a["theta"]}
            a32 = t32 if name != "fused_kappa" else single_args(t32)
            r = f64_kernel_timing(ck, name, a32, a, reps)
            rs = f64_kernel_timing(ck, stats, s32, s64, reps)
            (n_lat, b_, m_), d_ = kappa32.reshape(-1, *kappa32.shape[-2:]).shape, a["X"].shape[1]
            r["bound_ms"] = f64_kappa_bound(b_, d_, m_, n_lat, name != "fused_kappa")[0]
            rs["bound_ms"] = f64_stats_bound(b_, m_, n_lat)[0]
            out[name]["shapes"][label], out[stats]["shapes"][label] = r, rs
            for k, rr in ((name, r), (stats, rs)):
                log(f"  float64 {k} {label}: {rr['ms']:.4f} ms (float32 {rr['float32_ms']:.4f}), device "
                    f"{rr['device_us']:.1f} us; plain {rr['plain_ms']:.4f}; library (float64) {rr['library_ms']:.4f} ms, "
                    f"device {rr['library_device_us']:.1f} us; bound {rr['bound_ms']:.4f} ms"
                    + (f"; row-slab form {rr['slab_ms']:.4f} ms, device {rr['slab_device_us']:.1f} us"
                       if "slab_ms" in rr else "")
                    + (f"; m8n8k4 geometry {rr['k4_ms']:.4f} ms (this one beside it {rr['ms_beside_k4']:.4f}), "
                       f"device {rr['k4_device_us']:.1f} us" if "k4_ms" in rr else ""))
        del t64, cpu64
    reset_launches(ck)
    return out


def f64_hyper_after(agt, model, X, y, draws, steps):
    """mu and the log-hyperparameters after ``steps`` iterations of train
    (a CAVI step each, a hyperparameter step after iterations 3..n-1) from
    the given draws, as float64 on the CPU."""
    model, state = agt.train(model, X, y, iterations=steps, draws=draws.to(X.device))
    return state.mu.double().cpu(), log_hypers(model)


def phase_f64_paths(agt, ck, device):
    """Phase 47: float64 models on the card against the port's float64 run
    on the host's CPU from the same draws, each with its exact launches
    (kernels 6 + 7 or 4 + 5 in their float64 forms, no fused kernel):
    the flagship shape (N=200,000, D=20, M=64, B=4096, block) at F64_STEPS
    CAVI steps within F64_PATH_TOL; path A (the flagship with the default
    Adam(0.01)) at F64_STEPS iterations within F64_HYPER_TOL (mu and the
    log-hyperparameters); the M=512 multiclass oracle (K=3, B=8192) at
    F64_STEPS steps through kernels 4 + 5 within F64_PATH_TOL; the exact GP
    and the dense VGPs of phase 22 at N=1,024 (D_ITERS iterations, no
    launch) within F64_PATH_TOL.  Returns {path: error}."""
    errs = {}
    gen = torch.Generator().manual_seed(1)
    Xc, yc = (a.double() for a in flagship_data("cpu"))
    draws = torch.randint(0, N // 64, (F64_STEPS, B // 64), generator=gen)
    cpu = after_20(agt, flagship_model(agt, Xc), Xc, yc, draws, steps=F64_STEPS)
    Xd, yd = Xc.to(device), yc.to(device)
    reset_launches(ck)
    card = after_20(agt, flagship_model(agt, Xd), Xd, yd, draws, steps=F64_STEPS)
    torch.cuda.synchronize()
    expect_launches(ck, "float64 flagship", route_launches(F64_STEPS, "single", f64=True))
    errs["flagship"] = rel_err(card, cpu)
    reset_launches(ck)
    card_a = f64_hyper_after(agt, hyper_path(agt, Xd, "A"), Xd, yd, draws, F64_STEPS)
    torch.cuda.synchronize()
    expect_launches(ck, "float64 path A", route_launches(F64_STEPS, "single", hyper_steps=F64_STEPS - 3, f64=True))
    cpu_a = f64_hyper_after(agt, hyper_path(agt, Xc, "A"), Xc, yc, draws, F64_STEPS)
    errs["path A"] = max(float((card_a[0] - cpu_a[0]).abs().max() / cpu_a[0].abs().max()),
                         float((card_a[1] - cpu_a[1]).abs().max()))
    Xm, ym = pair_mc_data("cpu")
    Xm = Xm.double()
    draws = torch.randint(0, ON - PAIR_MC_B + 1, (F64_STEPS,), generator=gen)
    cpu = after_20(agt, pair_multi_model(agt, Xm, "multiclass"), Xm, ym, draws, steps=F64_STEPS)
    reset_launches(ck)
    card = after_20(agt, pair_multi_model(agt, Xm.to(device), "multiclass"), Xm.to(device), ym.to(device), draws,
                    steps=F64_STEPS)
    torch.cuda.synchronize()
    expect_launches(ck, "float64 multiclass M=512", route_launches(F64_STEPS, "batched", f64=True))
    errs["multiclass M=512"] = rel_err(card, cpu)
    for which in DENSE_PATHS:
        Xc, _, yc = (a.double() for a in dense_data(which, DN, "cpu", seed=1))
        reset_launches(ck)
        card = dense_after(agt, which, Xc.to(device), yc.to(device))
        torch.cuda.synchronize()
        expect_launches(ck, f"float64 {which}", {})
        errs[which] = triple_err(card, dense_after(agt, which, Xc, yc))
    for path, err in errs.items():
        tol = F64_HYPER_TOL if path == "path A" else F64_PATH_TOL
        log(f"float64 {path}: card vs CPU (both float64, the same draws) {err:.3e} (bound {tol:g})")
        if not err <= tol:
            raise AssertionError(f"float64 {path}: card vs CPU {err:.3e} > {tol:g}")
    return errs


def phase_f64_drift(agt, ck, device):
    """Phase 48 (ROADMAP queue 3 item 3): the ten oracle paths at M=128
    (B=8192, phase 11's configuration) and the pair's ten M=512 paths at
    B=PAIR_PARITY_B (phase 14's), F64_DRIFT_STEPS steps from the same
    draws, on the card
    in float64 (kernels 6 + 7 or 4 + 5, exact launches) and in float32, and
    on the CPU in float32 and float64: each one's distance to the CPU's
    float64 run, max |d mu| / max |mu| (and |d lam| / lam), logged (the
    float32 runs' includes the dtype-keyed jitter, 1e-3 against 1e-4).
    Returns {path: (card float64, card float32, CPU float32)}."""
    out = {}
    draws = torch.randint(0, ON - OB + 1, (F64_DRIFT_STEPS,), generator=torch.Generator().manual_seed(1))
    paths = [(f"oracle {lik}/{kernel} M={OM}", *oracle_data(lik, "cpu", seed=1)[:2],
              lambda X, lik=lik, kernel=kernel: oracle_model(agt, X, lik, kernel), draws, "single")
             for lik, kernel in single_paths()]
    for name, Xc, yc, build, b in pair_parity_paths(agt, device):
        pdraws = torch.randint(0, Xc.shape[0] - b + 1, (F64_DRIFT_STEPS,), generator=torch.Generator().manual_seed(1))
        paths.append((name, Xc, yc, build, pdraws, "batched" if name.startswith(("multiclass", "het")) else "single"))
    for name, Xc, yc, build, d, route in paths:
        t0 = time.perf_counter()
        X64, y64 = Xc.double(), yc.double()
        cpu64 = after_20(agt, build(X64), X64, y64, d, F64_DRIFT_STEPS)
        reset_launches(ck)
        card64 = after_20(agt, build(X64.to(device)), X64.to(device), y64.to(device), d, F64_DRIFT_STEPS)
        torch.cuda.synchronize()
        expect_launches(ck, f"float64 {name}", route_launches(F64_DRIFT_STEPS, route, f64=True))
        card32 = after_20(agt, build(Xc.to(device)), Xc.to(device), yc.to(device), d, F64_DRIFT_STEPS)
        cpu32 = after_20(agt, build(Xc), Xc, yc, d, F64_DRIFT_STEPS)
        reset_launches(ck)
        out[name] = (rel_err(card64, cpu64), rel_err(card32, cpu64), rel_err(cpu32, cpu64))
        log(f"drift {name} ({F64_DRIFT_STEPS} steps) against the CPU's float64: card float64 {out[name][0]:.3e}, card float32 "
            f"{out[name][1]:.3e}, CPU float32 {out[name][2]:.3e} ({time.perf_counter() - t0:.2f} s)")
        if not out[name][0] < 1.0:
            raise AssertionError(f"float64 {name}: the card's run is not near the CPU's ({out[name][0]:.3e})")
    return out


def phase_f64_rates(agt, ck, device):
    """Phase 49: the float64 flagship (N=200,000, D=20, M=64, B=4096,
    block) and logistic_m512_b65536 (N=500,000, D=20, M=512, B=65,536,
    slice) on the card, F64_WARM steps through agp_tpu_torch.train with
    their exact launches (kernels 6 + 7 a step), finite, then the steady
    CAVI iterations/s over F64_TIMED_STEPS steps (host clock) and a
    profiled window of 20 steps (wall, device busy, idle share).  Returns
    {path: (it/s, profile_window's dict)}."""
    from agp_tpu_torch.training.train import vi_steps

    out = {}
    for name, data, build in (("flagship", flagship_data, flagship_model), ("logistic_m512_b65536", big_logistic_data,
                                                                           big_logistic_model)):
        X, y = (a.double() for a in data(device))
        model = build(agt, X)
        gen = torch.Generator(device=device).manual_seed(0)
        reset_launches(ck)
        model, state = agt.train(model, X, y, iterations=F64_WARM, generator=gen)
        torch.cuda.synchronize()
        expect_launches(ck, f"float64 {name} rate", route_launches(F64_WARM, "single", f64=True))
        if not (bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())):
            raise AssertionError(f"float64 {name}: non-finite posterior")
        steps = F64_TIMED_STEPS if name == "flagship" else F64_TIMED_STEPS // 4
        t0 = time.perf_counter()
        model, state = vi_steps(model, state, X, y, steps, generator=gen)
        torch.cuda.synchronize()
        ips = steps / (time.perf_counter() - t0)
        p = profile_window(lambda: vi_steps(model, state, X, y, 20, generator=gen), 20)
        reset_launches(ck)
        log(f"float64 {name}: steady {ips:.2f} CAVI iterations/s over {steps} steps")
        log_profile(f"float64 {name} profile", p, 6)
        out[name] = (ips, p)
        del X, y, model, state
    return out


def float64_mode(agt, ck, device):
    """Phases 46-49 (``python3 chip_smoke.py float64``): kernels 4-7 in
    float64 against their plain versions and timed, the float64 paths
    against the CPU's float64 run, the drift of float32 and float64 from
    it, the float64 rates.  Returns phase 46's and 49's results."""
    kernels = timed_phase("float64 kernels 4-7", phase_f64_kernels, ck, device)
    timed_phase("float64 paths", phase_f64_paths, agt, ck, device)
    timed_phase("float64 drift", phase_f64_drift, agt, ck, device)
    rates = timed_phase("float64 rates", phase_f64_rates, agt, ck, device)
    return kernels, rates


# --------------------------- kernels 4 and 6 column-blocked (phases 50-52)
# the SVGP paths past the row slab's old ceilings: logistic_m512_b65536's
# model (bench.py:196-213) widened to M=4,096 in float32 and M=2,048 in
# float64, at B=16,384
CB, C32_M, C64_M = 16_384, 4096, 2048
# the MOVGP paths: tpu_acceptance.py:187-202's model (Gaussian(0.1) +
# logistic tasks, Q=2) as a MOVGP (Z = X: M = N) on N points, float32 and
# float64, full batch, and the reference's RMSE threshold (:202); its
# squared-exponential kernel at lengthscale CV_LS, not the reference's 1:
# with 3,000 points on [-2, 2]^2 a unit lengthscale puts cond(Kmm + 1e-3 I)
# near 8e5, where the card's float32 run diverges (task 0's RMSE 17.0
# after 60 steps; 13.06 with the plain versions in the kernels' place, so
# not by the kernels) while float32 on the host's CPU converges, in the
# JAX package (0.0148; 0.1032 through its Pallas pair) as in the port
# (0.0641), and float64 on the card tracks the CPU's to 6e-10
# (tests/movgp_lengthscale.py; PERF.md section 6, ROADMAP.md queue 3 item 9)
CV32_N, CV64_N, CV_ITERS, CV_RMSE, CV_LS = 3000, 1500, 60, 0.35, 0.25
# CAVI steps of each path's float64 run on the host's CPU (its floor, and
# its parity), which the card repeats from the same draws (the SVGP paths
# one: at M=4,096, B=16,384 a float64 step takes the host's CPU ~15 s); the
# SVGP paths' accuracy on the first COLS_EVAL rows; a path's error (1 -
# accuracy, or RMSE) within COLS_FLOOR_FACTOR times its CPU float64 run's
# (the floors' rule, PERF.md section 2)
COLS_STEPS, COLS_SVGP_STEPS, COLS_EVAL, COLS_FLOOR_FACTOR = 2, 1, 4096, 3.0
# the SVGP paths' further steps on the card alone, and the accuracy floor
# they reach (logistic_m512_b65536's)
COLS_TRAIN_STEPS = 20


@contextlib.contextmanager
def slab_route(ck):
    """The wrappers take the row-slab form in float64 where its slab fits
    (kappa_tile_rows in float64), as they did before the column-blocked
    form: a yardstick for the column-blocked kernels, timed beside them."""
    route = ck.kappa_route

    def slab_first(which, m, dtype=torch.float32, limit=ck.SMEM_OPTIN):
        tb = ck.kappa_tile_rows(which, m, limit, dtype)
        return ("slab", tb) if tb else route(which, m, dtype, limit)

    ck.kappa_route = slab_first
    try:
        yield
    finally:
        ck.kappa_route = route


@contextlib.contextmanager
def k4_stats(ck):
    """Kernels 5 and 7 take their float64 form's m8n8k4 geometry
    (``StatsF64K4``, the first float64 form) at every M, as they did
    before the m16n8k8 one: a yardstick for it, timed beside it."""
    depth = ck.STATS_F64_MMA_K
    ck.STATS_F64_MMA_K = 4
    try:
        yield
    finally:
        ck.STATS_F64_MMA_K = depth


def cols_cases(device):
    """(label, float32 inputs, kernels, dtype, timed) of phase 50: kernels 4
    and 6 in the column-blocked form past the row slab's old ceilings, on
    logistic_m512_b65536's data (D=20, lengthscale 2): float64 at kernel
    4's M=1,185 (two latents) and kernel 6's M=1,193 at ragged B=300, at
    M=2,048, B=700, and at the float64 SVGP path's M=2,048, B=16,384
    (timed only: the CPU's float64 check runs at B=700); float32 at kernel
    4's M=2,393 (two latents) and kernel 6's M=2,407 at B=300, and at the
    float32 SVGP path's M=4,096, B=16,384 (timed)."""
    Xl, _ = big_logistic_data("cpu", n=CB)
    f64, f32 = torch.float64, torch.float32
    return [("m1185_b300_L2", pair_inputs(Xl, 300, 1185, 2, device, seed=5), "moments", f64, False),
            ("m1193_b300", pair_inputs(Xl, 300, 1193, 1, device, seed=6), "both", f64, False),
            ("m2048_b700", pair_inputs(Xl, 700, C64_M, 1, device, seed=9), "both", f64, False),
            ("m2048_b16384", pair_inputs(Xl, CB, C64_M, 1, device), "both", f64, True),
            ("m2393_b300_L2", pair_inputs(Xl, 300, 2393, 2, device, seed=7), "moments", f32, False),
            ("m2407_b300", pair_inputs(Xl, 300, 2407, 1, device, seed=8), "both", f32, False),
            ("m4096_b16384", pair_inputs(Xl, CB, C32_M, 1, device), "both", f32, True)]


def cols_calls(t, kernels):
    """(wrapper name, caller, arguments, output names) of kernels 4 and 6 on
    pair_inputs' tensors (kernel 6 on the first latent), as ``kernels``
    names them ("moments", "single" or "both")."""
    calls = []
    if kernels in ("moments", "both"):
        calls.append(("fused_kappa_moments_batched", call_k4, t, ("kappa", "mf", "vf")))
    if kernels in ("single", "both"):
        calls.append(("fused_kappa", call_k6, single_args(t), ("kappa", "Ktilde")))
    return calls


# the large-B case of phase 50: float64 kernels 6 + 7 and 4 + 5 (L=1) past
# the column-blocked form's old grid ceiling (65,535 row tiles of 128, B <=
# 8,388,480), at M=129 and at M=260, where B M passes 2^31; D=2 keeps X
# small (kappa and the gram take B M doubles each: 8.7 GB at M=129, 17.4
# GB at M=260); the rows held against the plain version (large_b_rows);
# s1 and S2 against the plain sums over chunks of BIG_CHUNK rows, within
# BIG_STATS_TOL of their largest entry (another order of the same float64
# sums)
BIG_B, BIG_MS, BIG_ROWS, BIG_CHUNK, BIG_STATS_TOL = 8_388_481, (129, 260), 300, 1 << 20, 1e-9


def large_b_rows(b, m):
    """The rows of a large-B call held against the plain version: the first
    BIG_ROWS, the BIG_ROWS around the row where the flat index of kappa
    [b, m] passes 2^31 (clamped into the batch), and the last BIG_ROWS
    (the last 128-row tile past the old grid among them)."""
    h = BIG_ROWS // 2
    mid = min(max((1 << 31) // m, h), b - h)
    return torch.unique(torch.cat([torch.arange(BIG_ROWS), torch.arange(mid - h, mid + h),
                                   torch.arange(b - BIG_ROWS, b)]))


def chunked_stats(kappa, g, theta, rows=BIG_CHUNK):
    """(s1, S2) of kappa [..., B, M] by the plain version's products summed
    over chunks of ``rows`` rows (a large B's products in pieces)."""
    s1 = s2 = 0
    for i in range(0, kappa.shape[-2], rows):
        k, gc, tc = kappa[..., i:i + rows, :], g[..., i:i + rows], theta[..., i:i + rows]
        s1 = s1 + (k.mT @ gc[..., None])[..., 0]
        s2 = s2 + (k * tc[..., None]).mT @ k
    return s1, s2


def large_b_check(ck, device, m, b=BIG_B):
    """Float64 kernels 6 + 7 and 4 + 5 (L=1) at B=b and M=m on the
    column-blocked route, each wrapper one launch in launches_f64: kappa,
    Ktilde, mf and vf on large_b_rows against the plain version run on
    those rows alone (check_f64); s1 and S2 finite, S2 exactly symmetric,
    and within BIG_STATS_TOL of chunked_stats.  Returns {wrapper: {output:
    (abs error, relative error)}}."""
    X = torch.as_tensor(np.random.default_rng(21).uniform(-2.0, 2.0, size=(b, 2)))
    t = to_float64(pair_inputs(X, b, m, 1, device, ls=1.0, seed=m))
    del X
    rows = large_b_rows(b, m).to(device)
    out = {}
    for name, caller, a, names in cols_calls(t, "both"):
        stats = "cavi_stats" if name == "fused_kappa" else "cavi_stats_batched"
        label = f"{name} + {stats} float64 B={b} M={m}"
        if ck.kappa_route("single" if name == "fused_kappa" else "moments", m, torch.float64)[0] != "cols":
            raise AssertionError(f"{label}: not on the column-blocked route")
        reset_launches(ck)
        got = caller(getattr(ck, name), a)
        s_args = (got[0], a["g"], a["theta"])
        s_got = getattr(ck, stats)(*s_args)
        torch.cuda.synchronize()
        counts = {n: launches_of(ck, n) for n in LAUNCH_COUNTERS if launches_of(ck, n)}
        if counts != {name + "_f64": 1, stats + "_f64": 1}:
            raise AssertionError(f"{label}: launched {counts}")
        sub = {**a, "X": a["X"][rows]}
        cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in sub.items()}
        plain = getattr(ck, name + "_reference")
        picked = tuple(o.index_select(-2 if k == "kappa" else -1, rows) for k, o in zip(names, got))
        row = check_f64(label, names, picked, caller(plain, sub), caller(plain, cpu))
        out[name] = {k: v[:2] for k, v in row.items()}
        del got
        for k, o in zip(("s1", "S2"), s_got):
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"{label}: {k} is not finite")
        if not torch.equal(s_got[1], s_got[1].mT):
            raise AssertionError(f"{label}: S2 is not exactly symmetric")
        out[stats] = {}
        for k, o, r in zip(("s1", "S2"), s_got, chunked_stats(*s_args)):
            err = float((o - r).abs().max())
            rel = err / max(float(r.abs().max()), 1e-300)
            if not rel <= BIG_STATS_TOL:
                raise AssertionError(f"{label}: {k} {rel:.3e} from the plain sums over chunks > {BIG_STATS_TOL:g}")
            out[stats][k] = (err, rel)
        del s_args, s_got
        log(f"{label} (rows {rows.numel()} of {b}): " + " ".join(
            f"{k}={v[1]:.2e}" for k, v in {**out[name], **out[stats]}.items()))
    del t
    reset_launches(ck)
    return out


def phase_cols_kernels(ck, device):
    """Phase 50: kernels 4 and 6 in the column-blocked form at every case of
    cols_cases, each launch counted once in its wrapper's launches (or
    launches_f64): float64 against the float64 plain version within
    check_f64's bound (10 x its own card-vs-CPU difference), float32
    against the float64 plain version within FLOAT32_FACTOR times the
    float32 plain version's own error with no floor; a second call
    bit-equal; the timed cases' ms and device us beside the plain version,
    the products alone (torch.matmul / torch.bmm x2: the library call) and
    the bound, and in float64 the float32 kernel on the same inputs; then
    the large-B case (large_b_check at BIG_B, each of BIG_MS).  Returns
    {label: {wrapper: timing or None}} and the largest errors."""
    out, worst = {}, {}
    for label, t32, kernels, dtype, timed in cols_cases(device):
        t = to_float64(t32) if dtype == torch.float64 else t32
        out[label] = {}
        for name, caller, a, names in cols_calls(t, kernels):
            fn, plain = getattr(ck, name), getattr(ck, name + "_reference")
            reset_launches(ck)
            got = caller(fn, a)
            torch.cuda.synchronize()
            counter = name + ("_f64" if dtype == torch.float64 else "")
            counts = {n: launches_of(ck, n) for n in LAUNCH_COUNTERS if launches_of(ck, n)}
            if counts != {counter: 1}:
                raise AssertionError(f"{name} {label}: launched {counts}, expected {{{counter!r}: 1}}")
            if dtype == torch.float64 and timed:  # held to the CPU's float64 run at B=700
                row = {k: (float((o - r).abs().max()), float((o - r).abs().max()) / max(float(r.abs().max()), 1e-300),
                           float("nan")) for k, o, r in zip(names, got, caller(plain, a))}
                err = {k: v[1] for k, v in row.items()}
                log(f"column-blocked {name} float64 {label} against the plain version on the card: "
                    + " ".join(f"{k}={v:.2e}" for k, v in err.items()))
            elif dtype == torch.float64:
                a_cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in a.items()}
                row = check_f64(f"{name} {label}", names, got, caller(plain, a), caller(plain, a_cpu))
                err = {k: v[1] for k, v in row.items()}
                log(f"column-blocked {name} float64 {label}: " + " ".join(
                    f"{k}={v[1]:.2e} (plain card-vs-CPU {v[2]:.2e})" for k, v in row.items()))
            else:
                row = check_outputs(f"column-blocked {name} float32 {label}", names, got, caller(plain, a),
                                    caller(plain, to_float64(a)), floor=0.0)
                err = row
            check_repeat(f"{name} {label}", lambda: caller(fn, a), got)
            worst[name] = max(worst.get(name, 0.0), *(row[k][0] if isinstance(row[k], tuple) else row[k]
                                                       for k in row))
            del got
            r = None
            if timed:
                r = kappa_timing(ck, name, a, 5)
                n_lat, b_, m_ = a["Z"].shape[0] if a["Z"].ndim == 3 else 1, a["X"].shape[0], a["Z"].shape[-2]
                moments = name != "fused_kappa"
                if dtype == torch.float64:
                    r["bound_ms"], r["bound_by"] = f64_kappa_bound(b_, a["X"].shape[1], m_, n_lat, moments)
                    r["float32_ms"] = cuda_ms(lambda: caller(fn, t32 if moments else single_args(t32)), 5)
                else:
                    bounds = kappa_bounds(b_, a["X"].shape[1], m_, n_lat, moments)
                    (r["bound_ms"], r["bound_by"]), r["bound_3xtf32_ms"] = bounds[0], bounds[1][0]
                log(kappa_line(f"column-blocked {label} {str(dtype)[6:]}", "kernel 6" if not moments else "kernel 4",
                               r) + f"; bound {r['bound_ms']:.4f} ms"
                    + (f"; float32 kernel {r['float32_ms']:.4f} ms" if "float32_ms" in r else ""))
            out[label][name] = {"timing": r, "errors": err, "dtype": str(dtype).removeprefix("torch.")}
        del t
    for m in BIG_MS:
        t0 = time.perf_counter()
        big = large_b_check(ck, device, m)
        for name, row in big.items():
            worst[name] = max(worst.get(name, 0.0), *(v[0] for v in row.values()))
        out[f"b{BIG_B}_m{m}"] = {name: {"timing": None, "errors": {k: v[1] for k, v in row.items()},
                                        "dtype": "float64"} for name, row in big.items()}
        torch.cuda.empty_cache()
        log(f"large-B case M={m}: {time.perf_counter() - t0:.2f} s")
    reset_launches(ck)
    return out, worst


def phase_cols_float32_precision(ck, device):
    """Phase 51: the float32 column-blocked route past M=2,406 at
    ill-conditioned shapes, against the float64 plain version within
    FLOAT32_FACTOR times the float32 plain version's own error, no floor:
    kernels 4 and 6 at M=2,500 on the oracle paths' data (B=8192, D=2,
    lengthscale 1, Z on the batch's rows) and kernel 4 with two latents at
    M=2,410 on the heteroscedastic oracle's (B=8192, D=1).  Returns
    {label: {wrapper: errors}}."""
    out = {}
    Xo = oracle_data("studentt", "cpu")[0]
    Xh = pair_het_data("cpu")[0]
    for label, t, kernels in (("oracle_m2500_d2", pair_inputs(Xo, OB, 2500, 1, device, ls=1.0), "both"),
                              ("het_m2410_d1_L2", pair_inputs(Xh, OB, 2410, 2, device, ls=1.0), "moments")):
        out[label] = {}
        for name, caller, a, names in cols_calls(t, kernels):
            fn = getattr(ck, name)
            if ck.kappa_route("moments" if name != "fused_kappa" else "single", a["Z"].shape[-2])[0] != "cols":
                raise AssertionError(f"{name} {label}: not on the column-blocked route")
            got = caller(fn, a)
            torch.cuda.synchronize()
            plain = getattr(ck, name + "_reference")
            out[label][name] = check_outputs(f"column-blocked {name} float32 {label}", names, got, caller(plain, a),
                                             caller(plain, to_float64(a)), floor=0.0)
            check_repeat(f"{name} {label}", lambda: caller(fn, a), got)
    return out


def cols_svgp(agt, X, m):
    return agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create(),
                           agt.AnalyticSVI(CB, minibatch_sampling="slice"), X[:m], optimiser=None)


def cols_svgp_steps(agt, X, y, m, draws, perm=None, model=None, state=None):
    """(model, state, treated labels) of an SVGP path after len(draws) CAVI
    steps from the given slice starts: a new model on the labels y, or
    (model, state) on the treated labels y; ``perm`` reorders a new
    model's inducing points."""
    from agp_tpu_torch.training.train import vi_steps

    y_t = y
    if model is None:
        model = cols_svgp(agt, X, m)
        if perm is not None:
            model = model.replace(Z=model.Z[:, perm.to(X.device)].contiguous())
        y_t, lik = model.likelihood.treat_labels(y)
        model = model.replace(likelihood=lik)
        y_t = y_t.to(device=X.device, dtype=X.dtype)
        state = agt.init_state(model, X, y_t)
    model, state = vi_steps(model, state, X, y_t, len(draws), draws=draws.to(X.device))
    return model, state, y_t


def cols_svgp_error(agt, model, state, X, y):
    return 1.0 - float((agt.predict_y(model, state, X[:COLS_EVAL]) == y[:COLS_EVAL]).double().mean())


def cols_movgp(agt, X):
    liks = [agt.GaussianLikelihood.create(0.1), agt.LogisticLikelihood.create()]
    return seeded_A(agt.MOVGP.create(X, liks, agt.SqExponentialKernel(lengthscale=CV_LS), agt.AnalyticVI(),
                                     n_latent=2, optimiser=None))


def cols_movgp_steps(agt, X, ys, n, model=None, state=None):
    """(model, state, treated labels) of a MOVGP path after n CAVI steps
    (full batch): a new model on the labels ys, or (model, state) on the
    treated labels ys."""
    ys_t = ys
    if model is None:
        model, ys_t = mo_treated(cols_movgp(agt, X), ys)
        state = agt.mo_init_state(model, X, ys_t)
    model, state = mo_steps(model, state, X, ys_t, n)
    return model, state, ys_t


def cols_movgp_error(agt, model, state, X, f):
    return float(torch.sqrt(torch.mean((agt.mo_predict_f(model, state, X[:256])[0][0] - f[:256]) ** 2)))


def cols_path(agt, ck, device, which, dtype):
    """One path of phase 52 ("svgp" or "movgp" in ``dtype``): on the host's
    CPU in float64 (the floor's run) and on the card in ``dtype`` from the
    same draws, COLS_SVGP_STEPS or COLS_STEPS CAVI steps, the card's with
    its exact launches (kernels 6 + 7 or 4 + 5, column-blocked 6 or 4);
    the card's error (1 - accuracy on the first COLS_EVAL rows, or task 0's
    RMSE on 256 points) within COLS_FLOOR_FACTOR times the CPU run's;
    card-vs-CPU parity of mu (max |d mu| / max |mu|): in float64 within
    F64_PATH_TOL of the CPU's float64 run, in float32 (``parity_check``)
    within ORACLE_DEVICE_FACTOR times the path's own float32 noise (the
    card's run again with its inducing points, or a MOVGP's rows,
    reordered) of the CPU's float32 run; then the card's run on to
    COLS_TRAIN_STEPS steps (logistic_m512_b65536's accuracy floor) or
    CV_ITERS (the reference's RMSE threshold).  Returns its numbers."""
    t0 = time.perf_counter()
    r = {}
    if which == "svgp":
        m = C32_M if dtype == torch.float32 else C64_M
        Xc, yc = big_logistic_data("cpu")
        steps = COLS_SVGP_STEPS
        draws = torch.randint(0, LN - CB + 1, (steps,), generator=torch.Generator().manual_seed(1))
        run = lambda X, y, perm=None: cols_svgp_steps(agt, X, y, m, draws, perm)  # noqa: E731
        error = lambda out, X, y: cols_svgp_error(agt, out[0], out[1], X, y)  # noqa: E731
        route, counter = "single", "fused_kappa"
        perm = torch.randperm(m, generator=torch.Generator().manual_seed(2))
        unperm = lambda mu: mu[:, torch.argsort(perm)]  # noqa: E731
        run_perm = lambda X, y: run(X, y, perm)  # noqa: E731
    else:
        n = CV32_N if dtype == torch.float32 else CV64_N
        m = n
        Xc, fc, ysc = mo_data(n, "cpu", torch.float64, seed=4)
        yc = ysc
        steps = COLS_STEPS
        run = lambda X, y: cols_movgp_steps(agt, X, y, steps)  # noqa: E731
        error = lambda out, X, y: cols_movgp_error(agt, out[0], out[1], X, fc.to(X.device, X.dtype))  # noqa: E731
        route, counter = "batched", "fused_kappa_moments_batched"
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(2))
        unperm = lambda mu: mu[:, torch.argsort(perm)]  # noqa: E731
        run_perm = lambda X, y: run(X[perm.to(X.device)], tuple(v[perm.to(X.device)] for v in y))  # noqa: E731
    to = lambda v, dev, dt: (tuple(a.to(dev, dt) for a in v) if isinstance(v, tuple) else  # noqa: E731
                             v.to(dev, dt))
    X64, y64 = Xc.double(), to(yc, "cpu", torch.float64)
    t1 = time.perf_counter()
    cpu64 = run(X64, y64)
    r["cpu64_s"] = time.perf_counter() - t1
    r["cpu64_error"] = error(cpu64, X64, y64[0] if which == "movgp" else y64)
    Xd, yd = Xc.to(device, dtype), to(yc, device, dtype)
    reset_launches(ck)
    card = run(Xd, yd)
    torch.cuda.synchronize()
    f64 = dtype == torch.float64
    r["launches"] = expect_launches(ck, f"column-blocked {which} {str(dtype)[6:]} M={m}",
                                    route_launches(steps, route, f64=f64))
    if ck.kappa_route("single" if which == "svgp" else "moments", m, dtype)[0] != "cols":
        raise AssertionError(f"{which} M={m}: not on the column-blocked route")
    r["error"] = error(card, Xd, yd[0] if which == "movgp" else yd)
    r["floor"] = COLS_FLOOR_FACTOR * r["cpu64_error"]
    mu_card = card[1].mu.double().cpu()
    if f64:
        r["parity"] = float((mu_card - cpu64[1].mu).abs().max() / cpu64[1].mu.abs().max())
        r["parity_bound"] = F64_PATH_TOL
    else:
        cpu32 = run(Xc.float(), to(yc, "cpu", torch.float32))[1].mu.double()
        noise_mu = unperm(run_perm(Xd, yd)[1].mu.double().cpu())
        noise = float((noise_mu - mu_card).abs().max() / mu_card.abs().max())
        r["parity"] = float((mu_card - cpu32).abs().max() / cpu32.abs().max())
        r["parity_share"] = parity_check(f"column-blocked {which} M={m}", r["parity"], noise)
        r["parity_bound"], r["noise"] = ORACLE_DEVICE_FACTOR * noise, noise
    label = f"column-blocked {which} {str(dtype)[6:]} M={m}"
    if not r["error"] <= r["floor"]:
        raise AssertionError(f"{label}: error {r['error']:.4f} > floor {r['floor']:.4f} ({COLS_FLOOR_FACTOR:g} x the "
                             f"CPU float64 run's {r['cpu64_error']:.4f})")
    if f64 and not r["parity"] <= F64_PATH_TOL:
        raise AssertionError(f"{label}: card vs CPU (float64) {r['parity']:.3e} > {F64_PATH_TOL:g}")
    # on to a trained model, on the card alone
    more = (COLS_TRAIN_STEPS if which == "svgp" else CV_ITERS) - steps
    reset_launches(ck)
    t1 = time.perf_counter()
    if which == "svgp":
        more_draws = torch.randint(0, LN - CB + 1, (more,), generator=torch.Generator().manual_seed(3))
        model, state, _ = cols_svgp_steps(agt, Xd, card[2], m, more_draws, model=card[0], state=card[1])
    else:
        model, state, _ = cols_movgp_steps(agt, Xd, card[2], more, model=card[0], state=card[1])
    torch.cuda.synchronize()
    r["train_s"] = time.perf_counter() - t1
    r["launches"] += expect_launches(ck, f"{label} training", route_launches(more, route, f64=f64))
    if which == "svgp":
        r["accuracy"] = 1.0 - cols_svgp_error(agt, model, state, Xd, yd)
        ok = r["accuracy"] >= MIN_BIG_ACC
    else:
        r["rmse"] = cols_movgp_error(agt, model, state, Xd, fc.to(device, dtype))
        ok = r["rmse"] < CV_RMSE
    if not (ok and bool(torch.isfinite(state.mu).all())):
        raise AssertionError(f"{label}: after {more + steps} steps {r.get('accuracy', r.get('rmse'))} misses "
                             f"{MIN_BIG_ACC if which == 'svgp' else CV_RMSE}")
    r["seconds"] = time.perf_counter() - t0
    log(f"{label} ({steps} steps from the same draws): error {r['error']:.4f} (floor {r['floor']:.4f} = "
        f"{COLS_FLOOR_FACTOR:g} x the CPU float64 run's {r['cpu64_error']:.4f}, {r['cpu64_s']:.2f} s on the CPU); "
        f"card vs CPU {r['parity']:.3e} (bound {r['parity_bound']:.3e}); {r['launches']} launches ({counter} "
        f"column-blocked); after {more + steps} steps "
        + (f"accuracy {r['accuracy']:.4f}" if which == "svgp" else f"RMSE {r['rmse']:.4f}")
        + f" ({r['train_s']:.2f} s); {r['seconds']:.2f} s")
    return r


def phase_cols_paths(agt, ck, device):
    """Phase 52: the four paths past the old ceilings (``cols_path``): the
    SVGP at M=4,096 in float32 and M=2,048 in float64, the MOVGP on 3,000
    points in float32 and 1,500 in float64."""
    out = {}
    for which, dtype in (("svgp", torch.float32), ("svgp", torch.float64), ("movgp", torch.float32),
                         ("movgp", torch.float64)):
        out[f"{which} {str(dtype)[6:]}"] = cols_path(agt, ck, device, which, dtype)
    return out


def cols_mode(agt, ck, device):
    """Phases 50-52 (``python3 chip_smoke.py cols``): kernels 4 and 6
    column-blocked past the old ceilings, the float32 route's precision at
    ill-conditioned shapes, the four paths."""
    kernels = timed_phase("column-blocked kernels 4 and 6", phase_cols_kernels, ck, device)
    timed_phase("column-blocked float32 precision", phase_cols_float32_precision, ck, device)
    paths = timed_phase("column-blocked paths", phase_cols_paths, agt, ck, device)
    return kernels, paths


# ------------------------- the (data, latent) mesh, samplers, stream (53-55)
# phase 53: bench.py:165-179's multiclass (K=MK, N=MN, D=MD, M=MM, B=MB,
# slice) through sharded_svi_train on a 1 x 2 and a 2 x 2 mesh (5 latents a
# rank) for TAIL_MC_STEPS steps; tpu_acceptance.py:370-412's M=512
# multiclass oracle (K=3, B=PAIR_MC_B, PAIR_MC_STEPS steps) on a 1 x 2 mesh
# (latents 2 + 1).  Each data index draws its own slice starts.
TAIL_MC_STEPS, TAIL_MC_EVAL = 100, 4096
# the first steps of a process (each kernel's first load, the allocator)
# are left out of its rate; the world-1 run's rate comes after 5 steps
TAIL_WARM_STEPS = 10
# phase 54: SMC on phase 25's N=SAMPLER_N data rule (TAIL_SMC_P particles,
# TAIL_SMC_TEMPS temperatures, the default 5 MALA steps) and the Gibbs row
# (phase 24's model and solver "cg", GIBBS_CHAINS chains, its 50 burn-in
# sweeps; TAIL_GIBBS_SAMPLES samples, a quarter of phase 24's: a cut of steps) over
# TAIL_WORLD processes; Gibbs chain means within TAIL_SE standard errors
TAIL_SMC_P, TAIL_SMC_TEMPS, TAIL_GIBBS_SAMPLES, TAIL_SE = 64, 8, 100, 6.0
# phases 53-55's one-card worlds (gloo); phase 55's flagship checkpoint
# after JK_SVI_SAVE of JK_SVI_STEPS steps, as phase 40's
TAIL_WORLD = 2
# floors from ``python3 chip_smoke.py slice-tail-cpu`` (phase 53's paths at
# world 1 in float64 on the card's host's CPU, on each mesh's global
# draws): the K=10 multiclass's training accuracy on X[:TAIL_MC_EVAL] after
# TAIL_MC_STEPS steps reads 0.87354 (the 1 x 2 mesh's draws) and 0.87012
# (2 x 2's); three times its error gives 0.61, so the tighter earlier
# bound, bench.py's multiclass MIN_MC_ACC, holds it.  The M=512 oracle
# reads 0.99634 there and keeps MIN_PAIR_MC_ACC; the Gibbs row keeps
# GIBBS_FLOORS["sign"], the streaming row ONLINE_FLOORS["oips"], the
# flagship MIN_FLAGSHIP_ACC.
SLICE_TAIL_FLOORS = {"mc_k10": MIN_MC_ACC}
# the Gibbs row's chain means of phase 24 (solver "cg"), when it ran
GIBBS_ROW = {}


def tail_mc_case(which):
    """(data, model builder, steps, global B, accuracy rows) of a phase-53
    case: "k10" (bench.py's multiclass) or "m512" (the M=512 oracle)."""
    if which == "k10":
        return mc_data, lambda agt, X: multi_model(agt, X, "multiclass"), TAIL_MC_STEPS, MB
    return pair_mc_data, lambda agt, X: pair_multi_model(agt, X, "multiclass"), PAIR_MC_STEPS, PAIR_MC_B


def tail_mc_draws(which, n_data):
    """[steps, n_data] slice starts: each data index's rows of its shard."""
    _, _, steps, b = tail_mc_case(which)
    rows = (MN if which == "k10" else ON) // n_data
    return torch.randint(0, rows - b // n_data + 1, (steps, n_data), generator=torch.Generator().manual_seed(9))


def tail_world1(agt, X, y, model, draws, perm=None):
    """The world-1 run on a (data, latent) run's global rows: step i's batch
    is each data index's B / n_data rows from its slice start (in its shard
    of N / n_data rows), in data order, through the single-device step
    (kernel 2 at M=64, kernels 4 + 5 at M=512); ``perm`` reorders Z.
    Returns (model, state)."""
    from agp_tpu_torch.inference.analytic_vi import variational_update

    y_t, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    if perm is not None:
        model = model.replace(Z=model.Z[:, perm].contiguous())
    y_t = y_t.to(device=X.device, dtype=X.dtype)
    state = agt.init_state(model, X, y_t)
    n_data = draws.shape[1]
    rows, bpd = X.shape[0] // n_data, model.inference.batchsize // n_data
    within = torch.arange(bpd, device=X.device)
    starts = draws.to(X.device)
    for i in range(draws.shape[0]):
        idx = torch.cat([d * rows + starts[i, d] + within for d in range(n_data)])
        model, state = variational_update(model, state, X.index_select(0, idx), y_t.index_select(0, idx))
        state = state.replace(step=state.step + 1)
    return model, state


def tail_mesh_child(agt, ck, pm, mesh, root, device):
    """Phase 53 in a child: each case through sharded_svi_train on its
    data index's slice starts; (results of rank 0, launches by case,
    seconds by case)."""
    res, launches, seconds = {}, {}, {}
    cases = ("k10", "m512") if mesh.data.size == 1 else ("k10",)
    for which in cases:
        data, make, steps, b = tail_mc_case(which)
        X, y = data(device)
        starts = torch.load(os.path.join(root, f"{which}_{mesh.data.size}.pt"))[:, mesh.data.rank, None]
        bpd, warm = b // mesh.data.size, TAIL_WARM_STEPS
        reset_launches(ck)
        # the first steps load each kernel of the step and fill the allocator: untimed
        m, s = pm.sharded_svi_train(make(agt, X), X, y, warm, mesh=mesh, batch_per_device=bpd, draws=starts[:warm])
        sync(device)
        torch.distributed.barrier()  # the processes start their clocks together
        t0 = time.perf_counter()
        m, s = pm.sharded_svi_train(m, X, y, steps - warm, mesh=mesh, batch_per_device=bpd, state=s,
                                    draws=starts[warm:])
        sync(device)
        seconds[which] = time.perf_counter() - t0
        launches[which] = {name: launches_of(ck, name) for name in LAUNCH_COUNTERS if launches_of(ck, name)}
        if which == "k10" and mesh.data.size > 1 and device.type == "cuda":  # rank 0's profiled, on 2 x 2
            steps_fn, m_p, s_p, Xs, ys = pm.build_svi_trainer(m, X, y, mesh, bpd, s)
            run = lambda: steps_fn(m_p, s_p, Xs, ys, JK_PROFILE_STEPS, draws=starts[-JK_PROFILE_STEPS:].to(device))
            if mesh.rank == 0:
                p = profile_window(run, JK_PROFILE_STEPS)
                seconds["profile"] = {k: p[k] for k in ("wall_us", "busy_us", "idle_share", "launches")}
            else:
                run()
        mg, sg = pm.gather_latents(mesh, m, s)
        acc = float((agt.predict_y(mg, sg, X[:TAIL_MC_EVAL]) == y[:TAIL_MC_EVAL]).float().mean())
        res[which] = (sg.mu.cpu(), sg.Sigma.cpu(), acc, (m.n_latent, mg.n_latent))
    return res, launches, seconds


def tail_sampler_child(agt, pm, mesh, device):
    """Phase 54 in a child: SMC with its particles over the processes, the
    Gibbs row with its chains over them (each process's chains against its
    one-process twin, bit for bit)."""
    from agp_tpu_torch import bench
    from agp_tpu_torch.inference.smc import gather_particles

    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    Xs, ys = sampler_data(device)
    m = agt.MCGP.create(Xs, ys, agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create())
    seconds = {}
    sync(device)
    torch.distributed.barrier()  # the processes start their clocks together
    t0 = time.perf_counter()
    fs, log_z = agt.smc_sample(m, n_particles=TAIL_SMC_P, n_temps=TAIL_SMC_TEMPS, generator=gen(11), mesh=mesh)
    sync(device)
    seconds["smc"] = time.perf_counter() - t0
    block = tuple(fs.shape)
    f_all = gather_particles(mesh, fs)
    model = bench.gibbs_workload(device, "cg")
    own = GIBBS_CHAINS // mesh.size
    kept = agt.sample(model, TAIL_GIBBS_SAMPLES, generator=gen(20 + mesh.rank), n_chains=GIBBS_CHAINS, mesh=mesh)
    sync(device)
    torch.distributed.barrier()  # the twin, warm, gives the rate: a sweep has no collective
    t0 = time.perf_counter()
    twin = agt.sample(model, TAIL_GIBBS_SAMPLES, generator=gen(20 + mesh.rank), n_chains=own)
    sync(device)
    seconds["gibbs"] = time.perf_counter() - t0
    mine = kept[mesh.rank * own:(mesh.rank + 1) * own]
    equal = bool(torch.equal(mine, twin if own > 1 else twin[None]))
    flags = [None] * mesh.size
    torch.distributed.all_gather_object(flags, {"twin": equal, "block": block})
    return {"smc": (f_all.cpu(), float(log_z)), "gibbs": kept.mean(1)[:, 0].cpu(), "flags": flags}, seconds


def tail_stream(agt, name, X, y, device, mesh=None):
    """An online path (phase 27's "oips" or phase 29's "wide") streamed
    batch by batch through online_train, on ``mesh`` or on one process;
    (model, state, seconds of batches 2 to ONLINE_BATCHES: the first
    loads each kernel of the step)."""
    b = WIDE_B if name == "wide" else ONLINE_B
    model, state = online_model(agt, name, device, X.dtype), None
    for i in range(ONLINE_BATCHES):
        if i == 1:
            sync(device)
            if mesh is not None:
                torch.distributed.barrier()  # the processes start their clocks together
            t0 = time.perf_counter()
        model, state = agt.online_train(model, X[i * b:(i + 1) * b], y[i * b:(i + 1) * b], state=state,
                                        iterations=ONLINE_ITERS, mesh=mesh)
    sync(device)
    return model, state, time.perf_counter() - t0


def tail_stream_child(agt, ck, pm, mesh, root, device):
    """Phase 55 in a child: the two streams over the processes, then the
    flagship through sharded_svi_train with rank 0's gathered checkpoint
    at JK_SVI_SAVE steps, resumed from it on this world."""
    res, seconds = {}, {}
    for name in ("oips", "wide"):
        X, f, y = online_data(name, device, torch.float32)
        model, state, seconds[name] = tail_stream(agt, name, X, y, device, mesh)
        n = ONLINE_BATCHES * (WIDE_B if name == "wide" else ONLINE_B)
        mu = agt.predict_f(model, state, X[:n], chunk_size=4096)
        rmse = float(torch.sqrt(torch.mean((mu.double() - f[:n].double()) ** 2)))
        res[name] = (state.mu.cpu(), state.Sigma.cpu(), model.Z.cpu(), model.z_mask.cpu(), rmse)
        if name == "oips" and device.type == "cuda":  # one batch more, rank 0's profiled
            xb, yb = X[n:n + ONLINE_B], y[n:n + ONLINE_B]
            run = lambda: agt.online_train(model, xb, yb, state=state, iterations=ONLINE_ITERS, mesh=mesh)
            if mesh.rank == 0:
                p = profile_window(run, ONLINE_ITERS)
                seconds["profile"] = {k: p[k] for k in ("wall_us", "busy_us", "idle_share", "launches")}
            else:
                run()
    X, y = flagship_data(device)
    draws = torch.load(os.path.join(root, "draws.pt"))[:, mesh.rank].to(device)
    bpd = B // mesh.size
    reset_launches(ck)
    model, state = pm.sharded_svi_train(flagship_model(agt, X), X, y, JK_SVI_SAVE, mesh=mesh, batch_per_device=bpd,
                                        draws=draws[:JK_SVI_SAVE])
    local = pm.gather_local_vars(mesh, state.local_vars)
    if mesh.rank == 0:
        agt.checkpoint.save(os.path.join(root, "tail50"), model, state.replace(local_vars=local))
    model, state = pm.sharded_svi_train(model, X, y, JK_SVI_STEPS - JK_SVI_SAVE, mesh=mesh, batch_per_device=bpd,
                                        state=state, draws=draws[JK_SVI_SAVE:])
    torch.distributed.barrier()  # the checkpoint is written
    tmpl = flagship_model(agt, X)
    m50, s50 = agt.checkpoint.load(os.path.join(root, "tail50"), tmpl, agt.init_state(tmpl, X, y))
    m50, s50 = pm.sharded_svi_train(m50, X, y, JK_SVI_STEPS - JK_SVI_SAVE, mesh=mesh, batch_per_device=bpd,
                                    state=s50, draws=draws[JK_SVI_SAVE:])
    launches = {name: launches_of(ck, name) for name in LAUNCH_COUNTERS if launches_of(ck, name)}
    res["svi"] = (state.mu.cpu(), float((agt.predict_y(model, state, X) == y).float().mean()))
    res["resumed"] = s50.mu.cpu()
    return res, {"flagship": launches}, seconds


def tail_rank(phase, rank, world, init, root, device, backend):
    """``python3 chip_smoke.py tail-rank PHASE RANK WORLD INIT ROOT DEVICE
    BACKEND``: one process of phase 53, 54 or 55 on DEVICE (cuda:0 for
    every rank over gloo; cuda:RANK over NCCL, ``slice-tail-nccl``), on a
    (data, latent) mesh with a latent axis of 2 for phase 53, a data mesh
    otherwise.  Prints its launches by case and its seconds as its last
    line; rank 0 writes its results to ROOT/tailPHASE_WORLD.pt."""
    import agp_tpu_torch as agt
    from agp_tpu_torch.ops import cuda_kernels as ck
    from agp_tpu_torch.parallel import mesh as pm

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(device)
    if device.type == "cuda":
        ck._library()  # built by the parent
    mesh = pm.initialize_distributed(init, world, rank, backend=backend, device=device,
                                     latent=2 if phase == "53" else 1)
    for axis in (mesh, mesh.data, mesh.latent):  # NCCL makes a group's communicator at its first collective
        axis.all_reduce(torch.zeros(1, device=device))
    t1 = time.perf_counter()
    if phase == "53":
        res, launches, seconds = tail_mesh_child(agt, ck, pm, mesh, root, device)
    elif phase == "54":
        reset_launches(ck)
        res, seconds = tail_sampler_child(agt, pm, mesh, device)
        launches = {"samplers": {name: launches_of(ck, name) for name in LAUNCH_COUNTERS if launches_of(ck, name)}}
    else:
        res, launches, seconds = tail_stream_child(agt, ck, pm, mesh, root, device)
    seconds.update(setup=t1 - t0, cases=time.perf_counter() - t1)
    if rank == 0:
        torch.save(res, os.path.join(root, f"tail{phase}_{world}.pt"))
    torch.distributed.barrier()  # no rank tears down while another is still in a collective
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "launches": launches, "seconds": seconds}), flush=True)


def tail_spawn(phase, world, root, device, backend):
    """Starts the ``tail-rank`` processes of one world; returns them."""
    init = f"file://{os.path.abspath(root)}/rendezvous{phase}_{world}"
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), "tail-rank", phase, str(r), str(world), init,
                              root, str(device) if backend == "gloo" else f"cuda:{r}", backend],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


def tail_reports(phase, procs, root, world):
    """Waits for a world's processes; (rank 0's results, every rank's
    report).  A process that fails fails the phase.  Logs the world's wall
    time and rank 0's parts of it."""
    t0 = time.perf_counter()
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"tail-rank {phase} failed ({p.returncode}):\n{text[-4000:]}")
    reports = [json.loads(t.strip().splitlines()[-1]) for t in logs]
    log(f"phase {phase}'s {world} processes: {time.perf_counter() - t0:.2f} s from the spawn; rank 0 "
        f"{reports[0]['seconds']['setup']:.2f} s to its mesh (CUDA, the library, the groups), "
        f"{reports[0]['seconds']['cases']:.2f} s in its cases")
    return torch.load(os.path.join(root, f"tail{phase}_{world}.pt")), reports


def tail_launches(label, reports, want, device):
    """Every rank launched each case's kernels exactly as ``want`` names
    them ({case: {kernel: n}}) and nothing else; adds them to LAUNCHES."""
    for rep in reports:
        for case, counts in want.items():
            got = rep["launches"].get(case, {})
            if got != counts and device.type == "cuda":  # the CPU's plain versions launch nothing
                raise AssertionError(f"{label} rank {rep['rank']} {case}: launched {got}, expected {counts}")
            for k, v in got.items():
                LAUNCHES[k] = LAUNCHES.get(k, 0) + v


def phase_latent_mesh(agt, ck, device, root, worlds=(2, 4), backend="gloo"):
    """Phase 53: the (data, latent) mesh at full width, one world at a time
    (``worlds``: 2 processes as 1 x 2 and 4 as 2 x 2, all on the one card
    over gloo; NCCL refuses two ranks on one GPU).  bench.py's K=10
    multiclass (5 latents a rank) on each, and the M=512 oracle (K=3:
    latents 2 + 1) on 1 x 2.  Each run: rank 0's gathered mu and Sigma
    against the world-1 card run on the same global rows (kernel 2 at
    M=64, kernels 4 + 5 at M=512) within ORACLE_DEVICE_FACTOR times that
    path's float32 noise (the world-1 run again with Z reordered); its
    accuracy against its floor; every rank's exact launches (kernels 4 and
    5 once a step, kernel 2 never); its it/s against the world-1 rate."""
    out = {}
    perm = torch.randperm(MM, generator=torch.Generator().manual_seed(2))
    for world in worlds:
        n_data = world // 2
        for which in ("k10", "m512"):
            torch.save(tail_mc_draws(which, n_data), os.path.join(root, f"{which}_{n_data}.pt"))
        t0 = time.perf_counter()
        res, reports = tail_reports("53", tail_spawn("53", world, root, device, backend), root, world)
        wall = time.perf_counter() - t0
        cases = ("k10", "m512") if n_data == 1 else ("k10",)
        tail_launches(f"mesh {n_data} x 2", reports, {
            c: {"fused_kappa_moments_batched": tail_mc_case(c)[2], "cavi_stats_batched": tail_mc_case(c)[2]}
            for c in cases}, device)
        for which in cases:
            data, make, steps, _ = tail_mc_case(which)
            X, y = data(device)
            draws = torch.load(os.path.join(root, f"{which}_{n_data}.pt"))
            tail_world1(agt, X, y, make(agt, X), draws[:5])  # warm-up
            reset_launches(ck)
            sync(device)
            t0 = time.perf_counter()
            _, w1 = tail_world1(agt, X, y, make(agt, X), draws)
            sync(device)
            w1_ips = steps / (time.perf_counter() - t0)
            if device.type == "cuda":  # the CPU's plain versions launch nothing
                expect_launches(ck, f"{which} world 1", route_launches(
                    steps, "fused" if which == "k10" else "batched", fused="fused_cavi_stats_multiclass"))
            p = perm if which == "k10" else torch.randperm(PM, generator=torch.Generator().manual_seed(2))
            _, wp = tail_world1(agt, X, y, make(agt, X), draws, perm=p.to(device))
            back = torch.argsort(p).to(device)
            noise = max(mu_err(wp.mu, w1.mu, p), mu_err(wp.Sigma[:, back][:, :, back], w1.Sigma))
            mu, Sigma, acc, latents = res[which]
            label = f"{which} mesh {n_data} x 2"
            share = parity_check(label, max(mu_err(mu, w1.mu), mu_err(Sigma, w1.Sigma)), noise,
                                 what="rank 0's gathered mu and Sigma vs world 1 on the same global rows")
            floor = SLICE_TAIL_FLOORS["mc_k10"] if which == "k10" else MIN_PAIR_MC_ACC
            ips = [(steps - TAIL_WARM_STEPS) / rep["seconds"][which] for rep in reports]
            log(f"{label} ({world} processes on {'one card' if backend == 'gloo' else f'{world} cards'} over "
                f"{backend}, {steps} steps, rank 0's latents {latents[0]} of {latents[1]}): accuracy {acc:.4f} "
                f"(floor {floor}), parity share {share:.4f}, it/s by rank {', '.join(f'{v:.1f}' for v in ips)} "
                f"against world 1's {w1_ips:.1f} (kernel {'2' if which == 'k10' else '4 + 5'}); {wall:.2f} s for the "
                f"world")
            if not acc >= floor:
                raise AssertionError(f"{label}: accuracy {acc:.4f} < {floor}")
            out[label] = {"acc": acc, "share": share, "ips": ips, "world1_ips": w1_ips}
            prof = reports[0]["seconds"].get("profile")
            if which == "k10" and prof is not None:
                out[label]["profile"] = prof
                log(f"{label} rank 0's profiled step ({JK_PROFILE_STEPS} more): {prof['wall_us']:.1f} us wall, "
                    f"{prof['busy_us']:.1f} us device, idle share {prof['idle_share']:.4f}, "
                    f"{prof['launches']:.1f} launches")
    return out


def gibbs_row_means(agt, device):
    """Phase 24's chain means ([C, N], solver "cg"), or the same call
    made here when phase 24 did not run in this process."""
    if "cg" not in GIBBS_ROW:
        from agp_tpu_torch import bench

        _, s = bench.gibbs_rate(bench.gibbs_workload(device, "cg"), GIBBS_SAMPLES, GIBBS_CHAINS)
        GIBBS_ROW["cg"] = s.mean(1)[:, 0]
    return GIBBS_ROW["cg"].double().cpu()


def phase_tail_samplers(agt, ck, device, root, world=TAIL_WORLD, backend="gloo"):
    """Phase 54: particle-parallel SMC and chain-parallel Gibbs over
    ``world`` processes.  SMC (the same draws on every process): rank 0's
    gathered particles and log Z against the world-1 card run within
    ORACLE_DEVICE_FACTOR times its float32 noise (the world-1 run again
    with X's features in another order, which the kernel's sums round
    differently), run after the processes end (their rates measured
    alone).  Gibbs: each process's chains bit-equal to its
    one-process twin; the pooled mean over the points within TAIL_SE
    standard errors (of its chains' spread) of phase 24's, and its sign
    agreement with the labels above GIBBS_FLOORS; chain-sweeps/s of each
    twin (warm; a sweep has no collective) beside phase 24's."""
    from agp_tpu_torch import bench

    res, reports = tail_reports("54", tail_spawn("54", world, root, device, backend), root, world)
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    Xs, ys = sampler_data(device)
    feats = torch.randperm(Xs.shape[1], generator=torch.Generator().manual_seed(2)).to(device)
    runs = {}
    for label, X in (("world 1", Xs), ("features reordered", Xs[:, feats].contiguous())):
        m = agt.MCGP.create(X, ys, agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create())
        runs[label] = agt.smc_sample(m, n_particles=TAIL_SMC_P, n_temps=TAIL_SMC_TEMPS, generator=gen(11))
    ref_means = gibbs_row_means(agt, device)
    tail_launches("samplers", reports, {"samplers": {}}, device)
    (f_all, log_z), w1, wf = res["smc"], runs["world 1"], runs["features reordered"]

    def smc_err(a, b):
        return max(float((a[0].double().cpu() - b[0].double().cpu()).abs().max() / b[0].double().abs().max()),
                   abs(float(a[1]) - float(b[1])) / abs(float(b[1])))

    share = parity_check(f"smc over {world}", smc_err((f_all, log_z), w1), smc_err(wf, w1),
                         what="the gathered particles and log Z vs world 1 (the same draws)")
    flags = res["flags"]
    means = res["gibbs"].double()  # [C, N]
    c1, c2 = ref_means.shape[0], means.shape[0]
    scalar = means.mean(1), ref_means.mean(1)  # each chain's mean over the points
    se = float(torch.sqrt(scalar[0].var() / c2 + scalar[1].var() / c1))
    gap = float(scalar[0].mean() - scalar[1].mean())
    pooled = means.mean(0)
    y = bench.gibbs_workload("cpu", "cg").train_y.double()
    sign = float((torch.sign(pooled) == y).double().mean())
    rates = [GIBBS_CHAINS // world * (TAIL_GIBBS_SAMPLES + 50) / rep["seconds"]["gibbs"] for rep in reports]  # twins
    log(f"smc over {world} processes (N={SAMPLER_N}, {TAIL_SMC_P} particles, {TAIL_SMC_TEMPS} temperatures): block "
        f"{flags[0]['block']}, log Z {log_z:.4f} (world 1 {float(w1[1]):.4f}), parity share {share:.4f}, "
        f"{reports[0]['seconds']['smc']:.3f} s; gibbs over {world} processes ({GIBBS_CHAINS // world} chains each, "
        f"{TAIL_GIBBS_SAMPLES} samples): twins bit-equal {[f['twin'] for f in flags]}, mean over the points "
        f"{float(scalar[0].mean()):.5f} vs phase 24's {float(scalar[1].mean()):.5f} ({gap / se:.3f} standard "
        f"errors), largest point gap {float((pooled - ref_means.mean(0)).abs().max()):.4f}, sign agreement {sign:.5f}, "
        f"chain-sweeps/s by rank {', '.join(f'{r:.2f}' for r in rates)}")
    if not all(f["twin"] for f in flags):
        raise AssertionError(f"gibbs over {world}: a process's chains differ from its one-process twin")
    if not (abs(gap) <= TAIL_SE * se and sign >= GIBBS_FLOORS["sign"]):
        raise AssertionError(f"gibbs over {world}: {gap / se:.3f} standard errors from phase 24, sign {sign:.5f}")
    return {"smc_share": share, "gibbs_se": gap / se, "sign": sign, "chain_sweeps": rates}


def phase_tail_stream(agt, ck, device, root, world=TAIL_WORLD, backend="gloo"):
    """Phase 55: phase 27's streaming row and phase 29's wide stream over
    ``world`` processes (each batch's rows split, the selection made on
    process 0): Z and its mask equal to the world-1 card run's, mu and
    Sigma within ORACLE_DEVICE_FACTOR times the path's float32 noise (the
    world-1 card run's distance to the same run with X's features in
    another order, or for the 2-D row, where a reordering rounds nothing,
    in float32 on the host's CPU; float64 takes another jitter; either
    must select the same set), the streaming row's RMSE floor, points/s; then the flagship's checkpoint gathered on
    rank 0 after JK_SVI_SAVE of JK_SVI_STEPS steps (kernel 1), resumed on
    this world and on one process, each within phase 40's noise of the
    uninterrupted run."""
    draws = torch.randint(0, (N // world) // 64, (JK_SVI_STEPS, world, B // world // 64),
                          generator=torch.Generator().manual_seed(7))
    torch.save(draws, os.path.join(root, "draws.pt"))
    from agp_tpu_torch.utils import native

    native.available()  # builds the first batch's C++ OIPS here, before the processes time their streams
    res, reports = tail_reports("55", tail_spawn("55", world, root, device, backend), root, world)
    w1 = {}
    for name in ("oips", "wide"):
        X, f, y = online_data(name, device, torch.float32)
        m, s, secs = tail_stream(agt, name, X, y, device)
        if name == "wide":  # D=8: the sums over the features round otherwise in another order
            feats = torch.randperm(WIDE_D, generator=torch.Generator().manual_seed(2)).to(device)
            mn, sn, _ = tail_stream(agt, name, X[:, feats].contiguous(), y, device)
        else:  # D=2: a reordering rounds nothing; the host's CPU in float32 does
            mn, sn, _ = tail_stream(agt, name, X.cpu(), y.cpu(), torch.device("cpu"))
        if not torch.equal(mn.z_mask.cpu(), m.z_mask.cpu()):
            raise AssertionError(f"stream {name}: the noise run selects another inducing set")
        w1[name] = (m, s, secs, sn)
    X, y = flagship_data(device)
    draws_d = draws.to(device)
    perm = torch.randperm(M, generator=torch.Generator().manual_seed(2)).to(device)
    _, u1 = global_svi(agt, X, y, draws_d, world)
    _, u1p = global_svi(agt, X, y, draws_d, world, perm=perm)
    _, u1f = global_svi(agt, X, y, draws_d, world, flip=True)
    noise = max(mu_err(u1p.mu, u1.mu, perm.cpu()), mu_err(u1f.mu, u1.mu))
    tail_launches("stream and resume", reports, {"flagship": {"fused_cavi_stats": 2 * JK_SVI_STEPS - JK_SVI_SAVE}},
                  device)
    out = {}
    for name in ("oips", "wide"):
        m, s, secs, sc = w1[name]
        mu, Sigma, Z, mask, rmse = res[name]
        if not (torch.equal(Z, m.Z.cpu()) and torch.equal(mask, m.z_mask.cpu())):
            raise AssertionError(f"stream {name} over {world}: the inducing set differs from world 1's")
        noise_s = max(mu_err(s.mu, sc.mu), mu_err(s.Sigma, sc.Sigma))
        share = parity_check(f"stream {name} over {world}", max(mu_err(mu, s.mu), mu_err(Sigma, s.Sigma)), noise_s,
                             what="rank 0's mu and Sigma vs world 1")
        b = WIDE_B if name == "wide" else ONLINE_B
        points = [(ONLINE_BATCHES - 1) * b / rep["seconds"][name] for rep in reports]
        log(f"stream {name} over {world} processes ({ONLINE_BATCHES} batches of {b}, {int(mask[0].sum())} active "
            f"slots, the set equal to world 1's): RMSE {rmse:.5f}, parity share {share:.4f}, points/s by rank "
            f"{', '.join(f'{p:.1f}' for p in points)} against world 1's {(ONLINE_BATCHES - 1) * b / secs:.1f} (batches "
            f"2-{ONLINE_BATCHES})")
        floor = ONLINE_FLOORS[name].get("rmse")
        if floor is not None and not rmse <= floor:
            raise AssertionError(f"stream {name} over {world}: RMSE {rmse:.5f} > {floor}")
        out[name] = {"share": share, "rmse": rmse, "points": points}
        prof = reports[0]["seconds"].get("profile")
        if name == "oips" and prof is not None:
            out[name]["profile"] = prof
            log(f"stream oips over {world}, rank 0's profiled batch after the stream, an iteration: "
                f"{prof['wall_us']:.1f} us wall, {prof['busy_us']:.1f} us device, idle share "
                f"{prof['idle_share']:.4f}, {prof['launches']:.1f} launches")
    m41, s41 = agt.checkpoint.load(os.path.join(root, "tail50"), flagship_model(agt, X),
                                   agt.init_state(flagship_model(agt, X), X, y))
    _, s41 = global_svi(agt, X, y, draws_d, world, start=JK_SVI_SAVE, state=s41, model=m41)
    uninterrupted, acc = res["svi"]
    out["resume"] = {
        f"world {world}": parity_check(f"resumed on {world}", mu_err(res["resumed"], uninterrupted), noise,
                                       what=f"rank 0's checkpoint at step {JK_SVI_SAVE} resumed over {world} "
                                            f"processes vs the uninterrupted run at {JK_SVI_STEPS}"),
        "world 1": parity_check("resumed on 1", mu_err(s41.mu, uninterrupted), noise,
                                what=f"the same checkpoint resumed on one process vs the uninterrupted run")}
    log(f"flagship over {world} processes: accuracy {acc:.5f} (floor {MIN_FLAGSHIP_ACC}), resumed parity shares "
        f"{json.dumps({k: round(v, 4) for k, v in out['resume'].items()})}")
    if not acc >= MIN_FLAGSHIP_ACC:
        raise AssertionError(f"flagship over {world}: accuracy {acc:.5f} < {MIN_FLAGSHIP_ACC}")
    return out


def slice_tail_mode(agt, ck, device):
    """``python3 chip_smoke.py slice-tail``: phases 53-55 alone."""
    import tempfile

    root = tempfile.mkdtemp(prefix="tail-", dir=os.environ.get("TMPDIR"))
    return {"mesh": timed_phase("(data, latent) mesh", phase_latent_mesh, agt, ck, device, root),
            "samplers": timed_phase("sharded samplers", phase_tail_samplers, agt, ck, device, root),
            "stream": timed_phase("sharded stream and resume", phase_tail_stream, agt, ck, device, root)}


def slice_tail_nccl_mode(agt, ck, device):
    """``python3 chip_smoke.py slice-tail-nccl``: phases 53-55 over NCCL
    with one process on each card of the machine (2 cards: 1 x 2; 4: 2 x 2),
    against world 1 on cuda:0."""
    import tempfile

    world = torch.cuda.device_count()
    if world < 2 or world % 2:
        raise SystemExit(f"slice-tail-nccl needs an even count of two cards or more; {world} here")
    root = tempfile.mkdtemp(prefix="tail-nccl-", dir=os.environ.get("TMPDIR"))
    return {"mesh": timed_phase(f"(data, latent) mesh (NCCL, {world})", phase_latent_mesh, agt, ck, device, root,
                                worlds=(world,), backend="nccl"),
            "samplers": timed_phase(f"sharded samplers (NCCL, {world})", phase_tail_samplers, agt, ck, device, root,
                                    world=world, backend="nccl"),
            "stream": timed_phase(f"sharded stream and resume (NCCL, {world})", phase_tail_stream, agt, ck, device,
                                  root, world=world, backend="nccl")}


def slice_tail_cpu_mode(agt):
    """``python3 chip_smoke.py slice-tail-cpu``: phase 53's paths at world 1
    in float64 on the host's CPU, on each mesh's global draws, no floors
    held: the source of SLICE_TAIL_FLOORS."""
    torch.set_num_threads(min(torch.get_num_threads(), 8))
    cpu = torch.device("cpu")
    for which in ("k10", "m512"):
        data, make, steps, _ = tail_mc_case(which)
        X, y = (t.double() if t.is_floating_point() else t for t in data(cpu))
        for n_data in ((1, 2) if which == "k10" else (1,)):
            t0 = time.perf_counter()
            m, s = tail_world1(agt, X, y, make(agt, X), tail_mc_draws(which, n_data))
            acc = float((agt.predict_y(m, s, X[:TAIL_MC_EVAL]) == y[:TAIL_MC_EVAL]).double().mean())
            log(f"tail {which} on the CPU, float64, the {n_data} x 2 mesh's global draws ({steps} steps): accuracy "
                f"{acc:.5f}, {time.perf_counter() - t0:.2f} s")


def f64_rows(kernels):
    """The kernels line's rows of kernels 4-7's float64 forms, at
    logistic_m512_b65536 (the float32 rows' main shape), each with its
    ms, plain and library (float64 torch.matmul / torch.bmm) ms, its
    float32 kernel's ms on the same inputs, per-shape numbers and bound."""
    shape = "logistic_m512_b65536"
    bounds = {"fused_kappa_moments_batched": f64_kappa_bound(LB, LD, PM, 1, True),
              "cavi_stats_batched": f64_stats_bound(LB, PM, 1),
              "fused_kappa": f64_kappa_bound(LB, LD, PM, 1, False), "cavi_stats": f64_stats_bound(LB, PM, 1)}
    rows = []
    for name, line, source in (("fused_kappa_moments_batched", 361, "batched_pair.cu"),
                               ("cavi_stats_batched", 486, "batched_pair.cu"),
                               ("fused_kappa", 213, "kappa_single.cu"), ("cavi_stats", 545, "kappa_single.cu")):
        k, r = kernels[name], kernels[name]["shapes"][shape]
        rows.append({
            "name": f"{name}_f64",
            "route": "cuda",
            "source": f"agp_tpu_torch/csrc/{source}",
            "replaces": f"agp_tpu/ops/pallas_kernels.py:{line}",
            "dtype": "float64",
            "max_abs_err": k["worst"],
            "max_rel_err": k["rel"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            # kernels 4 and 6: no one PyTorch call computes the function; their
            # products alone in float64 are a yardstick beside it
            "library_ms": None if name.startswith("fused_kappa") else r["library_ms"],
            **({"products_ms": r["library_ms"], "products": "the products alone in float64 (torch.matmul; kernel 4: "
                "torch.bmm x2), cuBLAS: a yardstick, not the whole function"} if name.startswith("fused_kappa")
               else {"library": "torch.matmul / torch.bmm x2 in float64 (cuBLAS)"}),
            "float32_ms": r["float32_ms"],
            "device_us": r["device_us"],
            "per_shape_ms": ms_table({s: (v["ms"], v["plain_ms"]) for s, v in k["shapes"].items()}),
            "per_shape_float32_ms": {s: v["float32_ms"] for s, v in k["shapes"].items()},
            "per_shape_library_ms": {s: v["library_ms"] for s, v in k["shapes"].items()},
            "per_shape_device_us": {s: v["device_us"] for s, v in k["shapes"].items()},
            "per_shape_bound_ms": {s: v["bound_ms"] for s, v in k["shapes"].items()},
            **({"per_shape_slab_ms": {s: v["slab_ms"] for s, v in k["shapes"].items() if "slab_ms" in v},
                "slab": "the row-slab form in float64 on the same inputs, timed beside it"}
               if name.startswith("fused_kappa") else
               {"per_shape_k4_ms": {s: v["k4_ms"] for s, v in k["shapes"].items() if "k4_ms" in v},
                "per_shape_k4_device_us": {s: v["k4_device_us"] for s, v in k["shapes"].items() if "k4_ms" in v},
                "k4": "the m8n8k4 geometry (StatsF64K4) in float64 on the same inputs, timed beside it"}),
            "vs_plain_float64": k["errors"],
            "bound": "the function's products once at 67 TFLOP/s FP64 tensor cores, the gram and row sums at 34 FP64, "
                     "8-byte elements at 3.35 TB/s",
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
        })
    return rows


def cols_shapes(rows, cols_kernels):
    """Adds to the kernels line's rows of kernels 4 and 6 (float32) and of
    their float64 forms phase 50's shapes past the row slab's old ceilings
    ("column_blocked": {shape: ms, device us, plain ms, the products
    alone, bound, largest errors}), each where its dtype ran."""
    for label, by_kernel in cols_kernels.items():
        for name, r in by_kernel.items():
            row = next(k for k in rows if k["name"] == name + ("_f64" if r["dtype"] == "float64" else ""))
            t = r["timing"] or {}
            row.setdefault("column_blocked", {})[label] = {
                "ms": t.get("ms"), "device_us": t.get("device_us"), "plain_ms": t.get("plain_ms"),
                "products_ms": t.get("products_ms"), "bound_ms": t.get("bound_ms"),
                "float32_ms": t.get("float32_ms"), "errors": r["errors"]}


PHASE_SECONDS = {}


def timed_phase(name, fn, *args, **kw):
    """Runs one phase of main, logs and keeps its wall time."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 2)
    log(f"phase {name}: {PHASE_SECONDS[name]:.2f} s")
    return out


def main():
    t_start = time.perf_counter()
    if sys.argv[1:] == ["gibbs-cpu"]:  # the host's CPU alone, no card needed
        import agp_tpu_torch as agt

        gibbs_cpu_mode(agt)
        return
    if sys.argv[1:] == ["online-cpu"]:  # the host's CPU alone, no card needed
        import agp_tpu_torch as agt

        online_cpu_mode(agt)
        return
    if sys.argv[1:] == ["numerical-cpu"]:  # the host's CPU alone, no card needed
        import agp_tpu_torch as agt

        numerical_cpu_mode(agt)
        return
    if sys.argv[1:] == ["slice-h-cpu"]:  # the host's CPU alone, no card needed
        import agp_tpu_torch as agt

        slice_h_cpu_mode(agt)
        return
    if sys.argv[1:] == ["slice-jk-cpu"]:  # the host's CPU alone, no card needed
        import agp_tpu_torch as agt

        slice_jk_cpu_mode(agt)
        return
    if sys.argv[1:] == ["slice-l-cpu"]:  # the host's CPU alone, no card needed
        import agp_tpu_torch as agt

        slice_l_cpu_mode(agt)
        return
    if sys.argv[1:] == ["slice-tail-cpu"]:  # the host's CPU alone, no card needed
        import agp_tpu_torch as agt

        slice_tail_cpu_mode(agt)
        return
    if sys.argv[1:2] == ["jk-rank"]:  # one process of phase 40, started by it
        jk_rank(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:8])
        os._exit(0)  # its results are written; an orderly shutdown can abort in gloo's threads' teardown
    if sys.argv[1:2] == ["tail-rank"]:  # one process of phases 53-55, started by them
        tail_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), *sys.argv[5:9])
        os._exit(0)
    device = phase_device()
    args = sys.argv[1:]
    ab = args[:1] == ["ab"]
    if ab:  # ab ROOT MODE...: MODE with agp_tpu_torch from ROOT
        sys.path.insert(0, os.path.abspath(args[1]))
        args = args[2:]
    import agp_tpu_torch as agt
    from agp_tpu_torch.ops import cuda_kernels as ck

    if args == ["moved-paths"]:
        time_moved_paths(agt, device)
        return
    if args[:1] == ["probe"]:
        probe_mode(ck, args[1] if len(args) > 1 else "all")
        return
    if args == ["dense-cpu"]:  # the CPU alone: no kernel to build
        dense_cpu_mode(agt, ck)
        return
    lib_path = timed_phase("build", phase_build, ck)
    if not ab:  # this tree's fused_fits against its own library
        timed_phase("fused_fits", check_fused_fits, ck)
    if args == ["studentt-rate"]:
        launches, ips = phase_studentt_rate(agt, ck, device)
        print(json.dumps({"launches": launches, "ips": ips}))
        return
    if args == ["stats"]:
        stats_mode(agt, ck, device)
        return
    if args == ["kappa"]:
        kappa_mode(agt, ck, device)
        return
    if args == ["variants"]:
        variants_mode(agt, device)
        return
    if args == ["fused"]:
        fused_mode(agt, ck, device)
        return
    if args == ["paths"]:
        paths_mode(agt, ck, device)
        return
    if args == ["multi"]:
        multi_mode(agt, ck, device)
        return
    if args[:1] == ["bits"] and len(args) == 2:
        bits_mode(agt, ck, device, args[1])
        return
    if args[:2] == ["profile", "kernels"]:
        profile_bench_kernels(device)
        return
    if args == ["dense"]:
        dense_mode(agt, ck, device)
        return
    if args == ["ladder"]:
        ladder_mode(agt, device)
        return
    if args == ["samplers"]:
        samplers_mode(agt, ck, device)
        return
    if args[:2] == ["profile", "gibbs"]:
        profile_gibbs(agt, device)
        return
    if args == ["online"]:
        online_mode(agt, ck, device)
        return
    if args[:2] == ["profile", "online"]:
        profile_online(agt, device)
        return
    if args == ["numerical"]:
        numerical_mode(agt, ck, device)
        return
    if args == ["softmax-forms"]:
        softmax_forms_mode(agt, ck, device)
        return
    if args[:2] == ["profile", "numerical"]:
        profile_numerical(agt, device, args[2] if len(args) > 2 else "quad")
        return
    if args[:2] == ["profile", "dense"]:
        profile_dense(agt, device, args[2] if len(args) > 2 else "gp")
        return
    if args == ["slice-h"]:
        slice_h_mode(agt, ck, device)
        return
    if args == ["slice-jk"]:
        slice_jk_mode(agt, ck, device)
        return
    if args == ["slice-jk-nccl"]:
        slice_jk_nccl_mode(agt, ck, device)
        return
    if args == ["slice-l"]:
        slice_l_mode(agt, ck, device)
        return
    if args == ["slice-tail"]:
        slice_tail_mode(agt, ck, device)
        return
    if args == ["slice-tail-nccl"]:
        slice_tail_nccl_mode(agt, ck, device)
        return
    if args == ["float64"]:
        timed_phase("tensor-core SASS", check_tc_sass, lib_path)
        timed_phase("kappa tiles", check_kappa_tiles, ck)
        float64_mode(agt, ck, device)
        return
    if args == ["cols"]:
        timed_phase("tensor-core SASS", check_tc_sass, lib_path)
        timed_phase("kappa tiles", check_kappa_tiles, ck)
        cols_mode(agt, ck, device)
        return
    if args[:2] == ["profile", "mo"]:
        profile_mo(agt, device)
        return
    if args[:2] == ["profile", "hyper"]:
        profile_hyper_path(agt, device, args[2] if len(args) > 2 else "A")
        return
    if args[:1] == ["profile"]:
        profile_pair_path(agt, device, args[1])
        return
    timed_phase("tensor-core SASS", check_tc_sass, lib_path)
    timed_phase("kappa tiles", check_kappa_tiles, ck)
    timed_phase("variant tiles", check_variant_tiles, ck)
    errs, kern_ms, plain_ms = timed_phase("kernel 1 vs plain", phase_kernel_vs_plain, ck, device)
    branch_err, per_lik, per_kind, oracle_ms = timed_phase("kernel 1 branches", phase_branches_vs_plain,
                                                           agt, ck, device)
    multi = timed_phase("kernels 2-3 vs plain", phase_multi_kernels_vs_plain, ck, device)
    timed_phase("flagship path", phase_main_path, agt, ck, device)
    LAUNCHES["fused_cavi_stats"] += timed_phase("Student-t rate (child)", studentt_rate_first_in_process)
    timed_phase("oracle and flagship parity", phase_oracle_and_parity, agt, device)
    for which in ("multiclass", "het"):
        timed_phase(f"{which} path", phase_multi_path, agt, ck, device, which)
    timed_phase("multi-latent parity", phase_multi_parity, agt, device)
    timed_phase("oracles M=128", phase_oracles, agt, ck, device)
    timed_phase("single-latent parity", phase_single_parity, agt, ck, device)

    pair = timed_phase("kernels 4-5 vs plain", phase_pair_kernels_vs_plain, ck, device)
    timed_phase("kernel 4 autograd", phase_pair_autograd, ck, device)
    single = timed_phase("kernels 6-7 vs plain", phase_single_kernels_vs_plain, ck, device)
    timed_phase("kernel 6 autograd", phase_kappa_autograd, ck, device)
    timed_phase("logistic_m512_b65536", phase_big_logistic, agt, ck, device)
    for which in ("multiclass", "het"):
        timed_phase(f"{which} M=512", phase_pair_multi, agt, ck, device, which)
    timed_phase("oracles M=512", phase_oracles, agt, ck, device, m=PM, floors=PAIR_ORACLE_FLOORS,
                paths=[(lik, "SqExponentialKernel") for lik in ORACLE_LIKS])
    timed_phase("pair parity", phase_pair_parity, agt, ck, device)
    for which in ("A", "B"):
        timed_phase(f"hyper path {which}", phase_hyper_path, agt, ck, device, which)
    timed_phase("hyper parity", phase_hyper_parity, agt, ck, device)

    variant_err, ill, variant_ms, bar_ms, k1_ms, variant_dev = timed_phase(
        "kernels 8-9 vs plain", phase_variant_kernels_vs_plain, agt, ck, device)
    timed_phase("bench variants", phase_bench_variants, ck)
    gather_ms, gather_library = timed_phase("kernel 10 vs plain", phase_gather_vs_plain, device)
    timed_phase("bench gather", phase_bench_gather, ck)
    timed_phase("bench entry point (child)", phase_bench_entry)
    for which in DENSE_PATHS:
        timed_phase(f"{which} path", phase_dense, agt, ck, device, which)
    timed_phase("svgp_noise path", phase_noise, agt, ck, device)
    timed_phase("dense parity", phase_dense_parity, agt, device)
    samplers_mode(agt, ck, device)
    online_mode(agt, ck, device)
    numerical_mode(agt, ck, device)
    slice_h_mode(agt, ck, device)
    slice_jk_mode(agt, ck, device)
    slice_l_mode(agt, ck, device)
    f64_kernels, _ = float64_mode(agt, ck, device)
    (cols_kernels, _), _ = cols_mode(agt, ck, device)
    slice_tail_mode(agt, ck, device)
    log(f"phase seconds: {json.dumps(PHASE_SECONDS)}; total {time.perf_counter() - t_start:.2f} s")

    bounds = {
        "fused_cavi_stats": fused_bound(B, D, M, 1, 5),
        "fused_cavi_stats_multiclass": fused_bound(MB, MD, MM, MK, 3 + 4 * MK),
        "fused_cavi_stats_het": fused_bound(MB, MD, MM, 2, 6),
    }
    bounds["fused_kappa_moments_batched"], bounds["cavi_stats_batched"] = pair_bounds(LB, LD, PM, 1)
    bounds["fused_kappa"], bounds["cavi_stats"] = single_bounds(LB, LD, PM)
    bounds["direct_stats"] = variant_bound(*VARIANT_MAIN, False)
    bounds["two_factor_nt"] = variant_bound(*VARIANT_MAIN, True)
    bounds["gather_row_tiles"] = gather_bound(B // 32, 32, D)
    main_variant = shape_key(*VARIANT_MAIN)
    main_shape = "logistic_m512_b65536"
    kernels = {"kernels": [{
        "name": "fused_cavi_stats",
        "route": "cuda",
        "source": "agp_tpu_torch/csrc/fused_cavi_stats.cu",
        "replaces": "agp_tpu/ops/pallas_kernels.py:750",
        "max_abs_err": max(branch_err, *(v for row in errs.values() for v in row.values())),
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "per_lik_ms": ms_table(per_lik),
        "per_kind_ms": ms_table(per_kind),
        "oracle_shape_ms": ms_table({"studentt/rbf": oracle_ms}),
        "library_ms": bar_ms[shape_key(B, D, M)],
        "library": "xla_stats_reference at the flagship shape (phase 16)",
        "sweep_row": main_variant,
        "sweep_row_ms": k1_ms[main_variant],
        "sweep_row_device_us": variant_dev["fused_cavi_stats"][0],
        "sweep_row_device_us_by_kernel": variant_dev["fused_cavi_stats"][1],
        "sweep_row_library_ms": bar_ms[main_variant],
        "sweep_row_library_device_us": variant_dev["xla_stats_reference"][0],
        "sweep_row_bound_ms": fused_bound(*VARIANT_MAIN, 1, 5)[0][0],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "agp_tpu_torch/csrc/fused_cavi_stats_multi.cu",
        "replaces": f"agp_tpu/ops/pallas_kernels.py:{line}",
        "max_abs_err": multi[name]["worst"],
        "ms": multi[name]["ms"],
        "plain_ms": multi[name]["plain_ms"],
        "per_kind_ms": ms_table(multi[name]["per_kind"]),
        "device_us": multi[name]["device_us"],
        "device_us_by_kernel": multi[name]["device_us_by_kernel"],
        "products_ms": multi[name]["products_ms"],
        "products_device_us": multi[name]["products_device_us"],
        "products": "kappa's, kappa Sigma's and S2's products alone (torch.bmm x3): a yardstick, not the whole "
                    "function",
        "oracle_vs_float64": multi[name]["oracle"],
        "bound": "the function's products (kappa; the quadratic form's and S2's upper triangles) once at 495 TFLOP/s "
                 "TF32, the gram and row sums at 67 FP32, bytes at 3.35 TB/s",
        "bound_3xtf32": "kappa and kappa Sigma in full and S2's upper triangle in three TF32 passes, the rest at "
                        "FP32, bytes",
        "bound_fp32": "everything at 67 TFLOP/s FP32, bytes",
    } for name, line in (("fused_cavi_stats_multiclass", 953), ("fused_cavi_stats_het", 1133))] + [{
        "name": name,
        "route": "cuda",
        "source": f"agp_tpu_torch/csrc/{source}",
        "replaces": f"agp_tpu/ops/pallas_kernels.py:{line}",
        "max_abs_err": table[name][0],
        "ms": table[name][1][main_shape][0],
        "plain_ms": table[name][1][main_shape][1],
        "per_shape_ms": ms_table(table[name][1]),
        "library_ms": table[name][2].get(main_shape),
        "per_shape_library_ms": table[name][2] or None,
        **timing_fields(table[name][3], main_shape),
    } for name, line, source, table in (
        ("fused_kappa_moments_batched", 361, "batched_pair.cu", pair),
        ("cavi_stats_batched", 486, "batched_pair.cu", pair),
        ("fused_kappa", 213, "kappa_single.cu", single),
        ("cavi_stats", 545, "kappa_single.cu", single),
    )] + [{
        "name": name,
        "route": "cuda",
        "source": "agp_tpu_torch/csrc/fused_variants.cu",
        "replaces": f"benchmarks/fused_variants.py:{line}",
        "max_abs_err": variant_err[name],
        "ms": variant_ms[main_variant][label][0],
        "plain_ms": variant_ms[main_variant][label][1],
        "main_shape": main_variant,
        "per_shape_ms": ms_table({f"{shape} {k}": v for shape, row in variant_ms.items() for k, v in row.items()
                                  if k.startswith(name)}),
        "library_ms": bar_ms[main_variant],
        "per_shape_library_ms": bar_ms,
        "library": "xla_stats_reference (the sweep's bar, a chain of FP32 cuBLAS calls)",
        "device_us": variant_dev[label][0],
        "device_us_by_kernel": variant_dev[label][1],
        "per_variant_device_us": {k: v[0] for k, v in variant_dev.items() if k.startswith(name)},
        "kernel_1_ms": k1_ms,
        "ill_conditioned_vs_float64": {k: v for k, v in ill.items() if k.startswith(name) or
                                       k.startswith("fused_cavi_stats")},
        "bound": "the function's products (kappa; the quadratic form's and S2's upper triangles) once at 495 TFLOP/s "
                 "TF32, the gram and row sums at 67 FP32, bytes at 3.35 TB/s",
        "bound_3xtf32": "kappa and kappa Sigma in full (kernel 9: and W in four passes) and S2's upper triangle in "
                        "three TF32 passes, the rest at FP32, bytes",
        "bound_fp32": "everything at 67 TFLOP/s FP32, bytes",
    } for name, line, label in (("direct_stats", 132, "direct_stats/nt"), ("two_factor_nt", 214, "two_factor_nt"))] + [{
        "name": "gather_row_tiles",
        "route": "cuda",
        "source": "agp_tpu_torch/csrc/gather_tiles.cu",
        "replaces": "benchmarks/gather_modes.py:218",
        "max_abs_err": 0.0,
        "ms": gather_ms[32][0],
        "plain_ms": gather_ms[32][1],
        "per_tile_ms": ms_table({f"tile{tr}": v for tr, v in gather_ms.items()}),
        "library_ms": gather_library[32],
        "per_tile_library_ms": {f"tile{tr}": v for tr, v in gather_library.items()},
    }] + f64_rows(f64_kernels)}
    for row in kernels["kernels"][-4:]:  # the float64 forms' bounds (f64_rows)
        bounds[row["name"]] = (row.pop("bound_ms"), row.pop("bound_by"))
    cols_shapes(kernels["kernels"], cols_kernels)
    for name in [n for n, v in bounds.items() if len(v) == 3]:
        # (function's, 3xTF32 design's, FP32) bounds
        bounds[name], design, fp32 = bounds[name]
        row = next(k for k in kernels["kernels"] if k["name"] == name)
        row["bound_3xtf32_ms"], row["bound_fp32_ms"] = design[0], fp32[0]
    for k in kernels["kernels"]:
        k["launches"] = LAUNCHES.get(k["name"], 0)
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        k.setdefault("library_ms", None)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
