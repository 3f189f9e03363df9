#!/usr/bin/env python3
"""Drives gpflow_tpu_torch's main paths once on one NVIDIA GPU and checks them.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases 5-8,21  # phases 1-4, then only these
    python3 chip_smoke.py --k1-host-us ROOT  # K1's host dispatch with ROOT's package
    python3 chip_smoke.py --mesh-host-ms     # the latent-split step's host time, mesh or not

With ``--phases`` the script runs the build and the kernel checks of phases
1-4, then each group of phases that holds a selected one (5-8, 9-10, 11-12,
13-16, and 17 to 29 alone), then the record's kernel timings; without it,
every phase. ``--k1-host-us`` builds K1 from the checkout at ROOT and prints
phase 23's host time of one K1 call with that checkout's package, three
times, and nothing else: run it on two checkouts in one call to compare.

The paths are those of ``bench.py``'s flagship model at full width (SVGP,
D = 8, M = 2048 inducing points, batches and requests of B = 8192 points,
float32, Gaussian likelihood, whitened full q_sqrt), with values made from a
numpy seed: serving (slice 1) and training (slice 2); and ``bench.py``'s
exact-GP operating points (GPR at N = 8192 and 16384, D = 8, float32,
SquaredExponential, noise 0.1; slice 3); and its non-conjugate operating point
(a Bernoulli SVGP with M = 1024, B = 4096, D = 8, N = 32768, float32, 20
Gauss-Hermite points, natural gradients and Adam; slice 4); and its CGLB
operating point (SGPR, GPRFITC and the matrix-free CGLB at N = 32768,
M = 1024, chunk 4096, D = 8, float32; slice 6); and VGP and
VGPOpperArchambeau at N = 4096, D = 8, float32, on the natural-gradient
operating point's classification data and the GPR generator's regression
data (slice 7; ``bench.py`` has no VGP operating point); and the
multiclass SVGP of the JAX harness (``benchmark/models.py:80-108``) with
MultiClass (RobustMax) and Softmax over C = 10 latent GPs at M = 1024,
B = 4096, N = 32768, D = 64 on synthetic data (slice 8; ``bench.py`` has no
multiclass operating point); and the multioutput SVGP at SARCOS's shapes
(N = 44484, D = 21, P = 7) with M = 1024, B = 4096 (slice 9; ``bench.py``
has no multioutput operating point); and GPMC and SGPMC with priors on
their hyperparameters, sampled by HMC at the natural-gradient operating
point's widths (slice 10; ``bench.py`` has no MCMC operating point); and the
GPLVM and the Bayesian GPLVM through the psi statistics, with
``uncertain_conditional``, at oil flow's width (P = 12) with Q = 10 latent
dimensions on synthetic data (slice 11; ``bench.py`` has no GPLVM operating
point); and the convolutional SVGP at MNIST's shapes (28 x 28 images, 5 x 5
patches, M = 750 inducing patches, C = 10, B = 256) with ChangePoints and
Categorical GPRs at N = 8192 (slice 12; ``bench.py`` has no convolutional
operating point); and the flagship SVGP and the GPR at N = 8192 served from
``torch.export`` artifacts, with checkpoints and the trainer's state
(slice 13); and the tools around them, ``training_loop``, ``Monitor`` with
its TensorBoard tasks, the summary table, the profiler and the matmul tier
on the flagship SVGP and the GPR at N = 8192 (slice 14); and the shape
contracts of slices 1-6 on those paths, with the checks on and off (slice
15). Models are built
on the card, the
port's default device; the float64 references ask for the CPU, or for float64
on the card where the CPU would take minutes. Phases:

1. card: name and power limit; TF32 must be off for matmul and cuDNN;
2. build: kernels K1 and K2 from the sources in the checkout, one nvcc each,
   started together;
3. K1 against its plain PyTorch version on the card, six families, float32
   and bfloat16 inputs, at the paths' shapes and at ragged ones, each with
   its launch plan logged; both the TMA and the edge path must have run;
4. K2 against its plain version likewise, for its four families, and with a
   g that starts 4 bytes off alignment; then on an [N, N] block with X = Z
   (exponential and matern12), where W must be exactly 0 at every
   coincident pair;
5. the serving slice (SquaredExponential): ``model.posterior()`` with the
   TENSOR cache, requests through ``predict_f`` and ``predict_mean``, and
   ``model.predict_f`` and ``model.predict_y`` on the solve and INV_SOLVE
   routes; outputs finite with var > 0, K1's launch count exactly as the path
   implies, and one request of each entry point against the same model in
   float64 on the CPU;
6. the gradients of ``stationary_kernel_matrix`` (rbf from the saved K,
   matern52 through K2) at the Kuu and Kuf shapes, and (rbf, matern12) at
   the GPR's [N, N] Gram shape, against plain PyTorch autograd in float64;
7. the training slice: for SquaredExponential and Matern52 on the solve and
   INV_SOLVE routes, ``run_steps_sampled`` on data made as ``bench.py`` makes
   it, with CUDA's sync debug mode set to error; losses finite and falling,
   launch counts exactly as the path implies; then the first three steps of
   Matern52 on INV_SOLVE against the same model in float64 on the CPU;
8. serving from the trained Matern52 model;
9. the GPR slice: at N = 8192 and 16384 on the solve and INV_SOLVE routes,
   ``training_loss()`` and its gradient under sync debug mode "error"
   against the same model in float64 on the card; a Matern12 GPR at
   N = 8192 likewise (K2 on the path); 15 iterations (30 before phase 20) of
   ``Scipy().minimize`` at N = 16384, which must lower the objective; then
   ``posterior()`` with ``predict_f`` and ``predict_mean``, and the fused
   ``predict_f`` and ``predict_y``, on 8192 new points against float64;
   launch counts exactly as each path implies;
10. timings with CUDA events: per request, training steps per second for each
   kernel and route, a ``torch.profiler`` breakdown of one step, the GPR
   objective with and without its gradient, seconds per L-BFGS iteration,
   GPR requests, the blocked triangular inverse against cuSOLVER, a
   profiler breakdown of one GPR value-and-gradient;
11. the non-conjugate slice, its objective, training and minimize loop
   under sync debug mode "error": the Bernoulli ELBO, its gradient and the
   quadrature's variational expectations on one batch against float64 on
   the card;
   ``run_steps_sampled`` of ``DataParallelTrainer(natgrad_gamma=0.1)``, 250
   fused steps and 50 sequential ones, losses finite and the ELBO rising,
   ``natgrad_rejections`` printed, the first three steps of each mode
   against float64 on the card; 20 fused Matern52 steps (K2 on the path);
   ``NaturalGradient.minimize`` then one Adam step, five times; requests of
   4096 new points to the trained classifier (cached ``predict_f``,
   ``predict_y``, ``predict_log_density``) against float64, probabilities
   within [1e-3, 1 - 1e-3]; launch counts exactly as each path implies; steps
   per second of both modes, a profile of one fused step and of its
   natural-gradient update alone, request latency, and K1 and K2 at the
   path's shapes;
12. K1 and K2 against their plain versions at the GPR's shapes;
13. the sparse-regression slice at ``bench.py``'s CGLB operating point
   (N = 32768, M = 1024, D = 8, float32, SquaredExponential, noise 0.1):
   the SGPR ELBO, the Titsias upper bound and the GPRFITC objective with
   their gradients under sync debug mode "error" against float64 on the
   card, elbo <= upper_bound, 20 ``Scipy`` iterations of the SGPR, and
   requests of 8192 new points through its ``posterior()`` and fused entry
   points against float64; each float64 check beside a lower-tier control
   (K1 fed bfloat16-rounded inputs, TF32 matmuls), which must break one of
   its limits; the objectives' checks again on two more data sets;
14. the dense CGLB against the matrix-free one at N = 8192, M = 512, chunk
   2048 and one fixed v, on three data sets, the value and gradient within
   N * eps32 (the gradient in Z within a limit set from readings);
15. the matrix-free CGLB (chunk 4096) at bench width: the objective from
   v = 0 with its CG iterations; the value and gradient at the float64 CG's
   v under sync debug mode "error" against float64 and the lower-tier
   control, for SquaredExponential and Matern52 (K2 on the path), on three
   data sets; the sandwich bound <= upper_bound before and after training;
   the peak memory of one value and gradient below N^2 * 4 bytes; five
   ``Scipy`` iterations with ``nonfinite_penalty`` over the traced closure
   (one trace; each evaluation's CG from the same ``aux_vec``), which must
   improve on the objective from v = 0; adversarial v = s * 1; requests of 8192 new
   points (``predict_f``, ``predict_y``, ``predict_log_density``) against
   float64 from the same v and the lower-tier control; K1 and K2 launch
   counts exactly as the recorded CG iterations imply;
16. timings: the CGLB objective from v = 0 and warm-started, ms per CG
   iteration, seconds per L-BFGS evaluation, the SGPR objective and its
   value and gradient, a profile of one matrix-free value and gradient,
   requests, and K1 and K2 at the path's new shapes; then K1 and K2 at the
   GPR's shapes and K1 at (1, 1, 8), the launch floor;
17. the VGP slice at N = 4096: (a) one ``NaturalGradient(gamma=1)`` step on
   a Gaussian VGP in float64 on the card reaches the GPR's log marginal
   likelihood (rtol 1e-7) and its requests (1e-6), then the same step in
   float32 against float64; (b) the classifier (SquaredExponential +
   Linear, Bernoulli, Constant mean): ELBO and gradient under sync debug
   mode "error" against float64, a Periodic VGP's objective (no K1), 8
   ``Scipy`` iterations of ``training_loss_closure`` (20 before phase 20
   came), which must lower the
   objective, and requests of 4096 new points (``posterior()`` and
   ``predict_f``, fused ``predict_f``, ``predict_y``,
   ``predict_log_density``) on both routes against float64, probabilities
   in [0, 1]; (c) a Matern52 VGP's value and gradient (K2 on the path);
   (d) VGPOpperArchambeau's value, gradient and ``predict_f``; each
   float32 check beside the lower-tier control, which must break one of its
   limits; (e) ``SVGP_deprecated`` against ``SVGP`` at the flagship width;
   (f) K1 and K2 launch counts exactly as each path implies; (g) timings:
   the value and gradient of both models, L-BFGS, requests, a profile of
   one VGP value and gradient, K1 and K2 at (4096, 4096, 8);
18. the multiclass slice: (a) the MultiClass ELBO and gradient at B = 4096
   under sync debug mode "error" against float64 on the card, on three sets
   of values, and Softmax's with fixed draws, each beside the lower-tier
   control; (b) ``run_steps_sampled``, 20 Adam steps each for MultiClass and
   Softmax and 20 fused natural-gradient steps for MultiClass, under sync
   debug mode "error", losses finite and falling; (c) 5 ``Scipy`` iterations
   of ``training_loss_closure`` over N = 32768, which must lower the
   objective; (d) requests of 4096 held-out points (``posterior()`` and
   ``predict_f``, fused ``predict_f``, ``predict_y``,
   ``predict_log_density``) on both routes against float64, Softmax with
   fixed draws, class probabilities in [0, 1] (Softmax's summing to 1),
   accuracy above chance; (e) StudentT, Exponential, Gamma, Beta,
   ``SwitchedLikelihood``, ``GaussianMC`` and the heteroskedastic two-latent
   SVGP at the natural-gradient point, value and gradient against float64;
   (f) K1 against its plain version at (1024, 1024, 64), (1024, 4096, 64),
   (1024, 32768, 64) and (1024, 4096, 13), launch counts exactly as each
   path implies; (g) timings: value and gradient, steps per second, L-BFGS,
   requests, a profile of one MultiClass value and gradient, K1 at the four
   shapes;
19. the multioutput slice at SARCOS's shapes (N = 44484, 4449 held out,
   D = 21, P = 7; synthetic data from a seed) with M = 1024, B = 4096: (a)
   the main model, a LinearCoregionalization of L = 4 latent GPs (two
   SquaredExponential, two Matern52) on separate inducing points, its ELBO
   and gradient under sync debug mode "error" against float64 on the card
   on three sets of values, beside the lower-tier control, and once more on
   the INV_SOLVE route (the batched [L, M, M] inverse and its backward);
   (b) likewise
   SharedIndependent and SeparateIndependent over the 7 outputs; (c) the
   main model on the fallback route (the interdomain Kuf [M, L, B, P]),
   also equal to (a) from the same values; (d) the fully correlated route
   at M = 256, B = 1024, whitened and not (the [MP, MP] prior KL), against
   float64; (e) ``run_steps_sampled`` over the 44484 rows, 20 Adam steps
   each for (a) and the shared model and 20 fused natural-gradient steps
   (gamma 0.1) for (a), under sync debug mode "error", losses finite and
   falling; (f) requests of the 4449 held-out points to the trained (a)
   (``posterior()`` with ``predict_f`` and ``predict_mean``, fused
   ``predict_f`` with and without the full output covariance, whose
   diagonal must be the marginal variance, ``predict_y``,
   ``predict_log_density``) on both routes against float64 beside the
   control; (g) an SVGP
   with SquaredExponential * Coregion(7, rank 2) on 4096 stacked rows
   [x, output index] under a SwitchedLikelihood of 7 Gaussians, against
   float64 beside the control; (h) K1 and K2 against their plain versions
   at the D = 21 shapes, TMA and edge paths, and launch counts exactly as
   each path implies; (i) timings: each route's value and gradient, steps
   per second, requests, a profile of one value and gradient of (a), K1 and
   K2 at the D = 21 shapes;
20. the MCMC slice at the natural-gradient operating point's widths
   (Bernoulli labels, D = 8; Matern32 with ARD lengthscales and LogNormal
   priors on its variance and lengthscales): (a) SGPMC at M = 1024 over
   N = 32768 (Z frozen), ``run_hmc`` through ``SamplingHelper`` under sync
   debug mode "error" (each step a replay of one traced step), 100 burn-in
   steps adapting the step size toward an
   acceptance of 0.75 and 20 kept samples of 10 leapfrog steps, log
   probabilities finite, the acceptance logged; ``target_log_prob_fn`` and
   its gradient against float64 on the card at the initial state, a
   perturbed one and the state after burn-in, beside the lower-tier
   control; the posterior predictive (``predict_y`` averaged over the kept
   samples) on 4096 held-out points must beat the majority-class rate; (b)
   GPMC on the first 4096 rows likewise, then ``predict_f_samples`` with
   ``full_cov=True`` on the held-out points, whose moments must match
   ``predict_f``'s; (c) in float64 on the card: a leapfrog trajectory run
   back with the momentum negated returns to its start, |dH| falls by about
   4 per halving of the step, and the JAX package's conjugate oracles hold
   (GPMC against the exact GPR posterior, SGPMC against SGPR's optimal
   q(u), chain moments within 5 Monte-Carlo standard errors); (d)
   ``sample_conditional`` on phase 19's LinearCoregionalization at its 4449
   request points, the moments of 1000 draws against the conditional's; (e)
   K1 and K2 (matern32) against their plain versions at the path's shapes,
   launch counts exactly as the recorded leapfrog and step counts imply, and
   timings: each model's value and gradient, ms per HMC step, the chain, a
   profile of one SGPMC value and gradient and of one HMC step, K1 and K2
   at the path's shapes;
21. the latent-variable slice (P = 12, Q = 10; the data a smooth manifold
   made from a seed): (a) a BayesianGPLVM at N = 1000, M = 50 from PCA, 50
   float64 L-BFGS iterations, which must raise the bound; the float32 bound
   and its gradient against float64 on the card at the start, the result
   and a perturbed point, each beside the lower-tier control, the float32
   path's host syncs counted (``torch.linalg.eigh`` in the psi2 projection
   reads its error flag) and the float64 one under sync debug mode "error";
   ``predict_f`` of 1000 new points with and without ``full_cov``; the
   analytic psi0, psi1 and psi2 at Q = 2 against the quadrature fallback with
   20 points a dimension (K1 at (50, 400000, 2)); (b) a BayesianGPLVM at
   N = 8192, M = 256 (one float32 [N, M, M] psi2 is 2.1 GB): the float32
   bound and gradient against float64 (psi2 summed over chunks of N), the
   peak memory, the times and a profile, ``predict_f`` at the 8192 latent
   means; (c) a GPLVM at N = 8192: the float32 value and gradient in X and
   the hyperparameters against float64 under sync debug mode "error" beside
   the control (SquaredExponential at two points, Matern52 with K2 on the
   path), 15 L-BFGS iterations, which must lower the objective; (d)
   ``uncertain_conditional`` at 1024 inputs against a whitened q(u) of
   M = 256, with and without a Linear mean function, float32 against
   float64 beside the control, and float64 against a Monte-Carlo estimate of
   10^4 draws at 16 inputs; (e) K1 and K2 against their plain versions at
   the path's D = 10 and D = 2 shapes (TMA and edge paths, scalar staging),
   launch counts exactly as each path implies, and their timings;
22. the convolutional slice (synthetic images from a seed): (a) a multiclass
   SVGP with a Convolutional kernel over InducingPatches at MNIST's shapes
   (28 x 28 images, 5 x 5 patches, M = 750, C = 10, RobustMax, whitened full
   q_sqrt, B = 256, N = 60000 and 1000 held out): the ELBO and its gradient
   under sync debug mode "error" against float64 on the card on two sets of
   values and with a Matern52 base kernel (K2 on Kuf's backward), each beside
   the lower-tier control; ``Kuf_conv_patch``'s K1 route against the JAX
   package's batched plain route; 50 Adam steps under sync debug mode
   "error"; requests of the 1000 held-out images through ``posterior()``
   and ``predict_y`` against float64, the held-out accuracy; CIFAR-10's
   shapes once (32 x 32 x 3, 3 x 3 patches, B = 32); (b) a GPR with
   ChangePoints of two Matern32 kernels at N = 8192, D = 1: the value and
   gradient against float64 within cond * eps32, 15 L-BFGS iterations; (c) a
   GPR with Categorical over D = 8 inputs and 10 labels at N = 8192 likewise,
   an out-of-range label's NaN row; (d) K1 and K2 against their plain
   versions at the path's D = 25, 9 and 1 shapes (K1 also at (8192, 8192,
   9)), TMA and edge paths, launch counts exactly as each path implies, the
   value and gradient's split, peak memory and profile, and the timings;
23. serving artifacts (phase 5's flagship SVGP from the same seed, and the
   GPR at N = 8192 of ``bench.py``'s data): (a) ``export_serving`` of
   ``predict_f``, ``predict_y`` and ``predict_mean`` with a symbolic batch,
   ``load_serving``, requests of 8192, 5000 and 1 points against the live
   cached posterior (expected exact; held within ``SV_RTOL``) and float64 on
   the card (phase 5's 1e-3), K1 launched inside the loaded programs once per
   method and request at (2048, n, 8), once at export for the cache's Kuu;
   (b) a bucketed export (1024, 4096, 8192), requests of 1000, 5000, 8192
   and 20000 points (the last in three chunks), launch counts per bucket and
   chunk, outputs against the symbolic artifact's; (c) the GPR's symbolic
   ``predict_f`` and ``predict_y`` at 8192 points against the live
   posterior and float64 within cond * eps32; (d) assigns to the model leave
   the artifact unchanged, and an export under ``set_pallas_enabled(False)``
   launches no K1 and leaves the switch as it was; (e) a fresh process that
   imports torch and ``gpflow_tpu_torch.utilities.serving`` only (no model
   code) serves the bucketed artifact to the same bits; (f) a checkpoint
   round trip, and the trainer's state saved after 10 Adam steps on explicit
   batches of B: a fresh trainer that loads it takes the next 10 steps to the
   same bits; (g) requests by CUDA events on both artifacts against the live
   posterior, and K1's host dispatch through its op; K1 against its plain
   version at the new shapes and their timings;
24. the training tools (phase 5's flagship SVGP from the same seed on one
   batch of B rows of phase 7's data, and the GPR at N = 8192): (a)
   ``training_loop`` of 20 steps with ``use_scan`` False and True from the
   same start, both under sync debug mode "error", against a hand loop of
   ``torch.optim.Adam`` over the same closure, K1 twice a step, ms per step
   by CUDA events; (b) a ``Monitor`` over a 20-step loop, a period-1 group
   (an ``ExecuteCallback`` recording the ELBO, a ``ScalarToTensorBoard``)
   and a period-5 group (``ModelToTensorBoard``, and ``ImageToTensorBoard``
   where matplotlib is installed), the call counts, and the event file read
   back against the logged values (a task whose package is missing is
   named and not run); (c) the GPR fit by ``Scipy().minimize`` for 5
   iterations with the ``Monitor`` as ``step_callback``, called once per
   iteration with the step alone, K1 once per evaluation; (d)
   ``tabulate_module_summary`` of the trained SVGP against the table built
   from ``read_values``, and ``print_summary``; (e) ``profile`` around 3
   steps under ``annotate("train_step")``, whose trace must hold the
   annotation and K1; (f) the flagship ELBO's float32 error against float64
   on the card with exact fp32 matmuls and under the "high" tier (TF32),
   set in-process by ``config.apply_environment_tiers``, and exact fp32
   restored after. The script refuses to start where ``GPFLOW_TPU_PALLAS``
   is set;
25. the shape contracts of slices 1-6 (``set_enable_check_shapes``), each
   path run four times from the same state, checks off, on, on, off, and
   every run equal to the bit with the launch counts the path implies: (a)
   the flagship SVGP's training step (phase 7's model and data,
   SquaredExponential, then Matern52), 10 steps a run under sync debug mode
   "error", the losses and trained parameters, and ms per step both ways by
   CUDA events; (b) the GPR at N = 8192, value and gradient with rbf and
   with Matern12 (K2 at coincident points); (c) the Bernoulli SVGP's fused
   natural-gradient step (Matern52, M = 1024, B = 4096), 10 steps a run;
   (d) SGPR (rbf) and the matrix-free CGLB (Matern52, chunk 4096, a fixed
   v) at N = 32768, M = 1024, value and gradient; (e) with the checks on, a
   request of D = 7 to the flagship's cached and fused ``predict_f`` and a
   q_sqrt of rank 4 to ``gauss_kl`` and the unwhitened ``prior_kl`` raise
   ``ShapeError`` and launch no kernel; (f) the flagship exported with the
   checks on and a symbolic batch serves 8192, 5000 and 1 points against
   the live posterior, K1 inside the loaded program;
26. the one-rank mesh (``gpflow_tpu_torch.parallel`` over an NCCL group of
   world size 1 on a ``FileStore``): each path run with a one-rank mesh and
   without one from the same state, equal to the bit with the same launch
   counts: (a) the flagship SVGP step (phase 7's model and data,
   SquaredExponential, then Matern52), 10 steps each way under sync debug
   mode "error" through ``DataParallelTrainer(mesh=make_mesh())``, ms per
   step both ways by CUDA events; (b) the Bernoulli SVGP's fused
   natural-gradient step (Matern52, M = 1024, B = 4096), likewise; (c)
   ``shard_internal_data`` on SGPR and the matrix-free CGLB (chunk 4096, a
   fixed v) at N = 32768, M = 1024, value and gradient; (d)
   ``sharded_predict_f`` of 8192 points of the flagship against its
   ``predict_f``; (e) phase 19's multioutput SVGP (LinearCoregionalization
   of 4 latent GPs) with ``latent_axis`` on a {"data": 1, "latent": 1}
   mesh, 10 steps each way; (f) a numpy request to the flagship's
   ``predict_f`` against the same points as a tensor (outside sync debug
   mode "error": the copy of a numpy input to the card may synchronise);
   (b) and (e), host-bound, run once each way for the bits, then 12 steps
   each way timed with the two trainers' steps in turn (the host's speed
   drifts); (e) then under ``torch.profiler``: device busy time, kernels
   and collectives a step both ways, the kernels that the mesh adds and
   the host time of the operations that only the mesh runs.
   One rank checks no collective across cards: the 4-rank collectives are
   held to the JAX package on the CPU (``tests/test_torch_parallel.py``).
27. numpy at the functional API (slice 17): at the flagship's width
   (M = 2048, B = 8192, D = 8, float32, SquaredExponential) ``conditional``
   with numpy Xnew, q_mu and q_sqrt, ``Kuu`` of inducing points built from
   numpy, ``Kuf`` of numpy Xnew, ``gauss_kl`` of numpy q_mu and q_sqrt and
   a Parameter in arithmetic with numpy on either side, each equal to the
   bit to its tensor route, on the card, with the same K1 launches; the
   tensor routes under sync debug mode "error", the numpy routes' syncs
   counted (no more than their uploads: a numpy array is copied from
   pageable host memory, which synchronises). In a process of its own,
   started beside the build of phase 2, a subset of the JAX package's
   jax-free tests runs on the port through the alias of
   ``tests/test_torch_reference_plugin.py`` with the card as the default
   device, in float64: every test passes or fails as its row of that
   file's table of differences says.
28. the JAX package's tests that import jax or optax, translated onto the
   port (``tests/test_torch_translated_<stem>.py``, the files of
   ``tests/test_torch_translated_map.json``), with the card as the default
   device, in processes of their own started after the build: every test
   passes, or fails as the strict xfail of its deviation row expects (a
   test that skips itself may skip); each process's default device was
   "cuda"; their K1 and K2 launches are logged, and K1's must be above 0
   (``test_gplvm_f32.py``'s float32 BayesianGPLVM reaches K1). The other
   files run in float64, which no kernel serves; ``test_error_envelopes.py``
   holds that rule on CUDA tensors. The sizes are the JAX tests' own: the
   phase holds the JAX package's claims on the card and measures no speed.
29. the compile layer, traced against eager from one state, equal to the
   bit with the same launches: the flagship and the fused natural-gradient
   trainer steps with Adam's update inside the trace, the GPR fit by
   ``Scipy`` and its L-BFGS evaluations, ``training_loop``, short SGPMC and
   GPMC chains of ``run_hmc``, and the matrix-free CGLB's value and gradient
   with its CG (a traced ``while_loop`` with a ``cond`` restart) from a
   fixed v; the ms of both sides.

Every failure raises, and the script then exits non-zero without the result
line. The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
import atexit
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# Where Python runs with PYTHONDONTWRITEBYTECODE and torch ships no bytecode
# for its tracing code, every process compiles it anew (on the H100's host
# ~8 s to import torch, ~11 s more at the first trace, more with phase 28's
# processes beside it). This process writes its bytecode under the build
# directory, before it starts the others, which read it there (run as a
# script from a checkout only: an import leaves the importer as it is).
_HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__" and os.path.isdir(os.path.join(_HERE, "gpflow_tpu_torch")):
    sys.pycache_prefix = os.path.join(_HERE, "gpflow_tpu_torch", "_build", "pycache")
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
N_DATA, M, D, B = 1_000_000, 2048, 8, 8192  # bench.py:51
N_REQUESTS = 5
NOISE = 0.1

# K1 against its plain version evaluated in float64 on the same inputs. K1
# forms d2 as a sum of squared differences (relative error <= (D + 1) * 2^-24)
# and evaluates the tail in float32 (a few ulp): every entry lies within
# 1e-5 * var of the float64 value.
K1_ATOL_F64 = 1e-5
# K1 against the plain version in float32. The plain version's norm expansion
# loses about 2^-24 * (|x|^2 + |z|^2) of d2, which the r-based families turn
# into an error of that over 2r near r = 0: allow 1e-3 * var.
K1_ATOL_F32 = 1e-3
# The paths' shapes (Kuu, Kuf, the GPR's Gram matrix at N = 16384, whose
# [N, M] offsets pass 2^28 and are taken in int64; the natural-gradient
# path's Kuu and Kuf; the sparse path's matrix-free block, its Kuf and a
# CGLB request's K(Xnew, X); the VGP path's K(X) and K(X, Xnew) at
# N = 4096), all on the TMA path, and shapes that reach the
# other branches of the launch plan (pallas_distance._launch_plan): M % 4 of
# 1, 2 and 3 with a ragged N (the edge path), a ragged N and M with M % 4 ==
# 0 (the TMA path clipping both edges), fewer tiles than SMs, D = 16 (two
# chunks of dimensions, four-element loads) and D of 1, 3 and 37 (one
# element per load).
K1_SHAPES = [(2048, 2048, 8), (2048, 8192, 8), (16384, 16384, 8), (1024, 1024, 8), (1024, 4096, 8),
             (32768, 4096, 8), (1024, 32768, 8), (8192, 32768, 8), (1000, 777, 3), (517, 1030, 8),
             (1999, 2051, 8), (1000, 1004, 8), (64, 128, 8), (300, 260, 16), (1, 1, 1), (300, 129, 37),
             (4096, 4096, 8)]

# The float32 slice on the card against the same model in float64 on the CPU,
# both with the float32 jitter 1e-4, as a fraction of the largest float64
# entry of each output. The fused routes solve with an f32 Cholesky of the
# jittered M = 2048 Gram matrix (error ~ cond(Kuu) * eps32); the cached route
# multiplies by an explicit inverse of it (~ cond(Kuu)^2 * eps32). Inducing
# points drawn from uniform data on [0, 4]^8 lie about one lengthscale apart,
# so cond(Kuu) stays near 1e2 (37 at M = 1024).
SLICE_RTOL = {"fused": 1e-4, "cached": 1e-3}

# K2 against its plain version evaluated in float64 on the same inputs, as a
# fraction of the largest |W|. K2 forms d2 as K1 does (relative error
# <= (D + 1) * 2^-24) and h' in float32 (a few ulp), so each entry lies within
# about 1e-6 of its own value. bfloat16 inputs reach both sides rounded alike.
K2_RTOL_F64 = 1e-5
# K2 against the plain version in float32: both form d2 by direct
# differences, K2 with fused multiply-adds and the plain version rounding
# each square, and h' of the r-based families divides d2's rounding by about
# 2 d2 near r = 0; as K1's float32 tolerance.
K2_RTOL_F32 = 1e-3
K2_SHAPES = [s for s in K1_SHAPES if s != (8192, 32768, 8)]  # a CGLB request has no backward
# K2 also takes g as a contiguous view 4 bytes into its storage at this
# shape, which the TMA path cannot load: the edge path at a path's shape.
K2_OFFSET_G_SHAPE = (2048, 2048, 8)

# Gradients of stationary_kernel_matrix in float32 on the card against plain
# autograd in float64, as a fraction of the largest float64 entry: dXs and
# dZs contract [N, M] weights in float32 matmuls over up to 8192 terms, and
# dvar and dlengthscales sum over all N * M entries.
GRAD_RTOL = 1e-4

TRAIN_KERNELS = ("SquaredExponential", "Matern52")
TRAIN_ROUTES = (("solve", False), ("inv_solve", True))
TRAIN_CALLS, TRAIN_STEPS_PER_CALL = 3, 10
TIMED_STEPS = 20
# The float32 steps on the card against float64 on the CPU, from the same
# values on the same batches. The loss is a sum over the batch scaled by
# N / B plus the KL, both in float32: 1e-5 of it. Adam moves each element by
# about lr = 1e-2 per step whatever its gradient's size, so an element whose
# gradient float32 cannot resolve may step either way: the hyperparameters
# (large, well-resolved gradients) must agree within 1e-4, and in q_mu,
# q_sqrt and Z at most 1% of the elements may differ by more than 1e-3.
F64_STEPS = 3
F64_LOSS_RTOL = 1e-5
F64_HYPER_ATOL = 1e-4
F64_ELEMENT_ATOL, F64_ELEMENT_SHARE = 1e-3, 1e-2

# The GPR slice (bench.py:283-360): N training points, D = 8, X uniform on
# the unit cube, Y = sin(3 X[:, :1]) + 0.1 eps, SquaredExponential with
# lengthscales 1, noise 0.1, float32, B = 8192 new points per request.
GPR_NS = (8192, 16384)
GPR_NOISE = 0.1
GPR_MAXITER = 15  # 30 until phase 20 came
GPR_PENALTY = 1e15  # Scipy's nonfinite_penalty: a float32 trial point whose Cholesky fails is rejected
# float32 against float64 on the card, for the value, each parameter's
# gradient (relative to its largest float64 entry) and each prediction
# (relative to the largest float64 mean, and to the prior variance for the
# variance, of which the predictive variance is a difference): the solves
# with the float32 Cholesky of K + noise I, and INV_SOLVE's explicit inverse,
# carry about cond(K + noise I) * eps32. With lengthscales 1 every point of
# the unit cube is near every other, so lambda_max(K) ~ N E[k] ~ N / 2 and
# cond ~ 5 N / noise: ~1e5. The script measures cond (an upper bound:
# lambda_min >= noise) and holds each error to cond * eps32.
EPS32 = float(np.finfo(np.float32).eps)

# The non-conjugate path (bench.py:222-279): data as bench.py makes it
# (RandomState(2), D = 8, N = 8 * 4096, X uniform on [0, 4]^8,
# Y = (sin(X w) + 0.3 eps > 0)), M = 1024 inducing points drawn from X,
# SquaredExponential with lengthscales 1, Bernoulli (probit, 20 Gauss-Hermite
# points), whitened full q_sqrt, float32; natural gradients (gamma 0.1) on
# q(u) and Adam 1e-2 on the kernel and Z, batches of B = 4096; requests of
# 4096 new points drawn after the data from the same generator.
NG_M, NG_B, NG_N = 1024, 4096, 8 * 4096
NG_GAMMA = 0.1
NG_FUSED_STEPS = 250  # as many as bench.py scans in one call
NG_SEQ_STEPS, NG_MATERN_STEPS, NG_MINIMIZE_ITERS, NG_F64_STEPS = 50, 20, 5, 3
NG_TIMED_STEPS = {"fused": 100, "sequential": 50}
# float32 against float64 on the card (the objective, three steps, the
# requests), each as a fraction of its largest float64 entry. Whitened, the
# conditional solves with the float32 Cholesky of Kuu + 1e-4 I, and a
# natural-gradient step inverts q_sqrt's factor twice and takes three more
# float32 Choleskys: each carries about cond * eps32, cond the larger of
# cond(Kuu + 1e-4 I) and cond(S), S = q_sqrt q_sqrt^T, both measured in the
# run from their eigenvalues in float64. Those errors then pass through
# float32 sums and contractions over B = 4096 points, whose rounding grows as
# sqrt(B) eps32 for independent roundings: the tolerance is
# NG_MULT * cond * eps32 with NG_MULT = sqrt(B) = 64. Each float32 natural-
# gradient step also adds ``sym_jitter``'s 1e-5 times the mean |diagonal| to
# three matrices (ops/linalg.py, as the JAX package does; float64 adds none),
# moving the new q(u) by up to 1e-5 * cond(S) of its largest entry: after
# k steps the training checks add 3 * k * NG_JITTER * cond(S).
NG_MULT = 64.0
NG_JITTER = 1e-5

# The sparse-regression path (bench.py:363-417): data as bench.py makes it
# (RandomState(1), N = 32768, D = 8, X uniform on the unit cube,
# Y = sin(3 X[:, :1]) + 0.1 eps, float32), Z = the first M = 1024 rows of
# X[rng.permutation(N)], SquaredExponential with lengthscales 1, noise 0.1;
# SGPR and GPRFITC, and CGLB in its matrix-free mode with chunk 4096 and its
# defaults (cg_tolerance 1, at most 100 CG iterations, a restart every 40);
# requests of B = 8192 new points drawn after Z from the same generator.
SP_N, SP_M, SP_CHUNK = 32768, 1024, 4096
SP_NOISE = 0.1
SP_SGPR_MAXITER, SP_CGLB_MAXITER = 20, 5  # bench.py:405-417 runs CGLB's 5
SP_PENALTY = 1e15
SP_PREDICT_CG_TOL = 1e-3  # CGLB.predict_f's default
SP_OBJ_CALLS = 3  # bench.py:396-403
SP_ADVERSARIAL = (0.0, 1.0, 1e4, -1e4)  # tests/gpflow_tpu/models/test_cglb.py:95-126
SP_EXTRA_SEEDS = (2, 3)  # data for the float32-against-float64 checks besides bench.py's RandomState(1)
# Dense against matrix-free CGLB at (N, M, chunk) of the first row of
# PERFORMANCE.md:308, at one fixed v, on data made as above from each of
# SP_SMALL_SEEDS. The two modes form the same float32 products and sum them
# in another order: each entry of v K is a sum over N terms, and the
# kernel's gradients sum again over N, each within N * eps32 of the sum of
# its absolute terms (Higham's gamma_N). The terms share their sign (K > 0),
# so the value and the kernel's and noise's gradients are held to N * eps32
# of the largest entry. The gradient in Z carries such differences (in the
# residual r = y - (K + s2 I) v, which cancels far below K v) through
# Kuu^-1, cond(Kuu + jitter I) ~ 2e6 here: no rounding bound of use holds
# it, so its limit is set from readings, a small factor above the largest
# difference of the seeds (the readings are in PERF.md).
SP_SMALL = (8192, 512, 2048)
SP_SMALL_SEEDS = (SEED + 30, SEED + 31, SEED + 32)
SP_DENSE_MF_Z_RTOL = 1e-2
# float32 against float64 on the card, from the same values, both with the
# float32 jitter 1e-4, relative to the largest float64 entry (to the prior
# variance for a predictive variance). A bound from conditioning is of no
# use here: cond(B) * eps32 ~ 2e-2 and cond(Kuu + jitter I) * eps32 ~ 0.6
# (the points lie close), orders above what float32 gives. So each limit is
# set from readings (in PERF.md), a factor of 2.5 to 8 above the largest
# error of the sound float32 runs on three data sets (bench.py's and
# SP_EXTRA_SEEDS') and, but for the gradient in Z, below the error of a
# lower-tier control: the same float32 model with K1 fed bfloat16-rounded
# inputs (X, Z and the new points, 2^-9 relative) and its matmuls in TF32.
# Bf16 inputs alone move the objectives no more than float32's own
# rounding does on these smooth data (they do move the predictions); TF32
# moves them by 1e-2 and more. Each check runs the control and fails unless
# it breaks at least one of the check's limits: the check tells float32
# from a lower tier.
SP_RTOL = {
    "value": 3e-4,
    "gradient": 3e-3,
    "gradient Z": 0.2,
    "mean": 2e-3,
    "var": 5e-5,
    "log density": 6e-3,
}

# The VGP path (slice 7; bench.py has no VGP operating point, PERF.md §4):
# VGP and VGPOpperArchambeau at N = 4096 training points, D = 8, float32,
# whitened full q_sqrt [1, N, N]. The classifier is the natural-gradient
# operating point's data (bench.py:232-236: X on [0, 4]^8, Bernoulli
# labels), its first N rows and the next N as requests, with
# SquaredExponential(lengthscales 1) + Linear() and a Constant mean; the
# regression set is the GPR generator's formula (bench.py:294-299) at
# n = N with a Gaussian likelihood of variance 0.1.
VGP_N = 4096
VGP_NOISE = 0.1
VGP_MAXITER = 8  # 20 until phase 20 came: each evaluation takes ~1.5 s
VGP_TIMED_ROUNDS = 3
# One natural-gradient step of gamma = 1 takes the VGP to the GPR: in
# float64, with the JAX package's test jitter, the ELBO within 1e-7 of the
# GPR's log marginal likelihood and the requests within 1e-6 (that test's
# tolerances, tests/integration/test_method_equivalence.py:107-118).
VGP_IDENTITY_JITTER = 1e-10
VGP_IDENTITY_RTOL, VGP_IDENTITY_ATOL = 1e-7, 1e-6
# float32 against float64 on the card, from the same values, both with the
# float32 jitter 1e-4, relative to the largest float64 entry (the value to
# itself). cond(K + 1e-4 I) is 3.7e6 for the classifier and 2.2e7 for the
# regression data (printed), so cond * eps32 bounds nothing of use: each
# limit is set from readings on three sets of values or data (PERF.md §6,
# VGP table), 2-10 times the largest error of the sound float32 runs; each check's
# lower-tier control (K1 fed bfloat16-rounded inputs, TF32 matmuls) must
# break at least one of its limits. A gradient's limit is "gradient" for the
# kernel and the mean function, "gradient q" for the variational
# parameters, or the parameter's own where one is given:
# VGPOpperArchambeau's lambda carries 1.7e-3 of float32 error (its
# f_var = 1 / lambda^2 - sum(tmp^2) cancels), above what the control adds
# to alpha.
VGP_EXTRA_SEEDS = (2, 3)  # regression data as RandomState(seed), and variational values from these seeds
VGP_RTOL = {
    "identity": {"value": 6e-4, "mean": 5e-3, "var": 2e-3},
    "classifier": {"value": 5e-5, "gradient": 8e-3, "gradient q": 6e-4},
    "requests": {"mean": 3e-3, "var": 3e-3, "log density": 3e-3},
    "Matern52": {"value": 1e-6, "gradient": 2e-4, "gradient q": 1e-5},
    "VGPOpperArchambeau": {"value": 1e-4, "gradient": 2e-3, "gradient q": 2e-4, "gradient .q_lambda": 4e-3},
    "VGPOpperArchambeau request": {"mean": 2e-5, "var": 3e-3},
}
# SVGP_deprecated and SVGP run the same float32 operations in the same order
# (conditionals.conditional builds the posterior the fused route builds):
# they agree within a few roundings.
SVGP_ROUNDOFF = 1e-6

# The multiclass path (slice 8; bench.py has no multiclass point, PERF.md
# §4): the JAX harness's svgp_multiclass and svgp_softmax
# (benchmark/models.py:80-108), an SVGP whose C latent GPs share one
# SquaredExponential with ARD lengthscales, with MultiClass (RobustMax, 20
# Gauss-Hermite points) or Softmax (100 Monte-Carlo draws), at digits' width
# and class count (D = 64, C = 10; benchmark/datasets.py:306-323) and
# bench.py's non-conjugate operating point (M = 1024, B = 4096, N = 32768;
# bench.py:222-279), float32, whitened full q_sqrt [C, M, M]. The data are
# synthetic, from a seed (digits comes from sklearn): X ~ N(0, 1) in 64
# dimensions, N training points and MC_B held-out ones, labels
# argmax_c (X W)[:, c] + 0.5 noise for a seeded W [64, 10], Z the first M
# rows of a seeded permutation of X (benchmark/models.py:23-25). The
# lengthscales are sqrt(D) = 8, not the harness's 1, which suit digits
# scaled to [0, 1]: N(0, 1) points in 64 dimensions lie ~11 unit
# lengthscales apart, where Kuu is the identity to float32's resolution; at
# 8 an average pair has k = exp(-1).
MC_N, MC_M, MC_B, MC_D, MC_C = 32768, 1024, 4096, 64, 10
MC_STEPS = 20  # Adam steps for each likelihood, and fused natural-gradient steps for MultiClass
# RobustMax's expected log likelihood grows with the latent GPs' variances
# (it is not log-concave), so a natural-gradient step from q(u) = p(u) can
# leave the negative-definite cone: with NG_GAMMA = 0.1 the step's size grows
# with N, and the Bernoulli point's gamma is rejected here in both packages
# (the phase logs one such step). The multiclass steps take a gamma small
# against the N / B-scaled gradient.
MC_NG_GAMMA = 5e-4
MC_LBFGS_ITERS = 5  # benchmark/run.py:73-101 runs Scipy().minimize on training_loss_closure
MC_TIMED_ROUNDS = 3
MC_VALUE_SEEDS = (SEED + 18, SEED + 19, SEED + 20)  # variational values for the float64 checks
# The MultiClass and Softmax ELBO and gradient in float32 on the card
# against float64 on the card, from the same values (off their start) on
# the same batch, both with the float32 jitter 1e-4; Softmax with the same
# draws. Relative to the largest float64 entry, the value to itself. Each
# limit is set from readings on the three sets of values (PERF.md §6, multiclass table),
# 5-8 times the largest error of the sound float32 runs, and each check runs
# the lower-tier control (K1 fed bfloat16-rounded X and Z, TF32 matmuls),
# which must break at least one of its limits. MultiClass's slope in the
# kernel variance is a cancellation, 1e-2 to 3e-1 beside gradients of 1e2
# to 1e3 in the other parameters, and float32 leaves ~5e-3 of it: its limit
# is relative to that small slope. The requests (phase 18d) come from the
# trained models, the two likelihoods on both routes, against float64
# beside the same control.
MC_RTOL = {"value": 1e-6, "gradient": 5e-5, "gradient q": 5e-5, "gradient .kernel.variance": 0.6,
           "requests": {"mean": 1e-4, "var": 1e-3, "log density": 3e-5}}
# A Softmax class probability is a mean over 100 draws of a softmax row,
# which sums to 1 within C * eps32 in float32: the sums within 8 * C * eps32.
MC_PROB_SUM_ATOL = 8 * MC_C * float(np.finfo(np.float32).eps)
# K1 at the path's shapes at D = 64 (Kuu, Kuf of a batch or a request, Kuf
# of the whole data in an L-BFGS evaluation) and at wine's width, D = 13,
# where D % 4 != 0 takes the scalar staging.
MC_K1_SHAPES = [(MC_M, MC_M, MC_D), (MC_M, MC_B, MC_D), (MC_M, MC_N, MC_D), (MC_M, MC_B, 13)]

# The multioutput path (slice 9; bench.py has no multioutput point, PERF.md
# §4): SARCOS robot-arm inverse dynamics (Rasmussen and Williams, GPML,
# 2006, §2.5; 44484 training and 4449 test points, 21 inputs, 7 joint
# torques), the standard public multi-output regression set, at bench.py's
# non-conjugate operating point (M = 1024, B = 4096, float32, whitened full
# q_sqrt; bench.py:222-279). SARCOS is not in the repository and nothing is
# downloaded, so the data are synthetic at its shapes, from a seed: X ~
# N(0, 1) in 21 dimensions, Y = sin(X A) B^T + 0.1 noise for seeded A
# [21, 4] (entries N(0, 1 / 21), so that X A ~ N(0, 1)) and B [7, 4]; the Z
# of each latent GP the first M rows of its own seeded permutation of X;
# ARD lengthscales sqrt(21) times a factor per latent GP, as phase 18 took
# sqrt(64) for N(0, 1) data. The main model is a LinearCoregionalization of
# L = 4 latent GPs (two SquaredExponential, two Matern52) mixed by a seeded
# W [7, 4] into P = 7 outputs, on SeparateIndependentInducingVariables, with
# a Gaussian likelihood.
MO_N, MO_NEW, MO_D, MO_P, MO_L = 44484, 4449, 21, 7, 4
MO_M, MO_B = 1024, 4096
MO_LATENTS = (("SquaredExponential", 1.0), ("SquaredExponential", 0.75), ("Matern52", 1.0), ("Matern52", 0.75))
MO_NOISE = 0.1
# The fully correlated route (InducingPoints with SharedIndependent over the
# 7 outputs) works on Kuu [M, 7, M, 7] as one [7M, 7M] matrix: its cost grows
# as (MP)^3, and the JAX package offers it as the generic route, not the one
# users scale. It runs at M = 256 and B = 1024: a [1792, 1792] Kuu.
MO_FC_M, MO_FC_B = 256, 1024
MO_STEPS = 20  # Adam steps for the main model and the shared one, and fused natural-gradient steps
MO_NG_GAMMA = 0.1  # the Bernoulli point's gamma: a Gaussian likelihood is log-concave
MO_TIMED_ROUNDS = 3
MO_VALUE_SEEDS = (SEED + 40, SEED + 41, SEED + 42)  # variational values for the float64 checks
# Each route's ELBO and gradient in float32 on the card against float64 on
# the card, from the same values (off their start) on the same batch, both
# with the float32 jitter 1e-4. Relative to the largest float64 entry, the
# value to itself. The limits are set from readings on the three sets of
# values of every route (PERF.md §6, multioutput), 2-5 times the largest error of
# the sound float32 runs: value 4.5e-7 (Coregion's; the other routes'
# 2.5e-7), gradients 1.3e-4 (the fallback
# route's lengthscales and Z, cond(Kuu + 1e-4 I) 9.3e4), q 4.2e-5 (the
# unwhitened fully correlated route); requests from the trained model: mean
# 8.5e-5, variance 1.9e-4 (the cached route's explicit inverse), the full
# output covariance 2.1e-6, log density 6.6e-5. The main model on INV_SOLVE
# reads value 6.6e-7, gradients 9.0e-5, q 3.6e-5. Each check of routes (a),
# (b), (c) and (g), and the requests on both routes, run the lower-tier
# control (K1 fed bfloat16-rounded X and Z, TF32 matmuls), which must break
# at least one limit; the least, over the checks, of its largest error in
# each class: value 2.5e-5, gradients 2.9e-3, q 1.2e-3, mean 6.1e-3,
# variance 3.6e-2, covariance 3.8e-3, log density 3.2e-3.
MO_RTOL = {"value": 1e-6, "gradient": 6e-4, "gradient q": 2e-4,
           "requests": {"mean": 4e-4, "var": 1e-3, "cov": 1e-5, "log density": 3e-4}}
# The fallback route computes the main model's ELBO and gradient through the
# interdomain Kuf [M, L, B, P]: in float32 it must equal the main route's
# within these limits (two float32 runs, each within MO_RTOL of float64).
MO_SAME_RTOL = {key: 2 * MO_RTOL[key] for key in ("value", "gradient", "gradient q")}
# A request's full output covariance [N, 7, 7] must hold the marginal
# variance on its diagonal: the two mix the same latent variances with W in
# another order, so they agree to a few float32 roundings of the largest
# variance.
MO_DIAG_RTOL = 16 * float(np.finfo(np.float32).eps)
# K1 at the path's shapes at D = 21 (Kuu, Kuf of a batch, Kuf of a request,
# and the fully correlated route's Kuu and Kuf at M = 256, B = 1024) and K2
# at Kuu and Kuf of a batch; D % 4 != 0 takes the scalar staging, a
# request's 4449 columns the edge path, and K2 at the request shape (off the
# path: requests take no gradient) shows K2's edge path at D = 21.
MO_K1_SHAPES = [(MO_M, MO_M, MO_D), (MO_M, MO_B, MO_D), (MO_M, MO_NEW, MO_D),
                (MO_FC_M, MO_FC_M, MO_D), (MO_FC_M, MO_FC_B, MO_D)]
MO_K2_SHAPES = [(MO_M, MO_M, MO_D), (MO_M, MO_B, MO_D), (MO_M, MO_NEW, MO_D)]

# The MCMC path (slice 10; bench.py has no MCMC point): priors and HMC over
# a GP classifier at the natural-gradient operating point's widths
# (bench.py:233-249: D = 8, N = 32768, M = 1024, Bernoulli labels from
# RandomState(2), float32), with the kernel of the JAX package's MCMC
# example (doc/examples/mcmc.py), Matern32 with ARD lengthscales. Priors:
# LogNormal(0, 1) on the variance and on each of the 8 lengthscales, centred
# on bench.py's initial values (1 and 1); V ~ Normal(0, 1), the models' own.
# SGPMC at M = 1024 over all N rows, its inducing points bench.py's Z, frozen
# by set_trainable as the JAX package's oracle does
# (tests/gpflow_tpu/models/test_hmc_conjugate_oracle.py:45-49); GPMC on the
# first HMC_GPMC_N rows, the top of the non-LARGE range in which the JAX
# harness fits VGP (phase 17 too): each leapfrog step factors an [N, N] K.
# Both are sampled by run_hmc: HMC_BURNIN steps adapting the step size by
# dual averaging toward HMC_TARGET, then HMC_SAMPLES kept samples, each step
# HMC_LEAPFROG leapfrog steps; requests are the natural-gradient point's
# NG_B held-out points. 20 kept samples: 100 until phase 24 came (on a host
# whose HMC step took 148 ms, NVIDIA H100 80GB HBM3, 700 W, 100-116 ms on
# others, the whole run took 472.6 s), 60 until phase 26 came (the whole
# run then took 436.2 s). The checks read the first kept sample, which the
# cuts leave as it was; the posterior predictive averages the kept ones.
HMC_GPMC_N = 4096
HMC_BURNIN, HMC_SAMPLES, HMC_LEAPFROG = 100, 20, 10
HMC_STEP, HMC_TARGET = 0.01, 0.75
HMC_PRIOR = (0.0, 1.0)  # LogNormal(loc, scale) of the variance and the lengthscales
HMC_SEEDS = {"chain": SEED + 50, "state": SEED + 51, "momentum": SEED + 52, "conditional": SEED + 53,
             "samples": SEED + 54}
# target_log_prob_fn and its gradient in float32 on the card against float64
# on the card at the same state (each float32 state cast to float64): the
# value relative to itself, each part of the gradient to its largest float64
# entry. The limits are set from readings at the three states of both
# models (PERF.md §6, the MCMC slice), about 4-5 times the largest error of the sound
# float32 runs: value 2.0e-7 (SGPMC after burn-in), gradients 1.4e-4
# (SGPMC's lengthscales after burn-in; GPMC's 1.0e-4). Each check runs the
# lower-tier control (K1 fed bfloat16-rounded X and Z, TF32 matmuls), which
# must break a limit; its least largest gradient error over the checks is
# 4.4e-3 (SGPMC perturbed), its value error 2.1e-8 to 2.7e-4 (at GPMC's
# initial state V = 0, so F = 0 and K leaves the likelihood: only the
# gradient in V tells the tiers apart, 6.2e-3).
HMC_RTOL = {"value": 1e-6, "gradient": 5e-4}
# Sampler checks in float64 on the card, on SGPMC from the state after
# burn-in: HMC_LEAPFROG steps of HMC_DH_STEP forward and then back with the
# momentum negated must return to the start (relative to its largest entry);
# |dH| at (h, L), (h / 2, 2 L) and (h / 4, 4 L), the same trajectory length,
# must fall by 4 per halving (leapfrog's energy error is O(h^2)). At
# h = 0.02 the first readings were not in that regime (|dH| 5.5 for one
# momentum, ratios 1.2-95); at 0.004 they read 3.995-4.289, and the round
# trip 1.3e-15 (position) and 1.3e-13 (momentum). A chain that ends
# elsewhere moves the state: after the float32 backward's contraction went
# to float64 accumulation (ROADMAP F2) the chain ended at a state where the
# first ratio at 0.004 read 4.575 and the next 4.142 (the O(h^4) term:
# 4 (1 + 0.14) falling to 4 (1 + 0.036)), so the check starts at 0.002.
HMC_DH_STEP = 0.002
HMC_REVERSE_RTOL = 1e-10
HMC_DH_RATIO = (3.5, 4.5)
HMC_DH_MOMENTA = 3
# The JAX package's conjugate oracles (test_hmc_conjugate_oracle.py), in
# float64 on the card: with a Gaussian likelihood and fixed hyperparameters,
# GPMC's f = L v is the exact GPR posterior at the 40 training inputs and
# SGPMC's u = L_z v SGPR's optimal q(u) at M = 8. The chains keep
# HMC_ORACLE_SAMPLES after HMC_ORACLE_BURNIN adapted steps of 12 leapfrog
# steps each (the oracle keeps 2000 after 500; each value and gradient at
# these sizes is 2.6-3.3 ms of host time, so 1000 after 300 took 40-51 s a
# chain in the first readings, least ESS 552-645; 300 after 100 gave ESS
# 89-98 and a variance ratio of 1.49 for SGPMC, its step still adapting):
# each sample mean must lie
# within 5 Monte-Carlo standard errors (+1e-3) of the analytic mean, the
# effective sample size estimated from the lag-1 autocorrelation, and the
# mean ratio of sample to analytic variance within 25%, as in the oracle.
# 200 kept after 300, 500 after 300 until phase 24 came (least ESS 267-326
# at 500), 300 after 300 until phase 27 came (least ESS 167-200, the chains
# 12.0 and 21.8 s, NVIDIA H100 80GB HBM3, 700 W); the mean's limit scales
# with the ESS, and the ratio averages every dimension. 200 after 200 failed
# GPMC's mean (1.29 of its limit, least ESS 102): the step still adapts.
HMC_ORACLE_SAMPLES, HMC_ORACLE_BURNIN = 200, 300
# sample_conditional on phase 19's LinearCoregionalization (L = 4, P = 7,
# M = 1024) at the 4449 request points, full_cov=False: HMC_COND_SAMPLES
# draws, whose mean must lie within HMC_COND_Z standard errors of the
# conditional's mean at every point and output (the largest of 31143
# standard normals is ~4.5), and whose variance within HMC_COND_Z standard
# errors, sqrt(2 / (S - 1)), of its variance.
HMC_COND_SAMPLES, HMC_COND_Z = 1000, 6.0
HMC_K1_SHAPES = [(NG_M, NG_M, D), (NG_M, NG_N, D), (HMC_GPMC_N, HMC_GPMC_N, D), (NG_M, NG_B, D)]
HMC_K2_SHAPES = HMC_K1_SHAPES[:3]

# The latent-variable slice (phase 21; bench.py has no GPLVM operating
# point): oil flow's width (P = 12 measurements, N = 1000 points; Bishop and
# James 1993, the data set of GPflow's GPLVM notebook) with Q = 10 latent
# dimensions. The data set is not in the repository, so the data are a
# smooth manifold made from a seed as tests/gpflow_tpu/models/test_gplvm_f32.py
# makes one: t ~ N(0, 1) [N, Q], Y = tanh(t W / sqrt(Q)) + 0.05 noise, with
# one W [Q, P] for every size. (a) BayesianGPLVM at N = 1000, M = 50 from
# PCA, X_data_var 0.1, SquaredExponential with Q lengthscales 1, noise 0.1,
# trained in float64 (in float32 its bound climbs its own rounding error,
# README.md); (b) the wide point, N = 8192, M = 256: one float32 [N, M, M]
# psi2 is 2.1 GB, and the float64 reference sums psi2 over chunks of
# GL_WIDE_CHUNK rows; (c) GPLVM at N = 8192; (d) uncertain_conditional at
# GL_UC_N inputs with full covariances against a whitened q(u) of M = 256
# and P outputs, and a Monte-Carlo estimate of GL_UC_DRAWS draws at
# GL_UC_MC_N of them; the analytic psi statistics against the quadrature
# fallback at Q = 2 and 20 points a dimension (Kuf at N * 400 points).
GL_P, GL_Q = 12, 10
GL_N, GL_M, GL_NOISE, GL_XVAR = 1000, 50, 0.1, 0.1
GL_MAXITER, GL_EARLY = 50, 5
GL_JITTER = 1e-4  # the float32 jitter, which the float64 references take too
GL_WIDE_N, GL_WIDE_M, GL_WIDE_CHUNK = 8192, 256, 1024
GL_GPLVM_N = 8192
GL_UC_N, GL_UC_M, GL_UC_MC_N, GL_UC_DRAWS, GL_UC_Z = 1024, 256, 16, 10_000, 5.0
GL_QUAD_Q, GL_QUAD_NGHP = 2, 20
GL_SEEDS = {"W": SEED + 60, "data": SEED + 61, "Z": SEED + 62, "perturb": SEED + 63, "uc": SEED + 64,
            "mc": SEED + 65, "kernels": SEED + 66}
# float32 against float64 on the card, each output relative to the largest
# float64 entry (the bound and the GPLVM's objective relative to themselves),
# each check beside the lower-tier control (X_data_mean, Z and the inputs
# rounded to bfloat16, TF32 matmuls), which must break one of the limits.
# The limits are set from readings (PERF.md §6, the latent-variable slice), 3-7 times the largest
# sound error: the Bayesian GPLVM's bound 3.1e-5 (the wide point; its
# control 9.9e-5), its gradients 1.3e-3 (the wide point's Z; the control's
# largest error in each check 1.2e-2 or more), its predict_f mean 4.2e-4
# and variance 1.1e-5 (the control 3.0e-2 and 6.0e-3); the psi statistics
# 1.4e-6 analytic and 2.7e-7 by quadrature (the control 6.5e-3); the GPLVM's
# objective 4.0e-5 (the control's as small: float32 rounds the objective as
# bfloat16 inputs do) and gradients 7.0e-5 (the control's in X 2.3e-2);
# uncertain_conditional's mean 4.2e-6 and variance 5.8e-5 (the control 2.7e-3
# and 1.8e-2).
GL_RTOL = {"value": 1e-4, "gradient": 5e-3, "mean": 2e-3, "variance": 2e-4, "psi": 1e-5, "quadrature": 1e-5,
           "gplvm value": 2e-4, "gplvm gradient": 5e-4, "uc mean": 2e-5, "uc variance": 3e-4}
# The float32 bound and predict_f call torch.linalg.eigh once (the psi2
# projection, models/gplvm.py), which reads its error flag on the host: one
# sync each (the first call in a process synchronises once more).
GL_F32_SYNCS = 1
GL_K1_SHAPES = [(GL_M, GL_M, GL_Q), (GL_M, GL_N, GL_Q), (GL_N, GL_N, GL_Q), (GL_WIDE_M, GL_WIDE_M, GL_Q),
                (GL_WIDE_M, GL_WIDE_N, GL_Q), (GL_GPLVM_N, GL_GPLVM_N, GL_Q),
                (GL_M, GL_N * GL_QUAD_NGHP ** GL_QUAD_Q, GL_QUAD_Q),
                (GL_M, GL_N - 1, GL_Q)]  # checked only: an odd column count takes the edge path
GL_K2_SHAPES = [(GL_GPLVM_N, GL_GPLVM_N, GL_Q), (GL_WIDE_M, GL_WIDE_N - 2, GL_Q)]  # the second: the edge path

# The convolutional slice (phase 22; bench.py has no convolutional point):
# (a) the convolutional GP of van der Wilk, Rasmussen and Hensman (NeurIPS
# 2017) on MNIST's shapes: 28 x 28 images, 5 x 5 patches (P = 576 patches an
# image, S = 25), M = 750 inducing patches, C = 10 classes, MultiClass with
# RobustMax, whitened full q_sqrt [C, M, M], batches of B = 256 images,
# N = 60000 training and 1000 held-out images, float32. MNIST is not in the
# repository, so the images are synthetic, from a seed, a translation-
# invariant task as doc/examples/convolutional.py:47-58 makes one: noise
# uniform in [0, CV_NOISE], plus one of C seeded 7 x 7 templates (a random
# half of its pixels +0.8) at a uniformly random position; the label is the
# template's index. Z: 750 of the distinct patches of the first M images
# (doc/examples/convolutional.py:69-71). The base kernel is
# SquaredExponential (K1, its backward from the saved K; Matern52 once, K2
# on Kuf's backward) with lengthscale 0.5, near the median distance between
# the inducing patches (0.43): at 1.0 cond(Kuu + 1e-4 I) is 4.9e6, at 0.5
# 3.3e5 (numpy, the same Z). CIFAR-10's shapes once (32 x 32 x 3, 3 x 3
# patches: P = 2700, S = 9, B = 32), so that the colour channels' order runs
# on the card, with lengthscale 0.1: 3 x 3 patches inside a template nearly
# repeat, and at 0.5 cond(Kuu + 1e-4 I) is 6.2e6, at 0.1 7.7e3. (b) ChangePoints: a GPR at bench.py's N = 8192
# with D = 1, x sorted in [0, 10], sin(x) before 5 and sin(4 x) after,
# noise 0.1; ChangePoints([Matern32(1.0), Matern32(0.2)], locations [4.0],
# steepness 5.0), started away from the change at 5. (c) Categorical: a GPR
# at N = 8192 on bench.py's D = 8 inputs and a label column of 10 labels.
CV_C, CV_M, CV_B, CV_N, CV_NEW = 10, 750, 256, 60000, 1000
CV_MNIST = {"image": (28, 28), "patch": (5, 5), "channels": 1, "lengthscale": 0.5}
CV_NOISE, CV_BRIGHT, CV_TEMPLATE = 0.2, 0.8, 7
CV_STEPS = 50  # Adam steps
CV_TIMED_ROUNDS = 3
CV_CIFAR = {"image": (32, 32), "patch": (3, 3), "channels": 3, "lengthscale": 0.1}
CV_CIFAR_B = 32
CV_SEEDS = {"data": SEED + 70, "templates": SEED + 71, "Z": SEED + 72, "values": (SEED + 73, SEED + 74),
            "batch": SEED + 75, "train": SEED + 76, "cifar": SEED + 77, "kernels": SEED + 78, "cp": SEED + 79,
            "cat": SEED + 80, "route": SEED + 81}
CP_N, CP_NOISE, CP_MAXITER = GPR_NS[0], 0.1, GPR_MAXITER
CAT_N, CAT_LABELS = GPR_NS[0], 10
# float32 against float64 on the card, relative to the largest float64 entry
# (the value to itself), beside the lower-tier control (Z and the images
# rounded to bfloat16, TF32 matmuls), which must break at least one limit.
# The limits are set from readings (PERF.md §6, the convolutional slice), 3-10
# times the largest sound error over the two sets of values, the Matern52
# base kernel and CIFAR-10's shapes: the value 9.5e-7 (the control 1.9e-5 or
# more), the gradients 6.1e-4 (the lengthscale; the control's weights and Z
# 1.3e-2 or more), q's 1.1e-4 (the control 8.4e-3), the fused request's mean
# and variance 3.8e-4 and 4.7e-4 (the control 0.12 and 0.15). The slope in
# the base kernel's variance is a cancellation, 0.14-0.68 beside gradients of
# 1e3-2e4 in the other parameters, and float32 leaves 0.18-1.19 of it (the
# control 2.3-340): its limit is relative to that small slope. The cached
# route's float64 requests must equal the fused route's (4.3e-9 read; its
# explicit inverse carries up to cond(Kuu)^2 eps64 ~ 5e-6).
CV_RTOL = {"value": 1e-5, "gradient": 3e-3, "gradient q": 1e-3, "gradient .kernel.base_kernel.variance": 4.0,
           "requests": {"mean": 2e-3, "var": 2e-3}, "routes f64": 1e-6}
# Kuf_conv_patch's K1 route against the JAX package's batched plain route,
# both float32, value and gradients relative to the largest entry (1.6e-6
# read, the weights' gradient): the norm expansion of the plain route's
# square_distance rounds |x|^2 + |z|^2 - 2 x.z, K1 sums (x - z)^2 directly.
CV_ROUTE_RTOL = 1e-5
CV_K1_SHAPES = [(CV_M, CV_M, 25), (CV_M, CV_B * 576, 25), (CV_M, CV_NEW * 576, 25), (CV_M, CV_M, 9),
                (CV_M, 86400, 9), (CP_N, CP_N, 1), (CAT_N, CAT_N, 9),
                (CV_M, CV_B * 576 - 3, 25)]  # the last: the edge path, no path's shape
CV_K2_SHAPES = [(CV_M, CV_M, 25, "matern52"), (CV_M, CV_B * 576, 25, "matern52"),
                (CV_M, CV_NEW * 576, 25, "matern52"), (CP_N, CP_N, 1, "matern32"),
                (CV_M, CV_B * 576 - 3, 25, "matern52")]

# Phase 23, serving artifacts (slice 13): phase 5's flagship SVGP and the
# GPR at N = 8192 exported through torch.export and served from the loaded
# programs. Symbolic requests of these sizes; a bucketed artifact of these
# buckets served these sizes (the last in three chunks: 8192, 8192 and 3616
# padded to 4096).
SV_METHODS = ("predict_f", "predict_y", "predict_mean")
SV_REQUESTS = (8192, 5000, 1)
SV_BUCKETS = (1024, 4096, 8192)
SV_BUCKET_REQUESTS = (1000, 5000, 8192, 20000)
SV_GPR_N = 8192
SV_TRAIN_STEPS = 10  # Adam steps before the trainer's state is saved, and after
SV_HOST_CALLS = 1000  # K1 calls at (1, 1, 8) timed on the host clock
# Served outputs against the live cached posterior of the same model, and a
# bucketed request against the symbolic artifact's at the same points, as a
# fraction of the largest entry and at least of the prior variance (1): the
# same function of the same values, so they should agree to the bit; but the
# program may take a product through another routine than eager PyTorch
# does at some sizes (a request of one point), and a padded request may
# order the M = 2048 terms of its products otherwise:
# rounding of order sqrt(M) eps32 of the terms' sum, with the variance's
# cancellation Kff - kuf^T Qinv kuf on top.
SV_RTOL = 1e-4
# The shapes of phase 23 that no earlier phase checks: Kuf of the symbolic
# requests of 5000 and 1 points and of the buckets 1024 and 4096, and the
# GPR's K(X, Xnew) at N = 8192.
SV_K1_SHAPES = [(M, 5000, D), (M, 1, D), (M, 1024, D), (M, 4096, D), (SV_GPR_N, SV_GPR_N, D)]

# Phase 24: the training tools around the flagship SVGP (phase 5's values,
# one batch of B rows of phase 7's data) and the GPR at N = 8192.
TL_STEPS = 20  # training_loop steps, and steps of the monitored loop
TL_PERIODS = (1, 5)  # the monitor's two groups
TL_GPR_ITERS = 5  # the monitored Scipy fit of the GPR
TL_PROFILE_STEPS = 3
# The three loss histories of one start (training_loop with use_scan False
# and True, a hand loop of torch.optim.Adam over the same closure) run the
# same operations in the same order on the same inputs, so they should
# agree to the bit; the limit is phase 7's float32 loss tolerance, which a
# reduction taken in another order by an atomic would stay well inside.
TL_RTOL = 1e-5

# Phase 25: the shape contracts of slices 1-6 driven with the checks on and
# off from the same state, in this order (each mode twice, interleaved):
# the flagship SVGP step, the GPR at N = 8192, the Bernoulli SVGP's fused
# natural-gradient step, SGPR and the matrix-free CGLB at bench width. A
# check reads shapes only, so each run of a path gives the same bits.
CT_ORDER = (False, True, True, False)
CT_STEPS = 10  # training steps of each run
CT_SEED = SEED + 90  # the steps' batch draws and CGLB's fixed v
CGLB_AB_CALLS = 20  # --cglb-eager-ms: timed calls of each value and gradient
MESH_HOST_STEPS, MESH_HOST_ROUNDS = 20, 4  # --mesh-host-ms: steps in a row of each way, rounds
CT_SPARSE = (("SGPR", "SquaredExponential"), ("CGLB", "Matern52"))

# Phase 26: phase 25's paths (and phase 19's main model, phase 5's requests)
# through a one-rank mesh and without one, from one state, each run equal
# to the bit: every collective of one rank is a copy. A trainer's step (and
# its loss) on the mesh is traced and replayed ("mesh") or run eagerly
# ("eager mesh", ``jt_eager``); without a mesh it is traced ("no mesh").
MS_STEPS = 10  # training steps of each run
MS_MODES = ("mesh", "eager mesh", "no mesh")
MS_ORDER = ("mesh", "eager mesh", "no mesh", "no mesh", "eager mesh", "mesh")  # each mode twice, interleaved
MS_PROFILE_STEPS = 3  # steps under torch.profiler each way, on the latent-split path
MS_AB_STEPS = 12  # steps of each mode, the three trainers in turn, on the host-bound paths
MS_LATENT_NG_STEPS = 3  # sequential natural-gradient steps on the latent split, each mode
MS_REQUEST = 8192

# Phase 29: the compile layer (``gpflow_tpu_torch/_compile.py``): each path
# traced and eager from one state, equal to the bit with the same launches,
# the traced side tracing once; each mode twice, interleaved, for the times.
JT_ORDER = (False, True, True, False)  # traced or not
JT_STEPS = 10  # trainer steps of each run
JT_GPR_ITERS = 4  # L-BFGS iterations of the GPR at N = 8192, each way
JT_EVALS = 3  # timed L-BFGS evaluations of the GPR at N = 16384, each way, in turns
JT_LOOP_STEPS = 10  # training_loop steps of each run
JT_HMC_BURNIN, JT_HMC_SAMPLES = 5, 3  # the short chains' adapting and kept steps, each way
JT_CG_RESTART = 2  # CGLB's CG restarts every 2 iterations, so that both branches of its restart run
JT_CG_TIMED = 5  # timed CGLB values and gradients each way, in turns
# The whole run's launches of phases 5-28, each path's count as asserted
# (PERF.md section 6): phase 29 adds its own, which it asserts path by path.
# Phase 26's share is K1 897 and K2 356 (each run of its three modes counted).
LAUNCHES_5_TO_28 = {"K1": 8149, "K2": 4616}

# Phase 27: the JAX package's test files that run on the card through the
# alias, in a process of its own (no JAX there; --noconftest).
RF_FILES = (
    "tests/gpflow_tpu/test_logdensities.py",
    "tests/gpflow_tpu/test_functions_depth.py",
    "tests/gpflow_tpu/covariances/test_covariances.py",
    "tests/gpflow_tpu/test_inducing_variables.py",
    "tests/gpflow_tpu/posteriors/test_predict_mean.py",
    "tests/gpflow_tpu/models/test_model_predict.py",
)
RF_TIMEOUT = 300
RF_RUNS = []  # phase 27's run of them, started beside the build (it launches no kernel)

# Phase 28: the translated JAX test files (those of the map), each process
# with the card as the default device, all started early and waited for after
# the kernel checks, before any timed phase (TR_RUNS): the files that launch no
# kernel beside the build, each of TR_ALONE in a process of its own and the
# others in TR_PROCESSES, all but the longest (TR_ALONE's first) niced so that
# nvcc and that file keep their cores; the files that launch K1 or K2
# (TR_LAUNCHES's) in one process once the libraries are built. The phase reads
# and checks their outcomes and times the kernels at their shapes.
TR_MAP = "tests/test_torch_translated_map.json"
TR_PROCESSES = 4
TR_TIMEOUT = 600
TR_NICE = 5
# The launches each translated file makes on the card, by kernel; every other
# file launches none. The float32 Bayesian GPLVM launches K1 twice; the JAX
# package's own kernel tests launch K1 at (8, 8, 1), (16, 24, 3), (100, 130, 5),
# (20, 20, 2), (33, 21, 4) for each of the six families and (17, 13, 3) for rq,
# and K2 at (14, 11, 3) for the four families it serves.
TR_LAUNCHES = {
    "tests/test_torch_translated_gplvm_f32.py": {"K1": 2, "K2": 0},
    "tests/test_torch_translated_pallas_ops.py": {"K1": 11, "K2": 4},
}
# The shapes of those launches, timed after the tests: K1 (family, N, M, D), K2 likewise.
TR_K1_TIMED = ([("rbf", 8, 8, 1), ("rbf", 16, 24, 3), ("rbf", 100, 130, 5), ("rbf", 20, 20, 2)]
               + [(f, 33, 21, 4) for f in ("rbf", "exponential", "matern12", "matern32", "matern52", "rq")]
               + [("rq", 17, 13, 3)])
TR_K2_TIMED = [(f, 14, 11, 3) for f in ("exponential", "matern12", "matern32", "matern52")]
# The translated kernel test that must keep its own math, with no launch.
TR_NO_LAUNCH = "tests/test_torch_translated_pallas_ops.py::test_subclass_override_not_routed_to_pallas"
# The translated file whose tests run on 8 gloo ranks of the host's CPU.
TR_RANKS_FILE = "tests/test_torch_translated_parallel.py"
# The files that take a process each: the longest, its HMC chains a host-bound
# loop of launches on the card (~85 s), the ranks' file, and the baseline
# configurations, whose heteroskedastic case steps natural gradients 80 times
# through a new closure each, each step traced anew as the JAX package's.
TR_ALONE = ("tests/test_torch_translated_mcmc.py", TR_RANKS_FILE, "tests/test_torch_translated_baseline_configs.py")
TR_RUNS = []  # the processes started before the kernel checks


def log(*args):
    print(*args, flush=True)


def card_check():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    if "GPFLOW_TPU_PALLAS" in os.environ:
        # the variable could turn the kernels off, and the launch counts
        # would then fail far from their cause
        raise SystemExit("chip_smoke: unset GPFLOW_TPU_PALLAS; the script drives the kernels as they route by default")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    import gpflow_tpu_torch  # noqa: F401  (sets the exact-fp32 matmul tier)

    assert torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on for matmul"
    assert torch.backends.cudnn.allow_tf32 is False, "TF32 is on for cuDNN"
    assert torch.get_float32_matmul_precision() == "highest"
    return torch.cuda.get_device_name(0), smi


def build_kernels():
    """Phase 2: K1 and K2, one nvcc each, started together. Returns
    {name: (seconds until loaded, nvcc seconds)}."""
    from gpflow_tpu_torch.ops import cuda_build
    from gpflow_tpu_torch.ops.pallas_distance import k1_library, k2_library

    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = {"K1": pool.submit(timed, k1_library), "K2": pool.submit(timed, k2_library)}
        seconds = {k: f.result() for k, f in futures.items()}
    return {k: (seconds[k], cuda_build.build_seconds[lib])
            for k, lib in (("K1", "gpflow_k1"), ("K2", "gpflow_k2"))}


def request_ms(fn, iters, warmup=2):
    """Mean milliseconds per call of ``fn()`` called back to back, by CUDA
    events: the latency a stream of requests sees, host work included."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, warmup=3):
    """Mean device milliseconds per call of ``fn()``, which must not
    synchronise: its launches queue behind a ~30 ms GPU sleep, so the events
    time the kernels and not the Python that enqueues them."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plan_seen(kernel, seen):
    """Logs the launch plan of ``kernel``'s last launch and adds its
    (tma, vec) to ``seen``."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    plan = pd.launch_plans[kernel]
    seen.add((plan.tma, plan.vec))
    return (f"plan: {plan.tile_rows}-row tiles, {plan.tiles} tiles, grid {plan.grid}, "
            f"{'TMA' if plan.tma else 'edge'} path, {'vector' if plan.vec else 'scalar'} staging")


def expect_both_paths(kernel, seen):
    """Fails unless ``kernel`` ran on the TMA and on the edge path, and staged
    with vector and with scalar loads."""
    log(f"{kernel} checks ran (tma, vec) = {sorted(seen)}")
    for i, what in ((0, "TMA and edge paths"), (1, "vector and scalar staging")):
        if {key[i] for key in seen} != {True, False}:
            raise AssertionError(f"{kernel} checks did not run both its {what}: {sorted(seen)}")


def check_k1():
    """Phase 3: K1 against the plain version, every family, f32 and bf16."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 1)
    var = torch.tensor([1.7], device="cuda")
    alpha = torch.tensor([1.3], device="cuda")
    worst = 0.0
    seen = set()
    for n, m, d in K1_SHAPES:
        scale = 4.0 if d == 8 else 1.0  # the slice's inputs at D = 8, unit cube else
        Xs = torch.from_numpy((rng.rand(n, d) * scale).astype(np.float32)).cuda()
        Zs = torch.from_numpy((rng.rand(m, d) * scale).astype(np.float32)).cuda()
        for family in pd.PALLAS_FAMILIES:
            for dtype in (torch.float32, torch.bfloat16):
                x, z = Xs.to(dtype), Zs.to(dtype)
                K = pd.stationary_forward_cuda(family, x, z, var, alpha)
                plan = plan_seen("K1", seen)
                plain32 = pd.stationary_forward_plain(family, x, z, var, alpha)
                plain64 = pd.stationary_forward_plain(family, x.double(), z.double(), var.double(), alpha.double())
                torch.cuda.synchronize()
                assert K.shape == (n, m) and K.dtype == torch.float32
                err64 = float((K.double() - plain64).abs().max())
                err32 = float((K - plain32).abs().max())
                rel64 = err64 / max(float(plain64.abs().max()), 1e-30)
                log(f"K1 {family:11s} {str(dtype):14s} ({n}, {m}, {d}): max abs err {err64:.3e} "
                    f"(rel {rel64:.3e}) vs plain f64, tol {K1_ATOL_F64 * 1.7:.1e}; "
                    f"{err32:.3e} vs plain f32, tol {K1_ATOL_F32 * 1.7:.1e}; {plan}")
                if not err64 <= K1_ATOL_F64 * 1.7 or not err32 <= K1_ATOL_F32 * 1.7:
                    raise AssertionError(f"K1 disagrees with its plain version: {family} {dtype} {(n, m, d)}")
                worst = max(worst, err64)
    expect_both_paths("K1", seen)
    return worst


def offset_view(t):
    """A contiguous copy of ``t`` that starts 4 bytes into its storage."""
    storage = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = storage[1:].view(t.shape)
    view.copy_(t)
    return view


def check_k2():
    """Phase 4: K2 against the plain version, its four families, f32 and bf16
    inputs. Exponential and Matern 1/2 carry 1/r: their Zs sit 0.1 of the
    input scale apart from Xs in every dimension, away from r = 0; Matern
    3/2 and 5/2 take overlapping inputs, as the path's Kuu and Kuf do.
    Returns the largest absolute error against float64."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 4)
    var = torch.tensor([1.7], device="cuda")
    worst = 0.0
    seen = set()
    for (n, m, d), offset in [(s, False) for s in K2_SHAPES] + [(K2_OFFSET_G_SHAPE, True)]:
        scale = 4.0 if d == 8 else 1.0
        Xs = torch.from_numpy((rng.rand(n, d) * scale).astype(np.float32)).cuda()
        Zs = torch.from_numpy((rng.rand(m, d) * scale).astype(np.float32)).cuda()
        g = torch.from_numpy(rng.randn(n, m).astype(np.float32)).cuda()
        if offset:
            g = offset_view(g)
            assert g.is_contiguous() and g.data_ptr() % 16 == 4
        for family in pd.WGRAD_FAMILIES:
            z0 = Zs + 1.1 * scale if family in ("exponential", "matern12") else Zs
            for dtype in (torch.float32, torch.bfloat16):
                x, z = Xs.to(dtype), z0.to(dtype)
                W = pd.stationary_wgrad_cuda(family, x, z, var, g)
                plan = plan_seen("K2", seen)
                if offset and pd.launch_plans["K2"].tma:
                    raise AssertionError("K2 took the TMA path for a g 4 bytes off its alignment")
                plain32 = pd.stationary_wgrad_plain(family, x, z, var, g)
                plain64 = pd.stationary_wgrad_plain(family, x.double(), z.double(), var.double(), g.double())
                torch.cuda.synchronize()
                assert W.shape == (n, m) and W.dtype == torch.float32
                top = max(float(plain64.abs().max()), 1e-30)
                err64 = float((W.double() - plain64).abs().max())
                err32 = float((W - plain32).abs().max())
                log(f"K2 {family:11s} {str(dtype):14s} ({n}, {m}, {d}){' g 4 bytes off' if offset else ''}: "
                    f"max abs err {err64:.3e} (rel {err64 / top:.3e}, tol {K2_RTOL_F64:.0e}) vs plain f64; "
                    f"rel {err32 / top:.3e} (tol {K2_RTOL_F32:.0e}) vs plain f32; {plan}")
                if not err64 <= K2_RTOL_F64 * top or not err32 <= K2_RTOL_F32 * top:
                    raise AssertionError(f"K2 disagrees with its plain version: {family} {dtype} {(n, m, d)}")
                worst = max(worst, err64)
    expect_both_paths("K2", seen)
    return worst


def check_k2_coincident(n=8192):
    """Phase 4, last part: K2 on an [N, N] block with X = Z, as a GPR's Gram
    matrix has it, for the two families whose h' carries 1/r. Eight rows are
    repeated, so coincident pairs lie off the diagonal too. W must be
    exactly 0 at every coincident pair and agree with the plain version
    elsewhere. Returns the largest absolute error against float64."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 8)
    X = rng.rand(n, D).astype(np.float32)
    X[n // 2:n // 2 + 8] = X[:8]
    Xs = torch.from_numpy(X).cuda()
    g = torch.from_numpy(rng.randn(n, n).astype(np.float32)).cuda()
    var = torch.tensor([1.7], device="cuda")
    rows = torch.cat([torch.arange(n), torch.arange(8), torch.arange(n // 2, n // 2 + 8)]).cuda()
    cols = torch.cat([torch.arange(n), torch.arange(n // 2, n // 2 + 8), torch.arange(8)]).cuda()
    worst = 0.0
    for family in ("exponential", "matern12"):
        W = pd.stationary_wgrad_cuda(family, Xs, Xs, var, g)
        plain64 = pd.stationary_wgrad_plain(family, Xs.double(), Xs.double(), var.double(), g.double())
        torch.cuda.synchronize()
        at_pairs = W[rows, cols]
        top = float(plain64.abs().max())
        err64 = float((W.double() - plain64).abs().max())
        log(f"K2 {family:11s} coincident ({n}, {n}, {D}), X = Z: max |W| at the {rows.numel()} coincident "
            f"pairs {float(at_pairs.abs().max()):.1e} (must be 0); max abs err {err64:.3e} "
            f"(rel {err64 / top:.3e}, tol {K2_RTOL_F64:.0e}) vs plain f64")
        if not bool((at_pairs == 0).all()) or not bool((plain64[rows, cols] == 0).all()):
            raise AssertionError(f"K2 {family}: W is not 0 at coincident points")
        if not err64 <= K2_RTOL_F64 * top:
            raise AssertionError(f"K2 {family} disagrees with its plain version at X = Z")
        worst = max(worst, err64)
        del W, plain64
    return worst


def check_grads():
    """Phase 6: dX, dZ, dlengthscales and dvariance of
    ``stationary_kernel_matrix`` on the card against plain autograd through
    ``stationary_forward_plain`` in float64, at the path's Kuu and Kuf."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 3)
    Z = rng.rand(M, D) * 4
    Xb = rng.rand(B, D) * 4
    ls = 0.8 + 0.4 * rng.rand(D)
    for family in ("rbf", "matern52"):
        for which, other in (("Kuu", None), ("Kuf", Xb)):
            g = rng.randn(M, M if other is None else B)
            grads = {}
            for dtype in (torch.float32, torch.float64):
                leaves = [torch.tensor(v, dtype=dtype, device="cuda", requires_grad=True)
                          for v in (Z, Z if other is None else other, ls, 1.3)]
                A, Bm, l, v = leaves
                Bm = A if other is None else Bm
                if dtype == torch.float32:
                    K = pd.stationary_kernel_matrix(A, Bm, l, v, family)
                else:
                    K = pd.stationary_forward_plain(family, A / l, Bm / l, v)
                K.backward(torch.from_numpy(g).to(device="cuda", dtype=K.dtype))
                grads[dtype] = {name: t.grad for name, t in zip(("dZ", "dX", "dls", "dvar"), leaves)
                                if t.grad is not None}
            for name, want in grads[torch.float64].items():
                got = grads[torch.float32][name].double()
                err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
                log(f"grad {family} {which} {name}: max abs err {err:.3e} of the f64 max, tol {GRAD_RTOL:.0e}")
                if not err <= GRAD_RTOL:
                    raise AssertionError(f"gradient {name} of {family} {which} disagrees with plain autograd")


def check_gram_grads(n=8192):
    """Phase 6, last part: dX, dlengthscales and dvariance of
    ``stationary_kernel_matrix(X, X, ...)`` at a GPR's [N, N] Gram shape
    (rbf from the saved K, matern12 through K2) against plain autograd in
    float64 through the clamp formula h(sqrt(max(d2, 1e-36))), with d2 a
    sum of squared differences, exactly 0 on the diagonal."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 9)
    X = rng.rand(n, D)
    ls = 0.8 + 0.4 * rng.rand(D)
    g = torch.from_numpy(rng.randn(n, n)).cuda()
    for family in ("rbf", "matern12"):
        grads = {}
        for dtype in (torch.float32, torch.float64):
            leaves = [torch.tensor(v, dtype=dtype, device="cuda", requires_grad=True) for v in (X, ls, 1.3)]
            x, l, v = leaves
            if dtype == torch.float32:
                K = pd.stationary_kernel_matrix(x, x, l, v, family)
            else:
                xs = x / l
                d2 = torch.zeros((n, n), dtype=dtype, device="cuda")
                for k in range(D):
                    d2 = d2 + torch.square(xs[:, k, None] - xs[None, :, k])
                if family == "rbf":
                    K = v * torch.exp(-0.5 * d2)
                else:
                    K = v * torch.exp(-torch.sqrt(torch.clamp(d2, min=1e-36)))
            K.backward(g.to(K.dtype))
            grads[dtype] = {name: t.grad for name, t in zip(("dX", "dls", "dvar"), leaves)}
            del K
        for name, want in grads[torch.float64].items():
            got = grads[torch.float32][name].double()
            err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            log(f"grad {family} Gram ({n}, {n}, {D}) {name}: max abs err {err:.3e} of the f64 max, "
                f"tol {GRAD_RTOL:.0e}")
            if not err <= GRAD_RTOL:
                raise AssertionError(f"gradient {name} of {family} at the Gram shape disagrees with plain autograd")


def make_training_data(seed):
    """X, Y and Z as ``bench.py:121-126`` makes them."""
    rng = np.random.RandomState(seed)
    X = rng.rand(N_DATA, D).astype(np.float32) * 4.0
    w = rng.randn(D, 1).astype(np.float32)
    Y = np.sin(X @ w) + 0.1 * rng.randn(N_DATA, 1).astype(np.float32)
    Z = X[rng.choice(N_DATA, M, replace=False)].copy()
    return X, Y, Z


def training_model(kernel, Z, dtype, device):
    """The flagship SVGP before training: lengthscales 1, noise 0.1,
    ``num_data`` = N, whitened full q_sqrt (identity), q_mu zeros."""
    from gpflow_tpu_torch import config, kernels, likelihoods
    from gpflow_tpu_torch.models import SVGP

    with config.as_context(dataclasses.replace(config.config(), float=dtype, device=device)):
        model = SVGP(
            kernel=getattr(kernels, kernel)(lengthscales=np.ones(D)),
            likelihood=likelihoods.Gaussian(NOISE),
            inducing_variable=Z,
            num_data=N_DATA,
        )
    return model.to(dtype=dtype)


def train(kernel, route, flag, data, Z):
    """Phase 7 for one kernel and route: TRAIN_CALLS calls of
    ``run_steps_sampled`` with sync debug mode "error"; returns the trainer
    and the launch counts of the run."""
    from gpflow_tpu_torch.conditionals import inv_solve
    from gpflow_tpu_torch.ops import pallas_distance as pd
    from gpflow_tpu_torch.parallel import DataParallelTrainer

    trainer = DataParallelTrainer(training_model(kernel, Z, torch.float32, "cuda"))
    trainer.stage_data(data)
    with inv_solve(flag):
        pd.launch_counts.update(K1=0, K2=0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses = [trainer.run_steps_sampled(
                TRAIN_STEPS_PER_CALL, B, generator=torch.Generator(device="cuda").manual_seed(SEED + i))
                for i in range(TRAIN_CALLS)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        counts = dict(pd.launch_counts)
    losses = torch.cat(losses).cpu()
    steps = TRAIN_CALLS * TRAIN_STEPS_PER_CALL
    expected = {"K1": 2 * steps, "K2": 2 * steps if kernel == "Matern52" else 0}
    log(f"train {kernel} {route}: {steps} steps, loss {float(losses[0]):.6e} -> "
        f"{float(losses[-5:].mean()):.6e} (mean of the last 5); launches {counts}, expected {expected}")
    assert losses.shape == (steps,) and bool(torch.isfinite(losses).all()), f"{kernel} {route}: non-finite loss"
    assert float(losses[-5:].mean()) < float(losses[0]), f"{kernel} {route}: the loss did not fall"
    assert counts == expected, f"{kernel} {route}: launch counts {counts} != {expected}"
    return trainer, counts


def compare_f64(X, Y, Z):
    """Phase 7, last part: the first F64_STEPS steps of Matern52 on INV_SOLVE
    in float32 on the card against float64 on the CPU, from the same values
    on the same batches (both with the float32 jitter, 1e-4)."""
    from gpflow_tpu_torch import config
    from gpflow_tpu_torch.conditionals import inv_solve
    from gpflow_tpu_torch.parallel import DataParallelTrainer
    from gpflow_tpu_torch.utilities import load_jax_values, read_values

    idx = np.random.RandomState(SEED + 5).randint(0, N_DATA, (F64_STEPS, B))
    batches = (X[idx], Y[idx])
    card = training_model("Matern52", Z, torch.float32, "cuda")
    start = read_values(card)
    with inv_solve(True):
        losses32 = DataParallelTrainer(card).run_steps(tuple(torch.from_numpy(a).cuda() for a in batches))
        with config.as_context(config.Config(float=torch.float64, jitter=1e-4, device="cpu")):
            cpu = training_model("Matern52", Z, torch.float64, "cpu")
            load_jax_values(cpu, {k: v.astype(np.float64) for k, v in start.items()})
            t0 = time.perf_counter()
            losses64 = DataParallelTrainer(cpu).run_steps(tuple(torch.from_numpy(a).double() for a in batches))
            cpu_s = time.perf_counter() - t0
    losses32 = losses32.cpu().double()
    loss_err = float(((losses32 - losses64) / losses64).abs().max())
    log(f"f64: {F64_STEPS} Matern52 INV_SOLVE steps at M={M}, B={B} on the CPU in float64 took {cpu_s:.1f} s; "
        f"losses card {losses32.tolist()} cpu {losses64.tolist()}: max rel err {loss_err:.3e}, tol {F64_LOSS_RTOL:.0e}")
    assert loss_err <= F64_LOSS_RTOL, "float32 losses disagree with the float64 CPU model"
    got, want = read_values(card), read_values(cpu)
    for path in sorted(want):
        diff = np.abs(got[path].astype(np.float64) - want[path])
        if path.startswith((".kernel", ".likelihood")):
            log(f"f64: {path}: max abs diff {diff.max():.3e}, tol {F64_HYPER_ATOL:.0e}")
            assert diff.max() <= F64_HYPER_ATOL, f"{path} disagrees with the float64 CPU model"
        else:
            moved = want[path] != start[path]
            share = float(np.mean(diff[moved] > F64_ELEMENT_ATOL)) if moved.any() else 0.0
            log(f"f64: {path}: {int(moved.sum())} elements moved, share off by > {F64_ELEMENT_ATOL:.0e}: "
                f"{share:.3e} (tol {F64_ELEMENT_SHARE:.0e}); max abs diff {diff.max():.3e}")
            assert share <= F64_ELEMENT_SHARE, f"{path} disagrees with the float64 CPU model"


def serve_trained(model, X):
    """Phase 8: cached-posterior requests from the trained Matern52 model."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    requests = [torch.from_numpy(X[i * B:(i + 1) * B]).cuda() for i in range(N_REQUESTS)]
    with torch.no_grad():
        pd.launch_counts.update(K1=0, K2=0)
        post = model.posterior()
        outputs = [post.predict_f(Xb) for Xb in requests]
        torch.cuda.synchronize()
        counts = dict(pd.launch_counts)
    expected = {"K1": 1 + N_REQUESTS, "K2": 0}
    for mean, var in outputs:
        assert mean.shape == var.shape == (B, 1)
        assert bool(torch.isfinite(mean).all() and torch.isfinite(var).all()), "trained serving: non-finite output"
        assert bool((var > 0).all()), "trained serving: variance not positive"
    log(f"trained serving: {N_REQUESTS} Matern52 requests finite with var > 0; launches {counts}, expected {expected}")
    assert counts == expected, f"trained serving launch counts {counts} != {expected}"
    return counts


def time_training(trainers):
    """Phase 9: steps per second of each kernel and route, by CUDA events
    around one ``run_steps_sampled`` call, in two rounds of opposite order."""
    from gpflow_tpu_torch.conditionals import inv_solve

    got = {key: [] for key in trainers}
    for order in (list(trainers), list(reversed(trainers))):
        for key in order:
            with inv_solve(key[1] == "inv_solve"):
                ms = request_ms(lambda: trainers[key].run_steps_sampled(TIMED_STEPS, B), 1, warmup=1)
            got[key].append(TIMED_STEPS / ms * 1e3)
    for (kernel, route), rates in got.items():
        log(f"time: train {kernel} {route} at B={B}: {max(rates):.2f} steps/s "
            f"({1e3 / max(rates):.3f} ms per step); rounds {[round(r, 2) for r in rates]}")
    return got


def profile_step(trainer, kernel, route):
    """Phase 9: device time of one training step by kernel, from
    ``torch.profiler``."""
    from gpflow_tpu_torch.conditionals import inv_solve

    with inv_solve(route == "inv_solve"):
        profile_device(lambda: trainer.run_steps_sampled(1, B), f"train {kernel} {route}")


def time_k2(n, m, iters=50, family="matern52", d=D):
    """Phase 10: K2 against the plain version, device time, interleaved. At
    d = D the inputs are uniform on [0, 4]^8; at another width N(0, 1 / d)
    per dimension, as in ``time_k1`` (phase 19)."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 6)
    if d == D:
        Xs, Zs = (rng.rand(n, d) * 4).astype(np.float32), (rng.rand(m, d) * 4).astype(np.float32)
    else:
        Xs, Zs = ((rng.randn(k, d) / np.sqrt(d)).astype(np.float32) for k in (n, m))
    Xs, Zs = torch.from_numpy(Xs).cuda(), torch.from_numpy(Zs).cuda()
    g = torch.randn(n, m, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 6))
    var = torch.tensor([1.0], device="cuda")
    fns = {"plain": pd.stationary_wgrad_plain, "k2": pd.stationary_wgrad_cuda}
    got = {"plain": [], "k2": []}
    for which in ("plain", "k2", "k2", "plain"):
        got[which].append(device_ms(lambda: fns[which](family, Xs, Zs, var, g), iters))
    k2, plain = min(got["k2"]), min(got["plain"])
    gbs = n * m * 8 / (k2 * 1e-3) / 1e9
    bound_ms, bound_by = kernel_bound_ms("K2", n, m, d)
    log(f"time: K2 {family} ({n}, {m}, {d}): {k2:.4f} ms ({gbs:.0f} GB/s of g read and W written), "
        f"plain {plain:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / k2:.0f}% of the bound's rate); "
        f"runs k2 {got['k2']}, plain {got['plain']}")
    return k2, plain


def make_values(seed):
    """Model values in ``load_jax_values`` format, and the data X."""
    rng = np.random.RandomState(seed)
    X = (rng.rand(N_DATA, D) * 4.0).astype(np.float32)
    Z = X[rng.choice(N_DATA, M, replace=False)]
    q_sqrt = np.tril(rng.randn(1, M, M) * (0.1 / np.sqrt(M)), k=-1)
    q_sqrt[0, np.arange(M), np.arange(M)] = 0.1 + 0.9 * rng.rand(M)
    values = {
        ".inducing_variable.Z": Z,
        ".kernel.lengthscales": np.ones(D, np.float32),
        ".kernel.variance": np.asarray(1.0, np.float32),
        ".likelihood.variance": np.asarray(NOISE, np.float32),
        ".q_mu": rng.randn(M, 1).astype(np.float32),
        ".q_sqrt": q_sqrt.astype(np.float32),
    }
    return values, X


def build_model(values, dtype):
    from gpflow_tpu_torch import config, kernels, likelihoods
    from gpflow_tpu_torch.models import SVGP
    from gpflow_tpu_torch.utilities import load_jax_values

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        model = SVGP(
            kernel=kernels.SquaredExponential(lengthscales=np.ones(D)),
            likelihood=likelihoods.Gaussian(1.0),
            inducing_variable=np.zeros((M, D)),
        ).to(dtype)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    load_jax_values(model, {k: v.astype(np_dtype) for k, v in values.items()})
    return model


def serve(model, requests):
    """Phase 4's requests; returns the outputs of the first request of each
    entry point, keyed by route."""
    from gpflow_tpu_torch.conditionals import inv_solve

    out = {}
    post = model.posterior()
    for Xb in requests:
        out.setdefault("cached predict_f", post.predict_f(Xb))
    for Xb in requests:
        out.setdefault("cached predict_mean", (post.predict_mean(Xb),))
    for route, flag in (("solve", False), ("inv_solve", True)):
        with inv_solve(flag):
            out[f"fused predict_f ({route})"] = model.predict_f(requests[0])
            out[f"predict_y ({route})"] = model.predict_y(requests[0])
    return out


def check_slice(outputs, reference):
    """Phase 4's checks on the outputs of ``serve``."""
    for key, tensors in outputs.items():
        for t in tensors:
            assert t.shape == (B, 1) and t.dtype == torch.float32, (key, t.shape, t.dtype)
            assert bool(torch.isfinite(t).all()), f"{key}: non-finite output"
        if len(tensors) == 2:
            assert bool((tensors[1] > 0).all()), f"{key}: variance not positive"
        tol = SLICE_RTOL["cached" if key.startswith("cached") else "fused"]
        for what, got, want in zip(("mean", "var"), tensors, reference[key]):
            err = float((got.double().cpu() - want).abs().max()) / float(want.abs().max())
            log(f"slice: {key} {what}: max abs err {err:.3e} of the f64 CPU max, tol {tol:.0e}")
            assert err <= tol, f"{key} {what} disagrees with the float64 reference"


def time_requests(model, Xb):
    """Phase 5: milliseconds per request of each entry point."""
    from gpflow_tpu_torch.conditionals import inv_solve

    post = model.posterior()
    times = {
        "cached predict_f": request_ms(lambda: post.predict_f(Xb), 20),
        "cached predict_mean": request_ms(lambda: post.predict_mean(Xb), 20),
    }
    for route, flag in (("solve", False), ("inv_solve", True)):
        with inv_solve(flag):
            times[f"fused predict_f ({route})"] = request_ms(lambda: model.predict_f(Xb), 10)
            times[f"predict_y ({route})"] = request_ms(lambda: model.predict_y(Xb), 10)
    for key, ms in times.items():
        log(f"time: {key} at B={B}: {ms:.4f} ms per request ({B / ms * 1e3:.0f} points/s)")


def time_k1(n, m, iters=50, d=D, family="rbf"):
    """Phase 10: K1 against the plain version (``family``, rbf by default),
    device time, interleaved.
    At d = D the inputs are uniform on [0, 4]^8 as the flagship's; at another
    width N(0, 1 / d) per dimension, as N(0, 1) data over lengthscales
    sqrt(d) reach K1 (phase 18)."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 2)
    if d == D:
        Xs, Zs = (rng.rand(n, d) * 4).astype(np.float32), (rng.rand(m, d) * 4).astype(np.float32)
    else:
        Xs, Zs = ((rng.randn(k, d) / np.sqrt(d)).astype(np.float32) for k in (n, m))
    Xs, Zs = torch.from_numpy(Xs).cuda(), torch.from_numpy(Zs).cuda()
    var = torch.tensor([1.0], device="cuda")
    alpha = torch.tensor([1.0], device="cuda") if family == "rq" else None
    fns = {"plain": pd.stationary_forward_plain, "k1": pd.stationary_forward_cuda}
    got = {"plain": [], "k1": []}
    for which in ("plain", "k1", "k1", "plain"):
        got[which].append(device_ms(lambda: fns[which](family, Xs, Zs, var, alpha), iters))
    k1, plain = min(got["k1"]), min(got["plain"])
    gbs = n * m * 4 / (k1 * 1e-3) / 1e9
    bound_ms, bound_by = kernel_bound_ms("K1", n, m, d)
    log(f"time: K1 {family} ({n}, {m}, {d}): {k1:.4f} ms ({gbs:.0f} GB/s of output), plain {plain:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / k1:.0f}% of the bound's rate); "
        f"runs k1 {got['k1']}, plain {got['plain']}")
    return k1, plain


def counted(fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; returns (result, counts)."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    pd.launch_counts.update(K1=0, K2=0)
    out = fn()
    torch.cuda.synchronize()
    return out, dict(pd.launch_counts)


def expect_launches(what, counts, expected, launches):
    log(f"{what}: launches {counts}, expected {expected}")
    assert counts == expected, f"{what}: launch counts {counts} != {expected}"
    launches[what] = counts


def make_gpr_data():
    """(X, Y) for each N, drawn in turn from RandomState(1) as
    ``bench.py:294-299`` draws them, and B new points for the requests."""
    rng = np.random.RandomState(1)
    data = {}
    for n in GPR_NS:
        X = rng.rand(n, D).astype(np.float32)
        Y = np.sin(X[:, :1] * 3).astype(np.float32) + 0.1 * rng.randn(n, 1).astype(np.float32)
        data[n] = (X, Y)
    Xnew = np.random.RandomState(SEED + 10).rand(B, D).astype(np.float32)
    return data, Xnew


def gpr_model(kernel, data, dtype, values=None):
    """A GPR on the card in ``dtype``: lengthscales 1, noise 0.1, or the
    constrained ``values`` of ``read_values``."""
    from gpflow_tpu_torch import config, kernels
    from gpflow_tpu_torch.models import GPR
    from gpflow_tpu_torch.utilities import load_jax_values

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        model = GPR(data, getattr(kernels, kernel)(lengthscales=[1.0] * D), noise_variance=GPR_NOISE)
    if values is not None:
        load_jax_values(model, values)
    return model


def gpr_value_and_grad(model, flag):
    """The training loss and its gradient with respect to every trainable
    parameter's unconstrained tensor, on the INV_SOLVE route if ``flag``."""
    from gpflow_tpu_torch.conditionals import inv_solve

    with inv_solve(flag):
        loss = model.training_loss()
        grads = torch.autograd.grad(loss, [p.unconstrained for p in model.trainable_variables])
    return loss.detach(), grads


def gram_cond(model64):
    """An upper bound of cond(K + noise I) of a float64 GPR: lambda_min is at
    least the noise, and lambda_max(K) comes from 30 power iterations."""
    with torch.no_grad():
        K = model64.kernel(model64.data[0])
        v = torch.ones(K.shape[0], 1, dtype=K.dtype, device=K.device)
        for _ in range(30):
            v = K @ v
            v = v / v.norm()
        lam = float((v.mT @ (K @ v)).squeeze())
        noise = float(model64.likelihood.variance.value)
    return (lam + noise) / noise


def check_gpr_objective(kernel, n, data, launches):
    """Phase 9: the float32 GPR's training loss and gradient on both routes,
    under sync debug mode "error", against float64 on the card, with exact
    launch counts. Returns the float32 model."""
    from gpflow_tpu_torch.utilities import parameter_dict

    m32 = gpr_model(kernel, data, torch.float32)
    m64 = gpr_model(kernel, data, torch.float64)
    tol = gram_cond(m64) * EPS32
    log(f"gpr {kernel} N={n}: cond(K + noise I) <= {tol / EPS32:.4e}; tolerance cond * eps32 = {tol:.3e}")
    with torch.no_grad():
        loss, counts = counted(m32.training_loss)
    expect_launches(f"gpr {kernel} N={n} objective", counts, {"K1": 1, "K2": 0}, launches)
    paths = {id(p): path for path, p in parameter_dict(m32).items()}
    names = [paths[id(p)] for p in m32.trainable_variables]
    for route, flag in TRAIN_ROUTES:
        torch.cuda.set_sync_debug_mode("error")
        try:
            (loss32, grads32), counts = counted(lambda: gpr_value_and_grad(m32, flag))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        expected = {"K1": 1, "K2": 1 if kernel == "Matern12" else 0}
        expect_launches(f"gpr {kernel} N={n} {route} value and gradient", counts, expected, launches)
        loss64, grads64 = gpr_value_and_grad(m64, flag)
        err = abs(float(loss32) - float(loss64)) / abs(float(loss64))
        log(f"gpr {kernel} N={n} {route}: loss {float(loss32):.6e} (f64 {float(loss64):.6e}), "
            f"rel err {err:.3e}, tol {tol:.1e}")
        assert bool(torch.isfinite(loss32)) and err <= tol, f"GPR loss disagrees with float64 ({route})"
        for name, got, want in zip(names, grads32, grads64):
            gerr = float((got.double() - want).abs().max()) / float(want.abs().max())
            log(f"gpr {kernel} N={n} {route}: gradient {name} {got.double().cpu().numpy().round(4).tolist()} "
                f"(f64 max |.| {float(want.abs().max()):.4e}), rel err {gerr:.3e}, tol {tol:.1e}")
            assert bool(torch.isfinite(got).all()) and gerr <= tol, \
                f"GPR gradient {name} disagrees with float64 ({route})"
    return m32


def train_gpr(model, launches):
    """Phase 9: ``Scipy().minimize`` of the float32 GPR at N = 16384 on the
    INV_SOLVE route, GPR_MAXITER iterations; the objective must fall."""
    from gpflow_tpu_torch.conditionals import inv_solve
    from gpflow_tpu_torch.optimizers import Scipy
    from gpflow_tpu_torch.utilities import parameter_dict

    with inv_solve(True):
        with torch.no_grad():
            loss0 = float(model.training_loss())
        t0 = time.perf_counter()
        res, counts = counted(lambda: Scipy().minimize(
            model.training_loss_closure(), model.trainable_variables,
            options={"maxiter": GPR_MAXITER}, nonfinite_penalty=GPR_PENALTY))
        seconds = time.perf_counter() - t0
    values = {path: p.numpy().round(4).tolist() for path, p in parameter_dict(model).items()}
    log(f"gpr lbfgs N={model.data[0].shape[0]}: loss {loss0:.6e} -> {float(res.fun):.6e}; nit {res.nit}, "
        f"nfev {res.nfev}, non-finite evaluations {res.n_nonfinite_evals}, status {res.status} "
        f"({res.message}); values {values}")
    log(f"time: gpr lbfgs N={model.data[0].shape[0]}: {seconds:.3f} s, {seconds / max(res.nit, 1):.4f} s per "
        f"iteration, {seconds / res.nfev:.4f} s per evaluation")
    assert np.isfinite(res.fun) and float(res.fun) < loss0, "L-BFGS did not lower the GPR objective"
    expect_launches(f"gpr lbfgs N={model.data[0].shape[0]}", counts, {"K1": int(res.nfev), "K2": 0}, launches)
    return res, seconds


def serve_gpr(model, Xnew, launches, label):
    """Phase 9: requests to the GPR through ``posterior()`` and the fused
    entry points, with exact launch counts, against float64 on the card.
    The float64 variance must be positive; the float32 one lies within the
    envelope of it, which at a trained model's conditioning may reach below
    zero."""
    from gpflow_tpu_torch.utilities import read_values

    Xb = torch.from_numpy(Xnew).cuda()
    with torch.no_grad():
        post, counts = counted(model.posterior)
        expect_launches(f"gpr {label} posterior", counts, {"K1": 1, "K2": 0}, launches)
        out = {}
        for key, fn, k1 in (("cached predict_f", lambda: post.predict_f(Xb), 1),
                            ("cached predict_mean", lambda: (post.predict_mean(Xb),), 1),
                            ("fused predict_f", lambda: model.predict_f(Xb), 2),
                            ("predict_y", lambda: model.predict_y(Xb), 2)):
            out[key], counts = counted(fn)
            expect_launches(f"gpr {label} {key} request", counts, {"K1": k1, "K2": 0}, launches)
        m64 = gpr_model("SquaredExponential", tuple(t.cpu().numpy() for t in model.data), torch.float64,
                        {k: v.astype(np.float64) for k, v in read_values(model).items()})
        tol = gram_cond(m64) * EPS32
        post64 = m64.posterior()
        want = {"cached predict_f": post64.predict_f(Xb.double()),
                "cached predict_mean": (post64.predict_mean(Xb.double()),),
                "fused predict_f": m64.predict_f(Xb.double()), "predict_y": m64.predict_y(Xb.double())}
        prior = float(m64.kernel.variance.value)
    log(f"gpr serving {label}: cond(K + noise I) <= {tol / EPS32:.4e}; tolerance cond * eps32 = {tol:.3e}")
    for key, tensors in out.items():
        for what, got, w in zip(("mean", "var"), tensors, want[key]):
            assert got.shape == (B, 1) and bool(torch.isfinite(got).all()), f"gpr {key} {what}"
            scale = float(w.abs().max()) if what == "mean" else prior
            err = float((got.double() - w).abs().max()) / scale
            log(f"gpr serving {label}: {key} {what}: max abs err {err:.3e} of "
                f"{'the f64 max' if what == 'mean' else 'the prior variance'}, tol {tol:.1e}")
            assert err <= tol, f"gpr {label} {key} {what} disagrees with float64"
        if len(tensors) == 2:
            log(f"gpr serving {label}: {key} var: min {float(tensors[1].min()):.3e} (f64 min "
                f"{float(want[key][1].min()):.3e})")
            assert bool((want[key][1] > 0).all()), f"gpr {label} {key}: float64 variance not positive"
    return post, Xb


def time_gpr(models):
    """Phase 10: the GPR objective alone and with its gradient, per N and
    route, by CUDA events around back-to-back calls."""
    from gpflow_tpu_torch.conditionals import inv_solve

    for n, model in models.items():
        with torch.no_grad():
            ms = request_ms(model.training_loss, 5, warmup=1)
        log(f"time: gpr objective N={n}: {ms:.3f} ms")
        for route, flag in TRAIN_ROUTES:
            ms = request_ms(lambda: gpr_value_and_grad(model, flag), 5, warmup=1)
            log(f"time: gpr value and gradient N={n} {route}: {ms:.3f} ms")


def profile_gpr(model, route, flag):
    """Phase 10: device time of one GPR value-and-gradient by kernel."""
    profile_device(lambda: gpr_value_and_grad(model, flag),
                   f"gpr value and gradient N={model.data[0].shape[0]} {route}", top=10)


def time_inverse(model):
    """Phase 10: L^-1 of the GPR's [N, N] Cholesky factor by the blocked
    recursive doubling (``ops.linalg``) against one cuSOLVER/cuBLAS
    triangular solve against the identity, interleaved."""
    from gpflow_tpu_torch.ops import linalg
    from gpflow_tpu_torch.utilities import add_likelihood_noise_cov

    with torch.no_grad():
        X = model.data[0]
        L = linalg.cholesky(add_likelihood_noise_cov(model.kernel(X), model.likelihood, X))
        eye = torch.eye(L.shape[0], device="cuda")
        fns = {"blocked": lambda: linalg._blocked_lower_triangular_inverse(L),
               "solve": lambda: torch.linalg.solve_triangular(L, eye, upper=False)}
        got = {"blocked": [], "solve": []}
        for which in ("solve", "blocked", "blocked", "solve"):
            got[which].append(device_ms(fns[which], 3, warmup=1))
        err = float((fns["blocked"]() - fns["solve"]()).abs().max() / fns["solve"]().abs().max())
    n = L.shape[0]
    log(f"time: triangular inverse N={n}: blocked {min(got['blocked']):.3f} ms "
        f"({2 * n ** 3 / 3 / (min(got['blocked']) * 1e-3) / 1e12:.1f} TFLOP/s of (2/3) N^3), "
        f"solve_triangular(L, I) {min(got['solve']):.3f} ms; runs {got}; max rel diff {err:.2e}")


def make_ng_data():
    """X, Y and Z as ``bench.py:233-238`` makes them, then NG_B new points
    and their labels, drawn after them from the same generator."""
    rng = np.random.RandomState(2)
    X = rng.rand(NG_N, D).astype(np.float32) * 4.0
    w = rng.randn(D, 1).astype(np.float32)
    Y = (np.sin(X @ w) + 0.3 * rng.randn(NG_N, 1) > 0).astype(np.float32)
    Z = X[rng.choice(NG_N, NG_M, replace=False)].copy()
    Xnew = rng.rand(NG_B, D).astype(np.float32) * 4.0
    Ynew = (np.sin(Xnew @ w) + 0.3 * rng.randn(NG_B, 1) > 0).astype(np.float32)
    return X, Y, Z, Xnew, Ynew


def ng_model(kernel, Z, dtype, values=None):
    """The Bernoulli SVGP on the card in ``dtype``: lengthscales 1,
    ``num_data`` = NG_N, whitened full q_sqrt (identity) and q_mu zeros, or
    the constrained ``values`` of ``read_values``."""
    from gpflow_tpu_torch import config, kernels, likelihoods
    from gpflow_tpu_torch.models import SVGP
    from gpflow_tpu_torch.utilities import load_jax_values

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        model = SVGP(kernel=getattr(kernels, kernel)(lengthscales=np.ones(D)), likelihood=likelihoods.Bernoulli(),
                     inducing_variable=Z, num_data=NG_N)
    model = model.to(dtype=dtype)
    if values is not None:
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        load_jax_values(model, {k: v.astype(np_dtype) for k, v in values.items()})
    return model


def ng_values(Z, seed):
    """Values of the Bernoulli SVGP away from its start: q_mu ~ N(0, 0.25),
    q_sqrt with a diagonal in [0.1, 1] and small entries below it."""
    rng = np.random.RandomState(seed)
    q_sqrt = np.tril(rng.randn(1, NG_M, NG_M) * (0.1 / np.sqrt(NG_M)), k=-1)
    q_sqrt[0, np.arange(NG_M), np.arange(NG_M)] = 0.1 + 0.9 * rng.rand(NG_M)
    return {".inducing_variable.Z": Z, ".kernel.lengthscales": np.ones(D), ".kernel.variance": np.asarray(1.0),
            ".q_mu": 0.5 * rng.randn(NG_M, 1), ".q_sqrt": q_sqrt}


def ng_cond(model64):
    """cond(Kuu + jitter I) and cond(S), S = q_sqrt q_sqrt^T (the largest
    over the latent GPs), of a float64 model, from their eigenvalues."""
    from gpflow_tpu_torch.config import default_jitter
    from gpflow_tpu_torch.covariances import Kuu

    with torch.no_grad():
        kuu = torch.linalg.eigvalsh(Kuu(model64.inducing_variable, model64.kernel, jitter=default_jitter()))
        L = model64.q_sqrt.value  # [L, M, M]: the largest cond(S) over the latent GPs
        s = torch.linalg.eigvalsh(L @ L.mT)
    return float(kuu[-1] / kuu[0]), float((s[:, -1] / s[:, 0]).max())


def ng_tolerance(what, model64, steps=0):
    """NG_MULT * cond * eps32 for the larger of the two conditions, plus
    3 * steps * NG_JITTER * cond(S) after ``steps`` natural-gradient steps."""
    c_kuu, c_s = ng_cond(model64)
    rounding, jitter = NG_MULT * max(c_kuu, c_s) * EPS32, 3 * steps * NG_JITTER * c_s
    log(f"{what}: cond(Kuu + jitter I) {c_kuu:.4e}, cond(S) {c_s:.4e}; tolerance {NG_MULT:.0f} * cond * eps32 "
        f"= {rounding:.3e}" + (f" + 3 * {steps} * {NG_JITTER:.0e} * cond(S) = {rounding + jitter:.3e}" if steps else ""))
    return rounding + jitter


def rel_err(got, want):
    """max |got - want| over max |want|, in float64."""
    want = want.double()
    return float((got.double() - want).abs().max()) / max(float(want.abs().max()), 1e-300)


def ng_check_objective(data, Z, launches):
    """Phase 11: the float32 ELBO, its gradient with respect to every
    trainable parameter and the quadrature's variational expectations on one
    batch, under sync debug mode "error", against the same model in float64
    on the card."""
    from gpflow_tpu_torch.utilities import parameter_dict

    X, Y = data
    idx = torch.from_numpy(np.random.RandomState(SEED + 12).randint(0, NG_N, NG_B)).cuda()
    values = ng_values(Z, SEED + 12)
    m32, m64 = ng_model("SquaredExponential", Z, torch.float32, values), \
        ng_model("SquaredExponential", Z, torch.float64, values)
    tol = ng_tolerance("natgrad objective", m64)

    def evaluate(model, batch):
        elbo = model.elbo(batch)
        grads = torch.autograd.grad(elbo, [p.unconstrained for p in model.trainable_parameters])
        with torch.no_grad():
            fmu, fvar = model.predict_f(batch[0])
            ve = model.likelihood.variational_expectations(batch[0], fmu, fvar, batch[1])
        return elbo.detach(), grads, ve

    batch = (X.index_select(0, idx), Y.index_select(0, idx))
    torch.cuda.set_sync_debug_mode("error")
    try:
        (elbo32, grads32, ve32), counts = counted(lambda: evaluate(m32, batch))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    expect_launches("natgrad objective: ELBO, gradient and variational expectations", counts, {"K1": 4, "K2": 0},
                    launches)
    elbo64, grads64, ve64 = evaluate(m64, tuple(t.double() for t in batch))
    err = abs(float(elbo32) - float(elbo64)) / abs(float(elbo64))
    log(f"natgrad objective: ELBO {float(elbo32):.6e} (f64 {float(elbo64):.6e}), rel err {err:.3e}, tol {tol:.1e}")
    assert bool(torch.isfinite(elbo32)) and err <= tol, "the Bernoulli ELBO disagrees with float64"
    names = [path for path, p in parameter_dict(m32).items() if p.trainable]
    for name, got, want in zip(names, grads32, grads64):
        gerr = rel_err(got, want)
        log(f"natgrad objective: gradient {name}: rel err {gerr:.3e} of the f64 max {float(want.abs().max()):.4e}, "
            f"tol {tol:.1e}")
        assert bool(torch.isfinite(got).all()) and gerr <= tol, f"the ELBO's gradient {name} disagrees with float64"
    verr = rel_err(ve32, ve64)
    log(f"natgrad objective: variational expectations [{ve32.shape[0]}] through "
        f"{m32.likelihood.quadrature.n_gh} Gauss-Hermite points: rel err {verr:.3e}, tol {tol:.1e}")
    assert ve32.shape == (NG_B,) and bool(torch.isfinite(ve32).all()) and verr <= tol, \
        "the variational expectations disagree with float64"


def ng_train(kernel, fused, steps, data, Z, launches):
    """Phase 12: ``run_steps_sampled`` of the natural-gradient trainer under
    sync debug mode "error"; losses finite and falling, some step accepted,
    launch counts exact. Returns the trainer."""
    from gpflow_tpu_torch.parallel import DataParallelTrainer, adam

    mode = "fused" if fused else "sequential"
    trainer = DataParallelTrainer(ng_model(kernel, Z, torch.float32), adam(1e-2), natgrad_gamma=NG_GAMMA,
                                  natgrad_fused=fused)
    trainer.stage_data(data)
    generator = torch.Generator(device="cuda").manual_seed(SEED + 20)
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses, counts = counted(lambda: trainer.run_steps_sampled(steps, NG_B, generator=generator))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses = losses.cpu()
    rejected = trainer.natgrad_rejections
    last = float(losses[-10:].mean())
    log(f"natgrad train {kernel} {mode}: {steps} steps at B={NG_B}, loss {float(losses[0]):.6e} -> {last:.6e} "
        f"(mean of the last 10); natgrad_rejections {rejected} of {steps}")
    # sequential: the natural-gradient pass and the optimizer's pass each
    # build Kuu and Kuf; Matern52's backward runs K2 for both, once a step
    # (the natural-gradient pass differentiates q(u) alone)
    per_step = {"K1": 2 if fused else 4, "K2": 2 if kernel == "Matern52" else 0}
    expect_launches(f"natgrad train {kernel} {mode}", counts, {k: v * steps for k, v in per_step.items()}, launches)
    assert losses.shape == (steps,) and bool(torch.isfinite(losses).all()), f"natgrad {mode}: non-finite loss"
    assert last < float(losses[0]), f"natgrad {mode}: the ELBO did not rise"
    assert rejected < steps, f"natgrad {mode}: every natural-gradient step was rejected"
    return trainer


def ng_compare_f64(fused, data, Z):
    """Phase 12, last part: the first NG_F64_STEPS steps in float32 against
    float64 on the card, from the same values on the same batches. The loss,
    q_mu and q_sqrt within the cond-based tolerance; the hyperparameters and
    Z, which Adam moves, as in the Gaussian training slice."""
    from gpflow_tpu_torch.parallel import DataParallelTrainer, adam
    from gpflow_tpu_torch.utilities import read_values

    mode = "fused" if fused else "sequential"
    X, Y = data
    idx = torch.from_numpy(np.random.RandomState(SEED + 13).randint(0, NG_N, (NG_F64_STEPS, NG_B))).cuda()
    batches = (X[idx], Y[idx])
    models = {dtype: ng_model("SquaredExponential", Z, dtype) for dtype in (torch.float32, torch.float64)}
    start = read_values(models[torch.float32])
    losses = {dtype: DataParallelTrainer(m, adam(1e-2), natgrad_gamma=NG_GAMMA, natgrad_fused=fused).run_steps(
        tuple(t.to(dtype) for t in batches)).double() for dtype, m in models.items()}
    tol = ng_tolerance(f"natgrad f64 {mode}", models[torch.float64], NG_F64_STEPS)
    err = float(((losses[torch.float32] - losses[torch.float64]) / losses[torch.float64]).abs().max())
    log(f"natgrad f64 {mode}: losses card f32 {losses[torch.float32].tolist()} f64 "
        f"{losses[torch.float64].tolist()}: max rel err {err:.3e}, tol {tol:.1e}")
    assert err <= tol, f"natgrad {mode}: float32 losses disagree with float64"
    got, want = read_values(models[torch.float32]), read_values(models[torch.float64])
    for path in sorted(want):
        diff = np.abs(got[path].astype(np.float64) - want[path])
        if path in (".q_mu", ".q_sqrt"):
            rel = float(diff.max() / np.abs(want[path]).max())
            log(f"natgrad f64 {mode}: {path}: max abs diff {diff.max():.3e}, rel {rel:.3e}, tol {tol:.1e}")
            assert rel <= tol, f"natgrad {mode}: {path} disagrees with float64"
        elif path.startswith(".kernel"):
            log(f"natgrad f64 {mode}: {path}: max abs diff {diff.max():.3e}, tol {F64_HYPER_ATOL:.0e}")
            assert diff.max() <= F64_HYPER_ATOL, f"natgrad {mode}: {path} disagrees with float64"
        else:
            moved = want[path] != start[path]
            share = float(np.mean(diff[moved] > F64_ELEMENT_ATOL)) if moved.any() else 0.0
            log(f"natgrad f64 {mode}: {path}: {int(moved.sum())} elements moved, share off by > "
                f"{F64_ELEMENT_ATOL:.0e}: {share:.3e} (tol {F64_ELEMENT_SHARE:.0e}); max abs diff {diff.max():.3e}")
            assert share <= F64_ELEMENT_SHARE, f"natgrad {mode}: {path} disagrees with float64"


def ng_minimize(data, Z, launches):
    """Phase 13: the JAX package's own loop, ``NaturalGradient.minimize`` on
    (q_mu, q_sqrt) then one Adam step on the rest, each on the next batch of
    a ``training_loss_closure`` over an iterator, under sync debug mode
    "error"; the loss on a fixed batch must fall."""
    from gpflow_tpu_torch.optimizers import NaturalGradient

    X, Y = data
    model = ng_model("SquaredExponential", Z, torch.float32)
    hypers = [p.unconstrained for p in model.trainable_parameters if p is not model.q_mu and p is not model.q_sqrt]
    adam_opt = torch.optim.Adam(hypers, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    natgrad_opt = NaturalGradient(gamma=NG_GAMMA)
    # the batches drawn: the traced step's first call draws twice, as the JAX package's (a trace
    # that finds the Parameters the loss reads, then the traced one), every later call once, and
    # each Adam step once; the last batch is the fixed one
    idx = torch.randint(0, NG_N, (2 * NG_MINIMIZE_ITERS + 2, NG_B), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 14))
    fixed = (X[idx[-1]], Y[idx[-1]])
    loss_fn = model.training_loss_closure(iter([(X[i], Y[i]) for i in idx[:-1]]))

    def loop():
        for _ in range(NG_MINIMIZE_ITERS):
            natgrad_opt.minimize(loss_fn, [(model.q_mu, model.q_sqrt)])
            for p, g in zip(hypers, torch.autograd.grad(loss_fn(), hypers)):
                p.grad = g
            adam_opt.step()

    with torch.no_grad():
        before = float(model.training_loss(fixed))
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, counts = counted(loop)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with torch.no_grad():
        after = float(model.training_loss(fixed))
    log(f"natgrad minimize: {NG_MINIMIZE_ITERS} iterations of NaturalGradient.minimize and one Adam step: loss on a "
        f"fixed batch {before:.6e} -> {after:.6e}")
    expect_launches("natgrad minimize + Adam", counts, {"K1": 4 * NG_MINIMIZE_ITERS, "K2": 0}, launches)
    assert np.isfinite(after) and after < before, "NaturalGradient.minimize did not lower the loss"


def ng_serve(model, Xnew, Ynew, launches):
    """Phase 14: requests of NG_B new points to the trained classifier,
    cached ``predict_f``, fused ``predict_y`` (the probit closed form) and
    ``predict_log_density``, with exact launch counts, against float64 on
    the card. Probabilities lie within the squashed probit's limits, 1e-3
    and 1 - 1e-3. Returns the posterior and the requests."""
    from gpflow_tpu_torch.utilities import read_values

    Xb, Yb = torch.from_numpy(Xnew).cuda(), torch.from_numpy(Ynew).cuda()
    with torch.no_grad():
        post, counts = counted(model.posterior)
        expect_launches("natgrad classifier posterior", counts, {"K1": 1, "K2": 0}, launches)
        out = {}
        for key, fn, k1 in (("cached predict_f", lambda: post.predict_f(Xb), 1),
                            ("predict_y", lambda: model.predict_y(Xb), 2),
                            ("predict_log_density", lambda: (model.predict_log_density((Xb, Yb)),), 2)):
            out[key], counts = counted(fn)
            expect_launches(f"natgrad classifier {key} request", counts, {"K1": k1, "K2": 0}, launches)
        m64 = ng_model("SquaredExponential", np.zeros((NG_M, D)), torch.float64, read_values(model))
        tol = ng_tolerance("natgrad classifier", m64)
        want = {"cached predict_f": m64.posterior().predict_f(Xb.double()), "predict_y": m64.predict_y(Xb.double()),
                "predict_log_density": (m64.predict_log_density((Xb.double(), Yb.double())),)}
    for key, tensors in out.items():
        for what, got, w in zip(("mean", "var"), tensors, want[key]):
            assert got.shape == w.shape and got.dtype == torch.float32 and bool(torch.isfinite(got).all()), \
                f"natgrad classifier {key} {what}"
            err = rel_err(got, w)
            log(f"natgrad classifier: {key} {what if len(tensors) == 2 else ''}: rel err {err:.3e} of the f64 max, "
                f"tol {tol:.1e}")
            assert err <= tol, f"natgrad classifier {key} {what} disagrees with float64"
    p, v = out["predict_y"]
    fvar = out["cached predict_f"][1]
    # the squash's limits, 1e-3 and 1 - 1e-3, as float32 evaluates them:
    # float32's erf reaches -1 and 1 exactly beyond |x| ~ 3.9, and there
    # inv_probit gives the limit itself
    from gpflow_tpu_torch.likelihoods import inv_probit

    lo, hi = inv_probit(torch.tensor([-np.inf, np.inf], device="cuda")).tolist()
    assert 0 < lo and hi < 1 and bool(((p >= lo) & (p <= hi)).all()), \
        f"a probability outside [{lo}, {hi}], the squashed probit's limits"
    assert bool((fvar > 0).all()) and bool((v > 0).all()), "natgrad classifier: a variance is not positive"
    accuracy = float(((p > 0.5).float() == Yb).float().mean())
    log(f"natgrad classifier: probabilities in [{float(p.min()):.4e}, {float(p.max()):.4e}]; held-out accuracy "
        f"{accuracy:.4f}, mean log density {float(out['predict_log_density'][0].mean()):.4f}")
    return post, Xb, Yb


def make_sparse_data(n=SP_N, m=SP_M, seed=1):
    """(X, Y), Z as ``bench.py:379-384`` makes them, then B new points and
    their targets, drawn after them from the same generator."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, D).astype(np.float32)
    Y = np.sin(X[:, :1] * 3).astype(np.float32) + 0.1 * rng.randn(n, 1).astype(np.float32)
    Z = X[rng.permutation(n)[:m]].copy()
    Xnew = rng.rand(B, D).astype(np.float32)
    Ynew = np.sin(Xnew[:, :1] * 3).astype(np.float32) + 0.1 * rng.randn(B, 1).astype(np.float32)
    return (X, Y), Z, Xnew, Ynew


def sparse_model(cls, data, Z, dtype, kernel="SquaredExponential", values=None, **kwargs):
    """An SGPR, GPRFITC or CGLB on the card in ``dtype``: lengthscales 1,
    noise 0.1, or the constrained ``values`` of ``read_values`` (those of
    its own parameters)."""
    from gpflow_tpu_torch import config, kernels, models
    from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        model = getattr(models, cls)(data, kernel=getattr(kernels, kernel)(lengthscales=[1.0] * D),
                                     inducing_variable=Z, noise_variance=SP_NOISE, **kwargs).to(dtype=dtype)
    if values is not None:
        paths = parameter_dict(model)
        load_jax_values(model, {k: v for k, v in values.items() if k in paths})
    return model


def log_conditions(what, model64):
    """Logs cond(Kuu + jitter I) and cond(B) of a float64 SGPR, GPRFITC or
    CGLB, from eigenvalues; B is GPRFITC's own I + V nu^-1 V^T."""
    from gpflow_tpu_torch.config import default_jitter
    from gpflow_tpu_torch.covariances import Kuu

    with torch.no_grad():
        kuu = torch.linalg.eigvalsh(Kuu(model64.inducing_variable, model64.kernel, jitter=default_jitter()))
        if hasattr(model64, "common_terms"):
            L = model64.common_terms()[3]
            b = torch.linalg.eigvalsh(L @ L.mT)
        else:
            b = torch.linalg.eigvalsh(model64._common_calculation().B)
    log(f"{what}: cond(Kuu + jitter I) {float(kuu[-1] / kuu[0]):.4e}, cond(B) {float(b[-1] / b[0]):.4e}")


def bf16(a):
    """``a`` (an array or a tensor) rounded to bfloat16 and back to float32:
    what K1 reads on a path that hands it bf16 inputs (the control's)."""
    return torch.as_tensor(a).to(torch.bfloat16).to(torch.float32)


def run_control(fn):
    """``fn()`` with TF32 tensor-core matmuls, as a path built for
    throughput would run them: the control's outputs. The exact-fp32 tier
    is restored after."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def bf16_values(values):
    """``read_values`` output with every set of inducing points rounded as
    ``bf16``."""
    return {k: bf16(v).numpy() if k.endswith(".Z") else v for k, v in values.items()}


def judge(what, sound, control=None):
    """``sound`` and ``control``: {output: (error, limit)}. Every sound error
    must lie within its limit; the control, where given, must break at least
    one limit (a NaN breaks it). Every reading is logged before a failure
    is raised."""
    broken, failed = [], []
    for key, (err, limit) in sound.items():
        cerr = control[key][0] if control else None
        log(f"{what}: {key}: rel err {err:.3e}, tol {limit:.1e}"
            + ("" if cerr is None else f"; lower-tier control {cerr:.3e}"))
        if not err <= limit:
            failed.append(key)
        if cerr is not None and not cerr <= limit:
            broken.append(key)
    assert not failed, f"{what}: {failed} disagree with float64"
    if control:
        log(f"{what}: the lower-tier control breaks {len(broken)} of {len(sound)} limits {broken}")
        assert broken, f"{what}: the check cannot tell float32 from the lower tier"


def sparse_value_and_grad(model, objective):
    """``objective(model)`` and its gradient with respect to the unconstrained
    tensor of every trainable parameter but CGLB's v, keyed by path."""
    from gpflow_tpu_torch.utilities import parameter_dict

    params = {path: p for path, p in parameter_dict(model).items() if p.trainable and path != "._v"}
    value = objective(model)
    grads = torch.autograd.grad(value, [p.unconstrained for p in params.values()])
    return value.detach(), dict(zip(params, grads))


def value_and_grad_errors(got, want):
    """{output: (error, limit)} of a ``sparse_value_and_grad`` result against
    float64, each relative to the float64 value or largest gradient entry."""
    (value, grads), (value64, grads64) = got, want
    out = {"value": (abs(float(value) - float(value64)) / abs(float(value64)), SP_RTOL["value"])}
    for path, want_g in grads64.items():
        cls = "gradient Z" if path == ".inducing_variable.Z" else "gradient"
        out[f"gradient {path}"] = (rel_err(grads[path], want_g), SP_RTOL[cls])
    return out


def sgpr_check(data, Z, launches, tag=""):
    """Phase 13: the SGPR ELBO, the Titsias upper bound and the GPRFITC
    objective, each with its gradient, under sync debug mode "error",
    against the same models in float64 on the card, beside the lower-tier
    control; elbo <= upper_bound. Returns the float32 SGPR."""
    X, Y = data
    objectives = (("SGPR elbo", "SGPR", lambda m: m.training_loss()),
                  ("SGPR upper_bound", "SGPR", lambda m: -m.upper_bound()),
                  ("GPRFITC objective", "GPRFITC", lambda m: m.training_loss()))
    models32, controls = {}, {}
    for what, cls, objective in objectives:
        what += tag
        m32 = models32.setdefault(cls, sparse_model(cls, data, Z, torch.float32))
        control = controls.setdefault(cls, sparse_model(cls, (bf16(X), Y), bf16(Z), torch.float32))
        m64 = sparse_model(cls, data, Z, torch.float64)
        log_conditions(f"sparse {what}", m64)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, counts = counted(lambda: sparse_value_and_grad(m32, objective))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        # Kuu and Kuf; rbf takes its backward from the saved K
        expect_launches(f"sparse {what} value and gradient", counts, {"K1": 2, "K2": 0}, launches)
        want = sparse_value_and_grad(m64, objective)
        judge(f"sparse {what}", value_and_grad_errors(got, want),
              value_and_grad_errors(run_control(lambda: sparse_value_and_grad(control, objective)), want))
    m32 = models32["SGPR"]
    with torch.no_grad():
        elbo, upper = float(m32.elbo()), float(m32.upper_bound())
    log(f"sparse SGPR{tag}: elbo {elbo:.6e} <= upper_bound {upper:.6e}")
    assert elbo <= upper, "the SGPR ELBO exceeds the Titsias upper bound"
    return m32


def sgpr_train(model, launches):
    """Phase 13: ``Scipy().minimize`` of the float32 SGPR, SP_SGPR_MAXITER
    iterations; the objective must fall. Returns the seconds it took."""
    from gpflow_tpu_torch.optimizers import Scipy

    with torch.no_grad():
        loss0 = float(model.training_loss())
    t0 = time.perf_counter()
    res, counts = counted(lambda: Scipy().minimize(
        model.training_loss_closure(), model.trainable_variables,
        options={"maxiter": SP_SGPR_MAXITER}, nonfinite_penalty=SP_PENALTY))
    seconds = time.perf_counter() - t0
    log(f"sparse SGPR lbfgs: loss {loss0:.6e} -> {float(res.fun):.6e}; nit {res.nit}, nfev {res.nfev}, "
        f"non-finite evaluations {res.n_nonfinite_evals}, status {res.status} ({res.message})")
    log(f"time: sparse SGPR lbfgs: {seconds:.3f} s, {seconds / res.nfev:.4f} s per evaluation")
    assert np.isfinite(res.fun) and float(res.fun) < loss0, "L-BFGS did not lower the SGPR objective"
    expect_launches("sparse SGPR lbfgs", counts, {"K1": 2 * int(res.nfev), "K2": 0}, launches)
    return seconds


def request_errors(what, out, want, prior, shifts=None):
    """{output: (error, limit)} of each output of ``out`` against ``want``
    (float64), relative to the largest float64 entry (a variance to the
    prior variance), the limit SP_RTOL's plus ``shifts[key]`` where given.
    Each output must have the float64 shape; a non-finite one gives a NaN
    or infinite error, which breaks any limit."""
    errs = {}
    for key, tensors in out.items():
        kinds = ("mean", "var") if len(tensors) == 2 else ("log density" if "log_density" in key else "mean",)
        for kind, got, w in zip(kinds, tensors, want[key]):
            assert got.shape == w.shape and got.dtype == torch.float32, f"{what} {key} {kind}"
            scale = prior if kind == "var" else max(float(w.abs().max()), 1e-300)
            errs[f"{key} {kind}" if len(tensors) == 2 else key] = (float((got.double() - w).abs().max()) / scale,
                                     SP_RTOL[kind] + (shifts or {}).get(key, 0.0))
        if len(tensors) == 2:
            assert bool((want[key][1] > 0).all()), f"{what} {key}: float64 variance not positive"
    return errs


def sgpr_serve(model, Xnew, launches):
    """Phase 13: requests of B new points to the trained SGPR through
    ``posterior()`` (the TENSOR cache) with ``predict_f`` and
    ``predict_mean``, and the fused ``predict_f`` and ``predict_y``, with
    exact launch counts, against float64 on the card, beside the lower-tier
    control. Returns the posterior and the request."""
    from gpflow_tpu_torch.utilities import read_values

    def requests(m, post, x):
        return {"cached predict_f": lambda: post.predict_f(x), "cached predict_mean": lambda: (post.predict_mean(x),),
                "fused predict_f": lambda: m.predict_f(x), "predict_y": lambda: m.predict_y(x)}

    Xb = torch.from_numpy(Xnew).cuda()
    values = read_values(model)
    X, Y = model.data
    with torch.no_grad():
        post, counts = counted(model.posterior)
        expect_launches("sparse SGPR posterior", counts, {"K1": 2, "K2": 0}, launches)
        out = {}
        for (key, fn), k1 in zip(requests(model, post, Xb).items(), (1, 1, 3, 3)):
            out[key], counts = counted(fn)
            expect_launches(f"sparse SGPR {key} request", counts, {"K1": k1, "K2": 0}, launches)
        m64 = sparse_model("SGPR", model.data, np.zeros((SP_M, D)), torch.float64, values=values)
        log_conditions("sparse SGPR serving", m64)
        want = {key: fn() for key, fn in requests(m64, m64.posterior(), Xb.double()).items()}
        mc = sparse_model("SGPR", (bf16(X), Y), np.zeros((SP_M, D)), torch.float32, values=bf16_values(values))
        control = run_control(lambda: {key: fn() for key, fn in requests(mc, mc.posterior(), bf16(Xb)).items()})
        prior = float(m64.kernel.variance.value)
    judge("sparse SGPR serving", request_errors("sparse SGPR serving", out, want, prior),
          request_errors("sparse SGPR serving control", control, want, prior))
    return post, Xb


def cg_matvecs(model, iters):
    """K-matvecs of one CG run of ``iters`` iterations: the initial residual,
    one per iteration and one more at each restart."""
    return 1 + iters + iters // model._restart_cg_iters


def n_chunks(model):
    return -(-model.data[0].shape[0] // model._matrix_free_chunk)


def cglb_dense_vs_matrix_free(launches):
    """Phase 14: the dense CGLB against the matrix-free one at (N, M, chunk)
    = SP_SMALL, float32, at one fixed v (the dense float32 CG's, with
    ``v_grad_optimization=True``), on the data of each of SP_SMALL_SEEDS:
    the value and the gradient within N * eps32, the gradient in Z within
    SP_DENSE_MF_Z_RTOL."""
    n, m, chunk = SP_SMALL
    tol = n * EPS32
    for seed in SP_SMALL_SEEDS:
        data, Z, _, _ = make_sparse_data(n, m, seed=seed)
        cg = sparse_model("CGLB", data, Z, torch.float32)
        with torch.no_grad():
            cg.training_loss()
        v = cg.aux_vec.numpy()
        got = {}
        for mode, kwargs, k1 in (("dense", {}, 3), ("matrix-free", {"matrix_free_chunk": chunk}, 2 + 2 * (n // chunk))):
            model = sparse_model("CGLB", data, Z, torch.float32, v_grad_optimization=True, **kwargs)
            model.aux_vec.assign(v)
            got[mode], counts = counted(lambda: sparse_value_and_grad(model, lambda mm: mm.training_loss()))
            # dense: Kuu, Kuf and K(X) once; matrix-free: Kuu, Kuf and each
            # block forward and again in the backward
            expect_launches(f"cglb {mode} at N={n}, seed {seed}, value and gradient", counts, {"K1": k1, "K2": 0},
                            launches)
        (vd, gd), (vm, gm) = got["dense"], got["matrix-free"]
        diffs = {"value": (abs(float(vd) - float(vm)) / abs(float(vd)), tol)}
        for path in gd:
            diffs[f"gradient {path}"] = (rel_err(gm[path], gd[path]),
                                         SP_DENSE_MF_Z_RTOL if path == ".inducing_variable.Z" else tol)
        log(f"cglb dense vs matrix-free N={n}, M={m}, chunk {chunk}, seed {seed}, after {cg.cg_iterations} CG "
            f"iterations: value {float(vd):.6e} / {float(vm):.6e}")
        judge(f"cglb dense vs matrix-free, seed {seed}", diffs)


def cglb_objective(model, launches, what):
    """Phase 15: ``training_loss()`` of the matrix-free CGLB with its CG, with
    exact launch counts; returns the loss and the CG's iterations."""
    with torch.no_grad():
        loss, counts = counted(model.training_loss)
    it = model.cg_iterations
    # Kuu and Kuf, then every block for each CG matvec and once more for the
    # bound's K v
    expected = {"K1": 2 + n_chunks(model) * (cg_matvecs(model, it) + 1), "K2": 0}
    expect_launches(f"cglb {what}: {it} CG iterations", counts, expected, launches)
    assert bool(torch.isfinite(loss)), f"cglb {what}: non-finite objective"
    return float(loss), it


def cglb_v64(data, Z):
    """The float64 matrix-free CGLB's v from v = 0 on the card: the fixed v
    of ``cglb_fixed_v``."""
    m64 = sparse_model("CGLB", data, Z, torch.float64, matrix_free_chunk=SP_CHUNK)
    with torch.no_grad():
        loss64 = float(m64.training_loss())
    log(f"cglb objective in float64 from v = 0: {loss64:.6e} after {m64.cg_iterations} CG iterations")
    return m64.aux_vec.value.detach()


def cglb_fixed_v(kernel, data, Z, v64, launches, tag=""):
    """Phase 15: the matrix-free CGLB's value and gradient in float32 under
    sync debug mode "error" against float64 on the card, both at v = v64,
    beside the lower-tier control at the same v."""
    X, Y = data
    models = {}
    for key, dtype, d, z in (("f32", torch.float32, data, Z), ("f64", torch.float64, data, Z),
                             ("control", torch.float32, (bf16(X), Y), bf16(Z))):
        models[key] = sparse_model("CGLB", d, z, dtype, kernel=kernel, matrix_free_chunk=SP_CHUNK,
                                   v_grad_optimization=True)
        models[key].aux_vec.assign(v64.to(dtype))
    what = f"cglb {kernel} at a fixed v{tag}"
    log_conditions(what, models["f64"])
    objective = lambda m: m.training_loss()  # noqa: E731
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, counts = counted(lambda: sparse_value_and_grad(models["f32"], objective))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    nc = n_chunks(models["f32"])
    # forward: Kuu, Kuf and each block; backward: each block again, and for
    # Matern52 K2 for Kuu, Kuf and each rebuilt block
    expected = {"K1": 2 + 2 * nc, "K2": 2 + nc if kernel == "Matern52" else 0}
    expect_launches(f"{what}: value and gradient", counts, expected, launches)
    want = sparse_value_and_grad(models["f64"], objective)
    judge(what, value_and_grad_errors(got, want),
          value_and_grad_errors(run_control(lambda: sparse_value_and_grad(models["control"], objective)), want))


def cglb_peak_memory(model, launches):
    """Phase 15: the peak device memory of one matrix-free value and
    gradient (its CG included) above what was allocated before, which must
    stay below N^2 * 4 bytes: no [N, N] matrix is formed."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, counts = counted(lambda: sparse_value_and_grad(model, lambda m: m.training_loss()))
    peak = torch.cuda.max_memory_allocated() - base
    it = model.cg_iterations
    expected = {"K1": 2 + n_chunks(model) * (cg_matvecs(model, it) + 2), "K2": 0}
    expect_launches(f"cglb value and gradient ({it} CG iterations)", counts, expected, launches)
    limit = SP_N ** 2 * 4
    log(f"cglb value and gradient: peak memory {peak / 2 ** 30:.3f} GiB above the {base / 2 ** 30:.3f} GiB "
        f"allocated before ({torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB in all); limit N^2 * 4 bytes "
        f"= {limit / 2 ** 30:.0f} GiB")
    assert peak < limit, "the matrix-free value and gradient used the memory of an [N, N] matrix"


def cglb_sandwich(model, data, Z, what):
    """Phase 15: -training_loss() <= upper_bound() of the CGLB, with the ELBO
    of an SGPR at the same values printed beside it."""
    from gpflow_tpu_torch.utilities import read_values

    with torch.no_grad():
        bound, upper = -float(model.training_loss()), float(model.upper_bound())
        elbo = float(sparse_model("SGPR", data, Z, torch.float32, values=read_values(model)).elbo())
    log(f"cglb sandwich {what}: CGLB bound {bound:.6e} <= upper_bound {upper:.6e}; SGPR ELBO {elbo:.6e} "
        f"({model.cg_iterations} CG iterations)")
    assert np.isfinite(bound) and bound <= upper, f"cglb {what}: the bound exceeds the Titsias upper bound"


def cglb_train(model, loss0, launches):
    """Phase 15: ``Scipy().minimize`` of the matrix-free CGLB's traced
    closure, SP_CGLB_MAXITER iterations with ``nonfinite_penalty``, as
    ``bench.py:405-417`` runs it; it must improve on the objective from
    v = 0. Every evaluation replays one trace, whose CG starts from the
    ``aux_vec`` of the start (a replay writes no v back, as the JAX package
    under ``jit``); its iterations are read from ``cg_iterations`` after each
    evaluation. Returns the seconds per evaluation and the CG iterations of
    each evaluation."""
    from gpflow_tpu_torch.optimizers import Scipy

    iters = []

    class CountingScipy(Scipy):
        def eval_func(self, *args, **kwargs):
            evaluate = super().eval_func(*args, **kwargs)

            def counted_evaluation(x):
                out = evaluate(x)
                iters.append(model.cg_iterations)
                return out

            return counted_evaluation

    opt = CountingScipy()
    t0 = time.perf_counter()
    res, counts = counted(lambda: opt.minimize(model.training_loss_closure(), model.trainable_variables,
                                               options={"maxiter": SP_CGLB_MAXITER}, nonfinite_penalty=SP_PENALTY))
    seconds = time.perf_counter() - t0
    traces = next(iter(opt.compile_cache.values()))[0].traced.trace_count
    assert traces == 1 and len(iters) == res.nfev, f"cglb lbfgs: {traces} traces, {len(iters)} evaluations"
    log(f"cglb lbfgs: loss {loss0:.6e} (from v = 0) -> {float(res.fun):.6e}; nit {res.nit}, nfev {res.nfev}, "
        f"non-finite evaluations {res.n_nonfinite_evals}, status {res.status} ({res.message}); CG iterations "
        f"per evaluation {iters}")
    log(f"time: cglb lbfgs: {seconds:.3f} s, {seconds / res.nfev:.4f} s per evaluation (cglb_mf_lbfgs_s_per_eval_n32k)")
    assert np.isfinite(res.fun) and float(res.fun) < loss0, "CGLB L-BFGS failed to improve the bound"
    nc = n_chunks(model)
    expected = {"K1": sum(2 + nc * (cg_matvecs(model, it) + 2) for it in iters), "K2": 0}
    expect_launches("cglb lbfgs", counts, expected, launches)
    return seconds / res.nfev, iters


def cglb_adversarial(data, Z, launches):
    """Phase 15: in float32 at bench width, v = s * 1 for each s of
    SP_ADVERSARIAL gives a finite bound <= upper_bound (the one-sided clamps
    of ``quad_term``), and a huge v a very loose one."""
    model = sparse_model("CGLB", data, Z, torch.float32, matrix_free_chunk=SP_CHUNK, v_grad_optimization=True)
    with torch.no_grad():
        upper = float(model.upper_bound())
        bounds = []
        for s in SP_ADVERSARIAL:
            model.aux_vec.assign(torch.full_like(model.aux_vec.value, s))
            bound, counts = counted(lambda: -model.training_loss())
            expect_launches(f"cglb adversarial v = {s:g}", counts, {"K1": 2 + n_chunks(model), "K2": 0}, launches)
            bounds.append(float(bound))
    log(f"cglb adversarial v = s * 1 for s in {SP_ADVERSARIAL}: bounds {bounds} <= upper_bound {upper:.6e}")
    assert all(np.isfinite(b) and b <= upper + 1e-6 * abs(upper) for b in bounds), \
        "an adversarial v inflated the CGLB bound"
    assert bounds[2] < -1e3 and bounds[3] < -1e3, "a huge v did not loosen the bound"


def cglb_serve(model, Xnew, Ynew, launches):
    """Phase 15: requests of B new points to the trained matrix-free CGLB,
    ``predict_f``, ``predict_y`` and ``predict_log_density``, against the
    same model in float64 from the same v: exactly at that v
    (``cg_tolerance=None``), beside the lower-tier control, and after the CG
    to ``cg_tolerance=1e-3``, where each side's CG may stop at another
    iteration: there each limit adds twice the float64 move of the output
    between the two. Launch counts exact. Returns the requests."""
    from gpflow_tpu_torch.utilities import read_values

    def requests(m, x, y, cg_tol):
        return {"predict_f": lambda: m.predict_f(x, cg_tolerance=cg_tol),
                "predict_y": lambda: m.predict_y(x, cg_tolerance=cg_tol),
                "predict_log_density": lambda: (m.predict_log_density((x, y), cg_tolerance=cg_tol),)}

    Xb, Yb = torch.from_numpy(Xnew).cuda(), torch.from_numpy(Ynew).cuda()
    nc = n_chunks(model)
    values = read_values(model)
    X, Y = model.data
    m64 = sparse_model("CGLB", model.data, np.zeros((SP_M, D)), torch.float64, values=values,
                       matrix_free_chunk=SP_CHUNK)
    mc = sparse_model("CGLB", (bf16(X), Y), np.zeros((SP_M, D)), torch.float32, values=bf16_values(values),
                      matrix_free_chunk=SP_CHUNK)
    log_conditions("cglb serving", m64)
    with torch.no_grad():
        prior = float(m64.kernel.variance.value)
        outs, wants = {}, {}
        for cg_tol in (None, SP_PREDICT_CG_TOL):
            out = {}
            for key, fn in requests(model, Xb, Yb, cg_tol).items():
                out[key], counts = counted(fn)
                it = 0 if cg_tol is None else model.cg_iterations
                # K(Xnew, X), Kuu, Kuf, K(Z, Xnew), the CG's matvecs and the residual's
                k1 = 4 + nc * ((0 if cg_tol is None else cg_matvecs(model, it)) + 1)
                expect_launches(f"cglb {key} request (cg_tolerance {cg_tol}, {it} CG iterations)", counts,
                                {"K1": k1, "K2": 0}, launches)
            outs[cg_tol] = out
            wants[cg_tol] = {key: fn() for key, fn in requests(m64, Xb.double(), Yb.double(), cg_tol).items()}
        control = run_control(lambda: {key: fn() for key, fn in requests(mc, bf16(Xb), Yb, None).items()})
    judge("cglb serving at the same v", request_errors("cglb serving", outs[None], wants[None], prior),
          request_errors("cglb serving control", control, wants[None], prior))
    shifts = {key: 2 * max(rel_err(a, b) for a, b in zip(wants[SP_PREDICT_CG_TOL][key], wants[None][key]))
              for key in wants[None]}
    log(f"cglb serving: twice the float64 outputs' move from the CG to {SP_PREDICT_CG_TOL:g}: {shifts}")
    judge(f"cglb serving after the CG to {SP_PREDICT_CG_TOL:g}",
          request_errors("cglb serving", outs[SP_PREDICT_CG_TOL], wants[SP_PREDICT_CG_TOL], prior, shifts))
    mean, var = outs[SP_PREDICT_CG_TOL]["predict_f"]
    assert bool((var > 0).all()), "cglb serving: a predictive variance is not positive"
    rmse = float(torch.sqrt(torch.mean(torch.square(mean - Yb))))
    log(f"cglb serving: held-out RMSE {rmse:.4f}, mean log density "
        f"{float(outs[SP_PREDICT_CG_TOL]['predict_log_density'][0].mean()):.4f}")
    return Xb, Yb


def sparse_timings(sgpr, cglb, Xb, Yb):
    """Phase 16: the CGLB objective from v = 0 (cglb_mf_obj_ms_n32k, as
    ``bench.py:396-403`` times it: under ``jit`` there v stays at its
    start) and warm-started, ms per CG iteration, the SGPR objective and
    its value and gradient, CGLB requests, a profile of one matrix-free
    value and gradient, and K1 and K2 at the path's new shapes."""
    from gpflow_tpu_torch.models import NystromPreconditioner, cglb_conjugate_gradient

    zeros = torch.zeros_like(cglb.aux_vec.value)
    with torch.no_grad():
        ms, iters = [], []
        cglb.aux_vec.assign(zeros)
        cglb.training_loss()  # warm-up, as bench.py's compiling call
        for _ in range(SP_OBJ_CALLS):
            cglb.aux_vec.assign(zeros)
            ms.append(request_ms(cglb.training_loss, 1, warmup=0))
            iters.append(cglb.cg_iterations)
        log(f"time: cglb objective from v = 0 at N={SP_N}, M={SP_M}, chunk {SP_CHUNK}: {np.mean(ms):.3f} ms "
            f"(cglb_mf_obj_ms_n32k; calls {ms}, CG iterations {iters})")
        warm = request_ms(cglb.training_loss, SP_OBJ_CALLS, warmup=1)
        log(f"time: cglb objective warm-started: {warm:.3f} ms ({cglb.cg_iterations} CG iterations)")
        x, y = cglb.data
        common = cglb._common_calculation()
        precond = NystromPreconditioner(common.A, common.LB, cglb.likelihood.variance.value)
        mv = cglb._kmat_operator()
        steps = 20
        cg_ms = {k: request_ms(lambda: cglb_conjugate_gradient(mv, y.mT, zeros, precond, 0.0, k, 40), 3, warmup=1)
                 for k in (0, steps)}
        per_iter = (cg_ms[steps] - cg_ms[0]) / steps
        log(f"time: cglb CG: {per_iter:.4f} ms per iteration ({steps} iterations {cg_ms[steps]:.3f} ms, "
            f"0 iterations {cg_ms[0]:.3f} ms)")
        cg_by, _ = profile_device(lambda: cglb_conjugate_gradient(mv, y.mT, zeros, precond, 0.0, steps, 40),
                                  f"cglb CG, {steps} iterations from v = 0")
        if cg_by:
            log(f"profile: K1 is {100 * cg_by.get('K1', 0.0) / sum(cg_by.values()):.1f}% of the CG's device time; "
                f"per iteration K1 {cg_by.get('K1', 0.0) / steps:.4f} ms, gemm/gemv "
                f"{cg_by.get('gemm', 0.0) / steps:.4f} ms, all {sum(cg_by.values()) / steps:.4f} ms")
        log(f"time: sparse SGPR objective: {request_ms(sgpr.training_loss, 10):.4f} ms")
        post = sgpr.posterior()
        for key, fn in (("cached predict_f", lambda: post.predict_f(Xb)),
                        ("cached predict_mean", lambda: post.predict_mean(Xb)),
                        ("fused predict_f", lambda: sgpr.predict_f(Xb)), ("predict_y", lambda: sgpr.predict_y(Xb))):
            log(f"time: sparse SGPR {key} at B={B}: {request_ms(fn, 10):.4f} ms per request")
    log(f"time: sparse SGPR value and gradient: "
        f"{request_ms(lambda: sparse_value_and_grad(sgpr, lambda m: m.training_loss()), 10):.4f} ms")
    log(f"time: cglb value and gradient: "
        f"{request_ms(lambda: sparse_value_and_grad(cglb, lambda m: m.training_loss()), 3):.3f} ms "
        f"({cglb.cg_iterations} CG iterations)")
    by, _ = profile_device(lambda: sparse_value_and_grad(cglb, lambda m: m.training_loss()),
                           f"cglb matrix-free value and gradient ({cglb.cg_iterations} CG iterations)", top=10)
    if by:
        log(f"profile: K1 is {100 * by.get('K1', 0.0) / sum(by.values()):.1f}% of the matrix-free value and "
            f"gradient's device time")
    with torch.no_grad():
        for key, fn in (("predict_f", lambda: cglb.predict_f(Xb)), ("predict_y", lambda: cglb.predict_y(Xb)),
                        ("predict_log_density", lambda: cglb.predict_log_density((Xb, Yb)))):
            log(f"time: cglb {key} at B={B}: {request_ms(fn, 3):.3f} ms per request ({cglb.cg_iterations} CG "
                f"iterations)")
        time_k1(SP_N, SP_CHUNK, iters=20)  # a matrix-free block
        time_k1(SP_M, SP_N, iters=20)  # Kuf
        time_k1(B, SP_N, iters=20)  # K(Xnew, X) of a CGLB request
        time_k2(SP_N, SP_CHUNK, iters=20)  # a rebuilt block's backward, Matern52


def sparse_phases(launches):
    """Phases 13-16."""
    data, Z, Xnew, Ynew = make_sparse_data()
    sgpr = sgpr_check(data, Z, launches)
    sgpr_train(sgpr, launches)
    sgpr_serve(sgpr, Xnew, launches)

    cglb_dense_vs_matrix_free(launches)

    cglb = sparse_model("CGLB", data, Z, torch.float32, matrix_free_chunk=SP_CHUNK)
    loss0, it0 = cglb_objective(cglb, launches, "objective from v = 0")
    log(f"cglb objective from v = 0: {loss0:.6e} after {it0} CG iterations")
    v64 = cglb_v64(data, Z)
    for kernel in ("SquaredExponential", "Matern52"):
        cglb_fixed_v(kernel, data, Z, v64, launches)
    # the float32-against-float64 checks again on data drawn as bench.py
    # draws them from other seeds: the spread the limits must hold
    for seed in SP_EXTRA_SEEDS:
        d, z, _, _ = make_sparse_data(seed=seed)
        sgpr_check(d, z, launches, tag=f", data seed {seed}")
        v = cglb_v64(d, z)
        for kernel in ("SquaredExponential", "Matern52"):
            cglb_fixed_v(kernel, d, z, v, launches, tag=f", data seed {seed}")
        del d, z, v
        torch.cuda.empty_cache()
    cglb_sandwich(cglb, data, Z, "before training")
    cglb_peak_memory(cglb, launches)
    cglb_train(cglb, loss0, launches)
    cglb_sandwich(cglb, data, Z, "after training")
    cglb_adversarial(data, Z, launches)
    Xb, Yb = cglb_serve(cglb, Xnew, Ynew, launches)
    torch.cuda.empty_cache()
    sparse_timings(sgpr, cglb, Xb, Yb)


def make_vgp_regression(seed):
    """The GPR generator's formula (``bench.py:294-299``) at n = VGP_N from
    RandomState(``seed``), with VGP_N new points drawn after it."""
    rng = np.random.RandomState(seed)
    X = rng.rand(VGP_N, D).astype(np.float32)
    Y = np.sin(X[:, :1] * 3).astype(np.float32) + 0.1 * rng.randn(VGP_N, 1).astype(np.float32)
    return (X, Y), rng.rand(VGP_N, D).astype(np.float32)


def make_vgp_data():
    """Phase 17's data: the classification set, the first VGP_N rows of the
    natural-gradient operating point's X and Y (``bench.py:232-236``) and
    the next VGP_N rows as requests; and the regression set from
    RandomState(1), as ``bench.py`` seeds the GPR's."""
    X, Y, _, _, _ = make_ng_data()
    cls = (X[:VGP_N], Y[:VGP_N]), (X[VGP_N:2 * VGP_N], Y[VGP_N:2 * VGP_N])
    return cls, make_vgp_regression(1)


def vgp_model(data, dtype, cls="VGP", kernel="SE + Linear", values=None):
    """The Bernoulli classifier of phase 17 on the card in ``dtype``, a
    ``cls`` (VGP or VGPOpperArchambeau) with a Constant mean function and
    ``kernel`` (lengthscales 1), or the constrained ``values`` of
    ``read_values``."""
    from gpflow_tpu_torch import config, functions, kernels, likelihoods, models
    from gpflow_tpu_torch.utilities import load_jax_values

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        k = {"SE + Linear": lambda: kernels.SquaredExponential(lengthscales=np.ones(D)) + kernels.Linear(),
             "Matern52": lambda: kernels.Matern52(lengthscales=np.ones(D)),
             "Periodic": lambda: kernels.Periodic(kernels.SquaredExponential(lengthscales=np.ones(D)))}[kernel]()
        model = getattr(models, cls)(data, k, likelihoods.Bernoulli(), mean_function=functions.Constant())
    model = model.to(dtype=dtype)
    if values is not None:
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        load_jax_values(model, {p: np.asarray(v).astype(np_dtype) for p, v in values.items()})
    return model


def vgp_values(model, seed):
    """``read_values`` of ``model`` with its variational parameters moved
    off their start: q_mu ~ N(0, 0.25) and q_sqrt with a diagonal in
    [0.1, 1] and small entries below it (VGP), or alpha ~ N(0, 1e-6) and
    lambda in [0.5, 1.5] (VGPOpperArchambeau; K alpha stays of order 1
    where the Linear term's entries are ~30); and c = 0.2."""
    from gpflow_tpu_torch.utilities import read_values

    values = read_values(model)
    rng = np.random.RandomState(seed)
    n = VGP_N
    if ".q_alpha" in values:
        values[".q_alpha"] = 1e-3 * rng.randn(n, 1)
        values[".q_lambda"] = 0.5 + rng.rand(n, 1)
    else:
        q_sqrt = np.tril(rng.randn(1, n, n).astype(np.float32) * np.float32(0.1 / np.sqrt(n)), k=-1)
        q_sqrt[0, np.arange(n), np.arange(n)] = 0.1 + 0.9 * rng.rand(n)
        values[".q_mu"] = 0.5 * rng.randn(n, 1)
        values[".q_sqrt"] = q_sqrt
    values[".mean_function.c"] = np.array([0.2])
    return values


def vgp_cond(model64):
    """cond(K(X) + jitter I) of a float64 model, from its eigenvalues."""
    from gpflow_tpu_torch.config import default_jitter

    with torch.no_grad():
        K = model64.kernel(model64.data[0])
        eig = torch.linalg.eigvalsh(K + default_jitter() * torch.eye(K.shape[0], dtype=K.dtype, device=K.device))
    return float(eig[-1] / eig[0])


def vgp_errors(got, want, limits):
    """{output: (error, limit)} of ``sparse_value_and_grad`` results (value,
    {path: gradient}) against float64: the value relative to itself, each
    gradient to its largest float64 entry, under its parameter's own limit
    where ``limits`` has one."""
    (value, grads), (value64, grads64) = got, want
    out = {"value": (abs(float(value) - float(value64)) / abs(float(value64)), limits["value"])}
    for path, want_g in grads64.items():
        key = f"gradient {path}"
        if key not in limits:
            key = "gradient q" if path in (".q_mu", ".q_sqrt", ".q_alpha", ".q_lambda") else "gradient"
        out[f"gradient {path}"] = (rel_err(grads[path], want_g), limits[key])
    return out


def vgp_value_and_grad(model):
    return sparse_value_and_grad(model, lambda m: m.training_loss())


def vgp_checked_value_and_grad(what, m32, m64, control, launches, expected, limits):
    """The float32 model's training loss and gradient under sync debug mode
    "error", with exact launch counts, against float64 and the lower-tier
    control (``judge``)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, counts = counted(lambda: vgp_value_and_grad(m32))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    expect_launches(f"vgp {what} value and gradient", counts, expected, launches)
    want = vgp_value_and_grad(m64)
    judge(f"vgp {what}", vgp_errors(got, want, limits),
          vgp_errors(run_control(lambda: vgp_value_and_grad(control)), want, limits))
    return got


def vgp_identity(reg, launches, tag="", exact=True):
    """Phase 17a: one ``NaturalGradient(gamma=1)`` step on the whitened VGP
    with a Gaussian likelihood reaches the exact posterior. In float64 on the
    card, with the jitter 1e-10 of the JAX package's own test
    (``tests/integration/test_method_equivalence.py:17-26, 107-118``; at the
    default 1e-6 the jitter alone moves the ELBO by about N / (2 noise) *
    1e-6 = 2e-2 of ~4e3), the ELBO equals the GPR's log marginal likelihood
    within VGP_IDENTITY_RTOL and the requests agree within VGP_IDENTITY_ATOL.
    Then the same step in float32 (K1 on the path, the float32 jitter
    1e-4) against float64 with that jitter, beside the lower-tier control."""
    from gpflow_tpu_torch import config, kernels, likelihoods
    from gpflow_tpu_torch.models import GPR, VGP
    from gpflow_tpu_torch.optimizers import NaturalGradient

    (X, Y), Xnew = reg
    Xb = torch.from_numpy(Xnew).cuda()

    def build(data, dtype):
        with config.as_context(dataclasses.replace(config.config(), float=dtype)):
            return VGP(data, kernels.SquaredExponential(), likelihoods.Gaussian(VGP_NOISE)).to(dtype=dtype)

    def step(model, jitter=1e-4):
        """One step, then the ELBO and a fused request, all at ``jitter``."""
        with config.as_context(dataclasses.replace(config.config(), jitter=jitter)):
            NaturalGradient(gamma=1.0).minimize(model.training_loss, [(model.q_mu, model.q_sqrt)])
            with torch.no_grad():
                return model.elbo(), model.predict_f(Xb.to(model.q_mu.dtype))

    if exact:
        identity = build((X, Y), torch.float64)
        with config.as_context(dataclasses.replace(config.config(), float=torch.float64)):
            gpr = GPR((X, Y), kernels.SquaredExponential(), noise_variance=VGP_NOISE)
        elbo, (mean, var) = step(identity, VGP_IDENTITY_JITTER)
        with torch.no_grad():
            lml = gpr.log_marginal_likelihood()
            gmean, gvar = gpr.predict_f(Xb.double())
        rel = abs(float(elbo) - float(lml)) / abs(float(lml))
        merr, verr = float((mean - gmean).abs().max()), float((var - gvar).abs().max())
        log(f"vgp identity float64 N={VGP_N}, jitter {VGP_IDENTITY_JITTER:.0e}: ELBO after one natural-gradient "
            f"step {float(elbo):.10e}, GPR log marginal likelihood {float(lml):.10e}, rel diff {rel:.3e} (tol "
            f"{VGP_IDENTITY_RTOL:.0e}); predict_f at {VGP_N} new points: mean max abs diff {merr:.3e}, var "
            f"{verr:.3e} (tol {VGP_IDENTITY_ATOL:.0e})")
        assert rel <= VGP_IDENTITY_RTOL, "the VGP's ELBO after one natural-gradient step is not the GPR's LML"
        assert merr <= VGP_IDENTITY_ATOL and verr <= VGP_IDENTITY_ATOL, "the VGP's predictions are not the GPR's"
        del identity, gpr
    m32, m64 = build((X, Y), torch.float32), build((X, Y), torch.float64)
    control = build((bf16(X).numpy(), Y), torch.float32)
    log(f"vgp identity{tag}: cond(K + 1e-4 I) {vgp_cond(m64):.4e}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        (elbo32, (mean32, var32)), counts = counted(lambda: step(m32))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # the step's loss: K(X); the ELBO: K(X); the fused request: K(X) and K(X, Xnew)
    expect_launches(f"vgp identity{tag} float32 step, ELBO and request", counts, {"K1": 4, "K2": 0}, launches)
    elbo64, (mean64, var64) = step(m64)
    elboc, (meanc, varc) = run_control(lambda: step(control))

    limits = VGP_RTOL["identity"]

    def errors(e, m, v):
        return {"value": (abs(float(e) - float(elbo64)) / abs(float(elbo64)), limits["value"]),
                "mean": (rel_err(m, mean64), limits["mean"]), "var": (rel_err(v, var64), limits["var"])}

    judge(f"vgp identity{tag} float32", errors(elbo32, mean32, var32), errors(elboc, meanc, varc))


def vgp_requests(model, Xb, Yb, launches, label):
    """Requests of VGP_N new points through ``posterior()`` (TENSOR cache)
    with ``predict_f``, the fused ``predict_f``, ``predict_y`` and
    ``predict_log_density``, with exact launch counts."""
    with torch.no_grad():
        post, counts = counted(model.posterior)
        if launches is not None:
            expect_launches(f"{label} posterior", counts, {"K1": 1, "K2": 0}, launches)
        out = {}
        for key, fn, k1 in (("cached predict_f", lambda: post.predict_f(Xb), 1),
                            ("fused predict_f", lambda: model.predict_f(Xb), 2),
                            ("predict_y", lambda: model.predict_y(Xb), 2),
                            ("predict_log_density", lambda: (model.predict_log_density((Xb, Yb)),), 2)):
            out[key], counts = counted(fn)
            if launches is not None:
                expect_launches(f"{label} {key} request", counts, {"K1": k1, "K2": 0}, launches)
    return out, post


def vgp_request_errors(out, want, limits):
    """{output: (error, limit)}: each output relative to its largest float64
    entry; a non-finite one gives a NaN error, which breaks any limit."""
    errs = {}
    for key, tensors in out.items():
        kinds = ("mean", "var") if len(tensors) == 2 else ("log density",)
        for kind, got, w in zip(kinds, tensors, want[key]):
            assert got.shape == w.shape, f"{key} {kind}: shape {tuple(got.shape)} != {tuple(w.shape)}"
            errs[f"{key} {kind}"] = (rel_err(got, w), limits[kind])
    return errs


def vgp_serve_check(what, m32, m64, ctl, Xb, Yb, launches, routes, limits, control=True):
    """Requests of VGP_N points to ``m32`` on each of ``routes`` against the
    same values in float64, beside the lower-tier control ``ctl`` (fed
    bfloat16-rounded points) where ``control``; probabilities within
    [0, 1], predictive variances positive. Returns the last route's
    outputs and posterior."""
    from gpflow_tpu_torch.conditionals import inv_solve

    with torch.no_grad():
        want, _ = vgp_requests(m64, Xb.double(), Yb.double(), None, "")
    for route, flag in routes:
        with inv_solve(flag):
            out, post = vgp_requests(m32, Xb, Yb, launches, f"{what} {route}")
            cout = run_control(lambda: vgp_requests(ctl, bf16(Xb), Yb, None, "")[0]) if control else None
        judge(f"{what} {route} requests", vgp_request_errors(out, want, limits),
              vgp_request_errors(cout, want, limits) if control else None)
        p, v = out["predict_y"]
        assert bool(((p >= 0) & (p <= 1)).all()) and bool((v >= 0).all()), f"{what}: a probability outside [0, 1]"
        assert bool((out["cached predict_f"][1] > 0).all()), f"{what}: a predictive variance is not positive"
    accuracy = float(((p > 0.5).float() == Yb).float().mean())
    log(f"{what}: probabilities in [{float(p.min()):.4e}, {float(p.max()):.4e}]; held-out accuracy {accuracy:.4f}, "
        f"mean log density {float(out['predict_log_density'][0].mean()):.4f}")
    return out, post


def vgp_checks(cls_data, launches, seed, routes, tag=""):
    """Phase 17b-d on one set of values (``seed``): the classifier VGP
    (SquaredExponential + Linear, Bernoulli, Constant mean) with its
    variational parameters off their start, its ELBO and gradient against
    float64 and its requests on ``routes``; a Matern52 VGP's value and
    gradient (K2 on the path); VGPOpperArchambeau's value, gradient and
    ``predict_f``; each beside the lower-tier control. Returns the float32
    classifier and VGPOpperArchambeau, and the data's requests."""
    (X, Y), (Xnew, Ynew) = cls_data
    ctl_data = (bf16(X).numpy(), Y)
    Xb, Yb = torch.from_numpy(Xnew).cuda(), torch.from_numpy(Ynew).cuda()
    values = vgp_values(vgp_model((X, Y), torch.float32), seed)
    m32 = vgp_model((X, Y), torch.float32, values=values)
    m64 = vgp_model((X, Y), torch.float64, values=values)
    ctl = vgp_model(ctl_data, torch.float32, values=values)
    log(f"vgp classifier{tag}: cond(K + jitter I) {vgp_cond(m64):.4e} (float64, jitter 1e-4)")
    vgp_checked_value_and_grad(f"classifier{tag}", m32, m64, ctl, launches, {"K1": 1, "K2": 0},
                               VGP_RTOL["classifier"])  # the Linear term is a matmul
    vgp_serve_check(f"vgp classifier{tag}", m32, m64, ctl, Xb, Yb, launches, routes, VGP_RTOL["requests"])
    del m64, ctl

    mvals = {p: v for p, v in values.items() if not p.startswith(".kernel")}
    mvals.update({".kernel.variance": np.asarray(1.0), ".kernel.lengthscales": np.ones(D)})
    mat = {dtype: vgp_model((X, Y), dtype, kernel="Matern52", values=mvals) for dtype in (torch.float32, torch.float64)}
    vgp_checked_value_and_grad(f"Matern52{tag}", mat[torch.float32], mat[torch.float64],
                               vgp_model(ctl_data, torch.float32, kernel="Matern52", values=mvals), launches,
                               {"K1": 1, "K2": 1}, VGP_RTOL["Matern52"])
    del mat

    ovals = vgp_values(vgp_model((X, Y), torch.float32, cls="VGPOpperArchambeau"), seed + 1)
    oa = {dtype: vgp_model((X, Y), dtype, cls="VGPOpperArchambeau", values=ovals)
          for dtype in (torch.float32, torch.float64)}
    octl = vgp_model(ctl_data, torch.float32, cls="VGPOpperArchambeau", values=ovals)
    vgp_checked_value_and_grad(f"VGPOpperArchambeau{tag}", oa[torch.float32], oa[torch.float64], octl, launches,
                               {"K1": 1, "K2": 0}, VGP_RTOL["VGPOpperArchambeau"])
    with torch.no_grad():
        got, counts = counted(lambda: {"predict_f": oa[torch.float32].predict_f(Xb)})
        expect_launches(f"vgp VGPOpperArchambeau{tag} predict_f request", counts, {"K1": 2, "K2": 0}, launches)
        want = {"predict_f": oa[torch.float64].predict_f(Xb.double())}
        cout = run_control(lambda: {"predict_f": octl.predict_f(bf16(Xb))})
    limits = VGP_RTOL["VGPOpperArchambeau request"]
    judge(f"vgp VGPOpperArchambeau{tag} request", vgp_request_errors(got, want, limits),
          vgp_request_errors(cout, want, limits))
    return m32, oa[torch.float32], (Xb, Yb)


def vgp_train(m32, data, requests, launches):
    """Phase 17b, training: VGP_MAXITER iterations of ``Scipy().minimize``
    on ``models.training_loss_closure``, which must lower the objective;
    then the trained classifier's requests against float64 (no control:
    training leaves its predictions close to its mean function's, which
    bfloat16 points cannot move). Returns what the timings need."""
    from gpflow_tpu_torch.models import training_loss_closure
    from gpflow_tpu_torch.optimizers import Scipy
    from gpflow_tpu_torch.utilities import read_values

    with torch.no_grad():
        loss0 = float(m32.training_loss())
    t0 = time.perf_counter()
    res, counts = counted(lambda: Scipy().minimize(training_loss_closure(m32, data), m32.trainable_variables,
                                                   options={"maxiter": VGP_MAXITER}, nonfinite_penalty=GPR_PENALTY))
    seconds = time.perf_counter() - t0
    n_vars = sum(p.unconstrained.numel() for p in m32.trainable_variables if p is not m32.q_sqrt) \
        + VGP_N * (VGP_N + 1) // 2
    values = {path: v.round(4).tolist() for path, v in read_values(m32).items() if not path.startswith(".q")}
    log(f"vgp classifier lbfgs: {n_vars} variables, loss {loss0:.6e} -> {float(res.fun):.6e}; nit {res.nit}, "
        f"nfev {res.nfev}, non-finite evaluations {res.n_nonfinite_evals}, status {res.status} ({res.message}); "
        f"values {values}")
    log(f"time: vgp classifier lbfgs N={VGP_N}: {seconds:.3f} s, {seconds / max(res.nit, 1):.4f} s per iteration, "
        f"{seconds / res.nfev:.4f} s per evaluation")
    assert np.isfinite(res.fun) and float(res.fun) < loss0, "L-BFGS did not lower the VGP objective"
    expect_launches("vgp classifier lbfgs", counts, {"K1": int(res.nfev), "K2": 0}, launches)
    m64 = vgp_model(data, torch.float64, values=read_values(m32))
    _, post = vgp_serve_check("vgp trained classifier", m32, m64, None, *requests, launches, TRAIN_ROUTES[:1],
                              VGP_RTOL["requests"], control=False)
    return post, seconds / res.nfev


def svgp_deprecated_check(launches):
    """Phase 17e: ``SVGP_deprecated`` (``conditionals.conditional``) against
    ``SVGP`` (the posterior's fused route) at the flagship width (M = 2048,
    B = 8192, D = 8; phase 5's values, batch and Gaussian likelihood with
    ``num_data`` = N): ELBO, gradient and ``predict_f`` within
    SVGP_ROUNDOFF, the launch counts as each route implies."""
    from gpflow_tpu_torch import config, kernels, likelihoods, models
    from gpflow_tpu_torch.utilities import load_jax_values

    values, X = make_values(SEED)
    rng = np.random.RandomState(SEED + 19)
    Xb = torch.from_numpy(X[:B]).cuda()
    Yb = torch.from_numpy(np.sin(X[:B] @ rng.randn(D, 1)).astype(np.float32)).cuda()
    out = {}
    for cls in ("SVGP_deprecated", "SVGP"):
        with config.as_context(dataclasses.replace(config.config(), float=torch.float32)):
            m = getattr(models, cls)(kernels.SquaredExponential(lengthscales=np.ones(D)), likelihoods.Gaussian(1.0),
                                     np.zeros((M, D)), num_data=N_DATA).to(torch.float32)
        load_jax_values(m, values)
        torch.cuda.set_sync_debug_mode("error")
        try:
            (elbo, grads), counts = counted(lambda: sparse_value_and_grad(m, lambda mm: mm.elbo((Xb, Yb))))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        expect_launches(f"{cls} ELBO and gradient", counts, {"K1": 2, "K2": 0}, launches)  # Kuu and Kuf
        with torch.no_grad():
            pred, counts = counted(lambda: m.predict_f(Xb))
        expect_launches(f"{cls} predict_f", counts, {"K1": 2, "K2": 0}, launches)
        out[cls] = (elbo, grads, pred)
    (e0, g0, p0), (e1, g1, p1) = out["SVGP_deprecated"], out["SVGP"]
    errs = {"ELBO": abs(float(e0) - float(e1)) / abs(float(e1))}
    errs.update({f"gradient {path}": rel_err(g0[path], g1[path]) for path in g1})
    errs.update({f"predict_f {k}": rel_err(a, b) for k, a, b in zip(("mean", "var"), p0, p1)})
    for key, err in errs.items():
        log(f"SVGP_deprecated against SVGP: {key}: rel diff {err:.3e}, tol {SVGP_ROUNDOFF:.1e}")
        assert err <= SVGP_ROUNDOFF, f"SVGP_deprecated and SVGP disagree: {key}"


def vgp_timings(model, opper, post, Xb, Yb, lbfgs_eval_s):
    """Phase 17g: the VGP's and VGPOpperArchambeau's value and gradient by
    CUDA events, several rounds with their spread; seconds per L-BFGS
    evaluation; request latency; a profiler breakdown of one VGP value and
    gradient; K1 and K2 at the path's shape."""
    for label, m in (("VGP", model), ("VGPOpperArchambeau", opper)):
        rounds = [device_ms(lambda: vgp_value_and_grad(m), 5, warmup=1) for _ in range(VGP_TIMED_ROUNDS)]
        host = [request_ms(lambda: vgp_value_and_grad(m), 5, warmup=1) for _ in range(2)]
        log(f"time: vgp {label} value and gradient N={VGP_N}: device {min(rounds):.3f} ms (rounds "
            f"{[round(r, 3) for r in rounds]}, spread {max(rounds) - min(rounds):.3f} ms); back to back with the "
            f"host {min(host):.3f} ms (rounds {[round(r, 3) for r in host]})")
    log(f"time: vgp classifier lbfgs: {lbfgs_eval_s:.4f} s per evaluation")
    with torch.no_grad():
        for key, fn in (("posterior()", model.posterior), ("cached predict_f", lambda: post.predict_f(Xb)),
                        ("fused predict_f", lambda: model.predict_f(Xb)), ("predict_y", lambda: model.predict_y(Xb)),
                        ("predict_log_density", lambda: model.predict_log_density((Xb, Yb)))):
            rounds = [request_ms(fn, 5, warmup=1) for _ in range(VGP_TIMED_ROUNDS)]
            log(f"time: vgp {key} at B={VGP_N}: {min(rounds):.3f} ms per request (rounds "
                f"{[round(r, 3) for r in rounds]})")
    profile_device(lambda: vgp_value_and_grad(model), f"vgp value and gradient N={VGP_N}", top=12)
    with torch.no_grad():
        time_k1(VGP_N, VGP_N, iters=20)
        time_k2(VGP_N, VGP_N, iters=20)


def vgp_phases(launches):
    """Phase 17."""
    cls_data, reg = make_vgp_data()
    vgp_identity(reg, launches)
    torch.cuda.empty_cache()
    with torch.no_grad():
        periodic = vgp_model(cls_data[0], torch.float32, kernel="Periodic")
        loss, counts = counted(periodic.training_loss)
    assert bool(torch.isfinite(loss)), "the Periodic VGP's objective is not finite"
    expect_launches("vgp Periodic objective", counts, {"K1": 0, "K2": 0}, launches)
    del periodic
    model, opper, requests = vgp_checks(cls_data, launches, SEED + 17, TRAIN_ROUTES)
    torch.cuda.empty_cache()
    # the float32-against-float64 checks again on other values and other
    # regression data: the spread the limits must hold
    for seed in VGP_EXTRA_SEEDS:
        vgp_identity(make_vgp_regression(seed), launches, tag=f", data seed {seed}", exact=False)
        vgp_checks(cls_data, launches, seed, TRAIN_ROUTES[:1], tag=f", values seed {seed}")
        torch.cuda.empty_cache()
    post, lbfgs_eval_s = vgp_train(model, cls_data[0], requests, launches)
    torch.cuda.empty_cache()
    svgp_deprecated_check(launches)
    torch.cuda.empty_cache()
    vgp_timings(model, opper, post, *requests, lbfgs_eval_s)


def make_mc_data():
    """Phase 18's data: ((X, Y) of MC_N training points, (Xnew, Ynew) of
    MC_B held-out points, Z), from RandomState(SEED + 18)."""
    rng = np.random.RandomState(SEED + 18)
    X = rng.randn(MC_N + MC_B, MC_D).astype(np.float32)
    W = rng.randn(MC_D, MC_C).astype(np.float32)
    scores = X @ W + 0.5 * rng.randn(MC_N + MC_B, MC_C).astype(np.float32)
    Y = np.argmax(scores, axis=1)[:, None].astype(np.float32)
    Z = X[rng.permutation(MC_N)[:MC_M]].copy()
    return (X[:MC_N], Y[:MC_N]), (X[MC_N:], Y[MC_N:]), Z


def mc_model(lik, Z, dtype, values=None):
    """The multiclass SVGP of phase 18 on the card in ``dtype`` with ``lik``
    ("MultiClass" or "Softmax", its draws seeded with SEED), lengthscales
    sqrt(D), ``num_data`` = MC_N, q_mu zeros and q_sqrt identities, or the
    constrained ``values`` of ``read_values``."""
    from gpflow_tpu_torch import config, kernels, likelihoods
    from gpflow_tpu_torch.models import SVGP
    from gpflow_tpu_torch.utilities import load_jax_values

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        likelihood = likelihoods.MultiClass(MC_C) if lik == "MultiClass" else likelihoods.Softmax(MC_C, seed=SEED)
        model = SVGP(kernels.SquaredExponential(lengthscales=np.full(MC_D, np.sqrt(MC_D))), likelihood, Z,
                     num_latent_gps=MC_C, num_data=MC_N)
    model = model.to(dtype=dtype)
    if values is not None:
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        load_jax_values(model, {k: np.asarray(v).astype(np_dtype) for k, v in values.items()})
    return model


def latent_values(model, seed, latents):
    """``read_values`` of ``model`` with q(u) of its ``latents`` GPs moved off
    its start: q_mu ~ N(0, 0.25), q_sqrt with a diagonal in [0.1, 1] and
    small entries below it."""
    from gpflow_tpu_torch.utilities import read_values

    values = read_values(model)
    m = values[".q_mu"].shape[0]
    rng = np.random.RandomState(seed)
    q_sqrt = np.tril(rng.randn(latents, m, m).astype(np.float32) * np.float32(0.1 / np.sqrt(m)), k=-1)
    q_sqrt[:, np.arange(m), np.arange(m)] = 0.1 + 0.9 * rng.rand(latents, m)
    values[".q_mu"] = 0.5 * rng.randn(m, latents)
    values[".q_sqrt"] = q_sqrt
    return values


@contextlib.contextmanager
def fixed_draws(model, draws):
    """The model's entry points with its Monte-Carlo likelihood's draws set
    to ``draws`` [S, N, latents] (cast to each call's type), so that float32
    and float64 see the same draws; nothing changes for other likelihoods."""
    lik = model.likelihood
    if not hasattr(lik, "_mc_quadrature"):
        yield
        return
    inner = lik._mc_quadrature

    def pinned(funcs, Fmu, Fvar, logspace=False, epsilon=None, **Ys):
        return inner(funcs, Fmu, Fvar, logspace, draws.to(Fmu.dtype), **Ys)

    lik._mc_quadrature = pinned
    try:
        yield
    finally:
        del lik._mc_quadrature


def mc_draws(n, seed, latents=None):
    """Standard normals [100, n, latents (default MC_C)] on the card, in
    float64."""
    return torch.randn(100, n, latents or MC_C, dtype=torch.float64, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(seed))


def mc_check_objective(data, Z, launches):
    """Phase 18a: the MultiClass ELBO and its gradient at B = MC_B under
    sync debug mode "error", against float64 on the card and beside the
    lower-tier control, on three sets of values; then Softmax's with fixed
    draws on the first."""
    X, Y = data
    idx = np.random.RandomState(SEED + 18).randint(0, MC_N, MC_B)
    batch = (torch.from_numpy(X[idx]).cuda(), torch.from_numpy(Y[idx]).cuda())
    ctl_batch = (bf16(batch[0]).cuda(), batch[1])
    eps = mc_draws(MC_B, SEED + 18)
    for lik, seeds in (("MultiClass", MC_VALUE_SEEDS), ("Softmax", MC_VALUE_SEEDS[:1])):
        for seed in seeds:
            values = latent_values(mc_model(lik, Z, torch.float32), seed, MC_C)
            m32, m64 = mc_model(lik, Z, torch.float32, values), mc_model(lik, Z, torch.float64, values)
            ctl = mc_model(lik, Z, torch.float32, bf16_values(values))
            what = f"multiclass {lik} objective, values seed {seed}"
            c_kuu, c_s = ng_cond(m64)
            log(f"{what}: cond(Kuu + jitter I) {c_kuu:.4e}, cond(S) {c_s:.4e} (float64, jitter 1e-4)")

            def value_and_grad(model, b):
                with fixed_draws(model, eps):
                    return sparse_value_and_grad(model, lambda m: m.training_loss(b))

            torch.cuda.set_sync_debug_mode("error")
            try:
                got, counts = counted(lambda: value_and_grad(m32, batch))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            expect_launches(f"{what}: ELBO and gradient", counts, {"K1": 2, "K2": 0}, launches)  # Kuu, Kuf
            assert bool(torch.isfinite(got[0])), f"{what}: the ELBO is not finite"
            want = value_and_grad(m64, tuple(t.double() for t in batch))
            log(f"{what}: ELBO {float(want[0]):.6e}; largest float64 gradient entries "
                + ", ".join(f"{k} {float(g.abs().max()):.3e}" for k, g in want[1].items()))
            judge(what, vgp_errors(got, want, MC_RTOL),
                  vgp_errors(run_control(lambda: value_and_grad(ctl, ctl_batch)), want, MC_RTOL))
            del m32, m64, ctl
    torch.cuda.empty_cache()


def mc_train(lik, gamma, data, Z, launches, steps=MC_STEPS):
    """Phase 18b: ``steps`` steps of ``run_steps_sampled`` under sync debug
    mode "error", Adam 1e-2 on every parameter (``gamma`` None) or fused
    natural gradients of size ``gamma`` on q(u) and Adam on the rest;
    losses finite and falling, launch counts exact. Returns the trainer."""
    from gpflow_tpu_torch.parallel import DataParallelTrainer, adam

    natgrad = gamma is not None
    mode = f"natgrad fused gamma {gamma}" if natgrad else "adam"
    trainer = DataParallelTrainer(mc_model(lik, Z, torch.float32), adam(1e-2), natgrad_gamma=gamma,
                                  natgrad_fused=natgrad)
    trainer.stage_data(data)
    generator = torch.Generator(device="cuda").manual_seed(SEED + 21)
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses, counts = counted(lambda: trainer.run_steps_sampled(steps, MC_B, generator=generator))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses = losses.cpu()
    rejected = trainer.natgrad_rejections if natgrad else 0
    log(f"multiclass train {lik} {mode}: {steps} steps at B={MC_B}, losses {[round(float(v), 1) for v in losses]}"
        + (f"; natgrad_rejections {rejected} of {steps}" if natgrad else ""))
    expect_launches(f"multiclass train {lik} {mode}", counts, {"K1": 2 * steps, "K2": 0}, launches)
    assert losses.shape == (steps,) and bool(torch.isfinite(losses).all()), f"{lik} {mode}: non-finite loss"
    if steps > 1:
        last = float(losses[-5:].mean())
        log(f"multiclass train {lik} {mode}: loss {float(losses[0]):.6e} -> {last:.6e} (mean of the last 5)")
        assert last < float(losses[0]), f"{lik} {mode}: the loss did not fall"
        assert rejected < steps, f"{lik} {mode}: every natural-gradient step was rejected"
    return trainer


def mc_lbfgs(model, data, launches):
    """Phase 18c: MC_LBFGS_ITERS iterations of ``Scipy().minimize`` on
    ``training_loss_closure`` over the whole data, the harness's route
    (benchmark/run.py:73-101); the objective must fall. Returns seconds per
    evaluation."""
    from gpflow_tpu_torch.models import training_loss_closure
    from gpflow_tpu_torch.optimizers import Scipy

    X, Y = (torch.from_numpy(a).cuda() for a in data)
    with torch.no_grad():
        loss0 = float(model.training_loss((X, Y)))
    t0 = time.perf_counter()
    res, counts = counted(lambda: Scipy().minimize(training_loss_closure(model, (X, Y)), model.trainable_variables,
                                                   options={"maxiter": MC_LBFGS_ITERS}, nonfinite_penalty=GPR_PENALTY))
    seconds = time.perf_counter() - t0
    n_vars = sum(p.unconstrained.numel() for p in model.trainable_variables if p is not model.q_sqrt) \
        + MC_C * MC_M * (MC_M + 1) // 2
    log(f"multiclass lbfgs: {n_vars} variables over N={MC_N}, loss {loss0:.6e} -> {float(res.fun):.6e}; nit "
        f"{res.nit}, nfev {res.nfev}, non-finite evaluations {res.n_nonfinite_evals}, status {res.status} "
        f"({res.message})")
    log(f"time: multiclass lbfgs N={MC_N}: {seconds:.3f} s, {seconds / max(res.nit, 1):.4f} s per iteration, "
        f"{seconds / res.nfev:.4f} s per evaluation")
    assert np.isfinite(res.fun) and float(res.fun) < loss0, "L-BFGS did not lower the multiclass objective"
    expect_launches("multiclass lbfgs", counts, {"K1": 2 * int(res.nfev), "K2": 0}, launches)  # Kuu, Kuf a time
    return seconds / res.nfev


def mc_requests(model, Xb, Yb, launches, label):
    """Requests of MC_B points through ``posterior()`` (TENSOR cache) with
    ``predict_f``, the fused ``predict_f``, ``predict_y`` and
    ``predict_log_density``, with exact launch counts where ``launches``."""
    with torch.no_grad():
        post, counts = counted(model.posterior)
        if launches is not None:
            expect_launches(f"{label} posterior", counts, {"K1": 1, "K2": 0}, launches)
        out = {}
        for key, fn, k1 in (("cached predict_f", lambda: post.predict_f(Xb), 1),
                            ("fused predict_f", lambda: model.predict_f(Xb), 2),
                            ("predict_y", lambda: model.predict_y(Xb), 2),
                            ("predict_log_density", lambda: (model.predict_log_density((Xb, Yb)),), 2)):
            out[key], counts = counted(fn)
            if launches is not None:
                expect_launches(f"{label} {key} request", counts, {"K1": k1, "K2": 0}, launches)
    return out, post


def mc_serve(model, lik, requests, launches):
    """Phase 18d: requests of MC_B held-out points on the solve and
    INV_SOLVE routes against the same values in float64 on the card
    (Softmax with fixed draws), beside the lower-tier control (the same
    values with Z and the points rounded to bfloat16, TF32 matmuls); class
    probabilities in [0, 1], Softmax's summing to 1 within MC_PROB_SUM_ATOL
    (RobustMax's need not: each class's probability is its own
    Gauss-Hermite sum); held-out accuracy above chance. Returns the last
    route's posterior."""
    from gpflow_tpu_torch.conditionals import inv_solve
    from gpflow_tpu_torch.utilities import read_values

    Xb, Yb = (torch.from_numpy(a).cuda() for a in requests)
    eps = mc_draws(MC_B, SEED + 22)
    values = read_values(model)
    m64 = mc_model(lik, np.zeros((MC_M, MC_D)), torch.float64, values)
    ctl = mc_model(lik, np.zeros((MC_M, MC_D)), torch.float32, bf16_values(values))
    c_kuu, c_s = ng_cond(m64)
    log(f"multiclass {lik} requests: cond(Kuu + jitter I) {c_kuu:.4e}, cond(S) {c_s:.4e} (float64, jitter 1e-4)")
    with fixed_draws(m64, eps):
        want, _ = mc_requests(m64, Xb.double(), Yb.double(), None, "")
    for route, flag in TRAIN_ROUTES:
        with inv_solve(flag), fixed_draws(model, eps):
            out, post = mc_requests(model, Xb, Yb, launches, f"multiclass {lik} {route}")
        with inv_solve(flag), fixed_draws(ctl, eps):
            cout = run_control(lambda: mc_requests(ctl, bf16(Xb), Yb, None, "")[0])
        for key, tensors in out.items():
            assert all(bool(torch.isfinite(t).all()) for t in tensors), f"{lik} {route} {key}: not finite"
        judge(f"multiclass {lik} {route} requests", vgp_request_errors(out, want, MC_RTOL["requests"]),
              vgp_request_errors(cout, want, MC_RTOL["requests"]))
        p = out["predict_y"][0]
        assert p.shape == (MC_B, MC_C) and bool(((p >= 0) & (p <= 1)).all()), f"{lik}: a probability outside [0, 1]"
        assert bool((out["cached predict_f"][1] > 0).all()), f"{lik}: a predictive variance is not positive"
        sums = p.double().sum(-1)
        log(f"multiclass {lik} {route}: class probabilities in [{float(p.min()):.4e}, {float(p.max()):.4e}], "
            f"their sums in [{float(sums.min()):.6f}, {float(sums.max()):.6f}]")
        if lik == "Softmax":
            assert float((sums - 1).abs().max()) <= MC_PROB_SUM_ATOL, "Softmax probabilities do not sum to 1"
    accuracy = float((p.argmax(-1) == Yb[:, 0].long()).float().mean())
    log(f"multiclass {lik}: held-out accuracy {accuracy:.4f} over {MC_B} points (chance {1 / MC_C:.2f}), "
        f"mean log density {float(out['predict_log_density'][0].mean()):.4f}")
    assert accuracy > 1.0 / MC_C, f"multiclass {lik}: held-out accuracy at or below chance"
    return post


def mc_scalar_checks(launches):
    """Phase 18e: one value and gradient of an SVGP with each of the other
    new likelihoods on the natural-gradient operating point's X and Z
    (M = 1024, B = 4096, D = 8), float32 under sync debug mode "error"
    against float64 on the card, within 64 * cond * eps32; Y drawn in each
    likelihood's support, GaussianMC with fixed draws."""
    from gpflow_tpu_torch import config, kernels, likelihoods
    from gpflow_tpu_torch.models import SVGP
    from gpflow_tpu_torch.utilities import load_jax_values

    X, _, Z, _, _ = make_ng_data()
    rng = np.random.RandomState(SEED + 23)
    Xb = X[:NG_B]
    f = np.sin(Xb @ rng.randn(D, 1)).astype(np.float32)
    noise = rng.randn(NG_B, 1).astype(np.float32)
    cases = {
        "StudentT": (lambda: likelihoods.StudentT(scale=0.5, df=4.0), 1, f + 0.3 * noise),
        "Exponential": (likelihoods.Exponential, 1, np.exp(f) * rng.exponential(size=(NG_B, 1))),
        "Gamma": (lambda: likelihoods.Gamma(shape=2.0), 1, np.exp(f) * rng.gamma(2.0, size=(NG_B, 1))),
        "Beta": (lambda: likelihoods.Beta(scale=5.0), 1, np.clip(0.5 + 0.4 * f + 0.05 * noise, 0.01, 0.99)),
        "SwitchedLikelihood([Gaussian, StudentT])": (
            lambda: likelihoods.SwitchedLikelihood([likelihoods.Gaussian(0.1), likelihoods.StudentT(scale=0.5)]), 1,
            np.concatenate([f + 0.3 * noise, rng.randint(0, 2, (NG_B, 1))], axis=1)),
        "GaussianMC": (lambda: likelihoods.GaussianMC(0.1), 1, f + 0.3 * noise),
        "HeteroskedasticTFPConditional": (likelihoods.HeteroskedasticTFPConditional, 2,
                                          f + np.exp(0.5 * f) * 0.3 * noise),
    }
    Xt = torch.from_numpy(Xb).cuda()
    for name, (make, latents, Y) in cases.items():
        Yt = torch.from_numpy(np.asarray(Y, np.float32)).cuda()
        eps = mc_draws(NG_B, SEED + 24, latents)
        models = {}
        for dtype in (torch.float32, torch.float64):
            with config.as_context(dataclasses.replace(config.config(), float=dtype)):
                models[dtype] = SVGP(kernels.SquaredExponential(lengthscales=np.ones(D)), make(), Z,
                                     num_latent_gps=latents, num_data=NG_N).to(dtype=dtype)
        values = latent_values(models[torch.float32], SEED + 24, latents)
        for dtype, m in models.items():
            load_jax_values(m, {k: np.asarray(v).astype(np.float64 if dtype == torch.float64 else np.float32)
                                for k, v in values.items()})

        def value_and_grad(model, Xv, Yv):
            with fixed_draws(model, eps):
                return sparse_value_and_grad(model, lambda m: m.training_loss((Xv, Yv)))

        torch.cuda.set_sync_debug_mode("error")
        try:
            got, counts = counted(lambda: value_and_grad(models[torch.float32], Xt, Yt))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        expect_launches(f"multiclass slice {name}: ELBO and gradient", counts, {"K1": 2, "K2": 0}, launches)
        want = value_and_grad(models[torch.float64], Xt.double(), Yt.double())
        tol = ng_tolerance(f"multiclass slice {name}", models[torch.float64])
        errs = vgp_errors(got, want, {"value": tol, "gradient": tol, "gradient q": tol})
        for key, (err, limit) in errs.items():
            log(f"multiclass slice {name}: {key}: rel err {err:.3e}, tol {limit:.1e}")
            assert err <= limit, f"{name}: {key} disagrees with float64"
        del models


def mc_check_k1(launches):
    """Phase 18f: K1 against its plain version at the path's shapes, rbf,
    float32 inputs N(0, 1 / d) per dimension (N(0, 1) data over lengthscales
    sqrt(d)), each with its launch plan; the D = 64 shapes stage with
    vector loads, D = 13 with scalar ones. Returns the largest absolute
    error against float64."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 25)
    var = torch.tensor([1.0], device="cuda")
    worst = 0.0
    for n, m, d in MC_K1_SHAPES:
        Xs = torch.from_numpy((rng.randn(n, d) / np.sqrt(d)).astype(np.float32)).cuda()
        Zs = torch.from_numpy((rng.randn(m, d) / np.sqrt(d)).astype(np.float32)).cuda()
        seen = set()
        K = pd.stationary_forward_cuda("rbf", Xs, Zs, var)
        plan = plan_seen("K1", seen)
        plain32 = pd.stationary_forward_plain("rbf", Xs, Zs, var)
        plain64 = pd.stationary_forward_plain("rbf", Xs.double(), Zs.double(), var.double())
        torch.cuda.synchronize()
        assert K.shape == (n, m) and K.dtype == torch.float32
        err64 = float((K.double() - plain64).abs().max())
        err32 = float((K - plain32).abs().max())
        log(f"K1 rbf ({n}, {m}, {d}): max abs err {err64:.3e} vs plain f64, tol {K1_ATOL_F64:.1e}; {err32:.3e} vs "
            f"plain f32, tol {K1_ATOL_F32:.1e}; K in [{float(K.min()):.3e}, {float(K.max()):.3e}]; {plan}")
        assert err64 <= K1_ATOL_F64 and err32 <= K1_ATOL_F32, f"K1 disagrees with its plain version at {(n, m, d)}"
        assert seen == {(True, d % 4 == 0)}, f"K1 at {(n, m, d)} took plan {seen}"
        worst = max(worst, err64)
    return worst


def mc_value_and_grad(model, batch):
    return sparse_value_and_grad(model, lambda m: m.training_loss(batch))


def mc_timings(models, trainers, lbfgs_eval_s, posts, requests):
    """Phase 18g: the MultiClass and Softmax value and gradient by CUDA
    events, several rounds with their spread; Adam and natural-gradient
    steps per second, rounds with their spread; seconds per L-BFGS
    evaluation; request latency; a profiler breakdown of one MultiClass
    value and gradient; K1 at the path's shapes."""
    X, Y = trainers["MultiClass adam"]._staged_data
    batch = (X[:MC_B], Y[:MC_B])
    for lik, model in models.items():
        rounds = [device_ms(lambda: mc_value_and_grad(model, batch), 5, warmup=1) for _ in range(MC_TIMED_ROUNDS)]
        host = [request_ms(lambda: mc_value_and_grad(model, batch), 5, warmup=1) for _ in range(2)]
        log(f"time: multiclass {lik} value and gradient M={MC_M}, B={MC_B}, C={MC_C}: device {min(rounds):.3f} ms "
            f"(rounds {[round(r, 3) for r in rounds]}, spread {max(rounds) - min(rounds):.3f} ms); back to back "
            f"with the host {min(host):.3f} ms (rounds {[round(r, 3) for r in host]})")
    for key, trainer in trainers.items():
        rates = [MC_STEPS / request_ms(lambda: trainer.run_steps_sampled(MC_STEPS, MC_B), 1, warmup=int(i == 0))
                 * 1e3 for i in range(MC_TIMED_ROUNDS)]
        log(f"time: multiclass train {key} at B={MC_B}: {max(rates):.2f} steps/s ({1e3 / max(rates):.3f} ms per "
            f"step); rounds {[round(r, 2) for r in rates]}, spread {max(rates) - min(rates):.2f} steps/s")
    log(f"time: multiclass lbfgs: {lbfgs_eval_s:.4f} s per evaluation")
    Xb, Yb = (torch.from_numpy(a).cuda() for a in requests)
    with torch.no_grad():
        for lik, model in models.items():
            post = posts[lik]
            for key, fn in (("posterior()", model.posterior), ("cached predict_f", lambda: post.predict_f(Xb)),
                            ("fused predict_f", lambda: model.predict_f(Xb)),
                            ("predict_y", lambda: model.predict_y(Xb)),
                            ("predict_log_density", lambda: model.predict_log_density((Xb, Yb)))):
                rounds = [request_ms(fn, 5, warmup=1) for _ in range(MC_TIMED_ROUNDS)]
                log(f"time: multiclass {lik} {key} at B={MC_B}: {min(rounds):.3f} ms per request (rounds "
                    f"{[round(r, 3) for r in rounds]})")
    profile_device(lambda: mc_value_and_grad(models["MultiClass"], batch),
                   f"multiclass MultiClass value and gradient M={MC_M}, B={MC_B}, C={MC_C}", top=12)
    with torch.no_grad():
        for n, m, d in MC_K1_SHAPES:
            time_k1(n, m, iters=20, d=d)


def mc_phases(launches):
    """Phase 18."""
    data, requests, Z = make_mc_data()
    mc_check_objective(data, Z, launches)
    staged = (torch.from_numpy(data[0]).cuda(), torch.from_numpy(data[1]).cuda())
    trainers = {"MultiClass adam": mc_train("MultiClass", None, staged, Z, launches),
                "Softmax adam": mc_train("Softmax", None, staged, Z, launches),
                "MultiClass natgrad fused": mc_train("MultiClass", MC_NG_GAMMA, staged, Z, launches)}
    mc_train("MultiClass", NG_GAMMA, staged, Z, launches, steps=1)  # the Bernoulli point's gamma: logged
    torch.cuda.empty_cache()
    classifier = trainers["MultiClass natgrad fused"].model
    lbfgs_eval_s = mc_lbfgs(classifier, data, launches)
    torch.cuda.empty_cache()
    models = {"MultiClass": classifier, "Softmax": trainers["Softmax adam"].model}
    posts = {lik: mc_serve(model, lik, requests, launches) for lik, model in models.items()}
    torch.cuda.empty_cache()
    mc_scalar_checks(launches)
    torch.cuda.empty_cache()
    k1_err = mc_check_k1(launches)
    mc_timings(models, trainers, lbfgs_eval_s, posts, requests)
    return {"K1": k1_err}


def make_mo_data():
    """Phase 19's data: ((X, Y) of MO_N training points, (Xnew, Ynew) of
    MO_NEW held-out points, the Z of each of MO_P latent GPs, W [P, L]),
    from RandomState(SEED + 40)."""
    rng = np.random.RandomState(SEED + 40)
    X = rng.randn(MO_N + MO_NEW, MO_D).astype(np.float32)
    A = (rng.randn(MO_D, 4) / np.sqrt(MO_D)).astype(np.float32)
    Bm = rng.randn(MO_P, 4).astype(np.float32)
    Y = (np.sin(X @ A) @ Bm.T + MO_NOISE * rng.randn(MO_N + MO_NEW, MO_P)).astype(np.float32)
    Zs = [X[rng.permutation(MO_N)[:MO_M]].copy() for _ in range(MO_P)]
    W = rng.randn(MO_P, MO_L).astype(np.float32)
    return (X[:MO_N], Y[:MO_N]), (X[MO_N:], Y[MO_N:]), Zs, W


def mo_model(route, Zs, W, dtype, values=None, whiten=True):
    """An SVGP of phase 19 on the card in ``dtype``, ``num_data`` = MO_N,
    q_mu zeros and q_sqrt identities, or the constrained ``values`` of
    ``read_values``. Routes: "lmc" (the main model), "lmc fallback" (the
    same on FallbackSeparateIndependentInducingVariables), "shared"
    (SharedIndependent SquaredExponential on shared inducing points),
    "separate" (SeparateIndependent, one kernel and one Z per output) and
    "fully correlated" (InducingPoints, M = MO_FC_M, q(u) over the flattened
    [M * P] vector)."""
    from gpflow_tpu_torch import config, kernels, likelihoods
    from gpflow_tpu_torch.inducing_variables import (
        FallbackSeparateIndependentInducingVariables,
        InducingPoints,
        SeparateIndependentInducingVariables,
        SharedIndependentInducingVariables,
    )
    from gpflow_tpu_torch.models import SVGP
    from gpflow_tpu_torch.utilities import load_jax_values

    def latent(name, factor=1.0):
        return getattr(kernels, name)(lengthscales=np.full(MO_D, factor * np.sqrt(MO_D)))

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        q_mu = q_sqrt = None
        if route in ("lmc", "lmc fallback"):
            kernel = kernels.LinearCoregionalization([latent(n, f) for n, f in MO_LATENTS], W=W)
            cls = SeparateIndependentInducingVariables if route == "lmc" else FallbackSeparateIndependentInducingVariables
            iv = cls([InducingPoints(Zs[i]) for i in range(MO_L)])
        elif route == "shared":
            kernel = kernels.SharedIndependent(latent("SquaredExponential"), MO_P)
            iv = SharedIndependentInducingVariables(InducingPoints(Zs[0]))
        elif route == "separate":
            kernel = kernels.SeparateIndependent([latent(*MO_LATENTS[p % MO_L]) for p in range(MO_P)])
            iv = SeparateIndependentInducingVariables([InducingPoints(Zs[p]) for p in range(MO_P)])
        else:
            kernel = kernels.SharedIndependent(latent("SquaredExponential"), MO_P)
            iv = InducingPoints(Zs[0][:MO_FC_M])
            q_mu, q_sqrt = np.zeros((MO_FC_M * MO_P, 1)), np.eye(MO_FC_M * MO_P)[None]
        model = SVGP(kernel, likelihoods.Gaussian(MO_NOISE), iv, num_latent_gps=kernel.num_latent_gps,
                     q_mu=q_mu, q_sqrt=q_sqrt, whiten=whiten, num_data=MO_N)
    model = model.to(dtype=dtype)
    if values is not None:
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        load_jax_values(model, {k: np.asarray(v).astype(np_dtype) for k, v in values.items()})
    return model


def mo_launches(route, whiten=True):
    """K1 and K2 launches of one ELBO and gradient on ``route``: K1 for Kuu
    and Kuf of each latent kernel (and Kuu again for an unwhitened KL), K2
    in the backward of each Matern52's."""
    if route in ("lmc", "lmc fallback"):
        names = [n for n, _ in MO_LATENTS]
    elif route == "separate":
        names = [MO_LATENTS[p % MO_L][0] for p in range(MO_P)]
    else:
        names = ["SquaredExponential"]
    return {"K1": (2 if whiten else 3) * len(names), "K2": 2 * names.count("Matern52")}


def mo_value_and_grad(model, batch):
    return sparse_value_and_grad(model, lambda m: m.training_loss(batch))


def mo_cond(model64):
    """cond(Kuu + jitter I) (the largest over the latent GPs; the fully
    correlated one as [MP, MP]) and cond(S) of a float64 model."""
    from gpflow_tpu_torch.config import default_jitter
    from gpflow_tpu_torch.covariances import Kuu

    with torch.no_grad():
        kuu = Kuu(model64.inducing_variable, model64.kernel, jitter=default_jitter())
        if kuu.ndim == 4:
            kuu = kuu.reshape(kuu.shape[0] * kuu.shape[1], -1)
        e = torch.linalg.eigvalsh(kuu)
        L = model64.q_sqrt.value
        s = torch.linalg.eigvalsh(L @ L.mT)
    return float((e[..., -1] / e[..., 0]).max()), float((s[:, -1] / s[:, 0]).max())


def mo_batch(data, size):
    X, Y = data
    idx = np.random.RandomState(SEED + 40).randint(0, MO_N, size)
    return torch.from_numpy(X[idx]).cuda(), torch.from_numpy(Y[idx]).cuda()


def mo_check(what, build, values_of, batch, expected, launches, seeds=MO_VALUE_SEEDS, control=True, inv=False):
    """Phase 19a-d and g: the ELBO and its gradient of ``build(dtype,
    values)`` on ``batch`` under sync debug mode "error", against float64 on
    the card on the solve route, on the values ``values_of(seed)`` of each
    of ``seeds``, beside the lower-tier control where ``control``; launch
    counts exactly ``expected``. The float32 model and its control run on
    the INV_SOLVE route where ``inv``. Returns {seed: (values, float32
    result, float64 result)}."""
    from gpflow_tpu_torch.conditionals import inv_solve

    ctl_batch = (bf16(batch[0]).cuda(), batch[1])
    out = {}
    for seed in seeds:
        values = values_of(seed)
        m32, m64 = build(torch.float32, values), build(torch.float64, values)
        label = f"{what}, values seed {seed}"
        c_kuu, c_s = mo_cond(m64)
        log(f"{label}: cond(Kuu + jitter I) {c_kuu:.4e}, cond(S) {c_s:.4e} (float64, jitter 1e-4)")
        with inv_solve(inv):
            torch.cuda.set_sync_debug_mode("error")
            try:
                got, counts = counted(lambda: mo_value_and_grad(m32, batch))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        expect_launches(f"{label}: ELBO and gradient", counts, expected, launches)
        assert bool(torch.isfinite(got[0])), f"{label}: the ELBO is not finite"
        with inv_solve(False):
            want = mo_value_and_grad(m64, tuple(t.double() for t in batch))
        log(f"{label}: ELBO {float(want[0]):.6e}; largest float64 gradient entries "
            + ", ".join(f"{k} {float(g.abs().max()):.3e}" for k, g in want[1].items()))
        ctl_errs = None
        if control:
            ctl = build(torch.float32, bf16_values(values))
            with inv_solve(inv):
                ctl_errs = vgp_errors(run_control(lambda: mo_value_and_grad(ctl, ctl_batch)), want, MO_RTOL)
            del ctl
        judge(label, vgp_errors(got, want, MO_RTOL), ctl_errs)
        out[seed] = (values, got, want)
        del m32, m64
        torch.cuda.empty_cache()
    return out


def mo_check_route(route, data, Zs, W, launches, whiten=True, batch_size=MO_B, **kwargs):
    """``mo_check`` of the SVGP ``mo_model(route, ...)`` on a batch of
    ``batch_size`` training rows, from its start with q(u) moved off it."""
    def build(dtype, values):
        return mo_model(route, Zs, W, dtype, values, whiten)

    def values_of(seed):
        start = build(torch.float32, None)
        return latent_values(start, seed, start.q_mu.shape[1])

    what = (f"multioutput {route}{'' if whiten else ' unwhitened'} objective"
            f"{' on INV_SOLVE' if kwargs.get('inv') else ''} at B={batch_size}")
    return mo_check(what, build, values_of, mo_batch(data, batch_size), mo_launches(route, whiten), launches,
                    **kwargs)


def mo_same_model(main, fallback):
    """Phase 19c: the fallback route computes the main model's ELBO and
    gradient from the same values: float64 against float64 to round-off,
    float32 against float32 within MO_SAME_RTOL."""
    for seed, (_, got_a, want_a) in main.items():
        _, got_c, want_c = fallback[seed]
        errs = vgp_errors(want_c, want_a, {"value": 1e-9, "gradient": 1e-9, "gradient q": 1e-9})
        errs.update({f"float32 {k}": v for k, v in vgp_errors(got_c, got_a, MO_SAME_RTOL).items()})
        judge(f"multioutput fallback route against the main route, values seed {seed}", errs)


def mo_train(route, gamma, staged, Zs, W, launches, steps=MO_STEPS):
    """Phase 19e: ``steps`` steps of ``run_steps_sampled`` over the staged
    MO_N rows under sync debug mode "error", Adam 1e-2 on every parameter
    (``gamma`` None) or fused natural gradients of size ``gamma`` on q(u)
    and Adam on the rest; losses finite and falling, launch counts exact.
    Returns the trainer."""
    from gpflow_tpu_torch.parallel import DataParallelTrainer, adam

    natgrad = gamma is not None
    mode = f"natgrad fused gamma {gamma}" if natgrad else "adam"
    trainer = DataParallelTrainer(mo_model(route, Zs, W, torch.float32), adam(1e-2), natgrad_gamma=gamma,
                                  natgrad_fused=natgrad)
    trainer.stage_data(staged)
    generator = torch.Generator(device="cuda").manual_seed(SEED + 44)
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses, counts = counted(lambda: trainer.run_steps_sampled(steps, MO_B, generator=generator))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses = losses.cpu()
    rejected = trainer.natgrad_rejections if natgrad else 0
    log(f"multioutput train {route} {mode}: {steps} steps at B={MO_B}, losses {[round(float(v), 1) for v in losses]}"
        + (f"; natgrad_rejections {rejected} of {steps}" if natgrad else ""))
    per_step = mo_launches(route)
    expect_launches(f"multioutput train {route} {mode}", counts, {k: steps * v for k, v in per_step.items()},
                    launches)
    assert losses.shape == (steps,) and bool(torch.isfinite(losses).all()), f"{route} {mode}: non-finite loss"
    last = float(losses[-5:].mean())
    log(f"multioutput train {route} {mode}: loss {float(losses[0]):.6e} -> {last:.6e} (mean of the last 5)")
    assert last < float(losses[0]), f"{route} {mode}: the loss did not fall"
    assert rejected < steps, f"{route} {mode}: every natural-gradient step was rejected"
    return trainer


MO_REQUEST_KINDS = {"cached predict_mean": ("mean",), "predict_log_density": ("log density",),
                    "fused predict_f full_output_cov": ("mean", "cov")}


def mo_requests(model, Xb, Yb, launches, label):
    """Requests of MO_NEW points to the main model through ``posterior()``
    (TENSOR cache) with ``predict_f`` and ``predict_mean``, the fused
    ``predict_f`` with and without the full output covariance,
    ``predict_y`` and ``predict_log_density``, with exact launch counts
    where ``launches``: a cache builds Kuu of each latent GP, a cached
    request its Kuf, a fused request both."""
    with torch.no_grad():
        post, counts = counted(model.posterior)
        if launches is not None:
            expect_launches(f"{label} posterior", counts, {"K1": MO_L, "K2": 0}, launches)
        out = {}
        for key, fn, k1 in (("cached predict_f", lambda: post.predict_f(Xb), MO_L),
                            ("cached predict_mean", lambda: (post.predict_mean(Xb),), MO_L),
                            ("fused predict_f", lambda: model.predict_f(Xb), 2 * MO_L),
                            ("fused predict_f full_output_cov", lambda: model.predict_f(Xb, full_output_cov=True),
                             2 * MO_L),
                            ("predict_y", lambda: model.predict_y(Xb), 2 * MO_L),
                            ("predict_log_density", lambda: (model.predict_log_density((Xb, Yb)),), 2 * MO_L)):
            out[key], counts = counted(fn)
            if launches is not None:
                expect_launches(f"{label} {key} request", counts, {"K1": k1, "K2": 0}, launches)
    return out, post


def mo_request_errors(out, want):
    """{output: (error, limit)}, each output relative to its largest float64
    entry (a non-finite one gives NaN, which breaks any limit)."""
    errs = {}
    for key, tensors in out.items():
        for kind, got, w in zip(MO_REQUEST_KINDS.get(key, ("mean", "var")), tensors, want[key]):
            assert got.shape == w.shape, f"{key} {kind}: shape {tuple(got.shape)} != {tuple(w.shape)}"
            errs[f"{key} {kind}"] = (rel_err(got, w), MO_RTOL["requests"][kind])
    return errs


def mo_serve(model, requests, launches):
    """Phase 19f: requests of MO_NEW held-out points to the trained main
    model on the solve and INV_SOLVE routes against its values in float64
    on the card, beside the lower-tier control (the same values with Z and
    the points rounded to bfloat16, TF32 matmuls); variances positive; the
    full output covariance [N, 7, 7] holds the marginal variance on its
    diagonal. Returns the last route's posterior."""
    from gpflow_tpu_torch.conditionals import inv_solve
    from gpflow_tpu_torch.utilities import read_values

    Xb, Yb = (torch.from_numpy(a).cuda() for a in requests)
    placeholders = ([np.zeros((MO_M, MO_D))] * MO_P, np.zeros((MO_P, MO_L)))
    values = read_values(model)
    m64 = mo_model("lmc", *placeholders, torch.float64, values)
    ctl = mo_model("lmc", *placeholders, torch.float32, bf16_values(values))
    want, _ = mo_requests(m64, Xb.double(), Yb.double(), None, "")
    for route, flag in TRAIN_ROUTES:
        with inv_solve(flag):
            out, post = mo_requests(model, Xb, Yb, launches, f"multioutput lmc {route}")
            cout = run_control(lambda: mo_requests(ctl, bf16(Xb), Yb, None, "")[0])
        for key, tensors in out.items():
            assert all(bool(torch.isfinite(t).all()) for t in tensors), f"lmc {route} {key}: not finite"
        judge(f"multioutput lmc {route} requests", mo_request_errors(out, want), mo_request_errors(cout, want))
        mean, var = out["fused predict_f"]
        cov = out["fused predict_f full_output_cov"][1]
        assert mean.shape == var.shape == (MO_NEW, MO_P) and cov.shape == (MO_NEW, MO_P, MO_P)
        assert bool((var > 0).all()) and bool((out["cached predict_f"][1] > 0).all()), "a variance is not positive"
        err = rel_err(torch.diagonal(cov, dim1=-2, dim2=-1), var)
        log(f"multioutput lmc {route}: full output covariance's diagonal against the marginal variance: rel err "
            f"{err:.3e}, tol {MO_DIAG_RTOL:.1e}")
        assert err <= MO_DIAG_RTOL, "the full output covariance's diagonal is not the marginal variance"
    rmse = float(torch.sqrt(torch.mean((out["predict_y"][0] - Yb) ** 2)))
    log(f"multioutput lmc: held-out RMSE {rmse:.4f} over {MO_NEW} points and {MO_P} outputs (Y's std "
        f"{float(Yb.std()):.4f}), mean log density {float(out['predict_log_density'][0].mean()):.4f}")
    return post


def coregion_data(data):
    """Phase 19g's data: MO_B rows [x, output index] drawn from the training
    set with their outputs' Y and index, and MO_M such rows as Z."""
    X, Y = data
    rng = np.random.RandomState(SEED + 45)
    n, p = rng.randint(0, MO_N, MO_B), rng.randint(0, MO_P, MO_B)
    Xs = np.hstack([X[n], p[:, None]]).astype(np.float32)
    Ys = np.stack([Y[n, p], p], axis=1).astype(np.float32)
    Z = np.hstack([X[rng.permutation(MO_N)[:MO_M]], rng.randint(0, MO_P, (MO_M, 1))]).astype(np.float32)
    return (Xs, Ys), Z


def coregion_model(Z, dtype, values=None):
    """SquaredExponential on the 21 inputs times Coregion(7, rank 2) on the
    index column, a SwitchedLikelihood of 7 Gaussians, one latent GP."""
    from gpflow_tpu_torch import config, kernels, likelihoods
    from gpflow_tpu_torch.models import SVGP
    from gpflow_tpu_torch.utilities import load_jax_values

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        kernel = (kernels.SquaredExponential(lengthscales=np.full(MO_D, np.sqrt(MO_D)), active_dims=list(range(MO_D)))
                  * kernels.Coregion(MO_P, rank=2, active_dims=[MO_D]))
        likelihood = likelihoods.SwitchedLikelihood([likelihoods.Gaussian(MO_NOISE) for _ in range(MO_P)])
        model = SVGP(kernel, likelihood, Z, num_latent_gps=1, num_data=MO_N * MO_P)
    model = model.to(dtype=dtype)
    if values is not None:
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        load_jax_values(model, {k: np.asarray(v).astype(np_dtype) for k, v in values.items()})
    return model


def mo_coregion(data, launches):
    """Phase 19g: ``mo_check`` of the Coregion SVGP on MO_B stacked rows,
    on three sets of values (q(u), and Coregion's W and kappa, off their
    start); the SquaredExponential factor reaches K1 (Kuu and Kuf)."""
    (Xs, Ys), Z = coregion_data(data)

    def values_of(seed):
        values = latent_values(coregion_model(Z, torch.float32), seed, 1)
        rng = np.random.RandomState(seed)
        values[".kernel.kernels[1].W"] = 0.5 * rng.randn(MO_P, 2)
        values[".kernel.kernels[1].kappa"] = 0.5 + rng.rand(MO_P)
        return values

    batch = (torch.from_numpy(Xs).cuda(), torch.from_numpy(Ys).cuda())
    mo_check(f"multioutput coregion objective at B={MO_B}", lambda dtype, values: coregion_model(Z, dtype, values),
             values_of, batch, {"K1": 2, "K2": 0}, launches)


def mo_check_kernels():
    """Phase 19h: K1 (rbf and matern52) and K2 (matern52) against their
    plain versions at the D = 21 shapes, inputs N(0, 1 / d) per dimension,
    each with its launch plan; both kernels must run their TMA and their
    edge path, with scalar staging. Returns {kernel: largest absolute
    error against float64}."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 46)
    var = torch.tensor([1.0], device="cuda")
    worst = {"K1": 0.0, "K2": 0.0}
    for kernel, shapes, families in (("K1", MO_K1_SHAPES, ("rbf", "matern52")), ("K2", MO_K2_SHAPES, ("matern52",))):
        seen = set()
        for n, m, d in shapes:
            Xs, Zs = (torch.from_numpy((rng.randn(k, d) / np.sqrt(d)).astype(np.float32)).cuda() for k in (n, m))
            g = torch.from_numpy(rng.randn(n, m).astype(np.float32)).cuda()
            for family in families:
                if kernel == "K1":
                    out = pd.stationary_forward_cuda(family, Xs, Zs, var)
                    plan = plan_seen(kernel, seen)
                    plain32 = pd.stationary_forward_plain(family, Xs, Zs, var)
                    plain64 = pd.stationary_forward_plain(family, Xs.double(), Zs.double(), var.double())
                    tol64, tol32 = K1_ATOL_F64, K1_ATOL_F32
                else:
                    out = pd.stationary_wgrad_cuda(family, Xs, Zs, var, g)
                    plan = plan_seen(kernel, seen)
                    plain32 = pd.stationary_wgrad_plain(family, Xs, Zs, var, g)
                    plain64 = pd.stationary_wgrad_plain(family, Xs.double(), Zs.double(), var.double(), g.double())
                    top = max(float(plain64.abs().max()), 1e-30)
                    tol64, tol32 = K2_RTOL_F64 * top, K2_RTOL_F32 * top
                torch.cuda.synchronize()
                assert out.shape == (n, m) and out.dtype == torch.float32
                err64, err32 = float((out.double() - plain64).abs().max()), float((out - plain32).abs().max())
                log(f"{kernel} {family} ({n}, {m}, {d}): max abs err {err64:.3e} vs plain f64, tol {tol64:.1e}; "
                    f"{err32:.3e} vs plain f32, tol {tol32:.1e}; {plan}")
                assert err64 <= tol64 and err32 <= tol32, f"{kernel} {family} disagrees with its plain version at " \
                                                          f"{(n, m, d)}"
                worst[kernel] = max(worst[kernel], err64)
        log(f"{kernel} at D = {MO_D} ran (tma, vec) = {sorted(seen)}")
        assert seen == {(True, False), (False, False)}, f"{kernel} at D = {MO_D} did not run both its TMA and edge paths"
    return worst


def mo_timings(route_values, data, Zs, W, trainers, post, model, requests):
    """Phase 19i: each route's value and gradient by CUDA events, rounds
    with their spread; Adam and natural-gradient steps per second; request
    latency; a profiler breakdown of one value and gradient of the main
    model on both routes; K1 and K2 at the D = 21 shapes."""
    from gpflow_tpu_torch.conditionals import inv_solve

    for route, values in route_values.items():
        size = MO_FC_B if route == "fully correlated" else MO_B
        batch = mo_batch(data, size)
        m32 = mo_model(route, Zs, W, torch.float32, values)
        rounds = [device_ms(lambda: mo_value_and_grad(m32, batch), 5, warmup=1) for _ in range(MO_TIMED_ROUNDS)]
        log(f"time: multioutput {route} value and gradient at B={size}: device {min(rounds):.3f} ms (rounds "
            f"{[round(r, 3) for r in rounds]}, spread {max(rounds) - min(rounds):.3f} ms)")
        if route == "lmc":
            what = f"multioutput lmc value and gradient M={MO_M}, B={MO_B}, L={MO_L}, P={MO_P}"
            profile_device(lambda: mo_value_and_grad(m32, batch), what, top=12)
            with inv_solve(True):
                rounds = [device_ms(lambda: mo_value_and_grad(m32, batch), 5, warmup=1)
                          for _ in range(MO_TIMED_ROUNDS)]
                log(f"time: multioutput lmc value and gradient on INV_SOLVE at B={size}: device {min(rounds):.3f} ms "
                    f"(rounds {[round(r, 3) for r in rounds]})")
                profile_device(lambda: mo_value_and_grad(m32, batch), f"{what}, INV_SOLVE", top=8)
        del m32
        torch.cuda.empty_cache()
    for key, trainer in trainers.items():
        rates = [MO_STEPS / request_ms(lambda: trainer.run_steps_sampled(MO_STEPS, MO_B), 1, warmup=int(i == 0))
                 * 1e3 for i in range(MO_TIMED_ROUNDS)]
        log(f"time: multioutput train {key} at B={MO_B}: {max(rates):.2f} steps/s ({1e3 / max(rates):.3f} ms per "
            f"step); rounds {[round(r, 2) for r in rates]}, spread {max(rates) - min(rates):.2f} steps/s")
    Xb, Yb = (torch.from_numpy(a).cuda() for a in requests)
    with torch.no_grad():
        for key, fn in (("posterior()", model.posterior), ("cached predict_f", lambda: post.predict_f(Xb)),
                        ("cached predict_mean", lambda: post.predict_mean(Xb)),
                        ("fused predict_f", lambda: model.predict_f(Xb)),
                        ("fused predict_f full_output_cov", lambda: model.predict_f(Xb, full_output_cov=True)),
                        ("predict_y", lambda: model.predict_y(Xb)),
                        ("predict_log_density", lambda: model.predict_log_density((Xb, Yb)))):
            rounds = [request_ms(fn, 5, warmup=1) for _ in range(MO_TIMED_ROUNDS)]
            log(f"time: multioutput lmc {key} at B={MO_NEW}: {min(rounds):.3f} ms per request (rounds "
                f"{[round(r, 3) for r in rounds]})")
        for n, m, d in MO_K1_SHAPES:
            time_k1(n, m, iters=20, d=d)
        for n, m, d in MO_K2_SHAPES[:2]:
            time_k2(n, m, iters=20, d=d)


def mo_phases(launches):
    """Phase 19. Returns {kernel: largest absolute error of its checks}."""
    data, requests, Zs, W = make_mo_data()
    checks = {route: mo_check_route(route, data, Zs, W, launches)
              for route in ("lmc", "shared", "separate", "lmc fallback")}
    mo_same_model(checks["lmc"], checks["lmc fallback"])
    seed = MO_VALUE_SEEDS[0]
    mo_check_route("lmc", data, Zs, W, launches, seeds=(seed,), inv=True)
    fc = mo_check_route("fully correlated", data, Zs, W, launches, batch_size=MO_FC_B, seeds=(seed,), control=False)
    mo_check_route("fully correlated", data, Zs, W, launches, whiten=False, batch_size=MO_FC_B, seeds=(seed,),
                   control=False)
    route_values = {route: out[seed][0] for route, out in checks.items()}
    route_values["fully correlated"] = fc[seed][0]
    del checks, fc
    torch.cuda.empty_cache()
    staged = (torch.from_numpy(data[0]).cuda(), torch.from_numpy(data[1]).cuda())
    trainers = {"lmc adam": mo_train("lmc", None, staged, Zs, W, launches),
                "shared adam": mo_train("shared", None, staged, Zs, W, launches),
                "lmc natgrad fused": mo_train("lmc", MO_NG_GAMMA, staged, Zs, W, launches)}
    model = trainers["lmc natgrad fused"].model
    post = mo_serve(model, requests, launches)
    torch.cuda.empty_cache()
    mo_coregion(data, launches)
    torch.cuda.empty_cache()
    errs = mo_check_kernels()
    mo_timings(route_values, data, Zs, W, trainers, post, model, requests)
    return errs


def hmc_model(cls, data, Z, dtype):
    """The Bernoulli GPMC or SGPMC of phase 20 on the card in ``dtype``:
    Matern32 (variance 1, lengthscales 1) with LogNormal priors, V zeros;
    SGPMC's Z frozen."""
    from gpflow_tpu_torch import config, kernels, likelihoods, models, priors, set_trainable

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        kernel = kernels.Matern32(lengthscales=np.ones(D))
        kernel.variance.prior = priors.LogNormal(*HMC_PRIOR)
        kernel.lengthscales.prior = priors.LogNormal(*HMC_PRIOR)
        if cls == "GPMC":
            model = models.GPMC(data, kernel, likelihoods.Bernoulli())
        else:
            model = models.SGPMC(data, kernel, likelihoods.Bernoulli(), inducing_variable=Z)
            set_trainable(model.inducing_variable, False)
    return model.to(dtype=dtype)


def hmc_helper(model):
    """``SamplingHelper`` over the model's trainable parameters, and their
    paths in the same order."""
    from gpflow_tpu_torch.optimizers import SamplingHelper
    from gpflow_tpu_torch.utilities import parameter_dict

    params = model.trainable_parameters
    paths = {id(p): path for path, p in parameter_dict(model).items()}
    return SamplingHelper(model.log_posterior_density, params), [paths[id(p)] for p in params]


def hmc_launches(cls):
    """K1 and K2 launches of one value and gradient of the target: K1 for
    K(X) (GPMC) or Kuu and Kuf (SGPMC), K2 in the backward of each."""
    n = 1 if cls == "GPMC" else 2
    return {"K1": n, "K2": n}


def hmc_value_and_grad(helper, state):
    q = [s.detach().requires_grad_() for s in state]
    value = helper.target_log_prob_fn(*q)
    return value.detach(), torch.autograd.grad(value, q)


def hmc_errors(got, want, paths):
    """{output: (error, limit)} of a target value and gradient against float64."""
    (value, grads), (value64, grads64) = got, want
    out = {"value": (abs(float(value) - float(value64)) / abs(float(value64)), HMC_RTOL["value"])}
    for path, g, g64 in zip(paths, grads, grads64):
        out[f"gradient {path}"] = (rel_err(g, g64), HMC_RTOL["gradient"])
    return out


def hmc_perturbed(state):
    """The state moved off its start: V by N(0, 0.25), the kernel's
    unconstrained values by N(0, 0.09), from a seed (float32)."""
    rng = np.random.RandomState(HMC_SEEDS["state"])
    scales = [0.5 if s.numel() > D else 0.3 for s in state]
    return [s + torch.from_numpy(np.asarray(c * rng.randn(*s.shape), dtype=np.float32)).cuda()
            for s, c in zip(state, scales)]


def hmc_check(what, cls, models, states, launches):
    """Phase 20a/b: the target and its gradient of the float32 model under
    sync debug mode "error", with exact launch counts, against float64 on
    the card and the lower-tier control (K1 fed bfloat16-rounded X and Z,
    TF32 matmuls) at each of ``states`` ({name: float32 state})."""
    m32, m64, ctl = models
    (h32, paths), (h64, _), (hctl, _) = hmc_helper(m32), hmc_helper(m64), hmc_helper(ctl)
    for name, state in states.items():
        label = f"{what} target at the {name} state"
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, counts = counted(lambda: hmc_value_and_grad(h32, state))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        expect_launches(f"{label}: value and gradient", counts, hmc_launches(cls), launches)
        want = hmc_value_and_grad(h64, [s.double() for s in state])
        log(f"{label}: log density {float(want[0]):.6e}; largest float64 gradient entries "
            + ", ".join(f"{p} {float(g.abs().max()):.3e}" for p, g in zip(paths, want[1])))
        control = run_control(lambda: hmc_value_and_grad(hctl, state))
        judge(label, hmc_errors(got, want, paths), hmc_errors(control, want, paths))


def hmc_chain(what, cls, helper, launches):
    """Phase 20a/b: ``run_hmc`` under sync debug mode "error": HMC_BURNIN
    adapted steps and HMC_SAMPLES kept ones of HMC_LEAPFROG leapfrog steps,
    log probabilities finite, launch counts exactly one value and gradient
    per leapfrog step and one at the start. Returns the samples and the
    chain's seconds."""
    from gpflow_tpu_torch.optimizers import run_hmc

    generator = torch.Generator(device="cuda").manual_seed(HMC_SEEDS["chain"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (samples, log_probs), counts = counted(lambda: run_hmc(
            helper.target_log_prob_fn, helper.current_state, num_samples=HMC_SAMPLES,
            num_burnin_steps=HMC_BURNIN, step_size=HMC_STEP, num_leapfrog_steps=HMC_LEAPFROG,
            generator=generator, adapt_step_size=True, target_accept=HMC_TARGET))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    seconds = time.perf_counter() - t0
    steps = HMC_BURNIN + HMC_SAMPLES
    evaluations = 1 + steps * HMC_LEAPFROG
    expect_launches(f"{what} chain", counts, {k: v * evaluations for k, v in hmc_launches(cls).items()}, launches)
    lp = log_probs.cpu()
    assert bool(torch.all(torch.isfinite(lp))), f"{what}: a kept log probability is not finite"
    moved = torch.stack([(s[1:] != s[:-1]).reshape(len(s) - 1, -1).any(1) for s in samples]).any(0)
    log(f"{what} chain: {steps} steps ({HMC_BURNIN} adapting, {HMC_SAMPLES} kept) of {HMC_LEAPFROG} leapfrog steps, "
        f"{evaluations} values and gradients in {seconds:.2f} s ({1e3 * seconds / steps:.2f} ms per step); "
        f"acceptance over the kept steps {float(moved.double().mean()):.3f} (target {HMC_TARGET}); log probability "
        f"first kept {float(lp[0]):.6e}, last {float(lp[-1]):.6e}")
    return samples, seconds


def hmc_predict(what, model, helper, samples, Xnew, Ynew, launches):
    """Phase 20a/b: ``predict_y`` averaged over the kept samples on the
    held-out points, which must beat the majority-class rate; two K1
    launches a sample (Kuu and Kuf, or K(X) and K(X, Xnew))."""
    def average():
        total = 0.0
        for j in range(HMC_SAMPLES):
            helper.assign_values([s[j] for s in samples])
            total = total + model.predict_y(Xnew)[0]
        return total / HMC_SAMPLES

    with torch.no_grad():
        p, counts = counted(average)
    expect_launches(f"{what} posterior predictive", counts, {"K1": 2 * HMC_SAMPLES, "K2": 0}, launches)
    p = p.cpu().numpy()
    assert np.all(np.isfinite(p)) and np.all((p >= 0) & (p <= 1)), f"{what}: predictive probabilities"
    y = Ynew.cpu().numpy()
    accuracy = float(np.mean((p > 0.5) == (y > 0.5)))
    majority = float(max(y.mean(), 1 - y.mean()))
    log(f"{what} posterior predictive over {HMC_SAMPLES} samples on {len(y)} held-out points: accuracy "
        f"{accuracy:.4f}, majority-class rate {majority:.4f}")
    assert accuracy > majority, f"{what}: the posterior predictive does not beat the majority class"


def hmc_f_samples(model, Xnew, launches):
    """Phase 20b: ``predict_f_samples(full_cov=True)`` of GPMC on the
    held-out points; where float32's Cholesky of the [N, N] predictive
    covariance fails at the jitter (NaN draws), the finding is logged and
    the check runs with ``full_cov=False``. The draws' mean and variance
    must match ``predict_f``'s within HMC_COND_Z standard errors."""
    from gpflow_tpu_torch.config import default_jitter

    S = 200
    with torch.no_grad():
        mean, var = model.predict_f(Xnew)
        for full_cov in (True, False):
            generator = torch.Generator(device="cuda").manual_seed(HMC_SEEDS["samples"])
            draws, counts = counted(lambda: model.predict_f_samples(Xnew, num_samples=S, full_cov=full_cov,
                                                                    generator=generator))
            # K(X), K(X, Xnew), and K(Xnew) with full_cov
            expect_launches(f"gpmc predict_f_samples full_cov={full_cov}", counts, {"K1": 3 if full_cov else 2, "K2": 0},
                            launches)
            assert draws.shape == (S,) + tuple(mean.shape)
            if bool(torch.all(torch.isfinite(draws))):
                break
            assert full_cov, "gpmc predict_f_samples(full_cov=False) is not finite"
            log(f"gpmc predict_f_samples: FINDING: float32's Cholesky of the [{len(Xnew)}, {len(Xnew)}] predictive "
                f"covariance fails at the jitter {default_jitter()}; checking full_cov=False")
    hmc_moments(f"gpmc predict_f_samples full_cov={full_cov}", draws, mean, var)


def hmc_moments(what, draws, mean, var):
    """The draws' mean within HMC_COND_Z standard errors of ``mean`` and
    their variance within HMC_COND_Z standard errors of ``var``."""
    S = draws.shape[0]
    z_mean = float(((draws.double().mean(0) - mean.double()) / torch.sqrt(var.double() / S)).abs().max())
    z_var = float(((draws.double().var(0) / var.double() - 1.0) / np.sqrt(2.0 / (S - 1))).abs().max())
    log(f"{what}: {S} draws; largest standardized error of the mean {z_mean:.3f}, of the variance {z_var:.3f} "
        f"(limit {HMC_COND_Z})")
    assert z_mean <= HMC_COND_Z and z_var <= HMC_COND_Z, f"{what}: the draws' moments disagree"


def hmc_sampler_checks(model64, state):
    """Phase 20c: float64 leapfrog on the card from ``state``: forward then
    back with the momentum negated returns to the start; |dH| falls by about
    4 per halving of the step at a fixed trajectory length."""
    from gpflow_tpu_torch.optimizers import mcmc

    helper, _ = hmc_helper(model64)

    def value_and_grad(q):
        return mcmc._value_and_grad(helper.target_log_prob_fn, q)

    def kinetic(p):
        return sum(0.5 * float(torch.sum(pi * pi)) for pi in p)

    q0 = tuple(s.double() for s in state)
    logp0, g0 = value_and_grad(q0)
    rng = np.random.RandomState(HMC_SEEDS["momentum"])
    ratios = []
    for k in range(HMC_DH_MOMENTA):
        p0 = tuple(torch.from_numpy(np.asarray(rng.randn(*s.shape))).cuda() for s in q0)
        dh = []
        for halvings in range(3):
            step = torch.tensor(HMC_DH_STEP / 2 ** halvings, dtype=torch.float64, device="cuda")
            steps = HMC_LEAPFROG * 2 ** halvings
            q1, p1, logp1, g1 = mcmc._leapfrog(value_and_grad, q0, p0, g0, step, steps)
            dh.append(abs((-float(logp1) + kinetic(p1)) - (-float(logp0) + kinetic(p0))))
            if halvings == 0 and k == 0:
                q2, p2, _, _ = mcmc._leapfrog(value_and_grad, q1, tuple(-p for p in p1), g1, step, steps)
                err_q = max(rel_err(a, b) for a, b in zip(q2, q0))
                err_p = max(rel_err(-a, b) for a, b in zip(p2, p0))
                log(f"hmc reversibility (sgpmc, float64, {steps} steps of {HMC_DH_STEP}): position {err_q:.3e}, "
                    f"momentum {err_p:.3e} (limit {HMC_REVERSE_RTOL:.0e})")
                assert err_q <= HMC_REVERSE_RTOL and err_p <= HMC_REVERSE_RTOL, "the leapfrog is not reversible"
        ratios += [dh[0] / dh[1], dh[1] / dh[2]]
        log(f"hmc energy error (sgpmc, float64, momentum {k}): |dH| {dh[0]:.4e}, {dh[1]:.4e}, {dh[2]:.4e} at steps "
            f"{HMC_DH_STEP}, /2, /4; ratios {dh[0] / dh[1]:.3f}, {dh[1] / dh[2]:.3f}")
    assert all(HMC_DH_RATIO[0] <= r <= HMC_DH_RATIO[1] for r in ratios), \
        f"|dH| does not fall as step^2: ratios {ratios}, limits {HMC_DH_RATIO}"


def hmc_oracle(cls):
    """Phase 20c: the JAX package's conjugate oracle for ``cls`` in float64
    on the card (``tests/gpflow_tpu/models/test_hmc_conjugate_oracle.py``)."""
    from gpflow_tpu_torch import config, kernels, likelihoods, models, set_trainable
    from gpflow_tpu_torch.optimizers import SamplingHelper, run_hmc

    rng = np.random.RandomState(11)
    n, noise = 40, 0.05
    X = np.sort(rng.rand(n, 1) * 4.0, axis=0)
    Y = np.sin(2.0 * X) + np.sqrt(noise) * rng.randn(n, 1)
    with config.as_context(dataclasses.replace(config.config(), float=torch.float64)):
        kernel = kernels.SquaredExponential(variance=1.2, lengthscales=0.7)
        if cls == "GPMC":
            model = models.GPMC((X, Y), kernel, likelihoods.Gaussian(noise))
            Xu = X
        else:
            Xu = np.linspace(X.min(), X.max(), 8)[:, None]
            model = models.SGPMC((X, Y), kernel, likelihoods.Gaussian(noise), inducing_variable=Xu.copy())
            set_trainable(model.inducing_variable, False)
            sgpr = models.SGPR((X, Y), kernels.SquaredExponential(variance=1.2, lengthscales=0.7),
                               inducing_variable=Xu.copy(), noise_variance=noise)
        set_trainable(model.kernel, False)
        set_trainable(model.likelihood, False)
        helper = SamplingHelper(model.log_posterior_density, model.trainable_parameters)
        assert len(helper.current_state) == 1  # V only
        t0 = time.perf_counter()
        samples, log_probs = run_hmc(helper.target_log_prob_fn, helper.current_state,
                                     num_samples=HMC_ORACLE_SAMPLES, num_burnin_steps=HMC_ORACLE_BURNIN,
                                     step_size=0.08, num_leapfrog_steps=12, adapt_step_size=True,
                                     generator=torch.Generator(device="cuda").manual_seed(3))
        assert bool(torch.all(torch.isfinite(log_probs))), f"{cls} oracle chain: a log probability is not finite"
        seconds = time.perf_counter() - t0
        with torch.no_grad():
            K = model.kernel(torch.from_numpy(Xu).cuda()).cpu().numpy() + config.default_jitter() * np.eye(len(Xu))
            if cls == "GPMC":
                Kn_inv = np.linalg.inv(K + noise * np.eye(n))
                mean, var = (K @ Kn_inv @ Y)[:, 0], np.diag(K - K @ Kn_inv @ K)
            else:
                qu_mean, qu_cov = sgpr.compute_qu()
                mean, var = qu_mean.cpu().numpy()[:, 0], np.diag(qu_cov.cpu().numpy())
    f = samples[0].cpu().numpy()[..., 0] @ np.linalg.cholesky(K).T  # [S, n] or [S, M]
    S = f.shape[0]
    a = f - f.mean(0)
    lag1 = np.abs(np.sum(a[1:] * a[:-1], 0)) / (np.sum(a * a, 0) + 1e-12)
    ess = S * (1 - lag1) / (1 + lag1)
    mc_se = np.sqrt(var / np.maximum(ess, 10.0))
    err = np.abs(f.mean(0) - mean)
    ratio = float(np.mean(f.var(0) / var))
    log(f"hmc oracle {cls} (float64, {HMC_ORACLE_BURNIN} + {S} steps of 12, {seconds:.2f} s): largest mean error "
        f"{float(np.max(err / (5.0 * mc_se + 1e-3))):.3f} of its limit (5 MC SE + 1e-3), least ESS {ess.min():.0f}; "
        f"mean variance ratio {ratio:.3f} (limits 0.75, 1.25)")
    assert np.all(err < 5.0 * mc_se + 1e-3), f"{cls} oracle: the posterior mean is off"
    assert 0.75 < ratio < 1.25, f"{cls} oracle: the posterior variance is off"


def hmc_sample_conditional(launches):
    """Phase 20d: ``sample_conditional`` on phase 19's LinearCoregionalization
    with q(u) off its start, at the 4449 request points, full_cov=False:
    the draws' moments against the conditional's mean and variance; K1 for
    Kuu and Kuf of each latent GP."""
    from gpflow_tpu_torch.conditionals import sample_conditional

    _, requests, Zs, W = make_mo_data()
    start = mo_model("lmc", Zs, W, torch.float32)
    model = mo_model("lmc", Zs, W, torch.float32, latent_values(start, MO_VALUE_SEEDS[0], MO_L))
    Xnew = torch.from_numpy(requests[0]).cuda()
    generator = torch.Generator(device="cuda").manual_seed(HMC_SEEDS["conditional"])
    with torch.no_grad():
        (draws, mean, var), counts = counted(lambda: sample_conditional(
            Xnew, model.inducing_variable, model.kernel, model.q_mu.value, q_sqrt=model.q_sqrt.value, white=True,
            full_cov=False, num_samples=HMC_COND_SAMPLES, generator=generator))
    expect_launches("multioutput sample_conditional", counts, {"K1": 2 * MO_L, "K2": 0}, launches)
    assert draws.shape == (HMC_COND_SAMPLES, MO_NEW, MO_P) and mean.shape == var.shape == (MO_NEW, MO_P)
    hmc_moments(f"multioutput sample_conditional at {MO_NEW} points", draws, mean, var)


def hmc_check_kernels():
    """Phase 20e: K1 and K2 (matern32) against their plain versions at the
    path's shapes, inputs uniform on [0, 4]^8 as the path's. Returns
    {kernel: largest absolute error against float64}."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 55)
    var = torch.tensor([1.3], device="cuda")
    worst = {"K1": 0.0, "K2": 0.0}
    for kernel, shapes in (("K1", HMC_K1_SHAPES), ("K2", HMC_K2_SHAPES)):
        seen = set()
        for n, m, d in shapes:
            Xs, Zs = (torch.from_numpy((rng.rand(k, d) * 4).astype(np.float32)).cuda() for k in (n, m))
            if kernel == "K1":
                out = pd.stationary_forward_cuda("matern32", Xs, Zs, var)
                plan = plan_seen(kernel, seen)
                plain32 = pd.stationary_forward_plain("matern32", Xs, Zs, var)
                plain64 = pd.stationary_forward_plain("matern32", Xs.double(), Zs.double(), var.double())
                tol64, tol32 = K1_ATOL_F64 * 1.3, K1_ATOL_F32 * 1.3
            else:
                g = torch.from_numpy(rng.randn(n, m).astype(np.float32)).cuda()
                out = pd.stationary_wgrad_cuda("matern32", Xs, Zs, var, g)
                plan = plan_seen(kernel, seen)
                plain32 = pd.stationary_wgrad_plain("matern32", Xs, Zs, var, g)
                plain64 = pd.stationary_wgrad_plain("matern32", Xs.double(), Zs.double(), var.double(), g.double())
                top = max(float(plain64.abs().max()), 1e-30)
                tol64, tol32 = K2_RTOL_F64 * top, K2_RTOL_F32 * top
            torch.cuda.synchronize()
            assert out.shape == (n, m) and out.dtype == torch.float32
            err64, err32 = float((out.double() - plain64).abs().max()), float((out - plain32).abs().max())
            log(f"{kernel} matern32 ({n}, {m}, {d}): max abs err {err64:.3e} vs plain f64, tol {tol64:.1e}; "
                f"{err32:.3e} vs plain f32, tol {tol32:.1e}; {plan}")
            assert err64 <= tol64 and err32 <= tol32, f"{kernel} matern32 disagrees with its plain version at {(n, m, d)}"
            worst[kernel] = max(worst[kernel], err64)
    return worst


def hmc_timings(helpers, states, chain_seconds):
    """Phase 20e: each model's target value and gradient (CUDA events, three
    rounds of 5), ms per HMC step from the chain, a profile of one SGPMC
    value and gradient and of one SGPMC step of HMC_LEAPFROG leapfrog steps,
    and K1 and K2 (matern32) at the path's shapes."""
    from gpflow_tpu_torch._compile import jit
    from gpflow_tpu_torch.optimizers import mcmc

    for what, helper in helpers.items():
        rounds = [request_ms(lambda: hmc_value_and_grad(helper, states[what]), 5, warmup=1) for _ in range(3)]
        log(f"time: {what} target value and gradient: {min(rounds):.3f} ms (rounds {[round(r, 3) for r in rounds]})")
        log(f"time: {what} HMC step of {HMC_LEAPFROG} leapfrog steps: "
            f"{1e3 * chain_seconds[what] / (HMC_BURNIN + HMC_SAMPLES):.2f} ms (the chain: {chain_seconds[what]:.2f} s, "
            "its step's trace included; phase 29 times a step alone)")
    sgpmc = helpers["sgpmc"]
    profile_device(lambda: hmc_value_and_grad(sgpmc, states["sgpmc"]), "sgpmc target value and gradient")
    # one step as run_hmc replays it: traced at the profile's warm-up call, replayed in its window
    target, state = sgpmc.target_log_prob_fn, tuple(states["sgpmc"])
    generator = torch.Generator(device="cuda").manual_seed(HMC_SEEDS["chain"])
    step = jit(lambda *args: mcmc._hmc_step(target, generator, HMC_LEAPFROG, float(np.log(10.0 * HMC_STEP)), HMC_TARGET,
                                            *args))
    logp, g = mcmc._value_and_grad(target, state)
    log_step = torch.full((), np.log(HMC_STEP), dtype=logp.dtype, device="cuda")
    profile_device(lambda: step(state, g, logp, log_step, log_step, torch.zeros_like(logp),
                                torch.zeros((5,), dtype=logp.dtype)),
                   f"one sgpmc HMC step, a replay ({HMC_LEAPFROG} values and gradients)")
    with torch.no_grad():
        for n, m, d in HMC_K1_SHAPES:
            time_k1(n, m, iters=20, d=d, family="matern32")
        for n, m, d in HMC_K2_SHAPES:
            time_k2(n, m, iters=20, family="matern32", d=d)


def hmc_phases(launches):
    """Phase 20. Returns {kernel: largest absolute error of its checks}."""
    X, Y, Z, Xnew, Ynew = make_ng_data()
    requests = (torch.from_numpy(Xnew).cuda(), torch.from_numpy(Ynew).cuda())
    helpers, states, seconds = {}, {}, {}
    for cls, data in (("SGPMC", (X, Y)), ("GPMC", (X[:HMC_GPMC_N], Y[:HMC_GPMC_N]))):
        what = cls.lower()
        m32, m64 = hmc_model(cls, data, Z, torch.float32), hmc_model(cls, data, Z, torch.float64)
        ctl = hmc_model(cls, (bf16(data[0]).numpy(), data[1]), bf16(Z).numpy(), torch.float32)
        helper, paths = hmc_helper(m32)
        log(f"{what}: state {paths}, {sum(s.numel() for s in helper.current_state)} dimensions")
        start = helper.current_state
        samples, seconds[what] = hmc_chain(what, cls, helper, launches)
        after_burnin = [s[0].clone() for s in samples]
        hmc_check(what, cls, (m32, m64, ctl), {"initial": start, "perturbed": hmc_perturbed(start),
                                              "after burn-in": after_burnin}, launches)
        hmc_predict(what, m32, helper, samples, *requests, launches)
        if cls == "GPMC":
            hmc_f_samples(m32, requests[0], launches)
        else:
            hmc_sampler_checks(m64, after_burnin)
        helpers[what], states[what] = helper, after_burnin
        del m64, ctl
        torch.cuda.empty_cache()
    hmc_oracle("GPMC")
    hmc_oracle("SGPMC")
    hmc_sample_conditional(launches)
    torch.cuda.empty_cache()
    errs = hmc_check_kernels()
    hmc_timings(helpers, states, seconds)
    return errs



def make_gl_data(n):
    """Phase 21: Y [n, GL_P] on the manifold, float64 on the host."""
    W = np.random.RandomState(GL_SEEDS["W"]).randn(GL_Q, GL_P)
    rng = np.random.RandomState(GL_SEEDS["data"] + n)
    t = rng.randn(n, GL_Q)
    return np.tanh(t @ W / np.sqrt(GL_Q)) + 0.05 * rng.randn(n, GL_P)


def gl_bgplvm(Y, m, dtype, values=None):
    """Phase 21: a BayesianGPLVM on the card in ``dtype``: X_data_mean from
    PCA, Z m of its rows picked by numpy's global generator seeded
    GL_SEEDS["Z"]; or the constrained ``values`` of ``read_values``."""
    from gpflow_tpu_torch import config, kernels
    from gpflow_tpu_torch.models import BayesianGPLVM
    from gpflow_tpu_torch.utilities import load_jax_values
    from gpflow_tpu_torch.utilities.ops import pca_reduce

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        X_mean = pca_reduce(Y, GL_Q)
        np.random.seed(GL_SEEDS["Z"])
        model = BayesianGPLVM(Y, X_mean, torch.full_like(X_mean, GL_XVAR),
                              kernels.SquaredExponential(lengthscales=[1.0] * GL_Q), num_inducing_variables=m)
        model.likelihood.variance.assign(GL_NOISE)
    if values is not None:
        load_jax_values(model, values)
    return model


def gl_gplvm(Y, kernel, dtype, values=None):
    """Phase 21c: a GPLVM on the card in ``dtype``, X from PCA,
    ``kernel`` with Q lengthscales 1, noise GL_NOISE; or ``values``."""
    from gpflow_tpu_torch import config, kernels
    from gpflow_tpu_torch.models import GPLVM
    from gpflow_tpu_torch.utilities import load_jax_values

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        model = GPLVM(Y, latent_dim=GL_Q, kernel=getattr(kernels, kernel)(lengthscales=[1.0] * GL_Q))
        model.likelihood.variance.assign(GL_NOISE)
    if values is not None:
        load_jax_values(model, values)
    return model


def gl_bf16(values, keys):
    """``values`` with the arrays at ``keys`` rounded as ``bf16``: the
    lower-tier control's."""
    return {k: bf16(v).numpy() if k in keys else v for k, v in values.items()}


def gl_perturbed(values, x_key):
    """``values`` moved off their point: the latent means by 0.3 N(0, 1),
    the lengthscales by a factor exp(0.2 N(0, 1)) each."""
    rng = np.random.RandomState(GL_SEEDS["perturb"])
    out = dict(values)
    out[x_key] = values[x_key] + 0.3 * rng.randn(*values[x_key].shape)
    ls = values[".kernel.lengthscales"]
    out[".kernel.lengthscales"] = ls * np.exp(0.2 * rng.randn(*ls.shape))
    return out


def gl_loss(model):
    return model.training_loss()


def gl_errors(got, want, kind=""):
    """{output: (error, limit)} of a ``sparse_value_and_grad`` result against
    float64: the value relative to itself, each gradient relative to its
    largest float64 entry."""
    (value, grads), (value64, grads64) = got, want
    out = {"value": (abs(float(value) - float(value64)) / abs(float(value64)), GL_RTOL[f"{kind}value"])}
    for path, want_g in grads64.items():
        out[f"gradient {path}"] = (rel_err(grads[path], want_g), GL_RTOL[f"{kind}gradient"])
    return out


def count_syncs(fn):
    """``fn()`` under sync debug mode "warn": its result and the number of
    host synchronisations torch warned of."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def without_syncs(fn):
    """``fn()`` under sync debug mode "error": a host sync fails."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def gl_check_bgplvm(what, Y, m, values, launches, m64=None):
    """Phase 21a-b: the float32 bound and its gradient with respect to every
    trainable parameter against float64 on the card (``m64``, else one built
    from ``values``) and beside the lower-tier control, with exact launch
    counts; the float32 path's host syncs are counted (GL_F32_SYNCS:
    ``torch.linalg.eigh``'s error check), the float64 one runs under sync
    debug mode "error". Returns the float32 model."""
    m32 = gl_bgplvm(Y, m, torch.float32, values)
    (got, counts), syncs = count_syncs(lambda: counted(lambda: sparse_value_and_grad(m32, gl_loss)))
    expect_launches(f"{what} float32 value and gradient", counts, {"K1": 1, "K2": 0}, launches)
    log(f"{what}: the float32 value and gradient synchronised the host {syncs} times")
    assert syncs == GL_F32_SYNCS, f"{what}: {syncs} host syncs in the float32 value and gradient"
    m64 = gl_bgplvm(Y, m, torch.float64, values) if m64 is None else m64
    want = without_syncs(lambda: sparse_value_and_grad(m64, gl_loss))
    ctl = gl_bgplvm(Y, m, torch.float32, gl_bf16(values, (".X_data_mean", ".inducing_variable.Z")))
    control = run_control(lambda: sparse_value_and_grad(ctl, gl_loss))
    log(f"{what}: bound {-float(got[0]):.8e} (float64 {-float(want[0]):.8e})")
    judge(what, gl_errors(got, want), gl_errors(control, want))
    return m32


def gl_predict(what, m32, m64, ctl, Xnew, launches):
    """Phase 21a-b: ``predict_f`` with and without ``full_cov`` against
    float64 and beside the control, with exact launch counts (Kuu, Kuf and,
    with ``full_cov``, K(Xnew))."""
    for full_cov in (False, True):
        with torch.no_grad():
            (out, counts), syncs = count_syncs(lambda: counted(lambda: m32.predict_f(Xnew, full_cov=full_cov)))
            expect_launches(f"{what} predict_f full_cov={full_cov}", counts, {"K1": 2 + full_cov, "K2": 0}, launches)
            assert syncs == GL_F32_SYNCS, f"{what}: {syncs} host syncs in predict_f"
            want = m64.predict_f(Xnew.double(), full_cov=full_cov)
            control = run_control(lambda: ctl.predict_f(bf16(Xnew).cuda(), full_cov=full_cov))
        assert all(bool(torch.all(torch.isfinite(t))) for t in out), f"{what}: predict_f is not finite"
        assert float(want[1].diagonal(dim1=-2, dim2=-1).min() if full_cov else want[1].min()) > 0
        judge(f"{what} predict_f full_cov={full_cov}",
              {"mean": (rel_err(out[0], want[0]), GL_RTOL["mean"]), "variance": (rel_err(out[1], want[1]), GL_RTOL["variance"])},
              {"mean": (rel_err(control[0], want[0]), None), "variance": (rel_err(control[1], want[1]), None)})


def gl_quadrature(Y, launches):
    """Phase 21a: the analytic SquaredExponential psi0, psi1 and psi2 of a
    DiagonalGaussian at Q = 2 (X from PCA, Z 50 of its rows) against the
    quadrature fallback with GL_QUAD_NGHP points a dimension: Kuf at
    N * 400 points, one K1 launch for psi1 and two for psi2; both float32
    results against the analytic float64 ones, beside the control."""
    from gpflow_tpu_torch import config, kernels
    from gpflow_tpu_torch.expectations import expectation, quadrature_expectation
    from gpflow_tpu_torch.inducing_variables import InducingPoints
    from gpflow_tpu_torch.probability_distributions import DiagonalGaussian
    from gpflow_tpu_torch.utilities.ops import pca_reduce

    with config.as_context(dataclasses.replace(config.config(), float=torch.float64)):
        mu = pca_reduce(Y, GL_QUAD_Q).cpu().numpy()
    Z = mu[np.random.RandomState(GL_SEEDS["Z"]).permutation(len(mu))[:GL_M]]
    var = np.full_like(mu, GL_XVAR)

    def stats(dtype, mu, Z, quad):
        with config.as_context(dataclasses.replace(config.config(), float=dtype)), torch.no_grad():
            k = kernels.SquaredExponential(variance=1.3, lengthscales=[1.0] * GL_QUAD_Q)
            iv = InducingPoints(torch.as_tensor(np.asarray(Z, np.float64), dtype=dtype))
            p = DiagonalGaussian(*(torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device="cuda")
                                   for a in (mu, var)))
            if quad:
                return {"psi0": quadrature_expectation(p, k, nghp=GL_QUAD_NGHP),
                        "psi1": quadrature_expectation(p, (k, iv), nghp=GL_QUAD_NGHP),
                        "psi2": quadrature_expectation(p, (k, iv), (k, iv), nghp=GL_QUAD_NGHP)}
            return {"psi0": expectation(p, k), "psi1": expectation(p, (k, iv)), "psi2": expectation(p, (k, iv), (k, iv))}

    want = stats(torch.float64, mu, Z, False)
    got, counts = counted(lambda: stats(torch.float32, mu, Z, True))
    expect_launches(f"psi statistics by quadrature at Q = {GL_QUAD_Q}, N = {GL_N}, nghp = {GL_QUAD_NGHP}", counts,
                    {"K1": 3, "K2": 0}, launches)
    control = run_control(lambda: stats(torch.float32, bf16(mu).numpy(), bf16(Z).numpy(), True))
    judge(f"psi statistics: float32 quadrature (K1 at ({GL_M}, {GL_N * GL_QUAD_NGHP ** GL_QUAD_Q}, {GL_QUAD_Q})) "
          f"against the analytic float64",
          {k: (rel_err(got[k], want[k]), GL_RTOL["quadrature"]) for k in want},
          {k: (rel_err(control[k], want[k]), None) for k in want})
    del got, control
    torch.cuda.empty_cache()
    got = stats(torch.float32, mu, Z, False)
    control = run_control(lambda: stats(torch.float32, bf16(mu).numpy(), bf16(Z).numpy(), False))
    judge("psi statistics: analytic float32 against float64",
          {k: (rel_err(got[k], want[k]), GL_RTOL["psi"]) for k in want},
          {k: (rel_err(control[k], want[k]), None) for k in want})


def gl_small(launches):
    """Phase 21a: BayesianGPLVM at N = GL_N, M = GL_M: GL_MAXITER float64
    L-BFGS iterations from PCA, which must raise the bound; the float32
    bound and gradient against float64 at the start, a perturbed start and
    the fit's iterate after GL_EARLY iterations; ``predict_f`` of GL_N new
    points near that iterate's latent means; at the fit's result, where
    cond(Kuu) is past float32's reach, the float32 bound is only read; the
    psi statistics against quadrature."""
    from gpflow_tpu_torch.covariances import Kuu
    from gpflow_tpu_torch.optimizers import Scipy
    from gpflow_tpu_torch.utilities import read_values

    what = f"bgplvm N={GL_N} M={GL_M}"
    Y = make_gl_data(GL_N)
    m64 = gl_bgplvm(Y, GL_M, torch.float64)
    start = read_values(m64)
    early = {}

    def snapshot(step, variables, values):
        if step + 1 == GL_EARLY:
            early.update(read_values(m64))

    with torch.no_grad():
        elbo0 = float(m64.elbo())
    t0 = time.perf_counter()
    res, counts = counted(lambda: Scipy().minimize(m64.training_loss_closure(), m64.trainable_variables,
                                                   options={"maxiter": GL_MAXITER}, step_callback=snapshot))
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        elbo1 = float(m64.elbo())
    log(f"{what} float64 lbfgs from PCA: elbo {elbo0:.6e} -> {elbo1:.6e}; nit {res.nit}, nfev {res.nfev}, "
        f"status {res.status} ({res.message}); noise {float(m64.likelihood.variance.numpy()):.4e}")
    log(f"time: {what} float64 lbfgs: {seconds:.3f} s, {seconds / res.nfev:.4f} s per evaluation (a step callback "
        f"reads the values each iteration)")
    assert np.isfinite(elbo1) and elbo1 > elbo0, f"{what}: L-BFGS did not raise the bound"
    expect_launches(f"{what} float64 lbfgs", counts, {"K1": 0, "K2": 0}, launches)
    trained = read_values(m64)
    first = gl_bgplvm(Y, GL_M, torch.float32, start)
    with torch.no_grad():
        _, syncs = count_syncs(first.elbo)
    log(f"{what}: the first float32 bound in the process synchronised the host {syncs} times")
    for label, values in (("start", start), ("perturbed start", gl_perturbed(start, ".X_data_mean")),
                          (f"after {GL_EARLY} iterations", early)):
        model = gl_bgplvm(Y, GL_M, torch.float64, values)
        with torch.no_grad():
            kuu = torch.linalg.eigvalsh(Kuu(model.inducing_variable, model.kernel, jitter=GL_JITTER))
        log(f"{what} {label}: cond(Kuu + jitter I) {float(kuu[-1] / kuu[0]):.4e}")
        gl_check_bgplvm(f"{what} {label}", Y, GL_M, values, launches, m64=model)
    rng = np.random.RandomState(GL_SEEDS["perturb"] + 1)
    Xnew = torch.from_numpy((early[".X_data_mean"] + 0.1 * rng.randn(GL_N, GL_Q)).astype(np.float32)).cuda()
    ctl = gl_bgplvm(Y, GL_M, torch.float32, gl_bf16(early, (".X_data_mean", ".inducing_variable.Z")))
    gl_predict(what, gl_bgplvm(Y, GL_M, torch.float32, early), gl_bgplvm(Y, GL_M, torch.float64, early), ctl, Xnew,
               launches)
    # the fit's result: read, not held to a limit
    with torch.no_grad():
        kuu = torch.linalg.eigvalsh(Kuu(m64.inducing_variable, m64.kernel, jitter=GL_JITTER))
        bound32 = float(gl_bgplvm(Y, GL_M, torch.float32, trained).elbo())
    log(f"{what} after {GL_MAXITER} iterations: FINDING: cond(Kuu + jitter I) {float(kuu[-1] / kuu[0]):.4e}; the "
        f"float32 bound {bound32:.6e} against {elbo1:.6e} in float64 (rel err {abs(bound32 - elbo1) / abs(elbo1):.3e}): "
        f"float32 cannot evaluate the bound at this conditioning")
    assert np.isfinite(bound32), f"{what}: the float32 bound at the fit's result is not finite"
    gl_quadrature(Y, launches)


def gl_chunked_psi(model, chunk):
    """Makes ``model`` (a float64 BayesianGPLVM) sum psi2 over chunks of
    ``chunk`` rows, each recomputed in the backward pass, so that no
    [N, M, M] float64 tensor is kept."""
    from torch.utils.checkpoint import checkpoint

    from gpflow_tpu_torch.expectations import expectation
    from gpflow_tpu_torch.probability_distributions import DiagonalGaussian

    def psi_statistics(pX):
        kiv = (model.kernel, model.inducing_variable)

        def part(mu, var):
            return torch.sum(expectation(DiagonalGaussian(mu, var), kiv, kiv), dim=0)

        psi2 = sum(checkpoint(part, pX.mu[i:i + chunk], pX.cov[i:i + chunk], use_reentrant=False)
                   for i in range(0, pX.mu.shape[0], chunk))
        return expectation(pX, kiv), psi2

    model._psi_statistics = psi_statistics
    return model


def gl_wide(launches):
    """Phase 21b: BayesianGPLVM at N = GL_WIDE_N, M = GL_WIDE_M from PCA:
    the float32 bound and gradient against float64 (psi2 summed over
    chunks), its peak memory and its time; ``predict_f`` at the N latent
    means."""
    from gpflow_tpu_torch.utilities import read_values

    what = f"bgplvm N={GL_WIDE_N} M={GL_WIDE_M}"
    Y = make_gl_data(GL_WIDE_N)
    m64 = gl_chunked_psi(gl_bgplvm(Y, GL_WIDE_M, torch.float64), GL_WIDE_CHUNK)
    values = read_values(m64)
    m32 = gl_check_bgplvm(what, Y, GL_WIDE_M, values, launches, m64=m64)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sparse_value_and_grad(m32, gl_loss)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    psi2_gb = GL_WIDE_N * GL_WIDE_M ** 2 * 4 / 1e9
    log(f"memory: {what} float32 value and gradient: peak {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above "
        f"the {base / 1e9:.2f} GB held before it; one [N, M, M] psi2 is {psi2_gb:.2f} GB)")
    value_ms = [request_ms(lambda: m32.training_loss(), 3, warmup=1) for _ in range(2)]
    grad_ms = [request_ms(lambda: sparse_value_and_grad(m32, gl_loss), 3, warmup=1) for _ in range(2)]
    log(f"time: {what} float32 bound {min(value_ms):.3f} ms, value and gradient {min(grad_ms):.3f} ms "
        f"(rounds {[round(t, 3) for t in value_ms]}, {[round(t, 3) for t in grad_ms]})")
    profile_device(lambda: sparse_value_and_grad(m32, gl_loss), f"{what} float32 value and gradient")
    ctl = gl_bgplvm(Y, GL_WIDE_M, torch.float32, gl_bf16(values, (".X_data_mean", ".inducing_variable.Z")))
    Xnew = m32.X_data_mean.value.detach().clone()
    gl_predict(what, m32, m64, ctl, Xnew, launches)
    request = request_ms(lambda: m32.predict_f(Xnew), 3, warmup=1)
    log(f"time: {what} float32 predict_f at {GL_WIDE_N} points: {request:.3f} ms per request")


def gl_gplvm_phase(launches):
    """Phase 21c: GPLVM at N = GL_GPLVM_N from PCA: the float32 value and
    gradient in X and the hyperparameters against float64 under sync debug
    mode "error", beside the control, for SquaredExponential (at the start
    and perturbed) and Matern52 (K2 on the path); GPR_MAXITER L-BFGS
    iterations of the SquaredExponential one, which must lower the
    objective; timings."""
    from gpflow_tpu_torch.optimizers import Scipy
    from gpflow_tpu_torch.utilities import read_values

    Y = make_gl_data(GL_GPLVM_N)
    models = {}
    for kernel in ("SquaredExponential", "Matern52"):
        what = f"gplvm {kernel} N={GL_GPLVM_N}"
        start = read_values(gl_gplvm(Y, kernel, torch.float64))
        sets = {"start": start}
        if kernel == "SquaredExponential":
            sets["perturbed"] = gl_perturbed(start, ".data[0]")
        for label, values in sets.items():
            m32 = gl_gplvm(Y, kernel, torch.float32, values)
            got, counts = without_syncs(lambda: counted(lambda: sparse_value_and_grad(m32, gl_loss)))
            expect_launches(f"{what} {label} value and gradient", counts,
                            {"K1": 1, "K2": int(kernel == "Matern52")}, launches)
            m64 = gl_gplvm(Y, kernel, torch.float64, values)
            want = without_syncs(lambda: sparse_value_and_grad(m64, gl_loss))
            ctl = gl_gplvm(Y, kernel, torch.float32, gl_bf16(values, (".data[0]",)))
            control = run_control(lambda: sparse_value_and_grad(ctl, gl_loss))
            judge(f"{what} {label}", gl_errors(got, want, "gplvm "), gl_errors(control, want, "gplvm "))
            del ctl, m64
            torch.cuda.empty_cache()
        models[kernel] = gl_gplvm(Y, kernel, torch.float32, start)
    for kernel, model in models.items():
        ms = [request_ms(lambda: sparse_value_and_grad(model, gl_loss), 3, warmup=1) for _ in range(2)]
        log(f"time: gplvm {kernel} N={GL_GPLVM_N} float32 value and gradient: {min(ms):.3f} ms "
            f"(rounds {[round(t, 3) for t in ms]})")
    model = models["SquaredExponential"]
    with torch.no_grad():
        loss0 = float(model.training_loss())
    t0 = time.perf_counter()
    res, counts = counted(lambda: Scipy().minimize(model.training_loss_closure(), model.trainable_variables,
                                                   options={"maxiter": GPR_MAXITER}, nonfinite_penalty=GPR_PENALTY))
    seconds = time.perf_counter() - t0
    log(f"gplvm lbfgs N={GL_GPLVM_N}: loss {loss0:.6e} -> {float(res.fun):.6e}; nit {res.nit}, nfev {res.nfev}, "
        f"non-finite evaluations {res.n_nonfinite_evals}, status {res.status} ({res.message})")
    log(f"time: gplvm lbfgs N={GL_GPLVM_N}: {seconds:.3f} s, {seconds / res.nfev:.4f} s per evaluation over "
        f"{sum(p.unconstrained.numel() for p in model.trainable_variables)} variables")
    assert np.isfinite(res.fun) and float(res.fun) < loss0, "L-BFGS did not lower the GPLVM objective"
    expect_launches(f"gplvm lbfgs N={GL_GPLVM_N}", counts, {"K1": int(res.nfev), "K2": 0}, launches)


def gl_uncertain(launches):
    """Phase 21d: ``uncertain_conditional`` at GL_UC_N Gaussian inputs (full
    covariances) against a whitened q(u) of M = GL_UC_M and GL_P outputs,
    with and without a Linear mean function: float32 under sync debug mode
    "error" against float64, beside the control; and float64 at the first
    GL_UC_MC_N inputs against a Monte-Carlo estimate over GL_UC_DRAWS draws
    of each input through ``conditional``, within GL_UC_Z standard errors."""
    from gpflow_tpu_torch import config, functions, kernels
    from gpflow_tpu_torch.conditionals import conditional, uncertain_conditional
    from gpflow_tpu_torch.inducing_variables import InducingPoints

    rng = np.random.RandomState(GL_SEEDS["uc"])
    mu = rng.randn(GL_UC_N, GL_Q)
    a = 0.5 * rng.randn(GL_UC_N, GL_Q, GL_Q) / np.sqrt(GL_Q)
    cov = a @ np.swapaxes(a, -1, -2) + 0.05 * np.eye(GL_Q)
    Z = rng.randn(GL_UC_M, GL_Q)
    q_mu = rng.randn(GL_UC_M, GL_P)
    q_sqrt = np.tril(0.05 * rng.randn(GL_P, GL_UC_M, GL_UC_M), -1) + 0.5 * np.eye(GL_UC_M)
    A, b = rng.randn(GL_Q, GL_P) / np.sqrt(GL_Q), rng.randn(GL_P)

    def parts(dtype, mean, mu=mu, Z=Z):
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        with config.as_context(dataclasses.replace(config.config(), float=dtype)):
            k = kernels.SquaredExponential(variance=1.0, lengthscales=[2.0] * GL_Q)
            iv = InducingPoints(np.asarray(Z, np_dtype))
            mf = functions.Linear(A.astype(np_dtype), b.astype(np_dtype)) if mean else None
        t = lambda x: torch.as_tensor(np.asarray(x, np_dtype)).cuda()  # noqa: E731
        return t(mu), t(cov), iv, k, t(q_mu), t(q_sqrt), mf

    def run(args):
        Xmu, Xvar, iv, k, qm, qs, mf = args
        with torch.no_grad():
            return uncertain_conditional(Xmu, Xvar, iv, k, qm, qs, mean_function=mf, white=True)

    for mean in (False, True):
        what = f"uncertain_conditional N={GL_UC_N} M={GL_UC_M}" + (" with a Linear mean" if mean else "")
        args32 = parts(torch.float32, mean)
        got, counts = without_syncs(lambda: counted(lambda: run(args32)))
        expect_launches(what, counts, {"K1": 1, "K2": 0}, launches)
        args64 = parts(torch.float64, mean)
        want = without_syncs(lambda: run(args64))
        control = run_control(lambda: run(parts(torch.float32, mean, mu=bf16(mu).numpy(), Z=bf16(Z).numpy())))
        assert bool(torch.all(want[1] > 0)), f"{what}: a float64 variance is not positive"
        judge(what, {"mean": (rel_err(got[0], want[0]), GL_RTOL["uc mean"]),
                     "variance": (rel_err(got[1], want[1]), GL_RTOL["uc variance"])},
              {"mean": (rel_err(control[0], want[0]), None), "variance": (rel_err(control[1], want[1]), None)})
        ms = request_ms(lambda: run(args32), 5, warmup=1)
        log(f"time: {what} float32: {ms:.3f} ms per call")

        # the Monte-Carlo estimate at the first GL_UC_MC_N inputs, in float64
        n = GL_UC_MC_N
        Xmu, Xvar, iv, k, qm, qs, mf = args64
        fmean, fvar = (t[:n] for t in want)
        gen = torch.Generator(device="cuda").manual_seed(GL_SEEDS["mc"])
        eps = torch.randn((GL_UC_DRAWS, n, GL_Q), generator=gen, dtype=torch.float64, device="cuda")
        xs = Xmu[:n] + torch.einsum("nij,snj->sni", torch.linalg.cholesky(Xvar[:n]), eps)
        with torch.no_grad():
            mus, variances = conditional(xs.reshape(-1, GL_Q), iv, k, qm, q_sqrt=qs, white=True)
            if mf is not None:
                mus = mus + mf(xs.reshape(-1, GL_Q))
        mus, variances = mus.reshape(GL_UC_DRAWS, n, GL_P), variances.reshape(GL_UC_DRAWS, n, GL_P)
        mc_mean = mus.mean(0)
        mc_var = variances.mean(0) + mus.var(0)
        se_mean = mus.std(0) / np.sqrt(GL_UC_DRAWS)
        se_var = (variances + (mus - mc_mean) ** 2).std(0) / np.sqrt(GL_UC_DRAWS)
        z_mean = float(((mc_mean - fmean).abs() / se_mean).max())
        z_var = float(((mc_var - fvar).abs() / se_var).max())
        log(f"{what}: float64 against {GL_UC_DRAWS} Monte-Carlo draws at {n} inputs: mean within {z_mean:.2f}, "
            f"variance within {z_var:.2f} standard errors (limit {GL_UC_Z})")
        assert z_mean <= GL_UC_Z and z_var <= GL_UC_Z, f"{what}: disagrees with its Monte-Carlo estimate"


def gl_check_kernels():
    """Phase 21e: K1 (rbf) and K2 (matern52) against their plain versions
    at the path's D = 10 and D = 2 shapes and at the edge-path shapes."""
    return check_kernels(f"D = {GL_Q} and {GL_QUAD_Q}", GL_K1_SHAPES, [s + ("matern52",) for s in GL_K2_SHAPES],
                         GL_SEEDS["kernels"])


def gplvm_phases(launches):
    """Phase 21. Returns {kernel: largest absolute error of its checks}."""
    gl_small(launches)
    torch.cuda.empty_cache()
    gl_wide(launches)
    torch.cuda.empty_cache()
    gl_gplvm_phase(launches)
    torch.cuda.empty_cache()
    gl_uncertain(launches)
    torch.cuda.empty_cache()
    errs = gl_check_kernels()
    with torch.no_grad():
        for n, m, d in GL_K1_SHAPES:
            time_k1(n, m, iters=10 if n * m > 1e7 else 20, d=d)
        for n, m, d in GL_K2_SHAPES:
            time_k2(n, m, iters=10, d=d)
    return errs


def make_cv_images(n, point, seed):
    """``n`` images [n, W H C] of the operating point ``point`` (pixel (w, h)
    of channel c at (w H + h) C + c, the layout ``get_patches`` reads) and
    their labels [n, 1], float32: noise uniform in [0, CV_NOISE] plus one of
    CV_C templates, CV_TEMPLATE pixels square, at a uniformly random position
    in every channel."""
    rng = np.random.RandomState(seed)
    (W, H), channels = point["image"], point["channels"]
    t = CV_TEMPLATE
    templates = (np.random.RandomState(CV_SEEDS["templates"]).rand(CV_C, t, t) < 0.5) * np.float32(CV_BRIGHT)
    X = (rng.rand(n, W, H, channels) * CV_NOISE).astype(np.float32)
    labels = rng.randint(0, CV_C, n)
    rows = rng.randint(0, W - t + 1, n)[:, None, None] + np.arange(t)[None, :, None]
    cols = rng.randint(0, H - t + 1, n)[:, None, None] + np.arange(t)[None, None, :]
    X[np.arange(n)[:, None, None], rows, cols] += templates[labels][..., None]
    return X.reshape(n, W * H * channels), labels[:, None].astype(np.float32)


def cv_patches(X, point):
    """``Convolutional.get_patches`` in numpy: [n, C ow oh, S]."""
    (W, H), (pw, ph), channels = point["image"], point["patch"], point["channels"]
    imgs = X.reshape(-1, W * H, channels).transpose(0, 2, 1).reshape(-1, W, H)
    rows = np.arange(W - pw + 1)[:, None, None, None] + np.arange(pw)[None, None, :, None]
    cols = np.arange(H - ph + 1)[None, :, None, None] + np.arange(ph)[None, None, None, :]
    return imgs[:, rows, cols].reshape(X.shape[0], -1, pw * ph)


def cv_inducing(X, point, seed):
    """CV_M distinct patches of the first CV_M images, drawn with ``seed``
    (doc/examples/convolutional.py:69-71)."""
    patches = cv_patches(X[:CV_M], point)
    patches = np.unique(patches.reshape(-1, patches.shape[-1]), axis=0)
    return patches[np.random.RandomState(seed).choice(len(patches), CV_M, replace=False)].copy()


def cv_model(Z, dtype, values=None, base="SquaredExponential", point=CV_MNIST):
    """The convolutional multiclass SVGP of phase 22 at ``point`` on the card
    in ``dtype``: MultiClass (RobustMax) over CV_C latent GPs, ``num_data`` =
    CV_N, whitened full q_sqrt, the point's base lengthscale; or the
    constrained ``values`` of ``read_values``."""
    from gpflow_tpu_torch import config, kernels, likelihoods
    from gpflow_tpu_torch.inducing_variables import InducingPatches
    from gpflow_tpu_torch.models import SVGP
    from gpflow_tpu_torch.utilities import load_jax_values

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        kernel = kernels.Convolutional(getattr(kernels, base)(lengthscales=point["lengthscale"]), point["image"],
                                       point["patch"], colour_channels=point["channels"])
        model = SVGP(kernel, likelihoods.MultiClass(CV_C), InducingPatches(Z), num_latent_gps=CV_C, num_data=CV_N)
    model = model.to(dtype=dtype)
    if values is not None:
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        load_jax_values(model, {k: np.asarray(v).astype(np_dtype) for k, v in values.items()})
    return model


def cv_value_and_grad(model, batch):
    return sparse_value_and_grad(model, lambda m: m.training_loss(batch))


def cv_check(what, Z, values, batch, launches, expected, base="SquaredExponential", point=CV_MNIST):
    """Phase 22a: the float32 ELBO and its gradient in every trainable
    parameter under sync debug mode "error", with exact launch counts,
    against float64 on the card from the same values and beside the
    lower-tier control. Returns the float32 model."""
    m32, m64 = cv_model(Z, torch.float32, values, base, point), cv_model(Z, torch.float64, values, base, point)
    ctl = cv_model(Z, torch.float32, bf16_values(values), base, point)
    log(f"{what}: cond(Kuu + jitter I) {ng_cond(m64)[0]:.4e} (float64, jitter 1e-4)")
    got, counts = counted(lambda: without_syncs(lambda: cv_value_and_grad(m32, batch)))
    expect_launches(f"{what}: ELBO and gradient", counts, expected, launches)
    assert bool(torch.isfinite(got[0])) and all(bool(torch.isfinite(g).all()) for g in got[1].values())
    want = cv_value_and_grad(m64, tuple(t.double() for t in batch))
    log(f"{what}: ELBO {-float(want[0]):.8e} (float32 {-float(got[0]):.8e}); largest float64 gradient entries "
        + ", ".join(f"{k} {float(g.abs().max()):.3e}" for k, g in want[1].items()))
    control = run_control(lambda: cv_value_and_grad(ctl, (bf16(batch[0]).cuda(), batch[1])))
    judge(what, vgp_errors(got, want, CV_RTOL), vgp_errors(control, want, CV_RTOL))
    del m64, ctl
    torch.cuda.empty_cache()
    return m32


def cv_route_check(model, Xb):
    """Phase 22a: ``Kuf_conv_patch`` (one 2-D base-kernel call: K1, its
    backward from the saved K) against the JAX package's batched route (the
    base kernel on [N, P, S], plain PyTorch) on the card, both float32, the
    value and its gradients in Z, the weights and the base kernel's
    parameters for a seeded cotangent, each relative to its largest entry;
    both also against the batched route in float64."""
    from gpflow_tpu_torch.covariances.kufs import Kuf_conv_patch

    iv, k = model.inducing_variable, model.kernel
    params = [iv.Z.unconstrained, k.weights.unconstrained, k.base_kernel.lengthscales.unconstrained,
              k.base_kernel.variance.unconstrained]
    g = torch.randn(CV_M, Xb.shape[0], device="cuda", generator=torch.Generator(device="cuda").manual_seed(
        CV_SEEDS["route"]))

    def batched(dtype):
        # the base kernel's K(Z, Xp) on the [N, P, S] patches, as kufs.py:41-50
        # calls it; float64 inputs promote the float32 parameters
        Xp = k.get_patches(Xb).to(dtype)
        bigK = k.base_kernel.K(iv.Z.value.to(dtype), Xp)  # [M, N, P]
        return torch.sum(bigK * k.weights.value.to(dtype), dim=2) / k.num_patches

    outs = {}
    for label, fn in (("K1 route", lambda: Kuf_conv_patch(iv, k, Xb)), ("batched route", lambda: batched(torch.float32)),
                      ("batched route float64", lambda: batched(torch.float64))):
        value, counts = counted(fn)
        grads = torch.autograd.grad((value * g.to(value.dtype)).sum(), params)
        outs[label] = (value.detach(), grads, counts)
    assert outs["K1 route"][2] == {"K1": 1, "K2": 0} and outs["batched route"][2] == {"K1": 0, "K2": 0}, \
        f"the routes launched {outs['K1 route'][2]} and {outs['batched route'][2]}"
    names = ("value", "gradient Z", "gradient weights", "gradient lengthscales", "gradient variance")
    for a, b in (("K1 route", "batched route"), ("K1 route", "batched route float64"),
                 ("batched route", "batched route float64")):
        errs = [rel_err(outs[a][0], outs[b][0])] + [rel_err(x, y) for x, y in zip(outs[a][1], outs[b][1])]
        log(f"Kuf_conv_patch at B={Xb.shape[0]} ({CV_M}, {Xb.shape[0] * 576}, 25): {a} against the {b}: "
            + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs)) + f" (tol {CV_ROUTE_RTOL:.0e})")
        if b == "batched route":
            assert max(errs) <= CV_ROUTE_RTOL, "Kuf_conv_patch's K1 route disagrees with the batched route"
    del outs
    torch.cuda.empty_cache()


def cv_train(Z, staged, launches):
    """Phase 22a: CV_STEPS Adam steps (1e-2 on every parameter) of
    ``run_steps_sampled`` at B = CV_B under sync debug mode "error"; losses
    finite and falling, launch counts exact. Returns the trainer."""
    from gpflow_tpu_torch.parallel import DataParallelTrainer, adam

    trainer = DataParallelTrainer(cv_model(Z, torch.float32), adam(1e-2))
    trainer.stage_data(staged)
    generator = torch.Generator(device="cuda").manual_seed(CV_SEEDS["train"])
    losses, counts = counted(lambda: without_syncs(lambda: trainer.run_steps_sampled(CV_STEPS, CV_B, generator)))
    losses = losses.cpu()
    log(f"conv train adam: {CV_STEPS} steps at B={CV_B}, losses {[round(float(v), 1) for v in losses]}")
    expect_launches("conv train adam", counts, {"K1": 2 * CV_STEPS, "K2": 0}, launches)
    assert losses.shape == (CV_STEPS,) and bool(torch.isfinite(losses).all()), "conv training: a non-finite loss"
    last = float(losses[-5:].mean())
    log(f"conv train adam: loss {float(losses[0]):.6e} -> {last:.6e} (mean of the last 5)")
    assert last < float(losses[0]), "conv training: the loss did not fall"
    return trainer


def cv_requests(model, Xb, launches=None, label=""):
    """A request of Xb's images: class probabilities through ``posterior()``
    (cached predict_f and the likelihood's predictive moments) and through
    the fused ``predict_y``, with exact launch counts where ``launches``."""
    with torch.no_grad():
        post, counts = counted(model.posterior)
        if launches is not None:
            expect_launches(f"{label} posterior", counts, {"K1": 1, "K2": 0}, launches)
        out = {}
        for key, fn, k1 in (("posterior predict_y", lambda: model.likelihood.predict_mean_and_var(
                                Xb, *post.predict_f(Xb)), 1),
                            ("fused predict_y", lambda: model.predict_y(Xb), 2)):
            out[key], counts = counted(fn)
            if launches is not None:
                expect_launches(f"{label} {key} request", counts, {"K1": k1, "K2": 0}, launches)
    return out, post


def cv_serve(model, requests, launches):
    """Phase 22a: a request of the CV_NEW held-out images on both routes
    against float64 on the card. The fused route is held to float64 beside
    the lower-tier control; the cached route's float32 predictions are read,
    not held: its (alpha, Qinv) cache is an explicit inverse, whose error
    grows as cond(Kuu)^2 eps32 (posteriors.py), and the float64 cached route
    must equal the float64 fused one. Probabilities in [0, 1]; held-out
    accuracy above chance. Returns the posterior."""
    from gpflow_tpu_torch.utilities import read_values

    Xb, Yb = (torch.from_numpy(a).cuda() for a in requests)
    values = read_values(model)
    Z = values[".inducing_variable.Z"]
    out, post = cv_requests(model, Xb, launches, f"conv {CV_NEW} images")
    m64 = cv_model(Z, torch.float64, values)
    want, _ = cv_requests(m64, Xb.double())
    cond = ng_cond(m64)[0]
    del m64
    torch.cuda.empty_cache()
    routes = [rel_err(a, b) for a, b in zip(want["posterior predict_y"], want["fused predict_y"])]
    log(f"conv requests of {CV_NEW} images: float64 cached route against the fused one: mean {routes[0]:.3e}, var "
        f"{routes[1]:.3e} (tol {CV_RTOL['routes f64']:.0e})")
    assert max(routes) <= CV_RTOL["routes f64"], "conv: the cached route disagrees with the fused one in float64"
    ctl = cv_model(Z, torch.float32, bf16_values(values))
    cout = run_control(lambda: cv_requests(ctl, bf16(Xb).cuda())[0])
    key, limits = "fused predict_y", CV_RTOL["requests"]
    judge(f"conv fused predict_y of {CV_NEW} images",
          {part: (rel_err(out[key][i], want[key][i]), limits[part]) for i, part in enumerate(("mean", "var"))},
          {part: (rel_err(cout[key][i], want[key][i]), limits[part]) for i, part in enumerate(("mean", "var"))})
    cached = [rel_err(a, b) for a, b in zip(out["posterior predict_y"], want["posterior predict_y"])]
    log(f"conv requests of {CV_NEW} images: FINDING: at cond(Kuu + jitter I) {cond:.4e} (float64) the float32 "
        f"cached route is off float64 by mean {cached[0]:.3e}, var {cached[1]:.3e} (cond^2 eps32 = "
        f"{cond ** 2 * EPS32:.1e}); read, not held")
    for key in out:
        p = out[key][0]
        assert bool(torch.isfinite(p).all()) and p.shape == (CV_NEW, CV_C), f"conv {key}: not finite"
        accuracy = float((p.argmax(-1) == Yb[:, 0].long()).float().mean())
        log(f"conv {key}: held-out accuracy {accuracy:.4f} over {CV_NEW} images after {CV_STEPS} Adam steps "
            f"(chance {1 / CV_C:.2f}); probabilities in [{float(p.min()):.4e}, {float(p.max()):.4e}]")
    p = out["fused predict_y"][0]
    assert bool(((p >= 0) & (p <= 1)).all()), "conv: a probability outside [0, 1]"
    assert float((p.argmax(-1) == Yb[:, 0].long()).float().mean()) > 1.0 / CV_C, "conv: accuracy at or below chance"
    return post


def cv_split(model, batch):
    """Phase 22a: device milliseconds of the pieces of one value and
    gradient: Kuf (K1 and the weighted sum over P), K_diag (the batched
    plain path over [B, P, P]), each alone and with its backward, and the
    whole ELBO with and without its gradient."""
    from gpflow_tpu_torch.covariances import Kuf

    X, _ = batch
    iv, k = model.inducing_variable, model.kernel
    params = [p.unconstrained for p in model.trainable_variables]
    kuf_params = [iv.Z.unconstrained] + [p.unconstrained for p in k.trainable_variables]

    def grad_of(fn, wrt):
        return lambda: torch.autograd.grad(fn().sum(), wrt)

    pieces = (("Kuf", lambda: Kuf(iv, k, X)), ("Kuf and its backward", grad_of(lambda: Kuf(iv, k, X), kuf_params)),
              ("K_diag", lambda: k(X, full_cov=False)),
              ("K_diag and its backward", grad_of(lambda: k(X, full_cov=False), [p.unconstrained for p in
                                                                                 k.trainable_variables])),
              ("ELBO", lambda: model.training_loss(batch)),
              ("ELBO and its gradient", grad_of(lambda: model.training_loss(batch), params)))
    for label, fn in pieces:
        rounds = [device_ms(fn, 5, warmup=1) for _ in range(CV_TIMED_ROUNDS)]
        log(f"time: conv split at B={CV_B}: {label} {min(rounds):.3f} ms device (rounds "
            f"{[round(r, 3) for r in rounds]})")


def contraction_float32(needs, Xs, Zs, variance, K, W, g):
    """The backward's contraction as it was before ROADMAP F2, accumulated
    in float32: the reference that ``time_f2`` times the float64 one
    against."""
    dXs = dZs = dvar = None
    if needs[0]:
        dXs = 2.0 * (W.sum(dim=1, keepdim=True) * Xs - W @ Zs)
    if needs[1]:
        dZs = 2.0 * (W.sum(dim=0).unsqueeze(1) * Zs - W.mT @ Xs)
    if needs[2]:
        dvar = (torch.sum(g * K) / variance).reshape(variance.shape)
    return dXs, dZs, dvar


def time_f2(model, batch):
    """Phase 22: what F2's float64 accumulation costs, interleaved float32,
    float64, float64, float32 in this run: the contraction alone at the
    convolutional Kuf's and the CGLB block's shapes, and the convolutional
    value and gradient with each."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    generator = torch.Generator(device="cuda").manual_seed(SEED + 82)
    fns = {"float32": contraction_float32, "float64": pd._stationary_bwd_from_w}
    var = torch.ones(1, device="cuda")
    for n, m, d in ((CV_M, CV_B * 576, 25), (SP_N, SP_CHUNK, D)):
        Xs, Zs, W = (torch.randn(*shape, device="cuda", generator=generator) for shape in ((n, d), (m, d), (n, m)))
        got = {"float32": [], "float64": []}
        for which in ("float32", "float64", "float64", "float32"):
            got[which].append(device_ms(lambda: fns[which]((True, True, False), Xs, Zs, var, W, W, W), 10))
        log(f"time: the backward's contraction at ({n}, {m}, {d}): float64 accumulation {min(got['float64']):.4f} ms, "
            f"float32 {min(got['float32']):.4f} ms (runs {got})")
        del Xs, Zs, W
    got = {"float32": [], "float64": []}
    try:
        for which in ("float32", "float64", "float64", "float32"):
            pd._stationary_bwd_from_w = fns[which]
            got[which].append(device_ms(lambda: cv_value_and_grad(model, batch), 5, warmup=1))
    finally:
        pd._stationary_bwd_from_w = fns["float64"]
    log(f"time: conv value and gradient with the float64 contraction {min(got['float64']):.3f} ms, with the float32 "
        f"one {min(got['float32']):.3f} ms (runs {got})")


def cv_timings(model, batch, trainer, post, requests):
    """Phase 22a: the value and gradient by CUDA events (device and back to
    back with the host), its split, F2's cost, its peak memory and a
    profile; Adam steps per second; ms per request of CV_NEW images on both
    routes."""
    for what, fn in (("device", lambda: device_ms(lambda: cv_value_and_grad(model, batch), 5, warmup=1)),
                     ("back to back with the host", lambda: request_ms(lambda: cv_value_and_grad(model, batch), 5,
                                                                       warmup=1))):
        rounds = [fn() for _ in range(CV_TIMED_ROUNDS)]
        log(f"time: conv value and gradient M={CV_M}, B={CV_B}, C={CV_C}: {what} {min(rounds):.3f} ms "
            f"(rounds {[round(r, 3) for r in rounds]})")
    cv_split(model, batch)
    time_f2(model, batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cv_value_and_grad(model, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"memory: conv float32 value and gradient at B={CV_B}: peak {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} "
        f"GB above the {base / 1e9:.2f} GB held before it; one [M, B P] Kuf block is {CV_M * CV_B * 576 * 4 / 1e9:.2f} "
        f"GB, one [B, P, P] K_diag block {CV_B * 576 ** 2 * 4 / 1e9:.2f} GB)")
    profile_device(lambda: cv_value_and_grad(model, batch), f"conv value and gradient M={CV_M}, B={CV_B}", top=12)
    rates = [CV_STEPS / request_ms(lambda: trainer.run_steps_sampled(CV_STEPS, CV_B), 1, warmup=int(i == 0)) * 1e3
             for i in range(2)]
    log(f"time: conv train adam at B={CV_B}: {max(rates):.2f} steps/s ({1e3 / max(rates):.3f} ms per step); rounds "
        f"{[round(r, 2) for r in rates]}")
    Xb = torch.from_numpy(requests[0]).cuda()
    m = trainer.model
    with torch.no_grad():
        for key, fn in (("posterior()", m.posterior),
                        ("posterior predict_y", lambda: m.likelihood.predict_mean_and_var(Xb, *post.predict_f(Xb))),
                        ("fused predict_y", lambda: m.predict_y(Xb))):
            rounds = [request_ms(fn, 3, warmup=1) for _ in range(2)]
            log(f"time: conv {key} of {CV_NEW} images: {min(rounds):.3f} ms per request (rounds "
                f"{[round(r, 3) for r in rounds]})")
        peak_before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m.predict_y(Xb)
        torch.cuda.synchronize()
        log(f"memory: conv fused predict_y of {CV_NEW} images: peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
            f"(the value and gradient's {peak_before / 1e9:.2f})")


def cv_cifar(launches):
    """Phase 22a, once: a value and gradient at CIFAR-10's shapes (32 x 32 x
    3 images, 3 x 3 patches: P = 2700, S = 9, B = 32; K1 at (750, 86400, 9)),
    ``get_patches`` on the card against numpy, the float32 value and
    gradient against float64 beside the control."""
    b = CV_CIFAR_B
    X, Y = make_cv_images(CV_M + b, CV_CIFAR, CV_SEEDS["cifar"])
    Z = cv_inducing(X, CV_CIFAR, CV_SEEDS["cifar"])
    batch = (torch.from_numpy(X[-b:]).cuda(), torch.from_numpy(Y[-b:]).cuda())
    model = cv_model(Z, torch.float32, point=CV_CIFAR)
    with torch.no_grad():
        patches = model.kernel.get_patches(batch[0]).cpu().numpy()
    assert patches.shape == (b, model.kernel.num_patches, 9) and model.kernel.num_patches == 2700
    assert np.array_equal(patches, cv_patches(X[-b:], CV_CIFAR)), "get_patches on the card differs from numpy"
    values = latent_values(model, CV_SEEDS["values"][0], CV_C)
    cv_check(f"conv CIFAR-10 shapes B={b}", Z, values, batch, launches, {"K1": 2, "K2": 0}, point=CV_CIFAR)


def cp_data():
    """Phase 22b's GPR data: x sorted in [0, 10], sin(x) before 5 and
    sin(4 x) after, noise 0.1; float32."""
    rng = np.random.RandomState(CV_SEEDS["cp"])
    X = np.sort(rng.rand(CP_N, 1) * 10, axis=0).astype(np.float32)
    Y = np.where(X < 5, np.sin(X), np.sin(4 * X)) + 0.1 * rng.randn(CP_N, 1)
    return X, Y.astype(np.float32)


def cp_model(data, dtype, values=None):
    from gpflow_tpu_torch import config, kernels
    from gpflow_tpu_torch.models import GPR
    from gpflow_tpu_torch.utilities import load_jax_values

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        kernel = kernels.ChangePoints([kernels.Matern32(lengthscales=1.0), kernels.Matern32(lengthscales=0.2)],
                                      locations=[4.0], steepness=5.0)
        model = GPR(data, kernel, noise_variance=CP_NOISE)
    model = model.to(dtype=dtype)
    if values is not None:
        load_jax_values(model, values)
    return model


def cat_data():
    """Phase 22c's GPR data: bench.py's N = 8192 inputs in D = 8 and a label
    column of CAT_LABELS labels; y = sin(3 x_0) plus a seeded offset per
    label, noise 0.1."""
    rng = np.random.RandomState(CV_SEEDS["cat"])
    X = rng.rand(CAT_N, D).astype(np.float32)
    labels = rng.randint(0, CAT_LABELS, (CAT_N, 1))
    Y = np.sin(3 * X[:, :1]) + rng.randn(CAT_LABELS)[labels] + 0.1 * rng.randn(CAT_N, 1)
    return np.concatenate([X, labels.astype(np.float32)], axis=1), Y.astype(np.float32)


def cat_model(data, dtype, values=None):
    from gpflow_tpu_torch import config, kernels
    from gpflow_tpu_torch.models import GPR
    from gpflow_tpu_torch.utilities import load_jax_values

    with config.as_context(dataclasses.replace(config.config(), float=dtype)):
        np.random.seed(CV_SEEDS["cat"])  # Categorical draws its Z_deltas from numpy's global state
        kernel = kernels.Categorical(kernels.SquaredExponential(active_dims=list(range(D))),
                                     kernels.SquaredExponential(active_dims=[D]), num_labels=CAT_LABELS)
        model = GPR(data, kernel, noise_variance=GPR_NOISE)
    model = model.to(dtype=dtype)
    if values is not None:
        load_jax_values(model, values)
    return model


def gpr_check(what, build, data, launches, expected):
    """Phase 22b-c: a float32 GPR's training loss and gradient in every
    trainable parameter under sync debug mode "error", with exact launch
    counts, against float64 on the card from the same values, each within
    cond * eps32 (phase 9's limit; cond an upper bound of cond(K + noise I)).
    Returns the float32 model."""
    from gpflow_tpu_torch.utilities import parameter_dict, read_values

    m32 = build(tuple(torch.from_numpy(a).cuda() for a in data), torch.float32)
    m64 = build(tuple(torch.from_numpy(a).double().cuda() for a in data), torch.float64, read_values(m32))
    tol = gram_cond(m64) * EPS32
    log(f"{what}: cond(K + noise I) <= {tol / EPS32:.4e}; tolerance cond * eps32 = {tol:.3e}")
    (loss, grads), counts = counted(lambda: without_syncs(lambda: gpr_value_and_grad(m32, False)))
    expect_launches(f"{what} value and gradient", counts, expected, launches)
    loss64, grads64 = gpr_value_and_grad(m64, False)
    err = abs(float(loss) - float(loss64)) / abs(float(loss64))
    log(f"{what}: loss {float(loss):.8e} (float64 {float(loss64):.8e}), rel err {err:.3e}, tol {tol:.1e}")
    assert bool(torch.isfinite(loss)) and err <= tol, f"{what}: the loss disagrees with float64"
    paths = {id(p): path for path, p in parameter_dict(m32).items()}
    for p, got, want in zip(m32.trainable_variables, grads, grads64):
        gerr = rel_err(got, want)
        log(f"{what}: gradient {paths[id(p)]} max |.| {float(want.abs().max()):.4e}, rel err {gerr:.3e}, tol {tol:.1e}")
        assert bool(torch.isfinite(got).all()) and gerr <= tol, f"{what}: gradient {paths[id(p)]} disagrees"
    return m32


def cp_phase(launches):
    """Phase 22b: the ChangePoints GPR's value and gradient against float64,
    CP_MAXITER L-BFGS iterations, which must lower the objective (the
    location's move logged), and the times. Returns the model."""
    from gpflow_tpu_torch.optimizers import Scipy

    what = f"changepoints gpr N={CP_N}"
    model = gpr_check(what, cp_model, cp_data(), launches, {"K1": 2, "K2": 2})
    with torch.no_grad():
        loss0 = float(model.training_loss())
    before = (float(model.kernel.locations.numpy()[0]), float(model.kernel.steepness.numpy()))
    t0 = time.perf_counter()
    res, counts = counted(lambda: Scipy().minimize(model.training_loss_closure(), model.trainable_variables,
                                                   options={"maxiter": CP_MAXITER}, nonfinite_penalty=GPR_PENALTY))
    seconds = time.perf_counter() - t0
    after = (float(model.kernel.locations.numpy()[0]), float(model.kernel.steepness.numpy()))
    log(f"{what} lbfgs: loss {loss0:.6e} -> {float(res.fun):.6e}; nit {res.nit}, nfev {res.nfev}, non-finite "
        f"evaluations {res.n_nonfinite_evals}, status {res.status} ({res.message}); the location {before[0]:.4f} -> "
        f"{after[0]:.4f} (the data change at 5), steepness {before[1]:.4f} -> {after[1]:.4f}; lengthscales "
        f"{[round(float(k.lengthscales.numpy()), 4) for k in model.kernel.kernels]}")
    log(f"time: {what} lbfgs: {seconds:.3f} s, {seconds / res.nfev:.4f} s per evaluation")
    assert np.isfinite(res.fun) and float(res.fun) < loss0, "L-BFGS did not lower the ChangePoints objective"
    expect_launches(f"{what} lbfgs", counts, {"K1": 2 * int(res.nfev), "K2": 2 * int(res.nfev)}, launches)
    rounds = [request_ms(lambda: gpr_value_and_grad(model, False), 3, warmup=1) for _ in range(2)]
    log(f"time: {what} value and gradient {min(rounds):.3f} ms (rounds {[round(r, 3) for r in rounds]})")


def cat_phase(launches):
    """Phase 22c: the Categorical GPR's value and gradient (Z_deltas and the
    non-categorical kernel; the categorical one is frozen) against float64;
    an out-of-range label gives NaN in its row and column on the card."""
    from gpflow_tpu_torch.utilities import parameter_dict

    what = f"categorical gpr N={CAT_N}"
    data = cat_data()
    # Categorical's K is its product's K, which cuts no term to its active
    # dims (as in the JAX package): both SquaredExponential terms see all
    # D + 1 columns, and K1 runs at (N, N, D + 1) for each
    model = gpr_check(what, cat_model, data, launches, {"K1": 2, "K2": 0})
    names = sorted(p for p, v in parameter_dict(model).items() if v.trainable)
    assert names == [".kernel._Z_deltas", ".kernel.wrapped_kernel.kernels[0].lengthscales",
                     ".kernel.wrapped_kernel.kernels[0].variance", ".likelihood.variance"], names
    X = torch.from_numpy(data[0][:16]).cuda()
    X[3, D] = CAT_LABELS
    with torch.no_grad():
        K = model.kernel(X)
    nan = torch.isnan(K)
    log(f"{what}: a label of {CAT_LABELS} in row 3 of 16: NaN in {int(nan.sum())} entries of its K")
    assert bool(nan[3].all()) and bool(nan[:, 3].all()) and int(nan.sum()) == 2 * 16 - 1, "the NaN row is wrong"
    rounds = [request_ms(lambda: gpr_value_and_grad(model, False), 3, warmup=1) for _ in range(2)]
    log(f"time: {what} value and gradient {min(rounds):.3f} ms (rounds {[round(r, 3) for r in rounds]})")


def check_kernels(what, k1_shapes, k2_shapes, seed):
    """K1 (rbf) at ``k1_shapes`` [(n, m, d)] and K2 at ``k2_shapes``
    [(n, m, d, family)] against their plain versions, inputs N(0, 1 / d)
    per dimension, each with its launch plan; both kernels must run their
    TMA and their edge path, with scalar staging (no d here is a multiple of
    4). Returns {kernel: largest absolute error against float64}."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(seed)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    var = torch.tensor([1.0], device="cuda")
    worst = {"K1": 0.0, "K2": 0.0}
    for kernel, shapes in (("K1", [s + ("rbf",) for s in k1_shapes]), ("K2", k2_shapes)):
        seen = set()
        for n, m, d, family in shapes:
            Xs, Zs = (torch.from_numpy((rng.randn(k, d) / np.sqrt(d)).astype(np.float32)).cuda() for k in (n, m))
            if kernel == "K1":
                out = pd.stationary_forward_cuda(family, Xs, Zs, var)
                plan = plan_seen(kernel, seen)
                plain32 = pd.stationary_forward_plain(family, Xs, Zs, var)
                plain64 = pd.stationary_forward_plain(family, Xs.double(), Zs.double(), var.double())
                tol64, tol32 = K1_ATOL_F64, K1_ATOL_F32
            else:
                g = torch.randn(n, m, device="cuda", generator=generator)  # drawn on the card: n m reach 4e8
                out = pd.stationary_wgrad_cuda(family, Xs, Zs, var, g)
                plan = plan_seen(kernel, seen)
                plain32 = pd.stationary_wgrad_plain(family, Xs, Zs, var, g)
                plain64 = pd.stationary_wgrad_plain(family, Xs.double(), Zs.double(), var.double(), g.double())
                top = max(float(plain64.abs().max()), 1e-30)
                tol64, tol32 = K2_RTOL_F64 * top, K2_RTOL_F32 * top
                del g
            torch.cuda.synchronize()
            assert out.shape == (n, m) and out.dtype == torch.float32
            err64, err32 = float((out.double() - plain64).abs().max()), float((out - plain32).abs().max())
            log(f"{kernel} {family} ({n}, {m}, {d}): max abs err {err64:.3e} vs plain f64, tol {tol64:.1e}; "
                f"{err32:.3e} vs plain f32, tol {tol32:.1e}; {plan}")
            assert err64 <= tol64 and err32 <= tol32, f"{kernel} {family} disagrees with its plain version at {(n, m, d)}"
            worst[kernel] = max(worst[kernel], err64)
            del out, plain32, plain64
            torch.cuda.empty_cache()
        log(f"{kernel} at {what}'s shapes ran (tma, vec) = {sorted(seen)}")
        assert seen == {(True, False), (False, False)}, f"{kernel} at {what}'s shapes did not run both its paths"
    return worst


def conv_phases(launches):
    """Phase 22. Returns {kernel: largest absolute error of its checks}."""
    X, Y = make_cv_images(CV_N + CV_NEW, CV_MNIST, CV_SEEDS["data"])
    Z = cv_inducing(X, CV_MNIST, CV_SEEDS["Z"])
    staged = (torch.from_numpy(X[:CV_N]).cuda(), torch.from_numpy(Y[:CV_N]).cuda())
    requests = (X[CV_N:], Y[CV_N:])
    idx = torch.from_numpy(np.random.RandomState(CV_SEEDS["batch"]).randint(0, CV_N, CV_B)).cuda()
    batch = (staged[0][idx], staged[1][idx])
    base = cv_model(Z, torch.float32)
    for i, seed in enumerate(CV_SEEDS["values"]):
        values = latent_values(base, seed, CV_C)
        model = cv_check(f"conv objective B={CV_B}, values seed {seed}", Z, values, batch, launches, {"K1": 2, "K2": 0})
        if i == 0:
            cv_route_check(model, batch[0])
            cv_check(f"conv Matern52 objective B={CV_B}, values seed {seed}", Z, values, batch, launches,
                     {"K1": 2, "K2": 2}, base="Matern52")
    del model
    cv_cifar(launches)
    torch.cuda.empty_cache()
    trainer = cv_train(Z, staged, launches)
    post = cv_serve(trainer.model, requests, launches)
    torch.cuda.empty_cache()
    cp_phase(launches)
    torch.cuda.empty_cache()
    cat_phase(launches)
    torch.cuda.empty_cache()
    errs = check_kernels("phase 22", CV_K1_SHAPES, CV_K2_SHAPES, CV_SEEDS["kernels"])
    cv_timings(trainer.model, batch, trainer, post, requests)
    with torch.no_grad():
        for n, m, d in CV_K1_SHAPES:
            time_k1(n, m, iters=10 if n * m > 1e8 else 20, d=d)
        for n, m, d, family in CV_K2_SHAPES:  # the plain version takes 0.3 s at (750, 576000, 25)
            time_k2(n, m, iters=2 if n * m > 1e8 else 20, d=d, family=family)
    return errs


def _kernel_category(name):
    # cuSOLVER's float32 Cholesky runs as getrf_wo_pivot on this card
    n = name.lower()
    for key, words in (("K1", ("stationary_k1",)), ("K2", ("stationary_k2",)),
                       ("cholesky", ("potrf", "getrf", "chol")),
                       ("triangular", ("trsm", "trtri", "trsv")), ("gemm", ("gemm", "gemv", "syrk"))):
        if any(w in n for w in words):
            return key
    return "small"


def profile_device(fn, label, top=8):
    """Device time of ``fn()`` by kernel category, from ``torch.profiler``;
    returns {category: ms} and the wall milliseconds by CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    total_ms = start.elapsed_time(end)
    # kernels only: a user annotation such as "Optimizer.step#Adam.step"
    # carries the device time of the kernels inside it a second time
    device = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and getattr(e, "self_device_time_total", 0) > 0
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        log(f"profile: {label}: the profiler recorded no device time")
        return {}, total_ms
    device.sort(key=lambda e: e.self_device_time_total, reverse=True)
    by = {}
    for e in device:
        key = _kernel_category(e.key)
        ms, count = by.get(key, (0.0, 0))
        by[key] = (ms + e.self_device_time_total / 1e3, count + e.count)
    busy = sum(ms for ms, _ in by.values())
    log(f"profile: {label}: {total_ms:.3f} ms, device busy {busy:.3f} ms ({100 * busy / total_ms:.0f}%), "
        f"{sum(e.count for e in device)} kernels; by category "
        + ", ".join(f"{k} {ms:.3f} ms x{c}" for k, (ms, c) in sorted(by.items(), key=lambda kv: -kv[1][0])))
    for e in device[:top]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:110]}")
    return {k: ms for k, (ms, _) in by.items()}, total_ms


def ng_timings(trainers, post, model, Xb, Yb):
    """Phase 15: fused and sequential steps per second by CUDA events around
    one ``run_steps_sampled`` call, in two rounds of opposite order; a
    profile of one fused step and of its natural-gradient update alone; the
    classifier's requests; K1 at the path's shapes."""
    got = {mode: [] for mode in trainers}
    for order in (list(trainers), list(reversed(trainers))):
        for mode in order:
            steps = NG_TIMED_STEPS[mode]
            ms = request_ms(lambda: trainers[mode].run_steps_sampled(steps, NG_B), 1, warmup=1)
            got[mode].append(steps / ms * 1e3)
    for mode, rates in got.items():
        log(f"time: natgrad train {mode} at M={NG_M}, B={NG_B}: {max(rates):.2f} steps/s "
            f"({1e3 / max(rates):.3f} ms per step); rounds {[round(r, 2) for r in rates]}")
    fused = trainers["fused"]
    step_by, step_ms = profile_device(lambda: fused.run_steps_sampled(1, NG_B), "natgrad fused step")
    m = fused.model
    X, Y = fused._staged_data
    loss = m._training_loss((X[:NG_B], Y[:NG_B]))
    vgrads = torch.autograd.grad(loss, [m.q_mu.unconstrained, m.q_sqrt.unconstrained])
    update_by, _ = profile_device(
        lambda: fused._natgrad._natgrad_values_with_ok(vgrads[0], vgrads[1], m.q_mu.value, m.q_sqrt.value,
                                                       m.q_mu.transform, m.q_sqrt.transform,
                                                       fused._natgrad.xi_transform),
        "the natural-gradient update alone (conversions, three Choleskys, two triangular inverses, the VJP)")
    if step_by and update_by:
        share = sum(update_by.values()) / sum(step_by.values())
        log(f"profile: the natural-gradient update is {100 * share:.1f}% of a fused step's device time")
    with torch.no_grad():
        for key, fn in (("cached predict_f", lambda: post.predict_f(Xb)), ("predict_y", lambda: model.predict_y(Xb)),
                        ("predict_log_density", lambda: model.predict_log_density((Xb, Yb)))):
            ms = request_ms(fn, 20)
            log(f"time: natgrad classifier {key} at B={NG_B}: {ms:.4f} ms per request ({NG_B / ms * 1e3:.0f} points/s)")
        time_k1(NG_M, NG_M)
        time_k1(NG_M, NG_B)
        time_k2(NG_M, NG_M)  # the Matern52 variant's backward
        time_k2(NG_M, NG_B)
    return got


def kernel_bound_ms(kernel, n, m, d):
    """The least time of K1 or K2 at (n, m, d) with float32 inputs: the
    larger of its bytes (Xs and Zs read once; K1 writes K, K2 reads g and
    writes W) over 3.35 TB/s and its operations (3 d for d2 and about 8 for
    the tail and scale, per element) over 67 TFLOP/s of fp32; and which of
    the two bounds it."""
    nbytes = 4 * (n + m) * d + (4 if kernel == "K1" else 8) * n * m
    ops = n * m * (3 * d + 8)
    by_bytes, by_ops = nbytes / 3.35e12 * 1e3, ops / 67e12 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def svgp_phases(launches):
    """Phases 5-8, and phase 10's timings of the serving and training paths."""
    from gpflow_tpu_torch import config

    values, X = make_values(SEED)
    model = build_model(values, torch.float32)
    requests = [torch.from_numpy(X[i * B:(i + 1) * B]).to("cuda") for i in range(N_REQUESTS)]
    with torch.no_grad():
        outputs, counts = counted(lambda: serve(model, requests))
    # cache: Kuu once; cached requests: Kuf each; fused requests: Kuu + Kuf
    expect_launches("serving", counts, {"K1": 1 + 2 * N_REQUESTS + 2 * 2 * 2, "K2": 0}, launches)
    with config.as_context(config.Config(float=torch.float64, jitter=1e-4, device="cpu")), torch.no_grad():
        reference = serve(build_model(values, torch.float64), [torch.from_numpy(X[:B]).double()])
    check_slice(outputs, reference)

    check_grads()
    check_gram_grads()

    X, Y, Z = make_training_data(SEED)
    data = (torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda())
    trainers = {}
    for kernel in TRAIN_KERNELS:
        for route, flag in TRAIN_ROUTES:
            trainers[kernel, route], launches[f"training {kernel} {route}"] = train(kernel, route, flag, data, Z)
    compare_f64(X, Y, Z)
    launches["trained serving"] = serve_trained(trainers["Matern52", "inv_solve"].model, X)

    with torch.no_grad():
        time_requests(model, requests[0])
    time_training(trainers)
    for (kernel, route), trainer in trainers.items():
        profile_step(trainer, kernel, route)
    with torch.no_grad():
        time_k1(M, M)
        time_k1(M, B)
        time_k2(M, M)
        time_k2(M, B)


def gpr_phases(launches):
    """Phases 9-10."""
    gpr_data, Xnew = make_gpr_data()
    gpr_models = {n: check_gpr_objective("SquaredExponential", n, gpr_data[n], launches) for n in GPR_NS}
    check_gpr_objective("Matern12", GPR_NS[0], gpr_data[GPR_NS[0]], launches)
    torch.cuda.empty_cache()
    time_gpr(gpr_models)
    for route, flag in TRAIN_ROUTES:
        profile_gpr(gpr_models[GPR_NS[-1]], route, flag)
    time_inverse(gpr_models[GPR_NS[-1]])
    del gpr_models[GPR_NS[0]]
    torch.cuda.empty_cache()
    trained = gpr_models[GPR_NS[-1]]
    serve_gpr(trained, Xnew, launches, "initial")
    train_gpr(trained, launches)
    post, Xb = serve_gpr(trained, Xnew, launches, "trained")
    with torch.no_grad():
        for key, fn in (("cached predict_f", lambda: post.predict_f(Xb)),
                        ("cached predict_mean", lambda: post.predict_mean(Xb)),
                        ("fused predict_f", lambda: trained.predict_f(Xb)),
                        ("predict_y", lambda: trained.predict_y(Xb))):
            ms = request_ms(fn, 5, warmup=1)
            log(f"time: gpr {key} N={GPR_NS[-1]} at B={B}: {ms:.3f} ms per request ({B / ms * 1e3:.0f} points/s)")


def ng_phases(launches):
    """Phases 11-12."""
    ng_X, ng_Y, ng_Z, ng_Xnew, ng_Ynew = make_ng_data()
    ng_data = (torch.from_numpy(ng_X).cuda(), torch.from_numpy(ng_Y).cuda())
    ng_check_objective(ng_data, ng_Z, launches)
    ng_trainers = {"fused": ng_train("SquaredExponential", True, NG_FUSED_STEPS, ng_data, ng_Z, launches)}
    ng_compare_f64(True, ng_data, ng_Z)
    ng_trainers["sequential"] = ng_train("SquaredExponential", False, NG_SEQ_STEPS, ng_data, ng_Z, launches)
    ng_compare_f64(False, ng_data, ng_Z)
    ng_train("Matern52", True, NG_MATERN_STEPS, ng_data, ng_Z, launches)
    ng_minimize(ng_data, ng_Z, launches)
    classifier = ng_trainers["fused"].model
    ng_post, ng_Xb, ng_Yb = ng_serve(classifier, ng_Xnew, ng_Ynew, launches)
    ng_timings(ng_trainers, ng_post, classifier, ng_Xb, ng_Yb)


def k1_host_us(calls=SV_HOST_CALLS):
    """Host microseconds per K1 call at (1, 1, 8) through
    ``stationary_forward_cuda``: ``time.perf_counter`` around ``calls``
    calls and one synchronisation at the end. Each launch takes ~3 µs on
    the card, so the host's dispatch, not the kernel, sets the pace."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    Xs, Zs = torch.rand(1, D, device="cuda"), torch.rand(1, D, device="cuda")
    var = torch.ones(1, device="cuda")
    for _ in range(50):
        pd.stationary_forward_cuda("rbf", Xs, Zs, var)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        pd.stationary_forward_cuda("rbf", Xs, Zs, var)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def sv_check_k1():
    """Phase 23: K1 (rbf) against its plain version at ``SV_K1_SHAPES``, on
    the flagship's inputs (uniform on [0, 4]^8), with phase 3's tolerances.
    Returns the largest error against float64."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 80)
    var = torch.tensor([1.0], device="cuda")
    worst, seen = 0.0, set()
    for n, m, d in SV_K1_SHAPES:
        Xs, Zs = (torch.from_numpy((rng.rand(k, d) * 4).astype(np.float32)).cuda() for k in (n, m))
        K = pd.stationary_forward_cuda("rbf", Xs, Zs, var)
        plan = plan_seen("K1", seen)
        plain32 = pd.stationary_forward_plain("rbf", Xs, Zs, var)
        plain64 = pd.stationary_forward_plain("rbf", Xs.double(), Zs.double(), var.double())
        torch.cuda.synchronize()
        err64, err32 = float((K.double() - plain64).abs().max()), float((K - plain32).abs().max())
        log(f"K1 rbf ({n}, {m}, {d}): max abs err {err64:.3e} vs plain f64, tol {K1_ATOL_F64:.1e}; "
            f"{err32:.3e} vs plain f32, tol {K1_ATOL_F32:.1e}; {plan}")
        assert K.shape == (n, m) and err64 <= K1_ATOL_F64 and err32 <= K1_ATOL_F32, \
            f"K1 disagrees with its plain version at {(n, m, d)}"
        worst = max(worst, err64)
    return worst


def sv_outputs(served, Xn):
    """Every method of a served artifact on ``Xn``, as tuples of tensors."""
    outs = {}
    for name in served.methods:
        out = getattr(served, name)(Xn)
        outs[name] = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    return outs


def sv_live(post, likelihood, Xn):
    """The live counterparts of ``sv_outputs`` from a cached posterior."""
    with torch.no_grad():
        mean, var = post.predict_f(Xn)
        return {"predict_f": (mean, var), "predict_y": tuple(likelihood.predict_mean_and_var(Xn, mean, var)),
                "predict_mean": (post.predict_mean(Xn),)}


def sv_compare(what, got, want, rtol, scales=None, floor=1e-30):
    """The largest difference of each output against ``want``, as a
    fraction of the largest entry of ``want`` or ``floor``, the larger (or
    of ``scales[i]``); fails above ``rtol``. Returns the largest."""
    worst = 0.0
    for name, tensors in got.items():
        for i, (g, w) in enumerate(zip(tensors, want[name])):
            assert g.shape == w.shape and bool(torch.isfinite(g).all()), f"{what} {name}[{i}]: {g.shape} {w.shape}"
            scale = scales[i] if scales is not None else max(float(w.abs().max()), floor)
            err = float((g.double() - w.double()).abs().max()) / scale
            log(f"serving: {what}: {name}[{i}] max abs err {err:.3e} of the reference's scale, tol {rtol:.1e}")
            assert err <= rtol, f"serving: {what}: {name}[{i}] disagrees"
            worst = max(worst, err)
    return worst


def sv_k1_tiles(n):
    """The tiles of K1's launch plan for Kuf at (M, n): Z's M rows against
    the request's n columns."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    plan = pd.launch_plans["K1"]
    return plan.tiles == -(-M // plan.tile_rows) * -(-n // pd._TILE_COLS)


def sv_symbolic(model, model64, root, launches):
    """Phase 23 (a): the symbolic export of the flagship SVGP, its loaded
    artifact's requests against the live cached posterior and float64."""
    from gpflow_tpu_torch.utilities import export_serving, load_serving

    path = os.path.join(root, "symbolic")
    _, counts = counted(lambda: export_serving(model, path, input_dim=D, dtype=torch.float32, methods=SV_METHODS))
    expect_launches("serving symbolic export", counts, {"K1": 1, "K2": 0}, launches)  # Kuu of the cache
    served = load_serving(path)
    post, post64 = model.posterior(), model64.posterior()
    rng = np.random.RandomState(SEED + 81)
    requests = {}
    for n in SV_REQUESTS:
        Xn = torch.from_numpy((rng.rand(n, D) * 4).astype(np.float32)).cuda()
        out, counts = counted(lambda: sv_outputs(served, Xn))
        expect_launches(f"serving symbolic request {n}", counts, {"K1": len(SV_METHODS), "K2": 0}, launches)
        assert sv_k1_tiles(n), f"K1's last launch was not Kuf at ({M}, {n})"
        live = sv_compare(f"symbolic {n} against live", out, sv_live(post, model.likelihood, Xn), SV_RTOL,
                          floor=1.0)
        log(f"serving: symbolic request of {n}: largest difference from the live posterior {live:.3e} "
            f"({'exact' if live == 0 else 'not exact'})")
        sv_compare(f"symbolic {n} against f64", out, sv_live(post64, model64.likelihood, Xn.double()),
                   SLICE_RTOL["cached"])
        requests[n] = (Xn, out)
    return served, requests


def sv_bucketed(model, symbolic, root, launches):
    """Phase 23 (b): the bucketed export; each request's launches (one per
    method and chunk) and outputs against the symbolic artifact's."""
    from gpflow_tpu_torch.utilities import export_serving, load_serving

    path = os.path.join(root, "bucketed")
    _, counts = counted(lambda: export_serving(model, path, input_dim=D, dtype=torch.float32, methods=SV_METHODS,
                                               bucket_sizes=SV_BUCKETS))
    expect_launches("serving bucketed export", counts, {"K1": 1, "K2": 0}, launches)
    served = load_serving(path)
    rng = np.random.RandomState(SEED + 82)
    outputs = {}
    for n in SV_BUCKET_REQUESTS:
        Xn = torch.from_numpy((rng.rand(n, D) * 4).astype(np.float32)).cuda()
        chunks = -(-n // SV_BUCKETS[-1])
        out, counts = counted(lambda: sv_outputs(served, Xn))
        expect_launches(f"serving bucketed request {n}", counts, {"K1": len(SV_METHODS) * chunks, "K2": 0},
                        launches)
        last = n - (chunks - 1) * SV_BUCKETS[-1]
        assert sv_k1_tiles(next(b for b in SV_BUCKETS if b >= last)), f"K1's last launch was not a bucket's Kuf"
        with torch.no_grad():
            sv_compare(f"bucketed {n} against symbolic", out, sv_outputs(symbolic, Xn), SV_RTOL, floor=1.0)
        outputs[n] = (Xn, out)
    return path, served, outputs


def sv_gpr(root, launches):
    """Phase 23 (c): the GPR at N = 8192 (``bench.py``'s data), exported
    with a symbolic batch; a request of 8192 points against the live
    posterior and float64 on the card, as phase 9 holds it."""
    from gpflow_tpu_torch.utilities import export_serving, load_serving, read_values

    gpr_data, Xnew = make_gpr_data()
    data = tuple(torch.from_numpy(a).cuda() for a in gpr_data[SV_GPR_N])
    model = gpr_model("SquaredExponential", data, torch.float32)
    path = os.path.join(root, "gpr")
    _, counts = counted(lambda: export_serving(model, path, input_dim=D, dtype=torch.float32,
                                               methods=SV_METHODS[:2]))
    expect_launches("serving gpr export", counts, {"K1": 1, "K2": 0}, launches)  # K(X) of the cache
    served = load_serving(path)
    Xb = torch.from_numpy(Xnew).cuda()
    out, counts = counted(lambda: sv_outputs(served, Xb))
    expect_launches(f"serving gpr request {B}", counts, {"K1": 2, "K2": 0}, launches)  # K(X, Xnew) each
    live = {k: v for k, v in sv_live(model.posterior(), model.likelihood, Xb).items() if k in out}
    err = sv_compare("gpr against live", out, live, SV_RTOL, floor=1.0)
    log(f"serving: gpr request of {B}: largest difference from the live posterior {err:.3e}")
    m64 = gpr_model("SquaredExponential", tuple(t.double() for t in data), torch.float64,
                    {k: v.astype(np.float64) for k, v in read_values(model).items()})
    tol = gram_cond(m64) * EPS32
    want = {k: v for k, v in sv_live(m64.posterior(), m64.likelihood, Xb.double()).items() if k in out}
    prior = float(m64.kernel.variance.value)
    log(f"serving: gpr: cond(K + noise I) <= {tol / EPS32:.4e}; tolerance cond * eps32 = {tol:.3e}")
    for name, (mean, var) in out.items():
        sv_compare(f"gpr {name} against f64", {name: (mean, var)}, {name: want[name]}, tol,
                   scales=(float(want[name][0].abs().max()), prior))
    del served, model, m64
    torch.cuda.empty_cache()


def sv_frozen(model, served, request, root, launches):
    """Phase 23 (d): assigns to the model leave the artifact as it was; an
    export under ``set_pallas_enabled(False)`` launches no K1, and the
    switch stays as the caller set it."""
    from gpflow_tpu_torch.ops import get_pallas_enabled, set_pallas_enabled
    from gpflow_tpu_torch.utilities import export_serving, load_serving

    Xn, before = request
    model.kernel.lengthscales.assign(0.5 * np.ones(D, np.float32))
    model.kernel.variance.assign(2.0)
    with torch.no_grad():
        after = sv_outputs(served, Xn)
    for name in before:
        assert all(torch.equal(a, b) for a, b in zip(after[name], before[name])), f"{name} changed after assign"
    log("serving: the artifact's outputs are unchanged after assigning new kernel values to the model")
    switch = get_pallas_enabled()
    set_pallas_enabled(False)
    try:
        path = os.path.join(root, "plain")
        _, counts = counted(lambda: export_serving(model, path, input_dim=D, dtype=torch.float32,
                                                   methods=("predict_f",)))
        assert get_pallas_enabled() is False, "export changed the switch"
    finally:
        set_pallas_enabled(switch)
    plain = load_serving(path)
    _, request_counts = counted(lambda: plain.predict_f(Xn))
    log(f"serving: the plain-path export launched {counts}, its request {request_counts}")
    assert counts == request_counts == {"K1": 0, "K2": 0}, "a plain-path artifact launched a kernel"


def sv_fresh_process(path, request, root):
    """Phase 23 (e): a process that imports torch and
    ``gpflow_tpu_torch.utilities.serving`` only loads the bucketed artifact
    and serves one request, which must equal this process's to the bit."""
    Xn, out = request
    x_path, out_path = os.path.join(root, "X.npy"), os.path.join(root, "out.npz")
    np.save(x_path, Xn.cpu().numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "from gpflow_tpu_torch.utilities.serving import load_serving\n"
        "from gpflow_tpu_torch.ops import pallas_distance as pd\n"
        "path, x_path, out_path = sys.argv[1:]\n"
        "served = load_serving(path)\n"
        "X = torch.from_numpy(np.load(x_path)).cuda()\n"
        "outs = {name: getattr(served, name)(X) for name in served.methods}\n"
        "arrays = {f'{name}_{i}': t.cpu().numpy() for name, out in outs.items()\n"
        "          for i, t in enumerate(out if isinstance(out, tuple) else (out,))}\n"
        "np.savez(out_path, **arrays)\n"
        "bad = sorted(m for m in sys.modules if m.startswith('gpflow_tpu_torch.models') or m.split('.')[0] == 'jax')\n"
        "assert not bad, bad\n"
        "print('launches', pd.launch_counts['K1'])\n"
    )
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, path, x_path, out_path],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"the loader process failed: {proc.stderr[-3000:]}"
    log(f"serving: a fresh process loaded the bucketed artifact and served {Xn.shape[0]} points in "
        f"{time.perf_counter() - t0:.1f} s with K1 {proc.stdout.split()[-1]} launches, no model code imported")
    assert int(proc.stdout.split()[-1]) == len(SV_METHODS), proc.stdout
    with np.load(out_path) as got:
        for name, tensors in out.items():
            for i, t in enumerate(tensors):
                assert np.array_equal(got[f"{name}_{i}"], t.cpu().numpy()), f"fresh process: {name}[{i}] differs"
    log("serving: the fresh process's outputs equal this process's to the bit")


def sv_checkpoints(model, values, root, launches):
    """Phase 23 (f): a checkpoint of the flagship loads into a fresh model
    with equal outputs; the trainer's state saved after 10 Adam steps on
    explicit batches of B lets a fresh trainer take the next 10 steps to the
    same parameters."""
    from gpflow_tpu_torch.parallel import DataParallelTrainer, adam
    from gpflow_tpu_torch.utilities import load_checkpoint, read_values, save_checkpoint

    ckpt = os.path.join(root, "flagship.npz")
    save_checkpoint(ckpt, model)
    fresh = build_model(values, torch.float32)
    load_checkpoint(ckpt, fresh)
    Xn = torch.from_numpy((np.random.RandomState(SEED + 83).rand(B, D) * 4).astype(np.float32)).cuda()
    with torch.no_grad():
        for a, b in zip(fresh.posterior().predict_f(Xn), model.posterior().predict_f(Xn)):
            assert torch.equal(a, b), "a model loaded from the checkpoint serves other outputs"
    assert all(np.array_equal(read_values(fresh)[k], v) for k, v in read_values(model).items())
    log("serving: the checkpoint round trip gives equal values and outputs")

    X, Y, _ = make_training_data(SEED)
    steps = 2 * SV_TRAIN_STEPS
    Xs = torch.from_numpy(X[:steps * B].reshape(steps, B, D)).cuda()
    Ys = torch.from_numpy(Y[:steps * B].reshape(steps, B, 1)).cuda()

    def trainer():
        return DataParallelTrainer(build_model(values, torch.float32), adam(1e-2))

    first = trainer()
    _, counts = counted(lambda: first.run_steps((Xs[:SV_TRAIN_STEPS], Ys[:SV_TRAIN_STEPS])))
    expect_launches("serving trainer steps", counts, {"K1": 2 * SV_TRAIN_STEPS, "K2": 0}, launches)
    state = os.path.join(root, "trainer.npz")
    first.save_state(state)
    losses = first.run_steps((Xs[SV_TRAIN_STEPS:], Ys[SV_TRAIN_STEPS:]))
    second = trainer()
    second.load_state(state)
    resumed = second.run_steps((Xs[SV_TRAIN_STEPS:], Ys[SV_TRAIN_STEPS:]))
    worst = max(float((a - b).abs().max()) for a, b in zip(first.model.parameters(), second.model.parameters()))
    log(f"serving: trainer state: {SV_TRAIN_STEPS} steps after the restore; largest parameter difference "
        f"{worst:.3e}, losses {'equal' if torch.equal(losses, resumed) else 'differ'} "
        f"(last {float(losses[-1]):.6e} and {float(resumed[-1]):.6e})")
    assert worst == 0.0 and torch.equal(losses, resumed), "the restored trainer took other steps"


def sv_timings(model, symbolic, bucketed):
    """Phase 23 (g): requests by CUDA events, back to back, host included:
    8192 points on the symbolic and bucketed artifacts and the live cached
    posterior, and 5000 points (the bucketed artifact pads them to 8192);
    the op's host time."""
    from gpflow_tpu_torch.utilities import bucket_size_for

    Xn = torch.from_numpy((np.random.RandomState(SEED + 84).rand(B, D) * 4).astype(np.float32)).cuda()
    n = SV_REQUESTS[1]
    post = model.posterior()
    with torch.no_grad():
        for key, fn in ((f"live cached predict_f at {B}", lambda: post.predict_f(Xn)),
                        (f"symbolic artifact predict_f at {B}", lambda: symbolic.predict_f(Xn)),
                        (f"bucketed artifact predict_f at {B}", lambda: bucketed.predict_f(Xn)),
                        (f"live cached predict_f at {n}", lambda: post.predict_f(Xn[:n])),
                        (f"symbolic artifact predict_f at {n}", lambda: symbolic.predict_f(Xn[:n])),
                        (f"bucketed artifact predict_f at {n}, padded to {bucket_size_for(n, SV_BUCKETS)}",
                         lambda: bucketed.predict_f(Xn[:n]))):
            ms = request_ms(fn, 20)
            log(f"time: serving {key}: {ms:.4f} ms per request")
    log(f"time: K1 host dispatch at (1, 1, {D}): {k1_host_us():.2f} µs per call through the registered op "
        f"({SV_HOST_CALLS} calls, one synchronisation)")


def serving_phases(launches):
    """Phase 23: the serving artifacts of the flagship SVGP and the GPR, the
    checkpoints and the trainer's state, K1 at the new shapes, timings."""
    import tempfile

    from gpflow_tpu_torch import config
    from gpflow_tpu_torch.ops.cuda_build import BUILD_DIR

    values, _ = make_values(SEED)
    model = build_model(values, torch.float32)
    with config.as_context(config.Config(float=torch.float64, jitter=1e-4, device="cuda")):
        model64 = build_model(values, torch.float64)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        symbolic, requests = sv_symbolic(model, model64, root, launches)
        path, bucketed, outputs = sv_bucketed(model, symbolic, root, launches)
        sv_gpr(root, launches)
        sv_timings(model, symbolic, bucketed)
        sv_frozen(model, symbolic, requests[SV_REQUESTS[0]], root, launches)
        sv_fresh_process(path, outputs[SV_BUCKET_REQUESTS[1]], root)
        sv_checkpoints(model, values, root, launches)
    del model64
    worst = sv_check_k1()
    with torch.no_grad():
        for n, m, d in SV_K1_SHAPES:
            time_k1(n, m, d=d)
    return {"K1": worst}


def tl_batch():
    """One batch of B rows of phase 7's data (``bench.py``'s generator), on the card."""
    X, Y, _ = make_training_data(SEED)
    return torch.from_numpy(X[:B]).cuda(), torch.from_numpy(Y[:B]).cuda()


def tl_adam_steps(model, closure, steps, after_step=None):
    """``steps`` hand-written Adam steps (``parallel.adam``'s optimizer) of
    the model's trainable parameters on ``closure()``; ``after_step(step)``
    runs after each. Returns the [steps] loss history on the card."""
    from gpflow_tpu_torch.parallel import adam

    opt = adam()([p.unconstrained for p in model.trainable_variables])
    losses = []
    for step in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = closure()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if after_step is not None:
            after_step(step)
    return torch.stack(losses)


def tl_events_ms(fn):
    """``fn()`` and its milliseconds by CUDA events (ending in a synchronise)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def tl_training_loop(values, batch, launches):
    """Phase 24 (a): ``training_loop`` with ``use_scan`` False and True from
    the same start, both under sync debug mode "error", against a hand loop
    of torch.optim.Adam over the same closure. Returns the trained model."""
    from gpflow_tpu_torch.utilities import read_values, training_loop

    warm = build_model(values, torch.float32)  # the optimizer's first step loads code: not timed
    _, counts = counted(lambda: training_loop(warm.training_loss_closure(batch), var_list=warm.trainable_variables,
                                              maxiter=2))
    expect_launches("training_loop warm-up", counts, {"K1": 4, "K2": 0}, launches)
    histories, finals = {}, {}
    trained = None
    for label in ("use_scan=False", "use_scan=True", "hand loop"):
        model = build_model(values, torch.float32)
        closure = model.training_loss_closure(batch)
        if label == "hand loop":
            run = lambda: tl_adam_steps(model, closure, TL_STEPS)  # noqa: E731
        else:
            scan = label == "use_scan=True"
            run = lambda: training_loop(closure, var_list=model.trainable_variables,  # noqa: E731
                                        maxiter=TL_STEPS, use_scan=scan)
        torch.cuda.set_sync_debug_mode("error" if label != "hand loop" else 0)
        try:
            (history, ms), counts = counted(lambda: tl_events_ms(run))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        expect_launches(f"training_loop {label}", counts, {"K1": 2 * TL_STEPS, "K2": 0}, launches)  # Kuu, Kuf
        histories[label] = history.double().cpu()
        finals[label] = read_values(model)
        log(f"time: training_loop {label}: {TL_STEPS} steps at M={M}, B={B} in {ms:.2f} ms, "
            f"{ms / TL_STEPS:.3f} ms per step; loss {float(histories[label][0]):.6e} -> "
            f"{float(histories[label][-1]):.6e}")
        assert history.shape == (TL_STEPS,) and bool(torch.isfinite(history).all()), f"{label}: non-finite loss"
        assert float(histories[label][-1]) < float(histories[label][0]), f"{label}: the loss did not fall"
        if label == "use_scan=False":
            trained = model
    want = histories["hand loop"]
    for label in ("use_scan=False", "use_scan=True"):
        err = float(((histories[label] - want) / want).abs().max())
        bits = bool(torch.equal(histories[label], want))
        value_err = max(float(np.abs(finals[label][k] - v).max()) for k, v in finals["hand loop"].items())
        log(f"training_loop {label} against the hand loop: history max rel err {err:.3e} (equal bits: {bits}), "
            f"final values max abs diff {value_err:.3e}; tol {TL_RTOL:.0e}")
        assert err <= TL_RTOL, f"training_loop {label}: history disagrees with the hand loop"
    return trained


def tl_monitor(values, batch, root, launches):
    """Phase 24 (b): a Monitor with a period-1 group (an ExecuteCallback that
    records the ELBO, a ScalarToTensorBoard) and a period-5 group
    (ModelToTensorBoard) over a TL_STEPS-step loop; the call counts, and the
    event file read back against the logged values."""
    import importlib.util

    from gpflow_tpu_torch.monitor import (ExecuteCallback, ImageToTensorBoard, ModelToTensorBoard, Monitor,
                                          MonitorTaskGroup, ScalarToTensorBoard, ToTensorBoard)
    from gpflow_tpu_torch.utilities import read_values

    model = build_model(values, torch.float32)
    elbos, snapshots = [], {}

    def record_elbo():
        with torch.no_grad():
            elbos.append(float(model.elbo(batch)))

    class CountedModelTask(ModelToTensorBoard):
        def run(self, **kwargs):
            snapshots[self.current_step] = read_values(self.model)
            super().run(**kwargs)

    log_dir = os.path.join(root, "monitor")
    fast = [ExecuteCallback(record_elbo)]
    slow = []
    if importlib.util.find_spec("tensorboard") is None:
        log("monitor: ScalarToTensorBoard, ModelToTensorBoard and ImageToTensorBoard not run: "
            "no tensorboard package on this machine")
    else:
        fast.append(ScalarToTensorBoard(log_dir, lambda: elbos[-1], "elbo"))
        slow.append(CountedModelTask(log_dir, model))
        try:
            slow.append(ImageToTensorBoard(log_dir, lambda fig, ax: ax.plot(elbos), "elbo_curve"))
        except ImportError as e:
            log(f"monitor: ImageToTensorBoard not run: {e}")
    monitor = Monitor(MonitorTaskGroup(fast, period=TL_PERIODS[0]), MonitorTaskGroup(slow, period=TL_PERIODS[1]))
    (_, ms), counts = counted(lambda: tl_events_ms(lambda: tl_adam_steps(
        model, model.training_loss_closure(batch), TL_STEPS, after_step=monitor)))
    # each step: Kuu and Kuf of the loss, and of the recorded ELBO
    expect_launches("monitored loop", counts, {"K1": 4 * TL_STEPS, "K2": 0}, launches)
    calls = (len(elbos), len(snapshots))
    want_calls = (TL_STEPS // TL_PERIODS[0], TL_STEPS // TL_PERIODS[1])
    log(f"monitor: {TL_STEPS} steps, ELBO {elbos[0]:.6e} -> {elbos[-1]:.6e}; calls per group {calls}, "
        f"expected {want_calls if slow else (want_calls[0], 0)}")
    log(f"time: monitored loop: {TL_STEPS} steps with their monitor calls in {ms:.2f} ms, "
        f"{ms / TL_STEPS:.3f} ms per step")
    assert len(elbos) == want_calls[0] and np.all(np.isfinite(elbos))
    assert elbos[-1] > elbos[0], "the monitored loop did not raise the ELBO"
    if not slow:
        return
    assert len(snapshots) == want_calls[1] and sorted(snapshots) == list(range(0, TL_STEPS, TL_PERIODS[1]))
    ToTensorBoard.close_all_writers()
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir, size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    scalars = {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}
    assert scalars["elbo"] == [(i, float(np.float32(v))) for i, v in enumerate(elbos)], "elbo events differ"
    n_model = 0
    for path, first in snapshots[0].items():
        if not path.startswith((".kernel", ".likelihood")):
            continue
        name = path.lstrip(".")
        tags = [name] if first.size == 1 else [f"{name}[{i}]" for i in range(min(first.size, 3))]
        for j, tag in enumerate(tags):
            got = scalars.pop(tag)
            want = [(step, float(np.float32(snap[path].reshape(-1)[j]))) for step, snap in sorted(snapshots.items())]
            assert got == want, f"{tag}: events {got} != logged {want}"
            n_model += 1
    images = acc.Tags()["images"]
    log(f"monitor: event file read back: elbo x{len(elbos)} and {n_model} parameter tags x{len(snapshots)} "
        f"equal the logged values; images {[(t, len(acc.Images(t))) for t in images]}")
    assert set(scalars) == {"elbo"}, f"unexpected scalar tags {sorted(scalars)}"
    if len(slow) == 2:
        assert images == ["elbo_curve"] and len(acc.Images("elbo_curve")) == want_calls[1]


def tl_scipy_monitor(launches):
    """Phase 24 (c): the GPR at N = 8192 fit by ``Scipy().minimize`` with a
    Monitor as ``step_callback``: one call per iteration with the step
    alone, seeing the current iterate; K1 once per evaluation."""
    from gpflow_tpu_torch.monitor import Monitor, MonitorTask, MonitorTaskGroup
    from gpflow_tpu_torch.optimizers import Scipy

    gpr_data, _ = make_gpr_data()
    data = tuple(torch.from_numpy(a).cuda() for a in gpr_data[GPR_NS[0]])
    model = gpr_model("SquaredExponential", data, torch.float32)
    seen = []

    class Record(MonitorTask):
        def run(self, **kwargs):
            seen.append((self.current_step, kwargs, model.likelihood.variance.numpy()))

    with torch.no_grad():
        loss0 = float(model.training_loss())
    t0 = time.perf_counter()
    res, counts = counted(lambda: Scipy().minimize(
        model.training_loss_closure(), model.trainable_variables, options={"maxiter": TL_GPR_ITERS},
        step_callback=Monitor(MonitorTaskGroup(Record(), period=1)), nonfinite_penalty=GPR_PENALTY))
    seconds = time.perf_counter() - t0
    log(f"monitor: gpr N={GPR_NS[0]} Scipy: loss {loss0:.6e} -> {float(res.fun):.6e}, nit {res.nit}, "
        f"nfev {res.nfev}; monitor called at steps {[step for step, _, _ in seen]}")
    log(f"time: monitored gpr lbfgs N={GPR_NS[0]}: {seconds:.3f} s, {1e3 * seconds / res.nfev:.2f} ms per "
        f"evaluation (host clock)")
    expect_launches(f"monitored gpr lbfgs N={GPR_NS[0]}", counts, {"K1": int(res.nfev), "K2": 0}, launches)
    assert [step for step, _, _ in seen] == list(range(res.nit)) and res.nit > 0
    assert all(kwargs == {} for _, kwargs, _ in seen), "the Monitor was called with more than the step"
    assert np.array_equal(seen[-1][2], model.likelihood.variance.numpy()), "the last call saw another iterate"
    assert np.isfinite(res.fun) and float(res.fun) < loss0, "L-BFGS did not lower the GPR objective"


def tl_summary(model):
    """Phase 24 (d): the summary table of the card-trained SVGP, whose
    values come to the host in one copy, against the table built from
    ``read_values`` (one copy per parameter); then ``print_summary``."""
    from tabulate import tabulate

    from gpflow_tpu_torch.utilities import leaf_components, print_summary, read_values, tabulate_module_summary
    from gpflow_tpu_torch.utilities.traversal import _format_value

    t0 = time.perf_counter()
    text = tabulate_module_summary(model)
    ms = 1e3 * (time.perf_counter() - t0)
    values = read_values(model)
    root = type(model).__name__
    rows = [[path, "Parameter", p.transform.name, "", str(p.trainable), str(tuple(p.shape)),
             values[path[len(root):]].dtype.name, _format_value(values[path[len(root):]])]
            for path, p in leaf_components(model).items()]
    want = tabulate(rows, headers=["name", "class", "transform", "prior", "trainable", "shape", "dtype", "value"],
                    tablefmt="fancy_grid")
    log(f"summary: {len(rows)} parameters, table in {ms:.1f} ms on the host clock; equal to read_values' "
        f"table: {text == want}")
    assert text == want, "the summary table's values differ from read_values"
    print_summary(model)


def tl_profile(values, batch, root, launches):
    """Phase 24 (e): ``profile`` around TL_PROFILE_STEPS steps, each under
    ``annotate("train_step")``; the trace must hold the annotation and K1."""
    import glob

    from gpflow_tpu_torch.utilities import annotate, profile, training_loop

    model = build_model(values, torch.float32)
    log_dir = os.path.join(root, "profile")

    def step():
        with annotate("train_step"):
            return training_loop(model.training_loss_closure(batch), var_list=model.trainable_variables,
                                 maxiter=1)

    t0 = time.perf_counter()
    with profile(log_dir):
        _, counts = counted(lambda: [step() for _ in range(TL_PROFILE_STEPS)])
    seconds = time.perf_counter() - t0
    expect_launches("profiled steps", counts, {"K1": 2 * TL_PROFILE_STEPS, "K2": 0}, launches)
    traces = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(traces) == 1, f"profile wrote {traces}"
    with open(traces[0]) as f:
        trace = f.read()
    n_annot, n_k1 = trace.count('"train_step"'), trace.count("stationary_k1_kernel")
    log(f"profile: {TL_PROFILE_STEPS} steps traced in {seconds:.2f} s; {os.path.basename(traces[0])}, "
        f"{len(trace) / 1e6:.1f} MB: 'train_step' x{n_annot}, stationary_k1_kernel x{n_k1}")
    assert n_annot >= TL_PROFILE_STEPS and n_k1 > 0, "the trace lacks the annotation or K1"


def tl_tf32(values, batch, launches):
    """Phase 24 (f): the flagship ELBO's float32 error against float64 on
    the card with exact fp32 matmuls and under the "high" tier (TF32), set
    in-process through ``config.apply_environment_tiers``; then exact fp32
    is restored."""
    from gpflow_tpu_torch import config

    model = build_model(values, torch.float32)
    with config.as_context(config.Config(float=torch.float64, jitter=1e-4, device="cuda")):
        model64 = build_model(values, torch.float64)
    with torch.no_grad():
        want = float(model64.elbo(tuple(t.double() for t in batch)))
        errs = {}
        for tier, environ in (("exact fp32", {}), ("tf32 (GPFLOW_TPU_FAST_MATMUL=high)",
                                                   {"GPFLOW_TPU_FAST_MATMUL": "high"})):
            try:
                config.apply_environment_tiers(environ)
                assert torch.backends.cuda.matmul.allow_tf32 == bool(environ)
                got, counts = counted(lambda: float(model.elbo(batch)))
            finally:
                config.apply_environment_tiers({})
            expect_launches(f"elbo {tier}", counts, {"K1": 2, "K2": 0}, launches)
            errs[tier] = abs(got - want) / abs(want)
            log(f"tier: flagship ELBO at M={M}, B={B} with {tier}: {got:.8e}, float64 {want:.8e}, "
                f"rel err {errs[tier]:.3e}")
            assert np.isfinite(got)
    assert torch.backends.cuda.matmul.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest", "exact fp32 was not restored"
    del model64
    return errs


def tools_phases(launches):
    """Phase 24: training_loop, Monitor with the TensorBoard tasks, the
    monitored Scipy fit, the summary table, the profiler and the matmul tier
    on the flagship SVGP and the GPR at N = 8192."""
    import tempfile

    from gpflow_tpu_torch.ops.cuda_build import BUILD_DIR

    values, _ = make_values(SEED)
    batch = tl_batch()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        trained = tl_training_loop(values, batch, launches)
        tl_monitor(values, batch, root, launches)
        tl_scipy_monitor(launches)
        tl_summary(trained)
        tl_profile(values, batch, root, launches)
    tl_tf32(values, batch, launches)


@contextlib.contextmanager
def ct_checks(on):
    """The port's shape checks on or off inside the block, restored after."""
    from gpflow_tpu_torch.utilities import get_enable_check_shapes, set_enable_check_shapes

    previous = get_enable_check_shapes()
    set_enable_check_shapes(on)
    try:
        yield
    finally:
        set_enable_check_shapes(previous)


def ct_mode(on):
    return "checks on" if on else "checks off"


def ct_same(what, runs):
    """Every run's outputs (a list of tensors) equal to the first run's, to
    the bit and in shape."""
    first = runs[0]
    for i, outs in enumerate(runs[1:], 1):
        assert len(outs) == len(first), f"{what}: run {i} gave {len(outs)} outputs, run 0 {len(first)}"
        for j, (a, b) in enumerate(zip(outs, first)):
            assert a.shape == b.shape and torch.equal(a, b), \
                f"{what}: output {j} of run {i} ({ct_mode(CT_ORDER[i])}) differs from run 0's"
    log(f"contracts {what}: {len(runs)} runs ({', '.join(ct_mode(on) for on in CT_ORDER)}) equal to the bit, "
        f"{len(first)} outputs each")


def ct_steps(trainer, steps, batch):
    """``steps`` calls of ``run_steps_sampled(1, batch)``, each drawing with
    its own seeded generator, under sync debug mode "error"; returns the
    losses [steps], each step's milliseconds by CUDA events, and each step's
    host milliseconds (the time to enqueue it, which the device hides where
    it runs behind)."""
    generators = [torch.Generator(device="cuda").manual_seed(CT_SEED + i) for i in range(steps)]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses, host = [], []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        events[0].record()
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(trainer.run_steps_sampled(1, batch, generator=generators[i]))
            events[i + 1].record()
            host.append(1e3 * (time.perf_counter() - t0))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return torch.cat(losses), [events[i].elapsed_time(events[i + 1]) for i in range(steps)], host


def ct_training(what, build, staged, batch, expected, launches):
    """(a) and (c): CT_STEPS steps of a fresh trainer from ``build()`` in each
    mode of CT_ORDER; the losses and the trained parameters of every run
    equal to the bit, the launch counts ``expected`` in each. Returns the
    median ms per step of steps 2 to CT_STEPS in each mode, by CUDA events
    and on the host clock."""
    runs, ms, host_ms = [], {False: [], True: []}, {False: [], True: []}
    for i, on in enumerate(CT_ORDER):
        with ct_checks(on):
            trainer = build()
            trainer.stage_data(staged)
            (losses, step_ms, step_host), counts = counted(lambda: ct_steps(trainer, CT_STEPS, batch))
        expect_launches(f"contracts {what} run {i} ({ct_mode(on)})", counts, expected, launches)
        assert bool(torch.isfinite(losses).all()), f"contracts {what}: non-finite loss"
        runs.append([losses] + [p.unconstrained.detach().clone() for p in trainer.model.trainable_variables])
        ms[on] += step_ms[1:]
        host_ms[on] += step_host[1:]
    ct_same(what, runs)
    return ({on: float(np.median(v)) for on, v in ms.items()},
            {on: float(np.median(v)) for on, v in host_ms.items()})


def ct_log_step_times(what, ms, host_ms, smi):
    log(f"time: contracts {what}: {ms[False]:.3f} ms per step with the checks off, {ms[True]:.3f} ms with them "
        f"on ({100 * (ms[True] / ms[False] - 1):+.1f}%; CUDA events); host {host_ms[False]:.3f} and "
        f"{host_ms[True]:.3f} ms to enqueue a step ({host_ms[True] - host_ms[False]:+.3f} ms); medians of steps "
        f"2-{CT_STEPS} of two runs each; {smi}")


def ct_value_and_grad(what, build, objective, expected, launches):
    """(b) and (d): the value and gradient of ``objective(build())`` under
    sync debug mode "error" in each mode of CT_ORDER, equal to the bit,
    with the launch counts ``expected`` in each."""
    runs = []
    for i, on in enumerate(CT_ORDER):
        with ct_checks(on):
            model = build()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                (value, grads), counts = counted(lambda: objective(model))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        expect_launches(f"contracts {what} run {i} ({ct_mode(on)})", counts, expected, launches)
        grads = list(grads.values()) if isinstance(grads, dict) else list(grads)
        assert bool(torch.isfinite(value)), f"contracts {what}: non-finite value"
        runs.append([value] + grads)
    ct_same(what, runs)
    log(f"contracts {what}: value {float(runs[0][0]):.6e}")


def ct_flagship_steps(launches, smi):
    """(a): the flagship SVGP's training step (phase 7's model and data)."""
    from gpflow_tpu_torch.parallel import DataParallelTrainer

    X, Y, Z = make_training_data(SEED)
    staged = (torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda())
    for kernel in TRAIN_KERNELS:
        expected = {"K1": 2 * CT_STEPS, "K2": 2 * CT_STEPS if kernel == "Matern52" else 0}
        ms, host_ms = ct_training(f"flagship SVGP step {kernel}",
                                  lambda: DataParallelTrainer(training_model(kernel, Z, torch.float32, "cuda")),
                                  staged, B, expected, launches)
        ct_log_step_times(f"flagship SVGP step {kernel} (M={M}, B={B}, D={D})", ms, host_ms, smi)


def ct_gpr(launches):
    """(b): ``bench.py``'s GPR at N = 8192, value and gradient."""
    data = make_gpr_data()[0][GPR_NS[0]]
    for kernel in ("SquaredExponential", "Matern12"):
        ct_value_and_grad(f"GPR {kernel} N={GPR_NS[0]}", lambda: gpr_model(kernel, data, torch.float32),
                          lambda m: gpr_value_and_grad(m, False),
                          {"K1": 1, "K2": 1 if kernel == "Matern12" else 0}, launches)


def ct_natgrad(launches, smi):
    """(c): the Bernoulli SVGP's fused natural-gradient step with Matern52."""
    from gpflow_tpu_torch.parallel import DataParallelTrainer, adam

    X, Y, Z, _, _ = make_ng_data()
    staged = (torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda())
    # phase 12's counts of a fused step: Kuu and Kuf, and K2 for both
    ms, host_ms = ct_training("Bernoulli SVGP fused natural-gradient step Matern52",
                              lambda: DataParallelTrainer(ng_model("Matern52", Z, torch.float32), adam(1e-2),
                                                          natgrad_gamma=NG_GAMMA, natgrad_fused=True),
                              staged, NG_B, {"K1": 2 * CT_STEPS, "K2": 2 * CT_STEPS}, launches)
    ct_log_step_times(f"Bernoulli SVGP fused natural-gradient step Matern52 (M={NG_M}, B={NG_B})", ms, host_ms,
                      smi)


def ct_sparse(launches):
    """(d): SGPR and the matrix-free CGLB at bench width, at a fixed v."""
    data, Z, _, _ = make_sparse_data()
    v = torch.from_numpy(0.1 * np.random.RandomState(CT_SEED).randn(1, SP_N).astype(np.float32)).cuda()
    objective = lambda m: sparse_value_and_grad(m, lambda mm: mm.training_loss())  # noqa: E731
    for cls, kernel in CT_SPARSE:
        kwargs = {"matrix_free_chunk": SP_CHUNK, "v_grad_optimization": True} if cls == "CGLB" else {}

        def build():
            model = sparse_model(cls, data, Z, torch.float32, kernel=kernel, **kwargs)
            if cls == "CGLB":
                model.aux_vec.assign(v)
            return model

        nc = -(-SP_N // SP_CHUNK)
        # SGPR: Kuu and Kuf (rbf's backward from the saved K); CGLB as phase 15
        expected = ({"K1": 2 + 2 * nc, "K2": 2 + nc} if cls == "CGLB" else {"K1": 2, "K2": 0})
        ct_value_and_grad(f"{cls} {kernel} N={SP_N} M={SP_M}", build, objective, expected, launches)


def ct_malformed(model, post):
    """(e): a request of D = 7 to the flagship's cached and fused
    ``predict_f``, and a q_sqrt of rank 4 to ``gauss_kl`` and to the
    unwhitened ``prior_kl``: each raises ShapeError with the checks on,
    and no kernel launches."""
    from gpflow_tpu_torch.kullback_leiblers import gauss_kl, prior_kl
    from gpflow_tpu_torch.ops import pallas_distance as pd
    from gpflow_tpu_torch.utilities import ShapeError

    X7 = torch.rand(B, D - 1, device="cuda")
    q_mu, q_sqrt = model.q_mu.value.detach(), model.q_sqrt.value.detach()[None]  # [1, 1, M, M]
    calls = (("cached predict_f", lambda: post.predict_f(X7)),
             ("fused predict_f", lambda: model.predict_f(X7)),
             ("gauss_kl", lambda: gauss_kl(q_mu, q_sqrt)),
             ("prior_kl unwhitened", lambda: prior_kl(model.inducing_variable, model.kernel, q_mu, q_sqrt,
                                                      whiten=False)))
    torch.cuda.synchronize()
    pd.launch_counts.update(K1=0, K2=0)
    with ct_checks(True):
        for what, call in calls:
            try:
                call()
            except ShapeError as e:
                log(f"contracts malformed {what}: ShapeError: {e}")
            else:
                raise AssertionError(f"contracts: the malformed {what} did not raise ShapeError")
    torch.cuda.synchronize()
    counts = dict(pd.launch_counts)
    assert counts == {"K1": 0, "K2": 0}, f"contracts: the malformed calls launched {counts}"
    log(f"contracts malformed calls: {len(calls)} raised ShapeError, launches {counts}")


def ct_export(model, post, launches):
    """(f): the flagship exported with the checks on and a symbolic batch;
    the loaded artifact serves SV_REQUESTS, K1 inside the program once per
    method and request, against the live posterior."""
    import tempfile

    from gpflow_tpu_torch.ops.cuda_build import BUILD_DIR
    from gpflow_tpu_torch.utilities import export_serving, load_serving

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(CT_SEED)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root, ct_checks(True):
        path = os.path.join(root, "checked")
        _, counts = counted(lambda: export_serving(model, path, input_dim=D, dtype=torch.float32,
                                                   methods=SV_METHODS))
        expect_launches("contracts export with the checks on", counts, {"K1": 1, "K2": 0}, launches)
        served = load_serving(path)
        for n in SV_REQUESTS:
            Xn = torch.from_numpy((rng.rand(n, D) * 4).astype(np.float32)).cuda()
            out, counts = counted(lambda: sv_outputs(served, Xn))
            expect_launches(f"contracts served request {n}", counts, {"K1": len(SV_METHODS), "K2": 0}, launches)
            assert sv_k1_tiles(n), f"contracts: K1's last launch was not Kuf at ({M}, {n})"
            live = sv_compare(f"contracts checked export {n} against live", out,
                              sv_live(post, model.likelihood, Xn), SV_RTOL, floor=1.0)
            log(f"contracts: request of {n} from the artifact exported with the checks on: largest difference "
                f"from the live posterior {live:.3e} ({'exact' if live == 0 else 'not exact'})")


def contracts_phases(launches):
    """Phase 25: the slices-1-6 paths with the shape checks on and off."""
    _, smi = card_check()
    ct_flagship_steps(launches, smi)
    ct_gpr(launches)
    ct_natgrad(launches, smi)
    ct_sparse(launches)
    values, _ = make_values(SEED)
    model = build_model(values, torch.float32)
    with torch.no_grad():
        post = model.posterior()
        ct_malformed(model, post)
        ct_export(model, post, launches)


@contextlib.contextmanager
def ms_group():
    """An NCCL process group of world size 1 on a ``FileStore`` in a
    temporary directory of the build's, destroyed after."""
    import tempfile

    import torch.distributed as dist

    from gpflow_tpu_torch.ops.cuda_build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), 1), rank=0,
                                world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def ms_warm(mesh):
    """One all-reduce on each of the mesh's groups, so that NCCL makes its
    communicators outside sync debug mode "error"."""
    import torch.distributed as dist

    for name in mesh.mesh_dim_names:
        dist.all_reduce(torch.zeros(1, device=mesh.device_type), group=mesh.get_group(name))
    torch.cuda.synchronize()


def ms_same(what, got, want, how="with a one-rank mesh and without"):
    assert len(got) == len(want), f"mesh {what}: {len(got)} outputs against {len(want)}"
    for j, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and torch.equal(a, b), f"mesh {what}: output {j} differs ({how})"
    log(f"mesh {what}: {how}, {len(want)} outputs equal to the bit")


def ms_build(build, mesh, mode):
    """A trainer from ``build`` in ``mode`` (MS_MODES)."""
    trainer = build(None if mode == "no mesh" else mesh)
    return jt_eager(trainer) if mode == "eager mesh" else trainer


def ms_training(what, build, mesh, staged, batch, expected, forward_k1, launches, smi, host_bound=False,
                steps=MS_STEPS):
    """(a), (b) and (e): ``steps`` steps of a trainer from ``build(mesh)``,
    traced and eager (``ms_build``), and from ``build(None)``, in the order
    MS_ORDER, each as phase 25 runs them (sync debug mode "error", each
    step's batch drawn by its own seeded generator), then the loss of one
    batch twice; every run's losses and trained parameters equal to the
    bit, the launch counts ``expected`` in each (the losses' ``forward_k1``
    each, one forward's), one trace of the step and one of the loss in each traced
    run; ms per step each way by CUDA events (medians of steps 2-``steps``
    of both runs of a mode). A ``host_bound`` path runs once each way,
    untimed, and its three trainers are returned by mode: ``ms_in_turn``
    times them, their steps in turn."""
    runs, ms, trainers = [], {m: [] for m in MS_MODES}, {}
    order = MS_MODES if host_bound else MS_ORDER
    X, Y = staged
    loss_batch = (X[:batch], Y[:batch])
    for i, mode in enumerate(order):
        trainer = trainers[mode] = ms_build(build, mesh, mode)
        trainer.stage_data(staged)
        (losses, step_ms, _), counts = counted(lambda: ct_steps(trainer, steps, batch))
        expect_launches(f"mesh {what} run {i} ({mode})", counts, expected, launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss, loss_counts = counted(lambda: torch.stack([trainer.loss(loss_batch), trainer.loss(loss_batch)]))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        expect_launches(f"mesh {what} run {i} ({mode}): two losses", loss_counts, {"K1": 2 * forward_k1, "K2": 0},
                        launches)
        if mode != "eager mesh":
            traces = (trainer._traced.trace_count, trainer._loss.trace_count)
            assert traces == (1, 1), f"mesh {what} {mode}: {traces} traces of the step and the loss"
        assert bool(torch.isfinite(losses).all()), f"mesh {what}: non-finite loss"
        trainer.finalize()
        runs.append([losses, loss] + [p.unconstrained.detach().clone() for p in trainer.model.trainable_variables])
        ms[mode] += step_ms[1:]
    for run in runs[1:]:
        ms_same(what, run, runs[0], how=f"{len(runs)} runs ({', '.join(order)})")
    if host_bound:
        return trainers
    ms = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"time: mesh {what}: {ms['mesh']:.3f} ms per step on a one-rank mesh traced, {ms['eager mesh']:.3f} eager, "
        f"{ms['no mesh']:.3f} without a mesh ({100 * (ms['mesh'] / ms['no mesh'] - 1):+.1f}% traced, "
        f"{100 * (ms['eager mesh'] / ms['no mesh'] - 1):+.1f}% eager; CUDA events, medians of steps 2-{steps} of two "
        f"runs each, order {'/'.join(MS_ORDER)}); {smi}")


def ms_in_turn(what, trainers, batch, smi):
    """``trainers`` by mode (from ``ms_training``) on a host-bound path:
    MS_AB_STEPS steps of each, one of each in turn, the order rotating
    (the host's speed drifts over seconds, and steps taken in turn share
    its drift), ms per step by CUDA events."""
    marks = []
    for i in range(MS_AB_STEPS):
        for mode in MS_MODES[i % 3:] + MS_MODES[:i % 3]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainers[mode].run_steps_sampled(1, batch, generator=torch.Generator(device="cuda").manual_seed(CT_SEED + i))
            end.record()
            marks.append((mode, start, end))
    torch.cuda.synchronize()
    ab = {m: float(np.median([s.elapsed_time(e) for u, s, e in marks if u == m])) for m in MS_MODES}
    log(f"time in turn: mesh {what}: {ab['mesh']:.3f} ms per step on a one-rank mesh traced, {ab['eager mesh']:.3f} "
        f"eager, {ab['no mesh']:.3f} without a mesh ({100 * (ab['mesh'] / ab['no mesh'] - 1):+.1f}% traced, "
        f"{100 * (ab['eager mesh'] / ab['no mesh'] - 1):+.1f}% eager, traced {100 * (ab['mesh'] / ab['eager mesh'] - 1):+.1f}% "
        f"against eager; CUDA events, medians of {MS_AB_STEPS} steps each, the three trainers' steps in turn); {smi}")


def ms_profile(what, trainers, batch, smi):
    """MS_PROFILE_STEPS steps of each of ``trainers`` (as ``ms_in_turn``
    takes them) under ``torch.profiler``: each step's device busy time,
    kernels and collectives (``record_param_comms``, one a collective) and
    the host time of a collective's record; then what the mesh adds a step:
    the kernels by name, and the host (self CPU) time of the operations
    that only the mesh runs (the collectives and their autograd nodes): the
    traced step on the mesh against the traced step without it. The host
    times are the profiler's, which it inflates."""
    from torch.profiler import ProfilerActivity, profile

    kernels_by_name, host_by_op = {}, {}
    for use_mesh in (True, False):
        trainer = trainers["mesh" if use_mesh else "no mesh"]

        def run():
            for i in range(MS_PROFILE_STEPS):
                trainer.run_steps_sampled(1, batch, generator=torch.Generator(device="cuda").manual_seed(CT_SEED + i))

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and getattr(e, "self_device_time_total", 0) > 0 and not getattr(e, "is_user_annotation", False)]
        kernels_by_name[use_mesh] = {e.key: e.count / MS_PROFILE_STEPS for e in kernels}
        host_by_op[use_mesh] = {e.key: e.self_cpu_time_total / 1e3 / MS_PROFILE_STEPS for e in events
                                if not str(getattr(e, "device_type", "")).endswith("CUDA")}
        comms = [e for e in events if e.key == "record_param_comms"]
        n_comms = sum(e.count for e in comms)
        comm_us = sum(e.cpu_time_total for e in comms) / max(n_comms, 1)
        log(f"profile: mesh {what} {'with' if use_mesh else 'without'} the mesh: device busy "
            f"{sum(e.self_device_time_total for e in kernels) / 1e3 / MS_PROFILE_STEPS:.3f} ms, "
            f"{sum(e.count for e in kernels) / MS_PROFILE_STEPS:.0f} kernels and {n_comms / MS_PROFILE_STEPS:.0f} "
            f"collectives a step, {comm_us:.0f} µs of host time a collective's record (under the profiler); {smi}")

    def added(by_key):
        keys = set(by_key[True]) | set(by_key[False])
        return {k: by_key[True].get(k, 0.0) - by_key[False].get(k, 0.0) for k in keys}

    more_kernels = {k: d for k, d in added(kernels_by_name).items() if d}
    top = sorted(more_kernels.items(), key=lambda kv: -abs(kv[1]))[:8]
    log(f"profile: mesh {what}: the mesh adds {sum(more_kernels.values()):+.0f} kernels a step: "
        + "; ".join(f"{d:+.0f} {k[:60]}" for k, d in top))
    own = {k: v for k, v in host_by_op[True].items() if k not in host_by_op[False]}
    top = sorted(own.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile: mesh {what}: host (self CPU) time a step under the profiler {sum(host_by_op[True].values()):.3f} ms "
        f"with the mesh, {sum(host_by_op[False].values()):.3f} ms without; {sum(own.values()):.3f} ms of it in "
        f"operations that only the mesh runs: " + "; ".join(f"{v:.3f} ms {k[:50]}" for k, v in top) + f"; {smi}")


def ms_flagship(mesh, launches, smi):
    from gpflow_tpu_torch.parallel import DataParallelTrainer

    X, Y, Z = make_training_data(SEED)
    staged = (torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda())
    for kernel in TRAIN_KERNELS:
        expected = {"K1": 2 * MS_STEPS, "K2": 2 * MS_STEPS if kernel == "Matern52" else 0}
        ms_training(f"flagship SVGP step {kernel} (M={M}, B={B}, D={D})",
                    lambda m: DataParallelTrainer(training_model(kernel, Z, torch.float32, "cuda"), mesh=m),
                    mesh, staged, B, expected, 2, launches, smi)


def ms_natgrad(mesh, launches, smi):
    from gpflow_tpu_torch.parallel import DataParallelTrainer, adam

    X, Y, Z, _, _ = make_ng_data()
    staged = (torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda())
    what = f"Bernoulli SVGP fused natural-gradient step Matern52 (M={NG_M}, B={NG_B})"
    build = lambda m: DataParallelTrainer(ng_model("Matern52", Z, torch.float32), adam(1e-2), mesh=m,  # noqa: E731
                                          natgrad_gamma=NG_GAMMA, natgrad_fused=True)
    trainers = ms_training(what, build, mesh, staged, NG_B, {"K1": 2 * MS_STEPS, "K2": 2 * MS_STEPS}, 2, launches,
                           smi, host_bound=True)
    ms_in_turn(what, trainers, NG_B, smi)


def ms_sparse(mesh, launches):
    """(c): phase 25's SGPR and matrix-free CGLB (a fixed v), value and
    gradient under sync debug mode "error", the rows kept whole and split
    over the one-rank mesh by ``shard_internal_data``."""
    from gpflow_tpu_torch.parallel import shard_internal_data

    data, Z, _, _ = make_sparse_data()
    v = torch.from_numpy(0.1 * np.random.RandomState(CT_SEED).randn(1, SP_N).astype(np.float32)).cuda()
    objective = lambda m: sparse_value_and_grad(m, lambda mm: mm.training_loss())  # noqa: E731
    nc = -(-SP_N // SP_CHUNK)
    for cls, kernel in CT_SPARSE:
        kwargs = {"matrix_free_chunk": SP_CHUNK, "v_grad_optimization": True} if cls == "CGLB" else {}
        expected = {"K1": 2 + 2 * nc, "K2": 2 + nc} if cls == "CGLB" else {"K1": 2, "K2": 0}
        runs = {}
        for split in (True, False):
            model = sparse_model(cls, data, Z, torch.float32, kernel=kernel, **kwargs)
            if cls == "CGLB":
                model.aux_vec.assign(v)
            if split:
                shard_internal_data(model, mesh)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                (value, grads), counts = counted(lambda: objective(model))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            expect_launches(f"mesh {cls} {kernel} {'split' if split else 'whole'}", counts, expected, launches)
            runs[split] = [value] + list(grads.values())
        ms_same(f"{cls} {kernel} N={SP_N} M={SP_M} value and gradient", runs[True], runs[False])


def ms_serving(mesh, launches):
    """(d) and (f): ``sharded_predict_f`` of MS_REQUEST points of the
    flagship (phase 5's values), twice for each keyword set (the diagonal,
    which splits the rows, and ``full_cov``, which predicts them whole),
    against ``predict_f``, under sync debug mode "error": one trace a
    keyword set (``sharded._PREDICT_JITS``), each call equal to the bit;
    then the same points as a numpy array."""
    from gpflow_tpu_torch.parallel import sharded, sharded_predict_f

    values, _ = make_values(SEED)
    model = build_model(values, torch.float32)
    Xnp = (np.random.RandomState(SEED + 101).rand(MS_REQUEST, D) * 4.0).astype(np.float32)
    X = torch.from_numpy(Xnp).cuda()
    with torch.no_grad():
        for kwargs, k1 in (({}, 2), ({"full_cov": True}, 3)):  # full_cov: K(Xnew, Xnew) too
            name = "full_cov" if kwargs else "diagonal"
            outs = []
            for call in ("sharded_predict_f, call 1", "sharded_predict_f, call 2", "predict_f"):
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out, counts = counted(lambda: model.predict_f(X, **kwargs) if call == "predict_f"
                                          else sharded_predict_f(model, X, mesh, **kwargs))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                expect_launches(f"mesh request of {MS_REQUEST} ({name}), {call}", counts, {"K1": k1, "K2": 0},
                                launches)
                outs.append(list(out))
            traces = sharded._PREDICT_JITS[tuple(sorted(kwargs.items()))].trace_count
            assert traces == 1, f"sharded_predict_f ({name}): {traces} traces"
            for out in outs[:2]:
                ms_same(f"sharded_predict_f of {MS_REQUEST} points ({name})", out, outs[2],
                        how="traced (one trace, two calls) and predict_f")
            if not kwargs:
                whole = outs[2]
        out, counts = counted(lambda: model.predict_f(Xnp))
        expect_launches(f"mesh numpy request of {MS_REQUEST}", counts, {"K1": 2, "K2": 0}, launches)
        assert all(t.device == X.device for t in out), "a numpy request's outputs are not on the model's device"
        ms_same(f"request of {MS_REQUEST} points (F3)", list(out), whole, how="numpy and tensor requests")


def ms_latent(launches, smi):
    """(e): phase 19's main model with ``latent_axis`` on a
    {"data": 1, "latent": 1} mesh: Adam steps, then sequential
    natural-gradient steps (the latent ranks' acceptance, ``Blocks.all_true``,
    an all-reduce inside the traced step)."""
    from gpflow_tpu_torch.parallel import DataParallelTrainer, adam, make_mesh

    grid = make_mesh(shape={"data": 1, "latent": 1})
    ms_warm(grid)
    (X, Y), _, Zs, W = make_mo_data()
    staged = (torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda())
    per_step = mo_launches("lmc")
    what = f"multioutput SVGP step, {MO_L} latent GPs (M={MO_M}, B={MO_B}, D={MO_D})"
    build = lambda m: DataParallelTrainer(mo_model("lmc", Zs, W, torch.float32), adam(1e-2), mesh=m,  # noqa: E731
                                          latent_axis="latent" if m is not None else None)
    trainers = ms_training(what, build, grid, staged, MO_B, {k: MS_STEPS * v for k, v in per_step.items()},
                           per_step["K1"], launches, smi, host_bound=True)
    ms_in_turn(what, trainers, MO_B, smi)
    ms_profile(what, trainers, MO_B, smi)
    # two forward and backward passes a step: the natural gradients' (of q(u) only: no K2), then the optimizer's
    build = lambda m: DataParallelTrainer(mo_model("lmc", Zs, W, torch.float32), adam(1e-2), mesh=m,  # noqa: E731
                                          latent_axis="latent" if m is not None else None, natgrad_gamma=MO_NG_GAMMA)
    ms_training(f"multioutput SVGP sequential natural-gradient step, {MO_L} latent GPs (M={MO_M}, B={MO_B})", build,
                grid, staged, MO_B, {"K1": 2 * MS_LATENT_NG_STEPS * per_step["K1"],
                                     "K2": MS_LATENT_NG_STEPS * per_step["K2"]}, per_step["K1"],
                launches, smi, host_bound=True, steps=MS_LATENT_NG_STEPS)


def mesh_phases(launches):
    """Phase 26: the one-rank mesh."""
    import torch.distributed as dist

    from gpflow_tpu_torch.parallel import make_mesh

    _, smi = card_check()
    with ms_group():
        mesh = make_mesh()
        ms_warm(mesh)
        log(f"mesh: {mesh} over a {dist.get_backend()} group of world size {dist.get_world_size()}")
        for part, run in (("flagship", lambda: ms_flagship(mesh, launches, smi)),
                          ("natural gradients", lambda: ms_natgrad(mesh, launches, smi)),
                          ("sparse", lambda: ms_sparse(mesh, launches)),
                          ("serving", lambda: ms_serving(mesh, launches)),
                          ("latent axis", lambda: ms_latent(launches, smi))):
            t0 = time.perf_counter()
            run()
            log(f"time: mesh {part}: {time.perf_counter() - t0:.1f} s")


def rf_reference_run():
    """Starts phase 27's subset of the JAX package's tests on the port with
    the card as the default device, in float64 (which no kernel serves);
    returns the process and the run's report path. The process is killed
    at exit if it still runs."""
    import tempfile

    from tests import test_torch_reference_plugin as reference

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gpflow_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="reference_", dir=build)
    report = os.path.join(workdir, "outcomes.json")
    env = {**os.environ, **reference.SERIAL, reference.DEVICE_VARIABLE: "cuda", reference.REPORT_VARIABLE: report}
    with open(os.path.join(workdir, "output.txt"), "w") as output:  # no pipe to fill while the build runs
        proc = subprocess.Popen([*reference.command(RF_FILES), f"--basetemp={os.path.join(workdir, 'tmp')}"],
                                cwd=reference.REPO, env=env, stdout=output, stderr=subprocess.STDOUT,
                                stdin=subprocess.DEVNULL)
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    return proc, report


def rf_reference_check(proc, report):
    """Phase 27's subset: every committed node of ``RF_FILES`` ran and
    passed, or failed as its row of the table of differences says."""
    from tests import test_torch_reference_plugin as reference

    try:
        proc.wait(timeout=RF_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(os.path.join(os.path.dirname(report), "output.txt")) as f:
        out = f.read()
    tail = "\n".join(out.splitlines()[-40:])
    assert os.path.exists(report), f"the reference run wrote no report (exit code {proc.returncode}):\n{tail}"
    with open(report) as f:
        outcomes = json.load(f)
    nodes = reference.committed_nodes(RF_FILES)
    bad = [reason[-1500:] for reason in map(lambda node: reference.mismatch(node, outcomes), nodes) if reason]
    log(f"reference: {len(nodes)} JAX tests of {len(RF_FILES)} files on the card, {len(bad)} not as expected; "
        f"{out.strip().splitlines()[-1] if out.strip() else ''}")
    assert not bad, "\n".join(bad[:10])
    assert sorted(outcomes) == sorted(nodes), "the run's nodes are not the committed ones"


def rf_pair(what, numpy_route, tensor_route, uploads, launches, expected):
    """One entry point's numpy route against its tensor route: equal to the
    bit, on the card, with the same K1 launches (``expected``); the tensor
    route under sync debug mode "error", the numpy route's syncs counted."""
    want, want_counts = counted(lambda: without_syncs(tensor_route))
    (got, syncs), got_counts = counted(lambda: count_syncs(numpy_route))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cuda", f"{what}: {type(g)} on {g.device}"
        assert g.dtype == w.dtype and torch.equal(g, w), f"{what}: the numpy route differs from the tensor route"
    log(f"numpy route {what}: equal to the bit to the tensor route on {got[0].device}, shapes "
        f"{[tuple(g.shape) for g in got]}; {syncs} host syncs for {uploads} uploads")
    assert syncs <= uploads, f"{what}: {syncs} host syncs for {uploads} uploads"
    expect_launches(f"{what} (tensor route)", want_counts, expected, launches)
    expect_launches(f"{what} (numpy route)", got_counts, expected, launches)


def reference_phases(launches):
    """Phase 27: numpy at the functional API on the card, and the JAX
    package's tests of ``RF_FILES`` on the port beside it."""
    from gpflow_tpu_torch.conditionals import conditional
    from gpflow_tpu_torch.covariances import Kuf, Kuu
    from gpflow_tpu_torch.inducing_variables import InducingPoints
    from gpflow_tpu_torch.kullback_leiblers import gauss_kl

    t0 = time.perf_counter()
    proc, report = RF_RUNS.pop() if RF_RUNS else rf_reference_run()
    values, X = make_values(SEED)
    model = build_model(values, torch.float32)
    kernel, iv = model.kernel, model.inducing_variable
    Xnew_np = X[:B]
    q_mu_np, q_sqrt_np, Z_np = values[".q_mu"], values[".q_sqrt"], values[".inducing_variable.Z"]
    Xnew, q_mu, q_sqrt = (torch.as_tensor(a, device="cuda") for a in (Xnew_np, q_mu_np, q_sqrt_np))
    iv_np, iv_t = InducingPoints(Z_np), InducingPoints(torch.as_tensor(Z_np, device="cuda"))
    torch.cuda.synchronize()
    jitter = 1e-4
    k1 = lambda n: {"K1": n, "K2": 0}  # noqa: E731
    with torch.no_grad():
        rf_pair("conditional (M=2048, B=8192, D=8)",
                lambda: conditional(Xnew_np, iv, kernel, q_mu_np, q_sqrt=q_sqrt_np, white=True),
                lambda: conditional(Xnew, iv, kernel, q_mu, q_sqrt=q_sqrt, white=True), 3, launches, k1(2))
        rf_pair("Kuu of inducing points built from numpy (M=2048, D=8)",
                lambda: Kuu(iv_np, kernel, jitter=jitter), lambda: Kuu(iv_t, kernel, jitter=jitter), 0,
                launches, k1(1))
        rf_pair("Kuf of numpy Xnew (M=2048, B=8192, D=8)", lambda: Kuf(iv, kernel, Xnew_np),
                lambda: Kuf(iv, kernel, Xnew), 1, launches, k1(1))
        rf_pair("gauss_kl of numpy q_mu and q_sqrt (M=2048)", lambda: gauss_kl(q_mu_np, q_sqrt_np),
                lambda: gauss_kl(q_mu, q_sqrt), 2, launches, k1(0))
        rf_pair("Parameter arithmetic with numpy on either side (B=8192, D=8)",
                lambda: (kernel.variance * Xnew_np, Xnew_np - kernel.lengthscales),
                lambda: (kernel.variance.value * Xnew, Xnew - kernel.lengthscales.value), 2, launches, k1(0))
    log(f"time: numpy routes: {time.perf_counter() - t0:.1f} s")
    rf_reference_check(proc, report)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("gpflow_tpu", "jax", "jaxlib"))
    assert not loaded, f"the script loaded {loaded[:5]}"


def tr_slow(root, path):
    """The test names of a translated file that are marked ``slow`` (by the
    module's ``pytestmark`` or their own decorator), which the plugin
    deselects as tier-1 does."""
    import ast

    with open(os.path.join(root, path)) as f:
        tree = ast.parse(f.read())
    slow = lambda node: isinstance(node, ast.Attribute) and node.attr == "slow"  # noqa: E731
    tests = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]
    if any(isinstance(n, ast.Assign) and any(getattr(t, "id", None) == "pytestmark" for t in n.targets)
           and slow(n.value) for n in tree.body):
        return {n.name for n in tests}
    return {n.name for n in tests if any(slow(d) for d in n.decorator_list)}


def tr_files():
    """Phase 28's files: the translation of each JAX file of the map with a
    row that is not queued; the status of each translated test by its file
    and name; and the rows whose test is marked slow."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, TR_MAP)) as f:
        rows = json.load(f)
    status = {}
    for row in rows:
        if row["status"] != "queued":
            stem = os.path.basename(row["file"])[len("test_"):]
            status[(f"tests/test_torch_translated_{stem}", row["test"])] = row["status"]
    files = sorted({path for path, _ in status})
    slow = {(path, name) for path in files for name in tr_slow(root, path)}
    return files, status, slow


def tr_start_early():
    """Starts the translated files that launch no kernel but the longest,
    ``TR_ALONE``'s first, which ``main`` starts before the others (see
    ``TR_ALONE``)."""
    files = [f for f in tr_files()[0] if f not in TR_LAUNCHES and f not in TR_ALONE]
    runs = []
    for path in TR_ALONE[1:]:
        runs += tr_run([path], 1, "alone", TR_NICE)
    return runs + tr_run(files, TR_PROCESSES, "early", TR_NICE)


def tr_start_kernels():
    """Starts the translated files that launch K1 or K2, in one process."""
    return tr_run(sorted(TR_LAUNCHES), 1, "kernels")


def tr_run(files, processes, tag, nice=0):
    """Starts ``processes`` pytest processes on ``files`` (each file, the
    longest first, to the process with the fewest bytes of files yet), at
    ``nice``; returns each process with its report and state paths. Each is
    killed at exit if it still runs."""
    import tempfile

    from tests import test_torch_reference_plugin as reference

    root = os.path.dirname(os.path.abspath(__file__))
    shares = [[0, []] for _ in range(processes)]
    for size, path in sorted(((os.path.getsize(os.path.join(root, f)), f) for f in files), reverse=True):
        share = min(shares, key=lambda s: s[0])
        share[0] += size
        share[1].append(path)
    build = os.path.join(root, "gpflow_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    runs = []
    for i, (_, files) in enumerate(shares):
        workdir = tempfile.mkdtemp(prefix=f"{tag}{i}_", dir=build)
        report, state = os.path.join(workdir, "outcomes.json"), os.path.join(workdir, "state.json")
        env = {**os.environ, **reference.SERIAL, reference.DEVICE_VARIABLE: "cuda",
               reference.REPORT_VARIABLE: report, reference.STATE_VARIABLE: state}
        with open(os.path.join(workdir, "output.txt"), "w") as output:
            proc = subprocess.Popen([*reference.command(files), "--durations=3",
                                     f"--basetemp={os.path.join(workdir, 'tmp')}"],
                                    cwd=reference.REPO, env=env, stdout=output, stderr=subprocess.STDOUT,
                                    stdin=subprocess.DEVNULL, preexec_fn=(lambda: os.nice(nice)) if nice else None)
        atexit.register(lambda proc=proc: proc.poll() is None and (proc.kill(), proc.wait()))
        runs.append((proc, report, state))
    return runs


def translated_phases(launches):
    """Phase 28: the translated JAX test files on the card, from the
    processes that ``main`` started (``TR_RUNS``; started here where it did
    not). Every test passes, or fails as its deviation row's strict xfail
    expects, or skips itself; every translated row ran but those marked slow, which no row
    of them did; each process built on "cuda"; each file launched K1 and K2
    as ``TR_LAUNCHES`` says, at the shapes logged, and K2 too: the JAX
    package's own kernel tests hold K1 and K2 to their tolerances."""
    t0 = time.perf_counter()
    files, status, slow = tr_files()
    runs = list(TR_RUNS) or tr_run([TR_ALONE[0]], 1, "alone") + tr_start_early() + tr_start_kernels()
    TR_RUNS.clear()
    outcomes, counts, bad, devices, by_test = {}, {"K1": 0, "K2": 0}, [], [], {}
    for proc, report, state in runs:
        try:
            proc.wait(timeout=TR_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(os.path.join(os.path.dirname(report), "output.txt")) as f:
            out = f.read()
        tail = "\n".join(out.splitlines()[-40:])
        assert os.path.exists(report) and os.path.exists(state), \
            f"a translated run wrote no report (exit code {proc.returncode}):\n{tail}"
        with open(state) as f:
            st = json.load(f)
        devices.append(st["default_device"])
        for k in counts:
            counts[k] += st["launch_counts"][k]
        by_test.update(st["launches_by_test"])
        with open(report) as f:
            outcomes.update(json.load(f))
        slowest = [line.strip() for line in out.splitlines() if re.match(r"^\d+\.\d+s (call|setup|teardown) ", line)]
        log(f"translated: {out.strip().splitlines()[-1] if out.strip() else ''}; launches {st['launch_counts']}; "
            f"slowest: {'; '.join(slowest)}")
    by_file = {}
    for node, records in sorted(by_test.items()):
        for kernel, family, n, m, d in records:
            per = by_file.setdefault(node.partition("::")[0], {"K1": 0, "K2": 0, "shapes": {}})
            per[kernel] += 1
            shape = f"{kernel} {family} ({n}, {m}, {d})"
            per["shapes"][shape] = per["shapes"].get(shape, 0) + 1
    for path, per in sorted(by_file.items()):
        log(f"translated launches: {path}: K1 {per['K1']}, K2 {per['K2']}: "
            + ", ".join(f"{k} x{v}" for k, v in sorted(per["shapes"].items())))
    log(f"translated: {TR_RANKS_FILE}'s tests ran on 8 gloo ranks of the host's CPU (the machine has one card)")
    for node, entry in sorted(outcomes.items()):
        path, _, name = node.partition("::")
        row = status.get((path, name.split("[")[0]))
        expected = ("passed", "skipped") if row == "translated" else ("xfailed",)
        if row is None or entry["outcome"] not in expected:
            bad.append(f"{node}: {entry['outcome']} (map: {row})\n{entry['message'][-1500:]}")
    ran = {(node.partition("::")[0], node.partition("::")[2].split("[")[0]) for node in outcomes}
    missing = sorted(set(status) - ran - slow)
    log(f"translated: {len(outcomes)} tests of {len(files)} files on the card, {len(bad)} not as "
        f"the map says, {len(missing)} rows that did not run, {len(slow)} rows marked slow and deselected "
        f"as tier-1 deselects them ({', '.join(f'{p}::{n}' for p, n in sorted(slow))}); "
        f"K1 {counts['K1']}, K2 {counts['K2']} launches; {time.perf_counter() - t0:.1f} s")
    assert not bad, "\n".join(bad[:10])
    assert not missing, f"rows that did not run: {missing[:10]}"
    assert not (ran & slow), f"rows marked slow that ran: {sorted(ran & slow)}"
    assert devices == ["cuda"] * len(runs), f"the translated runs built on {devices}"
    recorded = {k: sum(per[k] for per in by_file.values()) for k in ("K1", "K2")}
    assert recorded == counts, f"the recorded launches {recorded} are not the counted ones {counts}"
    for path in files:
        per = by_file.get(path, {"K1": 0, "K2": 0})
        expected = TR_LAUNCHES.get(path, {"K1": 0, "K2": 0})
        assert {k: per[k] for k in ("K1", "K2")} == expected, f"{path}: launches {per}, expected {expected}"
    assert TR_NO_LAUNCH not in by_test, f"{TR_NO_LAUNCH} launched {by_test[TR_NO_LAUNCH]}"
    expected = {k: sum(e[k] for e in TR_LAUNCHES.values()) for k in ("K1", "K2")}
    expect_launches("translated JAX tests (phase 28)", counts, expected, launches)
    assert counts["K1"] > 0 and counts["K2"] > 0, f"the translated tests launched K1 or K2 no time: {counts}"
    for family, n, m, d in TR_K1_TIMED:
        time_k1(n, m, d=d, family=family)
    for family, n, m, d in TR_K2_TIMED:
        time_k2(n, m, family=family, d=d)


def jt_mode(traced):
    return "traced" if traced else "eager"


def jt_eager(trainer):
    """The trainer with its step and its loss run eagerly: the bodies that
    its jits trace (the optimizer's update inside the step) in their place."""
    trainer._traced, trainer._loss = trainer._model_step, trainer._model_loss
    return trainer


def jt_same(what, runs, order):
    """Every run's outputs (a list of tensors) equal to the first run's, to
    the bit and in shape."""
    for i, outs in enumerate(runs[1:], 1):
        assert len(outs) == len(runs[0]), f"{what}: run {i} gave {len(outs)} outputs, run 0 {len(runs[0])}"
        for j, (a, b) in enumerate(zip(outs, runs[0])):
            assert a.shape == b.shape and torch.equal(a, b), \
                f"{what}: output {j} of run {i} ({jt_mode(order[i])}) differs from run 0's ({jt_mode(order[0])})"
    log(f"compile {what}: {len(runs)} runs ({', '.join(jt_mode(t) for t in order)}) equal to the bit, "
        f"{len(runs[0])} outputs each")


def jt_training(what, build, staged, batch, expected, launches, smi):
    """JT_STEPS steps (phase 25's ``ct_steps``: ``run_steps_sampled(1)``
    with seeded draws, under sync debug mode "error") of a fresh trainer
    from ``build()``, traced and eager in JT_ORDER: the losses and the
    trained parameters equal to the bit, the launch counts ``expected`` in
    each run, one trace in each traced run (its first step); the median ms
    per step of steps 2 to JT_STEPS each way, by CUDA events and on the
    host clock."""
    runs, ms, host_ms, first = [], {False: [], True: []}, {False: [], True: []}, {False: [], True: []}
    for i, traced in enumerate(JT_ORDER):
        trainer = build()
        if not traced:
            jt_eager(trainer)
        trainer.stage_data(staged)
        (losses, step_ms, step_host), counts = counted(lambda: ct_steps(trainer, JT_STEPS, batch))
        expect_launches(f"compile {what} run {i} ({jt_mode(traced)})", counts, expected, launches)
        if traced:
            assert trainer._traced.trace_count == 1, f"{what}: {trainer._traced.trace_count} traces"
        assert bool(torch.isfinite(losses).all()), f"compile {what}: non-finite loss"
        runs.append([losses] + [p.unconstrained.detach().clone() for p in trainer.model.trainable_variables])
        ms[traced] += step_ms[1:]
        host_ms[traced] += step_host[1:]
        first[traced].append(step_host[0])
    jt_same(what, runs, JT_ORDER)
    ms = {t: float(np.median(v)) for t, v in ms.items()}
    host_ms = {t: float(np.median(v)) for t, v in host_ms.items()}
    log(f"time: compile {what}: {ms[False]:.3f} ms per step eager, {ms[True]:.3f} ms traced "
        f"({100 * (ms[True] / ms[False] - 1):+.1f}%; CUDA events); host {host_ms[False]:.3f} and {host_ms[True]:.3f} ms "
        f"to enqueue a step; medians of steps 2-{JT_STEPS} of two runs each way; the first step's host ms "
        f"{first[False]} eager, {first[True]} traced (the trace); {smi}")


def jt_gpr_fit(launches):
    """The GPR at N = 8192 (Matern52, so that K2 launches) fit by
    ``Scipy().minimize`` for JT_GPR_ITERS iterations, traced (the default,
    over ``training_loss_closure()``) and eager (``compile=False`` over
    ``training_loss``), from one start: the iterates, the objective and the
    evaluations equal to the bit, K1 and K2 once per evaluation each way,
    one trace for all the traced evaluations."""
    from gpflow_tpu_torch.optimizers import Scipy

    data = make_gpr_data()[0][GPR_NS[0]]
    runs, order = [], (True, False)
    for traced in order:
        model = gpr_model("Matern52", data, torch.float32)
        opt = Scipy()
        closure = model.training_loss_closure() if traced else model.training_loss
        res, counts = counted(lambda: opt.minimize(closure, model.trainable_variables, compile=traced,
                                                   options={"maxiter": JT_GPR_ITERS}, nonfinite_penalty=GPR_PENALTY))
        expect_launches(f"compile GPR N={GPR_NS[0]} Scipy fit ({jt_mode(traced)})", counts,
                        {"K1": int(res.nfev), "K2": int(res.nfev)}, launches)
        evaluate = next(iter(opt.compile_cache.values()))[0]
        if traced:
            assert evaluate.traced.trace_count == 1, f"GPR fit: {evaluate.traced.trace_count} traces"
        runs.append([torch.from_numpy(np.asarray(res.x)), torch.tensor([float(res.fun), res.nfev, res.nit])])
        log(f"compile GPR N={GPR_NS[0]} Scipy fit ({jt_mode(traced)}): loss {float(res.fun):.6e}, nit {res.nit}, "
            f"nfev {res.nfev}")
    jt_same(f"GPR N={GPR_NS[0]} Scipy fit", runs, order)


def jt_gpr_evaluations(launches, smi):
    """JT_EVALS evaluations of ``Scipy``'s L-BFGS function of the GPR at
    N = 16384 (Matern52) at its start, traced and eager in turns after one
    of each (the trace): equal to the bit, K1 and K2 once each; the median
    ms of an evaluation each way on the host clock (an evaluation ends in
    its download)."""
    from gpflow_tpu_torch.optimizers import Scipy

    data = make_gpr_data()[0][GPR_NS[1]]
    model = gpr_model("Matern52", data, torch.float32)
    x0 = Scipy().initial_parameters(model.trainable_variables)
    funcs = {traced: Scipy().eval_func(model.training_loss, model.trainable_variables, compile=traced)
             for traced in (False, True)}
    outs, ms = {False: [], True: []}, {False: [], True: []}
    for k in range(JT_EVALS + 1):
        for traced in (False, True) if k % 2 == 0 else (True, False):
            t0 = time.perf_counter()
            out, counts = counted(lambda: funcs[traced](x0))
            if k:
                ms[traced].append(1e3 * (time.perf_counter() - t0))
            expect_launches(f"compile GPR N={GPR_NS[1]} evaluation {k} ({jt_mode(traced)})", counts,
                            {"K1": 1, "K2": 1}, launches)
            outs[traced].append(torch.from_numpy(np.concatenate([np.ravel(out[0]), out[1]])))
    jt_same(f"GPR N={GPR_NS[1]} evaluation", outs[False] + outs[True], (False,) * len(outs[False]) + (True,) * len(outs[True]))
    log(f"time: compile GPR N={GPR_NS[1]} L-BFGS evaluation: {np.median(ms[False]):.3f} ms eager, "
        f"{np.median(ms[True]):.3f} ms traced (host clock, medians of {JT_EVALS}, in turns); {smi}")


def jt_training_loop(launches, smi):
    """``training_loop`` on the flagship SVGP (phase 7's model with Matern52,
    one batch of B rows of its data) under sync debug mode "error", eager
    (``compile=False`` over an eager closure) and traced (``use_scan=True``
    over the traced closure, one trace a call), 1 + JT_LOOP_STEPS steps each
    way from one start: the histories and the trained values equal to the
    bit, Kuu and Kuf (K1) and their gradients (K2) every step; a step's ms
    by CUDA events recorded after each step's update (Adam, as by default,
    inside the step: ``_optim.Update.commit`` closes a step on the host), the
    median of steps 2 to the last, and the first step's on the host clock
    (in the traced run, with its trace)."""
    from gpflow_tpu_torch import _compile, _optim
    from gpflow_tpu_torch.parallel import adam
    from gpflow_tpu_torch.utilities import training_loop

    X, Y, Z = make_training_data(SEED)
    batch = (torch.from_numpy(X[:B]).cuda(), torch.from_numpy(Y[:B]).cuda())
    runs, ms, first = [], {}, {}
    for i, traced in enumerate((False, True)):
        model = training_model("Matern52", Z, torch.float32, "cuda")
        closure = model.training_loss_closure(batch, compile=traced)
        options = {"use_scan": True} if traced else {}
        events, marks = [], []
        commit = _optim.Update.commit

        def timed_commit(self, *args):
            commit(self, *args)
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            marks.append(time.perf_counter())

        traces = sum(_compile.trace_counts.values())
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        _optim.Update.commit = timed_commit
        try:
            t0 = time.perf_counter()
            history, counts = counted(lambda: training_loop(closure, optimizer=adam(1e-2),
                                                            var_list=model.trainable_variables,
                                                            maxiter=1 + JT_LOOP_STEPS, **options))
        finally:
            _optim.Update.commit = commit
            torch.cuda.set_sync_debug_mode(0)
        expect_launches(f"compile training_loop run {i} ({jt_mode(traced)})", counts,
                        {"K1": 2 * (1 + JT_LOOP_STEPS), "K2": 2 * (1 + JT_LOOP_STEPS)}, launches)
        traces = sum(_compile.trace_counts.values()) - traces
        assert traces == int(traced), f"training_loop ({jt_mode(traced)}): {traces} traces"
        assert bool(torch.isfinite(history).all()), "training_loop: non-finite loss"
        runs.append([history] + [p.unconstrained.detach().clone() for p in model.trainable_variables])
        ms[traced] = float(np.median([events[k].elapsed_time(events[k + 1]) for k in range(len(events) - 1)]))
        first[traced] = 1e3 * (marks[0] - t0)
    jt_same("training_loop", runs, (False, True))
    log(f"time: compile training_loop step (M={M}, B={B}, Matern52, the update inside): {ms[False]:.3f} ms eager, "
        f"{ms[True]:.3f} ms traced (CUDA events between steps, medians of steps 2-{1 + JT_LOOP_STEPS}); the first step "
        f"{first[False]:.1f} ms eager, {first[True]:.1f} ms traced, its trace included (host clock); {smi}")


def jt_hmc(launches, smi):
    """A short chain of each of phase 20's models (SGPMC at M = NG_M,
    N = NG_N; GPMC at N = HMC_GPMC_N; float32), JT_HMC_BURNIN adapting and
    JT_HMC_SAMPLES kept steps of HMC_LEAPFROG leapfrog steps from one seed
    under sync debug mode "error", eager (``run_hmc``'s ``jit`` the identity)
    and traced (its default: one trace for every step): the samples
    and log probabilities equal to the bit, one value and gradient of the
    target per leapfrog step and one at the start each way; the ms of a step
    each way by CUDA events recorded after each step, the median over the
    steps but the first (the trace's)."""
    from gpflow_tpu_torch._compile import jit
    from gpflow_tpu_torch.optimizers import mcmc, run_hmc

    X, Y, Z, _, _ = make_ng_data()
    for cls, data in (("SGPMC", (X, Y)), ("GPMC", (X[:HMC_GPMC_N], Y[:HMC_GPMC_N]))):
        helper, _ = hmc_helper(hmc_model(cls, data, Z, torch.float32))
        runs, ms, order = [], {}, (False, True)
        for traced in order:
            events, made = [], []

            def timed_jit(fun):
                step = jit(fun) if traced else fun
                made.append(step)

                def timed(*args):
                    out = step(*args)
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
                    return out

                return timed

            generator = torch.Generator(device="cuda").manual_seed(HMC_SEEDS["chain"])
            original = mcmc.jit
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            mcmc.jit = timed_jit
            try:
                (samples, log_probs), counts = counted(lambda: run_hmc(
                    helper.target_log_prob_fn, helper.current_state, num_samples=JT_HMC_SAMPLES,
                    num_burnin_steps=JT_HMC_BURNIN, step_size=HMC_STEP, num_leapfrog_steps=HMC_LEAPFROG,
                    generator=generator, adapt_step_size=True, target_accept=HMC_TARGET))
            finally:
                mcmc.jit = original
                torch.cuda.set_sync_debug_mode(0)
            evaluations = 1 + (JT_HMC_BURNIN + JT_HMC_SAMPLES) * HMC_LEAPFROG
            expect_launches(f"compile {cls} chain ({jt_mode(traced)})", counts,
                            {k: v * evaluations for k, v in hmc_launches(cls).items()}, launches)
            if traced:
                assert made[0].trace_count == 1, f"{cls} chain: {made[0].trace_count} traces"
            assert bool(torch.isfinite(log_probs).all()), f"compile {cls} chain: a non-finite log probability"
            runs.append(list(samples) + [log_probs])
            # step k + 1 ends at events[k + 1]
            ms[traced] = float(np.median([events[k].elapsed_time(events[k + 1]) for k in range(len(events) - 1)]))
        jt_same(f"{cls} chain", runs, order)
        log(f"time: compile {cls} HMC step ({HMC_LEAPFROG} leapfrog steps): {ms[False]:.3f} ms eager, "
            f"{ms[True]:.3f} ms traced (CUDA events between steps, medians over steps 2-"
            f"{JT_HMC_BURNIN + JT_HMC_SAMPLES}); {smi}")


def jt_cglb(launches, smi):
    """The matrix-free CGLB at phase 15's point (N = SP_N, M = SP_M, chunk
    SP_CHUNK, Matern52, float32) with restarts every JT_CG_RESTART CG
    iterations: its value and gradient, the CG running from a fixed v
    (``aux_vec`` 0, put back before each run: an eager run writes its v
    back), traced (``training_loss_closure()``, one trace) and eager
    (``compile=False``) in JT_ORDER, equal to the bit with the same CG
    iterations (read from ``cg_iterations``); K1 for Kuu, Kuf, each block
    of every CG matvec, and each block of the bound's K v twice (forward,
    checkpointed backward); K2 for Matern52's backward of Kuu, Kuf and each rebuilt block; then
    JT_CG_TIMED runs each way in turns, timed on the host clock (the CG's
    loop reads its stopping test on the host every iteration)."""
    data, Z, _, _ = make_sparse_data()
    model = sparse_model("CGLB", data, Z, torch.float32, kernel="Matern52", matrix_free_chunk=SP_CHUNK,
                         restart_cg_iters=JT_CG_RESTART)
    start = model.aux_vec.value.detach().clone()
    closures = {True: model.training_loss_closure(), False: model.training_loss_closure(compile=False)}
    runs, ms = [], {False: [], True: []}
    nc = n_chunks(model)
    for i, traced in enumerate(JT_ORDER):
        model.aux_vec.assign(start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (value, grads), counts = counted(lambda: sparse_value_and_grad(model, lambda m: closures[traced]()))
        ms[traced].append(1e3 * (time.perf_counter() - t0))
        it = model.cg_iterations
        expected = {"K1": 2 + nc * (cg_matvecs(model, it) + 2), "K2": 2 + nc}
        expect_launches(f"compile cglb run {i} ({jt_mode(traced)}): {it} CG iterations", counts, expected, launches)
        assert it >= JT_CG_RESTART, f"cglb: {it} CG iterations did not reach a restart"
        assert torch.equal(model.aux_vec.value, start) == traced, "cglb: v written back in a replay, or not eagerly"
        runs.append([value, torch.tensor(it)] + [grads[k] for k in sorted(grads)])
    assert closures[True].traced.trace_count == 1, f"cglb: {closures[True].traced.trace_count} traces"
    jt_same(f"cglb value and gradient from a fixed v (N={SP_N}, M={SP_M}, chunk {SP_CHUNK})", runs, JT_ORDER)
    first = ms[True][0]
    ms = {False: [], True: []}
    for k in range(JT_CG_TIMED):  # in turns, after the trace
        for traced in (False, True) if k % 2 == 0 else (True, False):
            model.aux_vec.assign(start)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sparse_value_and_grad(model, lambda m: closures[traced]())
            torch.cuda.synchronize()
            ms[traced].append(1e3 * (time.perf_counter() - t0))
    log(f"time: compile cglb value and gradient from a fixed v, CG included (N={SP_N}, M={SP_M}, chunk {SP_CHUNK}, "
        f"{it} CG iterations): {np.median(ms[False]):.3f} ms eager, {np.median(ms[True]):.3f} ms traced (host clock, "
        f"medians of {JT_CG_TIMED} in turns; the traced run's first call, with its trace, {first:.1f} ms); {smi}")


def compile_phases(launches):
    """Phase 29: the compile layer, traced against eager."""
    from gpflow_tpu_torch.parallel import DataParallelTrainer, adam

    _, smi = card_check()
    log(f"compile: torch {torch.__version__}, CUDA {torch.version.cuda}; traces by make_fx with fake tensors")
    X, Y, Z = make_training_data(SEED)
    staged = (torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda())
    jt_training(f"flagship SVGP step Matern52 (M={M}, B={B})",
                lambda: DataParallelTrainer(training_model("Matern52", Z, torch.float32, "cuda")),
                staged, B, {"K1": 2 * JT_STEPS, "K2": 2 * JT_STEPS}, launches, smi)
    X, Y, Z, _, _ = make_ng_data()
    staged = (torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda())
    jt_training(f"Bernoulli SVGP fused natural-gradient step Matern52 (M={NG_M}, B={NG_B})",
                lambda: DataParallelTrainer(ng_model("Matern52", Z, torch.float32), adam(1e-2),
                                            natgrad_gamma=NG_GAMMA, natgrad_fused=True),
                staged, NG_B, {"K1": 2 * JT_STEPS, "K2": 2 * JT_STEPS}, launches, smi)
    jt_gpr_fit(launches)
    jt_gpr_evaluations(launches, smi)
    jt_training_loop(launches, smi)
    jt_hmc(launches, smi)
    jt_cglb(launches, smi)


# Phases 5-29 in the order they run, as groups that share their data: a
# selection runs each group that holds a selected phase.
PHASE_GROUPS = (
    (range(5, 9), svgp_phases),
    (range(9, 11), gpr_phases),
    (range(11, 13), ng_phases),
    (range(13, 17), sparse_phases),
    (range(17, 18), vgp_phases),
    (range(18, 19), mc_phases),
    (range(19, 20), mo_phases),
    (range(20, 21), hmc_phases),
    (range(21, 22), gplvm_phases),
    (range(22, 23), conv_phases),
    (range(23, 24), serving_phases),
    (range(24, 25), tools_phases),
    (range(25, 26), contracts_phases),
    (range(26, 27), mesh_phases),
    (range(27, 28), reference_phases),
    (range(28, 29), translated_phases),
    (range(29, 30), compile_phases),
)


def parse_args(argv=None):
    """The options: ``phases``, the phases named by ``--phases`` (numbers
    and ranges, e.g. "5-8,21"), or None for every phase; ``k1_host_us``,
    the root of a checkout whose package ``--k1-host-us`` times instead."""
    import argparse

    parser = argparse.ArgumentParser(description="Drives gpflow_tpu_torch's main paths on one CUDA card.")
    parser.add_argument("--phases", help="the phases to run after the build and the kernel checks of phases 1-4, "
                                         "as numbers and ranges among 5-29 (e.g. 5-8,21); by default every phase")
    parser.add_argument("--k1-host-us", metavar="ROOT",
                        help="only build K1 from the checkout at ROOT and print the host time of one K1 call "
                             "at (1, 1, 8) with that checkout's package (phase 23's measurement)")
    parser.add_argument("--cglb-eager-ms", metavar="ROOT",
                        help="only build K1 and K2 from the checkout at ROOT and time, with that checkout's "
                             "package, the matrix-free CGLB's eager value and gradient at phase 25's fixed v, "
                             "with v trainable (no CG) and with the CG from that v")
    parser.add_argument("--mesh-host-ms", action="store_true",
                        help="only build K1 and K2 and time phase 26's latent-split LMC step traced and eager, "
                             "on the one-rank mesh and without it, and the host time of one NCCL collective call")
    args = parser.parse_args(argv)
    if args.phases is None:
        return args
    selected = set()
    for part in args.phases.split(","):
        first, _, last = part.partition("-")
        try:
            selected.update(range(int(first), int(last or first) + 1))
        except ValueError:
            parser.error(f"--phases: {part!r} is not a number or a range")
    unknown = selected - {n for numbers, _ in PHASE_GROUPS for n in numbers}
    if unknown or not selected:
        parser.error(f"--phases: no phase {sorted(unknown)}; phases 5-29 can be selected")
    args.phases = selected
    return args


def k1_host_us_of(root):
    """``--k1-host-us``: ``k1_host_us`` with the package of the checkout at
    ``root`` (another commit's, to compare K1's dispatch on one card)."""
    sys.path.insert(0, os.path.abspath(root))
    name, smi = card_check()
    log(smi)
    import gpflow_tpu_torch

    from gpflow_tpu_torch.ops.pallas_distance import k1_library

    k1_library()
    for _ in range(3):
        log(f"time: K1 host dispatch at (1, 1, {D}): {k1_host_us():.2f} µs per call, package "
            f"{os.path.dirname(gpflow_tpu_torch.__file__)} ({SV_HOST_CALLS} calls, one synchronisation; {name})")


def cglb_eager_ms_of(root):
    """``--cglb-eager-ms``: with the package of the checkout at ``root``
    (another commit's, to compare the eager path on one card), the
    matrix-free CGLB's value and gradient at phase 25's point (N = SP_N,
    M = SP_M, chunk SP_CHUNK, Matern52, float32, v at phase 25's draw),
    eagerly: (a) with v trainable, as phase 25 runs it (no CG), and (b)
    with the CG running from that v (``aux_vec`` put back before each call:
    an eager call writes its v back); where the package traces the CG, (b)
    replayed too. The launches of one call of each are asserted; then
    CGLB_AB_CALLS calls of each in turns, the host clock around each call
    with the card synchronised before and after (medians), and the device
    time of one call of each by ``torch.profiler``."""
    sys.path.insert(0, os.path.abspath(root))
    name, smi = card_check()
    log(smi)
    import gpflow_tpu_torch
    from gpflow_tpu_torch import config

    package = os.path.dirname(gpflow_tpu_torch.__file__)
    config.set_default_float(torch.float32)
    data, Z, _, _ = make_sparse_data()
    v = torch.from_numpy(0.1 * np.random.RandomState(CT_SEED).randn(1, SP_N).astype(np.float32)).cuda()
    fixed = sparse_model("CGLB", data, Z, torch.float32, kernel="Matern52", matrix_free_chunk=SP_CHUNK,
                         v_grad_optimization=True)
    fixed.aux_vec.assign(v)
    cg = sparse_model("CGLB", data, Z, torch.float32, kernel="Matern52", matrix_free_chunk=SP_CHUNK)

    def run_cg():
        cg.aux_vec.assign(v)
        return sparse_value_and_grad(cg, lambda m: m.training_loss())

    runs = {"eager, v trainable, no CG": lambda: sparse_value_and_grad(fixed, lambda m: m.training_loss()),
            "eager, the CG from v": run_cg}
    if not hasattr(type(cg), "untraced"):  # the package traces the CG: (b) replayed too
        closure = cg.training_loss_closure()

        def run_traced():
            cg.aux_vec.assign(v)
            return sparse_value_and_grad(cg, lambda m: closure())

        runs["traced, the CG from v"] = run_traced
    nc = n_chunks(fixed)
    for what, fn in runs.items():
        fn()  # the warm-up: the kernels built and loaded, the trace made
        _, counts = counted(fn)
        iters = 0 if what.endswith("no CG") else cg.cg_iterations
        matvecs = 0 if what.endswith("no CG") else cg_matvecs(cg, iters)
        expect_launches(f"cglb {what} ({iters} CG iterations)", counts,
                        {"K1": 2 + nc * (matvecs + 2), "K2": 2 + nc}, {})
    ms = {what: [] for what in runs}
    for k in range(CGLB_AB_CALLS):
        for what in list(runs) if k % 2 == 0 else reversed(list(runs)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[what]()
            torch.cuda.synchronize()
            ms[what].append(1e3 * (time.perf_counter() - t0))
    for what, fn in runs.items():
        by, _ = profile_device(fn, f"cglb value and gradient, {what}", top=6)
        iters = 0 if what.endswith("no CG") else cg.cg_iterations
        log(f"time: cglb value and gradient, {what} (N={SP_N}, M={SP_M}, chunk {SP_CHUNK}, {iters} CG iterations): "
            f"{np.median(ms[what]):.3f} ms (host clock, median of {CGLB_AB_CALLS} in turns; calls {[round(t, 3) for t in ms[what]]}), device busy "
            f"{sum(by.values()):.3f} ms; package {package}; {smi}")


def mesh_host_ms():
    """``--mesh-host-ms``: phase 26's LMC SVGP step on {"data": 1, "latent":
    1}, traced and eager, on the mesh and without it (``MS_MODES`` and the
    eager step without a mesh), MESH_HOST_STEPS steps in a row of each way
    in MESH_HOST_ROUNDS rounds, the order rotating (ms a step: the host
    clock around them, the card synchronised before and after); then the
    host time of each NCCL collective call over 5 steps of each mesh mode:
    ``torch.distributed``'s ``all_reduce`` and ``all_gather`` eagerly, the
    ``c10d`` ops of the replayed graph traced (the host clock around each
    call, no synchronisation)."""
    import torch.distributed as dist

    from gpflow_tpu_torch import config
    from gpflow_tpu_torch.parallel import DataParallelTrainer, adam, make_mesh

    _, smi = card_check()
    log(smi)
    build_kernels()
    config.set_default_float(torch.float32)
    with ms_group():
        grid = make_mesh(shape={"data": 1, "latent": 1})
        ms_warm(grid)
        (X, Y), _, Zs, W = make_mo_data()
        staged = (torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda())
        build = lambda m: DataParallelTrainer(mo_model("lmc", Zs, W, torch.float32), adam(1e-2), mesh=m,  # noqa: E731
                                              latent_axis="latent" if m is not None else None)
        modes = (*MS_MODES, "eager no mesh")
        trainers = {}
        for mode in modes:
            trainer = trainers[mode] = jt_eager(build(None)) if mode == "eager no mesh" else ms_build(build, grid, mode)
            trainer.stage_data(staged)
            ct_steps(trainer, 3, MO_B)  # the trace and the warm-up

        def steps(mode, n, seed):
            for i in range(n):
                trainers[mode].run_steps_sampled(1, MO_B, generator=torch.Generator(device="cuda").manual_seed(seed + i))

        ms = {mode: [] for mode in modes}
        for r in range(MESH_HOST_ROUNDS):
            for mode in modes[r % len(modes):] + modes[:r % len(modes)]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps(mode, MESH_HOST_STEPS, CT_SEED)
                torch.cuda.synchronize()
                ms[mode].append(1e3 * (time.perf_counter() - t0) / MESH_HOST_STEPS)
        what = f"multioutput SVGP step, {MO_L} latent GPs (M={MO_M}, B={MO_B}, D={MO_D})"
        log(f"time: mesh host {what}: " + "; ".join(
            f"{mode} {np.median(v):.3f} ms (rounds {[round(t, 3) for t in v]})" for mode, v in ms.items())
            + f" (host clock, {MESH_HOST_STEPS} steps in a row a round, the order rotating); {smi}")
        calls = {}

        def timed(fn, record):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                record.append(1e6 * (time.perf_counter() - t0))
                return out
            return call

        eager = calls["eager mesh"] = []
        originals = {f: getattr(dist, f) for f in ("all_reduce", "all_gather")}
        for f, fn in originals.items():
            setattr(dist, f, timed(fn, eager))
        try:
            steps("eager mesh", 5, CT_SEED)
        finally:
            for f, fn in originals.items():
                setattr(dist, f, fn)
        gm = next(iter(trainers["mesh"]._traced.cache.values())).gm
        nodes = [n for n in gm.graph.nodes if n.op == "call_function" and getattr(n.target, "namespace", None) == "c10d"]
        calls["mesh"] = []
        targets = {n: n.target for n in nodes}
        for n in nodes:
            n.target = timed(n.target, calls["mesh"])
        gm.recompile()
        try:
            steps("mesh", 5, CT_SEED)
        finally:
            for n, target in targets.items():
                n.target = target
            gm.recompile()
        torch.cuda.synchronize()
        log("time: mesh host, one NCCL collective call: " + "; ".join(
            f"{mode} {np.median(v):.1f} µs (median of {len(v)} calls, {len(v) // 5} a step)" for mode, v in calls.items())
            + f" (host clock around each call); {smi}")


def main(phases=None):
    """Phases 1-4, then every phase in ``phases`` (all of them if None),
    then the timings of the record line."""
    name, smi = card_check()
    log(smi)
    from gpflow_tpu_torch import _compile, config

    with ThreadPoolExecutor(max_workers=1) as pool:
        build = pool.submit(build_kernels)
        if phases is None or 28 in phases:  # the longest, which traces nothing, at once
            TR_RUNS.extend(tr_run([TR_ALONE[0]], 1, "alone"))
        # beside the build: the tracing code loaded, and its bytecode written, before the
        # processes that read it start
        t0 = time.perf_counter()
        _compile.jit(lambda x: x + 1)(torch.ones(2))
        log(f"time: the first trace of the process, the tracing code loaded: {time.perf_counter() - t0:.1f} s")
        if phases is None or 27 in phases:
            RF_RUNS.append(rf_reference_run())
        if phases is None or 28 in phases:
            TR_RUNS.extend(tr_start_early())
        built = build.result()
    for kernel, (ready_s, nvcc_s) in built.items():
        log(f"build: {kernel} library ready in {ready_s:.2f} s (nvcc {nvcc_s:.2f} s; 0 means built earlier)")

    if TR_RUNS:
        TR_RUNS.extend(tr_start_kernels())
    errs = {"K1": check_k1(), "K2": max(check_k2(), check_k2_coincident())}
    if TR_RUNS:
        # they share the host's cores and the card: let them end before any phase is timed
        t0 = time.perf_counter()
        for proc, _, _ in TR_RUNS:
            proc.wait(timeout=TR_TIMEOUT)
        log(f"time: phase 28's processes, started before the kernel checks, ended {time.perf_counter() - t0:.1f} s "
            "after them")

    config.set_default_float(torch.float32)  # and with it the float32 jitter, 1e-4
    launches = {}  # path -> launch counts of its run
    for numbers, run in PHASE_GROUPS:
        if phases is not None and not phases & set(numbers):
            continue
        t0 = time.perf_counter()
        for kernel, err in (run(launches) or {}).items():
            errs[kernel] = max(errs[kernel], err)
        torch.cuda.empty_cache()
        log(f"time: phases {numbers[0]}-{numbers[-1]}: {time.perf_counter() - t0:.1f} s")

    n = GPR_NS[-1]
    with torch.no_grad():
        time_k1(GPR_NS[0], GPR_NS[0], iters=20)  # the Gram matrix at N = 8192
        time_k1(n, B, iters=20)  # Kmn of a request at N = 16384
        time_k2(GPR_NS[0], GPR_NS[0], iters=20, family="matern12")  # the Matern12 GPR's backward
        k1_ms, k1_plain_ms = time_k1(n, n, iters=10)
        k2_ms, k2_plain_ms = time_k2(n, n, iters=10)
        time_k1(1, 1)  # the launch floor: one tile, one block

    total = {k: sum(c[k] for c in launches.values()) for k in ("K1", "K2")}
    log(f"launches by path: {launches}")
    if phases is None:
        assert total["K1"] > 0 and total["K2"] > 0, f"a kernel of the paths never launched: {total}"
        # phases 5-28 as before the compile layer; phase 29's paths asserted one by one
        phase29 = {k: sum(c[k] for what, c in launches.items() if what.startswith("compile ")) for k in total}
        earlier = {k: total[k] - phase29[k] for k in total}
        log(f"launches: phases 5-28 {earlier}, phase 29 {phase29}, in all {total}")
        assert earlier == LAUNCHES_5_TO_28, f"phases 5-28 launched {earlier}, not {LAUNCHES_5_TO_28}"
    else:
        log(f"phases {sorted(phases)} only: launches {total}")
        assert total["K1"] + total["K2"] > 0, f"the selected phases launched no kernel: {total}"
    records = []
    for kernel, label, family, source, replaces, ms, plain_ms in (
        ("K1", "K1 stationary covariance (rbf, matern52, matern32 and matern12 on the paths)", "rbf",
         "stationary_k1.cu", 136, k1_ms, k1_plain_ms),
        ("K2", "K2 stationary VJP weight (matern52, matern32 and matern12 on the training paths)", "matern52",
         "stationary_k2.cu", 142, k2_ms, k2_plain_ms),
    ):
        bound_ms, bound_by = kernel_bound_ms(kernel, n, n, D)
        log(f"bound: {kernel} ({n}, {n}, {D}): {bound_ms:.4f} ms by {bound_by}; measured {ms:.4f} ms "
            f"({100 * bound_ms / ms:.0f}% of the bound's rate)")
        records.append({
            "name": f"{label}, timed as {family} at ({n}, {n}, {D})",
            "route": "cuda",
            "source": f"gpflow_tpu_torch/csrc/{source}",
            "replaces": f"gpflow_tpu/ops/pallas_distance.py:{replaces}",
            "launches": total[kernel],
            "max_abs_err": errs[kernel],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call computes var * h(d2) or g * var * h'(d2)
            "library_ms": None,
        })
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    options = parse_args()
    if options.k1_host_us:
        k1_host_us_of(options.k1_host_us)
    elif options.cglb_eager_ms:
        cglb_eager_ms_of(options.cglb_eager_ms)
    elif options.mesh_host_ms:
        mesh_host_ms()
    else:
        main(options.phases)
